"""Port parity: the MPC expert (profiling tables, sequence search, CLI).

* ``build_expert_tables``: all ten [V,U,C,A] tables of the port's plain
  version (K5's oracle) against the JAX function, on tables whose predicted
  viewport differs from the ground truth (so the gt/pred/dep/out variants
  differ) and that hold an empty ground-truth and an empty predicted
  viewport.  Tolerance rtol 1e-5, atol 1e-6: the 64-tile sums associate
  differently.
* ``choose_action``: the plain version (K4's oracle) against the JAX search
  vmapped over lanes, at horizons 1-3 (4 only on the card), in every mode:
  the privileged trace walk, per-lane ``bw_hat``, per-lane ``acc_hat``,
  per-lane ``use_corr`` and ``return_margin``.  Lanes sit at every point of
  their episodes, so some horizons cross ``end_chunk``; ``past_acc`` holds
  varied values (synthetic ``vp_acc`` is all ones).  Actions exact, margins
  1e-5.
* ``run_expert --test`` and ``run_expert --train --exact-action-values``
  of both packages on one on-disk tree: the same ``results.csv`` rows, and
  the same demonstration keys, actions and observations.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_tree import build_synthetic_tree
from mansy_immersivevideostreaming_tpu.cli import run_expert as JCLI
from mansy_immersivevideostreaming_tpu.ops import qoe as JQ
from mansy_immersivevideostreaming_tpu.sim import env as JE
from mansy_immersivevideostreaming_tpu.sim import expert as JX
from mansy_immersivevideostreaming_tpu.sim import simulator as JS
from mansy_immersivevideostreaming_tpu.sim import tables as JT
from mansy_immersivevideostreaming_torch.cli import run_expert as TCLI
from mansy_immersivevideostreaming_torch.kernels.env_step import env_step_plain
from mansy_immersivevideostreaming_torch.rl.rollout import init_lanes
from mansy_immersivevideostreaming_torch.sim import env as TE
from mansy_immersivevideostreaming_torch.sim import expert as TX
from mansy_immersivevideostreaming_torch.sim import tables as TT
from test_torch_tables import port_config

LANES_PER_POINT = 3   # lanes at each point of the episode
EPISODE_STEPS = 6     # 12 chunks, the first download at chunk 6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def make_tables(seed=3, empty_viewports=True):
    """Matching tables of both packages: 12 chunks, a trace with outages, a
    predicted viewport that misses ~15% of tiles and, with
    ``empty_viewports``, one empty ground-truth viewport and one empty
    predicted viewport."""
    jt = JT.synthetic_sim_tables(num_videos=2, num_users=3, num_traces=2, num_chunks=12,
                                 num_qoe=3, seed=seed)
    rng = np.random.default_rng(seed + 1)
    bw = np.asarray(jt.bw).copy()
    bw[0, 5:8] = 0.0
    lens = np.asarray(jt.bw_len)
    gt = np.asarray(jt.gt).copy()
    pred = np.where(rng.random(gt.shape) < 0.15, 1.0 - gt, gt).astype(np.float32)
    if empty_viewports:
        gt[0, 1, 7] = 0.0
        pred[1, 2, 8] = 0.0
    jt = jt._replace(bw=jnp.asarray(bw), bw_prefix=JS.build_prefix(bw, lens),
                     gt=jnp.asarray(gt), pred=jnp.asarray(pred))
    tt = TT.synthetic_sim_tables(num_videos=2, num_users=3, num_traces=2, num_chunks=12,
                                 num_qoe=3, seed=seed, device="cpu")
    tt = tt._replace(bw=torch.as_tensor(bw), bw_prefix=TT.build_prefix(bw, lens),
                     gt=torch.as_tensor(gt), pred=torch.as_tensor(pred))
    return jt, tt


@pytest.fixture(scope="module")
def setup():
    jt, tt = make_tables()
    return jt, tt, JX.build_expert_tables(jt), TX.build_expert_tables_plain(tt)


def to_jax_state(state: TE.EnvState) -> JE.EnvState:
    f = lambda x: jnp.asarray(x.numpy())
    fields = {k: f(v) for k, v in state._asdict().items() if k not in ("net", "qoe")}
    return JE.EnvState(net=JS.NetState(*map(f, state.net)),
                       qoe=JQ.QoEState(*map(f, state.qoe)), **fields)


def lanes_through_episodes(tables, seed=0):
    """Lanes at every point of their episodes (LANES_PER_POINT at each),
    stepped by the plain env step with random actions, with varied
    ``past_acc`` (entries left at 0 stay 0: the estimate skips them)."""
    samples = torch.as_tensor(TE.generate_demo_samples(2, 3, 2, 3, 9, seed=seed))
    rng = np.random.default_rng(seed)
    parts = []
    for k in range(EPISODE_STEPS):
        state = init_lanes(tables, samples, LANES_PER_POINT, seed=k)
        for _ in range(k):
            acts = torch.as_tensor(rng.integers(0, 15, LANES_PER_POINT).astype(np.int32))
            state, *_ = env_step_plain(tables, samples, state, acts, LANES_PER_POINT, False)
        parts.append(state)
    state = _cat(parts)
    acc = state.past_acc
    varied = torch.as_tensor(rng.uniform(0.2, 1.0, acc.shape).astype(np.float32))
    return state._replace(past_acc=torch.where(acc > 0, varied, acc))


def _cat(xs):
    if isinstance(xs[0], tuple):
        return type(xs[0])(*(_cat([x[i] for x in xs]) for i in range(len(xs[0]))))
    return torch.cat(xs)


def test_build_expert_tables_matches_jax(setup):
    jt, tt, jet, tet = setup
    assert tet.pred_quality.shape == (2, 3, 12, 15)
    for name in TX.ExpertTables._fields:
        np.testing.assert_allclose(getattr(tet, name).numpy(), np.asarray(getattr(jet, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    # the variants differ where pred != gt, and the empty viewports score 0
    assert not np.allclose(tet.dep_quality.numpy(), tet.pred_quality.numpy())
    assert float(tet.gt_quality[0, 1, 7].abs().max()) == 0.0
    assert float(tet.dep_quality[1, 2, 8].abs().max()) == 0.0


def test_build_expert_tables_goes_through_the_wrapper_on_cpu(setup):
    _, tt, _, tet = setup
    got = TX.build_expert_tables(tt)
    for a, b in zip(got, tet):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("horizon", [1, 2, 3])
def test_action_sequences_equal(horizon):
    np.testing.assert_array_equal(TX.action_sequences(horizon, 15),
                                  JX.action_sequences(horizon, 15))


def test_corrected_scores_and_estimates_match_jax(setup):
    jt, tt, _, _ = setup
    state = lanes_through_episodes(tt)
    js = to_jax_state(state)
    np.testing.assert_allclose(TX.causal_bw_estimate(tt, state).numpy(),
                               np.asarray(jax.vmap(lambda s: JX.causal_bw_estimate(jt, s))(js)),
                               rtol=1e-6)
    np.testing.assert_allclose(TE.viewport_acc_estimate(state.past_acc).numpy(),
                               np.asarray(jax.vmap(JE.viewport_acc_estimate)(js.past_acc)),
                               rtol=1e-6)
    rng = np.random.default_rng(0)
    x = [rng.uniform(0, 35, 40).astype(np.float32) for _ in range(4)]
    acc = rng.uniform(0, 1, 40).astype(np.float32)
    got = TX.corrected_scores(*map(torch.as_tensor, x), torch.as_tensor(acc))
    want = JX.corrected_scores(*map(jnp.asarray, x), jnp.asarray(acc))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


# (horizon, bandwidth: trace | bw_hat, scoring: pred | acc | use_corr, margin)
MODES = [(1, "trace", "pred", True), (2, "trace", "pred", False), (3, "trace", "pred", True),
         (2, "bw_hat", "pred", True), (3, "bw_hat", "acc", False), (2, "trace", "acc", True),
         (2, "bw_hat", "use_corr", True), (3, "trace", "use_corr", False),
         (1, "bw_hat", "use_corr", True)]


@pytest.mark.parametrize("horizon,bandwidth,scoring,margin", MODES)
def test_choose_action_matches_jax(setup, horizon, bandwidth, scoring, margin):
    jt, tt, jet, tet = setup
    state = lanes_through_episodes(tt, seed=horizon)
    N = state.buf.shape[0]
    if horizon > 1:  # some lanes' horizons cross end_chunk
        assert bool((state.next_chunk + horizon - 1 > tt.end_chunk[0, 0]).any())
    bw_hat = TX.causal_bw_estimate(tt, state) if bandwidth == "bw_hat" else None
    acc_hat = TE.viewport_acc_estimate(state.past_acc) if scoring != "pred" else None
    use_corr = torch.arange(N) % 2 == 0 if scoring == "use_corr" else None
    got = TX.choose_action(tt, tet, state, horizon, bw_hat, acc_hat, use_corr, margin)

    seqs = jnp.asarray(JX.action_sequences(horizon, 15))
    opt = lambda x: None if x is None else jnp.asarray(x.numpy())

    def one(s, bw, acc, corr):
        return JX.choose_action(jt, jet, s, seqs, bw_hat=bw, acc_hat=acc, use_corr=corr,
                                return_margin=margin)
    axes = tuple(0 if x is not None else None for x in (bw_hat, acc_hat, use_corr))
    want = jax.jit(jax.vmap(one, in_axes=(0,) + axes))(
        to_jax_state(state), opt(bw_hat), opt(acc_hat), opt(use_corr))
    if margin:
        (got, got_m), (want, want_m) = got, want
        np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=1e-5, atol=1e-5)
        assert bool((got_m >= 0).all())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_choose_action_use_corr_switches_per_lane(setup):
    _, tt, _, tet = setup
    state = lanes_through_episodes(tt, seed=4)
    N = state.buf.shape[0]
    acc = TE.viewport_acc_estimate(state.past_acc)
    corr = torch.arange(N) % 3 == 0
    mixed = TX.choose_action_plain(tt, tet, state, 2, None, acc, corr)
    on = TX.choose_action_plain(tt, tet, state, 2, None, acc)
    off = TX.choose_action_plain(tt, tet, state, 2)
    torch.testing.assert_close(mixed, torch.where(corr, on, off))
    with pytest.raises(ValueError, match="acc_hat"):
        TX.choose_action_plain(tt, tet, state, 2, use_corr=corr)


# ---------------------------------------------------------------- CLIs

def _read_csv(path):
    with open(path) as f:
        header = f.readline()
        rows = sorted(tuple(float(x) for x in line.split(",")) for line in f)
    return header, np.asarray(rows)


def _assert_same_results(tpath, jpath):
    th, trows = _read_csv(tpath)
    jh, jrows = _read_csv(jpath)
    assert th == jh and trows.shape == jrows.shape and len(trows) > 0
    np.testing.assert_array_equal(trows[:, :6], jrows[:, :6])
    # the CSV rounds to 5 digits: values 1e-5 apart may round one step apart
    np.testing.assert_allclose(trows[:, 6:], jrows[:, 6:], rtol=0, atol=1.5e-5)


def _dirs(cfg, package):
    """The JAX CLI's config, and the port's with its own models and results
    trees, so neither reads the other's expert-table cache."""
    import dataclasses
    root = os.path.dirname(cfg.bs_models_dir)
    pc = port_config(cfg)
    return dataclasses.replace(
        pc, bs_models_dir=os.path.join(root, package, "models"),
        bs_results_dir=os.path.join(root, package, "results"))


def test_run_expert_test_cli_matches_jax(tmp_path):
    cfg = build_synthetic_tree(str(tmp_path))
    argv = ["--test", "--horizon", "2", "--qoe-test-ids", "0", "2"]
    JCLI.run(JCLI.build_parser().parse_args(argv), cfg)
    tcfg = _dirs(cfg, "torch")
    TCLI.run(TCLI.build_parser().parse_args(argv + ["--device", "cpu"]), tcfg)
    rel = os.path.join("expert", "Jin2022_4G", "unseen_qoe0_2", "results.csv")
    _assert_same_results(os.path.join(tcfg.bs_results_dir, rel),
                         os.path.join(cfg.bs_results_dir, rel))


def test_run_expert_train_demos_match_jax(tmp_path):
    cfg = build_synthetic_tree(str(tmp_path))
    argv = ["--train", "--horizon", "2", "--exact-action-values", "--acc-correct-obs",
            "--qoe-train-ids", "1", "3"]
    JCLI.run(JCLI.build_parser().parse_args(argv), cfg)
    tcfg = _dirs(cfg, "torch")
    TCLI.run(TCLI.build_parser().parse_args(argv + ["--device", "cpu"]), tcfg)
    rel = os.path.join("expert", "Jin2022_4G", "qoe1_3")
    with open(os.path.join(cfg.bs_models_dir, rel, "train_demonstrations.pkl"), "rb") as f:
        jdemos = pickle.load(f)
    with open(os.path.join(tcfg.bs_models_dir, rel, "train_demonstrations.pkl"), "rb") as f:
        tdemos = pickle.load(f)
    assert sorted(tdemos) == sorted(jdemos) and len(tdemos) > 0
    for key, demo in jdemos.items():
        np.testing.assert_array_equal(tdemos[key]["act"], np.asarray(demo["act"]), err_msg=key)
        assert sorted(tdemos[key]["obs"]) == sorted(demo["obs"])
        assert "action_values" in tdemos[key]["obs"]
        for name, x in demo["obs"].items():
            y = tdemos[key]["obs"][name]
            assert isinstance(y, np.ndarray) and y.shape == np.shape(x), name
            np.testing.assert_allclose(y, np.asarray(x), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{key} {name}")
    _assert_same_results(os.path.join(tcfg.bs_models_dir, rel, "train_log.csv"),
                         os.path.join(cfg.bs_models_dir, rel, "train_log.csv"))
