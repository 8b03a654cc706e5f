"""Port parity: the derived action values (JAX ``models/abr_nets.py:
causal_action_values``, ``:29-92``) and the policies that read them.

* ``causal_action_values`` against JAX's on random observations and on the
  edge cases: an empty predicted viewport (every tile at the inside rate),
  an empty throughput history (the 0.5 prior), no previous action, a full
  viewport.
* K2's plain derived mode (``observe_mansy_pack(.., action_values=True)``
  on tables without action values) and its plain row mode
  (``derive_action_values``) against JAX ``observe_mansy`` followed by
  ``causal_action_values``, on lanes at every point of their episodes.
* ``MansyActorCritic`` with the action-value branch, the logit prior, and
  both, against the Flax module from its initialiser (weights carried by
  ``actor_critic_state_dict_from_flax``), on the derived field.
* Deterministic ``runner.evaluate`` of (i) v16's weights with a sidecar of
  ``obs_action_values`` without ``exact_action_values`` and (ii) v9's
  weights with a logit prior of 3.0, against the JAX runner: the same
  first-done masks and per-episode records.
* One ``ppo_update`` with ``--obs-action-values`` at hidden 16 against JAX's,
  with JAX's permutations.
* ``run_ensemble`` with a derived-value component beside the JAX CLI: the
  route, ``results.csv`` and ``route.json``.

Tolerance rtol 1e-5 and atol 1e-6 on the values (XLA sums the slabs over
(R, T) and the viewport over T in its own order; values near 0 compare
absolutely; NaN where an empty ground-truth viewport's quality reaches the
history, in both); the nets, records and updates as ``test_torch_nets.py``,
``test_torch_slice.py`` and ``test_torch_ppo.py`` hold them.  A net with a
logit prior gets a slack beyond 1e-5 on its logits (:func:`assert_matches_flax`):
the prior standardizes the 15 values of a state, whose condition is max|av|
/ std, so f32 roundings of the values, their mean and their std (a few ulps
of the largest) move the logits by up to beta 8 eps max|av| / std; on
random observations that passes 1e-5 where the values lie close together
(up to 2.7e-5 seen at beta 3, max|av| / std 19), and it does so between two
orders of the same sums in either package.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mansy_immersivevideostreaming_tpu.cli import run_ensemble as JENS
from mansy_immersivevideostreaming_tpu.cli.run_mansy import dummy_obs
from mansy_immersivevideostreaming_tpu.models import abr_nets as JN
from mansy_immersivevideostreaming_tpu.rl import ppo as JP
from mansy_immersivevideostreaming_tpu.rl import runner as JRun
from mansy_immersivevideostreaming_tpu.rl.types import RunningStat as JaxStat
from mansy_immersivevideostreaming_tpu.rl.types import Transition as JaxTransition
from mansy_immersivevideostreaming_tpu.sim import env as JE
from mansy_immersivevideostreaming_tpu.sim.tables import synthetic_sim_tables as jax_tables
from mansy_immersivevideostreaming_tpu.utils.checkpoint import save_checkpoint
from mansy_immersivevideostreaming_tpu.utils.checkpoint import save_net_config as jax_netcfg
from mansy_immersivevideostreaming_torch.cli import run_ensemble as TENS
from mansy_immersivevideostreaming_torch.kernels import observe as K2
from mansy_immersivevideostreaming_torch.models import abr_nets as TN
from mansy_immersivevideostreaming_torch.rl import ppo as TP
from mansy_immersivevideostreaming_torch.rl import runner as TRun
from mansy_immersivevideostreaming_torch.rl.types import RunningStat, Transition
from mansy_immersivevideostreaming_torch.sim import env as TE
from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables
from mansy_immersivevideostreaming_torch.utils.checkpoint import (
    DAGGER_V9_NPZ, DAGGER_V16_NPZ, NET_CONFIG_SUFFIX, actor_critic_state_dict_from_flax,
    flatten_params, flax_params, load_npz_policy, save_net_config,
)
from synthetic_tree import build_synthetic_tree
from test_torch_action_values import restore_v16
from test_torch_checkpoint import restore_v9
from test_torch_ensemble import _assert_close_tree, _read_csv
from test_torch_expert import lanes_through_episodes, make_tables, to_jax_state
from test_torch_ppo import MB, N, PREFS, T, random_obs, trajectory
from test_torch_slice import _assert_same_evaluation
from test_torch_tables import port_config

TOL = dict(rtol=1e-5, atol=1e-6)
DIMS = (8, 5, 64, 15)  # K, R, T, A


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def assert_matches_flax(logits, value, net, variables, obs):
    """The port's (logits, value) on ``obs`` (no exact field) against the
    Flax ``net``'s, which derives the values itself: 1e-5, plus with a logit
    prior beta 8 eps max|av| / std of each state's values (the docstring)."""
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    jl, jv = net.apply(variables, jobs)
    slack = 0.0
    if net.av_logit_prior:
        av = np.asarray(JN.causal_action_values(jobs), np.float64)[:, :net.action_space]
        slack = (net.av_logit_prior * 8 * np.finfo(np.float32).eps
                 * np.abs(av).max(-1) / av.std(-1))[:, None]
    excess = np.abs(np.asarray(logits) - np.asarray(jl)) - 1e-5 * np.abs(np.asarray(jl)) - slack
    assert excess.max() <= 1e-5, f"logits beyond tolerance by {excess.max()}"
    np.testing.assert_allclose(np.asarray(value), np.asarray(jv), rtol=1e-5, atol=1e-5)


def edge_obs(case: str) -> dict:
    """24 random observations, with the edge case on all of them."""
    obs = random_obs(np.random.default_rng(len(case)), (24,), False)
    if case == "empty_viewport":
        obs["pred_viewport"][:] = 0.0
    elif case == "empty_history":
        obs["throughput"][:] = 0.0
    elif case == "no_previous_action":
        obs["action_one_hot"][:] = 0.0
    elif case == "full_viewport":
        obs["pred_viewport"][:] = 1.0
    return obs


@pytest.mark.parametrize("case", ["random", "empty_viewport", "empty_history",
                                  "no_previous_action", "full_viewport"])
def test_causal_action_values_match_jax(case):
    obs = edge_obs(case)
    want = np.asarray(JN.causal_action_values({k: jnp.asarray(v) for k, v in obs.items()}))
    got = TN.causal_action_values({k: torch.as_tensor(v) for k, v in obs.items()}).numpy()
    assert got.shape == want.shape == (24, 16)
    np.testing.assert_allclose(got, want, **TOL)
    if case == "empty_history":
        assert (got[:, -1] == 0.5).all()
    # the exact field, where the observation has one, wins (_action_value_features)
    exact = {**obs, "action_values": np.ones((24, 16), np.float32)}
    assert (TN._action_value_features({k: torch.as_tensor(v) for k, v in exact.items()})
            == 1.0).all()


def test_derived_mode_and_row_mode_match_jax():
    jt, tt = make_tables(seed=6)  # an empty predicted viewport at (1, 2, 8)
    state = lanes_through_episodes(tt, seed=3)
    jobs = jax.vmap(lambda s: JE.observe_mansy(jt, s))(to_jax_state(state))
    want = np.asarray(JN.causal_action_values(jobs))
    x = K2.observe_mansy_pack(tt, state, action_values=True)
    assert x.shape == (state.buf.shape[0], K2.obs_width(*DIMS, True))
    col = K2.obs_columns(*DIMS, True)["action_values"]
    assert (col.start, col.stop) == (748, 764)
    np.testing.assert_allclose(x[:, col].numpy(), want, **TOL)
    # every other column is the 13-field observation's
    for name, view in K2.unpack_obs(x, *DIMS, True).items():
        if name != "action_values":
            np.testing.assert_allclose(view.numpy(), np.asarray(jobs[name]), **TOL, err_msg=name)
    # the row mode on rows packed without the field, and through pack_obs
    rows = x.clone()
    rows[:, col] = 0.0
    K2.derive_action_values(rows, *DIMS)
    torch.testing.assert_close(rows, x, rtol=0, atol=0, equal_nan=True)
    packed = K2.pack_obs({k: np.array(v) for k, v in jobs.items()}, action_values=True)
    np.testing.assert_allclose(packed.numpy(), x.numpy(), **TOL)


@pytest.mark.parametrize("kwargs", [dict(use_action_values=True), dict(av_logit_prior=3.0),
                                    dict(use_action_values=True, av_logit_prior=3.0)])
def test_flax_initialised_nets_match_on_the_derived_field(kwargs):
    obs = random_obs(np.random.default_rng(9), (32,), False)
    net = JN.MansyActorCritic(hidden_dim=16, **kwargs)
    params = net.init(jax.random.PRNGKey(2), {k: jnp.asarray(v) for k, v in obs.items()})
    policy = TN.MansyActorCritic(hidden_dim=16, device="cpu", **kwargs)
    policy.load_state_dict(actor_critic_state_dict_from_flax(jax.device_get(params["params"])))
    with torch.no_grad():
        logits, value = policy({k: torch.as_tensor(v) for k, v in obs.items()})
    assert_matches_flax(logits.numpy(), value.numpy(), net, params, obs)


def derived_policy(tmp_path, which: str):
    """(the port's policy from an npz with a derived-value sidecar, the JAX
    net, its params): (i) v16's weights, ``obs_action_values`` without
    ``exact_action_values`` (prior 3.0 kept); (ii) v9's with a prior of 3.0."""
    npz, base, override = {"i": (DAGGER_V16_NPZ, restore_v16,
                                 {"obs_action_values": True, "exact_action_values": False}),
                           "ii": (DAGGER_V9_NPZ, restore_v9, {"av_logit_prior": 3.0})}[which]
    path = tmp_path / f"{which}.npz"
    shutil.copyfile(npz, path)
    with open(f"{npz}{NET_CONFIG_SUFFIX}") as f:
        cfg = {**json.load(f), **override}
    with open(f"{path}{NET_CONFIG_SUFFIX}", "w") as f:
        json.dump(cfg, f)
    net = JN.MansyActorCritic(hidden_dim=128, use_action_values=cfg["obs_action_values"],
                              av_logit_prior=cfg["av_logit_prior"])
    return load_npz_policy(path, device="cpu"), net, base()


@pytest.mark.parametrize("which", ["i", "ii"])
def test_deterministic_derived_value_evaluation_matches_jax(tmp_path, which):
    dims, seed = (2, 3, 2, 16, 4), 7
    V, U, NT, _, Q = dims
    samples = TE.generate_environment_test_samples(V, U, NT, Q)
    policy, net, params = derived_policy(tmp_path, which)
    assert policy.reads_action_values and not policy.exact_action_values
    jlogs, jmasks = JRun.evaluate(lambda p, o: net.apply({"params": p}, o), params,
                                  jax_tables(*dims, seed=seed), jnp.asarray(samples),
                                  JE.observe_mansy, jax.random.PRNGKey(0), lane_chunk=24,
                                  deterministic=True)
    tlogs, tmasks = TRun.evaluate(policy, synthetic_sim_tables(*dims, seed=seed, device="cpu"),
                                  torch.as_tensor(samples), lane_chunk=24, deterministic=True)
    _assert_same_evaluation(tlogs, tmasks, jlogs, jmasks, len(samples))


def test_ppo_update_with_obs_action_values_matches_jax():
    """``test_torch_ppo``'s update (rew_norm, value clip) on a policy with the
    action-value branch over the derived field: the JAX net derives the
    values from the trajectory's 13 fields, the port reads them in the
    packed rows (K2's row mode)."""
    rng = np.random.default_rng(11)
    net = JN.MansyActorCritic(hidden_dim=16, use_action_values=True)
    obs0 = {k: jnp.asarray(v) for k, v in random_obs(rng, (2,), False).items()}
    params = net.init(jax.random.PRNGKey(5), obs0)["params"]
    policy = TN.MansyActorCritic(hidden_dim=16, use_action_values=True, device="cpu")
    policy.load_state_dict(actor_critic_state_dict_from_flax(jax.device_get(params)))
    tr = trajectory(rng, net, params)
    cfg_kw = dict(minibatch=MB, repeat=2, n_prefs=PREFS)
    before = {k: v.copy() for k, v in flatten_params(jax.device_get(params)).items()}
    optimizer = JP.make_optimizer(5e-4)
    key = jax.random.PRNGKey(8)
    jtraj = JaxTransition(obs={k: jnp.asarray(v) for k, v in tr["obs"].items()},
                          action=jnp.asarray(tr["action"]), log_prob=jnp.asarray(tr["log_prob"]),
                          value=jnp.asarray(tr["value"]), reward=jnp.asarray(tr["reward"]),
                          done=jnp.asarray(tr["done"]))
    jparams, _, jstat, jm = JP.ppo_update(
        lambda p, o: net.apply({"params": p}, o), optimizer, JP.PPOConfig(**cfg_kw), params,
        optimizer.init(params), jtraj, jnp.asarray(tr["reward"]), jnp.asarray(tr["last_values"]),
        JaxStat(*map(jnp.float32, (0.3, 2.0, 50.0))), key, None)
    perms = np.stack([np.asarray(jax.random.permutation(k, T * N))[:T * N // MB * MB]
                      .reshape(-1, MB) for k in jax.random.split(key, 2)])

    x = K2.pack_obs(tr["obs"], action_values=True)
    assert x.shape == (T * N, 795)
    traj = Transition(obs=x.reshape(T, N, -1), action=torch.as_tensor(tr["action"]),
                      log_prob=torch.as_tensor(tr["log_prob"]),
                      value=torch.as_tensor(tr["value"]), reward=torch.as_tensor(tr["reward"]),
                      done=torch.as_tensor(tr["done"]))
    stat, m = TP.ppo_update(
        policy, TP.make_optimizer(policy.parameters(), 5e-4), TP.PPOConfig(**cfg_kw), traj,
        traj.reward, torch.as_tensor(tr["last_values"]),
        RunningStat(*(torch.tensor(v, dtype=torch.float32) for v in (0.3, 2.0, 50.0))),
        perms=torch.as_tensor(perms))
    for k in ("loss", "loss/clip", "loss/vf", "loss/ent"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    for a, b in zip(stat, jstat):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    got, want = flax_params(policy), flatten_params(jax.device_get(jparams))
    assert "feature_net/action_values/kernel" in want
    excluded, total = 0, 0
    for k in want:
        moved = np.abs(want[k] - before[k])
        diff = np.abs(got[k] - want[k])
        ambiguous = moved < 0.5 * 8 * 5e-4  # gradients near 0 (test_torch_ppo's rule)
        assert (diff[~ambiguous] <= 2e-6).all(), f"{k}: {diff[~ambiguous].max()}"
        excluded += int((ambiguous & (diff > 2e-6)).sum())
        total += diff.size
    assert excluded <= 0.005 * total, f"{excluded} of {total} entries differ beyond 2e-6"


def test_run_ensemble_with_a_derived_component_matches_the_jax_cli(tmp_path):
    """Two hidden-16 components from Flax's init: a plain one and one that
    reads the derived values through its branch and a prior of 3.0."""
    base = str(tmp_path)
    cfg = build_synthetic_tree(base)
    jax_ckpts, npzs = [], []
    for seed, netcfg in ((0, {"hidden_dim": 16}),
                         (1, {"hidden_dim": 16, "obs_action_values": True,
                              "av_logit_prior": 3.0})):
        net = JN.MansyActorCritic(hidden_dim=16, action_space=cfg.action_space,
                                  use_action_values=netcfg.get("obs_action_values", False),
                                  av_logit_prior=netcfg.get("av_logit_prior", 0.0))
        params = net.init(jax.random.PRNGKey(seed), dummy_obs(cfg))["params"]
        ckpt, npz = os.path.join(base, f"comp{seed}.ckpt"), os.path.join(base, f"comp{seed}.npz")
        save_checkpoint(ckpt, params)
        jax_netcfg(ckpt, netcfg)
        np.savez(npz, **{k: np.asarray(v, np.float32)
                         for k, v in flatten_params(jax.device_get(params)).items()})
        save_net_config(npz, netcfg)
        jax_ckpts.append(ckpt)
        npzs.append(npz)
    out = {}
    for pkg, ckpts in (("jax", jax_ckpts), ("port", npzs)):
        csv_path, json_path = (os.path.join(base, f"{pkg}.{ext}") for ext in ("csv", "json"))
        argv = ["--ckpts", *ckpts, "--names", "plain", "derived", "--test-on-seen",
                "--route-gate", "argmax", "--route-grid", "roundrobin", "--output-csv", csv_path,
                "--route-json", json_path]
        if pkg == "jax":
            JENS.run(JENS.build_parser().parse_args(argv), cfg)
        else:
            TENS.run(TENS.build_parser().parse_args(argv + ["--device", "cpu"]),
                     port_config(cfg))
        with open(json_path) as f:
            out[pkg] = (_read_csv(csv_path), json.load(f))
    (jrows, jroute), (trows, troute) = out["jax"], out["port"]
    assert troute["route"] == jroute["route"]
    assert troute.pop("components").keys() == jroute.pop("components").keys()
    _assert_close_tree(troute, jroute)
    assert trows[0] == jrows[0] and len(trows) == len(jrows) == 1 + 4
    for t, j in zip(trows[1:], jrows[1:]):
        assert t[:3] == j[:3]
        np.testing.assert_allclose(np.asarray(t[3:], float), np.asarray(j[3:], float),
                                   rtol=1e-5, atol=1e-5)
