"""The routed ensemble in the port (``cli/run_ensemble.py``) against the JAX
package's, on the CPU.

* ``route_table`` and ``route_table_gated`` give JAX's routes and gate
  evidence on ``tests/test_ensemble.py``'s inputs and on random ones (the
  same numpy arithmetic: equal to the bit);
* ``per_sample_qoe`` gives JAX's values on the same evaluation logs, and
  raises where a lane finished no episode (JAX's ``argmax`` reads row 0
  there);
* the committed v7 and v21.last npz equal their Orbax checkpoints bit for
  bit, with copies of their sidecars; a deterministic v7 evaluation on
  ``synthetic_sim_tables`` gives the JAX package's records (ints exact,
  floats 1e-5, as ``test_torch_slice.py``);
* the port's ``run_ensemble`` beside the JAX CLI on the synthetic tree with
  two hidden-16 components (Flax init, saved as Orbax ``.ckpt`` for JAX and
  npz for the port) under ``argmax/roundrobin`` and ``sig/full``: the same
  route, and ``results.csv`` and ``route.json`` equal (ints and names
  exactly, floats 1e-5 relative and absolute; the CSV holds values rounded
  to 5 digits).  A gated route could flip only where |edge - z se| < 1e-5;
  the test reports that margin and holds the routes equal.

Regenerate the npz files with::

    JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests'); \
        import test_torch_ensemble as t; t.write_v7_npz(); t.write_v21_last_npz()"
"""

import csv
import functools
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
from mansy_immersivevideostreaming_tpu.models.abr_nets import MansyActorCritic as JaxAC
from mansy_immersivevideostreaming_tpu.rl import runner as JRun
from mansy_immersivevideostreaming_tpu.sim.env import observe_mansy
from mansy_immersivevideostreaming_tpu.sim.tables import synthetic_sim_tables as jax_tables
from mansy_immersivevideostreaming_tpu.utils.checkpoint import save_checkpoint
from mansy_immersivevideostreaming_tpu.utils.checkpoint import save_net_config as jax_netcfg
from mansy_immersivevideostreaming_torch.cli import run_ensemble as TENS
from mansy_immersivevideostreaming_torch.rl import runner as TRun
from mansy_immersivevideostreaming_torch.sim.env import generate_environment_test_samples
from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables
from mansy_immersivevideostreaming_torch.utils.checkpoint import (
    DAGGER_V7_NPZ, DAGGER_V21_LAST_NPZ, NET_CONFIG_SUFFIX, flatten_params, load_net_config,
    load_npz_policy, save_net_config,
)
from synthetic_tree import build_synthetic_tree
from test_torch_checkpoint import REPO, V7_CKPT, restore_params
from test_torch_slice import _assert_same_evaluation
from test_torch_tables import port_config

V21_LAST_CKPT = os.path.join(REPO, "artifacts", "round5", "dagger_v21.ckpt.last")
COMMITTED = {"v7": (V7_CKPT, DAGGER_V7_NPZ), "v21_last": (V21_LAST_CKPT, DAGGER_V21_LAST_NPZ)}
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def restore(name: str) -> dict:
    """A committed policy's Flax params, restored with the JAX package's own
    restore (once a process; callers do not modify them)."""
    return restore_params(COMMITTED[name][0])


def _write_npz(name: str) -> None:
    ckpt, path = COMMITTED[name]
    flat = flatten_params(jax.device_get(restore(name)))
    np.savez(path, **{k: np.asarray(v, np.float32) for k, v in flat.items()})
    shutil.copyfile(ckpt + NET_CONFIG_SUFFIX, f"{path}{NET_CONFIG_SUFFIX}")


def write_v7_npz() -> None:
    """Write the v7 params as a flat ``/``-keyed npz plus its netcfg copy."""
    _write_npz("v7")


def write_v21_last_npz() -> None:
    """Write the v21.last params as a flat ``/``-keyed npz plus its netcfg copy."""
    _write_npz("v21_last")


# ------------------------------------------------------------------ routing

def _gated_inputs(seed: int):
    """``tests/test_ensemble.py``'s gate construction (a decisive edge, an
    edge buried in paired noise, a worse candidate) at its seed 0, and
    random paired scores at other seeds."""
    rng = np.random.default_rng(seed)
    n = 200
    qids = np.repeat([0, 1, 2], n)
    base = rng.normal(0.0, 0.1, size=3 * n)
    if seed == 0:
        comp = base.copy()
        comp[:n] += 0.05 + rng.normal(0, 0.01, n)
        comp[n:2 * n] += 0.01 + 0.2 * np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
        comp[2 * n:] -= 0.05
        return [base, comp], qids
    comps = [base] + [base + rng.normal(rng.normal(0, 0.02), 0.05, size=3 * n)
                      for _ in range(2)]
    return comps, qids


@pytest.mark.parametrize("scores", [
    [[0.1, 0.5, -0.2, 0.0], [0.3, 0.5, -0.4, 0.0]],
    [[0.0, 0.0], [0.0, 1e-13], [-1.0, 2.0]],
    np.random.default_rng(3).normal(size=(4, 4)).tolist()])
def test_route_table_matches_jax(scores):
    assert TENS.route_table(scores) == JENS.route_table(scores)
    if scores[0] == [0.1, 0.5, -0.2, 0.0]:
        assert TENS.route_table(scores) == [1, 0, 0, 0]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("z", [2.0, 0.5])
def test_route_table_gated_matches_jax(seed, z):
    per_sample, qids = _gated_inputs(seed)
    route, evidence = TENS.route_table_gated(per_sample, qids, z=z)
    want_route, want_evidence = JENS.route_table_gated(per_sample, qids, z=z)
    assert route == want_route
    assert evidence == want_evidence
    if seed == 0 and z == 2.0:
        assert route == [1, 0, 0]


def _v9_evaluation():
    """The port's deterministic v9 evaluation logs on a small grid (CPU)."""
    dims = (2, 3, 2, 16, 4)
    samples = generate_environment_test_samples(2, 3, 2, 4)
    return TRun.evaluate(load_npz_policy(device="cpu"),
                         synthetic_sim_tables(*dims, seed=2, device="cpu"),
                         torch.as_tensor(samples), lane_chunk=20, deterministic=True)


def test_per_sample_qoe_matches_jax():
    logs, masks = _v9_evaluation()
    got = TENS.per_sample_qoe(logs, masks)
    np.testing.assert_array_equal(got, JENS.per_sample_qoe(logs, masks))
    assert got.shape == (48,)
    assert TENS.per_pref_qoe(logs, masks) == JENS.per_pref_qoe(logs, masks)


def test_per_sample_qoe_raises_on_a_lane_with_no_finished_episode():
    logs, masks = _v9_evaluation()
    masks = [m.copy() for m in masks]
    masks[1][:, 3] = False
    # JAX's argmax over the all-False column reads row 0 without a word
    assert np.isfinite(JENS.per_sample_qoe(logs, masks)).all()
    with pytest.raises(ValueError, match="finished no episode"):
        TENS.per_sample_qoe(logs, masks)


# ------------------------------------------------------------ committed npz

@pytest.mark.parametrize("name", list(COMMITTED))
def test_committed_npz_equals_orbax_checkpoint_bitwise(name):
    flat = flatten_params(jax.device_get(restore(name)))
    with np.load(COMMITTED[name][1]) as npz:
        assert sorted(npz.files) == sorted(flat)
        assert len(npz.files) == 28
        for k in npz.files:
            assert npz[k].dtype == np.float32 and npz[k].shape == flat[k].shape, k
            np.testing.assert_array_equal(npz[k], np.asarray(flat[k]), err_msg=k)
        assert npz["feature_net/cond/kernel"].shape[1] == 128


@pytest.mark.parametrize("name", list(COMMITTED))
def test_committed_netcfg_matches_checkpoint_sidecar(name):
    ckpt, path = COMMITTED[name]
    with open(ckpt + NET_CONFIG_SUFFIX) as f:
        ref = json.load(f)
    assert load_net_config(path) == ref
    assert ref["hidden_dim"] == 128 and not ref["exact_action_values"]
    assert not ref["obs_action_values"] and ref["av_logit_prior"] == 0.0
    assert load_npz_policy(path, device="cpu").packed_weights().b_branch.shape == (10, 128)


@pytest.mark.parametrize("grid", [(2, 2, 2, 20, 2, 3), (2, 3, 2, 16, 4, 8)])
def test_deterministic_v7_evaluation_matches_jax(grid):
    *dims, seed = grid
    V, U, NT, _, Q = dims
    samples = generate_environment_test_samples(V, U, NT, Q)
    net = JaxAC(hidden_dim=128)
    jlogs, jmasks = JRun.evaluate(lambda p, o: net.apply({"params": p}, o), restore("v7"),
                                  jax_tables(*dims, seed=seed), jnp.asarray(samples),
                                  observe_mansy, jax.random.PRNGKey(0), lane_chunk=24,
                                  deterministic=True)
    tlogs, tmasks = TRun.evaluate(load_npz_policy(DAGGER_V7_NPZ, device="cpu"),
                                  synthetic_sim_tables(*dims, seed=seed, device="cpu"),
                                  torch.as_tensor(samples), lane_chunk=24, deterministic=True)
    _assert_same_evaluation(tlogs, tmasks, jlogs, jmasks, len(samples))


# ---------------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The synthetic tree and two hidden-16 components from Flax's init, each
    as an Orbax checkpoint (JAX) and an npz (port), both with sidecars."""
    base = str(tmp_path_factory.mktemp("ensemble"))
    cfg = build_synthetic_tree(base)
    jax_ckpts, npzs = [], []
    for seed in (0, 1):
        params = JaxAC(hidden_dim=16, action_space=cfg.action_space).init(
            jax.random.PRNGKey(seed), dummy_obs(cfg))["params"]
        ckpt = os.path.join(base, f"comp{seed}.ckpt")
        save_checkpoint(ckpt, params)
        jax_netcfg(ckpt, {"hidden_dim": 16})
        npz = os.path.join(base, f"comp{seed}.npz")
        np.savez(npz, **{k: np.asarray(v, np.float32)
                         for k, v in flatten_params(jax.device_get(params)).items()})
        save_net_config(npz, {"hidden_dim": 16})
        jax_ckpts.append(ckpt)
        npzs.append(npz)
    return base, cfg, jax_ckpts, npzs


def _assert_close_tree(got, want, path=""):
    """Nested JSON values: names, ints and bools exact, floats 1e-5."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_close_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close_tree(g, w, f"{path}/{i}")
    elif isinstance(want, float) and not isinstance(want, bool):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=path)
    else:
        assert got == want, path


def _read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("gate,grid", [("argmax", "roundrobin"), ("sig", "full")])
def test_run_ensemble_matches_the_jax_cli(tree, gate, grid):
    base, cfg, jax_ckpts, npzs = tree
    out = {}
    for pkg, ckpts in (("jax", jax_ckpts), ("port", npzs)):
        csv_path = os.path.join(base, f"{pkg}_{gate}.csv")
        json_path = os.path.join(base, f"{pkg}_{gate}.json")
        argv = ["--ckpts", *ckpts, "--names", "a", "b", "--test-on-seen", "--route-gate", gate,
                "--route-grid", grid, "--output-csv", csv_path, "--route-json", json_path]
        if pkg == "jax":
            JENS.run(JENS.build_parser().parse_args(argv), cfg)
        else:
            TENS.run(TENS.build_parser().parse_args(argv + ["--device", "cpu"]),
                     port_config(cfg))
        with open(json_path) as f:
            out[pkg] = (_read_csv(csv_path), json.load(f))
    (jrows, jroute), (trows, troute) = out["jax"], out["port"]
    assert troute["route"] == jroute["route"]
    if gate == "sig":  # how near a gated route came to flipping
        margin = min(abs(ev["edge"] - 2.0 * ev["se"]) for ev in jroute["gate_evidence"])
        print(f"smallest |edge - z se|: {margin}")
    assert troute.pop("components").keys() == jroute.pop("components").keys()
    _assert_close_tree(troute, jroute)
    assert trows[0] == jrows[0] and len(trows) == len(jrows) == 1 + 4
    for t, j in zip(trows[1:], jrows[1:]):
        assert t[:3] == j[:3]
        np.testing.assert_allclose(np.asarray(t[3:], float), np.asarray(j[3:], float),
                                   rtol=TOL, atol=TOL)
