"""Port parity for the whole slice: deterministic evaluation of v9 and v16.

The round-4 flagship policy (dagger_v9) and the action-value policy
(dagger_v16: the exact, accuracy-corrected action values as an 11th branch
and a logit prior of 3.0) are evaluated with argmax actions over the
cartesian test grid by the JAX package (``rl/runner.evaluate``, Orbax
checkpoint) and by the PyTorch port (plain path on the CPU, committed npz):
same first-done masks, same per-episode records.  For v16 each package
attaches its own profiling tables.  The ``--test`` CLIs of both packages
then run on one on-disk dataset tree and must write the same
``results.csv``; with v16 the port reads the expert-table cache the JAX CLI
wrote.

Tolerance: masks, ids and step counts exact; per-episode floats 1e-5
(relative and absolute), from f32 sums in different orders.  The CSV values
are rounded to 5 digits, so a value within 1e-5 may round one digit apart:
they are held to 1.5e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_tree import build_synthetic_tree
from mansy_immersivevideostreaming_tpu.cli import run_mansy as JCLI
from mansy_immersivevideostreaming_tpu.models.abr_nets import MansyActorCritic as JaxAC
from mansy_immersivevideostreaming_tpu.rl import runner as JRun
from mansy_immersivevideostreaming_tpu.sim import expert as JX
from mansy_immersivevideostreaming_tpu.sim.env import observe_mansy
from mansy_immersivevideostreaming_tpu.sim.tables import synthetic_sim_tables as jax_tables
from mansy_immersivevideostreaming_torch.cli import run_mansy as TCLI
from mansy_immersivevideostreaming_torch.rl import runner as TRun
from mansy_immersivevideostreaming_torch.sim import expert as TX
from mansy_immersivevideostreaming_torch.sim.env import generate_environment_test_samples
from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables
from mansy_immersivevideostreaming_torch.utils.checkpoint import (
    DAGGER_V9_NPZ, DAGGER_V16_NPZ, load_npz_policy,
)
from test_torch_action_values import V16_CKPT, restore_v16, v16_net
from test_torch_checkpoint import V9_CKPT, restore_v9
from test_torch_tables import port_config

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _assert_same_evaluation(tlogs, tmasks, jlogs, jmasks, n_samples):
    assert len(tlogs) == len(jlogs) == -(-n_samples // 24)
    assert sum(int(m.sum()) for m in tmasks) == n_samples
    for tl, jl, tm, jm in zip(tlogs, jlogs, tmasks, jmasks):
        np.testing.assert_array_equal(tm, jm)
        for name in tl._fields:
            a, b = getattr(tl, name).numpy()[tm], np.asarray(getattr(jl, name))[jm]
            if np.issubdtype(b.dtype, np.floating):
                np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=name)
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("grid", [(2, 2, 2, 20, 2, 0), (2, 3, 2, 16, 4, 5)])
def test_deterministic_v9_evaluation_matches_jax(grid):
    *dims, seed = grid
    V, U, NT, _, Q = dims
    samples = generate_environment_test_samples(V, U, NT, Q)
    net = JaxAC(hidden_dim=128)
    jlogs, jmasks = JRun.evaluate(lambda p, o: net.apply({"params": p}, o), restore_v9(),
                                  jax_tables(*dims, seed=seed), jnp.asarray(samples),
                                  observe_mansy, jax.random.PRNGKey(0), lane_chunk=24,
                                  deterministic=True)
    tlogs, tmasks = TRun.evaluate(load_npz_policy(device="cpu"),
                                  synthetic_sim_tables(*dims, seed=seed, device="cpu"),
                                  torch.as_tensor(samples), lane_chunk=24, deterministic=True)
    _assert_same_evaluation(tlogs, tmasks, jlogs, jmasks, len(samples))


@pytest.mark.parametrize("grid", [(2, 2, 2, 20, 2, 1), (2, 3, 2, 16, 4, 6)])
def test_deterministic_v16_evaluation_matches_jax(grid):
    """v16 on tables whose predicted viewport misses ~15% of tiles, with the
    accuracy-corrected action-value tables attached, as its sidecar asks."""
    *dims, seed = grid
    V, U, NT, _, Q = dims
    samples = generate_environment_test_samples(V, U, NT, Q)
    jt = jax_tables(*dims, seed=seed)
    gt = np.asarray(jt.gt)
    flip = np.random.default_rng(seed).random(gt.shape) < 0.15
    pred = np.where(flip, 1.0 - gt, gt).astype(np.float32)
    jt = jt._replace(pred=jnp.asarray(pred))
    jt = JX.attach_action_values(jt, JX.build_expert_tables(jt), acc_correct=True)
    tt = synthetic_sim_tables(*dims, seed=seed, device="cpu")._replace(pred=torch.as_tensor(pred))
    policy = load_npz_policy(DAGGER_V16_NPZ, device="cpu")
    assert policy.acc_correct_obs
    tt = TX.attach_action_values(tt, TX.build_expert_tables(tt), acc_correct=True)
    net = v16_net()
    jlogs, jmasks = JRun.evaluate(lambda p, o: net.apply({"params": p}, o), restore_v16(), jt,
                                  jnp.asarray(samples), observe_mansy, jax.random.PRNGKey(0),
                                  lane_chunk=24, deterministic=True)
    tlogs, tmasks = TRun.evaluate(policy, tt, torch.as_tensor(samples), lane_chunk=24,
                                  deterministic=True)
    _assert_same_evaluation(tlogs, tmasks, jlogs, jmasks, len(samples))


def _read_csv(path):
    with open(path) as f:
        header = f.readline()
        rows = sorted(tuple(float(x) for x in line.split(",")) for line in f)
    return header, np.asarray(rows)


def test_run_mansy_test_cli_matches_jax(tmp_path, capsys):
    cfg = build_synthetic_tree(str(tmp_path))
    common = ["--test", "--deterministic-eval", "--qoe-test-ids", "0", "1", "--seed", "5"]
    jargs = JCLI.build_parser().parse_args(common + ["--policy-path", V9_CKPT])
    jargs.qoe_test_ids = [0, 1]
    jdir = tmp_path / "jax_results"
    os.makedirs(jdir)
    JCLI.test(jargs, cfg, str(tmp_path / "models"), str(jdir))
    targs = TCLI.build_parser().parse_args(
        common + ["--policy-path", str(DAGGER_V9_NPZ), "--device", "cpu",
                  "--results-dir", str(tmp_path / "torch_results")])
    tpath = TCLI.run(targs, port_config(cfg))
    jh, jrows = _read_csv(jdir / "results.csv")
    th, trows = _read_csv(tpath)
    assert th == jh and trows.shape == jrows.shape and len(trows) == 2
    np.testing.assert_array_equal(trows[:, :6], jrows[:, :6])
    # the CSV rounds to 5 digits: values 1e-5 apart may round one step apart
    np.testing.assert_allclose(trows[:, 6:], jrows[:, 6:], rtol=0, atol=1.5e-5)
    assert capsys.readouterr().out.count("Tested 2 episodes") == 2


def test_run_mansy_test_cli_with_v16_matches_jax(tmp_path, capsys):
    cfg = build_synthetic_tree(str(tmp_path))
    common = ["--test", "--deterministic-eval", "--qoe-test-ids", "0", "1", "2", "--seed", "5"]
    jargs = JCLI.build_parser().parse_args(common + ["--policy-path", V16_CKPT])
    jdir = tmp_path / "jax_results"
    os.makedirs(jdir)
    JCLI.test(jargs, cfg, str(tmp_path / "models"), str(jdir))
    assert jargs.exact_action_values and jargs.acc_correct  # from the sidecar
    targs = TCLI.build_parser().parse_args(
        common + ["--policy-path", str(DAGGER_V16_NPZ), "--device", "cpu",
                  "--results-dir", str(tmp_path / "torch_results")])
    tpath = TCLI.run(targs, port_config(cfg))
    jh, jrows = _read_csv(jdir / "results.csv")
    th, trows = _read_csv(tpath)
    assert th == jh and trows.shape == jrows.shape and len(trows) == 3
    np.testing.assert_array_equal(trows[:, :6], jrows[:, :6])
    np.testing.assert_allclose(trows[:, 6:], jrows[:, 6:], rtol=0, atol=1.5e-5)
    out = capsys.readouterr().out
    assert out.count("Tested 3 episodes") == 2
    assert "Load expert cache from" in out  # the JAX CLI's cache, read by the port
