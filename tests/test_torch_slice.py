"""Port parity for the whole slice: deterministic evaluation of v9.

The round-4 flagship policy (dagger_v9) is evaluated with argmax actions
over the cartesian test grid by the JAX package (``rl/runner.evaluate``,
Orbax checkpoint) and by the PyTorch port (plain path on the CPU, committed
npz): same first-done masks, same per-episode records.  The ``--test`` CLIs
of both packages then run on one on-disk dataset tree and must write the
same ``results.csv``.

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
from mansy_immersivevideostreaming_tpu.sim.env import observe_mansy
from mansy_immersivevideostreaming_tpu.sim.tables import synthetic_sim_tables as jax_tables
from mansy_immersivevideostreaming_torch.cli import run_mansy as TCLI
from mansy_immersivevideostreaming_torch.rl import runner as TRun
from mansy_immersivevideostreaming_torch.sim.env import generate_environment_test_samples
from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables
from mansy_immersivevideostreaming_torch.utils.checkpoint import DAGGER_V9_NPZ, load_npz_policy
from test_torch_checkpoint import V9_CKPT, restore_v9
from test_torch_tables import port_config

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


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
    assert len(tlogs) == len(jlogs) == -(-len(samples) // 24)
    assert sum(int(m.sum()) for m in tmasks) == len(samples)
    for tl, jl, tm, jm in zip(tlogs, jlogs, tmasks, jmasks):
        np.testing.assert_array_equal(tm, jm)
        for name in tl._fields:
            a, b = getattr(tl, name).numpy()[tm], np.asarray(getattr(jl, name))[jm]
            if np.issubdtype(b.dtype, np.floating):
                np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=name)
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)


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
