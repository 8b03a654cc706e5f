"""``--train --data-parallel`` over two ranks against one, on the synthetic
dataset tree (CPU, Gloo).

Each rank is a fresh interpreter, ``python -m
mansy_immersivevideostreaming_torch.parallel.launch <cli> <run.pkl>``,
with RANK and WORLD_SIZE in its environment, as torchrun would start it,
meeting the other at a ``file://`` store under ``tmp_path``; the world-1
run is the same arguments in this process, on one device (where the flag
runs as without it).  The JAX CLIs' own data-parallel test
(``tests/test_data_parallel_cli.py:73-74``) holds its sharded run to
rtol 2e-3, atol 1e-4 against one device; so do these, for:

* ``run_mansy --train --use-identifier --train-identifier``: the console's
  loss terms and valid mean returns, and the TensorBoard scalars.  The
  episode logs (train and valid CSVs) must be the same text: the lanes
  start, draw their noise and act as in the world-1 run, and a
  difference would be a sampled action flipped by float noise in the
  policy's output, which these runs do not come near.  The npz within
  1e-5 (measured: 3e-8; the update's gradients are means in other orders).
* ``run_models --train --model mtio``: the console's train losses and
  valid MSEs.  The npz (best model; checkpoint with AdamW's moments): all
  but 3% of the entries within 1e-5 and every one within 0.01 (measured:
  1.5% beyond 1e-5, at most 8.3e-4): Adam's steps are lr (1e-3) times the
  sign of the gradient where it is near 0, and there the two runs' float
  noise may carry opposite signs, step after step
  (``tests/test_torch_vp_train.py`` finds the same against JAX).

Both runs write the same set of files: rank 0 alone writes.
"""

import dataclasses
import glob
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from synthetic_tree import build_synthetic_tree
from mansy_immersivevideostreaming_torch.cli import run_mansy, run_models
from test_torch_tables import port_config
from test_torch_utils import EVENTS, tb_scalars

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 300
RTOL, ATOL = 2e-3, 1e-4      # tests/test_data_parallel_cli.py:73-74
MANSY_NPZ_ATOL = 1e-5
MTIO_ATOL, MTIO_LOOSE, MTIO_MAX = 1e-5, 0.03, 0.01

MANSY = ["--train", "--data-parallel", "--use-identifier", "--train-identifier",
         "--epochs", "2", "--step-per-epoch", "64", "--step-per-collect", "64",
         "--train-lanes", "8", "--batch-size", "64", "--hidden-dim", "16",
         "--save-interval", "1", "--seed", "7", "--device", "cpu"]
MODELS = ["--train", "--data-parallel", "--model", "mtio", "--hidden-dim", "16",
          "--block-num", "1", "--his-window", "3", "--fut-window", "5",
          "--trim-head", "5", "--trim-tail", "5", "--sample-step", "2",
          "--epochs", "2", "--epochs-per-valid", "1", "--bs", "16",
          "--lr", "1e-3", "--seed", "11", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    return port_config(build_synthetic_tree(str(tmp_path_factory.mktemp("synth_dp"))))


def run_two_ranks(cli: str, args, config, tmp_path) -> list:
    """``cli``'s run over two ranks; returns each rank's output."""
    run_pickle = tmp_path / f"{cli}.pkl"
    with open(run_pickle, "wb") as f:
        pickle.dump((args, config), f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", WORLD_SIZE="2",
               LOCAL_WORLD_SIZE="2", MANSY_DIST_INIT=(tmp_path / f"{cli}.store").as_uri())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mansy_immersivevideostreaming_torch.parallel.launch", cli,
         str(run_pickle)], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}"
    assert "backend gloo" in outs[0]
    return outs


def files(root: str) -> dict:
    """{path under root: path} of every file (an event file by its
    directory: its name holds the clock)."""
    out = {}
    for path in glob.glob(os.path.join(root, "**", "*"), recursive=True):
        if os.path.isfile(path):
            rel = os.path.relpath(path, root)
            out[os.path.join(os.path.dirname(rel), EVENTS) if EVENTS in rel else rel] = path
    return out


def numbers(pattern: str, text: str) -> np.ndarray:
    return np.asarray(re.findall(pattern, text, re.M), float)


def test_run_mansy_two_ranks_equal_one(config, tmp_path):
    roots = {w: dataclasses.replace(config, bs_models_dir=str(tmp_path / f"w{w}" / "models"),
                                    bs_results_dir=str(tmp_path / f"w{w}" / "results"))
             for w in (1, 2)}
    run_mansy.run(run_mansy.build_parser().parse_args(MANSY), roots[1])
    run_two_ranks("run_mansy", run_mansy.build_parser().parse_args(MANSY), roots[2], tmp_path)
    one, two = files(roots[1].bs_models_dir), files(roots[2].bs_models_dir)
    assert one.keys() == two.keys() and len(one) >= 10
    for rel, path in one.items():
        if rel.endswith(".npz"):
            with np.load(path) as want, np.load(two[rel]) as got:
                assert want.files == got.files
                for k in want.files:
                    np.testing.assert_allclose(got[k], want[k], rtol=0, atol=MANSY_NPZ_ATOL,
                                               err_msg=f"{rel}: {k}")
        elif rel.endswith(".csv"):
            assert open(two[rel]).read() == open(path).read(), rel
        elif rel.endswith(EVENTS):
            want, got = tb_scalars(os.path.dirname(path)), tb_scalars(os.path.dirname(two[rel]))
            assert [s[:2] for s in got] == [s[:2] for s in want] and len(want) == 10
            np.testing.assert_allclose([s[2] for s in got], [s[2] for s in want], rtol=RTOL,
                                       atol=ATOL)
    consoles = [open(p[next(k for k in p if k.endswith("console.log"))]).read()
                for p in (one, two)]
    assert "Env lanes sharded over 2 devices" in consoles[1]
    for pattern in (r"valid mean return (-?[0-9.]+)",
                    r"^loss: (\S+)  ---  loss/clip: (\S+)  ---  loss/vf: (\S+)  ---  "
                    r"loss/ent: (\S+)$"):
        want, got = numbers(pattern, consoles[0]), numbers(pattern, consoles[1])
        assert want.shape[0] == 2
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_run_models_two_ranks_equal_one(config, tmp_path):
    roots = {w: dataclasses.replace(config, vp_models_dir=str(tmp_path / f"w{w}" / "models"),
                                    vp_results_dir=str(tmp_path / f"w{w}" / "results"))
             for w in (1, 2)}
    run_models.run(run_models.build_parser().parse_args(MODELS), roots[1])
    run_two_ranks("run_models", run_models.build_parser().parse_args(MODELS), roots[2],
                  tmp_path)
    for attr in ("vp_models_dir", "vp_results_dir"):
        assert files(getattr(roots[1], attr)).keys() == files(getattr(roots[2], attr)).keys()
    one, two = files(roots[1].vp_models_dir), files(roots[2].vp_models_dir)
    assert len(one) == 2
    for rel, path in one.items():
        with np.load(path) as want, np.load(two[rel]) as got:
            assert want.files == got.files
            loose = total = 0
            for k in want.files:
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=MTIO_MAX,
                                           err_msg=f"{rel}: {k}")
                loose += int((np.abs(got[k] - want[k]) > MTIO_ATOL).sum())
                total += want[k].size
            assert loose <= MTIO_LOOSE * total, (rel, loose, total)
    (c1,), (c2,) = (glob.glob(os.path.join(r.vp_results_dir, "**", "*console.log"),
                              recursive=True) for r in (roots[1], roots[2]))
    consoles = [open(c1).read(), open(c2).read()]
    assert "Data-parallel over 2 devices" in consoles[1]
    for pattern in (r"mean train loss:\s*([0-9.eE+-]+)", r"mean square error:\s*([0-9.eE+-]+)"):
        want, got = numbers(pattern, consoles[0]), numbers(pattern, consoles[1])
        assert want.shape == (2,)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
