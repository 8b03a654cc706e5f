"""The port's data-parallel dry run (``parallel/dryrun.py``, ``mesh.py``)
and its entry file (``entry.py``), on the CPU over Gloo.

* Two ranks equal one: ``python -m
  mansy_immersivevideostreaming_torch.parallel.dryrun --n-devices 2
  --force-cpu`` in one process and in two that meet at a ``file://`` store
  under ``tmp_path`` (no port to collide on under xdist), each worker a
  fresh interpreter that imports no JAX.  Both losses finite; the MTIO and
  PPO losses rtol 1e-5 (the same sums in other orders); the BatchNorm
  statistics atol 1e-6; the PPO parameters atol 1e-6.  The MTIO
  parameters after AdamW's first step: within 2e-6 but for at most 1% of
  them (0.25% here), and every one within 2.5 x lr, Adam's first step
  being lr times the sign of the gradient: where a gradient is 0 in exact
  arithmetic (the key biases, which softmax ignores, and the conv bias the
  BatchNorm mean removes), the two runs' float noise may carry opposite
  signs (as ``tests/test_torch_vp_train.py`` finds against JAX).  The two
  ranks' parameters are the same bits.
* The one-rank MTIO step (``dryrun.mtio_step`` on a one-process mesh)
  against the JAX package's ``vp_train._train_step`` from the same Flax
  parameters, dropout 0, JAX's slot draws passed in: the loss, the
  parameters after AdamW and the batch statistics, with
  ``tests/test_torch_vp_train.py``'s tolerances and helpers.
* ``entry.entry`` gives the MTIO sample at d 128, fut 15 for a batch of 8;
  ``entry.dryrun_multichip`` runs the dry run in one process and two.
* The mesh's pieces without a group: a rank's rows and ``shard_batch``
  (contiguous, the leading axis divisible by the world), the init URL and
  the backend rule; ``launch.wait_ranks`` stops the other ranks and raises
  when one fails.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mansy_immersivevideostreaming_tpu.models import mtio as jax_mtio
from mansy_immersivevideostreaming_tpu.models import vp_train as JV
from mansy_immersivevideostreaming_torch import entry
from mansy_immersivevideostreaming_torch.parallel import dryrun
from mansy_immersivevideostreaming_torch.parallel import launch
from mansy_immersivevideostreaming_torch.parallel.mesh import (
    Mesh, choose_backend, init_method, make_mesh, shard_batch,
)
from mansy_immersivevideostreaming_torch.utils.checkpoint import (
    flatten_params, mtio_flax_from_module,
)
from test_torch_vp_train import (
    _TransformerWithoutDropout, check_params_after_adamw, close, close_tree, fresh_jit,
    jax_step_parts, port_grads, port_model, recording_slots,
)

ROOT = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT_S = 240
N_DEVICES = 2
LOSS_RTOL = 1e-5
STATS_ATOL = 1e-6
PPO_ATOL = 1e-6
MTIO_ATOL = 2e-6
MTIO_LOOSE = 0.01


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def worker_env() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(name, None)
    return env


def run_workers(argvs, timeout=WORKER_TIMEOUT_S):
    """Start one ``python -m`` worker for each argv at once; wait for all of
    them (each within ``timeout``) and fail on any that exits non-zero."""
    procs = [subprocess.Popen([sys.executable, "-m"] + argv, env=worker_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for argv in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


def test_two_rank_dryrun_equals_one_rank(tmp_path):
    module = "mansy_immersivevideostreaming_torch.parallel.dryrun"
    common = [module, "--n-devices", str(N_DEVICES), "--force-cpu"]
    store = (tmp_path / "store").as_uri()
    outs = run_workers([common + ["--out", str(tmp_path / "one")]] + [
        common + ["--coordinator", store, "--num-processes", "2", "--process-id", str(r),
                  "--out", str(tmp_path / "two")] for r in range(2)])
    assert "backend gloo" in outs[1] and "over 2 process(es)" in outs[1]
    one = dict(np.load(tmp_path / "one" / "rank0.npz"))
    two = [dict(np.load(tmp_path / "two" / f"rank{r}.npz")) for r in range(2)]
    assert one.keys() == two[0].keys() == two[1].keys()
    for key in one:
        np.testing.assert_array_equal(two[1][key], two[0][key], err_msg=key)
    for key in ("mtio_loss", "ppo_loss"):
        assert np.isfinite(one[key])
        np.testing.assert_allclose(two[0][key], one[key], rtol=LOSS_RTOL, err_msg=key)
    loose, total = 0, 0
    for key, want in one.items():
        got = two[0][key]
        if "bn." in key:
            np.testing.assert_allclose(got, want, rtol=0, atol=STATS_ATOL, err_msg=key)
        elif key.startswith("ppo/"):
            np.testing.assert_allclose(got, want, rtol=0, atol=PPO_ATOL, err_msg=key)
        elif key.startswith("mtio/"):
            np.testing.assert_allclose(got, want, rtol=0, atol=2.5 * dryrun.MTIO_LR,
                                       err_msg=key)
            loose += int((np.abs(got - want) > MTIO_ATOL).sum())
            total += want.size
    assert total > 30_000 and loose <= MTIO_LOOSE * total, (loose, total)


def test_one_rank_mtio_step_matches_jax_train_step(monkeypatch):
    monkeypatch.setattr(jax_mtio, "Transformer", _TransformerWithoutDropout)
    jm = jax_mtio.ViewportTransformerMTIO(**dryrun.MTIO, dropout=0.0)
    opt = JV.make_optimizer(dryrun.MTIO_LR)
    state = jax.jit(lambda key: JV.create_train_state(jm, key, dryrun.HIS, opt))(
        jax.random.PRNGKey(0))
    batch = dryrun.mtio_batch(N_DEVICES, "cpu")
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    with recording_slots() as slots:
        new, loss = fresh_jit(JV._train_step, jm, opt)(state, jbatch, jax.random.PRNGKey(1))
        _, _, grads = fresh_jit(jax_step_parts, jm)(state, jbatch, jax.random.PRNGKey(1))
        jax.effects_barrier()
    perms, repeat = slots["perm"][0], slots["repeat"][0]
    *_, port = port_grads(port_model(state, dryrun.MTIO, False), batch, perms, repeat)
    model = port_model(state, dryrun.MTIO, False)
    got = dryrun.mtio_step(make_mesh("cpu"), model, batch, perms, repeat)
    assert np.isfinite(got)
    close(torch.tensor(got), loss)
    check_params_after_adamw(model, new.params, flatten_params(jax.device_get(grads)), port)
    close_tree(mtio_flax_from_module(model).batch_stats, new.batch_stats, atol=1e-6, rtol=1e-5)


def test_entry_and_its_dryrun(capsys):
    fn, (history, current) = entry.entry("cpu")
    assert history.shape == (8, 5, 2) and current.shape == (8, 1, 2)
    out = fn(history, current)
    assert out.shape == (8, 15, 2) and torch.isfinite(out).all()
    entry.dryrun_multichip(N_DEVICES, "cpu", hidden_dim=32)
    assert "multi-process OK" in capsys.readouterr().out


def test_rows_shard_batch_and_the_backend_rule(monkeypatch):
    mesh = Mesh(rank=1, world=2, device=torch.device("cpu"))
    assert mesh.sharded and not mesh.is_main and mesh.rows(8) == slice(4, 8)
    with pytest.raises(ValueError, match="does not split"):
        mesh.rows(7)
    x = torch.arange(12).reshape(6, 2)
    got = shard_batch(mesh, {"a": x, "b": (x[:, 0], x[:, 1])})
    np.testing.assert_array_equal(got["a"].numpy(), x[3:].numpy())
    np.testing.assert_array_equal(got["b"][1].numpy(), x[3:, 1].numpy())
    one = make_mesh("cpu")
    assert (one.rank, one.world, one.backend, one.sharded) == (0, 1, None, False)
    assert init_method("localhost:9876") == "tcp://localhost:9876"
    assert init_method("file:///tmp/store") == "file:///tmp/store"
    assert init_method(None) == "env://"
    assert choose_backend(torch.device("cpu"), 1) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert choose_backend(torch.device("cuda", 0), 1) == "nccl"
    assert choose_backend(torch.device("cuda", 0), 2) == "gloo"  # two ranks share the card


def test_a_failing_rank_stops_the_others():
    procs = [subprocess.Popen([sys.executable, "-c", code]) for code in
             ("import time; time.sleep(60)", "import sys; sys.exit(3)")]
    with pytest.raises(RuntimeError, match="rank 1 exited with 3"):
        launch.wait_ranks(procs, timeout_s=30)
    assert procs[0].poll() is not None
