"""The port's viewport CLIs end to end on the synthetic dataset tree (CPU,
d = 16), against the JAX CLIs' outputs.

1. The JAX ``run_models --train --test`` (one epoch) writes its Orbax best
   model and its seen/unseen results.
2. :func:`test_torch_mtio.orbax_mtio_to_npz` writes that model as the
   port's ``<prefix>_best_model.npz`` beside the ``.ckpt``.
3. The port's ``run_models --test --device cpu`` writes ``results.csv``,
   ``.log`` and ``accuracy_result.csv`` for both splits with the JAX files'
   rows and columns: ids, times and gt exact, predictions within atol 2e-5
   (rtol 2e-4), MSE as well, and the tile metrics equal on every step
   where both predictions truncate to the same pixel.  ``--model
   regression`` likewise.
4. The port's ``predict --device cpu`` writes the JAX ``predict``'s set of
   ``video*/user*.pkl``: equal chunks and gt maps, pred maps equal and
   IoU within 1e-6 on every chunk whose steps truncate to the same pixels
   in both packages.

5. The port's ``run_models --train --test --device cpu`` (3 epochs,
   validating every 2) beside the JAX CLI's ``--train --test`` with the
   same flags: the JAX CLI's file set with ``.npz`` in place of each
   ``.ckpt``, the same console lines in the same order (epochs, train,
   valid, checkpoint, best model) at the same valid cadence, a falling
   train loss; the best model's npz applied by the JAX Flax module gives
   the port's ``sample`` outputs (atol 2e-5, rtol 2e-4).
6. ``--resume --resume-path`` continues from the saved step and AdamW state:
   its checkpoint equals one ``train_epoch`` from the restored state on the
   CLI's epoch permutation; ``--teacher-forcing`` trains and writes the
   file set.

``--data-parallel`` on one device: ``run_models --test`` and ``--train``
write the files and stdout of the same run without the flag; over two CUDA
devices ``--train`` plans two ranks.  ``--bf16`` runs
(``tests/test_torch_bf16.py``).
"""

import dataclasses
import glob
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_tree import build_synthetic_tree
from mansy_immersivevideostreaming_tpu.cli import predict as jax_predict
from mansy_immersivevideostreaming_tpu.cli import run_models as jax_run_models
from mansy_immersivevideostreaming_tpu.data.viewport import build_windowed_dataset
from mansy_immersivevideostreaming_tpu.models import ViewportTransformerMTIO as JaxMTIO
from mansy_immersivevideostreaming_tpu.models.vp_train import (
    create_train_state, make_optimizer, sample_step,
)
from mansy_immersivevideostreaming_tpu.utils.checkpoint import restore_checkpoint
from mansy_immersivevideostreaming_torch.cli import predict, run_models
from mansy_immersivevideostreaming_torch.data.prediction import load_prediction_tables
from mansy_immersivevideostreaming_torch.data.viewport import create_datasets
from mansy_immersivevideostreaming_torch.models import vp_train as TV
from mansy_immersivevideostreaming_torch.models.mtio import ViewportTransformerMTIO
from mansy_immersivevideostreaming_torch.parallel import launch
from mansy_immersivevideostreaming_torch.utils.checkpoint import (
    load_mtio_npz_into, load_train_checkpoint,
)
from test_torch_mtio import flax_variables, orbax_mtio_to_npz
from test_torch_tables import port_config
from test_torch_train_cli import assert_same_outputs, cli_outputs

COMMON = ["--hidden-dim", "16", "--block-num", "1", "--his-window", "3", "--fut-window", "5",
          "--trim-head", "5", "--trim-tail", "5", "--sample-step", "2"]
TRAIN = ["--epochs", "1", "--epochs-per-valid", "1", "--bs", "16", "--lr", "1e-3"]
ATOL, RTOL = 2e-5, 2e-4
W, H = 2560, 1440


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The synthetic tree after the JAX ``run_models --train --test``, with
    the best model converted to the port's npz.  Returns (base, JAX config,
    ckpt path, npz path)."""
    base = str(tmp_path_factory.mktemp("vp"))
    cfg = build_synthetic_tree(base)
    stdout = sys.stdout
    try:  # the JAX CLI tees stdout into its console log and leaves it so
        jax_run_models.run(jax_run_models.build_parser().parse_args(
            ["--train", "--test", "--model", "mtio", "--device", "cpu"] + COMMON + TRAIN), cfg)
    finally:
        sys.stdout = stdout
    ckpt, = glob.glob(os.path.join(base, "models", "viewport_prediction", "**",
                                   "*_best_model.ckpt"), recursive=True)
    npz = ckpt[:-len(".ckpt")] + ".npz"
    orbax_mtio_to_npz(ckpt, npz, JaxMTIO(d_model=16, dim_feedforward=16, fut_window=5,
                                         num_encoder_layers=1, num_decoder_layers=1), 3)
    return base, cfg, ckpt, npz


def read_csv(path):
    with open(path) as f:
        header, *rows = f.read().strip().splitlines()
    return header, np.asarray([[float(x) for x in r.split(",")] for r in rows])


def results_files(root: str):
    """The files under ``root`` but the JAX training's console log."""
    return sorted(os.path.relpath(p, root) for p in glob.glob(
        os.path.join(root, "**", "*"), recursive=True)
        if os.path.isfile(p) and not p.endswith("console.log"))


def pixels(v: np.ndarray, size: int) -> np.ndarray:
    return (v.astype(np.float32) * np.float32(size)).astype(np.int32)


def compare_results(jax_dir: str, port_dir: str, atol: float = ATOL, rtol: float = RTOL) -> int:
    """Hold each port results.csv / .log / accuracy_result.csv to the JAX
    one, the predictions and MSE within ``atol`` and ``rtol``.  Returns the
    rows whose metrics were held exactly."""
    names = results_files(jax_dir)
    assert names and results_files(port_dir) == names
    exact, off = 0, {}
    for name in [n for n in names if n.endswith("_results.csv")]:
        jh, jrows = read_csv(os.path.join(jax_dir, name))
        ph, prows = read_csv(os.path.join(port_dir, name))
        assert ph == jh and prows.shape == jrows.shape and len(jrows) > 0
        np.testing.assert_array_equal(prows[:, :6], jrows[:, :6])   # ids, time, gt
        np.testing.assert_allclose(prows[:, 6:9], jrows[:, 6:9], rtol=rtol, atol=atol)
        same = ((pixels(prows[:, 6], W) == pixels(jrows[:, 6], W))
                & (pixels(prows[:, 7], H) == pixels(jrows[:, 7], H)))
        assert same.mean() > 0.99
        np.testing.assert_array_equal(prows[same, 9:], jrows[same, 9:])
        exact += int(same.sum())
        # accuracy points a horizon's mean may move by: 100 / rows a horizon each
        off[name[:-len("results.csv")]] = 100.0 * int((~same).sum()) * 5 / len(jrows)
    for name in [n for n in names if not n.endswith("_results.csv")]:
        jpath, ppath = os.path.join(jax_dir, name), os.path.join(port_dir, name)
        if name.endswith(".log"):
            jl, pl = open(jpath).read().splitlines(), open(ppath).read().splitlines()
            assert len(pl) == len(jl)
            for a, b in zip(pl, jl):   # headers, times and gt exact; the quirk kept
                assert a.split(", pred=")[0] == b.split(", pred=")[0]
                assert a.startswith("#####") or "accuracy=None" in a
        else:
            jh, jrows = read_csv(jpath)
            ph, prows = read_csv(ppath)
            assert name.endswith("accuracy_result.csv") and ph == jh == "timestamp,accuracy"
            np.testing.assert_array_equal(prows[:, 0], jrows[:, 0])
            np.testing.assert_allclose(prows[:, 1], jrows[:, 1], rtol=1e-6,
                                       atol=off[name[:-len("accuracy_result.csv")]] + 1e-4)
    return exact


def port_results(base: str, cfg, model: str) -> str:
    """Run the port's ``run_models --test`` into its own results tree (the
    JAX one's models tree); returns the results dir."""
    pcfg = dataclasses.replace(port_config(cfg), vp_results_dir=os.path.join(
        base, "port_results", "viewport_prediction"))
    run_models.run(run_models.build_parser().parse_args(
        ["--test", "--model", model, "--device", "cpu"] + COMMON + TRAIN), pcfg)
    return pcfg.vp_results_dir


def test_run_models_test_matches_jax(trained):
    base, cfg, _, _ = trained
    port_dir = port_results(base, cfg, "mtio")
    jax_dir = os.path.join(base, "results", "viewport_prediction", "mtio")
    assert compare_results(jax_dir, os.path.join(port_dir, "mtio")) > 0


def test_run_models_regression_matches_jax(trained):
    base, cfg, _, _ = trained
    jax_run_models.run(jax_run_models.build_parser().parse_args(
        ["--test", "--model", "regression", "--device", "cpu"] + COMMON + TRAIN), cfg)
    port_dir = port_results(base, cfg, "regression")
    assert compare_results(os.path.join(base, "results", "viewport_prediction", "regression"),
                           os.path.join(port_dir, "regression")) > 0


def test_predict_matches_jax(trained):
    base, cfg, ckpt, npz = trained
    jax_out = os.path.join(base, "pred_jax")
    port_out = os.path.join(base, "port_viewports", "prediction")
    jax_predict.run(jax_predict.build_parser().parse_args(
        ["--model", "mtio", "--model-path", ckpt, "--bs", "64", "--output-dir", jax_out]
        + COMMON), cfg)
    stats = predict.run(predict.build_parser().parse_args(
        ["--model", "mtio", "--model-path", npz, "--bs", "64", "--output-dir", port_out,
         "--device", "cpu"] + COMMON), port_config(cfg))
    names = results_files(jax_out)
    assert names and results_files(port_out) == names

    # the predictions of both packages, to find the chunks whose pixels agree
    ds = build_windowed_dataset(cfg, "Jin2022", [1, 2], [1, 2, 3], 3, 5, 5, 5, 2)
    assert stats["trajectories"] == len(ds)
    h, c, _, video, user, _ = ds.gather(np.arange(len(ds)))
    jm = JaxMTIO(d_model=16, dim_feedforward=16, fut_window=5, num_encoder_layers=1,
                 num_decoder_layers=1)
    state = restore_checkpoint(ckpt, create_train_state(jm, jax.random.PRNGKey(0), 3,
                                                        make_optimizer(1e-4)))
    jpred = np.asarray(sample_step(jm, state, jnp.asarray(h), jnp.asarray(c)))
    model = ViewportTransformerMTIO(d_model=16, dim_feedforward=16, fut_window=5,
                                    num_encoder_layers=1, num_decoder_layers=1, device="cpu")
    load_mtio_npz_into(model, npz)
    ppred = model.sample(torch.as_tensor(h), torch.as_tensor(c)).numpy()
    np.testing.assert_allclose(ppred, jpred, rtol=RTOL, atol=ATOL)
    freq = cfg.frequency
    agree = ((pixels(ppred[:, :freq, 0], W) == pixels(jpred[:, :freq, 0], W))
             & (pixels(ppred[:, :freq, 1], H) == pixels(jpred[:, :freq, 1], H))).all(1)

    held = 0
    for name in names:
        if not name.endswith(".pkl"):
            continue
        with open(os.path.join(jax_out, name), "rb") as f:
            want = pickle.load(f)
        with open(os.path.join(port_out, name), "rb") as f:
            got = pickle.load(f)
        v, u = (int(s) for s in name.replace("video", "").replace(".pkl", "").split("/user"))
        rows = np.flatnonzero((video == v) & (user == u))
        assert len(got) == len(want) == len(rows)
        for row, (gc, gg, gp, ga), (wc, wg, wp, wa) in zip(rows, got, want):
            assert gc == wc
            np.testing.assert_array_equal(gg, wg)
            if agree[row]:
                np.testing.assert_array_equal(gp, wp)
                np.testing.assert_allclose(ga, wa, rtol=1e-6, atol=1e-6)
                held += 1
    assert held >= 0.99 * len(ds)
    # the export loads through the port's reader
    tables = load_prediction_tables(dataclasses.replace(port_config(cfg), viewport_datasets_dir={
        "Jin2022": os.path.dirname(port_out)}), "Jin2022", [1, 2], [1, 2, 3])
    assert tables.gt.shape[-1] == 64 and np.isfinite(tables.accuracy).all()
    assert (tables.start_chunk == 5 // freq).all()


@pytest.mark.parametrize("flag", ["--data-parallel"])
def test_run_models_refuses_the_flags_of_later_slices(tmp_path, flag, monkeypatch):
    """Over two CUDA devices ``--train --data-parallel`` is the multi-process
    path: the CLI, started by no launcher, plans two ranks, one a device,
    and hands them the run (``parallel.launch.launch_ranks``, a recorder
    here) before anything else runs.  The ranks' runs themselves are held
    by ``tests/test_torch_data_parallel_cli.py``."""
    cfg = port_config(build_synthetic_tree(str(tmp_path)))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    planned = []
    monkeypatch.setattr(launch, "launch_ranks",
                        lambda name, args, config, world: planned.append((name, args, world)))
    args = run_models.build_parser().parse_args(["--train", flag, "--device", "cuda"] + COMMON)
    assert run_models.run(args, cfg) is None
    assert planned == [("run_models", args, 2)]
    assert not os.path.exists(cfg.vp_models_dir)


@pytest.mark.parametrize("mode", ["--test", "--train"])
def test_run_models_data_parallel_on_one_device_runs_as_without_it(trained, tmp_path, capsys,
                                                                   mode):
    """``run_models --data-parallel`` on one device, as JAX runs it there
    (``maybe_mesh`` makes no mesh below two devices; ``--test`` never reads
    the flag): the same npz, console log, results and stdout as the run
    without the flag, same seed; no "Data-parallel over" line.  ``--test``
    reads the converted JAX best model."""
    base, cfg, _, _ = trained
    pcfg = dataclasses.replace(port_config(cfg), vp_results_dir=str(tmp_path / "results"))
    roots = [pcfg.vp_results_dir]
    if mode == "--train":
        pcfg = dataclasses.replace(pcfg, vp_models_dir=str(tmp_path / "models"))
        roots.append(pcfg.vp_models_dir)
    argv = [mode, "--model", "mtio", "--device", "cpu"] + COMMON + TRAIN
    outputs = [cli_outputs(lambda: run_models.run(run_models.build_parser().parse_args(
        argv + flag), pcfg), roots, capsys) for flag in ([], ["--data-parallel"])]
    assert_same_outputs(outputs[1], outputs[0])
    assert "Data-parallel" not in outputs[1]["stdout"]


# ------------------------------------------------------------- training

CADENCE = ["--epochs", "3", "--epochs-per-valid", "2", "--bs", "16", "--lr", "1e-3"]
SMALL_MTIO = dict(d_model=16, dim_feedforward=16, fut_window=5, num_encoder_layers=1,
                  num_decoder_layers=1)


def port_tree(base: str, cfg, name: str):
    """The port's Config with models and results under ``base/name``."""
    return dataclasses.replace(
        port_config(cfg), vp_models_dir=os.path.join(base, name, "models"),
        vp_results_dir=os.path.join(base, name, "results"))


def tree_files(root: str):
    """The files under ``root``; an Orbax ``.ckpt`` directory counts as one
    entry, named as the port's ``.npz`` in its place."""
    names = set()
    for p in glob.glob(os.path.join(root, "**", "*"), recursive=True):
        if os.path.isfile(p):
            parts = os.path.relpath(p, root).split(os.sep)
            for i, part in enumerate(parts):
                if part.endswith(".ckpt"):
                    parts = parts[:i] + [part[:-len(".ckpt")] + ".npz"]
                    break
            names.add("/".join(parts))
    return sorted(names)


def line_kinds(log: str):
    """The console log's lines by their first word, numbers dropped."""
    kinds = []
    for line in open(log).read().splitlines():
        if line.startswith(("Epoch", "Train:", "Valid:", "Checkpoint saved", "Best model",
                            "Training", "Testing", "Load model")):
            kinds.append(line.split(" ")[0] + (" " + line.split(" ")[1] if line.startswith(
                ("Epoch", "Best")) else ""))
    return kinds


def train_losses(log: str):
    return [float(line.split("loss:")[1].split("(")[0])
            for line in open(log).read().splitlines() if line.startswith("Train:")]


@pytest.fixture(scope="module")
def both_trained(tmp_path_factory):
    """The JAX and the port's ``run_models --train --test`` (CADENCE) on one
    synthetic tree.  Returns (base, JAX config, port config)."""
    base = str(tmp_path_factory.mktemp("vp_train"))
    cfg = build_synthetic_tree(base)
    cfg = dataclasses.replace(cfg, vp_models_dir=os.path.join(base, "jax", "models"),
                              vp_results_dir=os.path.join(base, "jax", "results"))
    argv = ["--train", "--test", "--model", "mtio", "--device", "cpu"] + COMMON + CADENCE
    stdout = sys.stdout
    try:  # the JAX CLI tees stdout into its console log and leaves it so
        jax_run_models.run(jax_run_models.build_parser().parse_args(argv), cfg)
    finally:
        sys.stdout = stdout
    pcfg = port_tree(base, cfg, "port")
    run_models.run(run_models.build_parser().parse_args(argv), pcfg)
    return base, cfg, pcfg


def test_run_models_train_writes_the_jax_file_set_and_console(both_trained):
    base, cfg, pcfg = both_trained
    jax_files = tree_files(os.path.join(base, "jax"))
    assert sum(f.endswith(("_checkpoint.npz", "_best_model.npz")) for f in jax_files) == 2
    assert tree_files(os.path.join(base, "port")) == jax_files
    jlog, = glob.glob(os.path.join(base, "jax", "**", "*console.log"), recursive=True)
    plog, = glob.glob(os.path.join(base, "port", "**", "*console.log"), recursive=True)
    assert os.path.relpath(plog, os.path.join(base, "port")) == os.path.relpath(
        jlog, os.path.join(base, "jax"))
    kinds = line_kinds(plog)
    assert kinds == line_kinds(jlog)
    assert kinds.count("Valid:") == len(range(0, 3, 2)) == kinds.count("Checkpoint")
    losses = train_losses(plog)
    assert len(losses) == 3 and all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_trained_best_model_runs_in_the_flax_module(both_trained):
    base, cfg, pcfg = both_trained
    npz, = glob.glob(os.path.join(pcfg.vp_models_dir, "**", "*_best_model.npz"), recursive=True)
    model = ViewportTransformerMTIO(**SMALL_MTIO, device="cpu")
    load_mtio_npz_into(model, npz)
    rng = np.random.default_rng(12)
    h = rng.random((9, 3, 2), dtype=np.float32)
    c = rng.random((9, 1, 2), dtype=np.float32)
    want = JaxMTIO(**SMALL_MTIO).apply(flax_variables(npz), jnp.asarray(h), jnp.asarray(c),
                                       method=JaxMTIO.sample)
    got = model.sample(torch.as_tensor(h), torch.as_tensor(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_run_models_resume_continues_from_the_checkpoint(both_trained):
    """One more epoch from the saved checkpoint: the step and AdamW count go
    on from it, and the weights equal one ``train_epoch`` from the restored
    state on the CLI's first permutation."""
    base, cfg, pcfg = both_trained
    ck, = glob.glob(os.path.join(pcfg.vp_models_dir, "**", "*_checkpoint.npz"), recursive=True)
    args = run_models.build_parser().parse_args(["--model", "mtio", "--device", "cpu"]
                                                + COMMON + CADENCE)
    model = run_models.build_model(args, torch.device("cpu"))
    saved = load_train_checkpoint(ck, model)
    assert saved.step == saved.count > 0
    resumed = port_tree(base, cfg, "resumed")
    run_models.run(run_models.build_parser().parse_args(
        ["--train", "--resume", "--resume-path", ck, "--model", "mtio", "--device", "cpu",
         "--epochs", "1", "--epochs-per-valid", "1", "--bs", "16", "--lr", "1e-3"] + COMMON),
        resumed)
    ck2, = glob.glob(os.path.join(resumed.vp_models_dir, "**", "*_checkpoint.npz"),
                     recursive=True)
    train = create_datasets(pcfg, "Jin2022", 3, 5, include=("train",), trim_head=5,
                            trim_tail=5, step=2, frequency=pcfg.frequency)["train"]
    h, c, f, *_ = train.gather(np.arange(len(train)))
    data = {k: torch.as_tensor(x) for k, x in (("history", h), ("current", c), ("future", f))}
    n_batches = len(train) // 16
    want_state, _ = TV.train_epoch(model, TV.make_optimizer(1e-3), saved, data, 16,
                                   np.random.default_rng(5).permutation(len(train)), 5)
    got_model = run_models.build_model(args, torch.device("cpu"))
    got = load_train_checkpoint(ck2, got_model)
    assert got.step == got.count == saved.step + n_batches == want_state.step
    for a, b in zip(got_model.parameters(), model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(got.mu + got.nu, want_state.mu + want_state.nu):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_run_models_teacher_forcing_trains(tmp_path):
    cfg = build_synthetic_tree(str(tmp_path))
    pcfg = port_tree(str(tmp_path), cfg, "tf")
    run_models.run(run_models.build_parser().parse_args(
        ["--train", "--teacher-forcing", "--model", "mtio", "--device", "cpu"] + COMMON
        + TRAIN), pcfg)
    names = [os.path.basename(p) for p in tree_files(os.path.join(str(tmp_path), "tf"))]
    assert sum(n.endswith(("_checkpoint.npz", "_best_model.npz", "console.log"))
               for n in names) == 3
    log, = glob.glob(os.path.join(str(tmp_path), "tf", "**", "*console.log"), recursive=True)
    assert all(np.isfinite(train_losses(log)))
