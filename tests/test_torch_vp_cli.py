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

The refused flags of later slices raise ``NotImplementedError``.
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
from mansy_immersivevideostreaming_torch.models.mtio import ViewportTransformerMTIO
from mansy_immersivevideostreaming_torch.utils.checkpoint import load_mtio_npz_into
from test_torch_mtio import orbax_mtio_to_npz
from test_torch_tables import port_config

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


def compare_results(jax_dir: str, port_dir: str) -> int:
    """Hold each port results.csv / .log / accuracy_result.csv to the JAX
    one.  Returns the rows whose metrics were held exactly."""
    names = results_files(jax_dir)
    assert names and results_files(port_dir) == names
    exact, off = 0, {}
    for name in [n for n in names if n.endswith("_results.csv")]:
        jh, jrows = read_csv(os.path.join(jax_dir, name))
        ph, prows = read_csv(os.path.join(port_dir, name))
        assert ph == jh and prows.shape == jrows.shape and len(jrows) > 0
        np.testing.assert_array_equal(prows[:, :6], jrows[:, :6])   # ids, time, gt
        np.testing.assert_allclose(prows[:, 6:9], jrows[:, 6:9], rtol=RTOL, atol=ATOL)
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


@pytest.mark.parametrize("flag", ["--train", "--resume", "--teacher-forcing", "--bf16",
                                  "--data-parallel"])
def test_run_models_refuses_the_flags_of_later_slices(tmp_path, flag):
    cfg = port_config(build_synthetic_tree(str(tmp_path)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_models.run(run_models.build_parser().parse_args(
            ["--test", flag, "--device", "cpu"] + COMMON), cfg)
