"""Port parity: the preprocessing (``ops/orientation.py`` and the
``preprocess_hmdtrace``, ``preprocess_network`` and ``preprocess_video``
CLIs) against the JAX package on the same inputs.

* Every ``orientation`` function on seeded numpy draws, the poles and the
  degenerate zero vectors included (nan where the JAX package gives nan),
  at 1e-12: both compute in float64 with the same formulas; the sums of
  three products and the square roots may round in another order.
* Wu2017 ``--preprocess`` + the 5 Hz simplify (the raw tree of
  ``tests/test_wu2017_smoke.py``) and Jin2022's preprocess + simplify on a
  synthetic raw tree (27 videos, an incomplete user and user 51 skipped)
  through both CLIs, the port's with ``--device cpu``: the same file set,
  every ``.csv`` and ``.npy`` equal at 1e-6 as read back (the CSVs hold
  ``%.6f``).
* ``preprocess_network``: the simplified ``.log`` text and the pickles of
  the simplify and of ``--scale`` equal.
* ``preprocess_video`` with ``_run_ffmpeg`` stubbed on both sides to write
  each output file at a size seeded by its path: the manifest JSON equal;
  ``main`` exits when ``ffmpeg`` is not on PATH.
* The Wu2017 chain of ``tests/test_wu2017_smoke.py`` through the port: raw
  logs -> preprocess -> simplify -> the port's ``build_windowed_dataset``
  -> one ``vp_train.train_step`` with dropout off and the JAX step's slot
  draws, the loss equal to the JAX chain's at atol 2e-5 / rtol 2e-4 (the
  bound of ``tests/test_torch_vp_train.py``).
"""

import dataclasses
import filecmp
import json
import os
import pickle
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mansy_immersivevideostreaming_tpu.cli import preprocess_hmdtrace as JH
from mansy_immersivevideostreaming_tpu.cli import preprocess_network as JN
from mansy_immersivevideostreaming_tpu.cli import preprocess_video as JVID
from mansy_immersivevideostreaming_tpu.config import default_config
from mansy_immersivevideostreaming_tpu.data.viewport import build_windowed_dataset as jax_windows
from mansy_immersivevideostreaming_tpu.models import mtio as jax_mtio
from mansy_immersivevideostreaming_tpu.models import vp_train as JV
from mansy_immersivevideostreaming_tpu.ops import orientation as JO
from mansy_immersivevideostreaming_torch.cli import preprocess_hmdtrace as TH
from mansy_immersivevideostreaming_torch.cli import preprocess_network as TN
from mansy_immersivevideostreaming_torch.cli import preprocess_video as TVID
from mansy_immersivevideostreaming_torch.data.viewport import build_windowed_dataset
from mansy_immersivevideostreaming_torch.models import vp_train as TV
from mansy_immersivevideostreaming_torch.models.mtio import ViewportTransformerMTIO
from mansy_immersivevideostreaming_torch.ops import orientation as TO
from mansy_immersivevideostreaming_torch.utils.checkpoint import mtio_state_dict_from_flax
from test_torch_tables import port_config
from test_torch_vp_train import _TransformerWithoutDropout, fresh_jit, recording_slots
from test_wu2017_smoke import N_USERS, N_VIDEOS, _write_raw_tree, _wu2017_config

ORIENT_ATOL = 1e-12
FILE_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def same(got, want, atol=ORIENT_ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=0, atol=atol,
                               equal_nan=True)
    assert np.array_equal(np.isnan(got), np.isnan(np.asarray(want, np.float64)))


# ------------------------------------------------------------ orientation

def _vectors(rng, n):
    """Seeded directions and the poles: along +-y (the 0 / 0 projection),
    along +-x and +-z, the zero vector."""
    poles = np.array([[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1], [0, 0, -1],
                      [0, 2.5, 0], [0, 0, 0]], np.float64)
    return np.concatenate([rng.normal(size=(n, 3)), poles])


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return np.concatenate([q, np.eye(4), [[0.5, 0.5, 0.5, 0.5]]])


ORIENTATION_CASES = {
    "quat_rotate": lambda M, rng: M.quat_rotate(_quats(rng, 64), rng.normal(size=3)),
    "extract_direction_dataset1": lambda M, rng: M.extract_direction_dataset1(_quats(rng, 64)),
    "extract_direction_dataset2": lambda M, rng: M.extract_direction_dataset2(
        _quats(rng, 64).astype(np.float32)),
    "degree_distance": lambda M, rng: M.degree_distance(_vectors(rng, 64), rng.normal(size=3)),
    "degree_distance_pole": lambda M, rng: M.degree_distance(_vectors(rng, 16),
                                                             np.zeros(3)),
    "vector_to_ang": lambda M, rng: M.vector_to_ang(_vectors(rng, 64)),
    "ang_to_geoxy": lambda M, rng: M.ang_to_geoxy(rng.uniform(-180, 180, 64),
                                                  rng.uniform(-90, 90, 64), 1440.0, 2560.0),
    "geoy_to_phi": lambda M, rng: M.geoy_to_phi(rng.uniform(0, 1440, 64), 1440.0),
    "pixel_to_ang": lambda M, rng: M.pixel_to_ang(rng.uniform(0, 1440, 64),
                                                  rng.uniform(0, 2560, 64), 1440.0, 2560.0),
    "adjust_pixel_dataset1": lambda M, rng: M.adjust_pixel_dataset1(
        rng.uniform(-100, 1500, 64), rng.uniform(0, 2560, 64), 1440.0, 2560.0),
    "adjust_pixel_dataset2": lambda M, rng: M.adjust_pixel_dataset2(
        rng.uniform(0, 1440, 64), rng.uniform(-100, 2700, 64), 1440.0, 2560.0),
}


@pytest.mark.parametrize("case", sorted(ORIENTATION_CASES))
def test_orientation_matches_jax(case):
    fn = ORIENTATION_CASES[case]
    want, got = fn(JO, np.random.default_rng(7)), fn(TO, np.random.default_rng(7))
    want, got = (want if isinstance(want, tuple) else (want,)), (got if isinstance(got, tuple)
                                                                 else (got,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor)
        same(g, w)
    if case == "vector_to_ang":  # the looking-up pole: theta is nan in both
        assert np.isnan(np.asarray(want[0])).any()


@pytest.mark.parametrize("dataset", [0, 1, 2])
def test_adjust_pixellist_matches_jax(dataset):
    rng = np.random.default_rng(dataset)
    pixels = [tuple(p) for p in rng.uniform(-50, 2600, (20, 2))]
    for pl in (pixels, []):
        want = list(JO.adjust_pixellist_dataset(dataset, pl, 1440.0, 2560.0))
        got = list(TO.adjust_pixellist_dataset(dataset, pl, 1440.0, 2560.0))
        assert len(got) == len(want)
        same(np.array(got).reshape(-1, 2), np.array(want).reshape(-1, 2))


def test_orientation_stays_on_its_input_device():
    v = torch.as_tensor(np.random.default_rng(0).normal(size=(5, 3)))
    theta, phi = TO.vector_to_ang(v)
    assert theta.device == v.device and theta.dtype == torch.float64 and phi.shape == (5,)


# ------------------------------------------------------- preprocess_hmdtrace

def tree_arrays(root: str) -> dict:
    """{relative path: array} of every .csv and .npy under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".npy"):
                out[rel] = np.load(path)
            elif f.endswith(".csv"):
                out[rel] = np.loadtxt(path, delimiter=",", ndmin=2)
    return out


def assert_trees_equal(port_root: str, jax_root: str) -> int:
    got, want = tree_arrays(port_root), tree_arrays(jax_root)
    assert sorted(got) == sorted(want) and want
    for rel in want:
        assert got[rel].shape == want[rel].shape, rel
        assert got[rel].dtype == want[rel].dtype, rel
        np.testing.assert_allclose(got[rel], want[rel], rtol=0, atol=FILE_ATOL, err_msg=rel)
    return len(want)


def _split(cfg, base: str, dataset: str):
    """``cfg`` with ``dataset``'s viewport outputs under ``base``."""
    return dataclasses.replace(cfg, viewport_datasets_dir={
        **cfg.viewport_datasets_dir, dataset: os.path.join(base, dataset, "viewports")})


def test_wu2017_preprocess_and_simplify_match_jax(tmp_path):
    cfg = _wu2017_config(tmp_path)
    _write_raw_tree(cfg)
    jcfg, tcfg = _split(cfg, str(tmp_path / "jax"), "Wu2017"), _split(cfg, str(tmp_path / "port"),
                                                                      "Wu2017")
    JH.preprocess_hmd_trace("Wu2017", jcfg)
    JH.simplify_hmd_trace("Wu2017", jcfg, frequency=5)
    TH.run(TH.build_parser().parse_args(["--dataset", "Wu2017", "--preprocess", "--device",
                                         "cpu"]), port_config(tcfg))
    n = assert_trees_equal(tcfg.viewport_dir("Wu2017"), jcfg.viewport_dir("Wu2017"))
    assert n == N_VIDEOS * N_USERS * 3  # user csv, simple csv and npy


def _write_jin2022_raw(raw_dir: str, rng) -> None:
    """Raw Jin2022 layout: viewports/<user>/<a>_<b>_<video>_<c>.csv with a
    header row and columns (time, pixel x, pixel y); users 1-3 complete,
    user 4 missing a video, user 51 complete (both skipped)."""
    for user in (1, 2, 3, 4, 51):
        udir = os.path.join(raw_dir, "viewports", str(user))
        os.makedirs(udir)
        for video in range(1, 28 if user != 4 else 27):
            n = int(rng.integers(40, 60))
            t = 100.0 + np.cumsum(rng.uniform(0.02, 0.12, n))
            if video % 5 == 0:  # dirty start: the first rows jump ahead
                t[:3] = t[0] + np.array([0.0, 2.5, 2.6])
            rows = np.column_stack([t, rng.uniform(0, 2560, n), rng.uniform(0, 1440, n)])
            np.savetxt(os.path.join(udir, f"u_{user}_{video}_log.csv"), rows, fmt="%.4f",
                       delimiter=",", header="t,x,y", comments="")


def test_jin2022_preprocess_and_simplify_match_jax(tmp_path):
    base = default_config(datasets_base_dir=str(tmp_path))
    cfg = dataclasses.replace(base, raw_datasets_dir={"Jin2022": str(tmp_path / "raw")},
                              user_num={"Jin2022": 3})
    _write_jin2022_raw(str(tmp_path / "raw"), np.random.default_rng(4))
    jcfg, tcfg = _split(cfg, str(tmp_path / "jax"), "Jin2022"), _split(cfg, str(tmp_path / "port"),
                                                                       "Jin2022")
    JH.preprocess_hmd_trace("Jin2022", jcfg)
    JH.simplify_hmd_trace("Jin2022", jcfg, frequency=5)
    TH.run(TH.build_parser().parse_args(["--preprocess", "--device", "cpu"]), port_config(tcfg))
    n = assert_trees_equal(tcfg.viewport_dir("Jin2022"), jcfg.viewport_dir("Jin2022"))
    assert n == 27 * 3 * 3
    assert not os.path.exists(os.path.join(tcfg.viewport_dir("Jin2022"), "video1", "user4.csv"))


# ------------------------------------------------------ preprocess_network

def test_network_simplify_and_scale_match_jax(tmp_path):
    rng = np.random.default_rng(11)
    raw = tmp_path / "raw4g"
    raw.mkdir()
    for name in ("a_trace.log", "b_trace.log"):
        n = int(rng.integers(30, 50))
        with open(raw / name, "w") as f:
            for i in range(n):
                f.write(f"{1500000000 + i} {i * 1000} 51.{i} 4.{i} "
                        f"{int(rng.integers(1e4, 5e6))} {1000 + i}\n")
    (raw / "notes.txt").write_text("not a trace\n")
    trees = {}
    for side in ("jax", "port"):
        cfg = default_config(datasets_base_dir=str(tmp_path / side))
        cfg = dataclasses.replace(cfg, raw_network_datasets_dir={"4G": str(raw)})
        if side == "jax":
            JN.simplify_network_dataset("4G", cfg)
            JN.scale_trace("4G", "a_trace.pkl", 8.0, 2.0, cfg)
        else:
            TN.run(TN.build_parser().parse_args([]), port_config(cfg))
            TN.run(TN.build_parser().parse_args(["--scale", "a_trace.pkl", "--up", "8",
                                                 "--low", "2"]), port_config(cfg))
        trees[side] = cfg.network_dir("4G")
    files = sorted(os.listdir(trees["jax"]))
    assert files == sorted(os.listdir(trees["port"]))
    assert files == ["a_trace.log", "a_trace.pkl", "b_trace.log", "b_trace.pkl",
                     "scaled_up_8.0_low_2.0a_trace.pkl"]
    for name in files:
        path = lambda side: os.path.join(trees[side], name)
        if name.endswith(".log"):
            assert filecmp.cmp(path("port"), path("jax"), shallow=False)
        else:
            with open(path("port"), "rb") as f, open(path("jax"), "rb") as g:
                assert pickle.load(f) == pickle.load(g)


# -------------------------------------------------------- preprocess_video

def _fake_ffmpeg(root: str):
    """An ``_run_ffmpeg`` that writes the command's output file (its last
    argument) at a size seeded by its path below ``root``."""
    def run(cmd):
        out = cmd[-1]
        size = 100 + zlib.crc32(os.path.relpath(out, root).encode()) % 5000
        with open(out, "wb") as f:
            f.write(b"\0" * size)
    return run


def test_video_manifest_matches_jax(tmp_path, monkeypatch):
    manifests = {}
    for side, module in (("jax", JVID), ("port", TVID)):
        root = tmp_path / side
        cfg = default_config(datasets_base_dir=str(root))
        cfg = dataclasses.replace(cfg, raw_datasets_dir={"Jin2022": str(root / "raw")},
                                  video_info={"Jin2022": {1: (3, 64, 32), 2: (2, 128, 64)}},
                                  video_datasets_dir={"Jin2022": str(root / "manifests")})
        monkeypatch.setattr(module, "_run_ffmpeg", _fake_ffmpeg(str(root)))
        for video in (1, 2):
            module.preprocess_video("Jin2022", video, cfg if side == "jax" else port_config(cfg),
                                    workers=3)
            with open(os.path.join(cfg.manifest_dir("Jin2022"), f"video{video}.json")) as f:
                manifests[side, video] = f.read()
    for video in (1, 2):
        assert manifests["port", video] == manifests["jax", video]
        m = json.loads(manifests["port", video])
        assert m["Chunk_Count"] == {1: 3, 2: 2}[video]
        assert len(m["Chunks"]["0"]["size"]) == 5 and len(m["Chunks"]["0"]["size"][0]) == 64


def test_video_main_exits_without_ffmpeg(monkeypatch):
    monkeypatch.setattr(TVID.shutil, "which", lambda name: None)
    with pytest.raises(SystemExit, match="ffmpeg"):
        TVID.main([])


# ---------------------------------------------------- the Wu2017 chain

def test_wu2017_chain_matches_jax(tmp_path):
    """raw -> preprocess -> simplify -> windows -> one MTIO train step
    (d 16, fut 10, dropout off) in both packages: the same windows and the
    same loss."""
    cfg = _wu2017_config(tmp_path)
    _write_raw_tree(cfg)
    jcfg, tcfg = _split(cfg, str(tmp_path / "jax"), "Wu2017"), _split(cfg, str(tmp_path / "port"),
                                                                      "Wu2017")
    JH.preprocess_hmd_trace("Wu2017", jcfg)
    JH.simplify_hmd_trace("Wu2017", jcfg, frequency=5)
    TH.preprocess_hmd_trace("Wu2017", port_config(tcfg), device="cpu")
    TH.simplify_hmd_trace("Wu2017", port_config(tcfg), frequency=5)
    window = dict(videos=list(range(1, N_VIDEOS + 1)), users=list(range(1, N_USERS + 1)),
                  his_window=5, fut_window=10, trim_head=10, trim_tail=10, step=3, frequency=5)
    jds = jax_windows(jcfg, "Wu2017", **window)
    tds = build_windowed_dataset(port_config(tcfg), "Wu2017", **window)
    assert len(tds) == len(jds) > 0
    idx = np.arange(min(len(jds), 16))
    (h, c, f, *_), (th, tc, tf, *_) = jds.gather(idx), tds.gather(idx)
    for a, b in ((th, h), (tc, c), (tf, f)):
        np.testing.assert_allclose(a, b, rtol=0, atol=FILE_ATOL)

    small = dict(d_model=16, dim_feedforward=16, fut_window=10)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mtio, "Transformer", _TransformerWithoutDropout)
        jm = jax_mtio.ViewportTransformerMTIO(**small, dropout=0.0)
        opt = JV.make_optimizer(1e-3)
        st = JV.create_train_state(jm, jax.random.PRNGKey(0), 5, opt)
        batch = {"history": jnp.asarray(h), "current": jnp.asarray(c), "future": jnp.asarray(f)}
        with recording_slots() as slots:
            _, loss = fresh_jit(JV._train_step, jm, opt)(st, batch, jax.random.PRNGKey(1))
            jax.effects_barrier()
    model = ViewportTransformerMTIO(**small, dropout=0.0, transformer_dropout=0.0, device="cpu")
    model.load_state_dict(mtio_state_dict_from_flax(jax.device_get(st.params),
                                                    jax.device_get(st.batch_stats)))
    tbatch = {k: torch.as_tensor(v) for k, v in (("history", th), ("current", tc),
                                                 ("future", tf))}
    _, got = TV.train_step(model, TV.make_optimizer(1e-3), TV.create_train_state(model), tbatch,
                           0, slots["perm"][0], slots["repeat"][0])
    np.testing.assert_allclose(float(got), float(loss), rtol=2e-4, atol=2e-5)
