"""Port parity: viewport geometry (``ops/geometry.py``) and K7's plain
versions, against the JAX package's ``ops/geometry.py``,
``cli/predict.py:chunk_maps`` and ``utils/results.py:_metrics_kernel``.

* occupancy of every integer pixel of the 2560 x 1440 frame, and of
  normalized positions on and beside every tile boundary and FoV edge
  (the wrap cases included): maps bit-equal;
* ``wrap_position`` on values below 0 and above 1 (truncation toward
  zero): bit-equal;
* ``periodic_mse``, ``iou_accuracy`` and ``tile_metrics``, and K7's two
  wrappers given CPU tensors: maps bit-equal, floats within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mansy_immersivevideostreaming_tpu.cli.predict import chunk_maps as jax_chunk_maps
from mansy_immersivevideostreaming_tpu.ops import geometry as JG
from mansy_immersivevideostreaming_tpu.utils.results import _metrics_kernel as jax_metrics
from mansy_immersivevideostreaming_torch.kernels import tile_occupancy as K7
from mansy_immersivevideostreaming_torch.ops import geometry as TG

W, H, TS_W, TS_H = 2560, 1440, 320, 180


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


_jax_occupancy = jax.jit(jax.vmap(JG.tile_occupancy))
_jax_from_normalized = jax.jit(JG.batched_tile_occupancy)


def test_tile_occupancy_on_every_pixel_of_the_frame():
    xs = np.arange(W + 1, dtype=np.int32)
    for y0 in range(0, H + 1, 96):
        ys = np.arange(y0, min(y0 + 96, H + 1), dtype=np.int32)
        x, y = (a.reshape(-1) for a in np.meshgrid(xs, ys))
        want = np.asarray(_jax_occupancy(jnp.asarray(x), jnp.asarray(y)))
        got = TG.tile_occupancy(torch.as_tensor(x), torch.as_tensor(y))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)


def _boundary_values(size: int, tile: int, half_fov: int) -> np.ndarray:
    """Normalized coordinates on and one pixel (and one f32 ulp) beside every
    tile edge and every position where the FoV's edge meets a tile edge or
    the frame's (the wrap cases)."""
    edges = np.arange(0, size + 1, tile)
    px = np.unique(np.concatenate([edges, edges - half_fov, edges + half_fov]))
    px = px[(px >= 0) & (px <= size)]
    px = np.unique(np.concatenate([px - 1, px, px + 1]))
    px = px[(px >= 0) & (px <= size)]
    v = (px / size).astype(np.float32)
    return np.unique(np.concatenate([v, np.nextafter(v, np.float32(-1)),
                                     np.nextafter(v, np.float32(2))]).astype(np.float32))


def test_tile_occupancy_from_normalized_on_tile_boundaries():
    vx = _boundary_values(W, TS_W, 300)
    vy = _boundary_values(H, TS_H, 150)
    x, y = (a.reshape(-1) for a in np.meshgrid(vx, vy))
    pos = np.stack([x, y], -1).astype(np.float32)
    want = np.asarray(_jax_from_normalized(jnp.asarray(pos)))
    got = TG.tile_occupancy_from_normalized(torch.as_tensor(pos))
    np.testing.assert_array_equal(got.numpy(), want)
    # the pixel truncation itself
    px, py = TG.pixels(torch.as_tensor(pos))
    np.testing.assert_array_equal(px.numpy(), np.asarray((jnp.asarray(x) * W).astype(jnp.int32)))
    np.testing.assert_array_equal(py.numpy(), np.asarray((jnp.asarray(y) * H).astype(jnp.int32)))


def test_wrap_position_below_zero_and_above_one():
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.uniform(-3.0, 4.0, 4000),
                        [-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5, 2.0, 3.0, -1e-7, 1 + 1e-7]])
    v = v.astype(np.float32)
    want = np.asarray(JG.wrap_position(jnp.asarray(v)))
    got = TG.wrap_position(torch.as_tensor(v)).numpy()
    np.testing.assert_array_equal(got, want)


def test_periodic_mse_iou_and_tile_metrics():
    rng = np.random.default_rng(1)
    a = rng.uniform(-0.2, 1.2, (64, 15, 2)).astype(np.float32)
    b = rng.uniform(0.0, 1.0, (64, 15, 2)).astype(np.float32)
    np.testing.assert_allclose(TG.periodic_mse(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
                               np.asarray(JG.periodic_mse(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6, atol=1e-6)
    g = (rng.random((500, 64)) < 0.3).astype(np.uint8)
    p = (rng.random((500, 64)) < 0.3).astype(np.uint8)
    g[0], p[0] = 0, 0   # empty maps: 0/0 everywhere
    g[1], p[1] = np.arange(64) < 32, np.arange(64) >= 32  # recall + precision == 0 -> f1 = 0
    gi, pi = g.astype(np.int32), p.astype(np.int32)
    np.testing.assert_allclose(
        TG.iou_accuracy(torch.as_tensor(gi), torch.as_tensor(pi)).numpy(),
        np.asarray(JG.iou_accuracy(jnp.asarray(gi), jnp.asarray(pi))), rtol=1e-6, atol=1e-6)
    for got, want in zip(TG.tile_metrics(torch.as_tensor(gi), torch.as_tensor(pi)),
                         JG.tile_metrics(jnp.asarray(gi), jnp.asarray(pi))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert float(TG.tile_metrics(torch.as_tensor(gi), torch.as_tensor(pi))[3][1]) == 0.0


def trajectories(rng, B: int, F: int) -> np.ndarray:
    """[B, F, 2] positions: uniform ones, ones on tile boundaries and FoV
    edges (the wrap cases), and the frame's corners."""
    pos = rng.uniform(0.0, 1.0, (B, F, 2)).astype(np.float32)
    edge = np.stack([rng.choice(_boundary_values(W, TS_W, 300), (B, F)),
                     rng.choice(_boundary_values(H, TS_H, 150), (B, F))], -1)
    pick = rng.random((B, F, 1)) < 0.5
    pos = np.where(pick, edge, pos).astype(np.float32)
    pos[0, :2] = [[0.0, 0.0], [1.0, 1.0]]
    return pos


@pytest.mark.parametrize("frequency", [1, 5, 15])
def test_chunk_maps_matches_jax(frequency):
    rng = np.random.default_rng(frequency)
    gt, pred = trajectories(rng, 96, 15), trajectories(rng, 96, 15)
    want = jax_chunk_maps(jnp.asarray(gt), jnp.asarray(pred), frequency)
    got = K7.chunk_maps(torch.as_tensor(gt), torch.as_tensor(pred), frequency)
    assert got[0].dtype == torch.uint8 and got[0].shape == (96, 64)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-6, atol=1e-6)


def test_trajectory_metrics_matches_jax():
    rng = np.random.default_rng(7)
    gt, pred = trajectories(rng, 128, 15), trajectories(rng, 128, 15)
    want = jax_metrics(jnp.asarray(gt), jnp.asarray(pred))
    got = K7.trajectory_metrics(torch.as_tensor(gt), torch.as_tensor(pred))
    assert len(got) == 5
    for g, w in zip(got, want):
        assert g.shape == (128, 15)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
