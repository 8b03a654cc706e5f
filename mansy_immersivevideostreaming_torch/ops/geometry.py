"""Viewport geometry: periodic MSE, torus wrap, FoV -> 8x8 tile occupancy.

Port of the JAX package's ``ops/geometry.py`` (``:29-157``; reference
``viewport_prediction/utils/common.py:37-127`` and ``results.py:21-31``).
The FoV is an axis-aligned box on a torus; its wrapped extent along each
axis is a union of at most two pixel intervals, and the marked tiles are the
outer product of the per-axis covered-tile vectors.  These are the plain
versions behind K7 (``kernels/tile_occupancy.py``), which fuses occupancy,
the chunk OR and the metrics into one pass.
"""

from __future__ import annotations

import torch

FOV_WIDTH = 600
FOV_HEIGHT = 300


def periodic_mse(a: torch.Tensor, b: torch.Tensor, dimension: int = 2) -> torch.Tensor:
    """Per coordinate ``min(|a-b|, |a+1-b|, |a-1-b|)``; the sum of squares over
    the last axis divided by ``dimension`` (``common.py:73-80``)."""
    err = (a - b).abs()
    err = torch.minimum(err, (a + 1.0 - b).abs())
    err = torch.minimum(err, (a - 1.0 - b).abs())
    return (err * err).sum(-1) / dimension


def wrap_position(values: torch.Tensor) -> torch.Tensor:
    """Torus wrap into [0, 1] with truncation toward zero, as the reference's
    ``.to(torch.int)`` (``common.py:61-70``): ``v - trunc(v) + 1`` for v < 0,
    ``v - trunc(v)`` for v > 1."""
    trunc = torch.trunc(values)
    out = torch.where(values < 0, values - trunc + 1.0, values)
    return torch.where(values > 1, values - trunc, out)


def _tile_of_point(p: torch.Tensor, tile_size: int) -> torch.Tensor:
    """Tile holding pixel ``p``; a point on a boundary belongs to the lower
    tile (``common.py:37-43``): ``max(0, ceil(p / ts) - 1)`` with floor
    division."""
    return torch.clamp(torch.div(p + tile_size - 1, tile_size, rounding_mode="floor") - 1,
                       min=0)


def _axis_coverage(lo: torch.Tensor, hi: torch.Tensor, size: int, tile_size: int,
                   num_tiles: int) -> torch.Tensor:
    """[..., num_tiles] coverage of the wrapped pixel interval [lo, hi] on a
    circle of ``size``: [lo, hi], or [0, b] U [a, size] when it wraps."""
    wraps = (lo < 0) | (hi > size)
    i1_lo = torch.where(wraps, torch.zeros_like(lo), lo)
    i1_hi = torch.where(hi > size, hi - size, hi)
    i2_lo = torch.where(lo < 0, lo + size, lo)
    t = torch.arange(num_tiles, device=lo.device)
    last = max(0, (size + tile_size - 1) // tile_size - 1)  # the tile of pixel `size`
    c1 = (t >= _tile_of_point(i1_lo, tile_size)[..., None]) & \
         (t <= _tile_of_point(i1_hi, tile_size)[..., None])
    c2 = wraps[..., None] & (t >= _tile_of_point(i2_lo, tile_size)[..., None]) & (t <= last)
    return c1 | c2


def tile_occupancy(x: torch.Tensor, y: torch.Tensor,
                   video_width: int = 2560, video_height: int = 1440,
                   tile_num_width: int = 8, tile_num_height: int = 8,
                   fov_width: int = FOV_WIDTH, fov_height: int = FOV_HEIGHT) -> torch.Tensor:
    """u8 [..., tile_num_height, tile_num_width]: the tiles a FoV centred at
    integer pixel (x, y) covers (``common.py:46-58``)."""
    x, y = x.to(torch.int32), y.to(torch.int32)
    cov_x = _axis_coverage(x - fov_width // 2, x + fov_width // 2, video_width,
                           video_width // tile_num_width, tile_num_width)
    cov_y = _axis_coverage(y - fov_height // 2, y + fov_height // 2, video_height,
                           video_height // tile_num_height, tile_num_height)
    return (cov_y[..., :, None] & cov_x[..., None, :]).to(torch.uint8)


def pixels(pos: torch.Tensor, video_width: int = 2560, video_height: int = 1440):
    """Integer pixel (x, y) of normalized positions [..., 2]: ``int(v * W)``
    in f32, truncating toward zero (``predict.py:40-44``)."""
    return ((pos[..., 0] * video_width).to(torch.int32),
            (pos[..., 1] * video_height).to(torch.int32))


def tile_occupancy_from_normalized(pos: torch.Tensor,
                                   video_width: int = 2560, video_height: int = 1440,
                                   tile_num_width: int = 8, tile_num_height: int = 8,
                                   fov_width: int = FOV_WIDTH,
                                   fov_height: int = FOV_HEIGHT) -> torch.Tensor:
    """Flattened u8 [..., tile_num_height * tile_num_width] occupancy of
    normalized positions [..., 2]."""
    x, y = pixels(pos, video_width, video_height)
    occ = tile_occupancy(x, y, video_width, video_height, tile_num_width, tile_num_height,
                         fov_width, fov_height)
    return occ.reshape(*occ.shape[:-2], -1)


def iou_accuracy(gt_map: torch.Tensor, pred_map: torch.Tensor) -> torch.Tensor:
    """Tile IoU of two occupancy bitmaps (last axis = tiles)."""
    inter = (gt_map & pred_map).to(torch.float32).sum(-1)
    union = (gt_map | pred_map).to(torch.float32).sum(-1)
    return inter / union


def tile_metrics(gt_map: torch.Tensor, pred_map: torch.Tensor):
    """(accuracy, recall, precision, f1) of occupancy maps, f1 = 0 where
    recall + precision is 0 (``results.py:21-31``)."""
    gt, pred = gt_map.to(torch.float32), pred_map.to(torch.float32)
    tp = (gt * pred).sum(-1)
    union = torch.clamp(gt + pred, 0, 1).sum(-1)
    accuracy = tp / union
    fp = pred.sum(-1) - tp
    fn = gt.sum(-1) - tp
    recall = tp / (tp + fn)
    precision = tp / (tp + fp)
    denom = recall + precision
    f1 = torch.where(denom == 0, torch.zeros_like(denom),
                     2.0 * recall * precision / torch.where(denom == 0, torch.ones_like(denom),
                                                            denom))
    return accuracy, recall, precision, f1
