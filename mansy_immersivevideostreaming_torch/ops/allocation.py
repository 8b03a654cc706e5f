"""Tile bitrate allocation and action codec (batched torch).

Port of ``mansy_immersivevideostreaming_tpu/ops/allocation.py``:

* 15-action <-> (rate_in, rate_out) codec (reference
  ``bitrate_selection/utils/common.py:101-139``), as static lookup tables.
* "Pyramid" allocation (reference ``common.py:142-193``): tiles inside the
  predicted viewport get ``rate_in``; every other tile gets the rate version
  closest to ``video_rates[rate_out] // scale``, where ``scale`` is the
  8-neighbour BFS ring distance on the torus from the viewport set.

These plain versions are the oracle for the fused env-step kernel
(``kernels/env_step.py``), which computes the same scales with bit operations.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

# Action codec tables; reference ``common.py:101-139``.  Index = action id.
ACTION_TO_RATES = np.array(
    [(1, 0), (2, 0), (3, 0), (4, 0), (2, 1), (3, 1), (4, 1), (3, 2), (4, 2),
     (4, 3), (0, 0), (1, 1), (2, 2), (3, 3), (4, 4)], dtype=np.int32)

_RATES_TO_ACTION = np.full((5, 5), 0, dtype=np.int32)
for _a, (_ri, _ro) in enumerate(ACTION_TO_RATES):
    _RATES_TO_ACTION[_ri, _ro] = _a


def action_to_rates(action: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """action id -> (rate_in, rate_out); reference ``common.py:101-119``."""
    pair = torch.as_tensor(ACTION_TO_RATES, device=action.device)[action.long()]
    return pair[..., 0], pair[..., 1]


def rates_to_action(rate_in: torch.Tensor, rate_out: torch.Tensor) -> torch.Tensor:
    """(rate_in, rate_out) -> action id; reference ``common.py:122-139``."""
    table = torch.as_tensor(_RATES_TO_ACTION, device=rate_in.device)
    return table[rate_in.long(), rate_out.long()]


def _closest_rate_version(video_rates: Sequence[int], rate: float) -> int:
    """Closest rate version, ties to the lower bitrate: the first index with
    the minimal gap wins (reference ``find_closest_rate_version``,
    ``common.py:170-180``; rates are ascending)."""
    gaps = [abs(r - rate) for r in video_rates]
    best = 0
    for i, g in enumerate(gaps):
        if g < gaps[best]:
            best = i
    return best


@functools.lru_cache(maxsize=None)
def _scale_rate_table(video_rates: Tuple[int, ...], max_scale: int) -> np.ndarray:
    """Static table [num_rates(out), max_scale+1] -> rate version of an outside
    tile at BFS distance ``scale`` (scale >= 1); column 0 unused.  Reference
    ``common.py:186-190``.  The returned array is shared: do not write to it."""
    n = len(video_rates)
    table = np.zeros((n, max_scale + 1), dtype=np.int32)
    for out in range(n):
        for scale in range(1, max_scale + 1):
            table[out, scale] = _closest_rate_version(video_rates, video_rates[out] // scale)
    return table


def scale_rate_table(video_rates: Sequence[int] = (1, 5, 8, 16, 35),
                     tile_num_width: int = 8, tile_num_height: int = 8) -> np.ndarray:
    """The allocation's scale -> rate-version table for a tiling (a copy)."""
    max_scale = max(tile_num_width // 2, tile_num_height // 2)
    return _scale_rate_table(tuple(int(r) for r in video_rates), max_scale).copy()


def viewport_scales(pred_viewport: torch.Tensor,
                    tile_num_width: int = 8, tile_num_height: int = 8) -> torch.Tensor:
    """BFS ring distance ("scale") of each tile from the viewport set.

    pred_viewport: [..., T] 0/1 map (flattened).  Returns int32 [..., T].
    An empty viewport leaves every scale at 0 (every tile then receives
    rate_in, reference ``common.py:184``).  Computed by separable 3x3 torus
    dilation: ``scale(t) = #{rings r : t not yet covered after r dilations}``.
    """
    h, w = tile_num_height, tile_num_width
    grid = (pred_viewport > 0).reshape(pred_viewport.shape[:-1] + (h, w))
    max_scale = max(h // 2, w // 2)

    def dilate(c):
        d = c | torch.roll(c, 1, dims=-1) | torch.roll(c, -1, dims=-1)
        return d | torch.roll(d, 1, dims=-2) | torch.roll(d, -1, dims=-2)

    covered = grid
    scales = torch.zeros(grid.shape, dtype=torch.int32, device=grid.device)
    for _ in range(max_scale):
        scales = scales + (~covered).to(torch.int32)
        covered = dilate(covered)
    scales = scales.reshape(pred_viewport.shape)
    any_inside = grid.flatten(-2).any(dim=-1, keepdim=True)
    return torch.where(any_inside, scales, torch.zeros_like(scales))


def allocate_tile_rates(rate_in: torch.Tensor, rate_out: torch.Tensor,
                        pred_viewport: torch.Tensor,
                        video_rates: Sequence[int] = (1, 5, 8, 16, 35),
                        tile_num_width: int = 8,
                        tile_num_height: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pyramid allocation; returns (tile_rate_versions, tile_rates), both
    int32 [..., T].  ``rate_in``/``rate_out`` are rate-version indices of
    shape ``pred_viewport.shape[:-1]``.  Reference ``common.py:142-193``."""
    dev = pred_viewport.device
    table = torch.as_tensor(scale_rate_table(video_rates, tile_num_width,
                                             tile_num_height), device=dev)
    rates = torch.as_tensor(np.asarray(video_rates, np.int32), device=dev)
    scales = viewport_scales(pred_viewport, tile_num_width, tile_num_height)
    rate_in = torch.as_tensor(rate_in, device=dev).long()
    rate_out = torch.as_tensor(rate_out, device=dev).long()
    outside = table[rate_out[..., None], scales.long()]
    versions = torch.where(scales == 0, rate_in[..., None].to(torch.int32),
                           outside).to(torch.int32)
    return versions, rates[versions.long()]
