"""QoE model as pure functions over explicit state.

Port of ``mansy_immersivevideostreaming_tpu/ops/qoe.py`` (reference
``bitrate_selection/utils/qoe.py:10-60``).  QoE of a downloaded chunk is
``w1*quality - w2*rebuffer - w3*variance`` where

* quality = viewport-weighted mean tile quality / max rate,
* variance = intra (viewport-weighted mean abs deviation, normalized)
             + inter (|quality_t - quality_{t-1}|),
* rebuffer = rebuffering seconds of this chunk.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

# Scale constants; reference ``qoe.py:5-7``.
SCALE_QUALITY = 1.0
SCALE_VARIANCE = 1.0
SCALE_REBUFFER = 1.0


class QoEState(NamedTuple):
    """Carry state of the sequential QoE model (reference ``qoe.py:19-28``)."""
    prev_quality: torch.Tensor  # f32 [...] (normalized viewport quality)
    has_prev: torch.Tensor      # bool [...]


def init_qoe_state(batch_shape: Tuple[int, ...] = (),
                   device: torch.device | str = "cpu") -> QoEState:
    return QoEState(prev_quality=torch.zeros(batch_shape, dtype=torch.float32, device=device),
                    has_prev=torch.zeros(batch_shape, dtype=torch.bool, device=device))


def qoe_step(state: QoEState, weights: torch.Tensor, actual_viewport: torch.Tensor,
             tile_quality: torch.Tensor, rebuffer_time: torch.Tensor,
             max_rate: float = 35.0):
    """One chunk's QoE (reference ``QoEModel.calculate_qoe``, ``qoe.py:22-34``).

    weights: [..., 3]; actual_viewport/tile_quality: [..., T];
    rebuffer_time: [...].  Returns (new_state, qoe, qoe1, qoe2, qoe3).
    """
    vp = actual_viewport.to(torch.float32)
    vp_sum = vp.sum(-1)
    quality_raw = (vp * tile_quality).sum(-1) / vp_sum
    intra_raw = (vp * (tile_quality - quality_raw[..., None]).abs()).sum(-1) / vp_sum
    intra = intra_raw / max_rate
    quality = quality_raw / max_rate
    inter = torch.where(state.has_prev, (quality - state.prev_quality).abs(),
                        torch.zeros_like(quality))
    qoe1 = quality * SCALE_QUALITY
    qoe2 = rebuffer_time * SCALE_REBUFFER
    qoe3 = (intra + inter) * SCALE_VARIANCE
    qoe = weights[..., 0] * qoe1 - weights[..., 1] * qoe2 - weights[..., 2] * qoe3
    new_state = QoEState(prev_quality=quality, has_prev=torch.ones_like(state.has_prev))
    return new_state, qoe, qoe1, qoe2, qoe3


def qoe_step_with_given_quality(weights: torch.Tensor, viewport_quality: torch.Tensor,
                                prev_quality: torch.Tensor, has_prev: torch.Tensor,
                                intra_variance: torch.Tensor, rebuffer_time: torch.Tensor,
                                max_rate: float = 35.0):
    """Stateless QoE of the MPC expert (reference
    ``QoEModelExpert.calculate_qoe_with_given_quality``, ``qoe.py:50-60``).

    ``viewport_quality``/``intra_variance`` are unnormalized (raw bitrate
    units).  Returns (qoe, qoe1, qoe2, qoe3, new_prev).
    """
    quality = viewport_quality / max_rate
    intra = intra_variance / max_rate
    inter = torch.where(has_prev, (quality - prev_quality).abs(), torch.zeros_like(quality))
    qoe1 = quality * SCALE_QUALITY
    qoe2 = rebuffer_time * SCALE_REBUFFER
    qoe3 = (intra + inter) * SCALE_VARIANCE
    qoe = weights[..., 0] * qoe1 - weights[..., 1] * qoe2 - weights[..., 2] * qoe3
    return qoe, qoe1, qoe2, qoe3, quality


def normalize_quality(quality: torch.Tensor, max_rate: float = 35.0) -> torch.Tensor:
    """Reference ``common.py:40-42``."""
    return quality / max_rate


def normalize_size(size: torch.Tensor, max_size: float = 500000.0) -> torch.Tensor:
    """Reference ``common.py:45-47``."""
    return size / max_size


def normalize_throughput(throughput: torch.Tensor, max_throughput: float = 5000000.0) -> torch.Tensor:
    """Reference ``common.py:50-52``."""
    return throughput / max_throughput


def normalize_qoe_weight(weight: torch.Tensor) -> torch.Tensor:
    """Reference ``common.py:55-57``."""
    return weight / weight.sum(-1, keepdim=True)
