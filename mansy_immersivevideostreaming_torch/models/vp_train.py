"""Evaluation steps of the viewport-prediction models.

The inference half of the JAX package's ``models/vp_train.py``
(``:100-116``): :func:`sample_step` and :func:`valid_step`.  The JAX steps
apply Flax params and ``batch_stats`` held in a ``VPTrainState``; here the
module holds its parameters and BatchNorm statistics itself, and
:class:`VPState` carries the same two collections in the JAX package's
layout (flat, "/"-keyed numpy arrays), as the ``.npz`` checkpoints hold them
(``utils/checkpoint.py``).  The AdamW train step and epoch come with the
training slice.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple

import numpy as np
import torch

from mansy_immersivevideostreaming_torch.models.mtio import ViewportTransformerMTIO
from mansy_immersivevideostreaming_torch.ops.geometry import periodic_mse


class VPState(NamedTuple):
    """Flax ``params`` and ``batch_stats`` of an MTIO model, flat and
    "/"-keyed (``transformer/distill/BatchNorm_0/mean``, ...)."""
    params: Dict[str, np.ndarray]
    batch_stats: Dict[str, np.ndarray]


def sample_step(model: ViewportTransformerMTIO, history: torch.Tensor,
                current: torch.Tensor) -> torch.Tensor:
    """Batched autoregressive inference (reference ``mtio.py:106-133``)."""
    return model.sample(history, current)


def valid_step(model: ViewportTransformerMTIO, batch: Mapping[str, torch.Tensor]
               ) -> torch.Tensor:
    """Mean periodic MSE of the sampled predictions (reference
    ``run_models.py:52-58``)."""
    pred = model.sample(batch["history"], batch["current"])
    return periodic_mse(pred, batch["future"]).mean()
