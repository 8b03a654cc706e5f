"""Shared RL data types."""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch


class Transition(NamedTuple):
    """One step of every env lane; stacked [T, N, ...] by the collector."""
    obs: Dict[str, torch.Tensor]
    action: torch.Tensor    # i32 [T, N]
    log_prob: torch.Tensor  # f32 [T, N]
    value: torch.Tensor     # f32 [T, N]
    reward: torch.Tensor    # f32 [T, N]
    done: torch.Tensor      # bool [T, N]
