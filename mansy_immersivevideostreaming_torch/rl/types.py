"""Shared RL data types."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Transition(NamedTuple):
    """One step of every env lane; stacked [T, N, ...] by the collector.
    ``obs`` is the packed observation buffer [T, N, F] of
    ``kernels/observe.py`` (``unpack_obs`` gives the field dict as views)."""
    obs: torch.Tensor       # f32 [T, N, F]
    action: torch.Tensor    # i32 [T, N]
    log_prob: torch.Tensor  # f32 [T, N]
    value: torch.Tensor     # f32 [T, N]
    reward: torch.Tensor    # f32 [T, N]
    done: torch.Tensor      # bool [T, N]


class RunningStat(NamedTuple):
    """Running mean/var of the returns for their normalization (tianshou's
    ``RunningMeanStd`` as ``reward_normalization=True`` uses it, reference
    ``run_mansy.py:241``): f32 scalars; ``count`` starts at 1e-4 and ``var``
    is the population variance (JAX ``rl/types.py:20-42``)."""
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def init(device: str | torch.device = "cpu") -> "RunningStat":
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return RunningStat(mean=f32(0.0), var=f32(1.0), count=f32(1e-4))

    def update(self, x: torch.Tensor) -> "RunningStat":
        bmean = x.mean()
        bvar = x.var(correction=0)
        bcount = torch.tensor(float(x.numel()), dtype=torch.float32, device=x.device)
        delta = bmean - self.mean
        tot = self.count + bcount
        new_mean = self.mean + delta * bcount / tot
        m2 = self.var * self.count + bvar * bcount + delta * delta * self.count * bcount / tot
        return RunningStat(mean=new_mean, var=m2 / tot, count=tot)
