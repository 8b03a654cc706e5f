"""Linear-regression viewport baseline as a closed-form batched solve.

Port of the JAX package's ``models/regression.py`` (``:15-33``; reference
``viewport_prediction/models/linear_regression.py:16-33``, one sklearn fit
per sample and axis): per-axis 1-D ordinary least squares with intercept
over (history ++ current), extrapolated ``fut_window`` steps.
"""

from __future__ import annotations

import torch


def linear_regression_sample(history: torch.Tensor, current: torch.Tensor,
                             fut_window: int) -> torch.Tensor:
    """history [B, M, 2], current [B, 1, 2] -> [B, F, 2] on the x-grid
    arange(M + 1), predicted at arange(M + 1, M + 1 + F)."""
    merge = torch.cat([history, current], dim=1)  # [B, P, 2]
    P = merge.shape[1]
    t = torch.arange(P, dtype=merge.dtype, device=merge.device)
    t_mean = t.mean()
    t_center = t - t_mean
    var_t = (t_center * t_center).sum()
    y_mean = merge.mean(1, keepdim=True)
    slope = torch.einsum("p,bpc->bc", t_center, merge - y_mean) / var_t
    intercept = y_mean[:, 0] - slope * t_mean
    t_fut = torch.arange(P, P + fut_window, dtype=merge.dtype, device=merge.device)
    return intercept[:, None, :] + slope[:, None, :] * t_fut[None, :, None]
