"""K6: generalized advantage estimation (wrapper, plain version, launch count).

Replaces the JAX package's ``rl/gae.py:compute_gae`` (``:17-36``), which
matches tianshou's ``compute_episodic_return`` as the reference's PPO runs
it: with auto-resetting lanes a ``done`` step neither bootstraps nor carries
advantage across the episode boundary.

On the H100 the recurrence is bound by device-memory bytes (17 bytes an
element); ``csrc/gae.cu`` walks each lane backwards in one thread, with
coalesced loads across lanes.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from mansy_immersivevideostreaming_torch.kernels import build


def compute_gae_plain(rewards: torch.Tensor, dones: torch.Tensor, values: torch.Tensor,
                      last_values: torch.Tensor, gamma: float, lam: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the JAX scan as a loop over T, in its operation
    order.  rewards/dones/values [T, N]; last_values [N] = V(s_T).  Returns
    (advantages [T, N], returns [T, N] = adv + values)."""
    not_done = 1.0 - dones.to(torch.float32)
    next_values = torch.cat([values[1:], last_values[None]], dim=0)
    adv = torch.empty_like(rewards)
    adv_next = torch.zeros_like(last_values)
    for t in reversed(range(rewards.shape[0])):
        delta = rewards[t] + gamma * next_values[t] * not_done[t] - values[t]
        adv_next = delta + gamma * lam * not_done[t] * adv_next
        adv[t] = adv_next
    return adv, adv + values


class _GaeArgs(ctypes.Structure):
    """Mirror of ``GaeArgs`` in ``csrc/gae.cu``."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "rewards", "dones", "values", "last_values", "adv", "ret")]
        + [("T", ctypes.c_int32), ("N", ctypes.c_int32),
           ("gamma", ctypes.c_float), ("gamma_lam", ctypes.c_float)])


def compute_gae(rewards: torch.Tensor, dones: torch.Tensor, values: torch.Tensor,
                last_values: torch.Tensor, gamma: float, lam: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(advantages, returns) of a [T, N] trajectory.  CPU tensors take
    :func:`compute_gae_plain`; CUDA tensors launch the kernel."""
    dev = rewards.device
    if dev.type == "cpu":
        return compute_gae_plain(rewards, dones, values, last_values, gamma, lam)
    T, N = rewards.shape
    for name, t, dtype, shape in (("rewards", rewards, torch.float32, (T, N)),
                                  ("dones", dones, torch.bool, (T, N)),
                                  ("values", values, torch.float32, (T, N)),
                                  ("last_values", last_values, torch.float32, (N,))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"compute_gae: {name} must be a contiguous {dtype} tensor of "
                             f"shape {shape} on {dev}, got {t.dtype} {tuple(t.shape)}")
    adv = torch.empty_like(rewards)
    ret = torch.empty_like(rewards)
    args = _GaeArgs(rewards=rewards.data_ptr(), dones=dones.data_ptr(),
                    values=values.data_ptr(), last_values=last_values.data_ptr(),
                    adv=adv.data_ptr(), ret=ret.data_ptr(), T=T, N=N, gamma=gamma,
                    gamma_lam=gamma * lam)
    lib = build.load("gae")
    lib.gae_launch.argtypes = [ctypes.POINTER(_GaeArgs), ctypes.c_void_p]
    lib.gae_launch.restype = ctypes.c_int
    err = lib.gae_launch(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"compute_gae kernel launch failed with CUDA error {err}")
    compute_gae.launches += 1
    return adv, ret


compute_gae.launches = 0
