"""K6: generalized advantage estimation (wrapper, plain version, launch count).

Replaces the JAX package's ``rl/gae.py:compute_gae`` (``:17-36``), which
matches tianshou's ``compute_episodic_return`` as the reference's PPO runs
it: with auto-resetting lanes a ``done`` step neither bootstraps nor carries
advantage across the episode boundary.

On the H100 the recurrence is bound by device-memory bytes (17 bytes an
element).  ``csrc/gae.cu`` walks each lane backwards in one thread, in the
plain version's operation order (bit-equal to it), while three helper
warps of its block bring the block's tile of lanes through shared memory
and store the results (:func:`gae_plan`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from mansy_immersivevideostreaming_torch.kernels import build

LANES = 32   # lanes a block: one walker warp, a lane a thread
CHUNK = 32   # steps a chunk of the shared-memory ring (four chunks: 128 steps in flight)


class GaePlan(NamedTuple):
    """K6's launch: block b walks lanes b * lanes .. b * lanes + lanes - 1
    (those below N), in ``chunks`` chunks of ``chunk`` steps,
    latest first: chunk k holds steps max(T - (k + 1) * chunk, 0) .. T - k *
    chunk - 1."""
    lanes: int
    chunk: int
    chunks: int
    blocks: int


def gae_plan(T: int, N: int) -> GaePlan:
    """Tiles of LANES lanes: 256 blocks at the rollout's 8192 lanes, 4 at
    train's 128."""
    return GaePlan(LANES, CHUNK, -(-T // CHUNK), -(-N // LANES))


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
           ("gamma", ctypes.c_float), ("gamma_lam", ctypes.c_float)]
        + [(f, ctypes.c_int32) for f in ("lanes", "chunk", "blocks", "vec")])


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
    plan = gae_plan(T, N)
    # 16-byte copies and stores need every row of every array 16-byte aligned
    vec = N % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in (rewards, dones, values, adv,
                                                                ret))
    args = _GaeArgs(rewards=rewards.data_ptr(), dones=dones.data_ptr(),
                    values=values.data_ptr(), last_values=last_values.data_ptr(),
                    adv=adv.data_ptr(), ret=ret.data_ptr(), T=T, N=N, gamma=gamma,
                    gamma_lam=gamma * lam, lanes=plan.lanes, chunk=plan.chunk,
                    blocks=plan.blocks, vec=int(vec))
    lib = build.load("gae")
    lib.gae_launch.argtypes = [ctypes.POINTER(_GaeArgs), ctypes.c_void_p]
    lib.gae_launch.restype = ctypes.c_int
    err = lib.gae_launch(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"compute_gae kernel launch failed with CUDA error {err}")
    compute_gae.launches += 1
    return adv, ret


compute_gae.launches = 0
