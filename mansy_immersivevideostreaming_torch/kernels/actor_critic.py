"""K3: actor-critic forward with the action head (wrapper, plain version,
launch count).

Replaces the JAX package's ``models/abr_nets.py:_branch``,
``MansyFeatureNet`` and ``MansyActorCritic.__call__`` (``:105-186``, with
the exact ``action_values`` field when ``use_action_values`` or
``av_logit_prior`` is set) plus the action head of
``rl/rollout.py:52-54`` and ``rl/runner.py:123-126``: log_softmax and the
first-index argmax of ``logits + noise`` (Gumbel noise for sampling, none
for the deterministic argmax).

It reads the packed observation buffer of ``kernels/observe.py``.  On the
H100 it is bound by f32 operations (~0.85 MFLOP a lane); ``csrc/
actor_critic.cu`` keeps the [N, 1280] features on chip and runs in full f32
(no TF32, no cuBLAS).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from mansy_immersivevideostreaming_torch.kernels import build

MAX_BRANCHES = 11  # 10, or 11 with the action-value branch
COND_BRANCH_INDEX = 9  # the cond branch, whose features are the residual
HIDDEN = 128  # the kernel's hidden width
MAX_ACTIONS = 15  # the kernel keeps A logits and the value in 16 slots


class ActorCriticWeights(NamedTuple):
    """MansyActorCritic's parameters in the layout the kernel reads (Flax's
    [in, out] kernels).  Branch b maps columns ``branch_off[b]:
    branch_off[b+1]`` of the packed observation to features ``128b:128b+128``
    (block-diagonal, stored compactly by input rows); branch 9 is ``cond``
    and the optional branch 10 reads the action values.  With
    ``av_prior`` != 0 the actor logits get ``av_prior`` times the standardized
    action values at columns ``av_off:av_off+A``."""
    w_branch: torch.Tensor      # [748 or 764, H]
    b_branch: torch.Tensor      # [nb, H]
    w_fc: torch.Tensor          # [nb H, 2 H]: actor_fc | critic_fc
    b_fc: torch.Tensor          # [2 H]
    w_actor_out: torch.Tensor   # [H, A]
    b_actor_out: torch.Tensor   # [A]
    w_critic_out: torch.Tensor  # [H, 1]
    b_critic_out: torch.Tensor  # [1]
    branch_off: Tuple[int, ...]  # nb + 1 column offsets into the packed observation
    av_off: int = -1            # column of the action values (-1: none)
    av_prior: float = 0.0       # the logit prior's beta


TENSOR_FIELDS = ActorCriticWeights._fields[:8]  # the weights; the rest are static


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise, as ``jax.random.gumbel`` draws it: uniforms in
    [tiny, 1) through ``-log(-log(u))``.  ``argmax(logits + noise)`` is then
    a sample of ``softmax(logits)`` (the Gumbel-max rule of
    ``jax.random.categorical``)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def action_head(logits: torch.Tensor, noise: Optional[torch.Tensor]):
    """(action, log_prob): first-index argmax of ``logits + noise`` (of the
    logits alone when ``noise`` is None) and its log-softmax probability."""
    scores = logits if noise is None else logits + noise
    action = scores.argmax(-1)
    log_prob = F.log_softmax(logits, -1).gather(-1, action[:, None])[:, 0]
    return action.to(torch.int32), log_prob


def actor_critic_forward_plain(w: ActorCriticWeights, x: torch.Tensor,
                               noise: Optional[torch.Tensor] = None):
    """Plain PyTorch version.  x: [N, >= 748] packed observations.  Returns
    (logits [N, A], value [N], action i32 [N], log_prob [N])."""
    feats = []
    for b in range(len(w.branch_off) - 1):
        lo, hi = w.branch_off[b], w.branch_off[b + 1]
        feats.append(F.leaky_relu(x[:, lo:hi] @ w.w_branch[lo:hi] + w.b_branch[b], 0.01))
    cond = feats[COND_BRANCH_INDEX]
    h = F.leaky_relu(torch.cat(feats, dim=-1) @ w.w_fc + w.b_fc, 0.01)
    H = w.b_branch.shape[1]
    logits = (h[:, :H] + cond) @ w.w_actor_out + w.b_actor_out
    if w.av_prior:
        av = x[:, w.av_off:w.av_off + logits.shape[1]]
        av = (av - av.mean(-1, keepdim=True)) / (av.std(-1, correction=0, keepdim=True) + 1e-6)
        logits = logits + w.av_prior * av
    value = ((h[:, H:] + cond) @ w.w_critic_out + w.b_critic_out)[:, 0]
    action, log_prob = action_head(logits, noise)
    return logits, value, action, log_prob


class _ActorCriticArgs(ctypes.Structure):
    """Mirror of ``ActorCriticArgs`` in ``csrc/actor_critic.cu``."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "x", "w_branch", "b_branch", "w_fc", "b_fc", "w_aout", "b_aout", "w_cout",
        "b_cout", "noise", "logits", "value", "action", "log_prob")]
        + [(f, ctypes.c_int32) for f in ("n_lanes", "ldx", "A", "num_branches")]
        + [("branch_off", ctypes.c_int32 * (MAX_BRANCHES + 1)), ("av_off", ctypes.c_int32),
           ("av_prior", ctypes.c_float)])


def actor_critic_forward(w: ActorCriticWeights, x: torch.Tensor,
                         noise: Optional[torch.Tensor] = None):
    """Policy forward and action head over the packed observations ``x``.
    CPU tensors take :func:`actor_critic_forward_plain`; CUDA tensors launch
    the kernel.  Returns (logits, value, action i32, log_prob)."""
    dev = x.device
    if dev.type == "cpu":
        return actor_critic_forward_plain(w, x, noise)
    N = x.shape[0]
    A = w.w_actor_out.shape[1]
    nb = len(w.branch_off) - 1
    if nb not in (MAX_BRANCHES - 1, MAX_BRANCHES) or w.b_branch.shape != (nb, HIDDEN) \
            or A > MAX_ACTIONS or x.shape[1] < w.branch_off[-1] \
            or (w.av_prior and not 0 <= w.av_off <= x.shape[1] - A):
        raise ValueError(f"actor_critic kernel needs 10 or 11 branches of hidden {HIDDEN}, "
                         f"<= {MAX_ACTIONS} actions, {w.branch_off[-1]} observation columns "
                         f"and the prior's action values inside them")
    tensors = {"x": x, "w_branch": w.w_branch, "b_branch": w.b_branch, "w_fc": w.w_fc,
               "b_fc": w.b_fc, "w_aout": w.w_actor_out, "b_aout": w.b_actor_out,
               "w_cout": w.w_critic_out, "b_cout": w.b_critic_out}
    if noise is not None:
        tensors["noise"] = noise
        if noise.shape != (N, A):
            raise ValueError(f"actor_critic: noise must be [{N}, {A}], got {tuple(noise.shape)}")
    for name, t in tensors.items():
        contiguous = t.stride(-1) == 1 if name == "x" else t.is_contiguous()
        if t.device != dev or t.dtype != torch.float32 or not contiguous:
            raise ValueError(f"actor_critic: {name} must be a contiguous f32 tensor on {dev}")
    logits = torch.empty((N, A), dtype=torch.float32, device=dev)
    value = torch.empty(N, dtype=torch.float32, device=dev)
    action = torch.empty(N, dtype=torch.int32, device=dev)
    log_prob = torch.empty(N, dtype=torch.float32, device=dev)
    args = _ActorCriticArgs(
        **{k: t.data_ptr() for k, t in tensors.items()},
        logits=logits.data_ptr(), value=value.data_ptr(), action=action.data_ptr(),
        log_prob=log_prob.data_ptr(), n_lanes=N, ldx=x.stride(0), A=A, num_branches=nb,
        branch_off=(ctypes.c_int32 * (MAX_BRANCHES + 1))(*w.branch_off),
        av_off=max(w.av_off, 0), av_prior=float(w.av_prior))
    lib = build.load("actor_critic")
    lib.actor_critic_launch.argtypes = [ctypes.POINTER(_ActorCriticArgs), ctypes.c_void_p]
    lib.actor_critic_launch.restype = ctypes.c_int
    err = lib.actor_critic_launch(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"actor_critic kernel launch failed with CUDA error {err}")
    actor_critic_forward.launches += 1
    return logits, value, action, log_prob


actor_critic_forward.launches = 0
