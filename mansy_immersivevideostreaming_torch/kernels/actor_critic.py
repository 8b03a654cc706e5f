"""K3: actor-critic forward with the action head, its training mode, and
K10: its backward (wrappers, plain versions, launch counts).

Replaces the JAX package's ``models/abr_nets.py:_branch``,
``MansyFeatureNet`` and ``MansyActorCritic.__call__`` (``:105-186``, with
the exact ``action_values`` field when ``use_action_values`` or
``av_logit_prior`` is set) and ``SimpleActorCritic.__call__`` (``:206-231``:
five branches, no cond branch and no residual, ``cond`` = -1) plus the
action head of
``rl/rollout.py:52-54`` and ``rl/runner.py:123-126``: log_softmax and the
first-index argmax of ``logits + noise`` (Gumbel noise for sampling, none
for the deterministic argmax).

It reads the packed observation buffer of ``kernels/observe.py``.  The
kernels take any hidden width H >= 1, as the JAX package's nets do: H runs
in the smallest compiled instance that holds it, of capacity 64, 128, 192
or 256 (:data:`WIDTHS`, :func:`kernel_instance`; the columns past H are
zeros inside the kernel, so the real columns get an unpadded kernel's sums),
or past 256 in a wide variant of 64 x 128 output tiles (``csrc/
actor_critic_wide.cuh``; three launches forward, K10's launch A in two).
On the H100 it is bound by operations (~0.85 MFLOP a lane at width 128);
``csrc/actor_critic.cu`` splits each 32-row tile across a thread-block cluster
whose size follows from N (:func:`cluster_plan`): at 512 rows one CTA a
branch (two for a branch of more than 128 inputs, one each half of them),
at wider N fewer CTAs with whole branches each, down to one CTA a tile at
8192 rows.  It keeps the [N, 1280] features on chip, sums the partial fc
products in a fixed order, and runs its products on the tensor cores in
3xTF32, which keeps f32 accuracy (no plain TF32, no cuBLAS).

Training goes through :func:`actor_critic_train`, a ``torch.autograd.Function``
over the eight packed weight tensors: its forward is K3's training mode
(:func:`actor_critic_train_forward`: no action head, and it saves the branch
and fc activations), its backward K10 (:func:`actor_critic_backward`,
``csrc/actor_critic_backward.cu``), which replaces what ``jax.grad`` derives
from the same network in the JAX package's PPO, BC and DAgger updates.  K10
is bound by operations too (~1.5 MFLOP a row) and runs every product on the
tensor cores in 3xTF32, in two launches whose shapes :func:`backward_plan`
picks from the batch and the card's SM count.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from mansy_immersivevideostreaming_torch.kernels import build, count_launch

MAX_BRANCHES = 11  # 10, or 11 with the action-value branch (5: the simple_rl net)
COND_BRANCH_INDEX = 9  # the MANSY net's cond branch, whose features are the residual
WIDTHS = (64, 128, 192, 256)  # instances' capacities: a width runs in the smallest holding it
WIDE = "wide"  # the variant past the largest instance
WIDE_TILE = (64, 128)  # the wide variant's output tile (rows, columns)
WIDE_STAGE, WIDE_STAGES = 16, 4  # its ring: four 16-deep stages
MAX_ACTIONS = 15  # the kernel keeps A logits and the value in 16 slots
# K10's tiling (csrc/actor_critic_backward.cu): launch A takes 32-row tiles of
# dPre_b, a 128-column block (a branch) at a time; launch B the batch-deep
# products in 32-deep stages.
BACKWARD_ROWS = 32
BACKWARD_STAGE = 32
BACKWARD_SLICES = (1, 2, 4, 8)  # depth slices of an output tile: its cluster's CTAs
SMEM_PER_SM = 228 * 1024        # the H100's shared memory an SM (a block takes at most 227 KB)
BACKWARD_HEAD_BLOCKS = 0.25     # launch A's head, in the time of one column block (an estimate)


class ActorCriticWeights(NamedTuple):
    """MansyActorCritic's or SimpleActorCritic's parameters in the layout the
    kernel reads (Flax's [in, out] kernels).  Branch b maps columns
    ``branch_off[b]:branch_off[b+1]`` of the packed observation to features
    ``Hb:Hb+H`` (block-diagonal, stored compactly by input rows); branch
    ``cond`` (9 in the MANSY net, -1 for none) is the residual added to both
    heads' inputs, and the optional branch 10 reads the action values.  With
    ``av_prior`` != 0 the actor logits get ``av_prior`` times the standardized
    action values at columns ``av_off:av_off+A``."""
    w_branch: torch.Tensor      # [748 or 764 (395: simple), H]
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
    cond: int = COND_BRANCH_INDEX  # the residual's branch, -1 for none


TENSOR_FIELDS = ActorCriticWeights._fields[:8]  # the weights; the rest are static


def kernel_instance(hidden: int):
    """The instance of K3 and K10 that runs hidden width ``hidden``: the
    smallest capacity in :data:`WIDTHS` that holds it, or :data:`WIDE` past
    256 (``csrc/actor_critic.cu:instance_of``)."""
    if hidden < 1:
        raise ValueError(f"actor_critic: hidden width must be >= 1, got {hidden}")
    return next((c for c in WIDTHS if hidden <= c), WIDE)


def launch_mode(w: ActorCriticWeights) -> str:
    """The mode a launch on ``w`` counts in (``launches_by_mode``): the net,
    ``cond`` (the MANSY net) or ``simple`` (no cond branch), and the
    instance its width runs in, e.g. ``cond256`` (widths 193 to 256) or
    ``condwide``."""
    return f"{'cond' if w.cond >= 0 else 'simple'}{kernel_instance(w.b_branch.shape[1])}"


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


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.01) as ``jax.nn.leaky_relu`` writes it, ``where(x >= 0, x,
    0.01 x)``: the values of ``F.leaky_relu``, and under autograd the slope
    1 at x = 0, as JAX's gradient and K10 (from the sign of the output) take
    it (``F.leaky_relu``'s autograd takes 0.01 there, where a zero bias
    meets a zero input)."""
    return torch.where(x >= 0, x, 0.01 * x)


def actor_critic_train_forward_plain(w: ActorCriticWeights, x: torch.Tensor):
    """Plain PyTorch version of the training mode, and the network of every
    plain version: (logits, value, feats [N, nb H], hidden [N, 2H]); feats
    and hidden are the branch and fc outputs after LeakyReLU (hidden before
    the cond residual), what the backward reads."""
    feats = []
    for b in range(len(w.branch_off) - 1):
        lo, hi = w.branch_off[b], w.branch_off[b + 1]
        feats.append(leaky_relu(x[:, lo:hi] @ w.w_branch[lo:hi] + w.b_branch[b]))
    cond = feats[w.cond] if w.cond >= 0 else 0.0
    feats = torch.cat(feats, dim=-1)
    hidden = leaky_relu(feats @ w.w_fc + w.b_fc)
    H = w.b_branch.shape[1]
    logits = (hidden[:, :H] + cond) @ w.w_actor_out + w.b_actor_out
    if w.av_prior:
        av = x[:, w.av_off:w.av_off + logits.shape[1]]
        av = (av - av.mean(-1, keepdim=True)) / (av.std(-1, correction=0, keepdim=True) + 1e-6)
        logits = logits + w.av_prior * av
    value = ((hidden[:, H:] + cond) @ w.w_critic_out + w.b_critic_out)[:, 0]
    return logits, value, feats, hidden


def actor_critic_forward_plain(w: ActorCriticWeights, x: torch.Tensor,
                               noise: Optional[torch.Tensor] = None):
    """Plain PyTorch version.  x: [N, >= 748] packed observations.  Returns
    (logits [N, A], value [N], action i32 [N], log_prob [N])."""
    logits, value, _, _ = actor_critic_train_forward_plain(w, x)
    action, log_prob = action_head(logits, noise)
    return logits, value, action, log_prob


class _ActorCriticArgs(ctypes.Structure):
    """Mirror of ``ActorCriticArgs`` in ``csrc/actor_critic.cu``."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "x", "w_branch", "b_branch", "w_fc", "b_fc", "w_aout", "b_aout", "w_cout",
        "b_cout", "noise", "logits", "value", "action", "log_prob", "feats", "hidden",
        "heads")]
        + [(f, ctypes.c_int32) for f in ("n_lanes", "ldx", "A", "num_branches", "hidden_dim")]
        + [("branch_off", ctypes.c_int32 * (MAX_BRANCHES + 1)), ("av_off", ctypes.c_int32),
           ("av_prior", ctypes.c_float), ("cond", ctypes.c_int32)])


def _weight_tensors(w: ActorCriticWeights, x: torch.Tensor):
    """The kernel's weight pointers by argument name, checked: up to 11
    branches of any hidden width, the cond branch one of them or none,
    contiguous f32 tensors on x's device."""
    A = w.w_actor_out.shape[1]
    nb, H = len(w.branch_off) - 1, w.b_branch.shape[-1]
    if H < 1 or not 1 <= nb <= MAX_BRANCHES or not -1 <= w.cond < nb \
            or w.b_branch.shape != (nb, H) or A > MAX_ACTIONS or x.shape[1] < w.branch_off[-1] \
            or (w.av_prior and not 0 <= w.av_off <= x.shape[1] - A):
        raise ValueError(f"actor_critic kernel needs 1 to {MAX_BRANCHES} branches, a cond "
                         f"branch among them or none, <= {MAX_ACTIONS} actions, "
                         f"{w.branch_off[-1]} observation columns and the prior's action "
                         f"values inside them")
    tensors = {"x": x, "w_branch": w.w_branch, "b_branch": w.b_branch, "w_fc": w.w_fc,
               "b_fc": w.b_fc, "w_aout": w.w_actor_out, "b_aout": w.b_actor_out,
               "w_cout": w.w_critic_out, "b_cout": w.b_critic_out}
    for name, t in tensors.items():
        contiguous = t.stride(-1) == 1 if name == "x" else t.is_contiguous()
        if t.device != x.device or t.dtype != torch.float32 or not contiguous:
            raise ValueError(f"actor_critic: {name} must be a contiguous f32 tensor on "
                             f"{x.device}")
    return tensors


def _args(w: ActorCriticWeights, n_lanes: int, ldx: int = 0, **pointers) -> _ActorCriticArgs:
    """The kernel's argument struct; ``pointers`` by argument name, the rest null."""
    return _ActorCriticArgs(
        **{k: t.data_ptr() for k, t in pointers.items()},
        n_lanes=n_lanes, ldx=ldx, A=w.w_actor_out.shape[1], num_branches=len(w.branch_off) - 1,
        hidden_dim=w.b_branch.shape[-1],
        branch_off=(ctypes.c_int32 * (MAX_BRANCHES + 1))(*w.branch_off),
        av_off=max(w.av_off, 0), av_prior=float(w.av_prior), cond=int(w.cond))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """K3's library, built and loaded at first use, its signatures set once."""
    lib = build.load("actor_critic")
    lib.actor_critic_launch.argtypes = [ctypes.POINTER(_ActorCriticArgs), ctypes.c_void_p]
    lib.actor_critic_plan.argtypes = [ctypes.POINTER(_ActorCriticArgs),
                                      ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.actor_critic_smem_bytes.argtypes = [ctypes.c_int]
    lib.actor_critic_instance.argtypes = [ctypes.c_int]
    for fn in (lib.actor_critic_launch, lib.actor_critic_plan, lib.actor_critic_smem_bytes,
               lib.actor_critic_instance):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _backward_lib() -> ctypes.CDLL:
    """K10's library, built and loaded at first use, its signatures set once."""
    lib = build.load("actor_critic_backward")
    lib.actor_critic_backward_launch.argtypes = [ctypes.POINTER(_ActorCriticBackwardArgs),
                                                 ctypes.c_void_p]
    lib.actor_critic_backward_smem_bytes.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.actor_critic_backward_instance.argtypes = [ctypes.c_int]
    for fn in (lib.actor_critic_backward_launch, lib.actor_critic_backward_smem_bytes,
               lib.actor_critic_backward_instance):
        fn.restype = ctypes.c_int
    return lib


def kernel_smem_bytes(hidden: int) -> Tuple[int, int, int]:
    """The shared memory a CTA of K3, K10's launch A and launch B takes at
    hidden width ``hidden``, as the compiled kernels report it (their
    instance's, or the wide variant's tile kernels'): what
    :func:`forward_smem_bytes` and :func:`backward_smem_bytes` compute."""
    launch_b = ctypes.c_int()
    launch_a = _backward_lib().actor_critic_backward_smem_bytes(hidden, ctypes.byref(launch_b))
    return _lib().actor_critic_smem_bytes(hidden), launch_a, launch_b.value


def kernel_instances(hidden: int) -> Tuple[int, int]:
    """The instance K3's and K10's compiled libraries pick for ``hidden``
    (0: the wide variant), which :func:`kernel_instance` mirrors."""
    return (_lib().actor_critic_instance(hidden),
            _backward_lib().actor_critic_backward_instance(hidden))


def _launch_forward(w: ActorCriticWeights, x: torch.Tensor, tensors, **outputs) -> None:
    """One launch of the forward kernel; ``outputs`` (and the noise) by
    argument name, the rest null."""
    args = _args(w, x.shape[0], x.stride(0), **tensors, **outputs)
    err = _lib().actor_critic_launch(ctypes.byref(args),
                                     torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"actor_critic kernel launch failed with CUDA error {err}")


def _wide_scratch(w: ActorCriticWeights, x: torch.Tensor, feats: bool) -> dict:
    """The wide variant's scratch (none for an instance): the partial
    logits and values of each 128-column tile of the fc product [2H / 128,
    N, 16], and with ``feats`` (the forward, which writes no features) the
    branch features [N, nb H] between its launches."""
    H, N, nb = w.b_branch.shape[1], x.shape[0], len(w.branch_off) - 1
    if kernel_instance(H) != WIDE:
        return {}
    out = dict(heads=torch.empty((_cdiv(2 * H, WIDE_TILE[1]), N, 16), dtype=torch.float32,
                                 device=x.device))
    if feats:
        out["feats"] = torch.empty((N, nb * H), dtype=torch.float32, device=x.device)
    return out


def cluster_plan(w: ActorCriticWeights, n_lanes: int) -> Tuple[int, bool]:
    """(CTAs a 32-row tile, whether the branches of more inputs than the
    instance's capacity run in two halves) that the kernel takes for
    ``n_lanes`` rows on the current card: the plan of least estimated time
    (``csrc/actor_critic.cu``: ``make_plan``); (1, False) for the wide
    variant, which runs no clusters."""
    ctas, split = ctypes.c_int(), ctypes.c_int()
    err = _lib().actor_critic_plan(ctypes.byref(_args(w, n_lanes)), ctypes.byref(ctas),
                                   ctypes.byref(split))
    if err != 0:
        raise RuntimeError(f"actor_critic_plan failed with CUDA error {err}")
    return ctas.value, bool(split.value)


def actor_critic_forward(w: ActorCriticWeights, x: torch.Tensor,
                         noise: Optional[torch.Tensor] = None):
    """Policy forward and action head over the packed observations ``x``.
    CPU tensors take :func:`actor_critic_forward_plain`; CUDA tensors launch
    the kernel, at any hidden width.  Returns (logits, value, action i32,
    log_prob)."""
    dev = x.device
    if dev.type == "cpu":
        return actor_critic_forward_plain(w, x, noise)
    tensors = {**_weight_tensors(w, x), **_wide_scratch(w, x, feats=True)}
    N, A = x.shape[0], w.w_actor_out.shape[1]
    if noise is not None:
        if noise.shape != (N, A) or noise.device != dev or noise.dtype != torch.float32 \
                or not noise.is_contiguous():
            raise ValueError(f"actor_critic: noise must be a contiguous f32 [{N}, {A}] "
                             f"tensor on {dev}, got {tuple(noise.shape)}")
        tensors["noise"] = noise
    out = dict(logits=torch.empty((N, A), dtype=torch.float32, device=dev),
               value=torch.empty(N, dtype=torch.float32, device=dev),
               action=torch.empty(N, dtype=torch.int32, device=dev),
               log_prob=torch.empty(N, dtype=torch.float32, device=dev))
    _launch_forward(w, x, tensors, **out)
    count_launch(actor_critic_forward, launch_mode(w))
    return out["logits"], out["value"], out["action"], out["log_prob"]


actor_critic_forward.launches = 0
actor_critic_forward.launches_by_mode = {}


def actor_critic_train_forward(w: ActorCriticWeights, x: torch.Tensor):
    """K3's training mode: (logits, value, feats, hidden), no action head.
    CPU tensors take :func:`actor_critic_train_forward_plain`; CUDA tensors
    launch the kernel, which also writes the activations K10 reads."""
    dev = x.device
    if dev.type == "cpu":
        return actor_critic_train_forward_plain(w, x)
    tensors = {**_weight_tensors(w, x), **_wide_scratch(w, x, feats=False)}
    N, A, nb, H = x.shape[0], w.w_actor_out.shape[1], len(w.branch_off) - 1, w.b_branch.shape[1]
    out = dict(logits=torch.empty((N, A), dtype=torch.float32, device=dev),
               value=torch.empty(N, dtype=torch.float32, device=dev),
               feats=torch.empty((N, nb * H), dtype=torch.float32, device=dev),
               hidden=torch.empty((N, 2 * H), dtype=torch.float32, device=dev))
    _launch_forward(w, x, tensors, **out)
    count_launch(actor_critic_train_forward, launch_mode(w))
    return out["logits"], out["value"], out["feats"], out["hidden"]


actor_critic_train_forward.launches = 0
actor_critic_train_forward.launches_by_mode = {}


def actor_critic_backward_plain(w: ActorCriticWeights, x: torch.Tensor, feats: torch.Tensor,
                                hidden: torch.Tensor, dlogits: torch.Tensor,
                                dvalue: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K10: the gradients of the eight weight
    tensors (``TENSOR_FIELDS`` order) from d/dlogits [N, A] and d/dvalue [N],
    with the activations of the training forward.  LeakyReLU's derivative
    comes from the sign of its output, as ``jax.nn.leaky_relu`` gives it."""
    H = w.b_branch.shape[1]
    nb = len(w.branch_off) - 1
    leaky_grad = lambda out, g: torch.where(out >= 0, g, 0.01 * g)
    cols = slice(w.cond * H, (w.cond + 1) * H)
    cond = feats[:, cols] if w.cond >= 0 else 0.0
    y_a, y_c = hidden[:, :H] + cond, hidden[:, H:] + cond
    dy_a = dlogits @ w.w_actor_out.t()
    dy_c = dvalue[:, None] * w.w_critic_out[:, 0]
    dpre_fc = leaky_grad(hidden, torch.cat([dy_a, dy_c], dim=1))
    dfeats = dpre_fc @ w.w_fc.t()
    if w.cond >= 0:
        dfeats[:, cols] = dfeats[:, cols] + (dy_a + dy_c)
    dpre_b = leaky_grad(feats, dfeats)
    dw_branch = torch.cat([
        x[:, w.branch_off[b]:w.branch_off[b + 1]].t() @ dpre_b[:, b * H:(b + 1) * H]
        for b in range(nb)])
    return (dw_branch, dpre_b.reshape(-1, nb, H).sum(0), feats.t() @ dpre_fc, dpre_fc.sum(0),
            y_a.t() @ dlogits, dlogits.sum(0), y_c.t() @ dvalue[:, None], dvalue.sum(0, keepdim=True))


class _ActorCriticBackwardArgs(ctypes.Structure):
    """Mirror of ``ActorCriticBackwardArgs`` in ``csrc/actor_critic_backward.cu``."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "x", "feats", "hidden", "w_fc", "w_aout", "w_cout", "dlogits", "dvalue", "y", "dpre_fc",
        "dpre_b", "dw_branch", "db_branch", "dw_fc", "db_fc", "dw_aout", "db_aout", "dw_cout",
        "db_cout")]
        + [(f, ctypes.c_int32) for f in ("B", "ldx", "A", "num_branches", "hidden_dim", "groups",
                                          "slices")]
        + [("branch_off", ctypes.c_int32 * (MAX_BRANCHES + 1)), ("cond", ctypes.c_int32)])


class BackwardPlan(NamedTuple):
    """K10's launch shapes: launch A splits each 32-row tile's column blocks
    over ``groups`` CTAs; launch B cuts the batch depth of each output tile
    into ``slices`` CTAs of one cluster."""
    groups: int
    slices: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _wide_smem_bytes(b_floats: int) -> int:
    """The wide variant's tile kernel: a ring of four stages, each an A
    stage [64][20] and a B stage of ``b_floats``, or the epilogue's output
    tile [64][132] over it where that is more."""
    rows, cols = WIDE_TILE
    return 4 * max(WIDE_STAGES * (rows * (WIDE_STAGE + 4) + b_floats), rows * (cols + 4))


def forward_smem_bytes(hidden: int) -> int:
    """K3's shared memory a CTA at hidden width ``hidden``, as
    ``csrc/actor_critic.cu``'s ``Dims`` lays out the instance of capacity
    kH that runs it: a ring of five stages, each the larger of (an x tile
    [32][20] and 16 W_b rows [16][kH + 8]) and 16 W_fc rows [16][2kH + 8],
    or what goes over the ring once the products are done where that is
    more (the partial fc product [32][2kH + 4], up to 16 CTAs' partial heads
    [32][16] and a CTA's slice of the fc columns, or the logits tile), and
    the feature tile [32][kH + 4].  Past 256: the wide variant's tile
    kernels (B stages [16][136])."""
    kh = kernel_instance(hidden)
    if kh == WIDE:
        return _wide_smem_bytes(WIDE_STAGE * (WIDE_TILE[1] + 8))
    slot = max(32 * 20 + 16 * (kh + 8), 16 * (2 * kh + 8))
    over = max(32 * (2 * kh + 4) + g * 32 * 16 + 32 * max(_cdiv(2 * kh, g) + 1, 16)
               for g in range(1, 17))
    return 4 * (max(5 * slot, over) + 32 * (kh + 4))


def backward_smem_bytes(hidden: int) -> Tuple[int, int]:
    """K10's shared memory a CTA (launch A, launch B) at hidden width
    ``hidden``, as ``csrc/actor_critic_backward.cu`` lays it out in the
    instance of capacity kH that runs it: launch A dPre_fc's TF32 hi and lo
    [32][2kH + 4] each, W_aout^T [16][kH], the dlogits rows [32][16] and
    three W_fc stages [kH][20]; past 256 the wide variant's tile kernel (B
    read transposed: stages [128][20]); launch B four stages of a [32][72]
    and a [32][136] tile, whatever the width."""
    kh = kernel_instance(hidden)
    launch_b = 4 * 4 * (32 * 72 + 32 * 136)
    if kh == WIDE:
        return _wide_smem_bytes(WIDE_TILE[1] * (WIDE_STAGE + 4)), launch_b
    return 4 * (2 * 32 * (2 * kh + 4) + 16 * kh + 32 * 16 + 3 * kh * 20), launch_b


def backward_plan(B: int, branch_off: Sequence[int], sms: int, hidden: int = 128) -> BackwardPlan:
    """The launch shapes for a batch of ``B`` rows of hidden width ``hidden``
    on a card of ``sms`` SMs.  Launch A: the groups of least estimated time,
    waves (of the CTAs an SM holds: two in the instances 64 and 128, one in
    192 and 256) times the blocks a CTA walks plus its head, each group at
    least one block, on a tie the fewer CTAs; one group in the wide variant,
    whose launch A is a thread an entry of the head, then 64 x 128 tiles of
    dPre_b.  Launch B: the most slices a cluster takes that the batch's
    32-deep stages fill (on the H100 more slices were faster at 512 and 4096
    rows alike)."""
    nb = len(branch_off) - 1
    row_tiles = _cdiv(B, BACKWARD_ROWS)
    per_sm = SMEM_PER_SM // (backward_smem_bytes(hidden)[0] + 1024)

    def cost_a(g: int) -> float:
        return _cdiv(row_tiles * g, per_sm * sms) * (BACKWARD_HEAD_BLOCKS + _cdiv(nb, g))

    groups = 1 if kernel_instance(hidden) == WIDE else min(
        (g for g in range(1, nb + 1) if _cdiv(nb, g) * (g - 1) < nb),
        key=lambda g: (cost_a(g), g))
    slices = max(s for s in BACKWARD_SLICES if s <= _cdiv(B, BACKWARD_STAGE))
    return BackwardPlan(groups, slices)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def actor_critic_backward(w: ActorCriticWeights, x: torch.Tensor, feats: torch.Tensor,
                          hidden: torch.Tensor, dlogits: torch.Tensor,
                          dvalue: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """K10: the eight weight gradients (see :func:`actor_critic_backward_plain`).
    CPU tensors take the plain version; CUDA tensors launch the kernel, at
    any hidden width."""
    dev = x.device
    if dev.type == "cpu":
        return actor_critic_backward_plain(w, x, feats, hidden, dlogits, dvalue)
    _weight_tensors(w, x)
    B, A, nb, H = x.shape[0], w.w_actor_out.shape[1], len(w.branch_off) - 1, w.b_branch.shape[1]
    for name, t, shape in (("feats", feats, (B, nb * H)), ("hidden", hidden, (B, 2 * H)),
                           ("dlogits", dlogits, (B, A)), ("dvalue", dvalue, (B,))):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"actor_critic_backward: {name} must be a contiguous f32 tensor "
                             f"of shape {shape} on {dev}, got {tuple(t.shape)}")
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    plan = backward_plan(B, w.branch_off, _sm_count(dev.index if dev.index is not None
                                                       else torch.cuda.current_device()), H)
    scratch = dict(y=empty(B, 2 * H), dpre_fc=empty(B, 2 * H), dpre_b=empty(B, nb * H))
    grads = dict(dw_branch=torch.empty_like(w.w_branch), db_branch=torch.empty_like(w.b_branch),
                 dw_fc=torch.empty_like(w.w_fc), db_fc=torch.empty_like(w.b_fc),
                 dw_aout=torch.empty_like(w.w_actor_out), db_aout=torch.empty_like(w.b_actor_out),
                 dw_cout=torch.empty_like(w.w_critic_out),
                 db_cout=torch.empty_like(w.b_critic_out))
    inputs = dict(x=x, feats=feats, hidden=hidden, w_fc=w.w_fc, w_aout=w.w_actor_out,
                  w_cout=w.w_critic_out, dlogits=dlogits, dvalue=dvalue)
    args = _ActorCriticBackwardArgs(
        **{k: t.data_ptr() for k, t in {**inputs, **scratch, **grads}.items()},
        B=B, ldx=x.stride(0), A=A, num_branches=nb, hidden_dim=H, groups=plan.groups,
        slices=plan.slices, branch_off=(ctypes.c_int32 * (MAX_BRANCHES + 1))(*w.branch_off),
        cond=int(w.cond))
    err = _backward_lib().actor_critic_backward_launch(
        ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"actor_critic_backward kernel launch failed with CUDA error {err}")
    count_launch(actor_critic_backward, launch_mode(w))
    return tuple(grads.values())


actor_critic_backward.launches = 0
actor_critic_backward.launches_by_mode = {}


class _ActorCriticTrain(torch.autograd.Function):
    """(logits, value) of the packed weights: K3's training mode forward and
    K10 backward (their plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, x, static, *weights):
        w = ActorCriticWeights(*(t.detach() for t in weights), *static)
        logits, value, feats, hidden = actor_critic_train_forward(w, x.detach())
        ctx.save_for_backward(x, feats, hidden, *weights)
        ctx.static = static
        return logits, value

    @staticmethod
    def backward(ctx, dlogits, dvalue):
        x, feats, hidden, *weights = ctx.saved_tensors
        w = ActorCriticWeights(*weights, *ctx.static)
        grads = actor_critic_backward(w, x, feats, hidden, dlogits.contiguous(),
                                      dvalue.contiguous())
        return (None, None) + grads


def actor_critic_train(w: ActorCriticWeights, x: torch.Tensor):
    """(logits [N, A], value [N]) of the packed observations ``x``,
    differentiable in ``w``'s eight tensors (the parameters flow back
    through ``MansyActorCritic._pack``)."""
    static = tuple(getattr(w, f) for f in ActorCriticWeights._fields[len(TENSOR_FIELDS):])
    return _ActorCriticTrain.apply(x, static, *(getattr(w, f) for f in TENSOR_FIELDS))
