"""K9: the policy-loss head and its gradient (wrapper, plain version, launch
count), in three modes.

* PPO mode replaces the JAX package's ``rl/ppo.py:_ppo_loss`` (``:55-99``)
  under ``jax.value_and_grad``: log-softmax and the action gather, the ratio
  and clipped surrogate, the clipped value loss, entropy, the optional KL to
  an anchor (scalar or per-preference coefficient) and the minibatch or
  per-preference advantage normalisation.
* CE mode replaces the cross-entropy heads of ``rl/bc.py:bc_step``
  (``:31-37``) and ``rl/dagger.py:_bc_batch_step`` (``:123-131``): ``ce -
  ent_coef * entropy``.
* A2C mode replaces the loss of ``rl/a2c.py:a2c_update`` (``:71-80``):
  ``-mean(logp[a] adv) + vf_coef mean((ret - v)^2) - ent_coef mean(entropy)``
  on the raw advantages (no ratio, no clip, no normalisation).

One launch computes the loss, its terms and the gradient with respect to the
logits (and the value); :func:`ppo_loss`, :func:`ce_loss` and
:func:`a2c_loss` wrap it in a
``torch.autograd.Function`` whose backward scales the saved gradient by the
incoming one.  On the H100 the head is bound by its launch and its
latency (it moves well under a megabyte: 0.00015 ms of bytes at 4096 rows).
``csrc/policy_loss.cu`` runs one thread-block cluster of up to 16 CTAs, one
row a thread, each CTA's logits staged through shared memory with coalesced
16-byte copies; every CTA takes the advantage statistics over the whole
batch itself, and the loss sums meet over the cluster's distributed shared
memory, all in a fixed order, so two launches give the same bits.
:func:`policy_loss_plan` sizes the cluster from the batch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from mansy_immersivevideostreaming_torch.kernels import build, count_launch

MAX_ACTIONS = 16
MAX_PREFS = 16              # preference groups the per-preference normalisation takes
MAX_CTAS = 16               # the largest (non-portable) thread-block cluster
TILE_ROWS = (128, 256, 512)  # rows of a tile, one a thread
MODES = {"ce": 0, "ppo": 1, "a2c": 2}  # the kernel's modes (csrc/policy_loss.cu: kCE, kPPO, kA2C)


class PolicyLossPlan(NamedTuple):
    """K9's launch: one cluster of ``ctas`` CTAs of ``rows`` threads; CTA r
    takes the row tiles r, r + ctas, ... of ``rows`` rows each."""
    rows: int
    ctas: int


def policy_loss_plan(B: int) -> PolicyLossPlan:
    """The fewest rows a tile whose tiles fit one cluster of MAX_CTAS CTAs
    (else the most, each CTA looping over several tiles), and as many CTAs
    as tiles, up to MAX_CTAS: 4 x 128 at PPO's 512 rows, 16 x 256 at CE's
    4096."""
    rows = next((r for r in TILE_ROWS if r * MAX_CTAS >= B), TILE_ROWS[-1])
    return PolicyLossPlan(rows, max(1, min(MAX_CTAS, -(-B // rows))))


class LossSpec(NamedTuple):
    """Everything the loss head reads besides the logits and the value.
    ``mode`` is one of MODES: CE reads ``action`` and ``ent_coef``; A2C also
    ``adv``, ``ret`` and ``vf_coef``; PPO the other fields too.
    :func:`ce_loss`, :func:`ppo_loss` and :func:`a2c_loss` set it."""
    action: torch.Tensor                          # i32 [B]
    ent_coef: float
    old_log_prob: Optional[torch.Tensor] = None   # [B]
    old_value: Optional[torch.Tensor] = None      # [B]
    adv: Optional[torch.Tensor] = None            # [B] raw advantages
    ret: Optional[torch.Tensor] = None            # [B] value targets
    pref_id: Optional[torch.Tensor] = None        # i32 [B]
    anchor_logits: Optional[torch.Tensor] = None  # [B, A]: adds KL(anchor || pi)
    kl_coef: Optional[torch.Tensor] = None        # f32 0-d, or [n] per preference
    eps_clip: float = 0.2
    vf_coef: float = 0.5
    value_clip: bool = True
    norm_adv: bool = True
    norm_adv_per_pref: bool = False
    n_prefs: int = 4
    mode: str = "ce"

    @property
    def kl_per_pref(self) -> bool:
        """A vector coefficient indexed by each row's preference (JAX:
        ``kl_coef.ndim == 1 and "pref_id" in batch``)."""
        return self.kl_coef is not None and self.kl_coef.dim() == 1


# LossSpec's optional tensors, and those each mode needs and those it may read
_TENSORS = ("old_log_prob", "old_value", "adv", "ret", "pref_id", "anchor_logits", "kl_coef")
_READS = {"ce": ((), ()), "a2c": (("adv", "ret"), ()),
          "ppo": (("old_log_prob", "old_value", "adv", "ret"),
                  ("pref_id", "anchor_logits", "kl_coef"))}


def _check_spec(spec: LossSpec) -> None:
    if spec.mode not in MODES:
        raise ValueError(f"policy_loss: mode must be one of {tuple(MODES)}, got {spec.mode!r}")
    needs, may = _READS[spec.mode]
    missing = [f for f in needs if getattr(spec, f) is None]
    unread = [f for f in _TENSORS if f not in needs + may and getattr(spec, f) is not None]
    if missing:
        raise ValueError(f"policy_loss: {spec.mode} mode needs {', '.join(missing)}")
    if unread:
        raise ValueError(f"policy_loss: {spec.mode} mode reads no {', '.join(unread)}")
    if spec.mode == "ppo" and spec.norm_adv_per_pref and spec.pref_id is None:
        raise ValueError("policy_loss: norm_adv_per_pref needs pref_id")
    if spec.anchor_logits is not None:
        if spec.kl_coef is None or spec.kl_coef.dim() > 1:
            raise ValueError("policy_loss: the KL term needs a scalar or [n_prefs] kl_coef")
        if spec.kl_per_pref and spec.pref_id is None:
            raise ValueError("policy_loss: a per-preference kl_coef needs pref_id")


def _tie_split(first: torch.Tensor, second: torch.Tensor, g1, g2):
    """d min(first, second) (or max, with the arguments swapped): the
    smaller one's gradient, halves of both on a tie (``lax.min``)."""
    return torch.where(first < second, g1, torch.where(second < first, g2, 0.5 * g1 + 0.5 * g2))


def _clip_grad(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """d clip(x, lo, hi) / dx as ``jnp.clip`` (maximum, then minimum) gives it."""
    m = torch.clamp(x, min=lo)
    ga = torch.where(x > lo, 1.0, torch.where(x == lo, 0.5, 0.0))
    gb = torch.where(m < hi, 1.0, torch.where(m == hi, 0.5, 0.0))
    return ga * gb


def normalized_advantages(spec: LossSpec) -> torch.Tensor:
    """PPO's advantages as the loss reads them: normalised over the
    minibatch (``norm_adv``) or within each preference group
    (``norm_adv_per_pref``), else raw."""
    adv = spec.adv
    if spec.norm_adv_per_pref:
        member = F.one_hot(spec.pref_id.long(), spec.n_prefs).to(adv.dtype)  # [B, K]
        cnt = torch.clamp(member.sum(0), min=1.0)
        mean_k = (member.t() @ adv) / cnt
        var_k = (member.t() @ (adv * adv)) / cnt - mean_k * mean_k
        std = member @ torch.sqrt(torch.clamp(var_k, min=0.0))
        return (adv - member @ mean_k) / (std + 1e-8)
    if spec.norm_adv:
        return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    return adv


def policy_loss_plain(spec: LossSpec, logits: torch.Tensor, value: Optional[torch.Tensor]):
    """Plain PyTorch version: the loss, its terms [3] ((clip, vf, entropy) in
    PPO mode, (actor, vf, entropy) in A2C mode, (ce, 0, entropy) in CE
    mode), d loss / d logits and d loss / d value (None in CE mode), with
    the gradients written out."""
    B, A = logits.shape
    inv_b = 1.0 / B
    lp = F.log_softmax(logits, -1)
    p = F.softmax(logits, -1)
    H = -(p * lp).sum(-1)
    ent = H.mean()
    act = spec.action.long()
    onehot = F.one_hot(act, A).to(logits.dtype)
    logp = lp.gather(1, act[:, None])[:, 0]
    dentropy = (spec.ent_coef * inv_b) * (p * (lp + H[:, None]))
    if spec.mode == "a2c":
        actor = -(logp * spec.adv).mean()
        r1 = spec.ret - value
        vf_loss = (r1 * r1).mean()
        dlogits = (-inv_b * spec.adv)[:, None] * (onehot - p) + dentropy
        return (actor + spec.vf_coef * vf_loss - spec.ent_coef * ent,
                torch.stack([actor, vf_loss, ent]), dlogits,
                (spec.vf_coef * inv_b) * (-2.0 * r1))
    if spec.mode == "ce":
        ce = -logp.mean()
        dlogits = -inv_b * (onehot - p) + dentropy
        terms = torch.stack([ce, torch.zeros_like(ce), ent])
        return ce - spec.ent_coef * ent, terms, dlogits, None

    adv = normalized_advantages(spec)
    ratio = torch.exp(logp - spec.old_log_prob)
    lo, hi = 1 - spec.eps_clip, 1 + spec.eps_clip
    t1, t2 = ratio * adv, torch.clamp(ratio, lo, hi) * adv
    clip_loss = -torch.minimum(t1, t2).mean()
    g_ratio = _tie_split(t1, t2, adv, adv * _clip_grad(ratio, lo, hi))
    g_logp = -inv_b * g_ratio * ratio

    r1 = spec.ret - value
    vf1, dvf1 = r1 * r1, -2.0 * r1
    if spec.value_clip:
        d = value - spec.old_value
        r2 = spec.ret - (spec.old_value + torch.clamp(d, -spec.eps_clip, spec.eps_clip))
        vf2, dvf2 = r2 * r2, -2.0 * r2 * _clip_grad(d, -spec.eps_clip, spec.eps_clip)
        vf_loss = torch.maximum(vf1, vf2).mean()
        g_value = _tie_split(vf2, vf1, dvf1, dvf2)
    else:
        vf_loss = vf1.mean()
        g_value = dvf1
    loss = clip_loss + spec.vf_coef * vf_loss - spec.ent_coef * ent
    dlogits = g_logp[:, None] * (onehot - p) + dentropy
    if spec.anchor_logits is not None:
        alp = F.log_softmax(spec.anchor_logits, -1)
        ap = torch.exp(alp)
        kl = (ap * (alp - lp)).sum(-1)
        if spec.kl_per_pref:
            k = torch.clamp(spec.pref_id.long(), 0, spec.kl_coef.shape[0] - 1)
            coef = spec.kl_coef[k]
            loss = loss + (coef * kl).mean()
        else:
            coef = spec.kl_coef.expand(B)
            loss = loss + spec.kl_coef * kl.mean()
        dlogits = dlogits + (coef * inv_b)[:, None] * (p * ap.sum(-1, keepdim=True) - ap)
    terms = torch.stack([clip_loss, vf_loss, ent])
    return loss, terms, dlogits, (spec.vf_coef * inv_b) * g_value


class _PolicyLossArgs(ctypes.Structure):
    """Mirror of ``PolicyLossArgs`` in ``csrc/policy_loss.cu``."""
    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "logits", "value", "action", "old_log_prob", "old_value", "adv", "ret", "pref_id",
        "anchor_logits", "kl_coef", "loss", "terms", "dlogits", "dvalue")]
        + [(f, ctypes.c_int32) for f in ("B", "A", "mode", "value_clip", "norm_adv",
                                         "norm_adv_per_pref", "n_prefs", "n_kl", "kl_per_pref",
                                         "rows", "ctas")]
        + [(f, ctypes.c_float) for f in ("clip_lo", "clip_hi", "eps_clip", "vf_coef",
                                         "ent_coef")])


def policy_loss(spec: LossSpec, logits: torch.Tensor, value: Optional[torch.Tensor]):
    """(loss, terms, d loss / d logits, d loss / d value) of one minibatch.
    CPU tensors take :func:`policy_loss_plain`; CUDA tensors launch the
    kernel."""
    _check_spec(spec)
    dev = logits.device
    if dev.type == "cpu":
        return policy_loss_plain(spec, logits, value)
    B, A = logits.shape
    if A > MAX_ACTIONS:
        raise ValueError(f"policy_loss kernel takes at most {MAX_ACTIONS} actions, got {A}")
    if spec.mode == "ppo" and spec.norm_adv_per_pref and not 1 <= spec.n_prefs <= MAX_PREFS:
        raise ValueError(f"policy_loss kernel takes 1 to {MAX_PREFS} preference groups, got "
                         f"{spec.n_prefs}")
    tensors = {"logits": (logits, torch.float32, (B, A)), "action": (spec.action, torch.int32, (B,))}
    if spec.mode == "a2c":
        tensors.update(value=(value, torch.float32, (B,)), adv=(spec.adv, torch.float32, (B,)),
                       ret=(spec.ret, torch.float32, (B,)))
    elif spec.mode == "ppo":
        tensors.update(value=(value, torch.float32, (B,)),
                       old_log_prob=(spec.old_log_prob, torch.float32, (B,)),
                       old_value=(spec.old_value, torch.float32, (B,)),
                       adv=(spec.adv, torch.float32, (B,)), ret=(spec.ret, torch.float32, (B,)))
        if spec.pref_id is not None:
            tensors["pref_id"] = (spec.pref_id, torch.int32, (B,))
        if spec.anchor_logits is not None:
            tensors["anchor_logits"] = (spec.anchor_logits, torch.float32, (B, A))
            tensors["kl_coef"] = (spec.kl_coef.reshape(-1), torch.float32, None)
    for name, (t, dtype, shape) in tensors.items():
        if t.device != dev or t.dtype != dtype or not t.is_contiguous() \
                or shape not in (None, tuple(t.shape)):
            raise ValueError(f"policy_loss: {name} must be a contiguous {dtype} tensor of "
                             f"shape {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    loss = torch.empty((), dtype=torch.float32, device=dev)
    terms = torch.empty(3, dtype=torch.float32, device=dev)
    dlogits = torch.empty_like(logits)
    dvalue = torch.empty_like(value) if spec.mode != "ce" else None
    ptrs = {name: t.data_ptr() for name, (t, _, _) in tensors.items()}
    plan = policy_loss_plan(B)
    args = _PolicyLossArgs(
        **ptrs, loss=loss.data_ptr(), terms=terms.data_ptr(), dlogits=dlogits.data_ptr(),
        dvalue=0 if dvalue is None else dvalue.data_ptr(), B=B, A=A, mode=MODES[spec.mode],
        value_clip=int(spec.value_clip), norm_adv=int(spec.norm_adv),
        norm_adv_per_pref=int(spec.norm_adv_per_pref), n_prefs=int(spec.n_prefs),
        n_kl=int(spec.kl_coef.numel()) if spec.anchor_logits is not None else 0,
        kl_per_pref=int(spec.kl_per_pref), rows=plan.rows, ctas=plan.ctas,
        clip_lo=1 - spec.eps_clip,
        clip_hi=1 + spec.eps_clip, eps_clip=spec.eps_clip, vf_coef=spec.vf_coef,
        ent_coef=float(spec.ent_coef))
    lib = build.load("policy_loss")
    lib.policy_loss_launch.argtypes = [ctypes.POINTER(_PolicyLossArgs), ctypes.c_void_p]
    lib.policy_loss_launch.restype = ctypes.c_int
    err = lib.policy_loss_launch(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"policy_loss kernel launch failed with CUDA error {err}")
    count_launch(policy_loss, spec.mode)
    return loss, terms, dlogits, dvalue


policy_loss.launches = 0
policy_loss.launches_by_mode = {}


class _PolicyLoss(torch.autograd.Function):
    """The loss as a function of logits and value; the gradient comes from the
    same launch and is scaled by the incoming one in the backward."""

    @staticmethod
    def forward(ctx, logits, value, spec):
        loss, terms, dlogits, dvalue = policy_loss(spec, logits.detach(),
                                                   None if value is None else value.detach())
        ctx.save_for_backward(dlogits, dvalue)
        ctx.mark_non_differentiable(terms)
        return loss, terms

    @staticmethod
    def backward(ctx, g_loss, _):
        dlogits, dvalue = ctx.saved_tensors
        return dlogits * g_loss, None if dvalue is None else dvalue * g_loss, None


def ppo_loss(logits: torch.Tensor, value: torch.Tensor,
             spec: LossSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, terms (clip, vf, entropy)) of a PPO minibatch, differentiable in
    logits and value."""
    return _PolicyLoss.apply(logits, value, spec._replace(mode="ppo"))


def ce_loss(logits: torch.Tensor, action: torch.Tensor,
            ent_coef: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ce - ent_coef * entropy, terms (ce, 0, entropy)), differentiable in
    the logits."""
    return _PolicyLoss.apply(logits, None, LossSpec(action=action, ent_coef=ent_coef, mode="ce"))


def a2c_loss(logits: torch.Tensor, value: torch.Tensor,
             spec: LossSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, terms (actor, vf, entropy)) of an A2C minibatch, differentiable
    in logits and value."""
    return _PolicyLoss.apply(logits, value, spec._replace(mode="a2c"))
