"""K8: the softmax-attention core of the MTIO transformer (wrapper, plain
version, launch count).

Replaces what the deleted Pallas kernel ``mha_pallas`` computed and the JAX
package leaves to XLA: the core of ``models/transformer.py:MHA.attend``
(``:67-74``), ``softmax(q . k^T / sqrt(Dh), masked with -1e30) . v`` with
scores and softmax in f32.  Every mask on the MTIO paths is a prefix of the
keys (the KV-cached decode step t sees slots <= t, the full decode is
causal, the encoder and cross-attention see all keys), so the mask is given
as ``kv_len0``: query row r sees keys ``[0, min(Lk, kv_len0 + r))``.

On the H100 the core is bound by the k and v bytes; ``csrc/attention.cu``
runs one warp a (b, query row, head).  The projections and the cache write
stay ``torch`` ops (``models/transformer.py``).

The kernel has no backward yet (ROADMAP Queue 2 A1): on the card,
:func:`attention` refuses tensors that would need one
(:func:`refuse_grad`), where the CPU's plain version differentiates.
"""

from __future__ import annotations

import ctypes

import torch

from mansy_immersivevideostreaming_torch.kernels import build


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len0: int | None = None) -> torch.Tensor:
    """Plain PyTorch version, as ``MHA.attend`` computes it: q [B, Lq, H, Dh],
    k and v [B, Lk, H, Dh] -> [B, Lq, H, Dh]."""
    Lq, Lk, dh = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / (dh ** 0.5)
    if kv_len0 is not None:
        seen = torch.clamp(torch.arange(Lq, device=q.device) + kv_len0, max=Lk)
        mask = torch.arange(Lk, device=q.device)[None, :] < seen[:, None]
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


class _AttentionArgs(ctypes.Structure):
    """Mirror of ``AttentionArgs`` in ``csrc/attention.cu``."""
    _fields_ = ([(f, ctypes.c_void_p) for f in ("q", "k", "v", "o")]
                + [(f, ctypes.c_int32) for f in ("B", "Lq", "Lk", "H", "Dh", "kv_len0")]
                + [("scale", ctypes.c_float)])


MAX_DH = 256    # head width the kernel holds in registers (8 values a lane)
MAX_LK = 2048   # keys a row's scores hold in shared memory


def refuse_grad(grad_enabled: bool, *tensors: torch.Tensor) -> None:
    """Raises if autograd would need the kernel's backward: grad mode on and
    any of ``tensors`` requiring grad.  K8's backward is ROADMAP Queue 2 A1;
    until then the CUDA path runs under ``torch.no_grad()`` (as ``sample``
    does) or on tensors that need no gradient."""
    if grad_enabled and any(t.requires_grad for t in tensors):
        raise RuntimeError("attention: the CUDA kernel has no backward yet (ROADMAP Queue 2 "
                           "A1); call it under torch.no_grad() or with q, k and v that do not "
                           "require grad")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_len0: int | None = None) -> torch.Tensor:
    """softmax(q . k^T / sqrt(Dh)) . v, query row r over the first
    ``min(Lk, kv_len0 + r)`` keys (all keys if ``kv_len0`` is None).  CPU
    tensors take :func:`attention_plain` (differentiable); CUDA tensors launch
    the kernel, which refuses to run where a gradient would be needed."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_len0)
    refuse_grad(torch.is_grad_enabled(), q, k, v)
    B, Lq, H, Dh = q.shape
    Lk = k.shape[1]
    for name, t, shape in (("q", q, (B, Lq, H, Dh)), ("k", k, (B, Lk, H, Dh)),
                           ("v", v, (B, Lk, H, Dh))):
        if t.device != q.device or t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"attention: {name} must be a contiguous float32 tensor of shape "
                             f"{shape} on {q.device}, got {t.dtype} {tuple(t.shape)}")
    kv_len0 = Lk if kv_len0 is None else int(kv_len0)
    if not (1 <= Dh <= MAX_DH and 1 <= Lk <= MAX_LK and kv_len0 >= 1):
        raise ValueError(f"attention: needs 1 <= Dh <= {MAX_DH}, 1 <= Lk <= {MAX_LK} and "
                         f"kv_len0 >= 1, got Dh {Dh}, Lk {Lk}, kv_len0 {kv_len0}")
    o = torch.empty_like(q)
    args = _AttentionArgs(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=o.data_ptr(),
                          B=B, Lq=Lq, Lk=Lk, H=H, Dh=Dh, kv_len0=kv_len0, scale=Dh ** 0.5)
    lib = build.load("attention")
    lib.attention_launch.argtypes = [ctypes.POINTER(_AttentionArgs), ctypes.c_void_p]
    lib.attention_launch.restype = ctypes.c_int
    err = lib.attention_launch(ctypes.byref(args), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed with CUDA error {err}")
    attention.launches += 1
    return o


attention.launches = 0
