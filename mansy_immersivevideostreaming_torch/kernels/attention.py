"""K8: the softmax-attention core of the MTIO transformer, its training mode
and its backward (wrappers, plain versions, launch counts).

Replaces what the deleted Pallas kernel ``mha_pallas`` computed and the JAX
package leaves to XLA: the core of ``models/transformer.py:MHA.attend``
(``:67-74``), ``softmax(q . k^T / sqrt(Dh), masked with -1e30) . v`` with
scores and softmax in f32, and in training the attention-probability
dropout (``:72-73``) and the gradient ``jax.value_and_grad`` takes through
it (``models/vp_train.py:_train_step``).  Every mask on the MTIO paths is a
prefix of the keys (the KV-cached decode step t sees slots <= t, the full
decode is causal, the encoder and cross-attention see all keys), so the
mask is given as ``kv_len0``: query row r sees keys
``[0, min(Lk, kv_len0 + r))``.

On the H100 the core is bound by the k and v bytes; ``csrc/attention.cu``
runs a serving mode and a training mode that also writes each row's max
and exp sum and applies a dropout keep mask, each as one of the kernels of
:func:`attention_forward_plan`: one warp a (b, query row, head) for one
query row up to SPLIT_KEYS keys (its scores in shared memory); past them
(at up to 256 dims) the split row kernels, flash-decoding in three
launches: a warp a (b, head, split) of the keys (:func:`row_split_plan`,
enough splits that the warps fill the H100 at B 4 as at B 64) streams its
k rows by cp.async and writes its scores (the row backward's arithmetic:
the butterfly's sums, the IEEE division by sqrt(Dh)) and its max and expf
sum to scratch; every warp of the row then combines the splits' statistics
in split order into the row's max and sum, forms p = expf(s - max) / sum
(so the row backward, reading them as row_max and row_sum, recomputes this
P bit for bit), the keep mask, the rounding to bf16, and its split's P . v
from its v rows; a last launch sums the splits' partials in split order;
else a CTA a
(b, head, row tile) that stages the k and v rows in shared memory once and
takes each warp's rows' scores by a reduce-scatter (the butterfly's sums),
bit for bit the one-row kernel's arithmetic, keeping each row's scores in
shared memory; where those rows no longer fit (past about 2490 keys) and
past 256 dims the streamed kernel takes its products on the tensor cores
(``mma.sync``: bf16 with f32 sums, f32 in 3xTF32), a warp 16 rows, and
recomputes the scores a key tile at a time in two passes (each row's max
and exp sum, then P . v), JAX's rounding points but the tensor cores' sum
order, so its bits are within ulps of the others'.  Heads past 256 dims
(``--hidden-dim`` past 2048) take wide variants of the row and streamed
kernels: the row kernel's head in chunks of 256 dims, 8 a lane, a score's
per-lane partial carried across the chunks before the butterfly; the
streamed kernel's P . v in output chunks of 256 dims, the scores
recomputed for each.
``csrc/attention_backward.cu`` recomputes P from those statistics (bit for
bit the row, split row and tile kernels' P, within ulps of the streamed kernel's up
to 256 dims) at any number of query rows and keys: a warp a (b, head) for
one query row, else a CTA a (b, head) over tiles of keys and rows, and past
256 dims for one row the row layout over the chunks; past 2048 keys at few
(b, head) pairs ``csrc/attention_backward_split.cu`` takes the same sums
over two grids of tiles (a CTA a (b, head, row tile) for dQ, then a CTA a
(b, head, key tile) for dK and dV).  Past 256 dims more than one row takes
``csrc/attention_backward_wide.cu`` (in f32 where it measured faster than
the wide SIMT tile kernel, which stays elsewhere): every product on the
tensor cores, the scores by the streamed forward's own wide score tile and
P by its exp2, so P is the streamed forward's bit for bit; a dQ grid of
(b, head, 16-row tile) CTAs, then a dK/dV grid of (b, head, 16-key tile)
CTAs, or one grid for up to 16 keys (:func:`attention_backward_plan`).
Every launch is counted by element type and variant (``launches_by_mode``:
``f32``, ``bf16``, with ``_stream``, ``_wide``, ``_split`` or ``_rowsplit``
for those variants; a call of the split row kernels counts once).
:func:`attention` picks the path: the plain version for CPU tensors, the
training forward and the backward kernel (:class:`_AttentionFunction`) when
autograd needs a gradient, else the serving kernel.  The projections, the
cache write and the mask draws stay ``torch`` ops (``models/transformer.py``).

Element types: q, k and v are all f32 or all bf16 (``run_models --bf16``:
``MHA.attend`` at ``dtype=bfloat16``); the output and the gradients take
their type, the row statistics stay f32 and the keep mask u8.  Any other
dtype raises a ``ValueError``: nothing is cast quietly.  In bf16 the sums
run in f32 and the rounding points are JAX's: the scores are f32 sums of
the exact products of the bf16 q and k, softmax and dropout act on the f32
P, P is rounded to bf16 and P . v summed in f32 and rounded once; the
backward rounds where ``jax.grad`` of those lines does (dP' = dO . V^T and
dV in bf16, the softmax's gradient in f32 from the rounded dP', dQ and dK
rounded once; ``attention_backward_plain``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from mansy_immersivevideostreaming_torch.kernels import build, count_launch

CHUNK_DIMS = 256  # dims a lane holds at most 8 of; wider heads run in chunks of these
ROW_WARPS = 4      # the forward's row kernels: warps (query rows) a CTA
MAX_ROW_TILE = 32  # the tile kernels (forward and backward): query rows a row tile
FORWARD_GROUP = 4  # the forward's tile kernels: rows a warp takes at once
STREAM_ROWS = 16   # the resident tile kernel's least row tile before the streamed one
STREAM_GROUP = 16  # the streamed kernel: rows a warp (one m16 fragment of mma.sync)
STREAM_MAX_ROWS = 64  # and rows a row tile (4 warps; past 128 dims 16 rows on 4 warps)
STREAM_SPLIT = 4   # past 128 dims: warps that split a chunk's dims (partial scores summed)
WIDE_KEYS = 8      # the wide backward's SIMT kernels: keys a tile
WIDE_ROWS = 8      # the wide SIMT tile kernel (f32): rows a row tile (a warp a row)
WIDE_TILE = 16     # the wide backward of more rows: rows a row tile and keys a key tile
WIDE_OUT = 512     # and dims an output chunk (64 a warp of its 8)
SMEM_BYTES = 232448  # the H100's shared memory a block (227 KB)
MAX_LK = SMEM_BYTES // (4 * ROW_WARPS)  # 14528: keys of the row kernels' f32 scores, 4 a CTA
#                                        (binding past 256 dims: up to them the split row
#                                        kernels take one query row past SPLIT_KEYS)
SPLIT_KEYS = 2048      # one query row, and the backward of more than one row tile, split past
#                        these keys
SPLIT_MAX_HEADS = 256  # the backward splits below these (b, head) pairs (half the tile
#                        kernel's 528 CTAs resident on the H100, 4 an SM): from there the
#                        one-CTA grid fills the card and the split's second score pass costs
#                        more than it gains
SPLIT_TILE_KEYS = 16  # the split backward's keys a tile (two rows' scores fill a warp's lanes)
ROW_SPLIT_TILE = 32    # the split row kernels: keys a staged tile (one reduce_scatter of 32)
ROW_SPLIT_MIN_KEYS = 64  # and keys a split at least (a tile in flight while one is taken)
ROW_SPLIT_WARPS = 132 * 8  # and the warps (a split each) they aim for: 8 an SM of the H100
DTYPES = (torch.float32, torch.bfloat16)  # the kernels' element types, by their code
MODES = ("f32", "bf16")  # the launch-count mode of each element type (``launches_by_mode``)


def _prefix_mask(Lq: int, Lk: int, kv_len0: Optional[int], device) -> Optional[torch.Tensor]:
    """[Lq, Lk] bool, key j seen by row r iff j < min(Lk, kv_len0 + r)."""
    if kv_len0 is None:
        return None
    seen = torch.clamp(torch.arange(Lq, device=device) + kv_len0, max=Lk)
    return torch.arange(Lk, device=device)[None, :] < seen[:, None]


def _elem(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """The kernels' element code of q, k and v (0: f32, 1: bf16); raises
    unless all three have one of those types."""
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention: q, k and v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    return DTYPES.index(q.dtype)


def _scores(q: torch.Tensor, k: torch.Tensor, kv_len0: Optional[int]) -> torch.Tensor:
    """The masked f32 scores [B, H, Lq, Lk], as ``MHA.attend`` computes them
    (bf16 q and k upcast: the products are exact and summed in f32)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (q.shape[-1] ** 0.5)
    mask = _prefix_mask(q.shape[1], k.shape[1], kv_len0, q.device)
    return s if mask is None else s.masked_fill(~mask, -1e30)


def _dropped(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """flax's Dropout with a given keep mask: x / keep_prob where kept, else 0."""
    if keep is None:
        return x
    return torch.where(keep.bool(), x / (1.0 - rate), torch.zeros_like(x))


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """P . v in v's type: in bf16, P rounded to bf16 (``p.astype(v.dtype)``),
    the product of the upcast operands summed in f32 and rounded once (in
    f32 every cast is the identity).  Under autograd the casts round where
    ``jax.grad`` rounds: dP' = dO . V^T and dV to bf16 (the f32 product's
    gradients cast back to the operands' type)."""
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float()).to(v.dtype)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len0: int | None = None, keep: Optional[torch.Tensor] = None,
                    rate: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version, as ``MHA.attend`` computes it: q [B, Lq, H, Dh],
    k and v [B, Lk, H, Dh] -> [B, Lq, H, Dh], f32 or bf16; with ``keep`` (u8
    or bool [B, H, Lq, Lk]) the probabilities go through dropout at
    ``rate``.  Differentiable: in bf16 its autograd rounds where ``jax.grad``
    of ``MHA.attend`` does."""
    _elem(q, k, v)
    p = _dropped(torch.softmax(_scores(q, k, kv_len0), dim=-1), keep, rate)
    return _pv(p, v)


def attention_train_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  kv_len0: int | None = None,
                                  keep: Optional[torch.Tensor] = None, rate: float = 0.0
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The training mode's plain version: (o, row max, row exp sum), the
    statistics f32 [B, H, Lq]."""
    _elem(q, k, v)
    s = _scores(q, k, kv_len0)
    row_max = s.amax(-1)
    e = torch.exp(s - row_max[..., None])
    row_sum = e.sum(-1)
    p = _dropped(e / row_sum[..., None], keep, rate)
    return _pv(p, v), row_max, row_sum


def attention_backward_plain(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor, row_max: torch.Tensor,
                             row_sum: torch.Tensor, kv_len0: int | None = None,
                             keep: Optional[torch.Tensor] = None, rate: float = 0.0
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's plain version, written out as the kernel computes it
    (``csrc/attention_backward.cu``): P from the row statistics,
    P' = P * M / kp, dV = P'^T dO, dP' = dO V^T, D = rowsum(dO * O),
    dS = P * (dP' * M / kp - D), dQ = (dS / sqrt(Dh)) K, dK = (dS / sqrt(Dh))^T Q.
    In bf16, JAX's rounding points (``jax.grad`` of ``MHA.attend``): P' and
    dP' rounded to bf16, dV, dQ and dK f32 sums rounded once, and
    D = sum_k g_k P_k with g = dP' * M / kp, the softmax's own gradient, in
    place of rowsum(dO * O), whose bf16 O would round it differently.
    Returns (dq, dk, dv)."""
    dt = q.dtype
    rounded = lambda t: t.to(dt).float()  # the element type's rounding (none in f32)
    p = torch.exp(_scores(q, k, kv_len0) - row_max[..., None]) / row_sum[..., None]
    dv = torch.einsum("bhqk,bqhd->bkhd", rounded(_dropped(p, keep, rate)), dout.float())
    dp = _dropped(rounded(torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())), keep, rate)
    if _elem(q, k, v):
        D = (dp * p).sum(-1)                             # [B, H, Lq]
    else:
        D = (dout * o).sum(-1).transpose(1, 2)
    ds = p * (dp - D[..., None]) / (q.shape[-1] ** 0.5)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(dt),
            torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).to(dt), dv.to(dt))


BF16_EPS = 2.0 ** -7  # a bf16 ulp is at most this share of its value


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element's magnitude (2^(floor(log2 |x|) - 7);
    the smallest normal's at 0)."""
    _, e = torch.frexp(x.float().abs().clamp(min=torch.finfo(torch.bfloat16).tiny))
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)


def bf16_slack(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
               kv_len0: int | None = None, keep: Optional[torch.Tensor] = None,
               rate: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """How far two bf16 evaluations of the core may part beyond one ulp of
    their outputs, (o, dq, dk, dv), f32: each computes P and dP' in f32
    (sums in another order, expf against torch's exp) and rounds them to
    bf16, so where an f32 value sits on a rounding boundary the two round it
    one bf16 ulp apart (at most BF16_EPS of it).  Bounds, from magnitudes:
    o and dV by BF16_EPS |P'| . |V| and |P'|^T . |dO|; dS by P (BF16_EPS |g|
    + BF16_EPS sum_k P_k |g_k|) / sqrt(Dh), with g = dP' * M / kp, and dQ,
    dK by |that| . |K| and its transpose . |Q|.  Where a sum cancels, one
    ulp of a summand is many of the sum: the kernels and their plain
    versions agree within one ulp of the larger plus this slack."""
    s = _scores(q, k, kv_len0)
    p = torch.softmax(s, dim=-1)
    pd = _dropped(p, keep, rate)
    qa, ka, va, da = (x.float().abs() for x in (q, k, v, dout))
    g = _dropped(torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float()).abs(), keep, rate)
    ds = BF16_EPS * p * (g + (p * g).sum(-1, keepdim=True)) / (q.shape[-1] ** 0.5)
    return (BF16_EPS * torch.einsum("bhqk,bkhd->bqhd", pd, va),
            torch.einsum("bhqk,bkhd->bqhd", ds, ka), torch.einsum("bhqk,bqhd->bkhd", ds, qa),
            BF16_EPS * torch.einsum("bhqk,bqhd->bkhd", pd, da))


def bf16_excess(got: torch.Tensor, ref: torch.Tensor, slack: torch.Tensor) -> float:
    """The largest (|got - ref| - one bf16 ulp of max(|got|, |ref|)) / slack;
    at most 1 where the two agree (:func:`bf16_slack`)."""
    got, ref = got.float(), ref.float()
    over = (got - ref).abs() - bf16_ulp(torch.maximum(got.abs(), ref.abs()))
    return float((over / slack.clamp(min=torch.finfo(torch.float32).tiny)).clamp(min=0).max())


class _AttentionArgs(ctypes.Structure):
    """Mirror of ``AttentionArgs`` in ``csrc/attention.cu``."""
    _fields_ = ([(f, ctypes.c_void_p) for f in ("q", "k", "v", "o")]
                + [(f, ctypes.c_int32) for f in ("B", "Lq", "Lk", "H", "Dh", "kv_len0")]
                + [("scale", ctypes.c_float), ("keep", ctypes.c_void_p),
                   ("keep_prob", ctypes.c_float), ("row_max", ctypes.c_void_p),
                   ("row_sum", ctypes.c_void_p)]
                + [(f, ctypes.c_int32) for f in ("per_lane", "keys", "rows", "group", "stream")])


class _RowSplitArgs(ctypes.Structure):
    """Mirror of ``RowSplitArgs`` in ``csrc/attention.cu``: the forward's
    arguments (``stream`` 1: ``attention_launch`` reads the rest) and the
    split row kernels' scratch (:func:`row_split_scratch`)."""
    _fields_ = [("a", _AttentionArgs)] + [(f, ctypes.c_void_p) for f in ("split_stats", "scores",
                                                                        "partial")]


class _AttentionBackwardArgs(ctypes.Structure):
    """Mirror of ``AttentionBackwardArgs`` in ``csrc/attention_backward.cuh``."""
    _fields_ = ([(f, ctypes.c_void_p) for f in ("dout", "q", "k", "v", "o", "row_max",
                                                 "row_sum", "keep", "dq", "dk", "dv")]
                + [(f, ctypes.c_int32) for f in ("B", "Lq", "Lk", "H", "Dh", "kv_len0")]
                + [("scale", ctypes.c_float), ("keep_prob", ctypes.c_float)]
                + [(f, ctypes.c_int32) for f in ("per_lane", "keys", "rows", "warps")]
                + [(f, ctypes.c_void_p) for f in ("delta", "dq_acc", "row_max_acc")])


class BackwardPlan(NamedTuple):
    """The backward's launch (``csrc/attention_backward.cu``): ``kernel`` is
    "row" (one query row: a warp a (b, head), ``threads // 32`` a CTA) or
    "tile" (a CTA a (b, head) over key tiles of ``keys`` keys and row tiles
    of ``rows`` rows); a lane holds ``per_lane`` dims of a row.
    "tile_split": the tile kernel's sums in two launches, a CTA a (b, head,
    row tile) for dQ, then a CTA a (b, head, key tile) for dK and dV;
    ``blocks`` counts both grids' CTAs.  Past 256 dims, "row_wide" and (in
    f32) "tile_wide": the row and tile layouts over chunks of 256 dims (8 a
    lane), ``keys`` = WIDE_KEYS; and "tile_wide_tc":
    ``csrc/attention_backward_wide.cu`` on the tensor cores, tiles of
    ``rows`` = ``keys`` = WIDE_TILE, 8 warps, a dQ grid and a dK/dV grid (one
    grid of B H CTAs for up to WIDE_TILE keys)."""
    kernel: str
    per_lane: int
    keys: int
    rows: int
    threads: int
    blocks: int
    smem_bytes: int


def _pow2_at_least(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def wide_backward_smem_bytes(Dh: int, elem: int = 4) -> int:
    """The wide backward's shared memory (``csrc/attention_backward_wide.cu``)
    for heads of ``Dh`` dims of ``elem``-byte elements: the 8 warps' partial
    scores and dP' (WIDE_TILE / 2 floats a lane), a pair's P' and dS
    (WIDE_TILE rows of WIDE_TILE + 4 floats) and a row tile's D; then up to
    WIDE_OUT dims (resident) the own tile's 2 x WIDE_TILE rows of WIDE_OUT
    dims and two slots of a pair's 2 x WIDE_TILE partner rows, past them
    (streamed) two slots of 4 x WIDE_TILE rows of a chunk of 256 dims; each
    row 16 bytes longer, each slot with a row tile's keep bytes (WIDE_TILE +
    4 a row)."""
    res = Dh <= WIDE_OUT
    row = elem * ((WIDE_OUT if res else CHUNK_DIMS) + 16 // elem)
    own, slot = (2 * WIDE_TILE, 2 * WIDE_TILE) if res else (0, 4 * WIDE_TILE)
    red = 8 * 32 * (WIDE_TILE // 2) + 2 * WIDE_TILE * (WIDE_TILE + 4) + WIDE_TILE
    return 4 * red + own * row + 2 * (slot * row + WIDE_TILE * (WIDE_TILE + 4))


def attention_backward_plan(B: int, Lq: int, Lk: int, H: int, Dh: int,
                            split: Optional[bool] = None, bf16: bool = False,
                            tensor_cores: Optional[bool] = None) -> BackwardPlan:
    """The plan for q [B, Lq, H, Dh] and k, v [B, Lk, H, Dh].  A lane holds
    the next power of two of ceil(Dh / 32) dims (1 to 8); a key tile the
    least power of two of keys, at least 4, that holds Lk, up to 32 / that
    for the row kernel (a warp's k rows of a tile fill at most 32 registers
    a lane) and up to 16 (8 at 8 dims a lane) for the tile kernel, whose
    warps reduce a row's scores and dP' together.  The tile kernel's row
    tiles take as many rows, up to MAX_ROW_TILE, as its shared memory holds
    within 227 KB (at most 115 KB at 32 rows, so always MAX_ROW_TILE), a
    CTA 8 warps (4 for up to 128 scores a row tile), and its shared memory
    holds the k and v tiles, the q, dO and o rows (zero-padded to 32 dims a
    lane), and a row tile's P', dS, row max, exp sum and keep bytes.  Past
    CHUNK_DIMS dims one query row takes the wide row kernel (a warp a (b,
    head), 8 dims a lane of each chunk of 256, key tiles of WIDE_KEYS); more
    take the tensor-core kernels ("tile_wide_tc"): a CTA of 8 warps a (b,
    head, tile of WIDE_TILE rows) for dQ, then one a (b, head, tile of
    WIDE_TILE keys) for dK and dV, ``blocks`` both grids' CTAs; up to
    WIDE_TILE keys one grid, a CTA a (b, head), takes all three.  In ``bf16`` they
    run at every such shape.  In f32 they run past WIDE_TILE keys up to
    WIDE_OUT dims, and past WIDE_OUT dims below SPLIT_MAX_HEADS (b, head)
    pairs; elsewhere the SIMT "tile_wide" kernel stays (a CTA a (b, head) of
    WIDE_ROWS warps, a warp a row, per-lane fmaf chains over key tiles of
    WIDE_KEYS), which measured faster there on the H100 (80GB HBM3, 700.00
    W; ``chip_smoke.py``, phase 2i's ``tensor_core_ms`` against
    ``simt_ms``, ms, PERF.md §6): vp_train_wide's encoder 5 x 5 and cross
    15 x 3 at Dh 512, B 512, 0.3972 / 0.5116 against 0.2142 / 0.3739;
    causal 15 x 15 at Dh 257 / 1024 / 2048, B 64, 0.1398 / 0.3696 / 0.8657
    against 0.1218 / 0.2315 / 0.4572; 96 x 96 at Dh 2048, B 64, 37.08
    against 25.02.  The rule keeps one kernel at one key tile and one past
    WIDE_OUT dims, so it also keeps the SIMT kernel at 15 x 15 Dh 320 and
    512 (B 512 at 512), where the tensor cores came 7% and 5% faster
    (0.0870 / 0.7081 against 0.0937 / 0.7491), and at 96 x 96 Dh 1024
    (12.28 against 12.18).  Where it takes the tensor cores, 96 x 96 at Dh
    257 / 320 / 512 took 5.398 / 2.969 / 23.86 against 6.219 / 4.552 /
    40.99.  At one key tile the tensor-core kernels' launch
    is one pair and its latency (3xTF32, one CTA an SM), and past WIDE_OUT
    dims they take the scores again for each output chunk of WIDE_OUT dims.
    ``tensor_cores`` True forces the tensor-core kernels,
    False the SIMT one (f32 only), for more than one query row past 256
    dims (else a ``ValueError``).
    More than one row tile (MAX_ROW_TILE rows) past SPLIT_KEYS keys at up
    to 256 dims, at fewer than SPLIT_MAX_HEADS (b, head) pairs, takes the
    split ("tile_split", ``csrc/attention_backward_split.cu``): the tile
    kernel's rows and shared memory at SPLIT_TILE_KEYS keys a tile (the
    same bits at any tile), 8 warps a CTA, B H (key tiles + row tiles) CTAs
    in place of B H, so a 5000 x 5000 backward at B 2 fills the card.  With
    one row tile the split's dQ grid is the tile kernel's own B H CTAs,
    each walking every key tile, and where B H CTAs fill the card the
    split's second pass of score work costs more than the idle SMs it
    fills: both make it slower (on the H100 in f32 at 15 x 2500, B 16, 32
    and 64: 1.203, 1.729 and 3.046 ms against 1.108, 1.313 and 1.999), so
    the tile kernel stays there.  The rule leaves every plan up to
    SPLIT_KEYS keys as it was.  ``split`` True forces the split, False the
    tile kernel, for more than one query row at up to 256 dims (else a
    ``ValueError``); None, the default, is the rule."""
    if split is not None and (Lq == 1 or Dh > CHUNK_DIMS):
        raise ValueError(f"attention: the split backward's choice takes more than one query "
                         f"row of at most {CHUNK_DIMS} dims, got Lq {Lq}, Dh {Dh}")
    if tensor_cores is not None and (Lq == 1 or Dh <= CHUNK_DIMS or
                                     (bf16 and not tensor_cores)):
        raise ValueError(f"attention: the wide backward's choice takes more than one query "
                         f"row past {CHUNK_DIMS} dims (the SIMT kernel f32 only), got Lq {Lq}, "
                         f"Dh {Dh}, bf16 {bf16}")
    if Dh > CHUNK_DIMS:
        if Lq == 1:
            return BackwardPlan("row_wide", 8, WIDE_KEYS, 1, 256, -(-B * H // 8), 0)
        if tensor_cores is None:
            tensor_cores = bf16 or (Lk > WIDE_TILE and (Dh <= WIDE_OUT
                                                        or B * H < SPLIT_MAX_HEADS))
        if not tensor_cores:
            rows = min(Lq, WIDE_ROWS)
            smem = 4 * (2 * WIDE_KEYS * CHUNK_DIMS + 3 * rows * CHUNK_DIMS
                        + 2 * rows * WIDE_KEYS + 2 * rows) + rows * WIDE_KEYS
            return BackwardPlan("tile_wide", 8, WIDE_KEYS, rows, 32 * WIDE_ROWS, B * H, smem)
        grids = 1 if Lk <= WIDE_TILE else -(-Lq // WIDE_TILE) + -(-Lk // WIDE_TILE)
        return BackwardPlan("tile_wide_tc", 8, WIDE_TILE, WIDE_TILE, 256, B * H * grids,
                            wide_backward_smem_bytes(Dh))
    per_lane = _pow2_at_least(math.ceil(Dh / 32))
    keys = max(4, _pow2_at_least(min(Lk, 32)))
    if Lq == 1:
        return BackwardPlan("row", per_lane, min(keys, 32 // per_lane), 1, 256, -(-B * H // 8),
                            0)
    if split is None:
        split = Lk > SPLIT_KEYS and Lq > MAX_ROW_TILE and B * H < SPLIT_MAX_HEADS
    keys = SPLIT_TILE_KEYS if split else min(keys, 16, 64 // per_lane)
    width = 32 * per_lane
    per_row = 4 * (3 * width + 2 * keys + 2) + keys
    rows = min(Lq, MAX_ROW_TILE, (SMEM_BYTES - 4 * 2 * keys * width) // per_row)
    smem = 4 * (2 * keys * width + 3 * rows * width + 2 * rows * keys + 2 * rows) + rows * keys
    if split:  # 8 warps a CTA, a warp two rows at a time
        return BackwardPlan("tile_split", per_lane, keys, rows, 256,
                            B * H * (-(-Lk // keys) + -(-Lq // rows)), smem)
    warps = 4 if rows * keys <= 128 else 8  # the faster of the two on the H100's shapes
    return BackwardPlan("tile", per_lane, keys, rows, 32 * warps, B * H, smem)


def backward_mode(plan: BackwardPlan) -> str:
    """The launch-count mode suffix of a backward plan's kernels: "" for the
    row and tile kernels, "_split" for the split, "_wide" past 256 dims."""
    modes = {"row_wide": "_wide", "tile_wide": "_wide", "tile_wide_tc": "_wide",
             "tile_split": "_split"}
    return modes.get(plan.kernel, "")


class ForwardPlan(NamedTuple):
    """The serving and training kernels' launch (``csrc/attention.cu``):
    ``kernel`` is "row" (one query row: a warp a (b, row, head), four a CTA,
    the row's ``keys`` scores in shared memory; a lane holds up to
    ``per_lane`` = 8 dims), "row_wide" (the same past 256 dims, a head in
    chunks of 256), "row_split" (one query row past SPLIT_KEYS keys: a warp a
    (b, head, split) of ``keys`` keys, ``threads // 32`` a CTA, ``blocks``
    CTAs, :func:`row_split_plan`), "tile" (a CTA a (b, head, row tile of ``rows`` rows), k
    and v staged in key tiles of ``keys`` keys, a warp taking ``group`` rows
    at once, each row's scores resident in shared memory; a lane holds
    ``per_lane`` dims of a row) or "stream" (a warp ``group`` = 16 rows on
    the tensor cores, past 128 dims ``threads // 32`` warps splitting the
    16 rows' dims, the scores recomputed a key tile at a time: a pass for
    the row statistics, then one for P . v a chunk of 32 ``per_lane``
    output dims)."""
    kernel: str
    per_lane: int
    keys: int
    rows: int
    group: int
    threads: int
    blocks: int
    smem_bytes: int


def score_stride(Lk: int) -> int:
    """Floats a row of the tile kernel's score buffer: Lk rounded up to 32,
    plus 8 (a warp's four rows start 8 banks apart)."""
    return -(-Lk // 32) * 32 + 8


def stream_keys(per_lane: int) -> int:
    """The streamed kernel's keys a tile: 64 up to 64 dims, else 32 (a
    warp's output and its scores share a lane's registers with a key
    tile's output from zero) (``csrc/attention.cu:stream_keys``)."""
    return 32 if per_lane >= 4 else 64


def stream_smem_bytes(per_lane: int, warps: int) -> int:
    """The streamed kernel's shared memory in f32 (bf16 takes less) for
    ``warps`` warps, each row 16 bytes longer than its values: up to 128
    dims the row tile's q rows (16 a warp) and two slots of a key tile's k
    or v rows; past them (8 dims a lane) the STREAM_SPLIT warps' partial
    scores and two slots of the 16 rows' q chunk of 256 dims and the key
    tile's k rows, or of its v rows; and the training mode's, counted here,
    in each slot the rows' keep bytes of a key tile, 4 more a row
    (``csrc/attention.cu:stream_smem_bytes``)."""
    keys, row = stream_keys(per_lane), 32 * per_lane + 4
    keep = lambda rows: -(-rows * (keys + 4) // 16) * 16  # a slot's keep bytes
    if per_lane == 8:
        return 4 * 2 * (16 + keys) * row + 2 * keep(16) + 4 * STREAM_SPLIT * 32 * keys // 2
    return 4 * (16 * warps + 2 * keys) * row + 2 * keep(16 * warps)


def row_split_plan(B: int, Lk: int, H: int, Dh: int) -> ForwardPlan:
    """The split row kernels' plan (``csrc/attention.cu``) for one query row
    of q [B, 1, H, Dh] over k, v [B, Lk, H, Dh], Dh at most 256: a lane
    holds the next power of two of ceil(Dh / 32) dims; each (b, head)'s keys
    are cut into S splits of ``keys`` keys (a multiple of ROW_SPLIT_TILE), S
    the least of ceil(ROW_SPLIT_WARPS / (B H)) and ceil(Lk /
    ROW_SPLIT_MIN_KEYS) (at least 1), so that B H S warps fill the H100 at
    B 4 as at B 64; a warp a split, 4 a CTA (2 at 8 dims a lane);
    ``blocks`` the CTAs of the score and P . v launches; shared memory each
    warp's two slots of ROW_SPLIT_TILE rows of 32 ``per_lane`` f32 values
    (bf16 takes half).  S = :func:`row_split_splits`."""
    per_lane = _pow2_at_least(math.ceil(Dh / 32))
    warps = 2 if per_lane == 8 else 4
    splits = max(1, min(-(-Lk // ROW_SPLIT_MIN_KEYS), -(-ROW_SPLIT_WARPS // (B * H))))
    per_split = -(-Lk // splits)
    keys = -(-per_split // ROW_SPLIT_TILE) * ROW_SPLIT_TILE  # rounded up to a tile
    items = B * H * -(-Lk // keys)
    return ForwardPlan("row_split", per_lane, keys, 1, 1, 32 * warps, -(-items // warps),
                       4 * warps * 2 * ROW_SPLIT_TILE * 32 * per_lane)


def row_split_splits(Lk: int, plan: ForwardPlan) -> int:
    """S, the splits of a (b, head)'s keys under a "row_split" plan."""
    return -(-Lk // plan.keys)


def row_split_scratch(B: int, H: int, Lk: int, Dh: int, plan: ForwardPlan) -> Tuple[int, ...]:
    """The f32 scratch the split row kernels read and write, in floats:
    (each split's max and exp sum [B, H, S, 2], each seen key's score [B, H,
    Lk], each split's P . v [B, H, S, Dh], none for one split)."""
    S = row_split_splits(Lk, plan)
    return 2 * B * H * S, B * H * Lk, B * H * S * Dh if S > 1 else 0


def attention_forward_plan(B: int, Lq: int, Lk: int, H: int, Dh: int,
                           stream: bool = False, split_row: Optional[bool] = None
                           ) -> ForwardPlan:
    """The forward's plan for q [B, Lq, H, Dh] and k, v [B, Lk, H, Dh].  One
    query row takes the row kernel (4 warps a CTA, Lk floats of scores a
    warp; past 256 dims its wide variant) up to SPLIT_KEYS keys, past them
    (at up to 256 dims) the split row kernels (:func:`row_split_plan`);
    ``split_row`` True takes those and False the row kernel for one query
    row at up to 256 dims whatever Lk (else a ``ValueError``).  More take the tile kernel: a
    lane holds the next power of two of ceil(Dh / 32) dims (1 to 8); a key
    tile holds Lk rounded up to 8 keys, at most 256 / dims a lane (its k
    rows, later its v rows, in one buffer of at most 32 KB as f32); a row
    tile up to MAX_ROW_TILE rows, a multiple of FORWARD_GROUP where the score
    buffer (rows x :func:`score_stride` floats) and the rows' keep bytes
    must shrink to keep shared memory within the H100's 227 KB (16 rows at
    2048 keys); a warp a group of 4 rows.  Where that leaves fewer than
    min(Lq, STREAM_ROWS) rows (past about 2490 keys), past 256 dims, or
    with ``stream``, the streamed kernel on the tensor cores: row tiles of
    up to STREAM_MAX_ROWS rows, a warp STREAM_GROUP of them (past 128 dims,
    ``per_lane`` 8, one group of 16 rows on STREAM_SPLIT warps, each a
    quarter of the head's chunks of 256 dims), key tiles of
    :func:`stream_keys`, shared memory (:func:`stream_smem_bytes`, f32)
    whatever Lk."""
    if split_row is not None and (Lq > 1 or Dh > CHUNK_DIMS):
        raise ValueError(f"attention: the split row kernels' choice takes one query row of at "
                         f"most {CHUNK_DIMS} dims, got Lq {Lq}, Dh {Dh}")
    if Lq <= 1 and (Lk > SPLIT_KEYS and Dh <= CHUNK_DIMS if split_row is None else split_row):
        return row_split_plan(B, Lk, H, Dh)
    if Lq <= 1:
        return ForwardPlan("row" if Dh <= CHUNK_DIMS else "row_wide", 8, Lk, 1, 1,
                           32 * ROW_WARPS, -(-B * Lq * H // ROW_WARPS), 4 * ROW_WARPS * Lk)
    wide = Dh > CHUNK_DIMS
    per_lane = 8 if wide else _pow2_at_least(math.ceil(Dh / 32))
    if not (wide or stream):
        keys = min(-(-Lk // 8) * 8, 256 // per_lane)
        staged = 4 * keys * 32 * per_lane
        fit = (SMEM_BYTES - staged - 15) // (4 * score_stride(Lk) + Lk)
        rows = min(Lq, MAX_ROW_TILE, fit - fit % FORWARD_GROUP)
        if rows >= min(Lq, STREAM_ROWS):
            return ForwardPlan("tile", per_lane, keys, rows, FORWARD_GROUP,
                               32 * -(-rows // FORWARD_GROUP), B * H * -(-Lq // rows),
                               staged + 4 * rows * score_stride(Lk) + -(-rows * Lk // 16) * 16)
    split = per_lane == 8
    rows = min(Lq, STREAM_GROUP if split else STREAM_MAX_ROWS)
    warps = STREAM_SPLIT if split else -(-rows // STREAM_GROUP)
    return ForwardPlan("stream", per_lane, stream_keys(per_lane), rows, STREAM_GROUP, 32 * warps,
                       B * H * -(-Lq // rows), stream_smem_bytes(per_lane, warps))


def forward_mode(plan: ForwardPlan, Dh: int) -> str:
    """The launch-count mode suffix of a forward plan's kernel: "" for the
    row and tile kernels, "_stream" for the streamed kernel at up to 256
    dims, "_rowsplit" for the split row kernels, "_wide" past 256 dims (the
    wide row and streamed kernels)."""
    if Dh > CHUNK_DIMS:
        return "_wide"
    return {"stream": "_stream", "row_split": "_rowsplit"}.get(plan.kernel, "")


@functools.lru_cache(maxsize=None)
def _forward_launch():
    """The serving and training kernels' launcher, its signature set once."""
    fn = build.load("attention").attention_launch
    fn.argtypes = [ctypes.POINTER(_AttentionArgs), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# the library of each backward plan's kernels (the row and tile kernels' by default)
BACKWARD_LIBRARIES = {"tile_split": "attention_backward_split",
                      "tile_wide_tc": "attention_backward_wide"}


@functools.lru_cache(maxsize=None)
def _backward_launch(lib: str):
    """The launcher of a backward library (``BACKWARD_LIBRARIES``), its
    signature set once."""
    fn = getattr(build.load(lib), f"{lib}_launch")
    fn.argtypes = [ctypes.POINTER(_AttentionBackwardArgs), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"attention: {name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _check_qkv(q, k, v, kv_len0, keep):
    """Checks the kernels' inputs; returns (B, Lq, Lk, H, Dh, kv_len0)."""
    _elem(q, k, v)
    B, Lq, H, Dh = q.shape
    Lk = k.shape[1]
    for name, t, shape in (("q", q, (B, Lq, H, Dh)), ("k", k, (B, Lk, H, Dh)),
                           ("v", v, (B, Lk, H, Dh))):
        _check(name, t, shape, q.dtype, q.device)
    if keep is not None:
        _check("keep", keep, (B, H, Lq, Lk), torch.uint8, q.device)
    kv_len0 = Lk if kv_len0 is None else int(kv_len0)
    if not (Dh >= 1 and Lk >= 1 and kv_len0 >= 1):
        raise ValueError(f"attention: needs Dh >= 1, Lk >= 1 and kv_len0 >= 1, got Dh {Dh}, "
                         f"Lk {Lk}, kv_len0 {kv_len0}")
    return B, Lq, Lk, H, Dh, kv_len0


def _launch_forward(q, k, v, kv_len0, o, train: bool, keep=None, rate: float = 0.0,
                    row_max=None, row_sum=None, stream: bool = False,
                    split_row: Optional[bool] = None) -> str:
    """Launches the plan's kernel (the split row kernels' scratch from
    ``torch.empty``); returns its launch-count mode suffix
    (:func:`forward_mode`)."""
    B, Lq, Lk, H, Dh, kv_len0 = _check_qkv(q, k, v, kv_len0, keep)
    plan = attention_forward_plan(B, Lq, Lk, H, Dh, stream, split_row)
    if plan.smem_bytes > SMEM_BYTES:  # the row kernels' scores past MAX_LK keys
        raise ValueError(f"attention: one query row on the row kernels (past {CHUNK_DIMS} dims, "
                         f"or forced) takes at most {MAX_LK} keys on the card, got Lk {Lk}")
    ptr = lambda t: None if t is None else t.data_ptr()
    args = _AttentionArgs(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), o=o.data_ptr(),
                          B=B, Lq=Lq, Lk=Lk, H=H, Dh=Dh, kv_len0=kv_len0, scale=Dh ** 0.5,
                          keep=ptr(keep), keep_prob=1.0 - rate, row_max=ptr(row_max),
                          row_sum=ptr(row_sum), per_lane=plan.per_lane, keys=plan.keys,
                          rows=plan.rows, group=plan.group,
                          stream=int(plan.kernel in ("stream", "row_split")))
    ref = ctypes.byref(args)
    if plan.kernel == "row_split":  # the args lead a _RowSplitArgs
        sizes = row_split_scratch(B, H, Lk, Dh, plan)
        scratch = torch.empty(sum(sizes), device=q.device).split(sizes)
        split_args = _RowSplitArgs(args, *(ptr(t) if n else None for t, n in zip(scratch, sizes)))
        ref = ctypes.cast(ctypes.pointer(split_args), ctypes.POINTER(_AttentionArgs))
    err = _forward_launch()(ref, int(train), _elem(q, k, v),
                            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch ({plan.kernel} plan {tuple(plan)}) failed "
                           f"with CUDA error {err}")
    return forward_mode(plan, Dh)


def attention_train_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            kv_len0: int | None = None, keep: Optional[torch.Tensor] = None,
                            rate: float = 0.0, stream: bool = False,
                            split_row: Optional[bool] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The training mode: (o, row max, row exp sum), the statistics f32
    [B, H, Lq] that :func:`attention_backward` reads; ``keep`` (u8
    [B, H, Lq, Lk]) drops probabilities at ``rate``.  CPU tensors take
    :func:`attention_train_forward_plain`.  ``stream`` takes the streamed
    kernel for more than one query row whatever its plan (its bits are
    within ulps of the resident kernel's); ``split_row`` True takes the
    split row kernels and False the row kernel for one query row whatever
    the rule (o within ulps of each other; the statistics feed the row
    backward either way)."""
    if q.device.type == "cpu":
        return attention_train_forward_plain(q, k, v, kv_len0, keep, rate)
    B, Lq, H, _ = q.shape
    o = torch.empty_like(q)
    row_max = torch.empty(B, H, Lq, device=q.device)
    row_sum = torch.empty(B, H, Lq, device=q.device)
    mode = _launch_forward(q, k, v, kv_len0, o, True, keep, rate, row_max, row_sum, stream,
                           split_row)
    count_launch(attention_train_forward, MODES[_elem(q, k, v)] + mode)
    return o, row_max, row_sum


def attention_backward(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, row_max: torch.Tensor, row_sum: torch.Tensor,
                       kv_len0: int | None = None, keep: Optional[torch.Tensor] = None,
                       rate: float = 0.0, split: Optional[bool] = None,
                       tensor_cores: Optional[bool] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the training mode's output from its gradient ``dout``,
    its inputs, its output and its row statistics, at any number of query
    rows and keys and any head width.  CPU tensors take
    :func:`attention_backward_plain`; CUDA tensors launch the kernels of
    :func:`attention_backward_plan`.  For more than one query row ``split``
    True takes the split kernels and False the one-CTA tile kernel whatever
    the rule (the two give the same bits); past 256 dims ``tensor_cores``
    True takes the tensor-core kernels and False (f32) the SIMT tile kernel
    whatever the rule."""
    if q.device.type == "cpu":
        return attention_backward_plain(dout, q, k, v, o, row_max, row_sum, kv_len0, keep, rate)
    B, Lq, Lk, H, Dh, kv_len0 = _check_qkv(q, k, v, kv_len0, keep)
    for name, t, shape, dtype in (("dout", dout, q.shape, q.dtype), ("o", o, q.shape, q.dtype),
                                  ("row_max", row_max, (B, H, Lq), torch.float32),
                                  ("row_sum", row_sum, (B, H, Lq), torch.float32)):
        _check(name, t, shape, dtype, q.device)
    elem = _elem(q, k, v)
    plan = attention_backward_plan(B, Lq, Lk, H, Dh, split, bf16=elem == 1,
                                   tensor_cores=tensor_cores)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # bf16: each row's D, and the dQ chains in f32 between key tiles (the
    # tile kernel; past 256 dims the row kernel).  Past 256 dims for more
    # rows, in both types: each row's max_acc and D from the dQ grid for the
    # dK/dV grid (not for one key tile, whose one grid takes them itself).
    lib = BACKWARD_LIBRARIES.get(plan.kernel, "attention_backward")
    wide_tc = plan.kernel == "tile_wide_tc"
    stats = wide_tc and Lk > WIDE_TILE
    delta = torch.empty(B, H, Lq, device=q.device) if (elem and not wide_tc) or stats else None
    row_max_acc = torch.empty(B, H, Lq, device=q.device) if stats else None
    dq_acc = (torch.empty(q.shape, device=q.device)
              if elem and plan.kernel in ("tile", "row_wide") else None)
    args = _AttentionBackwardArgs(
        dout=dout.data_ptr(), q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
        o=None if elem else o.data_ptr(),  # bf16 takes D from dP', not from o
        row_max=row_max.data_ptr(), row_sum=row_sum.data_ptr(),
        keep=None if keep is None else keep.data_ptr(), dq=dq.data_ptr(), dk=dk.data_ptr(),
        dv=dv.data_ptr(), B=B, Lq=Lq, Lk=Lk, H=H, Dh=Dh, kv_len0=kv_len0, scale=Dh ** 0.5,
        keep_prob=1.0 - rate, per_lane=plan.per_lane, keys=plan.keys, rows=plan.rows,
        warps=plan.threads // 32, delta=None if delta is None else delta.data_ptr(),
        dq_acc=None if dq_acc is None else dq_acc.data_ptr(),
        row_max_acc=None if row_max_acc is None else row_max_acc.data_ptr())
    err = _backward_launch(lib)(ctypes.byref(args), elem,
                                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_backward kernel launch failed with CUDA error {err}")
    count_launch(attention_backward, MODES[elem] + backward_mode(plan))
    return dq, dk, dv


class _AttentionFunction(torch.autograd.Function):
    """The kernels under autograd: the training forward saves its row
    statistics, the backward kernel reads them."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len0, keep, rate):
        o, row_max, row_sum = attention_train_forward(q, k, v, kv_len0, keep, rate)
        ctx.save_for_backward(q, k, v, o, row_max, row_sum, keep)
        ctx.kv_len0, ctx.rate = kv_len0, rate
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, row_max, row_sum, keep = ctx.saved_tensors
        dq, dk, dv = attention_backward(dout.contiguous(), q, k, v, o, row_max, row_sum,
                                        ctx.kv_len0, keep, ctx.rate)
        return dq, dk, dv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_len0: int | None = None, keep: Optional[torch.Tensor] = None,
              rate: float = 0.0) -> torch.Tensor:
    """softmax(q . k^T / sqrt(Dh)) . v, query row r over the first
    ``min(Lk, kv_len0 + r)`` keys (all keys if ``kv_len0`` is None), the
    probabilities dropped at ``rate`` where ``keep`` (u8 [B, H, Lq, Lk]) is 0.
    CPU tensors take :func:`attention_plain` (autograd differentiates it).
    CUDA tensors: where autograd needs a gradient of q, k or v, the training
    forward and the backward kernel; else with ``keep`` the training forward,
    without it the serving kernel; at any head width and any number of
    keys, but at up to MAX_LK keys for one query row of more than 256
    dims (JAX's positional table stops the MTIO at 5000)."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_len0, keep, rate)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _AttentionFunction.apply(q, k, v, kv_len0, keep, rate)
    if keep is not None:
        return attention_train_forward(q, k, v, kv_len0, keep, rate)[0]
    o = torch.empty_like(q)
    mode = _launch_forward(q, k, v, kv_len0, o, False)
    count_launch(attention, MODES[_elem(q, k, v)] + mode)
    return o


for _wrapper in (attention, attention_train_forward, attention_backward):
    _wrapper.launches = 0
    _wrapper.launches_by_mode = {}
