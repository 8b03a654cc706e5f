"""Transformer encoder/decoder with an Informer-style distillation layer.

Port of the JAX package's ``models/transformer.py`` (reference
``viewport_prediction/models/customized_transformer.py``): post-norm
residual blocks (LayerNorm eps 1e-5), ReLU feed-forward, a final LayerNorm
after both stacks, and a ``DistillLayer`` halving the encoder memory
between encoder and decoder.  Attention keeps the JAX layout
([B, L, H, Dh]) and its softmax core is K8 (``kernels/attention.py``);
every mask is a prefix of the keys, given as ``kv_len0`` (query row r sees
``min(Lk, kv_len0 + r)`` keys).

Training mode: every forward takes ``gen``, a ``torch.Generator`` in
training and None in the deterministic (serving) mode, as the JAX modules
take ``deterministic``.  In training, dropout runs at the JAX sites and
rates (:func:`dropout`: the attention probabilities, each residual branch
and the feed-forward hidden layer, 0.1), its keep masks drawn from ``gen``
by torch ops outside the kernels, so a run through the plain versions with
the same generator seed sees the same masks; the distillation layer's
BatchNorm normalises with the batch statistics and updates its running
ones.  :meth:`DecoderLayer.step_train` is the decode step whose cache is
out of place, for autograd; :meth:`DecoderLayer.step` writes it in place,
for ``sample`` under ``no_grad``.

Data parallelism (``parallel/mesh.py``): inside :func:`batch_shard` a
training forward computes one rank's rows of a global batch, as JAX's
sharded step computes the global one.  Each keep mask is drawn at the
global batch and the rank keeps its rows, so every rank's generator stays
in step with a one-process run's; the distillation layer's BatchNorm takes
its statistics over the global batch (the sums of h and h^2 and the count,
summed over the ranks, differentiably).

Compute dtype (``dtype``, the JAX modules' ``dtype``; bf16 for
``run_models --bf16``): parameters stay f32.  Each Dense (:class:`Dense`)
and the distillation layer's conv cast their input, weight and bias to the
compute dtype and return it, the product summed in f32 and rounded, then
the bias added in that dtype (Flax's ``dot_general``, then ``y += bias``:
two roundings).  The norms compute in f32 and return f32 (Flax promotes a
bf16 input with its f32 scale and bias), so the residual stream, the
distillation's batch statistics and the memory are f32, and the attention's
q, k and v, the KV caches and the feed-forward's hidden layer bf16.

Module names follow the Flax tree where it uses ``setup`` (``sa``, ``ca``,
``ff``, ``norm1-3``); ``utils/checkpoint.py`` maps the ``nn.compact`` names
(``MHA_0``, ``LayerNorm_0/1``, ``FeedForward_0/Dense_0/1``, ``Conv_0``,
``BatchNorm_0``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mansy_immersivevideostreaming_torch.kernels.attention import attention
from mansy_immersivevideostreaming_torch.parallel.mesh import Mesh, all_reduce_sum

KV = Tuple[torch.Tensor, torch.Tensor]
Gen = Optional[torch.Generator]

DROPOUT = 0.1   # Transformer's dropout (transformer.py:206; mtio.py:63-66 passes none)
BN_MOMENTUM = 0.9
F32 = torch.float32


class BatchShard(NamedTuple):
    """A rank's share of a training forward: the mesh, the rank's rows and
    the global batch size."""
    mesh: Mesh
    rows: slice
    total: int


_SHARD: contextvars.ContextVar = contextvars.ContextVar("batch_shard", default=None)


@contextlib.contextmanager
def batch_shard(mesh: Mesh, total: int) -> Iterator[BatchShard]:
    """Training forwards inside the context compute ``mesh``'s rows of a
    global batch of ``total`` (see the module docstring)."""
    shard = BatchShard(mesh, mesh.rows(total), total)
    token = _SHARD.set(shard)
    try:
        yield shard
    finally:
        _SHARD.reset(token)


def current_shard() -> Optional[BatchShard]:
    """The :func:`batch_shard` the forward runs in, or None."""
    return _SHARD.get()


def keep_mask(shape, rate: float, gen: torch.Generator, device) -> torch.Tensor:
    """flax's Dropout keep mask: a uniform draw from ``gen`` below
    ``1 - rate`` (``random.bernoulli(rng, keep_prob)``), as bool.  Inside
    :func:`batch_shard`, drawn at the global batch, the rank's rows kept."""
    shard = current_shard()
    if shard is None:
        return torch.rand(shape, generator=gen, device=device) < 1.0 - rate
    u = torch.rand((shard.total,) + tuple(shape[1:]), generator=gen, device=device)
    return u[shard.rows] < 1.0 - rate


def dropout(x: torch.Tensor, rate: float, gen: Gen) -> torch.Tensor:
    """flax's ``Dropout``: the identity when deterministic (``gen`` None) or
    at rate 0; else x / keep_prob where kept and 0 elsewhere."""
    if gen is None or rate == 0.0:
        return x
    keep = keep_mask(x.shape, rate, gen, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Dense(nn.Linear):
    """flax's ``nn.Dense(dtype=dtype)`` on f32 parameters: in f32 the plain
    linear; otherwise input, weight and bias cast to ``dtype``, the product
    summed in f32 and rounded to ``dtype``, then the bias added in
    ``dtype`` (``F.linear`` with the bias would round once).

    ``f32_sum``: the (bf16) bias added in f32 to the rounded product, and
    the sum returned in f32, unrounded.  That is what the JAX module computes where
    an f32 op takes the Dense's output (the residual adds after the out
    projection and the feed-forward, the positional encoding after the
    embedding): XLA drops the sum's round trip through bf16 (its
    ``xla_allow_excess_precision``, on by default)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = F32,
                 device=None, f32_sum: bool = False):
        super().__init__(in_features, out_features, device=device)
        self.compute_dtype, self.f32_sum = dtype, f32_sum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == F32:
            return F.linear(x, self.weight, self.bias)
        dt = self.compute_dtype
        y = F.linear(x.to(dt), self.weight.to(dt))
        b = self.bias.to(dt)
        return y.float() + b.float() if self.f32_sum else y + b


class MHA(nn.Module):
    """Multi-head attention with a KV-cache path (``transformer.py:25-79``):
    :meth:`project_kv` gives the cacheable (k, v), :meth:`attend` runs the
    query and out projections around the K8 core, with the probabilities'
    dropout in training; q, k, v and the output in the compute dtype."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = DROPOUT,
                 dtype: torch.dtype = F32, device=None):
        super().__init__()
        self.num_heads, self.dropout = num_heads, dropout
        self.query = Dense(d_model, d_model, dtype, device)
        self.key = Dense(d_model, d_model, dtype, device)
        self.value = Dense(d_model, d_model, dtype, device)
        self.out = Dense(d_model, d_model, dtype, device, f32_sum=True)

    def _split(self, y: torch.Tensor) -> torch.Tensor:
        return y.reshape(y.shape[0], y.shape[1], self.num_heads, -1)

    def project_kv(self, kv_in: torch.Tensor) -> KV:
        """(k, v), each [B, L, H, Dh]."""
        return self._split(self.key(kv_in)), self._split(self.value(kv_in))

    def attend(self, q_in: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_len0: Optional[int] = None, gen: Gen = None) -> torch.Tensor:
        """Attention of ``q_in`` [B, Lq, D] over projected ``k``/``v``."""
        B, Lq, D = q_in.shape
        keep = None
        if gen is not None and self.dropout > 0.0:
            keep = keep_mask((B, self.num_heads, Lq, k.shape[1]), self.dropout, gen,
                             q_in.device).view(torch.uint8)
        o = attention(self._split(self.query(q_in)), k, v, kv_len0, keep, self.dropout)
        return self.out(o.reshape(B, Lq, D))

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                kv_len0: Optional[int] = None, gen: Gen = None) -> torch.Tensor:
        return self.attend(q_in, *self.project_kv(kv_in), kv_len0, gen)


class FeedForward(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int, dropout: float = DROPOUT,
                 dtype: torch.dtype = F32, device=None):
        super().__init__()
        self.dropout = dropout
        self.linear1 = Dense(d_model, dim_feedforward, dtype, device)
        self.linear2 = Dense(dim_feedforward, d_model, dtype, device, f32_sum=True)

    def forward(self, x: torch.Tensor, gen: Gen = None) -> torch.Tensor:
        return self.linear2(dropout(F.relu(self.linear1(x)), self.dropout, gen))


class EncoderLayer(nn.Module):
    """Post-norm self-attention + feed-forward block (``transformer.py:97-113``)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = DROPOUT, dtype: torch.dtype = F32, device=None):
        super().__init__()
        self.dropout = dropout
        self.attn = MHA(d_model, nhead, dropout, dtype, device)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.ff = FeedForward(d_model, dim_feedforward, dropout, dtype, device)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor, gen: Gen = None) -> torch.Tensor:
        x = self.norm1(x + dropout(self.attn(x, x, None, gen), self.dropout, gen))
        return self.norm2(x + dropout(self.ff(x, gen), self.dropout, gen))


class DecoderLayer(nn.Module):
    """Post-norm self-attention, cross-attention and feed-forward block
    (``transformer.py:116-165``)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = DROPOUT, dtype: torch.dtype = F32, device=None):
        super().__init__()
        self.dropout = dropout
        self.sa = MHA(d_model, nhead, dropout, dtype, device)
        self.ca = MHA(d_model, nhead, dropout, dtype, device)
        self.ff = FeedForward(d_model, dim_feedforward, dropout, dtype, device)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def _blocks(self, x: torch.Tensor, sa: torch.Tensor, mem_kv: KV, gen: Gen) -> torch.Tensor:
        """The residual blocks after the self-attention ``sa`` of ``x``."""
        x = self.norm1(x + dropout(sa, self.dropout, gen))
        x = self.norm2(x + dropout(self.ca.attend(x, *mem_kv, None, gen), self.dropout, gen))
        return self.norm3(x + dropout(self.ff(x, gen), self.dropout, gen))

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                kv_len0: Optional[int] = None, gen: Gen = None) -> torch.Tensor:
        return self._blocks(x, self.sa(x, x, kv_len0, gen), self.ca.project_kv(memory), gen)

    def step(self, x_t: torch.Tensor, sa_cache: KV, t: int, mem_kv: KV) -> torch.Tensor:
        """One decode step at position ``t`` (``transformer.py:141-165``):
        ``x_t`` [B, 1, D]; the new k/v go into slot t of the preallocated
        [B, L, H, Dh] ``sa_cache``, in place (JAX's ``dynamic_update_slice``
        returns a new cache), and attention sees slots <= t, which makes the
        output column t of the full causal decode."""
        k_cache, v_cache = sa_cache
        k_t, v_t = self.sa.project_kv(x_t)
        k_cache[:, t] = k_t[:, 0]
        v_cache[:, t] = v_t[:, 0]
        return self._blocks(x_t, self.sa.attend(x_t, k_cache, v_cache, t + 1), mem_kv, None)

    def step_train(self, x_t: torch.Tensor, sa_cache: KV, t: int, mem_kv: KV, gen: Gen
                   ) -> Tuple[torch.Tensor, KV]:
        """:meth:`step` for training: the cache with slot t replaced is a new
        tensor, as ``dynamic_update_slice`` gives (``:156-157``), so the
        tensors autograd saved at earlier steps stay as they were.  The
        masked slots > t get weight 0, in the forward and the backward.
        Returns (out_t, the new cache)."""
        k_t, v_t = self.sa.project_kv(x_t)
        k_cache, v_cache = (torch.cat([c[:, :t], new, c[:, t + 1:]], dim=1)
                            for c, new in zip(sa_cache, (k_t, v_t)))
        sa = self.sa.attend(x_t, k_cache, v_cache, t + 1, gen)
        return self._blocks(x_t, sa, mem_kv, gen), (k_cache, v_cache)


class DistillLayer(nn.Module):
    """Circular Conv1d(k3) + BatchNorm + ELU + MaxPool1d(k3, s2, p1) over
    time (``transformer.py:168-190``); the conv in the compute dtype, its
    (bf16) bias added in f32 to the rounded product, as :class:`Dense` with
    ``f32_sum`` (BatchNorm, an f32 op, takes the sum), the rest in f32."""

    def __init__(self, d_model: int, dtype: torch.dtype = F32, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv1d(d_model, d_model, kernel_size=3, device=device)
        self.bn = nn.BatchNorm1d(d_model, eps=1e-5, momentum=0.1, device=device)

    def _batch_norm_train(self, h: torch.Tensor) -> torch.Tensor:
        """flax's ``BatchNorm(use_running_average=False, momentum=0.9)`` on
        h [B, D, L]: the batch mean and variance over (B, L), the variance
        as E[h^2] - E[h]^2 clipped at 0 (``use_fast_variance``); the output
        normalised by the biased variance; the running statistics updated
        as 0.9 * running + 0.1 * batch with that (biased) variance, which
        ``nn.BatchNorm1d`` would take unbiased.  Inside :func:`batch_shard`
        the statistics are the global batch's."""
        bn = self.bn
        shard = current_shard()
        if shard is None:
            mean = h.mean((0, 2))
            var = torch.clamp((h * h).mean((0, 2)) - mean * mean, min=0.0)
        else:
            D = h.shape[1]
            count = h.new_full((1,), float(h.shape[0] * h.shape[2]))
            sums = all_reduce_sum(shard.mesh, torch.cat([h.sum((0, 2)), (h * h).sum((0, 2)),
                                                         count]))
            mean = sums[:D] / sums[-1]
            var = torch.clamp(sums[D:2 * D] / sums[-1] - mean * mean, min=0.0)
        with torch.no_grad():
            for running, batch in ((bn.running_mean, mean), (bn.running_var, var)):
                running.copy_(BN_MOMENTUM * running + (1 - BN_MOMENTUM) * batch)
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        return (h - mean[:, None]) * mul[:, None] + bn.bias[:, None]

    def forward(self, x: torch.Tensor, gen: Gen = None) -> torch.Tensor:
        """x [B, L, D] -> [B, (L - 1) // 2 + 1, D].  BatchNorm on its running
        statistics whatever the module's mode when deterministic (``gen``
        None: the serving path's ``use_running_average=True``), on the
        batch's in training."""
        h = torch.cat([x[:, -1:], x, x[:, :1]], dim=1).transpose(1, 2)
        if self.dtype == F32:
            h = self.conv(h)
        else:
            dt, conv = self.dtype, self.conv
            h = F.conv1d(h.to(dt), conv.weight.to(dt)).float() + conv.bias.to(dt).float()[:, None]
        bn = self.bn
        if gen is None:
            h = F.batch_norm(h, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                             training=False, eps=bn.eps)
        else:
            h = self._batch_norm_train(h)
        # max_pool1d pads with -inf, as the JAX version does
        return F.max_pool1d(F.elu(h), kernel_size=3, stride=2, padding=1).transpose(1, 2)


class Transformer(nn.Module):
    """Encoder + DistillLayer + decoder (``transformer.py:198-262``), with
    the incremental decode (:meth:`init_decode_cache`, :meth:`decode_step`,
    :meth:`decode_step_train`)."""

    def __init__(self, d_model: int = 512, nhead: int = 8, num_encoder_layers: int = 2,
                 num_decoder_layers: int = 2, dim_feedforward: int = 512,
                 dropout: float = DROPOUT, dtype: torch.dtype = F32, device=None):
        super().__init__()
        self.d_model, self.nhead, self.dtype = d_model, nhead, dtype
        self.encoder_layers = nn.ModuleList(
            EncoderLayer(d_model, nhead, dim_feedforward, dropout, dtype, device)
            for _ in range(num_encoder_layers))
        self.encoder_norm = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.distill = DistillLayer(d_model, dtype, device)
        self.decoder_layers = nn.ModuleList(
            DecoderLayer(d_model, nhead, dim_feedforward, dropout, dtype, device)
            for _ in range(num_decoder_layers))
        self.decoder_norm = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def encode(self, src: torch.Tensor, gen: Gen = None) -> torch.Tensor:
        h = src
        for layer in self.encoder_layers:
            h = layer(h, gen)
        return self.distill(self.encoder_norm(h), gen)

    def decode(self, tgt: torch.Tensor, memory: torch.Tensor,
               kv_len0: Optional[int] = None, gen: Gen = None) -> torch.Tensor:
        """The full decode; ``kv_len0=1`` is the causal mask."""
        h = tgt
        for layer in self.decoder_layers:
            h = layer(h, memory, kv_len0, gen)
        return self.decoder_norm(h)

    def init_decode_cache(self, memory: torch.Tensor, max_len: int
                          ) -> Tuple[List[KV], List[KV]]:
        """Each decoder layer's cross-attention (k, v) of the memory, and
        zeroed [B, max_len, H, Dh] self-attention caches in the compute
        dtype (``transformer.py:242``)."""
        B = memory.shape[0]
        shape = (B, max_len, self.nhead, self.d_model // self.nhead)
        mem_kvs = [layer.ca.project_kv(memory) for layer in self.decoder_layers]
        sa_caches = [(memory.new_zeros(shape, dtype=self.dtype),
                      memory.new_zeros(shape, dtype=self.dtype))
                     for _ in self.decoder_layers]
        return mem_kvs, sa_caches

    def decode_step(self, x_t: torch.Tensor, sa_caches: Sequence[KV], t: int,
                    mem_kvs: Sequence[KV]) -> torch.Tensor:
        """Position ``t`` [B, 1, D] through every layer; equal to column t of
        :meth:`decode` under the causal mask.  The caches are written in
        place."""
        h = x_t
        for layer, cache, mem_kv in zip(self.decoder_layers, sa_caches, mem_kvs):
            h = layer.step(h, cache, t, mem_kv)
        return self.decoder_norm(h)

    def decode_step_train(self, x_t: torch.Tensor, sa_caches: Sequence[KV], t: int,
                          mem_kvs: Sequence[KV], gen: Gen) -> Tuple[torch.Tensor, List[KV]]:
        """:meth:`decode_step` with new caches (``transformer.py:241-255``),
        for training.  Returns (out_t, the new caches)."""
        h, new_caches = x_t, []
        for layer, cache, mem_kv in zip(self.decoder_layers, sa_caches, mem_kvs):
            h, cache = layer.step_train(h, cache, t, mem_kv, gen)
            new_caches.append(cache)
        return self.decoder_norm(h), new_caches
