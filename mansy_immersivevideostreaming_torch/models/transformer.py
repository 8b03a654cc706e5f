"""Transformer encoder/decoder with an Informer-style distillation layer.

Port of the JAX package's ``models/transformer.py`` (reference
``viewport_prediction/models/customized_transformer.py``) for inference:
post-norm residual blocks (LayerNorm eps 1e-5), ReLU feed-forward, a final
LayerNorm after both stacks, and a ``DistillLayer`` halving the encoder
memory between encoder and decoder.  Attention keeps the JAX layout
([B, L, H, Dh]) and its softmax core is K8 (``kernels/attention.py``);
every mask is a prefix of the keys, given as ``kv_len0`` (query row r sees
``min(Lk, kv_len0 + r)`` keys).  Dropout is not ported: the serving path
runs the modules deterministically, as ``MHA.attend(deterministic=True)``.

Module names follow the Flax tree where it uses ``setup`` (``sa``, ``ca``,
``ff``, ``norm1-3``); ``utils/checkpoint.py`` maps the ``nn.compact`` names
(``MHA_0``, ``LayerNorm_0/1``, ``FeedForward_0/Dense_0/1``, ``Conv_0``,
``BatchNorm_0``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mansy_immersivevideostreaming_torch.kernels.attention import attention

KV = Tuple[torch.Tensor, torch.Tensor]


class MHA(nn.Module):
    """Multi-head attention with a KV-cache path (``transformer.py:25-79``):
    :meth:`project_kv` gives the cacheable (k, v), :meth:`attend` runs the
    query and out projections around the K8 core."""

    def __init__(self, d_model: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(d_model, d_model, device=device)
        self.key = nn.Linear(d_model, d_model, device=device)
        self.value = nn.Linear(d_model, d_model, device=device)
        self.out = nn.Linear(d_model, d_model, device=device)

    def _split(self, y: torch.Tensor) -> torch.Tensor:
        return y.reshape(y.shape[0], y.shape[1], self.num_heads, -1)

    def project_kv(self, kv_in: torch.Tensor) -> KV:
        """(k, v), each [B, L, H, Dh]."""
        return self._split(self.key(kv_in)), self._split(self.value(kv_in))

    def attend(self, q_in: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_len0: Optional[int] = None) -> torch.Tensor:
        """Attention of ``q_in`` [B, Lq, D] over projected ``k``/``v``."""
        B, Lq, D = q_in.shape
        o = attention(self._split(self.query(q_in)), k, v, kv_len0)
        return self.out(o.reshape(B, Lq, D))

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                kv_len0: Optional[int] = None) -> torch.Tensor:
        return self.attend(q_in, *self.project_kv(kv_in), kv_len0)


class FeedForward(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int, device=None):
        super().__init__()
        self.linear1 = nn.Linear(d_model, dim_feedforward, device=device)
        self.linear2 = nn.Linear(dim_feedforward, d_model, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.relu(self.linear1(x)))


class EncoderLayer(nn.Module):
    """Post-norm self-attention + feed-forward block (``transformer.py:97-113``)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, device=None):
        super().__init__()
        self.attn = MHA(d_model, nhead, device)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.ff = FeedForward(d_model, dim_feedforward, device)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.attn(x, x))
        return self.norm2(x + self.ff(x))


class DecoderLayer(nn.Module):
    """Post-norm self-attention, cross-attention and feed-forward block
    (``transformer.py:116-165``)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, device=None):
        super().__init__()
        self.sa = MHA(d_model, nhead, device)
        self.ca = MHA(d_model, nhead, device)
        self.ff = FeedForward(d_model, dim_feedforward, device)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                kv_len0: Optional[int] = None) -> torch.Tensor:
        x = self.norm1(x + self.sa(x, x, kv_len0))
        x = self.norm2(x + self.ca(x, memory))
        return self.norm3(x + self.ff(x))

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
        x = self.norm1(x_t + self.sa.attend(x_t, k_cache, v_cache, t + 1))
        x = self.norm2(x + self.ca.attend(x, *mem_kv))
        return self.norm3(x + self.ff(x))


class DistillLayer(nn.Module):
    """Circular Conv1d(k3) + BatchNorm (running statistics) + ELU +
    MaxPool1d(k3, s2, p1) over time (``transformer.py:168-190``)."""

    def __init__(self, d_model: int, device=None):
        super().__init__()
        self.conv = nn.Conv1d(d_model, d_model, kernel_size=3, device=device)
        self.bn = nn.BatchNorm1d(d_model, eps=1e-5, momentum=0.1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, L, D] -> [B, (L - 1) // 2 + 1, D], BatchNorm on its running
        statistics whatever the module's mode (the serving path's
        ``use_running_average=True``)."""
        h = torch.cat([x[:, -1:], x, x[:, :1]], dim=1).transpose(1, 2)
        bn = self.bn
        h = F.elu(F.batch_norm(self.conv(h), bn.running_mean, bn.running_var, bn.weight,
                               bn.bias, training=False, eps=bn.eps))
        # max_pool1d pads with -inf, as the JAX version does
        return F.max_pool1d(h, kernel_size=3, stride=2, padding=1).transpose(1, 2)


class Transformer(nn.Module):
    """Encoder + DistillLayer + decoder (``transformer.py:198-262``), with
    the incremental decode (:meth:`init_decode_cache`, :meth:`decode_step`)."""

    def __init__(self, d_model: int = 512, nhead: int = 8, num_encoder_layers: int = 2,
                 num_decoder_layers: int = 2, dim_feedforward: int = 512, device=None):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        self.encoder_layers = nn.ModuleList(
            EncoderLayer(d_model, nhead, dim_feedforward, device)
            for _ in range(num_encoder_layers))
        self.encoder_norm = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.distill = DistillLayer(d_model, device)
        self.decoder_layers = nn.ModuleList(
            DecoderLayer(d_model, nhead, dim_feedforward, device)
            for _ in range(num_decoder_layers))
        self.decoder_norm = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def encode(self, src: torch.Tensor) -> torch.Tensor:
        h = src
        for layer in self.encoder_layers:
            h = layer(h)
        return self.distill(self.encoder_norm(h))

    def decode(self, tgt: torch.Tensor, memory: torch.Tensor,
               kv_len0: Optional[int] = None) -> torch.Tensor:
        """The full decode; ``kv_len0=1`` is the causal mask."""
        h = tgt
        for layer in self.decoder_layers:
            h = layer(h, memory, kv_len0)
        return self.decoder_norm(h)

    def init_decode_cache(self, memory: torch.Tensor, max_len: int
                          ) -> Tuple[List[KV], List[KV]]:
        """Each decoder layer's cross-attention (k, v) of the memory, and
        zeroed [B, max_len, H, Dh] self-attention caches."""
        B = memory.shape[0]
        shape = (B, max_len, self.nhead, self.d_model // self.nhead)
        mem_kvs = [layer.ca.project_kv(memory) for layer in self.decoder_layers]
        sa_caches = [(memory.new_zeros(shape), memory.new_zeros(shape))
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
