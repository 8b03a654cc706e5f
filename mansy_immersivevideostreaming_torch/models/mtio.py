"""MTIO ensemble viewport-prediction Transformer, for serving.

Port of the JAX package's ``models/mtio.py`` (reference
``viewport_prediction/models/mtio.py``): ``num_head`` trajectory slots
concatenated channel-wise and embedded by one Linear, a sinusoidal
positional encoding, the encoder with its distillation layer, and an
autoregressive decode of ``fut_window`` steps whose head averages the slots.
:meth:`ViewportTransformerMTIO.sample` is the serving path; the training
forward (the shuffle/repeat slots, dropout) and the teacher-forced decode
come with the training slice.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from mansy_immersivevideostreaming_torch.models.transformer import Transformer
from mansy_immersivevideostreaming_torch.ops.geometry import periodic_mse, wrap_position
from mansy_immersivevideostreaming_torch.utils.device import resolve_device


def sinusoidal_pe(max_len: int, d_model: int, device=None) -> torch.Tensor:
    """Sin/cos table [max_len, d_model] computed in f32 (``mtio.py:33-41``)."""
    position = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d_model))
    pe = torch.zeros(max_len, d_model, device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


class ViewportTransformerMTIO(nn.Module):
    """Defaults are ``run_models``' (d_model = dim_feedforward = 512, 2 + 2
    layers, 8 heads, in_channel 2, num_head 3, fut_window 15).
    ``incremental`` picks the KV-cached decode (the serving path) or the
    fixed-buffer decode (the parity oracle), as in the JAX module."""

    def __init__(self, in_channel: int = 2, fut_window: int = 15, d_model: int = 512,
                 dim_feedforward: int = 512, num_head: int = 3, num_encoder_layers: int = 2,
                 num_decoder_layers: int = 2, incremental: bool = True,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.in_channel, self.fut_window, self.num_head = in_channel, fut_window, num_head
        self.incremental = incremental
        self.embedding = nn.Linear(in_channel * num_head, d_model, device=dev)
        self.transformer = Transformer(d_model=d_model, num_encoder_layers=num_encoder_layers,
                                       num_decoder_layers=num_decoder_layers,
                                       dim_feedforward=dim_feedforward, device=dev)
        self.predictor = nn.Linear(d_model, in_channel * num_head, device=dev)
        self.register_buffer("pe", sinusoidal_pe(5000, d_model, dev), persistent=False)

    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        """Linear embed + positional encoding (``mtio.py:71-75``)."""
        return self.embedding(x) + self.pe[None, :x.shape[1]]

    def _predict_coords(self, h: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.predictor(h))

    def _decode_incremental(self, memory: torch.Tensor, current: torch.Tensor) -> torch.Tensor:
        """``fut_window``-step KV-cached decode, one position of decoder work a
        step (``mtio.py:80-102``).  Returns the raw slot predictions [B, F, C]."""
        mem_kvs, sa_caches = self.transformer.init_decode_cache(memory, self.fut_window)
        x_t = current[:, :1]
        preds = []
        for t in range(self.fut_window):
            h = self.embedding(x_t) + self.pe[None, t:t + 1]
            out = self.transformer.decode_step(h, sa_caches, t, mem_kvs)
            pred = self._predict_coords(out[:, 0])
            preds.append(pred)
            x_t = pred[:, None, :]
        return torch.stack(preds, dim=1)

    def _decode_autoregressive(self, memory: torch.Tensor, current: torch.Tensor
                               ) -> torch.Tensor:
        """``fut_window``-step decode over a fixed [B, 1 + F, C] buffer under
        the causal mask (``mtio.py:104-133``), the parity oracle of
        :meth:`_decode_incremental`.  Returns [B, F, C]."""
        B, F = current.shape[0], self.fut_window
        buf = current.new_zeros((B, 1 + F, self.in_channel * self.num_head))
        buf[:, 0] = current[:, 0]
        preds = []
        for t in range(F):
            out = self.transformer.decode(self._embed(buf), memory, kv_len0=1)
            pred = self._predict_coords(out[:, t])
            buf[:, t + 1] = pred
            preds.append(pred)
        return torch.stack(preds, dim=1)

    def loss_function(self, pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        """Sum over the slots of the mean periodic MSE (``mtio.py:201-207``)."""
        loss = pred.new_zeros(())
        for i in range(self.num_head):
            sl = slice(i * self.in_channel, (i + 1) * self.in_channel)
            loss = loss + periodic_mse(pred[:, :, sl], gt[:, :, sl]).mean()
        return loss

    @torch.no_grad()
    def sample(self, history: torch.Tensor, current: torch.Tensor) -> torch.Tensor:
        """history [B, M, 2], current [B, 1, 2] -> [B, F, 2]: every slot takes
        the input trajectory ([x, y, x, y, x, y]), the slots' predictions are
        averaged per step and wrapped into [0, 1]^2 (``mtio.py:209-223``)."""
        multi_history = history.repeat(1, 1, self.num_head)
        multi_current = current.repeat(1, 1, self.num_head)
        memory = self.transformer.encode(self._embed(multi_history))
        decode = self._decode_incremental if self.incremental else self._decode_autoregressive
        pred = decode(memory, multi_current)
        B, F, _ = pred.shape
        return wrap_position(pred.reshape(B, F, self.num_head, self.in_channel).mean(2))
