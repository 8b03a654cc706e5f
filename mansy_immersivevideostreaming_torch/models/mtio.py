"""MTIO ensemble viewport-prediction Transformer.

Port of the JAX package's ``models/mtio.py`` (reference
``viewport_prediction/models/mtio.py``): ``num_head`` trajectory slots
concatenated channel-wise and embedded by one Linear, a sinusoidal
positional encoding with dropout, the encoder with its distillation layer,
and an autoregressive decode of ``fut_window`` steps whose head averages
the slots.  :meth:`ViewportTransformerMTIO.sample` is the serving path;
:meth:`ViewportTransformerMTIO.forward` the training forward: the
shuffle/repeat slot trick, dropout from a ``torch.Generator``, and the
KV-cached decode that feeds its own predictions back (the gradient flows
through them) or, with ``teacher_forcing``, the single causal pass over the
ground truth.  :meth:`ViewportTransformerMTIO.init_like_flax` draws the
Flax initialisers.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from mansy_immersivevideostreaming_torch.models.transformer import (
    DROPOUT, F32, Dense, Gen, Transformer, current_shard, dropout,
)
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


def lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """Flax's default kernel init ``lecun_normal`` in place: a normal
    truncated at +-2 sigma with sigma = sqrt(1 / fan_in) / 0.8796..., drawn
    as ``jax.random.truncated_normal`` draws it (a uniform between the two
    bounds' erf values through erfinv)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(w.shape, generator=gen, device=w.device, dtype=w.dtype)
    with torch.no_grad():
        w.copy_((torch.erfinv(lo + (hi - lo) * u) * math.sqrt(2.0)).clamp(-2.0, 2.0) * std)
    return w


class ViewportTransformerMTIO(nn.Module):
    """Defaults are ``run_models``' (d_model = dim_feedforward = 512, 2 + 2
    layers, 8 heads, in_channel 2, num_head 3, fut_window 15, PE dropout
    0.2 and the transformer's 0.1, repeat probability 0.5).
    ``incremental`` picks the KV-cached decode (the serving path) or the
    fixed-buffer decode (the parity oracle), as in the JAX module;
    ``teacher_forcing`` the single-pass training decode.
    ``transformer_dropout`` is the Transformer's rate, which the JAX module
    fixes at 0.1 (the parity tests set both packages' to 0).  ``dtype`` is
    the compute dtype (``torch.bfloat16`` for ``run_models --bf16``): the
    embedding and the transformer compute in it (``models/transformer.py``),
    the parameters stay f32, and the predictor head stays f32
    (``mtio.py:68``), so the positional encoding's sum, the predictions and
    the loss are f32."""

    def __init__(self, in_channel: int = 2, fut_window: int = 15, d_model: int = 512,
                 dim_feedforward: int = 512, num_head: int = 3, num_encoder_layers: int = 2,
                 num_decoder_layers: int = 2, dropout: float = 0.2, repeat_prob: float = 0.5,
                 incremental: bool = True, teacher_forcing: bool = False,
                 transformer_dropout: float = DROPOUT, dtype: torch.dtype = F32,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.in_channel, self.fut_window, self.num_head = in_channel, fut_window, num_head
        self.dropout, self.repeat_prob = dropout, repeat_prob
        self.incremental, self.teacher_forcing = incremental, teacher_forcing
        self.embedding = Dense(in_channel * num_head, d_model, dtype, dev, f32_sum=True)
        self.transformer = Transformer(d_model=d_model, num_encoder_layers=num_encoder_layers,
                                       num_decoder_layers=num_decoder_layers,
                                       dim_feedforward=dim_feedforward,
                                       dropout=transformer_dropout, dtype=dtype, device=dev)
        self.predictor = nn.Linear(d_model, in_channel * num_head, device=dev)
        self.register_buffer("pe", sinusoidal_pe(5000, d_model, dev), persistent=False)

    @torch.no_grad()
    def init_like_flax(self, gen: torch.Generator) -> "ViewportTransformerMTIO":
        """Flax's initialisers, in distribution (``vp_train.create_train_state``):
        Dense and Conv kernels ``lecun_normal`` (a Conv's fan-in is
        kernel size x input channels), zero biases, LayerNorm and BatchNorm
        scales 1 and biases 0, running statistics 0 and 1."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d)):
                fan_in = mod.weight[0].numel()
                lecun_normal_(mod.weight, fan_in, gen)
                mod.bias.zero_()
            elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm1d)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if isinstance(mod, nn.BatchNorm1d):
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)
        return self

    def _embed(self, x: torch.Tensor, gen: Gen = None) -> torch.Tensor:
        """Linear embed + positional encoding + PE dropout (``mtio.py:71-75``);
        the f32 encoding promotes a bf16 embedding to f32."""
        return dropout(self.embedding(x) + self.pe[None, :x.shape[1]], self.dropout, gen)

    def _predict_coords(self, h: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.predictor(h))

    def _decode_incremental(self, memory: torch.Tensor, current: torch.Tensor,
                            gen: Gen = None) -> torch.Tensor:
        """``fut_window``-step KV-cached decode, one position of decoder work a
        step (``mtio.py:80-102``); each step feeds its prediction back.  In
        training or with grad enabled the caches are out of place
        (``decode_step_train``), so the gradient flows through the fed-back
        predictions.  Returns the raw slot predictions [B, F, C]."""
        mem_kvs, sa_caches = self.transformer.init_decode_cache(memory, self.fut_window)
        out_of_place = torch.is_grad_enabled() or gen is not None
        x_t = current[:, :1]
        preds = []
        for t in range(self.fut_window):
            h = dropout(self.embedding(x_t) + self.pe[None, t:t + 1], self.dropout, gen)
            if out_of_place:
                out, sa_caches = self.transformer.decode_step_train(h, sa_caches, t, mem_kvs,
                                                                    gen)
            else:
                out = self.transformer.decode_step(h, sa_caches, t, mem_kvs)
            pred = self._predict_coords(out[:, 0])
            preds.append(pred)
            x_t = pred[:, None, :]
        return torch.stack(preds, dim=1)

    def _decode_autoregressive(self, memory: torch.Tensor, current: torch.Tensor,
                               gen: Gen = None) -> torch.Tensor:
        """``fut_window``-step decode over a fixed [B, 1 + F, C] buffer under
        the causal mask (``mtio.py:104-133``), the parity oracle of
        :meth:`_decode_incremental`.  The buffer is rebuilt each step (JAX's
        ``dynamic_update_slice``), so autograd sees no in-place write.
        Returns [B, F, C]."""
        B, F = current.shape[0], self.fut_window
        buf = torch.cat([current[:, :1], current.new_zeros((B, F, current.shape[-1]))], dim=1)
        preds = []
        for t in range(F):
            out = self.transformer.decode(self._embed(buf, gen), memory, 1, gen)
            pred = self._predict_coords(out[:, t])
            buf = torch.cat([buf[:, :t + 1], pred[:, None], buf[:, t + 2:]], dim=1)
            preds.append(pred)
        return torch.stack(preds, dim=1)

    def _decode_teacher_forced(self, memory: torch.Tensor, current: torch.Tensor,
                               future: torch.Tensor, gen: Gen = None) -> torch.Tensor:
        """Single-pass training decode (``mtio.py:135-156``): position t's
        input is the ground truth at t - 1 (position 0 is ``current``), all
        ``fut_window`` positions in one causal pass.  Returns [B, F, C]."""
        tgt = self._embed(torch.cat([current, future[:, :-1]], dim=1), gen)
        return self._predict_coords(self.transformer.decode(tgt, memory, 1, gen))

    def draw_slots(self, B: int, gen: Gen, device) -> tuple:
        """The slot trick's draws (``mtio.py:166-175``): ``num_head - 1``
        permutations of the batch [num_head - 1, B], and one repeat draw
        (probability ``repeat_prob``), a bool tensor on ``device``."""
        perms = torch.stack([torch.randperm(B, generator=gen, device=device)
                             for _ in range(self.num_head - 1)])
        repeat = torch.rand((), generator=gen, device=device) < self.repeat_prob
        return perms, repeat

    def forward(self, history: torch.Tensor, current: torch.Tensor, future: torch.Tensor,
                train: bool = True, perms=None, repeat=None, generator: Gen = None):
        """Training forward (``mtio.py:158-199``): history [B, M, C_in],
        current [B, 1, C_in], future [B, F, C_in] -> (pred, gt), each
        [B, F, C_in * num_head].  In training the slots are the batch and
        ``num_head - 1`` permutations of it, or the batch itself in every
        slot when ``repeat`` (``perms`` and ``repeat`` drawn from
        ``generator`` unless given), and dropout draws from ``generator``
        (the device's default generator if None).  ``train=False`` tiles
        the input into every slot, deterministically.  Inside
        ``transformer.batch_shard`` the inputs are the global batch and the
        forward computes the rank's rows of it: row b's slots are b and
        ``perms[:, b]``, drawn over the global batch."""
        B, dev = history.shape[0], history.device
        gen = None
        shard = current_shard() if train else None
        if shard is not None and shard.total != B:
            raise ValueError(f"batch_shard of {shard.total} rows, batch of {B}")
        if train:
            gen = generator
            if gen is None:
                gen = (torch.cuda.default_generators[
                    torch.cuda.current_device() if dev.index is None else dev.index]
                       if dev.type == "cuda" else torch.default_generator)
            if perms is None or repeat is None:
                drawn = self.draw_slots(B, gen, dev)
                perms = drawn[0] if perms is None else perms
                repeat = drawn[1] if repeat is None else repeat
            perms = torch.as_tensor(perms, device=dev).long()
            repeat = torch.as_tensor(repeat, device=dev)
            perms = torch.where(repeat, torch.arange(B, device=dev)[None, :], perms)
            rows = slice(None) if shard is None else shard.rows
            slots = lambda x: torch.cat([x[rows]] + [x[p] for p in perms[:, rows]], dim=-1)
        else:
            slots = lambda x: x.repeat(1, 1, self.num_head)
        multi_history, multi_current, multi_future = (slots(x)
                                                      for x in (history, current, future))
        memory = self.transformer.encode(self._embed(multi_history, gen), gen)
        if train and self.teacher_forcing:
            pred = self._decode_teacher_forced(memory, multi_current, multi_future, gen)
        else:
            decode = (self._decode_incremental if self.incremental
                      else self._decode_autoregressive)
            pred = decode(memory, multi_current, gen)
        return pred, multi_future

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
