"""ABR environment as batched reset/step functions over device tables.

Port of ``mansy_immersivevideostreaming_tpu/sim/env.py`` (reference
``bitrate_selection/envs/mansy_env.py:16-290`` and ``simple_rl_env.py``).
Lane state is one :class:`EnvState` whose tensors carry a leading lane
dimension N, in place of the JAX package's per-lane pytree under ``vmap``.
Episodes auto-reset on completion and emit a per-episode log record.

:func:`step_env` runs the fused env-step kernel on the card
(``kernels/env_step.py``, whose plain PyTorch version is the CPU path).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch

from mansy_immersivevideostreaming_torch.ops.qoe import QoEState, init_qoe_state
from mansy_immersivevideostreaming_torch.sim.simulator import (
    NetState, init_buffer, init_net_state, push_chunk,
)
from mansy_immersivevideostreaming_torch.sim.tables import SimTables


# ---------------------------------------------------------------------------
# Environment sample schedules (host-side, tiny)
# ---------------------------------------------------------------------------

def generate_environment_samples(num_videos: int, num_users: int,
                                 num_traces: int, num_qoe: int,
                                 seed: int = 0) -> np.ndarray:
    """Round-robin train/valid schedule; each id appears at least once.

    Reference ``utils/common.py:60-84`` (its ``seed`` is unused there too).
    Returns i32 [S, 4] of (video_idx, user_idx, trace_idx, qoe_idx).
    """
    max_len = max(num_videos, num_users, num_traces, num_qoe)
    total_len = max(max_len, num_videos * num_qoe *
                    math.ceil(max_len / (num_videos * num_qoe)))
    idx = np.arange(total_len)
    return np.stack([idx % num_videos, idx % num_users,
                     idx % num_traces, idx % num_qoe], axis=1).astype(np.int32)


def generate_demo_samples(num_videos: int, num_users: int, num_traces: int,
                          num_qoe: int, total: int, seed: int = 0,
                          qoe_probs: Sequence[float] | None = None) -> np.ndarray:
    """Stratified random (video, user, trace, qoe) schedule of ``total`` rows:
    each column concatenates independent permutations, so every id appears
    equally often (+-1).  ``qoe_probs`` replaces the qoe column with a
    weighted draw.  Same draws as the JAX package for the same seed."""
    rng = np.random.default_rng(seed)
    cols = []
    for n in (num_videos, num_users, num_traces, num_qoe):
        reps = math.ceil(total / n)
        col = np.concatenate([rng.permutation(n) for _ in range(reps)])[:total]
        cols.append(col)
    if qoe_probs is not None:
        p = np.asarray(qoe_probs, np.float64)
        if p.shape != (num_qoe,):
            raise ValueError(f"qoe_probs has shape {p.shape}, expected ({num_qoe},)")
        cols[3] = rng.choice(num_qoe, size=total, p=p / p.sum())
    return np.stack(cols, axis=1).astype(np.int32)


def generate_environment_test_samples(num_videos: int, num_users: int,
                                      num_traces: int, num_qoe: int) -> np.ndarray:
    """Full cartesian product; reference ``utils/common.py:87-98``."""
    grid = np.stack(np.meshgrid(np.arange(num_videos), np.arange(num_users),
                                np.arange(num_traces), np.arange(num_qoe),
                                indexing="ij"), axis=-1)
    return grid.reshape(-1, 4).astype(np.int32)


# ---------------------------------------------------------------------------
# Environment state
# ---------------------------------------------------------------------------

class EnvState(NamedTuple):
    """Full simulator + observation state of N lanes (leading dim N)."""
    # identity of the current episode (indices into the split's tables)
    video: torch.Tensor    # i32 [N]
    user: torch.Tensor     # i32 [N]
    trace: torch.Tensor    # i32 [N]
    qoe_id: torch.Tensor   # i32 [N]
    # sample scheduling
    next_sample: torch.Tensor  # i32 [N] pointer into the samples for the NEXT reset
    # simulator state
    next_chunk: torch.Tensor   # i32 [N]
    buf: torch.Tensor          # f32 [N] seconds
    net: NetState
    qoe: QoEState
    # observation histories, newest first (np.roll(,1) semantics,
    # reference mansy_env.py:192-206)
    past_throughput: torch.Tensor  # f32 [N, K] normalized
    past_acc: torch.Tensor         # f32 [N, K]
    past_rate_in: torch.Tensor     # f32 [N, K] normalized
    past_rate_out: torch.Tensor    # f32 [N, K] normalized
    past_vq: torch.Tensor          # f32 [N, K] qoe1 history
    past_var: torch.Tensor         # f32 [N, K] qoe3 history
    past_rebuf: torch.Tensor       # f32 [N, K] qoe2 / startup_download history
    last_rebuffer: torch.Tensor    # f32 [N] (raw qoe2, for SimpleRL obs)
    last_acc: torch.Tensor         # f32 [N] accuracy of the chunk in the current obs
    last_action_one_hot: torch.Tensor  # f32 [N, A]
    # per-episode QoE accumulators (reference mansy_env.py:271-290)
    ep_qoe: torch.Tensor
    ep_qoe1: torch.Tensor
    ep_qoe2: torch.Tensor
    ep_qoe3: torch.Tensor
    ep_steps: torch.Tensor  # i32 [N]


class LogRecord(NamedTuple):
    """Per-episode summary emitted at episode end (means as in reference
    ``mansy_env.py:277-284``: qoe normalized by the preference weight sum)."""
    done: torch.Tensor
    video: torch.Tensor
    user: torch.Tensor
    trace: torch.Tensor
    qoe_id: torch.Tensor
    qoe: torch.Tensor
    qoe1: torch.Tensor
    qoe2: torch.Tensor
    qoe3: torch.Tensor
    ret: torch.Tensor    # episode return: sum of raw per-chunk qoe
    steps: torch.Tensor  # episode length in chunks


def tree_where(cond: torch.Tensor, a, b):
    """Per-lane select between two (nested) NamedTuples of [N, ...] tensors."""
    if isinstance(a, tuple):
        return type(a)(*(tree_where(cond, x, y) for x, y in zip(a, b)))
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - 1)), a, b)


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a (nested) NamedTuple."""
    if isinstance(tree, tuple):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    return fn(tree)


def reset_env(tables: SimTables, samples: torch.Tensor,
              sample_ptr: torch.Tensor, stride: int) -> EnvState:
    """Start lane i's episode at ``samples[sample_ptr[i]]``.

    Mirrors reference ``MANSYEnv.reset`` (``mansy_env.py:99-152``): fresh
    simulator (next_chunk = startup_download + 1, reference
    ``simulator.py:45``), fresh QoE model, zeroed histories.  ``stride``
    advances the pointer for worker-strided sampling (reference
    ``mansy_env.py:100-101``).
    """
    S = samples.shape[0]
    sample = samples[(sample_ptr % S).long()]
    video, user, trace, qoe_id = (sample[:, i].to(torch.int32).contiguous() for i in range(4))
    N = sample_ptr.shape[0]
    dev = samples.device
    K, A = tables.past_k, tables.action_space
    zeros_k = torch.zeros((N, K), dtype=torch.float32, device=dev)
    zeros = torch.zeros(N, dtype=torch.float32, device=dev)
    next_chunk = torch.full((N,), tables.startup_download + 1, dtype=torch.int32, device=dev)
    return EnvState(
        video=video, user=user, trace=trace, qoe_id=qoe_id,
        next_sample=((sample_ptr + stride) % S).to(torch.int32),
        next_chunk=next_chunk,
        buf=init_buffer(tables.chunk_length, (N,), dev),
        net=init_net_state((N,), dev),
        qoe=init_qoe_state((N,), dev),
        past_throughput=zeros_k, past_acc=zeros_k.clone(),
        past_rate_in=zeros_k.clone(), past_rate_out=zeros_k.clone(),
        past_vq=zeros_k.clone(), past_var=zeros_k.clone(), past_rebuf=zeros_k.clone(),
        last_rebuffer=zeros.clone(),
        last_acc=tables.vp_acc[video.long(), user.long(), next_chunk.long()],
        last_action_one_hot=torch.zeros((N, A), dtype=torch.float32, device=dev),
        ep_qoe=zeros.clone(), ep_qoe1=zeros.clone(),
        ep_qoe2=zeros.clone(), ep_qoe3=zeros.clone(),
        ep_steps=torch.zeros(N, dtype=torch.int32, device=dev),
    )


def _roll(hist: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """np.roll(hist, 1, axis=-1); hist[..., 0] = new (reference
    ``mansy_env.py:192-193``)."""
    return torch.cat([new[..., None].to(hist.dtype), hist[..., :-1]], dim=-1)


def harmonic_bw_estimate(past_throughput: torch.Tensor) -> torch.Tensor:
    """Harmonic mean of the non-zero (normalized) throughput history [..., K]
    — the FastMPC bandwidth predictor; 0.5 prior while the history is empty."""
    nz = past_throughput > 0
    n = nz.to(torch.float32).sum(-1)
    inv = torch.where(nz, 1.0 / torch.clamp(past_throughput, min=1e-12),
                      torch.zeros_like(past_throughput)).sum(-1)
    return torch.where(n > 0, n / torch.clamp(inv, min=1e-12), torch.full_like(n, 0.5))


def viewport_acc_estimate(past_acc: torch.Tensor) -> torch.Tensor:
    """Causal estimate of the next chunk's prediction recall from the lane's
    observed tile-IoU history [..., K]: mean over the filled entries (IoU
    prior 0.8 while empty), mapped by ``2 * iou / (1 + iou)``."""
    nz = past_acc > 0
    n = nz.to(torch.float32).sum(-1)
    s = torch.where(nz, past_acc, torch.zeros_like(past_acc)).sum(-1)
    iou = torch.where(n > 0, s / torch.clamp(n, min=1.0), torch.full_like(n, 0.8))
    return 2.0 * iou / (1.0 + iou)


def check_action_value_tables(tables: SimTables) -> None:
    """Action-value tables are attached whole: quality, intra and size
    together, and the two out-of-prediction tables together."""
    if (tables.av_intra is None or tables.av_size is None) != (tables.av_quality is None) \
            or (tables.av_out_quality is None) != (tables.av_out_intra is None) \
            or (tables.av_quality is None and tables.av_out_quality is not None):
        raise ValueError("action-value tables come whole: attach them with "
                         "sim.expert.attach_action_values")


def exact_action_values(tables: SimTables, state: EnvState) -> torch.Tensor:
    """[N, A+1] exact one-step causal action values plus bw_hat (JAX
    ``sim/env.py:220-259``): per action the deployable tables' quality,
    variance and size (``tables.av_*``), the download at the harmonic-mean
    bandwidth estimate, ``push_chunk``'s rebuffering and the normalized
    preference weights; with ``av_out_*`` attached, the accuracy-corrected
    quality and variance (``sim.expert.corrected_scores``)."""
    check_action_value_tables(tables)
    v, u, c = state.video.long(), state.user.long(), state.next_chunk.long()
    bw_hat = harmonic_bw_estimate(state.past_throughput)            # [N] normalized
    quality, intra = tables.av_quality[v, u, c], tables.av_intra[v, u, c]  # [N, A]
    if tables.av_out_quality is not None:
        # Imported here: sim.expert builds on this module.
        from mansy_immersivevideostreaming_torch.sim.expert import corrected_scores
        acc_hat = viewport_acc_estimate(state.past_acc)[:, None]
        quality, intra = corrected_scores(quality, intra, tables.av_out_quality[v, u, c],
                                          tables.av_out_intra[v, u, c], acc_hat)
    q_n = quality / tables.max_rate
    intra_n = intra / tables.max_rate
    dt = tables.av_size[v, u, c] / (bw_hat * tables.max_throughput)[:, None]
    _, rebuf = push_chunk(state.buf[:, None], tables.chunk_length, dt)
    w = tables.qoe_weights[state.qoe_id.long()]
    w = w / w.sum(-1, keepdim=True)
    inter = torch.where(state.qoe.has_prev[:, None],
                        (q_n - state.qoe.prev_quality[:, None]).abs(), torch.zeros_like(q_n))
    av = w[:, 0:1] * q_n - w[:, 1:2] * rebuf - w[:, 2:3] * (intra_n + inter)
    return torch.cat([av, bw_hat[:, None]], dim=-1)


def observe_mansy(tables: SimTables, state: EnvState) -> Dict[str, torch.Tensor]:
    """13-field MANSY observation of every lane (reference
    ``mansy_env.py:136-150``); with deployable action-value tables attached
    (``tables.av_quality``), a 14th field ``action_values`` [N, A+1] (see
    :func:`exact_action_values`)."""
    v, u, c = state.video.long(), state.user.long(), state.next_chunk.long()
    w = tables.qoe_weights[state.qoe_id.long()]
    obs = {
        "throughput": state.past_throughput,
        "next_chunk_size": tables.sizes[v, c] / tables.max_size,
        "next_chunk_quality": tables.qualities[v, c] / tables.max_rate,
        "pred_viewport": tables.pred[v, u, c],
        "rates_inside": state.past_rate_in,
        "rates_outside": state.past_rate_out,
        "viewport_acc": state.past_acc,
        "buffer": (state.buf / tables.startup_download)[:, None],
        "qoe_weight": w / w.sum(-1, keepdim=True),
        "action_one_hot": state.last_action_one_hot,
        "past_viewport_qualities": state.past_vq,
        "past_quality_variances": state.past_var,
        "past_rebuffering": state.past_rebuf,
    }
    if tables.av_quality is not None:
        obs["action_values"] = exact_action_values(tables, state)
    return obs


def observe_simple(tables: SimTables, state: EnvState) -> Dict[str, torch.Tensor]:
    """5-field SimpleRL observation (reference ``simple_rl_env.py:103-109``)."""
    v, u, c = state.video.long(), state.user.long(), state.next_chunk.long()
    return {
        "throughput": state.past_throughput,
        "chunk_sizes": tables.sizes[v, c] / tables.max_size,
        "rebuffer": state.last_rebuffer[:, None],
        "last_bitrates": torch.stack([state.past_rate_in[:, 0],
                                      state.past_rate_out[:, 0]], dim=-1),
        "pred_viewport": tables.pred[v, u, c],
    }


def step_env(tables: SimTables, samples: torch.Tensor, state: EnvState,
             action: torch.Tensor, stride: int, train: bool):
    """One env transition of every lane, with auto-reset.

    Mirrors reference ``MANSYEnv.step`` (``mansy_env.py:154-248``); returns
    (new_state, reward, done, log_record).  On the card this is one launch of
    the fused env-step kernel, which updates ``state``'s tensors in place and
    returns the same object; the caller must not keep the old state.
    """
    # Imported here: the kernel module builds on this module's state types.
    from mansy_immersivevideostreaming_torch.kernels.env_step import env_step
    return env_step(tables, samples, state, action, stride, train)
