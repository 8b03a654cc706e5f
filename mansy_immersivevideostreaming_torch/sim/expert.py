"""MPC expert: per-chunk action profiling tables and the lookahead search.

Port of ``mansy_immersivevideostreaming_tpu/sim/expert.py`` (reference
``bitrate_selection/envs/expert_env.py``), batched over lanes:

* :func:`build_expert_tables_plain` (reference
  ``_profile_viewport_qualities_sizes``, ``expert_env.py:127-182``): for
  every (video, user, chunk, action) the viewport quality, intra-viewport
  variance and chunk size under pyramid allocation, in four variants.
* :func:`choose_action_plain` (reference ``expert_env.py:358-422``): every
  ``action_space ** horizon`` action sequence (the digit order of
  :func:`action_sequences`) rolled forward virtually from each lane's real
  network/buffer/QoE state; the first action of the first best total.

These are the plain PyTorch versions of the kernels K5
(``kernels/expert_tables.py``) and K4 (``kernels/choose_action.py``);
:func:`build_expert_tables` and :func:`choose_action` go through the kernel
wrappers, which run the plain versions only for CPU tensors.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from mansy_immersivevideostreaming_torch.ops.allocation import (
    ACTION_TO_RATES, allocate_tile_rates,
)
from mansy_immersivevideostreaming_torch.sim.env import EnvState, harmonic_bw_estimate
from mansy_immersivevideostreaming_torch.sim.tables import SimTables


class ExpertTables(NamedTuple):
    """[V, U, C, A] profiling tables (A = action space).

    ``gt_*``: allocated and evaluated on the ground-truth viewport;
    ``pred_*``: allocated on the predicted viewport, evaluated on the
    ground-truth one (both as the reference, ``expert_env.py:160-172``);
    ``dep_*``: allocated and evaluated on the predicted viewport, the
    deployable variant (``pred_size`` serves it: size depends only on the
    allocation); ``out_*``: allocated on the predicted viewport, evaluated on
    its complement, for :func:`corrected_scores`."""
    gt_quality: torch.Tensor
    gt_intra: torch.Tensor
    gt_size: torch.Tensor
    pred_quality: torch.Tensor
    pred_intra: torch.Tensor
    pred_size: torch.Tensor
    dep_quality: torch.Tensor
    dep_intra: torch.Tensor
    out_quality: torch.Tensor
    out_intra: torch.Tensor


def _evaluate(eval_vp: torch.Tensor, q: torch.Tensor):
    """(quality, intra) of tile qualities ``q`` [..., T] over the viewport
    weights ``eval_vp`` [..., T], guarded against an empty viewport."""
    vp_sum = torch.clamp(eval_vp.sum(-1), min=1e-6)
    quality = (eval_vp * q).sum(-1) / vp_sum
    intra = (eval_vp * (q - quality[..., None]).abs()).sum(-1) / vp_sum
    return quality, intra


def build_expert_tables_plain(tables: SimTables) -> ExpertTables:
    """Plain PyTorch version of K5: every (v, u, c) at once, one action at a
    time (JAX ``build_expert_tables``, ``sim/expert.py:67-110``)."""
    V, U, C, T = tables.gt.shape
    R = tables.sizes.shape[2]
    gt, pred = tables.gt, tables.pred
    comp = torch.clamp(1.0 - pred, min=0.0)  # complement of the prediction
    sizes = tables.sizes[:, None].expand(V, U, C, R, T)
    quals = tables.qualities[:, None].expand(V, U, C, R, T)
    cols = [[] for _ in ExpertTables._fields]
    for rate_in, rate_out in ACTION_TO_RATES:
        ri = torch.tensor(int(rate_in), device=gt.device)
        ro = torch.tensor(int(rate_out), device=gt.device)
        out = []
        for alloc_vp, eval_vps in ((gt, (gt,)), (pred, (gt, pred, comp))):
            versions, _ = allocate_tile_rates(ri, ro, alloc_vp)
            sel = versions.long()[..., None, :]
            size = sizes.gather(3, sel)[..., 0, :].sum(-1)
            q = quals.gather(3, sel)[..., 0, :]
            for i, vp in enumerate(eval_vps):
                out.extend(_evaluate(vp, q))
                if i == 0:
                    out.append(size)
        # out: gt (q, i, s), pred (q, i, s), dep (q, i), out (q, i)
        for col, x in zip(cols, out):
            col.append(x)
    return ExpertTables(*(torch.stack(col, dim=-1) for col in cols))


def deployable_etables(etables: ExpertTables) -> ExpertTables:
    """The search's scoring tables swapped to the deployable variant
    (pred-allocated AND pred-evaluated quality/variance)."""
    return etables._replace(pred_quality=etables.dep_quality,
                            pred_intra=etables.dep_intra)


def corrected_scores(dep_q, dep_i, out_q, out_i, acc):
    """Accuracy-corrected estimate of the realized per-action quality and
    intra variance: ``acc * dep + (1 - acc) * out``, plus the two-region
    spread term ``2 acc (1 - acc) |dep_q - out_q|`` for the variance."""
    q = acc * dep_q + (1.0 - acc) * out_q
    i = (acc * dep_i + (1.0 - acc) * out_i
         + 2.0 * acc * (1.0 - acc) * (dep_q - out_q).abs())
    return q, i


def attach_action_values(tables: SimTables, etables: ExpertTables,
                         acc_correct: bool = False) -> SimTables:
    """Attach the deployable per-action tables, enabling the exact
    ``action_values`` observation field; with ``acc_correct`` also the
    out-of-prediction tables (the accuracy-corrected field)."""
    return tables._replace(av_quality=etables.dep_quality,
                           av_intra=etables.dep_intra,
                           av_size=etables.pred_size,
                           av_out_quality=etables.out_quality if acc_correct else None,
                           av_out_intra=etables.out_intra if acc_correct else None)


@functools.lru_cache(maxsize=None)
def action_sequences(horizon: int, action_space: int = 15) -> np.ndarray:
    """[A^h, h]; sequence i's step-j action is (i // A^j) % A, the
    reference's digit expansion (``expert_env.py:113-125``).  The returned
    array is shared: do not write to it."""
    n = action_space ** horizon
    i = np.arange(n)
    return np.stack([(i // action_space ** j) % action_space
                     for j in range(horizon)], axis=1).astype(np.int32)


def causal_bw_estimate(tables: SimTables, state: EnvState) -> torch.Tensor:
    """[N] harmonic-mean bandwidth predictor over each lane's own past
    throughput, in raw trace units (0.5 * max_throughput while empty)."""
    return harmonic_bw_estimate(state.past_throughput) * tables.max_throughput


def _download_lanes(bw, prefix, bw_len, idx, sec, frac, size):
    """``simulate_download_prefix`` for [N, S] cursors on per-lane trace rows
    bw [N, L], prefix [N, L+1], bw_len [N].  The count #{prefix <= rem} is a
    search, which gives the same integer on the nondecreasing, +inf-padded
    rows; the simulator's compare-and-sum count would hold [N, S, L+1]
    booleans, gigabytes at 64 lanes of 50,625 sequences on a long trace.
    Returns (idx, sec, frac, dt)."""
    L = bw_len.to(torch.int32)[:, None]
    total = prefix.gather(1, L.long())
    at = lambda row, i: row.gather(1, i.long())
    rate0 = at(bw, idx)
    avail0 = (1.0 - frac) * rate0
    full0 = size >= avail0
    fracA = frac + size / rate0
    sp = size - avail0
    j0 = idx + 1
    target = sp + at(prefix, j0)
    q = torch.floor(target / total)
    rem = target - q * total
    wrap = rem >= total
    q = torch.where(wrap, q + 1, q)
    rem = torch.where(wrap, rem - total, rem)
    neg = rem < 0
    q = torch.where(neg, q - 1, q)
    rem = torch.where(neg, rem + total, rem)
    cnt = torch.searchsorted(prefix, rem.contiguous(), right=True).to(torch.int32)
    r = torch.minimum(torch.clamp(cnt, min=1), L)
    n = (q.to(torch.int32) * L + r).to(torch.int32)
    n = torch.maximum(n, j0)  # rounding guard
    idxB = (n - 1) % L
    g_nm1 = total * ((n - 1) // L).to(torch.float32) + at(prefix, idxB)
    remainder = torch.clamp(target - g_nm1, min=0.0)
    fracB = torch.where(remainder > 0, remainder / at(bw, idxB), torch.zeros_like(remainder))
    m_adv = n - 1 - idx
    exact0 = sp == 0
    idxB = torch.where(exact0, j0 % L, idxB)
    m_adv = torch.where(exact0, torch.ones_like(m_adv), m_adv)
    fracB = torch.where(exact0, torch.zeros_like(fracB), fracB)
    new_idx = torch.where(full0, idxB, idx)
    new_sec = torch.where(full0, sec + m_adv, sec)
    new_frac = torch.where(full0, fracB, fracA)
    dt = (new_sec - sec).to(torch.float32) + (new_frac - frac)
    return new_idx, new_sec, new_frac, dt


def step_scores(tables: SimTables, etables: ExpertTables, state: EnvState,
                horizon: int, acc_hat: Optional[torch.Tensor] = None,
                use_corr: Optional[torch.Tensor] = None):
    """Per lane, step and action the scoring inputs of the search: (size,
    q_n, intra_n, valid), the first three [N, h, A], ``valid`` [N, h].  A
    step past ``end_chunk`` is masked; its chunk index is clamped, so its
    reads stay in bounds (the JAX gather clamps too), and it adds nothing."""
    v, u = state.video.long(), state.user.long()
    C = etables.pred_size.shape[2]
    chunk = state.next_chunk.long()[:, None] + torch.arange(horizon, device=v.device)
    valid = chunk <= tables.end_chunk[v, u].long()[:, None]
    chunk = torch.clamp(chunk, max=C - 1)
    row = lambda t: t[v[:, None], u[:, None], chunk]  # [N, h, A]
    size = row(etables.pred_size)
    if acc_hat is None:
        quality, intra = row(etables.pred_quality), row(etables.pred_intra)
    else:
        quality, intra = corrected_scores(row(etables.dep_quality), row(etables.dep_intra),
                                          row(etables.out_quality), row(etables.out_intra),
                                          acc_hat[:, None, None])
        if use_corr is not None:
            corr = use_corr[:, None, None]
            quality = torch.where(corr, quality, row(etables.pred_quality))
            intra = torch.where(corr, intra, row(etables.pred_intra))
    return size, quality / tables.max_rate, intra / tables.max_rate, valid


def sequence_totals(tables: SimTables, etables: ExpertTables, state: EnvState,
                    horizon: int, bw_hat: Optional[torch.Tensor] = None,
                    acc_hat: Optional[torch.Tensor] = None,
                    use_corr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N, A^h] QoE totals of every action sequence of every lane (the
    rollout of JAX ``choose_action``, ``sim/expert.py:234-281``)."""
    A = tables.action_space
    N = state.buf.shape[0]
    seqs = torch.as_tensor(action_sequences(horizon, A), device=state.buf.device).long()
    S = seqs.shape[0]
    size, q_n, intra_n, valid = step_scores(tables, etables, state, horizon, acc_hat, use_corr)
    w = tables.qoe_weights[state.qoe_id.long()]
    w0, w1, w2 = (w[:, k:k + 1] for k in range(3))
    tr = state.trace.long()
    bw, prefix, bw_len = tables.bw[tr], tables.bw_prefix[tr], tables.bw_len[tr]
    lanes = lambda x: x[:, None].expand(N, S)
    idx, sec, frac = lanes(state.net.idx), lanes(state.net.sec), lanes(state.net.frac)
    buf, prev_q = lanes(state.buf), lanes(state.qoe.prev_quality)
    has_prev = lanes(state.qoe.has_prev)
    total = torch.zeros((N, S), dtype=torch.float32, device=state.buf.device)
    for t in range(horizon):
        a = seqs[:, t]
        s_t, q_t, i_t = size[:, t, a], q_n[:, t, a], intra_n[:, t, a]
        ok = valid[:, t:t + 1]
        if bw_hat is None:
            n_idx, n_sec, n_frac, dt = _download_lanes(bw, prefix, bw_len, idx, sec, frac, s_t)
            idx = torch.where(ok, n_idx, idx)
            sec = torch.where(ok, n_sec, sec)
            frac = torch.where(ok, n_frac, frac)
        else:
            dt = s_t / bw_hat[:, None]
        rebuf = torch.clamp(dt - buf, min=0.0)
        new_buf = torch.where(dt > buf, torch.full_like(buf, tables.chunk_length),
                              buf - dt + tables.chunk_length)
        inter = torch.where(has_prev, (q_t - prev_q).abs(), torch.zeros_like(q_t))
        qoe = w0 * q_t - w1 * rebuf - w2 * (i_t + inter)
        buf = torch.where(ok, new_buf, buf)
        prev_q = torch.where(ok, q_t, prev_q)
        has_prev = has_prev | ok
        total = total + torch.where(ok, qoe, torch.zeros_like(qoe))
    return total


def first_action_values(totals: torch.Tensor, action_space: int) -> torch.Tensor:
    """[N, A] best total of the sequences that start with each action (the
    first action varies fastest, so grouping is a reshape)."""
    N, S = totals.shape
    return totals.reshape(N, S // action_space, action_space).amax(1)


def choose_action_plain(tables: SimTables, etables: ExpertTables, state: EnvState,
                        horizon: int, bw_hat: Optional[torch.Tensor] = None,
                        acc_hat: Optional[torch.Tensor] = None,
                        use_corr: Optional[torch.Tensor] = None,
                        return_margin: bool = False):
    """Plain PyTorch version of K4.  Per lane: the first action of the first
    sequence with the largest total, i32 [N]; with ``return_margin`` also the
    margin [N]: the gap between the two best first-action values over the
    preference's weight sum (exact ties give exactly 0).

    ``bw_hat`` [N] (raw trace units): virtual downloads take ``size / bw_hat``
    instead of walking the lane's trace.  ``acc_hat`` [N]: score with
    :func:`corrected_scores` of the ``dep_*``/``out_*`` tables;
    ``use_corr`` [N] bool (with ``acc_hat``) switches that per lane."""
    if use_corr is not None and acc_hat is None:
        raise ValueError("choose_action: use_corr needs acc_hat")
    A = tables.action_space
    totals = sequence_totals(tables, etables, state, horizon, bw_hat, acc_hat, use_corr)
    action = (totals.argmax(-1) % A).to(torch.int32)
    if not return_margin:
        return action
    top2 = first_action_values(totals, A).topk(2, dim=-1).values
    w = tables.qoe_weights[state.qoe_id.long()]
    return action, (top2[:, 0] - top2[:, 1]) / w.sum(-1)


def build_expert_tables(tables: SimTables) -> ExpertTables:
    """The profiling tables of ``tables``: K5 on the card, the plain version
    for CPU tensors."""
    # Imported here: the kernel module builds on this module's types.
    from mansy_immersivevideostreaming_torch.kernels import expert_tables as K5
    return K5.build_expert_tables(tables)


def choose_action(tables: SimTables, etables: ExpertTables, state: EnvState,
                  horizon: int, bw_hat=None, acc_hat=None, use_corr=None,
                  return_margin: bool = False):
    """Best first action of every lane (see :func:`choose_action_plain`): K4
    on the card, the plain version for CPU tensors."""
    from mansy_immersivevideostreaming_torch.kernels import choose_action as K4
    return K4.choose_action(tables, etables, state, horizon, bw_hat, acc_hat, use_corr,
                            return_margin)
