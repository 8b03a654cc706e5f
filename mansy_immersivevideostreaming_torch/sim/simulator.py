"""Functional core of the streaming simulator, batched over lanes.

Port of ``mansy_immersivevideostreaming_tpu/sim/simulator.py``:

* ``NetworkTrace.simulate_download`` (reference
  ``bitrate_selection/simulators/network.py:22-35``): consume per-second
  throughput segments, wrapping cyclically over the trace.
* ``PlaybackBuffer.push_chunk`` (reference ``simulators/buffer.py:8-15``).

Every function takes tensors with any leading batch shape ``[...]`` (the
lanes) in place of the JAX package's ``vmap``.  The network cursor keeps the
integer second and the fractional part separately, as the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class NetState(NamedTuple):
    """Bandwidth-trace cursor (reference ``network.py:19-20``)."""
    idx: torch.Tensor   # i32 [...]: index into the trace (wraps mod trace length)
    sec: torch.Tensor   # i32 [...]: whole seconds elapsed
    frac: torch.Tensor  # f32 [...] in [0, 1): fraction of the current second used


def init_net_state(batch_shape: Tuple[int, ...] = (),
                   device: torch.device | str = "cpu") -> NetState:
    zi = torch.zeros(batch_shape, dtype=torch.int32, device=device)
    return NetState(idx=zi, sec=zi.clone(),
                    frac=torch.zeros(batch_shape, dtype=torch.float32, device=device))


def _at(row: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """row[..., i] for a per-lane index i [...]."""
    return row.gather(-1, i.long()[..., None])[..., 0]


def simulate_download_bytes(bw_row: torch.Tensor, bw_len: torch.Tensor,
                            net: NetState, size: torch.Tensor
                            ) -> Tuple[NetState, torch.Tensor]:
    """Download ``size`` bytes; returns (new_state, download_time_seconds).

    The slow reference (reference ``network.py:22-35``): while bytes remain,
    the remaining throughput of the current second is ``(1 - frac) *
    bw[idx]``; consuming it advances to the next second (wrapping ``idx``),
    otherwise the fractional cursor advances by ``size / bw[idx]``.  Lanes
    that are done keep their state while the others loop on.
    """
    idx, sec, frac = net.idx, net.sec, net.frac
    s = torch.as_tensor(size, dtype=torch.float32, device=frac.device).expand(frac.shape)
    while bool((s > 0).any()):
        active = s > 0
        rate = _at(bw_row, idx)
        remain = (1.0 - frac) * rate
        full = s >= remain
        n_idx = torch.where(full, (idx + 1) % bw_len, idx)
        n_sec = torch.where(full, sec + 1, sec)
        n_frac = torch.where(full, torch.zeros_like(frac), frac + s / rate)
        n_s = torch.where(full, s - remain, torch.zeros_like(s))
        idx = torch.where(active, n_idx, idx)
        sec = torch.where(active, n_sec, sec)
        frac = torch.where(active, n_frac, frac)
        s = torch.where(active, n_s, s)
    dt = (sec - net.sec).to(torch.float32) + (frac - net.frac)
    return NetState(idx=idx, sec=sec, frac=frac), dt


def build_prefix(bw, bw_len) -> torch.Tensor:
    """Per-trace cumulative-bytes table for the closed-form download.

    bw [N, L] (padding after ``bw_len`` ignored) -> prefix [N, L+1] f32 with
    prefix[:, 0] = 0, prefix[:, i] = sum(bw[:, :i]) for i <= len, and +inf
    beyond the trace length so the count never selects padding.  Summed in
    f64 and cast to f32, as the JAX package does.
    """
    bw = np.asarray(bw, np.float64)
    lens = np.asarray(bw_len)
    N, L = bw.shape
    prefix = np.zeros((N, L + 1), np.float64)
    prefix[:, 1:] = np.cumsum(bw, axis=1)
    for i in range(N):
        prefix[i, lens[i] + 1:] = np.inf
    return torch.from_numpy(prefix.astype(np.float32))


def simulate_download_prefix(bw_row: torch.Tensor, prefix_row: torch.Tensor,
                             bw_len: torch.Tensor, net: NetState,
                             size: torch.Tensor) -> Tuple[NetState, torch.Tensor]:
    """Closed-form equivalent of :func:`simulate_download_bytes`.

    bw_row [..., L], prefix_row [..., L+1], bw_len/net/size [...].  The
    second-by-second walk is one cyclic prefix-sum search: finish inside the
    current second (case A), or consume its rest and then whole seconds found
    by counting prefix entries <= the remainder (case B).  Matches the JAX
    ``simulate_download_prefix`` operation for operation; it differs from the
    while loop only by float rounding (< ~1e-3 s) and at a download ending
    exactly on a second boundary before zero-bandwidth seconds.
    """
    L = bw_len.to(torch.int32)
    total = _at(prefix_row, L)
    rate0 = _at(bw_row, net.idx)
    size = torch.as_tensor(size, dtype=torch.float32, device=rate0.device)
    avail0 = (1.0 - net.frac) * rate0
    full0 = size >= avail0
    # Case A: finishes inside the current second.
    fracA = net.frac + size / rate0

    # Case B: consume the rest of this second, then whole seconds via the
    # cyclic prefix table.
    sp = size - avail0
    j0 = net.idx + 1  # may equal L (== position 0 of the next cycle)
    target = sp + _at(prefix_row, j0)
    q = torch.floor(target / total)
    rem = target - q * total
    wrap = rem >= total
    q = torch.where(wrap, q + 1, q)
    rem = torch.where(wrap, rem - total, rem)
    neg = rem < 0
    q = torch.where(neg, q - 1, q)
    rem = torch.where(neg, rem + total, rem)
    # smallest r with prefix[r] > rem == #{i: prefix[i] <= rem}
    r = torch.minimum(torch.clamp((prefix_row <= rem[..., None]).sum(-1), min=1), L)
    n = (q.to(torch.int32) * L + r).to(torch.int32)
    n = torch.maximum(n, j0)  # rounding guard; mathematically n > j0 - 1
    idxB = (n - 1) % L
    g_nm1 = total * ((n - 1) // L).to(torch.float32) + _at(prefix_row, idxB)
    remainder = torch.clamp(target - g_nm1, min=0.0)
    fracB = torch.where(remainder > 0, remainder / _at(bw_row, idxB),
                        torch.zeros_like(remainder))
    m_adv = n - 1 - net.idx
    # exact-boundary case: only the first second was consumed
    exact0 = sp == 0
    idxB = torch.where(exact0, j0 % L, idxB)
    m_adv = torch.where(exact0, torch.ones_like(m_adv), m_adv)
    fracB = torch.where(exact0, torch.zeros_like(fracB), fracB)

    new_idx = torch.where(full0, idxB, net.idx)
    new_sec = torch.where(full0, net.sec + m_adv, net.sec)
    new_frac = torch.where(full0, fracB, fracA)
    dt = (new_sec - net.sec).to(torch.float32) + (new_frac - net.frac)
    return NetState(idx=new_idx, sec=new_sec, frac=new_frac), dt


def push_chunk(buf_size: torch.Tensor, chunk_length: float,
               download_time: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Playback buffer update; returns (new_buf_size, rebuffer_time).

    Reference ``buffer.py:8-15``: rebuffering occurs iff the download outlasts
    the buffer, in which case the buffer restarts at one chunk.
    """
    rebuf = torch.clamp(download_time - buf_size, min=0.0)
    new_buf = torch.where(download_time > buf_size,
                          torch.full_like(buf_size, chunk_length),
                          buf_size - download_time + chunk_length)
    return new_buf, rebuf


INIT_BUFFER_CHUNKS = 3.0  # reference ``buffer.py:6``: buffer starts at 3 chunks


def init_buffer(chunk_length: float, batch_shape: Tuple[int, ...] = (),
                device: torch.device | str = "cpu") -> torch.Tensor:
    return torch.full(batch_shape, INIT_BUFFER_CHUNKS * chunk_length,
                      dtype=torch.float32, device=device)
