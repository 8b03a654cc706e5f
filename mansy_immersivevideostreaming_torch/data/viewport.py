"""Viewport trajectory dataset for the prediction models (numpy only).

A copy of the JAX package's ``data/viewport.py``, so that the port never
imports the JAX package.  It replaces the reference's torch
``ViewportDataset``/``DataLoader`` path
(``viewport_prediction/utils/load_dataset.py``) with precomputed gather
indices over a single padded trace tensor: sample i is three slices of
``traces[pair_index[i]]`` at ``timestep[i]``, so an entire batch is one
gather — no per-sample Python.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

from mansy_immersivevideostreaming_torch.config import Config


def load_viewport_trace(config: Config, dataset: str, video: int, user: int,
                        frequency: int | None = None) -> np.ndarray:
    """Load one simplified trace as f32[T, 2] (x, y), dropping the timestamp
    column as the reference does (``load_dataset.py:68``)."""
    freq = frequency or config.frequency
    path = os.path.join(config.viewport_dir(dataset), f"video{video}",
                        f"{freq}Hz", f"simple_{freq}Hz_user{user}.npy")
    data = np.load(path)
    return np.asarray(data[:, 1:], np.float32)


def pack_viewport_traces(config: Config, dataset: str,
                         pairs: Sequence[Tuple[int, int]],
                         frequency: int | None = None):
    """Load traces for (video, user) pairs -> (padded f32[P, Lmax, 2], i32[P])."""
    traces = [load_viewport_trace(config, dataset, v, u, frequency) for v, u in pairs]
    lens = np.asarray([len(t) for t in traces], np.int32)
    P, L = len(traces), int(lens.max())
    out = np.zeros((P, L, 2), np.float32)
    for i, t in enumerate(traces):
        out[i, : len(t)] = t
    return out, lens


class WindowedViewportDataset(NamedTuple):
    """Sliding-window sample index over packed traces.

    Semantics match reference ``ViewportDataset`` (``load_dataset.py:33-52``):
    for each (video, user) and each timestep in
    ``range(trim_head, len(trace) - trim_tail, step)``, the sample is
    (history[t-M:t], current[t:t+1], future[t+1:t+H+1]).
    """
    traces: np.ndarray      # f32 [P, Lmax, 2]
    pair_videos: np.ndarray  # i32 [P]
    pair_users: np.ndarray   # i32 [P]
    sample_pair: np.ndarray  # i32 [N] index into P
    sample_t: np.ndarray     # i32 [N] timestep
    his_window: int
    fut_window: int

    def __len__(self) -> int:
        return len(self.sample_pair)

    def gather(self, idx: np.ndarray):
        """Host-side gather of a batch: returns (history [B,M,2],
        current [B,1,2], future [B,H,2], video [B], user [B], timestep [B])."""
        p = self.sample_pair[idx]
        t = self.sample_t[idx]
        M, H = self.his_window, self.fut_window
        offs_h = np.arange(-M, 0)
        offs_c = np.arange(0, 1)
        offs_f = np.arange(1, H + 1)
        history = self.traces[p[:, None], t[:, None] + offs_h[None, :]]
        current = self.traces[p[:, None], t[:, None] + offs_c[None, :]]
        future = self.traces[p[:, None], t[:, None] + offs_f[None, :]]
        return history, current, future, self.pair_videos[p], self.pair_users[p], t


def build_windowed_dataset(config: Config, dataset: str,
                           videos: Sequence[int], users: Sequence[int],
                           his_window: int, fut_window: int,
                           trim_head: int | None = None,
                           trim_tail: int | None = None,
                           step: int | None = None,
                           frequency: int | None = None,
                           packed=None) -> WindowedViewportDataset:
    trim_head = config.trim_head if trim_head is None else trim_head
    trim_tail = config.trim_tail if trim_tail is None else trim_tail
    step = config.sample_step if step is None else step

    pairs = [(v, u) for v in videos for u in users]
    if packed is None:
        traces, lens = pack_viewport_traces(config, dataset, pairs, frequency)
    else:
        traces, lens = packed
    sample_pair: List[int] = []
    sample_t: List[int] = []
    for i, _ in enumerate(pairs):
        for t in range(trim_head, int(lens[i]) - trim_tail, step):
            sample_pair.append(i)
            sample_t.append(t)
    return WindowedViewportDataset(
        traces=traces,
        pair_videos=np.asarray([v for v, _ in pairs], np.int32),
        pair_users=np.asarray([u for _, u in pairs], np.int32),
        sample_pair=np.asarray(sample_pair, np.int32),
        sample_t=np.asarray(sample_t, np.int32),
        his_window=his_window,
        fut_window=fut_window,
    )


def create_datasets(config: Config, dataset: str, his_window: int, fut_window: int,
                    include: Sequence[str] = ("train", "valid", "test_seen", "test_unseen"),
                    trim_head: int | None = None, trim_tail: int | None = None,
                    step: int | None = None, frequency: int | None = None,
                    video_split: Dict[str, Sequence[int]] | None = None,
                    user_split: Dict[str, Sequence[int]] | None = None
                    ) -> Dict[str, WindowedViewportDataset]:
    """Split resolution matching reference ``create_dataset``
    (``load_dataset.py:72-128``): test_seen = test videos x valid users
    (truncated to min split length), test_unseen = test videos x test users."""
    vsplit = dict(video_split or config.video_split[dataset])
    usplit = dict(user_split or config.user_split[dataset])
    if "test_seen" in include:
        vsplit["test_seen"] = vsplit["test"]
        m = min(len(usplit["valid"]), len(usplit["test"]))
        usplit["test_seen"] = usplit["valid"][:m]
    if "test_unseen" in include:
        vsplit["test_unseen"] = vsplit["test"]
        m = min(len(usplit["valid"]), len(usplit["test"]))
        usplit["test_unseen"] = usplit["test"][:m]
    out = {}
    for split in include:
        out[split] = build_windowed_dataset(
            config, dataset, vsplit[split], usplit[split], his_window, fut_window,
            trim_head, trim_tail, step, frequency)
    return out
