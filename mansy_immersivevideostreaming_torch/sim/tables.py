"""Device-resident simulation tables.

Port of ``mansy_immersivevideostreaming_tpu/sim/tables.py``: everything a
rollout can touch is staged once as dense tensors keyed by (video, user,
trace) index within a split, so an episode reset is an index select and
thousands of simulator lanes step together on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from mansy_immersivevideostreaming_torch.config import Config
from mansy_immersivevideostreaming_torch.data.manifest import load_manifest_tables
from mansy_immersivevideostreaming_torch.data.network import load_network_tables
from mansy_immersivevideostreaming_torch.data.prediction import load_prediction_tables
from mansy_immersivevideostreaming_torch.sim.simulator import build_prefix
from mansy_immersivevideostreaming_torch.utils.device import resolve_device


class SimTables(NamedTuple):
    """All static data a rollout needs, indexed by split-local ids."""
    # chunk tables
    sizes: torch.Tensor        # f32 [V, C, R, T]
    qualities: torch.Tensor    # f32 [V, C, R, T]
    # viewport tables
    gt: torch.Tensor           # f32 [V, U, C, T]
    pred: torch.Tensor         # f32 [V, U, C, T]
    vp_acc: torch.Tensor       # f32 [V, U, C]
    start_chunk: torch.Tensor  # i32 [V, U]
    end_chunk: torch.Tensor    # i32 [V, U] (clamped to video length - 1)
    # bandwidth traces
    bw: torch.Tensor           # f32 [N, L] bytes/sec
    bw_len: torch.Tensor       # i32 [N]
    bw_prefix: torch.Tensor    # f32 [N, L+1] cumulative bytes (inf past len)
    # qoe preferences
    qoe_weights: torch.Tensor  # f32 [Q, 3]
    # streaming constants
    startup_download: int
    chunk_length: float
    max_rate: float
    max_size: float
    max_throughput: float
    video_rates: torch.Tensor  # i32 [R]
    past_k: int
    action_space: int
    # deployable per-action profiling tables f32 [V, U, C, A], attached by
    # sim.expert.attach_action_values: allocation AND evaluation on the
    # predicted viewport.  With them observe_mansy emits ``action_values``.
    av_quality: Optional[torch.Tensor] = None
    av_intra: Optional[torch.Tensor] = None
    av_size: Optional[torch.Tensor] = None       # bytes
    # out-of-prediction tables: when present, the action values are the
    # accuracy-corrected estimate (sim.expert.corrected_scores)
    av_out_quality: Optional[torch.Tensor] = None
    av_out_intra: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.sizes.device


def synthetic_sim_tables(num_videos: int = 2, num_users: int = 2,
                         num_traces: int = 2, num_chunks: int = 20,
                         num_qoe: int = 2, seed: int = 0,
                         device: str | torch.device = "cuda") -> SimTables:
    """Small random tables with the real schema (no dataset tree needed).

    Draws from ``np.random.default_rng(seed)`` in the JAX package's order, so
    the tables are bitwise identical to its ``synthetic_sim_tables``.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    R, T = 5, 64
    rates = np.array([1, 5, 8, 16, 35], np.int32)
    qualities = np.broadcast_to(
        rates.astype(np.float32)[None, None, :, None],
        (num_videos, num_chunks, R, T)).copy()
    sizes = qualities * 1e6 / 8 / T * rng.uniform(
        0.5, 1.5, (num_videos, num_chunks, R, T)).astype(np.float32)
    vp = np.zeros((num_videos, num_users, num_chunks, T), np.float32)
    for v in range(num_videos):
        for u in range(num_users):
            for c in range(num_chunks):
                start = rng.integers(0, T - 8)
                vp[v, u, c, start:start + 8] = 1
    pred = vp.copy()
    start = np.full((num_videos, num_users), 3, np.int32)
    end = np.full((num_videos, num_users), num_chunks - 1, np.int32)
    bw = rng.uniform(5e5, 4e6, (num_traces, 50)).astype(np.float32)
    qoe = rng.uniform(1, 7, (num_qoe, 3)).astype(np.float32)
    lens = np.full(num_traces, 50, np.int32)
    t = lambda a: torch.as_tensor(a, device=dev)
    return SimTables(
        sizes=t(sizes), qualities=t(qualities), gt=t(vp), pred=t(pred),
        vp_acc=torch.ones((num_videos, num_users, num_chunks), dtype=torch.float32, device=dev),
        start_chunk=t(start), end_chunk=t(end),
        bw=t(bw), bw_len=t(lens), bw_prefix=build_prefix(bw, lens).to(dev),
        qoe_weights=t(qoe),
        startup_download=5, chunk_length=1.0, max_rate=35.0,
        max_size=500000.0, max_throughput=5000000.0,
        video_rates=t(rates), past_k=8, action_space=15)


def build_sim_tables(config: Config, dataset: str, network_dataset: str,
                     videos: Sequence[int], users: Sequence[int],
                     traces: Sequence[int],
                     qoe_weights: Sequence[Sequence[float]],
                     trace_scale=None,
                     device: str | torch.device = "cuda") -> SimTables:
    """Tables of one split from the dataset tree.  ``trace_scale``: optional
    (up, low) min-max rescaling of every trace (reference
    ``Simulator.__init__`` trace_scale -> ``network.py:10-17``)."""
    dev = resolve_device(device)
    mt = load_manifest_tables(config, dataset, videos)
    pt = load_prediction_tables(config, dataset, videos, users,
                                max_chunks=mt.sizes.shape[1])
    nt = load_network_tables(config, network_dataset, traces, scale=trace_scale)
    end = np.minimum(pt.end_chunk, (mt.video_length - 1)[:, None])
    t = lambda a: torch.as_tensor(a, device=dev)
    return SimTables(
        sizes=t(mt.sizes), qualities=t(mt.qualities),
        gt=t(pt.gt.astype(np.float32)), pred=t(pt.pred.astype(np.float32)),
        vp_acc=t(pt.accuracy), start_chunk=t(pt.start_chunk),
        end_chunk=t(end.astype(np.int32)),
        bw=t(nt.throughput), bw_len=t(nt.length),
        bw_prefix=build_prefix(nt.throughput, nt.length).to(dev),
        qoe_weights=t(np.asarray(qoe_weights, np.float32)),
        startup_download=config.startup_download,
        chunk_length=float(config.chunk_length),
        max_rate=float(config.video_rates[-1]),
        max_size=float(config.max_size),
        max_throughput=float(config.max_throughput),
        video_rates=t(np.asarray(config.video_rates, np.int32)),
        past_k=config.past_k,
        action_space=config.action_space,
    )
