"""Bandwidth trace IO.

The reference stores each 4G trace as a pickled list of ``(second, bytes)``
tuples (written by ``dataset_preprocess/network.py:32-41``) and replays it
cyclically during downloads (``bitrate_selection/simulators/network.py:22-35``).

Here traces are packed into a padded ``[trace, sec]`` throughput matrix with an
explicit per-trace length so the functional simulator can be vmapped across
traces.  Min-max rescaling (reference ``network.py:10-17`` constructor `scale`)
is provided as :func:`scale_trace`.
"""

from __future__ import annotations

import os
import pickle
from typing import NamedTuple, Sequence, Tuple

import numpy as np

from mansy_immersivevideostreaming_torch.config import Config


class NetworkTables(NamedTuple):
    throughput: np.ndarray  # f32 [N, max_len] bytes/sec (zero-padded)
    length: np.ndarray      # i32 [N]


def load_network_trace(config: Config, network_dataset: str, trace: int,
                       scale: Tuple[float, float] | None = None) -> np.ndarray:
    """Load a single trace as f32[len] bytes/sec."""
    path = os.path.join(config.network_dir(network_dataset),
                        config.network_info[network_dataset][trace])
    with open(path, "rb") as f:
        data = pickle.load(f)
    tp = np.asarray([row[1] for row in data], np.float64)
    if scale is not None:
        tp = scale_trace(tp, scale[0], scale[1])
    return tp.astype(np.float32)


def scale_trace(throughput: np.ndarray, up: float, low: float) -> np.ndarray:
    """Min-max rescale into [low, up]; reference ``simulators/network.py:10-17``."""
    max_, min_ = throughput.max(), throughput.min()
    k = (up - low) / (max_ - min_)
    return low + k * (throughput - min_)


def load_network_tables(config: Config, network_dataset: str,
                        traces: Sequence[int],
                        scale: Tuple[float, float] | None = None) -> NetworkTables:
    tps = [load_network_trace(config, network_dataset, t, scale) for t in traces]
    max_len = max(len(t) for t in tps)
    N = len(tps)
    out = np.zeros((N, max_len), np.float32)
    lens = np.zeros(N, np.int32)
    for i, t in enumerate(tps):
        out[i, : len(t)] = t
        lens[i] = len(t)
    # Padding value 1.0 avoids division by zero in masked lanes; real lanes
    # never index past `length` because the cursor wraps modulo `length`.
    for i in range(N):
        out[i, lens[i]:] = 1.0
    return NetworkTables(throughput=out, length=lens)
