"""Viewport-prediction artifact IO — the L1 -> L2 bridge.

The reference exports per-(video, user) pickles with schema
``[(chunk:int, gt:uint8[64], pred:uint8[64], accuracy:float), ...]``
(written by ``viewport_prediction/predict.py:50-65``; consumed by
``bitrate_selection/simulators/hmdtrace.py:4-23``).  This module reads/writes
that exact format and additionally packs a whole (videos x users) grid into
dense padded arrays for the vmapped simulator.
"""

from __future__ import annotations

import os
import pickle
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

from mansy_immersivevideostreaming_torch.config import Config


class PredictionTables(NamedTuple):
    """Dense viewport tables over a (videos x users) grid, chunk-indexed
    from 0 (absolute chunk ids; entries before start_chunk are zeros)."""
    gt: np.ndarray          # u8 [V, U, C, T]
    pred: np.ndarray        # u8 [V, U, C, T]
    accuracy: np.ndarray    # f32 [V, U, C]
    start_chunk: np.ndarray  # i32 [V, U]
    end_chunk: np.ndarray    # i32 [V, U] (NOT yet clamped by video length)


def load_prediction(config: Config, dataset: str, video: int, user: int) -> list:
    path = os.path.join(config.viewport_dir(dataset), "prediction",
                        f"video{video}", f"user{user}.pkl")
    with open(path, "rb") as f:
        return pickle.load(f)


def write_prediction(config: Config, dataset: str, video: int, user: int,
                     entries: List[Tuple[int, np.ndarray, np.ndarray, float]],
                     out_dir: str | None = None) -> None:
    """Write the pkl + csv pair in the reference's exact format
    (``predict.py:50-65``)."""
    base = out_dir or os.path.join(config.viewport_dir(dataset), "prediction")
    vdir = os.path.join(base, f"video{video}")
    os.makedirs(vdir, exist_ok=True)
    with open(os.path.join(vdir, f"user{user}.pkl"), "wb") as f:
        pickle.dump(entries, f)
    with open(os.path.join(vdir, f"user{user}.csv"), "w", encoding="utf-8") as f:
        f.write("chunk,gt,pred,accuracy\n")
        for chunk, gt, pred, acc in entries:
            gt_s = ",".join(map(str, list(gt)))
            pred_s = ",".join(map(str, list(pred)))
            f.write(f"{chunk},{gt_s},{pred_s},{acc}\n")


def load_prediction_tables(config: Config, dataset: str,
                           videos: Sequence[int], users: Sequence[int],
                           max_chunks: int | None = None) -> PredictionTables:
    num_tiles = config.tile_total_num
    raw = {}
    ends = []
    for v in videos:
        for u in users:
            entries = load_prediction(config, dataset, v, u)
            raw[(v, u)] = entries
            ends.append(entries[-1][0])
    if max_chunks is None:
        max_chunks = max(ends) + 1
    V, U = len(videos), len(users)
    gt = np.zeros((V, U, max_chunks, num_tiles), np.uint8)
    pred = np.zeros((V, U, max_chunks, num_tiles), np.uint8)
    acc = np.zeros((V, U, max_chunks), np.float32)
    start = np.zeros((V, U), np.int32)
    end = np.zeros((V, U), np.int32)
    for i, v in enumerate(videos):
        for j, u in enumerate(users):
            entries = raw[(v, u)]
            start[i, j] = entries[0][0]
            end[i, j] = entries[-1][0]
            for chunk, g, p, a in entries:
                if chunk < max_chunks:
                    gt[i, j, chunk] = g
                    pred[i, j, chunk] = p
                    acc[i, j, chunk] = a
    return PredictionTables(gt=gt, pred=pred, accuracy=acc,
                            start_chunk=start, end_chunk=end)
