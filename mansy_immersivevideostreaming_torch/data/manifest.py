"""Video manifest IO.

Reads the reference's per-video manifest JSON (written by reference
``dataset_preprocess/video.py:123-152``) with schema::

    {"Video_Time": s, "Chunk_Count": n, "Chunk_Time": 1,
     "Available_Bitrates": [...],
     "Chunks": {"0": {"size": [rate][tile], "quality": [rate][tile]}, ...}}

and packs a set of videos into dense device-stageable arrays
``[video, chunk, rate, tile]`` padded to the longest video, which makes
episode reset an index-select and lets thousands of simulator instances be
vmapped.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Sequence, Tuple

import numpy as np

from mansy_immersivevideostreaming_torch.config import Config


class ManifestTables(NamedTuple):
    """Dense chunk tables for a list of videos (same index order as input)."""
    sizes: np.ndarray      # f32 [V, C, R, T] bytes
    qualities: np.ndarray  # f32 [V, C, R, T] bitrate units
    video_length: np.ndarray  # i32 [V] seconds (== Video_Time)
    num_chunks: np.ndarray    # i32 [V] chunks present in manifest


def load_manifest(config: Config, dataset: str, video: int) -> dict:
    path = os.path.join(config.manifest_dir(dataset), f"video{video}.json")
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def load_manifest_tables(config: Config, dataset: str,
                         videos: Sequence[int],
                         max_chunks: int | None = None) -> ManifestTables:
    num_rates = config.num_rates
    num_tiles = config.tile_total_num
    manifests = [load_manifest(config, dataset, v) for v in videos]
    chunk_counts = [len(m["Chunks"]) for m in manifests]
    if max_chunks is None:
        max_chunks = max(chunk_counts)
    V = len(videos)
    sizes = np.zeros((V, max_chunks, num_rates, num_tiles), np.float32)
    qualities = np.zeros((V, max_chunks, num_rates, num_tiles), np.float32)
    lengths = np.zeros(V, np.int32)
    counts = np.zeros(V, np.int32)
    for i, m in enumerate(manifests):
        lengths[i] = int(m["Video_Time"])
        counts[i] = chunk_counts[i]
        for c_str, info in m["Chunks"].items():
            c = int(c_str)
            if c < max_chunks:
                sizes[i, c] = np.asarray(info["size"], np.float32)
                qualities[i, c] = np.asarray(info["quality"], np.float32)
    return ManifestTables(sizes=sizes, qualities=qualities,
                          video_length=lengths, num_chunks=counts)
