"""HMD (viewport) trace preprocessing CLI.

Port of the JAX package's ``cli/preprocess_hmdtrace.py`` (reference
``dataset_preprocess/hmdtrace.py``), with the same files in name and
layout:

* ``--preprocess``: raw logs -> normalized (time, x, y) CSVs
  (``viewports/video{i}/user{j}.csv``, ``%.6f``).  Wu2017: quaternion ->
  direction -> angles -> equirect on a unit frame (reference
  ``hmdtrace.py:33-55``), whole traces at once through the port's
  ``ops/orientation.py`` in float64 on ``--device`` (the card unless
  ``--device cpu``).  Jin2022: per-video pixel normalization, incomplete
  users and user 51 skipped, the rest relabeled 1..n (reference
  ``hmdtrace.py:56-78``), on the host in float32.
* ``simplify``: the ``--frequency`` Hz resampling with the reference's
  greedy row selection and dirty-data filter (reference
  ``hmdtrace.py:81-115``), on the host with the JAX package's float32 /
  float64 mix: a float32 row time is compared with a float64 accumulator.
  Writes ``{frequency}Hz/simple_{frequency}Hz_user{j}.csv`` and ``.npy``.

Usage::

    python -m mansy_immersivevideostreaming_torch.cli.preprocess_hmdtrace \\
        --dataset Wu2017 --preprocess [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from mansy_immersivevideostreaming_torch.config import load_config
from mansy_immersivevideostreaming_torch.ops import orientation
from mansy_immersivevideostreaming_torch.utils.device import resolve_device


def wu2017_trace(raw_path: str, device) -> np.ndarray:
    """One raw Wu2017 log (idx, playback time, q1..q4 with a header row) ->
    [T, 3] (time, x, y), x and y on the unit equirect frame."""
    raw = np.loadtxt(raw_path, delimiter=",", usecols=(1, 2, 3, 4, 5),
                     dtype=str)[1:].astype(np.float32)
    playback_time, quat = raw[:, 0], raw[:, 1:]
    zyxw = np.stack([quat[:, 2], quat[:, 1], quat[:, 0], quat[:, 3]], axis=1)
    vec = orientation.extract_direction_dataset2(zyxw, device)
    theta, phi = orientation.vector_to_ang(vec)
    y, x = orientation.ang_to_geoxy(theta, phi, 1.0, 1.0)
    return np.stack([playback_time, x.cpu().numpy(), y.cpu().numpy()], axis=1)


def preprocess_hmd_trace(dataset: str, config, device="cuda") -> None:
    raw_dir = os.path.join(config.raw_datasets_dir.get(
        dataset, os.path.join(config.datasets_base_dir, "raw", dataset)), "viewports")
    out_dir = config.viewport_dir(dataset)

    if dataset == "Wu2017":
        dev = resolve_device(device)
        # raw Wu2017 ships 9 videos x 48 users (reference hmdtrace.py:24);
        # config entries override for smaller/synthetic trees
        origin_video_num = config.video_num.get(dataset, 9)
        origin_user_num = config.user_num.get(dataset, 48)
        for i in range(1, origin_video_num + 1):
            for j in range(1, origin_user_num + 1):
                data = wu2017_trace(os.path.join(raw_dir, str(j), f"video_{i - 1}.csv"), dev)
                vdir = os.path.join(out_dir, f"video{i}")
                os.makedirs(vdir, exist_ok=True)
                path = os.path.join(vdir, f"user{j}.csv")
                np.savetxt(path, data, fmt="%.6f", delimiter=",")
                print(path)
    elif dataset == "Jin2022":
        origin_video_num, origin_user_num = 27, 100
        label = 0
        for j in range(1, origin_user_num + 1):
            udir = os.path.join(raw_dir, str(j))
            if not os.path.isdir(udir):
                continue
            files = os.listdir(udir)
            # skip incomplete users and user 51 (reference hmdtrace.py:62-63)
            if len(files) != origin_video_num or j == 51:
                continue
            label += 1
            for fname in files:
                i = int(fname.split("_")[2])
                raw = np.loadtxt(os.path.join(udir, fname), delimiter=",",
                                 usecols=(0, 1, 2), dtype=str)[1:].astype(np.float32)
                _, vw, vh = config.video_info[dataset][i]
                raw[:, 1] /= vw
                raw[:, 2] /= vh
                vdir = os.path.join(out_dir, f"video{i}")
                os.makedirs(vdir, exist_ok=True)
                path = os.path.join(vdir, f"user{label}.csv")
                np.savetxt(path, raw, fmt="%.6f", delimiter=",")
                print(path)


def simplify_hmd_trace(dataset: str, config, frequency: int = 5) -> None:
    out_dir = config.viewport_dir(dataset)
    video_num = config.video_num[dataset]
    user_num = config.user_num[dataset]
    gap = 1.0 / frequency
    for i in range(1, video_num + 1):
        for j in range(1, user_num + 1):
            origin = np.loadtxt(os.path.join(out_dir, f"video{i}", f"user{j}.csv"),
                                delimiter=",", dtype=np.float32)
            rows = []
            timestamp = 0.0
            rela = origin[0][0]
            for row in origin:
                t = (row[0] - rela) if dataset == "Jin2022" else row[0]
                if int(t) > 0 and timestamp == 0:
                    continue  # dirty-data filter (reference hmdtrace.py:102)
                if t >= timestamp:  # float32 row time against the float64 accumulator
                    rows.append(row)
                    timestamp += gap
            data = np.asarray(rows)
            sdir = os.path.join(out_dir, f"video{i}", f"{frequency}Hz")
            os.makedirs(sdir, exist_ok=True)
            np.savetxt(os.path.join(sdir, f"simple_{frequency}Hz_user{j}.csv"),
                       data, fmt="%.6f", delimiter=",")
            np.save(os.path.join(sdir, f"simple_{frequency}Hz_user{j}.npy"), data)
            print("Simplified:", sdir, f"user{j}")


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="Jin2022")
    parser.add_argument("--frequency", type=int, default=5)
    parser.add_argument("--preprocess", action="store_true",
                        help="also run raw quaternion/pixel preprocessing "
                             "(reference runs only simplify by default)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where Wu2017's quaternion math runs")
    parser.add_argument("--config-yml", type=str, default=None)
    return parser


def run(args, config) -> None:
    if args.preprocess:
        preprocess_hmd_trace(args.dataset, config, args.device)
    simplify_hmd_trace(args.dataset, config, args.frequency)


def main(argv=None):
    args = build_parser().parse_args(argv)
    run(args, load_config(args.config_yml))


if __name__ == "__main__":
    main()
