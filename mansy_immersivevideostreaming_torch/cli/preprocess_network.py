"""Network trace preprocessing CLI.

Port of the JAX package's ``cli/preprocess_network.py`` (reference
``dataset_preprocess/network.py``): raw 4G ``.log`` files (``timestamp |
cumulative time | geo_x | geo_y | data volume | elapsed``) are simplified
to per-second ``(second, bytes)`` pairs written as both ``.log`` and
``.pkl`` (reference ``network.py:10-41``); ``--scale`` writes a min-max
rescaled copy of one trace's pickle (reference ``network.py:61-76``)
through the port's ``data/network.py:scale_trace``.  Host work only.

Usage::

    python -m mansy_immersivevideostreaming_torch.cli.preprocess_network --dataset 4G
    python -m mansy_immersivevideostreaming_torch.cli.preprocess_network --scale x.pkl \\
        --up 8 --low 2
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from mansy_immersivevideostreaming_torch.config import load_config
from mansy_immersivevideostreaming_torch.data.network import scale_trace as scale_throughputs


def simplify_network_trace(trace_name, raw_dataset_dir, dataset_dir, save_pkl=True):
    trace_path = os.path.join(raw_dataset_dir, trace_name)
    new_trace_path = os.path.join(dataset_dir, trace_name)
    data = []
    with open(trace_path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split()
            data.append(int(parts[-2]))
    with open(new_trace_path, "w", encoding="utf-8") as f:
        for i, v in enumerate(data):
            f.write(f"{i} {v}\n")
    print("Simplified trace (.log) saved at:", new_trace_path)
    if save_pkl:
        pkl_path = new_trace_path.replace(".log", ".pkl")
        with open(pkl_path, "wb") as f:
            pickle.dump(list(enumerate(data)), f)
        print("Simplified trace (.pkl) saved at:", pkl_path)


def simplify_network_dataset(dataset, config):
    raw_dir = config.raw_network_datasets_dir.get(
        dataset, os.path.join(config.datasets_base_dir, "raw_network", dataset))
    out_dir = config.network_dir(dataset)
    os.makedirs(out_dir, exist_ok=True)
    if dataset == "4G":
        for fname in os.listdir(raw_dir):
            if fname.endswith(".log"):
                simplify_network_trace(fname, raw_dir, out_dir)


def scale_trace(dataset, trace_pkl, up, low, config):
    trace_path = os.path.join(config.network_dir(dataset), trace_pkl)
    with open(trace_path, "rb") as f:
        trace = pickle.load(f)
    tps = np.asarray([t[1] for t in trace], np.float64)
    scaled_tp = scale_throughputs(tps, up, low)
    scaled = [(trace[i][0], float(scaled_tp[i])) for i in range(len(trace))]
    out = os.path.join(config.network_dir(dataset), f"scaled_up_{up}_low_{low}" + trace_pkl)
    with open(out, "wb") as f:
        pickle.dump(scaled, f)
    print("Scaled trace (.pkl) saved at:", out)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="4G")
    parser.add_argument("--scale", type=str, default=None,
                        help="trace pkl to rescale (requires --up/--low)")
    parser.add_argument("--up", type=float)
    parser.add_argument("--low", type=float)
    parser.add_argument("--config-yml", type=str, default=None)
    return parser


def run(args, config) -> None:
    if args.scale:
        scale_trace(args.dataset, args.scale, args.up, args.low, config)
    else:
        simplify_network_dataset(args.dataset, config)


def main(argv=None):
    args = build_parser().parse_args(argv)
    run(args, load_config(args.config_yml))


if __name__ == "__main__":
    main()
