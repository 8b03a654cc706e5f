"""Prediction-export CLI: the L1 -> L2 bridge artifact.

Port of the JAX package's ``cli/predict.py`` (reference
``viewport_prediction/predict.py``): runs a model over the merged
(train + valid + test) split and writes per-(video, user) chunk-level
viewport pickles ``[(chunk, gt_tilemap[64], pred_tilemap[64], IoU)]``
(reference ``predict.py:32-65``) with their CSVs, which
``data/prediction.py`` reads.  Every flag is the JAX CLI's; ``--model-path``
takes the MTIO ``.npz`` (``utils/checkpoint.py``).  Per batch the model runs
K8 62 times at the default widths and K7's chunk mode once (the first
``frequency`` steps' maps OR'd, and their IoU).

Example::

    python -m mansy_immersivevideostreaming_torch.cli.predict \\
        --model mtio --dataset Jin2022 --bs 512 --model-path best_model.npz
"""

from __future__ import annotations

import argparse
import os
import time
from collections import defaultdict

import numpy as np
import torch

from mansy_immersivevideostreaming_torch.cli.run_models import build_model, make_sample_fn
from mansy_immersivevideostreaming_torch.config import load_config
from mansy_immersivevideostreaming_torch.data.prediction import write_prediction
from mansy_immersivevideostreaming_torch.data.viewport import build_windowed_dataset
from mansy_immersivevideostreaming_torch.kernels.tile_occupancy import chunk_maps
from mansy_immersivevideostreaming_torch.utils.checkpoint import load_mtio_npz_into
from mansy_immersivevideostreaming_torch.utils.device import resolve_device
from mansy_immersivevideostreaming_torch.utils.prng import seed_everything


def run(args, config) -> dict:
    """Export the predictions; returns the trajectories and the seconds of
    the batch loop (sampling and K7, until the maps are on the host)."""
    # None -> config backfill (reference predict.py:148-153)
    args.trim_head = config.trim_head if args.trim_head is None else args.trim_head
    args.trim_tail = config.trim_tail if args.trim_tail is None else args.trim_tail
    args.dataset_frequency = (config.frequency if args.dataset_frequency is None
                              else args.dataset_frequency)
    args.sample_step = config.sample_step if args.sample_step is None else args.sample_step
    dev = resolve_device(args.device)
    seed_everything(args.seed)
    results_dir = args.output_dir or os.path.join(config.viewport_dir(args.dataset),
                                                  "prediction")
    os.makedirs(results_dir, exist_ok=True)

    videos, users = [], []
    for split in ("train", "valid", "test"):
        videos += config.video_split[args.dataset][split]
        users += config.user_split[args.dataset][split]
    videos, users = sorted(set(videos)), sorted(set(users))
    ds = build_windowed_dataset(config, args.dataset, videos, users,
                                args.his_window, args.fut_window,
                                args.trim_head, args.trim_tail,
                                args.sample_step, args.dataset_frequency)

    model = None
    if args.model != "regression":
        model = build_model(args, dev)
        load_mtio_npz_into(model, args.model_path)
        print("Successfully loaded model from", args.model_path)
    sample_fn = make_sample_fn(args, model)

    print(f"Predict with model {args.model} on {args.dataset} - seed: {args.seed}")
    per_pair = defaultdict(list)
    n = len(ds)
    t0 = time.time()
    for s in range(0, n, args.bs):
        h, c, f, video, user, _ = ds.gather(np.arange(s, min(s + args.bs, n)))
        h, c, f = (torch.as_tensor(x, device=dev) for x in (h, c, f))
        g, p, acc = chunk_maps(f, sample_fn(h, c), args.dataset_frequency)
        g, p, acc = g.cpu().numpy(), p.cpu().numpy(), acc.cpu().numpy()
        for i in range(len(video)):
            per_pair[(int(video[i]), int(user[i]))].append((g[i], p[i], float(acc[i])))
    seconds = time.time() - t0
    print(f"Processed {n} samples in {seconds:.1f}s ({n / seconds:,.0f} trajectories/s)")

    chunk_offset = args.trim_head // args.dataset_frequency
    for (video, user), entries in per_pair.items():
        out = [(i + chunk_offset, g, p, a) for i, (g, p, a) in enumerate(entries)]
        write_prediction(config, args.dataset, video, user, out, out_dir=results_dir)
    print("Predictions saved under", results_dir)
    return dict(trajectories=n, loop_seconds=seconds)


def build_parser():
    parser = argparse.ArgumentParser(description="Export chunk-level viewport predictions.")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--model", type=str, default="mtio")
    parser.add_argument("--hidden-dim", type=int, default=512)
    parser.add_argument("--block-num", type=int, default=2)
    parser.add_argument("--model-path", type=str,
                        help="the MTIO .npz (Flax params and batch_stats)")
    parser.add_argument("--compile", action="store_true",
                        help="accepted for reference-CLI compatibility")
    parser.add_argument("--dataset", type=str, default="Jin2022")
    parser.add_argument("--his-window", type=int, default=5)
    parser.add_argument("--fut-window", type=int, default=15)
    parser.add_argument("--trim-head", type=int)
    parser.add_argument("--trim-tail", type=int)
    parser.add_argument("--dataset-frequency", type=int)
    parser.add_argument("--sample-step", type=int)
    parser.add_argument("--bs", type=int, default=512)
    parser.add_argument("--seed", type=int, default=5)
    parser.add_argument("--output-dir", type=str, default=None,
                        help="override output dir (default: dataset tree)")
    parser.add_argument("--config-yml", type=str, default=None)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    print(args)
    return run(args, load_config(args.config_yml))


if __name__ == "__main__":
    main()
