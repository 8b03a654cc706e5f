"""Viewport-prediction training and testing CLI.

Port of the JAX package's ``cli/run_models.py`` (reference
``viewport_prediction/run_models.py``): the same flags, directory layout,
file prefix and outputs.  ``--train`` trains the MTIO model from Flax's
initialisers (``init_like_flax``) with AdamW, one epoch at a time over the
train split staged on the device (``vp_train.train_epoch``, the epoch's
permutation from ``np.random.default_rng(seed)`` as in the JAX CLI), and
every ``--epochs-per-valid`` epochs validates, writes
``<file_prefix>_checkpoint.npz`` (weights, AdamW state, step;
``--resume --resume-path`` reads it) and, when the validation MSE is the
best so far, ``<file_prefix>_best_model.npz`` (Flax params and
``batch_stats``, ``utils/checkpoint.py``), where the JAX CLI writes its
``.ckpt`` files; the console is tee'd into ``<file_prefix>console.log``.
``--teacher-forcing`` trains with the single-pass decode; ``--bf16``
computes in bf16 (the parameters, the optimizer state, the checkpoints and
the predictions stay f32; K8 runs its bf16 kernels) with ``--train``,
``--test``, ``--resume`` and ``--teacher-forcing`` alike.  ``--test``
writes ``<prefix>_seen_results.csv``, ``.log`` and ``accuracy_result.csv``
and the unseen ones; ``--model mtio`` reads the best model's npz,
``--model regression`` runs the closed-form baseline.  Per batch the model
runs K8 62 times at the default widths (2 encoder layers, then 15 decode
steps x 2 layers x self- and cross-attention): in training, its training
forward and its backward kernel 62 times each (6 with teacher forcing); in
validation and testing its serving kernel, and the results recorder K7
once.

``--data-parallel`` is read as the JAX CLI reads it: ``--test`` ignores it,
and ``--train`` on one device runs as without it.  Over more devices the
run is one rank a device (``parallel/launch.py`` starts them, or torchrun
does), each holding the whole split: each step's batch is the JAX CLI's
per-batch path's (the epoch's permutation, the last partial batch
dropped), and every rank computes its rows' share of it
(``vp_train.train_step`` with the mesh: the slot permutations, keep masks
and BatchNorm statistics are the whole batch's).  Rank 0 alone validates
and writes the checkpoints and the console, then runs ``--test``.

Example::

    python -m mansy_immersivevideostreaming_torch.cli.run_models --train --test \\
        --model mtio --train-dataset Jin2022 --test-dataset Jin2022 --his-window 5 \\
        --fut-window 15 --bs 512 --seed 5 --hidden-dim 512 --block-num 2 --lr 1e-4 \\
        --epochs 200
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

from mansy_immersivevideostreaming_torch.config import load_config
from mansy_immersivevideostreaming_torch.data.viewport import create_datasets
from mansy_immersivevideostreaming_torch.models import vp_train
from mansy_immersivevideostreaming_torch.models.mtio import ViewportTransformerMTIO
from mansy_immersivevideostreaming_torch.models.regression import linear_regression_sample
from mansy_immersivevideostreaming_torch.parallel import launch
from mansy_immersivevideostreaming_torch.parallel.mesh import Mesh, replicate, shutdown
from mansy_immersivevideostreaming_torch.utils.checkpoint import (
    load_mtio_npz_into, load_train_checkpoint, save_mtio_npz, save_train_checkpoint,
)
from mansy_immersivevideostreaming_torch.utils.device import check_data_parallel, resolve_device
from mansy_immersivevideostreaming_torch.utils.logging import ConsoleLogger
from mansy_immersivevideostreaming_torch.utils.prng import seed_everything
from mansy_immersivevideostreaming_torch.utils.results import Results


def batches(dataset, batch_size: int):
    """The dataset's samples in order, ``batch_size`` at a time (the test
    loop does not shuffle)."""
    n = len(dataset)
    for s in range(0, n, batch_size):
        yield dataset.gather(np.arange(s, min(s + batch_size, n)))


def build_model(args, device) -> ViewportTransformerMTIO:
    """The MTIO model of the flags (JAX ``cli/run_models.py:171-177``):
    ``--bf16`` picks the compute dtype."""
    return ViewportTransformerMTIO(
        in_channel=2, fut_window=args.fut_window, d_model=args.hidden_dim,
        dim_feedforward=args.hidden_dim, num_encoder_layers=args.block_num,
        num_decoder_layers=args.block_num,
        teacher_forcing=getattr(args, "teacher_forcing", False),
        dtype=torch.bfloat16 if getattr(args, "bf16", False) else torch.float32,
        device=device)


def train(args, config, model, opt, state, models_dir: str, file_prefix: str, device,
          mesh: Mesh | None = None):
    """``run_models --train``'s loop (JAX ``cli/run_models.py:60-134``); with
    a sharded ``mesh``, this rank's part of it (see the module docstring)."""
    main = mesh is None or mesh.is_main
    checkpoint_path = os.path.join(models_dir, file_prefix + "_checkpoint.npz")
    best_model_path = os.path.join(models_dir, file_prefix + "_best_model.npz")
    if args.resume:
        assert args.resume_path is not None
        state = load_train_checkpoint(args.resume_path, model)
        print("Resume model for training from:", args.resume_path)

    sets = create_datasets(config, args.train_dataset, args.his_window,
                           args.fut_window, include=("train", "valid"),
                           trim_head=args.trim_head, trim_tail=args.trim_tail,
                           step=args.sample_step, frequency=args.dataset_frequency)
    ds_train, ds_valid = sets["train"], sets["valid"]
    print(f"Training {args.model} on {args.train_dataset} - bs: {args.bs} "
          f"- lr: {args.lr} - seed: {args.seed} - samples: {len(ds_train)}")
    rng = np.random.default_rng(args.seed)
    if mesh is not None and mesh.sharded:
        print(f"Data-parallel over {mesh.world} devices, one rank each ({mesh.backend})")
    # the whole split on the device once; each epoch gathers its batches there
    h, c, f, *_ = ds_train.gather(np.arange(len(ds_train)))
    data = {k: torch.as_tensor(x, device=device)
            for k, x in (("history", h), ("current", c), ("future", f))}
    best_valid_mse, best_epoch = float("inf"), 0
    for epoch in range(args.epochs):
        print(f"Epoch {epoch + 1}/{args.epochs}\n-------------------------------")
        t0 = time.time()
        perm = rng.permutation(len(ds_train))
        state, losses = vp_train.train_epoch(model, opt, state, data, args.bs, perm, args.seed,
                                             mesh)
        losses = losses.cpu().numpy()
        mean_loss = float(np.mean([float(l) for l in losses]))
        print(f"Train: mean train loss: {mean_loss:>9f} "
              f"({losses.shape[0] * args.bs / (time.time() - t0):,.0f} samples/s)")
        if main and epoch % args.epochs_per_valid == 0:
            mses = []
            for h, c, f, *_ in batches(ds_valid, args.bs):
                batch = {k: torch.as_tensor(x, device=device)
                         for k, x in (("history", h), ("current", c), ("future", f))}
                mses.append(float(vp_train.valid_step(model, batch)))
            mse = float(np.mean(mses))
            print(f"Valid: mean square error: {mse:>9f}")
            save_train_checkpoint(checkpoint_path, model, state)
            print("Checkpoint saved at", checkpoint_path)
            if best_valid_mse > mse:
                best_valid_mse = mse
                best_epoch = epoch + 1
                save_mtio_npz(best_model_path, model)
            print(f"Best model (epoch {best_epoch}, loss {best_valid_mse}) "
                  f"saved at", best_model_path)
    return state


def make_sample_fn(args, model):
    """(history, current) tensors -> [B, F, 2] predictions of ``args.model``."""
    if args.model == "regression":
        return lambda h, c: linear_regression_sample(h, c, args.fut_window)
    return lambda h, c: vp_train.sample_step(model, h, c)


def test_split(sample_fn, dataset, batch_size: int, notebook: Results, device) -> int:
    """``run_models --test``'s loop over one split: sample each batch and
    record its metrics.  Returns the number of trajectories."""
    n = 0
    for h, c, f, video, user, ts in batches(dataset, batch_size):
        h, c, f = (torch.as_tensor(x, device=device) for x in (h, c, f))
        notebook.record(sample_fn(h, c), f, video, user, ts)
        n += h.shape[0]
    return n


def test(args, config, models_dir: str, results_dir: str, file_prefix: str):
    dev = resolve_device(args.device)
    model = None
    if args.model != "regression":
        best_model_path = os.path.join(models_dir, file_prefix + "_best_model.npz")
        model = build_model(args, dev)
        load_mtio_npz_into(model, best_model_path)
        print("Load model from", best_model_path)
    sample_fn = make_sample_fn(args, model)

    sets = create_datasets(config, args.test_dataset, args.his_window,
                           args.fut_window, include=("test_seen", "test_unseen"),
                           trim_head=args.trim_head, trim_tail=args.trim_tail,
                           step=args.sample_step, frequency=args.dataset_frequency)
    notebook = Results(args.model, fut_window=args.fut_window,
                       dataset_frequency=args.dataset_frequency,
                       output_dir=results_dir)
    print(f"Testing {args.model} on {args.test_dataset} - seed: {args.seed}")
    for split, label in (("test_seen", "_seen_"), ("test_unseen", "_unseen_")):
        print(f"On {'seen' if 'un' not in label else 'unseen'} viewing patterns.")
        t0 = time.time()
        n = test_split(sample_fn, sets[split], args.bs, notebook, dev)
        print(f"({n / (time.time() - t0):,.0f} trajectories/s)")
        notebook.write(log=True, label=file_prefix + label)
        notebook.reset()


def run(args, config):
    assert args.model in ("regression", "mtio")
    world = check_data_parallel(args)
    if world > 1 and not launch.launched():
        return launch.launch_ranks("run_models", args, config, world)
    # None -> config backfill (reference run_models.py:198-203)
    args.trim_head = config.trim_head if args.trim_head is None else args.trim_head
    args.trim_tail = config.trim_tail if args.trim_tail is None else args.trim_tail
    args.dataset_frequency = (config.frequency if args.dataset_frequency is None
                              else args.dataset_frequency)
    args.sample_step = config.sample_step if args.sample_step is None else args.sample_step
    seed_everything(args.seed)

    models_dir = os.path.join(config.vp_models_dir, args.model,
                              args.train_dataset, f"{args.dataset_frequency}Hz")
    results_dir = os.path.join(config.vp_results_dir, args.model,
                               args.test_dataset, f"{args.dataset_frequency}Hz")
    os.makedirs(models_dir, exist_ok=True)
    os.makedirs(results_dir, exist_ok=True)

    file_prefix = (f"his_{args.his_window}_fut_{args.fut_window}_"
                   f"hid_{args.hidden_dim}_ss_{args.sample_step}_"
                   f"epochs_{args.epochs}_bs_{args.bs}_lr_{args.lr}_seed_{args.seed}")
    main = True
    with contextlib.ExitStack() as stack:
        if args.train:
            mesh = None
            if world > 1:
                mesh = launch.join(args.device)
                main = mesh.is_main
            dev = resolve_device(args.device) if mesh is None else mesh.device
            model = build_model(args, dev)
            model.init_like_flax(torch.Generator(device=dev).manual_seed(args.seed))
            if mesh is not None:
                replicate(mesh, model)
            opt = vp_train.make_optimizer(
                args.lr, 0.01 if args.weight_decay is None else args.weight_decay)
            if main:
                console = stack.enter_context(
                    open(os.path.join(results_dir, file_prefix + "console.log"), "w"))
                stdout = ConsoleLogger(sys.stdout, console)
            else:
                stdout = stack.enter_context(open(os.devnull, "w"))
            stack.enter_context(contextlib.redirect_stdout(stdout))
            train(args, config, model, opt, vp_train.create_train_state(model), models_dir,
                  file_prefix, dev, mesh)
            if mesh is not None:
                shutdown(mesh)
        if args.test and main:
            test(args, config, models_dir, results_dir, file_prefix)


def build_parser():
    parser = argparse.ArgumentParser(
        description="Train/test viewport prediction models (PyTorch + CUDA).")
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--model", type=str, default="mtio")
    parser.add_argument("--hidden-dim", type=int, default=512)
    parser.add_argument("--block-num", type=int, default=2)
    parser.add_argument("--compile", action="store_true",
                        help="accepted for reference-CLI compatibility")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--resume-path", type=str)
    parser.add_argument("--train-dataset", type=str, default="Jin2022")
    parser.add_argument("--test-dataset", type=str, default="Jin2022")
    parser.add_argument("--his-window", type=int, default=5)
    parser.add_argument("--fut-window", type=int, default=15)
    parser.add_argument("--trim-head", type=int)
    parser.add_argument("--trim-tail", type=int)
    parser.add_argument("--dataset-frequency", type=int)
    parser.add_argument("--sample-step", type=int)
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--epochs-per-valid", type=int, default=3)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight-decay", type=float)
    parser.add_argument("--bs", type=int, default=512)
    parser.add_argument("--seed", type=int, default=5)
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 compute dtype (params stay f32; K8's bf16 kernels)")
    parser.add_argument("--teacher-forcing", action="store_true",
                        help="single-pass ground-truth-fed training decode instead of the "
                             "15-step autoregressive one; inference stays autoregressive")
    parser.add_argument("--data-parallel", action="store_true",
                        help="split each batch over all devices, one rank a device (one "
                             "device: as without the flag)")
    parser.add_argument("--config-yml", type=str, default=None)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    config = load_config(args.config_yml)
    if args.model == "regression":
        args.train = False
        print("Detect model: regression. Automatically disable train mode.")
    print(args)
    run(args, config)


if __name__ == "__main__":
    main()
