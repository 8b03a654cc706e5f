"""Entry points of the port: a compile check of the MTIO serving step and a
multi-process dry run (the counterparts of the JAX package's root
``__graft_entry__.py``).

* :func:`entry` returns the MTIO ``sample`` step (d 128, his 5, fut 15)
  with example inputs of a batch of 8, on the card unless asked otherwise;
* :func:`dryrun_multichip` runs ``parallel/dryrun.py`` in this process,
  then in two processes that form a group through
  ``parallel.mesh.init_distributed`` (a file store in a temporary
  directory).

    python -m mansy_immersivevideostreaming_torch.entry [--device cpu]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from mansy_immersivevideostreaming_torch.models.mtio import ViewportTransformerMTIO
from mansy_immersivevideostreaming_torch.parallel.dryrun import run_dryrun
from mansy_immersivevideostreaming_torch.parallel.launch import rank_env, wait_ranks
from mansy_immersivevideostreaming_torch.parallel.mesh import make_mesh
from mansy_immersivevideostreaming_torch.utils.device import resolve_device

DRYRUN_TIMEOUT_S = 900


def entry(device: str = "cuda"):
    """(fn, example_args): ``fn(history, current)`` is the autoregressive
    ``sample`` of the MTIO model at d 128 (ff 128, fut 15) from Flax's
    initialisers (seed 0); the examples are zeros [8, 5, 2] and [8, 1, 2]."""
    dev = resolve_device(device)
    model = ViewportTransformerMTIO(d_model=128, dim_feedforward=128, fut_window=15, device=dev)
    model.init_like_flax(torch.Generator(device=dev).manual_seed(0))
    example_args = (torch.zeros((8, 5, 2), device=dev), torch.zeros((8, 1, 2), device=dev))
    return model.sample, example_args


def dryrun_multichip(n_devices: int = 2, device: str = "cuda", hidden_dim: int = 32,
                     timeout_s: float = DRYRUN_TIMEOUT_S) -> None:
    """The dry run on data for ``n_devices`` devices in this process, then
    split over two processes (Gloo where they share a card or run on the
    CPU, NCCL where each has a card); raises if a rank fails."""
    run_dryrun(n_devices, make_mesh(device), hidden_dim)
    with tempfile.TemporaryDirectory(prefix="mansy_dryrun_") as tmp:
        init = Path(tmp, "store").as_uri()
        cmd = [sys.executable, "-m", "mansy_immersivevideostreaming_torch.parallel.dryrun",
               "--n-devices", str(n_devices), "--coordinator", init, "--num-processes", "2",
               "--hidden-dim", str(hidden_dim)] + (["--force-cpu"] if device == "cpu" else [])
        procs = [subprocess.Popen(cmd + ["--process-id", str(rank)],
                                  env=rank_env(rank, 2, init)) for rank in range(2)]
        wait_ranks(procs, timeout_s)
    print(f"[dryrun] multi-process OK: 2 processes over {n_devices} devices' data", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--hidden-dim", type=int, default=32,
                        help="the dry run's policy width (JAX's dry run: 32)")
    args = parser.parse_args(argv)
    dryrun_multichip(2, args.device, args.hidden_dim)
    fn, example_args = entry(args.device)
    print("entry OK:", tuple(fn(*example_args).shape), flush=True)


if __name__ == "__main__":
    main()
