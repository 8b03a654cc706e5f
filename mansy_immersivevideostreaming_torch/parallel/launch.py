"""Ranks of a data-parallel CLI run, one process a device.

JAX runs ``--train --data-parallel`` in one process over every device; the
port runs one rank a device.  A CLI run over more than one device that no
launcher started starts its ranks itself with :func:`launch_ranks`: each
is this module run as a program, which joins the group
(:func:`join`) and runs the CLI's ``run(args, config)``.  A run that
torchrun (or a test) started, with RANK and WORLD_SIZE in its environment,
joins that group instead: at ``MANSY_DIST_INIT`` (a torch init URL,
e.g. ``file:///path/store``) when it is set, else at torchrun's
MASTER_ADDR and MASTER_PORT.

    python -m mansy_immersivevideostreaming_torch.parallel.launch CLI RUN_PICKLE

runs rank RANK of WORLD_SIZE of ``cli.CLI.run`` on the ``(args, config)``
pickled in RUN_PICKLE.
"""

from __future__ import annotations

import argparse
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from mansy_immersivevideostreaming_torch.parallel.mesh import Mesh, init_distributed

INIT_ENV = "MANSY_DIST_INIT"
ROOT = Path(__file__).resolve().parents[2]


def launched() -> bool:
    """A launcher started this process as a rank."""
    return "WORLD_SIZE" in os.environ


def join(device: str) -> Mesh:
    """Join the group this process was launched into (see the module
    docstring)."""
    return init_distributed(os.environ.get(INIT_ENV), device=device)


def rank_env(rank: int, world: int, init: str) -> dict:
    """The environment of rank ``rank`` of ``world`` on this host."""
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), **{INIT_ENV: init})
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")]))
    return env


def launch_ranks(cli: str, args, config, world: int, timeout_s: float | None = None) -> None:
    """Run ``cli``'s ``run(args, config)`` as ``world`` ranks on this host,
    each a process of its own that rendezvous through a file store in a
    temporary directory, and wait for all of them.  A rank that exits
    non-zero, or outlives ``timeout_s``, stops the others and raises."""
    print(f"{cli}: --data-parallel over {world} devices, one rank a device", flush=True)
    with tempfile.TemporaryDirectory(prefix="mansy_ranks_") as tmp:
        run_pickle = os.path.join(tmp, "run.pkl")
        with open(run_pickle, "wb") as f:
            pickle.dump((args, config), f)
        init = Path(tmp, "store").as_uri()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "mansy_immersivevideostreaming_torch.parallel.launch", cli,
             run_pickle],
            env=rank_env(rank, world, init)) for rank in range(world)]
        wait_ranks(procs, timeout_s)


def wait_ranks(procs, timeout_s: float | None = None) -> None:
    """Wait for every rank; the first to fail (or the deadline) stops the
    rest and raises."""
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank {procs.index(failed[0])} exited with "
                                   f"{failed[0].returncode}")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout_s} s")
            time.sleep(0.1)
        codes = [p.returncode for p in procs]
        if any(codes):
            raise RuntimeError(f"ranks exited with {codes}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("cli", help="a module of mansy_immersivevideostreaming_torch.cli")
    parser.add_argument("run_pickle", help="the pickled (args, config) of the run")
    opts = parser.parse_args(argv)
    with open(opts.run_pickle, "rb") as f:
        args, config = pickle.load(f)
    module = importlib.import_module(f"mansy_immersivevideostreaming_torch.cli.{opts.cli}")
    module.run(args, config)


if __name__ == "__main__":
    main()
