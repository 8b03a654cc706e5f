"""Device selection for the port's entry points.

Entry points default to ``device="cuda"``.  On a machine without a GPU they
raise rather than quietly running on the CPU; the CPU is used only when the
caller asks for it, as the tests do.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def device_span(device: str | torch.device = "cuda") -> int:
    """How many devices a run on ``device`` would span, the port's answer to
    the JAX CLIs' ``jax.device_count()``: 1 on the CPU, every visible card
    on CUDA."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def check_data_parallel(args) -> int:
    """``--data-parallel`` as the JAX CLIs read it: only in ``--train`` and
    only over more than one device.  Returns the ranks the run spans, one
    process a device: 1 without the flag, in ``--test`` and on one device
    (the run is then the run without the flag); else the WORLD_SIZE a
    launcher (torchrun, ``parallel/launch.py``) gave this process, or, when
    none did, every device of ``--device``, whose ranks the CLI then starts
    itself (``parallel.launch.launch_ranks``)."""
    if not (args.train and args.data_parallel):
        return 1
    if "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return device_span(args.device)
