"""Device selection for the port's entry points.

Entry points default to ``device="cuda"``.  On a machine without a GPU they
raise rather than quietly running on the CPU; the CPU is used only when the
caller asks for it, as the tests do.
"""

from __future__ import annotations

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


def check_data_parallel(cli: str, args) -> None:
    """``--data-parallel`` as the JAX CLIs read it: only in ``--train`` and
    only over more than one device.  On one device the run is the run
    without the flag; over more, it raises ``SystemExit`` until the
    multi-process path is ported (ROADMAP Queue 1 item 14c)."""
    if not (args.train and args.data_parallel):
        return
    span = device_span(args.device)
    if span > 1:
        raise SystemExit(f"{cli}: --train --data-parallel over {span} devices is not ported "
                         "yet (the multi-process path, ROADMAP Queue 1 item 14c); one device "
                         "runs it as without the flag")
