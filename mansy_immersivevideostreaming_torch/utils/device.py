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
