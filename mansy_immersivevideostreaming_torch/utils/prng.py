"""Seeding helper (port of the JAX package's ``utils/prng.py``; reference
seeds numpy, torch, CUDA and ``random`` at every entry point, e.g.
``viewport_prediction/run_models.py:113-117``).

The JAX module's ``enable_compilation_cache`` (XLA's persistent cache) has
no counterpart here: what the port compiles are its CUDA kernels, and
``kernels/build.py`` keeps them in a build directory named by a hash of
their sources and flags (``library_path``), so a later run reuses them.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int, device: str | torch.device = "cpu") -> torch.Generator:
    """Seed ``random``, numpy's global generator and torch's (every card's
    too), and return a ``torch.Generator`` on ``device`` seeded with
    ``seed``: the run's stream of draws, as JAX's seeded key is."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)
