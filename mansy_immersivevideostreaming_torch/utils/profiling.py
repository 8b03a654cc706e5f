"""Profiling helpers (port of the JAX package's ``utils/profiling.py``; the
reference has only wall-clock prints).

``trace(name)`` labels a block in a ``torch.profiler`` capture;
``profile_to(dir)`` captures one (the card's kernels too, where there is
one) into a Chrome trace file under ``dir``; ``timed(label)`` prints a
block's wall-clock seconds once the work it watches is done.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(name: str):
    with record_function(name):
        yield


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Capture a profile of the block into ``log_dir/trace_<pid>.json``
    (chrome://tracing or Perfetto reads it); with CUDA activity when a card
    is present."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


class _Timed:
    """Handle yielded by :func:`timed`; register outputs with ``watch`` so the
    timer waits for the work that makes them."""

    def __init__(self):
        self._outputs = []
        self.seconds = None

    def watch(self, value):
        self._outputs.append(value)
        return value


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _wait(outputs) -> None:
    """Wait for the devices that hold the watched tensors; with nothing
    watched, for the card (where CUDA is in use)."""
    devices = {t.device for t in _tensors(outputs)}
    if not outputs and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


@contextlib.contextmanager
def timed(label: str, sync: bool = True):
    """Wall-clock timing that waits for the watched work.

    Usage::

        with timed("step") as t:
            out = t.watch(step(params, batch))

    CUDA launches return before the card finishes, so the timer
    synchronises on the devices of every tensor registered with
    ``t.watch``, or on the card when nothing was watched; CPU tensors are
    done when their op returns.  Prints ``[label] x.xxxs``.
    """
    handle = _Timed()
    t0 = time.time()
    yield handle
    if sync:
        _wait(handle._outputs)
    handle.seconds = time.time() - t0
    print(f"[{label}] {handle.seconds:.3f}s", flush=True)
