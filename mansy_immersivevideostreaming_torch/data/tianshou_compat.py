"""Loader for the reference's pickled tianshou expert demonstrations.

The port's own copy of ``mansy_immersivevideostreaming_tpu/data/
tianshou_compat.py`` (numpy and pickle only), so the port imports nothing of
the JAX package.  It reads the demonstration pickles that either package's
``run_expert --train`` writes and the reference's tianshou pickles.

The reference saves expert demos as ``{(video, user, trace, qoe_tuple):
tianshou.data.ReplayBuffer}`` pickles (``bitrate_selection/run_expert.py:35-39``)
and consumes them for behavior cloning (``run_mansy.py:265-274``).  tianshou is
not a dependency of this framework, so unpickling those files would normally
fail with ModuleNotFoundError.  :func:`load_demonstrations` understands BOTH
formats — this framework's native numpy pytrees and the reference's tianshou
pickles — by intercepting ``tianshou.*`` classes at unpickle time with inert
stand-ins (tianshou ``Batch.__setstate__`` re-inits from a plain dict of
arrays and ``ReplayBuffer.__setstate__`` updates ``__dict__``, so no real
tianshou code is needed to recover the stored arrays).

Field-shape note: the reference env stores history rows as ``[1, past_k]``
(``envs/mansy_env.py:130-150``) where this framework's ``observe_mansy`` uses
flat ``[past_k]`` — extracted observations are reshaped to this framework's
convention so BC (``rl/bc.py``) can consume either source unchanged.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Tuple

import numpy as np

# target per-step shapes of observe_mansy (sim/env.py:162-180)
_MANSY_OBS_SHAPES: Dict[str, Tuple[int, ...]] = {
    "throughput": (8,),
    "next_chunk_size": (5, 64),
    "next_chunk_quality": (5, 64),
    "pred_viewport": (64,),
    "rates_inside": (8,),
    "rates_outside": (8,),
    "viewport_acc": (8,),
    "buffer": (1,),
    "qoe_weight": (3,),
    "action_one_hot": (15,),
    "past_viewport_qualities": (8,),
    "past_quality_variances": (8,),
    "past_rebuffering": (8,),
}


class _StubBatch:
    """Stand-in for ``tianshou.data.Batch``: holds the unpickled state dict."""

    def __setstate__(self, state):
        # tianshou Batch.__setstate__ calls __init__(**state) on a plain dict
        # of (possibly nested-dict) contents; we just keep the dict.
        self.__dict__["_store"] = dict(state)

    def asdict(self) -> Dict[str, Any]:
        return self._store

    def __getattr__(self, k):
        try:
            return self.__dict__["_store"][k]
        except KeyError as e:
            raise AttributeError(k) from e


class _StubObject:
    """Stand-in for any other tianshou class (ReplayBuffer et al.)."""

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


# Non-tianshou globals a demo pickle legitimately needs: numpy array
# reconstruction plus the builtin containers pickle emits for dict/tuple keys.
# Anything else (os.system, subprocess, ...) is refused — these files come
# from the upstream repo and are untrusted input.
_SAFE_GLOBALS = {
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    # protocol-5 array pickles reconstruct via _frombuffer (numpy emits these
    # for pickle.HIGHEST_PROTOCOL dumps; reference demos use protocol <= 4)
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("collections", "OrderedDict"),
    ("builtins", "dict"),
    ("builtins", "list"),
    ("builtins", "tuple"),
    ("builtins", "set"),
    ("builtins", "frozenset"),
    ("builtins", "bytearray"),
}


class _TianshouUnpickler(pickle.Unpickler):
    """Unpickler that replaces every ``tianshou.*`` class with a stub and
    allows only numpy/builtin-container globals otherwise (the pickles are
    untrusted upstream content — an unrestricted ``find_class`` would execute
    arbitrary globals such as ``os.system``)."""

    def find_class(self, module, name):
        if module.split(".")[0] == "tianshou":
            return _StubBatch if name == "Batch" else _StubObject
        if (module, name) in _SAFE_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing to unpickle global {module}.{name} from an untrusted "
            "demonstrations file")


def _as_plain(value):
    """Recursively turn stub Batches into plain dicts."""
    if isinstance(value, _StubBatch):
        value = value.asdict()
    if isinstance(value, dict):
        return {k: _as_plain(v) for k, v in value.items()}
    return value


def _reshape_obs(obs: Dict[str, np.ndarray], length: int) -> Dict[str, np.ndarray]:
    out = {}
    for field, shape in _MANSY_OBS_SHAPES.items():
        if field not in obs:
            raise KeyError(f"reference demo is missing obs field {field!r}")
        arr = np.asarray(obs[field], dtype=np.float32)[:length]
        out[field] = arr.reshape((length,) + shape)
    return out


def _from_replay_buffer(buf: _StubObject) -> Dict[str, np.ndarray]:
    """Extract {'obs', 'act'} from a stubbed tianshou ReplayBuffer.

    tianshou 0.4.8 ``ReplayBuffer`` pickles its ``__dict__`` (buffer/base.py
    defines ``__getstate__``/``__setstate__`` around it), which carries the
    ring storage in ``_meta`` (a Batch of obs/act/rew/done/...) and the fill
    level in ``_size``.
    """
    d = buf.__dict__
    meta = _as_plain(d["_meta"])
    size = int(d.get("_size", d.get("maxsize", 0)))
    obs = _as_plain(meta["obs"])
    if not isinstance(obs, dict):
        raise TypeError("expected dict observations in reference demo")
    act = np.asarray(meta["act"])[:size].astype(np.int32)
    return {"obs": _reshape_obs(obs, size), "act": act}


def load_demonstrations(path: str) -> Dict[Any, Dict[str, Any]]:
    """Load expert demonstrations in either native or reference format.

    Returns ``{(video, user, trace, qoe_tuple): {"obs": {field: [T, ...]},
    "act": [T]}}`` regardless of which stack produced the file.
    """
    with open(path, "rb") as f:
        raw = _TianshouUnpickler(f).load()
    if not isinstance(raw, dict):
        raise TypeError(f"unexpected demonstrations payload in {path!r}")
    out = {}
    for key, value in raw.items():
        if isinstance(value, dict) and "obs" in value and "act" in value:
            out[key] = value  # native format (cli/run_expert.py)
        else:
            out[key] = _from_replay_buffer(value)
    return out
