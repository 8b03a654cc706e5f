"""K4: the MPC expert's sequence search (wrapper, plain version, launch
count).

Replaces the JAX package's ``sim/expert.py:choose_action`` (``:184-294``) in
every mode: the privileged trace walk or a per-lane ``bw_hat``, the
``pred_*`` tables or the accuracy-corrected ones at a per-lane ``acc_hat``
(switched per lane by ``use_corr``), and the optional decision margin.  The
plain version is ``sim/expert.py:choose_action_plain``.  On the H100 the
search is bound by f32 operations (15^h sequences a lane);
``csrc/choose_action.cu`` runs a cluster of 15 CTAs a lane, one a first
action, each walking its sequences as a tree of shared prefixes, and
reduces the 15 results in a fixed order.  See the source for the design.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mansy_immersivevideostreaming_torch.kernels import build
from mansy_immersivevideostreaming_torch.sim.env import EnvState
from mansy_immersivevideostreaming_torch.sim.expert import ExpertTables, choose_action_plain
from mansy_immersivevideostreaming_torch.sim.tables import SimTables

NUM_ACTIONS = 15        # the kernel's action space
MAX_SMEM = 200 * 1024   # dynamic shared memory the kernel may ask for

_TABLE_FIELDS = ("pred_size", "pred_quality", "pred_intra", "dep_quality", "dep_intra",
                 "out_quality", "out_intra")
_SIM_FIELDS = ("end_chunk", "bw", "bw_len", "bw_prefix", "qoe_weights")
_STATE_FIELDS = ("video", "user", "trace", "qoe_id", "next_chunk", "buf", "net_idx",
                 "net_sec", "net_frac", "prev_quality", "has_prev")
_LANE_FIELDS = ("bw_hat", "acc_hat", "use_corr")


class _ChooseActionArgs(ctypes.Structure):
    """Mirror of ``ChooseActionArgs`` in ``csrc/choose_action.cu``."""
    _fields_ = ([(f, ctypes.c_void_p) for f in _TABLE_FIELDS + _SIM_FIELDS + _STATE_FIELDS
                 + _LANE_FIELDS + ("action", "margin")]
                + [(f, ctypes.c_int32) for f in ("n_lanes", "U", "C", "L", "horizon",
                                                 "trace_in_smem")]
                + [(f, ctypes.c_float) for f in ("chunk_length", "max_rate")])


def choose_action(tables: SimTables, etables: ExpertTables, state: EnvState, horizon: int,
                  bw_hat: Optional[torch.Tensor] = None,
                  acc_hat: Optional[torch.Tensor] = None,
                  use_corr: Optional[torch.Tensor] = None,
                  return_margin: bool = False):
    """Best first action of every lane, i32 [N] (and the margin [N] with
    ``return_margin``); see :func:`choose_action_plain` for the modes.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    dev = state.buf.device
    if dev.type == "cpu":
        return choose_action_plain(tables, etables, state, horizon, bw_hat, acc_hat, use_corr,
                                   return_margin)
    if use_corr is not None and acc_hat is None:
        raise ValueError("choose_action: use_corr needs acc_hat")
    N = state.buf.shape[0]
    V, U, C, A = etables.pred_size.shape
    if A != NUM_ACTIONS or tables.action_space != A or not 1 <= horizon <= 7:
        raise ValueError(f"choose_action kernel needs {NUM_ACTIONS} actions and a horizon "
                         f"of 1 to 7; got {A} actions, horizon {horizon}")
    L = tables.bw.shape[1]
    f32, i32 = torch.float32, torch.int32
    used = _TABLE_FIELDS[:3] if acc_hat is None else _TABLE_FIELDS
    # name -> (tensor, dtype, shape or None for a table)
    srcs = {**{f: (getattr(etables, f), f32, (V, U, C, A)) for f in used},
            "end_chunk": (tables.end_chunk, i32, (V, U)), "bw": (tables.bw, f32, None),
            "bw_len": (tables.bw_len, i32, None), "bw_prefix": (tables.bw_prefix, f32, None),
            "qoe_weights": (tables.qoe_weights, f32, None),
            **{f: (getattr(state, f), i32, (N,)) for f in ("video", "user", "trace",
                                                            "qoe_id", "next_chunk")},
            "buf": (state.buf, f32, (N,)), "net_idx": (state.net.idx, i32, (N,)),
            "net_sec": (state.net.sec, i32, (N,)), "net_frac": (state.net.frac, f32, (N,)),
            "prev_quality": (state.qoe.prev_quality, f32, (N,)),
            "has_prev": (state.qoe.has_prev, torch.bool, (N,))}
    for name, x, dtype in (("bw_hat", bw_hat, f32), ("acc_hat", acc_hat, f32),
                           ("use_corr", use_corr, torch.bool)):
        if x is not None:
            srcs[name] = (x, dtype, (N,))
    for name, (x, dtype, shape) in srcs.items():
        if x.device != dev or x.dtype != dtype or not x.is_contiguous() \
                or shape not in (None, tuple(x.shape)):
            raise ValueError(f"choose_action: {name} must be a contiguous {dtype} tensor of "
                             f"shape {shape or tuple(x.shape)} on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    action = torch.empty(N, dtype=i32, device=dev)
    margin = torch.empty(N, dtype=f32, device=dev) if return_margin else None
    table_bytes = 4 * horizon * A * 4
    trace_bytes = (2 * L + 1) * 4
    trace_in_smem = bw_hat is None and table_bytes + trace_bytes <= MAX_SMEM
    smem = table_bytes + (trace_bytes if trace_in_smem else 0)
    ptrs = {name: x.data_ptr() for name, (x, _, _) in srcs.items()}
    args = _ChooseActionArgs(
        **ptrs, action=action.data_ptr(), margin=0 if margin is None else margin.data_ptr(),
        n_lanes=N, U=U, C=C, L=L, horizon=horizon, trace_in_smem=int(trace_in_smem),
        chunk_length=float(tables.chunk_length), max_rate=float(tables.max_rate))
    lib = build.load("choose_action")
    lib.choose_action_launch.argtypes = [ctypes.POINTER(_ChooseActionArgs), ctypes.c_int,
                                         ctypes.c_void_p]
    lib.choose_action_launch.restype = ctypes.c_int
    err = lib.choose_action_launch(ctypes.byref(args), smem,
                                   torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"choose_action kernel launch failed with CUDA error {err}")
    choose_action.launches += 1
    return action if margin is None else (action, margin)


choose_action.launches = 0
