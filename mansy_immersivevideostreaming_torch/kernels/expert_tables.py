"""K5: the MPC expert's per-action profiling tables (wrapper, plain version,
launch count).

Replaces the JAX package's ``sim/expert.py:build_expert_tables``
(``:67-110``) with ``ops/allocation.py:allocate_tile_rates``.  The plain
version is ``sim/expert.py:build_expert_tables_plain``.  It runs once a
split, at setup; ``csrc/expert_tables.cu`` runs one warp per (video, user,
chunk) over the actions (see the source for the design).
"""

from __future__ import annotations

import ctypes

import torch

from mansy_immersivevideostreaming_torch.kernels import build
from mansy_immersivevideostreaming_torch.kernels.env_step import NUM_TILES, _codec_tables
from mansy_immersivevideostreaming_torch.sim.expert import (
    ExpertTables, build_expert_tables_plain,
)
from mansy_immersivevideostreaming_torch.sim.tables import SimTables


class _ExpertTablesArgs(ctypes.Structure):
    """Mirror of ``ExpertTablesArgs`` in ``csrc/expert_tables.cu``."""
    _fields_ = ([(f, ctypes.c_void_p) for f in ("sizes", "qualities", "gt", "pred",
                                                "scale_table", "action_rates", "out")]
                + [(f, ctypes.c_int32) for f in ("V", "U", "C", "R", "A")])


def build_expert_tables(tables: SimTables) -> ExpertTables:
    """The ten [V, U, C, A] profiling tables of ``tables``.  CPU tensors take
    :func:`build_expert_tables_plain`; CUDA tensors launch the kernel, whose
    tables are views of one [10, V, U, C, A] buffer."""
    dev = tables.gt.device
    if dev.type == "cpu":
        return build_expert_tables_plain(tables)
    V, U, C, T = tables.gt.shape
    R = tables.sizes.shape[2]
    scale_table, action_rates = _codec_tables(dev)
    A = action_rates.shape[0]
    if T != NUM_TILES or A > 32 or scale_table.shape[0] != R \
            or tables.sizes.shape != (V, C, R, T) or tables.pred.shape != tables.gt.shape:
        raise ValueError(f"expert_tables kernel needs 64 tiles, <= 32 actions and {R} rates "
                         f"in the codec; got sizes {tuple(tables.sizes.shape)}, gt "
                         f"{tuple(tables.gt.shape)}, pred {tuple(tables.pred.shape)}")
    ins = {"sizes": tables.sizes, "qualities": tables.qualities, "gt": tables.gt,
           "pred": tables.pred}
    for name, x in ins.items():
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"expert_tables: {name} must be a contiguous f32 tensor on {dev}")
    out = torch.empty((len(ExpertTables._fields), V, U, C, A), dtype=torch.float32, device=dev)
    args = _ExpertTablesArgs(**{k: x.data_ptr() for k, x in ins.items()},
                             scale_table=scale_table.data_ptr(),
                             action_rates=action_rates.data_ptr(), out=out.data_ptr(),
                             V=V, U=U, C=C, R=R, A=A)
    lib = build.load("expert_tables")
    lib.expert_tables_launch.argtypes = [ctypes.POINTER(_ExpertTablesArgs), ctypes.c_void_p]
    lib.expert_tables_launch.restype = ctypes.c_int
    err = lib.expert_tables_launch(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"expert_tables kernel launch failed with CUDA error {err}")
    build_expert_tables.launches += 1
    return ExpertTables(*out.unbind(0))


build_expert_tables.launches = 0
