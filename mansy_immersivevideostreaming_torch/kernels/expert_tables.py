"""K5: the MPC expert's per-action profiling tables (wrapper, plain version,
launch count).

Replaces the JAX package's ``sim/expert.py:build_expert_tables``
(``:67-110``) with ``ops/allocation.py:allocate_tile_rates``.  The plain
version is ``sim/expert.py:build_expert_tables_plain``.  It runs once a
split, at setup.  ``csrc/expert_tables.cu`` stages a (video, chunk)'s slab
and a group of users' viewport rows in shared memory and runs one thread a
(row, action) over the 64 tiles and both allocations
(:func:`expert_tables_plan`; see the source for the design).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from mansy_immersivevideostreaming_torch.kernels import build
from mansy_immersivevideostreaming_torch.kernels.env_step import NUM_TILES, _codec_tables
from mansy_immersivevideostreaming_torch.sim.expert import (
    ExpertTables, build_expert_tables_plain,
)
from mansy_immersivevideostreaming_torch.sim.tables import SimTables


RATES = 5          # R: a tile's versions, the kernel's slab
MAX_USERS = 8      # users a block at most (the kernel's shared rows)
MAX_WARPS = 4      # warps of (user, action) threads at most (its launch bounds)


class ExpertTablesPlan(NamedTuple):
    """K5's launch: block b takes (v, c) = divmod(b // groups, C) and users
    g * users .. g * users + users - 1 (those below U), g = b % groups;
    thread i of its ``warps`` warps takes user i // A and action i % A, both
    allocations."""
    users: int
    warps: int
    groups: int
    blocks: int


def expert_tables_plan(V: int, U: int, C: int, A: int) -> ExpertTablesPlan:
    """As many users a block as MAX_USERS and MAX_WARPS warps of (user,
    action) threads hold: 8 users in 4 warps at 15 actions, 6480 blocks at
    the train split and 360 (more than the H100's 132 SMs) at the test
    split."""
    users = max(1, min(MAX_USERS, MAX_WARPS * 32 // A, U))
    groups = -(-U // users)
    return ExpertTablesPlan(users, -(-users * A // 32), groups, V * C * groups)


class _ExpertTablesArgs(ctypes.Structure):
    """Mirror of ``ExpertTablesArgs`` in ``csrc/expert_tables.cu``."""
    _fields_ = ([(f, ctypes.c_void_p) for f in ("sizes", "qualities", "gt", "pred",
                                                "scale_table", "action_rates", "out")]
                + [(f, ctypes.c_int32) for f in ("V", "U", "C", "R", "A", "users", "warps",
                                                 "groups", "blocks")])


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
    if T != NUM_TILES or A > 32 or R != RATES or scale_table.shape[0] != R \
            or tables.sizes.shape != (V, C, R, T) or tables.pred.shape != tables.gt.shape:
        raise ValueError(f"expert_tables kernel needs 64 tiles, <= 32 actions and the "
                         f"codec's {RATES} rates; got sizes {tuple(tables.sizes.shape)}, gt "
                         f"{tuple(tables.gt.shape)}, pred {tuple(tables.pred.shape)}")
    ins = {"sizes": tables.sizes, "qualities": tables.qualities, "gt": tables.gt,
           "pred": tables.pred}
    for name, x in ins.items():
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"expert_tables: {name} must be a contiguous f32 tensor on {dev}")
    out = torch.empty((len(ExpertTables._fields), V, U, C, A), dtype=torch.float32, device=dev)
    plan = expert_tables_plan(V, U, C, A)
    args = _ExpertTablesArgs(**{k: x.data_ptr() for k, x in ins.items()},
                             scale_table=scale_table.data_ptr(),
                             action_rates=action_rates.data_ptr(), out=out.data_ptr(),
                             V=V, U=U, C=C, R=R, A=A, **plan._asdict())
    lib = build.load("expert_tables")
    lib.expert_tables_launch.argtypes = [ctypes.POINTER(_ExpertTablesArgs), ctypes.c_void_p]
    lib.expert_tables_launch.restype = ctypes.c_int
    err = lib.expert_tables_launch(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"expert_tables kernel launch failed with CUDA error {err}")
    build_expert_tables.launches += 1
    return ExpertTables(*out.unbind(0))


build_expert_tables.launches = 0
