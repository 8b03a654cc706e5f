"""K7: viewport tile occupancy with the chunk OR and IoU, or with the per-step
metrics (wrappers, plain versions, launch counts).

Replaces what the deleted Pallas kernel ``tile_occupancy_pallas`` computed
and the JAX package leaves to XLA: ``ops/geometry.py:tile_occupancy_from_normalized``
(``:108``) with ``iou_accuracy`` and ``tile_metrics`` (``:130``, ``:140``),
as ``cli/predict.py:chunk_maps`` (``:42-56``) and
``utils/results.py:_metrics_kernel`` (``:31-40``) run them.  Two entry
points share ``csrc/tile_occupancy.cu``:

* :func:`chunk_maps` (``predict``): the OR of the first ``frequency`` steps'
  maps of gt and pred, and their IoU;
* :func:`trajectory_metrics` (``run_models --test``): per step the periodic
  MSE, accuracy (IoU), recall, precision and f1.

On the H100 both are bound by bytes in principle, and at the paths' 512
trajectories by the launch and one chain of dependent loads.  Chunk mode
runs a group of 16 threads a trajectory, one step's map a thread, ORed by
shuffles, the maps stored as whole words (:func:`chunk_plan`); metrics mode
one thread a step.  Each map is a 64-bit mask; the maps are bit-equal to the
plain versions: the pixel truncation is the same f32 product, and the counts
are exact.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from mansy_immersivevideostreaming_torch.kernels import build
from mansy_immersivevideostreaming_torch.ops.geometry import (
    FOV_HEIGHT, FOV_WIDTH, iou_accuracy, periodic_mse, tile_metrics,
    tile_occupancy_from_normalized,
)

# (video_width, video_height, tile_num_width, tile_num_height, fov_width,
# fov_height): the Jin2022 frame, its 8x8 tiling and the reference's FoV, the
# defaults of ops/geometry.py, which both callers use
GEOMETRY = (2560, 1440, 8, 8, FOV_WIDTH, FOV_HEIGHT)
TILES = GEOMETRY[2] * GEOMETRY[3]  # the kernel's 8x8 grid
GROUP = 16           # chunk mode: threads a trajectory, half on gt and half on pred
TRAJECTORIES = 4     # chunk mode: trajectories a block


class ChunkPlan(NamedTuple):
    """K7 chunk mode's launch: ``group`` threads a trajectory,
    ``trajectories`` trajectories a block, ``blocks`` blocks; thread j of
    trajectory b's group maps steps j % (group / 2), + group / 2, ... below
    ``frequency`` of gt (j < group / 2) or pred."""
    group: int
    trajectories: int
    blocks: int


def chunk_plan(B: int) -> ChunkPlan:
    """Blocks of TRAJECTORIES trajectories: 128 blocks of 64 threads at the
    paths' 512 trajectories."""
    return ChunkPlan(GROUP, TRAJECTORIES, -(-B // TRAJECTORIES))


def chunk_maps_plain(gt: torch.Tensor, pred: torch.Tensor, frequency: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: [B, F, 2] gt and pred trajectories -> the OR of
    the first ``frequency`` steps' occupancy maps (u8 [B, 64] each) and
    their IoU (f32 [B])."""
    g = tile_occupancy_from_normalized(gt[:, :frequency]).amax(1)
    p = tile_occupancy_from_normalized(pred[:, :frequency]).amax(1)
    return g, p, iou_accuracy(g, p)


def trajectory_metrics_plain(gt: torch.Tensor, pred: torch.Tensor):
    """Plain PyTorch version: [B, F, 2] gt and pred -> (mse, accuracy,
    recall, precision, f1), each f32 [B, F]."""
    mse = periodic_mse(pred, gt)
    acc, rec, prec, f1 = tile_metrics(tile_occupancy_from_normalized(gt),
                                      tile_occupancy_from_normalized(pred))
    return mse, acc, rec, prec, f1


class _Geometry(ctypes.Structure):
    """Mirror of ``Geometry`` in ``csrc/tile_occupancy.cu``."""
    _fields_ = [(f, ctypes.c_int32) for f in ("width", "height", "fov_w", "fov_h")]


class _ChunkArgs(ctypes.Structure):
    """Mirror of ``ChunkArgs`` in ``csrc/tile_occupancy.cu``."""
    _fields_ = ([(f, ctypes.c_void_p) for f in ("gt", "pred", "g", "p", "iou")]
                + [(f, ctypes.c_int32) for f in ("B", "F", "frequency", "trajectories")]
                + [("geo", _Geometry)])


class _MetricsArgs(ctypes.Structure):
    """Mirror of ``MetricsArgs`` in ``csrc/tile_occupancy.cu``."""
    _fields_ = ([(f, ctypes.c_void_p) for f in ("gt", "pred", "mse", "acc", "rec", "prec",
                                                 "f1")]
                + [(f, ctypes.c_int32) for f in ("B", "F")] + [("geo", _Geometry)])


def _geometry() -> _Geometry:
    width, height, _, _, fov_w, fov_h = GEOMETRY  # the kernel's grid is 8x8
    return _Geometry(width, height, fov_w, fov_h)


def _check(name: str, gt: torch.Tensor, pred: torch.Tensor) -> None:
    for label, t in (("gt", gt), ("pred", pred)):
        if t.device != gt.device or t.dtype != torch.float32 or t.dim() != 3 \
                or t.shape[-1] != 2 or t.shape != gt.shape or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous float32 [B, F, 2] tensor "
                             f"on {gt.device} shaped as gt, got {t.dtype} {tuple(t.shape)}")


def _launch(fn_name: str, args: ctypes.Structure, device: torch.device) -> None:
    lib = build.load("tile_occupancy")
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.POINTER(type(args)), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(ctypes.byref(args), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name[:-len('_launch')]} kernel launch failed with CUDA "
                           f"error {err}")


def chunk_maps(gt: torch.Tensor, pred: torch.Tensor, frequency: int):
    """(g, p, IoU) of the first ``frequency`` steps of [B, F, 2] trajectories.
    CPU tensors take :func:`chunk_maps_plain`; CUDA tensors launch the
    kernel."""
    if gt.device.type == "cpu":
        return chunk_maps_plain(gt, pred, frequency)
    _check("chunk_maps", gt, pred)
    B, F, _ = gt.shape
    if not 1 <= frequency <= F:
        raise ValueError(f"chunk_maps: frequency {frequency} outside [1, {F}]")
    g = torch.empty((B, TILES), dtype=torch.uint8, device=gt.device)
    p = torch.empty_like(g)
    iou = torch.empty(B, dtype=torch.float32, device=gt.device)
    _launch("chunk_maps_launch", _ChunkArgs(
        gt=gt.data_ptr(), pred=pred.data_ptr(), g=g.data_ptr(), p=p.data_ptr(),
        iou=iou.data_ptr(), B=B, F=F, frequency=frequency,
        trajectories=chunk_plan(B).trajectories, geo=_geometry()), gt.device)
    chunk_maps.launches += 1
    return g, p, iou


def trajectory_metrics(gt: torch.Tensor, pred: torch.Tensor):
    """(mse, accuracy, recall, precision, f1), each [B, F], of [B, F, 2]
    trajectories.  CPU tensors take :func:`trajectory_metrics_plain`; CUDA
    tensors launch the kernel."""
    if gt.device.type == "cpu":
        return trajectory_metrics_plain(gt, pred)
    _check("trajectory_metrics", gt, pred)
    B, F, _ = gt.shape
    out = torch.empty((5, B, F), dtype=torch.float32, device=gt.device)
    _launch("trajectory_metrics_launch", _MetricsArgs(
        gt.data_ptr(), pred.data_ptr(), *(o.data_ptr() for o in out), B=B, F=F,
        geo=_geometry()), gt.device)
    trajectory_metrics.launches += 1
    return tuple(out)


chunk_maps.launches = 0
trajectory_metrics.launches = 0
