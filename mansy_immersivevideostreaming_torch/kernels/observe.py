"""K2: observation gather into one [N, F] buffer (wrappers, plain versions,
launch counts), in three modes, and the derived action values of packed
rows.

Replaces the JAX package's ``sim/env.py:observe_mansy`` (``:262-286``) with
``exact_action_values`` (``:220-259``) when the tables carry action values
(:func:`observe_mansy_pack`), and in simple mode its ``observe_simple``
(``:289-300``, :func:`observe_simple_pack`): the simple_rl observation,
[N, 395] in ``SimpleActorCritic``'s concat order (``abr_nets.py:214-220``),
which K3 reads as is through :func:`simple_layout`'s offsets.
The buffer's first :func:`feature_width` columns are exactly what
``MansyFeatureNet`` reads, in its concat order (``abr_nets.py:124-141``), so
the actor-critic kernel reads it as is; the fields the net does not read
follow.  :func:`unpack_obs` gives back the 13- or 14-field dict.

A policy that reads action values on tables without them reads the derived
ones, ``models/abr_nets.py:causal_action_values`` (``:29-92``), which the
JAX net computes from the observation (``_action_value_features``,
``:95-102``): :func:`observe_mansy_pack`'s derived mode writes them into the
row where the exact field goes, and :func:`derive_action_values` (the row
mode) fills them in rows already packed, such as demonstrations recorded
without the field.  :func:`causal_action_values` is the plain version of
both.

On the H100 the pass is bound by device-memory bytes (a gather plus
elementwise scaling); ``csrc/observe.cu`` builds each lane's row in shared
memory with a group of threads (one warp, or four at up to 1024 lanes), its
loads in two levels and its shared values once, and stores a block's tile of
rows with 16-byte stores where it can (:func:`observe_plan`).  The derived
values' sums over tiles are two warp reduce-scatters of every action's
sums, each value in ``warp_sum``'s tree, so their bits are those of one
warp sum a value.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from mansy_immersivevideostreaming_torch.kernels import build, count_launch
from mansy_immersivevideostreaming_torch.ops.allocation import (
    ACTION_TO_RATES, allocate_tile_rates, scale_rate_table,
)
from mansy_immersivevideostreaming_torch.sim.env import (
    EnvState, check_action_value_tables, observe_mansy, observe_simple,
)
from mansy_immersivevideostreaming_torch.sim.tables import SimTables

# (field, shape) in buffer order, with K (history), R (rates), T (tiles) and
# A (actions) as symbols.  The first ten are the feature net's inputs; with
# action-value tables attached, ``action_values`` follows them as the
# eleventh (the net's action-value branch).
_LAYOUT = (("throughput", ("K",)), ("next_chunk_size", ("R", "T")),
           ("next_chunk_quality", ("R", "T")), ("pred_viewport", ("T",)),
           ("viewport_acc", ("K",)), ("past_viewport_qualities", ("K",)),
           ("past_quality_variances", ("K",)), ("past_rebuffering", ("K",)),
           ("buffer", (1,)), ("qoe_weight", (3,)),
           ("rates_inside", ("K",)), ("rates_outside", ("K",)),
           ("action_one_hot", ("A",)))
NET_FIELDS = 10  # fields MansyFeatureNet reads without action values
# simple mode: SimpleActorCritic's five branches, in its concat order
_SIMPLE_LAYOUT = (("throughput", ("K",)), ("chunk_sizes", ("R", "T")), ("rebuffer", (1,)),
                  ("last_bitrates", (2,)), ("pred_viewport", ("T",)))
AV_FIELD = ("action_values", ("A+1",))
LANES = 4            # lanes a block: a tile of 4 rows of f32 is a multiple of 16 bytes
WIDE_GROUP = 32      # threads a lane where the blocks fill the card
NARROW_GROUP = 128   # threads a lane at up to NARROW_LANES lanes
NARROW_LANES = 1024  # 256 blocks: at most two a streaming multiprocessor of the H100
MAX_HISTORY = 32     # K: one history entry a thread of the lane's first warp
MAX_ACTIONS = 32     # A: one action a thread of the lane's first warp
MAX_TILES = 64       # T: the viewport row in one pass of the group
# the derived action values: the JAX function's constants (abr_nets.py:29-31)
# and its allocation's defaults (5 rates, 8 x 8 tiles), one value an action
# of ACTION_TO_RATES
SIZE_OVER_THROUGHPUT = 0.1
BUFFER_SCALE = 5.0
DERIVED_RATES, DERIVED_TILES = 5, 64


class ObservePlan(NamedTuple):
    """K2's launch: ``lanes`` lanes a block of ``lanes * threads`` threads,
    ``blocks`` blocks; block b takes lanes b * lanes to b * lanes + lanes - 1
    (those below N), threads l * threads to l * threads + threads - 1 of it
    lane b * lanes + l."""
    lanes: int
    threads: int
    blocks: int


def observe_plan(n_lanes: int) -> ObservePlan:
    """Blocks of LANES lanes.  Where the blocks fill the card, one warp a
    lane (2048 blocks of 128 threads at collect's 8192 lanes); at up to
    NARROW_LANES lanes, too few blocks for that, four warps a lane, the
    first on the lane's scalars and action values, the others on its slab
    and viewport row (128 blocks of 512 threads at serve's 512 lanes)."""
    group = NARROW_GROUP if n_lanes <= NARROW_LANES else WIDE_GROUP
    return ObservePlan(LANES, group, -(-n_lanes // LANES))


def obs_layout(K: int, R: int, T: int, A: int,
               av: bool = False) -> List[Tuple[str, int, Tuple[int, ...]]]:
    """[(field, column offset, shape)] of the packed observation; ``av``:
    the tables carry action values (the 14-field observation)."""
    dims = {"K": K, "R": R, "T": T, "A": A, "A+1": A + 1}
    fields = _LAYOUT[:NET_FIELDS] + ((AV_FIELD,) if av else ()) + _LAYOUT[NET_FIELDS:]
    out, off = [], 0
    for name, sym in fields:
        shape = tuple(dims.get(s, s) for s in sym)
        out.append((name, off, shape))
        off += int(torch.Size(shape).numel())
    return out


def obs_dims(tables: SimTables) -> Tuple[int, int, int, int, bool]:
    """(K, R, T, A, av) of the packed observation of ``tables``."""
    return (tables.past_k, tables.sizes.shape[2], tables.sizes.shape[3],
            tables.action_space, tables.av_quality is not None)


def obs_width(K: int, R: int, T: int, A: int, av: bool = False) -> int:
    name, off, shape = obs_layout(K, R, T, A, av)[-1]
    return off + int(torch.Size(shape).numel())


def feature_width(K: int, R: int, T: int, A: int, av: bool = False) -> int:
    """Columns the feature net reads (748 at K=8, R=5, T=64; 764 with the
    action values)."""
    return obs_layout(K, R, T, A, av)[NET_FIELDS + av][1]


def obs_columns(K: int, R: int, T: int, A: int, av: bool = False) -> Dict[str, slice]:
    """Each field's columns in the packed observation."""
    return {name: slice(off, off + int(torch.Size(shape).numel()))
            for name, off, shape in obs_layout(K, R, T, A, av)}


def simple_layout(K: int, R: int, T: int) -> List[Tuple[str, int, Tuple[int, ...]]]:
    """[(field, column offset, shape)] of the packed simple_rl observation:
    offsets 0, 8, 328, 329, 331 and width 395 at K=8, R=5, T=64."""
    dims = {"K": K, "R": R, "T": T}
    out, off = [], 0
    for name, sym in _SIMPLE_LAYOUT:
        shape = tuple(dims.get(s, s) for s in sym)
        out.append((name, off, shape))
        off += int(torch.Size(shape).numel())
    return out


def simple_width(K: int, R: int, T: int) -> int:
    name, off, shape = simple_layout(K, R, T)[-1]
    return off + int(torch.Size(shape).numel())


def pack_simple_obs(obs, device: str | torch.device = "cpu") -> torch.Tensor:
    """The 5-field simple_rl observation dict -> the packed [n, 395] buffer."""
    K = obs["throughput"].shape[-1]
    R, T = obs["chunk_sizes"].shape[-2:]
    n = int(torch.Size(obs["throughput"].shape[:-1]).numel())
    cols = [torch.as_tensor(obs[name], dtype=torch.float32).reshape(n, -1)
            for name, _, _ in simple_layout(K, R, T)]
    return torch.cat(cols, dim=1).to(device)


def unpack_obs(buf: torch.Tensor, K: int, R: int, T: int, A: int,
               av: bool = False) -> Dict[str, torch.Tensor]:
    """[..., F] packed buffer -> the 13- or 14-field observation dict (views)."""
    lead = buf.shape[:-1]
    return {name: buf[..., off:off + int(torch.Size(shape).numel())].reshape(lead + shape)
            for name, off, shape in obs_layout(K, R, T, A, av)}


def pack_obs(obs, device: str | torch.device = "cpu",
             action_values: bool = False) -> torch.Tensor:
    """The 13- or 14-field observation dict (arrays or tensors of [..., field
    shape]) -> the packed [n, F] buffer on ``device``, :func:`unpack_obs`'s
    inverse.  The dims come from the fields' shapes.  With ``action_values``
    the rows carry the action-value columns even where ``obs`` has no such
    field: they are then derived from the rows' own fields
    (:func:`derive_action_values`), as the JAX net derives them."""
    return _pack(obs, device, action_values, derive_action_values)


def _pack(obs, device, action_values: bool, derive) -> torch.Tensor:
    """:func:`pack_obs` with ``derive`` for the derived values."""
    K = obs["throughput"].shape[-1]
    R, T = obs["next_chunk_size"].shape[-2:]
    A = obs["action_one_hot"].shape[-1]
    exact = "action_values" in obs
    layout = obs_layout(K, R, T, A, exact or action_values)
    n = int(torch.Size(obs["throughput"].shape[:-1]).numel())
    cols = [torch.as_tensor(obs[name], dtype=torch.float32).reshape(n, -1)
            for name, _, _ in layout if name in obs]
    if len(cols) < len(layout):  # the action-value columns, to be derived
        cols.insert(NET_FIELDS, cols[0].new_zeros((n, A + 1)))
    x = torch.cat(cols, dim=1).to(device)
    if action_values and not exact:
        derive(x, K, R, T, A)
    return x


def causal_action_values(obs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[..., 16] derived causal-MPC features of the 13 observation fields:
    one-step QoE estimates of the 15 actions, then ``bw_hat``.  The port of
    JAX ``models/abr_nets.py:causal_action_values`` (``:29-92``), in its
    operations, clamps and constants: ``bw_hat`` the harmonic mean of the
    non-zero throughput history (0.5 while empty); per action the pyramid
    allocation of the predicted viewport at the default rates and tiling,
    the download time ``SIZE_OVER_THROUGHPUT * size / bw_hat`` of the
    normalized slab, the rebuffer beyond ``buffer * BUFFER_SCALE``, the
    viewport-weighted quality and its mean absolute deviation, and |quality
    - the last viewport quality| after a first action; weighted by the
    normalized preference."""
    thpt = obs["throughput"]
    nz = thpt > 0
    n = nz.to(torch.float32).sum(-1)
    inv = torch.where(nz, 1.0 / torch.clamp(thpt, min=1e-12), torch.zeros_like(thpt)).sum(-1)
    bw_hat = torch.where(n > 0, n / torch.clamp(inv, min=1e-12), torch.full_like(n, 0.5))
    sizes = obs["next_chunk_size"]                 # [..., R, T], /max_size
    quals = obs["next_chunk_quality"]              # [..., R, T], /max_rate
    vp = obs["pred_viewport"].to(torch.float32)    # [..., T]
    buf = obs["buffer"][..., 0] * BUFFER_SCALE     # seconds
    prev_q = obs["past_viewport_qualities"][..., 0]
    has_prev = obs["action_one_hot"].sum(-1) > 0
    w = obs["qoe_weight"]                          # [..., 3] normalized
    vp_sum = torch.clamp(vp.sum(-1), min=1e-6)
    rates = torch.as_tensor(ACTION_TO_RATES, dtype=torch.int32, device=vp.device)
    lead, A = vp.shape[:-1], rates.shape[0]
    # every action's tile versions at once: [..., A, T]
    versions, _ = allocate_tile_rates(rates[:, 0].expand(*lead, A), rates[:, 1].expand(*lead, A),
                                      vp[..., None, :].expand(*lead, A, vp.shape[-1]))
    onehot = torch.nn.functional.one_hot(versions.long(), sizes.shape[-2]).to(torch.float32)
    onehot = onehot.transpose(-1, -2)              # [..., A, R, T]
    size = (sizes[..., None, :, :] * onehot).sum((-2, -1))
    q_tile = (quals[..., None, :, :] * onehot).sum(-2)                  # [..., A, T]
    qual = (vp[..., None, :] * q_tile).sum(-1) / vp_sum[..., None]
    intra = (vp[..., None, :] * (q_tile - qual[..., None]).abs()).sum(-1) / vp_sum[..., None]
    dt = SIZE_OVER_THROUGHPUT * size / torch.clamp(bw_hat, min=1e-6)[..., None]
    rebuf = torch.clamp(dt - buf[..., None], min=0.0)
    inter = torch.where(has_prev[..., None], (qual - prev_q[..., None]).abs(),
                        torch.zeros_like(qual))
    av = w[..., 0:1] * qual - w[..., 1:2] * rebuf - w[..., 2:3] * (intra + inter)
    return torch.cat([av, bw_hat[..., None]], dim=-1)


def derive_action_values_plain(rows: torch.Tensor, K: int, R: int, T: int,
                               A: int) -> torch.Tensor:
    """Plain PyTorch version of the row mode: :func:`causal_action_values`
    of packed rows [N, F] (``obs_layout(K, R, T, A, av=True)``) into their
    action-value columns, in place.  Returns ``rows``."""
    col = obs_columns(K, R, T, A, True)["action_values"]
    rows[:, col] = causal_action_values(unpack_obs(rows, K, R, T, A, True))
    return rows


_AV_FIELDS = ("av_quality", "av_intra", "av_size", "av_out_quality", "av_out_intra")
_PTR_FIELDS = ("sizes", "qualities", "pred", "qoe_weights") + _AV_FIELDS + (
    "video", "user", "next_chunk", "qoe_id", "buf", "prev_quality", "has_prev",
    "past_throughput", "past_acc", "past_vq", "past_var", "past_rebuf", "past_rate_in",
    "past_rate_out", "last_action_one_hot")


def observe_mansy_pack_plain(tables: SimTables, state: EnvState,
                             out: torch.Tensor | None = None,
                             action_values: bool = False) -> torch.Tensor:
    """Plain PyTorch version: :func:`observe_mansy`'s fields, packed; with
    ``action_values`` on tables without them, the derived values in their
    columns (:func:`derive_action_values_plain`)."""
    cols = _pack(observe_mansy(tables, state), state.buf.device, action_values,
                 derive_action_values_plain)
    if out is None:
        return cols
    out.copy_(cols)
    return out


def observe_simple_pack_plain(tables: SimTables, state: EnvState,
                              out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of simple mode: :func:`observe_simple`'s
    fields, packed."""
    cols = pack_simple_obs(observe_simple(tables, state), state.buf.device)
    if out is None:
        return cols
    out.copy_(cols)
    return out


class _ObserveArgs(ctypes.Structure):
    """Mirror of ``ObserveArgs`` in ``csrc/observe.cu`` (same field order)."""
    _fields_ = ([(f, ctypes.c_void_p) for f in _PTR_FIELDS + ("out",)]
                + [(f, ctypes.c_int32) for f in ("n_lanes", "U", "C", "RT", "T", "K", "A", "F",
                                                 "startup_download", "lanes", "group")]
                + [("out_stride", ctypes.c_int64)]
                + [(f, ctypes.c_float) for f in ("max_size", "max_rate", "max_throughput")]
                + [("last_rebuffer", ctypes.c_void_p), ("mode", ctypes.c_int32),
                   ("av_versions", ctypes.c_void_p)])


class _DeriveArgs(ctypes.Structure):
    """Mirror of ``DeriveArgs`` in ``csrc/observe.cu`` (same field order)."""
    _fields_ = ([("rows", ctypes.c_void_p), ("av_versions", ctypes.c_void_p),
                 ("stride", ctypes.c_int64)]
                + [(f, ctypes.c_int32) for f in ("n_rows", "K", "RT", "A", "F", "lanes", "group")])


MODES = {"gather": 0, "simple": 1, "derived": 2}  # ObserveArgs::mode


@functools.lru_cache(maxsize=None)
def _version_table(device: torch.device) -> torch.Tensor:
    """i32 [A, 5] on ``device``: the rate version of a tile of scale s under
    action a (scale 0, inside the viewport: the action's inside rate; else
    ``scale_rate_table`` at its outside rate), the lookup of
    ``allocate_tile_rates`` at the derived values' default rates and tiling.
    Each block of the derived and row modes stages it in shared memory."""
    table = scale_rate_table()
    versions = np.concatenate([ACTION_TO_RATES[:, :1], table[ACTION_TO_RATES[:, 1], 1:]], 1)
    return torch.as_tensor(versions.astype(np.int32), device=device)


def _check_derived_dims(name: str, K: int, R: int, T: int, A: int) -> None:
    if (R, T, A) != (DERIVED_RATES, DERIVED_TILES, ACTION_TO_RATES.shape[0]) or K > MAX_HISTORY:
        raise ValueError(f"{name}: the derived action values take R = {DERIVED_RATES}, "
                         f"T = {DERIVED_TILES}, A = {ACTION_TO_RATES.shape[0]} and K <= "
                         f"{MAX_HISTORY}; got K={K}, R={R}, T={T}, A={A}")


def _launch(name: str, tables: SimTables, state: EnvState, out: torch.Tensor | None,
            mode: str) -> torch.Tensor:
    """One launch of K2 in ``mode`` (``MODES``); ``name`` is the wrapper's,
    for the errors.  Returns the [N, F] output."""
    simple = mode == "simple"
    dev = state.buf.device
    if not simple:
        check_action_value_tables(tables)
    K, R, T, A, av = obs_dims(tables)
    if K > MAX_HISTORY or A > MAX_ACTIONS or T > MAX_TILES:
        raise ValueError(f"{name} kernel takes K <= {MAX_HISTORY}, A <= {MAX_ACTIONS} and "
                         f"T <= {MAX_TILES}; got K={K}, A={A}, T={T}")
    if mode == "derived":
        _check_derived_dims(name, K, R, T, A)
    N = state.buf.shape[0]
    Fw = simple_width(K, R, T) if simple else obs_width(K, R, T, A, av or mode == "derived")
    if out is None:
        out = torch.empty((N, Fw), dtype=torch.float32, device=dev)
    if out.shape != (N, Fw) or out.dtype != torch.float32 or out.stride(1) != 1 \
            or out.device != dev:
        raise ValueError(f"{name}: out must be f32 [{N}, {Fw}] with contiguous rows on {dev}")
    f32, i32 = torch.float32, torch.int32
    # name -> (tensor or None, dtype, shape or None for a table)
    srcs = {"sizes": (tables.sizes, f32, None), "pred": (tables.pred, f32, None),
            "video": (state.video, i32, (N,)), "user": (state.user, i32, (N,)),
            "next_chunk": (state.next_chunk, i32, (N,)),
            **{name: (getattr(state, name), f32, (N, K)) for name in (
                "past_throughput", "past_rate_in", "past_rate_out")}}
    if simple:
        srcs["last_rebuffer"] = (state.last_rebuffer, f32, (N,))
    else:
        srcs.update({
            "qualities": (tables.qualities, f32, None),
            "qoe_weights": (tables.qoe_weights, f32, None),
            **{name: (getattr(tables, name), f32, None) for name in _AV_FIELDS},
            "qoe_id": (state.qoe_id, i32, (N,)), "buf": (state.buf, f32, (N,)),
            "prev_quality": (state.qoe.prev_quality, f32, (N,)),
            "has_prev": (state.qoe.has_prev, torch.bool, (N,)),
            **{name: (getattr(state, name), f32, (N, K)) for name in (
                "past_acc", "past_vq", "past_var", "past_rebuf")},
            "last_action_one_hot": (state.last_action_one_hot, f32, (N, A))})
    for field, (x, dtype, shape) in srcs.items():
        if x is None and field in _AV_FIELDS:
            continue
        if x.device != dev or x.dtype != dtype or not x.is_contiguous() \
                or shape not in (None, tuple(x.shape)):
            raise ValueError(f"{name}: {field} must be a contiguous {dtype} tensor of shape "
                             f"{shape or tuple(x.shape)} on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    plan = observe_plan(N)
    args = _ObserveArgs(
        **{k: (0 if x is None else x.data_ptr()) for k, (x, _, _) in srcs.items()},
        out=out.data_ptr(), n_lanes=N, U=tables.pred.shape[1], C=tables.sizes.shape[1],
        RT=R * T, T=T, K=K, A=A, F=Fw, startup_download=int(tables.startup_download),
        lanes=plan.lanes, group=plan.threads, out_stride=out.stride(0),
        max_size=float(tables.max_size), max_rate=float(tables.max_rate),
        max_throughput=float(tables.max_throughput), mode=MODES[mode],
        av_versions=_version_table(dev).data_ptr() if mode == "derived" else 0)
    lib = build.load("observe")
    lib.observe_launch.argtypes = [ctypes.POINTER(_ObserveArgs), ctypes.c_void_p]
    lib.observe_launch.restype = ctypes.c_int
    err = lib.observe_launch(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    return out


def observe_mansy_pack(tables: SimTables, state: EnvState, out: torch.Tensor | None = None,
                       action_values: bool = False) -> torch.Tensor:
    """Packed [N, F] observation of every lane, written into ``out`` when
    given (its rows must be contiguous; they may be strided and the buffer
    unaligned).  With the tables' action values (the exact field) when they
    carry them; else, with ``action_values``, the derived values in their
    columns (the derived mode).  CPU tensors take the plain version; CUDA
    tensors launch the kernel.  Launches count by mode (``launches_by_mode``:
    ``gather``, the exact or no action values; ``derived``)."""
    if state.buf.device.type == "cpu":
        return observe_mansy_pack_plain(tables, state, out, action_values)
    mode = "derived" if action_values and tables.av_quality is None else "gather"
    out = _launch("observe_mansy_pack", tables, state, out, mode)
    count_launch(observe_mansy_pack, mode)
    return out


observe_mansy_pack.launches = 0
observe_mansy_pack.launches_by_mode = {}


def derive_action_values(rows: torch.Tensor, K: int, R: int, T: int, A: int) -> torch.Tensor:
    """K2's row mode: the derived action values of packed rows [N, F]
    (``obs_layout(K, R, T, A, av=True)``; their rows must be contiguous, and
    may be strided) into their action-value columns, in place.  Returns
    ``rows``.  CPU tensors take the plain version; CUDA tensors launch the
    kernel, whose blocks copy their tiles of rows in with 16-byte copies
    where the rows are contiguous and the tile 16-byte aligned."""
    if rows.device.type == "cpu":
        return derive_action_values_plain(rows, K, R, T, A)
    _check_derived_dims("derive_action_values", K, R, T, A)
    Fw = obs_width(K, R, T, A, True)
    if rows.dim() != 2 or rows.shape[1] != Fw or rows.dtype != torch.float32 \
            or rows.stride(1) != 1:
        raise ValueError(f"derive_action_values: rows must be f32 [N, {Fw}] with contiguous "
                         f"rows, got {rows.dtype} {tuple(rows.shape)}")
    N = rows.shape[0]
    plan = observe_plan(N)
    args = _DeriveArgs(rows=rows.data_ptr(), av_versions=_version_table(rows.device).data_ptr(),
                       stride=rows.stride(0), n_rows=N, K=K, RT=R * T, A=A, F=Fw,
                       lanes=plan.lanes, group=plan.threads)
    lib = build.load("observe")
    lib.derive_launch.argtypes = [ctypes.POINTER(_DeriveArgs), ctypes.c_void_p]
    lib.derive_launch.restype = ctypes.c_int
    err = lib.derive_launch(ctypes.byref(args), torch.cuda.current_stream(rows.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"derive_action_values kernel launch failed with CUDA error {err}")
    derive_action_values.launches += 1
    return rows


derive_action_values.launches = 0


def observe_simple_pack(tables: SimTables, state: EnvState,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """K2's simple mode: the packed [N, 395] simple_rl observation of every
    lane (see :func:`observe_mansy_pack` for ``out``).  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if state.buf.device.type == "cpu":
        return observe_simple_pack_plain(tables, state, out)
    out = _launch("observe_simple_pack", tables, state, out, "simple")
    observe_simple_pack.launches += 1
    return out


observe_simple_pack.launches = 0
