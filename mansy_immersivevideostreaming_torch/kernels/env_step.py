"""K1: the fused environment step (wrapper, plain version, launch count).

Replaces the JAX package's ``sim/env.py:step_env`` (``:303-385``) together
with the callees XLA fused into it: ``ops/allocation.py:viewport_scales`` and
``allocate_tile_rates`` (``:96``, ``:128``), the one-hot size/quality select
(``sim/env.py:327-331``), ``sim/simulator.py:simulate_download_prefix``
(``:84``) and ``push_chunk`` (``:142``), ``ops/qoe.py:qoe_step`` (``:38``),
``_roll`` (``sim/env.py:185``) and the auto-reset ``reset_env`` (``:149``).

On the H100 the step's bytes (about 0.8 KB a lane at 8192 lanes: 0.0019 ms
at 3.35 TB/s) bound it in principle; in practice the instructions it issues
do, since a lane's scalar download and QoE math runs on every thread that
takes the lane.  ``csrc/env_step.cu`` runs a group of 8 threads a lane, each
thread 8 of its 64 tiles, so that a warp runs four lanes' scalar math in one
instruction stream (32 threads a lane where a lane has more than 8 history
entries: :func:`env_step_plan`).  Every load that depends only on a lane's
state issues at once (its trace's prefix row held in registers when the
trace has at most 63 seconds), and only the selected version of each tile
is read.  See the source for the design.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mansy_immersivevideostreaming_torch.kernels import build
from mansy_immersivevideostreaming_torch.ops.allocation import (
    ACTION_TO_RATES, action_to_rates, allocate_tile_rates, scale_rate_table,
)
from mansy_immersivevideostreaming_torch.ops.qoe import qoe_step
from mansy_immersivevideostreaming_torch.sim.env import (
    EnvState, LogRecord, _roll, reset_env, tree_where,
)
from mansy_immersivevideostreaming_torch.sim.simulator import (
    INIT_BUFFER_CHUNKS, push_chunk, simulate_download_prefix,
)
from mansy_immersivevideostreaming_torch.sim.tables import SimTables

NUM_TILES = 64  # the kernel's 8x8 tiling
BLOCK_THREADS = 128


class EnvStepPlan(NamedTuple):
    """K1's launch: ``group`` threads a lane, ``lanes`` lanes a block of
    BLOCK_THREADS threads, ``blocks`` blocks; block b takes lanes b * lanes
    to b * lanes + lanes - 1 (those below N)."""
    group: int
    lanes: int
    blocks: int


def env_step_plan(n_lanes: int, past_k: int) -> EnvStepPlan:
    """8 threads a lane, each holding one history entry, or 32 where the
    lanes have more than 8 history entries."""
    group = 8 if past_k <= 8 else 32
    lanes = BLOCK_THREADS // group
    return EnvStepPlan(group, lanes, -(-n_lanes // lanes))


def env_step_plain(tables: SimTables, samples: torch.Tensor, state: EnvState,
                   action: torch.Tensor, stride: int, train: bool):
    """Plain PyTorch version of one env step of every lane, with auto-reset
    (mirrors the JAX ``step_env`` operation for operation).  Returns
    (new_state, reward, done, log_record); when a lane's episode is over its
    new state is already reset to the next scheduled sample."""
    v, u, c = state.video.long(), state.user.long(), state.next_chunk.long()
    rate_in, rate_out = action_to_rates(action)
    # the JAX step allocates with the default rates and tiling
    versions, _ = allocate_tile_rates(rate_in, rate_out, tables.pred[v, u, c])

    # each tile's size and quality at its allocated version
    sel = versions.long()[:, None, :]
    sizes = tables.sizes[v, c].gather(1, sel)[:, 0]
    quals = tables.qualities[v, c].gather(1, sel)[:, 0]
    chunk_size = sizes.sum(-1)

    tr = state.trace.long()
    net, download_time = simulate_download_prefix(
        tables.bw[tr], tables.bw_prefix[tr], tables.bw_len[tr], state.net, chunk_size)
    buf, rebuffer = push_chunk(state.buf, tables.chunk_length, download_time)

    weights = tables.qoe_weights[state.qoe_id.long()]
    qoe_state, qoe, qoe1, qoe2, qoe3 = qoe_step(
        state.qoe, weights, tables.gt[v, u, c], quals, rebuffer, tables.max_rate)
    wsum = weights.sum(-1)
    reward = qoe / wsum if train else qoe

    over = (c + 1) > tables.end_chunk[v, u]
    rates_f = tables.video_rates.to(torch.float32)
    C = tables.gt.shape[2]
    stepped = EnvState(
        video=state.video, user=state.user, trace=state.trace, qoe_id=state.qoe_id,
        next_sample=state.next_sample,
        next_chunk=state.next_chunk + 1,
        buf=buf, net=net, qoe=qoe_state,
        past_throughput=_roll(state.past_throughput,
                              chunk_size / download_time / tables.max_throughput),
        past_acc=_roll(state.past_acc, state.last_acc),
        past_rate_in=_roll(state.past_rate_in, rates_f[rate_in.long()] / tables.max_rate),
        past_rate_out=_roll(state.past_rate_out, rates_f[rate_out.long()] / tables.max_rate),
        past_vq=_roll(state.past_vq, qoe1),
        past_var=_roll(state.past_var, qoe3),
        past_rebuf=_roll(state.past_rebuf, qoe2 / tables.startup_download),
        last_rebuffer=qoe2,
        last_acc=tables.vp_acc[v, u, torch.clamp(c + 1, max=C - 1)],
        last_action_one_hot=F.one_hot(action.long(), tables.action_space).to(torch.float32),
        ep_qoe=state.ep_qoe + qoe, ep_qoe1=state.ep_qoe1 + qoe1,
        ep_qoe2=state.ep_qoe2 + qoe2, ep_qoe3=state.ep_qoe3 + qoe3,
        ep_steps=state.ep_steps + 1,
    )
    n = stepped.ep_steps.to(torch.float32)
    log = LogRecord(
        done=over, video=state.video, user=state.user, trace=state.trace,
        qoe_id=state.qoe_id,
        qoe=stepped.ep_qoe / n / wsum,
        qoe1=stepped.ep_qoe1 / n, qoe2=stepped.ep_qoe2 / n, qoe3=stepped.ep_qoe3 / n,
        ret=stepped.ep_qoe, steps=stepped.ep_steps,
    )
    fresh = reset_env(tables, samples, state.next_sample, stride)
    return tree_where(over, fresh, stepped), reward, over, log


_P, _I, _F = ctypes.c_void_p, ctypes.c_int32, ctypes.c_float

_TABLE_FIELDS = ("sizes", "qualities", "gt", "pred", "vp_acc", "end_chunk", "bw",
                 "bw_len", "bw_prefix", "qoe_weights", "video_rates")
_STATE_FIELDS = ("video", "user", "trace", "qoe_id", "next_sample", "next_chunk", "buf",
                 "net_idx", "net_sec", "net_frac", "prev_quality", "has_prev",
                 "past_throughput", "past_acc", "past_rate_in", "past_rate_out",
                 "past_vq", "past_var", "past_rebuf", "last_rebuffer", "last_acc",
                 "last_action_one_hot", "ep_qoe", "ep_qoe1", "ep_qoe2", "ep_qoe3",
                 "ep_steps")
_OUT_FIELDS = ("reward", "done", "log_video", "log_user", "log_trace", "log_qoe_id",
               "log_qoe", "log_qoe1", "log_qoe2", "log_qoe3", "log_ret", "log_steps")


class _EnvStepArgs(ctypes.Structure):
    """Mirror of ``EnvStepArgs`` in ``csrc/env_step.cu`` (same field order)."""
    _fields_ = ([(f, _P) for f in _TABLE_FIELDS]
                + [(f, _P) for f in ("scale_table", "action_rates", "samples", "action")]
                + [(f, _P) for f in _STATE_FIELDS]
                + [(f, _P) for f in _OUT_FIELDS]
                + [(f, _I) for f in ("n_lanes", "U", "C", "R", "L", "S", "A", "K",
                                     "stride", "train", "startup_download", "group")]
                + [(f, _F) for f in ("chunk_length", "init_buffer", "max_rate",
                                     "max_throughput")])


@functools.lru_cache(maxsize=None)
def _codec_tables(device: torch.device):
    """(scale table [R, 5], action -> rates [A, 2]) on ``device``: the
    allocation's default rates and 8x8 tiling, as the JAX step uses."""
    return (torch.as_tensor(scale_rate_table(), device=device),
            torch.as_tensor(ACTION_TO_RATES, device=device))


def _flat_state(state: EnvState):
    return (state.video, state.user, state.trace, state.qoe_id, state.next_sample,
            state.next_chunk, state.buf, state.net.idx, state.net.sec, state.net.frac,
            state.qoe.prev_quality, state.qoe.has_prev, state.past_throughput,
            state.past_acc, state.past_rate_in, state.past_rate_out, state.past_vq,
            state.past_var, state.past_rebuf, state.last_rebuffer, state.last_acc,
            state.last_action_one_hot, state.ep_qoe, state.ep_qoe1, state.ep_qoe2,
            state.ep_qoe3, state.ep_steps)


_INT_FIELDS = {"end_chunk", "bw_len", "video_rates", "scale_table", "action_rates", "samples",
               "action", "video", "user", "trace", "qoe_id", "next_sample", "next_chunk",
               "net_idx", "net_sec", "ep_steps"}


def _dtype(name: str) -> torch.dtype:
    if name in _INT_FIELDS:
        return torch.int32
    return torch.bool if name == "has_prev" else torch.float32


def _check(name: str, x: torch.Tensor, device: torch.device, shape) -> None:
    """``shape`` None (a table) takes any shape."""
    want = _dtype(name)
    if x.device != device or x.dtype != want or not x.is_contiguous() \
            or shape not in (None, tuple(x.shape)):
        raise ValueError(f"env_step: {name} must be a contiguous {want} tensor of shape "
                         f"{shape or tuple(x.shape)} on {device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def env_step(tables: SimTables, samples: torch.Tensor, state: EnvState,
             action: torch.Tensor, stride: int, train: bool):
    """One env step of every lane.  CPU tensors take :func:`env_step_plain`;
    CUDA tensors launch the kernel, which overwrites ``state``'s tensors in
    place and returns the same ``state`` object."""
    dev = state.buf.device
    if dev.type == "cpu":
        return env_step_plain(tables, samples, state, action, stride, train)
    N = state.buf.shape[0]
    V, C, R, T = tables.sizes.shape
    K, A = tables.past_k, tables.action_space
    if T != NUM_TILES or K > 32 or A > 32 or R > 16 or tables.video_rates.shape[0] != R:
        raise ValueError(f"env_step kernel needs 64 tiles, K <= 32, A <= 32 and R <= 16 "
                         f"rates; got T={T}, K={K}, A={A}, R={R}")
    if action.dtype != torch.int32:
        action = action.to(torch.int32)
    scale_table, action_rates = _codec_tables(dev)
    if scale_table.shape[0] != R:
        raise ValueError(f"env_step kernel: tables have {R} rates, the codec has "
                         f"{scale_table.shape[0]}")
    fbuf = torch.empty((6, N), dtype=torch.float32, device=dev)
    ibuf = torch.empty((5, N), dtype=torch.int32, device=dev)
    done = torch.empty(N, dtype=torch.bool, device=dev)
    reward, log_qoe, log_qoe1, log_qoe2, log_qoe3, log_ret = fbuf
    log_video, log_user, log_trace, log_qoe_id, log_steps = ibuf
    outs = (reward, done, log_video, log_user, log_trace, log_qoe_id,
            log_qoe, log_qoe1, log_qoe2, log_qoe3, log_ret, log_steps)

    tabs = [getattr(tables, f) for f in _TABLE_FIELDS]
    ptrs = {}
    for name, x in zip(_TABLE_FIELDS + ("scale_table", "action_rates", "samples", "action")
                       + _STATE_FIELDS,
                       tabs + [scale_table, action_rates, samples, action]
                       + list(_flat_state(state))):
        shape = (None if name not in _STATE_FIELDS and name != "action"
                 else (N, K) if name.startswith("past_")
                 else (N, A) if name.endswith("one_hot") else (N,))
        _check(name, x, dev, shape)
        ptrs[name] = x.data_ptr()
    for name, x in zip(_OUT_FIELDS, outs):
        ptrs[name] = x.data_ptr()
    args = _EnvStepArgs(
        **ptrs, n_lanes=N, U=tables.gt.shape[1], C=C, R=R, L=tables.bw.shape[1],
        S=samples.shape[0], A=A, K=K, stride=int(stride), train=int(bool(train)),
        startup_download=int(tables.startup_download),
        group=env_step_plan(N, K).group,
        chunk_length=float(tables.chunk_length),
        init_buffer=float(INIT_BUFFER_CHUNKS * tables.chunk_length),
        max_rate=float(tables.max_rate), max_throughput=float(tables.max_throughput))
    lib = build.load("env_step")
    lib.env_step_launch.argtypes = [ctypes.POINTER(_EnvStepArgs), ctypes.c_void_p]
    lib.env_step_launch.restype = ctypes.c_int
    err = lib.env_step_launch(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"env_step kernel launch failed with CUDA error {err}")
    env_step.launches += 1
    log = LogRecord(done=done, video=log_video, user=log_user, trace=log_trace,
                    qoe_id=log_qoe_id, qoe=log_qoe, qoe1=log_qoe1, qoe2=log_qoe2,
                    qoe3=log_qoe3, ret=log_ret, steps=log_steps)
    return state, reward, done, log


env_step.launches = 0
