#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: builds the hand-written
kernels, holds each against its plain PyTorch version, serves the v9 policy
over a test grid and collects a rollout, all through the port's own entry
points.  It imports no JAX.

    python3 chip_smoke.py

Phases:

1. device: the card's name and power limit (``nvidia-smi``); TF32 off.
2. kernels: build K1-K3 with nvcc (in parallel) and compare each kernel with
   its plain version on the same card tensors at the main path's shapes
   (8192 lanes on tables of the Jin2022/4G train split's shape); time both
   with CUDA events and print the ``kernels`` JSON line.
3. serve: deterministic evaluation of the committed v9 weights over the
   1440-episode test grid's shape, in lane chunks of 512; every lane must
   finish an episode, and the first-done masks and every episode record
   must match the plain path on the card.
4. collect: the sampling rollout collector, 8192 lanes x 128 steps.

Serve and collect are each timed over several passes (median and spread
of the host-clock rate); every pass must launch each kernel exactly once a
step (K2 and K3 once more per collect, for the bootstrap value).

Every phase raises on failure; the last line of a successful run is the
``{"ok": true, "device": ...}`` JSON object.  Without a card it exits 1.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM at its full 700 W power limit (NVIDIA's
# data sheet): HBM3 bandwidth and the f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

LANES = 8192            # main-path lanes (bench.py's rollout width)
COLLECT_STEPS = 128
TRAIN_SHAPE = (18, 45, 24, 60, 4)   # videos, users, traces, chunks, prefs (train split)
TEST_SHAPE = (3, 15, 8, 60, 4)      # the 1440-episode test grid
SERVE_CHUNK = 512
PASSES = 5              # timed passes of serve and collect (median and spread)
RTOL = 1e-5

PKG = "mansy_immersivevideostreaming_torch"
KERNELS = {
    "env_step": dict(route="cuda", source=f"{PKG}/kernels/csrc/env_step.cu",
                     replaces="mansy_immersivevideostreaming_tpu/sim/env.py:303"),
    "observe_mansy_pack": dict(route="cuda", source=f"{PKG}/kernels/csrc/observe.cu",
                               replaces="mansy_immersivevideostreaming_tpu/sim/env.py:262"),
    "actor_critic_forward": dict(route="cuda", source=f"{PKG}/kernels/csrc/actor_critic.cu",
                                 replaces="mansy_immersivevideostreaming_tpu/models/"
                                          "abr_nets.py:166"),
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def gpu_ms(fn, reps: int = 15) -> float:
    """Median device time of one call, by CUDA events.  A sleep kernel keeps
    the card busy while the calls are queued, so host-side launch overhead
    stays out of the time (a call that synchronises inside still pays it)."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def named_leaves(tree, name: str = ""):
    """[(dotted name, tensor)] of a nested tuple / NamedTuple of tensors."""
    if isinstance(tree, tuple):
        keys = getattr(tree, "_fields", range(len(tree)))
        return [x for k, t in zip(keys, tree) for x in named_leaves(t, f"{name}{k}.")]
    return [(name[:-1], tree)]


def tensor_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(tree))


def close(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Elementwise |got - ref| <= RTOL * max(|ref|, scale), with scale the
    largest |ref| of the tensor times RTOL, so values near 0 compare at the
    tensor's own precision."""
    scale = ref.abs().max().clamp(min=1.0) * RTOL
    return (got - ref).abs() <= RTOL * ref.abs() + scale


# ----------------------------------------------------------------- phase 2

def check_env_step(tables, samples, state, actions, K1, tree_map):
    """K1 from identical states.  The download cursor (``net.idx``,
    ``net.sec``) may move at a second boundary on at most 0.1% of lanes;
    every other integer field is exact on every lane, and the floats agree
    to RTOL on every lane whose cursor did not move.  Returns (max_abs_err,
    kernel ms, plain ms)."""
    N = actions.shape[0]
    a = tree_map(torch.clone, state)
    ref = K1.env_step_plain(tables, samples, tree_map(torch.clone, state), actions, N, True)
    got = K1.env_step(tables, samples, a, actions, N, True)
    torch.cuda.synchronize()
    cursor = ("0.net.idx", "0.net.sec")
    same_cursor = torch.ones(N, dtype=torch.bool, device=actions.device)
    for (name, x), (_, y) in zip(named_leaves(got), named_leaves(ref)):
        if name in cursor:
            same_cursor &= x == y
        elif not x.is_floating_point() and not bool((x == y).all()):
            raise AssertionError(f"env_step: integer field {name} disagrees on "
                                 f"{int((x != y).reshape(N, -1).any(-1).sum())} lanes")
    moved = int(N - same_cursor.sum())
    log(f"env_step: {moved} of {N} lanes moved their download cursor at a second boundary")
    if moved > 0.001 * N:
        raise AssertionError(f"env_step: {moved} lanes moved their download cursor")
    err = 0.0
    for (name, x), (_, y) in zip(named_leaves(got), named_leaves(ref)):
        if x.is_floating_point():
            xs, ys = x[same_cursor], y[same_cursor]
            if not bool(close(xs, ys).all()):
                raise AssertionError(f"env_step: float field {name} disagrees beyond rtol")
            err = max(err, float((xs - ys).abs().max()))
    st = tree_map(torch.clone, state)
    ms = gpu_ms(lambda: K1.env_step(tables, samples, st, actions, N, True))
    plain_ms = gpu_ms(lambda: K1.env_step_plain(tables, samples, state, actions, N, True), 5)
    return err, ms, plain_ms


def n_unique(*index: torch.Tensor, sizes) -> int:
    """Number of distinct index tuples (rows of a table that lanes share are
    read once)."""
    key = torch.zeros_like(index[0], dtype=torch.int64)
    for i, n in zip(index, sizes):
        key = key * n + i.long()
    return int(torch.unique(key).numel())


def env_step_bytes(tables, samples, state, actions) -> int:
    """Bytes K1 must move for this step's data: the lane state read and
    written, the action and the outputs; the distinct predicted and true
    viewport rows, the distinct (chunk, version, tile) sizes and qualities
    the allocation selects, the bandwidth and prefix rows of each trace in
    use, and for each lane that resets its sample row and accuracy entry."""
    from mansy_immersivevideostreaming_torch.ops.allocation import (
        action_to_rates, allocate_tile_rates,
    )
    V, C, R, T = tables.sizes.shape
    U, NT, L = tables.gt.shape[1], tables.bw.shape[0], tables.bw.shape[1]
    N = actions.shape[0]
    v, u, c = state.video, state.user, state.next_chunk
    rate_in, rate_out = action_to_rates(actions)
    versions, _ = allocate_tile_rates(rate_in, rate_out, tables.pred[v.long(), u.long(),
                                                                     c.long()])
    tile = torch.arange(T, device=v.device).expand(N, T)
    vct = [x[:, None].expand(N, T) for x in (v, c)] + [versions, tile]
    done = (c + 1) > tables.end_chunk[v.long(), u.long()]
    ptr = state.next_sample[done] % samples.shape[0]
    return (2 * tensor_bytes(state) + N * 4 + N * (6 * 4 + 5 * 4 + 1)
            + n_unique(v, u, c, sizes=(V, U, C)) * (2 * T * 4 + 4)    # pred, gt, vp_acc
            + n_unique(*vct, sizes=(V, C, R, T)) * 2 * 4               # sizes, qualities
            + n_unique(state.trace, sizes=(NT,)) * ((2 * L + 1) * 4 + 4)  # bw, prefix, len
            + n_unique(v, u, sizes=(V, U)) * 4                         # end_chunk
            + n_unique(state.qoe_id, sizes=(tables.qoe_weights.shape[0],)) * 3 * 4
            + (n_unique(ptr, sizes=(samples.shape[0],)) * (4 * 4 + 4) if ptr.numel() else 0))


def observe_bytes(tables, state, width: int) -> int:
    """Bytes K2 must move: the lane state it reads, the distinct chunk slabs
    (size and quality, every version) and predicted viewport rows, the
    distinct preference rows, and the [N, F] output."""
    V, C, R, T = tables.sizes.shape
    K, A, U = tables.past_k, tables.action_space, tables.pred.shape[1]
    N = state.buf.shape[0]
    v, u, c = state.video, state.user, state.next_chunk
    per_lane = 5 * 4 + 7 * K * 4 + A * 4 + width * 4
    return (N * per_lane + n_unique(v, c, sizes=(V, C)) * 2 * R * T * 4
            + n_unique(v, u, c, sizes=(V, U, C)) * T * 4
            + n_unique(state.qoe_id, sizes=(tables.qoe_weights.shape[0],)) * 3 * 4)


def actor_critic_cost(w, N: int, A: int):
    """(flops, bytes) of K3: the branch, fc and head products (2 flops per
    multiply-add) and the log-softmax; inputs read and outputs written once."""
    H = w.b_branch.shape[1]
    fin = w.branch_off[-1]
    flops = N * (2 * (fin * H + 10 * H * 2 * H + H * (A + 1)) + 4 * A)
    weight_bytes = sum(t.numel() * 4 for t in w[:-1])
    return flops, N * (fin + A) * 4 + weight_bytes + N * (A + 3) * 4


def library_actor_critic(w):
    """The same function as one composition of torch matmuls over a dense
    block-diagonal branch weight: the yardstick (library_ms) only."""
    H = w.b_branch.shape[1]
    fin = w.branch_off[-1]
    wbd = torch.zeros((fin, 10 * H), device=w.w_branch.device)
    for b in range(10):
        lo, hi = w.branch_off[b], w.branch_off[b + 1]
        wbd[lo:hi, b * H:(b + 1) * H] = w.w_branch[lo:hi]
    bias = w.b_branch.reshape(-1)

    def fn(x, noise):
        feats = torch.nn.functional.leaky_relu(x[:, :fin] @ wbd + bias, 0.01)
        cond = feats[:, -H:]
        h = torch.nn.functional.leaky_relu(feats @ w.w_fc + w.b_fc, 0.01)
        logits = (h[:, :H] + cond) @ w.w_actor_out + w.b_actor_out
        value = (h[:, H:] + cond) @ w.w_critic_out + w.b_critic_out
        logp = torch.log_softmax(logits, -1)
        action = (logits + noise).argmax(-1)
        return logits, value, action, logp.gather(-1, action[:, None])
    return fn


def kernel_phase(dev):
    from mansy_immersivevideostreaming_torch.kernels import actor_critic as K3
    from mansy_immersivevideostreaming_torch.kernels import build
    from mansy_immersivevideostreaming_torch.kernels import env_step as K1
    from mansy_immersivevideostreaming_torch.kernels import observe as K2
    from mansy_immersivevideostreaming_torch.rl.rollout import init_lanes
    from mansy_immersivevideostreaming_torch.sim.env import (
        generate_environment_samples, tree_map,
    )
    from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables
    from mansy_immersivevideostreaming_torch.utils.checkpoint import load_npz_policy

    t0 = time.time()
    reports = build.build()
    log(f"built {sorted(reports) or 'nothing (cached)'} in {time.time() - t0:.1f}s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    V, U, NT, C, Q = TRAIN_SHAPE
    tables = synthetic_sim_tables(V, U, NT, C, Q, seed=0, device=dev)
    samples = torch.as_tensor(generate_environment_samples(V, U, NT, Q), device=dev)
    N = LANES
    state = init_lanes(tables, samples, N)
    rng = np.random.default_rng(0)
    for _ in range(7):  # give the lanes history (plain path)
        acts = torch.as_tensor(rng.integers(0, 15, N).astype(np.int32), device=dev)
        state, *_ = K1.env_step_plain(tables, samples, state, acts, N, True)
    actions = torch.as_tensor(rng.integers(0, 15, N).astype(np.int32), device=dev)
    rows = {}

    # K2
    x = K2.observe_mansy_pack(tables, state)
    x_ref = K2.observe_mansy_pack_plain(tables, state)
    if not bool(close(x, x_ref).all()):
        raise AssertionError("observe_mansy_pack disagrees with its plain version")
    out = torch.empty_like(x)
    rows["observe_mansy_pack"] = dict(
        max_abs_err=float((x - x_ref).abs().max()),
        ms=gpu_ms(lambda: K2.observe_mansy_pack(tables, state, out=out)),
        plain_ms=gpu_ms(lambda: K2.observe_mansy_pack_plain(tables, state), 5),
        bound_ms=1e3 * observe_bytes(tables, state, x.shape[1]) / HBM_BYTES_PER_S,
        bound_by="bytes", library_ms=None)

    # K3 (v9 weights, sampling noise)
    policy = load_npz_policy(device=dev)
    w = policy.packed_weights()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    noise = K3.gumbel_noise((N, tables.action_space), gen, dev)
    got = K3.actor_critic_forward(w, x, noise)
    ref = K3.actor_critic_forward_plain(w, x, noise)
    for g, r in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
        if not bool(close(g, r).all()):
            raise AssertionError("actor_critic_forward disagrees with its plain version")
    scores = ref[0] + noise
    top2 = scores.topk(2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 1e-4
    if not bool((got[2] == ref[2])[decisive].all()):
        raise AssertionError("actor_critic_forward picks other actions than its plain version")
    flops, nbytes = actor_critic_cost(w, N, tables.action_space)
    lib = library_actor_critic(w)
    rows["actor_critic_forward"] = dict(
        max_abs_err=max(float((g - r).abs().max()) for g, r in zip(got[:2], ref[:2])),
        ms=gpu_ms(lambda: K3.actor_critic_forward(w, x, noise)),
        plain_ms=gpu_ms(lambda: K3.actor_critic_forward_plain(w, x, noise)),
        bound_ms=1e3 * max(flops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S),
        bound_by="operations" if flops / F32_FLOP_PER_S > nbytes / HBM_BYTES_PER_S
        else "bytes",
        library_ms=gpu_ms(lambda: lib(x, noise)))

    # K1 (one step from identical states)
    nbytes = env_step_bytes(tables, samples, state, actions)
    err, ms, plain_ms = check_env_step(tables, samples, state, actions, K1, tree_map)
    rows["env_step"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=1e3 * nbytes / HBM_BYTES_PER_S,
        bound_by="bytes", library_ms=None)
    return rows


# ----------------------------------------------------------------- phase 3

def plain_serve(policy, tables, samples):
    """The serve path through the plain versions only (the reference)."""
    from mansy_immersivevideostreaming_torch.kernels.actor_critic import (
        actor_critic_forward_plain,
    )
    from mansy_immersivevideostreaming_torch.kernels.env_step import env_step_plain
    from mansy_immersivevideostreaming_torch.kernels.observe import observe_mansy_pack_plain
    from mansy_immersivevideostreaming_torch.rl.rollout import stack_logs
    from mansy_immersivevideostreaming_torch.rl.runner import (
        episode_step_bound, first_done_mask,
    )
    from mansy_immersivevideostreaming_torch.sim.env import reset_env

    w = policy.packed_weights()
    all_logs, all_masks = [], []
    for s0 in range(0, samples.shape[0], SERVE_CHUNK):
        sub = samples[s0:s0 + SERVE_CHUNK]
        n = sub.shape[0]
        state = reset_env(tables, sub, torch.arange(n, dtype=torch.int32, device=sub.device), n)
        logs = []
        for _ in range(episode_step_bound(tables)):
            x = observe_mansy_pack_plain(tables, state)
            _, _, action, _ = actor_critic_forward_plain(w, x, None)
            state, _, _, log_ = env_step_plain(tables, sub, state, action, n, False)
            logs.append(log_)
        logs = stack_logs(logs)
        all_logs.append(logs)
        all_masks.append(first_done_mask(logs.done.cpu().numpy()))
    return all_logs, all_masks


def timed_passes(run, counters, want):
    """Run ``run()`` PASSES times on the host clock, each ended by a
    synchronize.  Every count is set to 0 just before each pass and read
    just after it; each pass must launch each kernel ``want[name]`` times.
    Returns (last pass's result, seconds of each pass, launches of a pass)."""
    seconds = []
    for _ in range(PASSES):
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches = {fn.__name__: fn.launches for fn in counters}
        if launches != want:
            raise AssertionError(f"launches {launches}, expected {want}")
    return out, seconds, launches


def rate_stats(work: int, seconds) -> dict:
    """Median rate of ``work`` units over the passes, and the passes' spread."""
    rates = sorted(work / s for s in seconds)
    return dict(median=statistics.median(rates), min=rates[0], max=rates[-1],
                spread=(rates[-1] - rates[0]) / statistics.median(rates))


def serve_phase(dev, counters):
    from mansy_immersivevideostreaming_torch.rl.runner import episode_step_bound, evaluate
    from mansy_immersivevideostreaming_torch.sim.env import generate_environment_test_samples
    from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables
    from mansy_immersivevideostreaming_torch.utils.checkpoint import load_npz_policy

    V, U, NT, C, Q = TEST_SHAPE
    tables = synthetic_sim_tables(V, U, NT, C, Q, seed=1, device=dev)
    samples = torch.as_tensor(generate_environment_test_samples(V, U, NT, Q), device=dev)
    policy = load_npz_policy(device=dev)
    evaluate(policy, tables, samples[:SERVE_CHUNK], deterministic=True)  # warm-up
    steps = -(-samples.shape[0] // SERVE_CHUNK) * episode_step_bound(tables)
    (logs, masks), seconds, launches = timed_passes(
        lambda: evaluate(policy, tables, samples, lane_chunk=SERVE_CHUNK, deterministic=True),
        counters, {fn.__name__: steps for fn in counters})
    n_eps = int(sum(m.sum() for m in masks))
    if n_eps != samples.shape[0]:
        raise AssertionError(f"serve: {n_eps} of {samples.shape[0]} lanes finished an episode")
    ref_logs, ref_masks = plain_serve(policy, tables, samples)
    for m, rm in zip(masks, ref_masks):
        if not np.array_equal(m, rm):
            raise AssertionError("serve: first-done masks differ from the plain path's")
    differing = 0  # per episode: ints exact, floats rtol = atol = 1e-5 (test_torch_slice)
    for name in logs[0]._fields:
        got = np.concatenate([getattr(l, name).cpu().numpy()[m] for l, m in zip(logs, masks)])
        ref = np.concatenate([getattr(l, name).cpu().numpy()[m]
                              for l, m in zip(ref_logs, ref_masks)])
        if np.issubdtype(ref.dtype, np.floating):
            if not np.isfinite(got).all():
                raise AssertionError(f"serve: non-finite {name}")
            differing += int((np.abs(got - ref) > 1e-5 + 1e-5 * np.abs(ref)).sum())
        else:
            differing += int((got != ref).sum())
        if name == "qoe":
            qoe, ref_qoe = got, ref
    if differing:
        raise AssertionError(f"serve: {differing} episode records differ from the plain path")
    rate = rate_stats(n_eps, seconds)
    return dict(episodes=n_eps, steps=steps, passes=PASSES, seconds=seconds,
                episodes_per_s_median=rate["median"], episodes_per_s_min=rate["min"],
                episodes_per_s_max=rate["max"], spread=rate["spread"],
                mean_qoe=float(qoe.mean()), plain_mean_qoe=float(ref_qoe.mean()),
                episodes_differing=differing, launches=launches)


# ----------------------------------------------------------------- phase 4

def collect_phase(dev, counters):
    from mansy_immersivevideostreaming_torch.rl.rollout import init_lanes, make_collector
    from mansy_immersivevideostreaming_torch.sim.env import generate_environment_samples
    from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables
    from mansy_immersivevideostreaming_torch.utils.checkpoint import load_npz_policy

    V, U, NT, C, Q = TRAIN_SHAPE
    tables = synthetic_sim_tables(V, U, NT, C, Q, seed=0, device=dev)
    samples = torch.as_tensor(generate_environment_samples(V, U, NT, Q), device=dev)
    policy = load_npz_policy(device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    lanes = [init_lanes(tables, samples, LANES)]
    make_collector(tables, samples, LANES, 4)(policy, lanes[0], gen)  # warm-up
    collect = make_collector(tables, samples, LANES, COLLECT_STEPS, train=True)

    def run():  # each pass goes on from the lanes the last one left
        lanes[0], *rest = collect(policy, lanes[0], gen)
        return rest

    want = {"env_step": COLLECT_STEPS, "observe_mansy_pack": COLLECT_STEPS + 1,
            "actor_critic_forward": COLLECT_STEPS + 1}
    (traj, logs, last_values), seconds, launches = timed_passes(run, counters, want)
    T, N = COLLECT_STEPS, LANES
    if traj.reward.shape != (T, N) or traj.obs["next_chunk_size"].shape != (T, N, 5, 64):
        raise AssertionError("collect: trajectory of the wrong shape")
    for name, x in (("reward", traj.reward), ("value", traj.value),
                    ("log_prob", traj.log_prob), ("last_values", last_values)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"collect: non-finite {name}")
    if not bool((traj.log_prob <= 0).all()) or int(traj.done.sum()) == 0:
        raise AssertionError("collect: log-probs above 0 or no episode ended")
    rate = rate_stats(N * T, seconds)
    return dict(lanes=N, steps=T, passes=PASSES, seconds=seconds,
                env_steps_per_s_median=rate["median"], env_steps_per_s_min=rate["min"],
                env_steps_per_s_max=rate["max"], spread=rate["spread"],
                episodes_ended=int(traj.done.sum()),
                mean_step_reward=float(traj.reward.mean()), launches=launches)


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA card (torch.cuda.is_available() is False)")
        return 1
    from mansy_immersivevideostreaming_torch.kernels.actor_critic import actor_critic_forward
    from mansy_immersivevideostreaming_torch.kernels.env_step import env_step
    from mansy_immersivevideostreaming_torch.kernels.observe import observe_mansy_pack

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = device_line()
    log(f"device: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    counters = (env_step, observe_mansy_pack, actor_critic_forward)

    t0 = time.time()
    rows = kernel_phase(dev)
    log(f"kernels checked in {time.time() - t0:.1f}s")
    serve = serve_phase(dev, counters)
    log(f"serve: {json.dumps(serve)}")
    collect = collect_phase(dev, counters)
    log(f"collect: {json.dumps(collect)}")
    for fn in counters:  # the counts of one pass of each path
        name = fn.__name__
        s, c = serve["launches"][name], collect["launches"][name]
        if s == 0 or c == 0:
            raise AssertionError(f"{name} was not launched on the main path")
        rows[name].update(launches=s + c, launches_serve=s, launches_collect=c,
                          launches_per_step_serve=s / serve["steps"],
                          launches_per_step_collect=c / collect["steps"])
    kernels = [dict(name=name, **KERNELS[name], **rows[name]) for name in KERNELS]
    print(json.dumps({"serve": {k: v for k, v in serve.items() if k != "launches"},
                      "collect": {k: v for k, v in collect.items() if k != "launches"},
                      "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
