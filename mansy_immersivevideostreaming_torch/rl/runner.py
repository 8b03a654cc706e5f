"""Evaluation and episode logging shared by the CLIs.

Port of ``mansy_immersivevideostreaming_tpu/rl/runner.py``: split resolution
-> device tables, vectorized evaluation over the cartesian test grid,
episode-log CSV rows in the reference's exact format (reference
``envs/mansy_env.py:271-290``), and the summary table (reference
``utils/common.py:196-218``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mansy_immersivevideostreaming_torch.config import Config
from mansy_immersivevideostreaming_torch.kernels.actor_critic import (
    actor_critic_forward, gumbel_noise,
)
from mansy_immersivevideostreaming_torch.rl.rollout import Policy, check_observation, stack_logs
from mansy_immersivevideostreaming_torch.sim.env import (
    LogRecord, generate_environment_samples, generate_environment_test_samples,
    reset_env, step_env,
)
from mansy_immersivevideostreaming_torch.sim.tables import SimTables, build_sim_tables
from mansy_immersivevideostreaming_torch.utils.logging import ascii_table


def episode_step_bound(tables: SimTables) -> int:
    """Max steps an episode can take: last chunk - first downloaded chunk + 1."""
    return int(tables.end_chunk.max().item()) - tables.startup_download


def first_done_mask(done: np.ndarray) -> np.ndarray:
    """[T, N] done flags -> mask selecting each lane's FIRST episode end."""
    first = np.zeros_like(done)
    seen = np.zeros(done.shape[1], bool)
    for t in range(done.shape[0]):
        first[t] = done[t] & ~seen
        seen |= done[t]
    return first


def build_split(config: Config, dataset: str, network_dataset: str, mode: str,
                qoe_weights: Sequence[Sequence[float]],
                test_grid: bool = False, device: str | torch.device = "cuda"):
    """Returns (tables, samples i32 [S, 4], videos, users, traces) of a split."""
    videos = list(config.video_split[dataset][mode])
    users = list(config.user_split[dataset][mode])
    traces = list(config.network_split[network_dataset][mode])
    tables = build_sim_tables(config, dataset, network_dataset, videos, users,
                              traces, qoe_weights, device=device)
    if test_grid:
        samples = generate_environment_test_samples(
            len(videos), len(users), len(traces), len(qoe_weights))
    else:
        samples = generate_environment_samples(
            len(videos), len(users), len(traces), len(qoe_weights))
    return tables, torch.as_tensor(samples, device=tables.device), videos, users, traces


def episode_log_rows(logs: LogRecord, videos: Sequence[int], users: Sequence[int],
                     traces: Sequence[int],
                     qoe_weights: Sequence[Sequence[float]]) -> List[str]:
    """Format finished-episode records as reference CSV rows
    (``mansy_env.py:277-284``: means rounded to 5 digits, qoe normalized)."""
    f = {k: torch.as_tensor(v).cpu().numpy() for k, v in logs._asdict().items()}
    rows = []
    for t, n in np.argwhere(f["done"]):
        w = qoe_weights[int(f["qoe_id"][t, n])]
        rows.append(
            f"{videos[int(f['video'][t, n])]},{users[int(f['user'][t, n])]},"
            f"{traces[int(f['trace'][t, n])]},"
            f"{float(w[0])},{float(w[1])},{float(w[2])},"
            f"{round(float(f['qoe'][t, n]), 5)},{round(float(f['qoe1'][t, n]), 5)},"
            f"{round(float(f['qoe2'][t, n]), 5)},{round(float(f['qoe3'][t, n]), 5)}")
    return rows


def append_episode_logs(path: str, rows: List[str]) -> None:
    if not rows:
        return
    new = not os.path.exists(path)
    with open(path, "a", encoding="utf-8") as f:
        if new:
            f.write("video,user,trace,qoe_w1,qoe_w2,qoe_w3,qoe,qoe1,qoe2,qoe3\n")
        for r in rows:
            f.write(r + "\n")


def evaluate(policy: Policy, tables: SimTables, samples: torch.Tensor,
             generator: Optional[torch.Generator] = None, lane_chunk: int = 512,
             deterministic: bool = False):
    """Run every sample episode exactly once; returns per-chunk LogRecords
    [T, n] plus per-sample first-done masks.

    Vectorized replacement for the reference's serial test loop (reference
    ``run_mansy.py:161-175``): each sample of a chunk gets a lane; lanes run
    ``episode_step_bound(tables)`` steps with auto-reset, and only each
    lane's first episode-end record is kept.  ``deterministic`` takes the
    argmax action instead of sampling (tianshou's ``deterministic_eval``; the
    reference test loop samples).  The policy decides the observation (K2's
    MANSY or simple mode, ``policy.observe``).
    """
    check_observation(policy, tables)
    n_steps = episode_step_bound(tables)
    A = tables.action_space
    w = policy.packed_weights()
    all_logs, all_masks = [], []
    for s0 in range(0, samples.shape[0], lane_chunk):
        sub = samples[s0: s0 + lane_chunk]
        n, dev = sub.shape[0], sub.device
        states = reset_env(tables, sub, torch.arange(n, dtype=torch.int32, device=dev), n)
        logs = []
        for _ in range(n_steps):
            x = policy.observe(tables, states)
            noise = None if deterministic else gumbel_noise((n, A), generator, dev)
            _, _, action, _ = actor_critic_forward(w, x, noise)
            states, _, _, log = step_env(tables, sub, states, action, n, False)
            logs.append(log)
        logs = stack_logs(logs)
        all_logs.append(logs)
        all_masks.append(first_done_mask(logs.done.cpu().numpy()))
    return all_logs, all_masks


def masked_log_rows(all_logs, all_masks, videos, users, traces, qoe_weights):
    """Format only each lane's first finished episode (mask from evaluate)."""
    rows: List[str] = []
    for logs, mask in zip(all_logs, all_masks):
        rows.extend(episode_log_rows(logs._replace(done=torch.as_tensor(mask)),
                                     videos, users, traces, qoe_weights))
    return rows


def read_log_file(log_path: str) -> Dict[str, float]:
    """Print the reference's summary table and return the means
    (reference ``utils/common.py:196-218``)."""
    rows = []
    sums = np.zeros(4)
    with open(log_path, "r", encoding="utf-8") as f:
        f.readline()
        for line in f:
            parts = line.strip().split(",")
            video, user, trace = map(int, parts[:3])
            vals = list(map(float, parts[3:]))
            rows.append([video, user, trace] + vals)
            sums += np.asarray(vals[3:])
    n = len(rows)
    means = sums / n
    rows.append([-1, -1, -1, -1, -1, -1] + list(means))
    print(ascii_table(
        ["video", "user", "trace", "qoe_w1", "qoe_w2", "qoe_w3",
         "qoe", "qoe1", "qoe2", "qoe3"], rows))
    return {"qoe": means[0], "qoe1": means[1], "qoe2": means[2], "qoe3": means[3]}
