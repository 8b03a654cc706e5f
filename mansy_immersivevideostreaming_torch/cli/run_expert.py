"""MPC expert CLI: demonstrations and direct evaluation.

Port of the JAX package's ``cli/run_expert.py`` (reference
``bitrate_selection/run_expert.py``).  Episodes run as lanes, lane_chunk at
a time; each step is the observation gather (K2, only when demonstrations
are recorded), the sequence search (K4) and the env step (K1).  The
profiling tables come from K5 once a split, cached in a pickle that either
package reads.

Demonstrations are saved as ``{(video, user, trace, qoe_weights): {"obs":
{field: [T, ...]}, "act": [T]}}`` of numpy arrays, the JAX package's schema.

Examples::

    python -m mansy_immersivevideostreaming_torch.cli.run_expert \\
        --train-dataset Jin2022 --train --valid --horizon 4
    python -m mansy_immersivevideostreaming_torch.cli.run_expert \\
        --test-dataset Jin2022 --test --horizon 2 --qoe-test-ids 3 --test-on-seen
"""

from __future__ import annotations

import argparse
import hashlib
import os
import pickle
import time

import numpy as np
import torch

from mansy_immersivevideostreaming_torch.config import load_config
from mansy_immersivevideostreaming_torch.kernels.observe import (
    obs_dims, obs_width, observe_mansy_pack, unpack_obs,
)
from mansy_immersivevideostreaming_torch.rl import runner
from mansy_immersivevideostreaming_torch.rl.rollout import stack_logs
from mansy_immersivevideostreaming_torch.sim.env import (
    generate_demo_samples, reset_env, step_env, viewport_acc_estimate,
)
from mansy_immersivevideostreaming_torch.sim.expert import (
    ExpertTables, attach_action_values, build_expert_tables, causal_bw_estimate,
    choose_action, deployable_etables,
)
from mansy_immersivevideostreaming_torch.utils.device import resolve_device
from mansy_immersivevideostreaming_torch.utils.prng import seed_everything


def tables_fingerprint(tables) -> str:
    """Content hash of the tables the profiling depends on (the JAX
    package's ``_tables_fingerprint``, so either package reads the other's
    cache)."""
    h = hashlib.sha256()
    for x in (tables.sizes, tables.qualities, tables.gt, tables.pred):
        a = x.cpu().numpy()
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def get_expert_tables(tables, cache_path: str, refresh: bool) -> ExpertTables:
    """Build the profiling tables, or load them from ``cache_path`` when its
    fingerprint and schema match (a pickle of numpy arrays)."""
    fp = tables_fingerprint(tables)
    if cache_path and os.path.exists(cache_path) and not refresh:
        with open(cache_path, "rb") as f:
            payload = pickle.load(f)
        if (isinstance(payload, dict) and payload.get("fingerprint") == fp
                and len(payload["tables"]) == len(ExpertTables._fields)):
            print("Load expert cache from", cache_path)
            return ExpertTables(*(torch.as_tensor(np.asarray(v), device=tables.device)
                                  for v in payload["tables"]))
        print("Expert cache stale (fingerprint or schema mismatch) — rebuilding")
    t0 = time.time()
    et = build_expert_tables(tables)
    print(f"Profiled expert tables in {time.time() - t0:.1f}s")
    if cache_path:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        with open(cache_path, "wb") as f:
            pickle.dump({"fingerprint": fp, "tables": [v.cpu().numpy() for v in et]}, f)
        print("Save expert cache at", cache_path)
    return et


def run_expert_episodes(tables, etables, samples, horizon: int,
                        lane_chunk: int = 64, collect_obs: bool = False,
                        causal: bool = False, acc_correct: bool = False):
    """Run each sample's episode once under the MPC expert.

    Returns a list, one entry per lane chunk, of (LogRecord [T, n],
    first-done mask [T, n], actions i32 [T, n], observation dict of [T, n,
    ...] tensors or None).  ``causal``: the harmonic-mean bandwidth estimate
    instead of the privileged trace walk; ``acc_correct``: the
    accuracy-corrected scores at each lane's own accuracy estimate.
    """
    n_steps = runner.episode_step_bound(tables)
    dims = obs_dims(tables)
    out = []
    for s0 in range(0, samples.shape[0], lane_chunk):
        sub = samples[s0:s0 + lane_chunk]
        n, dev = sub.shape[0], sub.device
        states = reset_env(tables, sub, torch.arange(n, dtype=torch.int32, device=dev), n)
        obs = (torch.empty((n_steps, n, obs_width(*dims)), dtype=torch.float32, device=dev)
               if collect_obs else None)
        actions, logs = [], []
        for t in range(n_steps):
            if collect_obs:
                observe_mansy_pack(tables, states, out=obs[t])
            bw_hat = causal_bw_estimate(tables, states) if causal else None
            acc_hat = viewport_acc_estimate(states.past_acc) if acc_correct else None
            action = choose_action(tables, etables, states, horizon, bw_hat, acc_hat)
            states, _, _, log = step_env(tables, sub, states, action, n, False)
            actions.append(action)
            logs.append(log)
        logs = stack_logs(logs)
        out.append((logs, runner.first_done_mask(logs.done.cpu().numpy()),
                    torch.stack(actions).cpu().numpy(),
                    unpack_obs(obs, *dims) if collect_obs else None))
    return out


def create_demonstrations(args, config, qoe_weights, models_dir, demos_dir,
                          cache_path, mode="train"):
    dev = resolve_device(args.device)
    log_path = os.path.join(models_dir, f"{mode}_log.csv")
    demo_path = os.path.join(demos_dir, f"{mode}_demonstrations.pkl")
    if os.path.exists(log_path):
        os.remove(log_path)
    tables, samples, videos, users, traces = runner.build_split(
        config, args.train_dataset, args.network_dataset, mode, qoe_weights, device=dev)
    if args.demo_samples and mode == "train":
        # a wider, stratified train grid (the valid set keeps the reference schedule)
        samples = torch.as_tensor(generate_demo_samples(
            len(videos), len(users), len(traces), len(qoe_weights), args.demo_samples,
            args.seed), device=dev)
    etables = get_expert_tables(tables, cache_path, args.refresh_cache)
    if args.exact_action_values:
        # demo observations carry the exact action-value field
        tables = attach_action_values(tables, etables,
                                      acc_correct=args.acc_correct or args.acc_correct_obs)
    if args.deployable_eval:
        etables = deployable_etables(etables)
    print("Total samples:", samples.shape[0])

    t0 = time.time()
    chunks = run_expert_episodes(tables, etables, samples, args.horizon,
                                 lane_chunk=args.lane_chunk, collect_obs=True,
                                 causal=args.causal_bw, acc_correct=args.acc_correct)
    host_samples = samples.cpu().numpy()
    demos, rows, offset = {}, [], 0
    for logs, first, actions, obs in chunks:
        obs = {k: v.cpu().numpy() for k, v in obs.items()}
        n = first.shape[1]
        for lane in range(n):
            ts = np.argwhere(first[:, lane])
            if len(ts) == 0:
                continue
            t_end = int(ts[0][0])
            sample = host_samples[offset + lane]
            key = (videos[sample[0]], users[sample[1]], traces[sample[2]],
                   tuple(int(w) for w in qoe_weights[sample[3]]))
            demos[key] = {"obs": {k: v[:t_end + 1, lane] for k, v in obs.items()},
                          "act": actions[:t_end + 1, lane]}
        rows.extend(runner.masked_log_rows([logs], [first], videos, users, traces,
                                           qoe_weights))
        offset += n
    runner.append_episode_logs(log_path, rows)
    os.makedirs(demos_dir, exist_ok=True)
    with open(demo_path, "wb") as f:
        pickle.dump(demos, f)
    print(f"Create {len(demos)} demonstrations, saved at {demo_path}, "
          f"cost {round((time.time() - t0) / 3600, 4)}h")


def test(args, config, qoe_weights, results_dir, cache_path):
    dev = resolve_device(args.device)
    log_path = os.path.join(results_dir, "results.csv")
    if os.path.exists(log_path):
        os.remove(log_path)
    tables, samples, videos, users, traces = runner.build_split(
        config, args.test_dataset, args.network_dataset, "test", qoe_weights,
        test_grid=True, device=dev)
    etables = get_expert_tables(tables, cache_path, args.refresh_cache)
    if args.deployable_eval:
        etables = deployable_etables(etables)
    t0 = time.time()
    chunks = run_expert_episodes(tables, etables, samples, args.horizon,
                                 lane_chunk=args.lane_chunk, causal=args.causal_bw,
                                 acc_correct=args.acc_correct)
    rows = []
    for logs, first, _, _ in chunks:
        rows.extend(runner.masked_log_rows([logs], [first], videos, users, traces,
                                           qoe_weights))
    runner.append_episode_logs(log_path, rows)
    print(f"Tested {len(rows)} episodes in {time.time() - t0:.1f}s")
    runner.read_log_file(log_path)
    return log_path


def run(args, config):
    seed_everything(args.seed)
    if args.qoe_train_ids is None:
        args.qoe_train_ids = list(range(len(config.qoe_split["train"])))
    split = "train" if args.test_on_seen else "test"
    if args.qoe_test_ids is None:
        args.qoe_test_ids = list(range(len(config.qoe_split[split])))

    models_dir = os.path.join(config.bs_models_dir, args.model,
                              args.train_dataset + "_" + args.network_dataset,
                              "qoe" + "_".join(map(str, args.qoe_train_ids)))
    seen = "seen" if args.test_on_seen else "unseen"
    results_dir = os.path.join(config.bs_results_dir, args.model,
                               args.test_dataset + "_" + args.network_dataset,
                               f"{seen}_qoe" + "_".join(map(str, args.qoe_test_ids)))
    train_cache = os.path.join(config.bs_models_dir, args.model,
                               f"{args.train_dataset}_cache.pkl")
    test_cache = os.path.join(config.bs_models_dir, args.model,
                              f"{args.test_dataset}_test_cache.pkl")
    os.makedirs(models_dir, exist_ok=True)
    os.makedirs(results_dir, exist_ok=True)

    if args.train:
        qoe_weights = [config.qoe_split["train"][i] for i in args.qoe_train_ids]
        print("Training QoE weights:", qoe_weights)
        create_demonstrations(args, config, qoe_weights, models_dir, models_dir,
                              train_cache, "train")
    if args.valid:
        qoe_weights = [config.qoe_split["valid"][i] for i in args.qoe_train_ids]
        print("Validating QoE weights:", qoe_weights)
        create_demonstrations(args, config, qoe_weights, models_dir, models_dir,
                              train_cache, "valid")
    if args.test:
        qoe_weights = [config.qoe_split[split][i] for i in args.qoe_test_ids]
        print("Testing QoE weights:", qoe_weights)
        return test(args, config, qoe_weights, results_dir, test_cache)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default="expert")
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--valid", action="store_true")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--test-on-seen", action="store_true")
    parser.add_argument("--train-dataset", type=str, default="Jin2022")
    parser.add_argument("--test-dataset", type=str, default="Jin2022")
    parser.add_argument("--network-dataset", type=str, default="4G")
    parser.add_argument("--qoe-train-ids", type=int, nargs="*")
    parser.add_argument("--qoe-test-ids", type=int, nargs="*")
    parser.add_argument("--proc-num", type=int, default=None,
                        help="accepted for reference-CLI compatibility "
                             "(episodes are lanes, not processes)")
    parser.add_argument("--lane-chunk", type=int, default=64,
                        help="episodes evaluated concurrently")
    parser.add_argument("--horizon", type=int, default=4)
    parser.add_argument("--causal-bw", action="store_true",
                        help="causal MPC: harmonic-mean bandwidth prediction "
                             "from observed throughput instead of the "
                             "privileged true future trace")
    parser.add_argument("--deployable-eval", action="store_true",
                        help="score the search on the deployable profiling "
                             "tables (pred-allocated AND pred-evaluated)")
    parser.add_argument("--acc-correct", action="store_true",
                        help="score the search with the accuracy-corrected "
                             "deployable estimate at each lane's observed "
                             "prediction accuracy")
    parser.add_argument("--acc-correct-obs", action="store_true",
                        help="accuracy-correct only the action-value field "
                             "recorded in demos")
    parser.add_argument("--exact-action-values", action="store_true",
                        help="record the exact one-step action-value field "
                             "in demos (sim.env.exact_action_values)")
    parser.add_argument("--demo-samples", type=int, default=0,
                        help="widen the train demo grid to this many "
                             "stratified episodes (0 = reference schedule)")
    parser.add_argument("--refresh-cache", action="store_true")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--config-yml", type=str, default=None)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    print(args)
    return run(args, load_config(args.config_yml))


if __name__ == "__main__":
    main()
