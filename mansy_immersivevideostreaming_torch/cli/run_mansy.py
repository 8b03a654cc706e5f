"""MANSY policy testing CLI (the ``--test`` path of the JAX package's
``cli/run_mansy.py``).

Restores a policy from its ``.npz`` (see ``utils/checkpoint.py``) and
evaluates it over the test grid of the dataset tree, writing the
reference-format ``results.csv`` and printing its summary table.  The
policy's sidecar decides the observation, as the JAX CLI's
``apply_net_config`` does: a policy that reads the exact action values (such
as ``assets/dagger_v16_params.npz``) gets the expert's deployable tables
attached, accuracy-corrected when the sidecar says ``acc_correct_obs``.
Training (PPO, identifier, DAgger) is not ported yet.

Example::

    python -m mansy_immersivevideostreaming_torch.cli.run_mansy --test \
        --policy-path mansy_immersivevideostreaming_torch/assets/dagger_v9_params.npz \
        --deterministic-eval --qoe-test-ids 0 1 2 3 --test-on-seen --seed 5
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from mansy_immersivevideostreaming_torch.cli.run_expert import get_expert_tables
from mansy_immersivevideostreaming_torch.config import load_config
from mansy_immersivevideostreaming_torch.rl import runner
from mansy_immersivevideostreaming_torch.sim.expert import attach_action_values
from mansy_immersivevideostreaming_torch.utils.checkpoint import DAGGER_V9_NPZ, load_npz_policy
from mansy_immersivevideostreaming_torch.utils.device import resolve_device


def results_dir_for(args, config) -> str:
    seen = "seen" if args.test_on_seen else "unseen"
    policy = os.path.splitext(os.path.basename(args.policy_path))[0]
    return os.path.join(
        config.bs_results_dir, args.model,
        args.test_dataset + "_" + args.network_dataset,
        f"{seen}_qoe" + "_".join(map(str, args.qoe_test_ids)), policy)


def test(args, config, results_dir: str):
    dev = resolve_device(args.device)
    test_log_path = os.path.join(results_dir, "results.csv")
    if os.path.exists(test_log_path):
        os.remove(test_log_path)
    split = "train" if args.test_on_seen else "test"
    qoe_weights = [config.qoe_split[split][i] for i in args.qoe_test_ids]
    print("Testing QoE weights:", qoe_weights)
    tables, samples, videos, users, traces = runner.build_split(
        config, args.test_dataset, args.network_dataset, "test", qoe_weights,
        test_grid=True, device=dev)
    policy = load_npz_policy(args.policy_path, device=dev)
    print("Successfully loaded agent from:", args.policy_path)
    if policy.reads_action_values:
        cache = os.path.join(config.bs_models_dir, "expert",
                             f"{args.test_dataset}_test_avcache0.pkl")
        tables = attach_action_values(tables, get_expert_tables(tables, cache, False),
                                      acc_correct=policy.acc_correct_obs)
    generator = torch.Generator(device=dev)
    generator.manual_seed(args.seed)
    t0 = time.time()
    logs, masks = runner.evaluate(policy, tables, samples, generator,
                                  deterministic=args.deterministic_eval)
    n_eps = int(sum(m.sum() for m in masks))
    print(f"Tested {n_eps} episodes in {time.time() - t0:.1f}s")
    rows = runner.masked_log_rows(logs, masks, videos, users, traces, qoe_weights)
    runner.append_episode_logs(test_log_path, rows)
    runner.read_log_file(test_log_path)
    print("Results saved at:", test_log_path)
    return test_log_path


def run(args, config):
    if not args.test:
        raise SystemExit("run_mansy: only --test is ported; training comes in a later port")
    split = "train" if args.test_on_seen else "test"
    if args.qoe_test_ids is None:
        args.qoe_test_ids = list(range(len(config.qoe_split[split])))
    results_dir = args.results_dir or results_dir_for(args, config)
    os.makedirs(results_dir, exist_ok=True)
    return test(args, config, results_dir)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--seed", type=int, default=5)
    parser.add_argument("--model", type=str, default="mansy")
    parser.add_argument("--policy-path", type=str, default=str(DAGGER_V9_NPZ),
                        help="policy .npz with its .netcfg.json sidecar")
    parser.add_argument("--deterministic-eval", action="store_true",
                        help="argmax actions at test time (tianshou "
                             "deterministic_eval; reference default samples)")
    parser.add_argument("--test-on-seen", action="store_true")
    parser.add_argument("--test-dataset", type=str, default="Jin2022")
    parser.add_argument("--network-dataset", type=str, default="4G")
    parser.add_argument("--qoe-test-ids", type=int, nargs="*")
    parser.add_argument("--results-dir", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--config-yml", type=str, default=None)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    print(args)
    return run(args, load_config(args.config_yml))


if __name__ == "__main__":
    main()
