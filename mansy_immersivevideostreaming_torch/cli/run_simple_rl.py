"""simple_rl (A2C) baseline CLI.

Port of the JAX package's ``cli/run_simple_rl.py`` (reference
``bitrate_selection/run_simple_rl.py``): A2C over the 5-field simple_rl
observation, one QoE preference per run (``--qoe-train-id``), RMSprop; the
same flags, file names (``.npz`` for ``.ckpt``), console lines and CSV logs.
``--train`` collects rollouts over N lanes (K2's simple mode -> K3 -> K1 a
step, K3 on ``SimpleActorCritic``'s five branches) and runs the A2C update
(K6, then per minibatch K3's training mode -> K9 in A2C mode -> K10 ->
RMSprop); each epoch evaluates the valid split with sampled actions, as the
JAX CLI does.  ``--test`` evaluates ``<prefix>_best_policy.npz`` over the
test grid (``--deterministic-eval`` takes the argmax).  Each epoch writes
the JAX CLI's TensorBoard scalars (``train/reward`` and the update's
metrics) under ``<prefix>_tb`` where ``tensorboardX`` imports, and the
console line carries them too: JAX's line (the valid mean return and the
loss) with the loss's three terms appended.

Example::

    python -m mansy_immersivevideostreaming_torch.cli.run_simple_rl --train --test \\
        --qoe-train-id 0 --qoe-test-ids 0 1 2 3 --test-on-seen --deterministic-eval
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from mansy_immersivevideostreaming_torch.config import load_config
from mansy_immersivevideostreaming_torch.models.abr_nets import SimpleActorCritic
from mansy_immersivevideostreaming_torch.rl import a2c as a2c_mod
from mansy_immersivevideostreaming_torch.rl import runner
from mansy_immersivevideostreaming_torch.rl.rollout import init_lanes, make_collector
from mansy_immersivevideostreaming_torch.rl.types import RunningStat
from mansy_immersivevideostreaming_torch.utils.checkpoint import load_npz_into, save_npz
from mansy_immersivevideostreaming_torch.utils.device import resolve_device
from mansy_immersivevideostreaming_torch.utils.logging import ConsoleLogger, tb_writer
from mansy_immersivevideostreaming_torch.utils.prng import seed_everything


def a2c_config(args) -> a2c_mod.A2CConfig:
    """The A2C hyperparameters of the command line."""
    return a2c_mod.A2CConfig(
        gamma=args.gamma, gae_lambda=args.gae_lambda, vf_coef=args.vf_coef,
        ent_coef=args.ent_coef, max_grad_norm=args.max_grad_norm,
        rew_norm=bool(args.rew_norm), minibatch=args.batch_size,
        repeat=args.repeat_per_collect)


def a2c_round(policy, optimizer, cfg, collect, states, ret_rms, generator):
    """One collect (K2's simple mode -> K3 -> K1 a step) and its A2C update.
    Returns (states, ret_rms, episode logs, the update's metrics)."""
    states, traj, logs, last_values = collect(policy, states, generator)
    ret_rms, metrics = a2c_mod.a2c_update(policy, optimizer, cfg, traj, last_values, ret_rms,
                                          generator)
    return states, ret_rms, logs, metrics


def train(args, config, models_dir: str, file_prefix: str):
    dev = resolve_device(args.device)
    train_log_path = os.path.join(models_dir, file_prefix + "_train_log.csv")
    valid_log_path = os.path.join(models_dir, file_prefix + "_valid_log.csv")
    for p in (train_log_path, valid_log_path):
        if os.path.exists(p):
            os.remove(p)

    qoe_weights = [config.qoe_split["train"][args.qoe_train_id]]
    print("Training QoE weights:", qoe_weights)
    tables, samples, videos, users, traces = runner.build_split(
        config, args.train_dataset, args.network_dataset, "train", qoe_weights, device=dev)
    vtables, vsamples, vvideos, vusers, vtraces = runner.build_split(
        config, args.train_dataset, args.network_dataset, "valid", qoe_weights, device=dev)

    generator = seed_everything(args.seed, dev)
    policy = SimpleActorCritic(action_space=config.action_space, device=dev)
    optimizer = a2c_mod.make_optimizer(policy.parameters(), args.lr)
    cfg = a2c_config(args)

    n_lanes = args.train_lanes
    n_steps = max(args.step_per_collect // n_lanes, 1)
    collect = make_collector(tables, samples, n_lanes, n_steps, train=True)
    states = init_lanes(tables, samples, n_lanes, args.seed)
    ret_rms = RunningStat.init(dev)

    checkpoint_path = os.path.join(models_dir, file_prefix + "_checkpoint.npz")
    best_policy_path = os.path.join(models_dir, file_prefix + "_best_policy.npz")
    writer = tb_writer(os.path.join(models_dir, file_prefix + "_tb"))

    best_reward = float("-inf")
    env_step = 0
    collects_per_epoch = max(args.step_per_epoch // (n_lanes * n_steps), 1)
    for epoch in range(1, args.epochs + 1):
        t0 = time.time()
        for _ in range(collects_per_epoch):
            states, ret_rms, logs, metrics = a2c_round(policy, optimizer, cfg, collect, states,
                                                       ret_rms, generator)
            env_step += n_lanes * n_steps
            runner.append_episode_logs(
                train_log_path,
                runner.episode_log_rows(logs, videos, users, traces, qoe_weights))

        vlogs, vmasks = runner.evaluate(policy, vtables, vsamples, generator)
        runner.append_episode_logs(
            valid_log_path,
            runner.masked_log_rows(vlogs, vmasks, vvideos, vusers, vtraces, qoe_weights))
        rets = np.concatenate([l.ret.cpu().numpy()[m] for l, m in zip(vlogs, vmasks)])
        mean_reward = float(rets.mean())
        if epoch % 4 == 0:
            save_npz(checkpoint_path, policy)
        if mean_reward > best_reward:
            best_reward = mean_reward
            save_npz(best_policy_path, policy)
        dt = time.time() - t0
        print(f"Epoch: {epoch} | env_step {env_step} | "
              f"{collects_per_epoch * n_lanes * n_steps / dt:,.0f} env-steps/s | "
              f"valid mean return {mean_reward:.4f} (best {best_reward:.4f}) | "
              f"loss {float(metrics['loss']):.4f} (actor {float(metrics['loss/actor']):.4f}, "
              f"vf {float(metrics['loss/vf']):.4f}, ent {float(metrics['loss/ent']):.4f})")
        if writer is not None:
            writer.add_scalar("train/reward", mean_reward, env_step)
            for k, v in metrics.items():
                writer.add_scalar(k, float(v), env_step)
        if mean_reward >= args.reward_threshold:
            break
    if writer is not None:
        writer.close()
    return policy


def test(args, config, models_dir: str, results_dir: str, file_prefix: str):
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

    policy = SimpleActorCritic(action_space=config.action_space, device=dev)
    policy_path = os.path.join(models_dir, file_prefix + "_best_policy.npz")
    if not os.path.exists(policy_path):
        raise FileExistsError(f"File not exist: {policy_path}")
    load_npz_into(policy, policy_path)
    print("Successfully loaded agent from:", policy_path)
    generator = seed_everything(args.seed, dev)

    logs, masks = runner.evaluate(policy, tables, samples, generator,
                                  deterministic=args.deterministic_eval)
    rows = runner.masked_log_rows(logs, masks, videos, users, traces, qoe_weights)
    runner.append_episode_logs(test_log_path, rows)
    runner.read_log_file(test_log_path)
    print("Results saved at:", test_log_path)
    return test_log_path


def run(args, config):
    if args.qoe_train_id is None:
        raise SystemExit("run_simple_rl: --qoe-train-id is required")
    split = "train" if args.test_on_seen else "test"
    if args.qoe_test_ids is None:
        args.qoe_test_ids = list(range(len(config.qoe_split[split])))

    models_dir = os.path.join(config.bs_models_dir, args.model,
                              args.train_dataset + "_" + args.network_dataset,
                              f"qoe{args.qoe_train_id}")
    seen = "seen" if args.test_on_seen else "unseen"
    results_dir = os.path.join(config.bs_results_dir, args.model,
                               args.test_dataset + "_" + args.network_dataset,
                               f"{seen}_qoe" + "_".join(map(str, args.qoe_test_ids)))
    os.makedirs(models_dir, exist_ok=True)
    os.makedirs(results_dir, exist_ok=True)

    file_prefix = (f"epochs_{args.epochs}_bs_{args.batch_size}_lr_{args.lr}_"
                   f"gamma_{args.gamma}_seed_{args.seed}_ent_{args.ent_coef}")
    result = None
    if args.train:
        stdout = sys.stdout
        with open(os.path.join(models_dir, file_prefix + "console.log"), "w") as console_log:
            sys.stdout = ConsoleLogger(stdout, console_log)
            try:
                train(args, config, models_dir, file_prefix)
            finally:
                sys.stdout = stdout
    if args.test:
        result = test(args, config, models_dir, results_dir, file_prefix)
    return result


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--task", type=str, default="simple_rl")
    parser.add_argument("--reward-threshold", type=float, default=500000.0)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--buffer-size", type=int, default=1000000)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--gamma", type=float, default=0.99)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--step-per-epoch", type=int, default=6000)
    parser.add_argument("--step-per-collect", type=int, default=2048)
    parser.add_argument("--repeat-per-collect", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--train-lanes", type=int, default=128,
                        help="parallel env lanes (replaces SubprocVectorEnv x10)")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--vf-coef", type=float, default=0.5)
    parser.add_argument("--ent-coef", type=float, default=0.01)
    parser.add_argument("--max-grad-norm", type=float, default=1)
    parser.add_argument("--gae-lambda", type=float, default=0.95)
    parser.add_argument("--rew-norm", type=int, default=1)
    parser.add_argument("--bound-action-method", type=str, default="clip")
    parser.add_argument("--model", type=str, default="simple_rl")
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--test-on-seen", action="store_true")
    parser.add_argument("--train-dataset", type=str, default="Jin2022")
    parser.add_argument("--test-dataset", type=str, default="Jin2022")
    parser.add_argument("--network-dataset", type=str, default="4G")
    parser.add_argument("--qoe-train-id", type=int)
    parser.add_argument("--qoe-test-ids", type=int, nargs="*")
    parser.add_argument("--deterministic-eval", action="store_true",
                        help="argmax actions at test time (tianshou "
                             "deterministic_eval; reference default samples)")
    parser.add_argument("--config-yml", type=str, default=None)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    print(args)
    return run(args, load_config(args.config_yml))


if __name__ == "__main__":
    main()
