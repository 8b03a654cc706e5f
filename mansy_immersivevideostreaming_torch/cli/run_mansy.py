"""MANSY training and testing CLI (PPO + QoE-preference identifier).

Port of the JAX package's ``cli/run_mansy.py`` (reference
``bitrate_selection/run_mansy.py``): the same flags, hyperparameters,
directory layout and CSV logs.  ``--train`` collects rollouts over N lanes
(K2 -> K3 -> K1 a step), trains the identifier on the fresh buffer and
shapes the rewards with it, and runs the PPO update (K6, then per minibatch
K3's training mode -> K9 -> K10); ``--bc``, ``--pretrain-identifier``,
``--init-path`` with the KL anchor (``--bc-kl``, ``--bc-kl-per-pref``),
``--norm-adv-per-pref``, ``--exact-action-values``, ``--obs-action-values``
and ``--av-logit-prior`` are ported (without ``--exact-action-values`` the
policy reads the derived action values: K2's derived mode a step, its row
mode on the ``--bc`` demos).  Policies
and identifiers are written as Flax-keyed ``.npz`` files with the policy's
``.netcfg.json`` sidecar (``utils/checkpoint.py``), which the JAX package's
nets load too; the console log, the CSV logs and the TensorBoard scalars
(``train/reward`` and the update's metrics each epoch, under
``mansy_tb_logger``, where ``tensorboardX`` imports) are the JAX CLI's.
``--test`` evaluates a policy over the test
grid (by default the ``best_policy.npz`` that ``--train`` wrote); the
sidecar decides the observation, as the JAX CLI's ``apply_net_config`` does.

``--data-parallel`` is read as the JAX CLI reads it: ``--test`` ignores it,
and ``--train`` on one device runs as without it.  Over more devices the
run is one rank a device (``parallel/launch.py`` starts them, or torchrun
does): the env lanes split over the ranks, each collects its lanes, the
trajectory is gathered and the PPO update's minibatch steps split over the
ranks (``rl/rollout.py``, ``rl/ppo.py``); the identifier trains on the
whole buffer on every rank.  Rank 0 alone validates and writes the logs,
checkpoints and console; the others wait for its validation's result.

Examples::

    python -m mansy_immersivevideostreaming_torch.cli.run_mansy --train --test \\
        --epochs 1000 --step-per-epoch 4096 --lr 5e-4 --batch-size 512 \\
        --qoe-test-ids 0 1 2 3 --test-on-seen --lamb 0.5 --train-identifier \\
        --use-identifier --gamma 0.95 --ent-coef 0.02 --seed 5
    python -m mansy_immersivevideostreaming_torch.cli.run_mansy --test \\
        --policy-path mansy_immersivevideostreaming_torch/assets/dagger_v9_params.npz \\
        --deterministic-eval --qoe-test-ids 0 1 2 3 --test-on-seen --seed 5
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

from mansy_immersivevideostreaming_torch.cli.run_expert import get_expert_tables
from mansy_immersivevideostreaming_torch.config import load_config
from mansy_immersivevideostreaming_torch.kernels.actor_critic import actor_critic_forward
from mansy_immersivevideostreaming_torch.models.abr_nets import MansyActorCritic, QoEIdentifier
from mansy_immersivevideostreaming_torch.parallel import launch
from mansy_immersivevideostreaming_torch.parallel.mesh import (
    Mesh, broadcast_object, replicate, shutdown,
)
from mansy_immersivevideostreaming_torch.rl import ppo as ppo_mod
from mansy_immersivevideostreaming_torch.rl import runner
from mansy_immersivevideostreaming_torch.rl.identifier import (
    center_rewards_by_preference, identifier_rewards, shape_rewards,
    train_identifier_on_buffer,
)
from mansy_immersivevideostreaming_torch.rl.rollout import init_lanes, make_collector
from mansy_immersivevideostreaming_torch.rl.types import RunningStat
from mansy_immersivevideostreaming_torch.sim.expert import attach_action_values
from mansy_immersivevideostreaming_torch.utils.checkpoint import (
    load_npz_into, load_npz_policy, save_net_config, save_npz,
)
from mansy_immersivevideostreaming_torch.utils.device import check_data_parallel, resolve_device
from mansy_immersivevideostreaming_torch.utils.logging import ConsoleLogger, tb_writer
from mansy_immersivevideostreaming_torch.utils.prng import seed_everything


def policy_net_config(args) -> dict:
    """The net/obs construction flags a policy was trained under, for its
    ``.netcfg.json`` sidecar."""
    return {"hidden_dim": int(args.hidden_dim),
            "obs_action_values": bool(args.obs_action_values),
            "exact_action_values": bool(args.exact_action_values),
            "av_logit_prior": float(args.av_logit_prior),
            "acc_correct_obs": bool(args.acc_correct)}


def attach_exact_action_values(config, dataset: str, *tables_list, acc_correct=False):
    """Attach the deployable per-action profiling tables (K5, or the
    expert-table cache either package writes) so the observation carries the
    exact ``action_values`` field."""
    cache_dir = os.path.join(config.bs_models_dir, "expert")
    return [attach_action_values(
        t, get_expert_tables(t, os.path.join(cache_dir, f"{dataset}_avcache{i}.pkl"), False),
        acc_correct=acc_correct) for i, t in enumerate(tables_list)]


def interp_preferences(qoe_weights, n: int, alpha: float, seed: int):
    """``qoe_weights`` plus ``n`` random convex combinations of them
    (preference-interpolation augmentation), the JAX CLIs' draws."""
    if n <= 0:
        return list(qoe_weights)
    rng = np.random.default_rng(seed)
    base = np.asarray(qoe_weights, np.float64)
    coef = rng.dirichlet(np.full(len(qoe_weights), alpha), size=n)
    return list(qoe_weights) + [[float(x) for x in np.round(c @ base, 4)] for c in coef]


def demos_dir(args, config) -> str:
    return os.path.join(config.bs_models_dir, "expert",
                        args.train_dataset + "_" + args.network_dataset,
                        "qoe" + "_".join(map(str, args.qoe_train_ids)))


def ppo_config(args, n_prefs: int) -> ppo_mod.PPOConfig:
    """The PPO hyperparameters of the command line."""
    return ppo_mod.PPOConfig(
        gamma=args.gamma, gae_lambda=args.gae_lambda, eps_clip=args.eps_clip,
        vf_coef=args.vf_coef, ent_coef=args.ent_coef, max_grad_norm=args.max_grad_norm,
        value_clip=bool(args.value_clip), norm_adv=bool(args.norm_adv),
        rew_norm=bool(args.rew_norm), repeat=args.repeat_per_collect,
        minibatch=args.batch_size, norm_adv_per_pref=bool(args.norm_adv_per_pref),
        n_prefs=n_prefs)


def ppo_round(args, policy, identifier, optimizer, id_optimizer, cfg, collect, states,
              ret_rms, generator, ent_coef: float, lamb: float, prefs, anchor=None,
              mesh: Mesh | None = None):
    """One collect and its updates, as ``--train`` runs them: the rollout
    (K2 -> K3 -> K1 a step), the identifier's training on the fresh buffer
    (``--train-identifier``), the identifier's reward shaping
    (``--use-identifier``, ``--id-reward-center`` against the normalized
    training preferences ``prefs`` [K, 3]) and the PPO update, with the KL
    to the frozen ``anchor`` weights when given.  With a sharded ``mesh``
    the collector is the mesh's (it returns every lane's trajectory) and
    the update's minibatch steps split over the ranks.  Returns (states,
    ret_rms, episode logs, the update's metrics)."""
    states, traj, logs, last_values = collect(policy, states, generator)
    x = traj.obs.reshape(-1, traj.obs.shape[-1])
    if args.train_identifier:
        id_losses, id_valid = train_identifier_on_buffer(
            identifier, id_optimizer, x, generator, args.identifier_update_round)
        print("identifier loss:", [round(float(l), 6) for l in id_losses.tolist()],
              "valid:", round(float(id_valid), 6))

    rewards = traj.reward
    if args.use_identifier:
        id_rew = identifier_rewards(identifier, x).reshape(rewards.shape)
        if args.id_reward_center:
            id_rew = center_rewards_by_preference(
                id_rew, identifier.target(x).reshape(rewards.shape + (-1,)), prefs)
        rewards = shape_rewards(rewards, id_rew, lamb)

    anchor_logits = None
    if anchor is not None:
        anchor_logits = actor_critic_forward(anchor, x)[0].reshape(rewards.shape + (-1,))
    kl_coef = args.bc_kl_per_pref if args.bc_kl_per_pref is not None else args.bc_kl
    per_pref_ids = args.norm_adv_per_pref or args.bc_kl_per_pref is not None
    ret_rms, metrics = ppo_mod.ppo_update(
        policy, optimizer, cfg, traj, rewards, last_values, ret_rms, generator, ent_coef,
        anchor_logits=anchor_logits, kl_coef=kl_coef,
        pref_ids=logs.qoe_id if per_pref_ids else None, mesh=mesh)
    return states, ret_rms, logs, metrics


def train(args, config, models_dir: str, mesh: Mesh | None = None):
    """``--train``; with a sharded ``mesh``, this rank's part of it (see the
    module docstring)."""
    # Imported here: the demo loaders serve only these options.
    from mansy_immersivevideostreaming_torch.data.tianshou_compat import load_demonstrations

    dev = resolve_device(args.device) if mesh is None else mesh.device
    main = mesh is None or mesh.is_main
    train_log_path = os.path.join(models_dir, "train_log.csv")
    valid_log_path = os.path.join(models_dir, "valid_log.csv")
    for p in (train_log_path, valid_log_path):
        if main and os.path.exists(p):
            os.remove(p)

    base_qoe_weights = [config.qoe_split["train"][i] for i in args.qoe_train_ids]
    qoe_weights = interp_preferences(base_qoe_weights, args.pref_interp,
                                     args.pref_interp_alpha, args.seed)
    print("Training QoE weights:", qoe_weights)
    tables, samples, videos, users, traces = runner.build_split(
        config, args.train_dataset, args.network_dataset, "train", qoe_weights, device=dev)
    # the valid split keeps the base preferences, so valid returns stay
    # comparable across runs with and without interpolation
    vtables, vsamples, vvideos, vusers, vtraces = runner.build_split(
        config, args.train_dataset, args.network_dataset, "valid", base_qoe_weights, device=dev)
    if args.exact_action_values:
        tables, vtables = attach_exact_action_values(config, args.train_dataset, tables,
                                                     vtables, acc_correct=args.acc_correct)

    generator = seed_everything(args.seed, dev)
    policy = MansyActorCritic(hidden_dim=args.hidden_dim, action_space=config.action_space,
                              use_action_values=args.obs_action_values or args.exact_action_values,
                              av_logit_prior=args.av_logit_prior, device=dev)
    policy.exact_action_values = args.exact_action_values
    identifier = QoEIdentifier(hidden_dim=args.hidden_dim, action_space=config.action_space,
                               device=dev)
    optimizer = ppo_mod.make_optimizer(policy.parameters(), args.lr, args.weight_decay)
    id_optimizer = ppo_mod.make_optimizer(identifier.parameters(), args.identifier_lr,
                                          args.weight_decay)
    cfg = ppo_config(args, len(qoe_weights))

    n_lanes = args.train_lanes
    n_steps = max(args.step_per_collect // n_lanes, 1)
    collect = make_collector(tables, samples, n_lanes, n_steps, train=True, mesh=mesh)
    states = init_lanes(tables, samples, n_lanes, args.seed, mesh)
    ret_rms = RunningStat.init(dev)

    checkpoint_path = os.path.join(models_dir, "checkpoint.npz")
    id_checkpoint_path = os.path.join(models_dir, "identifier_checkpoint.npz")
    best_policy_path = os.path.join(models_dir, "best_policy.npz")
    best_identifier_path = os.path.join(models_dir, "best_identifier.npz")
    bc_file_prefix = (f"bc_ms_{args.bc_max_steps}_ims_{args.bc_identifier_max_steps}"
                      f"_ilr_{args.identifier_lr}_iur_{args.identifier_update_round}")
    policy_bc_path = os.path.join(models_dir, bc_file_prefix + "_policy.npz")
    identifier_bc_path = os.path.join(models_dir, bc_file_prefix + "_identifier.npz")
    save = save_npz if main else lambda path, module: None
    for p in (checkpoint_path, best_policy_path) + ((policy_bc_path,) if args.bc else ()):
        if main:  # rank 0 alone writes
            save_net_config(p, policy_net_config(args))

    if args.bc:
        # behavior-cloning initialization from expert demos (reference
        # run_mansy.py:260-274)
        from mansy_immersivevideostreaming_torch.rl.bc import behavior_cloning_pretraining
        train_path = os.path.join(demos_dir(args, config), "train_demonstrations.pkl")
        valid_path = os.path.join(demos_dir(args, config), "valid_demonstrations.pkl")
        if not (os.path.exists(train_path) and os.path.exists(valid_path)):
            raise FileNotFoundError(f"--bc needs {train_path} and {valid_path}")
        behavior_cloning_pretraining(
            policy, optimizer, identifier, id_optimizer,
            list(load_demonstrations(train_path).values()),
            list(load_demonstrations(valid_path).values()), args.bc_max_steps,
            args.bc_valid_per_step, args.bc_identifier_max_steps,
            args.identifier_update_round, args.seed,
            save_policy=lambda p: save(policy_bc_path, p),
            save_identifier=lambda p: save(identifier_bc_path, p), generator=generator)

    if args.pretrain_identifier > 0:
        # the identifier pre-trained on the expert-demo grid before PPO
        # starts, so the shaping signal is informative from the first step
        from mansy_immersivevideostreaming_torch.rl.dagger import flatten_demos
        from mansy_immersivevideostreaming_torch.rl.identifier import (
            pretrain_identifier_on_demos)
        path = args.pretrain_demos_path or os.path.join(demos_dir(args, config),
                                                        "train_demonstrations.pkl")
        demo_x, _ = flatten_demos(list(load_demonstrations(path).values()), dev)
        pre_losses, pre_valid = pretrain_identifier_on_demos(
            identifier, id_optimizer, demo_x, args.pretrain_identifier, 4096, generator)
        print(f"Identifier pretrained on {demo_x.shape[0]} demo transitions "
              f"({args.pretrain_identifier} steps): mse {pre_losses[0]:.5f} -> "
              f"{pre_losses[-1]:.5f}, valid {pre_valid:.5f}")

    anchor = None
    if args.resume:
        if os.path.exists(checkpoint_path):
            load_npz_into(policy, checkpoint_path)
            print("Successfully loaded agent from:", checkpoint_path)
        if os.path.exists(id_checkpoint_path):
            load_npz_into(identifier, id_checkpoint_path)
            print("Successfully loaded identifier from:", id_checkpoint_path)
    elif args.init_path:
        # a warm start (e.g. a DAgger policy); with --bc-kl also the frozen
        # KL anchor
        load_npz_into(policy, args.init_path)
        print("Successfully init agent from:", args.init_path)
        if args.bc_kl > 0 or args.bc_kl_per_pref is not None:
            anchor = policy.packed_weights()
            print(f"KL anchor enabled (coef {args.bc_kl_per_pref or args.bc_kl})")
    elif args.init_from_bc:
        if os.path.exists(policy_bc_path):
            load_npz_into(policy, policy_bc_path)
            print("Successfully init agent from behavior cloning:", policy_bc_path)
            if args.bc_kl > 0 or args.bc_kl_per_pref is not None:
                anchor = policy.packed_weights()
                print(f"KL-to-BC anchor enabled (coef {args.bc_kl_per_pref or args.bc_kl})")
        if os.path.exists(identifier_bc_path):
            load_npz_into(identifier, identifier_bc_path)
            print("Successfully init identifier from behavior cloning:", identifier_bc_path)

    if mesh is not None:
        for module in (policy, identifier):
            replicate(mesh, module)
    writer = tb_writer(os.path.join(models_dir, "mansy_tb_logger")) if main else None
    prefs = torch.tensor(np.asarray([np.asarray(w) / np.sum(w) for w in qoe_weights]),
                         dtype=torch.float32, device=dev)
    collects_per_epoch = max(args.step_per_epoch // (n_lanes * n_steps), 1)
    best_reward = float("-inf")
    env_step = 0
    for epoch in range(1, args.epochs + 1):
        # optional entropy annealing: linear from --ent-coef to --ent-final
        if args.ent_final is not None:
            frac = (epoch - 1) / max(args.epochs - 1, 1)
            ent_coef = args.ent_coef + frac * (args.ent_final - args.ent_coef)
        else:
            ent_coef = args.ent_coef
        # optional λ warm-up: the identifier shaping ramps in over --lamb-warmup epochs
        lamb = args.lamb * min((epoch - 1) / args.lamb_warmup, 1.0) if args.lamb_warmup > 0 \
            else args.lamb
        t0 = time.time()
        metrics = {}
        for _ in range(collects_per_epoch):
            states, ret_rms, logs, metrics = ppo_round(
                args, policy, identifier, optimizer, id_optimizer, cfg, collect, states,
                ret_rms, generator, ent_coef, lamb, prefs, anchor, mesh)
            env_step += n_lanes * n_steps
            if main:
                runner.append_episode_logs(
                    train_log_path, runner.episode_log_rows(logs, videos, users, traces,
                                                            qoe_weights))

        # validation over the valid split (reference run_mansy.py:117-136); over
        # ranks, rank 0's: its result and its generator's state go to every rank
        valid = None
        if main:
            vlogs, vmasks = runner.evaluate(policy, vtables, vsamples, generator,
                                            deterministic=args.deterministic_eval)
            runner.append_episode_logs(valid_log_path, runner.masked_log_rows(
                vlogs, vmasks, vvideos, vusers, vtraces, base_qoe_weights))
            rets = np.concatenate([l.ret.cpu().numpy()[m] for l, m in zip(vlogs, vmasks)])
            vqids = np.concatenate([l.qoe_id.cpu().numpy()[m] for l, m in zip(vlogs, vmasks)])
            valid = (float(rets.mean()), " ".join(f"q{q}:{float(rets[vqids == q].mean()):.2f}"
                                                  for q in sorted(set(vqids.tolist()))))
        if mesh is not None:
            valid, gen_state = broadcast_object(mesh, (valid, generator.get_state()))
            generator.set_state(gen_state)
        mean_reward, per_pref = valid

        if epoch % max(args.save_interval, 1) == 0:
            # periodic checkpoint (reference save_interval, run_mansy.py:313)
            save(checkpoint_path, policy)
            save(id_checkpoint_path, identifier)
        if mean_reward > best_reward:
            best_reward = mean_reward
            save(best_policy_path, policy)
            save(best_identifier_path, identifier)
            print("=" * 68)
            print("Best policy save at " + best_policy_path)
            print("Best identifier save at " + best_identifier_path)
            print("=" * 68)

        dt = time.time() - t0
        print(f"Epoch: {epoch} | env_step {env_step} | "
              f"{collects_per_epoch * n_lanes * n_steps / dt:,.0f} env-steps/s | "
              f"valid mean return {mean_reward:.4f} [{per_pref}] (best {best_reward:.4f})")
        if metrics:
            print("loss:", float(metrics["loss"]), " --- ",
                  "loss/clip:", float(metrics["loss/clip"]), " --- ",
                  "loss/vf:", float(metrics["loss/vf"]), " --- ",
                  "loss/ent:", float(metrics["loss/ent"]))
        if writer is not None:
            writer.add_scalar("train/reward", mean_reward, env_step)
            for k, v in metrics.items():
                writer.add_scalar(k, float(v), env_step)
        if mean_reward >= args.reward_threshold:
            break
    if writer is not None:
        writer.close()
    return policy, identifier


def test(args, config, models_dir: str, results_dir: str):
    dev = resolve_device(args.device)
    test_log_path = os.path.join(results_dir, "results.csv")
    if os.path.exists(test_log_path):
        os.remove(test_log_path)
    policy_path = args.policy_path or os.path.join(models_dir, "best_policy.npz")
    if not os.path.exists(policy_path):
        raise FileNotFoundError(f"File not exist: {policy_path}")
    split = "train" if args.test_on_seen else "test"
    qoe_weights = [config.qoe_split[split][i] for i in args.qoe_test_ids]
    print("Testing QoE weights:", qoe_weights)
    tables, samples, videos, users, traces = runner.build_split(
        config, args.test_dataset, args.network_dataset, "test", qoe_weights,
        test_grid=True, device=dev)
    policy = load_npz_policy(policy_path, device=dev)
    print("Successfully loaded agent from:", policy_path)
    if policy.exact_action_values:
        tables, = attach_exact_action_values(config, args.test_dataset + "_test", tables,
                                             acc_correct=policy.acc_correct_obs)
    generator = seed_everything(args.seed, dev)
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
    world = check_data_parallel(args)
    if world > 1 and not launch.launched():
        return launch.launch_ranks("run_mansy", args, config, world)
    if args.qoe_train_ids is None:
        args.qoe_train_ids = list(range(len(config.qoe_split["train"])))
    split = "train" if args.test_on_seen else "test"
    if args.qoe_test_ids is None:
        args.qoe_test_ids = list(range(len(config.qoe_split[split])))

    prefix = (f"epochs_{args.epochs}_bs_{args.batch_size}_lr_{args.lr}_"
              f"gamma_{args.gamma}_seed_{args.seed}_ent_{args.ent_coef}_"
              f"useid_{args.use_identifier}_lambda_{args.lamb}_"
              f"ilr_{args.identifier_lr}_iur_{args.identifier_update_round}_"
              f"bc_{args.bc or args.init_from_bc}")
    models_dir = os.path.join(config.bs_models_dir, args.model,
                              args.train_dataset + "_" + args.network_dataset,
                              "qoe" + "_".join(map(str, args.qoe_train_ids)), prefix)
    seen = "seen" if args.test_on_seen else "unseen"
    results_dir = args.results_dir or os.path.join(
        config.bs_results_dir, args.model, args.test_dataset + "_" + args.network_dataset,
        f"{seen}_qoe" + "_".join(map(str, args.qoe_test_ids)), prefix)
    os.makedirs(models_dir, exist_ok=True)
    os.makedirs(results_dir, exist_ok=True)

    result, main = None, True
    if args.train:
        mesh = launch.join(args.device) if world > 1 else None
        main = mesh is None or mesh.is_main
        with contextlib.ExitStack() as stack:
            # rank 0 tees its console into console.log; the other ranks print nothing
            if main:
                console_log = stack.enter_context(
                    open(os.path.join(models_dir, "console.log"), "w"))
                stdout = ConsoleLogger(sys.stdout, console_log)
            else:
                stdout = stack.enter_context(open(os.devnull, "w"))
            stack.enter_context(contextlib.redirect_stdout(stdout))
            if mesh is not None:
                print(f"Env lanes sharded over {mesh.world} devices, one rank each "
                      f"({mesh.backend})")
            train(args, config, models_dir, mesh)
        if mesh is not None:
            shutdown(mesh)
    if args.test and main:
        result = test(args, config, models_dir, results_dir)
    return result


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--task", type=str, default="mansy")
    parser.add_argument("--reward-threshold", type=float, default=500000.0)
    parser.add_argument("--seed", type=int, default=5)
    parser.add_argument("--buffer-size", type=int, default=1000000,
                        help="accepted for reference-CLI compatibility (the buffer is "
                             "one collect)")
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--weight-decay", type=float, default=1e-2)
    parser.add_argument("--gamma", type=float, default=0.95)
    parser.add_argument("--epochs", type=int, default=1000)
    parser.add_argument("--step-per-epoch", type=int, default=4096)
    parser.add_argument("--step-per-collect", type=int, default=4096)
    parser.add_argument("--repeat-per-collect", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--train-lanes", type=int, default=128,
                        help="parallel env lanes (replaces tianshou train_num)")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--vf-coef", type=float, default=0.5)
    parser.add_argument("--ent-coef", type=float, default=0.02)
    parser.add_argument("--ent-final", type=float, default=None,
                        help="linearly anneal the entropy coef to this value over training")
    parser.add_argument("--eps-clip", type=float, default=0.2)
    parser.add_argument("--max-grad-norm", type=float, default=1)
    parser.add_argument("--gae-lambda", type=float, default=0.95)
    parser.add_argument("--rew-norm", type=int, default=1)
    parser.add_argument("--value-clip", type=int, default=1)
    parser.add_argument("--norm-adv", type=int, default=1)
    parser.add_argument("--recompute-adv", type=int, default=0,
                        help="accepted for reference-CLI compatibility; the reference "
                             "default (0) is the only supported mode")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--save-interval", type=int, default=4)
    parser.add_argument("--model", type=str, default="mansy")
    parser.add_argument("--hidden-dim", type=int, default=128)
    parser.add_argument("--obs-action-values", action="store_true",
                        help="derived causal-MPC action-value features")
    parser.add_argument("--av-logit-prior", type=float, default=0.0,
                        help="add beta * standardized one-step action values to the actor "
                             "logits (the exact ones with --exact-action-values, else the "
                             "derived ones)")
    parser.add_argument("--acc-correct", action="store_true",
                        help="the accuracy-corrected estimate for the exact action-value "
                             "observation field")
    parser.add_argument("--exact-action-values", action="store_true",
                        help="env-computed exact one-step action values as an observation "
                             "field")
    parser.add_argument("--identifier-lr", type=float, default=1e-4)
    parser.add_argument("--identifier-update-round", type=int, default=2)
    parser.add_argument("--lamb", type=float, default=0.5)
    parser.add_argument("--lamb-warmup", type=int, default=0,
                        help="ramp the identifier-shaping λ from 0 to --lamb over this many "
                             "epochs (0 = off)")
    parser.add_argument("--id-reward-center", action="store_true",
                        help="subtract the per-preference batch mean from the identifier "
                             "reward before shaping")
    parser.add_argument("--norm-adv-per-pref", action="store_true",
                        help="normalize advantages within each QoE-preference group instead "
                             "of per minibatch")
    parser.add_argument("--pretrain-identifier", type=int, default=0,
                        help="minibatch-MSE steps pre-training the identifier on the "
                             "expert-demo grid before PPO starts (0 = off)")
    parser.add_argument("--pretrain-demos-path", type=str, default=None,
                        help="demo pickle for --pretrain-identifier (default: the standard "
                             "expert demos dir)")
    parser.add_argument("--pref-interp", type=int, default=0,
                        help="append this many random convex combinations of the train "
                             "preferences as extra training preferences (0 = off)")
    parser.add_argument("--pref-interp-alpha", type=float, default=1.0,
                        help="Dirichlet concentration for --pref-interp combination "
                             "coefficients")
    parser.add_argument("--train", action="store_true")
    parser.add_argument("--train-identifier", action="store_true")
    parser.add_argument("--use-identifier", action="store_true")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--test-on-seen", action="store_true")
    parser.add_argument("--train-dataset", type=str, default="Jin2022")
    parser.add_argument("--test-dataset", type=str, default="Jin2022")
    parser.add_argument("--network-dataset", type=str, default="4G")
    parser.add_argument("--qoe-train-ids", type=int, nargs="*")
    parser.add_argument("--qoe-test-ids", type=int, nargs="*")
    parser.add_argument("--policy-path", type=str, default=None,
                        help="policy .npz with its .netcfg.json sidecar (default: the "
                             "best_policy.npz that --train wrote)")
    parser.add_argument("--bc", action="store_true")
    parser.add_argument("--bc-max-steps", type=int, default=150)
    parser.add_argument("--bc-valid-per-step", type=int, default=50)
    parser.add_argument("--bc-identifier-max-steps", type=int, default=150)
    parser.add_argument("--init-from-bc", action="store_true")
    parser.add_argument("--init-path", type=str, default=None,
                        help="warm-start policy .npz (e.g. DAgger); with --bc-kl also the "
                             "KL anchor")
    parser.add_argument("--bc-kl", type=float, default=0.0,
                        help="KL penalty toward the frozen warm-start policy during PPO")
    parser.add_argument("--bc-kl-per-pref", type=float, nargs="*", default=None,
                        help="per-preference KL anchor coefficients, one per train "
                             "preference; overrides --bc-kl")
    parser.add_argument("--data-parallel", action="store_true",
                        help="shard env lanes over all devices, one rank a device (one "
                             "device: as without the flag)")
    parser.add_argument("--deterministic-eval", action="store_true",
                        help="argmax actions at test time (tianshou deterministic_eval; "
                             "reference default samples)")
    parser.add_argument("--results-dir", type=str, default=None,
                        help="where --test writes results.csv (default: the JAX CLI's "
                             "results layout)")
    parser.add_argument("--config-yml", type=str, default=None)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    print(args)
    return run(args, load_config(args.config_yml))


if __name__ == "__main__":
    main()
