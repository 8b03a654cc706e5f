"""DAgger CLI: aggregate MPC-expert labels on the policy's own states.

Port of the JAX package's ``cli/run_dagger.py``, every flag.  It starts from
expert demos (either package's ``run_expert --train`` pickles, or the
reference's tianshou ones), optionally from a warm-start policy, then
alternates policy rollouts labelled by the MPC expert (K2 -> K4 -> K3
sampling -> K1 a step) with CE retraining on the aggregate (K3's training
mode -> K9 in CE mode -> K10 a minibatch).  A policy that reads action
values without ``--exact-action-values`` reads the derived ones: K2's
derived mode in the rollouts, its row mode on demos recorded without the
field.  The best policy by the valid
grid's mean QoE is saved as a Flax-keyed ``.npz`` with its ``.netcfg.json``
sidecar, usable via ``run_mansy --test --policy-path``; the final round's
params are always kept beside it (``<output>.last``).

Example::

    python -m mansy_immersivevideostreaming_torch.cli.run_dagger \\
        --rounds 8 --lanes 32 --bc-steps 300 --horizon 4
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mansy_immersivevideostreaming_torch.cli.run_expert import get_expert_tables
from mansy_immersivevideostreaming_torch.cli.run_mansy import interp_preferences
from mansy_immersivevideostreaming_torch.config import load_config
from mansy_immersivevideostreaming_torch.data.tianshou_compat import load_demonstrations
from mansy_immersivevideostreaming_torch.kernels.observe import obs_columns, obs_dims
from mansy_immersivevideostreaming_torch.models.abr_nets import MansyActorCritic
from mansy_immersivevideostreaming_torch.rl import dagger, runner
from mansy_immersivevideostreaming_torch.rl import ppo as ppo_mod
from mansy_immersivevideostreaming_torch.sim.env import generate_demo_samples
from mansy_immersivevideostreaming_torch.sim.expert import (
    attach_action_values, deployable_etables,
)
from mansy_immersivevideostreaming_torch.utils.checkpoint import (
    load_npz_into, save_net_config, save_npz,
)
from mansy_immersivevideostreaming_torch.utils.device import resolve_device
from mansy_immersivevideostreaming_torch.utils.prng import seed_everything


def balanced(args, dataset, tables):
    """``--class-balance`` multipliers on top of the aggregate's relabel
    weights (sampling-level; a no-op at beta 0), from its ``qoe_weight``
    columns in the packed layout of ``tables``' observation."""
    if not args.class_balance:
        return dataset
    x, act = dataset[0], dataset[1]
    w = dataset[2] if len(dataset) > 2 else torch.ones(act.shape[0], device=x.device)
    qoe = x[:, obs_columns(*obs_dims(tables))["qoe_weight"]]
    return x, act, w * dagger.class_balance_weights(qoe, act, args.class_balance)


def dagger_round(args, policy, optimizer, collect, tables, dataset, samples, generator):
    """One DAgger round after the initial fit: roll the policy out over
    ``samples`` with the expert labelling every visited state (``collect``,
    :func:`dagger.make_dagger_collector`), keep the confident relabels
    (``--relabel-margin``, ``--relabel-margin-q``), aggregate them and refit
    with ``--bc-steps`` CE steps.  The aggregate stays packed on the
    policy's device.  Returns (dataset, CE losses, margin statistics as
    text)."""
    extra_keep, mstats = None, ""
    if args.relabel_margin > 0 or args.relabel_margin_q is not None:
        obs, expert_act, done, margin = collect(policy, samples, generator)
        mg = margin.cpu().numpy()
        finite = np.isfinite(mg)  # pinned preferences are +inf: always kept
        thr = args.relabel_margin
        if args.relabel_margin_q is not None and finite.any():
            thr = float(np.quantile(mg[finite], args.relabel_margin_q))
        extra_keep = mg >= thr
        if finite.any():
            p25, p50, p75 = np.percentile(mg[finite], [25, 50, 75])
            mstats = (f" | margin thr {thr:.4f} kept {float(extra_keep[finite].mean()):.2f} "
                      f"(p25/50/75 {p25:.4f}/{p50:.4f}/{p75:.4f})")
    else:
        obs, expert_act, done = collect(policy, samples, generator)
    dataset = dagger.aggregate(dataset, obs, expert_act, done, weight=args.relabel_weight,
                               extra_keep=extra_keep)
    losses = dagger.bc_on_aggregate(policy, optimizer, balanced(args, dataset, tables),
                                    args.bc_steps, args.batch_size, generator, args.ent_coef)
    return dataset, losses, mstats


def run(args, config):
    dev = resolve_device(args.device)
    if args.qoe_train_ids is None:
        args.qoe_train_ids = list(range(len(config.qoe_split["train"])))
    generator = seed_everything(args.seed, dev)
    # preference interpolation: the MPC expert labels interpolated
    # preferences exactly as well as base ones
    qoe_weights = interp_preferences([config.qoe_split["train"][i] for i in args.qoe_train_ids],
                                     args.pref_interp, args.pref_interp_alpha, args.seed)
    qoe_probs = None
    if args.qoe_sample_weights is not None:
        w = list(args.qoe_sample_weights)
        if len(w) == len(args.qoe_train_ids) and len(qoe_weights) > len(w):
            # pad interp preferences with the mean base weight
            w = w + [float(np.mean(w))] * (len(qoe_weights) - len(w))
        if len(w) != len(qoe_weights):
            raise ValueError(f"--qoe-sample-weights needs {len(args.qoe_train_ids)} (base) or "
                             f"{len(qoe_weights)} (with interp) values, got {len(w)}")
        qoe_probs = w
        print("DAgger qoe sampling weights:", [round(x, 3) for x in w])
    print("DAgger QoE weights:", qoe_weights)
    models_dir = os.path.join(config.bs_models_dir, "expert",
                              args.train_dataset + "_" + args.network_dataset,
                              "qoe" + "_".join(map(str, args.qoe_train_ids)))
    cache_path = os.path.join(config.bs_models_dir, "expert", f"{args.train_dataset}_cache.pkl")

    tables, _, videos, users, traces = runner.build_split(
        config, args.train_dataset, args.network_dataset, "train", qoe_weights, device=dev)
    etables = get_expert_tables(tables, cache_path, False)
    vweights = [config.qoe_split["valid"][i] for i in args.qoe_train_ids]
    if args.valid_interp > 0:
        # interpolation-aware selection, from an rng stream of its own so the
        # valid preferences do not repeat the training ones
        vweights = interp_preferences(vweights, args.valid_interp, args.pref_interp_alpha,
                                      args.seed + 9973)
        print("Valid-grid interp preferences:", vweights[len(args.qoe_train_ids):])
    vtables, vsamples, _, _, _ = runner.build_split(
        config, args.train_dataset, args.network_dataset, "valid", vweights, device=dev)
    acc_obs = args.acc_correct or args.acc_correct_obs
    if args.exact_action_values:
        tables = attach_action_values(tables, etables, acc_correct=acc_obs)
        vtables = attach_action_values(
            vtables, get_expert_tables(vtables, cache_path.replace("_cache", "_valid_cache"),
                                       False), acc_correct=acc_obs)

    demos_path = args.demos_path or os.path.join(models_dir, "train_demonstrations.pkl")
    policy = MansyActorCritic(hidden_dim=args.hidden_dim, action_space=config.action_space,
                              use_action_values=args.obs_action_values or args.exact_action_values,
                              av_logit_prior=args.av_logit_prior, device=dev)
    policy.exact_action_values = args.exact_action_values
    demos = list(load_demonstrations(demos_path).values())
    dataset = dagger.flatten_demos(demos, dev, policy.reads_action_values)
    print(f"Aggregate init: {dataset[1].shape[0]} expert transitions from {len(demos)} demos")

    if args.init_path:
        load_npz_into(policy, args.init_path)
        print("Initialized policy from", args.init_path)
    optimizer = ppo_mod.make_optimizer(policy.parameters(), args.lr)

    pin_table = None
    if args.pin_expert:
        pin_table = np.full(len(qoe_weights), -1, np.int32)
        for spec in args.pin_expert:
            idx, act = (int(x) for x in spec.split(":"))
            if not (0 <= idx < len(qoe_weights) and 0 <= act < config.action_space):
                raise ValueError(f"--pin-expert {spec}: no such preference or action")
            pin_table[idx] = act
        print("Expert pins (pref idx -> fixed action):",
              {i: int(a) for i, a in enumerate(pin_table) if a >= 0})

    n_steps = runner.episode_step_bound(tables)
    if args.deployable_expert:
        etables = deployable_etables(etables)
    acc_correct = args.acc_correct
    if args.acc_correct_prefs is not None:
        # per-preference hybrid teacher: the listed preferences get
        # accuracy-corrected relabel scoring, the rest the gt-evaluated one
        acc_correct = np.zeros(len(qoe_weights), bool)
        for idx in args.acc_correct_prefs:
            if not 0 <= idx < len(qoe_weights):
                raise ValueError(f"--acc-correct-prefs {idx}: no such preference")
            acc_correct[idx] = True
        print("Corrected-scoring prefs (idx):", [i for i, c in enumerate(acc_correct) if c])
    with_margin = args.relabel_margin > 0 or args.relabel_margin_q is not None
    collect = dagger.make_dagger_collector(tables, etables, args.horizon, n_steps, pin_table,
                                           causal=args.causal_expert, acc_correct=acc_correct,
                                           with_margin=with_margin)

    def valid_return():
        """Deterministic-argmax valid metrics: (grid, ret, per-preference
        text).  ``grid`` is the equal-weight mean over preferences of the
        mean episode QoE, the statistic the test grids report; ``ret`` the
        legacy mean episode return."""
        logs, masks = runner.evaluate(policy, vtables, vsamples, deterministic=True)
        pick = lambda name: np.concatenate([getattr(l, name).cpu().numpy()[m]
                                            for l, m in zip(logs, masks)])
        rets, qoes, qids = pick("ret"), pick("qoe"), pick("qoe_id")
        per_pref = {q: float(qoes[qids == q].mean()) for q in sorted(set(qids.tolist()))}
        grid = float(np.mean(list(per_pref.values())))
        pp = " ".join(f"q{q}:{v:.4f}" for q, v in per_pref.items())
        return grid, float(rets.mean()), pp

    out_path = args.output_path or os.path.join(models_dir, "dagger_policy.npz")
    # the sidecar rebuilds the same policy function at test time
    netcfg = {"hidden_dim": int(args.hidden_dim),
              "obs_action_values": bool(args.obs_action_values),
              "exact_action_values": bool(args.exact_action_values),
              "av_logit_prior": float(args.av_logit_prior), "acc_correct_obs": bool(acc_obs)}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    for p in (out_path, out_path + ".last"):
        save_net_config(p, netcfg)

    # round 0: fit the initial aggregate
    losses = dagger.bc_on_aggregate(policy, optimizer, balanced(args, dataset, tables),
                                    args.bc_steps, args.batch_size, generator, args.ent_coef)
    best, ret0, pp = valid_return()
    best_round, best_ret, best_ret_round = 0, ret0, 0
    save_npz(out_path, policy)
    print(f"Round 0 (BC fit): ce {losses[0]:.4f} -> {losses[-1]:.4f} | "
          f"valid grid {best:.4f} return {ret0:.3f} [{pp}] | saved {out_path}")

    for r in range(1, args.rounds + 1):
        t0 = time.time()
        samples = torch.as_tensor(generate_demo_samples(
            len(videos), len(users), len(traces), len(qoe_weights), args.lanes, args.seed + r,
            qoe_probs=qoe_probs), device=dev)
        dataset, losses, mstats = dagger_round(args, policy, optimizer, collect, tables, dataset,
                                               samples, generator)
        grid, ret, pp = valid_return()
        if ret > best_ret:
            best_ret, best_ret_round = ret, r
        marker = ""
        if grid > best:
            best, best_round = grid, r
            save_npz(out_path, policy)
            marker = " *best*"
        print(f"Round {r}/{args.rounds}: +{args.lanes} episodes -> "
              f"{dataset[1].shape[0]} transitions | ce {losses[-1]:.4f} | "
              f"valid grid {grid:.4f} return {ret:.3f} [{pp}] "
              f"(best {best:.4f}){marker}{mstats} [{time.time() - t0:.1f}s]")
    # the valid split cannot see everything the test grid measures: keep the
    # final round's params too, so the test grid can arbitrate
    save_npz(out_path + ".last", policy)
    print(f"Best valid grid qoe {best:.4f} at round {best_round} "
          f"(legacy return metric would have picked round {best_ret_round}, "
          f"{best_ret:.3f}) | policy at {out_path} | last-round params at {out_path}.last")
    return out_path


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--rounds", type=int, default=8)
    parser.add_argument("--lanes", type=int, default=32,
                        help="policy episodes labelled by the expert per round")
    parser.add_argument("--bc-steps", type=int, default=300, help="CE minibatch steps per round")
    parser.add_argument("--batch-size", type=int, default=4096)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--ent-coef", type=float, default=0.1,
                        help="BC entropy bonus (reference uses 0.1; 0 = sharpest conditional "
                             "fit)")
    parser.add_argument("--horizon", type=int, default=4)
    parser.add_argument("--pref-interp", type=int, default=0,
                        help="append this many random convex combinations of the train "
                             "preferences")
    parser.add_argument("--pref-interp-alpha", type=float, default=1.0,
                        help="Dirichlet concentration for --pref-interp")
    parser.add_argument("--valid-interp", type=int, default=0,
                        help="append this many random convex combinations of the valid "
                             "preferences to the checkpoint-selection grid (a distinct rng "
                             "stream from --pref-interp)")
    parser.add_argument("--qoe-sample-weights", type=float, nargs="*", default=None,
                        help="relative sampling weights per preference for the rollouts; "
                             "base-preference count or full count with interp")
    parser.add_argument("--pin-expert", type=str, nargs="*", default=None,
                        metavar="PREF_IDX:ACTION",
                        help="pin a preference's expert label to a fixed action (e.g. '1:10' "
                             "= always min-rate for the 2nd preference) instead of the search")
    parser.add_argument("--causal-expert", action="store_true",
                        help="relabel with the causal harmonic-bandwidth MPC expert instead "
                             "of the privileged true-future-trace expert")
    parser.add_argument("--acc-correct", action="store_true",
                        help="score relabel searches (and the exact action-value obs field) "
                             "with the accuracy-corrected deployable estimate")
    parser.add_argument("--acc-correct-prefs", type=int, nargs="*", default=None,
                        metavar="PREF_IDX",
                        help="apply --acc-correct relabel scoring only to these preference "
                             "indices; the rest keep gt-evaluated scoring")
    parser.add_argument("--acc-correct-obs", action="store_true",
                        help="accuracy-correct only the exact action-value obs field")
    parser.add_argument("--deployable-expert", action="store_true",
                        help="score relabel searches on the fully deployable profiling "
                             "tables (pred-allocated and pred-evaluated)")
    parser.add_argument("--class-balance", type=float, default=0.0, metavar="BETA",
                        help="within-preference inverse-class-frequency CE sampling exponent "
                             "(0 = off, 1 = full balance)")
    parser.add_argument("--relabel-weight", type=float, default=1.0,
                        help="CE sampling weight of relabelled policy states relative to the "
                             "initial demo aggregate")
    parser.add_argument("--relabel-margin", type=float, default=0.0,
                        help="drop relabelled transitions whose teacher decision margin is "
                             "below this; pinned preferences are always kept")
    parser.add_argument("--relabel-margin-q", type=float, default=None, metavar="Q",
                        help="like --relabel-margin but per round: drop the fraction Q of "
                             "non-pinned relabels with the smallest margins")
    parser.add_argument("--hidden-dim", type=int, default=128)
    parser.add_argument("--obs-action-values", action="store_true",
                        help="derived causal-MPC action-value features (demos recorded "
                             "without the exact field get them too)")
    parser.add_argument("--av-logit-prior", type=float, default=0.0,
                        help="add beta * standardized one-step action values to the actor "
                             "logits (the exact ones with --exact-action-values, else the "
                             "derived ones)")
    parser.add_argument("--exact-action-values", action="store_true",
                        help="env-computed exact one-step action values as an observation "
                             "field; demos must be generated with the same flag")
    parser.add_argument("--seed", type=int, default=5)
    parser.add_argument("--train-dataset", type=str, default="Jin2022")
    parser.add_argument("--network-dataset", type=str, default="4G")
    parser.add_argument("--qoe-train-ids", type=int, nargs="*")
    parser.add_argument("--demos-path", type=str, default=None)
    parser.add_argument("--init-path", type=str, default=None,
                        help="warm-start policy .npz (e.g. a BC best)")
    parser.add_argument("--output-path", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--config-yml", type=str, default=None)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    print(args)
    return run(args, load_config(args.config_yml))


if __name__ == "__main__":
    main()
