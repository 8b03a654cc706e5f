"""Preference-routed ensemble: validation-routed deployment of K policies.

Port of the JAX package's ``cli/run_ensemble.py`` (the same flags, console
lines, ``results.csv`` and ``route.json``, plus ``--device``).  The QoE
weight vector is an input the controller reads before the episode starts,
so a deployable controller may hold K trained policies and serve, per
preference, the one with the best measured valid-split QoE at that
preference.  Each component (an npz with its ``.netcfg.json`` sidecar,
``utils/checkpoint.py:load_npz_policy``) is evaluated deterministically on
the valid split at the routed preferences (``--route-grid full``: the
cartesian videos x users x traces grid, 1080 episodes a preference on
Jin2022/4G; ``roundrobin``: the reference's 48-sample schedule); the route
is the per-preference argmax (``--route-gate argmax``) or, by default, the
first-listed component unless a candidate's paired per-episode edge exceeds
``--route-z`` standard errors (``sig``).  Then each preference's test lanes
run on their component over the 1440-episode test grid.  Every evaluation
is ``runner.evaluate``: K2 -> K3 -> K1 a step on the card, at each
component's hidden width (any width).

Refused, as in the JAX CLI: components that read the exact action values
(they need per-split action-value tables).  Components that read the
derived action values (``obs_action_values``, or a logit prior without
``exact_action_values``) are routed like the others, on K2's derived mode.

Example::

    python -m mansy_immersivevideostreaming_torch.cli.run_ensemble \\
        --ckpts mansy_immersivevideostreaming_torch/assets/dagger_v9_params.npz \\
                mansy_immersivevideostreaming_torch/assets/dagger_v18_params.npz \\
        --names v9 v18 --output-csv results/ensemble.csv --route-json results/route.json
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from mansy_immersivevideostreaming_torch.config import load_config
from mansy_immersivevideostreaming_torch.rl import runner
from mansy_immersivevideostreaming_torch.utils.checkpoint import load_net_config, load_npz_policy
from mansy_immersivevideostreaming_torch.utils.device import resolve_device
from mansy_immersivevideostreaming_torch.utils.prng import seed_everything


def build_component(path, device):
    """(policy, netcfg) of a component npz: its ``.netcfg.json`` sidecar,
    which must be present, decides the net."""
    policy = load_npz_policy(path, device=device)
    return policy, load_net_config(path)


def per_pref_qoe(logs, masks):
    """Deterministic grid statistic: mean episode QoE per preference id —
    the same number the test grids and ``run_dagger``'s valid grid report."""
    qoes = np.concatenate([l.qoe.cpu().numpy()[m] for l, m in zip(logs, masks)])
    qids = np.concatenate([l.qoe_id.cpu().numpy()[m] for l, m in zip(logs, masks)])
    return {int(q): float(qoes[qids == q].mean()) for q in sorted(set(qids.tolist()))}


def per_sample_qoe(logs, masks):
    """Per-episode QoE aligned to SAMPLE order (lane-major across chunks).

    ``masks`` select each lane's first finished episode from [T, N] logs;
    flattening ``qoe[mask]`` would be time-major and break cross-component
    pairing, so gather each lane's first-done row explicitly.  A lane with
    no finished episode has no QoE to pair: it raises (an argmax over an
    all-False column would silently read row 0)."""
    vals = []
    for l, m in zip(logs, masks):
        m = np.asarray(m)
        unfinished = np.flatnonzero(~m.any(axis=0))
        if unfinished.size:
            raise ValueError(f"per_sample_qoe: {unfinished.size} lanes finished no episode "
                             f"(first: lane {int(unfinished[0])})")
        qoe = l.qoe.cpu().numpy()
        vals.append(qoe[m.argmax(axis=0), np.arange(m.shape[1])])
    return np.concatenate(vals)


def route_table(valid_scores):
    """``valid_scores`` [K][Q] -> per-preference argmax component index.

    Ties go to the EARLIEST listed component (list your default first), so
    preferences the components solve identically don't churn the routing.
    """
    arr = np.asarray(valid_scores, np.float64)
    best = arr.max(axis=0)
    return [int(np.argmax(arr[:, q] >= best[q] - 1e-12)) for q in range(arr.shape[1])]


def route_table_gated(per_sample, qids, z: float = 2.0):
    """Significance-gated routing: deviate from the default (component 0)
    only when the valid evidence is decisive.

    ``per_sample`` [K][S] per-episode valid QoE, paired across components
    (identical episode schedule); ``qids`` [S] preference ids.  For each
    preference the argmax-mean candidate replaces the default only if the
    paired mean difference against the default exceeds ``z`` standard errors
    (sample std, ``ddof=1``).  Returns (route, evidence) where evidence[q]
    holds the candidate, edge, se, n and whether it routed.
    """
    arr = np.asarray(per_sample, np.float64)
    qids = np.asarray(qids)
    route, evidence = [], []
    for q in sorted(set(qids.tolist())):
        m = qids == q
        means = arr[:, m].mean(axis=1)
        cand = int(np.argmax(means))
        d = arr[cand, m] - arr[0, m]
        n = int(m.sum())
        se = float(d.std(ddof=1) / np.sqrt(n)) if n > 1 else float("inf")
        edge = float(d.mean())
        take = cand != 0 and edge > z * se
        route.append(cand if take else 0)
        evidence.append({"candidate": cand, "edge": edge, "se": se,
                         "n": n, "routed": bool(take or cand == 0)})
    return route, evidence


def run(args, config):
    dev = resolve_device(args.device)
    names = args.names or [os.path.basename(p) for p in args.ckpts]
    if len(names) != len(args.ckpts):
        raise SystemExit("run_ensemble: --names must match --ckpts")
    split = "train" if args.test_on_seen else "test"
    if args.qoe_test_ids is None:
        args.qoe_test_ids = list(range(len(config.qoe_split[split])))
    qoe_weights = [config.qoe_split[split][i] for i in args.qoe_test_ids]
    print("Routing QoE weights:", qoe_weights)

    components = []
    for path in args.ckpts:
        policy, netcfg = build_component(path, dev)
        if netcfg.get("exact_action_values"):
            raise SystemExit(
                f"{path}: exact_action_values components need per-split AV "
                "tables; route plain-observation policies only")
        components.append(policy)
        print(f"Loaded {path} ({netcfg})")
    generator = seed_everything(args.seed, dev)

    # ---- Phase 1: routing evidence — deterministic valid grid per component
    vtables, vsamples, *_ = runner.build_split(
        config, args.test_dataset, args.network_dataset, "valid", qoe_weights,
        test_grid=(args.route_grid == "full"), device=dev)
    vqids = vsamples[:, 3].cpu().numpy()
    print(f"Routing evidence: {vsamples.shape[0]} valid episodes "
          f"({args.route_grid} schedule), gate={args.route_gate}")
    valid_scores, valid_samples = [], []
    for name, policy in zip(names, components):
        t0 = time.time()
        logs, masks = runner.evaluate(policy, vtables, vsamples, generator, deterministic=True)
        pp = per_pref_qoe(logs, masks)
        valid_scores.append([pp[q] for q in range(len(qoe_weights))])
        valid_samples.append(per_sample_qoe(logs, masks))
        print(f"valid {name}: " + " ".join(
            f"q{q}:{v:.4f}" for q, v in pp.items())
            + f" | mean {np.mean(list(pp.values())):.4f}"
            + f" [{time.time() - t0:.1f}s]")
    if args.route_gate == "sig":
        route, gate_evidence = route_table_gated(valid_samples, vqids, z=args.route_z)
        for q, ev in enumerate(gate_evidence):
            print(f"gate q{q}: candidate {names[ev['candidate']]} edge "
                  f"{ev['edge']:+.4f} se {ev['se']:.4f} n {ev['n']} -> "
                  f"{names[route[q]]}")
    else:
        route, gate_evidence = route_table(valid_scores), None
    for q, w in enumerate(qoe_weights):
        print(f"route {w} -> {names[route[q]]}")

    # ---- Phase 2: routed test grid (each preference's lanes run on its
    #      valid-chosen component; identical episodes to run_mansy --test)
    tables, samples, videos, users, traces = runner.build_split(
        config, args.test_dataset, args.network_dataset, "test", qoe_weights,
        test_grid=True, device=dev)
    qcol = samples[:, 3].cpu().numpy()
    all_rows = []
    per_pref = {}
    for c, policy in enumerate(components):
        ids = [q for q in range(len(qoe_weights)) if route[q] == c]
        if not ids:
            continue
        sub = samples[torch.as_tensor(np.isin(qcol, ids), device=samples.device)]
        t0 = time.time()
        logs, masks = runner.evaluate(policy, tables, sub, generator, deterministic=True)
        all_rows.extend(runner.masked_log_rows(logs, masks, videos, users, traces,
                                               qoe_weights))
        pp = per_pref_qoe(logs, masks)
        per_pref.update(pp)
        print(f"test {names[c]} (prefs {ids}): " + " ".join(
            f"q{q}:{v:.4f}" for q, v in pp.items())
            + f" [{time.time() - t0:.1f}s]")

    os.makedirs(os.path.dirname(os.path.abspath(args.output_csv)), exist_ok=True)
    if os.path.exists(args.output_csv):
        os.remove(args.output_csv)
    runner.append_episode_logs(args.output_csv, all_rows)
    grid = float(np.mean([per_pref[q] for q in range(len(qoe_weights))]))
    print(f"Routed ensemble grid mean qoe: {grid:.4f} "
          f"({len(all_rows)} episodes) -> {args.output_csv}")

    if args.route_json:
        with open(args.route_json, "w") as f:
            json.dump({
                "split": "seen" if args.test_on_seen else "unseen",
                "qoe_weights": [list(map(float, w)) for w in qoe_weights],
                "components": {n: str(p) for n, p in zip(names, args.ckpts)},
                "route_grid": args.route_grid,
                "route_gate": args.route_gate,
                "gate_evidence": gate_evidence,
                "valid_scores": {n: s for n, s in zip(names, valid_scores)},
                "route": {str([float(x) for x in qoe_weights[q]]): names[route[q]]
                          for q in range(len(qoe_weights))},
                "test_per_pref": per_pref,
                "test_grid_mean": grid,
            }, f, indent=1, sort_keys=True)
        print("Routing evidence saved at:", args.route_json)
    runner.read_log_file(args.output_csv)
    return grid


def build_parser():
    parser = argparse.ArgumentParser(
        description="Validation-routed preference ensemble over trained policies")
    parser.add_argument("--ckpts", type=str, nargs="+", required=True,
                        help="component policy npz files (netcfg sidecars honored); list "
                             "the default/tie-break component first")
    parser.add_argument("--names", type=str, nargs="*", default=None)
    parser.add_argument("--test-on-seen", action="store_true")
    parser.add_argument("--test-dataset", type=str, default="Jin2022")
    parser.add_argument("--network-dataset", type=str, default="4G")
    parser.add_argument("--qoe-test-ids", type=int, nargs="*", default=None)
    parser.add_argument("--route-grid", choices=["full", "roundrobin"], default="full",
                        help="valid-episode schedule behind the routing: 'full' = cartesian "
                             "videos x users x traces per preference (1080 episodes/pref on "
                             "Jin2022), 'roundrobin' = the reference's 48-sample train/valid "
                             "schedule (12/pref)")
    parser.add_argument("--route-gate", choices=["sig", "argmax"], default="sig",
                        help="'sig' deviates from the first-listed default component only "
                             "when the paired valid edge exceeds --route-z standard errors; "
                             "'argmax' takes the per-preference valid argmax unconditionally")
    parser.add_argument("--route-z", type=float, default=2.0)
    parser.add_argument("--seed", type=int, default=5)
    parser.add_argument("--output-csv", type=str, required=True)
    parser.add_argument("--route-json", type=str, default=None)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return run(args, load_config(args.config))


if __name__ == "__main__":
    main()
