"""The port's training CLIs end to end on the synthetic dataset tree (CPU,
hidden 16), as ``tests/test_cli_integration.py`` runs the JAX CLIs.

* ``run_mansy --train`` with the identifier, reward centering and the λ
  warm-up, then ``--test`` on the ``best_policy.npz`` it wrote;
* ``--init-path`` with ``--bc-kl-per-pref`` (the KL anchor line in
  ``console.log``);
* ``run_expert --train --valid`` demos, then ``run_mansy --train --bc
  --pretrain-identifier --norm-adv-per-pref --exact-action-values``;
* ``run_expert --train`` demos, then ``run_dagger`` with the round-4 flag
  combination.

* ``--obs-action-values`` and ``--av-logit-prior`` without
  ``--exact-action-values`` (the derived action values): ``run_mansy
  --train`` then ``--test``, and ``run_dagger`` from demos recorded without
  the exact field.

Every policy and identifier npz loads into the JAX package's Flax net and
gives the port's outputs (1e-5), and each policy has its sidecar.

``--data-parallel`` on one device (``--device cpu``): ``run_mansy --train``
and ``--test`` write the npz, logs, TensorBoard scalars and stdout of the
same run without the flag; over two CUDA devices ``--train`` plans two
ranks.
"""

import dataclasses
import glob
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_tree import build_synthetic_tree
from mansy_immersivevideostreaming_tpu.models.abr_nets import MansyActorCritic as JaxAC
from mansy_immersivevideostreaming_tpu.models.abr_nets import QoEIdentifier as JaxID
from mansy_immersivevideostreaming_torch.cli import run_dagger, run_expert, run_mansy
from mansy_immersivevideostreaming_torch.kernels.observe import pack_obs
from mansy_immersivevideostreaming_torch.models.abr_nets import QoEIdentifier
from mansy_immersivevideostreaming_torch.parallel import launch
from mansy_immersivevideostreaming_torch.utils.checkpoint import (
    load_net_config, load_npz_into, load_npz_policy,
)
from test_torch_ppo import random_obs
from test_torch_tables import port_config
from test_torch_utils import EVENTS, tb_scalars

COMMON = ["--epochs", "2", "--step-per-epoch", "64", "--step-per-collect", "64",
          "--train-lanes", "8", "--batch-size", "64", "--hidden-dim", "16",
          "--save-interval", "1", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("synth")
    return str(base), port_config(build_synthetic_tree(str(base)))


def flax_tree(path) -> dict:
    """A Flax-keyed npz as the nested params dict Flax applies."""
    nested = {}
    with np.load(path) as npz:
        for key in npz.files:
            *scopes, leaf = key.split("/")
            node = nested
            for s in scopes:
                node = node.setdefault(s, {})
            node[leaf] = jnp.asarray(npz[key])
    return nested


def assert_policy_loads_into_flax(path):
    cfg = load_net_config(path)
    assert cfg is not None, f"{path} has no sidecar"
    exact = cfg["exact_action_values"]
    obs = random_obs(np.random.default_rng(0), (12,), exact)  # without the field: derived
    net = JaxAC(hidden_dim=cfg["hidden_dim"],
                use_action_values=exact or cfg["obs_action_values"],
                av_logit_prior=cfg["av_logit_prior"])
    jl, jv = net.apply({"params": flax_tree(path)}, {k: jnp.asarray(v) for k, v in obs.items()})
    with torch.no_grad():
        tl, tv = load_npz_policy(path, device="cpu")({k: torch.as_tensor(v) for k, v in obs.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)


def assert_identifier_loads_into_flax(path, hidden=16):
    obs = random_obs(np.random.default_rng(1), (12,), False)
    want = JaxID(hidden_dim=hidden).apply({"params": flax_tree(path)},
                                          {k: jnp.asarray(v) for k, v in obs.items()})
    ident = QoEIdentifier(hidden_dim=hidden, device="cpu")
    load_npz_into(ident, path)
    with torch.no_grad():
        np.testing.assert_allclose(ident(pack_obs(obs)).numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def models(base, name, seed="_seed_5_"):
    return [p for p in glob.glob(os.path.join(base, "models", "bitrate_selection", "**", name),
                                 recursive=True) if seed in p]


@pytest.fixture(scope="module")
def trained(tree):
    base, cfg = tree
    args = ["--use-identifier", "--train-identifier", "--id-reward-center", "--lamb-warmup", "1"]
    run_mansy.run(run_mansy.build_parser().parse_args(["--train"] + args + COMMON), cfg)
    return args


def test_run_mansy_train_then_test(tree, trained, capsys):
    base, cfg = tree
    (policy,) = models(base, "best_policy.npz")
    assert_policy_loads_into_flax(policy)
    assert_identifier_loads_into_flax(models(base, "best_identifier.npz")[0])
    for name in ("checkpoint.npz", "identifier_checkpoint.npz", "train_log.csv",
                 "valid_log.csv", "console.log"):
        assert models(base, name), name
    text = open(models(base, "console.log")[0]).read()
    assert text.count("identifier loss:") == 2 and "Best policy save at" in text
    loss = re.findall(r"^loss: ([-0-9.e]+)", text, re.M)
    assert len(loss) == 2 and all(np.isfinite(float(v)) for v in loss)

    path = run_mansy.run(run_mansy.build_parser().parse_args(
        ["--test", "--test-on-seen", "--deterministic-eval"] + trained + COMMON), cfg)
    rows = open(path).read().strip().splitlines()
    assert len(rows) == 1 + 4  # 1 video x 1 user x 1 trace x 4 preferences
    assert np.isfinite([float(r.split(",")[6]) for r in rows[1:]]).all()
    assert "Successfully loaded agent from: " + policy in capsys.readouterr().out


def test_run_mansy_init_path_with_per_pref_kl_anchor(tree, trained):
    base, cfg = tree
    init = models(base, "best_policy.npz")[0]
    run_mansy.run(run_mansy.build_parser().parse_args(
        ["--train", "--init-path", init, "--bc-kl-per-pref", "2.0", "1.0", "0.1", "0.1",
         "--seed", "21"] + COMMON), cfg)
    text = open(models(base, "console.log", "_seed_21_")[0]).read()
    assert "KL anchor enabled (coef [2.0, 1.0, 0.1, 0.1])" in text
    m = re.findall(r"valid mean return ([0-9.eE+-]+)", text)
    assert m and np.isfinite(float(m[-1]))
    assert_policy_loads_into_flax(models(base, "best_policy.npz", "_seed_21_")[0])


def test_run_mansy_bc_pretrained_identifier_exact_action_values(tree):
    base, cfg = tree
    run_expert.run(run_expert.build_parser().parse_args(
        ["--train", "--valid", "--horizon", "1", "--lane-chunk", "8", "--exact-action-values",
         "--acc-correct-obs", "--device", "cpu"]), cfg)
    run_mansy.run(run_mansy.build_parser().parse_args(
        ["--train", "--bc", "--bc-max-steps", "3", "--bc-valid-per-step", "2",
         "--bc-identifier-max-steps", "2", "--pretrain-identifier", "2",
         "--norm-adv-per-pref", "--exact-action-values", "--acc-correct",
         "--av-logit-prior", "3.0", "--use-identifier", "--train-identifier",
         "--seed", "33"] + COMMON), cfg)
    text = open(models(base, "console.log", "_seed_33_")[0]).read()
    assert text.count("BC (Training): loss=") == 3 and "Identifier pretrained on" in text
    (bc_policy,) = models(base, "bc_ms_*_policy.npz", "_seed_33_")
    for path in (bc_policy, models(base, "best_policy.npz", "_seed_33_")[0]):
        assert load_net_config(path)["exact_action_values"]
        assert_policy_loads_into_flax(path)


def test_run_expert_demos_then_run_dagger(tree, capsys):
    base, cfg = tree
    run_expert.run(run_expert.build_parser().parse_args(
        ["--train", "--horizon", "1", "--lane-chunk", "8", "--exact-action-values",
         "--acc-correct-obs", "--device", "cpu"]), cfg)
    (demos,) = glob.glob(os.path.join(base, "models", "bitrate_selection", "expert", "**",
                                      "train_demonstrations.pkl"), recursive=True)
    out = run_dagger.run(run_dagger.build_parser().parse_args([
        "--demos-path", demos, "--rounds", "1", "--lanes", "4", "--bc-steps", "10",
        "--batch-size", "64", "--horizon", "1", "--hidden-dim", "16",
        "--pref-interp", "2", "--pref-interp-alpha", "1.0",
        "--qoe-sample-weights", "0.5", "0.5", "4", "4", "2", "2",
        "--relabel-weight", "4", "--pin-expert", "0:14", "1:10",
        "--causal-expert", "--class-balance", "0.5", "--relabel-margin-q", "0.5",
        "--valid-interp", "2", "--exact-action-values", "--acc-correct-obs",
        "--av-logit-prior", "3.0", "--device", "cpu"]), cfg)
    stdout = capsys.readouterr().out
    assert "Valid-grid interp preferences:" in stdout and "q5:" in stdout
    assert "Round 1/1" in stdout and "margin thr" in stdout
    for path in (out, out + ".last"):
        cfg_ = load_net_config(path)
        assert cfg_["av_logit_prior"] == 3.0 and cfg_["acc_correct_obs"]
        assert_policy_loads_into_flax(path)


@pytest.mark.parametrize("cli,flags", [
    (run_mansy, ["--train", "--data-parallel"]),
])
def test_later_slices_flags_are_refused(tree, cli, flags, monkeypatch):
    """Over two CUDA devices ``--train --data-parallel`` is the multi-process
    path: the CLI, started by no launcher, plans two ranks, one a device,
    and hands them the run (``parallel.launch.launch_ranks``, a recorder
    here) before anything else runs.  The ranks' runs themselves are held
    by ``tests/test_torch_data_parallel_cli.py``."""
    _, cfg = tree
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    planned = []
    monkeypatch.setattr(launch, "launch_ranks",
                        lambda name, args, config, world: planned.append((name, args, world)))
    args = cli.build_parser().parse_args(flags + ["--device", "cuda"])
    assert cli.run(args, cfg) is None
    assert planned == [(cli.__name__.rsplit(".", 1)[1], args, 2)]


# a rate or a duration in a console line: the one thing two runs may differ in
TIMED = re.compile(r"[0-9][0-9,.]* (?:env-steps|samples|trajectories)/s|in [0-9.]+s\b")


def cli_outputs(run, roots, capsys) -> dict:
    """``run()``'s stdout and every file it wrote under ``roots`` ({path:
    content}: an npz as its arrays, a TensorBoard event file, whose name
    holds the clock, as its directory's scalars, text with TIMED masked);
    the roots are removed after, so that the next run writes the same paths
    afresh."""
    capsys.readouterr()
    run()
    out = {"stdout": TIMED.sub("<t>", capsys.readouterr().out)}
    for root in roots:
        for path in sorted(glob.glob(os.path.join(root, "**", "*"), recursive=True)):
            if EVENTS in os.path.basename(path):  # named by the clock: its scalars
                out[os.path.join(os.path.dirname(path), EVENTS)] = tb_scalars(
                    os.path.dirname(path))
            elif path.endswith(".npz"):
                with np.load(path) as npz:
                    out[path] = {k: npz[k] for k in npz.files}
            elif os.path.isfile(path):
                with open(path) as f:
                    out[path] = TIMED.sub("<t>", f.read())
        shutil.rmtree(root)
    return out


def assert_same_outputs(got: dict, want: dict) -> None:
    assert got.keys() == want.keys() and len(got) > 1
    for path, x in want.items():
        if isinstance(x, dict):
            assert got[path].keys() == x.keys(), path
            for k in x:
                np.testing.assert_array_equal(got[path][k], x[k], err_msg=f"{path}: {k}")
        else:
            assert got[path] == x, path


@pytest.mark.parametrize("mode", ["--train", "--test"])
def test_data_parallel_on_one_device_runs_as_without_it(tree, trained, tmp_path, capsys, mode):
    """``run_mansy --data-parallel`` on one device, as JAX runs it there
    (``--train`` shards only over more than one device, ``--test`` never
    reads the flag): the same npz, CSV logs, console log and stdout as the
    run without the flag, same seed; no line is added."""
    base, cfg = tree
    cfg = dataclasses.replace(cfg, bs_models_dir=str(tmp_path / "models"),
                              bs_results_dir=str(tmp_path / "results"))
    if mode == "--train":
        argv = ["--train", "--seed", "61"] + trained + COMMON
    else:
        argv = ["--test", "--test-on-seen", "--deterministic-eval", "--policy-path",
                models(base, "best_policy.npz")[0]] + trained + COMMON
    roots = [cfg.bs_models_dir, cfg.bs_results_dir]
    outputs = [cli_outputs(lambda: run_mansy.run(run_mansy.build_parser().parse_args(
        argv + flag), cfg), roots, capsys) for flag in ([], ["--data-parallel"])]
    assert_same_outputs(outputs[1], outputs[0])
    assert "sharded" not in outputs[1]["stdout"]


@pytest.mark.parametrize("cli,flags", [
    (run_mansy, ["--obs-action-values"]),
    (run_mansy, ["--av-logit-prior", "3.0"]),
    (run_dagger, ["--obs-action-values"]),
])
def test_derived_action_value_flags_run(tree, cli, flags, capsys):
    """The derived action values (``--obs-action-values``, or a logit prior
    without ``--exact-action-values``): ``run_mansy --train`` then ``--test``
    on the policy it wrote, whose sidecar asks for no tables; ``run_dagger``
    from ``run_expert`` demos recorded without the exact field (K2's row
    mode fills their action-value columns).  Each policy loads into the
    Flax net with the port's outputs on the derived field."""
    base, cfg = tree
    if cli is run_mansy:
        seed = ["--seed", str(40 + len(flags))]
        run_mansy.run(run_mansy.build_parser().parse_args(["--train"] + flags + seed + COMMON),
                      cfg)
        (path,) = models(base, "best_policy.npz", f"_seed_{seed[1]}_")
        results = run_mansy.run(run_mansy.build_parser().parse_args(
            ["--test", "--test-on-seen", "--deterministic-eval"] + seed + COMMON), cfg)
        rows = open(results).read().strip().splitlines()
        assert len(rows) == 1 + 4 and np.isfinite([float(r.split(",")[6]) for r in rows[1:]]).all()
    else:
        run_expert.run(run_expert.build_parser().parse_args(
            ["--train", "--horizon", "1", "--lane-chunk", "8", "--device", "cpu"]), cfg)
        (demos,) = glob.glob(os.path.join(base, "models", "bitrate_selection", "expert", "**",
                                          "train_demonstrations.pkl"), recursive=True)
        path = run_dagger.run(run_dagger.build_parser().parse_args(
            ["--demos-path", demos, "--rounds", "1", "--lanes", "4", "--bc-steps", "5",
             "--batch-size", "64", "--horizon", "1", "--hidden-dim", "16",
             "--output-path", os.path.join(base, "dagger_derived.npz"), "--device", "cpu"]
            + flags), cfg)
        assert "Round 1/1" in capsys.readouterr().out
    netcfg = load_net_config(path)
    assert not netcfg["exact_action_values"]
    assert netcfg["obs_action_values"] or netcfg["av_logit_prior"] == 3.0
    assert_policy_loads_into_flax(path)
