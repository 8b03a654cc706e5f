"""The PyTorch port's import and device rules.

* No module of ``mansy_immersivevideostreaming_torch`` imports JAX, Flax,
  Optax, Orbax or the JAX package (an AST scan, and a fresh interpreter that
  imports the port's runner, CLIs, ``parallel``, ``utils``, ``entry`` and
  the TensorBoard writer's ``tensorboardX`` without pulling in ``jax``, and
  ones that run
  ``run_simple_rl --train --test`` and ``run_ensemble``, and
  ``preprocess_hmdtrace`` and ``preprocess_network``, on the CPU without
  pulling in ``jax``, ``tensorflow`` or the JAX package).
* Entry points default to the card and raise where there is none, instead
  of running on the CPU unasked.
* A kernel wrapper given CPU tensors runs its plain PyTorch version and
  counts no launch (K1-K10, K3's training mode, K2's derived and row modes).
* A sidecar that asks for the derived action values builds the net that
  reads them, with the Flax net's outputs on an observation without the
  exact field.
"""

import ast
import glob
import json
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mansy_immersivevideostreaming_torch as port
from mansy_immersivevideostreaming_torch.kernels import actor_critic as K3
from mansy_immersivevideostreaming_torch.kernels import attention as K8
from mansy_immersivevideostreaming_torch.kernels import choose_action as K4
from mansy_immersivevideostreaming_torch.kernels import env_step as K1
from mansy_immersivevideostreaming_torch.kernels import expert_tables as K5
from mansy_immersivevideostreaming_torch.kernels import gae as K6
from mansy_immersivevideostreaming_torch.kernels import observe as K2
from mansy_immersivevideostreaming_torch.kernels import policy_loss as K9
from mansy_immersivevideostreaming_torch.kernels import tile_occupancy as K7
from mansy_immersivevideostreaming_torch.models.abr_nets import (
    MansyActorCritic, QoEIdentifier, SimpleActorCritic,
)
from mansy_immersivevideostreaming_torch.rl.rollout import init_lanes
from mansy_immersivevideostreaming_torch.sim.env import generate_environment_samples
from mansy_immersivevideostreaming_torch.sim.expert import (
    build_expert_tables_plain, causal_bw_estimate, choose_action_plain,
)
from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables
from mansy_immersivevideostreaming_torch.utils.checkpoint import (
    DAGGER_V9_NPZ, DAGGER_V16_NPZ, NET_CONFIG_SUFFIX, load_npz_policy,
)

PACKAGE = Path(port.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mansy_immersivevideostreaming_tpu")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PACKAGE.rglob("*.py"))
    assert len(files) >= 20
    for path in files:
        roots = set(_imported_roots(ast.parse(path.read_text(), str(path))))
        assert not roots & set(FORBIDDEN), f"{path} imports {roots & set(FORBIDDEN)}"


def test_runner_import_pulls_in_no_jax():
    code = ("import sys; import mansy_immersivevideostreaming_torch.rl.runner; "
            "import mansy_immersivevideostreaming_torch.cli.run_mansy; "
            "import mansy_immersivevideostreaming_torch.cli.run_expert; "
            "import mansy_immersivevideostreaming_torch.sim.expert; "
            "import mansy_immersivevideostreaming_torch.cli.run_dagger; "
            "import mansy_immersivevideostreaming_torch.rl.ppo; "
            "import mansy_immersivevideostreaming_torch.rl.bc; "
            "import mansy_immersivevideostreaming_torch.rl.identifier; "
            "import mansy_immersivevideostreaming_torch.data.tianshou_compat; "
            "import mansy_immersivevideostreaming_torch.cli.run_models; "
            "import mansy_immersivevideostreaming_torch.cli.predict; "
            "import mansy_immersivevideostreaming_torch.models.mtio; "
            "import mansy_immersivevideostreaming_torch.rl.a2c; "
            "import mansy_immersivevideostreaming_torch.cli.run_simple_rl; "
            "import mansy_immersivevideostreaming_torch.cli.run_ensemble; "
            "import mansy_immersivevideostreaming_torch.parallel.dryrun; "
            "import mansy_immersivevideostreaming_torch.parallel.launch; "
            "import mansy_immersivevideostreaming_torch.utils.prng; "
            "import mansy_immersivevideostreaming_torch.utils.profiling; "
            "import mansy_immersivevideostreaming_torch.utils.logging; "
            "import mansy_immersivevideostreaming_torch.entry; "
            "import tensorboardX; "
            "bad = [m for m in sys.modules if m.split('.')[0] in %r]; "
            "assert not bad, bad" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=str(PACKAGE.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_new_entry_points_run_without_jax(tmp_path):
    """``run_simple_rl --train --test`` and ``run_ensemble`` (v9 and v7) run
    on the synthetic dataset tree in a fresh interpreter, and neither pulls
    in JAX, TensorFlow or the JAX package while it runs."""
    from synthetic_tree import build_synthetic_tree
    from test_torch_tables import port_config
    from mansy_immersivevideostreaming_torch.utils.checkpoint import DAGGER_V7_NPZ

    with open(tmp_path / "config.pkl", "wb") as f:
        pickle.dump(port_config(build_synthetic_tree(str(tmp_path))), f)
    code = f"""
import pickle, sys
from mansy_immersivevideostreaming_torch.cli import run_ensemble, run_simple_rl
config = pickle.load(open({str(tmp_path / "config.pkl")!r}, "rb"))
run = lambda cli, argv: cli.run(cli.build_parser().parse_args(argv + ["--device", "cpu"]), config)
run(run_simple_rl, ["--train", "--test", "--qoe-train-id", "0", "--epochs", "1",
                    "--step-per-epoch", "32", "--step-per-collect", "32", "--train-lanes", "8",
                    "--batch-size", "32", "--test-on-seen", "--deterministic-eval"])
run(run_ensemble, ["--ckpts", {str(DAGGER_V9_NPZ)!r}, {str(DAGGER_V7_NPZ)!r},
                   "--test-on-seen", "--route-grid", "roundrobin",
                   "--output-csv", {str(tmp_path / "ensemble.csv")!r}])
bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + ("tensorflow",)!r}]
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=str(PACKAGE.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert (tmp_path / "ensemble.csv").exists()
    assert glob.glob(str(tmp_path / "**" / "*_best_policy.npz"), recursive=True)


def test_preprocessing_clis_run_without_jax(tmp_path):
    """``preprocess_hmdtrace --dataset Wu2017 --preprocess --device cpu`` and
    ``preprocess_network`` (simplify, then ``--scale``) run on synthetic raw
    trees in a fresh interpreter, and neither pulls in JAX, TensorFlow or
    the JAX package while it runs."""
    rng = np.random.default_rng(0)
    t = np.arange(0.0, 4.0, 1.0 / 30)
    for user in (1, 2):
        udir = tmp_path / "raw" / "viewports" / str(user)
        udir.mkdir(parents=True)
        q = rng.normal(size=(t.size, 4))
        rows = np.column_stack([np.arange(t.size), t, q / np.linalg.norm(q, axis=1,
                                                                          keepdims=True)])
        np.savetxt(udir / "video_0.csv", rows, fmt="%.6f", delimiter=",",
                   header="idx,time,q1,q2,q3,q4", comments="")
    (tmp_path / "raw4g").mkdir()
    (tmp_path / "raw4g" / "t.log").write_text(
        "".join(f"{i} {i} 0 0 {1000 + 7 * i} 1000\n" for i in range(20)))
    code = f"""
import dataclasses, os, sys
from mansy_immersivevideostreaming_torch.cli import preprocess_hmdtrace, preprocess_network
from mansy_immersivevideostreaming_torch.config import default_config
base = default_config(datasets_base_dir={str(tmp_path)!r})
config = dataclasses.replace(base, raw_datasets_dir={{"Wu2017": {str(tmp_path / "raw")!r}}},
    viewport_datasets_dir={{"Wu2017": {str(tmp_path / "vp")!r}}},
    raw_network_datasets_dir={{"4G": {str(tmp_path / "raw4g")!r}}},
    video_num={{"Wu2017": 1}}, user_num={{"Wu2017": 2}})
preprocess_hmdtrace.run(preprocess_hmdtrace.build_parser().parse_args(
    ["--dataset", "Wu2017", "--preprocess", "--device", "cpu"]), config)
preprocess_network.run(preprocess_network.build_parser().parse_args([]), config)
preprocess_network.run(preprocess_network.build_parser().parse_args(
    ["--scale", "t.pkl", "--up", "8", "--low", "2"]), config)
bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + ("tensorflow",)!r}]
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=str(PACKAGE.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert (tmp_path / "vp" / "video1" / "5Hz" / "simple_5Hz_user2.npy").exists()
    assert sorted(os.listdir(tmp_path / "network" / "4G")) == [
        "scaled_up_8.0_low_2.0t.pkl", "t.log", "t.pkl"]


def test_preprocess_hmdtrace_defaults_to_the_card(tmp_path):
    """Wu2017's quaternion math runs on ``--device``, the card unless the
    caller asks for the CPU: without a card the default raises."""
    from mansy_immersivevideostreaming_torch.cli import preprocess_hmdtrace
    from mansy_immersivevideostreaming_torch.config import default_config
    assert preprocess_hmdtrace.build_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        preprocess_hmdtrace.preprocess_hmd_trace("Wu2017", default_config(str(tmp_path)))


def test_entry_points_refuse_to_fall_back_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the entry points would run on it")
    from mansy_immersivevideostreaming_torch.cli import (
        predict, run_dagger, run_ensemble, run_expert, run_mansy, run_models, run_simple_rl,
    )
    from mansy_immersivevideostreaming_torch.models.mtio import ViewportTransformerMTIO
    from mansy_immersivevideostreaming_torch.config import default_config
    from mansy_immersivevideostreaming_torch.utils.device import resolve_device
    cli_device = lambda cli: resolve_device(cli.build_parser().parse_args([]).device)
    config = default_config(datasets_base_dir=str(tmp_path), results_base_dir=str(tmp_path),
                            models_base_dir=str(tmp_path))
    train = lambda cli, argv: cli.run(cli.build_parser().parse_args(argv), config)
    for entry in (lambda: synthetic_sim_tables(), lambda: load_npz_policy(),
                  lambda: MansyActorCritic(), lambda: QoEIdentifier(),
                  lambda: cli_device(run_expert), lambda: cli_device(run_mansy),
                  lambda: cli_device(run_dagger), lambda: train(run_mansy, ["--train"]),
                  lambda: train(run_dagger, []), lambda: cli_device(run_models),
                  lambda: cli_device(predict), lambda: ViewportTransformerMTIO(),
                  lambda: train(predict, ["--model", "regression"]),
                  lambda: train(run_models, ["--test", "--model", "regression"]),
                  lambda: train(run_models, ["--train"]), lambda: SimpleActorCritic(),
                  lambda: cli_device(run_simple_rl),
                  lambda: train(run_simple_rl, ["--train", "--qoe-train-id", "0"]),
                  lambda: train(run_simple_rl, ["--test", "--qoe-train-id", "0"]),
                  lambda: train(run_ensemble, ["--ckpts", str(DAGGER_V9_NPZ), "--output-csv",
                                               str(tmp_path / "ensemble.csv")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()


def test_wrappers_take_the_plain_path_for_cpu_tensors_and_count_nothing():
    wrappers = (K1.env_step, K2.observe_mansy_pack, K2.observe_simple_pack,
                K2.derive_action_values, K3.actor_critic_forward,
                K3.actor_critic_train_forward, K3.actor_critic_backward, K4.choose_action,
                K5.build_expert_tables, K6.compute_gae, K9.policy_loss, K7.chunk_maps,
                K7.trajectory_metrics, K8.attention, K8.attention_train_forward,
                K8.attention_backward)
    for fn in wrappers:
        fn.launches = 0
    tables = synthetic_sim_tables(device="cpu")
    samples = torch.as_tensor(generate_environment_samples(2, 2, 2, 2))
    torch.manual_seed(0)
    policy = MansyActorCritic(device="cpu")
    state = init_lanes(tables, samples, 8)
    x = K2.observe_mansy_pack(tables, state)
    torch.testing.assert_close(x, K2.observe_mansy_pack_plain(tables, state), rtol=0, atol=0)
    # K2's derived mode and its row mode
    xd = K2.observe_mansy_pack(tables, state, action_values=True)
    torch.testing.assert_close(xd, K2.observe_mansy_pack_plain(tables, state, action_values=True),
                               rtol=0, atol=0)
    torch.testing.assert_close(K2.derive_action_values(xd.clone(), 8, 5, 64, 15),
                               K2.derive_action_values_plain(xd.clone(), 8, 5, 64, 15),
                               rtol=0, atol=0)
    w = policy.packed_weights()
    noise = K3.gumbel_noise((8, 15), torch.Generator().manual_seed(1), torch.device("cpu"))
    got = K3.actor_critic_forward(w, x, noise)
    for a, b in zip(got, K3.actor_critic_forward_plain(w, x, noise)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    etables = K5.build_expert_tables(tables)
    for a, b in zip(etables, build_expert_tables_plain(tables)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    bw_hat = causal_bw_estimate(tables, state)
    got = K4.choose_action(tables, etables, state, 2, bw_hat, return_margin=True)
    for a, b in zip(got, choose_action_plain(tables, etables, state, 2, bw_hat,
                                             return_margin=True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    actions = torch.as_tensor(np.arange(8, dtype=np.int32))
    new, reward, done, log = K1.env_step(tables, samples, state, actions, 8, True)
    ref = K1.env_step_plain(tables, samples, state, actions, 8, True)
    torch.testing.assert_close(reward, ref[1], rtol=0, atol=0)
    torch.testing.assert_close(new.buf, ref[0].buf, rtol=0, atol=0)
    assert new is not state  # the plain path returns a new state

    # training: K6, K3's training mode, K9 and K10
    rewards, values = torch.randn(4, 8), torch.randn(4, 8)
    dones = torch.rand(4, 8) < 0.2
    for a, b in zip(K6.compute_gae(rewards, dones, values, values[0], 0.9, 0.8),
                    K6.compute_gae_plain(rewards, dones, values, values[0], 0.9, 0.8)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    fwd = K3.actor_critic_train_forward(w, x)
    for a, b in zip(fwd, K3.actor_critic_train_forward_plain(w, x)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    dlogits, dvalue = torch.randn(8, 15), torch.randn(8)
    for a, b in zip(K3.actor_critic_backward(w, x, *fwd[2:], dlogits, dvalue),
                    K3.actor_critic_backward_plain(w, x, *fwd[2:], dlogits, dvalue)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    spec = K9.LossSpec(action=actions, ent_coef=0.1)
    for a, b in zip(K9.policy_loss(spec, fwd[0], None)[:3],
                    K9.policy_loss_plain(spec, fwd[0], None)[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    # the simple_rl modes: K2's simple mode, K3 and K10 without the cond
    # branch, K9's A2C mode
    xs = K2.observe_simple_pack(tables, state)
    torch.testing.assert_close(xs, K2.observe_simple_pack_plain(tables, state), rtol=0, atol=0)
    ws = SimpleActorCritic(device="cpu").packed_weights()
    for a, b in zip(K3.actor_critic_forward(ws, xs, noise),
                    K3.actor_critic_forward_plain(ws, xs, noise)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    fwd = K3.actor_critic_train_forward(ws, xs)
    for a, b in zip(K3.actor_critic_backward(ws, xs, *fwd[2:], dlogits, dvalue),
                    K3.actor_critic_backward_plain(ws, xs, *fwd[2:], dlogits, dvalue)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    spec = K9.LossSpec(action=actions, ent_coef=0.01, adv=dvalue, ret=rewards[0], mode="a2c")
    for a, b in zip(K9.policy_loss(spec, fwd[0], fwd[1]), K9.policy_loss_plain(spec, fwd[0],
                                                                              fwd[1])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    # viewport serving: K7's two modes and K8
    gt, pred = torch.rand(6, 15, 2), torch.rand(6, 15, 2)
    for a, b in zip(K7.chunk_maps(gt, pred, 5), K7.chunk_maps_plain(gt, pred, 5)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(K7.trajectory_metrics(gt, pred), K7.trajectory_metrics_plain(gt, pred)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    q, k, v = torch.randn(4, 1, 8, 64), torch.randn(4, 15, 8, 64), torch.randn(4, 15, 8, 64)
    torch.testing.assert_close(K8.attention(q, k, v, 3), K8.attention_plain(q, k, v, 3),
                               rtol=0, atol=0)
    # K8's training mode and backward
    keep = (torch.rand(4, 8, 1, 15) < 0.9).to(torch.uint8)
    fwd = K8.attention_train_forward(q, k, v, 3, keep, 0.1)
    for a, b in zip(fwd, K8.attention_train_forward_plain(q, k, v, 3, keep, 0.1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    dout = torch.randn_like(q)
    for a, b in zip(K8.attention_backward(dout, q, k, v, *fwd, 3, keep, 0.1),
                    K8.attention_backward_plain(dout, q, k, v, *fwd, 3, keep, 0.1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert [fn.launches for fn in wrappers] == [0] * len(wrappers)
    assert not any(getattr(fn, "launches_by_mode", None) for fn in wrappers)


@pytest.mark.parametrize("netcfg", [
    {"obs_action_values": True},
    {"obs_action_values": True, "acc_correct_obs": True},
    {"av_logit_prior": 3.0},
])
def test_load_npz_policy_builds_derived_action_value_nets(tmp_path, netcfg):
    """``obs_action_values`` (or a logit prior) without ``exact_action_values``
    builds a policy that reads the derived causal_action_values (the 11th
    branch on v16's weights; a prior alone on v9's) and asks for no tables
    (``acc_correct_obs`` only qualifies the exact field); on an observation
    without the exact field it gives the Flax net's outputs (1e-5, and the
    prior's slack of ``test_torch_derived_action_values.assert_matches_flax``)."""
    from mansy_immersivevideostreaming_tpu.models.abr_nets import MansyActorCritic as JaxAC
    from test_torch_action_values import restore_v16
    from test_torch_checkpoint import restore_v9
    from test_torch_derived_action_values import assert_matches_flax
    from test_torch_ppo import random_obs

    branch = bool(netcfg.get("obs_action_values"))
    prior = netcfg.get("av_logit_prior", 0.0)
    path = tmp_path / "policy.npz"
    shutil.copyfile(DAGGER_V16_NPZ if branch else DAGGER_V9_NPZ, path)
    with open(f"{DAGGER_V9_NPZ}{NET_CONFIG_SUFFIX}") as f:
        cfg = json.load(f)
    with open(f"{path}{NET_CONFIG_SUFFIX}", "w") as f:
        json.dump({**cfg, **netcfg}, f)
    policy = load_npz_policy(path, device="cpu")
    assert policy.use_action_values == branch and policy.av_logit_prior == prior
    assert policy.reads_action_values
    assert not policy.exact_action_values and not policy.acc_correct_obs
    obs = random_obs(np.random.default_rng(4), (24,), False)
    with torch.no_grad():
        logits, value = policy({k: torch.as_tensor(v) for k, v in obs.items()})
    assert_matches_flax(logits.numpy(), value.numpy(),
                        JaxAC(hidden_dim=128, use_action_values=branch, av_logit_prior=prior),
                        {"params": restore_v16() if branch else restore_v9()}, obs)
