"""Hidden-256 policies in the port: the committed numpy copy of dagger_v18.

v18 is a plain ``MansyActorCritic`` of hidden width 256 (its sidecar,
``artifacts/round5/dagger_v18.ckpt.netcfg.json``).  The port cannot read
Orbax, so it carries the params as
``mansy_immersivevideostreaming_torch/assets/dagger_v18_params.npz`` beside
a copy of the sidecar; :func:`write_v18_npz` makes that file from the Orbax
checkpoint.  Held here, at the suite's small sizes:

* the committed npz equals the Orbax-restored params bit for bit, and its
  sidecar the checkpoint's;
* a deterministic v18 evaluation on ``synthetic_sim_tables`` gives the JAX
  package's per-episode records (tolerance as ``test_torch_slice.py``'s:
  ints exact, floats 1e-5);
* ``run_dagger --hidden-dim 256`` runs a round on the synthetic tree, and
  the policy it writes loads into the JAX package's Flax net with the same
  outputs.

Regenerate the npz with::

    JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests'); \
        import test_torch_hidden256 as t; t.write_v18_npz()"
"""

import functools
import glob
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mansy_immersivevideostreaming_tpu.cli.run_mansy import dummy_obs
from mansy_immersivevideostreaming_tpu.config import default_config
from mansy_immersivevideostreaming_tpu.models.abr_nets import MansyActorCritic as JaxAC
from mansy_immersivevideostreaming_tpu.rl import runner as JRun
from mansy_immersivevideostreaming_tpu.sim.env import observe_mansy
from mansy_immersivevideostreaming_tpu.sim.tables import synthetic_sim_tables as jax_tables
from mansy_immersivevideostreaming_tpu.utils.checkpoint import restore_checkpoint
from mansy_immersivevideostreaming_torch.cli import run_dagger, run_expert
from mansy_immersivevideostreaming_torch.rl import runner as TRun
from mansy_immersivevideostreaming_torch.sim.env import generate_environment_test_samples
from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables
from mansy_immersivevideostreaming_torch.utils.checkpoint import (
    DAGGER_V18_NPZ, NET_CONFIG_SUFFIX, flatten_params, load_net_config, load_npz_policy,
)
from synthetic_tree import build_synthetic_tree
from test_torch_checkpoint import REPO
from test_torch_slice import _assert_same_evaluation
from test_torch_tables import port_config
from test_torch_train_cli import assert_policy_loads_into_flax

V18_CKPT = os.path.join(REPO, "artifacts", "round5", "dagger_v18.ckpt")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@functools.lru_cache(maxsize=1)
def restore_v18() -> dict:
    """The v18 Flax params (hidden 256), restored with the JAX package's own
    restore (once a process; callers do not modify them)."""
    template = JaxAC(hidden_dim=256).init(
        jax.random.PRNGKey(0), dummy_obs(default_config()))["params"]
    return restore_checkpoint(V18_CKPT, template)


def write_v18_npz(path=DAGGER_V18_NPZ) -> None:
    """Write the v18 params as a flat ``/``-keyed npz plus its netcfg copy."""
    flat = flatten_params(jax.device_get(restore_v18()))
    np.savez(path, **{k: np.asarray(v, np.float32) for k, v in flat.items()})
    shutil.copyfile(V18_CKPT + NET_CONFIG_SUFFIX, f"{path}{NET_CONFIG_SUFFIX}")


def test_committed_v18_npz_equals_orbax_checkpoint_bitwise():
    flat = flatten_params(jax.device_get(restore_v18()))
    with np.load(DAGGER_V18_NPZ) as npz:
        assert sorted(npz.files) == sorted(flat)
        assert len(npz.files) == 28
        for k in npz.files:
            assert npz[k].dtype == np.float32 and npz[k].shape == flat[k].shape, k
            np.testing.assert_array_equal(npz[k], np.asarray(flat[k]), err_msg=k)
        assert npz["feature_net/cond/kernel"].shape[1] == 256
        assert npz["actor_fc/kernel"].shape == (10 * 256, 256)


def test_committed_v18_netcfg_matches_checkpoint_sidecar():
    with open(V18_CKPT + NET_CONFIG_SUFFIX) as f:
        ref = json.load(f)
    assert load_net_config(DAGGER_V18_NPZ) == ref
    assert ref["hidden_dim"] == 256 and not ref["exact_action_values"]
    policy = load_npz_policy(DAGGER_V18_NPZ, device="cpu")
    assert policy.packed_weights().b_branch.shape == (10, 256)
    assert sum(p.numel() for p in policy.parameters()) == sum(
        np.asarray(v).size for v in flatten_params(jax.device_get(restore_v18())).values())


@pytest.mark.parametrize("grid", [(2, 2, 2, 20, 2, 2), (2, 3, 2, 16, 4, 7)])
def test_deterministic_v18_evaluation_matches_jax(grid):
    *dims, seed = grid
    V, U, NT, _, Q = dims
    samples = generate_environment_test_samples(V, U, NT, Q)
    net = JaxAC(hidden_dim=256)
    jlogs, jmasks = JRun.evaluate(lambda p, o: net.apply({"params": p}, o), restore_v18(),
                                  jax_tables(*dims, seed=seed), jnp.asarray(samples),
                                  observe_mansy, jax.random.PRNGKey(0), lane_chunk=24,
                                  deterministic=True)
    tlogs, tmasks = TRun.evaluate(load_npz_policy(DAGGER_V18_NPZ, device="cpu"),
                                  synthetic_sim_tables(*dims, seed=seed, device="cpu"),
                                  torch.as_tensor(samples), lane_chunk=24, deterministic=True)
    _assert_same_evaluation(tlogs, tmasks, jlogs, jmasks, len(samples))


def test_run_dagger_at_hidden_256_runs_a_round(tmp_path):
    cfg = port_config(build_synthetic_tree(str(tmp_path)))
    run_expert.run(run_expert.build_parser().parse_args(
        ["--train", "--horizon", "1", "--lane-chunk", "8", "--device", "cpu"]), cfg)
    (demos,) = glob.glob(os.path.join(str(tmp_path), "models", "bitrate_selection", "expert",
                                      "**", "train_demonstrations.pkl"), recursive=True)
    out = run_dagger.run(run_dagger.build_parser().parse_args([
        "--demos-path", demos, "--rounds", "1", "--lanes", "4", "--bc-steps", "5",
        "--batch-size", "32", "--horizon", "1", "--hidden-dim", "256",
        "--init-path", str(DAGGER_V18_NPZ), "--device", "cpu"]), cfg)
    for path in (out, out + ".last"):
        assert load_net_config(path)["hidden_dim"] == 256
        assert_policy_loads_into_flax(path)
