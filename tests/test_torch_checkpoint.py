"""The committed numpy copy of the round-4 flagship policy (dagger_v9).

The PyTorch port cannot read Orbax, so it carries the v9 params as
``mansy_immersivevideostreaming_torch/assets/dagger_v9_params.npz`` beside a
copy of the checkpoint's ``.netcfg.json``.  :func:`write_v9_npz` makes that
file from the Orbax checkpoint; the tests hold the committed copy to the
checkpoint bit for bit.

Regenerate with::

    JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests'); \
        import test_torch_checkpoint as t; t.write_v9_npz()"
"""

import json
import os
import shutil

import jax
import numpy as np
import torch

from mansy_immersivevideostreaming_tpu.cli.run_mansy import dummy_obs
from mansy_immersivevideostreaming_tpu.config import default_config
from mansy_immersivevideostreaming_tpu.models.abr_nets import MansyActorCritic as JaxAC
from mansy_immersivevideostreaming_tpu.utils.checkpoint import restore_checkpoint

from mansy_immersivevideostreaming_torch.utils.checkpoint import (
    DAGGER_V9_NPZ, NET_CONFIG_SUFFIX, flatten_params, load_npz_policy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V9_CKPT = os.path.join(REPO, "artifacts", "round4", "dagger_v9.ckpt")
V7_CKPT = os.path.join(REPO, "artifacts", "round3", "dagger_v7.ckpt")


def restore_params(ckpt: str) -> dict:
    """Flax params of a hidden-128 MansyActorCritic checkpoint, restored with
    the JAX package's own restore."""
    template = JaxAC(hidden_dim=128).init(
        jax.random.PRNGKey(0), dummy_obs(default_config()))["params"]
    return restore_checkpoint(ckpt, template)


def restore_v9() -> dict:
    return restore_params(V9_CKPT)


def write_v9_npz(path=DAGGER_V9_NPZ) -> None:
    """Write the v9 params as a flat ``/``-keyed npz plus its netcfg copy."""
    flat = flatten_params(jax.device_get(restore_v9()))
    np.savez(path, **{k: np.asarray(v, np.float32) for k, v in flat.items()})
    shutil.copyfile(V9_CKPT + NET_CONFIG_SUFFIX, f"{path}{NET_CONFIG_SUFFIX}")


def test_committed_npz_equals_orbax_checkpoint_bitwise():
    flat = flatten_params(jax.device_get(restore_v9()))
    with np.load(DAGGER_V9_NPZ) as npz:
        assert sorted(npz.files) == sorted(flat)
        assert len(npz.files) == 28
        for k in npz.files:
            assert npz[k].dtype == np.float32 and npz[k].shape == flat[k].shape, k
            np.testing.assert_array_equal(npz[k], np.asarray(flat[k]), err_msg=k)
        assert sum(npz[k].size for k in npz.files) == 427_024


def test_committed_netcfg_matches_checkpoint_sidecar():
    with open(V9_CKPT + NET_CONFIG_SUFFIX) as f:
        ref = json.load(f)
    with open(f"{DAGGER_V9_NPZ}{NET_CONFIG_SUFFIX}") as f:
        port = json.load(f)
    assert port == ref
    assert ref["hidden_dim"] == 128 and not ref["obs_action_values"]


def test_load_npz_policy_carries_every_weight():
    torch.set_num_threads(1)
    policy = load_npz_policy(device="cpu")
    flat = flatten_params(jax.device_get(restore_v9()))
    np.testing.assert_array_equal(
        policy.feature_net.branches["next_size"].weight.detach().numpy(),
        np.asarray(flat["feature_net/next_size/kernel"]).T)
    np.testing.assert_array_equal(policy.critic_out.bias.detach().numpy(),
                                  np.asarray(flat["critic_out/bias"]))
    assert sum(p.numel() for p in policy.parameters()) == 427_024
