"""Port parity: the exact action-value observation and the v16 policy.

* ``exact_action_values`` and the 14-field ``observe_mansy``, with and
  without the accuracy correction, against the JAX package on tables with
  the expert's deployable tables attached (each package attaches its own).
  Tolerance rtol 1e-5, atol 1e-6 (the tables' 64-tile sums associate
  differently; values near 0 compare absolutely).
* The packed observation (K2's plain version) with the action values: the
  16 columns right after ``qoe_weight``.
* The committed ``assets/dagger_v16_params.npz``: bit for bit the Orbax
  checkpoint ``artifacts/round4/dagger_v16.ckpt``; its sidecar a copy.  The
  v16 network (11 branches, logit prior 3.0) gives the JAX network's logits
  and value to 1e-5.

Regenerate the npz with::

    JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests'); \\
        import test_torch_action_values as t; t.write_v16_npz()"
"""

import functools
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
from mansy_immersivevideostreaming_tpu.sim import env as JE
from mansy_immersivevideostreaming_tpu.sim import expert as JX
from mansy_immersivevideostreaming_tpu.utils.checkpoint import restore_checkpoint
from mansy_immersivevideostreaming_torch.kernels import actor_critic as K3
from mansy_immersivevideostreaming_torch.kernels import observe as K2
from mansy_immersivevideostreaming_torch.rl.runner import evaluate
from mansy_immersivevideostreaming_torch.sim import env as TE
from mansy_immersivevideostreaming_torch.sim import expert as TX
from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables
from mansy_immersivevideostreaming_torch.utils.checkpoint import (
    DAGGER_V16_NPZ, NET_CONFIG_SUFFIX, flatten_params, load_npz_policy,
)
from test_torch_checkpoint import REPO
from test_torch_expert import lanes_through_episodes, make_tables, to_jax_state

V16_CKPT = os.path.join(REPO, "artifacts", "round4", "dagger_v16.ckpt")
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def v16_net() -> JaxAC:
    return JaxAC(hidden_dim=128, use_action_values=True, av_logit_prior=3.0)


@functools.lru_cache(maxsize=1)
def restore_v16() -> dict:
    """The v16 Flax params, restored with the JAX package's own restore
    (once a process; callers do not modify them)."""
    template = v16_net().init(jax.random.PRNGKey(0), dummy_obs(
        default_config(), exact_action_values=True))["params"]
    return restore_checkpoint(V16_CKPT, template)


def write_v16_npz(path=DAGGER_V16_NPZ) -> None:
    """Write the v16 params as a flat ``/``-keyed npz plus its netcfg copy."""
    flat = flatten_params(jax.device_get(restore_v16()))
    np.savez(path, **{k: np.asarray(v, np.float32) for k, v in flat.items()})
    shutil.copyfile(V16_CKPT + NET_CONFIG_SUFFIX, f"{path}{NET_CONFIG_SUFFIX}")


@pytest.fixture(scope="module")
def attached():
    """{acc_correct: (JAX tables, port tables)} with the av tables attached."""
    # no empty ground-truth viewport: its NaN quality would reach the values
    jt, tt = make_tables(seed=5, empty_viewports=False)
    jet, tet = JX.build_expert_tables(jt), TX.build_expert_tables_plain(tt)
    return {acc: (JX.attach_action_values(jt, jet, acc_correct=acc),
                  TX.attach_action_values(tt, tet, acc_correct=acc)) for acc in (False, True)}


@pytest.mark.parametrize("acc_correct", [False, True])
def test_observe_mansy_with_action_values_matches_jax(attached, acc_correct):
    jt, tt = attached[acc_correct]
    assert (tt.av_out_quality is not None) == acc_correct
    state = lanes_through_episodes(tt, seed=7)
    got = TE.observe_mansy(tt, state)
    want = jax.vmap(lambda s: JE.observe_mansy(jt, s))(to_jax_state(state))
    assert sorted(got) == sorted(want) and len(got) == 14
    for name, x in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(x), err_msg=name, **TOL)
    assert got["action_values"].shape == (state.buf.shape[0], 16)
    # bw_hat is the last column; the accuracy correction moves the values
    np.testing.assert_allclose(got["action_values"][:, -1].numpy(),
                               TE.harmonic_bw_estimate(state.past_throughput).numpy())


def test_acc_correction_changes_the_values(attached):
    state = lanes_through_episodes(attached[False][1], seed=7)
    plain = TE.exact_action_values(attached[False][1], state)
    corrected = TE.exact_action_values(attached[True][1], state)
    assert not torch.allclose(plain[:, :15], corrected[:, :15])
    torch.testing.assert_close(plain[:, 15], corrected[:, 15], rtol=0, atol=0)


def test_packed_observation_carries_action_values(attached):
    tt = attached[True][1]
    state = lanes_through_episodes(tt, seed=8)
    dims = K2.obs_dims(tt)
    assert dims == (8, 5, 64, 15, True)
    assert K2.feature_width(*dims) == 764 and K2.obs_width(*dims) == 795
    names = [name for name, _, _ in K2.obs_layout(*dims)]
    assert len(names) == 14 and names[K2.NET_FIELDS] == "action_values"
    assert names[K2.NET_FIELDS - 1] == "qoe_weight"
    packed = K2.observe_mansy_pack(tt, state)
    assert packed.shape == (state.buf.shape[0], 795)
    obs = TE.observe_mansy(tt, state)
    for name, view in K2.unpack_obs(packed, *dims).items():
        torch.testing.assert_close(view, obs[name], rtol=0, atol=0)
    torch.testing.assert_close(packed[:, 748:764], obs["action_values"], rtol=0, atol=0)


def test_committed_v16_npz_equals_orbax_checkpoint_bitwise():
    flat = flatten_params(jax.device_get(restore_v16()))
    with np.load(DAGGER_V16_NPZ) as npz:
        assert sorted(npz.files) == sorted(flat) and len(npz.files) == 30
        for k in npz.files:
            assert npz[k].dtype == np.float32 and npz[k].shape == flat[k].shape, k
            np.testing.assert_array_equal(npz[k], np.asarray(flat[k]), err_msg=k)
        assert npz["feature_net/action_values/kernel"].shape == (16, 128)
    with open(V16_CKPT + NET_CONFIG_SUFFIX) as f:
        ref = json.load(f)
    with open(f"{DAGGER_V16_NPZ}{NET_CONFIG_SUFFIX}") as f:
        assert json.load(f) == ref
    assert ref["exact_action_values"] and ref["acc_correct_obs"] and ref["av_logit_prior"] == 3.0


def test_load_npz_policy_reads_the_v16_sidecar():
    policy = load_npz_policy(DAGGER_V16_NPZ, device="cpu")
    assert policy.use_action_values and policy.av_logit_prior == 3.0
    assert policy.reads_action_values and policy.acc_correct_obs
    assert sum(p.numel() for p in policy.parameters()) == 461_968
    w = policy.packed_weights()
    assert len(w.branch_off) == 12 and w.branch_off[-1] == 764 and w.av_off == 748
    v9 = load_npz_policy(device="cpu")
    assert not v9.reads_action_values and not v9.acc_correct_obs


def test_v16_network_matches_jax(attached):
    jt, tt = attached[True]
    state = lanes_through_episodes(tt, seed=9)
    obs = TE.observe_mansy(tt, state)
    policy = load_npz_policy(DAGGER_V16_NPZ, device="cpu")
    with torch.no_grad():
        logits, value = policy(obs)
    jl, jv = v16_net().apply({"params": restore_v16()},
                             {k: jnp.asarray(v.numpy()) for k, v in obs.items()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    # the kernel's plain version on the packed observation is the same function
    got = K3.actor_critic_forward(policy.packed_weights(), K2.observe_mansy_pack(tt, state))
    torch.testing.assert_close(got[0], logits, rtol=0, atol=0)
    torch.testing.assert_close(got[1], value, rtol=0, atol=0)
    assert torch.equal(got[2], logits.argmax(-1).to(torch.int32))


def test_the_prior_standardizes_with_the_population_std():
    torch.manual_seed(0)
    w = load_npz_policy(DAGGER_V16_NPZ, device="cpu").packed_weights()
    x = torch.randn(5, 795)
    base = K3.actor_critic_forward_plain(w._replace(av_prior=0.0), x)[0]
    av = x[:, 748:763].double()
    z = (av - av.mean(-1, keepdim=True)) / (
        ((av - av.mean(-1, keepdim=True)) ** 2).mean(-1, keepdim=True).sqrt() + 1e-6)
    got = K3.actor_critic_forward_plain(w, x)[0]
    np.testing.assert_allclose(got.numpy(), (base.double() + 3.0 * z).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_action_value_policy_needs_attached_tables():
    """v16 was trained on the exact field, so serving it needs tables that
    carry it; its forward on a dict without the field reads the derived
    values, as the JAX net does (``abr_nets.py:_action_value_features``)."""
    policy = load_npz_policy(DAGGER_V16_NPZ, device="cpu")
    tables = synthetic_sim_tables(device="cpu")
    samples = torch.as_tensor(TE.generate_environment_test_samples(2, 2, 2, 2))
    with pytest.raises(ValueError, match="action_values"):
        evaluate(policy, tables, samples, deterministic=True)
    state = TE.reset_env(tables, samples, torch.arange(4), 4)
    for _ in range(3):  # a history, a previous action
        state, *_ = TE.step_env(tables, samples, state, torch.arange(4, dtype=torch.int32) * 3,
                                4, False)
    obs = TE.observe_mansy(tables, state)
    assert "action_values" not in obs
    with torch.no_grad():
        logits, value = policy(obs)
    jl, jv = v16_net().apply({"params": restore_v16()},
                             {k: jnp.asarray(v.numpy()) for k, v in obs.items()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
