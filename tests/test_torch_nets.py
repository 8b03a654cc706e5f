"""Port parity: the MANSY actor-critic with the committed v9 weights.

The same numpy observations go through the JAX package's Flax
``MansyActorCritic`` (restored from ``artifacts/round4/dagger_v9.ckpt``) and
the port's ``nn.Module`` (from the committed npz), and through the plain
version of the actor-critic kernel on the packed observation buffer.  The
round-3 flagship (``artifacts/round3/dagger_v7.ckpt``) comes across through
the Flax-to-torch converter.
Tolerance 1e-5 (relative and absolute) on logits, value and log-probs: f32
dot products of up to 1280 terms summed in different orders.  Actions must
agree wherever the top two scores are further apart than that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mansy_immersivevideostreaming_tpu.models.abr_nets import MansyActorCritic as JaxAC
from mansy_immersivevideostreaming_torch.kernels.actor_critic import (
    TENSOR_FIELDS, actor_critic_forward_plain,
)
from mansy_immersivevideostreaming_torch.kernels.observe import obs_layout
from mansy_immersivevideostreaming_torch.models.abr_nets import MansyActorCritic
from mansy_immersivevideostreaming_torch.utils.checkpoint import (
    actor_critic_state_dict_from_flax, load_net_config, load_npz_policy,
)
from test_torch_checkpoint import V7_CKPT, restore_params, restore_v9

TOL = 1e-5
N = 48


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def v9():
    params = restore_v9()
    net = JaxAC(hidden_dim=128)
    return jax.jit(lambda o: net.apply({"params": params}, o)), load_npz_policy(device="cpu")


def random_obs(seed: int):
    """A 13-field observation batch with values in the env's ranges, and its
    packed [N, 779] buffer."""
    rng = np.random.default_rng(seed)
    obs = {}
    for name, _, shape in obs_layout(8, 5, 64, 15):
        obs[name] = rng.uniform(0, 1, (N,) + shape).astype(np.float32)
    obs["pred_viewport"] = (obs["pred_viewport"] < 0.15).astype(np.float32)
    obs["qoe_weight"] /= obs["qoe_weight"].sum(-1, keepdims=True)
    packed = np.concatenate([obs[name].reshape(N, -1)
                             for name, _, _ in obs_layout(8, 5, 64, 15)], axis=1)
    return obs, packed


def _decisive(scores: np.ndarray) -> np.ndarray:
    top2 = np.sort(scores, axis=-1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_v9_logits_and_value_match_jax(v9, seed):
    jax_fn, policy = v9
    obs, packed = random_obs(seed)
    jl, jv = jax_fn({k: jnp.asarray(v) for k, v in obs.items()})
    jl, jv = np.asarray(jl), np.asarray(jv)
    with torch.no_grad():
        tl, tv = policy({k: torch.as_tensor(v) for k, v in obs.items()})
        kl, kv, ka, klp = actor_critic_forward_plain(policy.packed_weights(),
                                                     torch.as_tensor(packed))
    for logits, value in ((tl, tv), (kl, kv)):
        np.testing.assert_allclose(logits.numpy(), jl, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(value.numpy(), jv, rtol=TOL, atol=TOL)
    ok = _decisive(jl)
    assert ok.mean() > 0.9
    np.testing.assert_array_equal(ka.numpy()[ok], np.argmax(jl, -1)[ok])
    jlp = np.asarray(jax.nn.log_softmax(jnp.asarray(jl)))[np.arange(N), np.argmax(jl, -1)]
    np.testing.assert_allclose(klp.numpy()[ok], jlp[ok], rtol=TOL, atol=TOL)


def test_v7_converted_from_flax_matches_jax():
    netcfg = load_net_config(V7_CKPT)
    assert netcfg["hidden_dim"] == 128 and not netcfg["obs_action_values"] \
        and not netcfg["av_logit_prior"]
    params = restore_params(V7_CKPT)
    obs, _ = random_obs(3)
    jl, jv = JaxAC(hidden_dim=128).apply({"params": params},
                                         {k: jnp.asarray(v) for k, v in obs.items()})
    policy = MansyActorCritic(device="cpu")
    policy.load_state_dict(actor_critic_state_dict_from_flax(jax.device_get(params)))
    with torch.no_grad():
        tl, tv = policy({k: torch.as_tensor(v) for k, v in obs.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)


def test_sampling_head_is_the_gumbel_max_rule(v9):
    """With the same injected noise, the port picks argmax(logits + noise),
    the rule jax.random.categorical applies to its own Gumbel draws."""
    jax_fn, policy = v9
    obs, packed = random_obs(2)
    noise = np.random.default_rng(7).gumbel(size=(N, 15)).astype(np.float32)
    jl, _ = jax_fn({k: jnp.asarray(v) for k, v in obs.items()})
    want = np.argmax(np.asarray(jl) + noise, -1)
    with torch.no_grad():
        logits, _, action, log_prob = actor_critic_forward_plain(
            policy.packed_weights(), torch.as_tensor(packed), torch.as_tensor(noise))
    ok = _decisive(np.asarray(jl) + noise)
    np.testing.assert_array_equal(action.numpy()[ok], want[ok])
    lp = torch.log_softmax(logits, -1).gather(-1, action.long()[:, None])[:, 0]
    np.testing.assert_array_equal(log_prob.numpy(), lp.numpy())


def test_packed_weights_are_cached_until_a_parameter_changes():
    torch.manual_seed(0)
    policy = MansyActorCritic(device="cpu")
    w = policy.packed_weights()
    assert policy.packed_weights() is w
    assert not any(getattr(w, f).requires_grad for f in TENSOR_FIELDS)
    with torch.no_grad():
        policy.actor_out.bias.add_(1.0)
    w2 = policy.packed_weights()
    assert w2 is not w
    torch.testing.assert_close(w2.b_actor_out, policy.actor_out.bias.detach(), rtol=0, atol=0)
    torch.testing.assert_close(w2.b_actor_out, w.b_actor_out + 1.0, rtol=0, atol=0)
    other = MansyActorCritic(device="cpu")
    policy.load_state_dict(other.state_dict())
    torch.testing.assert_close(policy.packed_weights().w_fc, other.packed_weights().w_fc,
                               rtol=0, atol=0)


@pytest.mark.parametrize("kwargs", [dict(use_action_values=True), dict(av_logit_prior=3.0)])
def test_action_value_settings_read_the_derived_values(kwargs):
    """Each action-value setting, on an observation without the exact
    field, reads the derived causal_action_values as the JAX net does: the
    Flax net from its initialiser, carried over by the converter, gives the
    same logits and value (with the prior's slack of
    ``test_torch_derived_action_values.assert_matches_flax``)."""
    from test_torch_derived_action_values import assert_matches_flax

    obs, _ = random_obs(3)
    net = JaxAC(hidden_dim=128, **kwargs)
    params = net.init(jax.random.PRNGKey(4), {k: jnp.asarray(v) for k, v in obs.items()})
    policy = MansyActorCritic(device="cpu", **kwargs)
    assert policy.reads_action_values and not policy.exact_action_values
    policy.load_state_dict(actor_critic_state_dict_from_flax(jax.device_get(params["params"])))
    with torch.no_grad():
        logits, value = policy({k: torch.as_tensor(v) for k, v in obs.items()})
    assert_matches_flax(logits.numpy(), value.numpy(), net, params, obs)
