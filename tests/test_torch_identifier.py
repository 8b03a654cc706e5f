"""Port parity: the QoE-preference identifier and its training.

The same numpy observations go through the JAX package's Flax
``QoEIdentifier`` (random init at hidden 16) and the port's (its params
converted from Flax, reading the packed buffer), and through both
packages' ``identifier_rewards``, ``shape_rewards``,
``center_rewards_by_preference``, ``train_identifier_on_buffer`` (the JAX
shuffle handed to the port) and ``pretrain_identifier_on_demos`` (the JAX
split and minibatch indices handed to the port).  The identifier reads the
previous action stored in the observation (``action_one_hot``) and ignores
the action-value columns.

Tolerance: predictions and rewards 1e-5 (relative and absolute, f32 dot
products in different orders); losses after Adam steps 1e-5; parameters
after them 2e-6 absolute with Adam's near-zero-gradient entries excluded
and counted (as ``test_torch_ppo``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mansy_immersivevideostreaming_tpu.models.abr_nets import QoEIdentifier as JaxID
from mansy_immersivevideostreaming_tpu.rl import identifier as JI
from mansy_immersivevideostreaming_tpu.rl import ppo as JP
from mansy_immersivevideostreaming_torch.kernels.observe import pack_obs
from mansy_immersivevideostreaming_torch.models.abr_nets import QoEIdentifier
from mansy_immersivevideostreaming_torch.rl import identifier as TI
from mansy_immersivevideostreaming_torch.rl.ppo import make_optimizer
from mansy_immersivevideostreaming_torch.utils.checkpoint import (
    flatten_params, flax_params, identifier_state_dict_from_flax,
)
from test_torch_ppo import random_obs

TOL = 1e-5
PREFS = np.asarray([[7, 1, 1], [1, 7, 1], [1, 1, 7], [3, 3, 3]], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def nets(av=False):
    """(Flax apply, Flax params, port identifier with the same weights)."""
    net = JaxID(hidden_dim=16)
    obs0 = {k: jnp.asarray(v) for k, v in random_obs(np.random.default_rng(0), (2,), av).items()}
    params = net.init(jax.random.PRNGKey(1), obs0)["params"]
    ident = QoEIdentifier(hidden_dim=16, device="cpu")
    ident.load_state_dict(identifier_state_dict_from_flax(jax.device_get(params)))
    return (lambda p, o: net.apply({"params": p}, o)), params, ident


def pref_obs(rng, n, av=False):
    """Observations whose preferences are the normalized training set."""
    obs = random_obs(rng, (n,), av)
    w = PREFS[rng.integers(0, len(PREFS), n)]
    obs["qoe_weight"] = w / w.sum(-1, keepdims=True)
    return obs


def assert_params_close(ident, jparams, before, steps, lr):
    got, want = flax_params(ident), flatten_params(jax.device_get(jparams))
    excluded = total = 0
    for k in want:
        moved = np.abs(want[k] - before[k])
        diff = np.abs(got[k] - want[k])
        ambiguous = moved < 0.5 * steps * lr
        assert (diff[~ambiguous] <= 2e-6).all(), f"{k}: {diff[~ambiguous].max()}"
        excluded += int((ambiguous & (diff > 2e-6)).sum())
        total += diff.size
    assert excluded <= 0.005 * total, f"{excluded} of {total}"


@pytest.mark.parametrize("av", [False, True])
def test_identifier_forward_and_rewards_match_jax(av):
    apply, params, ident = nets()
    rng = np.random.default_rng(2)
    obs = pref_obs(rng, 64, av)
    jobs = {k: jnp.asarray(v) for k, v in obs.items() if k != "action_values"}
    x = pack_obs(obs)
    with torch.no_grad():
        np.testing.assert_allclose(ident(x).numpy(), np.asarray(apply(params, jobs)),
                                   rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ident.target(x).numpy(), obs["qoe_weight"], rtol=0, atol=0)
    rew = TI.identifier_rewards(ident, x)
    jrew = JI.identifier_rewards(apply, params, jobs)
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), rtol=TOL, atol=TOL)

    q = rng.normal(0, 1, 64).astype(np.float32)
    np.testing.assert_allclose(
        TI.shape_rewards(torch.as_tensor(q), rew, 0.3).numpy(),
        np.asarray(JI.shape_rewards(jnp.asarray(q), jrew, 0.3)), rtol=TOL, atol=TOL)
    prefs = PREFS / PREFS.sum(-1, keepdims=True)
    got = TI.center_rewards_by_preference(rew.reshape(8, 8), ident.target(x).reshape(8, 8, 3),
                                          torch.as_tensor(prefs))
    want = JI.center_rewards_by_preference(jrew.reshape(8, 8), jobs["qoe_weight"].reshape(8, 8, 3),
                                           jnp.asarray(prefs))
    assert got.shape == (8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_train_identifier_on_buffer_matches_jax():
    apply, params, ident = nets()
    obs = pref_obs(np.random.default_rng(3), 80)
    before = {k: v.copy() for k, v in flatten_params(jax.device_get(params)).items()}
    opt = JP.make_optimizer(1e-3, 1e-2)
    key = jax.random.PRNGKey(4)
    jp, _, jlosses, jvalid = JI.train_identifier_on_buffer(
        apply, opt, params, opt.init(params), {k: jnp.asarray(v) for k, v in obs.items()},
        key, 3)
    perm = np.asarray(jax.random.permutation(key, 80))
    losses, valid = TI.train_identifier_on_buffer(
        ident, make_optimizer(ident.parameters(), 1e-3, 1e-2), pack_obs(obs), None, 3,
        perm=torch.as_tensor(perm))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(valid), float(jvalid), rtol=TOL, atol=TOL)
    assert_params_close(ident, jp, before, 3, 1e-3)


def test_pretrain_identifier_on_demos_matches_jax():
    apply, params, ident = nets()
    obs = pref_obs(np.random.default_rng(5), 120)
    before = {k: v.copy() for k, v in flatten_params(jax.device_get(params)).items()}
    opt = JP.make_optimizer(1e-3, 1e-2)
    key = jax.random.PRNGKey(6)
    steps, bs = 4, 32
    jp, _, jlosses, jvalid = JI.pretrain_identifier_on_demos(
        apply, opt, params, opt.init(params), {k: jnp.asarray(v) for k, v in obs.items()},
        steps, bs, key)
    # the JAX function's draws (identifier.py:120-131)
    k, k_split = jax.random.split(key)
    perm = np.asarray(jax.random.permutation(k_split, 120))
    n_train = 120 - 12
    idx = []
    for _ in range(steps):
        k, sub = jax.random.split(k)
        idx.append(np.asarray(jax.random.randint(sub, (bs,), 0, n_train)))
    losses, valid = TI.pretrain_identifier_on_demos(
        ident, make_optimizer(ident.parameters(), 1e-3, 1e-2), pack_obs(obs), steps, bs,
        perm=torch.as_tensor(perm), indices=torch.as_tensor(np.stack(idx)))
    np.testing.assert_allclose(losses, jlosses, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(valid, jvalid, rtol=TOL, atol=TOL)
    assert_params_close(ident, jp, before, steps, 1e-3)
