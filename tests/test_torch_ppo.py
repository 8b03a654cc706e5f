"""Port parity: the actor-critic backward (K3 training mode + K10) and the
PPO update.

* ``actor_critic_train`` (the plain training forward and the written-out
  ``actor_critic_backward_plain`` on the CPU) against ``jax.grad`` of the
  Flax ``MansyActorCritic``: every parameter's gradient of a random linear
  functional of logits and value, at hidden 16, 100, 256 and 320 (random
  Flax init; 256 is the width of v18, 100 runs in the kernels' 128
  instance and 320 in their wide variant) and 128, for v9 (10 branches)
  and v16 (11 branches, logit prior 3.0) weights converted from Flax, and
  the plain backward against autograd of the plain forward.  Tolerance rtol
  1e-4, atol 1e-6: sums of up to 1280 terms are taken in different orders.
  Past hidden 128 (sums of up to 2816 terms at 256, 3520 at 320) the atol
  adds 1e-5 of the tensor's largest entry, as the card tests hold K10:
  there JAX's own f32 gradients lie up to 5e-6 from a float64 evaluation of
  the same function, and the port's as close.
* ``ppo_update``: one full update (2 epochs x 4 minibatches) from the same
  converted params, trajectory and minibatch permutations (the JAX update's
  own ``jax.random.permutation`` draws, handed to the port), with rew_norm
  and the value clip, per-preference advantage normalization, and the
  per-preference KL anchor.  The loss metrics and ``ret_rms`` agree to 1e-5
  (sums of 32-row minibatches in different orders).  The parameters after
  eight Adam steps agree to 2e-6 absolute (lr 5e-4 a step); Adam divides the
  first moment by the root of the second, so an entry whose gradient sits
  near 0 can step by lr in either direction: such entries are excluded and
  counted, and must be under 0.5% of all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mansy_immersivevideostreaming_tpu.models.abr_nets import MansyActorCritic as JaxAC
from mansy_immersivevideostreaming_tpu.rl import ppo as JP
from mansy_immersivevideostreaming_tpu.rl.types import RunningStat as JaxStat
from mansy_immersivevideostreaming_tpu.rl.types import Transition as JaxTransition
from mansy_immersivevideostreaming_torch.kernels import actor_critic as K3
from mansy_immersivevideostreaming_torch.kernels.observe import obs_layout, pack_obs
from mansy_immersivevideostreaming_torch.models.abr_nets import MansyActorCritic
from mansy_immersivevideostreaming_torch.rl import ppo as TP
from mansy_immersivevideostreaming_torch.rl.types import RunningStat, Transition
from mansy_immersivevideostreaming_torch.utils.checkpoint import (
    actor_critic_state_dict_from_flax, flatten_params, flax_params,
)
from test_torch_action_values import restore_v16
from test_torch_checkpoint import restore_v9

K, R, TILES, A = 8, 5, 64, 15


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def random_obs(rng, lead, av: bool):
    """An observation dict of leading shape ``lead`` with values in the env's
    ranges (and the 14th field when ``av``)."""
    obs = {}
    for name, _, shape in obs_layout(K, R, TILES, A, av):
        obs[name] = rng.uniform(0, 1, lead + shape).astype(np.float32)
    obs["pred_viewport"] = (obs["pred_viewport"] < 0.15).astype(np.float32)
    obs["qoe_weight"] /= obs["qoe_weight"].sum(-1, keepdims=True)
    onehot = np.eye(A, dtype=np.float32)[rng.integers(0, A, lead)]
    obs["action_one_hot"] = onehot
    if av:
        obs["action_values"] = rng.normal(0, 0.3, lead + (A + 1,)).astype(np.float32)
    return obs


def make_nets(kind: str, hidden: int):
    """(Flax module, Flax params, port policy with the same weights)."""
    av = kind == "v16"
    net = JaxAC(hidden_dim=hidden, use_action_values=av, av_logit_prior=3.0 if av else 0.0)
    if hidden == 128:
        params = restore_v16() if av else restore_v9()
    else:
        obs0 = {k: jnp.asarray(v) for k, v in random_obs(np.random.default_rng(0), (2,), av).items()}
        params = net.init(jax.random.PRNGKey(3), obs0)["params"]
    policy = MansyActorCritic(hidden_dim=hidden, use_action_values=av,
                              av_logit_prior=3.0 if av else 0.0, device="cpu")
    policy.load_state_dict(actor_critic_state_dict_from_flax(jax.device_get(params)))
    return net, params, policy


def port_grads(policy: MansyActorCritic) -> dict:
    """The port's parameter gradients in the flat Flax layout."""
    out = {}
    for name, layer in policy.named_modules():
        if isinstance(layer, torch.nn.Linear):
            path = name.replace("feature_net.branches.", "feature_net/")
            out[f"{path}/kernel"] = layer.weight.grad.t().numpy()
            out[f"{path}/bias"] = layer.bias.grad.numpy()
    return out


@pytest.mark.parametrize("kind,hidden", [("v9", 16), ("v16", 16), ("v9", 100), ("v16", 100),
                                         ("v9", 128), ("v16", 128), ("v9", 256), ("v16", 256),
                                         ("v9", 320), ("v16", 320)])
def test_actor_critic_gradients_match_jax_grad(kind, hidden):
    rng = np.random.default_rng(hidden + len(kind))
    obs = random_obs(rng, (40,), kind == "v16")
    gl = rng.normal(size=(40, A)).astype(np.float32)
    gv = rng.normal(size=(40,)).astype(np.float32)
    net, params, policy = make_nets(kind, hidden)

    def functional(p):
        logits, value = net.apply({"params": p}, {k: jnp.asarray(v) for k, v in obs.items()})
        return jnp.sum(logits * gl) + jnp.sum(value * gv)
    want = flatten_params(jax.device_get(jax.jit(jax.grad(functional))(params)))

    logits, value = policy.forward_packed(pack_obs(obs))
    ((logits * torch.as_tensor(gl)).sum() + (value * torch.as_tensor(gv)).sum()).backward()
    got = port_grads(policy)
    assert sorted(got) == sorted(want)
    for k in want:
        wide = 1e-5 * float(np.abs(want[k]).max()) if hidden > 128 else 0.0
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6 + wide, err_msg=k)


def test_plain_backward_matches_autograd_of_plain_forward():
    torch.manual_seed(0)
    policy = MansyActorCritic(hidden_dim=32, use_action_values=True, av_logit_prior=2.0,
                              device="cpu")
    x = pack_obs(random_obs(np.random.default_rng(1), (24,), True))
    w = policy._pack()
    tensors = [getattr(w, f) for f in K3.TENSOR_FIELDS]
    gl, gv = torch.randn(24, A), torch.randn(24)
    logits, value, _, _ = K3.actor_critic_forward_plain(w, x)
    want = torch.autograd.grad((logits * gl).sum() + (value * gv).sum(), tensors)
    _, _, feats, hidden = K3.actor_critic_train_forward_plain(w, x)
    got = K3.actor_critic_backward(w, x, feats, hidden, gl, gv)
    for f, g, r in zip(K3.TENSOR_FIELDS, got, want):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6, msg=f)


# ------------------------------------------------------------ ppo_update

T, N, MB, PREFS = 8, 16, 32, 4
CONFIGS = {
    "rew_norm": dict(cfg={}, anchor=False, per_pref=False),
    "per_pref": dict(cfg=dict(norm_adv_per_pref=True, value_clip=False), anchor=False,
                     per_pref=True),
    "kl_anchor": dict(cfg=dict(rew_norm=False), anchor=True, per_pref=True),
}


def trajectory(rng, net, params):
    """A [T, N] trajectory: random observations, the policy's own values and
    the log-probs of random actions (perturbed, so ratios leave the clip
    range), random rewards and dones."""
    obs = random_obs(rng, (T, N), False)
    flat = {k: jnp.asarray(v.reshape((T * N,) + v.shape[2:])) for k, v in obs.items()}
    logits, value = net.apply({"params": params}, flat)
    logits, value = np.asarray(logits).reshape(T, N, A), np.asarray(value).reshape(T, N)
    action = rng.integers(0, A, (T, N)).astype(np.int32)
    logp = np.take_along_axis(np.asarray(jax.nn.log_softmax(logits)), action[..., None], -1)[..., 0]
    return dict(obs=obs, action=action,
                log_prob=(logp + rng.normal(0, 0.2, (T, N))).astype(np.float32),
                value=(np.asarray(value) + rng.normal(0, 0.3, (T, N))).astype(np.float32),
                reward=rng.normal(0.3, 1.0, (T, N)).astype(np.float32),
                done=rng.random((T, N)) < 0.15,
                last_values=rng.normal(0, 1, N).astype(np.float32),
                pref=rng.integers(0, PREFS, (T, N)).astype(np.int32),
                anchor=rng.normal(0, 1.5, (T, N, A)).astype(np.float32))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_ppo_update_matches_jax(name):
    spec = CONFIGS[name]
    cfg_kw = dict(minibatch=MB, repeat=2, n_prefs=PREFS, **spec["cfg"])
    rng = np.random.default_rng(len(name))
    net, params, policy = make_nets("v9", 16)
    tr = trajectory(rng, net, params)
    kl = np.asarray([2.0, 1.0, 0.1, 0.5], np.float32) if spec["anchor"] else 0.0
    stat0 = (0.3, 2.0, 50.0)  # a running stat some collects in

    before = {k: v.copy() for k, v in flatten_params(jax.device_get(params)).items()}
    jcfg = JP.PPOConfig(**cfg_kw)
    optimizer = JP.make_optimizer(5e-4)
    jtraj = JaxTransition(obs={k: jnp.asarray(v) for k, v in tr["obs"].items()},
                          action=jnp.asarray(tr["action"]), log_prob=jnp.asarray(tr["log_prob"]),
                          value=jnp.asarray(tr["value"]), reward=jnp.asarray(tr["reward"]),
                          done=jnp.asarray(tr["done"]))
    key = jax.random.PRNGKey(7)
    jparams, _, jstat, jm = JP.ppo_update(
        lambda p, o: net.apply({"params": p}, o), optimizer, jcfg, params,
        optimizer.init(params), jtraj, jnp.asarray(tr["reward"]), jnp.asarray(tr["last_values"]),
        JaxStat(*map(jnp.float32, stat0)), key, None,
        anchor_logits=jnp.asarray(tr["anchor"]) if spec["anchor"] else None,
        kl_coef=jnp.asarray(kl), pref_ids=jnp.asarray(tr["pref"]) if spec["per_pref"] else None)
    # the permutations the JAX update drew (ppo.py:158, :176)
    perms = np.stack([np.asarray(jax.random.permutation(k, T * N))[:T * N // MB * MB]
                      .reshape(-1, MB) for k in jax.random.split(key, 2)])

    traj = Transition(obs=pack_obs(tr["obs"]).reshape(T, N, -1),
                      action=torch.as_tensor(tr["action"]),
                      log_prob=torch.as_tensor(tr["log_prob"]),
                      value=torch.as_tensor(tr["value"]), reward=torch.as_tensor(tr["reward"]),
                      done=torch.as_tensor(tr["done"]))
    opt = TP.make_optimizer(policy.parameters(), 5e-4)
    stat, m = TP.ppo_update(
        policy, opt, TP.PPOConfig(**cfg_kw), traj, traj.reward,
        torch.as_tensor(tr["last_values"]),
        RunningStat(*(torch.tensor(v, dtype=torch.float32) for v in stat0)),
        anchor_logits=torch.as_tensor(tr["anchor"]) if spec["anchor"] else None,
        kl_coef=kl, pref_ids=torch.as_tensor(tr["pref"]) if spec["per_pref"] else None,
        perms=torch.as_tensor(perms))

    for k in ("loss", "loss/clip", "loss/vf", "loss/ent"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    for a, b in zip(stat, jstat):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)

    got = flax_params(policy)
    want = flatten_params(jax.device_get(jparams))
    excluded, total = 0, 0
    for k in want:
        moved = np.abs(want[k] - before[k])
        assert moved.max() > 1e-4, f"{k} did not move"
        diff = np.abs(got[k] - want[k])
        # an entry whose JAX step is well short of lr a step had gradients near 0
        ambiguous = moved < 0.5 * 8 * 5e-4
        assert (diff[~ambiguous] <= 2e-6).all(), f"{k}: {diff[~ambiguous].max()}"
        excluded += int((ambiguous & (diff > 2e-6)).sum())
        total += diff.size
    assert excluded <= 0.005 * total, f"{excluded} of {total} entries differ beyond 2e-6"

