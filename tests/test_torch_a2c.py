"""The simple_rl (A2C) baseline in the port against the JAX package's, on
the CPU.

* K2's simple mode (``observe_simple_pack_plain``) against JAX's
  ``observe_simple``, packed in ``SimpleActorCritic``'s concat order;
* ``SimpleActorCritic`` through K3's plain version (five branches, no
  residual) against the Flax module at hidden 16 and 128;
* K9's A2C mode (plain version) against ``jax.value_and_grad`` of
  ``rl/a2c.py``'s ``loss_fn`` with the identity ``apply_fn`` (the function
  itself, taken from a trace of ``a2c_update``);
* K3's simple training mode with K10's simple plain version against
  ``jax.grad`` of the Flax module (hidden 16 and 128);
* one ``a2c_update`` against JAX's, with JAX's own minibatch permutations:
  ``rew_norm`` 1 and 0, ``repeat`` 1 and 2 (metrics and ``ret_rms`` rtol
  1e-5; parameters after RMSprop atol 1e-6);
* ``run_simple_rl``: the JAX CLI's ``--train`` on the synthetic tree, its
  ``_best_policy.ckpt`` converted to npz, then the port's ``--test
  --deterministic-eval`` writes JAX's ``results.csv``; the port's ``--train
  --test`` writes JAX's file set (``.npz`` for ``.ckpt``, the ``_tb``
  TensorBoard directory too), and its npz loads into the Flax net with the
  same outputs.

Tolerances: the observation and the forward 1e-5 (f32 sums in other
orders); gradients rtol 1e-4, atol 1e-6 plus 1e-5 of the tensor's largest
entry, as ``test_torch_ppo.py`` holds hidden 256: from Flax's random init
on these inputs the fc gradients reach 14, and JAX's own f32 gradients lie
up to 4e-6 from a float64 evaluation of the same function (the port's up
to 5e-6); the CSV values are rounded to 5 digits and held to 1e-5 relative
and absolute.
"""

import glob
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mansy_immersivevideostreaming_tpu.cli import run_simple_rl as JCLI
from mansy_immersivevideostreaming_tpu.models.abr_nets import SimpleActorCritic as JaxSimple
from mansy_immersivevideostreaming_tpu.rl import a2c as JA
from mansy_immersivevideostreaming_tpu.rl import rollout as JR
from mansy_immersivevideostreaming_tpu.rl.types import RunningStat as JaxStat
from mansy_immersivevideostreaming_tpu.rl.types import Transition as JaxTransition
from mansy_immersivevideostreaming_tpu.sim import env as JE
from mansy_immersivevideostreaming_tpu.utils.checkpoint import restore_checkpoint
from mansy_immersivevideostreaming_torch.cli import run_simple_rl as TCLI
from mansy_immersivevideostreaming_torch.kernels import actor_critic as K3
from mansy_immersivevideostreaming_torch.kernels import observe as K2
from mansy_immersivevideostreaming_torch.kernels import policy_loss as K9
from mansy_immersivevideostreaming_torch.models.abr_nets import SimpleActorCritic
from mansy_immersivevideostreaming_torch.rl import a2c as TA
from mansy_immersivevideostreaming_torch.rl import rollout as TR
from mansy_immersivevideostreaming_torch.rl.types import RunningStat, Transition
from mansy_immersivevideostreaming_torch.sim import env as TE
from mansy_immersivevideostreaming_torch.utils.checkpoint import (
    flatten_params, flax_params, load_npz_into, simple_state_dict_from_flax,
)
from synthetic_tree import build_synthetic_tree
from test_torch_env import make_tables
from test_torch_tables import port_config
from test_torch_train_cli import flax_tree

K, R, TILES, A = 8, 5, 64, 15
TOL = 1e-5
identity = lambda p, o: (p["logits"], p["value"])


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def random_simple_obs(rng, lead):
    """A simple_rl observation dict of leading shape ``lead`` in the env's ranges."""
    obs = {name: rng.uniform(0, 1, lead + shape).astype(np.float32)
           for name, _, shape in K2.simple_layout(K, R, TILES)}
    obs["rebuffer"] *= 3.0
    obs["pred_viewport"] = (obs["pred_viewport"] < 0.15).astype(np.float32)
    return obs


def make_nets(hidden: int, seed: int = 0):
    """(Flax module, Flax params, port policy with the same weights)."""
    net = JaxSimple(hidden_dim=hidden)
    obs0 = {k: jnp.asarray(v) for k, v in random_simple_obs(np.random.default_rng(0), (2,)).items()}
    params = net.init(jax.random.PRNGKey(seed), obs0)["params"]
    policy = SimpleActorCritic(hidden_dim=hidden, device="cpu")
    policy.load_state_dict(simple_state_dict_from_flax(jax.device_get(params)))
    return net, params, policy


# ------------------------------------------------------------ K2, K3

def test_simple_layout_is_the_kernels_branch_offsets():
    layout = K2.simple_layout(K, R, TILES)
    assert [off for _, off, _ in layout] == [0, 8, 328, 329, 331]
    assert K2.simple_width(K, R, TILES) == 395
    w = SimpleActorCritic(hidden_dim=16, device="cpu").packed_weights()
    assert w.branch_off == (0, 8, 328, 329, 331, 395) and w.cond == -1


def test_observe_simple_pack_plain_matches_jax_observe_simple():
    jt, tt, samples = make_tables()
    n = 16
    jstate = JR.init_lanes(jt, jnp.asarray(samples), n, seed=1)
    tstate = TR.init_lanes(tt, torch.as_tensor(samples), n, seed=1)
    acts = np.arange(n, dtype=np.int32) % 15
    for _ in range(4):  # history, rebuffering and rates
        jstate, *_ = jax.vmap(lambda s, a: JE.step_env(jt, jnp.asarray(samples), s, a, n,
                                                       False))(jstate, jnp.asarray(acts))
        tstate, *_ = TE.step_env(tt, torch.as_tensor(samples), tstate, torch.as_tensor(acts),
                                 n, False)
    jo = jax.vmap(lambda s: JE.observe_simple(jt, s))(jstate)
    want = K2.pack_simple_obs({k: np.asarray(v) for k, v in jo.items()})
    got = K2.observe_simple_pack(tt, tstate)  # CPU tensors: the plain version
    assert got.shape == (n, 395)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    assert K2.observe_simple_pack.launches == 0
    out = torch.full((n, 395), -1.0)
    K2.observe_simple_pack_plain(tt, tstate, out=out)
    torch.testing.assert_close(out, got, rtol=0, atol=0)


@pytest.mark.parametrize("hidden", [16, 128])
def test_simple_actor_critic_matches_flax(hidden):
    net, params, policy = make_nets(hidden, seed=hidden)
    obs = random_simple_obs(np.random.default_rng(hidden), (37,))
    jl, jv = net.apply({"params": params}, {k: jnp.asarray(v) for k, v in obs.items()})
    with torch.no_grad():
        tl, tv = policy({k: torch.as_tensor(v) for k, v in obs.items()})
        x = K2.pack_simple_obs(obs)
        logits, value, action, logp = K3.actor_critic_forward(policy.packed_weights(), x)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)
    torch.testing.assert_close(logits, tl, rtol=TOL, atol=TOL)
    torch.testing.assert_close(value, tv, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(action.numpy(), np.asarray(jl).argmax(-1))
    assert K3.actor_critic_forward.launches == 0


def _simple_grads(policy: SimpleActorCritic) -> dict:
    return {f"{name}/{leaf}": (layer.weight.grad.t() if leaf == "kernel"
                               else layer.bias.grad).numpy()
            for name, layer in policy.named_modules() if isinstance(layer, torch.nn.Linear)
            for leaf in ("kernel", "bias")}


@pytest.mark.parametrize("hidden", [16, 128])
def test_simple_training_mode_and_backward_match_jax_grad(hidden):
    rng = np.random.default_rng(hidden + 1)
    obs = random_simple_obs(rng, (40,))
    gl = rng.normal(size=(40, A)).astype(np.float32)
    gv = rng.normal(size=(40,)).astype(np.float32)
    net, params, policy = make_nets(hidden, seed=3)

    def functional(p):
        logits, value = net.apply({"params": p}, {k: jnp.asarray(v) for k, v in obs.items()})
        return jnp.sum(logits * gl) + jnp.sum(value * gv)
    want = flatten_params(jax.device_get(jax.jit(jax.grad(functional))(params)))

    logits, value = policy.forward_packed(K2.pack_simple_obs(obs))
    ((logits * torch.as_tensor(gl)).sum() + (value * torch.as_tensor(gv)).sum()).backward()
    got = _simple_grads(policy)
    assert sorted(got) == sorted(want)
    for k in want:
        wide = 1e-5 * float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6 + wide, err_msg=k)
    # the written-out backward against autograd of the plain forward
    w = policy._pack()
    x = K2.pack_simple_obs(obs)
    tensors = [getattr(w, f) for f in K3.TENSOR_FIELDS]
    lg, vl, feats, hid = K3.actor_critic_train_forward_plain(w, x)
    ref = torch.autograd.grad((lg * torch.as_tensor(gl)).sum()
                              + (vl * torch.as_tensor(gv)).sum(), tensors)
    out = K3.actor_critic_backward(w, x, feats.detach(), hid.detach(), torch.as_tensor(gl),
                                   torch.as_tensor(gv))
    for f, g, r in zip(K3.TENSOR_FIELDS, out, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6, msg=f)


# ------------------------------------------------------------------- K9

def jax_a2c_loss_fn(cfg):
    """``rl/a2c.py``'s ``loss_fn`` (``:71-80``) with the identity
    ``apply_fn``, taken from a trace of ``a2c_update``."""
    captured = []
    real = jax.value_and_grad

    def spy(fn, *args, **kwargs):
        captured.append(fn)
        return real(fn, *args, **kwargs)

    B = 8
    params = {"logits": jnp.zeros((B, A)), "value": jnp.zeros(B)}
    opt = JA.make_optimizer(1e-4)
    traj = JaxTransition(obs=jnp.zeros((1, B, 1)), action=jnp.zeros((1, B), jnp.int32),
                         log_prob=jnp.zeros((1, B)), value=jnp.zeros((1, B)),
                         reward=jnp.zeros((1, B)), done=jnp.zeros((1, B), bool))
    with mock.patch.object(jax, "value_and_grad", spy):
        JA.a2c_update(lambda p, o: identity(p, o), opt, cfg, params, opt.init(params), traj,
                      jnp.zeros(B), JaxStat.init(), jax.random.PRNGKey(0))
    assert captured and captured[0].__name__ == "loss_fn"
    return captured[0]


@pytest.mark.parametrize("vf,ent", [(0.5, 0.01), (0.25, 0.0), (1.0, 0.3)])
def test_a2c_mode_matches_jax_value_and_grad(vf, ent):
    rng = np.random.default_rng(int(100 * vf + 10 * ent))
    B = 96
    logits = (2.0 * rng.normal(size=(B, A))).astype(np.float32)
    value = rng.normal(size=B).astype(np.float32)
    action = rng.integers(0, A, B).astype(np.int32)
    adv = (0.5 + 2.0 * rng.normal(size=B)).astype(np.float32)
    ret = (1.5 * rng.normal(size=B)).astype(np.float32)
    cfg = JA.A2CConfig(vf_coef=vf, ent_coef=ent, minibatch=8)
    loss_fn = jax_a2c_loss_fn(cfg)
    mb = {"obs": jnp.zeros((B, 1)), "action": jnp.asarray(action), "adv": jnp.asarray(adv),
          "ret": jnp.asarray(ret)}
    (jloss, jterms), jgrad = jax.value_and_grad(loss_fn, has_aux=True)(
        {"logits": jnp.asarray(logits), "value": jnp.asarray(value)}, mb)

    spec = K9.LossSpec(action=torch.as_tensor(action), ent_coef=ent, adv=torch.as_tensor(adv),
                       ret=torch.as_tensor(ret), vf_coef=vf, mode="a2c")
    loss, terms, dlogits, dvalue = K9.policy_loss(spec, torch.as_tensor(logits),
                                                  torch.as_tensor(value))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(terms.numpy(), np.asarray(jterms), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dlogits.numpy(), np.asarray(jgrad["logits"]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dvalue.numpy(), np.asarray(jgrad["value"]), rtol=TOL, atol=TOL)
    # the written-out gradient against autograd of the same plain loss
    lt = torch.as_tensor(logits).requires_grad_()
    vt = torch.as_tensor(value).requires_grad_()
    a_loss, _ = K9.a2c_loss(lt, vt, spec)
    assert K9.policy_loss.launches == 0
    lp = torch.log_softmax(lt, -1)
    ref = (-(lp.gather(1, spec.action.long()[:, None])[:, 0] * spec.adv).mean()
           + vf * ((spec.ret - vt) ** 2).mean() + ent * (lp.exp() * lp).sum(-1).mean())
    torch.testing.assert_close(a_loss, ref, rtol=TOL, atol=TOL)
    g_ref = torch.autograd.grad(ref, (lt, vt))
    g_got = torch.autograd.grad(a_loss, (lt, vt))
    for g, r in zip(g_got, g_ref):
        torch.testing.assert_close(g, r, rtol=TOL, atol=1e-7)


# ----------------------------------------------------------- a2c_update

T, N, MB = 8, 16, 32


@pytest.mark.parametrize("rew_norm,repeat", [(True, 1), (True, 2), (False, 2)])
def test_a2c_update_matches_jax(rew_norm, repeat):
    rng = np.random.default_rng(10 * repeat + rew_norm)
    net, params, policy = make_nets(16, seed=repeat)
    obs = random_simple_obs(rng, (T, N))
    flat = {k: jnp.asarray(v.reshape((T * N,) + v.shape[2:])) for k, v in obs.items()}
    value = np.asarray(net.apply({"params": params}, flat)[1]).reshape(T, N)
    tr = dict(action=rng.integers(0, A, (T, N)).astype(np.int32),
              value=(value + rng.normal(0, 0.3, (T, N))).astype(np.float32),
              reward=rng.normal(0.3, 1.0, (T, N)).astype(np.float32),
              done=rng.random((T, N)) < 0.15,
              last_values=rng.normal(0, 1, N).astype(np.float32))
    stat0 = (0.3, 2.0, 50.0)
    lr = 5e-4
    cfg_kw = dict(minibatch=MB, repeat=repeat, rew_norm=rew_norm)

    before = {k: v.copy() for k, v in flatten_params(jax.device_get(params)).items()}
    opt = JA.make_optimizer(lr)
    jtraj = JaxTransition(obs={k: jnp.asarray(v) for k, v in obs.items()},
                          action=jnp.asarray(tr["action"]), log_prob=jnp.zeros((T, N)),
                          value=jnp.asarray(tr["value"]), reward=jnp.asarray(tr["reward"]),
                          done=jnp.asarray(tr["done"]))
    key = jax.random.PRNGKey(11)
    jparams, _, jstat, jm = JA.a2c_update(
        lambda p, o: net.apply({"params": p}, o), opt, JA.A2CConfig(**cfg_kw), params,
        opt.init(params), jtraj, jnp.asarray(tr["last_values"]),
        JaxStat(*map(jnp.float32, stat0)), key)
    # the permutations the JAX update drew (a2c.py:84, :96)
    perms = np.stack([np.asarray(jax.random.permutation(k, T * N))[:T * N // MB * MB]
                      .reshape(-1, MB) for k in jax.random.split(key, repeat)])

    traj = Transition(obs=K2.pack_simple_obs(obs).reshape(T, N, -1),
                      action=torch.as_tensor(tr["action"]), log_prob=torch.zeros(T, N),
                      value=torch.as_tensor(tr["value"]), reward=torch.as_tensor(tr["reward"]),
                      done=torch.as_tensor(tr["done"]))
    stat, m = TA.a2c_update(policy, TA.make_optimizer(policy.parameters(), lr),
                            TA.A2CConfig(**cfg_kw), traj, torch.as_tensor(tr["last_values"]),
                            RunningStat(*(torch.tensor(v, dtype=torch.float32) for v in stat0)),
                            perms=torch.as_tensor(perms))

    for k in ("loss", "loss/actor", "loss/vf", "loss/ent"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=TOL, atol=TOL, err_msg=k)
    for a, b in zip(stat, jstat):
        np.testing.assert_allclose(float(a), float(b), rtol=TOL)
    got = flax_params(policy)
    want = flatten_params(jax.device_get(jparams))
    for k in want:
        assert np.abs(want[k] - before[k]).max() > lr, f"{k} did not move"
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_rmsprop_puts_eps_inside_the_square_root():
    p = torch.nn.Parameter(torch.tensor([1.0, 1.0, 1.0]))
    opt = TA.make_optimizer([p], 1e-2)
    g = torch.tensor([1e-4, 0.0, -2.0])
    p.grad = g.clone()
    opt.step()
    nu = 0.01 * g * g
    want = 1.0 - 1e-2 * g / torch.sqrt(nu + 1e-8)
    torch.testing.assert_close(p.detach(), want, rtol=0, atol=1e-7)
    # torch's RMSprop adds eps outside the root: another step for small gradients
    q = torch.nn.Parameter(torch.tensor([1.0, 1.0, 1.0]))
    q.grad = g.clone()
    torch.optim.RMSprop([q], lr=1e-2, alpha=0.99, eps=1e-8).step()
    assert abs(float(q.detach()[0] - p.detach()[0])) > 1e-3


# -------------------------------------------------------------------- CLI

COMMON = ["--qoe-train-id", "0", "--epochs", "4", "--step-per-epoch", "64",
          "--step-per-collect", "64", "--train-lanes", "8", "--batch-size", "32",
          "--test-on-seen", "--deterministic-eval"]


def _models_dir(base):
    (d,) = glob.glob(os.path.join(base, "models", "bitrate_selection", "simple_rl", "*", "qoe0"))
    return d


def _results(base):
    (path,) = glob.glob(os.path.join(base, "results", "bitrate_selection", "simple_rl", "**",
                                     "results.csv"), recursive=True)
    with open(path) as f:
        return [line.strip().split(",") for line in f]


def _assert_same_results(got, want):
    assert got[0] == want[0] and len(got) == len(want) > 1
    for g, w in zip(got[1:], want[1:]):
        assert g[:3] == w[:3]
        np.testing.assert_allclose(np.asarray(g[3:], float), np.asarray(w[3:], float),
                                   rtol=TOL, atol=TOL)


def test_run_simple_rl_test_on_jax_weights_and_train_file_set(tmp_path):
    jbase, tbase = str(tmp_path / "jax"), str(tmp_path / "port")
    jcfg = build_synthetic_tree(jbase)
    stdout = sys.stdout
    try:  # the JAX CLI tees stdout into its console.log and leaves it so
        JCLI.run(JCLI.build_parser().parse_args(["--train", "--test"] + COMMON), jcfg)
    finally:
        sys.stdout = stdout
    jax_results = _results(jbase)
    jdir = _models_dir(jbase)
    (ckpt,) = glob.glob(os.path.join(jdir, "*_best_policy.ckpt"))
    template = JaxSimple().init(jax.random.PRNGKey(0), JCLI.dummy_obs(jcfg))["params"]
    flat = flatten_params(jax.device_get(restore_checkpoint(ckpt, template)))
    with open(ckpt[:-len(".ckpt")] + ".npz", "wb") as f:
        np.savez(f, **flat)
    TCLI.run(TCLI.build_parser().parse_args(["--test", "--device", "cpu"] + COMMON),
             port_config(jcfg))
    _assert_same_results(_results(jbase), jax_results)

    TCLI.run(TCLI.build_parser().parse_args(["--train", "--test", "--device", "cpu"] + COMMON),
             port_config(build_synthetic_tree(tbase)))
    tdir = _models_dir(tbase)
    # both write the "_tb" TensorBoard directory (where tensorboard, and
    # tensorboardX, import)
    jax_files = {f[:-len(".ckpt")] + ".npz" if f.endswith(".ckpt") else f
                 for f in os.listdir(jdir) if not f.endswith(".npz")}
    assert set(os.listdir(tdir)) == jax_files
    assert any(f.endswith("_tb") for f in jax_files)
    assert any(f.endswith("_checkpoint.npz") for f in jax_files)
    assert len(_results(tbase)) == len(jax_results)
    (best,) = glob.glob(os.path.join(tdir, "*_best_policy.npz"))
    policy = SimpleActorCritic(device="cpu")
    load_npz_into(policy, best)
    obs = random_simple_obs(np.random.default_rng(2), (12,))
    jl, jv = JaxSimple().apply({"params": flax_tree(best)},
                               {k: jnp.asarray(v) for k, v in obs.items()})
    with torch.no_grad():
        tl, tv = policy({k: torch.as_tensor(v) for k, v in obs.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)
    with open(os.path.join(tdir, [f for f in os.listdir(tdir) if f.endswith("console.log")][0]))\
            as f:
        assert "Epoch: 4 | env_step 256" in f.read()
