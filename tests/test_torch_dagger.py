"""Port parity: DAgger and BC.

* ``flatten_demos``, ``aggregate`` (with episode ends, a confidence mask and
  a relabel weight) and ``class_balance_weights``: the port's packed
  aggregate, unpacked, equal to the JAX package's dict one, and equal
  weights.
* ``bc_on_aggregate``, uniform and weighted sampling: the JAX function's own
  minibatch draws handed to the port; CE losses 1e-5, parameters as in
  ``test_torch_ppo``.
* ``make_dagger_collector`` with preference pins, the causal expert,
  per-preference accuracy-corrected scoring and margins, against the JAX
  collector run with a key whose per-step Gumbel draws
  (``jax.random.categorical`` is the Gumbel-max rule) the port is given as
  its noise: the observations (1e-5), expert labels, dones (exact) and
  margins (1e-5, +inf where pinned) match.
* ``behavior_cloning_pretraining``: ``random.Random(seed)`` picks the same
  demos in both packages; the BC losses of every step and the best valid
  loss agree to 1e-5.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mansy_immersivevideostreaming_tpu.models.abr_nets import MansyActorCritic as JaxAC
from mansy_immersivevideostreaming_tpu.models.abr_nets import QoEIdentifier as JaxID
from mansy_immersivevideostreaming_tpu.rl import bc as JB
from mansy_immersivevideostreaming_tpu.rl import dagger as JD
from mansy_immersivevideostreaming_tpu.rl import ppo as JP
from mansy_immersivevideostreaming_tpu.sim import expert as JX
from mansy_immersivevideostreaming_torch.kernels.observe import (
    obs_columns, obs_dims, pack_obs, unpack_obs,
)
from mansy_immersivevideostreaming_torch.models.abr_nets import QoEIdentifier
from mansy_immersivevideostreaming_torch.rl import bc as TB
from mansy_immersivevideostreaming_torch.rl import dagger as TD
from mansy_immersivevideostreaming_torch.rl.ppo import make_optimizer
from mansy_immersivevideostreaming_torch.sim import env as TE
from mansy_immersivevideostreaming_torch.sim import expert as TX
from mansy_immersivevideostreaming_torch.utils.checkpoint import flatten_params
from test_torch_expert import make_tables
from test_torch_identifier import assert_params_close
from test_torch_ppo import make_nets, random_obs

TOL = 1e-5
DIMS = (8, 5, 64, 15)  # K, R, T, A of the 13-field observation (779 columns)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def demos(seed: int, n: int, length=None):
    """``n`` random demo episodes of 3-8 steps (all of ``length`` steps when
    given, so that the JAX steps compile once)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        T = int(rng.integers(3, 9)) if length is None else length
        obs = random_obs(rng, (T,), False)
        w = np.asarray([[7, 1, 1], [1, 7, 1], [3, 3, 3]], np.float32)[rng.integers(0, 3)]
        obs["qoe_weight"][:] = w / w.sum()
        out.append({"obs": obs, "act": rng.integers(0, 15, T).astype(np.int32)})
    return out


def unpacked(x: torch.Tensor):
    """The JAX package's dict layout of packed [n, 779] observations."""
    return {k: v.numpy() for k, v in unpack_obs(x, *DIMS).items()}


def test_flatten_aggregate_and_class_balance_equal_jax():
    d = demos(0, 5)
    x, act = TD.flatten_demos(d)
    jobs, jact = JD.flatten_demos(d)
    assert x.shape == (act.shape[0], 779) and act.dtype == torch.int32
    np.testing.assert_array_equal(act.numpy(), jact)
    obs = unpacked(x)
    assert sorted(obs) == sorted(jobs)
    for k in jobs:
        np.testing.assert_array_equal(obs[k], jobs[k])
    rng = np.random.default_rng(1)
    new = random_obs(rng, (6, 4), False)
    new_act = rng.integers(0, 15, (6, 4)).astype(np.int32)
    done = rng.random((6, 4)) < 0.3
    keep = rng.random((6, 4)) < 0.7
    got = TD.aggregate((x, act), pack_obs(new).reshape(6, 4, -1), torch.as_tensor(new_act),
                       torch.as_tensor(done), weight=3.0, extra_keep=keep)
    want = JD.aggregate((jobs, jact), new, new_act, done, weight=3.0, extra_keep=keep)
    got_obs = unpacked(got[0])
    for k in want[0]:
        np.testing.assert_array_equal(got_obs[k], want[0][k])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert float(got[2].max()) == 3.0 and got[1].shape[0] > act.shape[0]
    qoe = got[0][:, obs_columns(*DIMS)["qoe_weight"]]
    np.testing.assert_array_equal(TD.class_balance_weights(qoe, got[1], 0.5).numpy(),
                                  JD.class_balance_weights(want[0], want[1], 0.5))


@pytest.mark.parametrize("weighted", [False, True])
def test_bc_on_aggregate_matches_jax(weighted):
    net, params, policy = make_nets("v9", 16)
    x, act = TD.flatten_demos(demos(2, 12))
    obs = unpacked(x)
    w = np.random.default_rng(3).uniform(0.5, 3.0, act.shape[0]).astype(np.float32) \
        if weighted else np.ones(act.shape[0], np.float32)
    before = {k: v.copy() for k, v in flatten_params(jax.device_get(params)).items()}
    opt = JP.make_optimizer(5e-4)
    key = jax.random.PRNGKey(8)
    steps, bs, n = 4, 16, act.shape[0]
    jparams, _, jlosses = JD.bc_on_aggregate(lambda p, o: net.apply({"params": p}, o), opt,
                                             params, opt.init(params), (obs, act.numpy(), w),
                                             steps, bs, key, 0.1)
    # the JAX function's draws (dagger.py:226-232)
    idx, k = [], key
    probs = jnp.asarray(w / w.sum(), jnp.float32)
    for _ in range(steps):
        k, sub = jax.random.split(k)
        idx.append(np.asarray(jax.random.choice(sub, n, (bs,), replace=True, p=probs)
                              if weighted else jax.random.randint(sub, (bs,), 0, n)))
    losses = TD.bc_on_aggregate(policy, make_optimizer(policy.parameters(), 5e-4),
                                (x, act, torch.as_tensor(w)), steps, bs, None, 0.1,
                                indices=np.stack(idx))
    np.testing.assert_allclose(losses, jlosses, rtol=TOL, atol=TOL)
    assert_params_close(policy, jparams, before, steps, 5e-4)


def test_dagger_collector_matches_jax():
    jt, tt = make_tables(seed=5)
    jet, tet = JX.build_expert_tables(jt), TX.build_expert_tables(tt)
    net, params, policy = make_nets("v9", 16)
    samples = TE.generate_demo_samples(2, 3, 2, 3, 9, seed=4)
    n, steps, A = samples.shape[0], 6, 15
    pins, corr = np.asarray([-1, 10, -1], np.int32), np.asarray([True, False, True])
    jcollect = JD.make_dagger_collector(lambda p, o: net.apply({"params": p}, o), jt, jet, 2,
                                        steps, pin_table=pins, causal=True, acc_correct=corr,
                                        with_margin=True)
    key = jax.random.PRNGKey(11)
    jobs, jlabel, jdone, jmargin = jcollect(params, jnp.asarray(samples), key)
    noise, k = [], key
    for _ in range(steps):  # the collector's key splits (dagger.py:84-106)
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.random.gumbel(sub, (n, A), jnp.float32)))
    collect = TD.make_dagger_collector(tt, tet, 2, steps, pin_table=pins, causal=True,
                                       acc_correct=corr, with_margin=True)
    obs, label, done, margin = collect(policy, torch.as_tensor(samples),
                                       noise=torch.as_tensor(np.stack(noise)))
    assert obs.shape == (steps, n, 779) and label.dtype == torch.int32
    for name, x in unpack_obs(obs, *obs_dims(tt)).items():
        np.testing.assert_allclose(x.numpy(), np.asarray(jobs[name]), rtol=TOL, atol=TOL,
                                   err_msg=name)
    np.testing.assert_array_equal(label.numpy(), np.asarray(jlabel))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    jm = np.asarray(jmargin)
    np.testing.assert_array_equal(np.isinf(margin.numpy()), np.isinf(jm))
    np.testing.assert_allclose(margin.numpy()[np.isfinite(jm)], jm[np.isfinite(jm)],
                               rtol=TOL, atol=TOL)
    assert np.isinf(jm).any() and (np.asarray(jlabel)[np.isinf(jm)] == 10).all()
    assert int(done.sum()) >= n // 2


def test_behavior_cloning_pretraining_matches_jax(capsys):
    net, params, policy = make_nets("v9", 16)
    jid = JaxID(hidden_dim=16)
    obs0 = {k: jnp.asarray(v) for k, v in random_obs(np.random.default_rng(0), (2,), False).items()}
    id_params = jid.init(jax.random.PRNGKey(2), obs0)["params"]
    train, valid = demos(6, 8, length=5), demos(7, 3, length=5)
    opt, id_opt = JP.make_optimizer(5e-4), JP.make_optimizer(1e-4)
    jpicked, picked = [], []
    *_, jbest = JB.behavior_cloning_pretraining(
        lambda p, o: net.apply({"params": p}, o), opt, params, opt.init(params),
        lambda p, o: jid.apply({"params": p}, o), id_opt, id_params, id_opt.init(id_params),
        train, valid, 6, 2, 2, 2, seed=9, save_policy=lambda p: jpicked.append(1))
    jout = capsys.readouterr().out
    ident = QoEIdentifier(hidden_dim=16, device="cpu")
    best = TB.behavior_cloning_pretraining(
        policy, make_optimizer(policy.parameters(), 5e-4), ident,
        make_optimizer(ident.parameters(), 1e-4), train, valid, 6, 2, 2, 2, seed=9,
        save_policy=lambda p: picked.append(1))
    out = capsys.readouterr().out
    parse = lambda text, what: [float(v) for v in re.findall(what + r"=([-0-9.e]+)", text)]
    assert len(parse(out, "loss")) == 6 + 2 * 3  # steps; valid and best at steps 0, 2, 4
    np.testing.assert_allclose(parse(out, " loss"), parse(jout, " loss"), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(best, float(jbest), rtol=TOL, atol=TOL)
    assert len(picked) == len(jpicked) >= 1
