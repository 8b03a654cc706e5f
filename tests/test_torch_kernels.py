"""The port's three kernels: layouts and plain versions.

On the CPU the wrappers run their plain PyTorch versions; the packed
observation must reproduce the JAX package's ``observe_mansy`` exactly (a
gather and the same divisions).  The kernels themselves are held to their
plain versions on the card by ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mansy_immersivevideostreaming_tpu.rl import rollout as JR
from mansy_immersivevideostreaming_tpu.sim import env as JE
from mansy_immersivevideostreaming_tpu.sim import tables as JT
from mansy_immersivevideostreaming_torch.kernels import actor_critic as K3
from mansy_immersivevideostreaming_torch.kernels import env_step as K1
from mansy_immersivevideostreaming_torch.kernels import observe as K2
from mansy_immersivevideostreaming_torch.models.abr_nets import MansyActorCritic
from mansy_immersivevideostreaming_torch.rl import rollout as TR
from mansy_immersivevideostreaming_torch.sim import env as TE
from mansy_immersivevideostreaming_torch.sim import tables as TT

N = 24


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _stepped_lanes(tables, samples, steps=4, seed=0):
    """Lanes with some history (plain path on the tables' device)."""
    state = TR.init_lanes(tables, samples, N, seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        acts = torch.as_tensor(rng.integers(0, 15, N).astype(np.int32), device=samples.device)
        state, *_ = K1.env_step_plain(tables, samples, state, acts, N, True)
    return state


def test_layout_widths():
    assert K2.feature_width(8, 5, 64, 15) == 748
    assert K2.obs_width(8, 5, 64, 15) == 779
    names = [name for name, _, _ in K2.obs_layout(8, 5, 64, 15)]
    assert len(names) == 13 and names[K2.NET_FIELDS] == "rates_inside"


def test_pack_reproduces_jax_observe_mansy_exactly():
    jt = JT.synthetic_sim_tables(2, 3, 2, 14, 3, seed=1)
    tt = TT.synthetic_sim_tables(2, 3, 2, 14, 3, seed=1, device="cpu")
    samples = TE.generate_environment_samples(2, 3, 2, 3)
    jstate = JR.init_lanes(jt, jnp.asarray(samples), N)
    tstate = TR.init_lanes(tt, torch.as_tensor(samples), N)
    acts = np.random.default_rng(0).integers(0, 15, (5, N)).astype(np.int32)
    jstep = jax.jit(jax.vmap(lambda s, a: JE.step_env(jt, jnp.asarray(samples), s, a, N,
                                                      True)))
    for a in acts:  # lockstep, then compare the observations of the same states
        jstate, *_ = jstep(jstate, jnp.asarray(a))
        tstate, *_ = TE.step_env(tt, torch.as_tensor(samples), tstate, torch.as_tensor(a),
                                 N, True)
    ref = jax.vmap(lambda s: JE.observe_mansy(jt, s))(jstate)
    tstate = tstate._replace(**{k: torch.tensor(np.asarray(getattr(jstate, k)))
                                for k in TE.EnvState._fields if k not in ("net", "qoe")})
    packed = K2.observe_mansy_pack(tt, tstate)
    assert packed.shape == (N, 779)
    obs = K2.unpack_obs(packed, 8, 5, 64, 15)
    assert sorted(obs) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(obs[k].numpy(), np.asarray(ref[k]), err_msg=k)
    port = TE.observe_mansy(tt, tstate)
    for k in port:
        np.testing.assert_array_equal(obs[k].numpy(), port[k].numpy(), err_msg=k)


def test_actor_critic_plain_matches_module_forward():
    torch.manual_seed(0)
    policy = MansyActorCritic(device="cpu")
    tt = TT.synthetic_sim_tables(device="cpu")
    samples = torch.as_tensor(TE.generate_environment_samples(2, 2, 2, 2))
    state = _stepped_lanes(tt, samples)
    packed = K2.observe_mansy_pack(tt, state)
    with torch.no_grad():
        logits, value = policy(K2.unpack_obs(packed, 8, 5, 64, 15))
        kl, kv, ka, _ = K3.actor_critic_forward(policy.packed_weights(), packed)
    torch.testing.assert_close(kl, logits, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(kv, value, rtol=1e-5, atol=1e-5)
    assert ka.dtype == torch.int32
