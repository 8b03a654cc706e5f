"""Port parity: the sampling rollout collector with the v9 policy.

The port's ``make_collector`` (plain path on the CPU) samples its actions
from a ``torch.Generator``, which the JAX package's ``jax.random`` cannot
reproduce.  So the JAX package replays the port's sampled actions: at each
step its ``observe_mansy``, its Flax ``MansyActorCritic`` and its
``step_env`` run on the same lanes, and the port's recorded observation,
value, log-prob, reward, done flag and episode log must match them, as must
the last values and the final lane state.

Tolerance: ints and bools exact; floats 1e-5 (relative and absolute), from
f32 sums in different orders (the 64-tile sums and the dot products of up
to 1280 terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mansy_immersivevideostreaming_tpu.models.abr_nets import MansyActorCritic as JaxAC
from mansy_immersivevideostreaming_tpu.rl import rollout as JR
from mansy_immersivevideostreaming_tpu.sim import env as JE
from mansy_immersivevideostreaming_tpu.sim import tables as JT
from mansy_immersivevideostreaming_torch.kernels.observe import obs_dims, unpack_obs
from mansy_immersivevideostreaming_torch.rl import rollout as TR
from mansy_immersivevideostreaming_torch.sim import env as TE
from mansy_immersivevideostreaming_torch.sim import tables as TT
from mansy_immersivevideostreaming_torch.utils.checkpoint import load_npz_policy
from test_torch_checkpoint import restore_v9
from test_torch_env import assert_trees_close

N, T = 16, 14
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(port: torch.Tensor, ref, what: str) -> None:
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("train", [True, False])
def test_collector_matches_jax_replay_of_its_actions(train):
    dims = dict(num_videos=2, num_users=3, num_traces=2, num_chunks=12, num_qoe=3, seed=4)
    jt = JT.synthetic_sim_tables(**dims)
    tt = TT.synthetic_sim_tables(**dims, device="cpu")
    samples = TE.generate_demo_samples(2, 3, 2, 3, 10, seed=1)
    states = TR.init_lanes(tt, torch.as_tensor(samples), N, seed=2)
    generator = torch.Generator().manual_seed(3)
    collect = TR.make_collector(tt, torch.as_tensor(samples), N, T, train=train)
    final, traj, logs, last_values = collect(load_npz_policy(device="cpu"), states, generator)
    traj_obs = unpack_obs(traj.obs, *obs_dims(tt))

    params, net = restore_v9(), JaxAC(hidden_dim=128)
    apply = jax.jit(lambda o: net.apply({"params": params}, o))
    observe = jax.jit(jax.vmap(lambda s: JE.observe_mansy(jt, s)))
    step = jax.jit(jax.vmap(lambda s, a: JE.step_env(jt, jnp.asarray(samples), s, a, N, train)))
    jstate = JR.init_lanes(jt, jnp.asarray(samples), N, seed=2)
    not_argmax = 0
    for t in range(T):
        obs = observe(jstate)
        for k in obs:
            _close(traj_obs[k][t], obs[k], f"step {t} obs {k}")
        logits, value = apply(obs)
        _close(traj.value[t], value, f"step {t} value")
        action = traj.action[t].numpy()
        log_prob = jax.nn.log_softmax(logits)[np.arange(N), action]
        _close(traj.log_prob[t], log_prob, f"step {t} log_prob")
        not_argmax += int((action != np.argmax(np.asarray(logits), -1)).sum())
        jstate, reward, done, log = step(jstate, jnp.asarray(action))
        _close(traj.reward[t], reward, f"step {t} reward")
        np.testing.assert_array_equal(traj.done[t].numpy(), np.asarray(done))
        assert_trees_close(TE.LogRecord(*(x[t] for x in logs)), log, f"step {t} log")
    _, jlast = apply(observe(jstate))
    _close(last_values, jlast, "last values")
    assert_trees_close(final, jstate, "final state")
    assert int(traj.done.sum()) >= N  # every lane ended an episode on average
    assert not_argmax > 0  # the actions were sampled, not the argmax

    flat = TR.flatten_time(traj)
    assert flat.reward.shape == (T * N,) and flat.action.dtype == torch.int32
    assert flat.obs.shape == (T * N, 779)  # the packed observation buffer
