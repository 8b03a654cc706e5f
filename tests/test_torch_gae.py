"""Port parity: GAE (K6's plain version) and the running return statistic.

* ``compute_gae`` on random [T, N] rewards, values and dones (T up to 64)
  against the JAX ``rl/gae.py:compute_gae``: the plain version keeps the JAX
  scan's operation order, so the f32 recurrence agrees to rtol 1e-6 (plus
  1e-6 of the largest advantage, for entries that cancel to near 0).
* ``RunningStat.update`` over three batches against the JAX
  ``rl/types.py:RunningStat``: rtol 1e-6 (the batch mean and population
  variance are sums in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mansy_immersivevideostreaming_tpu.rl.gae import compute_gae as jax_gae
from mansy_immersivevideostreaming_tpu.rl.types import RunningStat as JaxStat
from mansy_immersivevideostreaming_torch.kernels import gae as K6
from mansy_immersivevideostreaming_torch.rl.types import RunningStat


@pytest.mark.parametrize("T,N,seed", [(1, 5, 0), (16, 33, 1), (64, 128, 2)])
def test_compute_gae_matches_jax(T, N, seed):
    rng = np.random.default_rng(seed)
    rewards = rng.normal(0.2, 1.0, (T, N)).astype(np.float32)
    values = rng.normal(0.0, 2.0, (T, N)).astype(np.float32)
    dones = rng.random((T, N)) < 0.1
    last = rng.normal(0.0, 2.0, N).astype(np.float32)
    jadv, jret = jax_gae(jnp.asarray(rewards), jnp.asarray(dones).astype(jnp.float32),
                         jnp.asarray(values), jnp.asarray(last), 0.95, 0.95)
    adv, ret = K6.compute_gae(*map(torch.as_tensor, (rewards, dones, values, last)), 0.95, 0.95)
    assert adv.dtype == torch.float32 and adv.shape == (T, N)
    for got, want in ((adv, jadv), (ret, jret)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


def test_compute_gae_masks_episode_ends():
    """A done step neither bootstraps nor carries advantage backwards."""
    rewards = torch.ones(3, 1)
    values = torch.zeros(3, 1)
    dones = torch.tensor([[False], [True], [False]])
    adv, ret = K6.compute_gae(rewards, dones, values, torch.tensor([10.0]), 0.5, 1.0)
    torch.testing.assert_close(adv[:, 0], torch.tensor([1.5, 1.0, 6.0]))
    torch.testing.assert_close(ret, adv)


def test_running_stat_matches_jax():
    rng = np.random.default_rng(3)
    stat, jstat = RunningStat.init(), JaxStat.init()
    for shape in ((32, 128), (32, 128), (7, 5)):
        x = rng.normal(1.5, 3.0, shape).astype(np.float32)
        stat, jstat = stat.update(torch.as_tensor(x)), jstat.update(jnp.asarray(x))
        for a, b in zip(stat, jstat):
            assert a.dtype == torch.float32 and a.dim() == 0
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    assert float(stat.count) == pytest.approx(2 * 32 * 128 + 35 + 1e-4)
