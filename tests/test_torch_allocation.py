"""Port parity: pyramid allocation and the action codec.

The same random viewports (including an empty and a full one) go through the
JAX package's ``ops/allocation.py``, the PyTorch port's, and the host BFS
oracle of ``tests/_alloc_oracle.py``.  Tolerance: exact — integer outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _alloc_oracle import oracle_allocate, oracle_bfs_scales
from mansy_immersivevideostreaming_tpu.ops import allocation as JA
from mansy_immersivevideostreaming_torch.ops import allocation as TA


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _viewports(seed: int, n: int = 48) -> np.ndarray:
    """[n + 2, 64] 0/1 maps: random blobs of varied density, an empty one and
    a full one."""
    rng = np.random.default_rng(seed)
    vps = (rng.random((n, 64)) < rng.uniform(0.02, 0.4, (n, 1))).astype(np.float32)
    return np.concatenate([vps, np.zeros((1, 64), np.float32),
                           np.ones((1, 64), np.float32)])


@pytest.mark.parametrize("seed", [0, 1])
def test_viewport_scales_match_jax_and_bfs_oracle(seed):
    vps = _viewports(seed)
    port = TA.viewport_scales(torch.as_tensor(vps)).numpy()
    ref = np.asarray(jax.jit(jax.vmap(JA.viewport_scales))(jnp.asarray(vps)))
    np.testing.assert_array_equal(port, ref)
    for vp, s in zip(vps, port):
        want = oracle_bfs_scales(vp.reshape(8, 8).astype(np.uint8)).reshape(-1)
        if not vp.any():  # empty viewport: every scale stays 0
            want = np.zeros(64, np.int32)
        np.testing.assert_array_equal(s, want)


def test_allocate_tile_rates_all_actions_match_jax_and_oracle():
    vps = _viewports(2, n=16)
    B = vps.shape[0]
    alloc = jax.jit(lambda a, v: JA.allocate_for_actions(a, v))
    for action in range(15):
        acts = np.full(B, action, np.int32)
        ri, ro = TA.action_to_rates(torch.as_tensor(acts))
        versions, rates = TA.allocate_tile_rates(ri, ro, torch.as_tensor(vps))
        ref = np.asarray(alloc(jnp.asarray(acts), jnp.asarray(vps)))
        np.testing.assert_array_equal(versions.numpy(), ref)
        np.testing.assert_array_equal(rates.numpy(),
                                      np.array([1, 5, 8, 16, 35])[versions.numpy()])
        r_in, r_out = JA.ACTION_TO_RATES[action]
        for vp, v in zip(vps, versions.numpy()):
            if vp.any():
                np.testing.assert_array_equal(v, oracle_allocate(r_in, r_out, vp))
            else:
                assert (v == r_in).all()


def test_action_codec_and_scale_table_match_jax():
    acts = torch.arange(15, dtype=torch.int32)
    ri, ro = TA.action_to_rates(acts)
    jri, jro = JA.action_to_rates(jnp.arange(15))
    np.testing.assert_array_equal(ri.numpy(), np.asarray(jri))
    np.testing.assert_array_equal(ro.numpy(), np.asarray(jro))
    np.testing.assert_array_equal(TA.rates_to_action(ri, ro).numpy(), np.arange(15))
    np.testing.assert_array_equal(TA.scale_rate_table(),
                                  JA._scale_rate_table((1, 5, 8, 16, 35), 4))
