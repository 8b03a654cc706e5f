"""Port parity: the QoE model.

Random viewports, tile qualities, rebuffer times and preference weights go
through the JAX package's ``ops/qoe.py`` (jitted, CPU) and the PyTorch
port's.  Tolerance 1e-6, relative and absolute: both sum 64 tiles in f32,
in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mansy_immersivevideostreaming_tpu.ops import qoe as JQ
from mansy_immersivevideostreaming_torch.ops import qoe as TQ

TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed, n=64):
    rng = np.random.default_rng(seed)
    vp = (rng.random((n, 64)) < 0.2).astype(np.float32)
    vp[:, 0] = 1.0  # a non-empty ground-truth viewport
    quality = rng.choice(np.array([1, 5, 8, 16, 35], np.float32), (n, 64))
    rebuf = np.where(rng.random(n) < 0.3, rng.uniform(0, 3, n), 0).astype(np.float32)
    weights = rng.uniform(1, 7, (n, 3)).astype(np.float32)
    prev = rng.uniform(0, 1, n).astype(np.float32)
    has_prev = rng.random(n) < 0.5
    return vp, quality, rebuf, weights, prev, has_prev


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_qoe_step_matches_jax(seed):
    vp, quality, rebuf, weights, prev, has_prev = _inputs(seed)
    jstate = JQ.QoEState(jnp.asarray(prev), jnp.asarray(has_prev))
    ref = jax.jit(jax.vmap(JQ.qoe_step))(jstate, jnp.asarray(weights), jnp.asarray(vp),
                                         jnp.asarray(quality), jnp.asarray(rebuf))
    t = torch.as_tensor
    out = TQ.qoe_step(TQ.QoEState(t(prev), t(has_prev)), t(weights), t(vp), t(quality),
                      t(rebuf))
    (jst, *jvals), (tst, *tvals) = ref, out
    np.testing.assert_allclose(tst.prev_quality.numpy(), np.asarray(jst.prev_quality),
                               rtol=TOL, atol=TOL)
    assert tst.has_prev.all()
    for a, b in zip(tvals, jvals):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)


def test_qoe_step_with_given_quality_and_normalizers_match_jax():
    rng = np.random.default_rng(3)
    n = 32
    w = rng.uniform(1, 7, (n, 3)).astype(np.float32)
    vq = rng.uniform(1, 35, n).astype(np.float32)
    prev = rng.uniform(0, 1, n).astype(np.float32)
    has_prev = rng.random(n) < 0.5
    intra = rng.uniform(0, 10, n).astype(np.float32)
    rebuf = rng.uniform(0, 2, n).astype(np.float32)
    ref = JQ.qoe_step_with_given_quality(*map(jnp.asarray, (w, vq, prev, has_prev, intra,
                                                            rebuf)))
    out = TQ.qoe_step_with_given_quality(*map(torch.as_tensor, (w, vq, prev, has_prev,
                                                                intra, rebuf)))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)
    x = rng.uniform(0, 1e7, 16).astype(np.float32)
    for tf, jf in ((TQ.normalize_quality, JQ.normalize_quality),
                   (TQ.normalize_size, JQ.normalize_size),
                   (TQ.normalize_throughput, JQ.normalize_throughput)):
        np.testing.assert_array_equal(tf(torch.as_tensor(x)).numpy(), np.asarray(jf(x)))
    np.testing.assert_allclose(TQ.normalize_qoe_weight(torch.as_tensor(w)).numpy(),
                               np.asarray(JQ.normalize_qoe_weight(jnp.asarray(w))),
                               rtol=TOL, atol=TOL)
