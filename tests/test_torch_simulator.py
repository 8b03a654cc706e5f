"""Port parity: the trace-driven download simulator and the playback buffer.

The cases of ``tests/test_download_prefix.py`` (a short trace with
zero-bandwidth seconds that wraps many times, a download ending exactly on a
second boundary) go through the JAX package's ``sim/simulator.py`` (jitted,
CPU) and the PyTorch port's.  Tolerance: ints exact; floats 1e-6, since both
compute in f32 with the same operations in the same order.  The batched
case runs the JAX function op by op (vmap without jit): XLA's fused jit may
contract a multiply and an add into one FMA, and the cancellation in
``target - g_nm1`` then magnifies that 1-ulp change by target / bandwidth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mansy_immersivevideostreaming_tpu.sim import simulator as JS
from mansy_immersivevideostreaming_torch.sim import simulator as TS

TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _outage_trace():
    bw = np.array([[1e6, 0.0, 0.0, 5e5, 2e6, 0.0, 3e6, 1e5]], np.float32)
    return bw, np.array([8], np.int32)


def _assert_net_equal(tnet, tdt, jnet, jdt):
    np.testing.assert_array_equal(tnet.idx.numpy(), np.asarray(jnet.idx))
    np.testing.assert_array_equal(tnet.sec.numpy(), np.asarray(jnet.sec))
    np.testing.assert_allclose(tnet.frac.numpy(), np.asarray(jnet.frac), rtol=0, atol=TOL)
    np.testing.assert_allclose(tdt.numpy(), np.asarray(jdt), rtol=0, atol=TOL)


def test_build_prefix_bitwise():
    bw, lens = _outage_trace()
    bw2 = np.concatenate([bw, np.full((1, 8), 7e5, np.float32)])
    lens2 = np.array([8, 5], np.int32)
    np.testing.assert_array_equal(TS.build_prefix(bw2, lens2).numpy(),
                                  np.asarray(JS.build_prefix(bw2, lens2)))


@pytest.mark.parametrize("fn", ["prefix", "bytes"])
def test_download_sequence_with_outages_and_wraps(fn):
    bw, lens = _outage_trace()
    prefix = np.asarray(JS.build_prefix(bw, lens))[0]
    rng = np.random.default_rng(1)
    sizes = np.concatenate([rng.uniform(1e3, 2e7, 60), np.array([1e6 * 0.5, 1e6])])
    if fn == "prefix":
        jfn = jax.jit(lambda n, s: JS.simulate_download_prefix(
            jnp.asarray(bw[0]), jnp.asarray(prefix), jnp.int32(8), n, s))
        tfn = lambda n, s: TS.simulate_download_prefix(
            torch.tensor(bw[0]), torch.tensor(prefix), torch.tensor(8), n, s)
    else:
        jfn = jax.jit(lambda n, s: JS.simulate_download_bytes(
            jnp.asarray(bw[0]), jnp.int32(8), n, s))
        tfn = lambda n, s: TS.simulate_download_bytes(
            torch.as_tensor(bw[0]), torch.tensor(8), n, s)
    jnet, tnet = JS.init_net_state(), TS.init_net_state()
    for size in sizes:
        jnet, jdt = jfn(jnet, jnp.float32(size))
        tnet, tdt = tfn(tnet, torch.tensor(size, dtype=torch.float32))
        _assert_net_equal(tnet, tdt, jnet, jdt)


def test_download_prefix_batched_lanes_match_vmapped_jax():
    """Many lanes at once, each from its own cursor on its own trace, against
    the JAX function run op by op."""
    rng = np.random.default_rng(2)
    N, L = 64, 12
    bw = rng.uniform(1e5, 3e6, (3, L)).astype(np.float32)
    bw[0, 3:5] = 0.0
    lens = np.array([12, 7, 9], np.int32)
    prefix = np.asarray(JS.build_prefix(bw, lens))
    tr = rng.integers(0, 3, N)
    idx = (rng.integers(0, 100, N) % lens[tr]).astype(np.int32)
    idx = np.where(bw[tr, idx] == 0, 0, idx).astype(np.int32)
    sec = rng.integers(0, 50, N).astype(np.int32)
    frac = rng.uniform(0, 0.99, N).astype(np.float32)
    sizes = rng.uniform(1e3, 3e7, N).astype(np.float32)
    jout = jax.vmap(JS.simulate_download_prefix)(
        jnp.asarray(bw[tr]), jnp.asarray(prefix[tr]), jnp.asarray(lens[tr]),
        JS.NetState(jnp.asarray(idx), jnp.asarray(sec), jnp.asarray(frac)),
        jnp.asarray(sizes))
    t = torch.as_tensor
    tout = TS.simulate_download_prefix(t(bw[tr]), t(prefix[tr]), t(lens[tr]),
                                       TS.NetState(t(idx), t(sec), t(frac)), t(sizes))
    _assert_net_equal(tout[0], tout[1], jout[0], jout[1])


def test_download_prefix_exact_first_second_boundary():
    bw = np.full((1, 4), 1e6, np.float32)
    prefix = TS.build_prefix(bw, np.array([4], np.int32))[0]
    net = TS.NetState(torch.tensor(0, dtype=torch.int32), torch.tensor(0, dtype=torch.int32),
                      torch.tensor(0.5))
    new, dt = TS.simulate_download_prefix(torch.as_tensor(bw[0]), prefix, torch.tensor(4),
                                          net, torch.tensor(0.5e6))
    assert int(new.idx) == 1 and int(new.sec) == 1
    assert float(new.frac) == 0.0
    assert float(dt) == pytest.approx(0.5, abs=TOL)


def test_push_chunk_and_init_buffer_match_jax():
    rng = np.random.default_rng(4)
    buf = rng.uniform(0, 5, 32).astype(np.float32)
    dt = rng.uniform(0, 8, 32).astype(np.float32)
    jb, jr = JS.push_chunk(jnp.asarray(buf), 1.0, jnp.asarray(dt))
    tb, tr = TS.push_chunk(torch.as_tensor(buf), 1.0, torch.as_tensor(dt))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert float(TS.init_buffer(1.0)) == float(JS.init_buffer(1.0))
