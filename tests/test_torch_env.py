"""Port parity: the ABR environment, N lanes x T steps in lockstep.

16 lanes step 40 times through the JAX package's ``step_env`` (vmapped,
jitted, CPU) and the PyTorch port's (plain path, CPU) with one injected numpy
action stream, over several episode ends per lane and over traces with
zero-bandwidth seconds that wrap: the synthetic 50-second traces, and traces
of 300 and 173 seconds on which the lanes start at random seconds, so that
cursors run beyond second 64 and the shorter trace wraps (the prefix row is
then longer than the 64 entries K1 holds in registers).  Every ``EnvState``
field, the reward, the done flag and every ``LogRecord`` field are compared
after each step, and the observations before it.

Tolerance: ints and bools exact; floats 1e-5 (absolute and relative).  Both
packages do the same f32 operations in the same order except the 64-tile
sums, which XLA and torch associate differently (a few ulp), and the episode
accumulators carry those over up to a dozen steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mansy_immersivevideostreaming_tpu.rl import rollout as JR
from mansy_immersivevideostreaming_tpu.sim import env as JE
from mansy_immersivevideostreaming_tpu.sim import simulator as JS
from mansy_immersivevideostreaming_tpu.sim import tables as JT
from mansy_immersivevideostreaming_torch.rl import rollout as TR
from mansy_immersivevideostreaming_torch.sim import env as TE
from mansy_immersivevideostreaming_torch.sim import tables as TT

N, T = 16, 40
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def make_tables(long_traces: bool = False):
    """Matching tables: 12 chunks (6-step episodes), traces with outages; with
    ``long_traces``, two traces of 300 and 173 seconds drawn as the
    synthetic ones are."""
    jt = JT.synthetic_sim_tables(num_videos=2, num_users=3, num_traces=2, num_chunks=12,
                                 num_qoe=3, seed=3)
    bw = np.asarray(jt.bw).copy()
    lens = np.asarray(jt.bw_len)
    if long_traces:
        bw = np.random.default_rng(7).uniform(5e5, 4e6, (2, 300)).astype(np.float32)
        lens = np.array([300, 173], np.int32)
        bw[0, 70:74] = 0.0
        bw[1, 173:] = 0.0
        jt = jt._replace(bw_len=jnp.asarray(lens))
    bw[0, 5:8] = 0.0
    bw[1, 20] = 0.0
    jt = jt._replace(bw=jnp.asarray(bw), bw_prefix=JS.build_prefix(bw, lens))
    tt = TT.synthetic_sim_tables(num_videos=2, num_users=3, num_traces=2, num_chunks=12,
                                 num_qoe=3, seed=3, device="cpu")
    tt = tt._replace(bw=torch.as_tensor(bw), bw_len=torch.as_tensor(lens),
                     bw_prefix=TT.build_prefix(bw, lens))
    samples = TE.generate_demo_samples(2, 3, 2, 3, 10, seed=0)
    return jt, tt, samples


def leaves(tree):
    """Flatten a (nested) NamedTuple of arrays or tensors into numpy arrays."""
    if isinstance(tree, tuple):
        return [x for t in tree for x in leaves(t)]
    return [tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)]


def assert_trees_close(port, ref, what):
    names = type(port)._fields
    for i, (a, b) in enumerate(zip(leaves(port), leaves(ref))):
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=f"{what} leaf {i}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} leaf {i} {names}")
    assert len(leaves(port)) == len(leaves(ref))


@pytest.mark.parametrize("train,long_traces", [
    pytest.param(False, False, id="False"), pytest.param(True, False, id="True"),
    pytest.param(True, True, id="long_traces")])
def test_step_env_lockstep_with_injected_actions(train, long_traces):
    jt, tt, samples = make_tables(long_traces)
    jstate = JR.init_lanes(jt, jnp.asarray(samples), N, seed=1)
    tstate = TR.init_lanes(tt, torch.as_tensor(samples), N, seed=1)
    assert_trees_close(tstate, jstate, "init")
    if long_traces:  # lanes resume at random seconds of their traces
        lens = np.asarray(jt.bw_len)[np.asarray(jstate.trace)]
        idx = (np.random.default_rng(9).integers(0, 1 << 20, N) % lens).astype(np.int32)
        jstate = jstate._replace(net=jstate.net._replace(idx=jnp.asarray(idx)))
        tstate = tstate._replace(net=tstate.net._replace(idx=torch.as_tensor(idx)))
    jstep = jax.jit(jax.vmap(lambda s, a: JE.step_env(jt, jnp.asarray(samples), s, a, N,
                                                      train)))
    jobs = jax.jit(jax.vmap(lambda s: JE.observe_mansy(jt, s)))
    actions = np.random.default_rng(5).integers(0, 15, (T, N)).astype(np.int32)
    dones = furthest = 0
    for t in range(T):
        jo, to = jobs(jstate), TE.observe_mansy(tt, tstate)
        assert sorted(jo) == sorted(to)
        for k in jo:
            np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), rtol=TOL, atol=TOL,
                                       err_msg=f"step {t} obs {k}")
        jstate, jrew, jdone, jlog = jstep(jstate, jnp.asarray(actions[t]))
        tstate, trew, tdone, tlog = TE.step_env(tt, torch.as_tensor(samples), tstate,
                                                torch.as_tensor(actions[t]), N, train)
        assert_trees_close(tstate, jstate, f"step {t} state")
        assert_trees_close(tlog, jlog, f"step {t} log")
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        dones += int(tdone.sum())
        furthest = max(furthest, int(tstate.net.idx.max()))
    assert dones >= 2 * N  # more than one episode end per lane on average
    assert furthest > 64 or not long_traces  # cursors beyond a 64-entry row


def test_observe_simple_and_estimators_match_jax():
    jt, tt, samples = make_tables()
    jstate = JR.init_lanes(jt, jnp.asarray(samples), N, seed=0)
    tstate = TR.init_lanes(tt, torch.as_tensor(samples), N, seed=0)
    acts = np.arange(N, dtype=np.int32) % 15
    for _ in range(3):  # fill some history
        jstate, *_ = jax.vmap(lambda s, a: JE.step_env(jt, jnp.asarray(samples), s, a, N,
                                                       False))(jstate, jnp.asarray(acts))
        tstate, *_ = TE.step_env(tt, torch.as_tensor(samples), tstate,
                                 torch.as_tensor(acts), N, False)
    jo = jax.vmap(lambda s: JE.observe_simple(jt, s))(jstate)
    to = TE.observe_simple(tt, tstate)
    for k in jo:
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), rtol=TOL, atol=TOL)
    hist = np.random.default_rng(0).uniform(0, 1, (8, 8)).astype(np.float32)
    hist[0] = 0.0
    hist[1, :4] = 0.0
    for tf, jf in ((TE.harmonic_bw_estimate, JE.harmonic_bw_estimate),
                   (TE.viewport_acc_estimate, JE.viewport_acc_estimate)):
        np.testing.assert_allclose(tf(torch.as_tensor(hist)).numpy(),
                                   np.asarray(jax.vmap(jf)(jnp.asarray(hist))),
                                   rtol=TOL, atol=TOL)


def test_observe_mansy_refuses_action_value_tables():
    """Action-value tables are observed only when attached whole (quality,
    intra and size together, as sim.expert.attach_action_values does)."""
    _, tt, samples = make_tables()
    state = TR.init_lanes(tt, torch.as_tensor(samples), 2)
    tables = tt._replace(av_quality=torch.zeros(1))
    with pytest.raises(ValueError, match="attach_action_values"):
        TE.observe_mansy(tables, state)
