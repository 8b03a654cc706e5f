"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where there is no card.  The
file imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest imports JAX.)  Tolerances: ints
exact, floats 1e-5 relative (K2's action values, exact or derived, with
atol 1e-6; the kernels sum in another order than PyTorch's CUDA ops, which
also divide by a Python scalar as a product with its reciprocal); K6
bit-equal (the plain version's operation order); K8 in
bf16 within one bf16 ulp plus ``kernels/attention.py:bf16_slack`` (the
inner bf16 roundings of P and dP' flip where the kernel and its plain
version sum in another order).  The search (K4) picks the plain version's action on every
lane whose first-action margin exceeds 1e-5, and elsewhere an action whose
first-action value is within 1e-5 of the best.
"""

import numpy as np
import pytest
import torch

from mansy_immersivevideostreaming_torch.kernels import actor_critic as K3
from mansy_immersivevideostreaming_torch.kernels import choose_action as K4
from mansy_immersivevideostreaming_torch.kernels import env_step as K1
from mansy_immersivevideostreaming_torch.kernels import expert_tables as K5
from mansy_immersivevideostreaming_torch.kernels import observe as K2
from mansy_immersivevideostreaming_torch.models.abr_nets import MansyActorCritic
from mansy_immersivevideostreaming_torch.rl.rollout import init_lanes
from mansy_immersivevideostreaming_torch.sim import expert as X
from mansy_immersivevideostreaming_torch.sim.env import (
    generate_demo_samples, generate_environment_samples, tree_map, viewport_acc_estimate,
)
from mansy_immersivevideostreaming_torch.sim.simulator import build_prefix
from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables
from mansy_immersivevideostreaming_torch.utils.checkpoint import DAGGER_V16_NPZ, load_npz_policy

N = 96


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _leaves(tree):
    """The tensors of a (nested) tuple of tensors and NamedTuples, in order."""
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _stepped_lanes(tables, samples, steps, seed=0):
    """Lanes with some history, stepped by the plain version."""
    state = init_lanes(tables, samples, N, seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        acts = torch.as_tensor(rng.integers(0, 15, N).astype(np.int32), device=samples.device)
        state, *_ = K1.env_step_plain(tables, samples, state, acts, N, True)
    return state


@pytest.mark.cuda
def test_env_step_kernel_matches_plain_on_card(cuda_device):
    tables = synthetic_sim_tables(3, 4, 3, 20, 4, seed=2, device=cuda_device)
    samples = torch.as_tensor(generate_demo_samples(3, 4, 3, 4, 17), device=cuda_device)
    state = _stepped_lanes(tables, samples, steps=3)
    rng = np.random.default_rng(1)
    for _ in range(20):
        acts = torch.as_tensor(rng.integers(0, 15, N).astype(np.int32), device=cuda_device)
        ref = K1.env_step_plain(tables, samples, tree_map(torch.clone, state), acts, N, True)
        got = K1.env_step(tables, samples, state, acts, N, True)
        assert got[0] is state  # updated in place
        for x, y in zip(_leaves(got), _leaves(ref)):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


def _with_outages(tables, trace_len: int, seed: int):
    """``tables`` with zero-bandwidth seconds in its traces; with trace_len
    300, three traces of 300, 211 and 97 seconds drawn as the synthetic ones
    are (the prefix row too long for registers)."""
    dev = tables.bw.device
    bw, lens = tables.bw.cpu().numpy().copy(), tables.bw_len.cpu().numpy()
    if trace_len == 300:
        bw = np.random.default_rng(seed).uniform(5e5, 4e6, (3, 300)).astype(np.float32)
        lens = np.array([300, 211, 97], np.int32)
        bw[0, 70:74] = 0.0
        bw[1, 210] = 0.0
        bw[2, 63:65] = 0.0
        for k, n in enumerate(lens):
            bw[k, n:] = 0.0
    bw[0, 5:8] = 0.0
    bw[1, 20] = 0.0
    return tables._replace(bw=torch.as_tensor(bw, device=dev),
                           bw_len=torch.as_tensor(lens, device=dev),
                           bw_prefix=build_prefix(bw, lens).to(dev))


def _step_until_every_lane_reset(tables, samples, n, rng):
    """Steps n lanes, started at random seconds of their traces, until every
    lane has reset at least once; each step from the kernel's state against
    the plain version (ints exact, floats 1e-5), and two launches from two
    clones of one state give the same bits."""
    state = init_lanes(tables, samples, n, seed=n)
    lens = tables.bw_len[state.trace.long()].cpu().numpy()
    start = (rng.integers(0, 1 << 20, n) % lens).astype(np.int32)
    state = state._replace(net=state.net._replace(idx=torch.as_tensor(start, device=samples.device)))
    reset = torch.zeros(n, dtype=torch.bool, device=samples.device)
    for step in range(40):
        acts = torch.as_tensor(rng.integers(0, 15, n).astype(np.int32), device=samples.device)
        ref = K1.env_step_plain(tables, samples, tree_map(torch.clone, state), acts, n, True)
        twin = K1.env_step(tables, samples, tree_map(torch.clone, state), acts, n, True)
        got = K1.env_step(tables, samples, state, acts, n, True)
        assert got[0] is state  # updated in place
        for x, y, z in zip(_leaves(got), _leaves(ref), _leaves(twin)):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
            assert torch.equal(x, z)
        reset |= got[2]
        if step >= 6 and bool(reset.all()):
            break
    assert bool(reset.all())


@pytest.mark.cuda
@pytest.mark.parametrize("trace_len", [50, 300])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 129, 512, 4095, 4097, 8192])
def test_env_step_kernel_at_every_block_edge_on_card(cuda_device, n, trace_len):
    """K1 at lane counts around its blocks of 16 lanes, on the synthetic
    50-second traces (the prefix row in registers) and on traces of up to 300
    seconds (from device memory), both with outages, until every lane has
    reset at least once (episodes of 1 to 6 steps)."""
    tables = synthetic_sim_tables(3, 4, 3, 12, 4, seed=n, device=cuda_device)
    rng = np.random.default_rng(n + trace_len)
    end = torch.as_tensor(rng.integers(6, 12, (3, 4)).astype(np.int32), device=cuda_device)
    tables = _with_outages(tables._replace(end_chunk=end), trace_len, seed=n)
    samples = torch.as_tensor(generate_demo_samples(3, 4, 3, 4, 37, seed=n), device=cuda_device)
    _step_until_every_lane_reset(tables, samples, n, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 33, 4097])
def test_env_step_kernel_with_more_history_on_card(cuda_device, n):
    """K1 with 12 history entries a lane, which take 32 threads a lane
    (``env_step_plan``), as the block-edge test runs it."""
    tables = synthetic_sim_tables(3, 4, 3, 12, 4, seed=n, device=cuda_device)._replace(past_k=12)
    assert K1.env_step_plan(n, tables.past_k).group == 32
    rng = np.random.default_rng(n)
    end = torch.as_tensor(rng.integers(6, 12, (3, 4)).astype(np.int32), device=cuda_device)
    tables = _with_outages(tables._replace(end_chunk=end), 50, seed=n)
    samples = torch.as_tensor(generate_demo_samples(3, 4, 3, 4, 37, seed=n), device=cuda_device)
    _step_until_every_lane_reset(tables, samples, n, rng)


@pytest.mark.cuda
def test_observe_and_actor_critic_kernels_match_plain_on_card(cuda_device):
    torch.manual_seed(0)
    policy = MansyActorCritic(device=cuda_device)
    tables = synthetic_sim_tables(device=cuda_device)
    samples = torch.as_tensor(generate_environment_samples(2, 2, 2, 2), device=cuda_device)
    state = _stepped_lanes(tables, samples, steps=4)
    packed = K2.observe_mansy_pack(tables, state)
    torch.testing.assert_close(packed, K2.observe_mansy_pack_plain(tables, state),
                               rtol=1e-5, atol=0.0)
    w = policy.packed_weights()
    for noise in (None, K3.gumbel_noise((N, 15), None, cuda_device)):
        got = K3.actor_critic_forward(w, packed, noise)
        ref = K3.actor_critic_forward_plain(w, packed, noise)
        for x, y in zip(got[:2], ref[:2]):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got[2], ref[2])
        torch.testing.assert_close(got[3], ref[3], rtol=1e-5, atol=1e-5)


def _perturbed_tables(device):
    """Tables whose predicted viewport misses ~15% of tiles."""
    tables = synthetic_sim_tables(3, 4, 3, 20, 4, seed=2, device=device)
    gt = tables.gt.cpu().numpy()
    flip = np.random.default_rng(3).random(gt.shape) < 0.15
    return tables._replace(pred=torch.as_tensor(np.where(flip, 1.0 - gt, gt), device=device))


def _on_cpu(tables):
    return type(tables)(*(x.cpu() if isinstance(x, torch.Tensor) else x for x in tables))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4, 5, 511, 512, 513, 8193])
@pytest.mark.parametrize("mode", ["none", "action_values", "accuracy_corrected", "derived"])
def test_observe_kernel_at_every_block_edge_on_card(cuda_device, n, mode):
    """K2 at the edges of its blocks of 4 lanes and of its two thread groups
    (a warp a lane above 1024 lanes, four below), with and without the
    action values (and the accuracy-corrected ``av_out_*`` tables), and in
    its derived mode (the derived values on tables without them).  Without
    action values every column is a copy or one IEEE division, bit-equal to
    the plain version on the CPU; the action values within 1e-5 of it (its
    sums over the history, and the derived values' over the tiles, run in
    another order).  Into ``obs[1]`` of a
    [3, N, F] buffer (unaligned for odd N: the row-wise path) and into a
    strided view the kernel writes the same bits as into a fresh buffer,
    and nothing beside its rows; two launches give the same bits."""
    tables = _perturbed_tables(cuda_device)
    if mode in ("action_values", "accuracy_corrected"):
        tables = X.attach_action_values(tables, X.build_expert_tables_plain(tables),
                                        acc_correct=mode == "accuracy_corrected")
    av = mode == "derived"
    samples = torch.as_tensor(generate_demo_samples(3, 4, 3, 4, 17), device=cuda_device)
    state = init_lanes(tables, samples, n, seed=n)
    rng = np.random.default_rng(n)
    for _ in range(5):
        acts = torch.as_tensor(rng.integers(0, 15, n).astype(np.int32), device=cuda_device)
        state, *_ = K1.env_step_plain(tables, samples, state, acts, n, True)
    got = K2.observe_mansy_pack(tables, state, action_values=av)
    torch.cuda.synchronize()
    ref = K2.observe_mansy_pack_plain(_on_cpu(tables), tree_map(lambda x: x.cpu(), state),
                                      action_values=av)
    if mode == "none":
        assert torch.equal(got.cpu(), ref)
    else:
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(K2.observe_mansy_pack(tables, state, action_values=av), got)
    F = got.shape[1]
    obs = torch.full((3, n, F), float("nan"), device=cuda_device)
    K2.observe_mansy_pack(tables, state, out=obs[1], action_values=av)
    assert torch.equal(obs[1], got) and bool(obs[0].isnan().all() and obs[2].isnan().all())
    wide = torch.full((n, F + 3), float("nan"), device=cuda_device)
    K2.observe_mansy_pack(tables, state, out=wide[:, :F], action_values=av)
    assert torch.equal(wide[:, :F], got) and bool(wide[:, F:].isnan().all())


def _derived_edge_rows(n: int, case: str, device) -> torch.Tensor:
    """[n, 795] packed rows (the plain derived mode) of lanes a few steps
    into their episodes, with ``case`` on every row (its action-value
    columns zeroed): an empty or a full predicted viewport, an empty
    throughput history, no previous action."""
    tables = _perturbed_tables("cpu")
    samples = torch.as_tensor(generate_demo_samples(3, 4, 3, 4, 17))
    state = init_lanes(tables, samples, n, seed=n)
    rng = np.random.default_rng(n)
    for _ in range(3):
        acts = torch.as_tensor(rng.integers(0, 15, n).astype(np.int32))
        state, *_ = K1.env_step_plain(tables, samples, state, acts, n, True)
    rows = K2.observe_mansy_pack_plain(tables, state, action_values=True)
    cols = K2.obs_columns(8, 5, 64, 15, True)
    rows[:, cols["action_values"]] = 0.0
    edit = {"empty_viewport": ("pred_viewport", 0.0), "full_viewport": ("pred_viewport", 1.0),
            "empty_history": ("throughput", 0.0), "no_previous_action": ("action_one_hot", 0.0)}
    if case in edit:
        field, value = edit[case]
        rows[:, cols[field]] = value
    return rows.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4, 5, 1023, 1024, 1025, 4096])
@pytest.mark.parametrize("case", ["lanes", "empty_viewport", "full_viewport", "empty_history",
                                  "no_previous_action"])
def test_derive_action_values_row_mode_on_card(cuda_device, n, case):
    """K2's row mode (``derive_action_values``) at the edges of its blocks
    and thread groups, on the derived values' edge cases: within 1e-5 of its
    plain version on the CPU (atol 1e-6: its sums over the tiles run in
    another order), every other column untouched, two launches bit-equal,
    and in a strided view the same bits with nothing beside its rows."""
    rows = _derived_edge_rows(n, case, cuda_device)
    got = K2.derive_action_values(rows.clone(), 8, 5, 64, 15)
    torch.cuda.synchronize()
    ref = K2.derive_action_values_plain(rows.cpu(), 8, 5, 64, 15)
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-6)
    col = K2.obs_columns(8, 5, 64, 15, True)["action_values"]
    keep = torch.ones(rows.shape[1], dtype=torch.bool)
    keep[col] = False
    assert torch.equal(got[:, keep.to(cuda_device)], rows[:, keep.to(cuda_device)])
    if case == "empty_history":
        assert bool((got[:, col.stop - 1] == 0.5).all())
    assert torch.equal(K2.derive_action_values(rows.clone(), 8, 5, 64, 15), got)
    wide = torch.full((n, rows.shape[1] + 5), float("nan"), device=cuda_device)
    wide[:, :rows.shape[1]] = rows
    K2.derive_action_values(wide[:, :rows.shape[1]], 8, 5, 64, 15)
    assert torch.equal(wide[:, :rows.shape[1]], got) and bool(wide[:, rows.shape[1]:].isnan().all())


def _numpy_lanes(n: int, seed: int):
    """(tables, state) on the CPU from numpy draws alone: tables of the
    train split's shape whose predicted tiles are 15% fractional, and n
    lanes whose fields K2 reads (the chunk, the buffer, the previous
    quality, the seven histories, the one-hot) drawn anew, about one lane in
    eight with no throughput yet and one in eight with no previous action."""
    tables = synthetic_sim_tables(18, 45, 24, 60, 4, seed=0, device="cpu")
    rng = np.random.default_rng(seed)
    pred = tables.pred.numpy().copy()
    flip = rng.random(pred.shape) < 0.15
    pred[flip] = rng.random(int(flip.sum())).astype(np.float32)
    tables = tables._replace(pred=torch.as_tensor(pred))
    state = init_lanes(tables, torch.as_tensor(generate_environment_samples(18, 45, 24, 4)), n)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    hist = lambda lo, hi: f32(rng.uniform(lo, hi, (n, 8)))
    throughput = hist(0.0, 1.0) * f32(rng.random((n, 1)) > 0.125)
    hot = np.eye(15, dtype=np.float32)[rng.integers(0, 15, n)] * (rng.random((n, 1)) > 0.125)
    state = state._replace(
        next_chunk=torch.as_tensor(rng.integers(4, 59, n).astype(np.int32)),
        buf=f32(rng.uniform(0.0, 30.0, n)),
        qoe=state.qoe._replace(prev_quality=f32(rng.random(n)),
                               has_prev=torch.as_tensor(hot.sum(1) > 0)),
        past_throughput=throughput, past_acc=hist(0.0, 1.0), past_vq=hist(0.0, 1.0),
        past_var=hist(0.0, 0.2), past_rebuf=hist(0.0, 0.5), past_rate_in=hist(0.0, 1.0),
        past_rate_out=hist(0.0, 1.0), last_action_one_hot=f32(hot))
    return tables, state


DERIVED_EDGES = {"empty_viewport": ("pred_viewport", 0.0), "full_viewport": ("pred_viewport", 1.0),
                 "empty_history": ("throughput", 0.0), "no_previous_action": ("action_one_hot", 0.0)}


def derived_digests(K2, dev) -> dict:
    """sha256 (16 hex digits) of K2's derived mode (``observe_mansy_pack(..,
    action_values=True)``) at 32, 128, 512 and 8192 lanes of
    :func:`_numpy_lanes`, and of its row mode (``derive_action_values``) on
    4096 of those lanes' rows (packed by the plain derived mode on the CPU,
    their action-value columns zeroed) and on the edge cases at 512 rows
    (DERIVED_EDGES, both modes: the edited field in the tables or state for
    the derived mode, in the rows for the row mode)."""
    import hashlib

    def digest(x):
        return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]

    def on(t, x):
        return type(x)(*(on(t, y) if isinstance(y, tuple) else y.to(t)
                         if isinstance(y, torch.Tensor) else y for y in x))

    tables, state = _numpy_lanes(8192, 1)
    cols = K2.obs_columns(8, 5, 64, 15, True)
    gpu_tables = on(dev, tables)
    out = {}
    for n in (32, 128, 512, 8192):
        sub = on(dev, tree_map(lambda x: x[:n].contiguous(), state))
        out[f"derived_{n}"] = digest(K2.observe_mansy_pack(gpu_tables, sub, action_values=True))
    for n, edges in ((4096, {"lanes": (None, None)}), (512, DERIVED_EDGES)):
        sub = tree_map(lambda x: x[:n].contiguous(), state)
        base = K2.observe_mansy_pack_plain(tables, sub, action_values=True)
        base[:, cols["action_values"]] = 0.0
        for case, (field, value) in edges.items():
            rows = base.clone()
            if field is not None:
                rows[:, cols[field]] = value
                t, s = tables, sub
                if field == "pred_viewport":
                    t = tables._replace(pred=torch.full_like(tables.pred, value))
                else:
                    name = "past_throughput" if field == "throughput" else "last_action_one_hot"
                    s = sub._replace(**{name: torch.zeros_like(getattr(sub, name))})
                out[f"derived_{case}"] = digest(K2.observe_mansy_pack(
                    on(dev, t), on(dev, s), action_values=True))
            out[f"row_{case}_{n}"] = digest(K2.derive_action_values(rows.to(dev), 8, 5, 64, 15))
    return out


# derived_digests of the one-warp-sum-a-value kernels before the derived
# values' reduce-scatter, taken on an H100 80GB HBM3 by the same function
# bound to that commit's kernels
DERIVED_DIGESTS = {
    "derived_32": "5b0732ea12e22660",
    "derived_128": "a8ac85a87eab39ad",
    "derived_512": "3f84e5ddcddb729c",
    "derived_8192": "47c0616d831fd67a",
    "row_lanes_4096": "0415e87b68855b77",
    "derived_empty_viewport": "11c522720a19cc62",
    "row_empty_viewport_512": "11c522720a19cc62",
    "derived_full_viewport": "74bec0f93e3ed037",
    "row_full_viewport_512": "74bec0f93e3ed037",
    "derived_empty_history": "f92494895133199e",
    "row_empty_history_512": "f92494895133199e",
    "derived_no_previous_action": "26c51578f3722abf",
    "row_no_previous_action_512": "26c51578f3722abf",
}


@pytest.mark.cuda
def test_derived_values_keep_their_bits_on_card(cuda_device):
    """K2's derived and row modes give the bits they gave before their
    reduce-scatter (DERIVED_DIGESTS): the four widths, 4096 rows and the
    edge cases."""
    assert derived_digests(K2, cuda_device) == DERIVED_DIGESTS


def _check_expert_tables(tables):
    """K5 against its plain version (rtol 1e-5, atol 1e-6: the kernel sums
    each quantity over the tiles in its own fixed order), and two launches
    bit-equal."""
    got = K5.build_expert_tables(tables)
    ref = X.build_expert_tables_plain(tables)
    for name, x, y in zip(X.ExpertTables._fields, got, ref):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6, msg=name)
    for name, x, y in zip(X.ExpertTables._fields, got, K5.build_expert_tables(tables)):
        assert torch.equal(x, y), name


def _split_tables(V, U, C, device, seed=0, random_slabs=False):
    """Synthetic tables of V videos, U users and C chunks whose predicted
    viewport misses ~15% of tiles; with ``random_slabs`` the tiles'
    qualities are drawn apart from their rates, so no sum is exact."""
    tables = synthetic_sim_tables(V, U, 3, C, 4, seed=seed, device=device)
    rng = np.random.default_rng(seed + 1)
    gt = tables.gt.cpu().numpy()
    flip = rng.random(gt.shape) < 0.15
    tables = tables._replace(pred=torch.as_tensor(np.where(flip, 1.0 - gt, gt), device=device))
    if random_slabs:
        q = rng.uniform(20.0, 95.0, tables.qualities.shape).astype(np.float32)
        tables = tables._replace(qualities=torch.as_tensor(np.sort(q, axis=2), device=device))
    return tables


@pytest.mark.cuda
def test_expert_tables_kernel_matches_plain_on_card(cuda_device):
    _check_expert_tables(_perturbed_tables(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["test", "train"])
def test_expert_tables_kernel_at_the_splits_shapes_on_card(cuda_device, split):
    """The Jin2022/4G test split's (3 x 15 x 60: the expert's and serve-v16's
    tables) and train split's (18 x 45 x 60) shapes."""
    V, U, C = {"test": (3, 15, 60), "train": (18, 45, 60)}[split]
    _check_expert_tables(_split_tables(V, U, C, cuda_device, random_slabs=True))


@pytest.mark.cuda
@pytest.mark.parametrize("V,U,C", [(1, 1, 1), (1, 13, 1), (1, 8, 1), (1, 9, 1), (2, 13, 5),
                                   (1, 45, 1), (4, 17, 3)])
def test_expert_tables_kernel_at_every_user_group_edge_on_card(cuda_device, V, U, C):
    """V * C = 1 (the plan's fewest blocks) and U on and off a multiple of
    the block's user group."""
    plan = K5.expert_tables_plan(V, U, C, 15)
    assert plan.blocks == V * C * -(-U // plan.users)
    _check_expert_tables(_split_tables(V, U, C, cuda_device, seed=U, random_slabs=True))


@pytest.mark.cuda
@pytest.mark.parametrize("share", [1.0, 0.3])
def test_expert_tables_kernel_on_fractional_weights_on_card(cuda_device, share):
    """Viewport weights in (0, 1) on every row, or on a share of the rows:
    the kernel's path for rows that are not all 0 and 1, and its warps that
    mix both kinds of row."""
    tables = _split_tables(3, 15, 20, cuda_device, seed=7, random_slabs=True)
    rng = np.random.default_rng(8)
    rows = rng.random(tables.gt.shape[:3]) < share
    fuzz = lambda x: torch.where(torch.as_tensor(rows[..., None], device=cuda_device),
                                 x * torch.as_tensor(rng.uniform(0.2, 1.0, x.shape)
                                                     .astype(np.float32), device=cuda_device),
                                 x)
    _check_expert_tables(tables._replace(gt=fuzz(tables.gt), pred=fuzz(tables.pred)))


@pytest.mark.cuda
def test_expert_tables_kernel_on_empty_viewports_on_card(cuda_device):
    """Rows with an empty ground-truth viewport, an empty prediction, both,
    a full prediction (an empty complement) and fractional predicted
    weights."""
    tables = _split_tables(2, 11, 7, cuda_device, seed=5, random_slabs=True)
    gt, pred = tables.gt.clone(), tables.pred.clone()
    gt[0, 0:3] = 0.0
    pred[0, 2:5] = 0.0
    pred[1, 0] = 1.0
    pred[1, 1] = torch.rand(pred[1, 1].shape, generator=torch.Generator(device=cuda_device)
                            .manual_seed(0), device=cuda_device)
    _check_expert_tables(tables._replace(gt=gt, pred=pred))


@pytest.mark.cuda
@pytest.mark.parametrize("horizon", [1, 2, 3, 4])
@pytest.mark.parametrize("mode", ["trace", "bw_hat", "acc_hat", "use_corr"])
def test_choose_action_kernel_matches_plain_on_card(cuda_device, horizon, mode):
    tables = _perturbed_tables(cuda_device)
    samples = torch.as_tensor(generate_demo_samples(3, 4, 3, 4, 17), device=cuda_device)
    etables = X.build_expert_tables_plain(tables)
    state = _stepped_lanes(tables, samples, steps=9)
    bw_hat = X.causal_bw_estimate(tables, state) if mode in ("bw_hat", "use_corr") else None
    acc_hat = viewport_acc_estimate(state.past_acc) if mode in ("acc_hat", "use_corr") else None
    use_corr = (torch.arange(N, device=cuda_device) % 2 == 0) if mode == "use_corr" else None
    action, margin = K4.choose_action(tables, etables, state, horizon, bw_hat, acc_hat,
                                      use_corr, return_margin=True)
    ref_action, ref_margin = X.choose_action_plain(tables, etables, state, horizon, bw_hat,
                                                   acc_hat, use_corr, return_margin=True)
    torch.testing.assert_close(margin, ref_margin, rtol=1e-5, atol=1e-5)
    totals = X.sequence_totals(tables, etables, state, horizon, bw_hat, acc_hat, use_corr)
    first = X.first_action_values(totals, 15)
    wsum = tables.qoe_weights[state.qoe_id.long()].sum(-1)
    gap = (first.amax(-1) - first.gather(1, action.long()[:, None])[:, 0]) / wsum
    decisive = ref_margin > 1e-5
    assert torch.equal(action[decisive], ref_action[decisive])
    assert bool((gap <= 1e-5).all())
    assert torch.equal(K4.choose_action(tables, etables, state, horizon, bw_hat, acc_hat,
                                        use_corr), action)


TIED = slice(0, 8)     # lanes past their end_chunk: every sequence totals 0
MASKED = slice(8, 16)  # lanes with 1 to 3 steps before end_chunk: later steps masked
TRAP = slice(16, 28)   # lanes whose best total is in two first-action blocks


def _tie_crafted(device):
    """(tables, etables, state, bw_hat, acc_hat) on 96 lanes with three
    crafted groups.

    TRAP lanes (one for each (video, user), chunk 5, bw_hat 1, acc_hat 0.5,
    buffer 1, no previous chunk, weights (1, 1, 0)) see dyadic table
    entries, the same in the predicted, deployable and out-of-viewport
    tables, so every total is exact in every scoring mode: step 0 action 5
    downloads 0.5 s at quality 0.5, action 3 1.0 s at 0.75, the others
    nothing; step 1 action 0 downloads 1.5 s at quality 1, action 1 nothing
    at 0.75; later steps are all 0.  Sequence (5, 0) and (3, 1) both total
    1.5, the best: the smaller full index (5) lies in the block of the larger
    first action, so the answer is 5, and the two block maxima tie, so the
    margin is exactly 0."""
    tables = _perturbed_tables(device)
    etables = X.build_expert_tables_plain(tables)
    samples = torch.as_tensor(generate_demo_samples(3, 4, 3, 4, 17), device=device)
    state = _stepped_lanes(tables, samples, steps=9)
    end = tables.end_chunk[state.video.long(), state.user.long()]
    lanes = torch.arange(N, device=device)
    n = state.next_chunk.clone()
    n[TIED] = end[TIED] + 1
    n[MASKED] = end[MASKED] - lanes[MASKED] % 3
    video, user = state.video.clone(), state.user.clone()
    trap = lanes[TRAP]
    video[TRAP], user[TRAP] = (trap - 16) // 4, (trap - 16) % 4
    n[TRAP] = 5
    buf, qoe_id = state.buf.clone(), state.qoe_id.clone()
    buf[TRAP], qoe_id[TRAP] = 1.0, 0
    prev_q, has_prev = state.qoe.prev_quality.clone(), state.qoe.has_prev.clone()
    prev_q[TRAP], has_prev[TRAP] = 0.0, False
    state = state._replace(video=video, user=user, next_chunk=n, buf=buf, qoe_id=qoe_id,
                           qoe=state.qoe._replace(prev_quality=prev_q, has_prev=has_prev))
    scores = ("pred_quality", "pred_intra", "dep_quality", "dep_intra", "out_quality",
              "out_intra")
    crafted = {f: getattr(etables, f).clone() for f in ("pred_size",) + scores}
    for c in range(5, 9):
        for t in crafted.values():
            t[:, :, c] = 0.0
    rate = tables.max_rate
    for c, act, s, q in ((5, 5, 0.5, 0.5), (5, 3, 1.0, 0.75), (6, 0, 1.5, 1.0), (6, 1, 0.0, 0.75)):
        crafted["pred_size"][:, :, c, act] = s
        for f in ("pred_quality", "dep_quality", "out_quality"):
            crafted[f][:, :, c, act] = q * rate
    etables = etables._replace(**crafted)
    weights = tables.qoe_weights.clone()
    weights[0] = torch.tensor([1.0, 1.0, 0.0])
    tables = tables._replace(qoe_weights=weights)
    bw_hat = X.causal_bw_estimate(tables, state)
    bw_hat[TRAP] = 1.0
    acc_hat = viewport_acc_estimate(state.past_acc)
    acc_hat[TRAP] = 0.5
    return tables, etables, state, bw_hat, acc_hat


@pytest.mark.cuda
@pytest.mark.parametrize("horizon", [1, 2, 3, 4])
@pytest.mark.parametrize("mode", ["trace", "bw_hat", "acc_hat", "use_corr"])
def test_choose_action_kernel_breaks_ties_by_full_index_on_card(cuda_device, horizon, mode):
    """Every mode but the trace walk downloads at bw_hat (acc_hat and
    use_corr with it, as DAgger's labels), so the TRAP lanes' totals are
    exact there."""
    tables, etables, state, bw_hat, acc_hat = _tie_crafted(cuda_device)
    bw_hat = None if mode == "trace" else bw_hat
    acc_hat = acc_hat if mode in ("acc_hat", "use_corr") else None
    use_corr = (torch.arange(N, device=cuda_device) % 2 == 0) if mode == "use_corr" else None
    search = (tables, etables, state, horizon, bw_hat, acc_hat, use_corr)
    action, margin = K4.choose_action(*search, return_margin=True)
    ref_action, ref_margin = X.choose_action_plain(*search, return_margin=True)
    assert bool((action[TIED] == 0).all()) and bool((margin[TIED] == 0).all())
    assert bool((ref_action[TIED] == 0).all()) and bool((ref_margin[TIED] == 0).all())
    if mode != "trace":
        want = 3 if horizon == 1 else 5
        assert bool((ref_action[TRAP] == want).all()) and bool((action[TRAP] == want).all())
        if horizon > 1:
            assert bool((margin[TRAP] == 0).all()) and bool((ref_margin[TRAP] == 0).all())
    torch.testing.assert_close(margin, ref_margin, rtol=1e-5, atol=1e-5)
    decisive = ref_margin > 1e-5
    assert torch.equal(action[decisive], ref_action[decisive])
    totals = X.sequence_totals(*search)
    first = X.first_action_values(totals, 15)
    gap = first.amax(-1) - first.gather(1, action.long()[:, None])[:, 0]
    assert bool((gap <= 1e-5 * tables.qoe_weights[state.qoe_id.long()].sum(-1)).all())
    again = K4.choose_action(*search, return_margin=True)
    assert torch.equal(again[0], action) and torch.equal(again[1], margin)


# K4 past the expert's default horizon (the JAX CLIs take any --horizon, the
# kernel 1 to 7): lanes held at each horizon, spread over the 96 stepped
# lanes.  The plain version runs a lane at a time: at 7 a lane's 15^7 totals
# are 683 MB of f32, and its trace walk holds ~40 such temporaries.
LONG_HORIZON_LANES = {5: 16, 6: 4, 7: 2}


@pytest.mark.cuda
@pytest.mark.parametrize("horizon", [5, 6, 7])
@pytest.mark.parametrize("mode", ["trace", "bw_hat", "acc_hat", "use_corr"])
def test_choose_action_kernel_at_long_horizons_on_card(cuda_device, horizon, mode):
    """K4 at horizons 5, 6 and 7 in every mode against its plain version, by
    the near-tie rule of ``test_choose_action_kernel_matches_plain_on_card``
    (margins within 1e-5, the plain action on every lane whose margin
    exceeds 1e-5, elsewhere one within 1e-5 of the best first-action
    value); two launches give the same bits."""
    tables = _perturbed_tables(cuda_device)
    samples = torch.as_tensor(generate_demo_samples(3, 4, 3, 4, 17), device=cuda_device)
    etables = X.build_expert_tables_plain(tables)
    n = LONG_HORIZON_LANES[horizon]
    lanes = torch.linspace(0, N - 1, n, device=cuda_device).long()
    state = tree_map(lambda x: x[lanes], _stepped_lanes(tables, samples, steps=9))
    bw_hat = X.causal_bw_estimate(tables, state) if mode in ("bw_hat", "use_corr") else None
    acc_hat = viewport_acc_estimate(state.past_acc) if mode in ("acc_hat", "use_corr") else None
    use_corr = (torch.arange(n, device=cuda_device) % 2 == 0) if mode == "use_corr" else None
    search = (bw_hat, acc_hat, use_corr)
    action, margin = K4.choose_action(tables, etables, state, horizon, *search,
                                      return_margin=True)
    refs, firsts = [], []
    for i in range(n):
        lane = tree_map(lambda x: x[i:i + 1], state)
        one = tuple(None if x is None else x[i:i + 1] for x in search)
        refs.append(X.choose_action_plain(tables, etables, lane, horizon, *one,
                                          return_margin=True))
        firsts.append(X.first_action_values(
            X.sequence_totals(tables, etables, lane, horizon, *one), 15))
    ref_action, ref_margin = (torch.cat(x) for x in zip(*refs))
    torch.testing.assert_close(margin, ref_margin, rtol=1e-5, atol=1e-5)
    first = torch.cat(firsts)
    wsum = tables.qoe_weights[state.qoe_id.long()].sum(-1)
    gap = (first.amax(-1) - first.gather(1, action.long()[:, None])[:, 0]) / wsum
    decisive = ref_margin > 1e-5
    assert torch.equal(action[decisive], ref_action[decisive])
    assert bool((gap <= 1e-5).all())
    again = K4.choose_action(tables, etables, state, horizon, *search, return_margin=True)
    assert torch.equal(again[0], action) and torch.equal(again[1], margin)


@pytest.mark.cuda
@pytest.mark.parametrize("use_av", [False, True])
def test_actor_critic_cluster_follows_n_on_card(cuda_device, use_av):
    """K3's cluster shrinks as N grows: one CTA a unit (the wide branches
    halved) for one tile, fewer CTAs of whole branches once the split
    clusters take more than one wave, one CTA a tile at 65536 rows."""
    w = MansyActorCritic(use_action_values=use_av, device=cuda_device).packed_weights()
    plans = [K3.cluster_plan(w, n) for n in (1, 512, 4096, 8192, 1 << 16)]
    assert plans[0] == ((13 if use_av else 12), True)
    assert all(a[0] >= b[0] for a, b in zip(plans, plans[1:])), plans
    assert plans[-1] == (1, False), plans


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 15, 17, 33, 511, 512, 513, 4096, 8192])
@pytest.mark.parametrize("use_av,prior", [(False, 0.0), (False, 3.0), (True, 0.0),
                                          (True, 3.0)])
def test_actor_critic_kernel_at_every_tile_edge_on_card(cuda_device, n, use_av, prior):
    """K3 (forward with and without noise, and training mode) with 10 or 11
    branches, the prior on and off, at row counts around its 32-row tile and
    in each cluster shape (split units at 512 rows, whole branches at 4096,
    one CTA a tile at 8192); two launches give the same bits; the training
    outputs feed K10."""
    from mansy_immersivevideostreaming_torch.kernels.observe import obs_width
    torch.manual_seed(n)
    policy = MansyActorCritic(use_action_values=use_av, av_logit_prior=prior,
                              device=cuda_device)
    w = policy.packed_weights()
    assert len(w.branch_off) - 1 == (11 if use_av else 10) and w.av_prior == prior
    g = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.rand(n, obs_width(*policy.dims), device=cuda_device, generator=g)
    for noise in (None, K3.gumbel_noise((n, 15), g, cuda_device)):
        got = K3.actor_critic_forward(w, x, noise)
        ref = K3.actor_critic_forward_plain(w, x, noise)
        for a, b in zip(got[:2], ref[:2]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        scores = ref[0] if noise is None else ref[0] + noise
        top2 = scores.topk(2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > 1e-4
        assert torch.equal(got[2][decisive], ref[2][decisive])
        torch.testing.assert_close(got[3][decisive], ref[3][decisive], rtol=1e-5, atol=1e-5)
        again = K3.actor_critic_forward(w, x, noise)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    got = K3.actor_critic_train_forward(w, x)
    ref = K3.actor_critic_train_forward_plain(w, x)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, K3.actor_critic_train_forward(w, x)))
    dlogits = torch.randn(n, 15, device=cuda_device, generator=g)
    dvalue = torch.randn(n, device=cuda_device, generator=g)
    grads = K3.actor_critic_backward(w, x, got[2], got[3], dlogits, dvalue)
    for a, b in zip(grads, K3.actor_critic_backward_plain(w, x, got[2], got[3], dlogits, dvalue)):
        _grad_close(a, b)
    # against the plain path end to end, where no LeakyReLU input sits so
    # near 0 that the two forwards put it on different sides
    if all(bool(((k >= 0) == (p >= 0)).all()) for k, p in zip(got[2:], ref[2:])):
        for a, b in zip(grads, K3.actor_critic_backward_plain(w, x, ref[2], ref[3], dlogits,
                                                              dvalue)):
            _grad_close(a, b)


@pytest.mark.cuda
def test_v16_observation_and_forward_kernels_match_plain_on_card(cuda_device):
    tables = _perturbed_tables(cuda_device)
    tables = X.attach_action_values(tables, X.build_expert_tables_plain(tables),
                                    acc_correct=True)
    samples = torch.as_tensor(generate_demo_samples(3, 4, 3, 4, 17), device=cuda_device)
    state = _stepped_lanes(tables, samples, steps=5)
    packed = K2.observe_mansy_pack(tables, state)
    torch.testing.assert_close(packed, K2.observe_mansy_pack_plain(tables, state),
                               rtol=1e-5, atol=1e-6)
    w = load_npz_policy(DAGGER_V16_NPZ, device=cuda_device).packed_weights()
    got = K3.actor_critic_forward(w, packed)
    ref = K3.actor_critic_forward_plain(w, packed)
    for x, y in zip(got[:2], ref[:2]):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[3], ref[3], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- training

def _grad_close(got, ref, rtol=1e-4):
    """Gradients summed over the batch in another order: rtol plus 1e-5 of
    the tensor's largest entry."""
    torch.testing.assert_close(got, ref, rtol=rtol, atol=1e-5 * float(ref.abs().max()) + 1e-12)


def _gae_inputs(T, N, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    rewards = torch.randn(T, N, device=device, generator=g)
    values = torch.randn(T, N, device=device, generator=g)
    dones = torch.rand(T, N, device=device, generator=g) < 0.1
    last = torch.randn(N, device=device, generator=g)
    return rewards, dones, values, last


def _check_gae(rewards, dones, values, last):
    """K6 bit-equal to its plain version (the same operation order,
    -fmad=false) and on two launches."""
    from mansy_immersivevideostreaming_torch.kernels import gae as K6
    got = K6.compute_gae(rewards, dones, values, last, 0.95, 0.95)
    ref = K6.compute_gae_plain(rewards, dones, values, last, 0.95, 0.95)
    again = K6.compute_gae(rewards, dones, values, last, 0.95, 0.95)
    for x, y, z in zip(got, ref, again):
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.cuda
@pytest.mark.parametrize("T,N", [(1, 7), (1, 8192), (32, 128), (64, 1000), (45, 48), (33, 64),
                                 (128, 8192), (200, 300), (300, 4112)])
def test_gae_kernel_matches_plain_on_card(cuda_device, T, N):
    """T = 1, T on and off the 32-step chunk and beyond the four chunks in
    flight (200, 300), N on and off the 32-lane tile and 16-lane copies;
    [32, 128] (train) and [128, 8192] (the rollout width)."""
    _check_gae(*_gae_inputs(T, N, cuda_device, T))


@pytest.mark.cuda
@pytest.mark.parametrize("T,N", [(1, 64), (32, 128), (128, 8192), (70, 100)])
def test_gae_kernel_with_dones_at_both_ends_on_card(cuda_device, T, N):
    """dones at t = 0 on every third lane and at t = T - 1 on every
    second."""
    rewards, dones, values, last = _gae_inputs(T, N, cuda_device, T + 1)
    dones[0, ::3] = True
    dones[T - 1, ::2] = True
    _check_gae(rewards, dones, values, last)


@pytest.mark.cuda
def test_gae_kernel_on_unaligned_inputs_on_card(cuda_device):
    """Inputs that start 4 bytes past a 16-byte boundary take the ordinary
    loads (N = 8192, a multiple of 16)."""
    T, N = 40, 8192
    rewards, dones, values, last = _gae_inputs(T, N, cuda_device, 9)
    shifted = []
    for x in (rewards, values):
        buf = torch.empty(T * N + 1, device=cuda_device)
        buf[1:] = x.reshape(-1)
        shifted.append(buf[1:].view(T, N))
    buf = torch.zeros(T * N + 1, dtype=torch.bool, device=cuda_device)
    buf[1:] = dones.reshape(-1)
    assert shifted[0].data_ptr() % 16 != 0
    _check_gae(shifted[0], buf[1:].view(T, N), shifted[1], last)


POLICY_LOSS_VARIANTS = ["clip_norm", "no_value_clip", "no_norm", "per_pref", "kl_scalar",
                        "kl_per_pref", "ce", "a2c"]


def _policy_loss_inputs(K9, variant, B, device, seed):
    """(spec, logits, value) of one K9 variant at B rows, from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(*s, device=device, generator=g)
    logits, value = 2.0 * r(B, 15), r(B)
    action = torch.randint(0, 15, (B,), device=device, generator=g, dtype=torch.int32)
    if variant == "ce":
        return K9.LossSpec(action=action, ent_coef=0.1), logits, None
    if variant == "a2c":
        return K9.LossSpec(action=action, ent_coef=0.01, adv=0.5 + 2.0 * r(B), ret=1.5 * r(B),
                           vf_coef=0.5, mode="a2c"), logits, value
    logp = torch.log_softmax(logits, -1).gather(1, action.long()[:, None])[:, 0]
    kl = {"kl_scalar": torch.tensor(0.7), "kl_per_pref": torch.tensor([2.0, 1.0, 0.1, 0.5])}
    spec = K9.LossSpec(
        action=action, ent_coef=0.02, old_log_prob=logp + 0.3 * r(B),
        old_value=value + 0.3 * r(B), adv=0.5 + 2.0 * r(B), ret=1.5 * r(B),
        pref_id=torch.randint(0, 4, (B,), device=device, generator=g, dtype=torch.int32),
        anchor_logits=1.5 * r(B, 15) if variant in kl else None,
        kl_coef=kl[variant].to(device) if variant in kl else None,
        value_clip=variant != "no_value_clip", norm_adv=variant != "no_norm",
        norm_adv_per_pref=variant in ("per_pref", "kl_per_pref"), mode="ppo")
    return spec, logits, value


def _assert_policy_loss_close(got, ref):
    for x, y in zip(got, ref):
        if y is None:
            assert x is None
        else:
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6 * float(y.abs().max()) + 1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", POLICY_LOSS_VARIANTS)
def test_policy_loss_kernel_matches_plain_on_card(cuda_device, variant):
    from mansy_immersivevideostreaming_torch.kernels import policy_loss as K9
    spec, logits, value = _policy_loss_inputs(K9, variant, 777, cuda_device, len(variant))
    _assert_policy_loss_close(K9.policy_loss(spec, logits, value),
                              K9.policy_loss_plain(spec, logits, value))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 17, 255, 256, 257, 512, 4095, 4096, 4097, 20000])
@pytest.mark.parametrize("variant", POLICY_LOSS_VARIANTS)
def test_policy_loss_kernel_at_every_batch_on_card(cuda_device, variant, B):
    """K9 at batches around its 128-, 256- and 512-row tiles and 16-CTA
    clusters (each CTA looping over tiles at 20000 rows), against its plain
    version; two launches give the same bits."""
    from mansy_immersivevideostreaming_torch.kernels import policy_loss as K9
    spec, logits, value = _policy_loss_inputs(K9, variant, B, cuda_device, B + len(variant))
    got = K9.policy_loss(spec, logits, value)
    _assert_policy_loss_close(got, K9.policy_loss_plain(spec, logits, value))
    again = K9.policy_loss(spec, logits, value)
    assert all(x is None and y is None or torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("v16", [False, True])
def test_actor_critic_train_and_backward_kernels_match_plain_on_card(cuda_device, v16):
    from mansy_immersivevideostreaming_torch.utils.checkpoint import DAGGER_V9_NPZ
    policy = load_npz_policy(DAGGER_V16_NPZ if v16 else DAGGER_V9_NPZ, device=cuda_device)
    B = 300
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.rand(B, 795 if v16 else 779, device=cuda_device, generator=g)
    w = policy._pack()
    got = K3.actor_critic_train_forward(w, x)
    ref = K3.actor_critic_train_forward_plain(w, x)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    dlogits = torch.randn(B, 15, device=cuda_device, generator=g)
    dvalue = torch.randn(B, device=cuda_device, generator=g)
    with torch.no_grad():
        grads = K3.actor_critic_backward(w, x, *ref[2:], dlogits, dvalue)
        want = K3.actor_critic_backward_plain(w, x, *ref[2:], dlogits, dvalue)
    for a, b in zip(grads, want):
        _grad_close(a, b)
    # through the autograd Function and _pack, into every parameter
    logits, value = policy.forward_packed(x)
    ((logits * dlogits).sum() + (value * dvalue).sum()).backward()
    assert all(p.grad is not None for p in policy.parameters())
    _grad_close(policy.actor_fc.weight.grad, want[2][:, :128].t())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 17, 300, 512, 513, 4096, 4097])
@pytest.mark.parametrize("v16", [False, True, "v18"])
def test_actor_critic_backward_kernel_at_every_batch_on_card(cuda_device, v16, B):
    """K10 against its plain version at batches around its 32-row and 32-deep
    tiles and at the paths' 512 and 4096 rows (each launch plan), with the
    v9, v16 and v18 (hidden 256) weights; two launches give the same bits."""
    from mansy_immersivevideostreaming_torch.utils.checkpoint import (
        DAGGER_V9_NPZ, DAGGER_V18_NPZ,
    )
    path = DAGGER_V18_NPZ if v16 == "v18" else DAGGER_V16_NPZ if v16 else DAGGER_V9_NPZ
    w = load_npz_policy(path, device=cuda_device).packed_weights()
    g = torch.Generator(device=cuda_device).manual_seed(B)
    x = torch.rand(B, 795 if v16 is True else 779, device=cuda_device, generator=g)
    _, _, feats, hidden = K3.actor_critic_train_forward_plain(w, x)
    dlogits = torch.randn(B, 15, device=cuda_device, generator=g) / B
    dvalue = torch.randn(B, device=cuda_device, generator=g) / B
    grads = K3.actor_critic_backward(w, x, feats, hidden, dlogits, dvalue)
    want = K3.actor_critic_backward_plain(w, x, feats, hidden, dlogits, dvalue)
    for a, b in zip(grads, want):
        _grad_close(a, b)
    again = K3.actor_critic_backward(w, x, feats, hidden, dlogits, dvalue)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


# --------------------------------------------------------- viewport serving

def _edge_positions(n: int, seed: int) -> torch.Tensor:
    """[n, 15, 2] normalized positions, half of them on or one pixel (one f32
    ulp) beside a tile edge or a FoV edge (the wrap cases)."""
    rng = np.random.default_rng(seed)
    cols = []
    for size, tile, half in ((2560, 320, 300), (1440, 180, 150)):
        px = np.arange(0, size + 1, tile)
        px = np.concatenate([px, px - half, px + half])
        px = np.concatenate([px - 1, px, px + 1])
        v = (px[(px >= 0) & (px <= size)] / size).astype(np.float32)
        v = np.concatenate([v, np.nextafter(v, np.float32(-1)), np.nextafter(v, np.float32(2))])
        edge = rng.choice(v, (n, 15))
        cols.append(np.where(rng.random((n, 15)) < 0.5, edge,
                             rng.random((n, 15), dtype=np.float32)))
    return torch.as_tensor(np.stack(cols, -1).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("frequency", [1, 5, 15])
def test_chunk_maps_kernel_matches_plain_on_card(cuda_device, frequency):
    from mansy_immersivevideostreaming_torch.kernels import tile_occupancy as K7
    gt, pred = (_edge_positions(700, s).to(cuda_device) for s in (frequency, frequency + 1))
    g, p, iou = K7.chunk_maps(gt, pred, frequency)
    rg, rp, riou = K7.chunk_maps_plain(gt, pred, frequency)
    assert torch.equal(g, rg) and torch.equal(p, rp)
    torch.testing.assert_close(iou, riou, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 15, 16, 17, 208, 511, 512, 513])
@pytest.mark.parametrize("frequency", [1, 5, 8, 9, 15])
def test_chunk_maps_kernel_at_every_block_edge_on_card(cuda_device, B, frequency):
    """K7 chunk mode at the edges of its blocks of 4 trajectories (208 is
    the export's last batch, 77,520 % 512) and of its groups' 8 step slots
    (frequency 8 and 9): maps bit-equal to the plain version, the IoU to
    1e-5 (in fact equal: quotients of the same integers), two launches
    bit-equal."""
    from mansy_immersivevideostreaming_torch.kernels import tile_occupancy as K7
    gt, pred = (_edge_positions(B, s).to(cuda_device) for s in (B, B + 1))
    g, p, iou = K7.chunk_maps(gt, pred, frequency)
    rg, rp, riou = K7.chunk_maps_plain(gt, pred, frequency)
    assert torch.equal(g, rg) and torch.equal(p, rp)
    torch.testing.assert_close(iou, riou, rtol=1e-5, atol=0)
    assert all(torch.equal(x, y) for x, y in zip(K7.chunk_maps(gt, pred, frequency),
                                                  (g, p, iou)))


@pytest.mark.cuda
def test_trajectory_metrics_kernel_matches_plain_on_card(cuda_device):
    from mansy_immersivevideostreaming_torch.kernels import tile_occupancy as K7
    gt, pred = (_edge_positions(700, s).to(cuda_device) for s in (7, 8))
    for x, y in zip(K7.trajectory_metrics(gt, pred), K7.trajectory_metrics_plain(gt, pred)):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 15, 1), (1, 15, 8), (1, 15, 15), (1, 3, None),
                                   (5, 5, None), (16, 16, 1)])
@pytest.mark.parametrize("H,Dh", [(8, 64), (8, 4)])
def test_attention_kernel_matches_plain_and_sdpa_on_card(cuda_device, shape, H, Dh):
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    Lq, Lk, kv_len0 = shape
    g = torch.Generator(device=cuda_device).manual_seed(Lq * 100 + Lk)
    q = torch.randn(77, Lq, H, Dh, device=cuda_device, generator=g)
    k = torch.randn(77, Lk, H, Dh, device=cuda_device, generator=g)
    v = torch.randn(77, Lk, H, Dh, device=cuda_device, generator=g)
    _attention_matches_plain_and_sdpa(K8, q, k, v, kv_len0)


def _attention_matches_plain_and_sdpa(K8, q, k, v, kv_len0):
    """K8 within rtol 1e-5, atol 1e-6 of its plain version and 1e-5 of SDPA's
    math backend; a second launch gives the same bits."""
    Lq, Lk = q.shape[1], k.shape[1]
    got = K8.attention(q, k, v, kv_len0)
    torch.testing.assert_close(got, K8.attention_plain(q, k, v, kv_len0), rtol=1e-5, atol=1e-6)
    seen = torch.arange(Lq, device=q.device) + (Lk if kv_len0 is None else kv_len0)
    mask = torch.arange(Lk, device=q.device)[None, :] < seen[:, None]
    with torch.nn.attention.sdpa_kernel(torch.nn.attention.SDPBackend.MATH):
        sdpa = torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask)
    torch.testing.assert_close(got, sdpa.transpose(1, 2), rtol=1e-5, atol=1e-5)
    assert torch.equal(got, K8.attention(q, k, v, kv_len0))


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lk,kv_len0", [(1, 100, None), (3, 100, 50), (1, 2048, None),
                                           (2, 2048, 1000)])
@pytest.mark.parametrize("Dh", [4, 64, 256])
def test_attention_kernel_over_long_keys_and_every_width_on_card(cuda_device, Lq, Lk, kv_len0,
                                                                 Dh):
    """Keys past one shared-memory tile (walked tile by tile at 2048 keys, and
    at 100 keys of Dh 256), heads of 4 to 256 dims, a batch that is no
    multiple of anything (77, or 5 at 2048 keys)."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    B, H = (77 if Lk <= 100 else 5), 8
    g = torch.Generator(device=cuda_device).manual_seed(Lk + Dh)
    q = torch.randn(B, Lq, H, Dh, device=cuda_device, generator=g)
    k = torch.randn(B, Lk, H, Dh, device=cuda_device, generator=g)
    v = torch.randn(B, Lk, H, Dh, device=cuda_device, generator=g)
    _attention_matches_plain_and_sdpa(K8, q, k, v, kv_len0)


# K8's training shapes (Lq, Lk, kv_len0) at run_models' widths: the encoder,
# decode steps over the 15-slot cache, cross-attention, the teacher-forced
# causal pass and its cross-attention, and the fixed-buffer decode's 16 x 16
TRAIN_SHAPES = [(5, 5, None), (1, 15, 1), (1, 15, 8), (1, 15, 15), (1, 3, None),
                (15, 15, 1), (15, 3, None), (16, 16, 1)]


def _attention_training_matches_plain(K8, B, shape, H, Dh, dropout, seed):
    """K8's training forward and backward against the plain version's
    autograd: rtol 1e-5 plus 1e-5 of the largest entry of the output, or of
    the three gradients (the kernels sum in another order; a gradient that
    is 0 in exact arithmetic, as dq and dk where a row sees one key, is
    rounding noise in autograd's softmax backward); keys no row sees get
    exactly 0; two launches of each give the same bits; ``attention`` under
    autograd launches them."""
    Lq, Lk, kv_len0 = shape
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, L, H, Dh, device=dev, generator=g) for L in (Lq, Lk, Lk))
    dout = torch.randn(B, Lq, H, Dh, device=dev, generator=g)
    keep = ((torch.rand(B, H, Lq, Lk, device=dev, generator=g) < 0.9).to(torch.uint8)
            if dropout else None)

    def close(got, want, scale):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)

    o, row_max, row_sum = K8.attention_train_forward(q, k, v, kv_len0, keep, 0.1)
    want_o, want_max, want_sum = K8.attention_train_forward_plain(q, k, v, kv_len0, keep, 0.1)
    for got, want in ((o, want_o), (row_max, want_max), (row_sum, want_sum)):
        close(got, want, float(want.abs().max()))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(K8.attention_plain(*leaves, kv_len0, keep, 0.1), leaves, dout)
    scale = max(float(w.abs().max()) for w in want)
    got = K8.attention_backward(dout, q, k, v, o, row_max, row_sum, kv_len0, keep, 0.1)
    for a, b in zip(got, want):
        close(a, b, scale)
    written = K8.attention_backward_plain(dout, q, k, v, o, row_max, row_sum, kv_len0, keep,
                                          0.1)
    for a, b in zip(got, written):
        close(a, b, scale)
    if kv_len0 is not None:
        unseen = slice(min(Lk, kv_len0 + Lq - 1), None)
        assert not got[1][:, unseen].any() and not got[2][:, unseen].any()
    assert all(torch.equal(a, b) for a, b in zip(
        (o, row_max, row_sum), K8.attention_train_forward(q, k, v, kv_len0, keep, 0.1)))
    assert all(torch.equal(a, b) for a, b in zip(got, K8.attention_backward(
        dout, q, k, v, o, row_max, row_sum, kv_len0, keep, 0.1)))
    launches = (K8.attention_train_forward.launches, K8.attention_backward.launches)
    out = K8.attention(*leaves, kv_len0, keep, 0.1)
    assert torch.equal(out, o)
    by_autograd = torch.autograd.grad(out, leaves, dout)
    assert all(torch.equal(a, b) for a, b in zip(by_autograd, got))
    assert (K8.attention_train_forward.launches, K8.attention_backward.launches) == (
        launches[0] + 1, launches[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TRAIN_SHAPES)
@pytest.mark.parametrize("dropout", [False, True])
def test_attention_training_kernels_match_plain_on_card(cuda_device, shape, dropout):
    """K8's training forward and backward at 8 heads of 64 over a batch of
    77, with and without a dropout keep mask at 0.1."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    _attention_training_matches_plain(K8, 77, shape, 8, 64, dropout, sum(shape[:2]))


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lk,kv_len0,Dh", [(1, 1, None, 4), (3, 7, 2, 33), (64, 64, 1, 64),
                                              (20, 40, None, 256), (2, 64, 10, 100),
                                              (96, 96, 1, 64), (70, 130, 50, 256),
                                              (40, 33, None, 33), (1, 256, None, 256)])
def test_attention_backward_at_other_widths_on_card(cuda_device, Lq, Lk, kv_len0, Dh):
    """Heads of 4 to 256 dims (each dims-a-lane instantiation of the plan),
    rows and keys on both sides of a tile (32 rows, 4 to 32 keys), a batch
    of 5."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    _attention_training_matches_plain(K8, 5, (Lq, Lk, kv_len0), 3, Dh, True, Lq + Lk + Dh)


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lk,kv_len0", [(65, 65, 1), (96, 96, None), (96, 96, 1),
                                           (1, 300, None), (1, 300, 200), (5, 300, None),
                                           (33, 300, 250)])
def test_attention_backward_beyond_64_keys_on_card(cuda_device, Lq, Lk, kv_len0):
    """Past 64 rows or keys (the limit of the earlier kernel's whole-head
    tiles) the backward walks key and row tiles: 65, 96 and 300 keys, causal
    and prefix masks, one and many rows, 8 heads of 64, with and without
    dropout, against the plain version; ``attention`` under autograd
    launches it."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    for dropout in (False, True):
        _attention_training_matches_plain(K8, 7, (Lq, Lk, kv_len0), 8, 64, dropout, Lq + Lk)


# ------------------------------------------------------------- K8 in bf16

# the training shapes, the --his-window 96 encoder and its cross-attention
# over the distilled 48, and a decode step over 256 keys
BF16_SHAPES = TRAIN_SHAPES + [(96, 96, None), (1, 48, None), (1, 256, None)]


def _attention_bf16_matches_plain(K8, B, shape, H, Dh, dropout, seed):
    """K8 on bf16 q, k, v (serving, training forward, backward) against its
    plain bf16 version: outputs and gradients in bf16, each element within
    one bf16 ulp of the larger of the two plus ``bf16_slack`` (P and dP' are
    rounded to bf16 inside, from f32 values the two compute in another
    order), the row statistics as the f32 kernels'; keys no row sees
    exactly 0 in dk and dv; two launches bit-equal; ``attention`` under
    autograd launches both kernels in their bf16 mode."""
    Lq, Lk, kv_len0 = shape
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, L, H, Dh, device=dev, generator=g).bfloat16()
               for L in (Lq, Lk, Lk))
    dout = torch.randn(B, Lq, H, Dh, device=dev, generator=g).bfloat16()
    keep = ((torch.rand(B, H, Lq, Lk, device=dev, generator=g) < 0.9).to(torch.uint8)
            if dropout else None)
    serve = K8.attention(q, k, v, kv_len0)
    assert serve.dtype == torch.bfloat16
    slack_o = K8.bf16_slack(q, k, v, dout, kv_len0)[0]
    assert K8.bf16_excess(serve, K8.attention_plain(q, k, v, kv_len0), slack_o) <= 1
    assert torch.equal(serve, K8.attention(q, k, v, kv_len0))
    slack = K8.bf16_slack(q, k, v, dout, kv_len0, keep, 0.1)
    o, row_max, row_sum = K8.attention_train_forward(q, k, v, kv_len0, keep, 0.1)
    want_o, want_max, want_sum = K8.attention_train_forward_plain(q, k, v, kv_len0, keep, 0.1)
    assert K8.bf16_excess(o, want_o, slack[0]) <= 1
    for got, want in ((row_max, want_max), (row_sum, want_sum)):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(K8.attention_plain(*leaves, kv_len0, keep, 0.1), leaves, dout)
    got = K8.attention_backward(dout, q, k, v, o, row_max, row_sum, kv_len0, keep, 0.1)
    written = K8.attention_backward_plain(dout, q, k, v, o, row_max, row_sum, kv_len0, keep,
                                          0.1)
    for a, b, c, sl in zip(got, want, written, slack[1:]):
        assert a.dtype == torch.bfloat16
        assert K8.bf16_excess(a, b, sl) <= 1
        assert K8.bf16_excess(a, c, sl) <= 1
    if kv_len0 is not None:
        unseen = slice(min(Lk, kv_len0 + Lq - 1), None)
        assert not got[1][:, unseen].any() and not got[2][:, unseen].any()
    assert all(torch.equal(a, b) for a, b in zip(
        (o, row_max, row_sum), K8.attention_train_forward(q, k, v, kv_len0, keep, 0.1)))
    assert all(torch.equal(a, b) for a, b in zip(got, K8.attention_backward(
        dout, q, k, v, o, row_max, row_sum, kv_len0, keep, 0.1)))
    before = [dict(w.launches_by_mode) for w in (K8.attention_train_forward,
                                                 K8.attention_backward)]
    out = K8.attention(*leaves, kv_len0, keep, 0.1)
    assert torch.equal(out, o)
    assert all(torch.equal(a, b) for a, b in zip(torch.autograd.grad(out, leaves, dout), got))
    # the bf16 modes: past 2048 keys the streamed kernel's and the split's, past 256 dims
    # the wide kernels'
    modes = ("bf16" + K8.forward_mode(K8.attention_forward_plan(B, Lq, Lk, H, Dh), Dh),
             "bf16" + K8.backward_mode(K8.attention_backward_plan(B, Lq, Lk, H, Dh)))
    for w, counts, mode in zip((K8.attention_train_forward, K8.attention_backward), before,
                               modes):
        assert w.launches_by_mode[mode] == counts.get(mode, 0) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BF16_SHAPES)
@pytest.mark.parametrize("dropout", [False, True])
def test_attention_bf16_kernels_match_plain_on_card(cuda_device, shape, dropout):
    """K8 in bf16 at 8 heads of 64 over a batch of 77, every training shape
    and the long ones, with and without a keep mask at 0.1."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    _attention_bf16_matches_plain(K8, 77, shape, 8, 64, dropout, 7 + sum(shape[:2]))


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lk,kv_len0,Dh", [(1, 1, None, 4), (3, 7, 2, 33), (64, 64, 1, 64),
                                              (20, 40, None, 256), (2, 64, 10, 100),
                                              (70, 130, 50, 256), (40, 33, None, 33),
                                              (1, 300, 200, 128), (33, 300, 250, 64)])
def test_attention_bf16_at_other_widths_on_card(cuda_device, Lq, Lk, kv_len0, Dh):
    """bf16 heads of 4 to 256 dims, rows and keys on both sides of the
    backward's tiles, a batch of 5."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    _attention_bf16_matches_plain(K8, 5, (Lq, Lk, kv_len0), 3, Dh, True, Lq + Lk + Dh)


@pytest.mark.cuda
def test_attention_refuses_other_dtypes_on_card(cuda_device):
    """f16, f64 or mixed q, k, v raise a ValueError, as a bf16 backward with
    an f32 dO or o does; nothing is cast."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    x = torch.randn(4, 3, 8, 64, device=cuda_device)
    for dtypes in ((torch.float16,) * 3, (torch.float64,) * 3,
                   (torch.bfloat16, torch.float32, torch.bfloat16),
                   (torch.float32, torch.float32, torch.bfloat16)):
        args = [x.to(d) for d in dtypes]
        for fn in (K8.attention, K8.attention_train_forward):
            with pytest.raises(ValueError, match="float32 or all bfloat16"):
                fn(*args)
    q = x.bfloat16()
    o, row_max, row_sum = K8.attention_train_forward(q, q, q)
    for dout, out in ((x, o), (q, o.float())):
        with pytest.raises(ValueError, match="bfloat16"):
            K8.attention_backward(dout, q, q, q, out, row_max, row_sum)


def attention_digests(K8, dev, dtype=torch.float32) -> dict:
    """sha256 (16 hex digits) of K8's outputs (serving, training forward
    with a keep mask at 0.1, backward) on numpy-seeded inputs in ``dtype``
    (f32, or the same values rounded to bf16) at each training shape and
    the two long ones, B 33, 8 heads of 64; each output hashed as f32 (a
    bf16 value upcasts exactly)."""
    import hashlib
    out = {}
    for shape in TRAIN_SHAPES + [(96, 96, None), (1, 256, None)]:
        Lq, Lk, kv_len0 = shape
        rng = np.random.default_rng(Lq * 1000 + Lk)
        q, k, v, dout = (torch.as_tensor(rng.standard_normal((33, L, 8, 64), dtype=np.float32),
                                         device=dev).to(dtype) for L in (Lq, Lk, Lk, Lq))
        keep = torch.as_tensor(rng.random((33, 8, Lq, Lk)) < 0.9, device=dev).to(torch.uint8)
        fwd = K8.attention_train_forward(q, k, v, kv_len0, keep, 0.1)
        bwd = K8.attention_backward(dout, q, k, v, *fwd, kv_len0, keep, 0.1)
        h = hashlib.sha256()
        for t in (K8.attention(q, k, v, kv_len0), *fwd, *bwd):
            h.update(t.float().cpu().numpy().tobytes())
        out[str(shape)] = h.hexdigest()[:16]
    return out


# attention_digests of the kernels before they became templates on the
# element type (the commit before K8's bf16 mode), taken on an H100 80GB
# HBM3 by the same function bound to that commit's kernels
F32_DIGESTS = {
    "(5, 5, None)": "228e7cbf25ab5e59",
    "(1, 15, 1)": "6e36abd8733ee8c3",
    "(1, 15, 8)": "88a1308491a94686",
    "(1, 15, 15)": "4b706341a0665710",
    "(1, 3, None)": "faccd4477f9950d1",
    "(15, 15, 1)": "1be7474e338c1d04",
    "(15, 3, None)": "65690a21187e1fb2",
    "(16, 16, 1)": "dc43a6924a9e0cfc",
    "(96, 96, None)": "08f55ac6328fc7d8",
    "(1, 256, None)": "127818342a86ac50",
}


@pytest.mark.cuda
def test_attention_f32_kernels_keep_their_bits_on_card(cuda_device):
    """The f32 instantiations of the templated kernels give the bits the f32
    kernels gave before (F32_DIGESTS): the forward's tile kernel for more
    than one query row gives the row kernel's bits."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    assert attention_digests(K8, cuda_device) == F32_DIGESTS


# attention_digests at bf16 of the kernels before the forward's tile kernel
# (every query row on the row kernel), taken on an H100 80GB HBM3 by the same
# function bound to that commit's kernels
BF16_DIGESTS = {
    "(5, 5, None)": "e74a9250684c3764",
    "(1, 15, 1)": "fffe14c2ed42adfe",
    "(1, 15, 8)": "280bba19cef08317",
    "(1, 15, 15)": "06135cfb6d563414",
    "(1, 3, None)": "d5d8ec3152e5c239",
    "(15, 15, 1)": "177b9a24fc437849",
    "(15, 3, None)": "98d638c552ff1779",
    "(16, 16, 1)": "921a70daf7a3b003",
    "(96, 96, None)": "57c0c3c73dc10a3c",
    "(1, 256, None)": "eae295ba164935a6",
}


@pytest.mark.cuda
def test_attention_bf16_kernels_keep_their_bits_on_card(cuda_device):
    """The bf16 kernels give the bits they gave before the forward's tile
    kernel (BF16_DIGESTS): serving, training forward and backward."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    assert attention_digests(K8, cuda_device, torch.bfloat16) == BF16_DIGESTS


# the forward's tile kernel off its tiles (Lq, Lk, kv_len0, Dh): two rows,
# one row past a row tile (33), 97 rows (three tiles of 32 and one of 1),
# 2048 keys with the row tile at its smallest (16), heads of 48 dims (a
# lane's second dim past Dh), prefixes of 1 and 7 keys
TILE_SHAPES = [(2, 2, None, 64), (2, 9, 7, 48), (33, 33, 1, 64), (33, 40, 7, 48),
               (97, 97, 1, 48), (97, 120, 7, 64), (30, 2048, 1, 256), (33, 2048, 7, 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lk,kv_len0,Dh", TILE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dropout", [False, True])
def test_attention_tile_kernel_at_ragged_shapes_on_card(cuda_device, Lq, Lk, kv_len0, Dh,
                                                        dtype, dropout):
    """The forward's tile kernel (more than one query row) against its plain
    version at the existing tolerances, serving and training mode, with
    and without a keep mask, in f32 and bf16 (the backward on its outputs
    too); two launches bit-equal; a batch of 3 and 3 heads.  In f32 the
    serving output is the training mode's bit for bit, and both are held
    at the training mode's tolerance (rtol 1e-5 plus 1e-5 of the largest
    entry): a row over up to 2048 keys of 256 dims sums in another order
    than the plain version's einsum, and where its output cancels to near 0
    that order moves it by more than 1e-6."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    plan = K8.attention_forward_plan(3, Lq, Lk, 3, Dh)
    assert plan.kernel == "tile" and (Lk < 2048 or plan.rows == 16)
    seed = Lq + Lk + Dh
    if dtype == torch.bfloat16:
        _attention_bf16_matches_plain(K8, 3, (Lq, Lk, kv_len0), 3, Dh, dropout, seed)
        return
    g = torch.Generator(device=cuda_device).manual_seed(seed)
    q, k, v = (torch.randn(3, L, 3, Dh, device=cuda_device, generator=g) for L in (Lq, Lk, Lk))
    serve = K8.attention(q, k, v, kv_len0)
    assert torch.equal(serve, K8.attention_train_forward(q, k, v, kv_len0)[0])
    assert torch.equal(serve, K8.attention(q, k, v, kv_len0))
    want = K8.attention_plain(q, k, v, kv_len0)
    torch.testing.assert_close(serve, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    _attention_training_matches_plain(K8, 3, (Lq, Lk, kv_len0), 3, Dh, dropout, seed)


# K8 past its earlier limits (Lq, Lk, kv_len0): one query row over 3073 and
# 5000 keys (the split row kernels: decode at --fut-window 5000), the
# encoder at --his-window 5000 (full and causal;
# the streamed tile kernel), the teacher-forced cross-attention over the
# distilled 2500, and a row tile off its 32 rows at 3000 keys
LONG_SHAPES = [(1, 3073, None), (1, 5000, 4000), (33, 5000, None), (33, 5000, 1),
               (15, 2500, None), (40, 3000, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lk,kv_len0", LONG_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_attention_past_2048_keys_on_card(cuda_device, Lq, Lk, kv_len0, dtype):
    """Serving, training (keep mask at 0.1) and backward over up to 5000
    keys, 2 heads of 64, a batch of 2, against the plain versions at the
    tolerances of the ragged-shape test; two launches bit-equal; more than
    one query row takes the streamed kernel (one row the split row
    kernels), and more than a row tile the split backward, each counted in
    its own mode."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    plan = K8.attention_forward_plan(2, Lq, Lk, 2, 64)
    assert plan.kernel == ("row_split" if Lq == 1 else "stream")
    assert K8.attention_backward_plan(2, Lq, Lk, 2, 64).kernel == (
        "row" if Lq == 1 else "tile_split" if Lq > 32 else "tile")
    seed = Lq + Lk
    elem = "f32" if dtype == torch.float32 else "bf16"
    mode = elem + ("_stream" if Lq > 1 else "_rowsplit")
    backward_mode = elem + ("_split" if Lq > 32 else "")
    before = K8.attention_train_forward.launches_by_mode.get(mode, 0)
    before_backward = K8.attention_backward.launches_by_mode.get(backward_mode, 0)
    if dtype == torch.bfloat16:
        _attention_bf16_matches_plain(K8, 2, (Lq, Lk, kv_len0), 2, 64, True, seed)
    else:
        g = torch.Generator(device=cuda_device).manual_seed(seed)
        q, k, v = (torch.randn(2, L, 2, 64, device=cuda_device, generator=g)
                   for L in (Lq, Lk, Lk))
        serve = K8.attention(q, k, v, kv_len0)
        assert torch.equal(serve, K8.attention_train_forward(q, k, v, kv_len0)[0])
        assert torch.equal(serve, K8.attention(q, k, v, kv_len0))
        want = K8.attention_plain(q, k, v, kv_len0)
        torch.testing.assert_close(serve, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
        _attention_training_matches_plain(K8, 2, (Lq, Lk, kv_len0), 2, 64, True, seed)
    assert K8.attention_train_forward.launches_by_mode[mode] > before
    assert K8.attention_backward.launches_by_mode[backward_mode] > before_backward


# heads past 256 dims (H 3, a batch of 2): one query row (the decode step),
# the teacher-forced causal pass, a --his-window 96 encoder
WIDE_SHAPES = [(1, 15, 1), (15, 15, 1), (96, 96, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lk,kv_len0", WIDE_SHAPES)
@pytest.mark.parametrize("Dh", [257, 320, 512, 1024, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_attention_wide_heads_on_card(cuda_device, Lq, Lk, kv_len0, Dh, dtype):
    """Heads of 257 to 2048 dims (the wide kernels, chunks of 256; for more
    than one row the backward on the tensor cores, one grid at 15 keys, the
    dQ and dK/dV grids at 96; in f32 at 15 keys the SIMT tile kernel):
    serving, training with and without a keep mask, and backward against
    the plain versions at the existing tolerances, two launches bit-equal;
    every launch counted in the ``_wide`` modes."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    bf16 = dtype == torch.bfloat16
    assert K8.attention_forward_plan(2, Lq, Lk, 3, Dh).kernel == (
        "row_wide" if Lq == 1 else "stream")
    assert K8.attention_backward_plan(2, Lq, Lk, 3, Dh, bf16=bf16).kernel == (
        "row_wide" if Lq == 1 else "tile_wide_tc" if bf16 or Lk > 16 else "tile_wide")
    mode = ("f32" if dtype == torch.float32 else "bf16") + "_wide"
    before = [w.launches_by_mode.get(mode, 0)
              for w in (K8.attention, K8.attention_train_forward, K8.attention_backward)]
    for dropout in (False, True):
        seed = Lq + Lk + Dh + dropout
        if dtype == torch.bfloat16:
            _attention_bf16_matches_plain(K8, 2, (Lq, Lk, kv_len0), 3, Dh, dropout, seed)
        else:
            _attention_training_matches_plain(K8, 2, (Lq, Lk, kv_len0), 3, Dh, dropout, seed)
    if dtype == torch.float32:
        g = torch.Generator(device=cuda_device).manual_seed(Dh)
        q, k, v = (torch.randn(2, L, 3, Dh, device=cuda_device, generator=g)
                   for L in (Lq, Lk, Lk))
        serve = K8.attention(q, k, v, kv_len0)
        assert torch.equal(serve, K8.attention_train_forward(q, k, v, kv_len0)[0])
        assert torch.equal(serve, K8.attention(q, k, v, kv_len0))
        want = K8.attention_plain(q, k, v, kv_len0)
        torch.testing.assert_close(serve, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    after = [w.launches_by_mode.get(mode, 0)
             for w in (K8.attention, K8.attention_train_forward, K8.attention_backward)]
    assert all(a > b for a, b in zip(after, before))


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [320, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_attention_wide_backward_past_2048_keys_on_card(cuda_device, Dh, dtype):
    """The wide backward on the tensor cores past 2048 keys (33 x 5000, B 1,
    a prefix of one key: the dQ grid's chains over 313 key tiles, key tiles
    no row sees), with and without a keep mask: dq, dk and dv against the
    plain version's autograd at K8's limits (f32: rtol 1e-5 plus 1e-5 of the
    largest entry; bf16: one ulp plus ``bf16_slack``), unseen keys exactly
    0, two launches bit-equal."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    assert K8.attention_backward_plan(1, 33, 5000, 2, Dh,
                                      bf16=dtype == torch.bfloat16).kernel == "tile_wide_tc"
    for dropout in (False, True):
        if dtype == torch.bfloat16:
            _attention_bf16_matches_plain(K8, 1, (33, 5000, 1), 2, Dh, dropout, Dh + dropout)
        else:
            _attention_training_matches_plain(K8, 1, (33, 5000, 1), 2, Dh, dropout,
                                              Dh + dropout)


# each wide backward forced where the plan takes the other in f32 (Lq, Lk,
# kv_len0): one key tile (the encoder's 5 x 5, the teacher-forced 15 x 15 and
# 15 x 3), the --his-window 96 encoder, rows and keys off the tiles
WIDE_FORCED = [(5, 5, None), (15, 15, 1), (15, 3, None), (96, 96, None), (33, 40, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lk,kv_len0", WIDE_FORCED)
@pytest.mark.parametrize("Dh", [320, 2048])
def test_attention_wide_backward_forced_kernels_on_card(cuda_device, Lq, Lk, kv_len0, Dh):
    """f32 past 256 dims, each wide backward forced (``tensor_cores`` True:
    the tensor cores' kernels; False: the SIMT tile kernel), with and
    without a keep mask: dq, dk and dv against the plain version's autograd
    at K8's f32 limits (rtol 1e-5 plus 1e-5 of the largest entry), unseen
    keys exactly 0, two launches bit-equal; bf16 refuses the SIMT kernel."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    g = torch.Generator(device=cuda_device).manual_seed(Lq + Lk + Dh)
    q, k, v, dout = (torch.randn(2, L, 3, Dh, device=cuda_device, generator=g)
                     for L in (Lq, Lk, Lk, Lq))
    keep = (torch.rand(2, 3, Lq, Lk, device=cuda_device, generator=g) < 0.9).to(torch.uint8)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    for mask in (None, keep):
        fwd = K8.attention_train_forward(q, k, v, kv_len0, mask, 0.1)
        want = torch.autograd.grad(K8.attention_plain(*leaves, kv_len0, mask, 0.1), leaves, dout)
        scale = max(float(w.abs().max()) for w in want)
        for forced in (True, False):
            got = K8.attention_backward(dout, q, k, v, *fwd, kv_len0, mask, 0.1,
                                        tensor_cores=forced)
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * scale)
            if kv_len0 is not None:
                unseen = slice(min(Lk, kv_len0 + Lq - 1), None)
                assert not got[1][:, unseen].any() and not got[2][:, unseen].any()
            assert all(torch.equal(a, b) for a, b in zip(got, K8.attention_backward(
                dout, q, k, v, *fwd, kv_len0, mask, 0.1, tensor_cores=forced)))
    with pytest.raises(ValueError, match="wide backward"):
        K8.attention_backward(*(x.bfloat16() for x in (dout, q, k, v)), fwd[0].bfloat16(),
                              *fwd[1:], kv_len0, None, 0.1, tensor_cores=False)


def _streamed_close(K8, got, want, q, k, v, kv_len0, keep):
    """The streamed kernel's (o, row max, row sum) against another
    evaluation's: o within rtol 1e-5 plus 1e-5 of its largest entry in f32,
    within one bf16 ulp plus ``bf16_slack`` in bf16 (phases 2d and 2f); the
    f32 statistics within rtol 1e-5 plus 1e-5 of their largest entry."""
    if q.dtype == torch.bfloat16:
        slack = K8.bf16_slack(q, k, v, torch.zeros_like(q), kv_len0, keep, 0.1)[0]
        assert K8.bf16_excess(got[0], want[0], slack) <= 1
    else:
        torch.testing.assert_close(got[0], want[0], rtol=1e-5,
                                   atol=1e-5 * float(want[0].abs().max()))
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lk,kv_len0,Dh", [(96, 96, None, 64), (15, 15, 1, 64),
                                              (33, 2048, 7, 48), (30, 2048, 1, 256),
                                              (97, 120, 7, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_attention_streamed_kernel_agrees_with_the_resident_kernel_on_card(
        cuda_device, Lq, Lk, kv_len0, Dh, dtype):
    """The streamed kernel (tensor cores) forced where the resident tile
    kernel runs: its output, row max and row sum, with and without a keep
    mask, against the resident kernel's and the plain version's at K8's
    limits (its sums run in the tensor cores' order, so not the resident
    kernel's bits); two launches bit-equal."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    assert K8.attention_forward_plan(3, Lq, Lk, 3, Dh).kernel == "tile"
    assert K8.attention_forward_plan(3, Lq, Lk, 3, Dh, stream=True).kernel == "stream"
    g = torch.Generator(device=cuda_device).manual_seed(Lq + Lk + Dh)
    q, k, v = (torch.randn(3, L, 3, Dh, device=cuda_device, generator=g).to(dtype)
               for L in (Lq, Lk, Lk))
    keep = (torch.rand(3, 3, Lq, Lk, device=cuda_device, generator=g) < 0.9).to(torch.uint8)
    for mask in (None, keep):
        streamed = K8.attention_train_forward(q, k, v, kv_len0, mask, 0.1, stream=True)
        for want in (K8.attention_train_forward(q, k, v, kv_len0, mask, 0.1),
                     K8.attention_train_forward_plain(q, k, v, kv_len0, mask, 0.1)):
            _streamed_close(K8, streamed, want, q, k, v, kv_len0, mask)
        assert all(torch.equal(a, b) for a, b in zip(streamed, K8.attention_train_forward(
            q, k, v, kv_len0, mask, 0.1, stream=True)))


# the streamed kernel off its tiles (Lq, Lk, kv_len0, Dh): rows not a
# multiple of a warp's 16 (and one row tile of 64 and one row more), keys
# not a multiple of the key tile, prefixes of 1 and Lk keys, heads of 48,
# 100, 257 and 2048 dims (off the 16-byte staging at 100 and 257)
STREAM_RAGGED = [(17, 77, 1, 48), (65, 130, 77, 48), (33, 97, 1, 100), (7, 70, 70, 100),
                 (15, 40, 1, 257), (21, 33, 33, 257), (17, 65, 1, 2048), (9, 9, 9, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lk,kv_len0,Dh", STREAM_RAGGED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_attention_streamed_kernel_at_ragged_shapes_on_card(cuda_device, Lq, Lk, kv_len0, Dh,
                                                            dtype):
    """The streamed kernel (forced up to 256 dims) at ragged rows, keys,
    prefixes and widths: serving and training, with and without a keep
    mask, against the plain version at K8's limits; the serving output is
    the training mode's bit for bit; two launches bit-equal."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    assert K8.attention_forward_plan(2, Lq, Lk, 3, Dh, stream=True).kernel == "stream"
    g = torch.Generator(device=cuda_device).manual_seed(Lq * Lk + Dh)
    q, k, v = (torch.randn(2, L, 3, Dh, device=cuda_device, generator=g).to(dtype)
               for L in (Lq, Lk, Lk))
    keep = (torch.rand(2, 3, Lq, Lk, device=cuda_device, generator=g) < 0.9).to(torch.uint8)
    served = torch.empty_like(q)
    K8._launch_forward(q, k, v, kv_len0, served, False, stream=True)
    for mask in (None, keep):
        streamed = K8.attention_train_forward(q, k, v, kv_len0, mask, 0.1, stream=True)
        _streamed_close(K8, streamed, K8.attention_train_forward_plain(q, k, v, kv_len0, mask,
                                                                       0.1),
                        q, k, v, kv_len0, mask)
        assert all(torch.equal(a, b) for a, b in zip(streamed, K8.attention_train_forward(
            q, k, v, kv_len0, mask, 0.1, stream=True)))
        if mask is None:
            assert torch.equal(served, streamed[0])


# each backward that reads the streamed forward's statistics (B, Lq, Lk,
# kv_len0, H, Dh, the backward's plan): the split at the --his-window 5000
# encoder (B 2) and at 33 x 2500, the one-CTA tile kernel at the
# teacher-forced cross-attention 15 x 2500, the wide backward at Dh 512: at
# 15 x 15 the SIMT tile kernel in f32 and the tensor cores' one grid in bf16,
# at 96 x 96 the tensor cores' dQ and dK/dV grids
STATS_INTO_BACKWARD = [(2, 5000, 5000, None, 2, 64, "tile_split"),
                       (2, 33, 2500, 1, 2, 64, "tile_split"),
                       (4, 15, 2500, None, 2, 64, "tile"),
                       (2, 15, 15, 1, 3, 512, "tile_wide"),
                       (2, 96, 96, None, 3, 512, "tile_wide_tc")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lk,kv_len0,H,Dh,backward", STATS_INTO_BACKWARD)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_attention_streamed_statistics_feed_each_backward_on_card(cuda_device, B, Lq, Lk,
                                                                  kv_len0, H, Dh, backward,
                                                                  dtype):
    """The streamed forward's row max and exp sum (from tensor-core scores)
    fed to each backward kernel that reads them, which recomputes P by its
    own scores: dq, dk and dv, with a keep mask at 0.1, against the plain
    version's autograd at K8's backward limits (f32: rtol 1e-5 plus 1e-5 of
    the largest entry of the three; bf16: one ulp plus ``bf16_slack``)."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    assert K8.attention_forward_plan(B, Lq, Lk, H, Dh).kernel == "stream"
    bf16 = dtype == torch.bfloat16
    assert K8.attention_backward_plan(B, Lq, Lk, H, Dh, bf16=bf16).kernel == (
        "tile_wide_tc" if bf16 and backward == "tile_wide" else backward)
    g = torch.Generator(device=cuda_device).manual_seed(Lq + Lk + Dh)
    q, k, v, dout = (torch.randn(B, L, H, Dh, device=cuda_device, generator=g).to(dtype)
                     for L in (Lq, Lk, Lk, Lq))
    keep = (torch.rand(B, H, Lq, Lk, device=cuda_device, generator=g) < 0.9).to(torch.uint8)
    fwd = K8.attention_train_forward(q, k, v, kv_len0, keep, 0.1)
    got = K8.attention_backward(dout, q, k, v, *fwd, kv_len0, keep, 0.1)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(K8.attention_plain(*leaves, kv_len0, keep, 0.1), leaves, dout)
    if dtype == torch.bfloat16:
        slack = K8.bf16_slack(q, k, v, dout, kv_len0, keep, 0.1)[1:]
        for a, b, sl in zip(got, want, slack):
            assert K8.bf16_excess(a, b, sl) <= 1
    else:
        scale = max(float(w.abs().max()) for w in want)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * scale)


# the split backward forced where the one-CTA tile kernel runs (Lq, Lk,
# kv_len0, Dh): the encoder's 5 x 5, the teacher-forced causal 15 x 15 and
# cross 15 x 3, the --his-window 96 encoder, 2048 keys at Dh 48 and 256, and
# each other dims-a-lane instance off the 16-byte staging (Dh 16, 33, 100)
SPLIT_SHAPES = [(5, 5, None, 64), (15, 15, 1, 64), (15, 3, None, 64), (96, 96, None, 64),
                (33, 2048, None, 48), (30, 2048, None, 256), (35, 40, 1, 16),
                (40, 33, None, 33), (33, 120, 7, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("Lq,Lk,kv_len0,Dh", SPLIT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_attention_backward_split_gives_the_one_cta_bits_on_card(cuda_device, Lq, Lk, kv_len0,
                                                                 Dh, dtype):
    """The split backward (a CTA a key tile for dK and dV, a CTA a row tile
    for dQ) forced where the one-CTA tile kernel runs: dq, dk and dv bit for
    bit the tile kernel's, with and without a keep mask at 0.1, a batch of
    3 and 3 heads; each launch counted in its own mode."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    assert K8.attention_backward_plan(3, Lq, Lk, 3, Dh).kernel == "tile"
    assert K8.attention_backward_plan(3, Lq, Lk, 3, Dh, split=True).kernel == "tile_split"
    g = torch.Generator(device=cuda_device).manual_seed(Lq + Lk + Dh)
    q, k, v, dout = (torch.randn(3, L, 3, Dh, device=cuda_device, generator=g).to(dtype)
                     for L in (Lq, Lk, Lk, Lq))
    keep = (torch.rand(3, 3, Lq, Lk, device=cuda_device, generator=g) < 0.9).to(torch.uint8)
    mode = ("f32" if dtype == torch.float32 else "bf16") + "_split"
    for mask in (None, keep):
        fwd = K8.attention_train_forward(q, k, v, kv_len0, mask, 0.1)
        tile = K8.attention_backward(dout, q, k, v, *fwd, kv_len0, mask, 0.1)
        before = K8.attention_backward.launches_by_mode.get(mode, 0)
        split = K8.attention_backward(dout, q, k, v, *fwd, kv_len0, mask, 0.1, split=True)
        assert K8.attention_backward.launches_by_mode[mode] == before + 1
        assert all(a.dtype == dtype and torch.equal(a, b) for a, b in zip(split, tile))


@pytest.mark.cuda
def test_attention_refuses_one_row_past_its_scores_on_card(cuda_device):
    """One query row of a head past 256 dims (the wide row kernel) holds its
    scores in shared memory: past MAX_LK keys (far past the 5000 of JAX's
    positional table) the wrapper raises, as it does for any plan that does
    not fit; up to 256 dims the split row kernels take one row at any
    length (Dh 4 past MAX_LK against the plain version), more rows stream."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    q = torch.randn(1, 1, 1, 4, device=cuda_device)
    k = torch.randn(1, K8.MAX_LK + 1, 1, 4, device=cuda_device)
    want = K8.attention_plain(q, k, k)
    torch.testing.assert_close(K8.attention(q, k, k), want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    qw = torch.randn(1, 1, 1, 257, device=cuda_device)
    kw = torch.randn(1, K8.MAX_LK + 1, 1, 257, device=cuda_device)
    with pytest.raises(ValueError, match="at most 14528 keys"):
        K8.attention(qw, kw, kw)
    torch.testing.assert_close(K8.attention(qw, kw[:, :K8.MAX_LK], kw[:, :K8.MAX_LK]),
                               K8.attention_plain(qw, kw[:, :K8.MAX_LK], kw[:, :K8.MAX_LK]),
                               rtol=1e-5, atol=1e-6)


# the split row kernels (one query row past 2048 keys) at 8 heads of 64 (B,
# Lk, kv_len0): vp_train_long's B 4 and vp_test_long's B 64 over the
# distilled 2500 keys, 2049 and 5000 keys, all keys seen and a prefix that
# ends inside a split (none seen past it)
ROW_SPLIT_SHAPES = [(B, Lk, kv_len0) for B in (4, 64) for Lk in (2049, 2500, 5000)
                    for kv_len0 in (None, Lk // 3 + 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lk,kv_len0", ROW_SPLIT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_attention_split_row_kernels_on_card(cuda_device, B, Lk, kv_len0, dtype):
    """The split row kernels against the plain versions at K8's limits:
    serving, training with and without a keep mask at 0.1, and the row
    backward fed their row max and sum (which recomputes their P) against
    the plain autograd (f32: rtol 1e-5 plus 1e-5 of the largest entry; bf16
    one ulp plus ``bf16_slack``); two launches bit-equal; each launch
    counted in the ``_rowsplit`` mode."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    assert K8.attention_forward_plan(B, 1, Lk, 8, 64).kernel == "row_split"
    mode = ("f32" if dtype == torch.float32 else "bf16") + "_rowsplit"
    before = (K8.attention.launches_by_mode.get(mode, 0),
              K8.attention_train_forward.launches_by_mode.get(mode, 0))
    for dropout in (False, True):
        if dtype == torch.bfloat16:
            _attention_bf16_matches_plain(K8, B, (1, Lk, kv_len0), 8, 64, dropout, Lk + B)
            continue
        g = torch.Generator(device=cuda_device).manual_seed(Lk + B)
        q, k, v = (torch.randn(B, L, 8, 64, device=cuda_device, generator=g) for L in (1, Lk, Lk))
        serve = K8.attention(q, k, v, kv_len0)
        assert torch.equal(serve, K8.attention(q, k, v, kv_len0))
        assert torch.equal(serve, K8.attention_train_forward(q, k, v, kv_len0)[0])
        want = K8.attention_plain(q, k, v, kv_len0)
        torch.testing.assert_close(serve, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
        _attention_training_matches_plain(K8, B, (1, Lk, kv_len0), 8, 64, dropout, Lk + B)
    assert K8.attention.launches_by_mode[mode] > before[0]
    assert K8.attention_train_forward.launches_by_mode[mode] > before[1]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lk,kv_len0", [(512, 15, None), (512, 15, 8), (64, 256, None),
                                          (3, 2048, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_attention_split_row_kernels_forced_on_card(cuda_device, B, Lk, kv_len0, dtype):
    """``split_row=True`` where the row kernel runs (phase 2i's forced
    cases): serving and training (keep mask at 0.1) within K8's limits of
    the plain version and of the row kernel, two launches bit-equal, and
    the row backward fed the forced kernels' statistics against the plain
    autograd."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    assert K8.attention_forward_plan(B, 1, Lk, 8, 64).kernel == "row"
    g = torch.Generator(device=cuda_device).manual_seed(Lk + B)
    q, k, v, dout = (torch.randn(B, L, 8, 64, device=cuda_device, generator=g).to(dtype)
                     for L in (1, Lk, Lk, 1))
    keep = (torch.rand(B, 8, 1, Lk, device=cuda_device, generator=g) < 0.9).to(torch.uint8)
    bf16 = dtype == torch.bfloat16
    slack = K8.bf16_slack(q, k, v, dout, kv_len0, keep, 0.1) if bf16 else None

    def agree(got, want, sl):
        if bf16:
            assert K8.bf16_excess(got, want, sl) <= 1
        else:
            torch.testing.assert_close(got, want, rtol=1e-5,
                                       atol=1e-5 * float(want.abs().max()))

    o, o2 = torch.empty_like(q), torch.empty_like(q)
    for out in (o, o2):
        assert K8._launch_forward(q, k, v, kv_len0, out, False, split_row=True) == "_rowsplit"
    assert torch.equal(o, o2)
    serve_slack = K8.bf16_slack(q, k, v, dout, kv_len0)[0] if bf16 else None
    agree(o, K8.attention_plain(q, k, v, kv_len0), serve_slack)
    agree(o, K8.attention(q, k, v, kv_len0), serve_slack)
    fwd = K8.attention_train_forward(q, k, v, kv_len0, keep, 0.1, split_row=True)
    assert all(torch.equal(a, b) for a, b in zip(fwd, K8.attention_train_forward(
        q, k, v, kv_len0, keep, 0.1, split_row=True)))
    want = K8.attention_train_forward_plain(q, k, v, kv_len0, keep, 0.1)
    agree(fwd[0], want[0], slack[0] if bf16 else None)
    for a, b in zip(fwd[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    wantg = torch.autograd.grad(K8.attention_plain(*leaves, kv_len0, keep, 0.1), leaves, dout)
    got = K8.attention_backward(dout, q, k, v, *fwd, kv_len0, keep, 0.1)
    scale = max(float(w.abs().max()) for w in wantg)
    for a, b, i in zip(got, wantg, range(3)):
        if bf16:
            assert K8.bf16_excess(a, b, slack[1 + i]) <= 1
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * scale)


# ------------------------------------------------------ hidden widths

@pytest.mark.cuda
def test_actor_critic_shared_memory_as_planned_on_card(cuda_device):
    """The compiled K3 and K10 take the shared memory that the wrapper's
    layouts compute in every instance and in the wide variant, within the
    H100's 227 KB a block, and pick for every width from 1 to 1100 the
    instance the wrapper names (0: the wide variant)."""
    for h in K3.WIDTHS + (257, 384, 512, 1024):
        assert K3.kernel_smem_bytes(h) == (K3.forward_smem_bytes(h), *K3.backward_smem_bytes(h))
        assert max(K3.kernel_smem_bytes(h)) <= 227 * 1024
    for h in range(1, 1101):
        want = K3.kernel_instance(h)
        assert K3.kernel_instances(h) == ((0, 0) if want == K3.WIDE else (want, want)), h


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [64, 100, 512])
def test_actor_critic_kernels_refuse_other_widths_on_card(cuda_device, hidden):
    """A width other than the committed policies' runs through the kernels
    (each call launches once, in the mode of its instance) and never falls
    back to the plain version: K3 (forward, training mode) and K10, also
    through the autograd Function, equal the plain versions at the
    tolerances of 128 and 256; two launches give the same bits."""
    from mansy_immersivevideostreaming_torch.kernels.observe import obs_width
    for use_av, prior in ((False, 0.0), (True, 3.0)):
        torch.manual_seed(hidden)
        policy = MansyActorCritic(hidden_dim=hidden, use_action_values=use_av,
                                  av_logit_prior=prior, device=cuda_device)
        w = policy.packed_weights()
        mode = K3.launch_mode(w)
        g = torch.Generator(device=cuda_device).manual_seed(hidden)
        n = 300
        x = torch.rand(n, obs_width(*policy.dims), device=cuda_device, generator=g)
        noise = K3.gumbel_noise((n, 15), g, cuda_device)
        for fn in (K3.actor_critic_forward, K3.actor_critic_train_forward,
                   K3.actor_critic_backward):
            fn.launches_by_mode.clear()
        got = K3.actor_critic_forward(w, x, noise)
        ref = K3.actor_critic_forward_plain(w, x, noise)
        for a, b in zip(got[:2], ref[:2]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        top2 = (ref[0] + noise).topk(2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > 1e-4
        assert torch.equal(got[2][decisive], ref[2][decisive])
        assert all(torch.equal(a, b) for a, b in zip(got, K3.actor_critic_forward(w, x, noise)))
        got = K3.actor_critic_train_forward(w, x)
        ref = K3.actor_critic_train_forward_plain(w, x)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        dlogits = torch.randn(n, 15, device=cuda_device, generator=g) / n
        dvalue = torch.randn(n, device=cuda_device, generator=g) / n
        grads = K3.actor_critic_backward(w, x, *ref[2:], dlogits, dvalue)
        want = K3.actor_critic_backward_plain(w, x, *ref[2:], dlogits, dvalue)
        for a, b in zip(grads, want):
            _grad_close(a, b)
        again = K3.actor_critic_backward(w, x, *ref[2:], dlogits, dvalue)
        assert all(torch.equal(a, b) for a, b in zip(grads, again))
        logits, value = policy.forward_packed(x)
        ((logits * dlogits).sum() + (value * dvalue).sum()).backward()
        _grad_close(policy.critic_out.weight.grad, want[6].t())
        assert K3.actor_critic_forward.launches_by_mode == {mode: 2}
        assert K3.actor_critic_train_forward.launches_by_mode == {mode: 2}
        assert K3.actor_critic_backward.launches_by_mode == {mode: 3}


# chip_smoke.py:actor_critic_digests of K3 and K10 before they took other
# hidden widths, taken on an H100 80GB HBM3 by the same function bound to
# that commit's kernels
AC_DIGESTS = {
    "forward_v9_h128_512": "56f12b5136718455",
    "forward_v9_h128_8192": "ab5d95581906c8d5",
    "train_forward_v9_h128_4096": "75c8abcb77bd1211",
    "backward_v9_h128_512": "d1c43a6fc06af77c",
    "backward_v9_h128_4096": "7751e0523d0ac567",
    "forward_v16_h128_512": "858fa7947e4ba1e1",
    "forward_v16_h128_8192": "f80f4afa71b04c3d",
    "train_forward_v16_h128_4096": "81dd70b5644dd25f",
    "backward_v16_h128_512": "0b60927988d9d2d3",
    "backward_v16_h128_4096": "d7300ed6b19dc831",
    "forward_v9_h256_512": "911f29d856625e20",
    "forward_v9_h256_8192": "b7ac37f0fa354f3d",
    "train_forward_v9_h256_4096": "a5db5fafb360cf62",
    "backward_v9_h256_512": "80b067298af31d84",
    "backward_v9_h256_4096": "e89904997d6ff0e0",
    "forward_v16_h256_512": "4d6836f7176df8b7",
    "forward_v16_h256_8192": "17b40fdaf3606d5a",
    "train_forward_v16_h256_4096": "a23fc3253b0a9689",
    "backward_v16_h256_512": "76c84f6063ea5725",
    "backward_v16_h256_4096": "93c7e06041dd437f",
}


@pytest.mark.cuda
def test_actor_critic_kernels_keep_their_bits_on_card(cuda_device):
    """K3 and K10 at the committed widths, 128 and 256, give the bits of the
    kernels before other widths ran (their exact instances), on inputs and
    weights drawn with numpy."""
    import chip_smoke
    assert chip_smoke.actor_critic_digests(K3, cuda_device) == AC_DIGESTS


@pytest.mark.cuda
@pytest.mark.parametrize("use_av", [False, True])
def test_actor_critic_cluster_follows_n_at_hidden_256_on_card(cuda_device, use_av):
    w = MansyActorCritic(hidden_dim=256, use_action_values=use_av,
                         device=cuda_device).packed_weights()
    plans = [K3.cluster_plan(w, n) for n in (1, 512, 4096, 8192, 1 << 16)]
    assert all(a[0] >= b[0] for a, b in zip(plans, plans[1:])), plans
    assert plans[-1] == (1, False), plans


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 511, 512, 4096, 8192])
@pytest.mark.parametrize("use_av,prior", [(False, 0.0), (True, 3.0)])
def test_actor_critic_kernels_at_hidden_256_on_card(cuda_device, n, use_av, prior):
    """K3 (forward with and without noise, training mode) and K10 at hidden
    256 with 10 or 11 branches, in each cluster shape; tolerances as at
    128; two launches give the same bits."""
    from mansy_immersivevideostreaming_torch.kernels.observe import obs_width
    torch.manual_seed(n)
    policy = MansyActorCritic(hidden_dim=256, use_action_values=use_av, av_logit_prior=prior,
                              device=cuda_device)
    w = policy.packed_weights()
    assert w.b_branch.shape[1] == 256
    g = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.rand(n, obs_width(*policy.dims), device=cuda_device, generator=g)
    noise = K3.gumbel_noise((n, 15), g, cuda_device)
    got = K3.actor_critic_forward(w, x, noise)
    ref = K3.actor_critic_forward_plain(w, x, noise)
    for a, b in zip(got[:2], ref[:2]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    top2 = (ref[0] + noise).topk(2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 1e-4
    assert torch.equal(got[2][decisive], ref[2][decisive])
    assert all(torch.equal(a, b) for a, b in zip(got, K3.actor_critic_forward(w, x, noise)))
    got = K3.actor_critic_train_forward(w, x)
    ref = K3.actor_critic_train_forward_plain(w, x)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    dlogits = torch.randn(n, 15, device=cuda_device, generator=g) / n
    dvalue = torch.randn(n, device=cuda_device, generator=g) / n
    grads = K3.actor_critic_backward(w, x, *ref[2:], dlogits, dvalue)
    for a, b in zip(grads, K3.actor_critic_backward_plain(w, x, *ref[2:], dlogits, dvalue)):
        _grad_close(a, b)
    again = K3.actor_critic_backward(w, x, *ref[2:], dlogits, dvalue)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.cuda
def test_v18_forward_and_training_kernels_match_plain_on_card(cuda_device):
    """The committed v18 npz through K3 (serving and training) and K10, and
    through the autograd Function into every parameter."""
    from mansy_immersivevideostreaming_torch.utils.checkpoint import DAGGER_V18_NPZ
    policy = load_npz_policy(DAGGER_V18_NPZ, device=cuda_device)
    B = 300
    g = torch.Generator(device=cuda_device).manual_seed(18)
    x = torch.rand(B, 779, device=cuda_device, generator=g)
    w = policy.packed_weights()
    got = K3.actor_critic_forward(w, x)
    ref = K3.actor_critic_forward_plain(w, x)
    for a, b in zip(got[:2], ref[:2]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    dlogits = torch.randn(B, 15, device=cuda_device, generator=g)
    dvalue = torch.randn(B, device=cuda_device, generator=g)
    with torch.no_grad():
        _, _, feats, hidden = K3.actor_critic_train_forward_plain(w, x)
        want = K3.actor_critic_backward_plain(w, x, feats, hidden, dlogits, dvalue)
    logits, value = policy.forward_packed(x)
    ((logits * dlogits).sum() + (value * dvalue).sum()).backward()
    assert all(p.grad is not None for p in policy.parameters())
    _grad_close(policy.actor_fc.weight.grad, want[2][:, :256].t())
    _grad_close(policy.critic_out.weight.grad, want[6].t())


# ---------------------------------------------------------------- simple_rl

@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4, 5, 128, 511, 512, 513, 1025, 8193])
def test_observe_simple_kernel_at_every_block_edge_on_card(cuda_device, n):
    """K2's simple mode at the edges of its 4-lane blocks and of its two
    thread groups: every column a copy or one IEEE division, bit-equal to
    the plain version on the CPU; into ``obs[1]`` of a [3, N, 395] buffer
    (unaligned for odd N) and into a strided view the same bits, nothing
    beside its rows; two launches give the same bits."""
    tables = _perturbed_tables(cuda_device)
    samples = torch.as_tensor(generate_demo_samples(3, 4, 3, 4, 17), device=cuda_device)
    state = init_lanes(tables, samples, n, seed=n)
    rng = np.random.default_rng(n)
    for _ in range(5):
        acts = torch.as_tensor(rng.integers(0, 15, n).astype(np.int32), device=cuda_device)
        state, *_ = K1.env_step_plain(tables, samples, state, acts, n, True)
    got = K2.observe_simple_pack(tables, state)
    torch.cuda.synchronize()
    ref = K2.observe_simple_pack_plain(_on_cpu(tables), tree_map(lambda x: x.cpu(), state))
    assert got.shape == (n, 395) and torch.equal(got.cpu(), ref)
    assert torch.equal(K2.observe_simple_pack(tables, state), got)
    obs = torch.full((3, n, 395), float("nan"), device=cuda_device)
    K2.observe_simple_pack(tables, state, out=obs[1])
    assert torch.equal(obs[1], got) and bool(obs[0].isnan().all() and obs[2].isnan().all())
    wide = torch.full((n, 398), float("nan"), device=cuda_device)
    K2.observe_simple_pack(tables, state, out=wide[:, :395])
    assert torch.equal(wide[:, :395], got) and bool(wide[:, 395:].isnan().all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 17, 33, 128, 511, 512, 513, 4096, 8192])
def test_simple_actor_critic_kernels_at_every_tile_edge_on_card(cuda_device, n):
    """K3 (forward with and without noise, training mode) and K10 on the
    simple_rl net (five branches, no cond branch): against their plain
    versions (K10 at rtol 1e-4 plus 1e-5 of the largest entry), two
    launches bit-equal, at row counts around the 32-row tile and at the A2C
    shapes (128 lanes, minibatch 512)."""
    from mansy_immersivevideostreaming_torch.models.abr_nets import SimpleActorCritic
    torch.manual_seed(n)
    w = SimpleActorCritic(device=cuda_device).packed_weights()
    assert w.cond == -1 and len(w.branch_off) == 6
    g = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.rand(n, 395, device=cuda_device, generator=g)
    for noise in (None, K3.gumbel_noise((n, 15), g, cuda_device)):
        got = K3.actor_critic_forward(w, x, noise)
        ref = K3.actor_critic_forward_plain(w, x, noise)
        for a, b in zip(got[:2], ref[:2]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        scores = ref[0] if noise is None else ref[0] + noise
        top2 = scores.topk(2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > 1e-4
        assert torch.equal(got[2][decisive], ref[2][decisive])
        assert all(torch.equal(a, b) for a, b in zip(got, K3.actor_critic_forward(w, x, noise)))
    got = K3.actor_critic_train_forward(w, x)
    ref = K3.actor_critic_train_forward_plain(w, x)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, K3.actor_critic_train_forward(w, x)))
    dlogits = torch.randn(n, 15, device=cuda_device, generator=g)
    dvalue = torch.randn(n, device=cuda_device, generator=g)
    grads = K3.actor_critic_backward(w, x, got[2], got[3], dlogits, dvalue)
    for a, b in zip(grads, K3.actor_critic_backward_plain(w, x, got[2], got[3], dlogits, dvalue)):
        _grad_close(a, b)
    again = K3.actor_critic_backward(w, x, got[2], got[3], dlogits, dvalue)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.cuda
def test_simple_actor_critic_cluster_plans_on_card(cuda_device):
    """K3's plan for the five-branch net: a valid cluster at the A2C shapes
    (128 and 512 rows) and one CTA a tile at 65536 rows."""
    from mansy_immersivevideostreaming_torch.models.abr_nets import SimpleActorCritic
    w = SimpleActorCritic(device=cuda_device).packed_weights()
    plans = [K3.cluster_plan(w, n) for n in (1, 128, 512, 4096, 1 << 16)]
    assert plans[0] == (6, True), plans  # one CTA a unit: chunk_sizes in two halves
    assert all(1 <= c <= 6 for c, _ in plans) and plans[-1] == (1, False), plans


@pytest.mark.cuda
def test_simple_policy_trains_through_the_kernels_on_card(cuda_device):
    """SimpleActorCritic's forward_packed (K3's training mode) and its
    backward (K10) into every parameter, against the plain versions."""
    from mansy_immersivevideostreaming_torch.models.abr_nets import SimpleActorCritic
    torch.manual_seed(5)
    policy = SimpleActorCritic(device=cuda_device)
    B = 512
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.rand(B, 395, device=cuda_device, generator=g)
    dlogits = torch.randn(B, 15, device=cuda_device, generator=g)
    dvalue = torch.randn(B, device=cuda_device, generator=g)
    w = policy.packed_weights()
    with torch.no_grad():
        _, _, feats, hidden = K3.actor_critic_train_forward_plain(w, x)
        want = K3.actor_critic_backward_plain(w, x, feats, hidden, dlogits, dvalue)
    logits, value = policy.forward_packed(x)
    ((logits * dlogits).sum() + (value * dvalue).sum()).backward()
    assert all(p.grad is not None for p in policy.parameters())
    _grad_close(policy.actor_fc.weight.grad, want[2][:, :128].t())
    _grad_close(policy.chunk_sizes.weight.grad, want[0][8:328].t())
    _grad_close(policy.critic_out.weight.grad, want[6].t())
