"""The launch plans the K10 and K9 wrappers compute in Python, and the
gradients of ``MHA.attend`` and of K8's plain versions on the CPU.

* ``backward_plan`` (K10): launch A's column groups cover every 128-column
  block with none empty; launch B's depth slices are the largest cluster
  size that splits its 64-row tile evenly and that the batch's 32-deep
  stages fill; the shapes taken at the paths' batches (512 and 4096 rows)
  on a 132-SM card; the same at hidden 256 (v18), where launch A holds
  one CTA an SM, and at 32, 100, 384 and 512 (the instances 64 and 128,
  and the wide variant, whose launch A takes one group).  K3's and K10's
  shared memory a CTA in every instance (64, 128, 192, 256) and in the
  wide variant fits the H100.
* ``attention_backward_plan`` (K8's backward): at 1 to 2048 rows and keys
  and Dh 4 to 256, causal and full, every (row, key) that a row sees is
  taken once, every key's dk and dv rows written once, with a compiled
  instantiation and shared memory within 227 KB.  Past 2048 keys more
  than one row takes the split: its dK/dV grid (a CTA a key tile) and its
  dQ grid (a CTA a row tile), walked by tile ranges up to 5000 x 5000,
  each take every (row, key) once, dK and dV over the rows and dQ over the
  keys in ascending order; ``split`` forces it or the tile kernel, and a
  CPU call with it takes the plain version.
* ``attention_forward_plan`` (K8's forward): at 1 to 2048 rows and keys and
  Dh 4 to 256, causal and full, the score and P . v phases each take every
  (row, key) a row sees once, every output row is written once and the
  shared memory fits the H100; one row keeps the row kernel's launch; the
  plans at the encoder, teacher-forced and 96 x 96 shapes.  Up to 2048
  keys and 256 dims both plans are pinned to the earlier kernels' (a
  digest over a grid of shapes); past them (2049, 3073 and 5000 keys,
  heads of 257 to 2048 dims) the streamed forward's passes, the wide
  kernels' chunks and the backward each take every (row, key) and every
  dim once within the H100's shared memory, and the forward streams
  exactly where the tile kernel's row tile would drop under 16 rows.
* ``policy_loss_plan`` (K9): one cluster of at most 16 CTAs whose row
  tiles (CTA r takes tiles r, r + ctas, ...) cover every row exactly once,
  for every B from 1 to 20000, with no CTA left without a tile; 4 CTAs of
  128 rows at PPO's 512 rows and 16 of 256 at CE's 4096.
* ``env_step_plan`` (K1): the blocks' lanes cover every lane exactly once
  for N from 1 to 20000, with 8 threads a lane, or 32 where the lanes have
  more than 8 history entries.
* ``observe_plan`` (K2): the blocks' lanes cover every lane exactly once
  for N from 1 to 20000, a block's tile of rows is a multiple of 16 bytes
  at the paths' widths (779 and 795 columns), and a group is one of the
  kernel's two (a warp, or four at up to 1024 lanes).
* K2's derived values (``csrc/observe.cu:derive_values``): the
  recursive-halving reduce-scatter over the xor offsets 16 to 1, emulated
  in numpy float32 at the value counts the kernel uses (30, 16, 8 and 4),
  gives every value the bits of ``mansy::warp_sum``'s butterfly on it, on
  seeded values over 12 decades, both signs and signed zeros; and the
  kernel's assignment (a warp or four a lane) puts each action's size,
  sum vp q and sum vp |q - qual| where the lane that writes it reads them,
  each action on one lane of one warp.
* ``chunk_plan`` (K7 chunk mode): the groups cover every trajectory and
  every step below ``frequency`` of gt and of pred exactly once, for B from
  1 to 20000 and frequency 1 to 15.
* ``expert_tables_plan`` (K5): the blocks' threads take every (video,
  user, chunk) x action exactly once, for a sweep of (V, U, C) and action
  spaces, within the kernel's launch bounds; 8 users a block at the test
  and train splits' shapes, 360 and 6480 blocks.
* ``gae_plan`` (K6): the blocks' lanes and the chunks' steps cover every
  (t, lane) exactly once for a sweep of [T, N]; 4 blocks of one chunk at
  train's [32, 128], 256 blocks of four chunks at [128, 8192].
* ``MHA.attend`` on the CPU (K8's plain version) gives outputs and q_in, k
  and v gradients equal to ``jax.grad`` of the JAX ``MHA.attend`` at d = 32
  in the serving shapes and the five training shapes (the encoder's 5 x 5,
  a decode step over the 15-slot cache, cross-attention 1 x 3 and 15 x 3,
  the teacher-forced causal 15 x 15, and an 80 x 80 causal attention past
  the earlier backward kernel's 64 rows), the training ones also with the
  probabilities' dropout at 0.1 (the JAX call's own keep mask, recorded
  from ``jax.random.bernoulli``, handed to the port).  At the core, the
  training mode's plain version gives ``attention_plain``'s output, and
  the written-out backward (``attention_backward_plain``) autograd's
  gradients of it, masked keys exactly 0.  Tolerance as
  ``test_torch_mtio.py``'s: atol 2e-5, rtol 2e-4 (sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mansy_immersivevideostreaming_tpu.models.transformer import MHA as JaxMHA
from mansy_immersivevideostreaming_tpu.models.transformer import causal_mask
from mansy_immersivevideostreaming_torch.kernels import actor_critic as K3
from mansy_immersivevideostreaming_torch.kernels import attention as K8
from mansy_immersivevideostreaming_torch.kernels import env_step as K1
from mansy_immersivevideostreaming_torch.kernels import expert_tables as K5
from mansy_immersivevideostreaming_torch.kernels import gae as K6
from mansy_immersivevideostreaming_torch.kernels import observe as K2
from mansy_immersivevideostreaming_torch.kernels import policy_loss as K9
from mansy_immersivevideostreaming_torch.kernels import tile_occupancy as K7
from mansy_immersivevideostreaming_torch.models.transformer import MHA
from mansy_immersivevideostreaming_torch.utils.checkpoint import mtio_state_dict_from_flax

ATOL, RTOL = 2e-5, 2e-4
H100_SMS = 132
V9_OFFSETS = (0, 8, 328, 648, 712, 720, 728, 736, 744, 745, 748)  # 10 branches, 748 inputs
V16_OFFSETS = V9_OFFSETS + (764,)                                  # + the action values
BATCHES = (1, 17, 300, 512, 513, 4096, 4097)


# ------------------------------------------------------------------- K10

@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("offsets", [V9_OFFSETS, V16_OFFSETS], ids=["v9", "v16"])
def test_backward_plan_covers_every_block_and_slice(B, offsets):
    plan = K3.backward_plan(B, offsets, H100_SMS)
    nb = len(offsets) - 1
    per = -(-nb // plan.groups)
    stages = -(-B // K3.BACKWARD_STAGE)
    assert 1 <= plan.groups <= nb
    assert all(g * per < nb for g in range(plan.groups))  # no group without a block
    assert plan.slices in K3.BACKWARD_SLICES              # a cluster size that splits 64 rows
    assert plan.slices <= stages                          # no slice starts past the batch
    assert plan.slices == 8 or 2 * plan.slices > stages   # the most that the stages fill


def test_backward_plan_at_the_paths_batches():
    """PPO's 512 rows: a CTA a (row tile, branch); DAgger's 4096 rows: two
    CTAs a row tile; eight slices at both."""
    assert K3.backward_plan(512, V9_OFFSETS, H100_SMS) == K3.BackwardPlan(10, 8)
    assert K3.backward_plan(4096, V16_OFFSETS, H100_SMS) == K3.BackwardPlan(2, 8)


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("offsets", [V9_OFFSETS, V16_OFFSETS], ids=["v9", "v16"])
def test_backward_plan_at_hidden_256_covers_every_block_and_slice(B, offsets):
    """At hidden 256 (v18) launch A holds one CTA an SM; its groups still
    cover every 256-column block with none empty."""
    plan = K3.backward_plan(B, offsets, H100_SMS, 256)
    nb = len(offsets) - 1
    per = -(-nb // plan.groups)
    blocks = [b for g in range(plan.groups) for b in range(g * per, min(nb, (g + 1) * per))]
    assert 1 <= plan.groups <= nb and all(g * per < nb for g in range(plan.groups))
    assert blocks == list(range(nb))                      # every block once, in order
    assert plan.slices in K3.BACKWARD_SLICES and plan.slices <= -(-B // K3.BACKWARD_STAGE)
    assert plan.slices == 8 or 2 * plan.slices > -(-B // K3.BACKWARD_STAGE)


def test_backward_plan_at_hidden_256_at_the_paths_batches():
    """v18's PPO batch of 512: 5 groups of two 256-column blocks (launch A
    holds one CTA an SM); a CE batch of 4096: one group; eight slices."""
    assert K3.backward_plan(512, V9_OFFSETS, H100_SMS, 256) == K3.BackwardPlan(5, 8)
    assert K3.backward_plan(4096, V9_OFFSETS, H100_SMS, 256) == K3.BackwardPlan(1, 8)


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("offsets", [V9_OFFSETS, V16_OFFSETS], ids=["v9", "v16"])
@pytest.mark.parametrize("hidden", [32, 100, 384, 512])
def test_backward_plan_covers_every_block_and_slice_at_width(B, offsets, hidden):
    """At widths of the instances 64 and 128 and of the wide variant the
    groups cover every column block once with none empty (one group in the
    wide variant, whose launch A runs 64 x 128 tiles of dPre_b, not blocks);
    the slices as at any width."""
    plan = K3.backward_plan(B, offsets, H100_SMS, hidden)
    nb = len(offsets) - 1
    per = -(-nb // plan.groups)
    blocks = [b for g in range(plan.groups) for b in range(g * per, min(nb, (g + 1) * per))]
    assert blocks == list(range(nb)) and all(g * per < nb for g in range(plan.groups))
    if K3.kernel_instance(hidden) == K3.WIDE:
        assert plan.groups == 1
    else:  # the plan of the instance's capacity
        assert plan == K3.backward_plan(B, offsets, H100_SMS, K3.kernel_instance(hidden))
    assert plan.slices in K3.BACKWARD_SLICES and plan.slices <= -(-B // K3.BACKWARD_STAGE)
    assert plan.slices == 8 or 2 * plan.slices > -(-B // K3.BACKWARD_STAGE)


@pytest.mark.parametrize("hidden", K3.WIDTHS + (K3.WIDE,))
def test_actor_critic_shared_memory_fits_the_h100(hidden):
    """K3's and K10's shared memory a CTA (the layouts of ``Dims`` and
    ``DimsA``, and of the wide variant's tile kernels, which the card tests
    hold against the compiled kernels) in every instance and the wide
    variant (at 257, 384, 512 and 1024: it does not grow with the width):
    within the H100's 227 KB a block, and two CTAs an SM in the instances 64
    and 128 and the wide variant; every width of an instance takes its
    capacity's."""
    widths = (257, 384, 512, 1024) if hidden == K3.WIDE else (hidden,)
    want = {64: (60_416, 55_296, 106_496), 128: (101_376, 107_520, 106_496),
            192: (150_528, 159_744, 106_496), 256: (199_680, 211_968, 106_496),
            K3.WIDE: (55_296, 61_440, 106_496)}[hidden]
    for h in widths:
        fwd, launch_a, launch_b = K3.forward_smem_bytes(h), *K3.backward_smem_bytes(h)
        assert (fwd, launch_a, launch_b) == want
    assert max(want) + 1024 <= 227 * 1024
    if hidden in (64, 128, K3.WIDE):
        assert 2 * (max(want[:2]) + 1024) <= K3.SMEM_PER_SM
    if hidden != K3.WIDE:
        below = max([c for c in K3.WIDTHS if c < hidden], default=0)
        assert all(K3.forward_smem_bytes(h) == want[0] and K3.backward_smem_bytes(h)[0] == want[1]
                   for h in range(below + 1, hidden + 1))


# -------------------------------------------------------------------- K9

def _rows_of_each_cta(B: int, plan) -> list:
    """The rows each CTA of the cluster takes, as ``csrc/policy_loss.cu``
    walks them: CTA r the row tiles r, r + ctas, ... of ``plan.rows`` rows."""
    tiles = -(-B // plan.rows)
    return [np.concatenate([np.arange(t * plan.rows, min(B, (t + 1) * plan.rows))
                            for t in range(r, tiles, plan.ctas)] or [np.zeros(0, int)])
            for r in range(plan.ctas)]


@pytest.mark.parametrize("B", [1, 17, 128, 129, 255, 256, 257, 512, 2048, 2049, 4095, 4096,
                               4097, 8192, 8193, 20000])
def test_policy_loss_plan_covers_every_row_once(B):
    plan = K9.policy_loss_plan(B)
    assert plan.rows in K9.TILE_ROWS and 1 <= plan.ctas <= K9.MAX_CTAS
    per_cta = _rows_of_each_cta(B, plan)
    assert all(len(rows) > 0 for rows in per_cta)  # no CTA without a tile
    rows = np.concatenate(per_cta)
    assert len(rows) == B and np.array_equal(np.sort(rows), np.arange(B))


def test_policy_loss_plan_for_every_batch_up_to_20000():
    """Every B from 1 to 20000: the cluster's tiles cover the batch, the
    last CTA's first tile starts inside it, and a plan with more rows a tile
    is taken only where the fewer would need more than 16 CTAs."""
    for B in range(1, 20001):
        rows, ctas = K9.policy_loss_plan(B)
        tiles = -(-B // rows)
        assert 1 <= ctas <= K9.MAX_CTAS and ctas == min(K9.MAX_CTAS, tiles)
        assert (ctas - 1) * rows < B                   # every CTA starts inside the batch
        assert -(-tiles // ctas) * ctas * rows >= B    # the tiles the CTAs walk cover it
        smaller = [r for r in K9.TILE_ROWS if r < rows]
        assert all(-(-B // r) > K9.MAX_CTAS for r in smaller)


def test_policy_loss_plan_at_the_paths_batches():
    assert K9.policy_loss_plan(512) == K9.PolicyLossPlan(128, 4)
    assert K9.policy_loss_plan(4096) == K9.PolicyLossPlan(256, 16)


# -------------------------------------------------------------------- K1

@pytest.mark.parametrize("past_k", [8, 9, 32])
def test_env_step_plan_covers_every_lane_once(past_k):
    """Block b takes lanes b * lanes .. b * lanes + lanes - 1, those below N
    (``csrc/env_step.cu``); a group of ``group`` threads a lane, one history
    entry a thread, fills the block's threads, and no block is empty."""
    for n in range(1, 20001):
        group, lanes, blocks = K1.env_step_plan(n, past_k)
        assert group * lanes == K1.BLOCK_THREADS and past_k <= group
        assert (blocks - 1) * lanes < n <= blocks * lanes
        assert group == (8 if past_k <= 8 else 32)


def test_env_step_plan_at_the_paths_widths():
    """Every path's lanes (K = 8) take 8 threads a lane, 16 lanes a block."""
    for n in (32, 64, 128, 512, 8192):
        assert K1.env_step_plan(n, 8) == K1.EnvStepPlan(8, 16, n // 16)


# -------------------------------------------------------------------- K2

@pytest.mark.parametrize("width", [779, 795])
def test_observe_plan_covers_every_lane_once(width):
    """Block b takes lanes b * lanes .. b * lanes + lanes - 1, those below N,
    with a group of ``threads`` threads a lane (``csrc/observe.cu``); the
    block's tile of ``lanes`` rows of f32 is a multiple of 16 bytes, so
    its 16-byte stores start aligned in every block of an aligned buffer;
    the block fits the kernel's launch bounds."""
    for n in range(1, 20001):
        lanes, threads, blocks = K2.observe_plan(n)
        assert (blocks - 1) * lanes < n <= blocks * lanes
        assert lanes * width * 4 % 16 == 0
        assert threads == (K2.NARROW_GROUP if n <= K2.NARROW_LANES else K2.WIDE_GROUP)
        assert threads in (32, 128) and lanes <= 4


def test_observe_plan_at_the_paths_widths():
    """Collect's 8192 lanes: a warp a lane; serve's 512, train's 128 and
    DAgger's 32: four warps a lane; 4 lanes a block throughout."""
    assert K2.observe_plan(8192) == K2.ObservePlan(4, 32, 2048)
    for n in (32, 128, 512):
        assert K2.observe_plan(n) == K2.ObservePlan(4, 128, n // 4)


# -------------------------------------------------------------------- K7

def _chunk_walk(B: int, frequency: int, plan) -> np.ndarray:
    """Every (trajectory, side, step) that a thread of the launch maps, as
    ``csrc/tile_occupancy.cu``'s chunk kernel walks them: thread t of block
    k takes trajectory k * trajectories + t // group (those below B), and
    its index j in the group maps side j // (group / 2) (gt, pred), steps
    j % (group / 2), + group / 2, ... below ``frequency``."""
    half = plan.group // 2
    t = np.arange(plan.blocks * plan.trajectories * plan.group)
    b = t // plan.group
    j = t % plan.group
    keep = b < B
    b, j = b[keep], j[keep]
    rows = [np.stack([b, j // half, s], -1)[s < frequency]
            for s in (j % half + half * r for r in range(-(-frequency // half)))]
    return np.concatenate(rows)


@pytest.mark.parametrize("frequency", range(1, 16))
def test_chunk_plan_covers_every_trajectory_and_step_once(frequency):
    """For every B from 1 to 20000 the blocks cover the trajectories, with
    none empty; at every B of the paths' edges the threads' walk covers each
    (trajectory, side, step below frequency) exactly once."""
    for B in range(1, 20001):
        group, per, blocks = K7.chunk_plan(B)
        assert (blocks - 1) * per < B <= blocks * per and group == K7.GROUP
    for B in (1, 15, 16, 17, 208, 511, 512, 513, 4097, 20000):
        walk = _chunk_walk(B, frequency, K7.chunk_plan(B))
        want = np.stack(np.meshgrid(np.arange(B), np.arange(2), np.arange(frequency),
                                    indexing="ij"), -1).reshape(-1, 3)
        assert len(walk) == len(want)
        assert np.array_equal(np.unique(walk, axis=0), want)


def test_chunk_plan_at_the_paths_batch():
    """predict's batch of 512: 128 blocks of 4 trajectories (64 threads)."""
    assert K7.chunk_plan(512) == K7.ChunkPlan(16, 4, 128)


# -------------------------------------------------------------------- K5

def _expert_tables_walk(V: int, U: int, C: int, A: int, plan) -> np.ndarray:
    """Every (v, u, c, action) that a thread of the launch takes (both
    allocations), as ``csrc/expert_tables.cu`` maps them: block b takes
    (v, c) = divmod(b // groups, C) and the user group g = b % groups;
    thread i of its 32 * warps threads user g * users + i // A and action
    i % A; a thread whose user lies past the group or past U takes
    nothing."""
    b, i = np.meshgrid(np.arange(plan.blocks), np.arange(32 * plan.warps), indexing="ij")
    group, vc = b % plan.groups, b // plan.groups
    r, act = i // A, i % A
    u = group * plan.users + r
    keep = (r < plan.users) & (u < U)
    v, c = np.divmod(vc, C)
    return np.stack([x[keep] for x in (v, u, c, act)], -1)


def _check_expert_tables_plan(V: int, U: int, C: int, A: int = 15):
    plan = K5.expert_tables_plan(V, U, C, A)
    assert 1 <= plan.users <= K5.MAX_USERS and 1 <= plan.warps <= K5.MAX_WARPS
    assert plan.warps * 32 >= plan.users * A and plan.users <= U
    assert (plan.groups - 1) * plan.users < U <= plan.groups * plan.users  # no empty group
    assert plan.blocks == V * C * plan.groups
    assert plan.users == min(K5.MAX_USERS, K5.MAX_WARPS * 32 // A, U)  # as many as fit
    walk = _expert_tables_walk(V, U, C, A, plan)
    key = ((walk[:, 0] * U + walk[:, 1]) * C + walk[:, 2]) * A + walk[:, 3]
    assert len(key) == V * U * C * A
    assert np.array_equal(np.sort(key), np.arange(V * U * C * A))


@pytest.mark.parametrize("V,C", [(1, 1), (1, 3), (2, 5), (3, 60), (18, 60), (5, 100)])
def test_expert_tables_plan_covers_every_row_and_action_once(V, C):
    for U in (1, 2, 3, 7, 8, 9, 15, 16, 17, 31, 45, 64):
        _check_expert_tables_plan(V, U, C)


@pytest.mark.parametrize("A", [1, 8, 15, 16, 32])
def test_expert_tables_plan_for_other_action_spaces(A):
    for V, U, C in ((1, 1, 1), (1, 13, 1), (3, 15, 60), (2, 45, 7)):
        _check_expert_tables_plan(V, U, C, A)


def test_expert_tables_plan_at_the_splits_shapes():
    """The test split (3 x 15 x 60, the expert's and serve-v16's tables): 8
    users a block, 2 groups, 360 blocks; the train split (18 x 45 x 60): 8
    users, 6 groups, 6480 blocks; 4 warps a block at 15 actions."""
    assert K5.expert_tables_plan(3, 15, 60, 15) == K5.ExpertTablesPlan(8, 4, 2, 360)
    assert K5.expert_tables_plan(18, 45, 60, 15) == K5.ExpertTablesPlan(8, 4, 6, 6480)
    assert K5.expert_tables_plan(3, 15, 60, 15).blocks >= H100_SMS


# -------------------------------------------------------------------- K6

def _gae_walk(T: int, N: int, plan) -> np.ndarray:
    """Every (t, lane) that a thread of the launch walks, as ``csrc/gae.cu``
    does: block b's thread l takes lane b * lanes + l (those below N), and
    walks chunk k = 0, 1, ... of steps max(T - (k + 1) * chunk, 0) .. T - k *
    chunk - 1, latest first."""
    lane = np.arange(plan.blocks * plan.lanes)
    lane = lane[lane < N]
    steps = []
    for k in range(plan.chunks):
        hi = T - k * plan.chunk
        steps.extend(range(hi - 1, max(hi - plan.chunk, 0) - 1, -1))
    t, n = np.meshgrid(np.asarray(steps, int), lane, indexing="ij")
    return np.stack([t.ravel(), n.ravel()], -1), steps


@pytest.mark.parametrize("T", [1, 2, 31, 32, 33, 64, 127, 128, 129, 200, 300])
def test_gae_plan_covers_every_step_and_lane_once(T):
    """Every lane of every block below N, and every step exactly once, from
    T - 1 down to 0 (the recurrence's order) over the chunks."""
    for N in (1, 7, 31, 32, 33, 48, 128, 1000, 4112, 8192):
        plan = K6.gae_plan(T, N)
        assert plan.lanes == K6.LANES and plan.chunk == K6.CHUNK
        assert (plan.blocks - 1) * plan.lanes < N <= plan.blocks * plan.lanes
        assert (plan.chunks - 1) * plan.chunk < T <= plan.chunks * plan.chunk
        walk, steps = _gae_walk(T, N, plan)
        assert steps == list(range(T - 1, -1, -1))
        key = walk[:, 0] * N + walk[:, 1]
        assert len(key) == T * N and np.array_equal(np.sort(key), np.arange(T * N))


def test_gae_plan_at_the_paths_shapes():
    """train's [32, 128]: 4 blocks of one chunk; the rollout's [128, 8192]:
    256 blocks (more than the H100's 132 SMs) of four chunks, all in flight
    before the walk."""
    assert K6.gae_plan(32, 128) == K6.GaePlan(32, 32, 1, 4)
    assert K6.gae_plan(128, 8192) == K6.GaePlan(32, 32, 4, 256)
    assert K6.gae_plan(128, 8192).blocks >= H100_SMS


# -------------------------------------------------------------------- K8

# the (dims a lane, keys a tile) instantiations of csrc/attention_backward.cu
ROW_KERNELS = {(1, 4), (1, 8), (1, 16), (1, 32), (2, 4), (2, 8), (2, 16), (4, 4), (4, 8), (8, 4)}
TILE_KERNELS = {(p, m) for p in (1, 2, 4, 8) for m in (4, 8, 16)}
BACKWARD_SIZES = (1, 15, 64, 65, 96, 2048)


def _wide_walk(Lq: int, Lk: int, kv_len0: int, plan):
    """The wide backward's walks (``csrc/attention_backward_wide.cu``) for one
    output chunk: (times each (row, key) is taken, one array a pass; times
    each key's dk and dv rows are written; times each row's dq row is
    written).  Up to ``keys`` keys one grid: a CTA a (b, head) over the row
    tiles of ``rows`` rows, a pair taking its rows' seen keys, dq written a
    row tile at a time.  Else the dQ grid: a CTA a row tile over the key
    tiles up to the last key a row of it sees, twice (each row's max and D,
    then dQ), dq written once; and the dK/dV grid: a CTA a key tile over the
    row tiles of ``rows`` from the first row that sees it (none if no row
    does), dk and dv written once."""
    seen = np.arange(Lk)[None, :] < np.minimum(Lk, kv_len0 + np.arange(Lq))[:, None]
    R, KT = plan.rows, plan.keys
    dkv_written, dq_written = np.zeros(Lk, int), np.zeros(Lq, int)
    n_max = min(Lk, kv_len0 + Lq - 1)

    def dkv_grid():
        taken = np.zeros((Lq, Lk), int)
        for j0 in range(0, Lk, KT):
            r_first = max(0, j0 - kv_len0 + 1)
            for r0 in (range(r_first, Lq, R) if j0 < n_max else ()):
                taken[r0:r0 + R, j0:j0 + KT] += seen[r0:r0 + R, j0:j0 + KT]
                if Lk <= KT:  # one grid: the pair's dq rows
                    dq_written[r0:r0 + R] += 1
            dkv_written[j0:j0 + KT] += 1
        return taken

    if Lk <= KT:
        return [dkv_grid()], dkv_written, dq_written
    passes = []
    for _ in range(2):  # the max and D, then dQ
        taken = np.zeros((Lq, Lk), int)
        for r0 in range(0, Lq, R):
            n_cta = min(Lk, kv_len0 + min(Lq, r0 + R) - 1)
            for j0 in range(0, n_cta, KT):
                taken[r0:r0 + R, j0:j0 + KT] += seen[r0:r0 + R, j0:j0 + KT]
        passes.append(taken)
    dq_written += 1
    return passes + [dkv_grid()], dkv_written, dq_written


def _backward_walk(Lq: int, Lk: int, kv_len0: int, plan):
    """(times each (row, key) is taken, one array a kernel's walk; times
    each key's dk and dv rows are written) as ``csrc/attention_backward.cu``
    walks them: the row kernel the row's seen keys in tiles of ``keys``,
    then the unseen keys' zeros; the tile kernel (and the split's dK and dV
    kernel) each key tile that some row sees, over the row tiles from the
    first row that sees it, and a key tile's rows once; the split's dQ
    kernel (``csrc/attention_backward_split.cu``) each row tile over the key
    tiles up to the last key a row of it sees, a row taking the tiles that
    start below its prefix; past 256 dims for more rows, :func:`_wide_walk`
    (each pass of an output chunk)."""
    if plan.kernel == "tile_wide_tc":
        takens, written, dq_written = _wide_walk(Lq, Lk, kv_len0, plan)
        assert (dq_written == 1).all()
        return takens, written
    taken, written = np.zeros((Lq, Lk), int), np.zeros(Lk, int)
    seen = np.arange(Lk)[None, :] < np.minimum(Lk, kv_len0 + np.arange(Lq))[:, None]
    if plan.kernel in ("row", "row_wide"):
        n = min(Lk, kv_len0)
        for j0 in range(0, n, plan.keys):
            taken[0, j0:min(n, j0 + plan.keys)] += 1
            written[j0:min(n, j0 + plan.keys)] += 1
        written[n:] += 1
        return [taken], written
    n_max = min(Lk, kv_len0 + Lq - 1)
    for j0 in range(0, Lk, plan.keys):
        j1 = min(Lk, j0 + plan.keys)
        if j0 < n_max:
            for r0 in range(max(0, j0 - kv_len0 + 1), Lq, plan.rows):
                r1 = min(Lq, r0 + plan.rows)
                taken[r0:r1, j0:j1] += seen[r0:r1, j0:j1]
        written[j0:j1] += 1
    if plan.kernel != "tile_split":
        return [taken], written
    dq_taken = np.zeros((Lq, Lk), int)
    for r0 in range(0, Lq, plan.rows):
        rn = min(plan.rows, Lq - r0)
        for j0 in range(0, min(Lk, kv_len0 + r0 + rn - 1), plan.keys):
            for r in range(r0, r0 + rn):
                if j0 < min(Lk, kv_len0 + r):
                    dq_taken[r, j0:j0 + plan.keys] += seen[r, j0:j0 + plan.keys]
    return [taken, dq_taken], written


@pytest.mark.parametrize("Lq", BACKWARD_SIZES)
@pytest.mark.parametrize("Lk", BACKWARD_SIZES)
@pytest.mark.parametrize("Dh", [4, 64, 256])
def test_attention_backward_plan_covers_every_row_and_key_once(Lq, Lk, Dh):
    """K8's backward plan at one and many rows and keys, past the earlier
    kernel's 64 and up to the forward's 2048 keys, causal (kv_len0 1) and
    full: every (row, key) a row sees is taken exactly once (and none it
    does not see), every key's dk and dv rows are written once (keys no row
    sees as zeros), a lane's dims hold Dh, the keys a tile and the dims a
    lane name a compiled instantiation, and the shared memory fits the
    H100."""
    for kv_len0 in (1, Lk):
        plan = K8.attention_backward_plan(512, Lq, Lk, 8, Dh)
        (taken,), written = _backward_walk(Lq, Lk, kv_len0, plan)
        seen = np.arange(Lk)[None, :] < np.minimum(Lk, kv_len0 + np.arange(Lq))[:, None]
        assert np.array_equal(taken, seen.astype(int))
        assert (written == 1).all()
        assert 32 * plan.per_lane >= Dh > 16 * plan.per_lane or plan.per_lane == 1
        assert plan.smem_bytes <= 227 * 1024
        if Lq == 1:
            assert plan.kernel == "row" and (plan.per_lane, plan.keys) in ROW_KERNELS
            assert plan.blocks * plan.threads // 32 >= 512 * 8
        else:
            assert plan.kernel == "tile" and (plan.per_lane, plan.keys) in TILE_KERNELS
            assert plan.rows == min(Lq, 32) and plan.blocks == 512 * 8
            assert plan.threads in (128, 256)


def test_attention_backward_plan_at_the_training_shapes():
    """The decode step and cross-attention (one row) take the row kernel with
    the 15-slot cache in one tile of 16 keys; the encoder, the teacher-forced
    causal pass and its cross-attention take the tile kernel, one key tile
    and one row tile each."""
    plan = lambda Lq, Lk: K8.attention_backward_plan(512, Lq, Lk, 8, 64)
    assert plan(1, 15) == K8.BackwardPlan("row", 2, 16, 1, 256, 512, 0)
    assert plan(1, 3) == K8.BackwardPlan("row", 2, 4, 1, 256, 512, 0)
    assert plan(5, 5)[:5] == ("tile", 2, 8, 5, 128)
    assert plan(15, 15)[:5] == ("tile", 2, 16, 15, 256)
    assert plan(15, 3)[:5] == ("tile", 2, 4, 15, 128)
    assert plan(96, 96)[:5] == ("tile", 2, 16, 32, 256)


FORWARD_SIZES = (1, 2, 15, 33, 96, 97, 2048)
H100_SMEM = 227 * 1024  # shared memory a block on the H100


def _forward_walk(Lq: int, Lk: int, kv_len0: int, plan, chunks: int = 1):
    """(times the score phase takes each (row, key), times the P . v phase
    takes it, times each output row is written) as ``csrc/attention.cu``
    walks them.  The row kernel: a warp a row over its seen keys (the wide
    one: P . v and the write once a chunk of ``chunks``).  The tile kernel:
    a CTA a row tile of ``rows`` rows; in it a warp a group of ``group``
    rows; each walks the key tiles of ``keys`` keys up to the last key a row
    of the CTA sees: the scores in reduce_scatter batches of 32 / ``group``
    keys (a lane keeps a (row, key) its row sees), P . v key by key, each
    row's fmaf taken where its row sees the key.  The streamed kernel: a
    group of 16 rows on the tensor cores (one warp, or past 256 dims the
    CTA's warps each summing a share of the dims), over the CTA's key tiles
    once for the row statistics and once for each of ``chunks`` output
    chunks; in a key tile the group takes the key groups of 8 below the
    last key its rows see (the score tile's n-tiles: a (row, key) its row
    sees is kept), P . v in steps of 8 (f32) or 16 (bf16) keys, p 0 where
    the row does not see the key; the write once an output chunk.  The split
    row kernels: :func:`_row_split_walk`."""
    scores, pv = np.zeros((Lq, Lk), int), np.zeros((Lq, Lk), int)
    written = np.zeros(Lq, int)
    if plan.kernel == "row_split":
        splits = _row_split_walk(Lk, kv_len0, plan)
        for taken, order in splits:
            scores[0] += taken
            pv[0, order] += 1
        written[0] = 1
        return scores, pv, written
    seen_by = lambda r: min(Lk, kv_len0 + r)
    if plan.kernel in ("row", "row_wide"):
        for r in range(Lq):
            scores[r, :seen_by(r)] += 1
            pv[r, :seen_by(r)] += chunks
            written[r] += chunks
        return scores, pv, written
    stream = plan.kernel == "stream"
    R, batch = plan.group, 8 if stream else 32 // plan.group
    passes = 1 + chunks if stream else 1
    groups = -(-plan.rows // R) if stream else plan.threads // 32  # row groups a CTA
    for r0 in range(0, Lq, plan.rows):
        rn = min(plan.rows, Lq - r0)
        n_cta = min(Lk, kv_len0 + r0 + rn - 1)
        for g0 in range(0, groups * R, R):
            gn = max(0, min(R, rn - g0))
            n_warp = min(Lk, kv_len0 + r0 + g0 + gn - 1) if gn else 0
            rows = range(r0 + g0, r0 + g0 + gn)
            for p in range(passes):
                for j0 in range(0, n_cta, plan.keys):
                    kn = min(plan.keys, n_cta - j0)
                    jn = min(kn, n_warp - j0)
                    if jn <= 0:
                        continue
                    batched = -(-jn // batch) * batch  # keys the batches (or n-tiles) cover
                    assert batched <= plan.keys        # within the staged tile
                    assert not stream or -(-jn // 16) * 16 <= plan.keys  # bf16's key steps
                    for r in rows:
                        scores[r, j0:min(j0 + batched, seen_by(r))] += 1
                        if p >= passes - chunks:
                            pv[r, j0:min(j0 + jn, seen_by(r))] += 1
            written[list(rows)] += chunks
    return scores, pv, written


def _row_split_walk(Lk: int, kv_len0: int, plan):
    """The split row kernels' walk of one (b, head) as ``csrc/attention.cu``
    takes it, a split at a time in split order (the order launch 2 combines
    their statistics in and launch 3 their partials): for each split, (times
    its score launch takes each key, the keys its P . v chain takes in
    order).  Split s holds keys [s keys, (s + 1) keys) below the keys the
    row sees; its warp walks them in tiles of ROW_SPLIT_TILE, a lane a key
    of the tile's reduce_scatter, then the tile's keys one by one."""
    n = min(Lk, kv_len0)
    out = []
    for s in range(K8.row_split_splits(Lk, plan)):
        begin, end = s * plan.keys, min(n, (s + 1) * plan.keys)
        taken, order = np.zeros(Lk, int), []
        for j0 in range(begin, end, K8.ROW_SPLIT_TILE):
            lanes = j0 + np.arange(K8.ROW_SPLIT_TILE)
            taken[lanes[lanes < end]] += 1
            order += list(range(j0, min(j0 + K8.ROW_SPLIT_TILE, end)))
        out.append((taken, order))
    return out


def _mma_dims_walk(Dh: int, width: int, chunks: int, splits: int) -> np.ndarray:
    """Times each of a head's dims is written by the streamed kernel: output
    chunk c of ``width`` dims, split among ``splits`` warps, warp w's
    n-tile n, lane 4 g + t's pair e is dim c width + w width / splits +
    8 n + 2 t + e, written where it is below Dh (the q and k chunks' dims
    split among the warps alike)."""
    taken = np.zeros(chunks * width, int)
    share = width // splits
    for c in range(chunks):
        for w in range(splits):
            for n in range(share // 8):
                for t in range(4):
                    for e in range(2):
                        taken[c * width + w * share + 8 * n + 2 * t + e] += 1
    assert (taken == 1).all()
    return taken[:Dh]


def _dims_walk(Dh: int, per_lane: int, chunks: int) -> np.ndarray:
    """Times each of a head's dims is taken: lane l's i-th value of chunk c
    is dim c 32 P + l + 32 i, taken where it is below Dh."""
    taken = np.zeros(chunks * 32 * per_lane, int)
    for c in range(chunks):
        for lane in range(32):
            for i in range(per_lane):
                taken[c * 32 * per_lane + lane + 32 * i] += 1
    assert (taken == 1).all()
    return taken[:Dh]


@pytest.mark.parametrize("Lq", FORWARD_SIZES)
@pytest.mark.parametrize("Lk", FORWARD_SIZES)
@pytest.mark.parametrize("Dh", [4, 48, 64, 256])
def test_attention_forward_plan_covers_every_row_and_key_once(Lq, Lk, Dh):
    """K8's forward plan at one and many rows and keys, up to MAX_LK keys,
    causal (kv_len0 1) and full: the score phase and the P . v phase each
    take every (row, key) a row sees exactly once and none it does not see,
    every output row is written once, a lane's dims hold Dh, the blocks
    cover every (b, head, row tile), and the shared memory fits the H100;
    one row takes the row kernel, more the tile kernel."""
    B, H = 512, 8
    for kv_len0 in (1, Lk):
        plan = K8.attention_forward_plan(B, Lq, Lk, H, Dh)
        scores, pv, written = _forward_walk(Lq, Lk, kv_len0, plan)
        seen = np.arange(Lk)[None, :] < np.minimum(Lk, kv_len0 + np.arange(Lq))[:, None]
        assert np.array_equal(scores, seen.astype(int))
        assert np.array_equal(pv, seen.astype(int))
        assert (written == 1).all()
        assert plan.smem_bytes <= H100_SMEM
        if Lq == 1:
            assert plan == K8.ForwardPlan("row", 8, Lk, 1, 1, 128, B * H // 4, 16 * Lk)
            continue
        assert plan.kernel == "tile" and plan.group == 4
        assert 32 * plan.per_lane >= Dh > 16 * plan.per_lane or plan.per_lane == 1
        assert plan.keys % 8 == 0 and plan.keys * 32 * plan.per_lane <= 8192
        assert plan.keys >= min(Lk, 256 // plan.per_lane)
        assert 1 <= plan.rows <= 32 and plan.threads == 32 * -(-plan.rows // 4)
        assert plan.rows == min(Lq, 32) or plan.rows % 4 == 0
        assert plan.blocks == B * H * -(-Lq // plan.rows)
        assert plan.smem_bytes == (4 * (plan.keys * 32 * plan.per_lane
                                        + plan.rows * K8.score_stride(Lk))
                                   + -(-plan.rows * Lk // 16) * 16)


def test_attention_forward_plan_keeps_the_row_launch_at_one_row():
    """One query row (every decode step and the decode's cross-attention)
    takes the row kernel's launch as it was: 4 warps a CTA, a warp a (b,
    row, head), 4 Lk floats of scores a CTA."""
    for Lk in (1, 3, 15, 256, 2048):
        for B, H in ((512, 8), (77, 8), (5, 3)):
            plan = K8.attention_forward_plan(B, 1, Lk, H, 64)
            assert plan == K8.ForwardPlan("row", 8, Lk, 1, 1, 128, -(-B * H // 4), 16 * Lk)


def test_attention_forward_plan_at_the_training_shapes():
    """The encoder's 5 x 5, the teacher-forced causal 15 x 15 and its cross
    15 x 3 take one row tile a (b, head), the --his-window 96 encoder three
    of 32 rows; at 2048 keys the score buffer leaves a row tile of 16.
    Shared memory: the key tile's k rows, later its v rows (keys x 64
    floats), the score buffer (rows x :func:`score_stride`) and the keep
    bytes (to 16)."""
    plan = lambda Lq, Lk, Dh=64: K8.attention_forward_plan(512, Lq, Lk, 8, Dh)
    assert plan(5, 5) == K8.ForwardPlan("tile", 2, 8, 5, 4, 64, 4096,
                                        4 * (8 * 64 + 5 * 40) + 32)
    assert plan(15, 15) == K8.ForwardPlan("tile", 2, 16, 15, 4, 128, 4096,
                                          4 * (16 * 64 + 15 * 40) + 240)
    assert plan(15, 3) == K8.ForwardPlan("tile", 2, 8, 15, 4, 128, 4096,
                                         4 * (8 * 64 + 15 * 40) + 48)
    assert plan(96, 96) == K8.ForwardPlan("tile", 2, 96, 32, 4, 256, 12288,
                                          4 * (96 * 64 + 32 * 104) + 32 * 96)
    assert plan(96, 2048).rows == plan(96, 2048, 256).rows == 16
    assert plan(96, 2048, 256).smem_bytes <= H100_SMEM


def _plans_digest(plan_module) -> str:
    """sha256 (16 hex digits) of K8's forward and backward plans at B 512,
    8 heads, over rows, keys (up to 2048) and dims (up to 256) on both sides
    of every tile."""
    import hashlib
    h = hashlib.sha256()
    for Lq in (1, 2, 5, 15, 16, 17, 33, 96, 97, 2048):
        for Lk in (1, 3, 8, 15, 64, 65, 96, 255, 256, 300, 1000, 1500, 2047, 2048):
            for Dh in (1, 4, 33, 48, 64, 100, 128, 129, 255, 256):
                h.update(repr((tuple(plan_module.attention_forward_plan(512, Lq, Lk, 8, Dh)),
                               tuple(plan_module.attention_backward_plan(512, Lq, Lk, 8, Dh)))
                              ).encode())
    return h.hexdigest()[:16]


def test_attention_plans_keep_their_launches_up_to_2048_keys_and_256_dims():
    """At up to 2048 keys and 256 dims the forward and backward plans are
    the ones of the kernels before the streamed and wide variants (the
    digest of that commit's plans over the same grid), so those shapes keep
    their launches and their bits."""
    assert _plans_digest(K8) == "f9a4d244b97d891d"


LIMIT_KEYS = (2049, 3073, 5000)
WIDE_DIMS = (257, 320, 512, 1024, 2048)


@pytest.mark.parametrize("Lq", [1, 15, 33])
@pytest.mark.parametrize("Lk,Dh", [(Lk, 64) for Lk in LIMIT_KEYS]
                         + [(Lk, 256) for Lk in LIMIT_KEYS]
                         + [(Lk, Dh) for Lk in (15, 96) for Dh in WIDE_DIMS]
                         + [(5000, Dh) for Dh in (320, 2048)])
def test_attention_plans_past_the_earlier_limits_cover_every_row_key_and_dim(Lq, Lk, Dh):
    """Past 2048 keys and 256 dims, causal (kv_len0 1) and full: the forward
    plan's score passes (the streamed kernel's: one for the row statistics,
    one an output chunk) and P . v chunks take every (row, key) a row sees
    once each (none it does not see), every output row is written once a
    chunk, the chunks' lanes (the streamed kernel's n-tiles) take every dim
    once; the backward plan takes
    every (row, key) once and writes every key's dk and dv rows once; both
    within the H100's shared memory.  One query row: the row kernel (its
    wide variant past 256 dims), its scores within MAX_LK keys; more: the
    streamed kernel wherever the resident tile kernel's rows would drop
    below 16 (or past 256 dims), the tile kernel elsewhere; the backward
    past 2048 keys at up to 256 dims the tile kernel at B 512 and for one
    row tile, and the split at B 2 for 33 rows, whose two walks each take
    every (row, key) once."""
    B, H = 512, 8
    fwd = K8.attention_forward_plan(B, Lq, Lk, H, Dh)
    bwd = K8.attention_backward_plan(B, Lq, Lk, H, Dh)
    wide = Dh > K8.CHUNK_DIMS
    chunks = -(-Dh // (32 * fwd.per_lane)) if fwd.kernel != "row" else 1
    assert chunks == (-(-Dh // 256) if wide else 1)
    if fwd.kernel == "stream":
        splits = fwd.threads // 32 // -(-fwd.rows // 16)
        assert splits == (4 if fwd.per_lane == 8 else 1)
        assert _mma_dims_walk(Dh, 32 * fwd.per_lane, chunks, splits).sum() == Dh
        chunks = -(-chunks // 2) if wide else 1  # output chunks: two of the staged chunks each
    else:
        assert _dims_walk(Dh, fwd.per_lane, chunks).sum() == Dh
    assert _dims_walk(Dh, bwd.per_lane, -(-Dh // (32 * bwd.per_lane))).sum() == Dh
    for kv_len0 in (1, Lk):
        seen = np.arange(Lk)[None, :] < np.minimum(Lk, kv_len0 + np.arange(Lq))[:, None]
        scores, pv, written = _forward_walk(Lq, Lk, kv_len0, fwd, chunks)
        passes = 1 + chunks if fwd.kernel == "stream" else 1
        assert np.array_equal(scores, passes * seen.astype(int))
        assert np.array_equal(pv, chunks * seen.astype(int))
        assert (written == chunks).all()
        takens, bwd_written = _backward_walk(Lq, Lk, kv_len0, bwd)
        assert all(np.array_equal(taken, seen.astype(int)) for taken in takens)
        assert (bwd_written == 1).all()
    assert fwd.smem_bytes <= H100_SMEM and bwd.smem_bytes <= H100_SMEM
    if Lq == 1:  # past 2048 keys at up to 256 dims the split row kernels
        assert fwd == (K8.ForwardPlan("row_wide", 8, Lk, 1, 1, 128, B * H // 4, 16 * Lk)
                       if wide else K8.row_split_plan(B, Lk, H, Dh))
        assert not wide or Lk <= K8.MAX_LK
        assert bwd.kernel == ("row_wide" if wide else "row")
        return
    assert fwd.kernel == "stream" if wide or Lk > 2490 else fwd.kernel == "tile"
    assert fwd.blocks == B * H * -(-Lq // fwd.rows)
    if fwd.kernel == "stream":
        split = fwd.per_lane == 8  # past 128 dims
        assert fwd.rows == min(Lq, 16 if split else 64) and fwd.group == 16
        assert fwd.threads == (128 if split else 32 * -(-fwd.rows // 16))
        assert fwd.keys == (32 if fwd.per_lane >= 4 else 64)
        assert fwd.smem_bytes == K8.stream_smem_bytes(fwd.per_lane, fwd.threads // 32)
    else:
        assert fwd.threads == 32 * -(-fwd.rows // 4)
    if wide:  # f32: the tensor cores past 16 keys up to 512 dims, the SIMT tile kernel else
        tc = Lk > 16 and Dh <= 512
        assert bwd.kernel == ("tile_wide_tc" if tc else "tile_wide")
        assert (bwd.per_lane, bwd.threads) == (8, 256)
        assert (bwd.rows, bwd.keys) == ((16, 16) if tc else (min(Lq, K8.WIDE_ROWS), 8))
        bf16 = K8.attention_backward_plan(B, Lq, Lk, H, Dh, bf16=True)
        assert bf16 == K8.attention_backward_plan(B, Lq, Lk, H, Dh, tensor_cores=True)
        assert bf16.kernel == "tile_wide_tc"
        for kv_len0 in (1, Lk):
            seen = np.arange(Lk)[None, :] < np.minimum(Lk, kv_len0 + np.arange(Lq))[:, None]
            takens, bf16_written = _backward_walk(Lq, Lk, kv_len0, bf16)
            assert all(np.array_equal(taken, seen.astype(int)) for taken in takens)
            assert (bf16_written == 1).all()
    else:
        assert bwd.kernel == "tile" and bwd.rows == min(Lq, 32)  # 4096 (b, head) fill the card
        split = K8.attention_backward_plan(2, Lq, Lk, H, Dh)  # at B 2 the split takes 33 rows
        assert split.kernel == ("tile_split" if Lk > K8.SPLIT_KEYS and Lq > 32 else "tile")
        for kv_len0 in (1, Lk):
            takens, split_written = _backward_walk(Lq, Lk, kv_len0, split)
            seen = np.arange(Lk)[None, :] < np.minimum(Lk, kv_len0 + np.arange(Lq))[:, None]
            assert all(np.array_equal(taken, seen.astype(int)) for taken in takens)
            assert (split_written == 1).all()


@pytest.mark.parametrize("Lq", [2, 15, 33])
@pytest.mark.parametrize("Lk", [15, 96, 5000])
@pytest.mark.parametrize("Dh", list(WIDE_DIMS))
def test_attention_wide_backward_plan_walks_every_pair_once(Lq, Lk, Dh):
    """The tensor-core backward of more than one query row past 256 dims
    (``tile_wide_tc``: bf16's plan, f32's with ``tensor_cores``): tiles of
    16 rows and 16 keys, 8 warps; up to 16 keys one grid of a CTA a (b,
    head), else a dQ grid of a CTA a (b, head, row tile) and a dK/dV grid of
    a CTA a (b, head, key tile); shared memory 209,600 bytes in f32 (111,296
    in bf16) up to 512 dims, where the CTA's own rows stay resident, and
    144,576 (79,040) streamed past them, all within the H100's 227 KB.
    Causal (kv_len0 1) and full, each pass of each grid
    takes every (row, key) a row sees once and none it does not see, and
    writes every dq row and every dk and dv row once an output chunk of 512
    dims, whose 8 warps' 64 dims each take every dim of the head once."""
    B, H = 512, 8
    plan = K8.attention_backward_plan(B, Lq, Lk, H, Dh, bf16=True)
    assert plan == K8.attention_backward_plan(B, Lq, Lk, H, Dh, tensor_cores=True)
    one_grid, resident = Lk <= 16, Dh <= 512
    blocks = B * H * (1 if one_grid else -(-Lq // 16) + -(-Lk // 16))
    assert plan == K8.BackwardPlan("tile_wide_tc", 8, 16, 16, 256, blocks,
                                   209600 if resident else 144576)
    assert K8.wide_backward_smem_bytes(Dh, 2) == (111296 if resident else 79040)
    assert plan.smem_bytes <= H100_SMEM and K8.backward_mode(plan) == "_wide"
    outs = -(-Dh // K8.WIDE_OUT)
    assert _mma_dims_walk(Dh, K8.WIDE_OUT, outs, 8).sum() == Dh
    for kv_len0 in (1, Lk):
        seen = np.arange(Lk)[None, :] < np.minimum(Lk, kv_len0 + np.arange(Lq))[:, None]
        takens, dkv_written, dq_written = _wide_walk(Lq, Lk, kv_len0, plan)
        assert len(takens) == (1 if Lk <= 16 else 3)
        assert all(np.array_equal(taken, seen.astype(int)) for taken in takens)
        assert (dkv_written == 1).all() and (dq_written == 1).all()


def test_attention_wide_backward_rule_by_element_type():
    """More than one query row past 256 dims: bf16 takes the tensor cores at
    every shape; f32 past 16 keys up to 512 dims, and past 512 dims below
    SPLIT_MAX_HEADS (b, head) pairs (the SIMT kernel's B H CTAs leave the
    card idle), else the SIMT tile kernel (a CTA a (b, head), row tiles of
    up to 8); ``tensor_cores`` forces either in f32, and refuses one row,
    heads of up to 256 dims and the SIMT kernel in bf16."""
    plan = lambda Lq, Lk, Dh, B=512, **kw: K8.attention_backward_plan(B, Lq, Lk, 8, Dh, **kw)
    assert plan(96, 96, 512).kernel == plan(96, 96, 320).kernel == "tile_wide_tc"
    assert plan(96, 96, 2048, B=64).kernel == plan(96, 96, 1024, B=64).kernel == "tile_wide"
    assert plan(33, 5000, 2048, B=1).kernel == plan(96, 96, 2048, B=31).kernel == "tile_wide_tc"
    assert plan(96, 96, 2048, B=32).kernel == "tile_wide"
    for Lq, Lk in ((5, 5), (15, 15), (15, 3)):
        assert plan(Lq, Lk, 512) == K8.BackwardPlan("tile_wide", 8, 8, min(Lq, 8), 256, 4096,
                                                    plan(Lq, Lk, 512, tensor_cores=False)[6])
        assert plan(Lq, Lk, 512, bf16=True) == plan(Lq, Lk, 512, tensor_cores=True)
        assert plan(Lq, Lk, 512, bf16=True).kernel == "tile_wide_tc"
    assert plan(96, 96, 512, tensor_cores=False).kernel == "tile_wide"
    assert plan(96, 96, 2048, B=64, tensor_cores=True).kernel == "tile_wide_tc"
    for Lq, Dh, kw in ((1, 512, {}), (15, 256, {}), (15, 512, {"bf16": True})):
        with pytest.raises(ValueError, match="wide backward"):
            plan(Lq, 96, Dh, tensor_cores=False, **kw)


def test_attention_forward_plan_streams_where_the_score_rows_no_longer_fit():
    """The resident tile kernel keeps a row tile of 16 up to about 2490 keys
    (as at 2048); past it the streamed kernel takes row tiles of 64 rows, a
    warp 16 of them, key tiles of 64 (32 past 64 dims), with shared memory
    that does not grow with Lk: the q rows and two slots of k or v rows,
    each row 16 bytes longer than its values; past 128 dims 16 rows on 4
    warps, two slots of the q chunk and the k rows (or the v rows) of 256
    dims and the warps' partial scores; a call with fewer
    rows than 16 streams where those rows no longer fit; ``stream`` forces
    it."""
    plan = lambda Lq, Lk, Dh=64, **kw: K8.attention_forward_plan(512, Lq, Lk, 8, Dh, **kw)
    assert plan(96, 2400)[:4] == ("tile", 2, 128, 16)
    assert plan(96, 2500) == K8.ForwardPlan("stream", 2, 64, 64, 16, 128, 8192,
                                            4 * 3 * 64 * (64 + 4) + 2 * 64 * 68)
    assert plan(96, 5000) == plan(96, 2500)
    assert plan(15, 2500).kernel == "stream" and plan(2, 5000)[:4] == ("tile", 2, 128, 2)
    assert plan(96, 96, stream=True) == plan(96, 2500)
    assert plan(15, 15, 512) == K8.ForwardPlan("stream", 8, 32, 15, 16, 128, 4096,
                                               4 * 2 * (16 + 32) * 260 + 2 * 16 * 36
                                               + 4 * 4 * 32 * 16)
    assert plan(96, 96, 2048)[2:7] == (32, 16, 16, 128, 512 * 8 * 6)
    assert plan(33, 96, 256, stream=True) == plan(16, 96, 512)._replace(rows=16, blocks=12288)
    assert plan(33, 96, 128, stream=True) == K8.ForwardPlan(
        "stream", 4, 32, 33, 16, 96, 4096, 4 * (48 * 132 + 2 * 32 * 132) + 2 * 48 * 36)
    assert max(plan(64, 5000, Dh).smem_bytes for Dh in (32, 64, 128, 256, 2048)) <= H100_SMEM
    assert plan(1, 5000, 512)[:3] == ("row_wide", 8, 5000)


# the (dims a lane, keys a tile) instantiations of the split backward
SPLIT_KERNELS = {(1, 16), (2, 16), (4, 16), (8, 16)}


def _split_intervals(Lq: int, Lk: int, kv_len0: int, plan):
    """The split backward's walks as ``csrc/attention_backward_split.cu`` takes
    them, as tile ranges: (dkv, dq).  dkv: per key tile (j0, j1, the row
    ranges its CTA walks, in order); dq: per row tile (r0, r1, the key
    ranges its CTA walks, in order)."""
    n_max = min(Lk, kv_len0 + Lq - 1)
    dkv = []
    for j0 in range(0, Lk, plan.keys):
        r_first = max(0, j0 - kv_len0 + 1)
        rows = ([(r0, min(Lq, r0 + plan.rows)) for r0 in range(r_first, Lq, plan.rows)]
                if j0 < n_max else [])
        dkv.append((j0, min(Lk, j0 + plan.keys), rows))
    dq = []
    for r0 in range(0, Lq, plan.rows):
        r1 = min(Lq, r0 + plan.rows)
        n_cta = min(Lk, kv_len0 + r1 - 1)  # the last key a row of the tile sees, + 1
        dq.append((r0, r1, [(j0, min(Lk, j0 + plan.keys)) for j0 in range(0, n_cta, plan.keys)]))
    return dkv, dq


def _ascending_cover(ranges, lo: int, hi: int) -> bool:
    """Whether ``ranges``, in order, cover [lo, hi) once, in ascending order
    (each starting where the last ended)."""
    return bool(ranges) and ranges[0][0] == lo and ranges[-1][1] == hi and all(
        a[1] == b[0] and a[0] < a[1] for a, b in zip(ranges, ranges[1:] + [(hi, hi + 1)]))


@pytest.mark.parametrize("Lq", [15, 33, 5000])
@pytest.mark.parametrize("Lk", [2049, 3073, 5000])
@pytest.mark.parametrize("Dh", [48, 64, 256])
def test_attention_backward_split_takes_every_row_and_key_once_in_order(Lq, Lk, Dh):
    """The split backward's plan (the rule's choice past 2048 keys for more
    than one row tile at fewer than SPLIT_MAX_HEADS (b, head) pairs; forced
    for one), causal (kv_len0 1) and full: its dK and dV kernel adds every
    row that sees a key to that key's sums once, the rows in ascending
    order, and
    writes every key's dk and dv rows once (keys no row sees as zeros); its
    dQ kernel takes every key a row sees into that row's chain once, the
    keys in ascending order.  By tile ranges (a row adds nothing to the sums
    of a key it does not see, so a walk may start before a key's first
    row).  A lane's dims hold Dh, the (dims, keys) name a compiled
    instantiation, the blocks are both grids' CTAs, and the shared memory
    is the tile kernel's at the same tiles: 4 CTAs an SM at up to 64 dims,
    one at 8 dims a lane."""
    B, H = 2, 8  # the --his-window 5000 encoder's (b, head) pairs in phase 2i
    plan = K8.attention_backward_plan(B, Lq, Lk, H, Dh, split=True)
    rule = K8.attention_backward_plan(B, Lq, Lk, H, Dh)
    assert rule == plan if Lq > 32 else rule.kernel == "tile"
    assert plan.kernel == "tile_split" and (plan.per_lane, plan.keys) in SPLIT_KERNELS
    assert 32 * plan.per_lane >= Dh > 16 * plan.per_lane
    assert plan.rows == min(Lq, 32) and plan.threads == 256
    key_tiles, row_tiles = -(-Lk // plan.keys), -(-Lq // plan.rows)
    assert plan.blocks == B * H * (key_tiles + row_tiles)
    width = 32 * plan.per_lane
    assert plan.smem_bytes == 4 * (2 * plan.keys * width + 3 * plan.rows * width
                                   + 2 * plan.rows * plan.keys + 2 * plan.rows) \
        + plan.rows * plan.keys
    assert plan.smem_bytes <= H100_SMEM and (Dh > 64 or 4 * plan.smem_bytes <= H100_SMEM)
    for kv_len0 in (1, Lk):
        dkv, dq = _split_intervals(Lq, Lk, kv_len0, plan)
        assert len(dkv) == key_tiles and _ascending_cover([(j0, j1) for j0, j1, _ in dkv], 0, Lk)
        for j0, j1, rows in dkv:
            first = max(0, j0 - kv_len0 + 1)  # the first row that sees key j0
            if first >= Lq:                   # no row sees the tile: zeros
                assert rows == []
            else:                             # and none before `first` sees a later key
                assert _ascending_cover(rows, first, Lq)
        assert len(dq) == row_tiles and _ascending_cover([(r0, r1) for r0, r1, _ in dq], 0, Lq)
        for r0, r1, keys in dq:
            starts, ends = np.array(keys).T
            assert starts[0] == 0 and (starts[1:] == ends[:-1]).all() and (starts < ends).all()
            # a row takes the tiles that start below its prefix n, so [0, n) once, in order
            n = np.minimum(Lk, kv_len0 + np.arange(r0, r1))
            assert (ends[np.searchsorted(starts, n) - 1] >= n).all()
            assert starts[-1] < n.max()  # no tile past the last key a row of the tile sees


def test_attention_backward_split_is_forced_and_refused_as_planned():
    """``split`` True forces the split wherever the tile kernel runs (the
    same rows as the rule gives, 16 keys a tile, 8 warps), False the tile
    kernel where the rule splits; either refuses one query row and heads
    past 256 dims.  The rule: the split past 2048 keys for more than 32
    rows below SPLIT_MAX_HEADS (b, head) pairs; the tile kernel at 2048
    keys (the digest below), for one row tile, and at B 32 and 64 of 8
    heads."""
    plan = lambda Lq, Lk, Dh=64, B=512, **kw: K8.attention_backward_plan(B, Lq, Lk, 8, Dh,
                                                                        **kw)
    assert plan(96, 96, split=True) == K8.BackwardPlan(
        "tile_split", 2, 16, 32, 256, 512 * 8 * (6 + 3), plan(96, 96).smem_bytes)
    assert plan(5, 5, split=True)[:5] == ("tile_split", 2, 16, 5, 256)
    assert plan(30, 2048, 256, split=True)[:5] == ("tile_split", 8, 16, 30, 256)
    assert plan(33, 2048, B=2).kernel == "tile" and plan(33, 2049, B=2).kernel == "tile_split"
    assert plan(33, 2049, B=31).kernel == "tile_split"
    assert plan(33, 5000, B=32).kernel == plan(33, 5000, B=64).kernel == "tile"
    assert plan(32, 5000, B=2).kernel == plan(15, 2500, B=4).kernel == "tile"
    assert plan(33, 2049, B=2) == plan(33, 2049, B=2, split=True)
    assert plan(33, 5000, B=2, split=False) == K8.BackwardPlan("tile", 2, 16, 32, 256, 2 * 8,
                                                               plan(33, 5000).smem_bytes)
    for Lq, Dh in ((1, 64), (15, 257), (1, 512)):
        for split in (True, False):
            with pytest.raises(ValueError, match="split backward"):
                plan(Lq, 96, Dh, split=split)


def test_attention_backward_split_on_cpu_takes_the_plain_version():
    """CPU tensors take the plain version with ``split`` too, and count no
    launch."""
    rng = np.random.default_rng(21)
    q, k, v, dout = (torch.as_tensor(rng.standard_normal((2, L, 2, 8)), dtype=torch.float32)
                     for L in (5, 7, 7, 5))
    o, row_max, row_sum = K8.attention_train_forward_plain(q, k, v, 3)
    before = (K8.attention_backward.launches, dict(K8.attention_backward.launches_by_mode))
    got = K8.attention_backward(dout, q, k, v, o, row_max, row_sum, 3, split=True)
    want = K8.attention_backward_plain(dout, q, k, v, o, row_max, row_sum, 3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (K8.attention_backward.launches, K8.attention_backward.launches_by_mode) == before


ROW_SPLIT_KEYS = (2049, 2500, 3073, 5000, 14529)
# the split row plan at 8 heads, (B, Lk) -> (keys a split, splits S); Dh does not move them
ROW_SPLIT_PINNED = {(4, 2049): (64, 33), (4, 2500): (96, 27), (4, 3073): (96, 33),
                    (4, 5000): (160, 32), (4, 14529): (448, 33),
                    (64, 2049): (704, 3), (64, 2500): (864, 3), (64, 3073): (1056, 3),
                    (64, 5000): (1696, 3), (64, 14529): (4864, 3),
                    **{(512, Lk): (-(-Lk // 32) * 32, 1) for Lk in ROW_SPLIT_KEYS}}


@pytest.mark.parametrize("B", [4, 64, 512])
@pytest.mark.parametrize("Lk", ROW_SPLIT_KEYS)
@pytest.mark.parametrize("Dh", [1, 64, 256])
def test_attention_row_split_plan_is_pinned(B, Lk, Dh):
    """One query row past 2048 keys at up to 256 dims takes the split row
    kernels: the (b, head)'s keys in S splits of ``keys`` keys (a multiple
    of 32, none empty at kv_len0 = Lk), a warp a split, 4 warps a CTA (2 at
    8 dims a lane), the grid every (b, head, split) once; at B 4 and 64
    B H S warps give each of the H100's 132 SMs 6 or more (at B 512 one
    split: B H warps do); shared memory each warp's two slots of 32 rows of
    32 P values (f32; bf16 half), within 227 KB; the scratch the wrapper
    allocates (f32): each split's max and sum, each key's score, each
    split's P . v where there are two or more."""
    H = 8
    plan = K8.attention_forward_plan(B, 1, Lk, H, Dh)
    keys, S = ROW_SPLIT_PINNED[(B, Lk)]
    per_lane, warps = {1: (1, 4), 64: (2, 4), 256: (8, 2)}[Dh]
    assert plan == K8.ForwardPlan("row_split", per_lane, keys, 1, 1, 32 * warps,
                                  -(-B * H * S // warps), 4 * warps * 2 * 32 * 32 * per_lane)
    assert plan == K8.row_split_plan(B, Lk, H, Dh) and K8.row_split_splits(Lk, plan) == S
    assert keys % K8.ROW_SPLIT_TILE == 0 and (S - 1) * keys < Lk <= S * keys
    assert (plan.blocks - 1) * warps < B * H * S <= plan.blocks * warps
    assert B * H * S >= 6 * 132
    assert plan.smem_bytes <= H100_SMEM
    assert K8.row_split_scratch(B, H, Lk, Dh, plan) == (
        2 * B * H * S, B * H * Lk, B * H * S * Dh if S > 1 else 0)
    assert K8.forward_mode(plan, Dh) == "_rowsplit"


@pytest.mark.parametrize("B", [4, 64, 512])
@pytest.mark.parametrize("Lk", ROW_SPLIT_KEYS)
def test_attention_row_split_walk_takes_every_seen_key_once(B, Lk):
    """The split row kernels' walk at kv_len0 1, a middle value and Lk:
    every key the row sees is scored once and enters P . v once, in key
    order within its split (split s holds keys [s keys, (s + 1) keys)), and
    the splits, taken in split order, cover the seen keys in order; no key
    past them is touched."""
    plan = K8.attention_forward_plan(B, 1, Lk, 8, 64)
    for kv_len0 in (1, (Lk + 1) // 2, Lk):
        n = min(Lk, kv_len0)
        splits = _row_split_walk(Lk, kv_len0, plan)
        assert len(splits) == K8.row_split_splits(Lk, plan)
        assert np.array_equal(sum(taken for taken, _ in splits), (np.arange(Lk) < n).astype(int))
        assert [j for _, order in splits for j in order] == list(range(n))
        for s, (_, order) in enumerate(splits):
            assert all(s * plan.keys <= j < (s + 1) * plan.keys for j in order)


def test_attention_row_split_is_forced_and_refused_as_planned():
    """``split_row`` True takes the split row kernels for one query row at
    any key count (phase 2i times them at 1 x 15, 1 x 256 and 1 x 2048),
    False the row kernel past 2048 keys (its scores in shared memory, so
    past MAX_LK it no longer fits); either refuses more rows and heads past
    256 dims, which keep the wide row kernel."""
    plan = lambda Lk, Dh=64, B=512, Lq=1, **kw: K8.attention_forward_plan(B, Lq, Lk, 8, Dh, **kw)
    assert plan(15, split_row=True) == K8.ForwardPlan("row_split", 2, 32, 1, 1, 128, 1024, 65536)
    assert plan(256, B=64, split_row=True) == K8.row_split_plan(64, 256, 8, 64)
    assert plan(2048, split_row=True)[:3] == ("row_split", 2, 2048)
    assert plan(2048) == plan(2048, split_row=False) == K8.ForwardPlan(
        "row", 8, 2048, 1, 1, 128, 1024, 16 * 2048)
    assert plan(5000, split_row=False) == K8.ForwardPlan("row", 8, 5000, 1, 1, 128, 1024, 80000)
    assert plan(K8.MAX_LK + 1, split_row=False).smem_bytes > K8.SMEM_BYTES
    assert plan(K8.MAX_LK + 1, Dh=257).smem_bytes > K8.SMEM_BYTES  # the wide row kernel's
    assert plan(5000, Dh=257).kernel == "row_wide"
    for kw in ({"Lq": 2}, {"Dh": 257}):
        for split_row in (True, False):
            with pytest.raises(ValueError, match="split row"):
                plan(5000, split_row=split_row, **kw)


def test_attention_row_split_on_cpu_takes_the_plain_version():
    """CPU tensors take the plain version with ``split_row`` too, and count
    no launch."""
    rng = np.random.default_rng(24)
    q, k, v = (torch.as_tensor(rng.standard_normal((2, L, 2, 8)), dtype=torch.float32)
               for L in (1, 70, 70))
    before = (K8.attention_train_forward.launches,
              dict(K8.attention_train_forward.launches_by_mode))
    got = K8.attention_train_forward(q, k, v, 40, split_row=True)
    want = K8.attention_train_forward_plain(q, k, v, 40)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (K8.attention_train_forward.launches,
            K8.attention_train_forward.launches_by_mode) == before


def _prefix(Lk: int, t: int):
    return (jnp.arange(Lk) <= t)[None, None, None, :]


# case -> (Lq, Lk, kv_len0, the JAX mask); "_dropout" cases add dropout 0.1
MHA_CASES = {
    "decode_t3": (1, 6, 4, _prefix(6, 3)),
    "cross_3": (1, 3, None, None),
    "encoder_5x5": (5, 5, None, None),
    "causal_6": (6, 6, 1, causal_mask(6)),
    "decode_t9_of_15": (1, 15, 10, _prefix(15, 9)),
    "cross_15x3": (15, 3, None, None),
    "causal_15": (15, 15, 1, causal_mask(15)),
    "causal_80": (80, 80, 1, causal_mask(80)),
}


@pytest.mark.parametrize("case", ["decode_t3", "cross_3", "encoder_5x5", "causal_6",
                                  "decode_t9_of_15", "cross_15x3", "causal_15",
                                  "encoder_5x5_dropout", "decode_t9_of_15_dropout",
                                  "cross_3_dropout", "cross_15x3_dropout",
                                  "causal_15_dropout", "causal_80", "causal_80_dropout"])
def test_mha_attend_gradients_match_jax_grad(case, monkeypatch):
    """The CPU path differentiates: the output and the q_in, k and v
    gradients of a random linear functional of MHA.attend's output, at
    d = 32 (4 heads of 8); with dropout, JAX's keep mask is the port's."""
    from mansy_immersivevideostreaming_torch.models import transformer
    d, H, B = 32, 4, 3
    dropout = case.endswith("_dropout")
    Lq, Lk, kv_len0, mask = MHA_CASES[case.removesuffix("_dropout")]
    rng = np.random.default_rng(len(case))
    q_in = rng.normal(0, 1, (B, Lq, d)).astype(np.float32)
    kv_in = rng.normal(0, 1, (B, Lk, d)).astype(np.float32)
    cot = rng.normal(0, 1, (B, Lq, d)).astype(np.float32)
    jmha = JaxMHA(d, H)
    params = jmha.init(jax.random.PRNGKey(1), jnp.asarray(q_in), jnp.asarray(kv_in), None,
                       True)["params"]
    k, v = jmha.apply({"params": params}, jnp.asarray(kv_in), method=JaxMHA.project_kv)
    keeps = []
    bernoulli = jax.random.bernoulli

    def recorded(*a, **kw):
        out = bernoulli(*a, **kw)
        keeps.append(np.array(out))
        return out

    monkeypatch.setattr(jax.random, "bernoulli", recorded)

    def functional(q_in, k, v):
        out = jmha.apply({"params": params}, q_in, k, v, mask, not dropout,
                         method=JaxMHA.attend, rngs={"dropout": jax.random.PRNGKey(7)})
        return jnp.sum(out * cot), out

    (_, want_out), want = jax.value_and_grad(functional, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q_in), k, v)
    assert len(keeps) == int(dropout)
    keep = torch.as_tensor(keeps[0]) if dropout else None
    if dropout:
        assert keep.shape == (B, H, Lq, Lk) and 0 < float(keep.float().mean()) < 1
        monkeypatch.setattr(transformer, "keep_mask", lambda *a: keep)
    mha = MHA(d, H, device="cpu")
    mha.load_state_dict(mtio_state_dict_from_flax(jax.device_get(params), {}))
    leaves = [torch.tensor(np.asarray(a), requires_grad=True) for a in (q_in, k, v)]
    out = mha.attend(*leaves, kv_len0, torch.Generator() if dropout else None)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=RTOL,
                               atol=ATOL)
    (out * torch.as_tensor(cot)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)

    # the core: the training mode's plain version and the written-out backward
    q = mha._split(mha.query(torch.as_tensor(q_in))).detach().requires_grad_()
    kc, vc = (torch.tensor(np.asarray(a), requires_grad=True) for a in (k, v))
    keep_u8 = None if keep is None else keep.view(torch.uint8)
    o = K8.attention_plain(q, kc, vc, kv_len0, keep_u8, 0.1)
    o_train, row_max, row_sum = K8.attention_train_forward_plain(q, kc, vc, kv_len0, keep_u8,
                                                                 0.1)
    torch.testing.assert_close(o_train, o, rtol=1e-6, atol=1e-6)
    dout = torch.as_tensor(rng.normal(0, 1, o.shape).astype(np.float32))
    want_core = torch.autograd.grad(o, (q, kc, vc), dout)
    got_core = K8.attention_backward_plain(dout, q.detach(), kc.detach(), vc.detach(),
                                           o.detach(), row_max.detach(), row_sum.detach(),
                                           kv_len0, keep_u8, 0.1)
    for g, w in zip(got_core, want_core):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
    if kv_len0 is not None:  # keys no row sees get exactly 0
        unseen = slice(min(Lk, kv_len0 + Lq - 1), None)
        assert not got_core[1][:, unseen].any() and not got_core[2][:, unseen].any()


# ------------------------------------------------- K2's derived values

OFFSETS = (16, 8, 4, 2, 1)  # mansy::warp_sum's xor offsets, in its order
LANES = np.arange(32)


def warp_sum(x: np.ndarray) -> np.ndarray:
    """``common.cuh:warp_sum`` on [32] float32 lanes: each lane's result."""
    for o in OFFSETS:
        x = x + x[LANES ^ o]
    return x


def reduce_scatter(v: np.ndarray) -> np.ndarray:
    """``csrc/observe.cu:reduce_scatter`` on [32 lanes, N values] float32:
    lane t's result.  While a lane holds more than one value, offset o
    halves them (the upper half kept where bit o of the lane is set) and
    adds the partner's matching half; then the offsets left add as
    warp_sum does."""
    n = v.shape[1]
    for o in OFFSETS:
        if n > 1:
            n //= 2
            upper = ((LANES & o) != 0)[:, None]
            keep = np.where(upper, v[:, n:2 * n], v[:, :n])
            send = np.where(upper, v[:, :n], v[:, n:2 * n])
            v = keep + send[LANES ^ o]
        else:
            v = v + v[LANES ^ o]
    return v[:, 0]


def adversarial_values(rng, shape) -> np.ndarray:
    """float32 over 12 decades, both signs, with signed zeros and exact
    cancellations."""
    x = (rng.choice([-1.0, 1.0], shape) * 10.0 ** rng.uniform(-6, 6, shape)).astype(np.float32)
    x[rng.random(shape) < 0.1] = 0.0
    x[rng.random(shape) < 0.1] = -0.0
    pairs = rng.random(shape) < 0.1
    x[pairs] = -np.roll(x, 1, axis=0)[pairs]
    return x


@pytest.mark.parametrize("V", [30, 16, 8, 4])
def test_derived_reduce_scatter_keeps_the_butterflys_bits(V):
    """Every value the reduce-scatter leaves on lane t (value t >> (5 -
    log2 N), N the count padded to a power of two) has the bits of
    warp_sum's butterfly on that value, on 200 seeded trials."""
    N = 1 << (V - 1).bit_length()
    shift = 5 - (N.bit_length() - 1)
    rng = np.random.default_rng(V)
    for trial in range(200):
        v = np.zeros((32, N), np.float32)
        v[:, :V] = adversarial_values(rng, (32, V)) if trial % 2 else \
            rng.standard_normal((32, V)).astype(np.float32)
        got = reduce_scatter(v)
        want = np.stack([warp_sum(v[:, i]) for i in range(N)])  # [N, 32]
        assert (want.view(np.uint32) == want[:, :1].view(np.uint32)).all()  # every lane alike
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want[LANES >> shift, 0].view(np.uint32))


@pytest.mark.parametrize("group", [32, 128])
def test_derived_values_assignment_puts_each_sum_where_it_is_read(group):
    """The kernel's assignment at one warp a lane and at four: warp w takes
    actions w, w + W, ...; its k-th action's size is first-pass value 2k,
    its sum vp q value 2k + 1, its sum vp |q - qual| second-pass value k.
    The lane that writes the action ((j & (2 << shift) - 1) == 1 << shift)
    holds value 2k + 1 and value k, its partner j ^ (1 << shift) value 2k,
    the qual's broadcast lane (2k + 1) << shift value 2k + 1; every action
    is written by exactly one lane of one warp."""
    A, W = 15, group // 32
    per = -(-A // W)
    slots = 1 << (per - 1).bit_length()
    shift = 4 - (slots.bit_length() - 1)
    assert 32 >> shift == 2 * slots
    writers = {}
    for w in range(W):
        for j in range(32):
            k = j >> (shift + 1)
            act = w + k * W
            if (j & ((2 << shift) - 1)) != (1 << shift) or act >= A:
                continue
            writers.setdefault(act, []).append((w, j))
            assert j >> shift == 2 * k + 1                 # its sum vp q, divided into qual
            assert (j ^ (1 << shift)) >> shift == 2 * k    # the partner's: the size
            assert ((2 * k + 1) << shift) >> shift == 2 * k + 1  # the broadcast lane's qual
    assert sorted(writers) == list(range(A)) and all(len(v) == 1 for v in writers.values())
    assert sorted({k for k in range(slots) for w in range(W) if w + k * W < A}) == \
        list(range(per))
