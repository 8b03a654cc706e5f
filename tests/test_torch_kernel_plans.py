"""The launch plan the K10 wrapper computes in Python, K8's refusal of
gradients, and the gradients of ``MHA.attend`` on the CPU.

* ``backward_plan`` (K10): launch A's column groups cover every 128-column
  block with none empty; launch B's depth slices are the largest cluster
  size that splits its 64-row tile evenly and that the batch's 32-deep
  stages fill; the shapes taken at the paths' batches (512 and 4096 rows)
  on a 132-SM card.
* ``refuse_grad``: raises with grad enabled and any of q, k, v requiring
  grad, and passes under ``torch.no_grad()`` or with none requiring it.
* ``MHA.attend`` on the CPU (K8's plain version) gives q_in, k and v
  gradients equal to ``jax.grad`` of the JAX ``MHA.attend`` at d = 32 in the
  four mask shapes.  Tolerance as ``test_torch_mtio.py``'s: atol 2e-5, rtol
  2e-4 (sums in other orders).
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


# -------------------------------------------------------------------- K8

@pytest.mark.parametrize("needs", ["q", "k", "v"])
def test_refuse_grad_refuses_tensors_that_need_the_backward(needs):
    q, k, v = (torch.zeros(2, 1, 8, 4, requires_grad=name == needs) for name in "qkv")
    with pytest.raises(RuntimeError, match="no backward"):
        K8.refuse_grad(torch.is_grad_enabled(), q, k, v)
    with torch.no_grad():
        K8.refuse_grad(torch.is_grad_enabled(), q, k, v)
    K8.refuse_grad(False, q, k, v)


def test_refuse_grad_passes_tensors_that_need_no_gradient():
    q, k, v = (torch.zeros(2, 1, 8, 4) for _ in range(3))
    K8.refuse_grad(True, q, k, v)


@pytest.mark.parametrize("case", ["decode_t3", "cross_3", "encoder_5x5", "causal_6"])
def test_mha_attend_gradients_match_jax_grad(case):
    """The CPU path differentiates: q_in, k and v gradients of a random
    linear functional of MHA.attend's output, at d = 32 (4 heads of 8)."""
    d, H, B = 32, 4, 3
    Lq, Lk, kv_len0, mask = {
        "decode_t3": (1, 6, 4, (jnp.arange(6) <= 3)[None, None, None, :]),
        "cross_3": (1, 3, None, None),
        "encoder_5x5": (5, 5, None, None),
        "causal_6": (6, 6, 1, causal_mask(6)),
    }[case]
    rng = np.random.default_rng(len(case))
    q_in = rng.normal(0, 1, (B, Lq, d)).astype(np.float32)
    kv_in = rng.normal(0, 1, (B, Lk, d)).astype(np.float32)
    cot = rng.normal(0, 1, (B, Lq, d)).astype(np.float32)
    jmha = JaxMHA(d, H)
    params = jmha.init(jax.random.PRNGKey(1), jnp.asarray(q_in), jnp.asarray(kv_in), None,
                       True)["params"]
    k, v = jmha.apply({"params": params}, jnp.asarray(kv_in), method=JaxMHA.project_kv)

    def functional(q_in, k, v):
        out = jmha.apply({"params": params}, q_in, k, v, mask, True, method=JaxMHA.attend)
        return jnp.sum(out * cot)

    want = jax.grad(functional, argnums=(0, 1, 2))(jnp.asarray(q_in), k, v)
    mha = MHA(d, H, device="cpu")
    mha.load_state_dict(mtio_state_dict_from_flax(jax.device_get(params), {}))
    leaves = [torch.tensor(np.asarray(a), requires_grad=True) for a in (q_in, k, v)]
    (mha.attend(*leaves, kv_len0) * torch.as_tensor(cot)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
