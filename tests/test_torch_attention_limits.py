"""K8 past its earlier card limits, on the CPU: the shapes the JAX MTIO takes
through its normal flags, against the JAX package.

``--his-window`` and ``--fut-window`` reach up to 5000 keys (the positional
table, ``sinusoidal_pe(5000, d_model)``, is the only bound on either side)
and ``--hidden-dim`` past 2048 makes heads wider than 256 dims (8 heads of
``d_model // 8``).  The card kernels' plans at those shapes are walked in
``test_torch_kernel_plans.py``; here the plain versions the CPU runs are
held to JAX:

* K8's plain version inside ``MHA.attend`` (output and the q_in, k and v
  gradients of a linear functional, ``jax.grad``) over 5000 keys (B 1, 3
  query rows, 2 heads of 4, full and causal) and at heads of 320 and 512
  dims (B 1, 5 rows over 7 keys, 2 heads), with the written-out backward
  (``attention_backward_plain``) against autograd: rtol 1e-5 (atol 1e-6,
  for entries that cancel to near 0).
* The port's MTIO against the JAX module in one ``sample`` and one
  ``_train_step`` (loss, gradients, the parameters after AdamW, the
  distillation's batch statistics), dropout off as in
  ``test_torch_vp_train.py`` (its helpers): at ``--hidden-dim 2560`` (heads
  of 320, one block, fut 2, B 2) and at ``--his-window 2100`` (d 32, fut 2,
  B 2; the decoder's cross-attention sees the distilled 1050).
  Tolerances as ``test_torch_vp_train.py``'s.
* Both packages refuse a history of 5001 steps at the positional table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mansy_immersivevideostreaming_tpu.models import mtio as jax_mtio
from mansy_immersivevideostreaming_tpu.models import vp_train as JV
from mansy_immersivevideostreaming_tpu.models.transformer import MHA as JaxMHA
from mansy_immersivevideostreaming_torch.kernels import attention as K8
from mansy_immersivevideostreaming_torch.models import vp_train as TV
from mansy_immersivevideostreaming_torch.models.mtio import ViewportTransformerMTIO
from mansy_immersivevideostreaming_torch.models.transformer import MHA
from mansy_immersivevideostreaming_torch.utils.checkpoint import (
    flatten_params, mtio_flax_from_module, mtio_flax_tensors, mtio_state_dict_from_flax,
)
from test_torch_vp_train import (  # noqa: F401 (_jax_dropout_off: the module's autouse fixture)
    LR, _jax_dropout_off, check_params_after_adamw, close, close_tree, fresh_jit,
    jax_step_parts, recording_slots,
)

CORE_RTOL, CORE_ATOL = 1e-5, 1e-6

# case -> (heads, dims a head, query rows, keys, kv_len0): the port's prefix
# mask, JAX's as a bool mask of the same keys
CORE_CASES = {
    "keys_5000": (2, 4, 3, 5000, None),
    "keys_5000_causal": (2, 4, 3, 5000, 1),
    "dh_320": (2, 320, 5, 7, None),
    "dh_512": (2, 512, 5, 7, None),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("case", list(CORE_CASES))
def test_attention_core_matches_jax_past_the_card_limits(case):
    """MHA.attend through K8's plain version against JAX's MHA.attend and
    jax.grad; the training mode's plain version and the written-out
    backward against autograd, keys no row sees exactly 0."""
    H, Dh, Lq, Lk, kv_len0 = CORE_CASES[case]
    d, B = H * Dh, 1
    rng = np.random.default_rng(Lk + Dh)
    q_in = rng.normal(0, 1, (B, Lq, d)).astype(np.float32)
    kv_in = rng.normal(0, 1, (B, Lk, d)).astype(np.float32)
    cot = rng.normal(0, 1, (B, Lq, d)).astype(np.float32)
    mask = None
    if kv_len0 is not None:
        seen = np.minimum(Lk, kv_len0 + np.arange(Lq))
        mask = jnp.asarray(np.arange(Lk)[None, :] < seen[:, None])[None, None]
    jmha = JaxMHA(d, H)
    params = jmha.init(jax.random.PRNGKey(1), jnp.asarray(q_in), jnp.asarray(kv_in), None,
                       True)["params"]
    k, v = jmha.apply({"params": params}, jnp.asarray(kv_in), method=JaxMHA.project_kv)

    def functional(q_in, k, v):
        out = jmha.apply({"params": params}, q_in, k, v, mask, True, method=JaxMHA.attend)
        return jnp.sum(out * cot), out

    (_, want_out), want = jax.value_and_grad(functional, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q_in), k, v)
    mha = MHA(d, H, device="cpu")
    mha.load_state_dict(mtio_state_dict_from_flax(jax.device_get(params), {}))
    leaves = [torch.tensor(np.asarray(a), requires_grad=True) for a in (q_in, k, v)]
    out = mha.attend(*leaves, kv_len0, None)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=CORE_RTOL,
                               atol=CORE_ATOL)
    (out * torch.as_tensor(cot)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=CORE_RTOL,
                                   atol=CORE_ATOL)

    q = mha._split(mha.query(torch.as_tensor(q_in))).detach().requires_grad_()
    kc, vc = (torch.tensor(np.asarray(a), requires_grad=True) for a in (k, v))
    o = K8.attention_plain(q, kc, vc, kv_len0)
    o_train, row_max, row_sum = K8.attention_train_forward_plain(q, kc, vc, kv_len0)
    torch.testing.assert_close(o_train, o, rtol=1e-6, atol=1e-6)
    dout = torch.as_tensor(rng.normal(0, 1, o.shape).astype(np.float32))
    want_core = torch.autograd.grad(o, (q, kc, vc), dout)
    got_core = K8.attention_backward_plain(dout, q.detach(), kc.detach(), vc.detach(),
                                           o.detach(), row_max, row_sum, kv_len0)
    for g, w in zip(got_core, want_core):
        torch.testing.assert_close(g, w, rtol=CORE_RTOL, atol=CORE_ATOL)
    if kv_len0 is not None:
        unseen = slice(min(Lk, kv_len0 + Lq - 1), None)
        assert not got_core[1][:, unseen].any() and not got_core[2][:, unseen].any()


# case -> (the JAX and port MTIO's widths, his_window): run_models at
# --hidden-dim 2560 --block-num 1 and at --his-window 2100, fut 2
MTIO_CASES = {
    "hidden_2560": (dict(d_model=2560, dim_feedforward=2560, fut_window=2,
                         num_encoder_layers=1, num_decoder_layers=1), 5),
    "his_window_2100": (dict(d_model=32, dim_feedforward=32, fut_window=2), 2100),
}


@pytest.mark.parametrize("case", list(MTIO_CASES))
def test_mtio_sample_and_train_step_match_jax_past_the_card_limits(case):
    """One ``sample`` and one ``_train_step`` (dropout off) of the JAX MTIO
    against the port's, from the JAX package's seeded train state: the
    predictions, the loss, every gradient, the parameters after AdamW and
    the distillation's batch statistics."""
    cfg, his = MTIO_CASES[case]
    jm = jax_mtio.ViewportTransformerMTIO(**cfg, dropout=0.0)
    opt = JV.make_optimizer(LR)
    state = jax.jit(lambda key: JV.create_train_state(jm, key, 5, opt))(jax.random.PRNGKey(4))
    rng = np.random.default_rng(his)
    B, F = 2, cfg["fut_window"]
    batch = {"history": rng.random((B, his, 2), dtype=np.float32),
             "current": rng.random((B, 1, 2), dtype=np.float32),
             "future": rng.random((B, F, 2), dtype=np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    model = ViewportTransformerMTIO(**cfg, dropout=0.0, transformer_dropout=0.0, device="cpu")
    model.load_state_dict(mtio_state_dict_from_flax(jax.device_get(state.params),
                                                    jax.device_get(state.batch_stats)))

    want = JV.sample_step(jm, state, jbatch["history"], jbatch["current"])
    got = TV.sample_step(model, torch.as_tensor(batch["history"]),
                         torch.as_tensor(batch["current"]))  # no_grad: the weights stay
    assert got.shape == (B, F, 2)
    close(got, want)

    with recording_slots() as slots:
        loss, (pred, _, stats), grads = fresh_jit(jax_step_parts, jm)(
            state, jbatch, jax.random.PRNGKey(5))
        jax.effects_barrier()
    updates, _ = jax.jit(opt.update)(grads, state.opt_state, state.params)
    new_params = jax.jit(optax.apply_updates)(state.params, updates)
    # the port's train_step, a part at a time: the training forward and its
    # gradients, then the AdamW update of them
    pred_t, gt_t = model(*(torch.as_tensor(batch[k]) for k in ("history", "current", "future")),
                         train=True, perms=slots["perm"][0], repeat=slots["repeat"][0],
                         generator=torch.Generator().manual_seed(0))
    got_loss = model.loss_function(pred_t, gt_t)
    params = list(model.parameters())
    got_grads = torch.autograd.grad(got_loss, params)
    close(pred_t, pred)
    close(got_loss, loss)
    flax_grads = mtio_flax_tensors(model, got_grads)
    close_tree(flax_grads, grads)
    with torch.no_grad():
        TV.adamw_update(TV.make_optimizer(LR), params, got_grads, TV.create_train_state(model))
    check_params_after_adamw(model, new_params, flatten_params(jax.device_get(grads)),
                             flax_grads)
    close_tree(mtio_flax_from_module(model).batch_stats, stats, atol=1e-6, rtol=1e-5)


def test_both_packages_refuse_a_history_past_the_positional_table():
    """5001 history steps: JAX's embedding adds a [1, 5000, d] table to a
    [B, 5001, d] input and raises, and so does the port's; 5000 is the
    longest window either takes."""
    cfg = dict(d_model=32, dim_feedforward=32, fut_window=2)
    jm = jax_mtio.ViewportTransformerMTIO(**cfg, dropout=0.0)
    state = jax.jit(lambda key: JV.create_train_state(jm, key, 5, JV.make_optimizer(LR)))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    h = rng.random((1, 5001, 2), dtype=np.float32)
    c = rng.random((1, 1, 2), dtype=np.float32)
    with pytest.raises((TypeError, ValueError)):
        jm.apply({"params": state.params, "batch_stats": state.batch_stats}, jnp.asarray(h),
                 jnp.asarray(c), method=jax_mtio.ViewportTransformerMTIO.sample)
    model = ViewportTransformerMTIO(**cfg, dropout=0.0, device="cpu")
    assert model.pe.shape[0] == 5000
    with pytest.raises(RuntimeError, match="5001"):
        model.sample(torch.as_tensor(h), torch.as_tensor(c))
