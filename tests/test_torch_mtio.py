"""Port parity: the MTIO viewport model's serving path and K8's plain version.

Weights come from the JAX package's seeded ``vp_train.create_train_state``
(with BatchNorm statistics moved off their initial 0 and 1, so the
distillation layer's running statistics matter) and are carried across by
``mtio_state_dict_from_flax``; inputs are numpy draws handed to both.

* K8's plain version inside ``MHA.attend`` against the JAX ``MHA.attend``
  at the full head width (8 x 64) in the four shapes the paths run: decode
  self-attention over a 15-slot cache at several t, cross-attention over 3
  keys, the encoder's 5 x 5 and the causal 16 x 16 of the fixed-buffer
  decode;
* the encoder, the causal decode, ``decode_step`` over all steps and
  ``sample`` against ``vp_train.sample_step``, at d = 32 (fut 5) and at the
  full width (d = 512, 8 x 64 heads, 2 + 2 layers, fut 15, B = 8);
* the fixed-buffer decode (``incremental=False``) against the KV-cached one
  in the port; ``loss_function`` and ``valid_step``;
* ``linear_regression_sample`` against JAX;
* the npz round trip: the port's npz applied by the JAX Flax module gives
  the port's outputs;
* the forward without training (every slot the input) against the JAX
  ``__call__(train=False)``; in training (dropout 0), the incremental
  decode with its out-of-place caches against the fixed-buffer decode:
  predictions and gradients.

Tolerance: atol 2e-5 and rtol 2e-4, the bound of the JAX package's own
decode-equivalence test (``tests/test_mtio.py:81-82``).  The sums run in
other orders, and Flax's LayerNorm takes the variance as E[x^2] - E[x]^2
where torch's takes E[(x - mean)^2]; both stay well inside it.

:func:`orbax_mtio_to_npz` turns a JAX ``run_models`` checkpoint into the
port's npz (``tests/test_torch_vp_cli.py`` uses it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mansy_immersivevideostreaming_tpu.models import ViewportTransformerMTIO as JaxMTIO
from mansy_immersivevideostreaming_tpu.models import linear_regression_sample as jax_regression
from mansy_immersivevideostreaming_tpu.models.transformer import MHA as JaxMHA
from mansy_immersivevideostreaming_tpu.models.transformer import causal_mask
from mansy_immersivevideostreaming_tpu.models.vp_train import (
    create_train_state, make_optimizer, sample_step, valid_step,
)
from mansy_immersivevideostreaming_tpu.utils.checkpoint import restore_checkpoint
from mansy_immersivevideostreaming_torch.models import vp_train as TV
from mansy_immersivevideostreaming_torch.models.mtio import ViewportTransformerMTIO
from mansy_immersivevideostreaming_torch.models.regression import linear_regression_sample
from mansy_immersivevideostreaming_torch.models.transformer import MHA
from mansy_immersivevideostreaming_torch.utils.checkpoint import (
    flatten_params, load_mtio_npz, load_mtio_npz_into, mtio_state_dict_from_flax,
    save_mtio_npz, write_mtio_npz,
)

ATOL, RTOL = 2e-5, 2e-4
SMALL = dict(d_model=32, dim_feedforward=32, fut_window=5)
FULL = dict(d_model=512, dim_feedforward=512, fut_window=15)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def orbax_mtio_to_npz(ckpt_path: str, npz_path: str, model: JaxMTIO, his_window: int) -> None:
    """Write the params and ``batch_stats`` of an Orbax MTIO checkpoint (a JAX
    ``VPTrainState``, as ``run_models --train`` saves it) as the port's
    Flax-keyed npz."""
    template = create_train_state(model, jax.random.PRNGKey(0), his_window, make_optimizer(1e-4))
    state = restore_checkpoint(ckpt_path, template)
    write_mtio_npz(npz_path, jax.device_get(state.params), jax.device_get(state.batch_stats))


def flax_variables(npz_path) -> dict:
    """A port MTIO npz as the nested ``{"params", "batch_stats"}`` Flax applies."""
    nested = {}
    with np.load(npz_path) as npz:
        for key in npz.files:
            *scopes, leaf = key.split("/")
            node = nested
            for s in scopes:
                node = node.setdefault(s, {})
            node[leaf] = jnp.asarray(npz[key])
    return nested


def jax_state(cfg: dict, seed: int = 0):
    """A seeded JAX MTIO and its train state, BatchNorm statistics moved to
    mean ~U(-0.3, 0.3), var ~U(0.5, 1.5)."""
    model = JaxMTIO(**cfg)
    init = jax.jit(lambda key: create_train_state(model, key, 5, make_optimizer(1e-3)))
    state = init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
    bn = stats["transformer"]["distill"]["BatchNorm_0"]
    bn["mean"] = rng.uniform(-0.3, 0.3, bn["mean"].shape).astype(np.float32)
    bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    return model, state._replace(batch_stats=stats)


def port_model(state, cfg: dict, **kw) -> ViewportTransformerMTIO:
    model = ViewportTransformerMTIO(**cfg, device="cpu", **kw)
    model.load_state_dict(mtio_state_dict_from_flax(jax.device_get(state.params),
                                                    state.batch_stats))
    return model


def variables(state) -> dict:
    return {"params": state.params, "batch_stats": state.batch_stats}


def inputs(rng, B: int, M: int = 5):
    return (rng.random((B, M, 2), dtype=np.float32), rng.random((B, 1, 2), dtype=np.float32))


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def small():
    return jax_state(SMALL)


# ------------------------------------------------------------------- K8

@pytest.mark.parametrize("case", ["decode_t0", "decode_t7", "decode_t14", "cross_3",
                                  "encoder_5x5", "causal_16"])
def test_attention_core_matches_jax_mha_attend(case):
    d, H, B = 512, 8, 4
    Lq, Lk, kv_len0, mask = {
        "decode_t0": (1, 15, 1, (jnp.arange(15) <= 0)[None, None, None, :]),
        "decode_t7": (1, 15, 8, (jnp.arange(15) <= 7)[None, None, None, :]),
        "decode_t14": (1, 15, 15, (jnp.arange(15) <= 14)[None, None, None, :]),
        "cross_3": (1, 3, None, None),
        "encoder_5x5": (5, 5, None, None),
        "causal_16": (16, 16, 1, causal_mask(16)),
    }[case]
    rng = np.random.default_rng(len(case))
    q_in = rng.normal(0, 1, (B, Lq, d)).astype(np.float32)
    kv_in = rng.normal(0, 1, (B, Lk, d)).astype(np.float32)
    jmha = JaxMHA(d, H)
    params = jmha.init(jax.random.PRNGKey(3), jnp.asarray(q_in), jnp.asarray(kv_in), None,
                       True)["params"]
    k, v = jmha.apply({"params": params}, jnp.asarray(kv_in), method=JaxMHA.project_kv)
    want = jmha.apply({"params": params}, jnp.asarray(q_in), k, v, mask, True,
                      method=JaxMHA.attend)
    mha = MHA(d, H, device="cpu")
    mha.load_state_dict(mtio_state_dict_from_flax(jax.device_get(params), {}))
    tk, tv = mha.project_kv(torch.as_tensor(kv_in))
    close(tk, k)
    close(tv, v)
    got = mha.attend(torch.as_tensor(q_in), torch.as_tensor(np.array(k)),
                     torch.as_tensor(np.array(v)), kv_len0)
    assert got.shape == (B, Lq, d)
    close(got, want)


# ------------------------------------------------------------ the model

def test_encoder_decoder_and_decode_steps_match_jax(small):
    jm, state = small
    model = port_model(state, SMALL)
    rng = np.random.default_rng(1)
    B, F = 4, SMALL["fut_window"]
    src = rng.normal(0, 1, (B, 5, 32)).astype(np.float32)
    tgt = rng.normal(0, 1, (B, 1 + F, 32)).astype(np.float32)
    jmem = jm.apply(variables(state), jnp.asarray(src),
                    method=lambda m, s: m.transformer.encode(s, True))
    mem = model.transformer.encode(torch.as_tensor(src))
    assert mem.shape == (B, 3, 32)
    close(mem, jmem)
    jdec = jm.apply(variables(state), jnp.asarray(tgt), jmem,
                    method=lambda m, t, mm: m.transformer.decode(t, mm, causal_mask(1 + F), True))
    with torch.no_grad():
        dec = model.transformer.decode(torch.as_tensor(tgt), torch.as_tensor(np.array(jmem)),
                                       kv_len0=1)
        close(dec, jdec)
        # decode_step over every position == the causal decode's columns
        mem_kvs, caches = model.transformer.init_decode_cache(torch.as_tensor(np.array(jmem)),
                                                              1 + F)
        for t in range(1 + F):
            out = model.transformer.decode_step(torch.as_tensor(tgt[:, t:t + 1]), caches, t,
                                                mem_kvs)
            close(out[:, 0], np.asarray(jdec)[:, t])


@pytest.mark.parametrize("width", ["small", "full"])
def test_sample_matches_jax_sample_step(width, small):
    cfg, B = (SMALL, 4) if width == "small" else (FULL, 8)
    jm, state = small if width == "small" else jax_state(FULL, seed=2)
    model = port_model(state, cfg)
    h, c = inputs(np.random.default_rng(5), B)
    want = sample_step(jm, state, jnp.asarray(h), jnp.asarray(c))
    got = TV.sample_step(model, torch.as_tensor(h), torch.as_tensor(c))
    assert got.shape == (B, cfg["fut_window"], 2)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    close(got, want)


def test_buffer_decode_matches_incremental_decode(small):
    _, state = small
    fast, slow = port_model(state, SMALL), port_model(state, SMALL, incremental=False)
    h, c = (torch.as_tensor(x) for x in inputs(np.random.default_rng(7), 6))
    torch.testing.assert_close(slow.sample(h, c), fast.sample(h, c), rtol=RTOL, atol=ATOL)


def test_loss_and_valid_step_match_jax(small):
    jm, state = small
    model = port_model(state, SMALL)
    rng = np.random.default_rng(9)
    B, F = 8, SMALL["fut_window"]
    pred = rng.random((B, F, 6), dtype=np.float32)
    gt = rng.random((B, F, 6), dtype=np.float32)
    want = jm.apply(variables(state), jnp.asarray(pred), jnp.asarray(gt), method="loss_function")
    close(model.loss_function(torch.as_tensor(pred), torch.as_tensor(gt)), want)
    h, c = inputs(rng, B)
    f = rng.random((B, F, 2), dtype=np.float32)
    want = valid_step(jm, state, {"history": jnp.asarray(h), "current": jnp.asarray(c),
                                  "future": jnp.asarray(f)})
    got = TV.valid_step(model, {"history": torch.as_tensor(h), "current": torch.as_tensor(c),
                                "future": torch.as_tensor(f)})
    close(got, want)


def test_linear_regression_matches_jax():
    rng = np.random.default_rng(4)
    h, c = inputs(rng, 16)
    want = jax_regression(jnp.asarray(h), jnp.asarray(c), 15)
    got = linear_regression_sample(torch.as_tensor(h), torch.as_tensor(c), 15)
    assert got.shape == (16, 15, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_npz_round_trip_into_the_flax_module(small, tmp_path):
    jm, state = small
    model = port_model(state, SMALL)
    with torch.no_grad():  # weights the JAX init never had
        for p in model.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
        model.transformer.distill.bn.running_var.mul_(1.5)
    path = tmp_path / "mtio.npz"
    save_mtio_npz(path, model)
    loaded = load_mtio_npz(path)
    want_keys = set(flatten_params(jax.device_get(state.params)))
    assert set(loaded.params) == want_keys
    assert set(loaded.batch_stats) == {"transformer/distill/BatchNorm_0/mean",
                                       "transformer/distill/BatchNorm_0/var"}
    h, c = inputs(np.random.default_rng(11), 5)
    got = model.sample(torch.as_tensor(h), torch.as_tensor(c))
    want = jm.apply(flax_variables(path), jnp.asarray(h), jnp.asarray(c),
                    method=JaxMTIO.sample)
    close(got, want)
    again = ViewportTransformerMTIO(**SMALL, device="cpu")
    load_mtio_npz_into(again, path)
    for (name, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


# ------------------------------------------------------- training forward

@pytest.mark.parametrize("teacher_forcing", [False, True])
def test_forward_without_training_matches_jax_call(teacher_forcing, small):
    """``forward(train=False)``: every slot the input, deterministic, the
    autoregressive decode whatever ``teacher_forcing`` says, as the JAX
    ``__call__(train=False)``."""
    _, state = small
    jm = JaxMTIO(**SMALL, teacher_forcing=teacher_forcing)
    model = port_model(state, SMALL, teacher_forcing=teacher_forcing)
    rng = np.random.default_rng(13)
    h, c = inputs(rng, 5)
    f = rng.random((5, SMALL["fut_window"], 2), dtype=np.float32)
    want_pred, want_gt = jm.apply(variables(state), jnp.asarray(h), jnp.asarray(c),
                                  jnp.asarray(f), train=False)
    with torch.no_grad():
        pred, gt = model(*(torch.as_tensor(x) for x in (h, c, f)), train=False)
    close(pred, want_pred)
    close(gt, want_gt)


def test_training_decodes_agree_in_predictions_and_gradients(small):
    """In training at dropout 0 with grad enabled, the KV-cached decode
    (``decode_step_train``, its caches out of place) equals the fixed-buffer
    decode's predictions and parameter gradients: the gradient flows
    through the fed-back predictions in both."""
    _, state = small
    rng = np.random.default_rng(14)
    h, c = inputs(rng, 6)
    f = rng.random((6, SMALL["fut_window"], 2), dtype=np.float32)
    perms = np.stack([rng.permutation(6), rng.permutation(6)])
    results = []
    for incremental in (True, False):
        model = port_model(state, SMALL, incremental=incremental, dropout=0.0,
                           transformer_dropout=0.0)
        pred, gt = model(*(torch.as_tensor(x) for x in (h, c, f)), perms=perms, repeat=False,
                         generator=torch.Generator().manual_seed(0))
        loss = model.loss_function(pred, gt)
        results.append((pred.detach(), torch.autograd.grad(loss, list(model.parameters()))))
    (p1, g1), (p2, g2) = results
    torch.testing.assert_close(p1, p2, rtol=RTOL, atol=ATOL)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
