"""Port parity: the MTIO model's bf16 compute mode (``run_models --bf16``)
against the JAX package's ``dtype=jnp.bfloat16`` on the CPU.

The JAX package has no test of its bf16 path; these are its first checks.
Rounding points: ``jax.grad`` of ``MHA.attend`` at bf16 (its
``jax.make_jaxpr``, JAX 0.9 on the CPU) converts, in order:
  forward   q_in -> bf16 (query's input), the query/out kernels and biases
            -> bf16, P -> bf16 (``p.astype(v.dtype)``), the out Dense's
            product and sum -> bf16; the score product's
            ``preferred_element_type=f32`` and the softmax stay f32;
  backward  the cotangent of the output -> bf16; dP' = dO . V^T and dV =
            P'^T . dO are bf16 products (each an f32 sum rounded once); dP'
            -> f32 for the softmax's gradient, which runs in f32 from it
            (D = sum_k g_k P_k); dK and dQ are f32 products of the f32 dS
            with the upcast q and k, each rounded to bf16 once; the q_in
            cotangent from the query Dense's bf16 product -> f32.
K8's plain version (``kernels/attention.py``) follows that list: its
autograd rounds at the same points, and ``attention_backward_plain``
writes them out.  One rounding point of XLA's CPU backend differs from the
jaxpr, and the port follows XLA (ROADMAP Queue 3, "not port faults"): where
an f32 op takes a bf16 Dense's output (the residual adds after the out
projection and the feed-forward, the positional encoding after the
embedding, BatchNorm after the distillation conv), XLA drops the bias sum's
round trip through bf16 (``xla_allow_excess_precision``): the product is
rounded, the bf16 bias added in f32, the sum kept f32
(``models/transformer.py:Dense``, ``f32_sum``).  Without that, the port's
d = 32 predictions sit at 0.85 of the f32-to-bf16 gap from JAX's bf16 ones
with nonzero biases; with it at 0.003.

Cases, each against the JAX bf16 result and the JAX f32 result of the same
weights and inputs (the biases moved off Flax's zeros):

* K8 inside ``MHA.attend``: output and the q_in, k and v gradients, in the
  shapes of ``test_torch_mtio.py`` (d = 512, 8 x 64: decode over the
  15-slot cache at t = 0, 7, 14, cross 1 x 3, the encoder's 5 x 5, causal
  16 x 16) and of ``test_torch_kernel_plans.py`` (d = 32, 4 x 8: its eight
  training shapes, with JAX's own dropout keep mask at 0.1 in five); the
  written-out backward against the plain version's autograd at the core;
* ``sample`` at d = 32 (fut 5) and at d = 512 (8 x 64, 2 + 2 layers, fut
  15, B 4) against ``vp_train.sample_step`` of the JAX bf16 model, and
  that d = 512 chain a stage at a time from the JAX bf16 stage's input;
* in ``tests/test_torch_bf16_train.py`` (a file of its own, so that the
  suite's workers run the two halves side by side): one ``_train_step`` at
  d = 32 in both decode modes (dropout off by the Transformer swap of
  ``test_torch_vp_train.py``, the JAX step's recorded slot draws): loss,
  each batch row's loss, gradients, parameters after AdamW; ``run_models
  --train --test --bf16`` beside the JAX CLI on the synthetic tree: the
  same file set and console lines; the port's ``--test --bf16`` on the JAX
  CLI's trained model against the JAX CLI's results; ``--teacher-forcing
  --bf16`` and ``--resume --bf16`` (the step and AdamW count go on).

Tolerances (bf16 has 8 significant bits: an ulp is at most 2^-7 of its
value): each K8 value within BF16_RTOL = 2^-6 (two ulps) of the JAX bf16
value plus that share of the tensor's largest magnitude (where a sum
cancels, one ulp of a summand is many of the sum); measured at most 0.3% of
the largest magnitude (flips where XLA and torch sum in another order and
round the other way).  ``sample``'s predictions carry such flips through
the layers and the fed-back decode steps: SAMPLE_ATOL = 5e-3, measured
2.6e-5 at d = 32 and 1.7e-3 at d = 512, against f32-to-bf16 gaps of 3.6e-3
and 1.8e-3.  The train step: the loss to BF16_RTOL (measured 4.4e-5
relative), each gradient entry within GRAD_ATOL_SHARE = 10% of the step's
largest (measured 5.3%, at the distillation conv's kernel, whose
f32-to-bf16 gap reaches 45%); after AdamW (about lr * sign(g) an entry) the
parameters to ``test_torch_vp_train.py``'s PARAM_ATOL wherever both
gradients are at least ADAM_GRAD_FLOOR and share their sign (optax's step
and the port's then differ by at most lr * eps / floor = 1e-6), the
gradients' signs differing on at most NOISY_SHARE = 5% (measured 1.5% and
0.7%: gradients that are noise at bf16, as the key biases', which softmax
ignores).

Each module-level case shows that the bf16 path is the one running: the
root mean square of (port - JAX bf16) is at most GAP_SHARE = 1/4 of that
of (JAX f32 - JAX bf16).  Measured: K8 at most 0.03 (0 in 14 of 19 cases),
``sample`` at d = 32 0.0025; the d = 512 stages 9e-6 (embedding), 2.7e-5
and 2.7e-5 (encoder layers), 0.0032 (norm and distillation), 1.3e-5
(target embedding), 0.048 and 0.105 (decoder layers); the train step's
gradients 0.10 and 0.11, its batch rows' losses 0.049 and 0.099.  Two
quantities are not held to it, for one cause.  ``sample``'s whole chain at
d = 512 reads 0.64: its stages each read at most 0.105 from JAX's input,
but the port's embedding, equal to JAX's to f32 rounding (276 of its
10,240 entries an f32 ulp apart, at most 2.4e-7), rounds one entry to bf16
the other way at the first layer's projections, and
that one flip alone moves the first encoder layer's output to 0.29 of its
gap (2.7e-5 from JAX's own embedding); every such flip where the two sum
512 terms in another order grows through the 4 layers as far as the
f32-to-bf16 roundings themselves reach.  The train step's scalar loss
(0.31 and 0.58) is the mean of its rows', whose f32-to-bf16 gaps cancel
in the mean (3.5e-5) while one row's flip does not (the other seven rows
equal to 1e-7); its rows are held to 1/4 instead.  Both keep "nearer JAX's
bf16 result than its f32 one" (the whole chain) or BF16_RTOL (the scalar
loss).  A check of the rule: the port with its Dense products left
unrounded (a half-rounded path) reads 1.2 on the rows' losses and fails
the stages and both ``sample`` cases.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mansy_immersivevideostreaming_tpu.models import ViewportTransformerMTIO as JaxMTIO
from mansy_immersivevideostreaming_tpu.models import vp_train as JV
from mansy_immersivevideostreaming_tpu.models.transformer import MHA as JaxMHA
from mansy_immersivevideostreaming_tpu.models.transformer import causal_mask
from mansy_immersivevideostreaming_torch.kernels import attention as K8
from mansy_immersivevideostreaming_torch.models import transformer
from mansy_immersivevideostreaming_torch.models.transformer import MHA
from mansy_immersivevideostreaming_torch.utils.checkpoint import mtio_state_dict_from_flax
from test_torch_kernel_plans import MHA_CASES
from test_torch_mtio import jax_state, port_model, variables

BF = torch.bfloat16
BF16_RTOL = 2.0 ** -6
SAMPLE_ATOL = 5e-3
GRAD_ATOL_SHARE = 0.1   # the train step's gradients (test_torch_bf16_train.py)
ADAM_GRAD_FLOOR = 1e-5  # and its AdamW comparison
GAP_SHARE = 0.25
SMALL = dict(d_model=32, dim_feedforward=32, fut_window=5)
FULL = dict(d_model=512, dim_feedforward=512, fut_window=15)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rms(x) -> float:
    return float(np.sqrt(np.mean(np.square(np.asarray(x, np.float64)))))


def bf16_close(got, want, msg=""):
    """Within BF16_RTOL of the JAX bf16 value plus BF16_RTOL of the tensor's
    largest magnitude."""
    got, want = f32(got), f32(want)
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL,
                               atol=BF16_RTOL * float(np.abs(want).max()), err_msg=msg)


def gap_share(got, want_bf16, want_f32) -> float:
    """rms(port - JAX bf16) / rms(JAX f32 - JAX bf16)."""
    got, b, f = (np.concatenate([f32(x).ravel() for x in xs]) if isinstance(xs, (list, tuple))
                 else f32(xs).ravel() for xs in (got, want_bf16, want_f32))
    gap = rms(f - b)
    assert gap > 0, "the bf16 and f32 results are equal: the bf16 path did not run"
    return rms(got - b) / gap


def with_biases(params, seed: int, scale: float = 0.1):
    """``params`` with every bias moved by a seeded normal draw (Flax inits
    them to 0, which would hide where the bias is added)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x + jnp.asarray(scale * rng.standard_normal(x.shape), jnp.float32)
        if "bias" in jax.tree_util.keystr(path) else x, params)


# --------------------------------------------------------------------- K8

SERVING_CASES = {
    "decode_t0": (1, 15, 1, (jnp.arange(15) <= 0)[None, None, None, :]),
    "decode_t7": (1, 15, 8, (jnp.arange(15) <= 7)[None, None, None, :]),
    "decode_t14": (1, 15, 15, (jnp.arange(15) <= 14)[None, None, None, :]),
    "cross_3": (1, 3, None, None),
    "encoder_5x5": (5, 5, None, None),
    "causal_16": (16, 16, 1, causal_mask(16)),
}
K8_CASES = ([f"full_{c}" for c in SERVING_CASES] + [f"small_{c}" for c in MHA_CASES]
            + [f"small_{c}_dropout" for c in ("encoder_5x5", "decode_t9_of_15", "cross_3",
                                              "cross_15x3", "causal_15")])


@pytest.mark.parametrize("case", K8_CASES)
def test_mha_attend_bf16_matches_jax(case, monkeypatch):
    """Output and q_in, k, v gradients of a random linear functional of
    ``MHA.attend``'s output; with dropout, JAX's keep mask is the port's."""
    width, name = case.split("_", 1)
    dropout = name.endswith("_dropout")
    name = name.removesuffix("_dropout")
    d, H, B = (512, 8, 4) if width == "full" else (32, 4, 3)
    Lq, Lk, kv_len0, mask = (SERVING_CASES if width == "full" else MHA_CASES)[name]
    rng = np.random.default_rng(len(case))
    q_in = rng.normal(0, 1, (B, Lq, d)).astype(np.float32)
    kv_in = rng.normal(0, 1, (B, Lk, d)).astype(np.float32)
    cot = rng.normal(0, 1, (B, Lq, d)).astype(np.float32)
    params = with_biases(JaxMHA(d, H).init(jax.random.PRNGKey(3), jnp.asarray(q_in),
                                           jnp.asarray(kv_in), None, True)["params"], 3)
    keeps = []
    bernoulli = jax.random.bernoulli

    def recorded(*a, **kw):
        out = bernoulli(*a, **kw)
        keeps.append(np.array(out))
        return out

    monkeypatch.setattr(jax.random, "bernoulli", recorded)
    want = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        jmha = JaxMHA(d, H, dtype=dtype)
        k, v = jmha.apply({"params": params}, jnp.asarray(kv_in), method=JaxMHA.project_kv)

        def functional(q_in, k, v):
            out = jmha.apply({"params": params}, q_in, k, v, mask, not dropout,
                             method=JaxMHA.attend, rngs={"dropout": jax.random.PRNGKey(7)})
            return jnp.sum(out * cot), out

        grad_fn = jax.value_and_grad(functional, argnums=(0, 1, 2), has_aux=True)
        if not dropout:  # jitted where no keep mask is recorded from the trace
            grad_fn = jax.jit(grad_fn)
        (_, out), grads = grad_fn(jnp.asarray(q_in), k, v)
        want[dtype] = [out, *grads]
        if dtype == jnp.bfloat16:
            kv_bf16 = (k, v)
    assert len(keeps) == 2 * int(dropout) and (not dropout or np.array_equal(*keeps))
    keep = torch.as_tensor(keeps[0]) if dropout else None
    if dropout:
        monkeypatch.setattr(transformer, "keep_mask", lambda *a: keep)
    mha = MHA(d, H, dtype=BF, device="cpu")
    mha.load_state_dict(mtio_state_dict_from_flax(jax.device_get(params), {}))
    tk, tv = mha.project_kv(torch.as_tensor(kv_in))
    for a, b in zip((tk, tv), kv_bf16):
        assert a.dtype == BF
        bf16_close(a, b)
    leaves = [torch.tensor(q_in, requires_grad=True)] + [
        torch.tensor(f32(a)).to(BF).requires_grad_() for a in kv_bf16]
    out = mha.attend(*leaves, kv_len0, torch.Generator() if dropout else None)
    (out * torch.as_tensor(cot)).sum().backward()
    # the standalone attend returns JAX's bf16 out Dense; the port's is its f32 sum
    got = [out.detach().to(BF)] + [leaf.grad for leaf in leaves]
    assert [g.dtype for g in got[2:]] == [BF, BF]
    for label, g, w in zip(("out", "dq_in", "dk", "dv"), got, want[jnp.bfloat16]):
        bf16_close(g, w, label)
    share = gap_share(got, want[jnp.bfloat16], want[jnp.float32])
    assert share <= GAP_SHARE, share

    # the core: the written-out backward against the plain version's autograd
    q = mha._split(mha.query(torch.as_tensor(q_in))).detach().requires_grad_()
    kc, vc = (x.detach().requires_grad_() for x in (tk, tv))
    keep_u8 = None if keep is None else keep.view(torch.uint8)
    o = K8.attention_plain(q, kc, vc, kv_len0, keep_u8, 0.1)
    o_train, row_max, row_sum = K8.attention_train_forward_plain(q, kc, vc, kv_len0, keep_u8,
                                                                 0.1)
    assert o.dtype == o_train.dtype == BF and row_max.dtype == torch.float32
    torch.testing.assert_close(o_train, o, rtol=0, atol=0)
    dout = torch.as_tensor(rng.normal(0, 1, o.shape).astype(np.float32)).to(BF)
    want_core = torch.autograd.grad(o, (q, kc, vc), dout)
    got_core = K8.attention_backward_plain(dout, q.detach(), kc.detach(), vc.detach(),
                                           o.detach(), row_max.detach(), row_sum.detach(),
                                           kv_len0, keep_u8, 0.1)
    for g, w in zip(got_core, want_core):
        assert g.dtype == w.dtype == BF
        bf16_close(g, w)
    if kv_len0 is not None:  # keys no row sees get exactly 0
        unseen = slice(min(Lk, kv_len0 + Lq - 1), None)
        assert not got_core[1][:, unseen].any() and not got_core[2][:, unseen].any()


def test_attention_refuses_other_dtypes():
    q = torch.zeros(2, 1, 4, 8)
    for dtypes in ((torch.float16,) * 3, (torch.float64,) * 3, (BF, torch.float32, BF),
                   (torch.float32, torch.float32, BF)):
        args = [q.to(dt) for dt in dtypes]
        with pytest.raises(ValueError, match="float32 or all bfloat16"):
            K8.attention(*args)
        with pytest.raises(ValueError, match="float32 or all bfloat16"):
            K8.attention_train_forward(*args)


# ------------------------------------------------------------------ sample

@pytest.mark.parametrize("width", ["small", "full"])
def test_sample_bf16_matches_jax_sample_step(width):
    cfg, B = (SMALL, 16) if width == "small" else (FULL, 4)
    jm, state = jax_state(cfg)
    state = state._replace(params=with_biases(state.params, 5))
    rng = np.random.default_rng(1)
    h, c = rng.random((B, 5, 2), dtype=np.float32), rng.random((B, 1, 2), dtype=np.float32)
    want32 = np.asarray(JV.sample_step(jm, state, jnp.asarray(h), jnp.asarray(c)))
    want16 = np.asarray(JV.sample_step(JaxMTIO(**cfg, dtype=jnp.bfloat16), state,
                                       jnp.asarray(h), jnp.asarray(c)))
    model = port_model(state, cfg, dtype=BF)
    got = model.sample(torch.as_tensor(h), torch.as_tensor(c))
    assert got.dtype == torch.float32 and got.shape == want16.shape
    np.testing.assert_allclose(got.numpy(), want16, rtol=0, atol=SAMPLE_ATOL)
    share = gap_share(got, want16, want32)
    if width == "small":
        assert share <= GAP_SHARE, share
    else:  # nearer JAX's bf16 predictions than JAX's f32 ones; each stage of
        # the chain within GAP_SHARE in test_full_width_stages_bf16_match_jax
        assert rms(got.numpy() - want16) < rms(got.numpy() - want32), share


def test_full_width_stages_bf16_match_jax():
    """``sample``'s chain at d = 512 a stage at a time, each stage given
    the JAX bf16 model's output of the stage before: the embedding, the two
    encoder layers, the encoder norm and distillation layer, the target's
    embedding, the two decoder layers (the full causal decode over 1 + F
    positions, from the distilled memory).  Each lies within GAP_SHARE of
    the JAX bf16 stage's output, the gap taken by the JAX f32 stage on the
    same input (the witness of the module docstring's account of
    ``sample`` at d = 512)."""
    jm32, state = jax_state(FULL)
    state = state._replace(params=with_biases(state.params, 5))
    jm16 = JaxMTIO(**FULL, dtype=jnp.bfloat16)
    model = port_model(state, FULL, dtype=BF)
    T, mask = model.transformer, causal_mask(1 + FULL["fut_window"])
    rng = np.random.default_rng(1)
    src = np.tile(rng.random((4, 5, 2), dtype=np.float32), (1, 1, model.num_head))
    tgt = np.tile(rng.random((4, 1 + FULL["fut_window"], 2), dtype=np.float32),
                  (1, 1, model.num_head))
    stages = [  # (name, the JAX stage of module m on (x, memory), the port's)
        ("embedding", lambda m, x, mem: m._embed(x, True), lambda x, mem: model._embed(x)),
        ("encoder_0", lambda m, x, mem: m.transformer.encoder_layers[0](x, True),
         lambda x, mem: T.encoder_layers[0](x)),
        ("encoder_1", lambda m, x, mem: m.transformer.encoder_layers[1](x, True),
         lambda x, mem: T.encoder_layers[1](x)),
        ("distill", lambda m, x, mem: m.transformer.distill(m.transformer.encoder_norm(x), True),
         lambda x, mem: T.distill(T.encoder_norm(x))),
        ("tgt_embedding", lambda m, x, mem: m._embed(x, True), lambda x, mem: model._embed(x)),
        ("decoder_0", lambda m, x, mem: m.transformer.decoder_layers[0](x, mem, mask, True),
         lambda x, mem: T.decoder_layers[0](x, mem, 1)),
        ("decoder_1", lambda m, x, mem: m.transformer.decoder_layers[1](x, mem, mask, True),
         lambda x, mem: T.decoder_layers[1](x, mem, 1)),
    ]
    x, mem = src, np.zeros(1, np.float32)
    shares = {}
    with torch.no_grad():
        for name, jax_stage, port_stage in stages:
            if name == "tgt_embedding":
                x, mem = tgt, x
            want16, want32 = (np.asarray(jax.jit(lambda v, x, mem: jm.apply(
                v, x, mem, method=jax_stage))(variables(state), jnp.asarray(x), jnp.asarray(mem))
                .astype(jnp.float32)) for jm in (jm16, jm32))
            got = port_stage(torch.as_tensor(x), torch.as_tensor(mem))
            assert got.dtype == torch.float32, name  # f32 norms and residuals
            shares[name] = gap_share(got, want16, want32)
            x = want16
    assert max(shares.values()) <= GAP_SHARE, shares
