"""Port parity: the MTIO training step (``vp_train.train_step`` and
``train_epoch``) against the JAX ``_train_step``.

Weights come from the JAX package's seeded ``create_train_state`` and are
carried across by ``mtio_state_dict_from_flax``; batches are numpy draws
handed to both.

* Dropout at 0 on both sides: the JAX ``Transformer``'s dropout cannot be
  reached from ``ViewportTransformerMTIO``'s constructor, so this module
  swaps ``mansy_immersivevideostreaming_tpu.models.mtio.Transformer`` for a
  subclass with dropout 0 (no JAX file is edited); the PE dropout is the
  MTIO's ``dropout=0`` on both sides.
* The slot draws are the JAX step's own: :func:`recording_slots` records
  what ``jax.random.permutation`` and ``jax.random.uniform`` return inside
  the jitted step (``jax.debug.callback``), and the port gets them as
  ``perms`` and ``repeat``.
* Cases, in both decode modes (the KV-cached autoregressive one and
  teacher forcing), at d = 32 (fut 5) and once at the full width (d = 512,
  8 x 64 heads, 2 + 2 layers, fut 15, B = 8): the training forward and the
  loss; the gradients of one ``_train_step`` mapped to the Flax tree; one
  AdamW step's params, optimizer state and ``batch_stats``; three looped
  ``_train_step`` losses against the port's ``train_epoch`` on a shared
  epoch permutation; the distillation layer's training mode; the train
  checkpoint's round trip; ``init_like_flax`` against Flax's init.

Tolerances: activations, losses and gradients atol 2e-5, rtol 2e-4 (the
bound of ``tests/test_torch_mtio.py``).  Parameters after AdamW within
2e-6 wherever the JAX gradient is at least 1e-6 in magnitude or both
gradients are exactly 0; elsewhere
Adam's first step (about lr * sign(g)) follows the sign of float noise:
those entries are counted and must stay under 5% of each width's
parameters: at d = 32 about 1% (mostly leaves whose gradient is 0 in exact
arithmetic but not in float: the key biases, which softmax ignores, and
the biases that BatchNorm's batch mean removes), at d = 512 with B = 8
about 3%, small gradients of a small batch.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mansy_immersivevideostreaming_tpu.models import mtio as jax_mtio
from mansy_immersivevideostreaming_tpu.models import vp_train as JV
from mansy_immersivevideostreaming_tpu.models.transformer import DistillLayer as JaxDistill
from mansy_immersivevideostreaming_tpu.models.transformer import Transformer as JaxTransformer
from mansy_immersivevideostreaming_torch.models import vp_train as TV
from mansy_immersivevideostreaming_torch.models.mtio import ViewportTransformerMTIO
from mansy_immersivevideostreaming_torch.models.transformer import DistillLayer
from mansy_immersivevideostreaming_torch.utils.checkpoint import (
    flatten_params, load_train_checkpoint, mtio_flax_from_module, mtio_flax_tensors,
    mtio_state_dict_from_flax, save_train_checkpoint,
)

ATOL, RTOL = 2e-5, 2e-4
PARAM_ATOL = 2e-6       # parameters after one AdamW step
GRAD_FLOOR = 1e-6       # |JAX gradient| below which Adam's step follows float noise
NOISY_SHARE = 0.05      # most of a width's parameters allowed below GRAD_FLOOR
LR = 1e-3
SMALL = dict(d_model=32, dim_feedforward=32, fut_window=5)
FULL = dict(d_model=512, dim_feedforward=512, fut_window=15)
HIS = 5


class _TransformerWithoutDropout(JaxTransformer):
    dropout: float = 0.0


@pytest.fixture(scope="module", autouse=True)
def _jax_dropout_off():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mtio, "Transformer", _TransformerWithoutDropout)
        yield


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@contextlib.contextmanager
def recording_slots():
    """Records the slot draws of every JAX MTIO training forward traced
    inside the context: {"perm": [[num_head - 1, B], ...], "repeat": [bool,
    ...]}, one entry a forward, in call order (``jax.debug.callback`` runs
    them inside jitted code).  Functions are traced afresh inside the
    context (:func:`fresh_jit`), so no cached trace records elsewhere."""
    got = {"perm": [], "repeat": []}
    perm, uniform = jax.random.permutation, jax.random.uniform

    def record(name, fn, post):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            jax.debug.callback(lambda x: got[name].append(post(np.asarray(x))), out,
                               ordered=True)
            return out
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "permutation", record("perm", perm, lambda x: x.copy()))
        mp.setattr(jax.random, "uniform", record("repeat", uniform, lambda x: bool(x < 0.5)))
        yield got


def fresh_jit(fn, *static):
    """``jax.jit`` of a new closure of ``fn`` over its static leading
    arguments: a trace of its own, not one cached by another test."""
    return jax.jit(lambda *args: fn(*static, *args))


def jax_setup(cfg: dict, teacher_forcing: bool, seed: int = 0):
    """The JAX module (dropout 0), its seeded train state and AdamW."""
    jm = jax_mtio.ViewportTransformerMTIO(**cfg, dropout=0.0, teacher_forcing=teacher_forcing)
    opt = JV.make_optimizer(LR)
    state = jax.jit(lambda key: JV.create_train_state(jm, key, HIS, opt))(
        jax.random.PRNGKey(seed))
    return jm, opt, state


def port_model(state, cfg: dict, teacher_forcing: bool) -> ViewportTransformerMTIO:
    model = ViewportTransformerMTIO(**cfg, dropout=0.0, transformer_dropout=0.0,
                                    teacher_forcing=teacher_forcing, device="cpu")
    model.load_state_dict(mtio_state_dict_from_flax(jax.device_get(state.params),
                                                    jax.device_get(state.batch_stats)))
    return model


def make_batch(rng, B: int, F: int):
    return {"history": rng.random((B, HIS, 2), dtype=np.float32),
            "current": rng.random((B, 1, 2), dtype=np.float32),
            "future": rng.random((B, F, 2), dtype=np.float32)}


def torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def jax_step_parts(jm, state, batch, rng):
    """What ``_train_step`` computes before the optimizer, with its keys:
    (loss, (pred, gt, new batch_stats), grads)."""
    k_drop, k_shuf = jax.random.split(jax.random.fold_in(rng, state.step))

    def loss_fn(params):
        (pred, gt), mutated = jm.apply(
            {"params": params, "batch_stats": state.batch_stats}, batch["history"],
            batch["current"], batch["future"], train=True,
            rngs={"dropout": k_drop, "shuffle": k_shuf}, mutable=["batch_stats"])
        return jm.loss_function(pred, gt), (pred, gt, mutated["batch_stats"])

    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    return loss, aux, grads


def close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def close_tree(got: dict, want: dict, atol=ATOL, rtol=RTOL):
    want = flatten_params(jax.device_get(want))
    assert set(got) == set(want)
    for key in want:
        close(got[key], want[key], atol, rtol, msg=key)


def port_grads(model, batch, perms, repeat):
    """The port's training forward, loss and gradients (Flax-keyed)."""
    pred, gt = model(*(torch.as_tensor(batch[k]) for k in ("history", "current", "future")),
                     train=True, perms=perms, repeat=repeat,
                     generator=torch.Generator().manual_seed(0))
    loss = model.loss_function(pred, gt)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss, pred, gt, mtio_flax_tensors(model, grads)


def check_params_after_adamw(model, want_params, grads_flat: dict, port_grads_flat: dict
                             ) -> int:
    """Parameters within PARAM_ATOL where the JAX gradient is at least
    GRAD_FLOOR in magnitude, or where both gradients are exactly 0 (a ReLU
    unit dead for the whole batch); returns the number of the other
    entries."""
    got = mtio_flax_from_module(model).params
    want = flatten_params(jax.device_get(want_params))
    noisy = 0
    for key, w in want.items():
        g = np.abs(np.asarray(grads_flat[key]))
        sure = (g >= GRAD_FLOOR) | ((g == 0) & (port_grads_flat[key] == 0))
        np.testing.assert_allclose(got[key][sure], np.asarray(w)[sure], rtol=0,
                                   atol=PARAM_ATOL, err_msg=key)
        noisy += int((~sure).sum())
    total = sum(np.size(w) for w in want.values())
    assert noisy <= NOISY_SHARE * total, (noisy, total)
    return noisy


@pytest.fixture(scope="module")
def small_incremental():
    return jax_setup(SMALL, False)


@pytest.fixture(scope="module")
def small_teacher():
    return jax_setup(SMALL, True)


def _setup(request, mode):
    return request.getfixturevalue("small_incremental" if mode == "incremental"
                                   else "small_teacher")


# ------------------------------------------------------------ one step

@pytest.mark.parametrize("mode", ["incremental", "teacher_forced"])
def test_training_forward_and_gradients_match_jax(mode, request):
    jm, _, state = _setup(request, mode)
    batch = make_batch(np.random.default_rng(3), 8, SMALL["fut_window"])
    with recording_slots() as slots:
        loss, (pred, gt, stats), grads = fresh_jit(jax_step_parts, jm)(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
        jax.effects_barrier()
    assert len(slots["perm"]) == len(slots["repeat"]) == 1
    model = port_model(state, SMALL, mode == "teacher_forced")
    got_loss, got_pred, got_gt, got_grads = port_grads(model, batch, slots["perm"][0],
                                                       slots["repeat"][0])
    assert got_pred.shape == (8, SMALL["fut_window"], 6)
    close(got_gt, gt, 0, 0)
    close(got_pred, pred)
    close(got_loss, loss)
    close_tree(got_grads, grads)
    # the distillation layer's running statistics after the batch
    close_tree(mtio_flax_from_module(model).batch_stats, stats, atol=1e-6, rtol=1e-5)


def test_repeat_draw_fills_every_slot_with_the_batch():
    """repeat=True gives the identity slots whatever the permutations (the
    JAX ``where(repeat, idx0, perms)``); the slots of gt are the batch's
    future, tiled."""
    model = ViewportTransformerMTIO(**SMALL, device="cpu")
    b = torch_batch(make_batch(np.random.default_rng(4), 6, SMALL["fut_window"]))
    perms = torch.stack([torch.randperm(6), torch.randperm(6)])
    with torch.no_grad():
        _, gt = model(b["history"], b["current"], b["future"], perms=perms, repeat=True,
                      generator=torch.Generator().manual_seed(0))
        _, gt_perm = model(b["history"], b["current"], b["future"], perms=perms,
                           repeat=False, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(gt, b["future"].repeat(1, 1, 3), rtol=0, atol=0)
    torch.testing.assert_close(gt_perm[..., 2:4], b["future"][perms[0]], rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["incremental", "teacher_forced"])
def test_adamw_step_matches_jax_train_step(mode, request):
    """One ``_train_step``: loss, parameters, optimizer state (mu, nu,
    count) and batch_stats."""
    jm, opt, state = _setup(request, mode)
    batch = make_batch(np.random.default_rng(5), 8, SMALL["fut_window"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with recording_slots() as slots:
        new, loss = fresh_jit(JV._train_step, jm, opt)(state, jbatch, jax.random.PRNGKey(2))
        _, _, grads = fresh_jit(jax_step_parts, jm)(
            state, jbatch, jax.random.PRNGKey(2))
        jax.effects_barrier()
    # the step and the parts drew the same slots from the same keys
    np.testing.assert_array_equal(slots["perm"][0], slots["perm"][1])
    perms, repeat = slots["perm"][0], slots["repeat"][0]
    *_, port = port_grads(port_model(state, SMALL, mode == "teacher_forced"), batch, perms,
                          repeat)
    model = port_model(state, SMALL, mode == "teacher_forced")
    tstate, got_loss = TV.train_step(model, TV.make_optimizer(LR), TV.create_train_state(model),
                                     torch_batch(batch), 0, perms=perms, repeat=repeat)
    close(got_loss, loss)
    assert (tstate.step, tstate.count) == (1, 1) == (int(new.step), int(new.opt_state[0].count))
    check_params_after_adamw(model, new.params, flatten_params(jax.device_get(grads)), port)
    close_tree(mtio_flax_tensors(model, tstate.mu), new.opt_state[0].mu)
    close_tree(mtio_flax_tensors(model, tstate.nu), new.opt_state[0].nu, atol=1e-9, rtol=RTOL)
    close_tree(mtio_flax_from_module(model).batch_stats, new.batch_stats, atol=1e-6, rtol=1e-5)


def test_full_width_train_step_matches_jax():
    """d = 512, 8 x 64 heads, 2 + 2 layers, fut 15, B = 8, the
    autoregressive decode: loss, gradients, AdamW's parameters (optax's
    update of the JAX gradients, as ``_train_step`` applies it) and
    batch_stats."""
    import optax
    jm, opt, state = jax_setup(FULL, False, seed=1)
    batch = make_batch(np.random.default_rng(6), 8, FULL["fut_window"])
    with recording_slots() as slots:
        loss, (pred, _, stats), grads = fresh_jit(jax_step_parts, jm)(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(3))
        jax.effects_barrier()
    updates, _ = opt.update(grads, state.opt_state, state.params)
    new_params = optax.apply_updates(state.params, updates)
    perms, repeat = slots["perm"][0], slots["repeat"][0]
    model = port_model(state, FULL, False)
    got_loss, got_pred, _, got_grads = port_grads(model, batch, perms, repeat)
    close(got_pred, pred)
    close(got_loss, loss)
    close_tree(got_grads, grads)
    close_tree(mtio_flax_from_module(model).batch_stats, stats, atol=1e-6, rtol=1e-5)
    model = port_model(state, FULL, False)
    TV.train_step(model, TV.make_optimizer(LR), TV.create_train_state(model),
                  torch_batch(batch), 0, perms=perms, repeat=repeat)
    check_params_after_adamw(model, new_params, flatten_params(jax.device_get(grads)), got_grads)


# ---------------------------------------------------------- three steps

def test_three_train_steps_match_train_epoch(small_incremental, monkeypatch):
    """Three looped ``_train_step``s (the epoch's shared permutation, B =
    8, the JAX steps' slot draws) against the port's ``train_epoch``: each
    batch's loss, the last partial batch dropped."""
    jm, opt, state = small_incremental
    rng = np.random.default_rng(7)
    n, bs = 27, 8    # 3 batches, the last 3 samples dropped
    data = make_batch(rng, n, SMALL["fut_window"])
    perm = np.random.default_rng(5).permutation(n)
    step = fresh_jit(JV._train_step, jm, opt)
    losses, jstate = [], state
    with recording_slots() as slots:
        for i in range(3):
            ib = perm[i * bs:(i + 1) * bs]
            jstate, loss = step(jstate, {k: jnp.asarray(v[ib])
                                                   for k, v in data.items()},
                                jax.random.PRNGKey(5))
            losses.append(float(loss))
        jax.effects_barrier()
    draws = list(zip(slots["perm"], slots["repeat"]))
    assert len(draws) == 3
    model = port_model(state, SMALL, False)
    monkeypatch.setattr(model, "draw_slots", lambda B, gen, device: draws.pop(0))
    tstate, got = TV.train_epoch(model, TV.make_optimizer(LR), TV.create_train_state(model),
                                 torch_batch(data), bs, perm, 5)
    assert got.shape == (3,) and not draws and tstate.step == 3
    close(got, losses)
    # the later losses hold the first updates; the parameters stay within
    # Adam's bound (lr a step) of each other on every entry, the entries
    # whose first step followed float noise included
    got_params = mtio_flax_from_module(model).params
    for key, w in flatten_params(jax.device_get(jstate.params)).items():
        assert np.abs(got_params[key] - w).max() <= 3 * 2 * LR, key


# --------------------------------------------------- distillation layer

def test_distill_layer_training_mode_matches_flax():
    """Batch statistics over (B, L) with Flax's E[x^2] - E[x]^2, the
    output and the running statistics (momentum 0.9, biased variance)."""
    d, B, L = 16, 6, 5
    rng = np.random.default_rng(8)
    x = rng.normal(0.5, 2.0, (B, L, d)).astype(np.float32)
    jl = JaxDistill(d)
    variables = jl.init(jax.random.PRNGKey(4), jnp.asarray(x), True)
    stats = {"BatchNorm_0": {"mean": rng.uniform(-0.3, 0.3, d).astype(np.float32),
                             "var": rng.uniform(0.5, 1.5, d).astype(np.float32)}}
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.1, np.shape(a)).astype(np.float32),
        jax.device_get(variables["params"]))
    want, mutated = jl.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), False,
                             mutable=["batch_stats"])
    layer = DistillLayer(d, device="cpu")
    flat = mtio_state_dict_from_flax({"d": params}, {"d": stats})
    layer.load_state_dict({k[2:]: v for k, v in flat.items()})
    got = layer(torch.as_tensor(x), torch.Generator())
    assert got.shape == (B, 3, d)
    close(got, want)
    bn = mutated["batch_stats"]["BatchNorm_0"]
    close(layer.bn.running_mean, bn["mean"], atol=1e-6, rtol=1e-5)
    close(layer.bn.running_var, bn["var"], atol=1e-6, rtol=1e-5)
    # deterministic: the running statistics, unchanged by the call
    before = layer.bn.running_var.clone()
    want = jl.apply({"params": params, "batch_stats": mutated["batch_stats"]},
                    jnp.asarray(x), True)
    close(layer(torch.as_tensor(x)), want)
    torch.testing.assert_close(layer.bn.running_var, before, rtol=0, atol=0)


# ------------------------------------------------------ checkpoint, init

def test_train_checkpoint_round_trip(tmp_path, small_incremental):
    """Weights, statistics, AdamW's moments and counts come back as saved,
    and the resumed state takes the step the unbroken one takes."""
    _, _, state = small_incremental
    model = port_model(state, SMALL, False)
    opt = TV.make_optimizer(LR)
    b = torch_batch(make_batch(np.random.default_rng(9), 8, SMALL["fut_window"]))
    tstate, _ = TV.train_step(model, opt, TV.create_train_state(model), b, 3)
    path = tmp_path / "ck.npz"
    save_train_checkpoint(path, model, tstate)
    again = port_model(state, SMALL, False)
    loaded = load_train_checkpoint(path, again)
    assert (loaded.step, loaded.count) == (tstate.step, tstate.count) == (1, 1)
    for a, c in zip(tstate.mu + tstate.nu, loaded.mu + loaded.nu):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    for (name, a), (_, c) in zip(model.state_dict().items(), again.state_dict().items()):
        if not name.endswith("num_batches_tracked"):
            torch.testing.assert_close(a, c, rtol=0, atol=0, msg=name)
    s1, l1 = TV.train_step(model, opt, tstate, b, 3)
    s2, l2 = TV.train_step(again, opt, loaded, b, 3)
    assert float(l1) == float(l2)
    for a, c in zip(model.parameters(), again.parameters()):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_init_like_flax_matches_flax_init_statistics():
    """Per leaf at d = 512: the std of each kernel within 3% of Flax's
    lecun_normal draw of the same shape, every bias 0, scales 1, running
    statistics 0 and 1, the |x| <= 2 sigma truncation."""
    jm = jax_mtio.ViewportTransformerMTIO(**FULL)
    state = jax.jit(lambda key: JV.create_train_state(jm, key, HIS, JV.make_optimizer(LR)))(
        jax.random.PRNGKey(0))
    want = flatten_params(jax.device_get(state.params))
    model = ViewportTransformerMTIO(**FULL, device="cpu").init_like_flax(
        torch.Generator().manual_seed(0))
    got = mtio_flax_from_module(model)
    assert set(got.params) == set(want)
    for key, w in want.items():
        g = got.params[key]
        if key.endswith("kernel"):
            fan_in = int(np.prod(w.shape[:-1]))
            sigma = np.sqrt(1.0 / fan_in) / 0.87962566103423978
            assert abs(g.std() / np.asarray(w).std() - 1) < 0.03, key
            assert np.abs(g).max() <= 2 * sigma * (1 + 1e-6), key
            assert abs(g.mean()) < 0.03 * sigma + 3 * sigma / np.sqrt(g.size), key
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=key)
    for key, w in flatten_params(jax.device_get(state.batch_stats)).items():
        np.testing.assert_array_equal(got.batch_stats[key], np.asarray(w), err_msg=key)
