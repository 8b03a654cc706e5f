"""Port parity: the MTIO training step and ``run_models`` at bf16 compute
against the JAX package's ``dtype=jnp.bfloat16``, on the CPU.

The second half of ``tests/test_torch_bf16.py``, whose docstring states the
rounding points, the tolerances (GRAD_ATOL_SHARE, ADAM_GRAD_FLOOR,
BF16_RTOL, SAMPLE_ATOL) and the share of the f32-to-bf16 gap each case is
held to, with the values measured.
"""

import dataclasses
import glob
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mansy_immersivevideostreaming_tpu.cli import run_models as jax_run_models
from mansy_immersivevideostreaming_tpu.models import ViewportTransformerMTIO as JaxMTIO
from mansy_immersivevideostreaming_tpu.models import mtio as jax_mtio
from mansy_immersivevideostreaming_tpu.models import vp_train as JV
from mansy_immersivevideostreaming_torch.cli import run_models
from mansy_immersivevideostreaming_torch.models import vp_train as TV
from mansy_immersivevideostreaming_torch.models.mtio import ViewportTransformerMTIO
from mansy_immersivevideostreaming_torch.ops.geometry import periodic_mse
from mansy_immersivevideostreaming_torch.utils.checkpoint import (
    flatten_params, mtio_flax_from_module, mtio_flax_tensors, mtio_state_dict_from_flax,
)
from synthetic_tree import build_synthetic_tree
from test_torch_bf16 import (
    ADAM_GRAD_FLOOR, BF, BF16_RTOL, GAP_SHARE, GRAD_ATOL_SHARE, SAMPLE_ATOL, SMALL, gap_share,
    with_biases,
)
from test_torch_mtio import orbax_mtio_to_npz
from test_torch_tables import port_config
from test_torch_vp_cli import (
    CADENCE, COMMON, TRAIN, compare_results, line_kinds, port_tree, train_losses, tree_files,
)
from test_torch_vp_train import (
    NOISY_SHARE, PARAM_ATOL, _TransformerWithoutDropout, fresh_jit, recording_slots,
)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# --------------------------------------------------------------- train step

@pytest.fixture(scope="module")
def _jax_dropout_off():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mtio, "Transformer", _TransformerWithoutDropout)
        yield


def _jax_step(cfg, teacher_forcing: bool, dtype, state, batch):
    """Loss, grads, the params after AdamW (optax's ``adamw`` on those
    grads, as ``_train_step`` applies it) and the (pred, gt) of the loss of
    the JAX MTIO (dropout 0) at ``dtype``, and its slot draws."""
    jm = jax_mtio.ViewportTransformerMTIO(**cfg, dropout=0.0, teacher_forcing=teacher_forcing,
                                          dtype=dtype)
    opt = JV.make_optimizer(1e-3)

    def step(state, batch, rng):
        k_drop, k_shuf = jax.random.split(jax.random.fold_in(rng, state.step))

        def loss_fn(params):
            (pred, gt), _ = jm.apply({"params": params, "batch_stats": state.batch_stats},
                                     batch["history"], batch["current"], batch["future"],
                                     train=True, rngs={"dropout": k_drop, "shuffle": k_shuf},
                                     mutable=["batch_stats"])
            return jm.loss_function(pred, gt), (pred, gt)

        (loss, (pred, gt)), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        updates, _ = opt.update(grads, state.opt_state, state.params)
        return loss, grads, optax.apply_updates(state.params, updates), (pred, gt)

    with recording_slots() as slots:
        out = fresh_jit(step)(state, {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.PRNGKey(1))
        jax.effects_barrier()
    return out, slots


@pytest.mark.parametrize("mode", ["incremental", "teacher_forced"])
def test_train_step_bf16_matches_jax(mode, _jax_dropout_off):
    tf = mode == "teacher_forced"
    jm = jax_mtio.ViewportTransformerMTIO(**SMALL, dropout=0.0, teacher_forcing=tf)
    state = jax.jit(lambda key: JV.create_train_state(jm, key, 5, JV.make_optimizer(1e-3)))(
        jax.random.PRNGKey(0))
    state = state._replace(params=with_biases(state.params, 6))
    rng = np.random.default_rng(3)
    batch = {"history": rng.random((8, 5, 2), dtype=np.float32),
             "current": rng.random((8, 1, 2), dtype=np.float32),
             "future": rng.random((8, SMALL["fut_window"], 2), dtype=np.float32)}
    (loss32, grads32, _, out32), _ = _jax_step(SMALL, tf, jnp.float32, state, batch)
    (loss16, grads16, params16, out16), slots = _jax_step(SMALL, tf, jnp.bfloat16, state,
                                                         batch)
    perm, repeat = slots["perm"][0], slots["repeat"][0]
    model = transformer_model(state, tf)
    pred, gt = model(*(torch.as_tensor(batch[k]) for k in ("history", "current", "future")),
                     train=True, perms=perm, repeat=repeat, generator=torch.Generator())
    loss = model.loss_function(pred, gt)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    got = mtio_flax_tensors(model, grads)
    want16, want32 = flatten_params(jax.device_get(grads16)), flatten_params(
        jax.device_get(grads32))
    assert sorted(got) == sorted(want16)
    np.testing.assert_allclose(float(loss.detach()), float(loss16), rtol=BF16_RTOL, atol=0)
    # the loss a batch row at a time (its mean is the loss): the scalar's own
    # f32-to-bf16 gap cancels across the rows (module docstring)
    rows = row_losses(model, pred, gt)
    np.testing.assert_allclose(float(rows.mean()), float(loss.detach()), rtol=1e-6)
    share = gap_share(rows, *(row_losses(model, *(torch.as_tensor(np.array(x)) for x in out))
                              for out in (out16, out32)))
    assert share <= GAP_SHARE, share
    scale = max(float(np.abs(w).max()) for w in want16.values())
    for key in want16:
        np.testing.assert_allclose(got[key], want16[key], rtol=0,
                                   atol=GRAD_ATOL_SHARE * scale, err_msg=key)
    keys = sorted(want16)
    share = gap_share([got[k] for k in keys], [want16[k] for k in keys],
                      [want32[k] for k in keys])
    assert share <= GAP_SHARE, share
    # one AdamW step, about lr * sign(g) an entry: within PARAM_ATOL where
    # both gradients are at least ADAM_GRAD_FLOOR and share their sign (the
    # steps then differ by at most lr * eps / floor); the gradients' signs disagree on at most NOISY_SHARE of the entries
    # (gradients that are noise at bf16, such as the key biases, which
    # softmax ignores)
    model = transformer_model(state, tf)
    TV.train_step(model, TV.make_optimizer(1e-3), TV.create_train_state(model),
                  {k: torch.as_tensor(v) for k, v in batch.items()}, 0, perm, repeat)
    after = mtio_flax_from_module(model).params
    want_params = flatten_params(jax.device_get(params16))
    flipped = 0
    for key in want_params:
        g, w, p = np.asarray(got[key]), np.asarray(want16[key]), np.asarray(want_params[key])
        same_sign = np.sign(g) == np.sign(w)
        sure = (np.minimum(np.abs(g), np.abs(w)) >= ADAM_GRAD_FLOOR) & same_sign
        np.testing.assert_allclose(after[key][sure], p[sure], rtol=0, atol=PARAM_ATOL,
                                   err_msg=key)
        flipped += int((~same_sign).sum())
    total = sum(np.size(w) for w in want_params.values())
    assert flipped <= NOISY_SHARE * total, (flipped, total)


def row_losses(model, pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """[B] each batch row's ``loss_function``: the sum over the slots of
    the row's mean periodic MSE."""
    C = model.in_channel
    return sum(periodic_mse(pred[:, :, i * C:(i + 1) * C], gt[:, :, i * C:(i + 1) * C]).mean(1)
               for i in range(model.num_head)).detach()


def transformer_model(state, teacher_forcing: bool):
    """The port's bf16 MTIO (dropout 0) with ``state``'s weights."""
    model = ViewportTransformerMTIO(**SMALL, dropout=0.0, transformer_dropout=0.0,
                                    teacher_forcing=teacher_forcing, dtype=BF, device="cpu")
    model.load_state_dict(mtio_state_dict_from_flax(jax.device_get(state.params),
                                                    jax.device_get(state.batch_stats)))
    return model


# -------------------------------------------------------------------- CLI

def test_run_models_bf16_beside_the_jax_cli(tmp_path):
    """``run_models --train --test --bf16`` in both packages (3 epochs,
    validating every 2; their draws differ, so the runs compare by file
    set, console lines and falling finite losses), then the port's ``--test
    --bf16`` on the JAX run's best model against the JAX run's results:
    predictions within SAMPLE_ATOL, tile metrics equal wherever both
    truncate to one pixel."""
    base = str(tmp_path)
    cfg = build_synthetic_tree(base)
    cfg = dataclasses.replace(cfg, vp_models_dir=os.path.join(base, "jax", "models"),
                              vp_results_dir=os.path.join(base, "jax", "results"))
    argv = ["--train", "--test", "--bf16", "--model", "mtio", "--device", "cpu"] + COMMON + CADENCE
    stdout = sys.stdout
    try:  # the JAX CLI tees stdout into its console log and leaves it so
        jax_run_models.run(jax_run_models.build_parser().parse_args(argv), cfg)
    finally:
        sys.stdout = stdout
    pcfg = port_tree(base, cfg, "port")
    run_models.run(run_models.build_parser().parse_args(argv), pcfg)
    jax_files = tree_files(os.path.join(base, "jax"))
    assert tree_files(os.path.join(base, "port")) == jax_files
    jlog, = glob.glob(os.path.join(base, "jax", "**", "*console.log"), recursive=True)
    plog, = glob.glob(os.path.join(base, "port", "**", "*console.log"), recursive=True)
    assert line_kinds(plog) == line_kinds(jlog)
    for log in (plog, jlog):
        losses = train_losses(log)
        assert len(losses) == 3 and all(np.isfinite(losses)) and losses[-1] < losses[0]

    # the port's --test --bf16 on the JAX run's model, beside its results
    ckpt, = glob.glob(os.path.join(cfg.vp_models_dir, "**", "*_best_model.ckpt"),
                      recursive=True)
    small = dict(d_model=16, dim_feedforward=16, fut_window=5, num_encoder_layers=1,
                 num_decoder_layers=1)
    orbax_mtio_to_npz(ckpt, ckpt[:-len(".ckpt")] + ".npz", JaxMTIO(**small), 3)
    tcfg = dataclasses.replace(port_config(cfg), vp_results_dir=os.path.join(
        base, "port_test", "results"))
    run_models.run(run_models.build_parser().parse_args(
        ["--test", "--bf16", "--model", "mtio", "--device", "cpu"] + COMMON + CADENCE), tcfg)
    assert compare_results(os.path.join(cfg.vp_results_dir, "mtio"),
                           os.path.join(tcfg.vp_results_dir, "mtio"),
                           atol=SAMPLE_ATOL, rtol=0) > 0


@pytest.mark.parametrize("flag", ["--teacher-forcing", "--resume"])
def test_run_models_bf16_teacher_forcing_and_resume(tmp_path, flag):
    """``--train --bf16`` with ``--teacher-forcing`` writes the file set with
    finite losses; ``--resume --bf16`` goes on from a bf16 run's checkpoint
    (the f32 npz of weights, AdamW state and step): its step and AdamW count
    continue from the saved ones."""
    from mansy_immersivevideostreaming_torch.utils.checkpoint import load_train_checkpoint
    cfg = build_synthetic_tree(str(tmp_path))
    first = port_tree(str(tmp_path), cfg, "first")
    run_models.run(run_models.build_parser().parse_args(
        ["--train", "--bf16", "--model", "mtio", "--device", "cpu"] + COMMON + TRAIN
        + ([flag] if flag == "--teacher-forcing" else [])), first)
    log, = glob.glob(os.path.join(str(tmp_path), "first", "**", "*console.log"), recursive=True)
    assert train_losses(log) and all(np.isfinite(train_losses(log)))
    ck, = glob.glob(os.path.join(first.vp_models_dir, "**", "*_checkpoint.npz"), recursive=True)
    assert glob.glob(os.path.join(first.vp_models_dir, "**", "*_best_model.npz"), recursive=True)
    if flag == "--resume":
        args = run_models.build_parser().parse_args(["--bf16"] + COMMON)
        saved = load_train_checkpoint(ck, run_models.build_model(args, torch.device("cpu")))
        resumed = port_tree(str(tmp_path), cfg, "resumed")
        run_models.run(run_models.build_parser().parse_args(
            ["--train", "--bf16", "--resume", "--resume-path", ck, "--model", "mtio",
             "--device", "cpu"] + COMMON + TRAIN), resumed)
        ck2, = glob.glob(os.path.join(resumed.vp_models_dir, "**", "*_checkpoint.npz"),
                         recursive=True)
        got = load_train_checkpoint(ck2, run_models.build_model(args, torch.device("cpu")))
        assert saved.step == saved.count > 0
        assert got.step == got.count == 2 * saved.step
