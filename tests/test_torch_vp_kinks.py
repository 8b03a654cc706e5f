"""``chip_smoke.py``'s phase 11 check on the CPU: :class:`chip_smoke.Kinks`,
which makes the plain path's MTIO training step take the kernels' branches
at the model's kinks (the feed-forward's ReLU, the distillation's max pool,
the periodic MSE's nearest image), and ``compare_vp_steps`` with it.

* Each kink on its own: replayed on its own inputs, it gives the plain
  function's outputs and gradients bit for bit; replayed on inputs moved
  across a near-tie, it takes the recorded branch, counts the flip and its
  margin (the distance from the tie over the call's largest input).
* The whole step at small widths (hidden 32 and 64): with the kernels'
  plain versions on both sides (the CPU) every reading is 0 and nothing
  flips; with the "kernels" an ulp apart (K8's plain output scaled by
  1 + 2^-22), the forced step is held to phase 11's limits and, where
  nothing flipped, equals the step on the plain path's own branches.
"""

import numpy as np
import pytest
import torch

import chip_smoke as CS
from mansy_immersivevideostreaming_torch.cli import run_models
from mansy_immersivevideostreaming_torch.kernels import attention as K8
from mansy_immersivevideostreaming_torch.models import transformer
from mansy_immersivevideostreaming_torch.models import vp_train as TV
from mansy_immersivevideostreaming_torch.ops.geometry import periodic_mse


def grad_of(fn, *xs):
    xs = [x.clone().requires_grad_(True) for x in xs]
    out = fn(*xs)
    grads = torch.autograd.grad(out.sum(), xs)
    return out.detach(), grads


KINKS = {
    "relu": (lambda k: k.relu, torch.nn.functional.relu),
    "max_pool": (lambda k: (lambda x: k.max_pool1d(x, kernel_size=3, stride=2, padding=1)),
                 lambda x: torch.nn.functional.max_pool1d(x, kernel_size=3, stride=2, padding=1)),
    "periodic": (lambda k: k.periodic_mse, periodic_mse),
}


def kink_inputs(kind):
    rng = np.random.default_rng(3)
    if kind == "periodic":
        return [torch.as_tensor(rng.random((4, 6, 2)), dtype=torch.float32) for _ in range(2)]
    shape = (4, 8) if kind == "relu" else (2, 3, 9)
    return [torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)]


@pytest.mark.parametrize("kind", sorted(KINKS))
def test_kinks_replayed_on_their_own_inputs_are_the_plain_functions(kind):
    wrap, plain = KINKS[kind]
    xs = kink_inputs(kind)
    rec = CS.Kinks()
    wrap(rec)(*xs)
    replay = CS.Kinks(rec.calls)
    out, grads = grad_of(wrap(replay), *xs)
    want, want_grads = grad_of(plain, *xs)
    assert torch.equal(out, want)
    for g, w in zip(grads, want_grads):
        assert torch.equal(g, w)
    assert replay.summary()["flips"] == {} and replay.summary()["largest_margin"] == 0.0


def test_relu_takes_the_recorded_branch_across_a_near_tie():
    x = torch.tensor([-1.0, 1e-7, 0.5, -1e-7])
    rec = CS.Kinks()
    rec.relu(x)
    moved = torch.tensor([-1.0, -1e-7, 0.5, 1e-7])  # entries 1 and 3 cross 0
    replay = CS.Kinks(rec.calls)
    out, (g,) = grad_of(replay.relu, moved)
    assert torch.equal(out, torch.tensor([0.0, -1e-7, 0.5, 0.0]))
    assert torch.equal(g, torch.tensor([0.0, 1.0, 1.0, 0.0]))
    assert replay.flips == {"relu": 2}
    assert replay.margin == pytest.approx(1e-7)


def test_max_pool_takes_the_recorded_index_across_a_near_tie():
    x = torch.tensor([[[0.0, 1.0, 0.9999, 0.0, 0.0]]])
    rec = CS.Kinks()
    rec.max_pool1d(x, kernel_size=3, stride=2, padding=1)
    moved = x.clone()
    moved[0, 0, 2] = 1.0001  # the middle window's maximum moves to index 2
    replay = CS.Kinks(rec.calls)
    out, (g,) = grad_of(lambda v: replay.max_pool1d(v, kernel_size=3, stride=2, padding=1),
                        moved)
    assert torch.equal(out, torch.tensor([[[1.0, 1.0, 0.0]]]))
    assert torch.equal(g, torch.tensor([[[0.0, 2.0, 0.0, 1.0, 0.0]]]))
    assert replay.flips == {"max_pool": 1}
    assert replay.margin == pytest.approx(1e-4 / 1.0001, rel=1e-3)


def test_periodic_mse_takes_the_recorded_image_across_a_near_tie():
    a = torch.tensor([[[0.75, 0.5]]])
    b = torch.tensor([[[0.2501, 0.5]]])  # |a - b| = 0.4999: the direct image
    rec = CS.Kinks()
    rec.periodic_mse(a, b)
    moved = torch.tensor([[[0.2499, 0.5]]])  # |a - b| = 0.5001: the image a - 1 is nearer
    replay = CS.Kinks(rec.calls)
    out, (ga, _) = grad_of(replay.periodic_mse, a, moved)
    d = float(a[0, 0, 0] - moved[0, 0, 0])
    assert float(out) == pytest.approx(d * d / 2, rel=1e-6)
    assert float(ga[0, 0, 0]) == pytest.approx(d, rel=1e-6)  # d/da (a - b)^2 / 2
    assert replay.flips == {"periodic": 1}
    assert replay.margin == pytest.approx(2e-4 / 0.5001, rel=1e-2)


def test_a_replay_refuses_another_sequence_of_calls():
    x = torch.ones(3)
    rec = CS.Kinks()
    rec.relu(x)
    with pytest.raises(AssertionError, match="recorded relu"):
        CS.Kinks(rec.calls).max_pool1d(torch.ones(1, 1, 3), kernel_size=3, stride=2, padding=1)


def small_step(hidden: int, bs: int, seed: int, epochs: int, data_seed: int, perm_seed: int):
    """A small MTIO from ``seed``, trained for ``epochs`` on synthetic
    traces from ``data_seed`` in orders from ``perm_seed``, and its
    optimizer and first batch."""
    dev = torch.device("cpu")
    args = run_models.build_parser().parse_args(
        ["--train", "--seed", str(seed), "--hidden-dim", str(hidden), "--bs", str(bs),
         "--device", "cpu"])
    model = run_models.build_model(args, dev).init_like_flax(
        torch.Generator().manual_seed(args.seed))
    opt = TV.make_optimizer(args.lr, 0.01)
    data = CS.vp_train_data(args, 4 * bs, data_seed, dev)
    state = TV.create_train_state(model)
    rng = np.random.default_rng(perm_seed)
    for _ in range(epochs):
        state, _ = TV.train_epoch(model, opt, state, data, bs, rng.permutation(4 * bs), seed)
    return model, opt, {k: v[:bs] for k, v in data.items()}, args.seed


def test_the_forced_step_is_the_step_when_the_paths_agree():
    model, opt, batch, seed = small_step(32, 16, 5, 0, 40, 0)
    r = CS.compare_vp_steps(model, opt, batch, seed)
    assert r["kinks"]["calls"] > 0 and r["kinks"]["flips"] == {}
    assert r["loss_rel_err"] == 0.0 and r["grad_share"] <= 0.0
    assert r["own_branches"]["grad_share"] == r["grad_share"]
    assert r["param_max_abs_err"] == 0.0 and r["batch_stats_max_abs_err"] == 0.0


def ulp_apart(q, k, v, kv_len0=None, keep=None, rate=0.0):
    return K8.attention_plain(q, k, v, kv_len0, keep, rate) * (1 + 2.0 ** -22)


@pytest.mark.parametrize("seeds, flips", [((5, 40, 0), {}), ((6, 41, 1), {"max_pool": 1})],
                         ids=["no_flip", "max_pool_flip"])
def test_the_forced_step_holds_a_path_an_ulp_apart(seeds, flips, monkeypatch):
    """``max_pool_flip``: one max-pool window 6e-8 of the call's largest
    input from its tie flips, and the step on the plain path's own branches
    lies 5.9e-3 of the largest gradient from the kernels' at the
    distillation conv's kernel, past phase 11's 1e-4; the forced step does
    not.  Eight CPU threads: at one or two no window lies that near."""
    threads = torch.get_num_threads()
    torch.set_num_threads(8)  # which windows lie near a tie depends on the CPU's sums
    try:
        model, opt, batch, seed = small_step(64, 64, *seeds[:1], 3, *seeds[1:])
        monkeypatch.setattr(transformer, "attention", ulp_apart)
        r = CS.compare_vp_steps(model, opt, batch, seed)
    finally:
        torch.set_num_threads(threads)
    assert not CS.vp_step_faults(r, CS.VP_LIMITS)
    assert r["kinks"]["flips"] == flips
    assert r["kinks"]["largest_margin"] <= CS.VP_KINK_MARGIN
    if flips:
        assert r["own_branches"]["grad_share"] > CS.VP_GRAD_RTOL >= r["grad_share"]
        assert r["own_branches"]["grad_worst"]["leaf"] == "transformer.distill.conv.weight"
    else:
        assert r["own_branches"]["grad_share"] == r["grad_share"]
