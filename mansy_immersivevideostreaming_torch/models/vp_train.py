"""Training and evaluation steps of the viewport-prediction models.

Port of the JAX package's ``models/vp_train.py`` (reference
``viewport_prediction/run_models.py:17-67``).  The JAX steps apply Flax
params and ``batch_stats`` held in a ``VPTrainState``; here the module
holds its parameters and BatchNorm statistics itself (updated in place by
:func:`train_step`), and :class:`VPTrainState` carries the optimizer's
state and the step count.  :class:`VPState` is the two Flax collections in
the JAX package's layout (flat, "/"-keyed numpy arrays), as the ``.npz``
files hold them (``utils/checkpoint.py``).

:func:`train_step` is ``_train_step`` (``:50-68``): the training forward
(``ViewportTransformerMTIO.forward``, its draws from a generator seeded by
the run's seed and the step, as JAX folds the step into its key), the loss,
its gradient by autograd (K8's backward kernel on the card) and AdamW
written out in optax's order (:func:`adamw_update`).  :func:`train_epoch`
runs it over an epoch's permutation, the last partial batch dropped
(``:75-97``), the losses kept on the device.

Given a sharded ``mesh`` (``parallel/mesh.py``, more than one rank), a
step is JAX's step over a ``data`` mesh: every rank holds the whole batch
and draws the slots and keep masks of the whole batch from the same
generator, and computes its rows' share of the loss
(``transformer.batch_shard``: the BatchNorm statistics are the global
batch's); the shares' gradients are summed over the ranks before AdamW,
so the parameters stay the same bits on every rank.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from mansy_immersivevideostreaming_torch.models.mtio import ViewportTransformerMTIO
from mansy_immersivevideostreaming_torch.models.transformer import batch_shard
from mansy_immersivevideostreaming_torch.ops.geometry import periodic_mse
from mansy_immersivevideostreaming_torch.parallel.mesh import Mesh, sum_tensors


class VPState(NamedTuple):
    """Flax ``params`` and ``batch_stats`` of an MTIO model, flat and
    "/"-keyed (``transformer/distill/BatchNorm_0/mean``, ...)."""
    params: Dict[str, np.ndarray]
    batch_stats: Dict[str, np.ndarray]


class AdamW(NamedTuple):
    """``optax.adamw`` with torch's defaults (``vp_train.py:30-32``); the
    decay applies to every parameter."""
    lr: float
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


class VPTrainState(NamedTuple):
    """What a training run carries besides the module: the steps taken
    (``VPTrainState.step``, which seeds each step's draws) and optax's
    ``ScaleByAdamState`` (count, mu, nu), mu and nu in
    ``model.parameters()`` order."""
    step: int
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def make_optimizer(lr: float, weight_decay: float = 0.01) -> AdamW:
    """AdamW with torch defaults (reference ``run_models.py:29``)."""
    return AdamW(lr, weight_decay)


def create_train_state(model: torch.nn.Module) -> VPTrainState:
    """Step 0 and zero moments for ``model``'s parameters (the module's
    weights are its own: ``init_like_flax`` or a loaded npz)."""
    zeros = [torch.zeros_like(p) for p in model.parameters()]
    return VPTrainState(0, 0, zeros, [torch.zeros_like(z) for z in zeros])


@torch.no_grad()
def adamw_update(opt: AdamW, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                 state: VPTrainState) -> VPTrainState:
    """One AdamW step in optax's order (``scale_by_adam``,
    ``add_decayed_weights``, ``scale_by_learning_rate``, ``apply_updates``):
    mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, the bias corrections
    1 - b^count in f32, u = mu_hat / (sqrt(nu_hat) + eps) + wd p, and
    p + (-lr) u.  ``torch.optim.AdamW`` decays p first, which rounds
    differently.  The parameters are updated in place; returns the state
    with the new moments."""
    count = state.count + 1
    f32 = np.float32
    bc1 = float(f32(1) - f32(opt.b1) ** f32(count))
    bc2 = float(f32(1) - f32(opt.b2) ** f32(count))
    grads = list(grads)
    mu = torch._foreach_add(torch._foreach_mul(grads, 1 - opt.b1),
                            torch._foreach_mul(state.mu, opt.b1))
    nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - opt.b2),
                            torch._foreach_mul(state.nu, opt.b2))
    denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), opt.eps)
    u = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
    u = torch._foreach_add(u, torch._foreach_mul(list(params), opt.weight_decay))
    torch._foreach_add_(list(params), torch._foreach_mul(u, -opt.lr))
    return state._replace(count=count, mu=mu, nu=nu)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of a training step's draws (slots, dropout masks),
    seeded by the run's seed and the step, as ``_train_step`` folds the step
    into the run's key: a resumed run draws what an unbroken one would."""
    return torch.Generator(device=device).manual_seed(seed * 2 ** 32 + step)


def train_step(model: ViewportTransformerMTIO, opt: AdamW, state: VPTrainState,
               batch: Mapping[str, torch.Tensor], seed: int, perms=None, repeat=None,
               mesh: Optional[Mesh] = None) -> Tuple[VPTrainState, torch.Tensor]:
    """One AdamW step on the MTIO loss (``vp_train.py:50-68``; reference
    ``run_models.py:37-45``); ``perms`` and ``repeat`` fix the slot draws
    (tests pass JAX's).  With a sharded ``mesh``, ``batch`` is the global
    batch on every rank (see the module docstring).  Returns (the new
    state, the loss on the device)."""
    gen = step_generator(seed, state.step, batch["history"].device)
    params = list(model.parameters())
    if mesh is None or not mesh.sharded:
        pred, gt = model(batch["history"], batch["current"], batch["future"], train=True,
                         perms=perms, repeat=repeat, generator=gen)
        loss = model.loss_function(pred, gt)
        grads = torch.autograd.grad(loss, params)
    else:
        B = batch["history"].shape[0]
        with batch_shard(mesh, B) as shard:
            pred, gt = model(batch["history"], batch["current"], batch["future"], train=True,
                             perms=perms, repeat=repeat, generator=gen)
            # the rank's rows' share of the global mean
            share = model.loss_function(pred, gt) * ((shard.rows.stop - shard.rows.start) / B)
            grads = torch.autograd.grad(share, params)
        *grads, loss = sum_tensors(mesh, list(grads) + [share.detach()])
    state = adamw_update(opt, params, grads, state)
    return state._replace(step=state.step + 1), loss.detach()


def train_epoch(model: ViewportTransformerMTIO, opt: AdamW, state: VPTrainState,
                data: Mapping[str, torch.Tensor], batch_size: int, perm, seed: int,
                mesh: Optional[Mesh] = None) -> Tuple[VPTrainState, torch.Tensor]:
    """A full epoch (``vp_train.py:75-97``): ``data`` holds the whole split
    on the model's device, ``perm`` the epoch's index order; the batches
    are its consecutive ``batch_size`` slices, the last partial one
    dropped (``run_models``' data-parallel loop, ``drop_remainder=True``,
    with a sharded ``mesh``).  Returns (state, the per-batch losses
    [n_batches] on the device: reading them is the epoch's one sync)."""
    dev = data["history"].device
    n_batches = len(perm) // batch_size
    idx = torch.as_tensor(np.asarray(perm[:n_batches * batch_size]), device=dev)
    losses = []
    for ib in idx.reshape(n_batches, batch_size):
        state, loss = train_step(model, opt, state, {k: v[ib] for k, v in data.items()}, seed,
                                 mesh=mesh)
        losses.append(loss)
    return state, (torch.stack(losses) if losses else torch.zeros(0, device=dev))


def sample_step(model: ViewportTransformerMTIO, history: torch.Tensor,
                current: torch.Tensor) -> torch.Tensor:
    """Batched autoregressive inference (reference ``mtio.py:106-133``)."""
    return model.sample(history, current)


def valid_step(model: ViewportTransformerMTIO, batch: Mapping[str, torch.Tensor]
               ) -> torch.Tensor:
    """Mean periodic MSE of the sampled predictions (reference
    ``run_models.py:52-58``)."""
    pred = model.sample(batch["history"], batch["current"])
    return periodic_mse(pred, batch["future"]).mean()
