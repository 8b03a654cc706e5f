"""QoE-preference identifier: training and reward shaping.

Port of ``mansy_immersivevideostreaming_tpu/rl/identifier.py`` (reference
``utils/mansy_utils.py:9-49`` and ``models/mansy_ppo.py:36-59``): the
identifier predicts the normalized QoE preference from the observation and
the previous action stored in it; the policy's reward is shaped toward
behaviour that reveals its preference.  The whole buffer is one batched
forward over the collector's packed observations.

As in the reference, the action the identifier reads is the one-hot stored
inside the observation, i.e. the previous step's action
(``mansy_ppo.py:44-45``), the ``action_one_hot`` columns of the buffer.

Randomness comes from a ``torch.Generator``; the tests inject the
permutations and minibatch indices instead.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mansy_immersivevideostreaming_torch.models.abr_nets import QoEIdentifier


def _mse(identifier: QoEIdentifier, x: torch.Tensor) -> torch.Tensor:
    return ((identifier(x) - identifier.target(x)) ** 2).mean()


def identifier_rewards(identifier: QoEIdentifier, x: torch.Tensor) -> torch.Tensor:
    """1 - MSE(identifier(obs), qoe_weight) per row of the packed
    observations ``x`` [B, F] (reference ``mansy_utils.py:42-49``)."""
    with torch.no_grad():
        return 1.0 - ((identifier(x) - identifier.target(x)) ** 2).mean(-1)


def shape_rewards(qoe_rewards: torch.Tensor, id_rewards: torch.Tensor,
                  lamb: float) -> torch.Tensor:
    """reward <- (1-λ)·qoe + λ·identifier (reference ``mansy_ppo.py:48``)."""
    return (1.0 - lamb) * qoe_rewards + lamb * id_rewards


def center_rewards_by_preference(id_rewards: torch.Tensor, qoe_weight: torch.Tensor,
                                 prefs: torch.Tensor) -> torch.Tensor:
    """Subtract each preference group's batch mean from the identifier reward
    (``--id-reward-center``): a fitted identifier's ``1 - MSE`` is a
    near-constant bonus per preference, which at λ = 0.5 drowns the QoE
    gradient; centering leaves only its variation.  ``qoe_weight`` [..., 3]
    aligns with ``id_rewards``; ``prefs`` [K, 3] is the normalized training
    preference set (a row's group is its nearest preference)."""
    flat_r = id_rewards.reshape(-1)
    flat_w = qoe_weight.reshape(-1, qoe_weight.shape[-1])
    dist = ((flat_w[:, None, :] - prefs[None, :, :]) ** 2).sum(-1)
    onehot = F.one_hot(dist.argmin(-1), prefs.shape[0]).to(flat_r.dtype)
    group_sum = onehot.t() @ flat_r
    group_cnt = torch.clamp(onehot.sum(0), min=1.0)
    return (flat_r - onehot @ (group_sum / group_cnt)).reshape(id_rewards.shape)


def identifier_step(identifier: QoEIdentifier, optimizer: torch.optim.Optimizer,
                    x: torch.Tensor) -> torch.Tensor:
    """One MSE step on the packed observations ``x``; returns the loss."""
    loss = _mse(identifier, x)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_identifier_on_buffer(identifier: QoEIdentifier, optimizer: torch.optim.Optimizer,
                               x: torch.Tensor, generator: Optional[torch.Generator] = None,
                               update_round: int = 2, train_ratio: float = 0.8,
                               perm: Optional[torch.Tensor] = None):
    """80/20-shuffled identifier training over the fresh buffer (reference
    ``mansy_utils.py:9-39``): ``update_round`` full-batch MSE steps on the
    train rows.  ``perm`` replaces the shuffle drawn from ``generator``.
    Returns (train losses [update_round], valid loss), as tensors."""
    n = x.shape[0]
    if perm is None:
        perm = torch.randperm(n, generator=generator, device=x.device)
    perm = torch.as_tensor(perm, device=x.device).long()
    n_train = int(n * train_ratio)
    train_x, valid_x = x[perm[:n_train]], x[perm[n_train:]]
    losses = torch.stack([identifier_step(identifier, optimizer, train_x)
                          for _ in range(update_round)])
    with torch.no_grad():
        return losses, _mse(identifier, valid_x)


def pretrain_identifier_on_demos(identifier: QoEIdentifier, optimizer: torch.optim.Optimizer,
                                 x: torch.Tensor, steps: int, batch_size: int,
                                 generator: Optional[torch.Generator] = None,
                                 valid_ratio: float = 0.1,
                                 perm: Optional[torch.Tensor] = None,
                                 indices: Optional[torch.Tensor] = None):
    """Minibatch-MSE pretraining on an expert-demo aggregate before PPO
    starts, so the shaping reward is informative from the first step.
    ``perm`` (the train/valid split) and ``indices`` [steps, batch] replace
    the draws from ``generator``.  Returns (train losses, valid loss) as
    floats."""
    n = x.shape[0]
    if perm is None:
        perm = torch.randperm(n, generator=generator, device=x.device)
    perm = torch.as_tensor(perm, device=x.device).long()
    n_valid = max(int(n * valid_ratio), 1)
    train_x, valid_x = x[perm[n_valid:]], x[perm[:n_valid]]
    n_train = train_x.shape[0]
    losses = []
    for s in range(steps):
        if indices is None:
            idx = torch.randint(0, n_train, (min(batch_size, n_train),), generator=generator,
                                device=x.device)
        else:
            idx = torch.as_tensor(indices[s], device=x.device).long()
        losses.append(identifier_step(identifier, optimizer, train_x[idx]))
    with torch.no_grad():
        valid = _mse(identifier, valid_x)
    return [float(v) for v in torch.stack(losses).tolist()] if losses else [], float(valid)
