"""Behavior-cloning initialization from MPC expert demonstrations.

Port of ``mansy_immersivevideostreaming_tpu/rl/bc.py`` (reference
``utils/mansy_utils.py:52-94``): per step one random demo episode,
cross-entropy toward the expert actions minus a 0.1 entropy bonus, an Adam
step; periodic validation over the held-out demos with best-checkpoint
tracking; the identifier co-trained on the same demos for the first
``identifier_max_steps`` steps.  A step on the card is K3's training mode,
K9 in CE mode and the K10 backward.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from mansy_immersivevideostreaming_torch.kernels.actor_critic import actor_critic_forward
from mansy_immersivevideostreaming_torch.kernels.observe import pack_obs
from mansy_immersivevideostreaming_torch.kernels.policy_loss import ce_loss
from mansy_immersivevideostreaming_torch.models.abr_nets import MansyActorCritic, QoEIdentifier
from mansy_immersivevideostreaming_torch.rl.identifier import train_identifier_on_buffer


def bc_step(policy: MansyActorCritic, optimizer: torch.optim.Optimizer, x: torch.Tensor,
            actions: torch.Tensor, ent_coef: float = 0.1) -> torch.Tensor:
    """One ``ce - ent_coef * entropy`` step on packed observations ``x``
    (reference ``mansy_utils.py:67-72`` uses 0.1).  Returns the loss."""
    logits, _ = policy.forward_packed(x)
    loss, _ = ce_loss(logits, actions, ent_coef)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def bc_valid_loss(policy: MansyActorCritic, x: torch.Tensor,
                  actions: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of the policy on packed observations ``x``."""
    with torch.no_grad():
        logits = actor_critic_forward(policy.packed_weights(), x)[0]
        return ce_loss(logits, actions, 0.0)[1][0]


def demo_tensors(demo: Dict[str, Any], device, action_values: bool = False) -> tuple:
    """(packed observations [T, F], actions i32 [T]) of one demo episode;
    with ``action_values`` (a policy that reads them), a demo recorded
    without the field gets the derived values (K2's row mode)."""
    return (pack_obs(demo["obs"], device, action_values=action_values),
            torch.as_tensor(np.asarray(demo["act"]), dtype=torch.int32, device=device))


def behavior_cloning_pretraining(
        policy: MansyActorCritic, optimizer: torch.optim.Optimizer,
        identifier: QoEIdentifier, id_optimizer: torch.optim.Optimizer,
        train_demos: List[Dict[str, Any]], valid_demos: List[Dict[str, Any]],
        max_steps: int, valid_per_step: int, identifier_max_steps: int,
        identifier_update_round: int, seed: int = 0,
        save_policy: Callable[[MansyActorCritic], None] = lambda p: None,
        save_identifier: Callable[[QoEIdentifier], None] = lambda p: None,
        generator: Optional[torch.Generator] = None) -> float:
    """Trains ``policy`` (and ``identifier``) in place; returns the best valid
    loss.  Demos are picked with ``random.Random(seed)``, the same object and
    draws as the JAX package's, so both pick the same demos."""
    rng = random.Random(seed)
    dev = next(policy.parameters()).device
    av = policy.reads_action_values
    valid = [demo_tensors(d, dev, av) for d in valid_demos]
    best_loss, best_step = float("inf"), 0
    for i in range(max_steps):
        x, actions = demo_tensors(rng.choice(train_demos), dev, av)
        loss = bc_step(policy, optimizer, x, actions)
        print(f"BC (Training): loss={float(loss)} ({i + 1}/{max_steps})")

        if i % valid_per_step == 0:
            vloss = float(np.mean([float(bc_valid_loss(policy, vx, va)) for vx, va in valid]))
            if vloss < best_loss:
                best_loss, best_step = vloss, i
                save_policy(policy)
            print(f"BC (Validation): valid loss={vloss} - best loss={best_loss} "
                  f"at step {best_step}")

        if i < identifier_max_steps:
            train_identifier_on_buffer(identifier, id_optimizer, x, generator,
                                       identifier_update_round)
            save_identifier(identifier)
    return best_loss
