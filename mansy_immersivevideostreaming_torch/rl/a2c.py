"""A2C update (the simple_rl baseline's algorithm).

Port of ``mansy_immersivevideostreaming_tpu/rl/a2c.py`` (the reference's
tianshou ``A2CPolicy`` configuration, reference ``run_simple_rl.py:194-208``):
GAE, vf_coef, ent_coef, the global-norm clip, optional return normalisation,
and RMSprop as optax writes it.

One minibatch step on the card is K3's training-mode forward on a row gather
of the collector's packed simple_rl observations, K9 in A2C mode, the K10
backward, the clip and RMSprop.  GAE is K6, once an update.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch

from mansy_immersivevideostreaming_torch.kernels.gae import compute_gae
from mansy_immersivevideostreaming_torch.kernels.policy_loss import LossSpec, a2c_loss
from mansy_immersivevideostreaming_torch.models.abr_nets import SimpleActorCritic
from mansy_immersivevideostreaming_torch.rl.ppo import clip_grad_norm
from mansy_immersivevideostreaming_torch.rl.types import RunningStat, Transition


@dataclasses.dataclass(frozen=True)
class A2CConfig:
    gamma: float = 0.99
    gae_lambda: float = 0.95
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 1.0
    rew_norm: bool = True
    minibatch: int = 512
    repeat: int = 1  # repeat_per_collect


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr, decay, eps)`` (JAX ``a2c.py:34-37``): nu <- decay nu
    + (1 - decay) g^2 from nu = 0, then p <- p - lr g / sqrt(nu + eps).  The
    eps sits inside the square root; ``torch.optim.RMSprop`` adds it outside,
    which moves the first steps of a parameter with a small gradient."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float, decay: float = 0.99,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            grads = [p.grad for p in params]
            nus = []
            for p in params:
                state = self.state[p]
                if "nu" not in state:
                    state["nu"] = torch.zeros_like(p)
                nus.append(state["nu"])
            torch._foreach_mul_(nus, group["decay"])
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - group["decay"])
            denom = torch._foreach_sqrt(torch._foreach_add(nus, group["eps"]))
            torch._foreach_addcdiv_(params, grads, denom, value=-group["lr"])


def make_optimizer(params: Iterable[torch.Tensor], lr: float) -> RMSprop:
    """torch RMSprop's defaults (alpha 0.99, eps 1e-8; reference
    ``run_simple_rl.py:189``), with optax's eps inside the square root."""
    return RMSprop(params, lr, decay=0.99, eps=1e-8)


def a2c_update(policy: SimpleActorCritic, optimizer: torch.optim.Optimizer, cfg: A2CConfig,
               traj: Transition, last_values: torch.Tensor, ret_rms: RunningStat,
               generator: Optional[torch.Generator] = None,
               perms: Optional[torch.Tensor] = None):
    """tianshou-0.4.8 A2C semantics on a [T, N] trajectory: with ``rew_norm``
    the value targets (returns) are divided by the running return std from
    before this update, while advantages stay unnormalised; the batch is
    split into ``minibatch``-sized slices and swept ``repeat`` times.
    ``policy`` and ``optimizer`` are updated in place.  Returns (ret_rms,
    metrics: loss, loss/actor, loss/vf, loss/ent, each the mean over every
    minibatch step, as 0-d tensors).

    ``perms`` [repeat, n_mb, mb] replaces the minibatch permutations drawn
    from ``generator`` (each epoch permutes the T*N rows flattened
    time-major and keeps the first ``n_mb * mb``, JAX ``a2c.py:84``)."""
    T, N = traj.reward.shape
    dev = traj.reward.device
    adv, ret = compute_gae(traj.reward.contiguous(), traj.done.contiguous(),
                           traj.value.contiguous(), last_values.contiguous(), cfg.gamma,
                           cfg.gae_lambda)
    if cfg.rew_norm:
        ret_n = ret / torch.sqrt(ret_rms.var + 1e-8)
        ret_rms = ret_rms.update(ret)
    else:
        ret_n = ret
    total = T * N
    flat = {"obs": traj.obs.reshape(total, -1), "action": traj.action.reshape(-1),
            "adv": adv.reshape(-1), "ret": ret_n.reshape(-1)}
    mb_size = min(cfg.minibatch, total)
    n_mb = total // mb_size
    if perms is None:
        perms = torch.stack([
            torch.randperm(total, generator=generator, device=dev)[:n_mb * mb_size]
            .reshape(n_mb, mb_size) for _ in range(cfg.repeat)])
    perms = torch.as_tensor(perms, device=dev).long()
    if perms.shape != (cfg.repeat, n_mb, mb_size):
        raise ValueError(f"a2c_update: perms must be [{cfg.repeat}, {n_mb}, {mb_size}]")
    params = list(policy.parameters())
    metrics = []
    for idx in perms.reshape(-1, mb_size):
        mb = {k: v[idx] for k, v in flat.items()}
        logits, value = policy.forward_packed(mb["obs"])
        spec = LossSpec(action=mb["action"], ent_coef=cfg.ent_coef, adv=mb["adv"],
                        ret=mb["ret"], vf_coef=cfg.vf_coef)
        loss, terms = a2c_loss(logits, value, spec)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        clip_grad_norm(params, cfg.max_grad_norm)
        optimizer.step()
        metrics.append(torch.cat([loss.detach()[None], terms]))
    m = torch.stack(metrics).mean(0)
    return ret_rms, {"loss": m[0], "loss/actor": m[1], "loss/vf": m[2], "loss/ent": m[3]}
