"""PPO update.

Port of ``mansy_immersivevideostreaming_tpu/rl/ppo.py`` (hyperparameters of
the reference's tianshou configuration, reference ``run_mansy.py:231-251``):
clip 0.2, value clip, per-minibatch advantage normalization, entropy coef,
vf coef 0.5, grad-norm clip 1, optional return normalization by the running
std (``rew_norm=1``), gamma 0.95, gae-lambda 0.95, ``repeat`` epochs over
shuffled minibatches.

One minibatch step on the card is K3's training-mode forward on a row gather
of the collector's packed observation buffer, the K9 loss head, the K10
backward, the global-norm clip and Adam.  GAE is K6, once an update.

Given a sharded ``mesh`` (``parallel/mesh.py``), the update is JAX's
update over a ``data`` mesh: every rank holds the whole (gathered)
trajectory, so GAE, the return normalisation and the minibatch
permutations are the same everywhere; each rank runs a minibatch step on
its ``1/world`` of the minibatch's rows, with the advantages normalised
over the whole minibatch first, and the gradients are averaged over the
ranks before the clip and Adam.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import torch

from mansy_immersivevideostreaming_torch.kernels.gae import compute_gae
from mansy_immersivevideostreaming_torch.kernels.policy_loss import (
    LossSpec, normalized_advantages, ppo_loss,
)
from mansy_immersivevideostreaming_torch.models.abr_nets import MansyActorCritic
from mansy_immersivevideostreaming_torch.parallel.mesh import Mesh, mean_gradients, sum_tensors
from mansy_immersivevideostreaming_torch.rl.types import RunningStat, Transition


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    gamma: float = 0.95
    gae_lambda: float = 0.95
    eps_clip: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.02
    max_grad_norm: float = 1.0
    value_clip: bool = True
    norm_adv: bool = True
    rew_norm: bool = True
    repeat: int = 2          # repeat_per_collect
    minibatch: int = 512
    # normalize advantages within each QoE preference group instead of over
    # the whole minibatch
    norm_adv_per_pref: bool = False
    n_prefs: int = 4


def make_optimizer(params: Iterable[torch.Tensor], lr: float,
                   weight_decay: float = 1e-2) -> torch.optim.Adam:
    """Adam with coupled L2 weight decay (reference ``run_mansy.py:216``): the
    JAX package's ``add_decayed_weights`` -> ``scale_by_adam`` -> ``scale(-lr)``
    chain is this update.  Every parameter must get a gradient tensor (zeros
    where the loss does not reach), as ``jax.grad`` gives one, or Adam skips
    its decay."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def clip_grad_norm(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients by ``min(1, max_norm / (gnorm + 1e-8))`` (JAX
    ``ppo.py:166-167``; ``torch.nn.utils.clip_grad_norm_`` adds 1e-6).
    Returns the global norm, without a host sync."""
    grads = [p.grad for p in params]
    gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.clamp(max_norm / (gnorm + 1e-8), max=1.0)
    torch._foreach_mul_(grads, scale)
    return gnorm


def ppo_update(policy: MansyActorCritic, optimizer: torch.optim.Optimizer, cfg: PPOConfig,
               traj: Transition, rewards: torch.Tensor, last_values: torch.Tensor,
               ret_rms: RunningStat, generator: Optional[torch.Generator] = None,
               ent_coef: Optional[float] = None,
               anchor_logits: Optional[torch.Tensor] = None, kl_coef=0.0,
               pref_ids: Optional[torch.Tensor] = None,
               perms: Optional[torch.Tensor] = None, mesh: Optional[Mesh] = None):
    """Full PPO update on a [T, N] trajectory with (possibly reshaped)
    ``rewards``; ``policy`` and ``optimizer`` are updated in place.  Returns
    (ret_rms, metrics: mean loss, loss/clip, loss/vf, loss/ent over every
    minibatch, as 0-d tensors).

    ``ent_coef`` overrides ``cfg.ent_coef`` (entropy annealing).
    ``anchor_logits`` [T, N, A] with ``kl_coef`` (a float, or a per-preference
    sequence read at ``pref_ids``) adds KL(anchor || pi).  ``pref_ids`` [T, N]
    i32 enables ``cfg.norm_adv_per_pref``.  ``perms`` [repeat, n_mb, mb]
    replaces the minibatch permutations drawn from ``generator`` (each
    epoch permutes the T*N rows flattened time-major and drops the tail past
    ``n_mb * mb``, JAX ``ppo.py:158``).  With a sharded ``mesh`` the
    minibatch must split over the ranks (see the module docstring)."""
    ent_coef = cfg.ent_coef if ent_coef is None else float(ent_coef)
    T, N = rewards.shape
    dev = rewards.device
    adv, ret = compute_gae(rewards.contiguous(), traj.done.contiguous(),
                           traj.value.contiguous(), last_values.contiguous(),
                           cfg.gamma, cfg.gae_lambda)
    if cfg.rew_norm:
        # tianshou-0.4.8 semantics: only the returns (value targets) are
        # divided by the running std from before this update; advantages stay
        # raw until the minibatch normalization
        ret_n = ret / torch.sqrt(ret_rms.var + 1e-8)
        ret_rms = ret_rms.update(ret)
    else:
        ret_n = ret
    total = T * N
    flat = {"obs": traj.obs.reshape(total, -1), "action": traj.action.reshape(-1),
            "log_prob": traj.log_prob.reshape(-1), "value": traj.value.reshape(-1),
            "adv": adv.reshape(-1), "ret": ret_n.reshape(-1)}
    if anchor_logits is not None:
        flat["anchor_logits"] = anchor_logits.reshape(total, -1)
    if pref_ids is not None:
        flat["pref_id"] = pref_ids.reshape(-1).to(torch.int32)
    kl = torch.as_tensor(kl_coef, dtype=torch.float32, device=dev)
    mb_size = min(cfg.minibatch, total)
    n_mb = total // mb_size
    if perms is None:
        perms = torch.stack([
            torch.randperm(total, generator=generator, device=dev)[:n_mb * mb_size]
            .reshape(n_mb, mb_size) for _ in range(cfg.repeat)])
    perms = torch.as_tensor(perms, device=dev).long()
    if perms.shape != (cfg.repeat, n_mb, mb_size):
        raise ValueError(f"ppo_update: perms must be [{cfg.repeat}, {n_mb}, {mb_size}]")
    sharded = mesh is not None and mesh.sharded
    rows = mesh.rows(mb_size) if sharded else slice(None)
    params = list(policy.parameters())
    metrics = []
    for idx in perms.reshape(-1, mb_size):
        mb = {k: v[idx] for k, v in flat.items()}
        spec = LossSpec(
            action=mb["action"], ent_coef=ent_coef, old_log_prob=mb["log_prob"],
            old_value=mb["value"], adv=mb["adv"], ret=mb["ret"], pref_id=mb.get("pref_id"),
            anchor_logits=mb.get("anchor_logits"),
            kl_coef=kl if anchor_logits is not None else None, eps_clip=cfg.eps_clip,
            vf_coef=cfg.vf_coef, value_clip=cfg.value_clip, norm_adv=cfg.norm_adv,
            norm_adv_per_pref=cfg.norm_adv_per_pref and pref_ids is not None,
            n_prefs=cfg.n_prefs, mode="ppo")
        if sharded:
            # the whole minibatch's advantage statistics, then the rank's rows
            spec = spec._replace(adv=normalized_advantages(spec), norm_adv=False,
                                 norm_adv_per_pref=False)
            spec = spec._replace(**{f: getattr(spec, f)[rows].contiguous() for f in (
                "action", "old_log_prob", "old_value", "adv", "ret", "pref_id",
                "anchor_logits") if getattr(spec, f) is not None})
        logits, value = policy.forward_packed(mb["obs"][rows])
        loss, terms = ppo_loss(logits, value, spec)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if sharded:
            mean_gradients(mesh, params)
        clip_grad_norm(params, cfg.max_grad_norm)
        optimizer.step()
        metrics.append(torch.cat([loss.detach()[None], terms]))
    m = torch.stack(metrics).mean(0)
    if sharded:
        m = sum_tensors(mesh, [m])[0] / mesh.world
    return ret_rms, {"loss": m[0], "loss/clip": m[1], "loss/vf": m[2], "loss/ent": m[3]}
