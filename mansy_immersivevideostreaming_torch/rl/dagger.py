"""DAgger: dataset aggregation with the batched MPC expert.

Port of ``mansy_immersivevideostreaming_tpu/rl/dagger.py``: roll out the
current policy and have the MPC expert label every visited state, so the
cloned policy learns recoveries on its own state distribution (Ross et al.,
AISTATS 2011).  A collector step on the card is the observation gather (K2),
the expert's sequence search (K4), the policy's sampling forward (K3) and
the env step (K1); a CE step on the aggregate is K3's training mode, K9 in
CE mode and the K10 backward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mansy_immersivevideostreaming_torch.kernels.actor_critic import (
    actor_critic_forward, gumbel_noise,
)
from mansy_immersivevideostreaming_torch.kernels.observe import pack_obs
from mansy_immersivevideostreaming_torch.models.abr_nets import MansyActorCritic
from mansy_immersivevideostreaming_torch.rl.bc import bc_step
from mansy_immersivevideostreaming_torch.rl.rollout import check_observation
from mansy_immersivevideostreaming_torch.sim.env import reset_env, step_env, viewport_acc_estimate
from mansy_immersivevideostreaming_torch.sim.expert import (
    ExpertTables, causal_bw_estimate, choose_action,
)
from mansy_immersivevideostreaming_torch.sim.tables import SimTables


def make_dagger_collector(tables: SimTables, etables: ExpertTables, horizon: int,
                          n_steps: int, pin_table=None, causal: bool = False,
                          acc_correct=False, with_margin: bool = False):
    """Policy-driven rollout whose every visited state the MPC expert also
    labels.  Returns ``collect(policy, samples, generator=None, noise=None)
    -> (obs [T, N, F] packed, expert_actions i32 [T, N], done [T, N])``,
    with the teacher's margin [T, N] last when ``with_margin``.  Lanes are
    ``samples``' rows (one reset stride for reset and step).  Actions are
    sampled by the Gumbel-max rule with noise from ``generator``, or with
    ``noise`` [T, N, A] when given.

    ``pin_table`` i32 [n_prefs]: preferences with an entry >= 0 are labelled
    with that fixed action (margin +inf) instead of the search.
    ``causal``: the search predicts bandwidth with the harmonic mean of the
    lane's own throughput history.  ``acc_correct``: accuracy-corrected
    scoring at the lane's own accuracy estimate; a bool array [n_prefs]
    switches it per preference."""
    dev = tables.device
    pins = None if pin_table is None else torch.as_tensor(
        np.asarray(pin_table), dtype=torch.int32, device=dev)
    corr_table = None
    if not isinstance(acc_correct, bool):
        corr_table = torch.as_tensor(np.asarray(acc_correct, bool), device=dev)
        acc_correct = True
    A = tables.action_space

    def collect(policy: MansyActorCritic, samples: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        check_observation(policy, tables)
        n = samples.shape[0]
        states = reset_env(tables, samples, torch.arange(n, dtype=torch.int32, device=dev), n)
        w = policy.packed_weights()
        obs = torch.empty((n_steps, n, policy.obs_width(tables)), dtype=torch.float32,
                          device=dev)
        labels, dones, margins = [], [], []
        for t in range(n_steps):
            x = policy.observe(tables, states, out=obs[t])
            qoe_id = states.qoe_id.long()
            out = choose_action(
                tables, etables, states, horizon,
                bw_hat=causal_bw_estimate(tables, states) if causal else None,
                acc_hat=viewport_acc_estimate(states.past_acc) if acc_correct else None,
                use_corr=None if corr_table is None else corr_table[qoe_id],
                return_margin=with_margin)
            label, margin = out if with_margin else (out, None)
            if pins is not None:
                pinned = pins[qoe_id]
                label = torch.where(pinned >= 0, pinned, label)
                if margin is not None:
                    margin = torch.where(pinned >= 0, torch.full_like(margin, float("inf")),
                                         margin)
            g = noise[t] if noise is not None else gumbel_noise((n, A), generator, dev)
            _, _, action, _ = actor_critic_forward(w, x, g)
            states, _, done, _ = step_env(tables, samples, states, action, n, False)
            labels.append(label)
            dones.append(done)
            margins.append(margin)
        out = (obs, torch.stack(labels), torch.stack(dones))
        return out + (torch.stack(margins),) if with_margin else out

    return collect


def flatten_demos(demos, device: str | torch.device = "cpu",
                  action_values: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """List of {'obs': {f: [T, ...]}, 'act': [T]} -> (packed observations
    [n, F] f32, actions i32 [n]) on ``device``: the aggregate's layout,
    packed once.  With ``action_values`` (a policy that reads them), demos
    recorded without the field get the derived values (K2's row mode)."""
    obs = {k: np.concatenate([np.asarray(d["obs"][k]) for d in demos])
           for k in demos[0]["obs"]}
    act = np.concatenate([np.asarray(d["act"]) for d in demos]).astype(np.int32)
    return (pack_obs(obs, device, action_values=action_values),
            torch.as_tensor(act, device=device))


def aggregate(dataset, new_obs: torch.Tensor, new_act: torch.Tensor, done=None,
              weight: float = 1.0, extra_keep=None):
    """Append expert-labelled policy states to the aggregate dataset, all on
    the aggregate's device.

    ``dataset`` is ``(x, act)`` or ``(x, act, w)``: packed observations
    [n, F], actions i32 [n] and ``w`` [n] f32 a per-transition CE sampling
    weight; the result always carries weights (existing transitions default
    to 1.0) and ``weight`` scales the new ones.  ``new_obs`` is the
    collector's packed [T, N, F] buffer; ``new_act``/``done`` [T, N].  Only
    steps up to and including each lane's first episode end are kept (the
    tail after auto-reset would duplicate episode starts); ``extra_keep``
    (bool [T, N]) is ANDed in, e.g. the teacher-confidence mask."""
    x, act = dataset[0], dataset[1]
    dev = x.device
    w = dataset[2] if len(dataset) > 2 else torch.ones(act.shape[0], device=dev)
    T, N = new_act.shape
    keep = torch.ones((T, N), dtype=torch.bool, device=dev)
    if done is not None:
        # no episode end before t: up to and including the first one
        d = torch.as_tensor(done, device=dev).to(torch.int32)
        keep = (d.cumsum(0) - d) == 0
    if extra_keep is not None:
        keep = keep & torch.as_tensor(extra_keep, dtype=torch.bool, device=dev)
    keep = keep.reshape(-1)
    new_x = new_obs.reshape(T * N, -1)[keep]
    new_a = torch.as_tensor(new_act, device=dev).reshape(-1)[keep].to(torch.int32)
    return (torch.cat([x, new_x]), torch.cat([act, new_a]),
            torch.cat([w, torch.full((new_a.shape[0],), float(weight), device=dev)]))


def class_balance_weights(qoe_weight: torch.Tensor, act: torch.Tensor,
                          beta: float = 0.5) -> torch.Tensor:
    """Per-transition CE weight multipliers ``(1 / freq(action | pref))**beta``
    from the aggregate's ``qoe_weight`` columns [n, 3] and actions [n],
    normalized to mean 1 within each preference group, so the balance never
    moves sampling mass between preferences.  Counters the underfit of the
    causal teacher's rare, QoE-critical labels."""
    qoe = torch.round(qoe_weight.double(), decimals=4)
    _, group = torch.unique(qoe, dim=0, return_inverse=True)
    a = act.long()
    counts = torch.zeros((int(group.max()) + 1, 15), dtype=torch.float64, device=act.device)
    counts.index_put_((group, a), torch.ones_like(qoe[:, 0]), accumulate=True)
    freq = counts / counts.sum(1, keepdim=True)
    w = torch.where(counts > 0, (1.0 / freq.clamp(min=1e-9)) ** beta, 0.0)
    per = w[group, a]
    mean = torch.zeros_like(counts[:, 0]).index_add_(0, group, per) / counts.sum(1)
    return (per / mean[group]).float()


def bc_on_aggregate(policy: MansyActorCritic, optimizer: torch.optim.Optimizer, dataset,
                    steps: int, batch_size: int, generator: Optional[torch.Generator] = None,
                    ent_coef: float = 0.1, indices=None):
    """``steps`` minibatch CE steps over the aggregate ``(x, act[, w])`` on
    the policy's device (weighted sampling with replacement when the dataset
    carries unequal weights, else uniform).  ``indices`` [steps, batch]
    replace the draws from ``generator``.  Returns the losses as floats."""
    x_all, act_all = dataset[0], dataset[1]
    n = act_all.shape[0]
    dev = x_all.device
    probs = None
    if len(dataset) > 2 and dataset[2] is not None:
        w = dataset[2].double()
        if not torch.allclose(w, w[0].expand_as(w)):
            probs = (w / w.sum()).float()
    m = min(batch_size, n)
    losses = []
    for i in range(steps):
        if indices is not None:
            idx = torch.as_tensor(np.asarray(indices[i]), device=dev).long()
        elif probs is None:
            idx = torch.randint(0, n, (m,), generator=generator, device=dev)
        else:
            idx = torch.multinomial(probs, m, replacement=True, generator=generator)
        losses.append(bc_step(policy, optimizer, x_all[idx], act_all[idx], ent_coef))
    return torch.stack(losses).tolist() if losses else []
