"""Vectorized on-policy rollout collection.

Port of ``mansy_immersivevideostreaming_tpu/rl/rollout.py``: N lanes x T
steps, a Python loop over T in place of ``lax.scan``.  Each step is three
kernel launches on the card: the observation gather (K2) into the step's
slice of the trajectory buffer, the actor-critic forward with the sampling
head (K3), and the fused env step (K1), which updates the lanes in place.
The policy decides the observation (``policy.observe``): K2's MANSY mode for
``MansyActorCritic`` (its derived mode for a policy that reads action values
on tables without them), its simple mode for the simple_rl baseline's
``SimpleActorCritic``, as the JAX collector takes ``observe_mansy`` or
``observe_simple``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from mansy_immersivevideostreaming_torch.kernels.actor_critic import (
    actor_critic_forward, gumbel_noise,
)
from mansy_immersivevideostreaming_torch.models.abr_nets import (
    MansyActorCritic, SimpleActorCritic,
)
from mansy_immersivevideostreaming_torch.rl.types import Transition
from mansy_immersivevideostreaming_torch.sim.env import EnvState, LogRecord, reset_env, step_env
from mansy_immersivevideostreaming_torch.sim.tables import SimTables

Policy = Union[MansyActorCritic, SimpleActorCritic]


def init_lanes(tables: SimTables, samples: torch.Tensor, n_lanes: int,
               seed: int = 0) -> EnvState:
    """N independent lanes with worker-strided sample pointers (reference
    seeds workers at ``seed % worker_num`` and strides by worker count,
    ``mansy_env.py:56,100-101``)."""
    starts = (seed + torch.arange(n_lanes, dtype=torch.int32, device=samples.device)) \
        % samples.shape[0]
    return reset_env(tables, samples, starts.to(torch.int32), n_lanes)


def check_observation(policy: Policy, tables: SimTables) -> None:
    """A policy trained on the exact action values needs tables that carry
    them; one that reads action values on tables without them reads the
    derived ones (JAX ``abr_nets.py:_action_value_features``'s rule)."""
    if policy.exact_action_values and tables.av_quality is None:
        raise ValueError("the policy reads the exact action_values observation field: attach "
                         "the expert's tables first (sim.expert.attach_action_values)")


def stack_logs(logs) -> LogRecord:
    """A list of per-step LogRecords [N] -> one LogRecord [T, N]."""
    return LogRecord(*(torch.stack(field) for field in zip(*logs)))


def make_collector(tables: SimTables, samples: torch.Tensor,
                   n_lanes: int, n_steps: int, train: bool = True):
    """Build a collector.

    Returns ``collect(policy, states, generator) -> (new_states, Transition
    [T, N, ...], LogRecord [T, N], last_values [N])``; the transition's
    observations are the packed [T, N, F] buffer of the policy's
    observation.  Actions are sampled
    with Gumbel noise drawn from ``generator`` (a ``torch.Generator`` on the
    lanes' device).  On the card ``states`` is updated in place and returned.
    """
    A = tables.action_space

    def collect(policy: Policy, states: EnvState, generator: Optional[torch.Generator]):
        check_observation(policy, tables)
        dev = states.buf.device
        w = policy.packed_weights()
        obs = torch.empty((n_steps, n_lanes, policy.obs_width(tables)), dtype=torch.float32,
                          device=dev)
        actions, log_probs, values, rewards, dones, logs = [], [], [], [], [], []
        for t in range(n_steps):
            x = policy.observe(tables, states, out=obs[t])
            noise = gumbel_noise((n_lanes, A), generator, dev)
            _, value, action, log_prob = actor_critic_forward(w, x, noise)
            states, reward, done, log = step_env(tables, samples, states, action,
                                                 n_lanes, train)
            actions.append(action)
            log_probs.append(log_prob)
            values.append(value)
            rewards.append(reward)
            dones.append(done)
            logs.append(log)
        _, last_values, _, _ = actor_critic_forward(w, policy.observe(tables, states))
        traj = Transition(obs=obs, action=torch.stack(actions),
                          log_prob=torch.stack(log_probs), value=torch.stack(values),
                          reward=torch.stack(rewards), done=torch.stack(dones))
        return states, traj, stack_logs(logs), last_values

    return collect


def flatten_time(tree):
    """[T, N, ...] -> [T*N, ...] over a NamedTuple of tensors."""
    if isinstance(tree, tuple):
        return type(tree)(*(flatten_time(x) for x in tree))
    return tree.reshape((-1,) + tuple(tree.shape[2:]))
