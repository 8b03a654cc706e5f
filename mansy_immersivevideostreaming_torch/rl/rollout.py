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

Given a sharded ``mesh`` (``parallel/mesh.py``), each rank steps its
contiguous ``1/world`` of the lanes, as JAX's collector does with the lanes
sharded over a ``data`` mesh: the lanes start where a one-process run's
would (``init_lanes`` is a function of ``seed + lane``), the sampling noise
is drawn for every lane and each rank keeps its lanes' rows, and the
trajectory, the episode logs and the bootstrap values are gathered over
the ranks at the end of the collect, so every rank updates on the whole
of it.
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
from mansy_immersivevideostreaming_torch.parallel.mesh import Mesh, all_gather_cat, gather_tree
from mansy_immersivevideostreaming_torch.rl.types import Transition
from mansy_immersivevideostreaming_torch.sim.env import EnvState, LogRecord, reset_env, step_env
from mansy_immersivevideostreaming_torch.sim.tables import SimTables

Policy = Union[MansyActorCritic, SimpleActorCritic]


def lane_rows(mesh: Optional[Mesh], n_lanes: int) -> slice:
    """The lanes a rank steps: all of them unless ``mesh`` is sharded."""
    return mesh.rows(n_lanes) if mesh is not None and mesh.sharded else slice(None)


def init_lanes(tables: SimTables, samples: torch.Tensor, n_lanes: int,
               seed: int = 0, mesh: Optional[Mesh] = None) -> EnvState:
    """N independent lanes with worker-strided sample pointers (reference
    seeds workers at ``seed % worker_num`` and strides by worker count,
    ``mansy_env.py:56,100-101``); with a sharded ``mesh``, the rank's
    lanes of them."""
    starts = (seed + torch.arange(n_lanes, dtype=torch.int32, device=samples.device)) \
        % samples.shape[0]
    return reset_env(tables, samples, starts[lane_rows(mesh, n_lanes)].to(torch.int32),
                     n_lanes)


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
                   n_lanes: int, n_steps: int, train: bool = True,
                   mesh: Optional[Mesh] = None):
    """Build a collector.

    Returns ``collect(policy, states, generator) -> (new_states, Transition
    [T, N, ...], LogRecord [T, N], last_values [N])``; the transition's
    observations are the packed [T, N, F] buffer of the policy's
    observation.  Actions are sampled
    with Gumbel noise drawn from ``generator`` (a ``torch.Generator`` on the
    lanes' device).  On the card ``states`` is updated in place and returned.
    With a sharded ``mesh``, ``states`` holds the rank's lanes and the
    trajectory, logs and last values returned are every lane's.
    """
    A = tables.action_space
    rows = lane_rows(mesh, n_lanes)
    sharded = mesh is not None and mesh.sharded
    local = n_lanes // mesh.world if sharded else n_lanes

    def collect(policy: Policy, states: EnvState, generator: Optional[torch.Generator]):
        check_observation(policy, tables)
        dev = states.buf.device
        w = policy.packed_weights()
        obs = torch.empty((n_steps, local, policy.obs_width(tables)), dtype=torch.float32,
                          device=dev)
        actions, log_probs, values, rewards, dones, logs = [], [], [], [], [], []
        for t in range(n_steps):
            x = policy.observe(tables, states, out=obs[t])
            noise = gumbel_noise((n_lanes, A), generator, dev)[rows]
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
        logs = stack_logs(logs)
        if sharded:
            traj, logs = gather_tree(mesh, traj, 1), gather_tree(mesh, logs, 1)
            last_values = all_gather_cat(mesh, last_values, 0)
        return states, traj, logs, last_values

    return collect


def flatten_time(tree):
    """[T, N, ...] -> [T*N, ...] over a NamedTuple of tensors."""
    if isinstance(tree, tuple):
        return type(tree)(*(flatten_time(x) for x in tree))
    return tree.reshape((-1,) + tuple(tree.shape[2:]))
