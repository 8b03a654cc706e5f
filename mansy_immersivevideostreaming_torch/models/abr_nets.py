"""MANSY actor-critic, QoE-preference identifier and simple_rl actor-critic
networks (torch ``nn.Module``s).

Port of ``mansy_immersivevideostreaming_tpu/models/abr_nets.py``
``MansyFeatureNet``, ``MansyActorCritic`` and ``QoEIdentifier`` (reference
``bitrate_selection/models/mansy.py:5-155``) and ``SimpleActorCritic``
(``:206-231``, reference ``bitrate_selection/models/simple_rl.py:9-63``).  ``use_action_values`` and
``av_logit_prior`` read the action values: the exact ``action_values``
observation field (``sim/env.py:exact_action_values``) where the tables
carry it, else the derived :func:`causal_action_values` (JAX
``abr_nets.py:29-92``) of the observation's own fields, by the JAX net's
rule (``_action_value_features``, ``:95-102``).  Both have the same width,
so a checkpoint reads either; the derived values are K2's derived mode and
row mode (``kernels/observe.py``), whose plain version
:func:`causal_action_values` is.

The actor-critic's math lives once, in ``kernels/actor_critic.py``:
``forward`` packs the 13- or 14-field observation dict and
:meth:`MansyActorCritic.forward_packed` runs ``actor_critic_train`` on the
packed buffer, differentiable in the parameters (K3's training mode and the
K10 backward on the card, their plain versions on the CPU); the rollout runs
the inference kernel on :meth:`MansyActorCritic.packed_weights`.  Each
actor-critic names the K2 mode that builds its observation (``observe``):
the MANSY row, or the simple_rl row for :class:`SimpleActorCritic`, which
runs the same K3 and K10 with five branches and no residual.  The
identifier has no kernel: its dense layers stay ``nn.Linear`` with autograd,
as the JAX package leaves them to XLA's dots.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mansy_immersivevideostreaming_torch.kernels.actor_critic import (
    TENSOR_FIELDS, ActorCriticWeights, actor_critic_train,
)
from mansy_immersivevideostreaming_torch.kernels.observe import (
    NET_FIELDS, causal_action_values, obs_columns, obs_dims, obs_layout, obs_width,
    observe_mansy_pack, observe_simple_pack, pack_obs, pack_simple_obs, simple_layout,
    simple_width,
)
from mansy_immersivevideostreaming_torch.utils.device import resolve_device

# (observation field, Flax branch name), in the feature net's concat order;
# the cond branch follows them, and the action-value branch comes last
# (abr_nets.py:124-141).
BRANCHES = (("throughput", "throughput"), ("next_chunk_size", "next_size"),
            ("next_chunk_quality", "next_quality"), ("pred_viewport", "pred_viewport"),
            ("viewport_acc", "viewport_acc"), ("past_viewport_qualities", "past_vq"),
            ("past_quality_variances", "past_var"), ("past_rebuffering", "past_rebuf"),
            ("buffer", "buffer"))
COND_BRANCH = "cond"
AV_BRANCH = "action_values"


def _action_value_features(obs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[..., A+1] action-value features (JAX ``abr_nets.py:95-102``): the
    exact field when the observation has one, else the derived
    :func:`causal_action_values`.  Both have the same width."""
    if "action_values" in obs:
        return obs["action_values"]
    return causal_action_values(obs)


def _linear(n_in: int, n_out: int, device) -> nn.Linear:
    """Dense layer with the JAX package's init: orthogonal(sqrt 2), zero bias
    (reference ``run_mansy.py:211-215``)."""
    layer = nn.Linear(n_in, n_out, device=device)
    nn.init.orthogonal_(layer.weight, gain=math.sqrt(2.0))
    nn.init.zeros_(layer.bias)
    return layer


class MansyFeatureNet(nn.Module):
    """The 10 branch layers of the feature extractor (reference
    ``mansy.py:5-51``), the cond branch after the nine others, and with
    ``use_action_values`` an 11th over the action values.  Their forward is
    the first stage of :func:`actor_critic_forward_plain`."""

    def __init__(self, in_dims: Dict[str, int], hidden_dim: int = 128,
                 cond_key: str = "qoe_weight", use_action_values: bool = False,
                 device=None):
        super().__init__()
        self.branches = nn.ModuleDict(
            {name: _linear(in_dims[key], hidden_dim, device) for key, name in BRANCHES})
        self.branches[COND_BRANCH] = _linear(in_dims[cond_key], hidden_dim, device)
        if use_action_values:
            self.branches[AV_BRANCH] = _linear(in_dims["action_values"], hidden_dim, device)


def _packed_weights(net) -> ActorCriticWeights:
    """A detached copy of ``net._pack()``, for the kernels.  Cached, and
    packed anew only after a parameter was replaced or changed in place (its
    storage or its version counter moved)."""
    key = tuple((p.data_ptr(), p._version) for p in net.parameters())
    if net._packed is None or net._packed[0] != key:
        with torch.no_grad():
            w = net._pack()
        net._packed = (key, w._replace(**{f: getattr(w, f).detach().clone()
                                          for f in TENSOR_FIELDS}))
    return net._packed[1]


class MansyActorCritic(nn.Module):
    """Shared feature net + actor/critic heads with the conditional-feature
    residual (reference ``mansy.py:54-80``, residual at ``:65``/``:79``).

    ``use_action_values``: an 11th branch over the action values.
    ``av_logit_prior`` (beta): the actor logits get ``beta * (av - mean) /
    (std + 1e-6)`` of their first A entries (population std, JAX
    ``abr_nets.py:176-180``).  Either reads the packed observation with the
    action-value columns: the exact field where the tables carry it, else
    the derived values (:func:`_action_value_features`'s rule).
    ``exact_action_values`` says that the policy was trained on the exact
    field, so that its tables must carry it (``rl/rollout.py:
    check_observation``)."""

    def __init__(self, hidden_dim: int = 128, action_space: int = 15,
                 use_action_values: bool = False, av_logit_prior: float = 0.0,
                 past_k: int = 8, num_rates: int = 5, num_tiles: int = 64,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.use_action_values = bool(use_action_values)
        self.av_logit_prior = float(av_logit_prior)
        # which action-value tables the observation needs (the sidecar's
        # exact_action_values and acc_correct_obs, set by
        # utils.checkpoint.load_npz_policy and the training CLIs): none (the
        # derived values, if any), the exact ones, or the accuracy-corrected ones
        self.exact_action_values = False
        self.acc_correct_obs = False
        # the packed observation's layout: with action values when either reads them
        self.dims = (past_k, num_rates, num_tiles, action_space,
                     self.use_action_values or bool(self.av_logit_prior))
        layout = obs_layout(*self.dims)
        in_dims = {name: int(torch.Size(shape).numel()) for name, _, shape in layout}
        self.feature_net = MansyFeatureNet(in_dims, hidden_dim, "qoe_weight",
                                           self.use_action_values, dev)
        width = hidden_dim * (len(BRANCHES) + 1 + self.use_action_values)
        self.actor_fc = _linear(width, hidden_dim, dev)
        self.actor_out = _linear(hidden_dim, action_space, dev)
        self.critic_fc = _linear(width, hidden_dim, dev)
        self.critic_out = _linear(hidden_dim, 1, dev)
        self._packed = None  # (parameter key, ActorCriticWeights) of packed_weights

    def observe(self, tables, state, out=None) -> torch.Tensor:
        """The packed observation of every lane (K2): with the tables'
        action values where they carry them, else, where the policy reads
        action values, with the derived ones (K2's derived mode)."""
        return observe_mansy_pack(tables, state, out, action_values=self.reads_action_values)

    def obs_width(self, tables) -> int:
        """Columns of the packed observation this policy reads from ``tables``."""
        K, R, T, A, av = obs_dims(tables)
        return obs_width(K, R, T, A, av or self.reads_action_values)

    @property
    def reads_action_values(self) -> bool:
        """The policy reads the action-value columns (the 14-field
        observation: exact or derived)."""
        return self.dims[-1]

    def _net_layout(self):
        """The packed observation's fields the net reads, with offsets."""
        return obs_layout(*self.dims)[:NET_FIELDS + self.dims[-1]]

    def forward(self, obs: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits [N, A], value [N]) from the observation dict, packed into
        the kernel's layout by :func:`pack_obs` (see :meth:`forward_packed`);
        a policy that reads action values on a dict without the exact field
        gets the derived ones there (K2's row mode)."""
        return self.forward_packed(pack_obs(obs, self.actor_out.weight.device,
                                            action_values=self.reads_action_values))

    def forward_packed(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits [N, A], value [N]) of packed observations [N, >= 748],
        differentiable in the parameters: K3's training mode and K10 for CUDA
        tensors (any hidden width), their plain versions for CPU tensors."""
        return actor_critic_train(self._pack(), x)

    def _pack(self) -> ActorCriticWeights:
        """The parameters in the actor-critic kernel's layout (Flax's
        [in, out] kernels)."""
        layout = self._net_layout()
        names = [name for _, name in BRANCHES] + [COND_BRANCH]
        if self.use_action_values:
            names.append(AV_BRANCH)
        branches = [self.feature_net.branches[n] for n in names]
        # the branches read the net's fields in order; without the action-value
        # branch the prior still reads the field, which follows them
        offsets = [off for _, off, _ in layout[:len(names)]]
        offsets.append(offsets[-1] + branches[-1].in_features)
        av_off = layout[NET_FIELDS][1] if self.reads_action_values else -1
        kernel = lambda layer: layer.weight.t().contiguous()
        return ActorCriticWeights(
            w_branch=torch.cat([kernel(b) for b in branches], dim=0),
            b_branch=torch.stack([b.bias for b in branches]),
            w_fc=torch.cat([kernel(self.actor_fc), kernel(self.critic_fc)], dim=1),
            b_fc=torch.cat([self.actor_fc.bias, self.critic_fc.bias]),
            w_actor_out=kernel(self.actor_out), b_actor_out=self.actor_out.bias,
            w_critic_out=kernel(self.critic_out), b_critic_out=self.critic_out.bias,
            branch_off=tuple(offsets), av_off=av_off, av_prior=self.av_logit_prior)

    def packed_weights(self) -> ActorCriticWeights:
        """A detached, cached copy of :meth:`_pack` (:func:`_packed_weights`)."""
        return _packed_weights(self)


class QoEIdentifier(nn.Module):
    """Predicts the normalized QoE preference from the observation and the
    previous action stored in it (reference ``mansy.py:143-155``, JAX
    ``abr_nets.py:189-203``): the ten-branch feature net with cond =
    ``action_one_hot``, ``fc`` with LeakyReLU, the cond residual, ``out`` (3)
    and a sigmoid.  It reads packed observations (``kernels/observe.py``),
    with or without the action-value columns, which it does not use."""

    def __init__(self, hidden_dim: int = 128, action_space: int = 15, past_k: int = 8,
                 num_rates: int = 5, num_tiles: int = 64,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.dims = (past_k, num_rates, num_tiles, action_space)
        in_dims = {name: int(torch.Size(shape).numel())
                   for name, _, shape in obs_layout(*self.dims)}
        self.feature_net = MansyFeatureNet(in_dims, hidden_dim, "action_one_hot", False, dev)
        self.fc = _linear(hidden_dim * (len(BRANCHES) + 1), hidden_dim, dev)
        self.out = _linear(hidden_dim, 3, dev)

    def columns(self, x: torch.Tensor) -> Dict[str, slice]:
        """Each field's columns in the packed observations ``x``."""
        for av in (False, True):
            if x.shape[-1] == obs_width(*self.dims, av):
                return obs_columns(*self.dims, av)
        raise ValueError(f"QoEIdentifier: {x.shape[-1]} columns is no packed observation width")

    def target(self, x: torch.Tensor) -> torch.Tensor:
        """The normalized preference [N, 3] the identifier predicts."""
        return x[:, self.columns(x)["qoe_weight"]]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Predicted preference [N, 3] of packed observations [N, F]."""
        cols = self.columns(x)
        branch = lambda name, field: F.leaky_relu(
            self.feature_net.branches[name](x[:, cols[field]]), 0.01)
        cond = branch(COND_BRANCH, "action_one_hot")
        feats = torch.cat([branch(name, field) for field, name in BRANCHES] + [cond], dim=-1)
        h = F.leaky_relu(self.fc(feats), 0.01)
        return torch.sigmoid(self.out(h + cond))


# SimpleActorCritic's branches: (Flax name, observation field), in its concat
# order (abr_nets.py:214-220), the packed simple observation's fields
SIMPLE_BRANCHES = tuple(name for name, _, _ in simple_layout(1, 1, 1))


class SimpleActorCritic(nn.Module):
    """The simple_rl (A2C) baseline's actor-critic (reference
    ``simple_rl.py:9-63``, JAX ``abr_nets.py:206-231``): five branches of
    ``hidden_dim`` with LeakyReLU(0.01) (``throughput``, ``chunk_sizes``,
    ``rebuffer``, ``last_bitrates``, ``pred_viewport``), then ``actor_fc`` and
    ``critic_fc`` on their concatenation, ``actor_out`` and ``critic_out``;
    no cond branch and no residual.  Its layers sit at the top level, as
    Flax names them.  It reads the packed simple_rl observation
    (``kernels/observe.py:simple_layout``)."""

    def __init__(self, hidden_dim: int = 128, action_space: int = 15, past_k: int = 8,
                 num_rates: int = 5, num_tiles: int = 64,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.dims = (past_k, num_rates, num_tiles)
        for name, _, shape in simple_layout(*self.dims):
            setattr(self, name, _linear(int(torch.Size(shape).numel()), hidden_dim, dev))
        width = hidden_dim * len(SIMPLE_BRANCHES)
        self.actor_fc = _linear(width, hidden_dim, dev)
        self.actor_out = _linear(hidden_dim, action_space, dev)
        self.critic_fc = _linear(width, hidden_dim, dev)
        self.critic_out = _linear(hidden_dim, 1, dev)
        self._packed = None

    observe = staticmethod(observe_simple_pack)
    reads_action_values = exact_action_values = False

    @staticmethod
    def obs_width(tables) -> int:
        K, R, T, _, _ = obs_dims(tables)
        return simple_width(K, R, T)

    def forward(self, obs: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits [N, A], value [N]) from the 5-field observation dict."""
        return self.forward_packed(pack_simple_obs(obs, self.actor_out.weight.device))

    def forward_packed(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, value) of packed simple observations [N, 395],
        differentiable in the parameters (K3's training mode and K10 on the
        card, their plain versions on the CPU)."""
        return actor_critic_train(self._pack(), x)

    def _pack(self) -> ActorCriticWeights:
        layout = simple_layout(*self.dims)
        branches = [getattr(self, name) for name in SIMPLE_BRANCHES]
        kernel = lambda layer: layer.weight.t().contiguous()
        return ActorCriticWeights(
            w_branch=torch.cat([kernel(b) for b in branches], dim=0),
            b_branch=torch.stack([b.bias for b in branches]),
            w_fc=torch.cat([kernel(self.actor_fc), kernel(self.critic_fc)], dim=1),
            b_fc=torch.cat([self.actor_fc.bias, self.critic_fc.bias]),
            w_actor_out=kernel(self.actor_out), b_actor_out=self.actor_out.bias,
            w_critic_out=kernel(self.critic_out), b_critic_out=self.critic_out.bias,
            branch_off=tuple(off for _, off, _ in layout) + (simple_width(*self.dims),),
            cond=-1)

    def packed_weights(self) -> ActorCriticWeights:
        """A detached, cached copy of :meth:`_pack` (:func:`_packed_weights`)."""
        return _packed_weights(self)
