"""Policy weights carried across from the JAX package.

The JAX package stores policies as Orbax checkpoints of Flax params with a
``.netcfg.json`` sidecar naming the net's construction flags
(``mansy_immersivevideostreaming_tpu/utils/checkpoint.py``).  The port reads
the same params from a numpy ``.npz`` (one array per leaf, keyed by its
``/``-joined Flax path) beside a copy of that sidecar, so it needs neither
JAX nor Orbax.  ``assets/dagger_v9_params.npz`` is the round-4 flagship;
``assets/dagger_v16_params.npz`` is the round-4 policy that observes the
exact, accuracy-corrected action values and adds their logit prior.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

from mansy_immersivevideostreaming_torch.models.abr_nets import (
    AV_BRANCH, BRANCHES, COND_BRANCH, MansyActorCritic,
)
from mansy_immersivevideostreaming_torch.utils.device import resolve_device

NET_CONFIG_SUFFIX = ".netcfg.json"
ASSETS = Path(__file__).resolve().parent.parent / "assets"
DAGGER_V9_NPZ = ASSETS / "dagger_v9_params.npz"
DAGGER_V16_NPZ = ASSETS / "dagger_v16_params.npz"


def flatten_params(params: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested Flax param dict -> {"feature_net/cond/kernel": array, ...}."""
    flat = {}
    for key, value in params.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_params(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def actor_critic_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """MansyActorCritic Flax params (nested or flat "/"-keyed dict of numpy
    arrays), with or without the action-value branch, -> the port's
    ``state_dict``.  Flax ``Dense`` kernels are [in, out]; ``nn.Linear``
    weights are [out, in]."""
    flat = flatten_params(params)
    names = [n for _, n in BRANCHES] + [COND_BRANCH]
    if f"feature_net/{AV_BRANCH}/kernel" in flat:
        names.append(AV_BRANCH)
    layers = {f"feature_net.branches.{name}": f"feature_net/{name}" for name in names}
    layers.update({name: name for name in ("actor_fc", "actor_out", "critic_fc",
                                           "critic_out")})
    expected = {f"{p}/{leaf}" for p in layers.values() for leaf in ("kernel", "bias")}
    if set(flat) != expected:
        raise ValueError(f"not MansyActorCritic params: missing {sorted(expected - set(flat))}, "
                         f"unexpected {sorted(set(flat) - expected)}")
    state = {}
    for module, path in layers.items():
        state[f"{module}.weight"] = torch.from_numpy(
            np.array(flat[f"{path}/kernel"].T, order="C"))
        state[f"{module}.bias"] = torch.from_numpy(np.array(flat[f"{path}/bias"]))
    return state


def load_net_config(path: str | os.PathLike) -> dict | None:
    """The ``.netcfg.json`` sidecar beside a policy file, or None."""
    p = f"{os.path.abspath(path)}{NET_CONFIG_SUFFIX}"
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def load_npz_policy(path: str | os.PathLike = DAGGER_V9_NPZ,
                    device: str | torch.device = "cuda") -> MansyActorCritic:
    """MansyActorCritic with the weights of a policy ``.npz`` and the flags of
    its sidecar, which must be present: flags like ``av_logit_prior`` add no
    params, so a policy without its sidecar could load into the wrong
    function.  The policy's ``acc_correct_obs`` attribute tells the caller
    which action-value tables to attach (``reads_action_values`` whether to):
    the accuracy-corrected ones (``attach_action_values(acc_correct=True)``)
    or the plain deployable ones.

    Refused: a policy that reads the derived ``causal_action_values``
    (``obs_action_values`` or a logit prior without ``exact_action_values``),
    which the port does not have."""
    dev = resolve_device(device)
    netcfg = load_net_config(path)
    if netcfg is None:
        raise FileNotFoundError(f"{path}{NET_CONFIG_SUFFIX} not found")
    exact = bool(netcfg.get("exact_action_values"))
    prior = float(netcfg.get("av_logit_prior", 0.0))
    if not exact and (netcfg.get("obs_action_values") or prior):
        raise NotImplementedError(f"{path}: the policy reads the derived causal action "
                                  f"values, which are not ported (netcfg {netcfg})")
    with np.load(path) as npz:
        params = {k: npz[k] for k in npz.files}
    policy = MansyActorCritic(hidden_dim=int(netcfg["hidden_dim"]),
                              use_action_values=exact, av_logit_prior=prior, device=dev)
    policy.load_state_dict(actor_critic_state_dict_from_flax(params))
    policy.acc_correct_obs = exact and bool(netcfg.get("acc_correct_obs"))
    return policy
