"""Policy and identifier weights, carried across from and back to the JAX
package.

The JAX package stores policies as Orbax checkpoints of Flax params with a
``.netcfg.json`` sidecar naming the net's construction flags
(``mansy_immersivevideostreaming_tpu/utils/checkpoint.py``).  The port reads
the same params from a numpy ``.npz`` (one array per leaf, keyed by its
``/``-joined Flax path) beside a copy of that sidecar, so it needs neither
JAX nor Orbax.  ``assets/dagger_v9_params.npz`` is the round-4 flagship;
``assets/dagger_v16_params.npz`` is the round-4 policy that observes the
exact, accuracy-corrected action values and adds their logit prior.  The
port's trainers write their policies and identifiers in the same layout
(:func:`save_npz`, :func:`save_net_config`), so the JAX package's Flax nets
load them too.
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


AC_HEADS = ("actor_fc", "actor_out", "critic_fc", "critic_out")
ID_HEADS = ("fc", "out")


def _state_from_flax(flat: Dict[str, np.ndarray], names, heads,
                     what: str) -> Dict[str, torch.Tensor]:
    """Flat Flax params of the branches ``names`` and dense layers ``heads``
    -> a ``state_dict``.  Flax ``Dense`` kernels are [in, out]; ``nn.Linear``
    weights are [out, in]."""
    layers = {f"feature_net.branches.{name}": f"feature_net/{name}" for name in names}
    layers.update({name: name for name in heads})
    expected = {f"{p}/{leaf}" for p in layers.values() for leaf in ("kernel", "bias")}
    if set(flat) != expected:
        raise ValueError(f"not {what} params: missing {sorted(expected - set(flat))}, "
                         f"unexpected {sorted(set(flat) - expected)}")
    state = {}
    for module, path in layers.items():
        state[f"{module}.weight"] = torch.from_numpy(
            np.array(flat[f"{path}/kernel"].T, order="C"))
        state[f"{module}.bias"] = torch.from_numpy(np.array(flat[f"{path}/bias"]))
    return state


def actor_critic_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """MansyActorCritic Flax params (nested or flat "/"-keyed dict of numpy
    arrays), with or without the action-value branch, -> the port's
    ``state_dict``."""
    flat = flatten_params(params)
    names = [n for _, n in BRANCHES] + [COND_BRANCH]
    if f"feature_net/{AV_BRANCH}/kernel" in flat:
        names.append(AV_BRANCH)
    return _state_from_flax(flat, names, AC_HEADS, "MansyActorCritic")


def identifier_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """QoEIdentifier Flax params -> the port's ``state_dict``."""
    return _state_from_flax(flatten_params(params), [n for _, n in BRANCHES] + [COND_BRANCH],
                            ID_HEADS, "QoEIdentifier")


def flax_params(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """A MansyActorCritic's or QoEIdentifier's parameters in the flat,
    "/"-keyed Flax layout (kernels [in, out]): the inverse of the
    converters above."""
    flat = {}
    for name, layer in module.named_modules():
        if isinstance(layer, torch.nn.Linear):
            path = name.replace("feature_net.branches.", "feature_net/")
            flat[f"{path}/kernel"] = layer.weight.detach().t().cpu().numpy().astype(np.float32)
            flat[f"{path}/bias"] = layer.bias.detach().cpu().numpy().astype(np.float32)
    return flat


def save_npz(path: str | os.PathLike, module: torch.nn.Module) -> None:
    """Write ``module``'s parameters as a Flax-keyed ``.npz`` at exactly
    ``path`` (``np.savez`` given a name would append ".npz")."""
    with open(path, "wb") as f:
        np.savez(f, **flax_params(module))


def load_npz_into(module: torch.nn.Module, path: str | os.PathLike) -> None:
    """Load a Flax-keyed ``.npz`` into a MansyActorCritic or QoEIdentifier."""
    with np.load(path) as npz:
        params = {k: npz[k] for k in npz.files}
    convert = (actor_critic_state_dict_from_flax if isinstance(module, MansyActorCritic)
               else identifier_state_dict_from_flax)
    module.load_state_dict(convert(params))


def save_net_config(path: str | os.PathLike, cfg: dict) -> None:
    """Record the net-construction flags in the sidecar beside a policy file
    (flags like ``av_logit_prior`` add no params, so the sidecar is what
    rebuilds the same function)."""
    with open(f"{os.path.abspath(path)}{NET_CONFIG_SUFFIX}", "w") as f:
        json.dump(cfg, f, indent=1, sort_keys=True)


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
    policy = MansyActorCritic(hidden_dim=int(netcfg["hidden_dim"]),
                              use_action_values=exact, av_logit_prior=prior, device=dev)
    load_npz_into(policy, path)
    policy.acc_correct_obs = exact and bool(netcfg.get("acc_correct_obs"))
    return policy
