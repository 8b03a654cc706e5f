"""Policy and identifier weights, carried across from and back to the JAX
package.

The JAX package stores policies as Orbax checkpoints of Flax params with a
``.netcfg.json`` sidecar naming the net's construction flags
(``mansy_immersivevideostreaming_tpu/utils/checkpoint.py``).  The port reads
the same params from a numpy ``.npz`` (one array per leaf, keyed by its
``/``-joined Flax path) beside a copy of that sidecar, so it needs neither
JAX nor Orbax.  ``assets/dagger_v9_params.npz`` is the round-4 flagship;
``assets/dagger_v16_params.npz`` is the round-4 policy that observes the
exact, accuracy-corrected action values and adds their logit prior;
``dagger_v18`` is a hidden-256 policy, and ``dagger_v7`` and
``dagger_v21_last`` are the plain hidden-128 policies that the routed
ensemble (``cli/run_ensemble.py``) combines with v9 and v18.  The simple_rl
baseline's ``SimpleActorCritic`` is stored the same way, its layers at the
top level as Flax names them (no sidecar: its one width is 128).  The
port's trainers write their policies and identifiers in the same layout
(:func:`save_npz`, :func:`save_net_config`), so the JAX package's Flax nets
load them too.

MTIO viewport models (:func:`mtio_state_dict_from_flax` and its inverse)
keep both Flax collections in one ``.npz``, keyed ``params/<path>`` and
``batch_stats/<path>``: a Flax-keyed file that ``run_models --test`` and
``predict`` read, and that the JAX package's Flax module applies as
``{"params": ..., "batch_stats": ...}``.  ``run_models --train``'s
checkpoint adds AdamW's state and the step (:func:`save_train_checkpoint`,
:func:`load_train_checkpoint`, which ``--resume`` reads).
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

from mansy_immersivevideostreaming_torch.models.abr_nets import (
    AV_BRANCH, BRANCHES, COND_BRANCH, SIMPLE_BRANCHES, MansyActorCritic, SimpleActorCritic,
)
from mansy_immersivevideostreaming_torch.models.vp_train import VPState, VPTrainState
from mansy_immersivevideostreaming_torch.utils.device import resolve_device

NET_CONFIG_SUFFIX = ".netcfg.json"
ASSETS = Path(__file__).resolve().parent.parent / "assets"
DAGGER_V9_NPZ = ASSETS / "dagger_v9_params.npz"
DAGGER_V16_NPZ = ASSETS / "dagger_v16_params.npz"
DAGGER_V18_NPZ = ASSETS / "dagger_v18_params.npz"
DAGGER_V7_NPZ = ASSETS / "dagger_v7_params.npz"
DAGGER_V21_LAST_NPZ = ASSETS / "dagger_v21_last_params.npz"


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


def simple_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """SimpleActorCritic Flax params -> the port's ``state_dict``."""
    return _state_from_flax(flatten_params(params), [], SIMPLE_BRANCHES + AC_HEADS,
                            "SimpleActorCritic")


def identifier_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """QoEIdentifier Flax params -> the port's ``state_dict``."""
    return _state_from_flax(flatten_params(params), [n for _, n in BRANCHES] + [COND_BRANCH],
                            ID_HEADS, "QoEIdentifier")


def flax_params(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """A MansyActorCritic's, SimpleActorCritic's or QoEIdentifier's
    parameters in the flat, "/"-keyed Flax layout (kernels [in, out]): the
    inverse of the converters above."""
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
    """Load a Flax-keyed ``.npz`` into a MansyActorCritic, SimpleActorCritic
    or QoEIdentifier."""
    with np.load(path) as npz:
        params = {k: npz[k] for k in npz.files}
    convert = (actor_critic_state_dict_from_flax if isinstance(module, MansyActorCritic)
               else simple_state_dict_from_flax if isinstance(module, SimpleActorCritic)
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
    function.  The policy reads action values with ``obs_action_values`` or
    ``exact_action_values`` (its 11th branch) or a logit prior, as JAX
    ``cli/run_ensemble.py:67-75`` builds it: the derived ones on tables
    without them, else the tables' exact ones.  Its ``exact_action_values``
    and ``acc_correct_obs`` attributes tell the caller which action-value
    tables to attach: none (the derived values), the plain deployable ones
    (``attach_action_values``) or the accuracy-corrected ones
    (``acc_correct=True``)."""
    dev = resolve_device(device)
    netcfg = load_net_config(path)
    if netcfg is None:
        raise FileNotFoundError(f"{path}{NET_CONFIG_SUFFIX} not found")
    exact = bool(netcfg.get("exact_action_values"))
    policy = MansyActorCritic(hidden_dim=int(netcfg["hidden_dim"]),
                              use_action_values=exact or bool(netcfg.get("obs_action_values")),
                              av_logit_prior=float(netcfg.get("av_logit_prior", 0.0)),
                              device=dev)
    load_npz_into(policy, path)
    policy.exact_action_values = exact
    policy.acc_correct_obs = exact and bool(netcfg.get("acc_correct_obs"))
    return policy


# Flax names of the MTIO modules that ``nn.compact`` names, and the port's
# (models/transformer.py): an encoder layer's children, and the layers
# inside the feed-forward and distillation blocks.  The ``setup`` names (sa,
# ca, ff, norm1-3 of a decoder layer, ...) are the same in both.
_ENCODER_LAYER = {"MHA_0": "attn", "LayerNorm_0": "norm1", "LayerNorm_1": "norm2",
                  "FeedForward_0": "ff"}
_SUBLAYERS = {"Dense_0": "linear1", "Dense_1": "linear2", "Conv_0": "conv",
              "BatchNorm_0": "bn"}


def _rename(segments, to_port: bool):
    """Flax <-> port module names along a path of layer-list-joined
    segments (``encoder_layers_0``)."""
    tables = (_ENCODER_LAYER, _SUBLAYERS)
    if not to_port:
        tables = tuple({v: k for k, v in t.items()} for t in tables)
    return [tables[0 if i and segments[i - 1].startswith("encoder_layers_") else 1].get(s, s)
            for i, s in enumerate(segments)]


def _mtio_module_path(flax_path: str) -> str:
    """``transformer/encoder_layers_0/MHA_0/key`` -> ``transformer.encoder_layers.0.attn.key``."""
    name = ".".join(_rename(flax_path.split("/"), to_port=True))
    return re.sub(r"(encoder_layers|decoder_layers)_(\d+)", r"\1.\2", name)


def _mtio_flax_path(module_name: str) -> str:
    """The inverse of :func:`_mtio_module_path`."""
    name = re.sub(r"(encoder_layers|decoder_layers)\.(\d+)", r"\1_\2", module_name)
    return "/".join(_rename(name.split("."), to_port=False))


def mtio_state_dict_from_flax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """ViewportTransformerMTIO Flax ``params`` and ``batch_stats`` (nested or
    flat "/"-keyed numpy arrays) -> the port's ``state_dict``.  Dense kernels
    [in, out] become Linear weights [out, in]; the Conv kernel [k, in, out]
    becomes Conv1d's [out, in, k]; LayerNorm and BatchNorm ``scale`` become
    ``weight``, BatchNorm ``mean``/``var`` its running statistics."""
    state = {}
    for path, x in flatten_params(params).items():
        module, leaf = path.rsplit("/", 1)
        name = _mtio_module_path(module)
        x = np.asarray(x, np.float32)
        if leaf == "kernel":
            x = x.T if x.ndim == 2 else np.transpose(x, (2, 1, 0))
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        elif leaf != "bias":
            raise ValueError(f"not an MTIO parameter: {path}")
        state[f"{name}.{leaf}"] = torch.from_numpy(np.array(x, order="C"))
    for path, x in flatten_params(batch_stats).items():
        module, leaf = path.rsplit("/", 1)
        if leaf not in ("mean", "var"):
            raise ValueError(f"not an MTIO batch statistic: {path}")
        name = _mtio_module_path(module)
        state[f"{name}.running_{leaf}"] = torch.from_numpy(np.array(x, np.float32))
        state[f"{name}.num_batches_tracked"] = torch.tensor(0)
    return state


def mtio_flax_tensors(model: torch.nn.Module, tensors) -> Dict[str, np.ndarray]:
    """Tensors shaped as ``model.parameters()`` (the parameters, their
    gradients, AdamW's moments), in that order, as flat Flax-keyed arrays in
    Flax's layouts: Linear weights become ``kernel`` [in, out], Conv1d's
    ``kernel`` [k, in, out], LayerNorm and BatchNorm weights ``scale``."""
    modules = dict(model.named_modules())
    flat = {}
    for (name, _), x in zip(model.named_parameters(), tensors):
        module, leaf = name.rsplit(".", 1)
        a = x.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":
            mod = modules[module]
            if isinstance(mod, torch.nn.Linear):
                a, leaf = a.T.copy(), "kernel"
            elif isinstance(mod, torch.nn.Conv1d):
                a, leaf = np.transpose(a, (2, 1, 0)).copy(), "kernel"
            else:
                leaf = "scale"
        flat[f"{_mtio_flax_path(module)}/{leaf}"] = a
    return flat


def mtio_flax_from_module(model: torch.nn.Module) -> VPState:
    """The inverse of :func:`mtio_state_dict_from_flax`: a
    ViewportTransformerMTIO's weights as flat Flax ``params`` and
    ``batch_stats``."""
    stats = {}
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.BatchNorm1d):
            path = _mtio_flax_path(name)
            stats[f"{path}/mean"] = mod.running_mean.detach().cpu().numpy().astype(np.float32)
            stats[f"{path}/var"] = mod.running_var.detach().cpu().numpy().astype(np.float32)
    return VPState(mtio_flax_tensors(model, model.parameters()), stats)


def write_mtio_npz(path: str | os.PathLike, params: Mapping, batch_stats: Mapping) -> None:
    """Write Flax ``params`` and ``batch_stats`` (nested or flat) into one
    ``.npz`` at exactly ``path``, keyed ``params/...`` and ``batch_stats/...``."""
    with open(path, "wb") as f:
        np.savez(f, **flatten_params({"params": params, "batch_stats": batch_stats}))


def save_mtio_npz(path: str | os.PathLike, model: torch.nn.Module) -> None:
    """Write a ViewportTransformerMTIO's weights as its Flax-keyed ``.npz``."""
    write_mtio_npz(path, *mtio_flax_from_module(model))


def load_mtio_npz(path: str | os.PathLike) -> VPState:
    """The Flax ``params`` and ``batch_stats`` of an MTIO ``.npz``."""
    with np.load(path) as npz:
        split = {"params": {}, "batch_stats": {}}
        for key in npz.files:
            collection, rest = key.split("/", 1)
            if collection not in split:
                raise ValueError(f"{path}: {key} is neither params/ nor batch_stats/")
            split[collection][rest] = npz[key]
    return VPState(split["params"], split["batch_stats"])


def load_mtio_npz_into(model: torch.nn.Module, path: str | os.PathLike) -> None:
    """Load an MTIO ``.npz`` into a ViewportTransformerMTIO of the same shape."""
    model.load_state_dict(mtio_state_dict_from_flax(*load_mtio_npz(path)))


def save_train_checkpoint(path: str | os.PathLike, model: torch.nn.Module,
                          state: VPTrainState) -> None:
    """``run_models --train``'s ``<prefix>_checkpoint.npz``: the MTIO npz's
    ``params/...`` and ``batch_stats/...``, AdamW's moments Flax-keyed as the
    params under ``opt_state/mu/...`` and ``opt_state/nu/...``, its count
    ``opt_state/count`` and the step count ``step`` (the JAX CLI's Orbax
    ``VPTrainState``)."""
    params, stats = mtio_flax_from_module(model)
    arrays = flatten_params({"params": params, "batch_stats": stats, "opt_state": {
        "mu": mtio_flax_tensors(model, state.mu), "nu": mtio_flax_tensors(model, state.nu)}})
    arrays["opt_state/count"] = np.int32(state.count)
    arrays["step"] = np.int32(state.step)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_train_checkpoint(path: str | os.PathLike, model: torch.nn.Module) -> VPTrainState:
    """Restore :func:`save_train_checkpoint`'s file: the weights and
    statistics into ``model``, and the train state (``--resume``)."""
    split = {"params": {}, "batch_stats": {}, "mu": {}, "nu": {}}
    with np.load(path) as npz:
        for key in npz.files:
            collection, _, rest = key.partition("/")
            if collection == "opt_state" and rest.split("/", 1)[0] in ("mu", "nu"):
                moment, rest = rest.split("/", 1)
                split[moment][rest] = npz[key]
            elif collection in ("params", "batch_stats"):
                split[collection][rest] = npz[key]
        count, step = int(npz["opt_state/count"]), int(npz["step"])
    model.load_state_dict(mtio_state_dict_from_flax(split["params"], split["batch_stats"]))
    device = next(model.parameters()).device
    moments = []
    for moment in ("mu", "nu"):
        by_name = mtio_state_dict_from_flax(split[moment], {})
        moments.append([by_name[name].to(device) for name, _ in model.named_parameters()])
    return VPTrainState(step=step, count=count, mu=moments[0], nu=moments[1])
