"""Data-parallel dry run: one MTIO training step and one PPO collect and
update over the ranks of a process group.

Port of the JAX package's ``parallel/dryrun.py`` (``run_dryrun``,
``:30-124``, and its ``main``, ``:127-150``).  ``--n-devices`` sizes the
data as JAX's global mesh does (an MTIO batch of 4 rows a device, 2 env
lanes a device); the ranks split it, so one process and two give the same
step.  Multi-process (``--coordinator``), the ranks join a group with
:func:`parallel.mesh.init_distributed` (Gloo on the CPU and where ranks
share a card, NCCL where each has its own).  At its end the run checks that
the parameters are the same bits on every rank.

Run as a worker::

    python -m mansy_immersivevideostreaming_torch.parallel.dryrun \\
        --n-devices 2 --coordinator localhost:9876 --num-processes 2 \\
        --process-id 0 [--force-cpu] [--hidden-dim 32] [--out DIR]

The models are small (under 10M parameters, sequences of at most 21
tokens), so only the batch and lane axis is split, as in the JAX package.
The MTIO batch is a seeded draw of positions (the JAX run's is zeros), so
that the step's parity checks are not trivial.  The policy's width is
JAX's 32 (``MansyActorCritic(hidden_dim=32)``, JAX ``parallel/dryrun.py:95``)
unless ``--hidden-dim`` asks for another; K3 and K10 run any width on the
card (32 in the instance of capacity 64).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np
import torch

from mansy_immersivevideostreaming_torch.models import vp_train
from mansy_immersivevideostreaming_torch.models.abr_nets import MansyActorCritic
from mansy_immersivevideostreaming_torch.models.mtio import ViewportTransformerMTIO
from mansy_immersivevideostreaming_torch.parallel.mesh import (
    Mesh, all_gather_cat, init_distributed, make_mesh, replicate, shutdown,
)
from mansy_immersivevideostreaming_torch.rl import ppo as ppo_mod
from mansy_immersivevideostreaming_torch.rl.rollout import init_lanes, make_collector
from mansy_immersivevideostreaming_torch.rl.types import RunningStat
from mansy_immersivevideostreaming_torch.sim.env import generate_environment_samples
from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables

MTIO = dict(d_model=32, dim_feedforward=32, fut_window=4)  # JAX dryrun.py:64
HIS = 5
MTIO_LR = 1e-4
MTIO_SEED = 1       # the step's draws (slots, keep masks)
PPO_LR = 5e-4
PPO_STEPS = 4
PPO_MINIBATCH = 8


def mtio_batch(n_devices: int, device) -> Dict[str, torch.Tensor]:
    """4 rows a device of positions in [0, 1), the same on every rank."""
    rng = np.random.default_rng(1)
    B = 4 * n_devices
    return {k: torch.as_tensor(rng.random((B, n, 2), dtype=np.float32), device=device)
            for k, n in (("history", HIS), ("current", 1), ("future", MTIO["fut_window"]))}


def mtio_model(device, dropout: bool = True) -> ViewportTransformerMTIO:
    """The dry run's MTIO (d 32, ff 32, fut 4) from Flax's initialisers
    (seed 0); ``dropout=False`` sets both of its rates to 0."""
    rates = {} if dropout else dict(dropout=0.0, transformer_dropout=0.0)
    model = ViewportTransformerMTIO(**MTIO, **rates, device=device)
    return model.init_like_flax(torch.Generator(device=device).manual_seed(0))


def mtio_step(mesh: Mesh, model: ViewportTransformerMTIO, batch, perms=None, repeat=None):
    """One AdamW step from a fresh optimizer state over the mesh.  Returns
    the loss (a float)."""
    opt = vp_train.make_optimizer(MTIO_LR)
    state = vp_train.create_train_state(model)
    _, loss = vp_train.train_step(model, opt, state, batch, MTIO_SEED, perms, repeat, mesh=mesh)
    return float(loss)


def ppo_step(mesh: Mesh, n_devices: int, hidden_dim: int):
    """One collect over 2 lanes a device x 4 steps and one PPO update
    (minibatch 8, one epoch) on the synthetic tables.  Returns (the policy,
    the update's loss as a float)."""
    dev = mesh.device
    tables = synthetic_sim_tables(device=dev)
    samples = torch.as_tensor(generate_environment_samples(2, 2, 2, 2), device=dev)
    torch.manual_seed(2)
    policy = replicate(mesh, MansyActorCritic(hidden_dim=hidden_dim, device=dev))
    n_lanes = 2 * n_devices
    collect = make_collector(tables, samples, n_lanes, PPO_STEPS, train=True, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(3)
    _, traj, _, last_values = collect(policy, init_lanes(tables, samples, n_lanes, 0, mesh),
                                      gen)
    optimizer = ppo_mod.make_optimizer(policy.parameters(), PPO_LR)
    cfg = ppo_mod.PPOConfig(minibatch=PPO_MINIBATCH, repeat=1)
    _, metrics = ppo_mod.ppo_update(policy, optimizer, cfg, traj, traj.reward, last_values,
                                    RunningStat.init(dev), gen, mesh=mesh)
    return policy, float(metrics["loss"])


def check_replicated(mesh: Mesh, module: torch.nn.Module, label: str) -> None:
    """Raise unless ``module``'s parameters and buffers are the same bits on
    every rank."""
    flat = torch.cat([t.detach().reshape(-1).float()
                      for t in list(module.parameters()) + list(module.buffers())])
    every = all_gather_cat(mesh, flat[None], 0)
    if not all(torch.equal(every[0], row) for row in every[1:]):
        raise AssertionError(f"[dryrun] {label}: the ranks' parameters differ")


def run_dryrun(n_devices: int, mesh: Optional[Mesh] = None, hidden_dim: int = 32,
               device: str = "cuda") -> Dict[str, np.ndarray]:
    """One MTIO data-parallel train step and one PPO collect and update on
    data sized for ``n_devices`` devices, split over ``mesh``'s ranks
    (default: the group this process joined, else one process on
    ``device``).  Returns the losses, the parameters after each step and
    the BatchNorm statistics, as numpy arrays."""
    mesh = make_mesh(device) if mesh is None else mesh
    if n_devices % mesh.world:
        raise ValueError(f"--n-devices {n_devices} does not split over {mesh.world} ranks")
    tag = f"{n_devices} devices' data over {mesh.world} process(es) on {mesh.device}"

    model = replicate(mesh, mtio_model(mesh.device))
    loss = mtio_step(mesh, model, mtio_batch(n_devices, mesh.device))
    if not np.isfinite(loss):
        raise AssertionError(f"[dryrun] MTIO loss {loss}")
    check_replicated(mesh, model, "MTIO")
    print(f"[dryrun] MTIO DP train step OK on {tag}: loss={loss:.4f}", flush=True)

    policy, ppo_loss = ppo_step(mesh, n_devices, hidden_dim)
    if not np.isfinite(ppo_loss):
        raise AssertionError(f"[dryrun] PPO loss {ppo_loss}")
    check_replicated(mesh, policy, "PPO")
    print(f"[dryrun] PPO rollout+update OK on {tag}: loss={ppo_loss:.4f}", flush=True)

    out = {"mtio_loss": np.float32(loss), "ppo_loss": np.float32(ppo_loss)}
    for prefix, module in (("mtio", model), ("ppo", policy)):
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            if name != "pe":
                out[f"{prefix}/{name}"] = t.detach().cpu().numpy()
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n-devices", type=int, required=True,
                        help="the devices the data is sized for (the JAX mesh's global count)")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="host:port (or a torch init URL, e.g. file:///tmp/store) of "
                             "the process group")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--force-cpu", action="store_true",
                        help="run on the CPU (Gloo); default: the rank's card")
    parser.add_argument("--hidden-dim", type=int, default=32,
                        help="the policy's width (JAX's dry run: 32)")
    parser.add_argument("--out", type=str, default=None,
                        help="directory for each rank's results, rank<r>.npz")
    args = parser.parse_args(argv)
    device = "cpu" if args.force_cpu else "cuda"
    if args.coordinator is not None:
        mesh = init_distributed(args.coordinator, args.num_processes, args.process_id, device)
    else:
        mesh = make_mesh(device)
    out = run_dryrun(args.n_devices, mesh, args.hidden_dim)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        np.savez(os.path.join(args.out, f"rank{mesh.rank}.npz"), **out)
    shutdown(mesh)


if __name__ == "__main__":
    main()
