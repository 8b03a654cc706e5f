"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where there is no card.  The
file imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest imports JAX.)  Tolerances: ints
exact, floats 1e-5 relative (the kernels sum in another order than
PyTorch's CUDA ops, which also divide by a Python scalar as a product with
its reciprocal).
"""

import numpy as np
import pytest
import torch

from mansy_immersivevideostreaming_torch.kernels import actor_critic as K3
from mansy_immersivevideostreaming_torch.kernels import env_step as K1
from mansy_immersivevideostreaming_torch.kernels import observe as K2
from mansy_immersivevideostreaming_torch.models.abr_nets import MansyActorCritic
from mansy_immersivevideostreaming_torch.rl.rollout import init_lanes
from mansy_immersivevideostreaming_torch.sim.env import (
    generate_demo_samples, generate_environment_samples, tree_map,
)
from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables

N = 96


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _leaves(tree):
    """The tensors of a (nested) tuple of tensors and NamedTuples, in order."""
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _stepped_lanes(tables, samples, steps, seed=0):
    """Lanes with some history, stepped by the plain version."""
    state = init_lanes(tables, samples, N, seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        acts = torch.as_tensor(rng.integers(0, 15, N).astype(np.int32), device=samples.device)
        state, *_ = K1.env_step_plain(tables, samples, state, acts, N, True)
    return state


@pytest.mark.cuda
def test_env_step_kernel_matches_plain_on_card(cuda_device):
    tables = synthetic_sim_tables(3, 4, 3, 20, 4, seed=2, device=cuda_device)
    samples = torch.as_tensor(generate_demo_samples(3, 4, 3, 4, 17), device=cuda_device)
    state = _stepped_lanes(tables, samples, steps=3)
    rng = np.random.default_rng(1)
    for _ in range(20):
        acts = torch.as_tensor(rng.integers(0, 15, N).astype(np.int32), device=cuda_device)
        ref = K1.env_step_plain(tables, samples, tree_map(torch.clone, state), acts, N, True)
        got = K1.env_step(tables, samples, state, acts, N, True)
        assert got[0] is state  # updated in place
        for x, y in zip(_leaves(got), _leaves(ref)):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_observe_and_actor_critic_kernels_match_plain_on_card(cuda_device):
    torch.manual_seed(0)
    policy = MansyActorCritic(device=cuda_device)
    tables = synthetic_sim_tables(device=cuda_device)
    samples = torch.as_tensor(generate_environment_samples(2, 2, 2, 2), device=cuda_device)
    state = _stepped_lanes(tables, samples, steps=4)
    packed = K2.observe_mansy_pack(tables, state)
    torch.testing.assert_close(packed, K2.observe_mansy_pack_plain(tables, state),
                               rtol=1e-5, atol=0.0)
    w = policy.packed_weights()
    for noise in (None, K3.gumbel_noise((N, 15), None, cuda_device)):
        got = K3.actor_critic_forward(w, packed, noise)
        ref = K3.actor_critic_forward_plain(w, packed, noise)
        for x, y in zip(got[:2], ref[:2]):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got[2], ref[2])
        torch.testing.assert_close(got[3], ref[3], rtol=1e-5, atol=1e-5)
