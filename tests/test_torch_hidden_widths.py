"""Hidden widths other than the committed policies' 128 and 256.

The JAX package's ``MansyActorCritic`` takes any ``hidden_dim``, and so do
``run_mansy --hidden-dim`` and ``run_dagger --hidden-dim``; its dry run
builds the net at 32.  The port's K3 and K10 run any width on the card: a
width runs in the smallest compiled instance that holds it (64, 128, 192 or
256), or past 256 in the wide variant.  Held here, on the CPU (the plain
versions; the kernels themselves are held on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s phase 2h):

* the plain forward (``actor_critic_forward_plain`` on the port's packed
  weights) at hidden 32, 100 and 320 against the Flax net from the same
  numpy weights (Flax's initialiser), v9's net and v16's with a logit
  prior: logits and value within rtol 1e-5, atol 1e-5;
* ``run_dagger --hidden-dim 100`` runs a round on the synthetic tree from
  Flax's initialiser, and the npz it writes loads into the JAX package's
  Flax net with the same outputs (as ``test_torch_hidden256.py`` at 256);
* the wrapper's instance choice for every width from 1 to 1100: the
  smallest instance that holds it, or the wide variant past 256, and the
  mode a launch counts in names that instance.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mansy_immersivevideostreaming_tpu.models.abr_nets import MansyActorCritic as JaxAC
from mansy_immersivevideostreaming_torch.cli import run_dagger, run_expert
from mansy_immersivevideostreaming_torch.kernels import actor_critic as K3
from mansy_immersivevideostreaming_torch.kernels.observe import pack_obs
from mansy_immersivevideostreaming_torch.models.abr_nets import MansyActorCritic
from mansy_immersivevideostreaming_torch.utils.checkpoint import (
    actor_critic_state_dict_from_flax, load_net_config,
)
from synthetic_tree import build_synthetic_tree
from test_torch_ppo import random_obs
from test_torch_tables import port_config
from test_torch_train_cli import assert_policy_loads_into_flax


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("hidden", [32, 100, 320])
@pytest.mark.parametrize("kind", ["v9", "v16"])
def test_plain_forward_matches_flax_at_width(kind, hidden):
    av = kind == "v16"
    prior = 3.0 if av else 0.0
    rng = np.random.default_rng(hidden)
    obs = random_obs(rng, (48,), av)
    net = JaxAC(hidden_dim=hidden, use_action_values=av, av_logit_prior=prior)
    params = jax.device_get(net.init(jax.random.PRNGKey(hidden),
                                     {k: jnp.asarray(v[:2]) for k, v in obs.items()})["params"])
    want_logits, want_value = net.apply({"params": params},
                                        {k: jnp.asarray(v) for k, v in obs.items()})
    policy = MansyActorCritic(hidden_dim=hidden, use_action_values=av, av_logit_prior=prior,
                              device="cpu")
    policy.load_state_dict(actor_critic_state_dict_from_flax(params))
    with torch.no_grad():
        w = policy.packed_weights()
        assert w.b_branch.shape[1] == hidden
        logits, value, action, _ = K3.actor_critic_forward_plain(w, pack_obs(obs))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value), rtol=1e-5, atol=1e-5)
    assert np.array_equal(action.numpy(), logits.numpy().argmax(-1))


def test_run_dagger_at_hidden_100_runs_a_round(tmp_path):
    cfg = port_config(build_synthetic_tree(str(tmp_path)))
    run_expert.run(run_expert.build_parser().parse_args(
        ["--train", "--horizon", "1", "--lane-chunk", "8", "--device", "cpu"]), cfg)
    (demos,) = glob.glob(os.path.join(str(tmp_path), "models", "bitrate_selection", "expert",
                                      "**", "train_demonstrations.pkl"), recursive=True)
    out = run_dagger.run(run_dagger.build_parser().parse_args([
        "--demos-path", demos, "--rounds", "1", "--lanes", "4", "--bc-steps", "5",
        "--batch-size", "32", "--horizon", "1", "--hidden-dim", "100", "--device", "cpu"]), cfg)
    for path in (out, out + ".last"):
        assert load_net_config(path)["hidden_dim"] == 100
        assert_policy_loads_into_flax(path)


def test_every_width_takes_the_smallest_instance_that_holds_it():
    for hidden in range(1, 1101):
        instance = K3.kernel_instance(hidden)
        if hidden > max(K3.WIDTHS):
            assert instance == K3.WIDE
        else:
            assert instance in K3.WIDTHS and instance >= hidden
            assert all(c < hidden for c in K3.WIDTHS if c < instance)
    assert [K3.kernel_instance(h) for h in (1, 32, 64, 65, 100, 128, 129, 192, 193, 256, 257)] \
        == [64, 64, 64, 128, 128, 128, 192, 192, 256, 256, K3.WIDE]
    with pytest.raises(ValueError):
        K3.kernel_instance(0)
    modes = {h: K3.launch_mode(MansyActorCritic(hidden_dim=h, device="cpu").packed_weights())
             for h in (32, 100, 160, 256, 512)}
    assert modes == {32: "cond64", 100: "cond128", 160: "cond192", 256: "cond256",
                     512: "condwide"}
