"""Hand-written CUDA kernels of the port's paths (Hopper, sm_90a).

* ``env_step``: the fused environment step (``env_step.py``, K1);
* ``observe_mansy_pack`` and ``observe_simple_pack``: the observation
  gather into one [N, F] buffer, MANSY's or simple_rl's (``observe.py``, K2);
* ``actor_critic_forward``: the policy forward with its action head, for
  the MANSY net and the simple_rl net (``actor_critic.py``, K3);
* ``choose_action``: the MPC expert's sequence search (``choose_action.py``,
  K4);
* ``build_expert_tables``: the MPC expert's profiling tables
  (``expert_tables.py``, K5);
* ``compute_gae``: generalized advantage estimation (``gae.py``, K6);
* ``policy_loss``: the PPO, A2C and cross-entropy loss heads with their
  gradient (``policy_loss.py``, K9);
* ``actor_critic_train_forward`` and ``actor_critic_backward``: K3's
  training mode and the actor-critic backward (``actor_critic.py``, K10);
* ``chunk_maps`` and ``trajectory_metrics``: viewport tile occupancy with the
  chunk OR and IoU, or with the per-step tile metrics
  (``tile_occupancy.py``, K7);
* ``attention``: the MTIO transformer's softmax-attention core, in f32 or
  bf16 (``attention.py``, K8).

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain PyTorch version beside it only for tensors that lie on the CPU.  Each
counts its launches in a plain integer attribute, ``wrapper.launches``; K3,
K10, K9 and K8, whose kernels have several modes (K8: f32 and bf16), also
count them by mode in ``wrapper.launches_by_mode`` (:func:`count_launch`).
The sources under ``csrc/`` (with the shared ``common.cuh`` and
``elem.cuh``) are compiled with nvcc at first use (``build.py``).
"""


def count_launch(wrapper, mode: str) -> None:
    """Count one launch of ``wrapper``'s kernel in ``mode``."""
    wrapper.launches += 1
    wrapper.launches_by_mode[mode] = wrapper.launches_by_mode.get(mode, 0) + 1
