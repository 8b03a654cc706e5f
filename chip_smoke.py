#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: builds the hand-written
kernels, holds each against its plain PyTorch version, serves the v9 policy
over a test grid, collects a rollout, runs the MPC expert over a test grid,
serves the action-value policy v16 and the hidden-256 policy v18, trains
with PPO and the identifier (at hidden 128 and 256, and at 512, 64 and 160
from Flax's initialiser, serving the 512-wide policy it wrote), runs DAgger
rounds,
serves the MTIO viewport model (``run_models --test``, the ``predict``
export) and trains it (``run_models --train``, also at ``--his-window
96``), trains and tests the simple_rl (A2C) baseline and runs the routed
ensemble over four committed policies, and serves, trains and runs DAgger
with policies that read the derived action values, all through the port's
own entry points.  It imports no JAX.

    python3 chip_smoke.py [--parent DIR] [--vp-train N] [--limits]

With ``--parent``, DIR is another checkout of the repo (the parent commit's,
unpacked with ``git archive``): its K3, K10, K8, K1, K9, K2, K7, K5 and K6 are
built from its own sources into its own build directory and timed beside
this tree's on the same inputs (``earlier_ms``; K1, K9, K2, K7, K5 and K6
also with the spread of their 15 timings, ``earlier_ms_range``; K2, K7, K5,
K6 and K8 with ``earlier_bits_equal``, K5 also with
``earlier_max_abs_diff``; K6, K8 and K2's derived and row modes must equal
the parent's bits; so must K3 and K10 at hidden 128 and 256, phase 2h).
With ``--parent`` K8's viewport batch (62 serving launches) and a d 512
training step's 62 forward and 62 backward launches are also timed against
the parent's in turns (parent, this, this, parent; ``earlier_check``, ratio
within PARENT_MARGIN of 1), and so are the 62 backward launches of a
``--his-window 96`` step (``his96_earlier_check``).  ``--vp-train N`` runs only phase 11, N times
over (each training's weights differ), and prints each run's step checks;
``--limits`` runs only phase 2i and the vp_test_long, vp_train_long and
vp_train_wide paths (with ``--parent``, phase 2i's ``earlier_ms`` and the
three paths in turns with the parent's K8 too).

Phases:

1. device: the card's name and power limit (``nvidia-smi``); TF32 off.
2. kernels: build every kernel with nvcc (in parallel) and compare K1-K5 with
   its plain version on the same card tensors at the main paths' shapes
   (8192 lanes on tables of the Jin2022/4G train split's shape; K4 on 512
   lanes at horizon 4 in every mode; K5 on the train split's tables and on
   the test split's, which the expert and serve-v16 paths build, two
   launches bit-equal; K2 and K3 again with the action values and the v16
   weights; K3 with the v18 weights at hidden 256 at 512 and 8192 lanes,
   two launches bit-equal); time both with CUDA events and print the
   ``kernels`` JSON line (K3 and K10 at hidden 256 in rows of their own,
   ``_h256``, with the launches of the paths that run v18).  K3 is also timed at
   serve's lane chunk (512), with two bounds (f32 outside the tensor cores,
   and its products as three TF32 products on them); K4 also at the
   expert's lane chunk (64) and DAgger's lanes (32, accuracy-corrected).
   K1 is held and timed at each path's width (32, 64, 128, 512 and 8192
   lanes: DAgger, expert, train, serve, collect), with the spread of its 15
   timings; two launches from two clones of one state give the same bits.
   K2 likewise at 8192, 512, 128 and 32 lanes, with 779 and 795 columns
   (two launches bit-equal).
3. serve: deterministic evaluation of the committed v9 weights over the
   1440-episode test grid's shape, in lane chunks of 512; every lane must
   finish an episode, and the first-done masks and every episode record
   must match the plain path on the card.  One lane chunk's episode is
   profiled once every path has been timed (``step_profile``: the card's
   busy share of a step, the costliest device and host ops).
4. collect: the sampling rollout collector, 8192 lanes x 128 steps.
   PROFILE_COLLECT_STEPS steps are profiled once every path has been timed
   (``step_profile``).
5. expert: ``run_expert_episodes`` over the 1440-episode grid at the CLI's
   defaults (horizon 4, lane chunks of 64), privileged mode, on K5's
   tables; every lane finishes an episode, and the run is held against the
   plain path on the card (every lane: equal masks; equal episode records
   unless the lane's first differing decision was a near-tie).  One lane
   chunk's episode is profiled once every path has been timed
   (``decision_profile``).
6. serve-v16: K5 attaches the accuracy-corrected action-value tables, then
   the committed v16 weights are served deterministically over the
   1440-episode grid, held against the plain path as in phase 3.
6b. serve-v18: the committed v18 weights (hidden 256, K3's second
   instantiation) served as in phase 3: 0 episode records may differ.

Phase 2c holds the training kernels against their plain versions: K6
``compute_gae`` at [16, 128] (run_simple_rl's collect), [32, 128] and
[128, 8192], bit-equal to its plain
version and on two launches; K9 ``policy_loss`` in every
PPO variant at B = 512 and in CE mode at B = 4096 (two launches give the
same bits; CE's yardstick: ``F.cross_entropy`` forward and backward by
autograd); K3's training mode and K10 ``actor_critic_backward`` at B = 512
and 4096 with the v9, v16 and v18 (hidden 256) weights (K10's yardstick:
autograd through a ``torch.matmul`` composition; two launches of each give
the same bits; its launch plan and a second bound, its products as three
TF32 products on the tensor cores).

7. train: ``run_mansy --train --train-identifier --use-identifier --lamb
   0.5`` at the CLI defaults (128 lanes x 32 steps, minibatch 512, repeat
   2) through ``run_mansy.ppo_round``, from the v9 weights, on tables of the
   train split's shape; then one PPO update (16 minibatch steps) timed
   and profiled (``torch.profiler``: the device's busy share of a step,
   the costliest device and host ops), and one update through the kernels
   against the plain path on the card from the same parameters, trajectory
   and permutations.
7b. train_256: the same from the v18 weights at ``--hidden-dim 256`` (K3
   and K10 at width 256): a warm-up round, one timed round, a profiled
   update, and one update against the plain path at phase 7's limits.
   Phase 7's update check holds the plain path to the kernels' LeakyReLU
   branches where the two differ at a near-tie, each within
   TRAIN_KINK_MARGIN of its tie (``kinks``; the unforced reading beside,
   ``own_branches``).
7c-7f. train_512, serve_512, train_64, train_160: phase 7b at
   ``--hidden-dim 512`` (K3 and K10's wide variant), 64 and 160 (their
   instances of capacity 64 and 192) from Flax's initialiser; train_512
   writes its policy as ``run_mansy`` writes ``best_policy.npz`` (npz and
   sidecar), and serve_512 serves that file over the 1440-episode grid as
   phase 3 serves v9 (0 records may differ).
8. dagger: ``run_dagger`` rounds with v16's flags through
   ``run_dagger.dagger_round``, from the v16 weights and an initial
   aggregate of the port's expert demos on the test grid's shape; then a
   deterministic evaluation of the grid that every lane must finish,
   PROFILE_CE_STEPS CE steps on the final aggregate timed and profiled as
   in phase 7, and the rest of a round (the expert-labelled rollout and
   the aggregate) timed alone.

Phase 2d holds the viewport kernels against their plain versions at
``run_models``' batch of 512: K8 ``attention`` (8 heads of 64) in each of
its shapes (the decode self-attention at every t of the 15-slot cache, the
cross-attention over 3 keys, the encoder's 5 x 5, the causal 16 x 16, and
the --his-window 96 encoder's 96 x 96 and a decode step over 256 keys),
also against ``scaled_dot_product_attention`` (math backend; its default
backend is K8's yardstick; two launches give the same bits), with the sums
of a viewport batch's 62 launches (times and bounds); K8's training mode and its
backward kernel in each training shape (the encoder, the decode step over
the 15-slot cache at every prefix, the cross-attention 1 x 3 and 15 x 3,
the teacher-forced causal 15 x 15), with a dropout keep mask at 0.1 and
without, against the plain version's autograd (two launches of each give
the same bits; keys no row sees get exactly 0), timed beside SDPA's
forward and forward + backward, with the sums of a training step's 62
launches of each (6 with teacher forcing), and beyond the earlier
backward's 64 rows and keys (96 x 96, a decode step over 256 keys; each
with the kernel's tile plan); each forward case names its plan
(``attention_forward_plan``: the row kernel for one query row, the tile
kernel for more); with ``--parent`` the parent commit's forward (serving
and training) and backward beside them, which must give the same bits
(``earlier_bits_equal``); K7 in metrics mode (F = 15) and
chunk mode (frequency 5; two launches of each give the same bits), and on a
grid of positions on and beside every pixel boundary that moves a map.

Phase 2f holds K8 on bf16 q, k and v (``run_models --bf16``; serving,
training mode with a keep mask at 0.1, backward) in every shape of phase
2d, the teacher-forced ones and the --his-window 96 ones, against its
plain bf16 version: each element within one bf16 ulp of the larger of the
two plus the slack of one-ulp flips of the inner bf16 roundings of P and dP'
(``kernels/attention.py:bf16_slack``), two launches bit-equal; timed beside
the bf16 bytes bound and SDPA on the same bf16 tensors (rows ``*_bf16``);
each forward case names its plan, and with ``--parent`` the parent
commit's serving and training forward are timed beside them and must give
the same bits.

9. vp_test: ``run_models --test``'s loop (``run_models.test_split``) over
   the Jin2022 test splits' shape (test_seen and test_unseen, each 3 videos
   x 15 users x 54 windows = 2,430 trajectories) at bs 512, with full-width
   MTIO weights from a seed and synthetic traces in memory; then held
   against the plain path on the card (K8 and K7 swapped for their plain
   versions): predictions within VP_ATOL, tile metrics equal on every step
   where both predictions truncate to the same pixel.
10. vp_export: ``predict.run`` over the merged split's shape (24 videos x 60
   users, 77,520 trajectories) from trace ``.npy`` files in the dataset
   schema under a temporary directory, the weights from an ``.npz``; every
   pickle written must load through ``data/prediction.py``.
11. vp_train: ``run_models --train``'s epoch (``vp_train.train_epoch``) at
   its defaults (d 512, 2 + 2 layers, 8 x 64 heads, bs 512, fut 15, his 5,
   the KV-cached autoregressive decode, dropout on) from Flax's
   initialisers over 32 batches of seeded synthetic trajectories: samples/s
   over VP_PASSES epochs, then one ``--teacher-forcing`` epoch; one step
   profiled (``train_step_profile``); one step through the kernels against
   the same step with K8 swapped for its plain versions (same weights,
   generator seed, slot draws and dropout masks, and the kernels' branches
   at the ReLUs, the max pool and the periodic MSE's images, each flipped
   branch a near-tie; both under PyTorch's deterministic algorithms): loss,
   gradients and the parameters after AdamW within their tolerances; the
   first step at
   ``--his-window 96`` (an encoder attention of 96 x 96, cross-attention
   over the distilled 48) from Flax's initialisers, held against the plain
   path in the same way, then timed, and K8's device milliseconds in it
   read from ``torch.profiler`` (``k8_device_ms``: the forward's row and
   tile kernels, the backward's); a validation pass on the trained
   weights.
9b, 11b. vp_test_bf16, vp_train_bf16: phases 9 and 11 with ``--bf16`` (K8
   in its bf16 mode, the predictions and the step held to the plain bf16
   path at VP_BF16_* limits, and against the plain path at f32 compute
   from the same weights as a control, which must break them; no
   --his-window 96 step).

Each path is timed over several passes (median and spread of the host-clock
rate); every pass must launch each kernel exactly as often as the path has
steps (K2 and K3 once more per collect, for the bootstrap value; K4 and K1
once a decision in the expert phase; K5 once a split, at setup; K6 once a
collect, and K3's training mode, K9 and K10 once a minibatch step (A2C:
K2's simple mode in K2's place); K8 62
times and K7 once a viewport batch; K8's training mode and backward 62
times each a training step, 6 with teacher forcing).  The ``kernels`` line
counts each launch in the row of the mode its wrapper counted it in
(``launches_by_mode``: K3 and K10 by net and hidden width, K9 by loss).

Phase 2e holds the simple_rl modes against their plain versions at the A2C
path's shapes (two launches of each give the same bits): K2's simple mode
(the [N, 395] observation) at 128 and 512 lanes, K3 on the five-branch net
without the cond branch (forward with sampling noise, and training mode)
at 128 and 512 rows, K10 on it and K9's A2C mode at the minibatch of 512;
each timed with its bound and, for K3 and K10, the ``torch.matmul``
composition.

12. simple_rl: ``run_simple_rl --train --qoe-train-id 0`` at the CLI
   defaults (128 lanes x 16 steps, minibatch 512, repeat 1, RMSprop)
   through ``run_simple_rl.a2c_round`` from Flax's initialiser, on tables of
   the train split's shape with one preference: env-steps/s including the
   update (median of 5 rounds), one update profiled, and one update through
   the kernels against the plain path at phase 7's limits.
12b. simple_rl_test: ``--test --deterministic-eval``'s evaluation of the
   trained policy over the 1440-episode grid's shape, held against the
   plain path as in phase 3.
13. ensemble: ``run_ensemble.run`` over the committed v7, v9, v18 and
   v21.last npz at its defaults (full valid grid, significance gate), its
   splits from ``synthetic_sim_tables`` at the valid split's shape (3 x 45
   x 8, 4,320 episodes a component) and the test grid's: episodes/s over
   the whole run (median of 3), then the same run through the plain
   versions; the route, the gate evidence and every valid and test episode
   record equal.
14. preprocess: ``preprocess_hmdtrace --dataset Wu2017 --preprocess`` on
   the card over the raw layout's 9 videos x 48 users of synthetic 30 Hz
   quaternion logs, every output file equal to the same CLI's ``--device
   cpu`` run to 1e-6; ``preprocess_network`` over 40 synthetic 4G traces;
   wall seconds of each.
15. serve_av: deterministic evaluation over the 1440-episode grid's shape
   (tables without action values: K2's derived mode) of (i) v16's weights
   with a sidecar of ``obs_action_values`` and no ``exact_action_values``
   and (ii) v9's weights with a logit prior of 3.0, each held against the
   plain path on the card: equal masks and records, or a first differing
   decision at a near-tie of the plain logits (LOGIT_NEAR_TIE; the count of
   such lanes reported); episodes/s over PASSES passes.
15b. train_av: phase 7 with ``--obs-action-values --av-logit-prior 3.0``
   from Flax's initialiser (K2's derived mode in the collect): env-steps/s,
   one update against the plain path at phase 7's limits.
15c. dagger_av: ``run_dagger --obs-action-values --av-logit-prior 3.0
   --acc-correct`` one round at phase 8's shape from policy (i), its
   initial aggregate the port's expert demos recorded without the exact
   field (``flatten_demos`` fills their columns by K2's row mode, held
   against the plain row mode); the launches of the packing, the fit and
   the round.
16. data_parallel: ``--train --data-parallel`` over ranks, each rank a
   process running this script as ``--dp-worker`` (the group's store a
   file in a temporary directory), first one rank (world 1, NCCL), then
   two ranks sharing the card (world 2, Gloo through host copies): (a, b)
   ``parallel.dryrun.run_dryrun`` on data for two devices at JAX's hidden
   32 (K3 and K10's instance of capacity 64);
   (c) ``run_mansy``'s loop (``ppo_round`` with the mesh) at phase 7's
   shapes from the v9 weights, DP_ROUNDS rounds; (d) ``run_models``' loop
   (``vp_train.train_step`` with the mesh) at d 512, bs 512 over
   DP_VP_BATCHES batches.  World 2 is held against world 1: the two ranks'
   parameters the same bits; the dry run's losses rtol 1e-4, its PPO
   parameters and batch statistics 1e-5, its MTIO parameters 2e-6 but for
   1% (every one within 2.5 lr); run_mansy's first round's metrics and
   run_models' losses at DP_RTOL, DP_ATOL (the JAX CLIs' data-parallel
   test's), the parameters after them within 1e-5 but for 1% and 3%
   (every one within 2.5 lr a step).  Each rank counts its launches over
   (a) to (d) and prints them; the phase sums them.  The step times of
   both worlds are reported (``timing``: the last run_mansy round, each
   run_models step); world 2 adds Gloo's host copies, no speed-up.
   ``--data-parallel`` runs this phase alone (after building the kernels).

Phase 2h holds K3 (forward with its action head, training mode) and K10
at the hidden widths of WIDTHS_2H (v9's layout; v16's 11 branches with
its prior at AV_WIDTHS_2H), each from Flax's initialiser: the forward at
512 and 8192 lanes, the training mode and K10 at 512 and 4096 rows,
against their plain versions at phases 2's and 2c's tolerances, two
launches bit-equal, each timed beside its bounds, plain version and
``torch.matmul`` composition (rows ``*_h64``, ``*_h192``, ``*_wide``: the
instances of capacity 64 and 192 and the wide variant past 256; the 128
instance's widths as ``cases_other_widths``).  With ``--parent``, K3 and
K10 at 128 and 256 give the parent's bits (``actor_critic_digests``) and
are timed beside the parent's kernels in turns at 8192 lanes and 4096 rows
(``earlier_check``).

Phase 2g holds K2's derived mode at 32, 128, 512 and 8192 lanes and its
row mode at 4096 and 77,760 rows (DEMO_ROWS) against their plain versions
(AV_RTOL, AV_ATOL), two launches bit-equal, on the edge cases too (an
empty and a full predicted viewport, an empty throughput history, no
previous action), each timed beside its bytes bound (rows
``observe_mansy_pack_derived`` and ``derive_action_values``); with
``--parent`` both modes of the parent's kernel are timed beside them and
must give the same bits everywhere.  Phase 11's
failure message names the gradient leaf past its limit and its worst
entry, with the two paths' values there.

Phase 2i holds K8 past its earlier limits of 2048 keys and 256 dims: the
row kernel over 3073 and 5000 keys (decode at --fut-window 5000, B
LIMIT_LONG_BATCH), the streamed kernel on the tensor cores (rows ``attention_stream``,
``attention_train_forward_stream``) at the --his-window 5000 encoder's
5000 x 5000 (full and causal, B 2) and its teacher-forced cross-attention
15 x 2500 (B LIMIT_LONG_BATCH), and the wide kernels (rows ``attention_wide``,
``attention_train_forward_wide``, ``attention_backward_wide``) at heads of
257, 320, 512, 1024 and 2048 dims (8 heads; 1 x 15, the causal 15 x 15 and
96 x 96; B 512 at 512 dims, LIMIT_WIDE_BATCH at the others): serving,
training with a keep mask at 0.1 and backward, f32 and bf16, against the
plain versions at phase 2d's and 2f's tolerances, two launches bit-equal,
each timed beside its bound, plain version and SDPA (the streamed kernel
also beside its bound on the tensor cores, ``bound_3xtf32_ms`` or
``bound_bf16_mma_ms``, and with ``--parent`` the streamed and wide rows
beside the parent commit's kernel in turns, ``earlier_ms``, the wide
backward rows too); the wide backward of more than one row has its
tensor-core bound of the five products and, in f32, both its kernels forced
and timed (``tensor_core_ms``: csrc/attention_backward_wide.cu; ``simt_ms``:
the SIMT tile kernel; bf16 runs on the tensor cores only), each within the
tolerances and bit-equal twice; the streamed
kernel forced at 96 and 2048 keys agrees with the resident kernel and the
plain version at those tolerances (``forced_stream``).  The backward of
more than one query row past 2048 keys runs K8's split kernels (row ``attention_backward_split``: a CTA a
key tile for dK and dV, a CTA a row tile for dQ), forced at 15 x 2500
where the rule keeps the one-CTA tile kernel; the one-CTA kernel beside
it gives the same bits (``one_cta_ms``), and so does the split forced at
SPLIT_FORCED's shapes (``forced_split``: both timed, the rule's choice in
``planned``).  Three paths run past those limits at the MTIO's
full width, each listing its reductions: vp_test_long (``run_models
--test --his-window 5000``, one batch of LONG_TEST_BATCH timed, its first
LONG_HELD samples held against the plain path, the metrics finite),
vp_train_long (``--train --his-window 5000`` at --bs LONG_TRAIN_BATCH: the
first step from Flax's initialisers by ``compare_vp_steps``, one step
timed) and vp_train_wide (``--train --hidden-dim 4096``, bs 512: the same,
then a validation batch through the serving kernels, then the step at
``--his-window 96``, bs WIDE_96_BATCH, ``his_window_96``, whose 96 x 96
encoder backward runs on the tensor cores in f32 too); vp_train_long
also profiles a step (K8's backward share of the device's busy time, the
host's share of the step).  K8 counts these variants' launches in modes
of their own (``f32_stream``, ``bf16_stream``, ``f32_wide``, ``bf16_wide``,
``f32_split``, ``bf16_split``), each in its row for both element types.
Phase 2 also holds K4 at horizons 5, 6 and 7 in every mode on
LONG_HORIZON_LANES lanes (``long_horizons`` in its row).

Every phase raises on failure; the last line of a successful run is the
``{"ok": true, "device": ...}`` JSON object.  Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path
from unittest import mock

import numpy as np
import torch

# Published peaks of one H100 SXM at its full 700 W power limit (NVIDIA's
# data sheet): HBM3 bandwidth, the f32 rate outside the tensor cores and the
# dense TF32 and bf16 rates of the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12  # dense bf16 on the tensor cores: the bf16 rows' operations bound

LANES = 8192            # main-path lanes (bench.py's rollout width)
COLLECT_STEPS = 128
TRAIN_SHAPE = (18, 45, 24, 60, 4)   # videos, users, traces, chunks, prefs (train split)
TEST_SHAPE = (3, 15, 8, 60, 4)      # the 1440-episode test grid
SERVE_CHUNK = 512
PASSES = 5              # timed passes of serve, collect and serve-v16 (median and spread)
RTOL = 1e-5
HORIZON = 4             # the expert's default lookahead (run_expert --horizon)
EXPERT_CHUNK = 64       # run_expert --lane-chunk default
SEARCH_LANES = 512      # lanes of K4's kernel check
DAGGER_LANES = 32       # run_dagger --lanes: K4's width on the DAgger path
EXPERT_PASSES = 3       # timed passes of the expert path
NEAR_TIE = 1e-5         # first-action margin (over the weight sum) of a near-tie
MISPREDICT = 0.15       # share of tiles the synthetic predicted viewport gets wrong
GAE_SHAPES = ((16, 128), (32, 128), (128, 8192))  # K6: run_simple_rl's and the CLI's collects,
#                                                  and bench.py's rollout width
PPO_BATCH = 512         # run_mansy --batch-size default
CE_BATCH = 4096         # run_dagger --batch-size default
TRAIN_BATCHES = (PPO_BATCH, CE_BATCH)
GRAD_RTOL = 1e-4        # K10 against its plain version: batch sums in another order
UPDATE_RTOL = 1e-4      # phase 7: update metrics, relative to max(|plain|, 0.01)
UPDATE_ATOL = 2e-6      # phase 7: parameters the plain update moved by >= lr / 2 a step
UPDATE_LOOSE = 0.005    # phase 7: share of the other parameters allowed beyond UPDATE_ATOL
# phase 7: a LeakyReLU branch the plain update takes from the kernels' lies
# this close to its tie (a share of the layer's largest |pre-activation|)
TRAIN_KINK_MARGIN = 1e-4
DAGGER_ROUNDS = 2       # phase 8: timed rounds after the initial fit
UPDATE_PASSES = 3       # phases 7, 8: unprofiled timings of an update loop (median)
PROFILE_CE_STEPS = 20   # phase 8: CE steps of the profiled loop (phase 7: one PPO update)
PROFILE_TOP = 6         # device and host ops reported per profiled loop
PROFILE_COLLECT_STEPS = 16  # collect steps of the profiled loop (8192 lanes)
VP_BATCH = 512          # run_models / predict --bs default
VP_PASSES = 3           # timed passes of vp_test and vp_export (median and spread)
VP_ATOL = 2e-5          # phase 9: predictions through the kernels against the plain path
VP_SEED = 5             # run_models / predict --seed default: the MTIO weights' seed
FRAME = (2560, 1440)    # the Jin2022 frame K7 maps onto 8 x 8 tiles
VP_TRAIN_BATCHES = 32   # phase 11: batches an epoch (bench.py's MTIO epoch)
VP_LOSS_RTOL = 1e-5     # phase 11: a step's loss through the kernels against the plain path
VP_GRAD_RTOL = 1e-4     # phase 11: gradients, plus VP_GRAD_RTOL of the largest entry
VP_PARAM_ATOL = 2e-6    # phase 11: parameters after AdamW whose two gradients agree to 1%
VP_PARAM_LOOSE = 0.005  # phase 11: share of the other parameters allowed beyond VP_PARAM_ATOL
VP_KINK_MARGIN = 1e-4   # phase 11: a branch the plain path takes from the kernels' (Kinks) lies
#                         this share of the call's largest input from its tie, at most
# phase 9 and 9b, predictions through the kernels against the plain path
# (compare_vp): their largest and root-mean-square differences, the per-step
# MSE's largest.  bf16: H100 readings 5.9e-4, 1.1e-5, 2.5e-4 (the f32 plain
# path as the control: 1.0e-3, 2.4e-4, 5.7e-4)
VP_TEST_LIMITS = (VP_ATOL, math.inf, 1e-5)
VP_BF16_TEST_LIMITS = (8e-4, 5e-5, 4e-4)
# phase 11 and 11b, a step through the kernels against the plain path
# (compare_vp_steps): the loss's rtol; the gradients' rtol, and their share of
# a leaf's scale beyond it, the scale at least the floor's share of the
# model's largest entry; the share of parameters beyond VP_PARAM_ATOL after
# AdamW.  bf16: H100 readings 5.0e-5, 0.024, 0.023 (the f32 plain path as the
# control: 2.5e-4, 0.064, 0.039)
VP_LIMITS = (VP_LOSS_RTOL, VP_GRAD_RTOL, VP_GRAD_RTOL, 1.0, VP_PARAM_LOOSE)
VP_BF16_LIMITS = (1e-4, 2.0 ** -6, 0.04, 1e-3, 0.03)
WU2017_SHAPE = (9, 48)  # phase 14: the raw Wu2017 layout's videos and users
NETWORK_TRACES = (40, 600)  # phase 14: synthetic 4G .log traces and their seconds
SIMPLE_LANES = 128      # run_simple_rl --train-lanes default
A2C_BATCH = 512         # run_simple_rl --batch-size default
SIMPLE_WIDTHS = (SIMPLE_LANES, SERVE_CHUNK)  # phase 2e: K2 and K3 at the train lanes, the test chunk
SIMPLE_RL_ROUNDS = 5    # phase 12: timed rounds (a collect and its update each)
ENSEMBLE_VALID_SHAPE = (3, 45, 8, 60, 4)  # the Jin2022/4G valid split at run_ensemble's full grid
ENSEMBLE_PASSES = 3     # phase 13: timed runs of run_ensemble
AV_PRIOR = 3.0          # phases 15-15c: the logit prior of v16's flags (--av-logit-prior)
AV_RTOL, AV_ATOL = 1e-5, 1e-6  # phase 2g: the derived values against their plain version
DEMO_ROWS = 77_760      # phase 2g: the row mode at the rows of dagger_av's demos (its demo_rows)
DP_DEVICES = 2          # phase 16: the dry run's data, sized for two devices
DP_HIDDEN = 32          # phase 16: the dry run's policy width (JAX's dry run builds it at 32)
WIDTHS_2H = (32, 64, 100, 160, 384, 512, 1024)  # phase 2h: K3 and K10 at these widths (v9's layout)
AV_WIDTHS_2H = (512, 1024)  # phase 2h: and with v16's 11 branches and a prior of 3.0
PATH_WIDTHS = {"_h64": 64, "_h192": 160, "_wide": 512}  # the main case of each instance's rows
PARENT_MARGIN = 0.05    # --parent: K3, K10 and K8 at the earlier shapes within 5% of the parent's
LIMIT_REPS = 5          # phase 2i: CUDA-event timings a call (the long shapes take up to ~0.1 s)
LIMIT_WIDE_DIMS = (257, 320, 512, 1024, 2048)  # phase 2i: the wide heads (d_model 2056 to 16384)
LIMIT_WIDE_BATCH = 64   # phase 2i: the batch of the wide cases but 512 dims' (reduced from 512)
LIMIT_LONG_BATCH = 64   # phase 2i: the batch past 2048 keys but the 5000 x 5000 encoder's (from
#                         512: at 512 a decode over 5000 keys has dk and dv of 5.2 GB in f32,
#                         and its checks' temporaries run the card out of memory)
ONE_CTA_REPS = 2        # phase 2i: timings a call of the one-CTA backward past 2048 keys (~0.7 s)
# phase 2i: the split backward and the one-CTA tile kernel, each forced (B, Lq, Lk, kv_len0,
# Dh): the training shapes and the --his-window 96 encoder at --bs 512, two at 2048 keys, the
# his-96 encoder and the causal pass at a batch of 4, where B H CTAs leave the card idle, and
# the teacher-forced cross-attention over 2500 keys at B 16 and 32 (128 and 256 (b, head))
SPLIT_FORCED = {"encoder": (512, 5, 5, None, 64), "causal_tf": (512, 15, 15, 1, 64),
                "cross_tf": (512, 15, 3, None, 64), "encoder_96": (512, 96, 96, None, 64),
                "rows_33_keys_2048": (8, 33, 2048, None, 48),
                "rows_30_keys_2048_dh256": (8, 30, 2048, None, 256),
                "encoder_96_b4": (4, 96, 96, None, 64), "causal_tf_b4": (4, 15, 15, 1, 64),
                "cross_tf_2500_b16": (16, 15, 2500, None, 64),
                "cross_tf_2500_b32": (32, 15, 2500, None, 64)}
LONG_HORIZON_LANES = {5: 16, 6: 4, 7: 1}  # phase 2: K4's lanes a horizon past 4 (the plain
#                         version a lane at a time: at 7 its trace walk holds ~40 f32
#                         temporaries of 15^7 entries, ~30 GB, and takes ~1.2 s)
LONG_HIS = 5000         # vp_test_long, vp_train_long: --his-window at JAX's positional table's end
LONG_TEST_BATCH = 64    # vp_test_long: --bs (reduced from 512: the encoder's q, k, v of 655 MB)
LONG_TRAIN_BATCH = 4    # vp_train_long: --bs (reduced from 512: a keep mask of 512 x 8 x 5000^2 B)
LONG_HELD = 4           # vp_test_long: samples held against the plain path (its 5000^2 scores)
WIDE_HIDDEN = 4096      # vp_train_wide: --hidden-dim (8 heads of 512)
WIDE_96_BATCH = 128     # vp_train_wide's --his-window 96 step: --bs (reduced from 512)
WIDE_96_REDUCED = (f"{WIDE_96_BATCH} (from 512): the step through the kernels and the plain "
                   f"path's beside it at 96 keys and hidden 4096 ran the H100's 80 GB out at 512")
DP_ROUNDS = 2           # phase 16c: run_mansy rounds a world (the first held, the last timed)
DP_VP_BATCHES = 3       # phase 16d: run_models batches a world
DP_TIMEOUT_S = 300      # phase 16: a rank's limit
DP_RTOL, DP_ATOL = 2e-3, 1e-4  # phase 16: world 2 against world 1 (tests/test_data_parallel_cli.py)
LOGIT_NEAR_TIE = 1e-4   # phase 15: top-two plain logit margin of a near-tie (the prior
#                         standardizes the 15 values, so their ulps move the logits by ~1e-5)

PKG = "mansy_immersivevideostreaming_torch"
KERNELS = {
    "env_step": dict(route="cuda", source=f"{PKG}/kernels/csrc/env_step.cu",
                     replaces="mansy_immersivevideostreaming_tpu/sim/env.py:303"),
    "observe_mansy_pack": dict(route="cuda", source=f"{PKG}/kernels/csrc/observe.cu",
                               replaces="mansy_immersivevideostreaming_tpu/sim/env.py:262"),
    "actor_critic_forward": dict(route="cuda", source=f"{PKG}/kernels/csrc/actor_critic.cu",
                                 replaces="mansy_immersivevideostreaming_tpu/models/"
                                          "abr_nets.py:166"),
    "choose_action": dict(route="cuda", source=f"{PKG}/kernels/csrc/choose_action.cu",
                          replaces="mansy_immersivevideostreaming_tpu/sim/expert.py:184"),
    "build_expert_tables": dict(route="cuda", source=f"{PKG}/kernels/csrc/expert_tables.cu",
                                replaces="mansy_immersivevideostreaming_tpu/sim/expert.py:67"),
    "compute_gae": dict(route="cuda", source=f"{PKG}/kernels/csrc/gae.cu",
                        replaces="mansy_immersivevideostreaming_tpu/rl/gae.py:17"),
    "policy_loss": dict(route="cuda", source=f"{PKG}/kernels/csrc/policy_loss.cu",
                        replaces="mansy_immersivevideostreaming_tpu/rl/ppo.py:55"),
    "actor_critic_train_forward": dict(route="cuda", source=f"{PKG}/kernels/csrc/actor_critic.cu",
                                       replaces="mansy_immersivevideostreaming_tpu/models/"
                                                "abr_nets.py:166"),
    "actor_critic_backward": dict(route="cuda",
                                  source=f"{PKG}/kernels/csrc/actor_critic_backward.cu",
                                  replaces="mansy_immersivevideostreaming_tpu/rl/ppo.py:163"),
    # the same kernels at hidden 256 (v18): their own instantiation, timed
    # apart, with the launches of the paths that run v18
    "actor_critic_forward_h256": dict(route="cuda", source=f"{PKG}/kernels/csrc/actor_critic.cu",
                                      replaces="mansy_immersivevideostreaming_tpu/models/"
                                               "abr_nets.py:166"),
    "actor_critic_train_forward_h256": dict(route="cuda",
                                            source=f"{PKG}/kernels/csrc/actor_critic.cu",
                                            replaces="mansy_immersivevideostreaming_tpu/models/"
                                                     "abr_nets.py:166"),
    "actor_critic_backward_h256": dict(route="cuda",
                                       source=f"{PKG}/kernels/csrc/actor_critic_backward.cu",
                                       replaces="mansy_immersivevideostreaming_tpu/rl/ppo.py:163"),
    # and in their other instances: capacity 64 (widths 1-64: train_64 and
    # the dry run at 32) and 192 (129-192: train_160), and the wide variant
    # past 256 (train_512, serve_512); held at every width of phase 2h
    **{f"{name}{suffix}": dict(route="cuda", source=f"{PKG}/kernels/csrc/{src}.cu",
                               replaces=f"mansy_immersivevideostreaming_tpu/{jax_line}")
       for suffix in ("_h64", "_h192", "_wide")
       for name, src, jax_line in (
           ("actor_critic_forward", "actor_critic", "models/abr_nets.py:166"),
           ("actor_critic_train_forward", "actor_critic", "models/abr_nets.py:166"),
           ("actor_critic_backward", "actor_critic_backward", "rl/ppo.py:163"))},
    "tile_occupancy": dict(route="cuda", source=f"{PKG}/kernels/csrc/tile_occupancy.cu",
                           replaces="mansy_immersivevideostreaming_tpu/ops/geometry.py:108"),
    "attention": dict(route="cuda", source=f"{PKG}/kernels/csrc/attention.cu",
                      replaces="mansy_immersivevideostreaming_tpu/models/transformer.py:61"),
    "attention_train_forward": dict(route="cuda", source=f"{PKG}/kernels/csrc/attention.cu",
                                    replaces="mansy_immersivevideostreaming_tpu/models/"
                                             "transformer.py:61"),
    "attention_backward": dict(route="cuda",
                               source=f"{PKG}/kernels/csrc/attention_backward.cu",
                               replaces="mansy_immersivevideostreaming_tpu/models/"
                                        "vp_train.py:65"),
    # K8 at bf16 (run_models --bf16): the bf16 instantiations of the same
    # kernels, with the launches of the bf16 viewport paths
    "attention_bf16": dict(route="cuda", source=f"{PKG}/kernels/csrc/attention.cu",
                           replaces="mansy_immersivevideostreaming_tpu/models/transformer.py:61"),
    "attention_train_forward_bf16": dict(route="cuda",
                                         source=f"{PKG}/kernels/csrc/attention.cu",
                                         replaces="mansy_immersivevideostreaming_tpu/models/"
                                                  "transformer.py:61"),
    "attention_backward_bf16": dict(route="cuda",
                                    source=f"{PKG}/kernels/csrc/attention_backward.cu",
                                    replaces="mansy_immersivevideostreaming_tpu/models/"
                                             "vp_train.py:65"),
    # K8 past 2048 keys and 256 dims: the streamed kernel on the tensor cores
    # (more than one query row where the resident score rows no longer fit,
    # and past 256 dims) and the wide kernels (heads past 256 dims, in chunks
    # of 256), each in f32 and
    # bf16, with the launches of the --his-window 5000 and --hidden-dim 4096
    # paths
    **{f"attention{mode}": dict(route="cuda", source=f"{PKG}/kernels/csrc/attention.cu",
                                replaces="mansy_immersivevideostreaming_tpu/models/"
                                         "transformer.py:61")
       for mode in ("_stream", "_train_forward_stream", "_wide", "_train_forward_wide")},
    # the wide backward: one query row in attention_backward.cu's wide row
    # kernel, more rows on the tensor cores (its main case)
    "attention_backward_wide": dict(route="cuda",
                                    source=f"{PKG}/kernels/csrc/attention_backward_wide.cu",
                                    replaces="mansy_immersivevideostreaming_tpu/models/"
                                             "vp_train.py:65"),
    # K8's split backward (more than one query row past 2048 keys: a CTA a
    # key tile for dK and dV, a CTA a row tile for dQ), f32 and bf16, with
    # the launches of the --his-window 5000 training path
    "attention_backward_split": dict(route="cuda",
                                     source=f"{PKG}/kernels/csrc/attention_backward_split.cu",
                                     replaces="mansy_immersivevideostreaming_tpu/models/"
                                              "vp_train.py:65"),
    # the simple_rl (A2C) modes: K2's simple mode, K3 and K10 on the
    # five-branch net without the cond branch, K9's A2C mode; each with the
    # launches of the simple_rl paths
    "observe_simple_pack": dict(route="cuda", source=f"{PKG}/kernels/csrc/observe.cu",
                                replaces="mansy_immersivevideostreaming_tpu/sim/env.py:289"),
    "actor_critic_forward_simple": dict(route="cuda",
                                        source=f"{PKG}/kernels/csrc/actor_critic.cu",
                                        replaces="mansy_immersivevideostreaming_tpu/models/"
                                                 "abr_nets.py:211"),
    "actor_critic_train_forward_simple": dict(route="cuda",
                                              source=f"{PKG}/kernels/csrc/actor_critic.cu",
                                              replaces="mansy_immersivevideostreaming_tpu/"
                                                       "models/abr_nets.py:211"),
    "actor_critic_backward_simple": dict(route="cuda",
                                         source=f"{PKG}/kernels/csrc/actor_critic_backward.cu",
                                         replaces="mansy_immersivevideostreaming_tpu/rl/"
                                                  "a2c.py:88"),
    "policy_loss_a2c": dict(route="cuda", source=f"{PKG}/kernels/csrc/policy_loss.cu",
                            replaces="mansy_immersivevideostreaming_tpu/rl/a2c.py:71"),
    # K2's derived mode (the row with the derived action values, on tables
    # without them) and its row mode (packed rows), each with the launches
    # of the paths that read the derived values
    "observe_mansy_pack_derived": dict(route="cuda", source=f"{PKG}/kernels/csrc/observe.cu",
                                       replaces="mansy_immersivevideostreaming_tpu/models/"
                                                "abr_nets.py:29"),
    "derive_action_values": dict(route="cuda", source=f"{PKG}/kernels/csrc/observe.cu",
                                 replaces="mansy_immersivevideostreaming_tpu/models/"
                                          "abr_nets.py:29"),
}
# the kernels-line row of a launch: the wrapper's name, and the suffix of
# the mode it counted the launch in (K3 and K10 by net and the instance its
# width runs in, the simple_rl net's in one row; K9 by loss, K8 by element
# type, K2 by the action values: gathered or derived); K7's two wrappers
# share one row
MODE_SUFFIX = {None: "", "cond64": "_h64", "cond128": "", "cond192": "_h192", "cond256": "_h256",
               "condwide": "_wide",
               **{f"simple{k}": "_simple" for k in (64, 128, 192, 256, "wide")}, "ce": "", "ppo": "", "a2c": "_a2c", "f32": "", "bf16": "_bf16", "gather": "",
               "derived": "_derived", "f32_stream": "_stream", "bf16_stream": "_stream",
               "f32_wide": "_wide", "bf16_wide": "_wide", "f32_split": "_split",
               "bf16_split": "_split"}
SHARED_ROW = {"chunk_maps": "tile_occupancy", "trajectory_metrics": "tile_occupancy"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def gpu_times(fn, reps: int = 15) -> list:
    """Device times of ``reps`` calls, by CUDA events.  A sleep kernel keeps
    the card busy while the calls are queued, so host-side launch overhead
    stays out of the time (a call that synchronises inside still pays it)."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def gpu_ms(fn, reps: int = 15) -> float:
    """Median device time of one call (``gpu_times``)."""
    return statistics.median(gpu_times(fn, reps))


def gpu_spread(fn, key: str = "ms") -> dict:
    """{key: median, key + "_range": [min, max]} of 15 timed calls."""
    times = gpu_times(fn)
    return {key: statistics.median(times), f"{key}_range": [min(times), max(times)]}


def leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def named_leaves(tree, name: str = ""):
    """[(dotted name, tensor)] of a nested tuple / NamedTuple of tensors."""
    if isinstance(tree, tuple):
        keys = getattr(tree, "_fields", range(len(tree)))
        return [x for k, t in zip(keys, tree) for x in named_leaves(t, f"{name}{k}.")]
    return [(name[:-1], tree)]


def tensor_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(tree))


def close(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Elementwise |got - ref| <= RTOL * max(|ref|, scale), with scale the
    largest |ref| of the tensor times RTOL, so values near 0 compare at the
    tensor's own precision."""
    scale = ref.abs().max().clamp(min=1.0) * RTOL
    return (got - ref).abs() <= RTOL * ref.abs() + scale


# ----------------------------------------------------------------- phase 2

def check_env_step(tables, samples, state, actions, K1, tree_map, parent=None) -> dict:
    """K1 from identical states.  The download cursor (``net.idx``,
    ``net.sec``) may move at a second boundary on at most 0.1% of lanes;
    every other integer field is exact on every lane, and the floats agree
    to RTOL on every lane whose cursor did not move.  Two launches from two
    clones of the state give the same bits.  Returns the max abs error, the
    moved lanes, and the kernel's (with the spread of its 15 timings), the
    plain version's and, with ``parent``, the parent commit's kernel's ms."""
    N = actions.shape[0]
    a = tree_map(torch.clone, state)
    ref = K1.env_step_plain(tables, samples, tree_map(torch.clone, state), actions, N, True)
    got = K1.env_step(tables, samples, a, actions, N, True)
    twin = K1.env_step(tables, samples, tree_map(torch.clone, state), actions, N, True)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(leaves(got), leaves(twin))):
        raise AssertionError(f"env_step ({N} lanes): two launches from one state differ")
    cursor = ("0.net.idx", "0.net.sec")
    same_cursor = torch.ones(N, dtype=torch.bool, device=actions.device)
    for (name, x), (_, y) in zip(named_leaves(got), named_leaves(ref)):
        if name in cursor:
            same_cursor &= x == y
        elif not x.is_floating_point() and not bool((x == y).all()):
            raise AssertionError(f"env_step: integer field {name} disagrees on "
                                 f"{int((x != y).reshape(N, -1).any(-1).sum())} lanes")
    moved = int(N - same_cursor.sum())
    log(f"env_step: {moved} of {N} lanes moved their download cursor at a second boundary")
    if moved > 0.001 * N:
        raise AssertionError(f"env_step: {moved} lanes moved their download cursor")
    err = 0.0
    for (name, x), (_, y) in zip(named_leaves(got), named_leaves(ref)):
        if x.is_floating_point():
            xs, ys = x[same_cursor], y[same_cursor]
            if not bool(close(xs, ys).all()):
                raise AssertionError(f"env_step: float field {name} disagrees beyond rtol")
            err = max(err, float((xs - ys).abs().max()))
    st = tree_map(torch.clone, state)
    out = dict(lanes=N, max_abs_err=err, moved_lanes=moved,
               **gpu_spread(lambda: K1.env_step(tables, samples, st, actions, N, True)),
               plain_ms=gpu_ms(lambda: K1.env_step_plain(tables, samples, state, actions, N,
                                                         True), 5))
    if parent is not None:  # the parent commit's kernel from the same state
        sp = tree_map(torch.clone, state)
        out.update(gpu_spread(lambda: parent.env_step.env_step(tables, samples, sp, actions, N,
                                                                True), "earlier_ms"))
    return out


def n_unique(*index: torch.Tensor, sizes) -> int:
    """Number of distinct index tuples (rows of a table that lanes share are
    read once)."""
    key = torch.zeros_like(index[0], dtype=torch.int64)
    for i, n in zip(index, sizes):
        key = key * n + i.long()
    return int(torch.unique(key).numel())


def env_step_bytes(tables, samples, state, actions) -> int:
    """Bytes K1 must move for this step's data: the lane state read and
    written, the action and the outputs; the distinct predicted and true
    viewport rows, the distinct (chunk, version, tile) sizes and qualities
    the allocation selects, the bandwidth and prefix rows of each trace in
    use, and for each lane that resets its sample row and accuracy entry."""
    from mansy_immersivevideostreaming_torch.ops.allocation import (
        action_to_rates, allocate_tile_rates,
    )
    V, C, R, T = tables.sizes.shape
    U, NT, L = tables.gt.shape[1], tables.bw.shape[0], tables.bw.shape[1]
    N = actions.shape[0]
    v, u, c = state.video, state.user, state.next_chunk
    rate_in, rate_out = action_to_rates(actions)
    versions, _ = allocate_tile_rates(rate_in, rate_out, tables.pred[v.long(), u.long(),
                                                                     c.long()])
    tile = torch.arange(T, device=v.device).expand(N, T)
    vct = [x[:, None].expand(N, T) for x in (v, c)] + [versions, tile]
    done = (c + 1) > tables.end_chunk[v.long(), u.long()]
    ptr = state.next_sample[done] % samples.shape[0]
    return (2 * tensor_bytes(state) + N * 4 + N * (6 * 4 + 5 * 4 + 1)
            + n_unique(v, u, c, sizes=(V, U, C)) * (2 * T * 4 + 4)    # pred, gt, vp_acc
            + n_unique(*vct, sizes=(V, C, R, T)) * 2 * 4               # sizes, qualities
            + n_unique(state.trace, sizes=(NT,)) * ((2 * L + 1) * 4 + 4)  # bw, prefix, len
            + n_unique(v, u, sizes=(V, U)) * 4                         # end_chunk
            + n_unique(state.qoe_id, sizes=(tables.qoe_weights.shape[0],)) * 3 * 4
            + (n_unique(ptr, sizes=(samples.shape[0],)) * (4 * 4 + 4) if ptr.numel() else 0))


def observe_bytes(tables, state, width: int) -> int:
    """Bytes K2 must move: the lane state it reads, the distinct chunk slabs
    (size and quality, every version) and predicted viewport rows, the
    distinct rows of the attached action-value tables, the distinct
    preference rows, and the [N, F] output."""
    V, C, R, T = tables.sizes.shape
    K, A, U = tables.past_k, tables.action_space, tables.pred.shape[1]
    N = state.buf.shape[0]
    v, u, c = state.video, state.user, state.next_chunk
    per_lane = 5 * 4 + 7 * K * 4 + A * 4 + width * 4
    av_tables = sum(getattr(tables, f) is not None for f in (
        "av_quality", "av_intra", "av_size", "av_out_quality", "av_out_intra"))
    if av_tables:
        per_lane += 4 + 1  # prev_quality, has_prev
    return (N * per_lane + n_unique(v, c, sizes=(V, C)) * 2 * R * T * 4
            + n_unique(v, u, c, sizes=(V, U, C)) * (T + av_tables * A) * 4
            + n_unique(state.qoe_id, sizes=(tables.qoe_weights.shape[0],)) * 3 * 4)


def observe_cases(K2, tables, state, parent=None) -> dict:
    """K2 at each path's width (the first n of the lanes): against its plain
    version (RTOL), two launches bit-equal, and the kernel's (with the spread
    of its 15 timings), the plain version's and, with ``parent``, the parent
    commit's kernel's ms, with its plan and bound; ``write_floor_ms`` is
    torch's ``fill_`` of the same [n, F] output, the time a kernel takes to
    write it alone."""
    from mansy_immersivevideostreaming_torch.sim.env import tree_map

    cases = {}
    for n in K2_WIDTHS:
        sub = tree_map(lambda x: x[:n].contiguous(), state)
        x = K2.observe_mansy_pack(tables, sub)
        x_ref = K2.observe_mansy_pack_plain(tables, sub)
        if not bool(close(x, x_ref).all()):
            raise AssertionError(f"observe_mansy_pack ({n} lanes, {x.shape[1]} columns) "
                                 "disagrees with its plain version")
        if not torch.equal(K2.observe_mansy_pack(tables, sub), x):
            raise AssertionError(f"observe_mansy_pack ({n} lanes): two launches differ")
        out = torch.empty_like(x)
        case = dict(lanes=n, width=x.shape[1], plan=K2.observe_plan(n)._asdict(),
                    max_abs_err=float((x - x_ref).abs().max()),
                    **gpu_spread(lambda: K2.observe_mansy_pack(tables, sub, out=out)),
                    plain_ms=gpu_ms(lambda: K2.observe_mansy_pack_plain(tables, sub), 5),
                    bound_ms=1e3 * observe_bytes(tables, sub, x.shape[1]) / HBM_BYTES_PER_S,
                    write_floor_ms=gpu_ms(lambda: out.fill_(0.0)))
        if parent is not None:  # the parent commit's kernel on the same lanes
            case["earlier_bits_equal"] = torch.equal(
                parent.observe.observe_mansy_pack(tables, sub), x)
            case.update(gpu_spread(lambda: parent.observe.observe_mansy_pack(
                tables, sub, out=out), "earlier_ms"))
        cases[str(n)] = case
    return cases


def observe_row(cases) -> dict:
    """K2's row: the widest case's numbers, with every case beside them."""
    main = cases[str(LANES)]
    return dict(max_abs_err=max(c["max_abs_err"] for c in cases.values()), width=main["width"],
                **{k: main[k] for k in main if k.endswith("ms") or k.endswith("range")},
                bound_by="bytes", library_ms=None, cases=cases)


def actor_critic_cost(w, N: int, A: int):
    """(flops, bytes) of K3: the branch, fc and head products (2 flops per
    multiply-add), the logit prior's standardization (about 6 flops an
    action) and the log-softmax; inputs read and outputs written once."""
    from mansy_immersivevideostreaming_torch.kernels.actor_critic import TENSOR_FIELDS
    H = w.b_branch.shape[1]
    nb, fin = len(w.branch_off) - 1, w.branch_off[-1]
    flops = N * (2 * (fin * H + nb * H * 2 * H + H * (A + 1)) + 4 * A
                 + (6 * A if w.av_prior else 0))
    weight_bytes = sum(getattr(w, f).numel() * 4 for f in TENSOR_FIELDS)
    return flops, N * (fin + A) * 4 + weight_bytes + N * (A + 3) * 4


def block_diagonal(w) -> torch.Tensor:
    """The branch weights as one dense block-diagonal [748/764, nb H] matrix."""
    H = w.b_branch.shape[1]
    nb, fin = len(w.branch_off) - 1, w.branch_off[-1]
    wbd = torch.zeros((fin, nb * H), device=w.w_branch.device)
    for b in range(nb):
        lo, hi = w.branch_off[b], w.branch_off[b + 1]
        wbd[lo:hi, b * H:(b + 1) * H] = w.w_branch[lo:hi]
    return wbd


def library_actor_critic(w):
    """The same function as one composition of torch matmuls over a dense
    block-diagonal branch weight: the yardstick (library_ms) only."""
    H, fin = w.b_branch.shape[1], w.branch_off[-1]
    wbd = block_diagonal(w)
    bias = w.b_branch.reshape(-1)
    cond_cols = slice(w.cond * H, (w.cond + 1) * H)

    def fn(x, noise):
        feats = torch.nn.functional.leaky_relu(x[:, :fin] @ wbd + bias, 0.01)
        cond = feats[:, cond_cols] if w.cond >= 0 else 0.0
        h = torch.nn.functional.leaky_relu(feats @ w.w_fc + w.b_fc, 0.01)
        logits = (h[:, :H] + cond) @ w.w_actor_out + w.b_actor_out
        if w.av_prior:
            av = x[:, w.av_off:w.av_off + logits.shape[1]]
            logits = logits + w.av_prior * (av - av.mean(-1, keepdim=True)) / (
                av.std(-1, correction=0, keepdim=True) + 1e-6)
        value = (h[:, H:] + cond) @ w.w_critic_out + w.b_critic_out
        logp = torch.log_softmax(logits, -1)
        action = (logits + noise).argmax(-1)
        return logits, value, action, logp.gather(-1, action[:, None])
    return fn


def actor_critic_timing(K3, w, x, noise=None, train: bool = False, parent=None) -> dict:
    """K3's forward (or its training mode) on ``x``: the kernel's, the plain
    version's and the ``torch.matmul`` composition's times (with ``parent``,
    the parent commit's kernel's, ``earlier_ms``), and two bounds: every
    operation in f32 outside the tensor cores (``bound_ms``), and the branch
    and fc products as the kernel runs them, three TF32 products on the
    tensor cores, the rest in f32 (``bound_3xtf32_ms``)."""
    N, A = x.shape[0], w.w_actor_out.shape[1]
    H = w.b_branch.shape[1]
    nb, fin = len(w.branch_off) - 1, w.branch_off[-1]
    flops, nbytes = actor_critic_cost(w, N, A)
    if train:
        nbytes += N * (nb + 2) * H * 4  # feats and hidden written
        run = lambda: K3.actor_critic_train_forward(w, x)
        plain = lambda: K3.actor_critic_train_forward_plain(w, x)
    else:
        run = lambda: K3.actor_critic_forward(w, x, noise)
        plain = lambda: K3.actor_critic_forward_plain(w, x, noise)
    products = 2 * N * (fin * H + nb * H * 2 * H)
    t_tc = 3 * products / TF32_FLOP_PER_S + (flops - products) / F32_FLOP_PER_S
    lib = library_actor_critic(w)
    zeros = torch.zeros((N, A), device=x.device)
    ctas, split = K3.cluster_plan(w, N)
    out = dict(lanes=N, cluster_ctas=ctas, split_branches=split, ms=gpu_ms(run),
               plain_ms=gpu_ms(plain),
               library_ms=gpu_ms(lambda: lib(x, zeros if noise is None else noise)),
               **bound(flops, nbytes),
               bound_3xtf32_ms=1e3 * max(t_tc, nbytes / HBM_BYTES_PER_S))
    if parent is not None:  # the parent commit's kernel on the same inputs
        earlier = parent.actor_critic
        out["earlier_ms"] = gpu_ms(
            (lambda: earlier.actor_critic_train_forward(w, x)) if train
            else (lambda: earlier.actor_critic_forward(w, x, noise)))
    return out


def digest(*tensors) -> str:
    """sha256 (16 hex digits) of the tensors' bytes, in order."""
    import hashlib
    return hashlib.sha256(b"".join(t.detach().cpu().numpy().tobytes()
                                   for t in tensors)).hexdigest()[:16]


def actor_critic_digests(K3, dev) -> dict:
    """Digests of K3's forward (numpy Gumbel noise) at 512 and 8192 lanes,
    its training mode at 4096 rows and K10 at 512 and 4096 rows (on the
    training mode's activations), at hidden 128 and 256 with v9's net and
    v16's with a logit prior of 3.0, every weight and input drawn with
    numpy: the bits the instances of the committed widths keep.  ``K3`` is
    this tree's ``kernels/actor_critic.py`` or another checkout's."""
    from mansy_immersivevideostreaming_torch.kernels.observe import obs_width
    from mansy_immersivevideostreaming_torch.models.abr_nets import MansyActorCritic

    f32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)
    out = {}
    for H in (128, 256):
        for label, kw in (("v9", {}), ("v16", dict(use_action_values=True, av_logit_prior=3.0))):
            rng = np.random.default_rng(H + len(label))
            policy = MansyActorCritic(hidden_dim=H, device=dev, **kw)
            with torch.no_grad():
                for p in policy.parameters():
                    p.copy_(f32(rng.normal(0.0, p.shape[-1] ** -0.5, tuple(p.shape))))
            w = policy.packed_weights()
            x = f32(rng.uniform(0.0, 1.0, (LANES, obs_width(*policy.dims))))
            noise = f32(rng.gumbel(size=(LANES, 15)))
            for n in (SERVE_CHUNK, LANES):
                out[f"forward_{label}_h{H}_{n}"] = digest(*K3.actor_critic_forward(
                    w, x[:n], noise[:n]))
            train = K3.actor_critic_train_forward(w, x[:CE_BATCH])
            out[f"train_forward_{label}_h{H}_{CE_BATCH}"] = digest(*train)
            dlogits = f32(rng.normal(size=(CE_BATCH, 15)) / CE_BATCH)
            dvalue = f32(rng.normal(size=CE_BATCH) / CE_BATCH)
            for n in TRAIN_BATCHES:
                out[f"backward_{label}_h{H}_{n}"] = digest(*K3.actor_critic_backward(
                    w, x[:n], train[2][:n], train[3][:n], dlogits[:n], dvalue[:n]))
    return out


def load_parent(root: str):
    """The K3, K10, K8, K1, K9, K2, K7, K5 and K6 wrappers of another checkout of
    the repo at ``root`` (the parent commit's, unpacked there), each bound
    to that checkout's ``kernels/build.py``, so they build its own ``csrc/``
    into its own ``kernels/build/``.  Returns a namespace with ``build``,
    ``actor_critic``, ``attention``, ``env_step``, ``policy_loss``,
    ``observe``, ``tile_occupancy``, ``expert_tables`` and ``gae``."""
    import importlib.util
    import types
    from mansy_immersivevideostreaming_torch import kernels
    from mansy_immersivevideostreaming_torch.kernels import build  # noqa: F401 (the attribute)

    kdir = os.path.join(root, PKG, "kernels")
    if not os.path.isdir(os.path.join(kdir, "csrc")):
        raise FileNotFoundError(f"--parent {root}: no {PKG}/kernels/csrc there")

    def module(name: str, own_build=None):
        spec = importlib.util.spec_from_file_location(f"parent_{name}",
                                                      os.path.join(kdir, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        with mock.patch.object(kernels, "build", own_build or kernels.build):
            spec.loader.exec_module(mod)
        return mod

    own = module("build")
    return types.SimpleNamespace(build=own, **{name: module(name, own) for name in (
        "actor_critic", "attention", "env_step", "policy_loss", "observe", "tile_occupancy",
        "expert_tables", "gae")})


# timed beside this tree's
PARENT_KERNELS = ("actor_critic", "actor_critic_backward", "attention", "env_step",
                  "policy_loss", "observe", "tile_occupancy", "expert_tables", "gae")
K1_WIDTHS = {"dagger": 32, "expert": 64, "train": 128, "serve": 512, "collect": LANES}
K2_WIDTHS = (LANES, SERVE_CHUNK, 128, DAGGER_LANES)  # collect, serve, train, DAgger


def kernel_phase(dev, parent=None):
    from mansy_immersivevideostreaming_torch.kernels import actor_critic as K3
    from mansy_immersivevideostreaming_torch.kernels import build
    from mansy_immersivevideostreaming_torch.kernels import env_step as K1
    from mansy_immersivevideostreaming_torch.kernels import observe as K2
    from mansy_immersivevideostreaming_torch.rl.rollout import init_lanes
    from mansy_immersivevideostreaming_torch.sim.env import (
        generate_environment_samples, tree_map,
    )
    from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables
    from mansy_immersivevideostreaming_torch.utils.checkpoint import (
        DAGGER_V18_NPZ, load_npz_policy,
    )

    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # nvcc for both trees at once
        earlier = pool.submit(parent.build.build, PARENT_KERNELS) if parent else None
        reports = build.build()
        earlier = earlier.result() if earlier is not None else {}
    log(f"built {sorted(reports) or 'nothing (cached)'} in {time.time() - t0:.1f}s")
    if parent:
        log(f"built the parent's {sorted(earlier) or 'nothing (cached)'}")
    for label, texts in (("", reports), ("parent ", earlier)):
        for name, text in texts.items():  # ptxas: registers, stack frame, spills
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {label}{name}: {line.strip()}")

    V, U, NT, C, Q = TRAIN_SHAPE
    tables = synthetic_sim_tables(V, U, NT, C, Q, seed=0, device=dev)
    samples = torch.as_tensor(generate_environment_samples(V, U, NT, Q), device=dev)
    N = LANES
    state = init_lanes(tables, samples, N)
    rng = np.random.default_rng(0)
    for _ in range(7):  # give the lanes history (plain path)
        acts = torch.as_tensor(rng.integers(0, 15, N).astype(np.int32), device=dev)
        state, *_ = K1.env_step_plain(tables, samples, state, acts, N, True)
    actions = torch.as_tensor(rng.integers(0, 15, N).astype(np.int32), device=dev)
    rows = {}

    # K2 at each path's width
    rows["observe_mansy_pack"] = observe_row(observe_cases(K2, tables, state, parent))
    x = K2.observe_mansy_pack(tables, state)

    # K3 (v9 weights, sampling noise)
    policy = load_npz_policy(device=dev)
    w = policy.packed_weights()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    noise = K3.gumbel_noise((N, tables.action_space), gen, dev)
    got = K3.actor_critic_forward(w, x, noise)
    ref = K3.actor_critic_forward_plain(w, x, noise)
    for g, r in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
        if not bool(close(g, r).all()):
            raise AssertionError("actor_critic_forward disagrees with its plain version")
    scores = ref[0] + noise
    top2 = scores.topk(2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 1e-4
    if not bool((got[2] == ref[2])[decisive].all()):
        raise AssertionError("actor_critic_forward picks other actions than its plain version")
    rows["actor_critic_forward"] = dict(
        max_abs_err=max(float((g - r).abs().max()) for g, r in zip(got[:2], ref[:2])),
        **actor_critic_timing(K3, w, x, noise, parent=parent),
        serve_chunk=actor_critic_timing(K3, w, x[:SERVE_CHUNK], noise[:SERVE_CHUNK],
                                        parent=parent))

    # K3 with v18's weights (hidden 256, v9's observation) at serve's lane
    # chunk and collect's width; two launches give the same bits
    w18 = load_npz_policy(DAGGER_V18_NPZ, device=dev).packed_weights()
    cases, err = {}, 0.0
    for n in (SERVE_CHUNK, N):
        got = K3.actor_critic_forward(w18, x[:n], noise[:n])
        ref = K3.actor_critic_forward_plain(w18, x[:n], noise[:n])
        for g, r in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
            if not bool(close(g, r).all()):
                raise AssertionError(f"actor_critic_forward (v18, {n} lanes) disagrees with its "
                                     f"plain version")
        top2 = (ref[0] + noise[:n]).topk(2, dim=-1).values
        if not bool((got[2] == ref[2])[(top2[:, 0] - top2[:, 1]) > 1e-4].all()):
            raise AssertionError(f"actor_critic_forward (v18, {n} lanes) picks other actions "
                                 f"than its plain version")
        if not all(torch.equal(a, b) for a, b in zip(got, K3.actor_critic_forward(
                w18, x[:n], noise[:n]))):
            raise AssertionError(f"actor_critic_forward (v18, {n} lanes): two launches differ")
        err = max(err, max(float((g - r).abs().max()) for g, r in zip(got[:2], ref[:2])))
        cases[f"{n}_lanes"] = actor_critic_timing(K3, w18, x[:n], noise[:n], parent=parent)
    rows["actor_critic_forward_h256"] = dict(max_abs_err=err, hidden=256,
                                             **cases[f"{SERVE_CHUNK}_lanes"], cases=cases)

    # K1 (one step from identical states) at each path's width: the first n
    # of the 8192 lanes
    cases = {}
    for path, n in K1_WIDTHS.items():
        sub = tree_map(lambda x: x[:n].contiguous(), state)
        cases[path] = dict(**check_env_step(tables, samples, sub, actions[:n], K1, tree_map,
                                            parent),
                           plan=K1.env_step_plan(n, tables.past_k)._asdict(),
                           bound_ms=1e3 * env_step_bytes(tables, samples, sub, actions[:n])
                           / HBM_BYTES_PER_S)
    main = cases["collect"]
    rows["env_step"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in cases.values()),
        **{k: main[k] for k in main if k.endswith("ms")}, bound_by="bytes", library_ms=None,
        cases=cases)
    return rows


# ---------------------------------------------------------------- phase 2b

def perturb_pred(tables, seed: int):
    """The tables with a predicted viewport that gets MISPREDICT of the tiles
    wrong: synthetic tables predict perfectly, so the expert's gt, pred, dep
    and out variants would coincide."""
    gt = tables.gt.cpu().numpy()
    flip = np.random.default_rng(seed).random(gt.shape) < MISPREDICT
    return tables._replace(pred=torch.as_tensor(np.where(flip, 1.0 - gt, gt),
                                                device=tables.device))


def cat_states(states):
    """Concatenate (nested) NamedTuples of [N, ...] tensors along the lanes."""
    if isinstance(states[0], tuple):
        return type(states[0])(*(cat_states([s[i] for s in states])
                                 for i in range(len(states[0]))))
    return torch.cat(states)


def search_lanes(tables, samples, dev):
    """SEARCH_LANES lanes for K4: half 7 steps into their episodes, half 52
    (their horizon crosses end_chunk), stepped by the plain env step, with
    varied accuracy histories (synthetic vp_acc is all ones)."""
    from mansy_immersivevideostreaming_torch.kernels.env_step import env_step_plain
    from mansy_immersivevideostreaming_torch.rl.rollout import init_lanes
    rng = np.random.default_rng(2)
    n = SEARCH_LANES // 2
    parts = []
    for steps, seed in ((7, 0), (52, 1000)):
        state = init_lanes(tables, samples, n, seed=seed)
        for _ in range(steps):
            acts = torch.as_tensor(rng.integers(0, 15, n).astype(np.int32), device=dev)
            state, *_ = env_step_plain(tables, samples, state, acts, n, True)
        parts.append(state)
    state = cat_states(parts)
    acc = state.past_acc
    varied = torch.as_tensor(rng.uniform(0.2, 1.0, acc.shape).astype(np.float32), device=dev)
    return state._replace(past_acc=torch.where(acc > 0, varied, acc))


def valid_steps(tables, state, horizon: int) -> torch.Tensor:
    """[N] steps of each lane's horizon before its end_chunk."""
    end = tables.end_chunk[state.video.long(), state.user.long()]
    return torch.clamp(end - state.next_chunk + 1, 0, horizon)


def search_flops(tables, state, horizon: int) -> int:
    """f32 operations of K4's privileged search, counted as a tree: a lane
    with hv steps before its end_chunk needs sum_{k=1..hv} 15^k virtual
    steps.  A step is 14 operations (push_chunk, the QoE and the running
    total) plus the download's 20 operations and ceil(log2(L+1)) compares
    of the prefix search; the argmax adds one compare for each of the 15^h
    totals."""
    A, L = tables.action_space, tables.bw.shape[1]
    per_step = 14 + 20 + math.ceil(math.log2(L + 1))
    steps = sum(sum(A ** k for k in range(1, hv + 1))
                for hv in valid_steps(tables, state, horizon).tolist())
    return steps * per_step + state.buf.shape[0] * A ** horizon


def expert_tables_cost(tables, A: int):
    """(flops, bytes) of K5: the least work the function needs.  Per (v, u,
    c), once: the complement (2 x 64 operations) and the three viewport sums
    (3 x 63 adds), which no action changes; per action two size sums (63
    adds each) and four evaluations (vp q and its sum, |q - quality|, its
    product and sum: 2 x 63 + 3 x 64 operations and 2 divisions).  Bytes:
    viewports and slabs read once, the ten tables written once."""
    V, U, C, T = tables.gt.shape
    R = tables.sizes.shape[2]
    rows = V * U * C
    flops = rows * (2 * T + 3 * (T - 1)
                    + A * (2 * (T - 1) + 4 * (2 * (T - 1) + 3 * T + 2)))
    nbytes = rows * 2 * T * 4 + V * C * R * T * 2 * 4 + rows * A * 10 * 4
    return flops, nbytes


def expert_tables_case(K5, X, tables, parent=None) -> dict:
    """K5 on ``tables`` against its plain version (RTOL), two launches
    bit-equal, its plan, the kernel's (with the spread of its 15 timings) and
    the plain version's ms and its bound; with ``parent``, the parent
    commit's kernel timed beside it, with whether its bits are equal and
    their largest difference."""
    got = K5.build_expert_tables(tables)
    ref = X.build_expert_tables_plain(tables)
    for name, g, r in zip(X.ExpertTables._fields, got, ref):
        if not bool(close(g, r).all()):
            raise AssertionError(f"build_expert_tables: {name} disagrees with its plain version "
                                 f"at {tuple(tables.gt.shape[:3])}")
    if not all(torch.equal(g, a) for g, a in zip(got, K5.build_expert_tables(tables))):
        raise AssertionError("build_expert_tables: two launches differ")
    V, U, C, _ = tables.gt.shape
    A = tables.action_space
    case = dict(rows=V * U * C, plan=K5.expert_tables_plan(V, U, C, A)._asdict(),
                max_abs_err=max(float((g - r).abs().max()) for g, r in zip(got, ref)),
                **gpu_spread(lambda: K5.build_expert_tables(tables)),
                plain_ms=gpu_ms(lambda: X.build_expert_tables_plain(tables), 3),
                **bound(*expert_tables_cost(tables, A)))
    if parent is not None:  # the parent commit's kernel on the same tables
        earlier = parent.expert_tables.build_expert_tables(tables)
        case["earlier_bits_equal"] = all(torch.equal(g, e) for g, e in zip(got, earlier))
        case["earlier_max_abs_diff"] = max(float((g - e).abs().max())
                                           for g, e in zip(got, earlier))
        case.update(gpu_spread(lambda: parent.expert_tables.build_expert_tables(tables),
                               "earlier_ms"))
    return case


def check_search(name, got, ref_action, ref_margin, first, wsum):
    """K4 against its plain version by the near-tie rule: the action equal
    on every lane whose plain first-action margin exceeds NEAR_TIE, and
    elsewhere one whose first-action value is within NEAR_TIE of the best
    (both over the weight sum); the margins equal to 1e-5.  Returns (lanes
    under the margin, lanes whose action differs, max margin error)."""
    action, margin = got
    decisive = ref_margin > NEAR_TIE
    if not bool((action[decisive] == ref_action[decisive]).all()):
        raise AssertionError(f"choose_action ({name}): another action than the plain version "
                             f"on {int((action != ref_action)[decisive].sum())} decisive lanes")
    gap = (first.amax(-1) - first.gather(1, action.long()[:, None])[:, 0]) / wsum
    if not bool((gap <= NEAR_TIE).all()):
        raise AssertionError(f"choose_action ({name}): an action {float(gap.max())} below "
                             f"the best first-action value")
    err = float((margin - ref_margin).abs().max())
    if err > 1e-5:
        raise AssertionError(f"choose_action ({name}): margins differ by {err}")
    return int((~decisive).sum()), int((action != ref_action).sum()), err


def long_horizon_cases(K4, X, tables, etables, state, acc_hat) -> dict:
    """K4 past the expert's default horizon: at 5, 6 and 7 (the JAX CLIs
    take any --horizon, the kernel 1 to 7) in every mode on
    LONG_HORIZON_LANES lanes, from both halves of ``search_lanes`` (7 and
    52 steps into their episodes; the first half's lane alone at 7), against its plain version by the
    near-tie rule (``check_search``), the plain version a lane at a time
    (its 15^h totals); two launches give the same action.  Each horizon is
    timed in the trace mode beside its bound and the plain version (its
    calls a lane at a time, LIMIT_REPS and 1 timings)."""
    from mansy_immersivevideostreaming_torch.sim.env import tree_map
    A, half, dev = tables.action_space, state.buf.shape[0] // 2, state.buf.device
    cases = {}
    for horizon, n in LONG_HORIZON_LANES.items():
        idx = torch.tensor([*range((n + 1) // 2), *range(half, half + n // 2)], device=dev)
        sub = tree_map(lambda x: x[idx], state)
        lanes = [tree_map(lambda x: x[i:i + 1], sub) for i in range(n)]
        bw_hat = X.causal_bw_estimate(tables, sub)
        modes = {"trace": (None, None, None), "bw_hat": (bw_hat, None, None),
                 "acc_hat": (None, acc_hat[idx], None),
                 "use_corr": (bw_hat, acc_hat[idx], torch.arange(n, device=dev) % 2 == 0)}
        checks, err = {}, 0.0
        for mode, lane_args in modes.items():
            got = K4.choose_action(tables, etables, sub, horizon, *lane_args, return_margin=True)
            refs, firsts = [], []
            for i, lane in enumerate(lanes):
                one = tuple(None if x is None else x[i:i + 1] for x in lane_args)
                refs.append(X.choose_action_plain(tables, etables, lane, horizon, *one,
                                                  return_margin=True))
                firsts.append(X.first_action_values(
                    X.sequence_totals(tables, etables, lane, horizon, *one), A))
            ref_action, ref_margin = (torch.cat(x) for x in zip(*refs))
            near, differ, m_err = check_search(
                f"{mode}, horizon {horizon}", got, ref_action, ref_margin, torch.cat(firsts),
                tables.qoe_weights[sub.qoe_id.long()].sum(-1))
            if not torch.equal(K4.choose_action(tables, etables, sub, horizon, *lane_args),
                               got[0]):
                raise AssertionError(f"choose_action ({mode}, horizon {horizon}): two launches "
                                     f"differ")
            checks[mode] = dict(lanes_under_margin=near, lanes_differing=differ)
            err = max(err, m_err)
            del refs, firsts
        cases[f"horizon_{horizon}"] = dict(
            lanes=n, sequences_a_lane=A ** horizon, checks=checks, max_abs_err=err,
            ms=gpu_ms(lambda: K4.choose_action(tables, etables, sub, horizon), LIMIT_REPS),
            plain_ms=gpu_ms(lambda: [X.choose_action_plain(tables, etables, lane, horizon)
                                     for lane in lanes], 1),
            bound_ms=1e3 * search_flops(tables, sub, horizon) / F32_FLOP_PER_S,
            bound_by="operations")
        torch.cuda.empty_cache()
        log(f"choose_action at horizon {horizon} on {n} lanes: "
            f"{json.dumps(cases[f'horizon_{horizon}'])}")
    return cases


def expert_kernel_phase(dev, parent=None):
    """K5 on the train split's tables and the test split's, K4 on
    SEARCH_LANES lanes in every mode at horizon 4 (and at 5, 6 and 7 on a
    few lanes, ``long_horizon_cases``), then K2 at each path's
    width and K3 at LANES with the action values attached and the v16
    weights (with ``parent``, the parent commit's K5 and K2 timed beside
    them).  Returns (rows of K4 and K5, K2 and K3's extra fields)."""
    from mansy_immersivevideostreaming_torch.kernels import actor_critic as K3
    from mansy_immersivevideostreaming_torch.kernels import choose_action as K4
    from mansy_immersivevideostreaming_torch.kernels import env_step as K1
    from mansy_immersivevideostreaming_torch.kernels import expert_tables as K5
    from mansy_immersivevideostreaming_torch.kernels import observe as K2
    from mansy_immersivevideostreaming_torch.rl.rollout import init_lanes
    from mansy_immersivevideostreaming_torch.sim import expert as X
    from mansy_immersivevideostreaming_torch.sim.env import (
        generate_environment_samples, viewport_acc_estimate,
    )
    from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables
    from mansy_immersivevideostreaming_torch.utils.checkpoint import (
        DAGGER_V16_NPZ, load_npz_policy,
    )

    V, U, NT, C, Q = TRAIN_SHAPE
    tables = perturb_pred(synthetic_sim_tables(V, U, NT, C, Q, seed=0, device=dev), seed=0)
    samples = torch.as_tensor(generate_environment_samples(V, U, NT, Q), device=dev)
    A = tables.action_space
    rows, extra = {}, {}

    # K5 on the train split's tables, and on the test split's (the expert's and serve-v16's)
    V, U, NT, C, Q = TEST_SHAPE
    test_tables = perturb_pred(synthetic_sim_tables(V, U, NT, C, Q, seed=1, device=dev), seed=1)
    shapes = {label: expert_tables_case(K5, X, t, parent)
              for label, t in (("train", tables), ("test", test_tables))}
    main = shapes["train"]
    rows["build_expert_tables"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in shapes.values()),
        **{k: main[k] for k in main if k.endswith("ms") or k.endswith("range")},
        bound_by=main["bound_by"], library_ms=None, shapes=shapes)
    etables = K5.build_expert_tables(tables)
    del test_tables

    # K4, every mode at horizon 4, with the margin
    state = search_lanes(tables, samples, dev)
    N = state.buf.shape[0]
    wsum = tables.qoe_weights[state.qoe_id.long()].sum(-1)
    bw_hat = X.causal_bw_estimate(tables, state)
    acc_hat = viewport_acc_estimate(state.past_acc)
    use_corr = torch.arange(N, device=dev) % 2 == 0
    modes = {"trace": (None, None, None), "bw_hat": (bw_hat, None, None),
             "acc_hat": (None, acc_hat, None), "use_corr": (bw_hat, acc_hat, use_corr)}
    checks, err = {}, 0.0
    for mode, (bw, acc, corr) in modes.items():
        got = K4.choose_action(tables, etables, state, HORIZON, bw, acc, corr,
                               return_margin=True)
        totals = X.sequence_totals(tables, etables, state, HORIZON, bw, acc, corr)
        first = X.first_action_values(totals, A)
        ref_action, ref_margin = X.choose_action_plain(tables, etables, state, HORIZON, bw,
                                                       acc, corr, return_margin=True)
        near, differ, m_err = check_search(mode, got, ref_action, ref_margin, first, wsum)
        if not torch.equal(K4.choose_action(tables, etables, state, HORIZON, bw, acc, corr),
                           got[0]):
            raise AssertionError(f"choose_action ({mode}): the margin changes the action")
        checks[mode] = dict(lanes_under_margin=near, lanes_differing=differ)
        err = max(err, m_err)
        del totals, first
    log(f"choose_action checks on {N} lanes: {json.dumps(checks)}")
    flops = search_flops(tables, state, HORIZON)
    # the expert path's width: one lane chunk of lanes 7 steps into their episodes
    chunk = type(state)(*(x[:EXPERT_CHUNK] if isinstance(x, torch.Tensor) else
                          type(x)(*(y[:EXPERT_CHUNK] for y in x)) for x in state))
    # and DAgger's: its first DAGGER_LANES lanes, scored at their accuracy estimate
    dagger = type(state)(*(x[:DAGGER_LANES] if isinstance(x, torch.Tensor) else
                           type(x)(*(y[:DAGGER_LANES] for y in x)) for x in state))
    dagger_acc = acc_hat[:DAGGER_LANES]
    rows["choose_action"] = dict(
        max_abs_err=err, lanes=N, horizon=HORIZON, checks=checks,
        ms=gpu_ms(lambda: K4.choose_action(tables, etables, state, HORIZON)),
        plain_ms=gpu_ms(lambda: X.choose_action_plain(tables, etables, state, HORIZON), 3),
        bound_ms=1e3 * flops / F32_FLOP_PER_S, bound_by="operations", library_ms=None,
        expert_chunk=dict(
            lanes=EXPERT_CHUNK, mode="trace",
            ms=gpu_ms(lambda: K4.choose_action(tables, etables, chunk, HORIZON)),
            plain_ms=gpu_ms(lambda: X.choose_action_plain(tables, etables, chunk, HORIZON), 3),
            bound_ms=1e3 * search_flops(tables, chunk, HORIZON) / F32_FLOP_PER_S),
        dagger_chunk=dict(
            lanes=DAGGER_LANES, mode="acc_hat",
            ms=gpu_ms(lambda: K4.choose_action(tables, etables, dagger, HORIZON,
                                               acc_hat=dagger_acc)),
            plain_ms=gpu_ms(lambda: X.choose_action_plain(tables, etables, dagger, HORIZON,
                                                          acc_hat=dagger_acc), 3),
            bound_ms=1e3 * search_flops(tables, dagger, HORIZON) / F32_FLOP_PER_S),
        long_horizons=long_horizon_cases(K4, X, tables, etables, state, acc_hat))
    del state, chunk, dagger

    # K2 with the accuracy-corrected action values, K3 with v16, at LANES
    tav = X.attach_action_values(tables, etables, acc_correct=True)
    lanes = init_lanes(tav, samples, LANES)
    rng = np.random.default_rng(3)
    for _ in range(7):
        acts = torch.as_tensor(rng.integers(0, 15, LANES).astype(np.int32), device=dev)
        lanes, *_ = K1.env_step_plain(tav, samples, lanes, acts, LANES, True)
    extra["observe_mansy_pack"] = observe_row(observe_cases(K2, tav, lanes, parent))
    x = K2.observe_mansy_pack(tav, lanes)
    w = load_npz_policy(DAGGER_V16_NPZ, device=dev).packed_weights()
    got = K3.actor_critic_forward(w, x)
    ref = K3.actor_critic_forward_plain(w, x)
    for g, r in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
        if not bool(close(g, r).all()):
            raise AssertionError("actor_critic_forward (v16) disagrees with its plain version")
    top2 = ref[0].topk(2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 1e-4
    if not bool((got[2] == ref[2])[decisive].all()):
        raise AssertionError("actor_critic_forward (v16) picks other actions than its plain "
                             "version")
    extra["actor_critic_forward"] = dict(
        max_abs_err=max(float((g - r).abs().max()) for g, r in zip(got[:2], ref[:2])),
        branches=len(w.branch_off) - 1, av_prior=w.av_prior, **actor_critic_timing(K3, w, x),
        serve_chunk=actor_critic_timing(K3, w, x[:SERVE_CHUNK]))
    return rows, extra


# ----------------------------------------------------------------- phase 3

def plain_serve(policy, tables, samples):
    """The serve path through the plain versions only (the reference); the
    policy's K2 mode decides the plain observation.  Returns the LogRecords,
    the first-done masks and each chunk's decisions for ``compare_lanes``:
    actions [T, n], top-two logit margins [T, n] and logits [T, n, A]
    (numpy)."""
    from mansy_immersivevideostreaming_torch.kernels.actor_critic import (
        actor_critic_forward_plain,
    )
    from mansy_immersivevideostreaming_torch.kernels.env_step import env_step_plain
    from mansy_immersivevideostreaming_torch.kernels.observe import (
        observe_mansy_pack_plain, observe_simple_pack, observe_simple_pack_plain,
    )
    from mansy_immersivevideostreaming_torch.rl.rollout import stack_logs
    from mansy_immersivevideostreaming_torch.rl.runner import (
        episode_step_bound, first_done_mask,
    )
    from mansy_immersivevideostreaming_torch.sim.env import reset_env

    w = policy.packed_weights()
    all_logs, all_masks, decisions = [], [], []
    for s0 in range(0, samples.shape[0], SERVE_CHUNK):
        sub = samples[s0:s0 + SERVE_CHUNK]
        n = sub.shape[0]
        state = reset_env(tables, sub, torch.arange(n, dtype=torch.int32, device=sub.device), n)
        logs, actions, all_logits = [], [], []
        for _ in range(episode_step_bound(tables)):
            if policy.observe is observe_simple_pack:
                x = observe_simple_pack_plain(tables, state)
            else:
                x = observe_mansy_pack_plain(tables, state,
                                             action_values=policy.reads_action_values)
            logits, _, action, _ = actor_critic_forward_plain(w, x, None)
            state, _, _, log_ = env_step_plain(tables, sub, state, action, n, False)
            logs.append(log_)
            actions.append(action)
            all_logits.append(logits)
        logs = stack_logs(logs)
        all_logs.append(logs)
        all_masks.append(first_done_mask(logs.done.cpu().numpy()))
        logits = torch.stack(all_logits)
        top2 = logits.topk(2, dim=-1).values
        decisions.append((torch.stack(actions).cpu().numpy(),
                          (top2[..., 0] - top2[..., 1]).cpu().numpy(), logits.cpu().numpy()))
    return all_logs, all_masks, decisions


def expect(counters, **launches):
    """Launches of one pass: ``launches`` by name, 0 for every other kernel."""
    return {fn.__name__: launches.get(fn.__name__, 0) for fn in counters}


def row_launches(counters) -> dict:
    """The wrappers' counts by kernels-line row: a wrapper's launches in each
    of its modes (``launches_by_mode``), else all of them, in the row of
    ``MODE_SUFFIX`` and ``SHARED_ROW``."""
    rows = {}
    for fn in counters:
        by_mode = getattr(fn, "launches_by_mode", None) or {None: fn.launches}
        for mode, n in by_mode.items():
            row = SHARED_ROW.get(fn.__name__, fn.__name__) + MODE_SUFFIX[mode]
            rows[row] = rows.get(row, 0) + n
    return rows


def timed_passes(run, counters, want, passes: int = PASSES):
    """Run ``run()`` ``passes`` times on the host clock, each ended by a
    synchronize.  Every count is set to 0 just before each pass and read
    just after it; each pass must launch each kernel ``want[name]`` times.
    Returns (last pass's result, seconds of each pass, launches of a pass
    by kernels-line row)."""
    seconds = []
    for _ in range(passes):
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
            getattr(fn, "launches_by_mode", {}).clear()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches = {fn.__name__: fn.launches for fn in counters}
        if launches != want:
            raise AssertionError(f"launches {launches}, expected {want}")
    return out, seconds, row_launches(counters)


def profile_update(run, steps: int) -> dict:
    """Where the time of a loop goes (an update loop, a serve or expert
    episode, a viewport batch).  ``run()`` makes ``steps`` steps; it is
    timed UPDATE_PASSES times on the host clock (each
    ended by a synchronize), then once more under ``torch.profiler``.  The
    device's busy time is the union of the device events' intervals; its
    share is taken of the unprofiled wall time (the median pass) and, apart,
    of the profiled one.  Per step: the wall time, the busy time, the
    costliest device ops and the host ops with the most self time."""
    from torch.profiler import ProfilerActivity, profile
    seconds = []
    for _ in range(UPDATE_PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    wall_s = statistics.median(seconds)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    events = prof.events()
    # a range that code marks (``record_function``, the optimizer's step) is
    # mirrored on the device from its first kernel to its last, idle gaps
    # included: only kernels, copies and sets count as busy
    host_names = {e.name for e in events if e.device_type != torch.autograd.DeviceType.CUDA}
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False) and e.name not in host_names]
    union, end, by_name = 0.0, float("-inf"), {}
    for e in sorted(device, key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        if b > end:
            union += b - max(a, end)
            end = b
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a)
    top = lambda pairs: {k[:80]: v / 1e3 / steps
                         for k, v in sorted(pairs, key=lambda kv: -kv[1])[:PROFILE_TOP]}
    return dict(steps=steps, passes=UPDATE_PASSES, ms_per_step=1e3 * wall_s / steps,
                ms_per_step_profiled=1e3 * prof_s / steps, device_captured=bool(device),
                device_busy_ms_per_step=union / 1e3 / steps,
                busy_share=union / 1e6 / wall_s, busy_share_profiled=union / 1e6 / prof_s,
                device_ms_per_step=top(by_name.items()),
                host_self_ms_per_step=top((a.key, a.self_cpu_time_total)
                                          for a in prof.key_averages()))


def rate_stats(work: int, seconds) -> dict:
    """Median rate of ``work`` units over the passes, and the passes' spread."""
    rates = sorted(work / s for s in seconds)
    return dict(median=statistics.median(rates), min=rates[0], max=rates[-1],
                spread=(rates[-1] - rates[0]) / statistics.median(rates))


def compare_serve(logs, masks, ref_logs, ref_masks, label: str) -> dict:
    """Hold a served grid to the plain path's: equal first-done masks, and
    every episode record equal (ints exact, floats rtol = atol = 1e-5, as
    test_torch_slice).  Returns the mean QoE of both."""
    for m, rm in zip(masks, ref_masks):
        if not np.array_equal(m, rm):
            raise AssertionError(f"{label}: first-done masks differ from the plain path's")
    differing = 0
    for name in logs[0]._fields:
        got = np.concatenate([getattr(l, name).cpu().numpy()[m] for l, m in zip(logs, masks)])
        ref = np.concatenate([getattr(l, name).cpu().numpy()[m]
                              for l, m in zip(ref_logs, ref_masks)])
        if np.issubdtype(ref.dtype, np.floating):
            if not np.isfinite(got).all():
                raise AssertionError(f"{label}: non-finite {name}")
            differing += int((np.abs(got - ref) > 1e-5 + 1e-5 * np.abs(ref)).sum())
        else:
            differing += int((got != ref).sum())
        if name == "qoe":
            qoe, ref_qoe = got, ref
    if differing:
        raise AssertionError(f"{label}: {differing} episode records differ from the plain path")
    return dict(mean_qoe=float(qoe.mean()), plain_mean_qoe=float(ref_qoe.mean()),
                episodes_differing=differing)


def serve_setup(dev, policy_name: str = "v9", path=None):
    """(policy, tables, samples, K5's launches) of a serve phase: the v9 or
    v18 weights, the policy npz at ``path``, or the v16 weights on tables
    whose accuracy-corrected action values K5 attaches, over the test
    grid."""
    from mansy_immersivevideostreaming_torch.kernels import expert_tables as K5
    from mansy_immersivevideostreaming_torch.sim.env import generate_environment_test_samples
    from mansy_immersivevideostreaming_torch.sim.expert import attach_action_values
    from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables
    from mansy_immersivevideostreaming_torch.utils.checkpoint import (
        DAGGER_V9_NPZ, DAGGER_V16_NPZ, DAGGER_V18_NPZ, load_npz_policy,
    )

    V, U, NT, C, Q = TEST_SHAPE
    tables = synthetic_sim_tables(V, U, NT, C, Q, seed=1, device=dev)
    samples = torch.as_tensor(generate_environment_test_samples(V, U, NT, Q), device=dev)
    path = path or {"v9": DAGGER_V9_NPZ, "v16": DAGGER_V16_NPZ, "v18": DAGGER_V18_NPZ}[policy_name]
    policy = load_npz_policy(path, device=dev)
    setup = 0
    if policy_name == "v16":
        tables = perturb_pred(tables, seed=1)
        K5.build_expert_tables.launches = 0
        tables = attach_action_values(tables, K5.build_expert_tables(tables),
                                      acc_correct=policy.acc_correct_obs)
        setup = K5.build_expert_tables.launches
    return policy, tables, samples, setup


def serve_phase(dev, counters, policy_name: str = "v9", path=None):
    """Serve the v9, v16 or v18 weights, or the policy npz at ``path``, over
    the test grid (``serve_setup``)."""
    from mansy_immersivevideostreaming_torch.rl.runner import episode_step_bound, evaluate

    label = "serve" if policy_name == "v9" else f"serve-{policy_name}"
    policy, tables, samples, setup = serve_setup(dev, policy_name, path)
    if setup != (1 if policy_name == "v16" else 0):
        raise AssertionError(f"{label}: K5 launched {setup} times at setup")
    evaluate(policy, tables, samples[:SERVE_CHUNK], deterministic=True)  # warm-up
    steps = -(-samples.shape[0] // SERVE_CHUNK) * episode_step_bound(tables)
    (logs, masks), seconds, launches = timed_passes(
        lambda: evaluate(policy, tables, samples, lane_chunk=SERVE_CHUNK, deterministic=True),
        counters, expect(counters, env_step=steps, observe_mansy_pack=steps,
                         actor_critic_forward=steps))
    n_eps = int(sum(m.sum() for m in masks))
    if n_eps != samples.shape[0]:
        raise AssertionError(f"{label}: {n_eps} of {samples.shape[0]} lanes finished an episode")
    ref_logs, ref_masks, _ = plain_serve(policy, tables, samples)
    qoe = compare_serve(logs, masks, ref_logs, ref_masks, label)
    rate = rate_stats(n_eps, seconds)
    launches["build_expert_tables"] += setup
    return dict(episodes=n_eps, steps=steps, passes=PASSES, seconds=seconds,
                hidden=int(policy.packed_weights().b_branch.shape[1]),
                episodes_per_s_median=rate["median"], episodes_per_s_min=rate["min"],
                episodes_per_s_max=rate["max"], spread=rate["spread"], **qoe,
                launches=launches)


# ----------------------------------------------------------------- phase 4

def collect_phase(dev, counters):
    from mansy_immersivevideostreaming_torch.rl.rollout import init_lanes, make_collector
    from mansy_immersivevideostreaming_torch.sim.env import generate_environment_samples
    from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables
    from mansy_immersivevideostreaming_torch.utils.checkpoint import load_npz_policy

    V, U, NT, C, Q = TRAIN_SHAPE
    tables = synthetic_sim_tables(V, U, NT, C, Q, seed=0, device=dev)
    samples = torch.as_tensor(generate_environment_samples(V, U, NT, Q), device=dev)
    policy = load_npz_policy(device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    lanes = [init_lanes(tables, samples, LANES)]
    make_collector(tables, samples, LANES, 4)(policy, lanes[0], gen)  # warm-up
    collect = make_collector(tables, samples, LANES, COLLECT_STEPS, train=True)

    def run():  # each pass goes on from the lanes the last one left
        lanes[0], *rest = collect(policy, lanes[0], gen)
        return rest

    want = expect(counters, env_step=COLLECT_STEPS, observe_mansy_pack=COLLECT_STEPS + 1,
                  actor_critic_forward=COLLECT_STEPS + 1)
    (traj, logs, last_values), seconds, launches = timed_passes(run, counters, want)
    T, N = COLLECT_STEPS, LANES
    if traj.reward.shape != (T, N) or traj.obs.shape != (T, N, 779):
        raise AssertionError("collect: trajectory of the wrong shape")
    for name, x in (("reward", traj.reward), ("value", traj.value),
                    ("log_prob", traj.log_prob), ("last_values", last_values)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"collect: non-finite {name}")
    if not bool((traj.log_prob <= 0).all()) or int(traj.done.sum()) == 0:
        raise AssertionError("collect: log-probs above 0 or no episode ended")
    rate = rate_stats(N * T, seconds)
    return dict(lanes=N, steps=T, passes=PASSES, seconds=seconds,
                env_steps_per_s_median=rate["median"], env_steps_per_s_min=rate["min"],
                env_steps_per_s_max=rate["max"], spread=rate["spread"],
                episodes_ended=int(traj.done.sum()),
                mean_step_reward=float(traj.reward.mean()), launches=launches)


# ----------------------------------------------------------------- phase 5

def plain_expert(tables, etables, samples):
    """The expert path through the plain versions only, lane chunk by lane
    chunk: (LogRecord [T, n], first-done mask, actions [T, n], the plain
    first-action margin [T, n] and first-action values [T, n, A], both over
    the weight sum)."""
    from mansy_immersivevideostreaming_torch.kernels.env_step import env_step_plain
    from mansy_immersivevideostreaming_torch.rl.rollout import stack_logs
    from mansy_immersivevideostreaming_torch.rl.runner import (
        episode_step_bound, first_done_mask,
    )
    from mansy_immersivevideostreaming_torch.sim import expert as X
    from mansy_immersivevideostreaming_torch.sim.env import reset_env

    A = tables.action_space
    out = []
    for s0 in range(0, samples.shape[0], EXPERT_CHUNK):
        sub = samples[s0:s0 + EXPERT_CHUNK]
        n = sub.shape[0]
        state = reset_env(tables, sub, torch.arange(n, dtype=torch.int32, device=sub.device), n)
        logs, actions, margins, firsts = [], [], [], []
        for _ in range(episode_step_bound(tables)):
            totals = X.sequence_totals(tables, etables, state, HORIZON)
            wsum = tables.qoe_weights[state.qoe_id.long()].sum(-1)
            first = X.first_action_values(totals, A) / wsum[:, None]
            top2 = first.topk(2, dim=-1).values
            action = (totals.argmax(-1) % A).to(torch.int32)
            state, _, _, log_ = env_step_plain(tables, sub, state, action, n, False)
            logs.append(log_)
            actions.append(action)
            margins.append(top2[:, 0] - top2[:, 1])
            firsts.append(first)
        logs = stack_logs(logs)
        out.append((logs, first_done_mask(logs.done.cpu().numpy()),
                    torch.stack(actions).cpu().numpy(), torch.stack(margins).cpu().numpy(),
                    torch.stack(firsts).cpu().numpy()))
    return out


def compare_lanes(chunks, ref_chunks, label: str = "expert", tie: float = NEAR_TIE) -> dict:
    """Hold a path to the plain path's, lane by lane: equal first-done
    masks; up to its first episode end, a lane takes the plain path's
    decisions and then has equal episode records (ints exact, floats rtol =
    atol = 1e-5), or its first differing decision is a near-tie (the plain
    margin at most ``tie`` and the path's decision within ``tie`` of the
    best plain score: phase 5's first-action values over the weight sum,
    phase 15's logits).  ``chunks``: (LogRecord [T, n], mask, decisions [T,
    n], ...); ``ref_chunks``: (LogRecord, mask, decisions, margin [T, n],
    scores [T, n, A]).  Returns the counts."""
    near_tie, same = 0, 0
    for (logs, mask, actions, *_), (rlogs, rmask, ractions, rmargin, rfirst) in zip(
            chunks, ref_chunks):
        if not np.array_equal(mask, rmask):
            raise AssertionError(f"{label}: first-done masks differ from the plain path's")
        logs = {name: x.cpu().numpy() for name, x in logs._asdict().items()}
        rlogs = {name: x.cpu().numpy() for name, x in rlogs._asdict().items()}
        for lane in range(mask.shape[1]):
            t_end = int(np.argwhere(mask[:, lane])[0][0])
            diff = np.flatnonzero(actions[:t_end + 1, lane] != ractions[:t_end + 1, lane])
            if diff.size:
                t = int(diff[0])
                gap = rfirst[t, lane].max() - rfirst[t, lane, actions[t, lane]]
                if rmargin[t, lane] > tie or gap > tie:
                    raise AssertionError(
                        f"{label}: lane {lane} decides otherwise at step {t} off a near-tie "
                        f"(plain margin {rmargin[t, lane]}, gap {gap})")
                near_tie += 1
                continue
            for name, x in logs.items():
                got, ref = x[t_end, lane], rlogs[name][t_end, lane]
                if (abs(got - ref) > 1e-5 + 1e-5 * abs(ref)) if np.issubdtype(x.dtype, np.floating) \
                        else got != ref:
                    raise AssertionError(f"{label}: lane {lane} record {name} {got} != {ref}")
            same += 1
    return dict(lanes_equal=same, lanes_near_tie=near_tie)


def expert_setup(dev):
    """(tables, etables, samples, K5's launches) of the expert phase: the
    test grid, its profiling tables built by K5."""
    from mansy_immersivevideostreaming_torch.kernels import expert_tables as K5
    from mansy_immersivevideostreaming_torch.sim.env import generate_environment_test_samples
    from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables

    V, U, NT, C, Q = TEST_SHAPE
    tables = perturb_pred(synthetic_sim_tables(V, U, NT, C, Q, seed=1, device=dev), seed=1)
    samples = torch.as_tensor(generate_environment_test_samples(V, U, NT, Q), device=dev)
    K5.build_expert_tables.launches = 0
    etables = K5.build_expert_tables(tables)
    return tables, etables, samples, K5.build_expert_tables.launches


def expert_phase(dev, counters):
    """The MPC expert over the 1440-episode grid, privileged, at the CLI's
    defaults, against the plain path on the card (every lane compared)."""
    from mansy_immersivevideostreaming_torch.cli.run_expert import run_expert_episodes
    from mansy_immersivevideostreaming_torch.rl.runner import episode_step_bound

    tables, etables, samples, setup = expert_setup(dev)
    if setup != 1:
        raise AssertionError(f"expert: K5 launched {setup} times at setup, expected 1")
    run_expert_episodes(tables, etables, samples[:EXPERT_CHUNK], HORIZON,
                        lane_chunk=EXPERT_CHUNK)  # warm-up
    steps = -(-samples.shape[0] // EXPERT_CHUNK) * episode_step_bound(tables)
    chunks, seconds, launches = timed_passes(
        lambda: run_expert_episodes(tables, etables, samples, HORIZON, lane_chunk=EXPERT_CHUNK),
        counters, expect(counters, env_step=steps, choose_action=steps), EXPERT_PASSES)
    n_eps = int(sum(c[1].sum() for c in chunks))
    if n_eps != samples.shape[0]:
        raise AssertionError(f"expert: {n_eps} of {samples.shape[0]} lanes finished an episode")
    t0 = time.time()
    ref_chunks = plain_expert(tables, etables, samples)
    plain_s = time.time() - t0
    counts = compare_lanes(chunks, ref_chunks)
    log(f"expert: {json.dumps(counts)} of {n_eps} lanes (all compared)")
    qoe = np.concatenate([c[0].qoe.cpu().numpy()[c[1]] for c in chunks])
    ref_qoe = np.concatenate([c[0].qoe.cpu().numpy()[c[1]] for c in ref_chunks])
    rate = rate_stats(n_eps, seconds)
    launches["build_expert_tables"] += setup
    return dict(episodes=n_eps, steps=steps, horizon=HORIZON, lane_chunk=EXPERT_CHUNK,
                passes=EXPERT_PASSES, seconds=seconds,
                episodes_per_s_median=rate["median"], episodes_per_s_min=rate["min"],
                episodes_per_s_max=rate["max"], spread=rate["spread"],
                ms_per_decision_median=1e3 * statistics.median(seconds) / steps,
                plain_seconds=plain_s, mean_qoe=float(qoe.mean()),
                plain_mean_qoe=float(ref_qoe.mean()), lanes_compared=n_eps, **counts,
                launches=launches)


def profile_phase(dev):
    """Where a serve step's (512 lanes), a collect step's (8192 lanes) and
    an expert decision's (64 lanes) time goes: one lane chunk's episode of
    serve and of the expert, PROFILE_COLLECT_STEPS steps of collect, per
    step.  Run after every path is timed: a profiler session leaves tracing
    on the host that would slow the later phases."""
    from mansy_immersivevideostreaming_torch.cli.run_expert import run_expert_episodes
    from mansy_immersivevideostreaming_torch.rl.rollout import init_lanes, make_collector
    from mansy_immersivevideostreaming_torch.rl.runner import episode_step_bound, evaluate
    from mansy_immersivevideostreaming_torch.sim.env import generate_environment_samples
    from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables
    from mansy_immersivevideostreaming_torch.utils.checkpoint import load_npz_policy

    policy, tables, samples, _ = serve_setup(dev)
    serve = profile_update(
        lambda: evaluate(policy, tables, samples[:SERVE_CHUNK], deterministic=True),
        episode_step_bound(tables))
    V, U, NT, C, Q = TRAIN_SHAPE  # collect as phase 4 runs it
    tables = synthetic_sim_tables(V, U, NT, C, Q, seed=0, device=dev)
    samples = torch.as_tensor(generate_environment_samples(V, U, NT, Q), device=dev)
    policy = load_npz_policy(device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    lanes = [init_lanes(tables, samples, LANES)]
    collect_fn = make_collector(tables, samples, LANES, PROFILE_COLLECT_STEPS, train=True)

    def collect():  # each run goes on from the lanes the last one left
        lanes[0], *_ = collect_fn(policy, lanes[0], gen)

    collect()  # warm-up
    collect = profile_update(collect, PROFILE_COLLECT_STEPS)
    tables, etables, samples, _ = expert_setup(dev)
    expert = profile_update(
        lambda: run_expert_episodes(tables, etables, samples[:EXPERT_CHUNK], HORIZON,
                                    lane_chunk=EXPERT_CHUNK),
        episode_step_bound(tables))
    return serve, collect, expert


# ---------------------------------------------------------------- phase 2c

def grads_close(got, ref) -> bool:
    """Gradients summed over the batch in another order: rtol GRAD_RTOL plus
    GRAD_RTOL / 10 of the tensor's largest entry."""
    scale = float(ref.abs().max()) * GRAD_RTOL / 10
    return bool(((got - ref).abs() <= GRAD_RTOL * ref.abs() + scale).all())


def gae_cost(T: int, N: int) -> int:
    """Bytes K6 must move: rewards, values (f32) and dones (bool) read, the
    bootstrap values read, advantages and returns written."""
    return T * N * (4 + 1 + 4 + 4 + 4) + N * 4


def policy_loss_cost(spec, B: int, A: int):
    """(operations, bytes) of K9: log-softmax, entropy and the logit gradient
    about 17 operations a logit (an exp or log counted as one), the PPO
    terms about 40 a row, the A2C terms about 8, the KL 10 more a logit;
    inputs read and outputs written once."""
    flops = B * 17 * A
    nbytes = B * A * 4 * 2 + B * 4 + 16  # logits, dlogits, action; loss and terms
    if spec.mode == "a2c":  # value, adv, ret read; dvalue written
        flops += B * 8
        nbytes += B * 4 * 4
    if spec.mode == "ppo":
        flops += B * 40
        nbytes += B * 4 * 6 + (B * 4 if spec.pref_id is not None else 0)
        if spec.anchor_logits is not None:
            flops += B * 10 * A
            nbytes += B * A * 4 + spec.kl_coef.numel() * 4
    return flops, nbytes


def backward_cost(w, B: int, A: int):
    """(operations, bytes) of K10: the head gradients (2 x 128 x (A + 1)
    twice a row), dW_fc and dPre_b (2 x nb 128 x 256 each), the branch
    weights (2 x 748/764 x 128), the leaky' and residual epilogues and the
    bias sums; the activations, weights and gradients read and written
    once."""
    from mansy_immersivevideostreaming_torch.kernels.actor_critic import TENSOR_FIELDS
    H = w.b_branch.shape[1]
    nb, fin = len(w.branch_off) - 1, w.branch_off[-1]
    F = nb * H
    flops = B * (4 * H * (A + 1) + 2 * 2 * F * 2 * H + 2 * fin * H + 4 * 2 * H + 3 * F + A + 1)
    weight_bytes = sum(getattr(w, f).numel() * 4 for f in TENSOR_FIELDS)
    nbytes = B * (fin + F + 2 * H + A + 1) * 4 + 2 * weight_bytes
    return flops, nbytes


def backward_bounds(w, B: int, A: int) -> dict:
    """K10's two bounds: every operation in f32 outside the tensor cores
    (``bound_ms``), and as the kernel runs them (``bound_3xtf32_ms``): dPre_b,
    dW_fc, the branch and the head weight products as three TF32 products on
    the tensor cores, the rest (the head's d/dy, the epilogues) in f32."""
    H = w.b_branch.shape[1]
    nb, fin = len(w.branch_off) - 1, w.branch_off[-1]
    flops, nbytes = backward_cost(w, B, A)
    products = 2 * B * (2 * nb * H * 2 * H + fin * H + H * (A + 1))
    t_tc = 3 * products / TF32_FLOP_PER_S + (flops - products) / F32_FLOP_PER_S
    return dict(**bound(flops, nbytes), bound_3xtf32_ms=1e3 * max(t_tc, nbytes / HBM_BYTES_PER_S))


def bound(flops: int, nbytes: int, flop_per_s: float = F32_FLOP_PER_S) -> dict:
    t_ops, t_bytes = flops / flop_per_s, nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops > t_bytes else "bytes")


def library_actor_critic_grad(w, x, dlogits, dvalue):
    """The yardstick of K10 (library_ms only): autograd's backward through
    the ``torch.matmul`` composition of ``library_actor_critic``, with the
    branch weights as one dense block-diagonal matrix, from the same
    incoming gradients.  Returns a function that runs the backward once."""
    H, fin = w.b_branch.shape[1], w.branch_off[-1]
    leaf = [t.detach().clone().requires_grad_() for t in (
        block_diagonal(w), w.b_branch.reshape(-1), w.w_fc, w.b_fc, w.w_actor_out, w.b_actor_out,
        w.w_critic_out, w.b_critic_out)]
    wb, bb, wfc, bfc, wa, ba, wc, bc = leaf
    feats = torch.nn.functional.leaky_relu(x[:, :fin] @ wb + bb, 0.01)
    cond = feats[:, w.cond * H:(w.cond + 1) * H] if w.cond >= 0 else 0.0
    h = torch.nn.functional.leaky_relu(feats @ wfc + bfc, 0.01)
    logits = (h[:, :H] + cond) @ wa + ba
    value = ((h[:, H:] + cond) @ wc + bc)[:, 0]
    return lambda: torch.autograd.grad((logits, value), leaf, (dlogits, dvalue),
                                       retain_graph=True)


def library_cross_entropy(logits, action):
    """K9 CE mode's yardstick (library_ms only): ``F.cross_entropy`` forward
    and its backward by autograd on the same logits and labels; it computes
    less than K9 (no entropy term).  Returns a function that runs both once."""
    leaf = logits.detach().clone().requires_grad_()
    target = action.long()
    return lambda: torch.autograd.grad(torch.nn.functional.cross_entropy(leaf, target), leaf)


def training_inputs(dev, n: int = max(TRAIN_BATCHES)):
    """Packed observations of ``n`` lanes (the largest training batch's) on
    tables of the train split's shape, 7 steps into their episodes: 779
    columns (v9's observation), and 795 with K5's accuracy-corrected action
    values attached (v16's)."""
    from mansy_immersivevideostreaming_torch.kernels import expert_tables as K5
    from mansy_immersivevideostreaming_torch.kernels.env_step import env_step_plain
    from mansy_immersivevideostreaming_torch.kernels.observe import observe_mansy_pack
    from mansy_immersivevideostreaming_torch.rl.rollout import init_lanes
    from mansy_immersivevideostreaming_torch.sim.env import generate_environment_samples
    from mansy_immersivevideostreaming_torch.sim.expert import attach_action_values
    from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables

    V, U, NT, C, Q = TRAIN_SHAPE
    tables = perturb_pred(synthetic_sim_tables(V, U, NT, C, Q, seed=0, device=dev), seed=2)
    samples = torch.as_tensor(generate_environment_samples(V, U, NT, Q), device=dev)
    state = init_lanes(tables, samples, n, seed=4)
    rng = np.random.default_rng(4)
    for _ in range(7):
        acts = torch.as_tensor(rng.integers(0, 15, n).astype(np.int32), device=dev)
        state, *_ = env_step_plain(tables, samples, state, acts, n, True)
    tav = attach_action_values(tables, K5.build_expert_tables(tables), acc_correct=True)
    return observe_mansy_pack(tables, state), observe_mansy_pack(tav, state)


def training_kernel_phase(dev, parent=None):
    """K6 at [32, 128] and [128, 8192]; K9 in every PPO variant at B = 512
    and in CE mode at B = 4096 (CE also beside ``F.cross_entropy``); K3's
    training mode and K10 at B = 512 and 4096 with the v9 and v16 weights.
    Each against its plain version on the same card tensors (K6 bit-equal),
    timed with CUDA events (K6, K9 and K10 also: two launches give the same
    bits; with ``parent``, the parent commit's K6, K9 and K10 timed beside
    them, K6 with the parent's bits).  Returns the kernels' rows."""
    from mansy_immersivevideostreaming_torch.kernels import actor_critic as K3
    from mansy_immersivevideostreaming_torch.kernels import gae as K6
    from mansy_immersivevideostreaming_torch.kernels import policy_loss as K9
    from mansy_immersivevideostreaming_torch.utils.checkpoint import (
        DAGGER_V9_NPZ, DAGGER_V16_NPZ, DAGGER_V18_NPZ, load_npz_policy,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    rows = {}

    # K6
    shapes = {}
    for T, N in GAE_SHAPES:
        rewards = torch.randn(T, N, device=dev, generator=gen)
        values = torch.randn(T, N, device=dev, generator=gen)
        dones = torch.rand(T, N, device=dev, generator=gen) < 0.05
        last = torch.randn(N, device=dev, generator=gen)
        args = (rewards, dones, values, last, 0.95, 0.95)
        got, ref = K6.compute_gae(*args), K6.compute_gae_plain(*args)
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):  # the same operation order
            raise AssertionError(f"compute_gae [{T}, {N}] is not bit-equal to its plain version")
        if not all(torch.equal(g, a) for g, a in zip(got, K6.compute_gae(*args))):
            raise AssertionError(f"compute_gae [{T}, {N}]: two launches differ")
        shape = shapes[f"{T}x{N}"] = dict(
            max_abs_err=max(float((g - r).abs().max()) for g, r in zip(got, ref)),
            plan=K6.gae_plan(T, N)._asdict(), **gpu_spread(lambda: K6.compute_gae(*args)),
            plain_ms=gpu_ms(lambda: K6.compute_gae_plain(*args), 5),
            **bound(6 * T * N, gae_cost(T, N)))
        if parent is not None:  # the parent commit's kernel on the same inputs: the same bits
            shape["earlier_bits_equal"] = all(torch.equal(g, e) for g, e in zip(
                got, parent.gae.compute_gae(*args)))
            if not shape["earlier_bits_equal"]:
                raise AssertionError(f"compute_gae [{T}, {N}]: bits differ from the parent's")
            shape.update(gpu_spread(lambda: parent.gae.compute_gae(*args), "earlier_ms"))
    main = shapes["x".join(map(str, GAE_SHAPES[-1]))]
    rows["compute_gae"] = dict(**main, library_ms=None, shapes=shapes)

    # K9
    A, B = 15, PPO_BATCH
    r = lambda *s: torch.randn(*s, device=dev, generator=gen)
    logits, value = 2.0 * r(B, A), r(B)
    action = torch.randint(0, A, (B,), device=dev, generator=gen, dtype=torch.int32)
    logp = torch.log_softmax(logits, -1).gather(1, action.long()[:, None])[:, 0]
    base = dict(action=action, ent_coef=0.02, old_log_prob=logp + 0.3 * r(B),
                old_value=value + 0.3 * r(B), adv=0.5 + 2.0 * r(B), ret=1.5 * r(B),
                pref_id=torch.randint(0, 4, (B,), device=dev, generator=gen, dtype=torch.int32))
    anchor = 1.5 * r(B, A)
    kl = {"kl_scalar": torch.tensor(0.7, device=dev),
          "kl_per_pref": torch.tensor([2.0, 1.0, 0.1, 0.5], device=dev)}
    variants = {
        "clip_norm": dict(), "no_value_clip": dict(value_clip=False),
        "no_norm": dict(norm_adv=False), "per_pref": dict(norm_adv_per_pref=True),
        "kl_scalar": dict(anchor_logits=anchor, kl_coef=kl["kl_scalar"]),
        "kl_per_pref": dict(anchor_logits=anchor, kl_coef=kl["kl_per_pref"],
                            norm_adv_per_pref=True)}
    ce_logits = 2.0 * r(CE_BATCH, A)
    ce_action = torch.randint(0, A, (CE_BATCH,), device=dev, generator=gen, dtype=torch.int32)
    cases = {name: (K9.LossSpec(**base, **kw, mode="ppo"), logits, value)
             for name, kw in variants.items()}
    cases["ce"] = (K9.LossSpec(action=ce_action, ent_coef=0.1), ce_logits, None)
    out, err = {}, 0.0
    for name, (spec, lg, v) in cases.items():
        got, ref = K9.policy_loss(spec, lg, v), K9.policy_loss_plain(spec, lg, v)
        for g, rf in zip(got, ref):
            if (g is None) != (rf is None) or (rf is not None and not bool(close(g, rf).all())):
                raise AssertionError(f"policy_loss ({name}) disagrees with its plain version")
        err = max(err, max(float((g - rf).abs().max()) for g, rf in zip(got, ref)
                           if rf is not None))
        again = K9.policy_loss(spec, lg, v)
        if not all(g is None or torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"policy_loss ({name}): two launches differ")
        out[name] = dict(batch=lg.shape[0], plan=K9.policy_loss_plan(lg.shape[0])._asdict(),
                         **gpu_spread(lambda: K9.policy_loss(spec, lg, v)),
                         plain_ms=gpu_ms(lambda: K9.policy_loss_plain(spec, lg, v), 5),
                         **bound(*policy_loss_cost(spec, lg.shape[0], A)))
        if parent is not None:  # the parent commit's kernel on the same inputs
            fields = parent.policy_loss.LossSpec._fields  # its own spec, as its modes read it
            old = parent.policy_loss.LossSpec(**{k: x for k, x in spec._asdict().items()
                                                 if k in fields})
            out[name].update(gpu_spread(lambda: parent.policy_loss.policy_loss(old, lg, v),
                                        "earlier_ms"))
    # CE's yardstick: cross_entropy forward and backward by autograd (no entropy term)
    out["ce"]["library_ms"] = gpu_ms(library_cross_entropy(ce_logits, ce_action))
    rows["policy_loss"] = dict(max_abs_err=err, **{k: out["clip_norm"][k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by") + (("earlier_ms",) if parent else ())},
        library_ms=None, variants=out)

    # K3's training mode and K10 (v18: hidden 256, v9's observation)
    x9, x16 = training_inputs(dev)
    fwd, bwd = {}, {}
    f_err, b_err = {128: 0.0, 256: 0.0}, {128: 0.0, 256: 0.0}
    for label, path, x_all in (("v9", DAGGER_V9_NPZ, x9), ("v16", DAGGER_V16_NPZ, x16),
                               ("v18", DAGGER_V18_NPZ, x9)):
        w = load_npz_policy(path, device=dev).packed_weights()
        H = w.b_branch.shape[1]
        for Bn in TRAIN_BATCHES:
            x = x_all[:Bn]
            got = K3.actor_critic_train_forward(w, x)
            ref = K3.actor_critic_train_forward_plain(w, x)
            if not all(bool(close(g, rf).all()) for g, rf in zip(got, ref)):
                raise AssertionError(f"actor_critic_train_forward ({label}, B = {Bn}) disagrees "
                                     f"with its plain version")
            if not all(torch.equal(g, a) for g, a in zip(got, K3.actor_critic_train_forward(w, x))):
                raise AssertionError(f"actor_critic_train_forward ({label}, B = {Bn}): two "
                                     f"launches differ")
            f_err[H] = max(f_err[H], max(float((g - rf).abs().max()) for g, rf in zip(got, ref)))
            key = f"{label}_B{Bn}"
            fwd[key] = actor_critic_timing(K3, w, x, train=True, parent=parent)
            dlogits, dvalue = r(Bn, A) / Bn, r(Bn) / Bn
            acts = ref[2], ref[3]
            got = K3.actor_critic_backward(w, x, *acts, dlogits, dvalue)
            ref_g = K3.actor_critic_backward_plain(w, x, *acts, dlogits, dvalue)
            for f, g, rf in zip(K3.TENSOR_FIELDS, got, ref_g):
                if not grads_close(g, rf):
                    raise AssertionError(f"actor_critic_backward ({key}): {f} disagrees with "
                                         f"its plain version")
                b_err[H] = max(b_err[H], float((g - rf).abs().max()))
            again = K3.actor_critic_backward(w, x, *acts, dlogits, dvalue)
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise AssertionError(f"actor_critic_backward ({key}): two launches differ")
            lib_grad = library_actor_critic_grad(w, x, dlogits, dvalue)
            plan = K3.backward_plan(Bn, w.branch_off, K3._sm_count(torch.cuda.current_device()),
                                    H)
            bwd[key] = dict(ms=gpu_ms(lambda: K3.actor_critic_backward(w, x, *acts, dlogits,
                                                                      dvalue)),
                            plain_ms=gpu_ms(lambda: K3.actor_critic_backward_plain(
                                w, x, *acts, dlogits, dvalue)),
                            library_ms=gpu_ms(lib_grad), **backward_bounds(w, Bn, A),
                            plan=plan._asdict())
            if parent is not None:  # the parent commit's kernel on the same inputs
                bwd[key]["earlier_ms"] = gpu_ms(lambda: parent.actor_critic.actor_critic_backward(
                    w, x, *acts, dlogits, dvalue))
    for suffix, H, main in (("", 128, f"v9_B{PPO_BATCH}"), ("_h256", 256, f"v18_B{PPO_BATCH}")):
        mine = lambda cases: {k: v for k, v in cases.items() if k.startswith("v18") == (H == 256)}
        rows[f"actor_critic_train_forward{suffix}"] = dict(max_abs_err=f_err[H], hidden=H,
                                                           **fwd[main], cases=mine(fwd))
        rows[f"actor_critic_backward{suffix}"] = dict(max_abs_err=b_err[H], hidden=H,
                                                      **bwd[main], cases=mine(bwd))
    return rows


# ---------------------------------------------------------------- phase 2h

def widths_kernel_phase(dev, parent=None):
    """Phase 2h: K3 (the forward with its action head, and the training
    mode) and K10 at every hidden width of WIDTHS_2H in v9's layout, and of
    AV_WIDTHS_2H with v16's 11 branches and a logit prior of 3.0, each net
    from Flax's initialiser at a seed, on the packed observations of the
    train split's lanes (``training_inputs``): the forward at 512 and 8192
    lanes, the training mode and K10 at 512 and 4096 rows.  Each against its
    plain version at phases 2's and 2c's tolerances (K10 on the plain
    training mode's activations), two launches bit-equal, timed beside its
    bounds (operations at the real width, f32 and 3xTF32), its plain
    version and the ``torch.matmul`` composition.  With ``parent``: the
    instances of the committed widths, 128 and 256, against the parent's
    kernels: ``actor_critic_digests`` equal, and the times of K3 at
    collect's 8192 lanes and of K10 at DAgger's 4096 rows in turns (parent,
    this tree, this tree, parent) within PARENT_MARGIN.  Returns the rows of
    the instances 64 and 192 and of the wide variant (main case: PATH_WIDTHS
    at 512 lanes or rows), the other widths of the 128 instance as
    ``cases_other_widths`` of phase 2's and 2c's rows, and with ``parent``
    the comparison as ``earlier_check`` of the 128 and 256 rows."""
    from mansy_immersivevideostreaming_torch.kernels import actor_critic as K3
    from mansy_immersivevideostreaming_torch.models.abr_nets import MansyActorCritic
    from mansy_immersivevideostreaming_torch.utils.checkpoint import (
        DAGGER_V9_NPZ, DAGGER_V18_NPZ, load_npz_policy,
    )

    x9, x16 = training_inputs(dev, LANES)
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    noise = K3.gumbel_noise((LANES, 15), gen, dev)
    cases, errors = {}, {}

    def add(row: str, key: str, err: float, case: dict) -> None:
        cases.setdefault(row, {})[key] = case
        errors[row] = max(errors.get(row, 0.0), err)

    nets = [("v9", H, {}, x9) for H in WIDTHS_2H] + [
        ("v16", H, dict(use_action_values=True, av_logit_prior=AV_PRIOR), x16)
        for H in AV_WIDTHS_2H]
    for label, H, kw, x_all in nets:
        torch.manual_seed(H)
        w = MansyActorCritic(hidden_dim=H, device=dev, **kw).packed_weights()
        suffix = MODE_SUFFIX[K3.launch_mode(w)]
        for n in (SERVE_CHUNK, LANES):
            x, nz = x_all[:n], noise[:n]
            got = K3.actor_critic_forward(w, x, nz)
            ref = K3.actor_critic_forward_plain(w, x, nz)
            top2 = (ref[0] + nz).topk(2, dim=-1).values
            decisive = (top2[:, 0] - top2[:, 1]) > 1e-4
            if not all(bool(close(g, r).all())
                       for g, r in zip(got[:2] + got[3:], ref[:2] + ref[3:])) \
                    or not bool((got[2] == ref[2])[decisive].all()):
                raise AssertionError(f"actor_critic_forward ({label}, hidden {H}, {n} lanes) "
                                     f"disagrees with its plain version")
            if not all(torch.equal(a, b) for a, b in zip(got, K3.actor_critic_forward(w, x, nz))):
                raise AssertionError(f"actor_critic_forward ({label}, hidden {H}, {n} lanes): two "
                                     f"launches differ")
            add(f"actor_critic_forward{suffix}", f"{label}_h{H}_{n}",
                max(float((g - r).abs().max()) for g, r in zip(got[:2], ref[:2])),
                dict(hidden=H, **actor_critic_timing(K3, w, x, nz)))
        for n in TRAIN_BATCHES:
            x = x_all[:n]
            got = K3.actor_critic_train_forward(w, x)
            ref = K3.actor_critic_train_forward_plain(w, x)
            if not all(bool(close(g, r).all()) for g, r in zip(got, ref)):
                raise AssertionError(f"actor_critic_train_forward ({label}, hidden {H}, B = {n}) "
                                     f"disagrees with its plain version")
            if not all(torch.equal(a, b) for a, b in zip(got, K3.actor_critic_train_forward(w, x))):
                raise AssertionError(f"actor_critic_train_forward ({label}, hidden {H}, B = {n}): "
                                     f"two launches differ")
            add(f"actor_critic_train_forward{suffix}", f"{label}_h{H}_B{n}",
                max(float((g - r).abs().max()) for g, r in zip(got, ref)),
                dict(hidden=H, **actor_critic_timing(K3, w, x, train=True)))
            dlogits = torch.randn(n, 15, device=dev, generator=gen) / n
            dvalue = torch.randn(n, device=dev, generator=gen) / n
            acts = ref[2], ref[3]
            got = K3.actor_critic_backward(w, x, *acts, dlogits, dvalue)
            want = K3.actor_critic_backward_plain(w, x, *acts, dlogits, dvalue)
            for f, g, r in zip(K3.TENSOR_FIELDS, got, want):
                if not grads_close(g, r):
                    raise AssertionError(f"actor_critic_backward ({label}, hidden {H}, B = {n}): "
                                         f"{f} disagrees with its plain version")
            if not all(torch.equal(a, b) for a, b in zip(
                    got, K3.actor_critic_backward(w, x, *acts, dlogits, dvalue))):
                raise AssertionError(f"actor_critic_backward ({label}, hidden {H}, B = {n}): two "
                                     f"launches differ")
            plan = K3.backward_plan(n, w.branch_off, K3._sm_count(torch.cuda.current_device()), H)
            add(f"actor_critic_backward{suffix}", f"{label}_h{H}_B{n}",
                max(float((g - r).abs().max()) for g, r in zip(got, want)),
                dict(hidden=H, plan=plan._asdict(),
                     ms=gpu_ms(lambda: K3.actor_critic_backward(w, x, *acts, dlogits, dvalue)),
                     plain_ms=gpu_ms(lambda: K3.actor_critic_backward_plain(
                         w, x, *acts, dlogits, dvalue)),
                     library_ms=gpu_ms(library_actor_critic_grad(w, x, dlogits, dvalue)),
                     **backward_bounds(w, n, 15)))

    rows = {}
    for row, by_case in cases.items():
        suffix = next((s for s in PATH_WIDTHS if row.endswith(s)), "")
        if not suffix:  # widths of the 128 instance: cases of phase 2's and 2c's rows
            rows[row] = dict(cases_other_widths=by_case)
            continue
        forward = row.startswith("actor_critic_forward")
        n = SERVE_CHUNK if forward else PPO_BATCH
        main = by_case[f"v9_h{PATH_WIDTHS[suffix]}_{'' if forward else 'B'}{n}"]
        rows[row] = dict(max_abs_err=errors[row],
                         **{k: main[k] for k in ("hidden", "ms", "plain_ms", "library_ms",
                                                 "bound_ms", "bound_by", "bound_3xtf32_ms")},
                         main_case=f"v9, hidden {PATH_WIDTHS[suffix]}, {n} rows", cases=by_case)

    if parent is not None:  # the exact instances against the parent's kernels
        mine = actor_critic_digests(K3, dev)
        theirs = actor_critic_digests(parent.actor_critic, dev)
        if mine != theirs:
            raise AssertionError(f"K3 / K10 at 128 and 256: digests differ from the parent's in "
                                 f"{sorted(k for k in mine if mine[k] != theirs[k])}")
        earlier = parent.actor_critic
        x9b = x9[:CE_BATCH]
        for H, path, suffix in ((128, DAGGER_V9_NPZ, ""), (256, DAGGER_V18_NPZ, "_h256")):
            w = load_npz_policy(path, device=dev).packed_weights()
            _, _, feats, hidden = K3.actor_critic_train_forward_plain(w, x9b)
            dlogits = torch.randn(CE_BATCH, 15, device=dev, generator=gen) / CE_BATCH
            dvalue = torch.randn(CE_BATCH, device=dev, generator=gen) / CE_BATCH
            for row, shape, this, that in (
                    (f"actor_critic_forward{suffix}", f"{LANES} lanes",
                     lambda: K3.actor_critic_forward(w, x9, noise),
                     lambda: earlier.actor_critic_forward(w, x9, noise)),
                    (f"actor_critic_backward{suffix}", f"{CE_BATCH} rows",
                     lambda: K3.actor_critic_backward(w, x9b, feats, hidden, dlogits, dvalue),
                     lambda: earlier.actor_critic_backward(w, x9b, feats, hidden, dlogits,
                                                           dvalue))):
                turns = [gpu_ms(that), gpu_ms(this), gpu_ms(this), gpu_ms(that)]
                ratio = (turns[1] + turns[2]) / (turns[0] + turns[3])
                rows.setdefault(row, {})["earlier_check"] = dict(
                    shape=shape, digests=mine, digests_equal=True,
                    turns_ms_parent_this_this_parent=turns, ratio=ratio,
                    within_margin=ratio <= 1 + PARENT_MARGIN)
    return rows


# ----------------------------------------------------------------- phase 7

def forced_train_forward(w, x, taken, kinks: dict):
    """``actor_critic_train_forward_plain``'s (logits, value) with its two
    LeakyReLUs (the branch features and the fc outputs) taking the branches
    ``taken`` (masks of the entries on the identity side, as the kernel path
    took them: the sign of K3's training outputs) where its own differ.
    Each such entry is counted in ``kinks["flips"]``, and ``kinks["margin"]``
    keeps the largest distance of one from its tie, as a share of the
    layer's largest pre-activation magnitude."""
    import torch.nn.functional as F

    def leaky(pre, mask, kind):
        flip = (pre >= 0) != mask
        if bool(flip.any()):
            kinks["flips"][kind] = kinks["flips"].get(kind, 0) + int(flip.sum())
            kinks["margin"] = max(kinks["margin"], float(pre[flip].abs().max() / pre.abs().max()))
        return torch.where(mask, pre, 0.01 * pre)

    pre = torch.cat([x[:, w.branch_off[b]:w.branch_off[b + 1]]
                     @ w.w_branch[w.branch_off[b]:w.branch_off[b + 1]] + w.b_branch[b]
                     for b in range(len(w.branch_off) - 1)], dim=-1)
    feats = leaky(pre, taken[0], "feats")
    H = w.b_branch.shape[1]
    cond = feats[:, w.cond * H:(w.cond + 1) * H] if w.cond >= 0 else 0.0
    hidden = leaky(feats @ w.w_fc + w.b_fc, taken[1], "hidden")
    logits = (hidden[:, :H] + cond) @ w.w_actor_out + w.b_actor_out
    if w.av_prior:
        av = x[:, w.av_off:w.av_off + logits.shape[1]]
        av = (av - av.mean(-1, keepdim=True)) / (av.std(-1, correction=0, keepdim=True) + 1e-6)
        logits = logits + w.av_prior * av
    value = ((hidden[:, H:] + cond) @ w.w_critic_out + w.b_critic_out)[:, 0]
    return logits, value


def plain_ppo_update(policy, optimizer, cfg, traj, rewards, last_values, ret_rms, perms,
                     branches=None, kinks=None):
    """``rl.ppo.ppo_update`` through the plain versions on the card (the
    reference of phase 7's comparison): K6's plain recurrence, the plain
    training forward differentiated by autograd from K9's written-out
    gradient, the same clip and Adam.  With ``branches`` (the kernel path's
    LeakyReLU branches of each minibatch step), the forward takes them
    where its own differ (``forced_train_forward``, the flips counted in
    ``kinks``).  Returns (ret_rms, mean metrics [4])."""
    from mansy_immersivevideostreaming_torch.kernels.actor_critic import (
        actor_critic_train_forward_plain,
    )
    from mansy_immersivevideostreaming_torch.kernels.gae import compute_gae_plain
    from mansy_immersivevideostreaming_torch.kernels.policy_loss import (
        LossSpec, policy_loss_plain,
    )
    from mansy_immersivevideostreaming_torch.rl.ppo import clip_grad_norm

    T, N = rewards.shape
    adv, ret = compute_gae_plain(rewards, traj.done, traj.value, last_values, cfg.gamma,
                                 cfg.gae_lambda)
    ret_n = ret / torch.sqrt(ret_rms.var + 1e-8)
    ret_rms = ret_rms.update(ret)
    flat = dict(obs=traj.obs.reshape(T * N, -1), action=traj.action.reshape(-1),
                log_prob=traj.log_prob.reshape(-1), value=traj.value.reshape(-1),
                adv=adv.reshape(-1), ret=ret_n.reshape(-1))
    params = list(policy.parameters())
    metrics = []
    for step, idx in enumerate(perms.reshape(-1, perms.shape[-1])):
        mb = {k: v[idx] for k, v in flat.items()}
        if branches is None:
            logits, value, _, _ = actor_critic_train_forward_plain(policy._pack(), mb["obs"])
        else:
            logits, value = forced_train_forward(policy._pack(), mb["obs"], branches[step], kinks)
        spec = LossSpec(action=mb["action"], ent_coef=cfg.ent_coef, old_log_prob=mb["log_prob"],
                        old_value=mb["value"], adv=mb["adv"], ret=mb["ret"],
                        eps_clip=cfg.eps_clip, vf_coef=cfg.vf_coef, value_clip=cfg.value_clip,
                        norm_adv=cfg.norm_adv, n_prefs=cfg.n_prefs, mode="ppo")
        loss, terms, dlogits, dvalue = policy_loss_plain(spec, logits.detach(), value.detach())
        optimizer.zero_grad(set_to_none=True)
        torch.autograd.backward([logits, value], [dlogits, dvalue])
        clip_grad_norm(params, cfg.max_grad_norm)
        optimizer.step()
        metrics.append(torch.cat([loss[None], terms]))
    return ret_rms, torch.stack(metrics).mean(0)


def compare_updates(policy, cfg, args, traj, rewards, last_values, gen) -> dict:
    """One PPO update from the same parameters, trajectory and permutations
    through the kernels (``rl.ppo.ppo_update``) and through the plain path
    on the card, each with a fresh Adam.  The loss metrics and the running
    return statistic must agree to UPDATE_RTOL; a parameter whose plain
    update moved it by at least half of lr a step must agree to
    UPDATE_ATOL, and the others (Adam steps an entry whose gradient sits
    near 0 by up to lr either way) are counted and must stay under
    UPDATE_LOOSE of all.  The plain path takes the kernel path's branches
    at the LeakyReLUs where its own differ, each such entry within
    TRAIN_KINK_MARGIN of its tie (``kinks``): an ulp there moves the entry's
    whole share of the gradient into the other slope, and the parameters
    it reaches then differ by Adam's sign steps, not by an ulp (at hidden
    512 the plain f32 update against a float64 one breaks UPDATE_ATOL so).
    The same comparison with the plain path's own branches is reported
    beside (``own_branches``), unchecked."""
    from mansy_immersivevideostreaming_torch.kernels import actor_critic as K3
    from mansy_immersivevideostreaming_torch.rl.ppo import make_optimizer, ppo_update
    from mansy_immersivevideostreaming_torch.rl.types import RunningStat

    T, N = rewards.shape
    n_mb = T * N // cfg.minibatch
    perms = torch.stack([torch.randperm(T * N, generator=gen, device=rewards.device)
                         [:n_mb * cfg.minibatch].reshape(n_mb, cfg.minibatch)
                         for _ in range(cfg.repeat)])
    before = [p.detach().clone() for p in policy.parameters()]
    kernel_p, plain_p, own_p = (copy.deepcopy(policy) for _ in range(3))
    opt_k, opt_p, opt_o = (make_optimizer(p.parameters(), args.lr, args.weight_decay)
                           for p in (kernel_p, plain_p, own_p))
    branches, train_forward = [], K3.actor_critic_train_forward

    def recording(w, x):  # the kernel path's LeakyReLU branches, a minibatch step each
        out = train_forward(w, x)
        branches.append((out[2] >= 0, out[3] >= 0))
        return out

    # the wrapper counts its launches under its module name, here this one's
    recording.launches, recording.launches_by_mode = 0, {}
    with mock.patch.object(K3, "actor_critic_train_forward", recording):
        stat_k, m = ppo_update(kernel_p, opt_k, cfg, traj, rewards, last_values,
                               RunningStat.init(rewards.device), perms=perms)
    kinks = dict(flips={}, margin=0.0)
    stat_p, m_plain = plain_ppo_update(plain_p, opt_p, cfg, traj, rewards, last_values,
                                       RunningStat.init(rewards.device), perms, branches, kinks)
    if kinks["margin"] > TRAIN_KINK_MARGIN:
        raise AssertionError(f"train: the kernels took a LeakyReLU branch {kinks['margin']} of "
                             f"the layer's largest pre-activation from its tie "
                             f"(> {TRAIN_KINK_MARGIN}): {kinks['flips']}")
    plain_ppo_update(own_p, opt_o, cfg, traj, rewards, last_values,
                     RunningStat.init(rewards.device), perms)
    own = {}
    for p0, pk, po in zip(before, kernel_p.parameters(), own_p.parameters()):
        sure = (po.detach() - p0).abs() >= 0.5 * args.lr * cfg.repeat * n_mb
        diff = (pk.detach() - po.detach()).abs()
        own["param_max_abs_err"] = max(own.get("param_max_abs_err", 0.0),
                                       float(diff[sure].max()) if bool(sure.any()) else 0.0)
        own["params_beyond_atol"] = own.get("params_beyond_atol", 0) + int(
            (diff > UPDATE_ATOL).sum())
    m_kernel = torch.stack([m[k] for k in ("loss", "loss/clip", "loss/vf", "loss/ent")])
    scalars = torch.cat([m_kernel, torch.stack(stat_k)])
    ref = torch.cat([m_plain, torch.stack(stat_p)])
    metric_err = float(((scalars - ref).abs() / ref.abs().clamp(min=1e-2)).max())
    if metric_err > UPDATE_RTOL:
        raise AssertionError(f"train: the kernels' update metrics differ from the plain path's "
                             f"by {metric_err} (relative)")
    steps = cfg.repeat * n_mb
    return dict(minibatch_steps=steps, metric_rel_err=metric_err,
                **compare_params(before, kernel_p, plain_p, args.lr * steps, "train"),
                loss=float(m_kernel[0]), plain_loss=float(m_plain[0]),
                kinks=dict(flips=kinks["flips"], largest_margin=kinks["margin"]),
                own_branches=own)


def compare_params(before, kernel_p, plain_p, lr_steps: float, label: str) -> dict:
    """The parameters after an update through the kernels against those
    after the plain path's: a parameter whose plain update moved it by at
    least half of ``lr_steps`` (lr times the steps) must agree to
    UPDATE_ATOL; the others (whose gradients sit near 0) are counted and
    must stay under UPDATE_LOOSE of all."""
    tight, loose, total, err = 0, 0, 0, 0.0
    for p0, pk, pp in zip(before, kernel_p.parameters(), plain_p.parameters()):
        moved = (pp.detach() - p0).abs()
        diff = (pk.detach() - pp.detach()).abs()
        sure = moved >= 0.5 * lr_steps
        if bool((diff[sure] > UPDATE_ATOL).any()):
            raise AssertionError(f"{label}: a parameter the plain update moved by "
                                 f"{float(moved[sure][diff[sure].argmax()])} differs by "
                                 f"{float(diff[sure].max())}")
        err = max(err, float(diff[sure].max()) if bool(sure.any()) else 0.0)
        tight += int(sure.sum())
        loose += int((~sure & (diff > UPDATE_ATOL)).sum())
        total += diff.numel()
    if loose > UPDATE_LOOSE * total:
        raise AssertionError(f"{label}: {loose} of {total} parameters differ beyond "
                             f"{UPDATE_ATOL}")
    return dict(param_max_abs_err=err, params_compared=tight,
                params_near_zero_gradient_differing=loose, params_total=total)


def train_phase(dev, counters, hidden: int = 128, derived: bool = False, trained=None):
    """``run_mansy --train --train-identifier --use-identifier --lamb 0.5``
    at the CLI defaults (128 lanes x 32 steps, minibatch 512, repeat 2)
    through ``run_mansy.ppo_round``, on tables of the train split's shape,
    from the v9 weights at hidden 128 (``hidden`` 256: from the v18 weights,
    ``--hidden-dim 256``; any other ``hidden``: ``--hidden-dim hidden`` from
    Flax's initialiser, orthogonal sqrt 2 and zero bias, K3 and K10 in the
    instance or the wide variant that width runs in; with ``derived``, phase
    15b: ``--obs-action-values --av-logit-prior 3.0`` from Flax's
    initialiser, the observation from K2's derived mode): a warm-up round,
    then PASSES timed rounds (one at a width other than 128; one collect and
    its updates each).  Then one update through the kernels against the
    plain path on the card.  With ``trained``, the policy is written as
    run_mansy writes it (npz and sidecar, in a temporary directory kept in
    ``trained``) and its path kept under ``trained[hidden]``."""
    from mansy_immersivevideostreaming_torch.cli import run_mansy
    from mansy_immersivevideostreaming_torch.models.abr_nets import (
        MansyActorCritic, QoEIdentifier,
    )
    from mansy_immersivevideostreaming_torch.rl.ppo import make_optimizer, ppo_update
    from mansy_immersivevideostreaming_torch.rl.rollout import init_lanes, make_collector
    from mansy_immersivevideostreaming_torch.rl.types import RunningStat
    from mansy_immersivevideostreaming_torch.sim.env import generate_environment_samples
    from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables
    from mansy_immersivevideostreaming_torch.utils.checkpoint import (
        DAGGER_V9_NPZ, DAGGER_V18_NPZ, load_npz_policy,
    )

    args = run_mansy.build_parser().parse_args(
        ["--train", "--train-identifier", "--use-identifier", "--lamb", "0.5"]
        + (["--hidden-dim", str(hidden)] if hidden != 128 else [])
        + (["--obs-action-values", "--av-logit-prior", str(AV_PRIOR)] if derived else []))
    V, U, NT, C, Q = TRAIN_SHAPE
    tables = synthetic_sim_tables(V, U, NT, C, Q, seed=0, device=dev)
    samples = torch.as_tensor(generate_environment_samples(V, U, NT, Q), device=dev)
    torch.manual_seed(args.seed)
    if derived or hidden not in (128, 256):  # as run_mansy.train builds it
        policy = MansyActorCritic(hidden_dim=args.hidden_dim,
                                  use_action_values=args.obs_action_values,
                                  av_logit_prior=args.av_logit_prior, device=dev)
    else:
        policy = load_npz_policy(DAGGER_V18_NPZ if hidden == 256 else DAGGER_V9_NPZ, device=dev)
    if policy.packed_weights().b_branch.shape[1] != args.hidden_dim:
        raise AssertionError(f"train: the policy's width is not --hidden-dim {args.hidden_dim}")
    identifier = QoEIdentifier(hidden_dim=args.hidden_dim, device=dev)
    optimizer = make_optimizer(policy.parameters(), args.lr, args.weight_decay)
    id_optimizer = make_optimizer(identifier.parameters(), args.identifier_lr, args.weight_decay)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    cfg = run_mansy.ppo_config(args, Q)
    n_lanes, n_steps = args.train_lanes, args.step_per_collect // args.train_lanes
    collect = make_collector(tables, samples, n_lanes, n_steps, train=True)
    prefs = tables.qoe_weights / tables.qoe_weights.sum(-1, keepdim=True)
    start = [p.detach().clone() for p in policy.parameters()]
    carry = [init_lanes(tables, samples, n_lanes, args.seed), RunningStat.init(dev)]
    losses = []

    def run():
        with contextlib.redirect_stdout(sys.stderr):  # the identifier's loss lines
            carry[0], carry[1], logs, metrics = run_mansy.ppo_round(
                args, policy, identifier, optimizer, id_optimizer, cfg, collect, carry[0],
                carry[1], gen, args.ent_coef, args.lamb, prefs)
        losses.append({k: float(v) for k, v in metrics.items()})
        return logs

    run()  # warm-up
    n_mb = cfg.repeat * (n_lanes * n_steps // cfg.minibatch)
    want = expect(counters, env_step=n_steps, observe_mansy_pack=n_steps + 1,
                  actor_critic_forward=n_steps + 1, compute_gae=1,
                  actor_critic_train_forward=n_mb, policy_loss=n_mb, actor_critic_backward=n_mb)
    passes = PASSES if hidden == 128 else 1
    _, seconds, launches = timed_passes(run, counters, want, passes)
    if not all(math.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"train: non-finite losses {losses}")
    moved = max(float((p.detach() - p0).abs().max())
                for p, p0 in zip(policy.parameters(), start))
    if not moved > 0:
        raise AssertionError("train: the parameters did not move")

    # where a minibatch update's time goes, and the kernels against the plain path
    carry[0], traj, _, last_values = collect(policy, carry[0], gen)
    if traj.obs.shape[-1] != policy.obs_width(tables):
        raise AssertionError(f"train: observations of {traj.obs.shape[-1]} columns")

    def update():
        carry[1], _ = ppo_update(policy, optimizer, cfg, traj, traj.reward, last_values,
                                 carry[1], gen)

    profiled = profile_update(update, n_mb)
    check = compare_updates(policy, cfg, args, traj, traj.reward, last_values, gen)
    rate = rate_stats(n_lanes * n_steps, seconds)
    if trained is not None:  # best_policy.npz as run_mansy.train writes it
        from mansy_immersivevideostreaming_torch.utils.checkpoint import (
            save_net_config, save_npz,
        )
        tmp = tempfile.TemporaryDirectory(prefix="train_", dir=os.environ.get("TMPDIR"))
        trained.setdefault("dirs", []).append(tmp)
        path = trained[hidden] = os.path.join(tmp.name, "best_policy.npz")
        save_npz(path, policy)
        save_net_config(path, run_mansy.policy_net_config(args))
    return dict(lanes=n_lanes, steps=n_steps, minibatch=cfg.minibatch, repeat=cfg.repeat,
                hidden=args.hidden_dim, columns=int(traj.obs.shape[-1]),
                minibatch_steps_per_round=n_mb, passes=passes,
                seconds=seconds,
                env_steps_per_s_median=rate["median"], env_steps_per_s_min=rate["min"],
                env_steps_per_s_max=rate["max"], spread=rate["spread"],
                ms_per_minibatch_update=profiled["ms_per_step"], update_profile=profiled,
                last_losses=losses[-1], max_param_move=moved, kernels_vs_plain=check,
                launches=launches)


# ----------------------------------------------------------------- phase 8

def dagger_phase(dev, counters):
    """``run_dagger`` with v16's flags (``--exact-action-values --acc-correct
    --av-logit-prior 3.0``, horizon 4, 32 lanes, batch 4096) from the v16
    weights, through ``run_dagger.dagger_round``: the initial aggregate is
    the port's expert demos over the 1440-episode grid of the test shape
    (K5's accuracy-corrected action values attached), round 0 fits it, and
    DAGGER_ROUNDS timed rounds follow.  Then the valid-grid evaluation."""
    from mansy_immersivevideostreaming_torch.cli import run_dagger
    from mansy_immersivevideostreaming_torch.cli.run_expert import run_expert_episodes
    from mansy_immersivevideostreaming_torch.kernels import expert_tables as K5
    from mansy_immersivevideostreaming_torch.rl import dagger
    from mansy_immersivevideostreaming_torch.rl.ppo import make_optimizer
    from mansy_immersivevideostreaming_torch.rl.runner import episode_step_bound, evaluate
    from mansy_immersivevideostreaming_torch.sim.env import (
        generate_demo_samples, generate_environment_test_samples,
    )
    from mansy_immersivevideostreaming_torch.sim.expert import attach_action_values
    from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables
    from mansy_immersivevideostreaming_torch.utils.checkpoint import (
        DAGGER_V16_NPZ, load_npz_policy,
    )

    args = run_dagger.build_parser().parse_args(
        ["--exact-action-values", "--acc-correct", "--av-logit-prior", "3.0", "--horizon",
         str(HORIZON), "--lanes", "32", "--batch-size", "4096",
         "--rounds", str(DAGGER_ROUNDS)])
    V, U, NT, C, Q = TEST_SHAPE
    tables = perturb_pred(synthetic_sim_tables(V, U, NT, C, Q, seed=1, device=dev), seed=1)
    samples = torch.as_tensor(generate_environment_test_samples(V, U, NT, Q), device=dev)
    etables = K5.build_expert_tables(tables)
    tables = attach_action_values(tables, etables, acc_correct=args.acc_correct)
    t0 = time.time()
    chunks = run_expert_episodes(tables, etables, samples, args.horizon, lane_chunk=EXPERT_CHUNK,
                                 collect_obs=True, acc_correct=args.acc_correct)
    demos = []
    for _, first, actions, obs in chunks:
        obs = {k: v.cpu().numpy() for k, v in obs.items()}
        for lane in range(first.shape[1]):
            t_end = int(np.argwhere(first[:, lane])[0][0])
            demos.append({"obs": {k: v[:t_end + 1, lane] for k, v in obs.items()},
                          "act": actions[:t_end + 1, lane]})
    dataset = dagger.flatten_demos(demos, dev)
    demo_s = time.time() - t0

    policy = load_npz_policy(DAGGER_V16_NPZ, device=dev)
    if policy.av_logit_prior != args.av_logit_prior or not policy.use_action_values:
        raise AssertionError("dagger: the v16 npz is not a policy of v16's flags")
    optimizer = make_optimizer(policy.parameters(), args.lr)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    n_steps = episode_step_bound(tables)
    collect = dagger.make_dagger_collector(tables, etables, args.horizon, n_steps,
                                           acc_correct=args.acc_correct)
    t0 = time.time()
    fit = dagger.bc_on_aggregate(policy, optimizer, run_dagger.balanced(args, dataset, tables),
                                 args.bc_steps, args.batch_size, gen, args.ent_coef)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    state = dict(dataset=dataset, r=0, ce=[])

    def run():
        state["r"] += 1
        lanes = torch.as_tensor(generate_demo_samples(V, U, NT, Q, args.lanes,
                                                      args.seed + state["r"]), device=dev)
        state["dataset"], losses, _ = run_dagger.dagger_round(
            args, policy, optimizer, collect, tables, state["dataset"], lanes, gen)
        state["ce"].append(losses[-1])

    want = expect(counters, env_step=n_steps, observe_mansy_pack=n_steps,
                  choose_action=n_steps, actor_critic_forward=n_steps,
                  actor_critic_train_forward=args.bc_steps, policy_loss=args.bc_steps,
                  actor_critic_backward=args.bc_steps)
    _, seconds, launches = timed_passes(run, counters, want, DAGGER_ROUNDS)
    if not all(math.isfinite(v) for v in fit + state["ce"]):
        raise AssertionError(f"dagger: non-finite CE {fit} {state['ce']}")
    logs, masks = evaluate(policy, tables, samples, deterministic=True)
    n_eps = int(sum(m.sum() for m in masks))
    if n_eps != samples.shape[0]:
        raise AssertionError(f"dagger: {n_eps} of {samples.shape[0]} valid lanes finished")
    qoe = np.concatenate([l.qoe.cpu().numpy()[m] for l, m in zip(logs, masks)])
    if not np.isfinite(qoe).all():
        raise AssertionError("dagger: non-finite valid QoE")
    # where a CE step's time goes, on the aggregate the rounds left
    agg = run_dagger.balanced(args, state["dataset"], tables)
    profiled = profile_update(lambda: dagger.bc_on_aggregate(
        policy, optimizer, agg, PROFILE_CE_STEPS, args.batch_size, gen, args.ent_coef),
        PROFILE_CE_STEPS)
    # the rest of a round: the expert-labelled rollout and the aggregate
    outside = []
    for i in range(UPDATE_PASSES):
        lanes = torch.as_tensor(generate_demo_samples(V, U, NT, Q, args.lanes,
                                                      args.seed + 100 + i), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        obs, expert_act, done = collect(policy, lanes, gen)
        dagger.aggregate(state["dataset"], obs, expert_act, done, weight=args.relabel_weight)
        torch.cuda.synchronize()
        outside.append(time.perf_counter() - t0)
    return dict(rounds=DAGGER_ROUNDS, lanes=args.lanes, steps=n_steps, bc_steps=args.bc_steps,
                batch=args.batch_size, demos=len(demos), demo_seconds=demo_s,
                aggregate_rows=int(state["dataset"][1].shape[0]), round0_fit_seconds=fit_s,
                round0_ce=[fit[0], fit[-1]], round_ce=state["ce"], seconds=seconds,
                round_seconds_median=statistics.median(seconds), valid_episodes=n_eps,
                valid_mean_qoe=float(qoe.mean()), ce_step_profile=profiled,
                collect_and_aggregate_seconds=outside, launches=launches)


# ---------------------------------------------------------------- phase 2d

def attention_cost(B: int, Lq: int, Lk: int, H: int, Dh: int, kv_len0, elem: int = 4):
    """(operations, bytes) of K8: per query row over its n keys, the q . k
    and p . v multiply-adds (4 Dh operations a key) and the softmax's
    subtract, exp, sum and divide (4 a key); q read and o written once, and
    the k and v rows that any row of the call needs read once, ``elem``
    bytes an element (4 in f32, 2 in bf16)."""
    first = Lk if kv_len0 is None else kv_len0
    seen = [min(Lk, first + r) for r in range(Lq)]
    flops = B * H * sum(n * (4 * Dh + 4) for n in seen)
    return flops, elem * B * H * Dh * (2 * Lq + 2 * max(seen))


def attention_train_cost(B: int, Lq: int, Lk: int, H: int, Dh: int, kv_len0,
                         dropout: bool, elem: int = 4):
    """(operations, bytes) of K8's training mode: the serving mode's, the
    row max and sum written (f32 [B, H, Lq] each) and the keep mask read
    (u8 [B, H, Lq, Lk]) when there is one."""
    flops, nbytes = attention_cost(B, Lq, Lk, H, Dh, kv_len0, elem)
    return flops, nbytes + 8 * B * H * Lq + (B * H * Lq * Lk if dropout else 0)


def attention_backward_cost(B: int, Lq: int, Lk: int, H: int, Dh: int, kv_len0,
                            dropout: bool, elem: int = 4):
    """(operations, bytes) of K8's backward: per (row, seen key) the score,
    dO . v, and the dq, dk and dv multiply-adds (10 Dh) and about 10 scalar
    operations; per row D, in f32 dO . o (2 Dh operations), in bf16
    sum_k g_k P_k over the row's n keys (2 n: that function reads no o);
    q, dO (and in f32 o) and the seen k and v rows, the statistics and the
    mask read once, dq, dk and dv written once, ``elem`` bytes an element
    of all but the statistics and the mask."""
    first = Lk if kv_len0 is None else kv_len0
    seen = [min(Lk, first + r) for r in range(Lq)]
    bf16 = elem == 2
    delta = sum(2 * n for n in seen) if bf16 else Lq * 2 * Dh
    flops = B * H * (sum(n * (10 * Dh + 10) for n in seen) + delta)
    rows = 3 * Lq if bf16 else 4 * Lq
    nbytes = elem * B * H * Dh * (rows + 2 * max(seen) + 2 * Lk) + 8 * B * H * Lq
    return flops, nbytes + (B * H * Lq * Lk if dropout else 0)


def occupancy_cost(B: int, F: int, frequency=None):
    """(operations, bytes) of K7.  A point's map takes about 120 integer
    operations (two axes: 4 tile lookups, 8 range tests; 8 row ORs); a
    metrics step adds the periodic MSE and the counts' quotients (about
    20), a chunk the OR and its IoU.  Chunk mode reads the first
    ``frequency`` steps of gt and pred and writes two u8 maps and the IoU;
    metrics mode reads every step and writes five f32 values a step."""
    if frequency is None:
        return B * F * (2 * 120 + 20), B * F * (2 * 2 * 4 + 5 * 4)
    return B * (frequency * 2 * 121 + 4), B * (frequency * 2 * 2 * 4 + 2 * 64 + 4)


def edge_coordinates(size: int, tile: int, half_fov: int) -> np.ndarray:
    """Normalized coordinates on and one pixel (and one f32 ulp) beside every
    tile edge and every position where the FoV's edge meets a tile edge or
    the frame's (the wrap cases)."""
    px = np.arange(0, size + 1, tile)
    px = np.concatenate([px, px - half_fov, px + half_fov])
    px = np.concatenate([px - 1, px, px + 1])
    v = (np.unique(px[(px >= 0) & (px <= size)]) / size).astype(np.float32)
    return np.unique(np.concatenate([v, np.nextafter(v, np.float32(-1)),
                                     np.nextafter(v, np.float32(2))]))


def edge_positions(B: int, F: int, seed: int, dev) -> torch.Tensor:
    """[B, F, 2] positions, half of them drawn from :func:`edge_coordinates`."""
    rng = np.random.default_rng(seed)
    cols = []
    for size, tiles, fov in zip(FRAME, (8, 8), (600, 300)):
        edge = rng.choice(edge_coordinates(size, size // tiles, fov // 2), (B, F))
        cols.append(np.where(rng.random((B, F)) < 0.5, edge, rng.random((B, F))))
    return torch.as_tensor(np.stack(cols, -1).astype(np.float32), device=dev)


def earlier_forward(earlier, current, args, label: str) -> dict:
    """K8's forward of the parent commit beside this tree's on the same
    inputs: ``earlier_ms``, and ``earlier_bits_equal``, which must hold
    (every output, the training mode's row statistics too)."""
    same = all(torch.equal(a, b) for a, b in zip(leaves(earlier(*args)), leaves(current(*args))))
    if not same:
        raise AssertionError(f"{label}: the parent commit's kernel gives other bits")
    return dict(earlier_ms=gpu_ms(lambda: earlier(*args)), earlier_bits_equal=same)


def parent_turns(this, that, reps: int = 15) -> dict:
    """``this`` tree's call against the parent's, ``that``, timed in turns
    (parent, this, this, parent; ``reps`` calls a timing) on the same
    inputs: the parent's mean (``earlier_ms``), the ratio of the two sums,
    within PARENT_MARGIN of 1 or not (``within_margin``)."""
    turns = [gpu_ms(that, reps), gpu_ms(this, reps), gpu_ms(this, reps), gpu_ms(that, reps)]
    ratio = (turns[1] + turns[2]) / (turns[0] + turns[3])
    return dict(turns_ms_parent_this_this_parent=turns, earlier_ms=(turns[0] + turns[3]) / 2,
                ratio=ratio, within_margin=abs(ratio - 1) <= PARENT_MARGIN)


def viewport_kernel_phase(dev, parent=None):
    """K8 at B = VP_BATCH in each of its shapes, against its plain version
    and SDPA's math backend, with its per-batch sums over the 62 launches of
    a viewport batch, and its refusal of gradients; K7 in both modes at B =
    VP_BATCH, F = 15, and on every pair of boundary coordinates.  With
    ``parent``, the parent commit's K8 is timed beside K8.  Returns the
    kernels' rows."""
    from mansy_immersivevideostreaming_torch.cli import run_models
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    from mansy_immersivevideostreaming_torch.kernels import tile_occupancy as K7
    from torch.nn.attention import SDPBackend, sdpa_kernel

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    B, H, Dh, F = VP_BATCH, 8, 64, 15
    rows = {}

    # K8: the decode self-attention at every t, the cross-attention over the
    # distilled memory, the encoder, the fixed-buffer decode's causal mask
    shapes = {f"decode_t{t}": (1, F, t + 1) for t in range(F)}
    shapes.update(cross=(1, 3, None), encoder=(5, 5, None), causal=(F + 1, F + 1, 1),
                  encoder_96=(96, 96, None), decode_256=(1, 256, None))
    cases, err, sdpa_err, inputs = {}, 0.0, 0.0, {}
    for name, (Lq, Lk, kv_len0) in shapes.items():
        q = torch.randn(B, Lq, H, Dh, device=dev, generator=gen)
        k = torch.randn(B, Lk, H, Dh, device=dev, generator=gen)
        v = torch.randn(B, Lk, H, Dh, device=dev, generator=gen)
        inputs[name] = (q, k, v, kv_len0)
        got, ref = K8.attention(q, k, v, kv_len0), K8.attention_plain(q, k, v, kv_len0)
        seen = torch.arange(Lq, device=dev) + (Lk if kv_len0 is None else kv_len0)
        mask = torch.arange(Lk, device=dev)[None, :] < seen[:, None]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                                        attn_mask=mask)
        with sdpa_kernel(SDPBackend.MATH):
            lib = sdpa().transpose(1, 2)
        if not bool(close(got, ref).all()):
            raise AssertionError(f"attention ({name}) disagrees with its plain version")
        if not bool(close(got, lib).all()):
            raise AssertionError(f"attention ({name}) disagrees with SDPA's math backend")
        if not torch.equal(got, K8.attention(q, k, v, kv_len0)):
            raise AssertionError(f"attention ({name}): two launches differ")
        err = max(err, float((got - ref).abs().max()))
        sdpa_err = max(sdpa_err, float((got - lib).abs().max()))
        cases[name] = dict(Lq=Lq, Lk=Lk, kv_len0=kv_len0,
                           plan=K8.attention_forward_plan(B, Lq, Lk, H, Dh)._asdict(),
                           ms=gpu_ms(lambda: K8.attention(q, k, v, kv_len0)),
                           plain_ms=gpu_ms(lambda: K8.attention_plain(q, k, v, kv_len0)),
                           library_ms=gpu_ms(sdpa),
                           **bound(*attention_cost(B, Lq, Lk, H, Dh, kv_len0)))
        if parent is not None:  # the parent commit's kernel on the same inputs
            cases[name].update(earlier_forward(parent.attention.attention, K8.attention,
                                               (q, k, v, kv_len0), f"attention ({name})"))
    # a viewport batch's launches: each encoder layer once, then per decode
    # step each decoder layer's self-attention at t and cross-attention
    args = run_models.build_parser().parse_args(["--test"])
    mix = {"encoder": args.block_num, "cross": args.fut_window * args.block_num,
           **{f"decode_t{t}": args.block_num for t in range(args.fut_window)}}
    if sum(mix.values()) != attention_launches(args):
        raise AssertionError(f"attention: the batch mix {mix} is not a batch's launches")
    batch = {f"{key}_sum": sum(n * cases[name][key] for name, n in mix.items())
             for key in ("ms", "bound_ms", "plain_ms", "library_ms")
             + (("earlier_ms",) if parent is not None else ())}
    # the least a call times by gpu_ms here: one torch.add of a decode step's q
    x = torch.randn(B, 1, H, Dh, device=dev, generator=gen)
    out = torch.empty_like(x)
    batch["timing_floor_ms"] = gpu_ms(lambda: torch.add(x, x, out=out))
    if parent is not None:  # the whole batch's 62 launches against the parent's, in turns
        mix_of = lambda fn: lambda: [fn(*inputs[name]) for name, n in mix.items()
                                     for _ in range(n)]
        batch["earlier_check"] = parent_turns(mix_of(K8.attention),
                                              mix_of(parent.attention.attention))
    rows["attention"] = dict(max_abs_err=err, sdpa_math_max_abs_err=sdpa_err,
                             **{k: cases["decode_t14"][k] for k in (
                                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                             shape=dict(B=B, H=H, Dh=Dh, Lq=1, Lk=F, t=F - 1),
                             batch=dict(launches=mix, **batch), cases=cases)
    rows.update(attention_training_cases(K8, dev, gen, args, batch["timing_floor_ms"], parent))

    # K7: metrics mode (run_models --test) and chunk mode (predict)
    gt, pred = edge_positions(B, F, 1, dev), edge_positions(B, F, 2, dev)
    got, ref = K7.trajectory_metrics(gt, pred), K7.trajectory_metrics_plain(gt, pred)
    for name, g, r in zip(("mse", "accuracy", "recall", "precision", "f1"), got, ref):
        if not bool(close(g, r).all()):
            raise AssertionError(f"trajectory_metrics: {name} disagrees with its plain version")
    m_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    freq = 5
    g, p, iou = K7.chunk_maps(gt, pred, freq)
    rg, rp, riou = K7.chunk_maps_plain(gt, pred, freq)
    if not (torch.equal(g, rg) and torch.equal(p, rp) and bool(close(iou, riou).all())):
        raise AssertionError("chunk_maps disagrees with its plain version")
    # every pair of boundary coordinates, one step a trajectory: the maps
    # (chunk mode, frequency 1) and the metrics against a shifted copy
    vx, vy = (edge_coordinates(size, size // 8, fov // 2) for size, fov in zip(FRAME, (600, 300)))
    grid = np.stack([a.reshape(-1) for a in np.meshgrid(vx, vy)], -1)
    grid = torch.as_tensor(grid[:, None, :].astype(np.float32), device=dev)
    shifted = grid.roll(1, 0)
    g, p, iou = K7.chunk_maps(grid, shifted, 1)
    rg, rp, riou = K7.chunk_maps_plain(grid, shifted, 1)
    same = torch.equal(g, rg) and torch.equal(p, rp) and bool(close(iou, riou).all())
    for a, b in zip(K7.trajectory_metrics(grid, shifted),
                    K7.trajectory_metrics_plain(grid, shifted)):
        same = same and bool(close(a, b).all())
    if not same:
        raise AssertionError("tile_occupancy disagrees with its plain version on the boundary grid")
    # two launches of each mode give the same bits
    if not all(torch.equal(a, b) for a, b in zip(K7.chunk_maps(gt, pred, freq),
                                                  K7.chunk_maps(gt, pred, freq))):
        raise AssertionError("chunk_maps: two launches differ")
    if not all(torch.equal(a, b) for a, b in zip(K7.trajectory_metrics(gt, pred),
                                                  K7.trajectory_metrics(gt, pred))):
        raise AssertionError("trajectory_metrics: two launches differ")
    chunk = dict(frequency=freq, plan=K7.chunk_plan(B)._asdict(),
                 **gpu_spread(lambda: K7.chunk_maps(gt, pred, freq)),
                 plain_ms=gpu_ms(lambda: K7.chunk_maps_plain(gt, pred, freq)),
                 **bound(*occupancy_cost(B, F, freq)))
    metrics = dict(**gpu_spread(lambda: K7.trajectory_metrics(gt, pred)),
                   plain_ms=gpu_ms(lambda: K7.trajectory_metrics_plain(gt, pred)))
    if parent is not None:  # the parent commit's kernel on the same inputs
        P7 = parent.tile_occupancy
        chunk["earlier_bits_equal"] = all(torch.equal(a, b) for a, b in zip(
            P7.chunk_maps(gt, pred, freq), K7.chunk_maps(gt, pred, freq)))
        chunk.update(gpu_spread(lambda: P7.chunk_maps(gt, pred, freq), "earlier_ms"))
        metrics["earlier_bits_equal"] = all(torch.equal(a, b) for a, b in zip(
            P7.trajectory_metrics(gt, pred), K7.trajectory_metrics(gt, pred)))
        metrics.update(gpu_spread(lambda: P7.trajectory_metrics(gt, pred), "earlier_ms"))
    rows["tile_occupancy"] = dict(
        max_abs_err=max(m_err, float((iou - riou).abs().max())), maps_equal=True,
        boundary_grid_points=int(grid.shape[0]), shape=dict(B=B, F=F, mode="metrics"),
        **metrics, **bound(*occupancy_cost(B, F)), library_ms=None, chunk_mode=chunk)
    return rows


def training_close(got, ref, scale: float) -> bool:
    """K8's training mode and backward against the plain version's autograd:
    rtol 1e-5 plus 1e-5 of ``scale``, the largest entry of the output or
    of the three gradients (sums in another order; where a gradient is 0
    in exact arithmetic, as dq and dk of a row that sees one key, autograd's
    softmax backward leaves rounding noise)."""
    return bool(((got - ref).abs() <= RTOL * ref.abs() + RTOL * scale).all())


def attention_training_cases(K8, dev, gen, args, floor_ms: float, parent=None) -> dict:
    """K8's training forward and backward at B = VP_BATCH in each training
    shape (the encoder's 5 x 5, the decode step over the 15-slot cache at
    each prefix, the cross-attention 1 x 3, the teacher-forced causal 15 x
    15 and its cross-attention 15 x 3) and beyond the earlier backward's 64
    rows and keys (an encoder's 96 x 96, ``--his-window 96``; a decode step
    over 256 keys), with a dropout keep mask at 0.1 and without: held
    against the plain version's autograd, two launches each bit-equal, keys
    no row sees exactly 0 in dk and dv.  Timed with the mask (the training
    default): the kernels, the plain versions, SDPA's forward and its
    forward + backward (autograd) as ``library_ms``, with ``parent`` the
    parent commit's backward (``earlier_ms``, where it takes the shape); the
    sums over a training step's 62 launches of each (6 with teacher
    forcing).  Returns the two kernels' rows."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    B, H, Dh, F = VP_BATCH, 8, 64, args.fut_window
    rate = 0.1
    shapes = {f"decode_t{t}": (1, F, t + 1) for t in range(F)}
    shapes.update(cross=(1, 3, None), encoder=(5, 5, None), causal_tf=(F, F, 1),
                  cross_tf=(F, 3, None), encoder_96=(96, 96, None), cross_48=(1, 48, None),
                  decode_256=(1, 256, None))
    fwd_cases, bwd_cases, fwd_err, bwd_err, inputs = {}, {}, 0.0, 0.0, {}
    for name, (Lq, Lk, kv_len0) in shapes.items():
        q, k, v = (torch.randn(B, L, H, Dh, device=dev, generator=gen) for L in (Lq, Lk, Lk))
        dout = torch.randn(B, Lq, H, Dh, device=dev, generator=gen)
        keep = (torch.rand(B, H, Lq, Lk, device=dev, generator=gen) < 1 - rate).to(torch.uint8)
        for mask in (None, keep):
            label = f"training {name}{' with dropout' if mask is not None else ''}"
            fwd = K8.attention_train_forward(q, k, v, kv_len0, mask, rate)
            ref = K8.attention_train_forward_plain(q, k, v, kv_len0, mask, rate)
            for got, want in zip(fwd, ref):
                if not training_close(got, want, float(want.abs().max())):
                    raise AssertionError(f"attention ({label}) disagrees with its plain version")
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            want = torch.autograd.grad(K8.attention_plain(*leaves, kv_len0, mask, rate), leaves,
                                       dout)
            got = K8.attention_backward(dout, q, k, v, *fwd, kv_len0, mask, rate)
            scale = max(float(w.abs().max()) for w in want)
            if not all(training_close(g, w, scale) for g, w in zip(got, want)):
                raise AssertionError(f"attention_backward ({label}) disagrees with the plain "
                                     f"version's autograd")
            if kv_len0 is not None:
                unseen = slice(min(Lk, kv_len0 + Lq - 1), None)
                if bool(got[1][:, unseen].any()) or bool(got[2][:, unseen].any()):
                    raise AssertionError(f"attention_backward ({label}): keys no row sees have "
                                         f"a gradient")
            if not (all(torch.equal(a, b) for a, b in zip(
                    fwd, K8.attention_train_forward(q, k, v, kv_len0, mask, rate)))
                    and all(torch.equal(a, b) for a, b in zip(got, K8.attention_backward(
                        dout, q, k, v, *fwd, kv_len0, mask, rate)))):
                raise AssertionError(f"attention ({label}): two launches differ")
            fwd_err = max(fwd_err, max(float((a - b).abs().max()) for a, b in zip(fwd, ref)))
            bwd_err = max(bwd_err, max(float((a - b).abs().max()) for a, b in zip(got, want)))
        # timings with the mask; SDPA on the same prefix mask, its own dropout off
        seen = torch.arange(Lq, device=dev) + (Lk if kv_len0 is None else kv_len0)
        allowed = torch.arange(Lk, device=dev)[None, :] < seen[:, None]
        qt, kt, vt = (x.transpose(1, 2).clone().requires_grad_() for x in (q, k, v))
        dout_t = dout.transpose(1, 2)
        fwd = K8.attention_train_forward(q, k, v, kv_len0, keep, rate)
        inputs[name] = (dout, q, k, v, fwd, kv_len0, keep)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        common = dict(Lq=Lq, Lk=Lk, kv_len0=kv_len0)
        fwd_cases[name] = dict(
            **common, plan=K8.attention_forward_plan(B, Lq, Lk, H, Dh)._asdict(),
            ms=gpu_ms(lambda: K8.attention_train_forward(q, k, v, kv_len0, keep, rate)),
            plain_ms=gpu_ms(lambda: K8.attention_train_forward_plain(q, k, v, kv_len0, keep,
                                                                     rate)),
            library_ms=gpu_ms(lambda: sdpa(*(x.transpose(1, 2) for x in (q, k, v)),
                                           attn_mask=allowed)),
            **bound(*attention_train_cost(B, Lq, Lk, H, Dh, kv_len0, True)))
        bwd_cases[name] = dict(
            **common, ms=gpu_ms(lambda: K8.attention_backward(dout, q, k, v, *fwd, kv_len0, keep,
                                                              rate)),
            plain_ms=gpu_ms(lambda: K8.attention_backward_plain(dout, q, k, v, *fwd, kv_len0,
                                                                keep, rate)),
            autograd_plain_ms=gpu_ms(lambda: torch.autograd.grad(
                K8.attention_plain(*leaves, kv_len0, keep, rate), leaves, dout)),
            library_ms=gpu_ms(lambda: torch.autograd.grad(
                sdpa(qt, kt, vt, attn_mask=allowed), (qt, kt, vt), dout_t)),
            plan=K8.attention_backward_plan(B, Lq, Lk, H, Dh)._asdict(),
            **bound(*attention_backward_cost(B, Lq, Lk, H, Dh, kv_len0, True)))
        if parent is not None:  # the parent commit's kernels on the same inputs
            fwd_cases[name].update(earlier_forward(
                parent.attention.attention_train_forward, K8.attention_train_forward,
                (q, k, v, kv_len0, keep, rate), f"attention_train_forward ({name})"))
            earlier = parent.attention.attention_backward(dout, q, k, v, *fwd, kv_len0, keep, rate)
            got = K8.attention_backward(dout, q, k, v, *fwd, kv_len0, keep, rate)
            bwd_cases[name]["earlier_bits_equal"] = all(torch.equal(a, b)
                                                        for a, b in zip(got, earlier))
            if not bwd_cases[name]["earlier_bits_equal"]:
                raise AssertionError(f"attention_backward ({name}): the parent commit's kernel "
                                     f"gives other bits")
            bwd_cases[name]["earlier_ms"] = gpu_ms(lambda: parent.attention.attention_backward(
                dout, q, k, v, *fwd, kv_len0, keep, rate))
    # a training step's launches: each encoder layer once, then per decode
    # step each decoder layer's self-attention at t and cross-attention; with
    # teacher forcing each decoder layer's causal pass and cross-attention;
    # at --his-window 96 the encoder's 96 x 96 and the cross-attention over
    # the distilled 48
    L = args.block_num
    decode = {f"decode_t{t}": L for t in range(F)}
    mixes = {"step": {"encoder": L, "cross": F * L, **decode},
             "teacher_forced_step": {"encoder": L, "causal_tf": L, "cross_tf": L},
             "his96_step": {"encoder_96": L, "cross_48": F * L, **decode}}
    if sum(mixes["step"].values()) != attention_launches(args):
        raise AssertionError(f"attention: the step mix {mixes['step']} is not a step's launches")
    rows = {}
    for row, cases, err in (("attention_train_forward", fwd_cases, fwd_err),
                            ("attention_backward", bwd_cases, bwd_err)):
        keys = ("ms", "bound_ms", "plain_ms", "library_ms") + (
            ("earlier_ms",) if parent is not None else ())
        sums = {f"{mix}_{key}_sum": sum(n * cases[name][key] for name, n in shape_n.items())
                for mix, shape_n in mixes.items() for key in keys}
        main = cases[f"decode_t{F - 1}"]
        rows[row] = dict(max_abs_err=err, **{k: main[k] for k in (
                             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                             "earlier_ms") if k in main},
                         shape=dict(B=B, H=H, Dh=Dh, Lq=1, Lk=F, t=F - 1, dropout=rate),
                         batch=dict(launches=mixes, timing_floor_ms=floor_ms, **sums),
                         bits_equal_on_two_launches=True, cases=cases)
    if parent is not None:  # a d 512 training step's 62 launches of each, in turns
        P8 = parent.attention

        def step_of(fn, mix="step"):
            return lambda: [fn(*inputs[name]) for name, n in mixes[mix].items()
                            for _ in range(n)]

        forward = lambda train_forward: step_of(
            lambda dout, q, k, v, fwd, kv_len0, keep: train_forward(q, k, v, kv_len0, keep,
                                                                    rate))
        backward = lambda backward_fn, mix="step": step_of(
            lambda dout, q, k, v, fwd, kv_len0, keep: backward_fn(dout, q, k, v, *fwd, kv_len0,
                                                                  keep, rate), mix)
        rows["attention_train_forward"]["batch"]["earlier_check"] = parent_turns(
            forward(K8.attention_train_forward), forward(P8.attention_train_forward))
        rows["attention_backward"]["batch"]["earlier_check"] = parent_turns(
            backward(K8.attention_backward), backward(P8.attention_backward))
        rows["attention_backward"]["batch"]["his96_earlier_check"] = parent_turns(
            backward(K8.attention_backward, "his96_step"),
            backward(P8.attention_backward, "his96_step"))
    return rows


# ---------------------------------------------------------------- phase 2f

def attention_bf16_phase(dev, floor_ms: float, parent=None) -> dict:
    """K8 on bf16 q, k, v (``run_models --bf16``) at B = VP_BATCH in every
    viewport shape of phase 2d: the decode step over the 15-slot cache at
    each t, the cross-attention 1 x 3, the encoder's 5 x 5, the
    teacher-forced causal 15 x 15 and cross 15 x 3, and the --his-window 96
    shapes (the encoder's 96 x 96, the cross-attention over the distilled
    48) and a decode step over 256 keys; serving, training mode (keep mask
    at 0.1) and backward, each against its plain bf16 version: every
    element within one bf16 ulp of the larger of the two plus
    ``bf16_slack`` (P and dP' are rounded to bf16 inside from f32 values
    the two compute in another order; ``excess`` <= 1), the row statistics
    as phase 2d's, two launches bit-equal.  Timed by CUDA events beside the
    bf16 bytes bound and SDPA on the same bf16 tensors (forward; forward +
    backward by autograd); the sums over a viewport batch's 62 serving
    launches and a training step's 62 (6 teacher-forced).  Each forward case
    names its plan; with ``parent``, the parent commit's serving and
    training kernels are timed beside them (``earlier_ms``) and must give
    the same bits (``earlier_bits_equal``).  Returns the three bf16 rows."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from mansy_immersivevideostreaming_torch.cli import run_models
    from mansy_immersivevideostreaming_torch.kernels import attention as K8

    args = run_models.build_parser().parse_args(["--test", "--bf16"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    B, H, Dh, F, rate = VP_BATCH, 8, 64, args.fut_window, 0.1
    shapes = {f"decode_t{t}": (1, F, t + 1) for t in range(F)}
    shapes.update(cross=(1, 3, None), encoder=(5, 5, None), causal_tf=(F, F, 1),
                  cross_tf=(F, 3, None), encoder_96=(96, 96, None), cross_48=(1, 48, None),
                  decode_256=(1, 256, None))
    cases = {"serve": {}, "train": {}, "backward": {}}
    worst = {"serve": 0.0, "train": 0.0, "backward": 0.0}
    err = {"serve": 0.0, "train": 0.0, "backward": 0.0}
    beyond_ulp = {"serve": 0, "train": 0, "backward": 0}
    for name, (Lq, Lk, kv_len0) in shapes.items():
        q, k, v = (torch.randn(B, L, H, Dh, device=dev, generator=gen).bfloat16()
                   for L in (Lq, Lk, Lk))
        dout = torch.randn(B, Lq, H, Dh, device=dev, generator=gen).bfloat16()
        keep = (torch.rand(B, H, Lq, Lk, device=dev, generator=gen) < 1 - rate).to(torch.uint8)

        def agree(kind, got, ref, slack, label):
            excess = K8.bf16_excess(got, ref, slack)
            if not excess <= 1:
                raise AssertionError(f"attention bf16 ({label}, {name}) disagrees with its plain "
                                     f"version beyond one ulp and the rounding slack "
                                     f"({excess})")
            diff = (got.float() - ref.float()).abs()
            ulp = K8.bf16_ulp(torch.maximum(got.float().abs(), ref.float().abs()))
            worst[kind] = max(worst[kind], excess)
            err[kind] = max(err[kind], float(diff.max()))
            beyond_ulp[kind] += int((diff > ulp).sum())

        got = K8.attention(q, k, v, kv_len0)
        agree("serve", got, K8.attention_plain(q, k, v, kv_len0),
              K8.bf16_slack(q, k, v, dout, kv_len0)[0], "serving")
        if not torch.equal(got, K8.attention(q, k, v, kv_len0)):
            raise AssertionError(f"attention bf16 ({name}): two launches differ")
        slack = K8.bf16_slack(q, k, v, dout, kv_len0, keep, rate)
        fwd = K8.attention_train_forward(q, k, v, kv_len0, keep, rate)
        ref = K8.attention_train_forward_plain(q, k, v, kv_len0, keep, rate)
        agree("train", fwd[0], ref[0], slack[0], "training")
        for a, b in zip(fwd[1:], ref[1:]):
            if not training_close(a, b, float(b.abs().max())):
                raise AssertionError(f"attention bf16 (training {name}): row statistics differ")
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        want = torch.autograd.grad(K8.attention_plain(*leaves, kv_len0, keep, rate), leaves,
                                   dout)
        grads = K8.attention_backward(dout, q, k, v, *fwd, kv_len0, keep, rate)
        for g, w, sl in zip(grads, want, slack[1:]):
            agree("backward", g, w, sl, "backward")
        if not (all(torch.equal(a, b) for a, b in zip(
                fwd, K8.attention_train_forward(q, k, v, kv_len0, keep, rate)))
                and all(torch.equal(a, b) for a, b in zip(grads, K8.attention_backward(
                    dout, q, k, v, *fwd, kv_len0, keep, rate)))):
            raise AssertionError(f"attention bf16 (training {name}): two launches differ")
        seen = torch.arange(Lq, device=dev) + (Lk if kv_len0 is None else kv_len0)
        allowed = torch.arange(Lk, device=dev)[None, :] < seen[:, None]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
        dout_t = dout.transpose(1, 2)
        common = dict(Lq=Lq, Lk=Lk, kv_len0=kv_len0)
        plan = K8.attention_forward_plan(B, Lq, Lk, H, Dh)._asdict()
        cases["serve"][name] = dict(
            **common, plan=plan, ms=gpu_ms(lambda: K8.attention(q, k, v, kv_len0)),
            plain_ms=gpu_ms(lambda: K8.attention_plain(q, k, v, kv_len0)),
            library_ms=gpu_ms(lambda: sdpa(qt, kt, vt, attn_mask=allowed)),
            **bound(*attention_cost(B, Lq, Lk, H, Dh, kv_len0, 2), BF16_FLOP_PER_S))
        cases["train"][name] = dict(
            **common, plan=plan,
            ms=gpu_ms(lambda: K8.attention_train_forward(q, k, v, kv_len0, keep, rate)),
            plain_ms=gpu_ms(lambda: K8.attention_train_forward_plain(q, k, v, kv_len0, keep,
                                                                     rate)),
            library_ms=gpu_ms(lambda: sdpa(qt, kt, vt, attn_mask=allowed)),
            **bound(*attention_train_cost(B, Lq, Lk, H, Dh, kv_len0, True, 2),
                    BF16_FLOP_PER_S))
        cases["backward"][name] = dict(
            **common, ms=gpu_ms(lambda: K8.attention_backward(dout, q, k, v, *fwd, kv_len0, keep,
                                                              rate)),
            plain_ms=gpu_ms(lambda: K8.attention_backward_plain(dout, q, k, v, *fwd, kv_len0,
                                                                keep, rate)),
            library_ms=gpu_ms(lambda: torch.autograd.grad(
                sdpa(qg, kg, vg, attn_mask=allowed), (qg, kg, vg), dout_t)),
            plan=K8.attention_backward_plan(B, Lq, Lk, H, Dh)._asdict(),
            **bound(*attention_backward_cost(B, Lq, Lk, H, Dh, kv_len0, True, 2),
                    BF16_FLOP_PER_S))
        if parent is not None:  # the parent commit's kernels on the same inputs
            cases["serve"][name].update(earlier_forward(
                parent.attention.attention, K8.attention, (q, k, v, kv_len0),
                f"attention bf16 ({name})"))
            cases["train"][name].update(earlier_forward(
                parent.attention.attention_train_forward, K8.attention_train_forward,
                (q, k, v, kv_len0, keep, rate), f"attention_train_forward bf16 ({name})"))
    L = args.block_num
    serve_mix = {"encoder": L, "cross": F * L, **{f"decode_t{t}": L for t in range(F)}}
    mixes = {"step": serve_mix, "teacher_forced_step": {"encoder": L, "causal_tf": L,
                                                        "cross_tf": L}}
    if sum(serve_mix.values()) != attention_launches(args):
        raise AssertionError(f"attention bf16: the mix {serve_mix} is not a batch's launches")
    rows = {}
    for row, kind, row_mixes in (("attention_bf16", "serve", {"batch": serve_mix}),
                                 ("attention_train_forward_bf16", "train", mixes),
                                 ("attention_backward_bf16", "backward", mixes)):
        keys = ("ms", "bound_ms", "plain_ms", "library_ms") + (
            ("earlier_ms",) if parent is not None and kind != "backward" else ())
        sums = {f"{mix}_{key}_sum": sum(n * cases[kind][name][key] for name, n in shape_n.items())
                for mix, shape_n in row_mixes.items() for key in keys}
        main = cases[kind][f"decode_t{F - 1}"]
        rows[row] = dict(max_abs_err=err[kind], max_excess_over_slack=worst[kind],
                         elements_beyond_one_ulp=beyond_ulp[kind],
                         **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms")},
                         shape=dict(B=B, H=H, Dh=Dh, Lq=1, Lk=F, t=F - 1, dtype="bfloat16",
                                    **({"dropout": rate} if kind != "serve" else {})),
                         batch=dict(launches=row_mixes, timing_floor_ms=floor_ms, **sums),
                         bits_equal_on_two_launches=True, cases=cases[kind])
    return rows


# ---------------------------------------------------------------- phase 2i

def library_ms(fn, reps: int):
    """``gpu_ms`` of a PyTorch yardstick call, or None where PyTorch takes
    no backend for the shape (nothing of the port calls it)."""
    try:
        return gpu_ms(fn, reps)
    except RuntimeError:
        return None


def limit_row(kind: str, plan, Dh: int, dtype) -> str:
    """The kernels-line row of a phase 2i case: the wrapper's row in the mode
    its launch is counted in (``forward_mode``; for the backward, whose
    ``plan`` is the backward's, ``backward_mode``: the split's ``_split``
    past 2048 keys, ``_wide`` past 256 dims); the streamed, wide and split
    variants take both element types in one row (MODE_SUFFIX)."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    base = {"serve": "attention", "train": "attention_train_forward",
            "backward": "attention_backward"}[kind]
    suffix = K8.forward_mode(plan, Dh) if kind != "backward" else K8.backward_mode(plan)
    return base + (suffix or ("_bf16" if dtype == torch.bfloat16 else ""))


def tensor_core_bound(B: int, Lq: int, Lk: int, H: int, Dh: int, kv_len0, nbytes: int,
                      bf16: bool, backward: bool = False) -> dict:
    """A tensor-core kernel's bound as it runs its work: its products on the
    tensor cores, bf16 at 989 TFLOP/s (``bound_bf16_mma_ms``) or f32 as
    three TF32 products at 495 (``bound_3xtf32_ms``), and its scalar work
    in f32 at 67; or the bytes, if they take longer.  The streamed forward:
    q . k and p . v (4 Dh operations a seen (row, key)) and the softmax's 4
    a key; the wide backward (``backward``): q . k, dO . v, dS . k, dS^T . q
    and P'^T . dO (10 Dh) and about 10 scalar operations a key
    (:func:`attention_backward_cost`)."""
    first = Lk if kv_len0 is None else kv_len0
    pairs = B * H * sum(min(Lk, first + r) for r in range(Lq))
    per_pair = 10 if backward else 4
    products = per_pair * Dh * pairs
    t_tc = products / BF16_FLOP_PER_S if bf16 else 3 * products / TF32_FLOP_PER_S
    t = t_tc + per_pair * pairs / F32_FLOP_PER_S
    key = "bound_bf16_mma_ms" if bf16 else "bound_3xtf32_ms"
    return {key: 1e3 * max(t, nbytes / HBM_BYTES_PER_S)}


def attention_limits_phase(dev, floor_ms: float, parent=None) -> dict:
    """K8 past its earlier limits of 2048 keys and 256 dims (phase 2i): the
    row kernel over 3073 and 5000 keys (decode at --fut-window 5000), the
    streamed kernel (tensor cores) at --his-window 5000 (the encoder's 5000 x 5000,
    full and causal, B 2; the teacher-forced cross-attention 15 x 2500),
    both at LIMIT_LONG_BATCH but the encoder's, and the wide kernels at heads of 257, 320, 512, 1024 and 2048
    dims (8 heads; a decode step 1 x 15, the teacher-forced causal 15 x 15,
    an encoder's 96 x 96; B 512 at 512 dims, the --hidden-dim 4096 path's,
    LIMIT_WIDE_BATCH at the others): serving, training mode with a keep mask
    at 0.1 and backward, in f32 and bf16, each against its plain version
    at phase 2d's training tolerance (f32) or phase 2f's ulp and slack
    (bf16), two launches bit-equal; each timed (LIMIT_REPS calls) beside
    its bound, its plain version and SDPA (``library_ms``), the streamed
    kernel's cases also beside its bound on the tensor cores
    (:func:`tensor_core_bound`), and with ``parent`` every serving and
    training case of the streamed and wide rows (the forward's bits equal
    to the parent's, ``earlier_bits_equal``), and every wide backward case,
    beside the parent commit's kernel, in turns (:func:`parent_turns`:
    ``ratio`` below 1 where this tree's is faster); also vp_train_wide's
    encoder 5 x 5 and cross-attention 15 x 3 at 512 dims.  The wide backward of
    more than one row has the tensor-core bound of its five products and,
    in f32, both kernels forced and timed (``tensor_core_ms``,
    ``simt_ms``), each within the limits and bit-equal twice.  The backward
    of more than one row past 2048 keys runs the split (forced where the
    rule takes the one-CTA kernel: 15 x 2500 at B LIMIT_LONG_BATCH, its
    choice in ``planned``), with the one-CTA tile kernel's bits and time
    beside it (``one_cta_ms``, ONE_CTA_REPS calls).  The streamed kernel
    forced at 96 and 2048 keys agrees with the resident kernel and the
    plain version at the same limits (``forced_stream``: its sums run in
    the tensor cores' order), and the split and the one-CTA backward, each
    forced, give the same bits at SPLIT_FORCED's shapes, each timed
    (``forced_split``).  Returns the six new rows and, for the rows of
    the row kernel and the narrow backward, ``cases_past_limits``."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from mansy_immersivevideostreaming_torch.kernels import attention as K8

    P8 = parent.attention if parent is not None else None
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    H, rate, reps = 8, 0.1, LIMIT_REPS
    shapes = {"decode_3073": (LIMIT_LONG_BATCH, 1, 3073, None, 64),
              "decode_5000": (LIMIT_LONG_BATCH, 1, 5000, None, 64),
              "encoder_5000": (2, 5000, 5000, None, 64), "causal_5000": (2, 5000, 5000, 1, 64),
              "cross_tf_2500": (LIMIT_LONG_BATCH, 15, 2500, None, 64)}
    for Dh in LIMIT_WIDE_DIMS:
        B = VP_BATCH if Dh == 512 else LIMIT_WIDE_BATCH
        shapes.update({f"decode_dh{Dh}": (B, 1, 15, None, Dh),
                       f"causal_tf_dh{Dh}": (B, 15, 15, 1, Dh),
                       f"encoder_96_dh{Dh}": (B, 96, 96, None, Dh)})
    # the rest of vp_train_wide's shapes: its encoder and teacher-forced cross-attention
    shapes.update(encoder_dh512=(VP_BATCH, 5, 5, None, 512),
                  cross_tf_dh512=(VP_BATCH, 15, 3, None, 512))
    cases, errs = {}, {}

    def record(row, label, err, fields):
        cases.setdefault(row, {})[label] = dict(max_abs_err=err, **fields)
        errs[row] = max(errs.get(row, 0.0), err)

    for name, (B, Lq, Lk, kv_len0, Dh) in shapes.items():
        plan = K8.attention_forward_plan(B, Lq, Lk, H, Dh)
        # the split backward past 2048 keys, forced where the rule keeps the one-CTA tile
        # kernel (15 x 2500: one row tile), the one-CTA kernel beside it
        split = True if Lq > 1 and Dh <= K8.CHUNK_DIMS and Lk > K8.SPLIT_KEYS else None
        seen = torch.arange(Lq, device=dev) + (Lk if kv_len0 is None else kv_len0)
        allowed = torch.arange(Lk, device=dev)[None, :] < seen[:, None]
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            bf16 = dtype == torch.bfloat16
            elem, rate_ops = (2, BF16_FLOP_PER_S) if bf16 else (4, F32_FLOP_PER_S)
            bplan = K8.attention_backward_plan(B, Lq, Lk, H, Dh, split, bf16=bf16)
            q, k, v, dout = (torch.randn(B, L, H, Dh, device=dev, generator=gen).to(dtype)
                             for L in (Lq, Lk, Lk, Lq))
            keep = (torch.rand(B, H, Lq, Lk, device=dev, generator=gen) < 1 - rate).to(
                torch.uint8)
            label = f"{name}_{tag}"
            slack = K8.bf16_slack(q, k, v, dout, kv_len0, keep, rate) if bf16 else None

            def agree(got, want, sl, what):
                if bf16:
                    excess = K8.bf16_excess(got, want, sl)
                    ok = excess <= 1
                else:
                    ok = training_close(got, want, float(want.abs().max()))
                if not ok:
                    raise AssertionError(f"attention {what} ({label}) disagrees with its plain "
                                         f"version")
                return float((got.float() - want.float()).abs().max())

            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            streamed = plan.kernel == "stream"
            # the parent's kernel in turns, for the streamed and wide rows; the forward's bits
            # must be the parent's (its wide score tile is the backward's since this tree)
            def earlier(this, that, bits=False):
                if P8 is None or not (streamed or Dh > K8.CHUNK_DIMS):
                    return {}
                same = not bits or all(torch.equal(a, b)
                                       for a, b in zip(leaves(this()), leaves(that())))
                if not same:
                    raise AssertionError(f"attention ({label}): the parent commit's forward "
                                         f"gives other bits")
                return dict(parent_turns(this, that, reps), **({"earlier_bits_equal": True}
                                                               if bits else {}))
            wide_rows = Lq > 1 and Dh > K8.CHUNK_DIMS  # the backward on the tensor cores, or
            #                                          (f32, where the plan keeps it) the SIMT one
            # serving
            got = K8.attention(q, k, v, kv_len0)
            err = agree(got, K8.attention_plain(q, k, v, kv_len0),
                        K8.bf16_slack(q, k, v, dout, kv_len0)[0] if bf16 else None, "serving")
            if not torch.equal(got, K8.attention(q, k, v, kv_len0)):
                raise AssertionError(f"attention ({label}): two launches differ")
            record(limit_row("serve", plan, Dh, dtype), label, err, dict(
                B=B, Lq=Lq, Lk=Lk, kv_len0=kv_len0, Dh=Dh, dtype=tag, plan=plan._asdict(),
                ms=gpu_ms(lambda: K8.attention(q, k, v, kv_len0), reps),
                plain_ms=gpu_ms(lambda: K8.attention_plain(q, k, v, kv_len0), reps),
                library_ms=library_ms(lambda: sdpa(qt, kt, vt, attn_mask=allowed), reps),
                **bound(*attention_cost(B, Lq, Lk, H, Dh, kv_len0, elem), rate_ops),
                **(tensor_core_bound(B, Lq, Lk, H, Dh, kv_len0,
                                     attention_cost(B, Lq, Lk, H, Dh, kv_len0, elem)[1], bf16)
                   if streamed else {}),
                **earlier(lambda: K8.attention(q, k, v, kv_len0),
                          lambda: P8.attention(q, k, v, kv_len0), bits=True)))
            del got
            # training mode
            fwd = K8.attention_train_forward(q, k, v, kv_len0, keep, rate)
            ref = K8.attention_train_forward_plain(q, k, v, kv_len0, keep, rate)
            err = agree(fwd[0], ref[0], slack[0] if bf16 else None, "training")
            for a, b in zip(fwd[1:], ref[1:]):
                if not training_close(a, b, float(b.abs().max())):
                    raise AssertionError(f"attention training ({label}): row statistics differ")
            if not all(torch.equal(a, b) for a, b in zip(
                    fwd, K8.attention_train_forward(q, k, v, kv_len0, keep, rate))):
                raise AssertionError(f"attention training ({label}): two launches differ")
            del ref
            record(limit_row("train", plan, Dh, dtype), label, err, dict(
                B=B, Lq=Lq, Lk=Lk, kv_len0=kv_len0, Dh=Dh, dtype=tag, dropout=rate,
                plan=plan._asdict(),
                ms=gpu_ms(lambda: K8.attention_train_forward(q, k, v, kv_len0, keep, rate), reps),
                plain_ms=gpu_ms(lambda: K8.attention_train_forward_plain(q, k, v, kv_len0, keep,
                                                                         rate), reps),
                library_ms=library_ms(lambda: sdpa(qt, kt, vt, attn_mask=allowed), reps),
                **bound(*attention_train_cost(B, Lq, Lk, H, Dh, kv_len0, True, elem), rate_ops),
                **(tensor_core_bound(B, Lq, Lk, H, Dh, kv_len0, attention_train_cost(
                    B, Lq, Lk, H, Dh, kv_len0, True, elem)[1], bf16) if streamed else {}),
                **earlier(lambda: K8.attention_train_forward(q, k, v, kv_len0, keep, rate),
                          lambda: P8.attention_train_forward(q, k, v, kv_len0, keep, rate),
                          bits=True)))
            # backward
            leaves_ = [x.clone().requires_grad_() for x in (q, k, v)]
            want = torch.autograd.grad(K8.attention_plain(*leaves_, kv_len0, keep, rate),
                                       leaves_, dout)
            grads = K8.attention_backward(dout, q, k, v, *fwd, kv_len0, keep, rate, split)
            scale = max(float(w.abs().max()) for w in want)
            err = 0.0
            for g, w, sl in zip(grads, want, slack[1:] if bf16 else (None,) * 3):
                if bf16:
                    err = max(err, agree(g, w, sl, "backward"))
                elif not training_close(g, w, scale):
                    raise AssertionError(f"attention_backward ({label}) disagrees with the plain "
                                         f"version's autograd")
                else:
                    err = max(err, float((g - w).abs().max()))
            if not all(torch.equal(a, b) for a, b in zip(grads, K8.attention_backward(
                    dout, q, k, v, *fwd, kv_len0, keep, rate, split))):
                raise AssertionError(f"attention_backward ({label}): two launches differ")
            one_cta = {}
            if wide_rows:  # each wide kernel forced: within K8's limits, bit-equal twice, timed
                for forced, key in ((True, "tensor_core_ms"), (False, "simt_ms")):
                    if bf16 and not forced:
                        continue
                    run = lambda: K8.attention_backward(dout, q, k, v, *fwd, kv_len0, keep, rate,
                                                        tensor_cores=forced)
                    other = run()
                    for g, w, sl in zip(other, want, slack[1:] if bf16 else (None,) * 3):
                        if bf16:
                            agree(g, w, sl, f"backward ({key[:-3]} forced)")
                        elif not training_close(g, w, scale):
                            raise AssertionError(f"attention_backward ({label}, {key[:-3]} "
                                                 f"forced) disagrees with the plain version")
                    if not all(torch.equal(a, b) for a, b in zip(other, run())):
                        raise AssertionError(f"attention_backward ({label}, {key[:-3]} forced): "
                                             f"two launches differ")
                    one_cta[key] = gpu_ms(run, reps)
                    del other
            if split:  # the one-CTA tile kernel's bits, and its time
                if not all(torch.equal(a, b) for a, b in zip(grads, K8.attention_backward(
                        dout, q, k, v, *fwd, kv_len0, keep, rate, split=False))):
                    raise AssertionError(f"attention_backward ({label}): the split's bits differ "
                                         f"from the one-CTA tile kernel's")
                one_cta = dict(
                    one_cta_bits_equal=True,
                    planned=K8.attention_backward_plan(B, Lq, Lk, H, Dh).kernel,
                    one_cta_ms=gpu_ms(lambda: K8.attention_backward(
                        dout, q, k, v, *fwd, kv_len0, keep, rate, split=False), ONE_CTA_REPS))
            del want, grads, slack
            qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
            dout_t = dout.transpose(1, 2)
            record(limit_row("backward", bplan, Dh, dtype), label, err, dict(
                B=B, Lq=Lq, Lk=Lk, kv_len0=kv_len0, Dh=Dh, dtype=tag, dropout=rate,
                plan=bplan._asdict(),
                ms=gpu_ms(lambda: K8.attention_backward(dout, q, k, v, *fwd, kv_len0, keep, rate,
                                                        split), reps),
                plain_ms=gpu_ms(lambda: K8.attention_backward_plain(dout, q, k, v, *fwd, kv_len0,
                                                                    keep, rate), reps),
                library_ms=library_ms(lambda: torch.autograd.grad(
                    sdpa(qg, kg, vg, attn_mask=allowed), (qg, kg, vg), dout_t), reps),
                **bound(*attention_backward_cost(B, Lq, Lk, H, Dh, kv_len0, True, elem),
                        rate_ops), **one_cta,
                **(tensor_core_bound(B, Lq, Lk, H, Dh, kv_len0, attention_backward_cost(
                    B, Lq, Lk, H, Dh, kv_len0, True, elem)[1], bf16, backward=True)
                   if wide_rows else {}),
                **(earlier(lambda: K8.attention_backward(dout, q, k, v, *fwd, kv_len0, keep,
                                                         rate),
                           lambda: P8.attention_backward(dout, q, k, v, *fwd, kv_len0, keep,
                                                         rate))
                   if Dh > K8.CHUNK_DIMS else {})))
            del q, k, v, dout, keep, fwd, leaves_, qg, kg, vg
        torch.cuda.empty_cache()
        log(f"phase 2i: {name} checked and timed (the card's peak so far "
            f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB)")

    # the streamed kernel where the resident one runs: within K8's limits of the
    # resident kernel's outputs and statistics and of the plain version's
    forced = {}
    for name, (B, Lq, Lk, kv_len0) in (("encoder_96", (VP_BATCH, 96, 96, None)),
                                       ("rows_33_keys_2048", (8, 33, 2048, 7))):
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            bf16 = dtype == torch.bfloat16
            q, k, v = (torch.randn(B, L, H, 64, device=dev, generator=gen).to(dtype)
                       for L in (Lq, Lk, Lk))
            keep = (torch.rand(B, H, Lq, Lk, device=dev, generator=gen) < 1 - rate).to(
                torch.uint8)
            streamed_o = torch.empty_like(q)
            serve_stream = lambda: K8._launch_forward(q, k, v, kv_len0, streamed_o, False,
                                                      stream=True)
            serve_stream()
            errs_ = []
            for mask in (None, keep):
                got = K8.attention_train_forward(q, k, v, kv_len0, mask, rate, stream=True)
                if mask is None and not torch.equal(streamed_o, got[0]):
                    raise AssertionError(f"attention ({name}, {tag}): the streamed kernel's "
                                         f"serving and training outputs differ")
                if not all(torch.equal(a, b) for a, b in zip(got, K8.attention_train_forward(
                        q, k, v, kv_len0, mask, rate, stream=True))):
                    raise AssertionError(f"attention ({name}, {tag}): two launches of the "
                                         f"streamed kernel differ")
                slack = (K8.bf16_slack(q, k, v, torch.zeros_like(q), kv_len0, mask, rate)[0]
                         if bf16 else None)
                for what, want in (("resident", K8.attention_train_forward(
                        q, k, v, kv_len0, mask, rate)), ("plain", K8.attention_train_forward_plain(
                            q, k, v, kv_len0, mask, rate))):
                    ok = (K8.bf16_excess(got[0], want[0], slack) <= 1 if bf16
                          else training_close(got[0], want[0], float(want[0].abs().max())))
                    if not (ok and all(training_close(a, b, float(b.abs().max()))
                                       for a, b in zip(got[1:], want[1:]))):
                        raise AssertionError(f"attention ({name}, {tag}): the streamed kernel "
                                             f"disagrees with the {what} version")
                    if what == "resident":
                        errs_.append(float((got[0].float() - want[0].float()).abs().max()))
                del got
            seen = torch.arange(Lq, device=dev) + (Lk if kv_len0 is None else kv_len0)
            allowed = torch.arange(Lk, device=dev)[None, :] < seen[:, None]
            elem, rate_ops = (2, BF16_FLOP_PER_S) if bf16 else (4, F32_FLOP_PER_S)
            nbytes = attention_cost(B, Lq, Lk, H, 64, kv_len0, elem)[1]
            forced[f"{name}_{tag}"] = dict(
                B=B, Lq=Lq, Lk=Lk, kv_len0=kv_len0, Dh=64, agrees_with_resident=True,
                max_abs_err_vs_resident=max(errs_),
                resident_plan=K8.attention_forward_plan(B, Lq, Lk, H, 64)._asdict(),
                streamed_plan=K8.attention_forward_plan(B, Lq, Lk, H, 64, stream=True)._asdict(),
                resident_ms=gpu_ms(lambda: K8.attention(q, k, v, kv_len0), reps),
                streamed_ms=gpu_ms(serve_stream, reps),
                plain_ms=gpu_ms(lambda: K8.attention_plain(q, k, v, kv_len0), reps),
                library_ms=library_ms(lambda: sdpa(*(x.transpose(1, 2) for x in (q, k, v)),
                                                   attn_mask=allowed), reps),
                **bound(*attention_cost(B, Lq, Lk, H, 64, kv_len0, elem), rate_ops),
                **tensor_core_bound(B, Lq, Lk, H, 64, kv_len0, nbytes, bf16),
                train_resident_ms=gpu_ms(lambda: K8.attention_train_forward(
                    q, k, v, kv_len0, keep, rate), reps),
                train_streamed_ms=gpu_ms(lambda: K8.attention_train_forward(
                    q, k, v, kv_len0, keep, rate, stream=True), reps))
            del q, k, v, keep, streamed_o

    # the split backward and the one-CTA tile kernel, each forced where the rule takes the
    # one-CTA kernel: the same bits, and both times beside the rule's choice
    forced_split = {}
    for name, (B, Lq, Lk, kv_len0, Dh) in SPLIT_FORCED.items():
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            q, k, v, dout = (torch.randn(B, L, H, Dh, device=dev, generator=gen).to(dtype)
                             for L in (Lq, Lk, Lk, Lq))
            keep = (torch.rand(B, H, Lq, Lk, device=dev, generator=gen) < 1 - rate).to(
                torch.uint8)
            for mask in (None, keep):
                fwd = K8.attention_train_forward(q, k, v, kv_len0, mask, rate)
                if not all(torch.equal(a, b) for a, b in zip(
                        K8.attention_backward(dout, q, k, v, *fwd, kv_len0, mask, rate,
                                              split=False),
                        K8.attention_backward(dout, q, k, v, *fwd, kv_len0, mask, rate,
                                              split=True))):
                    raise AssertionError(f"attention_backward ({name}, {tag}): the split's bits "
                                         f"differ from the one-CTA tile kernel's")
            forced_split[f"{name}_{tag}"] = dict(
                B=B, Lq=Lq, Lk=Lk, kv_len0=kv_len0, Dh=Dh, bits_equal=True,
                planned=K8.attention_backward_plan(B, Lq, Lk, H, Dh).kernel,
                one_cta_plan=K8.attention_backward_plan(B, Lq, Lk, H, Dh, split=False)._asdict(),
                split_plan=K8.attention_backward_plan(B, Lq, Lk, H, Dh, split=True)._asdict(),
                one_cta_ms=gpu_ms(lambda: K8.attention_backward(dout, q, k, v, *fwd, kv_len0,
                                                                keep, rate, split=False), reps),
                split_ms=gpu_ms(lambda: K8.attention_backward(dout, q, k, v, *fwd, kv_len0, keep,
                                                              rate, split=True), reps))
            del q, k, v, dout, keep, fwd

    rows = {}
    mains = {"attention_stream": "encoder_5000_f32",
             "attention_train_forward_stream": "encoder_5000_f32",
             "attention_backward_split": "encoder_5000_f32",
             **{row: "decode_dh512_f32" for row in ("attention_wide",
                                                    "attention_train_forward_wide")},
             # the backward on the tensor cores at the --hidden-dim 4096 path's encoder
             "attention_backward_wide": "encoder_96_dh512_f32"}
    for row, main in mains.items():
        m = cases[row][main]
        rows[row] = dict(max_abs_err=errs[row],
                         **{k: m[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                              "bound_3xtf32_ms", "bound_bf16_mma_ms",
                                              "library_ms", "one_cta_ms", "tensor_core_ms",
                                              "simt_ms", "earlier_ms")
                            if k in m},
                         main_case=main, timing_floor_ms=floor_ms,
                         bits_equal_on_two_launches=True, cases=cases[row])
    rows["attention_stream"]["forced_stream"] = forced
    rows["attention_backward_split"]["forced_split"] = forced_split
    for row in set(cases) - set(mains):  # the row kernel and the narrow backward, past 2048 keys
        rows[row] = dict(cases_past_limits=cases[row], max_abs_err_past_limits=errs[row])
    return rows


# ----------------------------------------------------------- phases 9, 10

def synthetic_traces(pairs: int, length: int, seed: int) -> np.ndarray:
    """[pairs, length, 2] f32 head traces: a random start, drift and random
    walk, the yaw wrapped into [0, 1) and the pitch clipped to [0, 1]."""
    rng = np.random.default_rng(seed)
    t = np.arange(length)[None, :, None]
    xy = (rng.random((pairs, 1, 2)) + rng.normal(0, 0.01, (pairs, 1, 2)) * t
          + rng.normal(0, 0.01, (pairs, length, 2)).cumsum(1))
    xy[..., 0] %= 1.0
    xy[..., 1] = np.clip(xy[..., 1], 0.0, 1.0)
    return xy.astype(np.float32)


def seeded_mtio(dev, seed: int, dtype=torch.float32):
    """The full-width MTIO of ``run_models``' defaults with PyTorch's default
    initialisation from ``seed``, and BatchNorm statistics off 0 and 1, at
    the compute ``dtype``."""
    from mansy_immersivevideostreaming_torch.models.mtio import ViewportTransformerMTIO
    torch.manual_seed(seed)
    model = ViewportTransformerMTIO(dtype=dtype, device=dev)
    bn = model.transformer.distill.bn
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    bn.running_mean.copy_(0.3 * torch.randn(bn.running_mean.shape, device=dev, generator=gen))
    bn.running_var.copy_(0.5 + torch.rand(bn.running_var.shape, device=dev, generator=gen))
    return model


def attention_launches(args) -> int:
    """K8 launches a batch: each encoder layer once, then per decode step
    each decoder layer's self- and cross-attention."""
    return args.block_num + args.fut_window * args.block_num * 2


def stack_rows(rows):
    """A Results notebook's rows as (pred [N, F, 2], metrics [5, N, F])."""
    return (np.stack([r[4] for r in rows]),
            np.stack([np.stack([r[i] for r in rows]) for i in range(5, 10)]))


def vp_readings(rows, ref_rows) -> dict:
    """How far phase 9's rows lie from another run's: the predictions'
    largest and root-mean-square differences; on every step where both
    truncate to the same pixel, whether accuracy, recall, precision and f1
    are equal, and the MSE's largest difference."""
    pred, metrics = stack_rows(rows)
    ref_pred, ref_metrics = stack_rows(ref_rows)
    same = np.ones(pred.shape[:2], bool)
    for axis, size in enumerate(FRAME):
        same &= ((pred[..., axis] * np.float32(size)).astype(np.int32)
                 == (ref_pred[..., axis] * np.float32(size)).astype(np.int32))
    return dict(pred_max_abs_err=float(np.abs(pred - ref_pred).max()),
                pred_rms_err=float(np.sqrt(np.mean(np.square(pred.astype(np.float64)
                                                              - ref_pred)))),
                mse_max_abs_err=float(np.abs(metrics[0] - ref_metrics[0]).max()),
                metrics_equal=bool(np.array_equal(metrics[1:, same], ref_metrics[1:, same])),
                in_range=bool(np.isfinite(metrics).all() and (0 <= pred).all()
                              and (pred <= 1).all()),
                steps_compared=int(same.sum()), steps_total=int(same.size),
                trajectories_with_a_moved_pixel=int((~same).any(1).sum()))


def vp_faults(r: dict, limits) -> list:
    """The ``limits`` (the predictions' largest and root-mean-square
    differences, the MSE's largest) that the readings ``r`` of
    ``vp_readings`` break."""
    return [f"{key} {r[key]} > {limit}" for key, limit in zip(
        ("pred_max_abs_err", "pred_rms_err", "mse_max_abs_err"), limits) if r[key] > limit]


def compare_vp(rows, ref_rows, limits=VP_TEST_LIMITS) -> dict:
    """Phase 9's rows against the plain path's: within ``limits``
    (``vp_faults``), tile metrics equal wherever the pixels agree, values
    finite and in [0, 1]."""
    r = vp_readings(rows, ref_rows)
    faults = vp_faults(r, limits)
    if faults or not (r["metrics_equal"] and r["in_range"]):
        raise AssertionError(f"vp_test: the kernels' rows differ from the plain path's: "
                             f"{'; '.join(faults)} (readings {r})")
    return r


def vp_test_phase(dev, counters, bf16: bool = False):
    """``run_models --test``'s loop over the test splits' shape with seeded
    full-width weights, then the same loop through the plain versions.
    With ``bf16``, ``run_models --test --bf16`` (phase 9b): K8's bf16 mode,
    the rows held to the plain path at VP_BF16_TEST_LIMITS (bf16 roundings
    of P flip where the two sum in another order, and the fed-back decode
    steps grow the flips), and the plain path at f32 compute from the same
    weights as the control, which must break one of them."""
    from mansy_immersivevideostreaming_torch.cli import run_models
    from mansy_immersivevideostreaming_torch.config import default_config
    from mansy_immersivevideostreaming_torch.data.viewport import build_windowed_dataset
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    from mansy_immersivevideostreaming_torch.kernels import tile_occupancy as K7
    from mansy_immersivevideostreaming_torch.models import transformer
    from mansy_immersivevideostreaming_torch.utils import results
    from mansy_immersivevideostreaming_torch.utils.results import Results

    config = default_config()
    args = run_models.build_parser().parse_args(["--test", "--seed", str(VP_SEED)]
                                                + (["--bf16"] if bf16 else []))
    vsplit, usplit = config.video_split["Jin2022"], config.user_split["Jin2022"]
    m = min(len(usplit["valid"]), len(usplit["test"]))  # create_datasets' split rule
    length = 60 * config.frequency   # the test videos' 60 s at 5 Hz
    sets = {}
    for i, (split, users) in enumerate((("test_seen", usplit["valid"][:m]),
                                        ("test_unseen", usplit["test"][:m]))):
        P = len(vsplit["test"]) * len(users)
        sets[split] = build_windowed_dataset(
            config, "Jin2022", vsplit["test"], users, args.his_window, args.fut_window,
            config.trim_head, config.trim_tail, config.sample_step, config.frequency,
            packed=(synthetic_traces(P, length, 20 + i), np.full(P, length, np.int32)))
    sizes = {split: len(ds) for split, ds in sets.items()}
    if sizes != {"test_seen": 2430, "test_unseen": 2430}:
        raise AssertionError(f"vp_test: splits of {sizes} trajectories")
    model = seeded_mtio(dev, VP_SEED, torch.bfloat16 if args.bf16 else torch.float32)
    sample_fn = run_models.make_sample_fn(args, model)
    book = lambda: Results("mtio", fut_window=args.fut_window, output_dir="unused",
                           dataset_frequency=config.frequency)
    notebook = book()

    def run():
        notebook.reset()
        return sum(run_models.test_split(sample_fn, ds, args.bs, notebook, dev)
                   for ds in sets.values())

    run()  # warm-up
    batches = sum(-(-n // args.bs) for n in sizes.values())
    n, seconds, launches = timed_passes(
        run, counters, expect(counters, attention=attention_launches(args) * batches,
                              trajectory_metrics=batches), VP_PASSES)
    # where a batch's time goes: sampling and recording one batch of 512
    h, c, f, video, user, ts = sets["test_seen"].gather(np.arange(args.bs))
    h, c, f = (torch.as_tensor(x, device=dev) for x in (h, c, f))
    probe = book()
    profiled = profile_update(lambda: probe.record(sample_fn(h, c), f, video, user, ts), 1)
    plain = book()
    with mock.patch.object(transformer, "attention", K8.attention_plain), \
            mock.patch.object(results, "trajectory_metrics", K7.trajectory_metrics_plain):
        for ds in sets.values():
            run_models.test_split(sample_fn, ds, args.bs, plain, dev)
    if bf16:
        check = compare_vp(notebook._rows, plain._rows, VP_BF16_TEST_LIMITS)
        # the control: the plain path at f32 compute, from the same weights,
        # must break a limit of VP_BF16_TEST_LIMITS
        f32_model = seeded_mtio(dev, VP_SEED)
        f32_model.load_state_dict(model.state_dict())
        f32_book = book()
        with mock.patch.object(transformer, "attention", K8.attention_plain), \
                mock.patch.object(results, "trajectory_metrics", K7.trajectory_metrics_plain):
            for ds in sets.values():
                run_models.test_split(run_models.make_sample_fn(args, f32_model), ds, args.bs,
                                      f32_book, dev)
        control = vp_readings(notebook._rows, f32_book._rows)
        control["limits_broken"] = vp_faults(control, VP_BF16_TEST_LIMITS)
        if not control["limits_broken"]:
            raise AssertionError(f"vp_test: the bf16 limits do not tell the bf16 predictions "
                                 f"from the f32 plain path's ({control})")
        check["control_f32_plain"] = control
    else:
        check = compare_vp(notebook._rows, plain._rows)
    rate = rate_stats(n, seconds)
    return dict(trajectories=n, batches=batches, steps=batches, batch=args.bs, passes=VP_PASSES,
                seconds=seconds, trajectories_per_s_median=rate["median"],
                trajectories_per_s_min=rate["min"], trajectories_per_s_max=rate["max"],
                spread=rate["spread"], batch_profile=profiled,
                mean_accuracy=notebook.mean_accuracy(), kernels_vs_plain=check,
                launches=launches)


def vp_export_phase(dev, counters):
    """``predict.run`` over the merged split's shape: trace files in the
    dataset schema and the weights' npz under a temporary directory, the
    pickles written there and read back through ``data/prediction.py``."""
    from mansy_immersivevideostreaming_torch.cli import predict
    from mansy_immersivevideostreaming_torch.config import default_config
    from mansy_immersivevideostreaming_torch.data.prediction import load_prediction_tables
    from mansy_immersivevideostreaming_torch.utils.checkpoint import save_mtio_npz

    with tempfile.TemporaryDirectory() as tmp:
        config = default_config(datasets_base_dir=tmp, results_base_dir=os.path.join(tmp, "r"),
                                models_base_dir=os.path.join(tmp, "m"))
        videos, users = set(), set()
        for split in ("train", "valid", "test"):
            videos |= set(config.video_split["Jin2022"][split])
            users |= set(config.user_split["Jin2022"][split])
        videos, users = sorted(videos), sorted(users)
        t0 = time.time()
        for v in videos:
            length = config.video_info["Jin2022"][v][0] * config.frequency
            vdir = os.path.join(config.viewport_dir("Jin2022"), f"video{v}",
                                f"{config.frequency}Hz")
            os.makedirs(vdir)
            times = np.arange(length, dtype=np.float32)[:, None] / config.frequency
            for u, xy in zip(users, synthetic_traces(len(users), length, 100 + v)):
                np.save(os.path.join(vdir, f"simple_{config.frequency}Hz_user{u}.npy"),
                        np.concatenate([times, xy], 1))
        npz = os.path.join(tmp, "best_model.npz")
        save_mtio_npz(npz, seeded_mtio(dev, VP_SEED))
        setup_s = time.time() - t0
        stats = []

        def run():
            args = predict.build_parser().parse_args(["--model-path", npz, "--seed",
                                                      str(VP_SEED)])
            with contextlib.redirect_stdout(sys.stderr):
                stats.append(predict.run(args, config))

        args = predict.build_parser().parse_args([])
        n = sum(len(range(config.trim_head, config.video_info["Jin2022"][v][0] * config.frequency
                          - config.trim_tail, config.sample_step)) for v in videos) * len(users)
        batches = -(-n // args.bs)
        _, seconds, launches = timed_passes(
            run, counters, expect(counters, attention=attention_launches(args) * batches,
                                  chunk_maps=batches), VP_PASSES)
        if any(s["trajectories"] != n for s in stats) or n != 77520:
            raise AssertionError(f"vp_export: {[s['trajectories'] for s in stats]} trajectories, "
                                 f"expected {n} (77,520)")
        tables = load_prediction_tables(config, "Jin2022", videos, users)
        chunks = int((tables.accuracy > 0).sum())
        acc = tables.accuracy[tables.gt.any(-1)]
        if not ((tables.start_chunk == config.trim_head // config.frequency).all()
                and np.isfinite(acc).all() and (acc >= 0).all() and (acc <= 1).all()
                and acc.size == n):
            raise AssertionError("vp_export: the pickles do not read back as written")
        files = len(os.listdir(os.path.join(config.viewport_dir("Jin2022"), "prediction")))
    rate = rate_stats(n, [s["loop_seconds"] for s in stats])
    return dict(trajectories=n, batches=batches, steps=batches, batch=args.bs,
                passes=VP_PASSES, setup_seconds=setup_s, pass_seconds=seconds,
                loop_seconds=[s["loop_seconds"] for s in stats],
                trajectories_per_s_median=rate["median"], trajectories_per_s_min=rate["min"],
                trajectories_per_s_max=rate["max"], spread=rate["spread"],
                pairs=len(videos) * len(users), video_dirs=files, chunks_read_back=int(acc.size),
                chunks_with_overlap=chunks, mean_iou=float(acc.mean()), launches=launches)


# ---------------------------------------------------------------- phase 11

def vp_train_data(args, n: int, seed: int, dev) -> dict:
    """[n] windows of seeded synthetic head traces on the card: history,
    current and future of ``run_models``' widths."""
    M, F = args.his_window, args.fut_window
    xy = torch.as_tensor(synthetic_traces(n, M + 1 + F, seed), device=dev)
    return {"history": xy[:, :M].contiguous(), "current": xy[:, M:M + 1].contiguous(),
            "future": xy[:, M + 1:].contiguous()}


@contextlib.contextmanager
def deterministic_algorithms():
    """PyTorch's deterministic algorithms inside the block (cuDNN's
    convolutions, CUDA index accumulation; cuBLAS with the workspace that
    ``main`` sets): without them two runs of one path's gradient differ by
    atomics in the distillation layer's backward and the slot gathers', a
    noise that is no part of what phase 11 compares."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


class Kinks:
    """The branches an MTIO training step takes where its function has a
    kink: the feed-forward's ReLU (``models/transformer.py``), the
    distillation's max pool, and the periodic MSE's nearest image
    (``ops/geometry.py:periodic_mse``, through ``models/mtio.py``).  Two
    paths whose sums differ by an ulp can land on two sides of a near-tie
    there, and a gradient that flows through another branch differs by that
    entry's whole share, not by an ulp.  Built without ``recorded``, the
    step's branches are kept (each later pass must take the same ones);
    with a record, each call takes the recorded branch, and ``flips``
    counts the entries where its own would differ, with the largest
    ``margin``: how far the flipped entry lies from its tie, as a share of
    the call's largest input magnitude."""

    def __init__(self, recorded=None):
        self.recorded = recorded
        self.calls = [] if recorded is None else recorded
        self.cursor, self.entries, self.flips, self.margin = 0, 0, {}, 0.0

    @contextlib.contextmanager
    def patched(self):
        """One forward (and its loss) with the kinks routed through here."""
        from mansy_immersivevideostreaming_torch.models import mtio, transformer
        shim = types.SimpleNamespace(**{k: getattr(torch.nn.functional, k)
                                        for k in dir(torch.nn.functional)
                                        if not k.startswith("__")})
        shim.relu, shim.max_pool1d = self.relu, self.max_pool1d
        self.cursor, self.entries, self.flips, self.margin = 0, 0, {}, 0.0
        with (mock.patch.object(transformer, "F", shim),
              mock.patch.object(mtio, "periodic_mse", self.periodic_mse)):
            yield self
        if self.cursor != len(self.calls):
            raise AssertionError(f"kinks: {self.cursor} calls of {len(self.calls)} recorded")

    def _take(self, kind: str, own: torch.Tensor):
        """The branch to take where ``own`` is this pass's, and the entries
        where the two differ (None when recording)."""
        self.entries += own.numel()
        if self.cursor == len(self.calls):
            if self.recorded is not None:
                raise AssertionError(f"kinks: more calls than recorded ({kind})")
            self.calls.append((kind, own))
        recorded_kind, taken = self.calls[self.cursor]
        self.cursor += 1
        if recorded_kind != kind or taken.shape != own.shape:
            raise AssertionError(f"kinks: call {self.cursor} is {kind} {tuple(own.shape)}, "
                                 f"recorded {recorded_kind} {tuple(taken.shape)}")
        if self.recorded is None:
            if not torch.equal(taken, own):
                raise AssertionError(f"kinks: a pass took other branches ({kind})")
            return taken, None
        return taken, taken != own

    def _count(self, kind: str, flip, gap: torch.Tensor, scale: torch.Tensor) -> None:
        n = int(flip.sum())
        if n:
            self.flips[kind] = self.flips.get(kind, 0) + n
            self.margin = max(self.margin, float(gap[flip].max() / scale))

    def relu(self, x, inplace: bool = False):
        out = torch.nn.functional.relu(x)
        taken, flip = self._take("relu", (x > 0).detach())
        if flip is None:
            return out
        self._count("relu", flip, x.detach().abs(), x.detach().abs().amax())
        return torch.where(flip, torch.where(taken, x, 0.0), out)

    def max_pool1d(self, x, kernel_size, stride=None, padding=0, **kw):
        out, own = torch.nn.functional.max_pool1d(x, kernel_size, stride=stride,
                                                  padding=padding, return_indices=True, **kw)
        taken, flip = self._take("max_pool", own)
        if flip is None:
            return out
        forced = x.gather(-1, taken)
        self._count("max_pool", flip, (out - forced).detach(), x.detach().abs().amax())
        return torch.where(flip, forced, out)

    def periodic_mse(self, a, b, dimension: int = 2):
        """``ops/geometry.py:periodic_mse``'s expression, the nearest of the
        three images as a branch."""
        images = torch.stack([(a - b).abs(), (a + 1.0 - b).abs(), (a - 1.0 - b).abs()])
        err = torch.minimum(torch.minimum(images[0], images[1]), images[2])
        near = images.detach()
        own = torch.where(near[2] < torch.minimum(near[0], near[1]), 2,
                          torch.where(near[1] < near[0], 1, 0))
        taken, flip = self._take("periodic", own)
        if flip is not None:
            forced = images.gather(0, taken[None])[0]
            self._count("periodic", flip, (forced - err).detach(), near[0].amax())
            err = torch.where(flip, forced, err)
        return (err * err).sum(-1) / dimension

    def summary(self) -> dict:
        return dict(calls=len(self.calls), entries=self.entries, flips=self.flips,
                    largest_margin=self.margin)


def vp_step(model, opt, batch, seed: int, perms, repeat, plain: bool, kinks=None) -> dict:
    """One ``vp_train.train_step`` from ``model``'s weights and a fresh
    train state, through the kernels or (``plain``) K8's plain version
    (``mock.patch``): its loss and gradients (on one copy of the model) and
    its parameters after AdamW and BatchNorm statistics (on another).  With
    ``kinks`` (:class:`Kinks`), both passes record or take its branches."""
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    from mansy_immersivevideostreaming_torch.models import transformer
    from mansy_immersivevideostreaming_torch.models import vp_train as TV

    dev = batch["history"].device
    state = TV.create_train_state(model)
    branches = kinks.patched if kinks is not None else contextlib.nullcontext
    with (mock.patch.object(transformer, "attention", K8.attention_plain) if plain
          else contextlib.nullcontext()):
        m = copy.deepcopy(model)
        with branches():
            pred, gt = m(batch["history"], batch["current"], batch["future"], train=True,
                         perms=perms, repeat=repeat,
                         generator=TV.step_generator(seed, state.step, dev))
            loss = m.loss_function(pred, gt)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        stepped = copy.deepcopy(model)
        with branches():
            TV.train_step(stepped, opt, state, batch, seed, perms, repeat)
    return dict(loss=float(loss.detach()), grads=grads, params=[p.detach() for p in stepped.parameters()],
                stats=list(stepped.transformer.distill.bn.buffers()))


def vp_step_readings(got: dict, ref: dict, names, limits) -> dict:
    """How far one step (``vp_step``) lies from another, ``ref``, under the
    ``limits`` (loss rtol, gradient rtol, gradient share, gradient floor,
    loose share): the loss's relative error; each gradient leaf's largest
    excess over the gradient rtol, as a share of its scale, the larger of
    the leaf's largest entry and the floor's share of the model's (the key
    biases and the convolution's bias before BatchNorm have a gradient of 0
    but for float noise; a floor of 1 scales every leaf by the model's
    largest entry); after AdamW, whose
    first step is about lr * sign(g), the largest difference of a parameter
    whose two gradients agree to 1% (Adam's step then differs by at most
    lr / 400), and the share of the others beyond VP_PARAM_ATOL (gradients
    near 0, or of two signs)."""
    _, grad_rtol, _, floor, _ = limits
    top = max(float(g.abs().max()) for g in ref["grads"])
    shares, at = {}, {}
    for name, a, b in zip(names, got["grads"], ref["grads"]):
        excess = (a - b).abs() - grad_rtol * b.abs()
        i = int(excess.argmax())  # the leaf's worst entry, flat
        shares[name] = float(excess.reshape(-1)[i]) / max(float(b.abs().max()), floor * top)
        at[name] = dict(index=[int(v) for v in np.unravel_index(i, tuple(a.shape))],
                        kernels=float(a.reshape(-1)[i]), plain=float(b.reshape(-1)[i]))
    sure_err, tight, loose, flipped, total = 0.0, 0, 0, 0, 0
    for ga, gb, pa, pb in zip(got["grads"], ref["grads"], got["params"], ref["params"]):
        sure = (ga - gb).abs() <= 0.01 * gb.abs()
        diff = (pa - pb).abs()
        sure_err = max(sure_err, float(diff[sure].max()) if bool(sure.any()) else 0.0)
        tight += int(sure.sum())
        loose += int((~sure & (diff > VP_PARAM_ATOL)).sum())
        flipped += int((ga.sign() != gb.sign()).sum())
        total += diff.numel()
    worst = sorted(shares, key=shares.get, reverse=True)[:3]
    return dict(loss=got["loss"], ref_loss=ref["loss"],
                loss_rel_err=abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
                grad_share=shares[worst[0]], grad_share_leaves={n: shares[n] for n in worst},
                grad_worst=dict(leaf=worst[0], **at[worst[0]]),
                grad_max_abs_err=max(float((a - b).abs().max())
                                     for a, b in zip(got["grads"], ref["grads"])),
                param_max_abs_err=sure_err, params_compared=tight,
                params_beyond_atol_share=loose / total, gradient_signs_differing=flipped,
                params_total=total,
                batch_stats_max_abs_err=max(float((a - b).abs().max())
                                            for a, b in zip(got["stats"], ref["stats"])))


def vp_step_faults(r: dict, limits) -> list:
    """The ``limits`` (those of ``vp_step_readings``) that its readings ``r``
    break; parameters whose gradients agree to 1% are held to
    VP_PARAM_ATOL.  A gradient fault names the leaf and its worst entry with
    the two paths' values there."""
    loss_rtol, _, grad_share, _, loose = limits
    worst = r["grad_worst"]
    return [what for what, bad in (
        (f"loss {r['loss_rel_err']} > {loss_rtol}", not r["loss_rel_err"] <= loss_rtol),
        (f"gradient share {r['grad_share']} > {grad_share} at {worst['leaf']}{worst['index']}: "
         f"kernels {worst['kernels']} against plain {worst['plain']}",
         not r["grad_share"] <= grad_share),
        (f"parameters {r['param_max_abs_err']} > {VP_PARAM_ATOL}",
         r["param_max_abs_err"] > VP_PARAM_ATOL),
        (f"{r['params_beyond_atol_share']} of the parameters beyond {VP_PARAM_ATOL} > {loose}",
         r["params_beyond_atol_share"] > loose),
        (f"a flipped branch {r['kinks']['largest_margin'] if 'kinks' in r else 0} from its tie "
         f"> {VP_KINK_MARGIN}", "kinks" in r and not r["kinks"]["largest_margin"] <= VP_KINK_MARGIN)
    ) if bad]


@deterministic_algorithms()
def compare_vp_steps(model, opt, batch, seed: int, f32_model=None) -> dict:
    """One ``vp_train.train_step`` from the same weights, generator seed (so
    the same dropout masks), slot permutations and repeat draw through the
    kernels and through K8's plain version, each under PyTorch's
    deterministic algorithms (``deterministic_algorithms``), so that the two
    differ only by the attention's implementation, held at the limits of
    ``vp_step_faults``.  In f32 the plain path takes the kernels' branches
    at the model's kinks (:class:`Kinks`; each flipped branch within
    VP_KINK_MARGIN of its tie): where an ulp of K8 flips a near-tie ReLU or
    max-pool window, the gradient through it differs by that entry's whole
    share (H100 readings on the plain path's own branches, ``own_branches``,
    shown and not held: 8e-8 to 2.1e-4 of the largest entry, and each one
    past 1e-6 that was counted had a flip; forced, 4e-8 to 5.4e-7; PERF.md
    section 6).
    VP_LIMITS: the loss to VP_LOSS_RTOL, each gradient entry to VP_GRAD_RTOL
    relative plus VP_GRAD_RTOL of the model's largest entry,
    VP_PARAM_LOOSE of the parameters beyond VP_PARAM_ATOL.  A bf16
    ``model`` (phase 11b) comes with ``f32_model``, its weights at f32
    compute: the two bf16 paths part by bf16 roundings that flip where K8
    and its plain version sum in another order, held at VP_BF16_LIMITS; and
    the same check of the bf16 step through the kernels against the f32
    plain path must fail (the control: the limits tell a path without
    bf16's roundings apart)."""
    dev = batch["history"].device
    perms, repeat = model.draw_slots(batch["history"].shape[0],
                                     torch.Generator(device=dev).manual_seed(seed), dev)
    names = [n for n, _ in model.named_parameters()]
    bf16 = f32_model is not None
    limits = VP_BF16_LIMITS if bf16 else VP_LIMITS
    kinks = None if bf16 else Kinks()
    got = vp_step(model, opt, batch, seed, perms, repeat, False, kinks)
    forced = None if bf16 else Kinks(kinks.calls)
    readings = vp_step_readings(got, vp_step(model, opt, batch, seed, perms, repeat, True, forced),
                                names, limits)
    if not bf16:  # the plain path on its own branches: shown, not held
        free = vp_step_readings(got, vp_step(model, opt, batch, seed, perms, repeat, True),
                                names, limits)
        readings.update(kinks=forced.summary(), own_branches={
            k: free[k] for k in ("loss_rel_err", "grad_share", "grad_worst")})
    faults = vp_step_faults(readings, limits)
    if faults:
        raise AssertionError(f"vp_train: the kernels' step differs from the plain path's: "
                             f"{'; '.join(faults)}")
    if not bf16:
        return dict(readings, repeat=bool(repeat))
    control = vp_step_readings(got, vp_step(f32_model, opt, batch, seed, perms, repeat, True),
                               names, limits)
    control["limits_broken"] = vp_step_faults(control, limits)
    if not control["limits_broken"]:
        raise AssertionError("vp_train: the bf16 limits do not tell the bf16 step from the f32 "
                             f"plain path's ({control})")
    return dict(readings, repeat=bool(repeat), control_f32_plain=control)


def vp_train_phase(dev, counters, bf16: bool = False):
    """``run_models --train``'s epoch (``vp_train.train_epoch``) at its
    defaults (d 512, 2 + 2 layers, 8 x 64 heads, bs 512, fut 15, his 5, the
    KV-cached autoregressive decode, dropout on, AdamW lr 1e-4) from Flax's
    initialisers, over VP_TRAIN_BATCHES batches of seeded synthetic
    trajectories: a warm-up epoch, VP_PASSES timed epochs, then one
    ``--teacher-forcing`` epoch; one step profiled; one step through the
    kernels against the plain path; a validation pass (``valid_step``, K8's
    serving mode) on the trained weights; the first step at ``--his-window
    96`` against the plain path.  With ``bf16``, ``run_models --train
    --bf16`` (phase 11b): K8's bf16 modes, the step held to the plain path at
    ``compare_vp_steps``' bf16 limits, no --his-window 96 step."""
    from mansy_immersivevideostreaming_torch.cli import run_models
    from mansy_immersivevideostreaming_torch.models import vp_train as TV

    args = run_models.build_parser().parse_args(["--train", "--seed", str(VP_SEED)]
                                                + (["--bf16"] if bf16 else []))
    n = VP_TRAIN_BATCHES * args.bs
    data = vp_train_data(args, n, 40, dev)
    model = run_models.build_model(args, dev).init_like_flax(
        torch.Generator(device=dev).manual_seed(args.seed))
    opt = TV.make_optimizer(args.lr, 0.01 if args.weight_decay is None else args.weight_decay)
    rng = np.random.default_rng(args.seed)
    carry = {"state": TV.create_train_state(model)}
    losses = []

    def epoch(m, key):
        carry[key], epoch_losses = TV.train_epoch(m, opt, carry[key], data, args.bs,
                                                  rng.permutation(n), args.seed)
        losses.append(epoch_losses.cpu())  # the epoch's one sync

    epoch(model, "state")  # warm-up
    per_step = attention_launches(args)
    _, seconds, launches = timed_passes(
        lambda: epoch(model, "state"), counters,
        expect(counters, attention_train_forward=per_step * VP_TRAIN_BATCHES,
               attention_backward=per_step * VP_TRAIN_BATCHES), VP_PASSES)
    rate = rate_stats(n, seconds)
    # --teacher-forcing: the same weights, its own AdamW state
    tf_model = copy.deepcopy(model)
    tf_model.teacher_forcing = True
    carry["tf"] = TV.create_train_state(tf_model)
    epoch(tf_model, "tf")  # warm-up
    tf_launches = 3 * args.block_num  # the encoder's layers, each decoder layer's two
    _, tf_seconds, tf_counts = timed_passes(
        lambda: epoch(tf_model, "tf"), counters,
        expect(counters, attention_train_forward=tf_launches * VP_TRAIN_BATCHES,
               attention_backward=tf_launches * VP_TRAIN_BATCHES), 1)
    flat = torch.cat(losses)
    if not bool(torch.isfinite(flat).all()):
        raise AssertionError("vp_train: non-finite losses")
    # where a step's time goes, then the kernels against the plain path
    batch = {k: v[:args.bs] for k, v in data.items()}
    step = {"state": carry["state"]}

    def one_step():
        step["state"], _ = TV.train_step(model, opt, step["state"], batch, args.seed)

    profiled = profile_update(one_step, 1)
    f32_model = None
    if bf16:  # the control: the same weights at f32 compute
        f32_model = run_models.build_model(
            run_models.build_parser().parse_args(["--train", "--seed", str(VP_SEED)]), dev)
        f32_model.load_state_dict(model.state_dict())
    check = compare_vp_steps(model, opt, batch, args.seed, f32_model)
    # validation on the trained weights, K8's serving mode
    valid = vp_train_data(args, 4 * args.bs, 41, dev)
    mses = [float(TV.valid_step(model, {k: v[i:i + args.bs] for k, v in valid.items()}))
            for i in range(0, 4 * args.bs, args.bs)]
    if not all(math.isfinite(m) for m in mses):
        raise AssertionError(f"vp_train: non-finite validation MSE {mses}")
    result = dict(samples=n, batches=VP_TRAIN_BATCHES, steps=VP_TRAIN_BATCHES, batch=args.bs,
                  passes=VP_PASSES, seconds=seconds, samples_per_s_median=rate["median"],
                  samples_per_s_min=rate["min"], samples_per_s_max=rate["max"],
                  spread=rate["spread"], teacher_forcing_seconds=tf_seconds[0],
                  teacher_forcing_samples_per_s=n / tf_seconds[0],
                  teacher_forcing_launches=tf_counts,
                  first_epoch_loss=float(losses[0].mean()),
                  last_epoch_loss=float(losses[-2].mean()),
                  teacher_forcing_epoch_loss=float(losses[-1].mean()),
                  train_step_profile=profiled, kernels_vs_plain=check, valid_mse=mses,
                  peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches)
    if bf16:
        return result
    # --his-window 96: the encoder's attention is 96 x 96 and the decoder's
    # cross-attention sees the distilled 48, past the earlier backward's 64
    # rows and keys: the first step from Flax's initialisers through the
    # kernels against the plain path, then a step timed after a warm-up
    wide_args = run_models.build_parser().parse_args(
        ["--train", "--seed", str(VP_SEED), "--his-window", "96"])
    wide_model = run_models.build_model(wide_args, dev).init_like_flax(
        torch.Generator(device=dev).manual_seed(wide_args.seed))
    wide_batch = vp_train_data(wide_args, wide_args.bs, 42, dev)
    wide_check = compare_vp_steps(wide_model, opt, wide_batch, wide_args.seed)
    wide_state = TV.create_train_state(wide_model)
    wide_step = lambda: TV.train_step(wide_model, opt, wide_state, wide_batch, wide_args.seed)
    wide_step()  # warm-up
    (_, wide_loss), wide_seconds, wide_launches = timed_passes(
        wide_step, counters, expect(counters, attention_train_forward=per_step,
                                    attention_backward=per_step), 1)
    result["his_window_96"] = dict(
        his_window=wide_args.his_window, encoder_attention=[wide_args.his_window] * 2,
        cross_attention_keys=wide_args.his_window // 2, step_seconds=wide_seconds[0],
        loss=float(wide_loss), launches=wide_launches, kernels_vs_plain=wide_check,
        k8_device_ms=attention_kernel_ms(wide_step))
    result["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return result


def path_turns(run, parent) -> dict:
    """One pass of a path, ``run()``, on the host clock (ended by a sync)
    with the parent commit's K8 in ``models/transformer.py`` and with this
    tree's, in turns (parent, this, this, parent; a parent pass first, so
    its kernels are built and warm): ``earlier_seconds``, the parent's
    mean, and the four readings."""
    from mansy_immersivevideostreaming_torch.models import transformer

    def timed(theirs: bool) -> float:
        with (mock.patch.object(transformer, "attention", parent.attention.attention) if theirs
              else contextlib.nullcontext()):
            return synced_seconds(run)[1]

    timed(True)
    turns = [timed(True), timed(False), timed(False), timed(True)]
    return dict(earlier_seconds=(turns[0] + turns[3]) / 2,
                seconds_turns_parent_this_this_parent=turns)


def vp_test_long_phase(dev, counters, parent=None):
    """``run_models --test --his-window 5000 --trim-head 5000`` (every history
    inside its trace) over one batch of LONG_TEST_BATCH windows (reduced from
    512), one a seeded synthetic trace, with seeded full-width MTIO weights:
    the encoder's attention is 5000 x 5000 (K8's streamed kernel), the
    decode's cross-attention sees the distilled 2500 (the row kernel).  The
    batch is timed once after a warm-up; its first LONG_HELD samples are held
    against the plain path (K8 swapped for its plain version) at VP_ATOL; the
    metrics must be finite.  With ``parent``, the batch also in turns with
    the parent commit's K8 (:func:`path_turns`)."""
    from mansy_immersivevideostreaming_torch.cli import run_models
    from mansy_immersivevideostreaming_torch.config import default_config
    from mansy_immersivevideostreaming_torch.data.viewport import build_windowed_dataset
    from mansy_immersivevideostreaming_torch.kernels import attention as K8
    from mansy_immersivevideostreaming_torch.models import transformer
    from mansy_immersivevideostreaming_torch.utils.results import Results

    config = default_config()
    args = run_models.build_parser().parse_args(
        ["--test", "--seed", str(VP_SEED), "--his-window", str(LONG_HIS), "--trim-head",
         str(LONG_HIS), "--bs", str(LONG_TEST_BATCH)])
    length = args.his_window + 1 + args.fut_window  # one window a trace, at t = --trim-head
    pairs = (4, LONG_TEST_BATCH // 4)
    ds = build_windowed_dataset(
        config, "Jin2022", list(range(pairs[0])), list(range(pairs[1])), args.his_window,
        args.fut_window, args.trim_head, config.trim_tail, config.sample_step, config.frequency,
        packed=(synthetic_traces(LONG_TEST_BATCH, length, 30),
                np.full(LONG_TEST_BATCH, length, np.int32)))
    if len(ds) != LONG_TEST_BATCH:
        raise AssertionError(f"vp_test_long: {len(ds)} windows")
    model = seeded_mtio(dev, VP_SEED)
    sample_fn = run_models.make_sample_fn(args, model)
    notebook = Results("mtio", fut_window=args.fut_window, output_dir="unused",
                       dataset_frequency=config.frequency)

    def run():
        notebook.reset()
        return run_models.test_split(sample_fn, ds, args.bs, notebook, dev)

    run()  # warm-up
    n, seconds, launches = timed_passes(
        run, counters, expect(counters, attention=attention_launches(args),
                              trajectory_metrics=1), 1)
    pred, metrics = stack_rows(notebook._rows)
    if not (np.isfinite(pred).all() and np.isfinite(metrics).all()):
        raise AssertionError("vp_test_long: non-finite predictions or metrics")
    h, c, *_ = ds.gather(np.arange(LONG_HELD))
    with mock.patch.object(transformer, "attention", K8.attention_plain):
        plain = sample_fn(*(torch.as_tensor(x, device=dev) for x in (h, c))).cpu().numpy()
    err = float(np.abs(pred[:LONG_HELD] - plain).max())
    if not err <= VP_ATOL:
        raise AssertionError(f"vp_test_long: the first {LONG_HELD} predictions differ from the "
                             f"plain path's by {err} > {VP_ATOL}")
    turns = path_turns(run, parent) if parent is not None else {}
    return dict(**turns, trajectories=n, batches=1, steps=1, batch=args.bs,
                his_window=args.his_window,
                encoder_attention=[args.his_window] * 2,
                cross_attention_keys=-(-args.his_window // 2),
                reduced=dict(bs=f"{LONG_TEST_BATCH} (from {VP_BATCH}): the encoder's q, k and v "
                                f"at 512 would be 655 MB each, the plain check's scores 26 GB",
                             held_against_plain=f"the first {LONG_HELD} samples"),
                seconds=seconds[0], trajectories_per_s=n / seconds[0],
                pred_max_abs_err_held=err, mean_accuracy=notebook.mean_accuracy(),
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches)


def vp_train_long_phase(dev, counters, parent=None):
    """``run_models --train --his-window 5000`` at --bs LONG_TRAIN_BATCH
    (reduced from 512: the encoder's keep mask alone would be 512 x 8 x
    5000^2 bytes, 102 GB): the first step from Flax's initialisers through
    the kernels against the plain path (``compare_vp_steps``; the encoder's
    training forward on K8's streamed kernel, its backward on the split
    kernels over 5000 keys), then one step timed after a warm-up and one
    profiled (``vp_train_step_path``'s ``profile``); with ``parent`` the step
    also in turns with the parent commit's K8."""
    from mansy_immersivevideostreaming_torch.cli import run_models

    args = run_models.build_parser().parse_args(
        ["--train", "--seed", str(VP_SEED), "--his-window", str(LONG_HIS), "--bs",
         str(LONG_TRAIN_BATCH)])
    result, _ = vp_train_step_path(dev, counters, args, 43, dict(
        bs=f"{LONG_TRAIN_BATCH} (from {VP_BATCH}): the encoder's keep mask at 512 would be "
           f"512 x 8 x 5000^2 bytes, 102 GB"), profile=True, parent=parent)
    return dict(result, encoder_attention=[args.his_window] * 2,
                cross_attention_keys=-(-args.his_window // 2))


def vp_train_wide_phase(dev, counters, parent=None):
    """``run_models --train --hidden-dim 4096`` (8 heads of 512: K8's wide
    kernels) at bs 512: the first step from Flax's initialisers against the
    plain path (``compare_vp_steps``), one step timed after a warm-up, then
    a validation batch (``valid_step``: the serving kernels) whose MSE must
    be finite; then the same step at ``--his-window 96`` and bs WIDE_96_BATCH
    (``his_window_96``: an encoder attention of 96 x 96 and a cross-attention
    of 15 x 48, whose
    f32 backward runs on the tensor cores, csrc/attention_backward_wide.cu;
    the step profiled: ``step_profile``, K8's device ms in ``k8_device_ms``);
    with ``parent`` each step also in turns with the parent commit's K8."""
    from mansy_immersivevideostreaming_torch.cli import run_models
    from mansy_immersivevideostreaming_torch.models import vp_train as TV

    args = run_models.build_parser().parse_args(
        ["--train", "--seed", str(VP_SEED), "--hidden-dim", str(WIDE_HIDDEN)])
    result, model = vp_train_step_path(dev, counters, args, 44, {}, parent=parent)
    valid = vp_train_data(args, args.bs, 45, dev)
    mse, _, valid_launches = timed_passes(
        lambda: float(TV.valid_step(model, valid)), counters,
        expect(counters, attention=attention_launches(args)), 1)
    if not math.isfinite(mse):
        raise AssertionError(f"vp_train_wide: non-finite validation MSE {mse}")
    args96 = run_models.build_parser().parse_args(
        ["--train", "--seed", str(VP_SEED), "--hidden-dim", str(WIDE_HIDDEN), "--his-window",
         "96", "--bs", str(WIDE_96_BATCH)])
    his96, _ = vp_train_step_path(dev, counters, args96, 46, {"bs": WIDE_96_REDUCED},
                                  profile=True, parent=parent)
    for extra in (valid_launches, his96["launches"]):
        for row, n in extra.items():
            result["launches"][row] = result["launches"].get(row, 0) + n
    return dict(result, valid_mse=mse, valid_launches=valid_launches, his_window_96=his96)


def vp_train_step_path(dev, counters, args, seed: int, reduced: dict, profile: bool = False,
                       parent=None):
    """One ``run_models --train`` configuration's first step from Flax's
    initialisers held against the plain path (``compare_vp_steps``), then a
    step timed after a warm-up; the loss must be finite.  With ``profile``,
    a step under ``torch.profiler`` too (``step_profile``, K8's device ms in
    ``k8_device_ms``): K8's backward share of the device's busy time and
    the host's share of the step (the share the device is idle).  With
    ``parent``, the step in turns with the parent commit's K8
    (:func:`path_turns`).  Returns (the path's result, the trained model)."""
    from mansy_immersivevideostreaming_torch.cli import run_models
    from mansy_immersivevideostreaming_torch.models import vp_train as TV

    model = run_models.build_model(args, dev).init_like_flax(
        torch.Generator(device=dev).manual_seed(args.seed))
    opt = TV.make_optimizer(args.lr, 0.01 if args.weight_decay is None else args.weight_decay)
    batch = vp_train_data(args, args.bs, seed, dev)
    check = compare_vp_steps(model, opt, batch, args.seed)
    state = TV.create_train_state(model)
    step = lambda: TV.train_step(model, opt, state, batch, args.seed)
    step()  # warm-up
    per_step = attention_launches(args)
    (_, loss), seconds, launches = timed_passes(
        step, counters, expect(counters, attention_train_forward=per_step,
                               attention_backward=per_step), 1)
    if not math.isfinite(float(loss)):
        raise AssertionError(f"{args.his_window} / {args.hidden_dim}: non-finite loss")
    result = dict(steps=1, batch=args.bs, his_window=args.his_window, hidden_dim=args.hidden_dim,
                  heads=[8, args.hidden_dim // 8], reduced=reduced, step_seconds=seconds[0],
                  samples_per_s=args.bs / seconds[0], loss=float(loss), kernels_vs_plain=check,
                  peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches,
                  **(path_turns(step, parent) if parent is not None else {}))
    if profile:
        prof, k8 = profile_update(step, 1), attention_kernel_ms(step)
        captured = prof["device_captured"] and k8["device_captured"]
        result.update(step_profile=prof, k8_device_ms=k8,
                      backward_share_of_device=(k8["backward_ms"] / prof["device_busy_ms_per_step"]
                                                if captured else None),
                      host_share_of_step=1 - prof["busy_share"] if captured else None)
    return result, model


# K8's kernels by the names the profiler gives them: the forward's row,
# tile and streamed kernels, the backward's delta, row, tile, split and wide
# kernels (the f32 SIMT wide tile kernel is no template)
K8_KERNEL_NAMES = {"forward_row": ("attention_kernel<", "attention_row_wide_kernel<"),
                   "forward_tile": "attention_tile_kernel<",
                   "forward_stream": "attention_stream_kernel<",
                   "backward": ("delta_kernel<", "backward_row_kernel<", "backward_tile_kernel<",
                                "backward_dkv_kernel<", "backward_dq_kernel<",
                                "delta_wide_kernel<", "backward_row_wide_kernel<",
                                "backward_tile_wide_kernel(", "backward_wide_kernel<")}


def attention_kernel_ms(run) -> dict:
    """Device milliseconds of K8's kernels over one ``run()`` under
    ``torch.profiler``: the forward's row, tile and streamed kernels apart
    and together, the backward's kernels together, and their launches (None
    where the profiler saw no device event)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        return dict(device_captured=False)
    out = dict(device_captured=True)
    for key, names in K8_KERNEL_NAMES.items():
        names = names if isinstance(names, tuple) else (names,)
        hits = [e for e in device if any(n in e.name for n in names)]
        out[f"{key}_ms"] = sum(e.time_range.end - e.time_range.start for e in hits) / 1e3
        out[f"{key}_launches"] = len(hits)
    out["forward_ms"] = out["forward_row_ms"] + out["forward_tile_ms"] + out["forward_stream_ms"]
    return out


# ---------------------------------------------------------------- phase 14

def write_wu2017_raw(raw_dir: str, videos: int, users: int, seed: int) -> None:
    """The raw Wu2017 layout (``viewports/<user>/video_<i-1>.csv``: a header
    row, then idx, playback time and a unit quaternion q1..q4 a row) with
    12 s of seeded 30 Hz logs a file, as ``tests/test_wu2017_smoke.py``
    writes them."""
    rng = np.random.default_rng(seed)
    t = np.arange(0.0, 12.0, 1.0 / 30)
    for j in range(1, users + 1):
        udir = os.path.join(raw_dir, "viewports", str(j))
        os.makedirs(udir)
        for i in range(1, videos + 1):
            q = rng.normal(size=(t.size, 4))
            q /= np.linalg.norm(q, axis=1, keepdims=True)
            np.savetxt(os.path.join(udir, f"video_{i - 1}.csv"),
                       np.column_stack([np.arange(t.size), t, q]), fmt="%.6f", delimiter=",",
                       header="idx,time,q1,q2,q3,q4", comments="")


def preprocess_phase(dev) -> dict:
    """``preprocess_hmdtrace --dataset Wu2017 --preprocess`` (the quaternion
    math on the card, then the 5 Hz simplify) over the raw layout's full
    WU2017_SHAPE videos x users of synthetic logs, against the same CLI
    with ``--device cpu``: every output file read back equal to 1e-6; then
    ``preprocess_network`` over NETWORK_TRACES synthetic 4G ``.log`` traces.
    Wall seconds of each."""
    import dataclasses
    from mansy_immersivevideostreaming_torch.cli import preprocess_hmdtrace, preprocess_network
    from mansy_immersivevideostreaming_torch.config import default_config

    videos, users = WU2017_SHAPE
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_wu2017_raw(os.path.join(tmp, "raw"), videos, users, 14)
        setup_s = time.perf_counter() - t0
        outputs, seconds = {}, {}
        for device in ("cuda", "cpu"):
            base = default_config(datasets_base_dir=os.path.join(tmp, device))
            config = dataclasses.replace(
                base, raw_datasets_dir={"Wu2017": os.path.join(tmp, "raw")},
                viewport_datasets_dir={"Wu2017": os.path.join(tmp, device, "viewports")},
                video_num={**base.video_num, "Wu2017": videos},
                user_num={**base.user_num, "Wu2017": users})
            args = preprocess_hmdtrace.build_parser().parse_args(
                ["--dataset", "Wu2017", "--preprocess", "--device", device])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                preprocess_hmdtrace.run(args, config)
            torch.cuda.synchronize()
            seconds[device] = time.perf_counter() - t0
            root = config.viewport_dir("Wu2017")
            outputs[device] = {}
            for d, _, files in os.walk(root):
                for f in files:
                    path = os.path.join(d, f)
                    outputs[device][os.path.relpath(path, root)] = (
                        np.load(path) if f.endswith(".npy")
                        else np.loadtxt(path, delimiter=",", ndmin=2))
        if sorted(outputs["cuda"]) != sorted(outputs["cpu"]) or \
                len(outputs["cuda"]) != videos * users * 3:
            raise AssertionError(f"preprocess: {len(outputs['cuda'])} files on the card, "
                                 f"{len(outputs['cpu'])} on the CPU")
        err = max(float(np.abs(outputs["cuda"][k] - outputs["cpu"][k]).max())
                  for k in outputs["cpu"])
        if not err <= 1e-6:
            raise AssertionError(f"preprocess: the card's files differ from the CPU's by {err}")
        rows = int(sum(len(v) for k, v in outputs["cuda"].items() if k.endswith(".npy")))
        # preprocess_network over synthetic 4G traces
        traces, length = NETWORK_TRACES
        rng = np.random.default_rng(15)
        raw_net = os.path.join(tmp, "raw_network")
        os.makedirs(raw_net)
        for n in range(traces):
            volume = rng.integers(10_000, 5_000_000, length)
            with open(os.path.join(raw_net, f"trace_{n}.log"), "w") as f:
                f.writelines(f"{1_500_000_000 + i} {1000 * i} 51.{i} 4.{i} {volume[i]} 1000\n"
                             for i in range(length))
        config = dataclasses.replace(default_config(datasets_base_dir=os.path.join(tmp, "net")),
                                     raw_network_datasets_dir={"4G": raw_net})
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            preprocess_network.run(preprocess_network.build_parser().parse_args([]), config)
        network_s = time.perf_counter() - t0
        written = sorted(os.listdir(config.network_dir("4G")))
        if len(written) != 2 * traces:
            raise AssertionError(f"preprocess_network wrote {len(written)} files")
    return dict(wu2017_videos=videos, wu2017_users=users, raw_rows=videos * users * 360,
                simplified_rows=rows, setup_seconds=setup_s, hmdtrace_seconds_card=seconds["cuda"],
                hmdtrace_seconds_cpu=seconds["cpu"], card_vs_cpu_max_abs_err=err,
                network_traces=traces, network_seconds=network_s, steps=1, launches={})


# ---------------------------------------------------------------- phase 2e

def observe_simple_bytes(tables, state, width: int) -> int:
    """Bytes K2's simple mode must move: the lane state it reads (indices,
    the throughput history, the last rates and rebuffer time), the distinct
    chunk size slabs and predicted viewport rows, and the [N, 395] output."""
    V, C, R, T = tables.sizes.shape
    K, U = tables.past_k, tables.pred.shape[1]
    N = state.buf.shape[0]
    v, u, c = state.video, state.user, state.next_chunk
    return (N * (3 * 4 + K * 4 + 3 * 4 + width * 4)
            + n_unique(v, c, sizes=(V, C)) * R * T * 4
            + n_unique(v, u, c, sizes=(V, U, C)) * T * 4)


def simple_inputs(dev):
    """Tables of the train split's shape with one preference (run_simple_rl
    trains on one) and SERVE_CHUNK lanes 7 steps into their episodes."""
    from mansy_immersivevideostreaming_torch.kernels.env_step import env_step_plain
    from mansy_immersivevideostreaming_torch.rl.rollout import init_lanes
    from mansy_immersivevideostreaming_torch.sim.env import generate_environment_samples
    from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables

    V, U, NT, C, _ = TRAIN_SHAPE
    tables = synthetic_sim_tables(V, U, NT, C, 1, seed=0, device=dev)
    samples = torch.as_tensor(generate_environment_samples(V, U, NT, 1), device=dev)
    n = max(SIMPLE_WIDTHS)
    state = init_lanes(tables, samples, n, seed=3)
    rng = np.random.default_rng(3)
    for _ in range(7):
        acts = torch.as_tensor(rng.integers(0, 15, n).astype(np.int32), device=dev)
        state, *_ = env_step_plain(tables, samples, state, acts, n, True)
    return tables, state


def simple_kernel_phase(dev):
    """Phase 2e: the simple_rl modes at the A2C path's shapes, each against
    its plain version on the same card tensors (RTOL; K10 by
    ``grads_close``), two launches bit-equal, timed by CUDA events: K2's
    simple mode at 128 and 512 lanes (the train lanes and the test's lane
    chunk), K3 on the five-branch net (forward with sampling noise, and
    training mode) at 128 and 512 rows, K10 and K9's A2C mode at the
    minibatch of 512.  Returns the kernels' rows."""
    from mansy_immersivevideostreaming_torch.kernels import actor_critic as K3
    from mansy_immersivevideostreaming_torch.kernels import observe as K2
    from mansy_immersivevideostreaming_torch.kernels import policy_loss as K9
    from mansy_immersivevideostreaming_torch.models.abr_nets import SimpleActorCritic
    from mansy_immersivevideostreaming_torch.sim.env import tree_map

    tables, state = simple_inputs(dev)
    rows = {}

    # K2's simple mode
    cases = {}
    for n in SIMPLE_WIDTHS:
        sub = tree_map(lambda t: t[:n].contiguous(), state)
        x = K2.observe_simple_pack(tables, sub)
        ref = K2.observe_simple_pack_plain(tables, sub)
        if not bool(close(x, ref).all()):
            raise AssertionError(f"observe_simple_pack ({n} lanes) disagrees with its plain "
                                 "version")
        if not torch.equal(K2.observe_simple_pack(tables, sub), x):
            raise AssertionError(f"observe_simple_pack ({n} lanes): two launches differ")
        out = torch.empty_like(x)
        cases[str(n)] = dict(
            lanes=n, width=x.shape[1], plan=K2.observe_plan(n)._asdict(),
            max_abs_err=float((x - ref).abs().max()),
            **gpu_spread(lambda: K2.observe_simple_pack(tables, sub, out=out)),
            plain_ms=gpu_ms(lambda: K2.observe_simple_pack_plain(tables, sub), 5),
            bound_ms=1e3 * observe_simple_bytes(tables, sub, x.shape[1]) / HBM_BYTES_PER_S,
            write_floor_ms=gpu_ms(lambda: out.fill_(0.0)))
    main = cases[str(SIMPLE_LANES)]
    rows["observe_simple_pack"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in cases.values()), width=main["width"],
        **{k: main[k] for k in main if k.endswith("ms") or k.endswith("range")},
        bound_by="bytes", library_ms=None, cases=cases)

    # K3 on the five-branch net, forward and training mode
    torch.manual_seed(1)
    w = SimpleActorCritic(device=dev).packed_weights()
    x = K2.observe_simple_pack(tables, state)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    A = tables.action_space
    noise = K3.gumbel_noise((x.shape[0], A), gen, dev)
    fwd, trn, f_err, t_err = {}, {}, 0.0, 0.0
    for n in SIMPLE_WIDTHS:
        xs, ns = x[:n], noise[:n]
        got = K3.actor_critic_forward(w, xs, ns)
        ref = K3.actor_critic_forward_plain(w, xs, ns)
        for g, r in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
            if not bool(close(g, r).all()):
                raise AssertionError(f"actor_critic_forward (simple, {n} lanes) disagrees with "
                                     "its plain version")
        top2 = (ref[0] + ns).topk(2, dim=-1).values
        if not bool((got[2] == ref[2])[(top2[:, 0] - top2[:, 1]) > 1e-4].all()):
            raise AssertionError(f"actor_critic_forward (simple, {n} lanes) picks other actions "
                                 "than its plain version")
        if not all(torch.equal(a, b) for a, b in zip(got, K3.actor_critic_forward(w, xs, ns))):
            raise AssertionError(f"actor_critic_forward (simple, {n} lanes): two launches differ")
        f_err = max(f_err, max(float((g - r).abs().max()) for g, r in zip(got[:2], ref[:2])))
        fwd[f"{n}_lanes"] = actor_critic_timing(K3, w, xs, ns)
        got = K3.actor_critic_train_forward(w, xs)
        ref = K3.actor_critic_train_forward_plain(w, xs)
        if not all(bool(close(g, r).all()) for g, r in zip(got, ref)):
            raise AssertionError(f"actor_critic_train_forward (simple, {n} rows) disagrees with "
                                 "its plain version")
        if not all(torch.equal(a, b) for a, b in zip(got, K3.actor_critic_train_forward(w, xs))):
            raise AssertionError(f"actor_critic_train_forward (simple, {n} rows): two launches "
                                 "differ")
        t_err = max(t_err, max(float((g - r).abs().max()) for g, r in zip(got, ref)))
        trn[f"{n}_rows"] = actor_critic_timing(K3, w, xs, train=True)
    rows["actor_critic_forward_simple"] = dict(max_abs_err=f_err, hidden=128,
                                               **fwd[f"{SIMPLE_LANES}_lanes"], cases=fwd)
    rows["actor_critic_train_forward_simple"] = dict(max_abs_err=t_err, hidden=128,
                                                     **trn[f"{A2C_BATCH}_rows"], cases=trn)

    # K10 on the five-branch net at the minibatch
    B = A2C_BATCH
    xb = x[:B]
    _, _, feats, hidden = K3.actor_critic_train_forward(w, xb)
    dlogits = torch.randn(B, A, device=dev, generator=gen) / B
    dvalue = torch.randn(B, device=dev, generator=gen) / B
    got = K3.actor_critic_backward(w, xb, feats, hidden, dlogits, dvalue)
    ref = K3.actor_critic_backward_plain(w, xb, feats, hidden, dlogits, dvalue)
    for f, g, r in zip(K3.TENSOR_FIELDS, got, ref):
        if not grads_close(g, r):
            raise AssertionError(f"actor_critic_backward (simple): {f} disagrees with its plain "
                                 "version")
    if not all(torch.equal(a, b) for a, b in zip(got, K3.actor_critic_backward(
            w, xb, feats, hidden, dlogits, dvalue))):
        raise AssertionError("actor_critic_backward (simple): two launches differ")
    plan = K3.backward_plan(B, w.branch_off, K3._sm_count(torch.cuda.current_device()), 128)
    rows["actor_critic_backward_simple"] = dict(
        max_abs_err=max(float((g - r).abs().max()) for g, r in zip(got, ref)), hidden=128,
        batch=B, ms=gpu_ms(lambda: K3.actor_critic_backward(w, xb, feats, hidden, dlogits,
                                                            dvalue)),
        plain_ms=gpu_ms(lambda: K3.actor_critic_backward_plain(w, xb, feats, hidden, dlogits,
                                                               dvalue)),
        library_ms=gpu_ms(library_actor_critic_grad(w, xb, dlogits, dvalue)),
        **backward_bounds(w, B, A), plan=plan._asdict())

    # K9's A2C mode at the minibatch (run_simple_rl's vf and entropy coefficients)
    r = lambda *shape: torch.randn(*shape, device=dev, generator=gen)
    logits, value = 2.0 * r(B, A), r(B)
    action = torch.randint(0, A, (B,), device=dev, generator=gen, dtype=torch.int32)
    spec = K9.LossSpec(action=action, ent_coef=0.01, adv=0.5 + 2.0 * r(B), ret=1.5 * r(B),
                       vf_coef=0.5, mode="a2c")
    got, ref = K9.policy_loss(spec, logits, value), K9.policy_loss_plain(spec, logits, value)
    if not all(bool(close(g, rf).all()) for g, rf in zip(got, ref)):
        raise AssertionError("policy_loss (A2C) disagrees with its plain version")
    if not all(torch.equal(g, a) for g, a in zip(got, K9.policy_loss(spec, logits, value))):
        raise AssertionError("policy_loss (A2C): two launches differ")
    rows["policy_loss_a2c"] = dict(
        max_abs_err=max(float((g - rf).abs().max()) for g, rf in zip(got, ref)), batch=B,
        plan=K9.policy_loss_plan(B)._asdict(),
        **gpu_spread(lambda: K9.policy_loss(spec, logits, value)),
        plain_ms=gpu_ms(lambda: K9.policy_loss_plain(spec, logits, value), 5),
        **bound(*policy_loss_cost(spec, B, A)), library_ms=None)
    return rows


# ---------------------------------------------------------------- phase 12

def plain_a2c_update(policy, optimizer, cfg, traj, last_values, ret_rms, perms):
    """``rl.a2c.a2c_update`` through the plain versions on the card (the
    reference of phase 12's comparison).  Returns (ret_rms, mean metrics [4])."""
    from mansy_immersivevideostreaming_torch.kernels.actor_critic import (
        actor_critic_train_forward_plain,
    )
    from mansy_immersivevideostreaming_torch.kernels.gae import compute_gae_plain
    from mansy_immersivevideostreaming_torch.kernels.policy_loss import (
        LossSpec, policy_loss_plain,
    )
    from mansy_immersivevideostreaming_torch.rl.ppo import clip_grad_norm

    T, N = traj.reward.shape
    adv, ret = compute_gae_plain(traj.reward, traj.done, traj.value, last_values, cfg.gamma,
                                 cfg.gae_lambda)
    ret_n = ret / torch.sqrt(ret_rms.var + 1e-8) if cfg.rew_norm else ret
    ret_rms = ret_rms.update(ret) if cfg.rew_norm else ret_rms
    flat = dict(obs=traj.obs.reshape(T * N, -1), action=traj.action.reshape(-1),
                adv=adv.reshape(-1), ret=ret_n.reshape(-1))
    params = list(policy.parameters())
    metrics = []
    for idx in perms.reshape(-1, perms.shape[-1]):
        mb = {k: v[idx] for k, v in flat.items()}
        logits, value, _, _ = actor_critic_train_forward_plain(policy._pack(), mb["obs"])
        spec = LossSpec(action=mb["action"], ent_coef=cfg.ent_coef, adv=mb["adv"],
                        ret=mb["ret"], vf_coef=cfg.vf_coef, mode="a2c")
        loss, terms, dlogits, dvalue = policy_loss_plain(spec, logits.detach(), value.detach())
        optimizer.zero_grad(set_to_none=True)
        torch.autograd.backward([logits, value], [dlogits, dvalue])
        clip_grad_norm(params, cfg.max_grad_norm)
        optimizer.step()
        metrics.append(torch.cat([loss[None], terms]))
    return ret_rms, torch.stack(metrics).mean(0)


def compare_a2c_updates(policy, cfg, lr: float, traj, last_values, gen) -> dict:
    """One A2C update from the same parameters, trajectory and permutations
    through the kernels (``rl.a2c.a2c_update``) and through the plain path
    on the card, each with a fresh RMSprop: the metrics and the running
    return statistic within UPDATE_RTOL, the parameters as
    ``compare_params`` holds them (phase 7's limits)."""
    from mansy_immersivevideostreaming_torch.rl.a2c import a2c_update, make_optimizer
    from mansy_immersivevideostreaming_torch.rl.types import RunningStat

    T, N = traj.reward.shape
    n_mb = T * N // cfg.minibatch
    dev = traj.reward.device
    perms = torch.stack([torch.randperm(T * N, generator=gen, device=dev)
                         [:n_mb * cfg.minibatch].reshape(n_mb, cfg.minibatch)
                         for _ in range(cfg.repeat)])
    before = [p.detach().clone() for p in policy.parameters()]
    kernel_p, plain_p = copy.deepcopy(policy), copy.deepcopy(policy)
    stat_k, m = a2c_update(kernel_p, make_optimizer(kernel_p.parameters(), lr), cfg, traj,
                           last_values, RunningStat.init(dev), perms=perms)
    stat_p, m_plain = plain_a2c_update(plain_p, make_optimizer(plain_p.parameters(), lr), cfg,
                                       traj, last_values, RunningStat.init(dev), perms)
    m_kernel = torch.stack([m[k] for k in ("loss", "loss/actor", "loss/vf", "loss/ent")])
    scalars = torch.cat([m_kernel, torch.stack(stat_k)])
    ref = torch.cat([m_plain, torch.stack(stat_p)])
    metric_err = float(((scalars - ref).abs() / ref.abs().clamp(min=1e-2)).max())
    if metric_err > UPDATE_RTOL:
        raise AssertionError(f"simple_rl: the kernels' update metrics differ from the plain "
                             f"path's by {metric_err} (relative)")
    steps = cfg.repeat * n_mb
    return dict(minibatch_steps=steps, metric_rel_err=metric_err,
                **compare_params(before, kernel_p, plain_p, lr * steps, "simple_rl"),
                loss=float(m_kernel[0]), plain_loss=float(m_plain[0]))


def simple_rl_phase(dev, counters, trained: dict):
    """``run_simple_rl --train --qoe-train-id 0`` at the CLI defaults (128
    lanes x 16 steps, minibatch 512: 4 minibatch steps an update, repeat 1,
    2 collects an epoch) through ``run_simple_rl.a2c_round``, from Flax's
    initialiser (orthogonal sqrt 2, zero bias) on tables of the train split's
    shape with one preference: a warm-up round, then SIMPLE_RL_ROUNDS timed
    rounds (one collect and its update each), one update profiled, and one
    update through the kernels against the plain path.  The trained policy
    goes into ``trained`` for phase 12b."""
    from mansy_immersivevideostreaming_torch.cli import run_simple_rl
    from mansy_immersivevideostreaming_torch.models.abr_nets import SimpleActorCritic
    from mansy_immersivevideostreaming_torch.rl.a2c import a2c_update, make_optimizer
    from mansy_immersivevideostreaming_torch.rl.rollout import init_lanes, make_collector
    from mansy_immersivevideostreaming_torch.rl.types import RunningStat
    from mansy_immersivevideostreaming_torch.sim.env import generate_environment_samples
    from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables

    args = run_simple_rl.build_parser().parse_args(["--train", "--qoe-train-id", "0"])
    V, U, NT, C, _ = TRAIN_SHAPE
    tables = synthetic_sim_tables(V, U, NT, C, 1, seed=0, device=dev)
    samples = torch.as_tensor(generate_environment_samples(V, U, NT, 1), device=dev)
    torch.manual_seed(args.seed)
    policy = SimpleActorCritic(device=dev)
    optimizer = make_optimizer(policy.parameters(), args.lr)
    cfg = run_simple_rl.a2c_config(args)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    n_lanes = args.train_lanes
    n_steps = max(args.step_per_collect // n_lanes, 1)
    collect = make_collector(tables, samples, n_lanes, n_steps, train=True)
    start = [p.detach().clone() for p in policy.parameters()]
    carry = [init_lanes(tables, samples, n_lanes, args.seed), RunningStat.init(dev)]
    losses = []

    def run():
        carry[0], carry[1], logs, metrics = run_simple_rl.a2c_round(
            policy, optimizer, cfg, collect, carry[0], carry[1], gen)
        losses.append({k: float(v) for k, v in metrics.items()})
        return logs

    run()  # warm-up
    n_mb = cfg.repeat * (n_lanes * n_steps // cfg.minibatch)
    want = expect(counters, env_step=n_steps, observe_simple_pack=n_steps + 1,
                  actor_critic_forward=n_steps + 1, compute_gae=1,
                  actor_critic_train_forward=n_mb, policy_loss=n_mb, actor_critic_backward=n_mb)
    _, seconds, launches = timed_passes(run, counters, want, SIMPLE_RL_ROUNDS)
    if not all(math.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"simple_rl: non-finite losses {losses}")
    moved = max(float((p.detach() - p0).abs().max())
                for p, p0 in zip(policy.parameters(), start))
    if not moved > 0:
        raise AssertionError("simple_rl: the parameters did not move")

    carry[0], traj, _, last_values = collect(policy, carry[0], gen)
    if traj.obs.shape != (n_steps, n_lanes, 395):
        raise AssertionError(f"simple_rl: observations of shape {tuple(traj.obs.shape)}")

    def update():
        carry[1], _ = a2c_update(policy, optimizer, cfg, traj, last_values, carry[1], gen)

    profiled = profile_update(update, n_mb)
    check = compare_a2c_updates(policy, cfg, args.lr, traj, last_values, gen)
    trained["policy"] = policy
    rate = rate_stats(n_lanes * n_steps, seconds)
    return dict(lanes=n_lanes, steps=n_steps, minibatch=cfg.minibatch, repeat=cfg.repeat,
                hidden=128, minibatch_steps_per_round=n_mb,
                collects_per_epoch=max(args.step_per_epoch // (n_lanes * n_steps), 1),
                passes=SIMPLE_RL_ROUNDS, seconds=seconds,
                env_steps_per_s_median=rate["median"], env_steps_per_s_min=rate["min"],
                env_steps_per_s_max=rate["max"], spread=rate["spread"],
                ms_per_minibatch_update=profiled["ms_per_step"], update_profile=profiled,
                last_losses=losses[-1], max_param_move=moved, kernels_vs_plain=check,
                launches=launches)


def simple_rl_test_phase(dev, counters, trained: dict):
    """Phase 12b, ``run_simple_rl --test --deterministic-eval``'s evaluation
    (``runner.evaluate``, K2's simple mode -> K3 -> K1 a step) of the
    policy phase 12 trained, over the 1440-episode grid's shape in lane
    chunks of 512: every lane finishes, and every episode record equals the
    plain path's on the card."""
    from mansy_immersivevideostreaming_torch.rl.runner import episode_step_bound, evaluate
    from mansy_immersivevideostreaming_torch.sim.env import generate_environment_test_samples
    from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables

    policy = trained["policy"]
    V, U, NT, C, Q = TEST_SHAPE
    tables = synthetic_sim_tables(V, U, NT, C, Q, seed=1, device=dev)
    samples = torch.as_tensor(generate_environment_test_samples(V, U, NT, Q), device=dev)
    evaluate(policy, tables, samples[:SERVE_CHUNK], deterministic=True)  # warm-up
    steps = -(-samples.shape[0] // SERVE_CHUNK) * episode_step_bound(tables)
    (logs, masks), seconds, launches = timed_passes(
        lambda: evaluate(policy, tables, samples, lane_chunk=SERVE_CHUNK, deterministic=True),
        counters, expect(counters, env_step=steps, observe_simple_pack=steps,
                         actor_critic_forward=steps))
    n_eps = int(sum(m.sum() for m in masks))
    if n_eps != samples.shape[0]:
        raise AssertionError(f"simple_rl test: {n_eps} of {samples.shape[0]} lanes finished an "
                             "episode")
    ref_logs, ref_masks, _ = plain_serve(policy, tables, samples)
    qoe = compare_serve(logs, masks, ref_logs, ref_masks, "simple_rl test")
    rate = rate_stats(n_eps, seconds)
    return dict(episodes=n_eps, steps=steps, passes=PASSES, seconds=seconds, hidden=128,
                episodes_per_s_median=rate["median"], episodes_per_s_min=rate["min"],
                episodes_per_s_max=rate["max"], spread=rate["spread"], **qoe,
                launches=launches)


# ---------------------------------------------------------------- phase 13

def ensemble_phase(dev, counters):
    """``run_ensemble.run`` over the committed v7, v9, v18 and v21.last npz
    (in that order, v7 the default; ``artifacts/round5/ensemble_v24_run.sh``)
    at the CLI's defaults (``--route-grid full --route-gate sig``, unseen
    preferences), with ``runner.build_split`` serving synthetic tables of
    the valid split's shape (3 x 45 x 8, 60 chunks, 4 preferences: 4,320
    episodes a component) and of the test grid's (1440 episodes):
    ENSEMBLE_PASSES timed runs (episodes/s over the whole run), then the
    same run with K1, K2 and K3 swapped for their plain versions
    (``mock.patch``).  Every lane finishes; the route, the gate evidence,
    the valid scores and every valid and test episode record equal the plain
    run's (records as ``compare_serve``; scores and evidence within 1e-5).
    The launches follow the run's schedule (lane chunks x episode steps),
    which the records of each ``runner.evaluate`` call give; K3 counts
    v18's share in its hidden-256 mode."""
    from mansy_immersivevideostreaming_torch.cli import run_ensemble
    from mansy_immersivevideostreaming_torch.config import default_config
    from mansy_immersivevideostreaming_torch.kernels import actor_critic as K3
    from mansy_immersivevideostreaming_torch.kernels import env_step as K1
    from mansy_immersivevideostreaming_torch.kernels import observe as K2
    from mansy_immersivevideostreaming_torch.models.abr_nets import MansyActorCritic
    from mansy_immersivevideostreaming_torch.rl import runner
    from mansy_immersivevideostreaming_torch.sim.env import (
        generate_environment_samples, generate_environment_test_samples,
    )
    from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables
    from mansy_immersivevideostreaming_torch.utils.checkpoint import (
        DAGGER_V7_NPZ, DAGGER_V9_NPZ, DAGGER_V18_NPZ, DAGGER_V21_LAST_NPZ,
    )

    shapes = {"valid": (ENSEMBLE_VALID_SHAPE, 2), "test": (TEST_SHAPE, 1)}

    def synthetic_split(config, dataset, network_dataset, mode, qoe_weights, test_grid=False,
                        device="cuda"):
        (V, U, NT, C, _), seed = shapes[mode]
        tables = synthetic_sim_tables(V, U, NT, C, len(qoe_weights), seed=seed, device=device)
        tables = tables._replace(qoe_weights=torch.tensor(qoe_weights, dtype=torch.float32,
                                                          device=device))
        make = generate_environment_test_samples if test_grid else generate_environment_samples
        samples = torch.as_tensor(make(V, U, NT, len(qoe_weights)), device=device)
        return tables, samples, list(range(V)), list(range(U)), list(range(NT))

    real_evaluate = runner.evaluate
    calls = []  # each evaluation's (steps, logs, masks, episodes), to hold against the plain run

    def recorded(policy, tables, samples, *a, **k):
        logs, masks = real_evaluate(policy, tables, samples, *a, **k)
        steps = -(-samples.shape[0] // SERVE_CHUNK) * runner.episode_step_bound(tables)
        calls.append((steps, logs, masks, int(samples.shape[0])))
        return logs, masks

    names = ["v7", "v9", "v18", "v21last"]
    ckpts = [str(p) for p in (DAGGER_V7_NPZ, DAGGER_V9_NPZ, DAGGER_V18_NPZ, DAGGER_V21_LAST_NPZ)]
    tmp = tempfile.mkdtemp(prefix="ensemble_")
    csv_path, json_path = os.path.join(tmp, "results.csv"), os.path.join(tmp, "route.json")
    args = run_ensemble.build_parser().parse_args(
        ["--ckpts", *ckpts, "--names", *names, "--output-csv", csv_path,
         "--route-json", json_path])
    config = default_config(datasets_base_dir=tmp, results_base_dir=tmp, models_base_dir=tmp)

    def run():
        calls.clear()
        with mock.patch.object(runner, "build_split", synthetic_split), \
                mock.patch.object(runner, "evaluate", recorded), \
                contextlib.redirect_stdout(io.StringIO()):  # its summary table
            run_ensemble.run(args, config)
        with open(json_path) as f:
            return json.load(f), list(calls)

    try:
        _, schedule = run()  # warm-up: the route, and with it the schedule of every pass
        steps = sum(c[0] for c in schedule)
        want = expect(counters, env_step=steps, observe_mansy_pack=steps,
                      actor_critic_forward=steps)
        (route, calls_k), seconds, launches = timed_passes(run, counters, want,
                                                           ENSEMBLE_PASSES)
        for _, logs, masks, n in calls_k:
            if int(sum(m.sum() for m in masks)) != n:
                raise AssertionError(f"ensemble: a lane of a {n}-episode evaluation finished "
                                     "no episode")
        with open(csv_path) as f:
            rows_k = f.read().splitlines()

        # the plain path: K1, K2 and K3 swapped for their plain versions
        for fn in counters:
            fn.launches = 0
        with mock.patch.object(MansyActorCritic, "observe",
                               staticmethod(K2.observe_mansy_pack_plain)), \
                mock.patch.object(runner, "actor_critic_forward", K3.actor_critic_forward_plain), \
                mock.patch.object(K1, "env_step", K1.env_step_plain):
            route_p, calls_p = run()
        if any(fn.launches for fn in counters):
            raise AssertionError("ensemble: the plain run launched a kernel")
    finally:
        for path in (csv_path, json_path):
            if os.path.exists(path):
                os.remove(path)
        os.rmdir(tmp)

    if route["route"] != route_p["route"]:
        raise AssertionError(f"ensemble: route {route['route']}, plain path {route_p['route']}")
    for ev, ev_p in zip(route["gate_evidence"], route_p["gate_evidence"]):
        if (ev["candidate"], ev["n"], ev["routed"]) != (ev_p["candidate"], ev_p["n"],
                                                         ev_p["routed"]) \
                or abs(ev["edge"] - ev_p["edge"]) > 1e-5 or abs(ev["se"] - ev_p["se"]) > 1e-5:
            raise AssertionError(f"ensemble: gate evidence {ev}, plain path {ev_p}")
    for name in names:
        if not np.allclose(route["valid_scores"][name], route_p["valid_scores"][name],
                           rtol=1e-5, atol=1e-5):
            raise AssertionError(f"ensemble: valid scores of {name} differ from the plain path")
    differing = 0
    for k, p in zip(calls_k, calls_p):
        differing += compare_serve(k[1], k[2], p[1], p[2], "ensemble")["episodes_differing"]
    episodes = sum(c[3] for c in calls_k)
    rate = rate_stats(episodes, seconds)
    margin = min((abs(ev["edge"] - args.route_z * ev["se"]) for ev in route["gate_evidence"]
                  if ev["candidate"] != 0), default=None)  # how near a gated route came to flipping
    return dict(components=names, episodes=episodes,
                valid_episodes=sum(c[3] for c in calls_k[:len(names)]),
                test_episodes=sum(c[3] for c in calls_k[len(names):]),
                test_csv_rows=len(rows_k) - 1, steps=steps, passes=ENSEMBLE_PASSES,
                seconds=seconds, episodes_per_s_median=rate["median"],
                episodes_per_s_min=rate["min"], episodes_per_s_max=rate["max"],
                spread=rate["spread"], route=route["route"],
                gate_evidence=route["gate_evidence"], smallest_gate_margin=margin,
                test_grid_mean=route["test_grid_mean"],
                plain_test_grid_mean=route_p["test_grid_mean"], episodes_differing=differing,
                launches=launches)


# ---------------------------------------------------------------- phase 2g

def derived_close(got: torch.Tensor, ref: torch.Tensor) -> bool:
    """|got - ref| <= AV_RTOL |ref| + AV_ATOL everywhere (NaN only where both)."""
    both_nan = got.isnan() & ref.isnan()
    return bool((both_nan | ((got - ref).abs() <= AV_RTOL * ref.abs() + AV_ATOL)).all())


def derived_bytes(rows: int, K: int, R: int, T: int, A: int) -> int:
    """Bytes K2's row mode must move: the columns causal_action_values reads
    (the throughput history, both slabs, the viewport, the last viewport
    quality, the buffer, the weights and the one-hot) and the A + 1 it
    writes, for each row."""
    return rows * ((K + 2 * R * T + T + 1 + 1 + 3 + A) + (A + 1)) * 4


def derived_kernel_phase(dev, parent=None):
    """Phase 2g: K2's derived mode at each path's width (the first 32, 128,
    512 and 8192 lanes of tables of the train split's shape, without action
    values) and its row mode at CE_BATCH rows and at DEMO_ROWS (rows packed
    by the plain derived mode, their action-value columns zeroed; the
    8192 lanes' rows repeated to DEMO_ROWS), each against its plain version
    on the same card tensors (AV_RTOL, AV_ATOL), two launches bit-equal,
    timed by CUDA events beside the bytes bound and the plain version; then
    both modes on the edge cases at serve's lane chunk (an empty and a full
    predicted viewport, an empty throughput history, no previous action).
    With ``parent``, the parent commit's two modes on the same inputs: timed
    at every width and row count (``earlier_ms``, ``earlier_ms_range``), and
    their bits must equal this tree's everywhere (``earlier_bits_equal``;
    on the edge cases ``row_earlier_bits_equal`` too)."""
    from mansy_immersivevideostreaming_torch.kernels import env_step as K1
    from mansy_immersivevideostreaming_torch.kernels import observe as K2
    from mansy_immersivevideostreaming_torch.rl.rollout import init_lanes
    from mansy_immersivevideostreaming_torch.sim.env import (
        generate_environment_samples, tree_map,
    )
    from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables

    V, U, NT, C, Q = TRAIN_SHAPE
    tables = synthetic_sim_tables(V, U, NT, C, Q, seed=0, device=dev)
    samples = torch.as_tensor(generate_environment_samples(V, U, NT, Q), device=dev)
    state = init_lanes(tables, samples, LANES)
    rng = np.random.default_rng(5)
    for _ in range(7):  # give the lanes history (plain path)
        acts = torch.as_tensor(rng.integers(0, 15, LANES).astype(np.int32), device=dev)
        state, *_ = K1.env_step_plain(tables, samples, state, acts, LANES, True)
    dims = K2.obs_dims(tables)[:4]
    col = K2.obs_columns(*dims, True)["action_values"]
    earlier = parent.observe if parent else None
    differ = []  # where the parent's bits differ

    def same_bits(label, got, theirs) -> bool:
        if not torch.equal(got, theirs):
            differ.append(label)
            return False
        return True

    def fused(t, sub, label):
        x = K2.observe_mansy_pack(t, sub, action_values=True)
        ref = K2.observe_mansy_pack_plain(t, sub, action_values=True)
        if not derived_close(x, ref):
            raise AssertionError(f"observe_mansy_pack, derived ({label}) disagrees with its "
                                 f"plain version by {float((x - ref).abs().max())}")
        if not torch.equal(K2.observe_mansy_pack(t, sub, action_values=True), x):
            raise AssertionError(f"observe_mansy_pack, derived ({label}): two launches differ")
        return x, ref

    def row_mode(ref, label):
        rows = ref.clone()
        rows[:, col] = 0.0
        got = K2.derive_action_values(rows.clone(), *dims)
        want = K2.derive_action_values_plain(rows.clone(), *dims)
        others = torch.ones(rows.shape[1], dtype=torch.bool, device=rows.device)
        others[col] = False
        if not derived_close(got, want) or not torch.equal(got[:, others], rows[:, others]):
            raise AssertionError(f"derive_action_values ({label}) disagrees with its plain version")
        if not torch.equal(K2.derive_action_values(rows.clone(), *dims), got):
            raise AssertionError(f"derive_action_values ({label}): two launches differ")
        return rows, got, want

    cases = {}
    for n in K2_WIDTHS:
        sub = tree_map(lambda x: x[:n].contiguous(), state)
        x, ref = fused(tables, sub, f"{n} lanes")
        out = torch.empty_like(x)
        case = cases[str(n)] = dict(
            lanes=n, width=x.shape[1], plan=K2.observe_plan(n)._asdict(),
            max_abs_err=float((x - ref).abs().max()),
            **gpu_spread(lambda: K2.observe_mansy_pack(tables, sub, out=out, action_values=True)),
            plain_ms=gpu_ms(lambda: K2.observe_mansy_pack_plain(tables, sub,
                                                                action_values=True), 5),
            bound_ms=1e3 * observe_bytes(tables, sub, x.shape[1]) / HBM_BYTES_PER_S,
            write_floor_ms=gpu_ms(lambda: out.fill_(0.0)))
        if earlier:
            case["earlier_bits_equal"] = same_bits(
                f"{n} lanes", x, earlier.observe_mansy_pack(tables, sub, action_values=True))
            case.update(gpu_spread(lambda: earlier.observe_mansy_pack(
                tables, sub, out=out, action_values=True), "earlier_ms"))
        if n == LANES:
            ref_all = ref

    # the edge cases, both modes, at serve's lane chunk
    sub = tree_map(lambda x: x[:SERVE_CHUNK].contiguous(), state)
    edge = {"empty_viewport": (tables._replace(pred=torch.zeros_like(tables.pred)), sub),
            "full_viewport": (tables._replace(pred=torch.ones_like(tables.pred)), sub),
            "empty_history": (tables, sub._replace(
                past_throughput=torch.zeros_like(sub.past_throughput))),
            "no_previous_action": (tables, sub._replace(
                last_action_one_hot=torch.zeros_like(sub.last_action_one_hot)))}
    edges = {}
    for label, (t, s) in edge.items():
        x, ref = fused(t, s, label)
        rows, got, want = row_mode(ref, label)
        if label == "empty_history" and not bool((x[:, col.stop - 1] == 0.5).all()):
            raise AssertionError("observe_mansy_pack, derived: bw_hat is not the 0.5 prior")
        edges[label] = dict(fused_max_abs_err=float((x - ref).abs().max()),
                            row_max_abs_err=float((got - want).abs().max()))
        if earlier:
            edges[label].update(
                earlier_bits_equal=same_bits(
                    label, x, earlier.observe_mansy_pack(t, s, action_values=True)),
                row_earlier_bits_equal=same_bits(
                    f"{label}, row mode", got, earlier.derive_action_values(rows.clone(), *dims)))

    # the row mode at CE_BATCH rows and at DEMO_ROWS
    row_cases = {}
    for n in (CE_BATCH, DEMO_ROWS):
        ref = ref_all.repeat(-(-n // LANES), 1)[:n]
        rows, got, want = row_mode(ref, f"{n} rows")
        buf = rows.clone()
        case = row_cases[str(n)] = dict(
            rows=n, plan=K2.observe_plan(n)._asdict(), max_abs_err=float((got - want).abs().max()),
            **gpu_spread(lambda: K2.derive_action_values(buf, *dims)),
            plain_ms=gpu_ms(lambda: K2.derive_action_values_plain(buf, *dims), 5),
            bound_ms=1e3 * derived_bytes(n, *dims) / HBM_BYTES_PER_S)
        if earlier:
            case["earlier_bits_equal"] = same_bits(
                f"{n} rows", got, earlier.derive_action_values(rows.clone(), *dims))
            case.update(gpu_spread(lambda: earlier.derive_action_values(buf, *dims),
                                   "earlier_ms"))
    if differ:
        raise AssertionError(f"K2's derived values differ from the parent's kernels' bits: "
                             f"{differ}")
    main = cases[str(LANES)]
    fused_row = dict(max_abs_err=max(c["max_abs_err"] for c in cases.values()),
                     width=main["width"],
                     **{k: main[k] for k in main if k.endswith("ms") or k.endswith("range")},
                     bound_by="bytes", library_ms=None, cases=cases, edge_cases=edges)
    main = row_cases[str(CE_BATCH)]
    row_row = dict(max_abs_err=max(c["max_abs_err"] for c in row_cases.values()),
                   rows=main["rows"], plan=main["plan"],
                   **{k: main[k] for k in main if k.endswith("ms") or k.endswith("range")},
                   bound_by="bytes", library_ms=None, cases=row_cases)
    return {"observe_mansy_pack_derived": fused_row, "derive_action_values": row_row}


# ------------------------------------------------------------- phases 15-15c

def derived_policy(dev, which: str, tmp: str):
    """A policy that reads the derived action values, from a committed npz
    with a sidecar written under ``tmp``: (i) v16's weights with
    ``obs_action_values`` and no ``exact_action_values`` (its 11th branch
    and prior 3.0 on the derived field), (ii) v9's with a logit prior of
    3.0."""
    from mansy_immersivevideostreaming_torch.utils.checkpoint import (
        DAGGER_V9_NPZ, DAGGER_V16_NPZ, load_net_config, load_npz_policy, save_net_config,
    )

    src, override = {"i": (DAGGER_V16_NPZ, {"obs_action_values": True,
                                            "exact_action_values": False}),
                     "ii": (DAGGER_V9_NPZ, {"av_logit_prior": AV_PRIOR})}[which]
    path = os.path.join(tmp, f"policy_{which}.npz")
    shutil.copyfile(src, path)
    save_net_config(path, {**load_net_config(src), **override})
    policy = load_npz_policy(path, device=dev)
    if not policy.reads_action_values or policy.exact_action_values \
            or policy.av_logit_prior != AV_PRIOR:
        raise AssertionError(f"policy ({which}) does not read the derived values")
    return policy


def serve_av_phase(dev, counters):
    """Phase 15: deterministic evaluation of the two derived-value policies
    (``derived_policy``: (i) and (ii)) over the 1440-episode test grid's
    shape as phase 3 (tables without action values, so K2 runs its derived
    mode), each timed over PASSES passes and held against the plain path on
    the card by ``compare_lanes`` with LOGIT_NEAR_TIE: a lane whose first
    differing decision is a near-tie of the plain logits is counted."""
    from mansy_immersivevideostreaming_torch.rl import runner
    from mansy_immersivevideostreaming_torch.sim.env import generate_environment_test_samples
    from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables

    V, U, NT, C, Q = TEST_SHAPE
    tables = synthetic_sim_tables(V, U, NT, C, Q, seed=1, device=dev)
    samples = torch.as_tensor(generate_environment_test_samples(V, U, NT, Q), device=dev)
    steps = -(-samples.shape[0] // SERVE_CHUNK) * runner.episode_step_bound(tables)
    out, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for which in ("i", "ii"):
            policy = derived_policy(dev, which, tmp)
            run = lambda: runner.evaluate(policy, tables, samples, lane_chunk=SERVE_CHUNK,
                                          deterministic=True)
            runner.evaluate(policy, tables, samples[:SERVE_CHUNK], deterministic=True)  # warm-up
            (logs, masks), seconds, counts = timed_passes(
                run, counters, expect(counters, env_step=steps, observe_mansy_pack=steps,
                                      actor_critic_forward=steps))
            n_eps = int(sum(m.sum() for m in masks))
            if n_eps != samples.shape[0]:
                raise AssertionError(f"serve_av ({which}): {n_eps} of {samples.shape[0]} lanes "
                                     "finished an episode")
            # the kernels' decisions, recorded through the entry point's own calls
            actions = []
            forward = runner.actor_critic_forward

            def recording(*a, **k):
                result = forward(*a, **k)
                actions.append(result[2])
                return result

            with mock.patch.object(runner, "actor_critic_forward", recording):
                logs, masks = run()
            per_chunk = len(actions) // len(logs)
            chunks = [(l, m, torch.stack(actions[i * per_chunk:(i + 1) * per_chunk]).cpu().numpy())
                      for i, (l, m) in enumerate(zip(logs, masks))]
            ref_logs, ref_masks, decisions = plain_serve(policy, tables, samples)
            counts_cmp = compare_lanes(chunks, [(l, m) + d for l, m, d in zip(
                ref_logs, ref_masks, decisions)], f"serve_av ({which})", LOGIT_NEAR_TIE)
            qoe = np.concatenate([l.qoe.cpu().numpy()[m] for l, m in zip(logs, masks)])
            rate = rate_stats(n_eps, seconds)
            out[which] = dict(episodes=n_eps, seconds=seconds,
                              episodes_per_s_median=rate["median"],
                              episodes_per_s_min=rate["min"], episodes_per_s_max=rate["max"],
                              spread=rate["spread"], mean_qoe=float(qoe.mean()),
                              near_tie_margin=LOGIT_NEAR_TIE, **counts_cmp)
            for row, n in counts.items():
                launches[row] = launches.get(row, 0) + n
    return dict(steps=2 * steps, passes=PASSES, v16_derived=out["i"], v9_prior=out["ii"],
                launches=launches)


def dagger_av_phase(dev, counters):
    """Phase 15c: ``run_dagger --obs-action-values --av-logit-prior 3.0
    --acc-correct`` (phase 8's flags without ``--exact-action-values``), one
    round at phase 8's shape from policy (i): the initial aggregate is the
    port's expert demos over the 1440-episode grid recorded without the
    exact field, so ``flatten_demos`` fills their action-value columns by
    K2's row mode (held against its plain version); round 0 fits it, then
    one round (the derived mode in the expert-labelled rollout).  Every
    count is set to 0 before the aggregate is packed and read after the
    round."""
    from mansy_immersivevideostreaming_torch.cli import run_dagger
    from mansy_immersivevideostreaming_torch.cli.run_expert import run_expert_episodes
    from mansy_immersivevideostreaming_torch.kernels import expert_tables as K5
    from mansy_immersivevideostreaming_torch.kernels.observe import (
        derive_action_values_plain, obs_columns, obs_dims,
    )
    from mansy_immersivevideostreaming_torch.rl import dagger
    from mansy_immersivevideostreaming_torch.rl.ppo import make_optimizer
    from mansy_immersivevideostreaming_torch.rl.runner import episode_step_bound
    from mansy_immersivevideostreaming_torch.sim.env import (
        generate_demo_samples, generate_environment_test_samples,
    )
    from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables

    args = run_dagger.build_parser().parse_args(
        ["--obs-action-values", "--av-logit-prior", str(AV_PRIOR), "--acc-correct",
         "--horizon", str(HORIZON), "--lanes", "32", "--batch-size", "4096", "--rounds", "1"])
    V, U, NT, C, Q = TEST_SHAPE
    tables = perturb_pred(synthetic_sim_tables(V, U, NT, C, Q, seed=1, device=dev), seed=1)
    samples = torch.as_tensor(generate_environment_test_samples(V, U, NT, Q), device=dev)
    etables = K5.build_expert_tables(tables)  # the expert's; no action values attached
    chunks = run_expert_episodes(tables, etables, samples, args.horizon, lane_chunk=EXPERT_CHUNK,
                                 collect_obs=True, acc_correct=args.acc_correct)
    demos = []
    for _, first, actions, obs in chunks:
        if "action_values" in obs:
            raise AssertionError("dagger_av: the demos carry the exact field")
        obs = {k: v.cpu().numpy() for k, v in obs.items()}
        for lane in range(first.shape[1]):
            t_end = int(np.argwhere(first[:, lane])[0][0])
            demos.append({"obs": {k: v[:t_end + 1, lane] for k, v in obs.items()},
                          "act": actions[:t_end + 1, lane]})
    with tempfile.TemporaryDirectory() as tmp:
        policy = derived_policy(dev, "i", tmp)
    optimizer = make_optimizer(policy.parameters(), args.lr)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    n_steps = episode_step_bound(tables)
    collect = dagger.make_dagger_collector(tables, etables, args.horizon, n_steps,
                                           acc_correct=args.acc_correct)
    lanes = torch.as_tensor(generate_demo_samples(V, U, NT, Q, args.lanes, args.seed + 1),
                            device=dev)

    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
        getattr(fn, "launches_by_mode", {}).clear()
    t0 = time.perf_counter()
    dataset = dagger.flatten_demos(demos, dev, policy.reads_action_values)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    fit = dagger.bc_on_aggregate(policy, optimizer, run_dagger.balanced(args, dataset, tables),
                                 args.bc_steps, args.batch_size, gen, args.ent_coef)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dataset, losses, _ = run_dagger.dagger_round(args, policy, optimizer, collect, tables,
                                                 dataset, lanes, gen)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    got = {fn.__name__: fn.launches for fn in counters}
    want = expect(counters, derive_action_values=1, env_step=n_steps, observe_mansy_pack=n_steps,
                  choose_action=n_steps, actor_critic_forward=n_steps,
                  actor_critic_train_forward=2 * args.bc_steps, policy_loss=2 * args.bc_steps,
                  actor_critic_backward=2 * args.bc_steps)
    if got != want:
        raise AssertionError(f"dagger_av: launches {got}, expected {want}")
    launches = row_launches(counters)
    # the demos' derived columns against the plain row mode
    n_demo = sum(len(d["act"]) for d in demos)
    x = dataset[0][:n_demo]
    dims = obs_dims(tables)[:4]
    col = obs_columns(*dims, True)["action_values"]
    if x.shape[1] != policy.obs_width(tables) or not derived_close(
            x, derive_action_values_plain(x.clone(), *dims)):
        raise AssertionError("dagger_av: the demos' derived columns disagree with the plain "
                             "row mode")
    if not all(math.isfinite(v) for v in fit + losses):
        raise AssertionError(f"dagger_av: non-finite CE {fit} {losses}")
    return dict(rounds=1, lanes=args.lanes, steps=n_steps, bc_steps=args.bc_steps,
                batch=args.batch_size, demos=len(demos), demo_rows=n_demo,
                demo_bw_hat_mean=float(x[:, col.stop - 1].mean()),
                aggregate_rows=int(dataset[1].shape[0]), pack_seconds=pack_s,
                round0_ce=[fit[0], fit[-1]], round_ce=[losses[0], losses[-1]],
                round_seconds=round_s, launches=launches)


# ---------------------------------------------------------- phase 16

def dp_counters():
    """The kernel wrappers whose launches phase 16's workers count."""
    from mansy_immersivevideostreaming_torch.kernels.actor_critic import (
        actor_critic_backward, actor_critic_forward, actor_critic_train_forward,
    )
    from mansy_immersivevideostreaming_torch.kernels.attention import (
        attention, attention_backward, attention_train_forward,
    )
    from mansy_immersivevideostreaming_torch.kernels.env_step import env_step
    from mansy_immersivevideostreaming_torch.kernels.gae import compute_gae
    from mansy_immersivevideostreaming_torch.kernels.observe import observe_mansy_pack
    from mansy_immersivevideostreaming_torch.kernels.policy_loss import policy_loss
    return (env_step, observe_mansy_pack, actor_critic_forward, compute_gae, policy_loss,
            actor_critic_train_forward, actor_critic_backward, attention,
            attention_train_forward, attention_backward)


def synced_seconds(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def dp_mansy_loop(mesh) -> dict:
    """Phase 16c in a rank: ``run_mansy --train --data-parallel``'s loop
    (``ppo_round`` with the mesh) at phase 7's shapes from the v9 weights,
    DP_ROUNDS rounds: the first's metrics and the parameters after it are
    held against world 1, the second is timed."""
    from mansy_immersivevideostreaming_torch.cli import run_mansy
    from mansy_immersivevideostreaming_torch.models.abr_nets import QoEIdentifier
    from mansy_immersivevideostreaming_torch.parallel.mesh import replicate
    from mansy_immersivevideostreaming_torch.rl.ppo import make_optimizer
    from mansy_immersivevideostreaming_torch.rl.rollout import init_lanes, make_collector
    from mansy_immersivevideostreaming_torch.rl.types import RunningStat
    from mansy_immersivevideostreaming_torch.sim.env import generate_environment_samples
    from mansy_immersivevideostreaming_torch.sim.tables import synthetic_sim_tables
    from mansy_immersivevideostreaming_torch.utils.checkpoint import (
        DAGGER_V9_NPZ, load_npz_policy,
    )
    from mansy_immersivevideostreaming_torch.utils.prng import seed_everything

    dev = mesh.device
    args = run_mansy.build_parser().parse_args(
        ["--train", "--data-parallel", "--train-identifier", "--use-identifier", "--lamb",
         "0.5"])
    V, U, NT, C, Q = TRAIN_SHAPE
    tables = synthetic_sim_tables(V, U, NT, C, Q, seed=0, device=dev)
    samples = torch.as_tensor(generate_environment_samples(V, U, NT, Q), device=dev)
    gen = seed_everything(args.seed, dev)
    policy = replicate(mesh, load_npz_policy(DAGGER_V9_NPZ, device=dev))
    identifier = replicate(mesh, QoEIdentifier(hidden_dim=args.hidden_dim, device=dev))
    optimizer = make_optimizer(policy.parameters(), args.lr, args.weight_decay)
    id_optimizer = make_optimizer(identifier.parameters(), args.identifier_lr,
                                  args.weight_decay)
    cfg = run_mansy.ppo_config(args, Q)
    n_lanes, n_steps = args.train_lanes, args.step_per_collect // args.train_lanes
    collect = make_collector(tables, samples, n_lanes, n_steps, train=True, mesh=mesh)
    prefs = tables.qoe_weights / tables.qoe_weights.sum(-1, keepdim=True)
    carry = [init_lanes(tables, samples, n_lanes, args.seed, mesh), RunningStat.init(dev)]
    rounds = []
    for _ in range(DP_ROUNDS):
        def round_():
            with contextlib.redirect_stdout(sys.stderr):  # the identifier's loss lines
                carry[0], carry[1], logs, metrics = run_mansy.ppo_round(
                    args, policy, identifier, optimizer, id_optimizer, cfg, collect,
                    carry[0], carry[1], gen, args.ent_coef, args.lamb, prefs, mesh=mesh)
            return logs, metrics
        (logs, metrics), seconds = synced_seconds(round_)
        done = logs.done
        rounds.append(dict(seconds=seconds, metrics={k: float(v) for k, v in metrics.items()},
                           episodes=int(done.sum()),
                           return_sum=float(logs.ret[done].double().sum())))
        if len(rounds) == 1:
            first = [p.detach().cpu().numpy().copy() for p in policy.parameters()]
    return dict(lanes=n_lanes, lanes_per_rank=n_lanes // mesh.world, steps=n_steps,
                minibatch=cfg.minibatch, hidden=args.hidden_dim, rounds=rounds,
                params_after_first=first)


def dp_models_loop(mesh) -> dict:
    """Phase 16d in a rank: ``run_models --train --data-parallel``'s loop
    (``vp_train.train_epoch`` with the mesh) at its defaults (d 512, bs
    512) over DP_VP_BATCHES batches of phase 11's synthetic traces, from
    Flax's initialisers: the per-batch losses and the parameters after."""
    from mansy_immersivevideostreaming_torch.cli import run_models
    from mansy_immersivevideostreaming_torch.models import vp_train as TV
    from mansy_immersivevideostreaming_torch.parallel.mesh import replicate

    dev = mesh.device
    args = run_models.build_parser().parse_args(["--train", "--data-parallel", "--seed",
                                                 str(VP_SEED)])
    n = DP_VP_BATCHES * args.bs
    data = vp_train_data(args, n, 40, dev)
    model = replicate(mesh, run_models.build_model(args, dev).init_like_flax(
        torch.Generator(device=dev).manual_seed(args.seed)))
    opt = TV.make_optimizer(args.lr, 0.01 if args.weight_decay is None else args.weight_decay)
    state = TV.create_train_state(model)
    perm = np.random.default_rng(args.seed).permutation(n)
    steps = []
    for b in range(DP_VP_BATCHES):
        idx = torch.as_tensor(perm[b * args.bs:(b + 1) * args.bs], device=dev)
        batch = {k: v[idx] for k, v in data.items()}
        (state, loss), seconds = synced_seconds(
            lambda: TV.train_step(model, opt, state, batch, args.seed, mesh=mesh))
        steps.append(dict(seconds=seconds, loss=float(loss)))
    return dict(d_model=args.hidden_dim, bs=args.bs, batches=DP_VP_BATCHES, steps=steps,
                params=[p.detach().cpu().numpy() for p in model.parameters()])


def dp_worker(world: int, out_dir: str) -> int:
    """One rank of phase 16 (``--dp-worker``): joins the group that phase
    16 set up in its environment, runs the dry run (16a/b), the run_mansy
    loop (16c) and the run_models loop (16d) with the launch counts set to
    0 just before and read just after, and writes its results to
    ``out_dir/w<world>_r<rank>.npz`` (arrays) and a JSON line on stdout."""
    from mansy_immersivevideostreaming_torch.parallel import launch
    from mansy_immersivevideostreaming_torch.parallel.dryrun import run_dryrun
    from mansy_immersivevideostreaming_torch.parallel.mesh import shutdown

    mesh = launch.join("cuda")
    if mesh.world != world:
        raise AssertionError(f"joined a group of {mesh.world}, expected {world}")
    counters = dp_counters()
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
        getattr(fn, "launches_by_mode", {}).clear()
    dry, dry_s = synced_seconds(lambda: run_dryrun(DP_DEVICES, mesh, DP_HIDDEN))
    mansy = dp_mansy_loop(mesh)
    models = dp_models_loop(mesh)
    torch.cuda.synchronize()
    launches = row_launches(counters)
    arrays = {f"dry/{k}": v for k, v in dry.items()}
    arrays.update({f"mansy/{i}": p for i, p in enumerate(mansy.pop("params_after_first"))})
    arrays.update({f"models/{i}": p for i, p in enumerate(models.pop("params"))})
    np.savez(os.path.join(out_dir, f"w{world}_r{mesh.rank}.npz"), **arrays)
    print("DP_RESULT " + json.dumps(dict(
        rank=mesh.rank, world=mesh.world, backend=mesh.backend, dryrun_seconds=dry_s,
        mansy=mansy, models=models, launches=launches)), flush=True)
    shutdown(mesh)
    return 0


def start_dp_ranks(world: int, out_dir: str):
    """Phase 16's ranks of one world: this script as ``--dp-worker``, the
    group's store a file under ``out_dir``."""
    from mansy_immersivevideostreaming_torch.parallel.launch import rank_env

    init = Path(out_dir, f"store{world}").as_uri()
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker",
                              str(world), "--dp-out", out_dir],
                             env=rank_env(rank, world, init), stdout=subprocess.PIPE,
                             text=True) for rank in range(world)]


def finish_dp_ranks(procs) -> list:
    """Every rank's DP_RESULT; a rank that exits non-zero or outlives
    DP_TIMEOUT_S fails the phase (the others are stopped)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        log(f"data_parallel rank {rank}/{len(procs)}: {out.strip()[-2000:]}")
        if p.returncode != 0:
            raise AssertionError(f"data_parallel: rank {rank} of {len(procs)} exited with "
                                 f"{p.returncode}")
        lines = [l for l in out.splitlines() if l.startswith("DP_RESULT ")]
        if len(lines) != 1:
            raise AssertionError(f"data_parallel: rank {rank} printed no result")
        results.append(json.loads(lines[0][len("DP_RESULT "):]))
    return results


def dp_params_close(got, want, atol: float, loose: float, most: float) -> dict:
    """All but ``loose`` of the entries within ``atol``, every one within
    ``most``: Adam's steps are lr times the sign of a gradient near 0, where
    two runs' float noise may carry opposite signs."""
    beyond = total = 0
    worst = 0.0
    for g, w in zip(got, want):
        d = np.abs(g.astype(np.float64) - w)
        beyond += int((d > atol).sum())
        total += d.size
        worst = max(worst, float(d.max()))
    share = beyond / total
    if share > loose or worst > most:
        raise AssertionError(f"data_parallel: {share:.4f} of the parameters beyond {atol} "
                             f"(limit {loose}), largest {worst} (limit {most})")
    return dict(share_beyond_atol=share, atol=atol, max_abs_diff=worst)


def dp_rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), DP_ATOL / DP_RTOL)


def data_parallel_phase(dev) -> dict:
    """Phase 16: the dry run, run_mansy's and run_models' loops at world 1
    (one rank, NCCL) and world 2 (two ranks sharing the card, Gloo), each
    rank a process; world 2 held against world 1 (module docstring)."""
    from mansy_immersivevideostreaming_torch.parallel.dryrun import MTIO_LR

    with tempfile.TemporaryDirectory(prefix="dp_", dir=os.environ.get("TMPDIR")) as out_dir:
        results = {w: finish_dp_ranks(start_dp_ranks(w, out_dir)) for w in (1, 2)}
        arrays = {(w, r): dict(np.load(os.path.join(out_dir, f"w{w}_r{r}.npz")))
                  for w in (1, 2) for r in range(w)}
    backends = {w: [r["backend"] for r in res] for w, res in results.items()}
    if backends != {1: ["nccl"], 2: ["gloo", "gloo"]}:
        raise AssertionError(f"data_parallel: backends {backends}")
    for key, x in arrays[2, 0].items():  # the ranks' parameters: the same bits
        if not np.array_equal(x, arrays[2, 1][key]):
            raise AssertionError(f"data_parallel: the two ranks differ in {key}")
    one, two = arrays[1, 0], arrays[2, 0]
    r1, r2 = results[1][0], results[2][0]
    checks = {}
    # 16a/b: the dry run
    for key in ("dry/mtio_loss", "dry/ppo_loss"):
        if not (np.isfinite(one[key]) and dp_rel(float(two[key]), float(one[key])) <= 1e-4):
            raise AssertionError(f"data_parallel: {key} {two[key]} against {one[key]}")
    keys = sorted(k for k in one if k.startswith("dry/mtio/") and "bn." not in k)
    checks["dryrun_mtio_params"] = dp_params_close([two[k] for k in keys], [one[k] for k in keys],
                                                   2e-6, 0.01, 2.5 * MTIO_LR)
    keys = sorted(k for k in one if k.startswith(("dry/ppo/")) or "bn." in k)
    checks["dryrun_ppo_params_and_bn"] = dp_params_close(
        [two[k] for k in keys], [one[k] for k in keys], 1e-5, 0.0, 1e-5)
    # 16c: run_mansy's loop, the first round
    m1, m2 = r1["mansy"]["rounds"][0], r2["mansy"]["rounds"][0]
    for k, v in m1["metrics"].items():
        if dp_rel(m2["metrics"][k], v) > DP_RTOL:
            raise AssertionError(f"data_parallel: run_mansy round 1 {k} {m2['metrics'][k]} "
                                 f"against {v}")
    checks["mansy_round_1_episodes_equal"] = (
        (m1["episodes"], m1["return_sum"]) == (m2["episodes"], m2["return_sum"]))
    keys = sorted((k for k in one if k.startswith("mansy/")), key=lambda k: int(k[6:]))
    n_mb = r1["mansy"]["steps"] * r1["mansy"]["lanes"] // r1["mansy"]["minibatch"] * 2
    checks["mansy_params_after_round_1"] = dp_params_close(
        [two[k] for k in keys], [one[k] for k in keys], 1e-5, 0.01, 2.5 * n_mb * 5e-4)
    # 16d: run_models' loop
    for s1, s2 in zip(r1["models"]["steps"], r2["models"]["steps"]):
        if not math.isfinite(s1["loss"]) or dp_rel(s2["loss"], s1["loss"]) > DP_RTOL:
            raise AssertionError(f"data_parallel: run_models loss {s2['loss']} against "
                                 f"{s1['loss']}")
    keys = sorted((k for k in one if k.startswith("models/")), key=lambda k: int(k[7:]))
    checks["models_params"] = dp_params_close([two[k] for k in keys], [one[k] for k in keys],
                                              1e-5, 0.03, 2.5 * DP_VP_BATCHES * 1e-4)
    launches = {}
    for res in results[1] + results[2]:
        for row, n in res["launches"].items():
            launches[row] = launches.get(row, 0) + n
    timing = {f"world_{w}": dict(
        backend=results[w][0]["backend"],
        dryrun_s=[r["dryrun_seconds"] for r in results[w]],
        ppo_round_s=[r["mansy"]["rounds"][-1]["seconds"] for r in results[w]],
        ppo_round_metrics=results[w][0]["mansy"]["rounds"][-1]["metrics"],
        mtio_step_s=[[s["seconds"] for s in r["models"]["steps"]] for r in results[w]],
        mtio_losses=[s["loss"] for s in results[w][0]["models"]["steps"]])
        for w in (1, 2)}
    return dict(devices_of_data=DP_DEVICES, hidden=DP_HIDDEN,
                ppo=dict(lanes=r1["mansy"]["lanes"], steps=r1["mansy"]["steps"],
                         minibatch=r1["mansy"]["minibatch"], rounds=DP_ROUNDS),
                mtio=dict(d_model=r1["models"]["d_model"], bs=r1["models"]["bs"],
                          batches=DP_VP_BATCHES),
                steps=DP_ROUNDS * r1["mansy"]["steps"], timing=timing, checks=checks,
                launches=launches)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", metavar="DIR",
                        help="another checkout of the repo (e.g. the parent commit's, from "
                             "git archive): its K3, K10, K8, K1, K9, K2, K7, K5 and K6 are built and "
                             "timed beside this tree's (earlier_ms)")
    parser.add_argument("--vp-train", metavar="N", type=int, default=0,
                        help="run only phase 11 (vp_train), N times over, and print each "
                             "run's step checks (kernels_vs_plain) as a JSON line")
    parser.add_argument("--data-parallel", action="store_true",
                        help="run only phase 16 (data_parallel) and print its JSON line")
    parser.add_argument("--limits", action="store_true",
                        help="run only phase 2i (K8 past 2048 keys and 256 dims) and the "
                             "vp_test_long, vp_train_long and vp_train_wide paths, and print "
                             "their JSON lines")
    parser.add_argument("--dp-worker", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--dp-out", help=argparse.SUPPRESS)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA card (torch.cuda.is_available() is False)")
        return 1
    if opts.dp_worker:  # one rank of phase 16
        return dp_worker(opts.dp_worker, opts.dp_out)
    # cuBLAS's deterministic workspace, read when the first handle is made:
    # phase 11 compares its steps under deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from mansy_immersivevideostreaming_torch.kernels.actor_critic import (
        actor_critic_backward, actor_critic_forward, actor_critic_train_forward,
    )
    from mansy_immersivevideostreaming_torch.kernels.choose_action import choose_action
    from mansy_immersivevideostreaming_torch.kernels.env_step import env_step
    from mansy_immersivevideostreaming_torch.kernels.expert_tables import build_expert_tables
    from mansy_immersivevideostreaming_torch.kernels.gae import compute_gae
    from mansy_immersivevideostreaming_torch.kernels.observe import (
        derive_action_values, observe_mansy_pack, observe_simple_pack,
    )
    from mansy_immersivevideostreaming_torch.kernels.policy_loss import policy_loss
    from mansy_immersivevideostreaming_torch.kernels.attention import (
        attention, attention_backward, attention_train_forward,
    )
    from mansy_immersivevideostreaming_torch.kernels.tile_occupancy import (
        chunk_maps, trajectory_metrics,
    )

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = device_line()
    log(f"device: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    counters = (env_step, observe_mansy_pack, actor_critic_forward, choose_action,
                build_expert_tables, compute_gae, policy_loss, actor_critic_train_forward,
                actor_critic_backward, chunk_maps, trajectory_metrics, attention,
                attention_train_forward, attention_backward, observe_simple_pack,
                derive_action_values)
    if opts.data_parallel:  # phase 16 alone
        from mansy_immersivevideostreaming_torch.kernels import build
        build.build()
        t0 = time.time()
        result = data_parallel_phase(dev)
        print(json.dumps({"data_parallel": result, "card": card,
                          "seconds": time.time() - t0}))
        return 0
    if opts.limits:  # phase 2i and the paths past K8's earlier limits
        from mansy_immersivevideostreaming_torch.kernels import build
        build.build()
        t0 = time.time()
        parent = load_parent(opts.parent) if opts.parent else None
        rows = attention_limits_phase(dev, 0.0, parent)
        print(json.dumps({"phase_2i": rows, "card": card, "seconds": time.time() - t0}))
        for name, run in (("vp_test_long", vp_test_long_phase),
                          ("vp_train_long", vp_train_long_phase),
                          ("vp_train_wide", vp_train_wide_phase)):
            t0 = time.time()
            result = run(dev, counters, parent)
            print(json.dumps({name: result, "card": card, "seconds": time.time() - t0}))
        return 0
    if opts.vp_train:  # phase 11's step checks over trainings whose weights differ
        for run in range(opts.vp_train):
            result = vp_train_phase(dev, counters)
            print(json.dumps({"run": run, "card": card, "step": result["kernels_vs_plain"],
                              "his_window_96": result["his_window_96"]["kernels_vs_plain"]}))
        return 0

    t0 = time.time()
    parent = load_parent(opts.parent) if opts.parent else None
    rows = kernel_phase(dev, parent)
    expert_rows, extra = expert_kernel_phase(dev, parent)
    rows.update(expert_rows)
    for name, fields in extra.items():
        rows[name]["action_values"] = fields
    rows.update(training_kernel_phase(dev, parent))
    rows.update(viewport_kernel_phase(dev, parent))
    rows.update(attention_bf16_phase(dev, rows["attention"]["batch"]["timing_floor_ms"],
                                     parent))
    rows.update(simple_kernel_phase(dev))
    rows.update(derived_kernel_phase(dev, parent))
    for name, fields in widths_kernel_phase(dev, parent).items():
        rows.setdefault(name, {}).update(fields)
    t2i = time.time()
    for name, fields in attention_limits_phase(
            dev, rows["attention"]["batch"]["timing_floor_ms"], parent).items():
        rows.setdefault(name, {}).update(fields)
    log(f"phase 2i (K8 past its earlier limits) in {time.time() - t2i:.1f}s")
    log(f"kernels checked in {time.time() - t0:.1f}s")
    paths, trained = {}, {}
    for name, run in (("serve", lambda: serve_phase(dev, counters)),
                      ("collect", lambda: collect_phase(dev, counters)),
                      ("expert", lambda: expert_phase(dev, counters)),
                      ("serve_v16", lambda: serve_phase(dev, counters, "v16")),
                      ("serve_v18", lambda: serve_phase(dev, counters, "v18")),
                      ("train", lambda: train_phase(dev, counters)),
                      ("train_256", lambda: train_phase(dev, counters, 256)),
                      ("train_512", lambda: train_phase(dev, counters, 512, trained=trained)),
                      ("serve_512", lambda: serve_phase(dev, counters, "trained-512",
                                                        trained[512])),
                      ("train_64", lambda: train_phase(dev, counters, 64)),
                      ("train_160", lambda: train_phase(dev, counters, 160)),
                      ("dagger", lambda: dagger_phase(dev, counters)),
                      ("serve_av", lambda: serve_av_phase(dev, counters)),
                      ("train_av", lambda: train_phase(dev, counters, derived=True)),
                      ("dagger_av", lambda: dagger_av_phase(dev, counters)),
                      ("vp_test", lambda: vp_test_phase(dev, counters)),
                      ("vp_export", lambda: vp_export_phase(dev, counters)),
                      ("vp_train", lambda: vp_train_phase(dev, counters)),
                      ("vp_test_bf16", lambda: vp_test_phase(dev, counters, bf16=True)),
                      ("vp_train_bf16", lambda: vp_train_phase(dev, counters, bf16=True)),
                      ("vp_test_long", lambda: vp_test_long_phase(dev, counters, parent)),
                      ("vp_train_long", lambda: vp_train_long_phase(dev, counters, parent)),
                      ("vp_train_wide", lambda: vp_train_wide_phase(dev, counters, parent)),
                      ("simple_rl", lambda: simple_rl_phase(dev, counters, trained)),
                      ("simple_rl_test", lambda: simple_rl_test_phase(dev, counters, trained)),
                      ("ensemble", lambda: ensemble_phase(dev, counters)),
                      ("preprocess", lambda: preprocess_phase(dev)),
                      ("data_parallel", lambda: data_parallel_phase(dev))):
        t0 = time.time()
        paths[name] = run()
        paths[name]["phase_seconds"] = time.time() - t0
        log(f"{name} ({time.time() - t0:.1f}s): {json.dumps(paths[name])}")
    for tmp in trained.pop("dirs", []):
        tmp.cleanup()
    (paths["serve"]["step_profile"], paths["collect"]["step_profile"],
     paths["expert"]["decision_profile"]) = profile_phase(dev)
    log(f"serve step_profile: {json.dumps(paths['serve']['step_profile'])}")
    log(f"collect step_profile: {json.dumps(paths['collect']['step_profile'])}")
    log(f"expert decision_profile: {json.dumps(paths['expert']['decision_profile'])}")
    # the kernels-line rows (kernels and modes) each path runs; every one must
    # have launched on it
    serve = ("env_step", "observe_mansy_pack", "actor_critic_forward")
    training = ("actor_critic_train_forward", "policy_loss", "actor_critic_backward")
    wide = ("actor_critic_forward_h256", "actor_critic_train_forward_h256", "policy_loss",
            "actor_critic_backward_h256")
    simple = ("env_step", "observe_simple_pack", "actor_critic_forward_simple")
    instance = lambda suffix: tuple(f"{name}{suffix}" for name in (
        "actor_critic_forward", "actor_critic_train_forward", "actor_critic_backward"))
    at_width = lambda suffix: ("env_step", "observe_mansy_pack", "compute_gae", "policy_loss") \
        + instance(suffix)
    derived = ("env_step", "observe_mansy_pack_derived", "actor_critic_forward")
    path_kernels = {"serve": serve, "collect": serve,
                    "expert": ("env_step", "choose_action", "build_expert_tables"),
                    "serve_v16": serve + ("build_expert_tables",),
                    "serve_v18": ("env_step", "observe_mansy_pack", "actor_critic_forward_h256"),
                    "train": serve + ("compute_gae",) + training,
                    "train_256": ("env_step", "observe_mansy_pack", "compute_gae") + wide,
                    "train_512": at_width("_wide"),
                    "serve_512": ("env_step", "observe_mansy_pack", "actor_critic_forward_wide"),
                    "train_64": at_width("_h64"),
                    "train_160": at_width("_h192"),
                    "dagger": serve + ("choose_action",) + training,
                    "serve_av": derived,
                    "train_av": derived + ("compute_gae",) + training,
                    "dagger_av": derived + ("choose_action", "derive_action_values") + training,
                    "vp_test": ("attention", "tile_occupancy"),
                    "vp_export": ("attention", "tile_occupancy"),
                    "vp_train": ("attention_train_forward", "attention_backward"),
                    "vp_test_bf16": ("attention_bf16", "tile_occupancy"),
                    "vp_train_bf16": ("attention_train_forward_bf16", "attention_backward_bf16"),
                    "vp_test_long": ("attention", "attention_stream", "tile_occupancy"),
                    "vp_train_long": ("attention_train_forward", "attention_train_forward_stream",
                                      "attention_backward", "attention_backward_split"),
                    "vp_train_wide": ("attention_train_forward_wide", "attention_backward_wide",
                                      "attention_wide"),
                    "simple_rl": simple + ("compute_gae", "actor_critic_train_forward_simple",
                                           "policy_loss_a2c", "actor_critic_backward_simple"),
                    "simple_rl_test": simple,
                    "ensemble": serve + ("actor_critic_forward_h256",),
                    "data_parallel": serve + ("compute_gae",) + training + instance("_h64")
                    + ("attention_train_forward", "attention_backward")}
    for path, names in path_kernels.items():
        for name in names:
            if paths[path]["launches"].get(name, 0) == 0:
                raise AssertionError(f"{name} was not launched on the {path} path")
    for path, result in paths.items():
        if set(result["launches"]) - set(KERNELS):
            raise AssertionError(f"{path}: launches in rows the kernels line has not: "
                                 f"{set(result['launches']) - set(KERNELS)}")
    # row -> path -> launches of one pass of the path
    per_row = {row: {path: result["launches"].get(row, 0) for path, result in paths.items()}
               for row in KERNELS}
    for row, per_path in per_row.items():
        rows[row].update(launches=sum(per_path.values()), launches_per_path=per_path,
                         launches_per_step={path: n / paths[path]["steps"]
                                            for path, n in per_path.items()})
    kernels = [dict(name=name, **KERNELS[name], **rows[name]) for name in KERNELS]
    print(json.dumps({**{path: {k: v for k, v in r.items() if k != "launches"}
                         for path, r in paths.items()}, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
