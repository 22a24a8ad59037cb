"""Smoke run of the PyTorch/CUDA port (``neuraloperator_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and nvcc:

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds as it goes:

1. the card: requires CUDA, prints ``nvidia-smi``'s name and power limit;
2. build: compiles the CUDA kernels from ``neuraloperator_tpu_torch/csrc``
   and prints nvcc's registers and spills per kernel;
3. kernels: runs each kernel (K1 forward contraction, K2 its input
   gradient, K3 its weight gradient) against its plain PyTorch version at
   the flagship shapes (K1 at batches 1, 8 and 16, K2 and K3 at 8, each in
   f32 and bf16; at the Darcy recipe's, phase 15; at UNO's widest layer,
   phase 17; K2/K3 at UQNO's batch, phase 18; K1-K3 at the FNO-3D's and
   the multi-variable FNO's, phase 20; at the Burgers scripts' three,
   phase 21; at the GNO family's two, phase 22; at OTNO's, phase 23; at
   the model-sharded flagship's out-channel slice, 64 x 32 channels over
   2112 modes at batch 8, phase 25), and times the kernel,
   the plain version and one library
   call on the device (``_timing.device_ms``: the launches queued behind a
   device-side wait, so the CUDA events do not time the host's enqueue
   rate) beside the kernel's bound and the host's time per call, through
   the ``torch.library`` operator and launched directly; each is
   also checked, untimed, at the edge shapes (K1 and K2: more rows than a
   block holds, wider channels, more mode tiles than SMs, unaligned rows;
   K3: a ragged shape and slices too large for shared memory). Every check
   prints the plan its launcher chose, and two launches on the same inputs
   must agree bit for bit;
4. serve: loads the published flagship NS-128 FNO (``artifacts/ns128_v2``,
   the float16 copy of its best weights, evaluated in float32) at full width
   with the checkpoint's normalizers through ``models.load_flagship``,
   serves requests through ``CompiledForward``, checks every answer, K1's
   launch count and a batch-3 answer against the same file's model on the
   CPU, and probes the latency of each bucket;
5. data: generates the flagship's splits on the card through the port's
   ``scripts.generate_ns_data`` entry point into its default directory (the
   seeded pseudo-spectral solver at 128², 50 000 steps per trajectory):
   8 training trajectories (400 pairs, seed 0) and the 40 test
   trajectories of the evaluation (2000 pairs, seed 10 000);
   eval: reads that test split through ``eval_ns_checkpoint.load_test_split``
   and evaluates the loaded weights on it at batch 16 through
   ``scripts.eval_ns_checkpoint.evaluate``; checks (a) one record of the
   solver on the card against the CPU, (b) the first 16 pairs' losses on
   the card against the CPU, (c) rel_l2 and rel_h1 within twice the JAX
   package's figures for these weights' f32 original, and K1's launch
   count; last, a torch.profiler table of 200 solver steps;
6. train, in the same process after serving: builds the flagship FNO at
   full width with seeded weights, seeded 128² pairs (a fixed spectral
   filter of smooth inputs at the checkpoint normalizer's scale) and fitted
   normalizers, runs ``Trainer.train`` for 2 epochs with the flagship's
   factored AdamW and H1 loss, checks every metric is finite and the launch
   counts of K1, K2 and K3, times the train steps and reads the peak device
   memory; then runs one train step of batch 2 on the card and the same
   step on the CPU from the same weights, and compares the loss and every
   gradient; last, a torch.profiler table of two train steps (device time
   by kernel, and the device's idle share of the host-clock window);
7. recipe: the flagship training recipe (``scripts/run_flagship_v2.sh:43-53``)
   through the port's ``scripts.train_navier_stokes`` entry point at full
   width, cut to 400 training pairs: a fine-tune of 4 epochs warm-started
   from the published weights under their normalizers, with
   ``--device_dataset true`` (the staged set and the replayed CUDA graph of
   the step), ``--save_every 2 --save_best 128_l2``, then the recipe's
   relaunch, resumed from the saved state to epoch 6. Checks: (1) every
   evaluation of the fine-tune after the first, and the stored best,
   within (c)'s bounds, the first (after the fresh optimizer's warm-restart
   bump) within ten times them, (2) the resumed run
   starts at epoch 4 with the optimizer's count at 200 and ends at 300,
   (3) the resumed run never raises the stored best metric, (4) the saved
   best weights rebuild through ``models.from_checkpoint`` and score the
   manifest's best metric, (5) K1, K2 and K3 launched once per layer and
   step (K1 also per evaluation forward), counted from the graph's
   replays. Then the graphed staged epoch against the loader loop from the
   published weights over the same batches (parameters and losses), the
   step ms of each, the device's idle share over graphed steps, the seconds
   per save of ``model.msgpack`` and ``optimizer.msgpack``, and the peak
   device memory;
8. mixed: the JAX benchmark's mixed-precision policy at full width
   (``bench.py:212-226``; ``scripts/run_round4_post.sh:23-24``): (1) the
   published weights served through ``CompiledForward(param_dtype=bf16)``
   on the serve phase's requests (f32 arithmetic over bf16 weights), each
   answer against the CPU port's under the same policy and against the f32
   answer, then the same weights in the "mixed" model served on bf16
   inputs (K1's bf16 variant); (2) those weights in the flagship with
   ``weight_dtype="bfloat16"`` and ``fno_block_precision="mixed"``
   evaluated on the 2000 test pairs under the Trainer's half policy
   (``eval_ns_checkpoint.evaluate(mixed_precision=True)``), checked against
   bounds set from the JAX package's mixed forward of these weights, and
   its first 16 pairs against the CPU; (3) ``train_navier_stokes`` with the
   recipe phase's flags plus the three mixed flags, warm-started from the
   published weights: 2 epochs of 50 graphed steps, an evaluation at the
   end, ``model.msgpack`` reloaded through ``models.from_checkpoint`` and
   rescored; K1, K2 and K3 launched in bf16 only; the graphed mixed step's
   ms beside the recipe's f32 one, the idle share over 20 replays, a
   profile of two replays and the peak memory; (4) one mixed step of
   batch 2, card against CPU, from the published weights and from seeded
   ones;
9. superres: the flagship's zero-shot super-resolution
   (``scripts/eval_ns_superres.py``) through the port's entry point: 3 and 2
   test trajectories solved on the card at 256² and 512² by
   ``generate_ns_data``, the published weights scored at 128², 256² and
   512² (256, 150 and 100 pairs at batch 8, the DFT path at every size);
   128² held to (c)'s bounds, 256² and 512² to three times the JAX figures;
   the first 8 pairs at 256² card against CPU; K1's launch count;
10. rollout: ``scripts/eval_ns_rollout.py`` through the port's entry point
   at 128² on the 40 test trajectories, 10 steps from snapshot 10 (t=1 and
   t=10 held to three times the JAX figures), then with its pushforward
   fine-tune (1 epoch, K=4, on the 8 training trajectories: finite losses,
   t=10 within the JAX package's own figure after its pushforward
   fine-tune, the peak memory), K1-K3
   launched once per layer and rollout step, and one rollout step (K=2,
   batch 2) card against CPU;
11. options: ``train_navier_stokes`` with the recipe phase's flags, the
   mixed flags and each of ``--opt.opt_state factored8``,
   ``--opt.stochastic_rounding true`` and ``--opt.ema_decay 0.999``: one
   graphed epoch warm-started from the published weights, then one more
   resumed from its files, the resumed evaluation within twice the mixed
   fine-tune's; ``optimizer.msgpack`` against the live state to the bit;
   bf16 K1-K3 only; factored8's int8 codes, stochastic rounding's bf16
   parameters and two replays from one state drawing other noise, the
   EMA's printed evaluation; the graphed step's ms of each beside the mixed
   phase's;
12. quantize/export: (1) the published weights served through
   ``CompiledForward(quantize="int8")`` on the serve phase's requests
   (int8 codes and f32 scales resident, dequantized to bf16 in each
   forward, K1's f32 variant): the first two groups' answers against the
   CPU port's int8 answers, every answer's distance to the f32 answers, the resident bytes, the
   latency per bucket, and the 2000 test pairs scored within twice the JAX
   package's int8 figures for these weights; (2) ``export_forward`` of the
   published weights (symbolic batch) and ``serve_model --export`` with
   ``--bf16``: each graph holds the contraction operator once per layer and
   no einsum, and each artifact, loaded in turn by one fresh ``python3``
   process that switched TF32 on, answers batches 1, 3 and 8 within 1e-6 of the
   eager ``CompiledForward``, launching K1 once per layer and forward;
13. remat/scan: (1) one eager step of batch 8 from seeded weights with and
   without ``remat``: equal loss and gradients, K1 twice per layer, the
   peak memory of each; remat's graphed steps against the loop, and its
   step ms; (2) the published weights stacked into the scanned layout
   against the unrolled forward, ``train_navier_stokes --model.scan_layers
   true`` on the recipe's 400 pairs (one graphed epoch, then one more
   resumed from its files), ``model.msgpack`` rebuilt by
   ``models.from_checkpoint`` and rescored, the graphed scanned step's ms,
   and one scan+remat step card against CPU;
14. tfno: the flagship's architecture with Tucker rank-0.1 spectral weights
   (``--model.factorization tucker --model.rank 0.1``, 6,837,841
   parameters) from a seeded init: (1) ``train_navier_stokes`` with the
   recipe phase's flags, 2 graphed epochs then 1 resumed from the saved
   files (finite losses, the resume at epoch 2 from count 100,
   ``model.msgpack`` rebuilt by ``models.from_checkpoint`` and rescored),
   the graphed step's ms beside the recipe's FNO step, its idle share over
   20 replays, the peak memory, and an evaluation forward at batch 16; (2)
   one step of batch 2 and a batch-3 forward, card against CPU; (3) the
   trained weights contracted "reconstructed" (K1 per layer and forward,
   K2 and K3 per layer and step) against "factorized" (no kernel): the
   forward on 16 test pairs and one step's gradients; (4) ``serve_model``
   on the saved run (latency per bucket, resident bytes); (5)
   ``export_forward`` of it (symbolic batch) answered by phase 12's fresh
   ``python3`` process; (6) one graphed epoch under the mixed flags;
15. darcy: the Darcy recipe (``scripts/train_darcy.py``'s defaults: the
   FNO_Small2d width, 1000 training pairs at 16², tests at 16² and 32²)
   through the port's ``scripts.train_darcy`` entry point, its data
   generated on the host by ``load_darcy_flow_small`` into a temporary
   directory that phases 16-18 read too, cut to 3 epochs of the loader loop: finite losses, the
   training loss falling, the evaluations within twice the JAX script's
   own figures for the same cut on the same files, K1 once per layer and
   forward (steps and evaluation batches) and K2/K3 once per layer and
   step; the loop step's ms, a profile of 10 loop steps (the device's idle
   share), the peak memory, and one step of batch 2 card against CPU. The
   kernels phase also checks and times K1 at batches 8 and 16 and K2/K3 at
   8 at the recipe's 24 x 24 channels over 144 modes;
16. layer options: each new option of the FNO family at the Darcy width,
   card against CPU from the same seeded weights (a forward and one step's
   H1 gradients, K1-K3 once per layer): domain padding, the four norms
   (AdaIN on the blocks, with an embedding; BatchNorm's running
   statistics), preactivation, the tanh stabilizer, ``conv_bias_kernel=3``,
   complex data, a per-layer resolution scaling and a per-call
   ``output_shape`` (16² in, 32² out); then the published weights forward on
   a 128 x 1024 input (the rFFT/irFFT path), card against CPU, K1 once per
   layer, the transforms in the profile;
17. families: UNO, LocalNO and CODANO at their recorded widths
   (``scripts/train_family_quality.py``'s configurations: 407,521,
   703,465 and 219,721 parameters) through the port's
   ``scripts.train_family_quality`` entry point on the Darcy recipe's files
   (1000 training pairs at 16², tests of 100 at 16² and 50 at 32², made on
   the host by ``load_darcy_flow_small`` into a temporary directory), cut to
   2 epochs each on the first 400 training pairs, CODANO's on the first
   200 (see phase 24): finite losses, the training loss falling, each
   evaluation within twice the JAX script's own figure for the same cut on
   the same files, the parameter counts; K1 once per spectral layer and
   forward (steps and evaluation batches) and K2/K3 once per spectral
   layer and step for UNO and LocalNO, none for CODANO (its Tucker einsum
   chain); the loop step's ms, a profile of 2 loop steps (the device's
   idle share; cut from 10, see phase 24), the peak memory, and one step
   of batch 2 card against CPU from the same weights. The kernels phase
   also checks and times K1 at batches 8 and 16 and K2/K3 at 8 at UNO's
   widest layer (64 -> 32 channels over 8 x 5 modes);
18. uqno: the port's ``scripts.train_uqno_darcy`` at its defaults but for
   the epochs (the solution FNO 10 epochs through the ``Trainer``, the
   residual FNO 10 epochs of its autograd loop, each cut from 30 for the
   script's time, 1000 pairs at 16² split 600 / 250 /
   150, 100 test pairs) on the same files: the calibration indices equal
   to ``get_coeff_quantile_idx``'s on the host, the pointwise and
   function-level coverage held to the JAX script's CPU figures on the same
   files less a slack, the UQNO's solution getting no gradient, and K1-K3
   counted against the script's batches. The kernels phase also checks and
   times K2/K3 at the Darcy shapes at UQNO's batch of 16;
19. sfno: the port's ``scripts.train_sfno_swe`` at its defaults, whole (the
   SFNO of 296,707 parameters, 20 epochs on 200 pairs at 32x64 made on the
   host by the package's SWE generator, evaluated at 32x64 and zero-shot
   at 64x128): both figures within twice the JAX script's own on the CPU,
   the training loss falling, no launch of K1-K3 (its contractions are
   einsums, its transforms matmuls); the loop step's ms, a profile of 10
   loop steps (the device's idle share, kernels by kind), the peak memory,
   one step of batch 2 card against CPU, and ``sht``/``isht`` on the card
   against the CPU on both grids;
20. mhd and multivar: the port's ``scripts.train_mhd64`` at its defaults
   (the FNO-3D, 659,027 parameters, 5 epochs on its synthetic 16³ fields)
   and ``scripts.train_codano_multivar`` cut to 64 training pairs and 2 /
   1 / 2 epochs (``--no_results``): finite figures, K1-K3 launched as the
   batches ask (the FNO-3D's and the matched FNO's layers; CODANO's none),
   one FNO-3D step card against CPU. The kernels phase also checks and
   times K1-K3 at both FNOs' shapes (16 x 16 channels over 320 modes at
   batch 2; over 40 modes at batch 16);
21. burgers: the port's ``scripts.train_burgers`` (the FNO-1D through the
   ``Trainer``), ``train_burgers_pino`` (the PINO FNO on (t, x) with the
   data, initial-condition and Burgers-residual losses under ReLoBRaLo) and
   ``train_burgers_rno`` (the RNO over windows of 4 frames), each at its
   defaults, whole, on data made on the host into a temporary directory:
   figures within twice the JAX scripts' own on the CPU, K1-K3 launched as
   the batches and layers ask (48 K1 launches an RNO forward: 2 layers x 4
   frames x 6 gates), each script's wall seconds and eager loop step; one
   RNO step and a 5-step ``RNO.predict`` rollout card against CPU, a
   profile of 10 RNO loop steps, and ``BurgersEqnLoss`` and
   ``FourierDiff`` (without and with Legendre and Gram continuation) card
   against CPU. The kernels phase also checks and times K1-K3 at 24 x 24
   channels over 5 modes at batches 16 and 8 and over 40 modes at 8;
22. gno: the port's ``scripts.train_gino_carcfd`` and
   ``train_fnogno_carcfd`` with ``--data_source synthetic`` at full width
   (2048-vertex bodies, the 16³ latent grid, radius 0.25, 32 neighbours,
   the FNO at hidden 32 over (8, 8, 8) modes), cut to 16 training and 4
   test samples and 2 epochs, and ``train_poisson`` at its defaults,
   without and with ``--interior_weight 0.1`` (the interior residual through
   second derivatives with respect to the queries): finite figures within
   twice the JAX scripts' own for the same flags on the CPU, a falling
   training loss, K1-K3 launched as the steps and evaluations ask (the
   physics loss runs the model twice a step); each script's wall seconds
   and loop step; one GINO and one FNOGNO step card against CPU with the
   CPU's neighbourhoods fed to both, the padded searches card against CPU
   as sets (differences only at near ties), each Poisson run's figures and
   epoch losses against the same script run on the CPU from the same init
   (the figure bound alone cannot fail there), the Poisson interior loss
   and its gradient card against CPU, and a profile of 5 GINO loop steps. The
   kernels phase also checks and times K1-K3 at batch 1 at 32 x 32
   channels over 320 modes and at 24 x 24 over 40;
23. otno: the port's ``scripts.train_otno_carcfd --data_source synthetic``
   at full width (2048-vertex bodies, a 24² latent sphere grid, the OT maps
   by Sinkhorn in float64 on the card, OTNO at hidden 32 over (12, 12)
   modes, 4 layers), cut to 16 training and 4 test bodies and 2 epochs: a
   finite figure within twice the JAX script's own for the same flags on
   the CPU, a falling training loss, K1-K3 launched as the steps and
   evaluations ask; the same script on the CPU from the same init (every
   epoch's loss and test figure); one OTNO step card against CPU; one
   body's OT maps on the card against the numpy plain version (the plan,
   and the index maps but for near ties), with each solver's seconds; the
   loop step and a profile of 5 steps; then the modules no model builds,
   card against CPU: the legacy 1-D, 2-D, 3-D and joint-factorized
   spectral convolutions, the divergence-free projection (its output's
   divergence, its spectrum's Hermitian symmetry), the attention kernel
   integral with and without rotary embeddings, an FNO loaded through
   ``models.torch_import`` from a reference-layout state dict, and a
   ``save_checkpoint`` / ``load_checkpoint`` round trip to the bit. The
   kernels phase also checks and times K1-K3 at batch 1 at 32 x 32
   channels over 84 modes;
24. patching: the flagship recipe's flags with ``--patching.levels 1``
   (multigrid-patched FNO, MG-TFNO) through ``scripts.train_navier_stokes``
   at full width from seeded weights on phase 5's 400 pairs: 2 graphed
   epochs (saved), then a third on the loader loop resumed from the saved
   state, evaluated on the first 256 test pairs after each epoch; each
   128² field reaches the spectral layers as 4 patches of 84², so K1-K3 run
   at batch 32 in the steps and K1 at 64 in the evaluations, launched as
   those ask; finite figures and a falling training loss; the graphed and
   loop step ms beside the unpatched recipe's, the peak memory and the idle
   share over 5 replays. Then one patched step card against CPU, the
   patched staged epoch against the loop, ``patch`` then ``unpatch`` on the
   card to the bit (and against the CPU's patches); the incremental FNO
   example (``scripts.train_incremental_fno_darcy``) whole on the card
   (figures within twice the JAX example's), then for 5 epochs on the card
   and on the CPU under each of two sets of flags that grow the modes, once
   by the loss gap and once by the gradient criterion (the same modes every
   epoch on both, figures within 1e-3, and more modes at the end);
   Tensor-GaLore at flagship width (3 steps, refreshes at 1 and 3: the
   losses, then each step's update per leaf from the card's state) and the
   optimizer options
   (``max_grad_norm``, ``ReduceLROnPlateau``, ``reduce_on_plateau``; 3 steps
   each) card against CPU on 32² fields; ``PrefetchLoader`` against the
   plain loader to the bit; a ``ThroughputMeter`` over flagship forwards
   against CUDA events; a ``profiling.trace`` that names K1;
   ``scripts.compress_checkpoint`` on the published f16 weights (their
   f32 expansion compressed back to f16 byte for byte, and to bf16). The
   kernels phase also checks and times K1-K3 at batch 32 over the
   flagship's 64 x 64 channels and 2112 modes, and checks K1 at 64. For
   the script's time (it must end within 1200 s on a slower machine too),
   earlier paths were cut in depth: phase 17's profile window from 10
   steps to 2 and its runs to the first 400 training pairs (CODANO's to
   200; they were 1000, 1000 and 400), phase 9's trajectories at 256² and
   512² from 6 and 4 to 3 and 2, phases 22 and 23's profiles from 10 steps
   to 5, phase 15 from 5 epochs to 3 (and to 2 for phase 25's model axis),
   phases 22 and 23's car-CFD runs from 4 epochs to 2 (for phases 25(d)'s
   Tensor-GaLore and 26; JAX's figures retaken on the CPU),
   phase 18 from 30 + 30 epochs to
   10 + 10, phase 8's and phase 12's CPU answers to the first two of the
   six request groups, and the card-against-CPU pairs of phases 5 and 8 from 32 to 16;
   the exported artifacts of phases 12 and 14 share one fresh process,
   the solver replays its steps as CUDA graphs, and every profile
   window reads the profiler's raw events;
25. distribution: ``scripts.train_navier_stokes`` at full width from the
   published weights on the loader loop, 25 steps of batch 8 on phase 5's
   pairs and an evaluation of 32 test pairs, (a) without and with
   ``--distributed.use_distributed true`` (a world of one on NCCL, which
   skips the reductions over a group of one; one all-reduce of a small
   tensor on the world checks NCCL), (b) with it under ZeRO
   (``Trainer(zero_sharding=True)``, which cuts nothing at data size 1):
   metrics and parameters equal to the bit, K1-K3 launched once per layer
   and step (K1 also per evaluation forward), each step's ms and peak
   memory, ZeRO's peak no higher than (a)'s; (c) two spawned ranks sharing
   the card on gloo (NCCL refuses two ranks on one device), one
   data-parallel step of global batch 8 (4 rows a rank) of the seeded
   flagship against one rank's step on the 8 rows (the loss, and every
   gradient within STEP_GRAD_TOL against the larger of its norm and 1% of
   the whole gradient's), ZeRO against replicated to the bit, each rank's
   step ms and peak memory with and without ZeRO, ZeRO's no higher; (d) the
   model axis: the same two ranks (one spawn for (c) and (d)) at mesh
   (data 1, model 2), each holding its out-channel slice of the four spectral
   weights (half of their 69.2M values), one Trainer step of the seeded
   flagship on the 8 rows held to one rank's whole step as (c) is, K1-K3
   launched once per layer at the slice's shape (B=8, I=64, O=32, M=2112;
   the plans printed), each rank's step ms and peak memory beside a whole
   step's in the same process and (c)'s; then 2 steps, an async save of
   the orbax counterpart (``save_training_state_orbax`` over
   ``torch.distributed.checkpoint``), a restore into fresh modules and
   optimizer and 1 step, equal to the bit to 3 uninterrupted steps; and a
   msgpack save at model size 2 that this process (a world of one) reads
   to the bit of the gathered slices; then Tensor-GaLore (every leaf of two
   or more dims projected at rank 3, the spectral weights too, a
   refresh every 2 steps) on the same two ranks, at model size 2 (the
   whole leaf's HOSVD, each rank projecting its slice) and under ZeRO at
   data size 2, 2 steps each (a refresh, then a step between refreshes)
   in lockstep with one rank's whole-leaf step in the same process (each
   step from the sharded run's parameters and state): every loss within STEP_LOSS_TOL, each leaf's update within
   GALORE_UPDATE_TOL but for named known differences (diagonal cores,
   kept singular values that nearly tie or vanish), never a sliced
   spectral weight; the factors equal on both ranks, the state's bytes per
   rank against the whole; and ZeRO with Tensor-GaLore at world size 1 on
   NCCL equal to the plain loop to the bit. Gloo runs no
   ``all_to_all`` and no point-to-point send on CUDA tensors, so the sharded
   FFT (``DistributedSpectralConv2d``) and the halo exchange are held on the
   CPU only (``tests/test_torch_distributed_fft.py``);
26. well: the_well's schema on the card. train_mhd64's FNO-3D (n_modes 8³,
   hidden 16, 4 layers) at 64³, the resolution of the_well's MHD_64, fed
   windows of 2 input steps (time as channels) and one constant field in
   the_well's layout (channels last), cut from trajectories made here from
   a seed by train_mhd64's synthetic fields and diffusion step, through
   ``TheWellDataProcessor`` (fitted channel-wise normalizers) and the
   ``Trainer``: 3 loader-loop epochs, then an autoregressive evaluation of
   3 steps (``format_rollout_batch``, ``ar_feedback``). Checks: finite
   losses, the training loss falling, K1-K3 launched once per layer and
   step (K1 also per rollout step) at (2, 16, 16, 320), one step and one
   rolled-out batch card against CPU from the same weights. Prints the
   step's ms, the idle share of 3 loop steps, the peak memory and the
   rollout's seconds;
27. prints one ``{"kernels": [...]}`` line, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Any failed phase raises and the script exits non-zero without the last
line. It imports nothing of JAX.
"""

import atexit
import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "artifacts" / "ns128_v2"
SEED = 0
SOURCE = "neuraloperator_tpu_torch/csrc/spectral_contraction.cu"
PALLAS = "neuraloperator_tpu/ops/pallas/spectral_contraction.py"

# NVIDIA H100 SXM data sheet: HBM3 rate and dense peaks by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
L2_BYTES = 50 * 2**20

# the flagship's spectral contraction: 64 x 64 channels over 64 x 33 modes
CHANNELS, MODES = 64, 64 * 33
TRAIN_BATCH = 8
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
SERVE_TOL = 1e-4
# checked off the flagship shape, untimed: (B, (I, O), M)
K3_EDGE_SHAPES = ((13, (66, 20), 77), (32, (128, 128), MODES))
# K1 and K2: more rows than a block holds (17, 32), wider channels, more
# mode tiles than SMs, and rows that are not 16-byte aligned
K12_EDGE_SHAPES = ((17, (64, 64), MODES), (32, (64, 64), MODES), (32, (128, 128), MODES),
                   (8, (64, 64), 4 * MODES), (13, (66, 20), 77), (5, (7, 9), 100))
REQUESTS = (3, 1, 8, 3, 8, 1)
BUCKETS = (1, 8)
# the published weights the serve and eval phases load: the f16 copy, the
# one checkpoint .chiprunignore lets into the copy sent to the GPU machine
CHECKPOINT = "best_model_f16"

# the eval phase: scripts/eval_ns_checkpoint.py's protocol on the test split
# of scripts/generate_ns_data.py (40 trajectories, seed 10 000)
EVAL_BATCH, EVAL_PAIRS, EVAL_RES = 16, 2000, 128
# (a) one record (1000 steps) of 2 trajectories, card against CPU: relative
# l2 per snapshot. Measured 1.7e-7 on an H100 (cuFFT against pocketfft, the
# same float32 steps), and the CPU port reads 1e-6 against JAX's CPU solver
# (tests/test_torch_ns_solver.py): 1e-5 admits FFT rounding, not a step the
# card computes differently.
SOLVER_TOL = 1e-5
SOLVER_PROFILE_STEPS = 200
# (b) the first 16 pairs (one evaluation batch) through evaluate, card
# against CPU: each figure
EVAL_CPU_PAIRS, EVAL_CPU_TOL = 16, 1e-4
# (c) twice the JAX package's figures for the f32 weights (BASELINE.md:
# rel_l2 0.000232, rel_h1 0.000395). The f16 copy's rounding raises l2 by
# about 70%; a 0.23% normalizer mismatch alone gives 5.68e-4
# (BASELINE.md:1078-1084), and wrong weights score orders of magnitude more.
REL_L2_BOUND, REL_H1_BOUND = 4.6e-4, 7.9e-4

# the training phase: the flagship v2 run's optimizer (scripts/run_flagship_v2.sh)
OPT = SimpleNamespace(learning_rate=3e-5, weight_decay=1e-4, step_size=50, gamma=0.5,
                      opt_state="factored")
TRAIN_BATCHES, TEST_BATCHES, EPOCHS = 4, 1, 2
# One step on the card against the same step on the CPU, f32 on both with
# TF32 off: the loss sums 2 x 128² points in another order on each device
# (relative error ~1e-7 per sum), so 1e-5; a gradient is a chain of such
# sums through 4 spectral layers, DFT matmuls and channel MLPs, whose
# rounding compounds, so 1e-4 per parameter (the small on-card test holds
# the same bound, tests/test_torch_on_card.py).
STEP_LOSS_TOL, STEP_GRAD_TOL = 1e-5, 1e-4

# the recipe phase: scripts/run_flagship_v2.sh:43-53, cut to 400 training
# pairs (8 trajectories) and 4 + 2 epochs, warm-started from the published
# weights under their own normalizers (fitted on 20 000 pairs; a refit on
# 400 shifts every input, BASELINE.md:1078-1084)
RECIPE_TRAIN_TRAJ, RECIPE_EPOCHS, RECIPE_RESUMED_EPOCHS = 8, 4, 6
RECIPE_PAIRS = RECIPE_TRAIN_TRAJ * 50
RECIPE_FLAGS = [
    "--data.n_train", str(RECIPE_PAIRS), "--data.train_resolution", "128",
    "--data.n_tests", f"[{EVAL_PAIRS}]", "--data.test_resolutions", "[128]",
    "--data.test_batch_sizes", f"[{EVAL_BATCH}]", "--data.batch_size", str(TRAIN_BATCH),
    "--model.n_modes", "[64,64]", "--model.hidden_channels", "64",
    "--model.projection_channel_ratio", "4",
    "--opt.learning_rate", "3e-5", "--opt.weight_decay", "1e-4",
    "--opt.training_loss", "h1", "--opt.step_size", "50", "--opt.gamma", "0.5",
    "--opt.opt_state", "factored", "--opt.mixed_precision", "false",
    "--device_dataset", "true", "--eval_interval", "2", "--save_every", "2",
    "--save_best", "128_l2", "--normalizer_from", str(FLAGSHIP),
]
# (1) the fine-tune's evaluations. A fresh optimizer state knocks the
# converged weights off their optimum in the first epoch, and they climb
# back: fresh Adam's bias-corrected first steps move every weight by about
# lr. The JAX package records this warm-restart bump (BASELINE.md:1127-1131:
# a converged 2e-4 model knocked to ~5.5e-4 in the first epoch at lr 2e-5;
# scripts/run_flagship_v2.sh's header), and the port shows it at the first
# evaluation, after 50 steps at lr 3e-5 (128_l2 1.17e-3 on an H100). So
# (c)'s bounds hold from the second evaluation on and for the stored best,
# and the first evaluation is held to ten times them: weights that were not
# taken, or wrong normalizers, score orders of magnitude more.
FIRST_EVAL_FACTOR = 10.0
# (4) the rebuilt best weights against the manifest's best metric: the same
# forwards on the same pairs, summed per batch ("sum" reduction) in the
# Trainer and weighted batch means in evaluate, so float64 sums of f32
# losses in another grouping
BEST_RELOAD_TOL = 1e-5
# the graphed staged epochs against the loader loop from the same weights
# over the same batches, the loop fed the staged path's precomputed H1
# denominators (with them, H1 takes one stencil pass on the difference, which
# rounds unlike two passes; tests/test_torch_trainer_recipe.py holds that
# precompute to the JAX package): the same kernels on the same inputs, but
# cuBLAS may pick other kernels under capture (1e-7 relative per sum). The
# bf16 first moment turns such differences into whole bf16 ulps of single
# updates, and the loss, a 2-3% residual, magnifies a parameter difference
# some 40-fold; the published weights are all nonzero
GRAPH_TOL = 1e-5
GRAPH_EPOCHS, GRAPH_SEED, GRAPH_PROFILE_STEPS = 2, 11, 20

# the mixed phase: the JAX package's mixed-precision run
# (scripts/run_round4_post.sh:23-24) on the flagship
MIXED_MODEL = {"weight_dtype": "bfloat16", "fno_block_precision": "mixed"}
MIXED_FLAGS = {"--model.weight_dtype": "bfloat16", "--model.fno_block_precision": "mixed",
               "--opt.mixed_precision": "true"}
MIXED_EPOCHS = 2
# Bounds from the JAX package's own mixed forward of the published weights
# (a CPU probe on two 128² unit-variance Gaussian random fields): bf16
# weights with f32 arithmetic sit 2.5e-3 (l2) from the f32 forward, the
# "mixed" policy 6.0e-3 (l2) and 5.4e-2 (H1; bf16 rounding noise is high
# frequency). So: a served answer over bf16 weights within 1e-2 of the f32
# answer, the mixed served answer within 2e-2; the mixed evaluation at
# rel_l2 <= 2e-2 and rel_h1 <= 1.5e-1 (the f16 weights score 3.3e-4 / 3.5e-4
# in f32; wrong weights or normalizers score about 1).
MIXED_SERVE_F32_TOL, MIXED_POLICY_F32_TOL = 1e-2, 2e-2
# the serve phase's white-noise requests: on an H100 bf16 weights read
# 1.9e-2 from the f32 answers there (2.4e-3 on the test inputs; the card and
# the CPU agree to 9e-7, and the CPU tests hold this path to JAX at 1e-5),
# the mixed policy 3.3e-2 (5.8e-3), and the card's mixed answers 2.3e-2 from
# the CPU's: a bound that only wrong weights or casts (about 1) cross
NOISE_F32_TOL = 1e-1
MIXED_L2_BOUND, MIXED_H1_BOUND = 2e-2, 1.5e-1
# card against CPU under the same bf16 policy: the two pipelines round the
# same operands at the same points and differ in the order of f32 sums
# alone, which flips a bf16 rounding now and then. A served answer within
# 2e-2 (the distance of two rounding orders of one JAX forward, jitted and
# eager, on the CPU: 1e-2); the 16 pairs' figures within 10% of each other;
# one step: the loss within 1e-2 relative, the gradients within 5e-2
# relative l2 (each leaf against the larger of its norm and 1% of the whole
# gradient's: the biases' gradients are sums that cancel)
MIXED_SERVE_CPU_TOL, MIXED_EVAL_CPU_TOL = 2e-2, 0.1
# the CPU answers the first two groups of each set (3 + 1 inputs) under the
# bf16 policies here and under int8 in the quantize phase, for the script's
# time: its forwards at full width are slow on the host
CPU_REQUEST_GROUPS = 2
MIXED_STEP_LOSS_TOL, MIXED_STEP_GRAD_TOL = 1e-2, 5e-2
# ... except at the published weights, where the loss is bf16 noise and the
# gradients of two pipelines read 8.2e-2 apart on an H100 (all together; up
# to 0.28 per leaf): a bound that only a step on other weights or data
# (about 1) crosses
MIXED_STEP_NOISE_GRAD_TOL = 0.25
# the saved mixed weights rebuilt and rescored: the same bf16 forwards
MIXED_RELOAD_TOL = 1e-6

# the superres phase: scripts/eval_ns_superres.py's defaults (256 pairs at
# most, batch 8) on test trajectories solved on the card at each resolution,
# 50 pairs per trajectory; the JAX record's 256 pairs at 256² and 200 at 512²
# (BASELINE.md:930-937) are cut to half for phase 24's time
SUPERRES_RES, SUPERRES_TRAJ = (128, 256, 512), {256: 3, 512: 2}
SUPERRES_PAIRS, SUPERRES_BATCH = 256, 8
# three times the JAX figures (BASELINE.md:936-937), a reference taken on
# another checkpoint under refit normalizers, not a target; 128² is held to
# (c)'s bounds
SUPERRES_BOUNDS = {256: (3 * 0.00327, 3 * 0.00341), 512: (3 * 0.00463, 3 * 0.00505)}
# the first 8 pairs at 256², card against CPU: the eval phase's (b)
SUPERRES_CPU_PAIRS = 8
# the rollout phase: scripts/eval_ns_rollout.py at 128² on the 40 test
# trajectories, from snapshot 10, 10 steps: three times the JAX figures at
# t=1 and t=10 (BASELINE.md:939-944: 5.1e-4 and 3.34e-3)
ROLLOUT_HORIZON, ROLLOUT_BOUNDS = 10, {1: 1.5e-3, 10: 1.0e-2}
# the pushforward fine-tune: 1 epoch at K=4 on the 8 training trajectories.
# The JAX package records pushforward on converged weights as a loss
# (BASELINE.md:948-955: 2 epochs took its t=10 from 0.00334 to 0.00712, its
# t=1 from 0.00051 to 0.00391): a fresh AdamW's first steps move every
# weight by about lr, and the rollout falls to that noise floor whatever it
# started from (on an H100 these weights went from 1.05e-3 to 4.03e-3 at
# t=10). So no gain is asked: t=10 after it stays within the JAX package's
# own figure after its fine-tune; training on wrong targets or a broken
# feedback scores about 1
ROLLOUT_K, PUSHFORWARD_T10_BOUND = 4, 0.00712
# one rollout step (K=2, batch 2) card against CPU: f32 on both, the train
# phase's bounds
ROLLOUT_STEP_K = 2
# the options phase: the recipe's flags, the mixed flags and each option of
# scripts/run_round4_post.sh:26-33, one graphed epoch then one resumed
OPTIONS = {"factored8": {"--opt.opt_state": "factored8"},
           "stochastic_rounding": {"--opt.stochastic_rounding": "true"},
           "ema": {"--opt.ema_decay": "0.999"}}
# the resumed run's evaluation (after 100 steps, as many as the mixed
# fine-tune's) within twice the mixed fine-tune's figures
OPTIONS_EVAL_FACTOR = 2.0

# the quantize/export phase: int8 weight-only serving and exported forwards
# of the published weights. Bounds of the int8 evaluation: twice the JAX
# package's own int8 figures for these weights (f16 copy widened to f32),
# from neuraloperator_tpu.serving.CompiledForward(quantize="int8") on the
# CPU over the test split's first pairs that a CPU can make, the 40 pairs
# of its trajectories' first record (w0 -> w(1), seed 10 000; the slow test
# tests/test_torch_quantize_export.py::test_chip_smoke_int8_bounds_are_jax_figures
# recomputes them): rel_l2 0.002264, rel_h1 0.004132 (f32: 0.001734 /
# 0.004037 on those pairs; the int8 answers sit 2.9e-3 relative l2 from the
# f32 ones on average). The f32 weights score 3.3e-4 on all 2000 pairs, wrong
# weights or normalizers about 1.
INT8_L2_BOUND, INT8_H1_BOUND = 2 * 0.002264, 2 * 0.004132
# an artifact loaded in a fresh process with TF32 switched on, against the
# eager forward: the same kernels on the same inputs with TF32 off in both
# (the artifact runs its matmuls with it off); 1e-6 admits a cuBLAS kernel
# chosen for another batch shape (the eager forward pads to its bucket)
EXPORT_TOL, EXPORT_BATCHES = 1e-6, (1, 3, 8)
# the remat/scan phase: seeded flagship weights at batch 8
REMAT_STEPS = 4
# the tfno phase: the flagship's architecture with Tucker rank-0.1 spectral
# weights (scripts/train_navier_stokes.py:8; the JAX package's TFNO_Medium2d),
# from a seeded init (no TFNO checkpoint exists): the recipe's flags, 2
# graphed epochs, then 1 resumed
TFNO_FLAGS = ["--model.factorization", "tucker", "--model.rank", "0.1"]
TFNO_PARAMS, TFNO_EPOCHS = 6_837_841, 2
# the same trained weights contracted "reconstructed" (the weight rebuilt
# from its factors, then K1-K3) against "factorized" (the Tucker einsums):
# the same f32 arithmetic in another order. The forward on 16 test pairs
# within 1e-5 relative l2; one train step's gradients within 1e-4 per leaf,
# the card-against-CPU bound of a step
TFNO_IMPL_PAIRS, TFNO_IMPL_TOL, TFNO_IMPL_GRAD_TOL = 16, 1e-5, 1e-4
# a batch-3 forward of the seeded TFNO, card against CPU: the serve phase's bound
TFNO_FORWARD_TOL = 1e-4
# the darcy phase: scripts/train_darcy.py's recipe (config.DarcyConfig: the
# FNO_Small2d width, 16x16 modes, hidden 24, 4 layers; 1000 training pairs
# at 16², tests of 100 at 16² and 50 at 32²; batch 8, evaluations at 16),
# the data generated on the host by the port's load_darcy_flow_small, cut to
# DARCY_EPOCHS epochs. Its contraction: 24 x 24 channels over 16 x 9 modes
DARCY_CHANNELS, DARCY_MODES, DARCY_EVAL_BATCH = 24, 16 * 9, 16
# (cut for the script's time: from 5 epochs to 3, then to 2)
DARCY_EPOCHS = 2
# The evaluations after the cut, within twice the JAX package's own figures
# for the same cut on the same generated files: its scripts/train_darcy.py on
# the CPU, 2 epochs from the seed-0 files (1000 + 100 + 100 pairs, which the
# port's generator writes to the bit), read 16_l2 0.11112, 16_h1 0.13574,
# 32_l2 0.14391, 32_h1 0.30092 (its Trainer's PRNGKey(0) init; the same
# procedure at 3 epochs gives back the 3-epoch figures 0.09242, 0.12104,
# 0.10870 and 0.30638 to the digit). The port starts from its own seeded
# init, and a short run moves by some 10% from epoch to epoch; an untrained
# model reads about 1.
DARCY_BOUNDS = {"16_l2": 2 * 0.11112, "16_h1": 2 * 0.13574,
                "32_l2": 2 * 0.14391, "32_h1": 2 * 0.30092}
DARCY_PROFILE_STEPS = 10
# the options phase: each new layer option of the FNO family at the Darcy
# width (16x16 modes, hidden 24, 4 layers) on a batch of 8 at 16², card
# against CPU from the same seeded weights: the forward within 1e-5 relative
# l2 (TF32 off on both), one step's H1 gradients within 1e-4 per leaf
# against the larger of the leaf's norm and 1% of the whole gradient's (a
# conv bias before a norm has a zero gradient, in rounding noise); BatchNorm's
# running statistics within 1e-5
OPTION_FORWARD_TOL, OPTION_GRAD_TOL = 1e-5, 1e-4
OPTION_CASES = {
    "domain_padding": ({"domain_padding": 0.125}, {}),
    "instance_norm": ({"norm": "instance_norm"}, {}),
    "group_norm": ({"norm": "group_norm", "norm_groups": 4}, {}),
    "batch_norm": ({"norm": "batch_norm"}, {}),
    "preactivation": ({"preactivation": True}, {}),
    "stabilizer": ({"stabilizer": "tanh"}, {}),
    "conv_bias_kernel": ({"conv_bias_kernel": 3}, {}),
    "complex_data": ({"complex_data": True}, {}),
    "resolution_scaling_factor": ({"resolution_scaling_factor": [1, 2, 1, 0.5]}, {}),
    "output_shape": ({}, {"output_shape": (32, 32)}),
}
# the FFT path at the flagship's width: the published weights on an input
# whose last axis is over 512 points (rFFT in, irFFT out), card against CPU
# within the serve phase's bound
FFT_SHAPE = (1, 1, 128, 1024)
# the families phase: scripts/train_family_quality.py's recorded
# configurations on the Darcy recipe's files, FAMILY_EPOCHS epochs each at
# batch 8 (125 steps an epoch) with evaluations after each (7 + 4 batches of
# 16), the spectral layers that reach K1-K3 (CODANO's are Tucker, contracted
# by einsums), and the parameter counts of BASELINE.md:722-726
FAMILIES = ("uno", "local_no", "codano")
FAMILY_EPOCHS = 2
# the training pairs of each family's cut, for the script's time (the
# steps are host-bound; CODANO's ~0.3 s each): the first 400 pairs of the
# 1000, and CODANO's first 200
FAMILY_N_TRAIN = {"uno": 400, "local_no": 400, "codano": 200}
FAMILY_SPECTRAL_LAYERS = {"uno": 5, "local_no": 4, "codano": 0}
FAMILY_PARAMS = {"uno": 407_521, "local_no": 703_465, "codano": 219_721}
# Each evaluation after the cut within twice the JAX package's own figure for
# the same cut on the same files: its scripts/train_family_quality.py on the
# CPU, 2 epochs on the seed-0 files (1000 + 100 + 100 pairs, which the port's
# generator writes to the bit) with ``--n_train`` as FAMILY_N_TRAIN, from its
# Trainer's PRNGKey(0) init. The port starts from its own seeded init (on
# the CPU at these cuts, 16_l2 0.15850 / 0.09482 / 0.48863); an untrained
# model reads about 1 in l2.
FAMILY_JAX = {
    "uno": {"16_l2": 0.14937, "16_h1": 0.28754, "32_l2": 0.15999, "32_h1": 0.43364},
    "local_no": {"16_l2": 0.16090, "16_h1": 0.29706, "32_l2": 0.19326, "32_h1": 0.54839},
    "codano": {"16_l2": 0.51661, "16_h1": 1.39935, "32_l2": 0.54727, "32_h1": 1.80804},
}
FAMILY_BOUNDS = {fam: {k: 2 * v for k, v in figures.items()}
                 for fam, figures in FAMILY_JAX.items()}
# cut from 10 for phase 24's time: the profiler's processing of 10 CODANO
# steps' events took 77 s of a 1050.6 s run of the whole script, of 4 40 s
FAMILY_PROFILE_STEPS = 2
# UNO's widest spectral layer (block 3: 32 + 32 channels in, 32 out, 8 x 5 modes)
UNO_CHANNELS, UNO_MODES = (64, 32), 8 * 5
# the uqno phase: scripts/train_uqno_darcy.py at its defaults on the same
# files. The JAX script on the CPU on these files, from its PRNGKey(0) and
# (1) inits, printed pointwise coverage 0.997 and function coverage 1.000
# (domain_idx 5, function_idx 4, scale 3.9976, mean band 0.00109). The
# port's run, from its own seeded inits, must cover as well less a slack of
# 0.05: a band trained from another init covers otherwise (the README's
# runs read function coverage 0.970-1.000), and the slack keeps each floor
# at or above what the calibration promises (0.9 of the points, 0.95 of
# the functions)
UQNO_BATCH = 16
# cut from the script's 30 + 30 epochs for the script's time: the coverage
# comes from the calibration on held-out pairs, not from the band's fit
# (the port on the CPU at this cut: pointwise 0.995, function 0.980; at
# 30 + 30 on the card: 0.996 and 1.000)
UQNO_EPOCHS = 10
UQNO_JAX = {"pointwise": 0.997, "function": 1.000}
UQNO_SLACK = {"pointwise": 0.05, "function": 0.05}

# the sfno phase: scripts/train_sfno_swe.py at its defaults, whole (200 pairs
# at 32x64 from the package's SWE generator, tests of 40 at 32x64 and 64x128,
# batch 32, the SFNO at n_modes (16, 32), hidden 64, 2 layers, 20 epochs of
# AdamW over a cosine annealing). Its figures within twice the JAX script's
# own at its defaults on the CPU, on the same data (the two generators agree
# within 2e-7, tests/test_torch_sfno.py), from its Trainer's PRNGKey(0) init:
# (32, 64)_l2 0.00472, (64, 128)_l2 0.00473. The port starts from its own
# seeded init; an untrained model reads about 1.
SFNO_PARAMS = 296_707
SFNO_JAX = {"(32, 64)_l2": 0.00472, "(64, 128)_l2": 0.00473}
SFNO_BOUNDS = {k: 2 * v for k, v in SFNO_JAX.items()}
SFNO_PROFILE_STEPS = 10
# the SHT on the card against the CPU: f32 matmuls summed in another order
# (TF32 off in the DFT matmuls; the Legendre einsums at setup()'s "highest")
SHT_TOL = 1e-5
# the mhd and multivar phase: scripts/train_mhd64.py at its defaults (the
# FNO-3D at n_modes (8, 8, 8), hidden 16, on 16 + 4 synthetic pairs at 16³,
# batch 2, 5 epochs): its contraction is 16 x 16 channels over 8 x 8 x 5 =
# 320 kept modes; scripts/train_codano_multivar.py cut to MULTIVAR_FLAGS,
# whose parameter-matched FNO (hidden 16, 2 layers, 8 x 8 modes) contracts
# 16 x 16 channels over 8 x 5 = 40 modes at batch 16
MHD_CHANNELS, MHD_MODES, MHD_BATCH = 16, 8 * 8 * 5, 2
MULTIVAR_FLAGS = ["--n_train", "64", "--n_test", "32", "--pretrain_epochs", "2",
                  "--ft_epochs", "1", "--full_epochs", "2", "--no_results"]
MULTIVAR_CHANNELS, MULTIVAR_MODES, MULTIVAR_BATCH = 16, 8 * 5, 16
# the burgers phase: scripts/train_burgers.py, train_burgers_pino.py and
# train_burgers_rno.py at their defaults, whole, on data the port makes into
# a temporary directory. Their figures within twice the JAX scripts' own on
# the CPU at their defaults: train_burgers on the port's pairs (the JAX
# generator's hold non-finite solutions, ROADMAP §C) 16_h1 0.06928, 16_l2
# 0.07029; the PINO on its package's tracked files (2e-7 from the port's)
# test l2 1.5795055627822876; the RNO test l2 1.7771174907684326. Each port
# script starts from its own seeded init. Their contractions: 24 x 24
# channels over 8 // 2 + 1 = 5 modes (the FNO-1D at batch 16; every gate of
# every RNO cell at batch 8) and over 8 x 5 = 40 (the PINO FNO at batch 8).
BURGERS_JAX = {"train_burgers": {"16_h1": 0.06928, "16_l2": 0.07029},
               "train_burgers_pino": {"test_l2": 1.5795055627822876},
               "train_burgers_rno": {"test_l2": 1.7771174907684326}}
BURGERS_BOUNDS = {script: {k: 2 * v for k, v in figures.items()}
                  for script, figures in BURGERS_JAX.items()}
BURGERS_CHANNELS = 24
BURGERS_SHAPES = (("burgers", 16, 5), ("rno", 8, 5), ("pino", 8, 40))
# an RNO forward: 2 layers x a window of 4 x 6 gates, each one K1 launch
RNO_LAUNCHES_PER_FORWARD = 2 * 4 * 6
# the RNO loop step timed over 10 steps, profiled over 3 (the profiler's
# own processing of a step's ~2,800 launches takes seconds)
RNO_TIMED_STEPS, RNO_PROFILE_STEPS = 10, 3
RNO_ROLLOUT_STEPS = 5
# card against CPU in f32: the equation loss and its gradient, and the
# spectral derivatives of a periodic field, relative to the largest value;
# with continuation, relative to the largest derivative on the continued
# domain, where cuFFT and pocketfft round on fields up to 475x the input
# per axis (an H100 read 3.8e-5 for a second derivative)
BURGERS_LOSS_TOL, BURGERS_FC_TOL = 1e-5, 1e-4

# the gno phase: scripts/train_gino_carcfd.py and train_fnogno_carcfd.py on
# the synthetic car-CFD set (2048-vertex bodies, 16³ latent / SDF grid, the
# FNO at 32 channels over 8 x 8 x 5 = 320 modes) cut from 100 + 20 samples
# and 20 epochs to 16 + 4 and 2 (4 before the well phase), and
# scripts/train_poisson.py at its
# defaults (the 2-D FNOGNO at 24 channels over 8 x 5 = 40 modes), without and
# with --interior_weight 0.1. Their final figures within twice the JAX
# scripts' own for the same flags on the same generated data, on the CPU:
# GINO test l2 0.60408, FNOGNO 0.61464 (printed to 5 decimals; at 4
# epochs 0.54467 and 0.48452), the Poisson
# test samples 1.2890855073928833 and 1.771366000175476, with the physics
# loss 4.2353596687316895 and 4.090581893920898. Each port script starts
# from its own seeded init.
GNO_CUT = {"n_train": 16, "n_test": 4, "n_epochs": 2, "eval_interval": 2}
GNO_CUT_FLAGS = ["--data_source", "synthetic",
                 *[a for k, v in GNO_CUT.items() for a in (f"--{k}", str(v))]]
GNO_JAX = {"train_gino_carcfd": [0.60408], "train_fnogno_carcfd": [0.61464],
           "train_poisson": [1.2890855073928833, 1.771366000175476],
           "train_poisson_interior": [4.2353596687316895, 4.090581893920898]}
GNO_BOUNDS = {script: [2 * v for v in figures] for script, figures in GNO_JAX.items()}
POISSON_INTERIOR_FLAGS = ["--interior_weight", "0.1"]
# At its defaults the Poisson recipe does not fit (test l2 above 1 in both
# packages), so the bound above would pass a wrong answer. Its real check:
# the same script on the host from the same seeded init (the same weights on
# the card and the CPU under one torch build, not across builds), each
# epoch's loss and each test figure within this, relative. The recipe's 40
# steps do not amplify rounding, so the card and the CPU stay close; a wrong
# kernel or search moves the figures at their first digits.
POISSON_CPU_TOL = 1e-4
# the FNO layers' contractions at batch 1: (recipe, batch, channels, modes)
GNO_SHAPES = (("gno", 1, 32, 8 * 8 * 5), ("poisson", 1, 24, 8 * 5))
GNO_TIMED_STEPS, GNO_PROFILE_STEPS = 10, 5
# the padded search, card against CPU, as sets: a query's kept set may
# differ only by points whose float64 squared distance lies within this of
# its cut (its k-th squared distance, or the radius squared), some 40x the
# f32 rounding of the expanded form |q|² + |p|² - 2 q·p on the unit cube
NEIGHBOR_TIE_MARGIN = 1e-5

# the otno phase: scripts/train_otno_carcfd.py --data_source synthetic at
# full width (2048-vertex bodies, a 24² latent sphere grid, reg 5e-3, 200
# Sinkhorn iterations, OTNO at hidden 32 over 12 x 7 = 84 modes, 4 layers),
# cut from 100 + 20 bodies and 30 epochs to 16 + 4 and 2 (4 before the well
# phase). Its final figure within twice the JAX script's own for the same
# flags on the same bodies, on the CPU: test l2 0.61334 (printed to 5
# decimals; at 4 epochs 0.51777). The port's seeded
# init differs between torch builds (trunc_normal_), so the card run is
# also held to the same script on this machine's CPU from the same init:
# every epoch's loss and each test figure within OTNO_CPU_TOL, relative.
OTNO_CUT = {"n_train": 16, "n_test": 4, "n_epochs": 2, "eval_interval": 2}
OTNO_CUT_FLAGS = ["--data_source", "synthetic",
                  *[a for k, v in OTNO_CUT.items() for a in (f"--{k}", str(v))]]
OTNO_JAX = 0.61334
OTNO_CPU_TOL = 1e-4
# its contraction at batch 1: 32 x 32 channels over 84 modes
OTNO_SHAPE = ("otno", 1, 32, 12 * 7)
OTNO_TIMED_STEPS, OTNO_PROFILE_STEPS = 10, 5
# the card's Sinkhorn (float64, torch.logsumexp) against the numpy plain
# version on one mesh: the plan within OT_PLAN_TOL of the largest entry; an
# index map may differ only where the two choices' entries lie within
# OT_TIE_MARGIN of the row's (column's) largest entry
OT_PLAN_TOL, OT_TIE_MARGIN = 1e-10, 1e-9
# the modules no model builds, card against CPU, relative to the largest
# entry of the CPU's answer (cuFFT and pocketfft, and the matmuls, sum in
# other orders); a divergence-free field's spectral divergence, relative to
# the largest wavenumber times the largest mode (f32 rounding of the field
# leaves ~1e-7), and the projected spectrum's departure from Hermitian
# symmetry, relative to its largest mode
PART2_TOL, DIVERGENCE_TOL, HERMITIAN_TOL = 1e-5, 1e-5, 1e-6

# the patching phase: the recipe's flags with --patching.levels 1 (MG-TFNO):
# round(128 * 0.078125) = 10 points of wrap padding, 4 patches of 84² a
# field with its coarse view as a second channel, so a batch of 8 reaches
# the spectral layers as 32 patches and an evaluation batch of 16 as 64.
# The published weights take one channel, so the run starts from seeded
# weights; cut to 2 graphed epochs and one on the loop, and to 256 test pairs
PATCH_EPOCHS, PATCH_TEST_PAIRS = 2, 256
PATCH_BATCH, PATCH_EVAL_BATCH = 4 * TRAIN_BATCH, 4 * EVAL_BATCH
PATCH_FLAGS = [
    "--data.n_train", str(RECIPE_PAIRS), "--data.train_resolution", "128",
    "--data.n_tests", f"[{PATCH_TEST_PAIRS}]", "--data.test_resolutions", "[128]",
    "--data.test_batch_sizes", f"[{EVAL_BATCH}]", "--data.batch_size", str(TRAIN_BATCH),
    "--model.n_modes", "[64,64]", "--model.hidden_channels", "64",
    "--model.projection_channel_ratio", "4",
    "--opt.learning_rate", "3e-5", "--opt.weight_decay", "1e-4",
    "--opt.training_loss", "h1", "--opt.step_size", "50", "--opt.gamma", "0.5",
    "--opt.opt_state", "factored", "--opt.mixed_precision", "false",
    "--eval_interval", "1", "--normalizer_from", str(FLAGSHIP), "--patching.levels", "1",
]
PATCH_GRAPH_STEPS, PATCH_PROFILE_STEPS = 20, 5
# the incremental FNO example (examples/training/plot_incremental_FNO_darcy.py)
# at its defaults: its final 16_l2 in the JAX package on the CPU, 0.14451
INCREMENTAL_JAX = 0.14451
# flags under which the example's modes grow within 5 epochs (at its defaults
# they stay at 4 x 4: the loss never moves by 1e-3 or less in an epoch)
INCREMENTAL_GROWTH = {
    "loss_gap": ["--n_epochs", "5", "--incremental_eps", "10"],
    "grad": ["--n_epochs", "5", "--criterion", "grad", "--incremental_eps", "0.999",
             "--incremental_grad_max_iter", "1", "--incremental_buffer", "1"],
}
# the card's figures of an incremental run against the CPU's, relative
INCREMENTAL_CPU_TOL = 1e-3
# Tensor-GaLore and the optimizer options, card against CPU from one seeded
# init: every step's loss within STEP_LOSS_TOL; at flagship width (hidden 64,
# 4 layers) over 16 x 16 modes on 32² fields. GaLore at rank 64 (a matrix
# keeps its smaller side whole, so no core is the diagonal one whose rounding
# Adam turns into +-1: tests/test_torch_training_extras.py), a refresh every
# 2 steps, so 3 steps reach the first refresh after the initial one. Then the
# same 3 steps in lockstep (the CPU takes the card's parameters and state
# before each): each leaf's update, card against CPU, within
# GALORE_UPDATE_TOL against the larger of its norm and 1% of the whole
# update. A projected leaf whose factor keeps singular values of the step's
# gradient below GALORE_VANISH of its largest is a known difference: those
# directions' vectors and core entries are rounding noise, each device has
# its own, and Adam scales each core entry to a step of full size
# (lifting.w1 and projection.w0 at this width: gradients of rank ~20 kept
# at rank 64). Without the lockstep such a leaf moves every later gradient:
# the other leaves' updates then differ by up to 1.85e-3 (projection.b0).
GALORE_STEPS, GALORE_RANK, GALORE_GAP = 3, 64, 2
GALORE_UPDATE_TOL, GALORE_VANISH = 1e-3, 1e-5
# ThroughputMeter's ms a forward against CUDA events' over the same forwards
METER_FORWARDS, METER_TOL = 10, 0.1
OPTION_STEPS, OPTION_RES, OPTION_MODES = 3, 32, [16, 16]

# the distribution phase (25): train_navier_stokes on the loader loop from the
# published weights, 25 steps of batch 8 and an evaluation of 32 test pairs,
# without --distributed.use_distributed, with it (a world of one on NCCL) and
# with it under ZeRO, once each; then one data-parallel step of global batch 8 on two
# ranks sharing the card (gloo, 4 rows a rank) against one rank's step on
# the 8 rows, replicated and under ZeRO, each rank's group ended within
# DIST_TIMEOUT_S
DIST_PAIRS, DIST_TESTS, DIST_RANKS, DIST_TIMED_STEPS = 200, 32, 2, 3
DIST_TIMEOUT_S = 360
# (d): the model axis at mesh (data 1, model DIST_MODEL_SIZE) on two ranks
# sharing the card; the resume check's steps before its save and after it
DIST_MODEL_SIZE, DIST_RESUME_STEPS = 2, (2, 1)
# (d) Tensor-GaLore on the same two ranks: the seeded flagship with every
# leaf of two or more dims projected (min_dim_size_to_project 2: the spectral
# weights' real/imaginary axis counts) at rank GALORE_AXIS_RANK, the largest
# the flagship takes there: lifting.w0 (128 x 3) unfolds to 3 columns, and
# a larger rank fails on it in both packages (JAX's lax.cond branches
# disagree in shape). Each spectral weight keeps 3 of its 64 in and out
# channels (the sliced out channels' factor among them) and of its modes: a
# core of 2 x 3^4. A refresh every GALORE_GAP steps, GALORE_AXIS_STEPS steps
# (a refresh, then a step between refreshes) at model size 2 and under ZeRO
# at data size 2, each in lockstep with one rank's whole-leaf run (before
# each step it takes the sharded run's parameters and state): every step's
# loss within STEP_LOSS_TOL and each leaf's update within GALORE_UPDATE_TOL,
# phase 24's bounds for GaLore on the card against the CPU. A matrix both of
# whose sides truncate (a diagonal core), or a leaf whose kept singular
# values lie within GALORE_AXIS_SPREAD of each other, of the first one
# dropped or of zero (galore_known), is a known difference, named; a sliced
# spectral weight never is. Then ZeRO at world size 1 on NCCL against the
# plain loop, to the bit.
GALORE_AXIS_RANK, GALORE_AXIS_STEPS, GALORE_AXIS_SPREAD = 3, 2, 1e-4

# the well phase (26): train_mhd64's FNO-3D on the_well's schema at 64³, the
# resolution of the_well's MHD_64 (MHDDataConfig.resolution's note): windows
# of WELL_STEPS_IN input steps (time as channels) and one constant field
# from WELL_TRAIN_TRAJ synthetic trajectories, WELL_EPOCHS loop epochs of
# batch WELL_BATCH through TheWellDataProcessor and the Trainer, then an
# autoregressive evaluation of WELL_ROLLOUT steps on WELL_TEST_TRAJ
# trajectories. The rolled-out batch, card against CPU: each loss within
# WELL_ROLLOUT_TOL (the served answers' bound: three chained forwards)
WELL_RES, WELL_STEPS_IN, WELL_WINDOWS, WELL_ROLLOUT = 64, 2, 2, 3
WELL_TRAIN_TRAJ, WELL_TEST_TRAJ, WELL_BATCH, WELL_EPOCHS = 6, 2, 2, 3
WELL_ROLLOUT_TOL, WELL_PROFILE_STEPS = 1e-4, 3
DIST_FLAGS = [
    "--data.n_train", str(DIST_PAIRS), "--data.train_resolution", "128",
    "--data.n_tests", f"[{DIST_TESTS}]", "--data.test_resolutions", "[128]",
    "--data.test_batch_sizes", f"[{EVAL_BATCH}]", "--data.batch_size", str(TRAIN_BATCH),
    "--model.n_modes", "[64,64]", "--model.hidden_channels", "64",
    "--model.projection_channel_ratio", "4",
    "--opt.learning_rate", "3e-5", "--opt.weight_decay", "1e-4",
    "--opt.training_loss", "h1", "--opt.step_size", "50", "--opt.gamma", "0.5",
    "--opt.opt_state", "factored", "--opt.mixed_precision", "false", "--opt.n_epochs", "1",
    "--device_dataset", "false", "--eval_interval", "1", "--normalizer_from", str(FLAGSHIP),
    "--warm_start_from", str(FLAGSHIP), "--warm_start_name", CHECKPOINT,
]

# the profile tables' kinds of kernel, by words in a kernel's name (first match)
KERNEL_KINDS = (("K1-K3", ("channel_contraction", "weight_grad")),
                ("gemm", ("gemm", "splitKreduce")), ("copy", ("copy",)),
                ("reduce", ("reduce",)), ("elementwise", ("elementwise",)))

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip()


def rel_l2(ar, ai, br, bi) -> float:
    ar, ai, br, bi = (t.double() for t in (ar, ai, br, bi))
    num = ((ar - br) ** 2 + (ai - bi) ** 2).sum()
    return float((num / (br ** 2 + bi ** 2).sum()).sqrt())


# One packed einsum per kernel: the four real products of the complex
# contraction in one cuBLAS-backed call (the JAX package's XLA path), the
# library yardstick. The port never calls them.
def packed_fwd(x2, w2):
    return torch.einsum("bim,iom->bom", x2, w2)


def packed_dx(g2, w2):
    return torch.einsum("bom,iom->bim", g2, w2)


def packed_dw(x2, g2):
    return torch.einsum("bim,bom->iom", x2, g2)


def kernel_specs():
    """Name, wrapper, plain version, library call and operand shapes per kernel."""
    from neuraloperator_tpu_torch.ops import spectral_contraction as tsc

    return {
        "mode_contraction": dict(
            fn=tsc.mode_contraction, plain=tsc.mode_contraction_reference,
            direct=tsc._CUDA_IMPLS["fwd"], plan=tsc.mode_contraction_plan,
            library=packed_fwd, dn="_FWD", line=67, b_is_weight=True,
            a=lambda B, I, O, M: (B, I, M), b=lambda B, I, O, M: (I, O, M),
            out=lambda B, I, O, M: (B, O, M),
            pack=lambda s: (torch.cat([s[0], s[1]]), torch.cat([s[2], s[3]], dim=1)),
        ),
        "mode_contraction_dx": dict(
            fn=tsc.mode_contraction_dx, plain=tsc.mode_contraction_dx_reference,
            direct=tsc._CUDA_IMPLS["dx"],
            plan=lambda *ops: tsc.mode_contraction_plan(*ops, dx=True),
            library=packed_dx, dn="_BWD_X, conj_b=True", line=68, b_is_weight=True,
            a=lambda B, I, O, M: (B, O, M), b=lambda B, I, O, M: (I, O, M),
            out=lambda B, I, O, M: (B, I, M),
            pack=lambda s: (torch.cat([s[0], s[1]]), torch.cat([s[2], s[3]])),
        ),
        "mode_contraction_dw": dict(
            fn=tsc.mode_contraction_dw, plain=tsc.mode_contraction_dw_reference,
            direct=tsc._CUDA_IMPLS["dw"], plan=tsc.mode_contraction_dw_plan,
            library=packed_dw, dn="_BWD_W, conj_a=True", line=69, b_is_weight=False,
            a=lambda B, I, O, M: (B, I, M), b=lambda B, I, O, M: (B, O, M),
            out=lambda B, I, O, M: (I, O, M),
            pack=lambda s: (torch.cat([s[0], s[1]], dim=1), torch.cat([s[2], s[3]], dim=1)),
        ),
    }


def check_kernel(name: str, batch: int, dtype: torch.dtype, channels=None, modes=None,
                 timed: bool = True) -> dict:
    """One kernel against its plain version (at the flagship shape unless
    ``channels`` = (I, O) and ``modes`` say otherwise), and its times.

    The timed calls walk operand sets that together exceed the L2 cache, so
    every call reads its operands from device memory, as each layer of the
    model does."""
    from neuraloperator_tpu_torch._timing import device_ms

    spec = kernel_specs()[name]
    I, O = channels or (CHANNELS, CHANNELS)
    M = modes or MODES
    dims = (batch, I, O, M)
    size = torch.finfo(dtype).bits // 8
    a_shape, b_shape, out_shape = spec["a"](*dims), spec["b"](*dims), spec["out"](*dims)
    in_bytes = 2 * (math.prod(a_shape) + math.prod(b_shape)) * size
    out_bytes = 2 * math.prod(out_shape) * 4
    n_sets = max(2, math.ceil(2 * L2_BYTES / (in_bytes + out_bytes)) + 1) if timed else 1
    gen = torch.Generator(device="cuda").manual_seed(SEED + batch + spec["line"])
    # a weight operand at the layer's init scale, the others unit normal
    b_scale = (2 / (I + O)) ** 0.5 / 2 ** 0.5 if spec["b_is_weight"] else 1.0

    def draw(shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)

    sets = [(draw(a_shape), draw(a_shape), draw(b_shape, b_scale), draw(b_shape, b_scale))
            for _ in range(n_sets)]
    kr, ki = spec["fn"](*sets[0])
    torch.cuda.synchronize()
    pr, pi = spec["plain"](*sets[0])
    err = rel_l2(kr, ki, pr, pi)
    max_abs = float(torch.maximum((kr - pr).abs().max(), (ki - pi).abs().max()))
    label = f"{name} B={batch} I={I} O={O} M={M} {str(dtype).replace('torch.', '')}"
    # each kernel sums every output in one thread, in a fixed order: two
    # launches on the same inputs agree bit for bit
    again = spec["fn"](*sets[0])
    torch.cuda.synchronize()
    if not (torch.equal(again[0], kr) and torch.equal(again[1], ki)):
        raise AssertionError(f"{label}: two launches on the same inputs differ")
    path = spec["plan"](*sets[0])
    log(f"{label}: rel_l2 {err:.3e} (tol {KERNEL_TOL[dtype]:.0e}), max_abs {max_abs:.3e}; "
        f"plan {path}, two launches bit-identical")
    if not err <= KERNEL_TOL[dtype]:
        raise AssertionError(f"{label} disagrees with its plain version: rel_l2 {err}")
    if not timed:
        return {"batch": batch, "dtype": str(dtype).replace("torch.", ""),
                "shape": {"B": batch, "I": I, "O": O, "M": M}, "rel_l2": err,
                "max_abs_err": max_abs, "path": path}

    ms, host_ms = device_ms(spec["fn"], sets, iters=60)
    # the same launch without the dispatcher: what the operator's dispatch costs the host
    direct_host_ms = device_ms(spec["direct"], sets, iters=60)[1]
    plain_ms = device_ms(spec["plain"], sets, iters=20)[0]
    library_ms = device_ms(spec["library"], [spec["pack"](s) for s in sets], iters=20)[0]
    flops = 8 * batch * I * O * M
    bytes_s = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    ops_s = flops / PEAK_FLOPS[dtype]
    result = {
        "batch": batch, "dtype": str(dtype).replace("torch.", ""),
        "shape": {"B": batch, "I": I, "O": O, "M": M},
        "rel_l2": err, "max_abs_err": max_abs,
        "ms": ms, "host_ms": host_ms, "direct_host_ms": direct_host_ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(bytes_s, ops_s) * 1e3,
        "bound_by": "bytes" if bytes_s >= ops_s else "operations",
        "bytes": in_bytes + out_bytes, "flops": flops, "path": path,
    }
    log(f"{label}: kernel {ms:.4f} ms on the device (host {host_ms:.4f} ms per call through "
        f"the operator, {direct_host_ms:.4f} ms direct), bound {result['bound_ms']:.4f} ms "
        f"({result['bound_by']}), plain {plain_ms:.4f} ms, packed einsum {library_ms:.4f} ms")
    return result


def reset_launches() -> None:
    from neuraloperator_tpu_torch.ops import spectral_contraction as tsc

    tsc.reset_launch_counts()


def read_launches() -> dict:
    from neuraloperator_tpu_torch.ops import spectral_contraction as tsc

    return tsc.launch_counts()


def read_launches_by_dtype() -> dict:
    from neuraloperator_tpu_torch.ops import spectral_contraction as tsc

    return tsc.launch_counts(by_dtype=True)


def only_dtype(by_dtype: dict, dtype: str) -> None:
    """Raise unless every launch counted in ``by_dtype`` ran the ``dtype`` variant."""
    other = {name: {d: n for d, n in counts.items() if d != dtype and n}
             for name, counts in by_dtype.items()}
    other = {name: c for name, c in other.items() if c}
    if other:
        raise AssertionError(f"launches of other variants than {dtype}: {other}")


def flagship_meta() -> dict:
    return json.loads((FLAGSHIP / "model_metadata.json").read_text())


def cpu_copy(model, meta):
    from neuraloperator_tpu_torch.models import model_from_metadata

    cpu_model = model_from_metadata(meta, device="meta").to_empty(device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return cpu_model


def load_flagship_on(device: str):
    """The published flagship: (model, data processor, manifest) on ``device``."""
    from neuraloperator_tpu_torch.models import load_flagship

    t0 = time.perf_counter()
    model, processor, manifest = load_flagship(FLAGSHIP, CHECKPOINT, device=device)
    if processor is None:
        raise FileNotFoundError(f"no data_processor.json in {FLAGSHIP}")
    dtypes = sorted({str(p.dtype) for p in model.parameters()})
    log(f"load: {FLAGSHIP.name}/{CHECKPOINT}.msgpack onto {device} in "
        f"{time.perf_counter() - t0:.1f} s; parameters {dtypes}; manifest {manifest}")
    return model, processor


def serve(model, processor, cpu_model) -> dict:
    """The flagship FNO served through CompiledForward; returns its numbers."""
    from neuraloperator_tpu_torch.serving import CompiledForward

    meta = flagship_meta()
    n_params = sum(p.numel() for p in model.parameters())
    n_layers = meta["init_kwargs"]["n_layers"]
    log(f"serve: FNO {meta['init_kwargs']['n_modes']} modes, hidden "
        f"{meta['init_kwargs']['hidden_channels']}, {n_layers} layers, {n_params} "
        f"parameters, the published weights")
    example = torch.zeros(1, 1, 128, 128)
    normalizers = dict(
        preprocess_fn=processor.in_normalizer.transform,
        postprocess_fn=processor.out_normalizer.inverse_transform,
    )
    served = CompiledForward(model, example, batch_sizes=BUCKETS, device="cuda", **normalizers)
    log(f"serve: buckets {served.batch_sizes}, first runs (s) {served.compile_seconds}")

    gen = torch.Generator().manual_seed(SEED + 1)
    in_std = float(processor.in_normalizer.std.ravel()[0])
    requests = [in_std * torch.randn(n, 1, 128, 128, generator=gen) for n in REQUESTS]
    reset_launches()
    t0 = time.perf_counter()
    answers = []
    for x in requests:
        answers.append(served(x))
        torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches, by_dtype = read_launches(), read_launches_by_dtype()
    only_dtype(by_dtype, "float32")
    for x, y in zip(requests, answers):
        if tuple(y.shape) != tuple(x.shape):
            raise AssertionError(f"answer of shape {tuple(y.shape)} to a {tuple(x.shape)} request")
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"non-finite answer to a batch-{x.shape[0]} request")
    log(f"serve: {len(REQUESTS)} requests of batch {REQUESTS} answered in {serve_s:.3f} s, "
        f"shapes and finiteness checked; kernel launches {launches}")
    expected = {"mode_contraction": n_layers * len(REQUESTS),
                "mode_contraction_dx": 0, "mode_contraction_dw": 0}
    if launches != expected:
        raise AssertionError(
            f"serving {len(REQUESTS)} forwards of {n_layers} spectral layers launched "
            f"{launches}, expected {expected}"
        )

    # the same file's model on the CPU, through the plain versions
    batch3 = REQUESTS.index(3)
    cpu_served = CompiledForward(cpu_model, example, batch_sizes=(3,),
                                 device="cpu", **normalizers)
    ref = cpu_served(requests[batch3])
    got = answers[batch3].cpu()
    err = float((got.double() - ref.double()).norm() / ref.double().norm())
    log(f"serve: batch-3 answer vs CPU run rel_l2 {err:.3e} (tol {SERVE_TOL:.0e})")
    if not err <= SERVE_TOL:
        raise AssertionError(f"GPU and CPU answers differ: rel_l2 {err}")

    latency_ms = {b: 1e3 * served.latency_probe(batch_size=b, iters=20) for b in BUCKETS}
    log(f"serve: latency_probe ms per forward {latency_ms}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    return {"launches": launches, "launches_by_dtype": by_dtype, "latency_ms": latency_ms,
            "rel_l2_vs_cpu": err, "requests": list(REQUESTS), "serve_s": serve_s,
            "_requests": requests, "_answers": [a.cpu() for a in answers]}


def rel_l2_np(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def evaluate_flagship(model, processor, cpu_model) -> dict:
    """The published weights on their regenerated test split; returns the numbers."""
    from neuraloperator_tpu_torch.data.datasets import ns_solver
    from neuraloperator_tpu_torch.scripts import eval_ns_checkpoint as ev

    n_layers = flagship_meta()["init_kwargs"]["n_layers"]
    xs, ys = ev.load_test_split(EVAL_RES, EVAL_PAIRS, device="cuda")
    log(f"eval: the test split nsforcing_test_{EVAL_RES}.pt: {len(xs)} pairs, "
        f"max |w| {np.abs(xs).max():.3f}")
    if len(xs) != EVAL_PAIRS or not (np.isfinite(xs).all() and np.isfinite(ys).all()):
        raise AssertionError(f"the split holds {len(xs)} pairs or non-finite values")

    reset_launches()
    t0 = time.perf_counter()
    figures = ev.evaluate(model, processor, xs, ys, EVAL_BATCH, device="cuda")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches, by_dtype = read_launches(), read_launches_by_dtype()
    only_dtype(by_dtype, "float32")
    log(f"eval: {figures['pairs']} pairs at batch {EVAL_BATCH} in {eval_s:.3f} s: "
        f"rel_l2 {figures['rel_l2']:.6e}, rel_h1 {figures['rel_h1']:.6e}; kernel launches "
        f"{launches}")
    expected = {"mode_contraction": n_layers * (EVAL_PAIRS // EVAL_BATCH),
                "mode_contraction_dx": 0, "mode_contraction_dw": 0}
    if launches != expected:
        raise AssertionError(f"the evaluation launched {launches}, expected {expected}")

    # (a) the solver: one record of the split's first 2 trajectories, card vs CPU
    w0 = ns_solver.gaussian_rf_vorticity(np.random.default_rng(ev.TEST_SEED),
                                         ev.TEST_TRAJECTORIES, EVAL_RES)[:2]
    record = {k: v for k, v in ev.SOLVER.items() if k != "T"}
    t0 = time.perf_counter()
    card = ns_solver.simulate_navier_stokes_2d(w0, T=ev.SOLVER["record_dt"], device="cuda",
                                               **record).cpu().numpy()
    cpu = ns_solver.simulate_navier_stokes_2d(w0, T=ev.SOLVER["record_dt"], device="cpu",
                                              **record).numpy()
    solver_err = [rel_l2_np(card[b, 0], cpu[b, 0]) for b in range(2)]
    log(f"eval (a): one record ({round(ev.SOLVER['record_dt'] / ev.SOLVER['dt'])} steps) of "
        f"2 trajectories, card vs CPU in {time.perf_counter() - t0:.1f} s: rel_l2 per "
        f"snapshot {solver_err} (tol {SOLVER_TOL:.0e})")
    if not max(solver_err) <= SOLVER_TOL:
        raise AssertionError(f"the solver on the card departs from the CPU: {solver_err}")

    # (b) the first pairs through evaluate, card vs CPU, same weights
    t0 = time.perf_counter()
    head = slice(0, EVAL_CPU_PAIRS)
    on_card = ev.evaluate(model, processor, xs[head], ys[head], EVAL_BATCH, device="cuda")
    on_cpu = ev.evaluate(cpu_model, processor, xs[head], ys[head], EVAL_BATCH, device="cpu")
    eval_err = {k: abs(on_card[k] - on_cpu[k]) / abs(on_cpu[k]) for k in ("rel_l2", "rel_h1")}
    log(f"eval (b): first {EVAL_CPU_PAIRS} pairs, card {on_card} vs CPU {on_cpu} in "
        f"{time.perf_counter() - t0:.1f} s: relative differences {eval_err} "
        f"(tol {EVAL_CPU_TOL:.0e})")
    if not max(eval_err.values()) <= EVAL_CPU_TOL:
        raise AssertionError(f"the evaluation on the card departs from the CPU: {eval_err}")

    # (c) the figure against the bound that wrong weights or normalizers miss
    log(f"eval (c): rel_l2 {figures['rel_l2']:.6e} (bound {REL_L2_BOUND:.1e}), rel_h1 "
        f"{figures['rel_h1']:.6e} (bound {REL_H1_BOUND:.1e})")
    if not (figures["rel_l2"] <= REL_L2_BOUND and figures["rel_h1"] <= REL_H1_BOUND):
        raise AssertionError(f"the published weights score {figures} on the regenerated split")
    # where the solver's time goes: 200 steps of the split's batch
    w0_all = ns_solver.gaussian_rf_vorticity(np.random.default_rng(ev.TEST_SEED),
                                             ev.TEST_TRAJECTORIES, EVAL_RES)
    window = {**ev.SOLVER, "T": SOLVER_PROFILE_STEPS * ev.SOLVER["dt"],
              "record_dt": SOLVER_PROFILE_STEPS * ev.SOLVER["dt"]}
    profile = profile_window(
        f"{SOLVER_PROFILE_STEPS} solver steps of {ev.TEST_TRAJECTORIES} x {EVAL_RES}²",
        lambda: ns_solver.simulate_navier_stokes_2d(w0_all, device="cuda", **window),
    )
    return {"launches": launches, "launches_by_dtype": by_dtype, **figures, "eval_s": eval_s,
            "solver_rel_l2_vs_cpu": solver_err, "eval_rel_diff_vs_cpu": eval_err,
            "solver_profile": profile}


def make_pairs(n: int, in_std: float, seed: int):
    """n seeded 128² pairs: smooth inputs at ``in_std`` and a fixed spectral
    filter of them (a smoothing, phase-shifting multiplier on the rfft2)."""
    rng = np.random.default_rng(seed)
    k1 = np.fft.fftfreq(128, 1 / 128)[:, None]
    k2 = np.fft.rfftfreq(128, 1 / 128)[None, :]
    k_sq = k1 ** 2 + k2 ** 2
    coeffs = rng.standard_normal((n, 1, 128, 65)) + 1j * rng.standard_normal((n, 1, 128, 65))
    x = np.fft.irfft2(coeffs * (1 + k_sq) ** -1.5, s=(128, 128))
    x = (in_std * x / x.std()).astype(np.float32)
    response = np.exp(-k_sq / 400.0) * np.exp(2j * np.pi * (3 * k1 + 5 * k2) / 128)
    y = np.fft.irfft2(np.fft.rfft2(x) * response, s=(128, 128)).astype(np.float32)
    return x, y


def train() -> dict:
    """The flagship FNO trained through Trainer.train; returns its numbers."""
    from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
    from neuraloperator_tpu_torch.data.transforms import (
        DefaultDataProcessor,
        UnitGaussianNormalizer,
        load_data_processor,
    )
    from neuraloperator_tpu_torch.losses import H1Loss, LpLoss
    from neuraloperator_tpu_torch.models import model_from_metadata
    from neuraloperator_tpu_torch.training import Trainer, build_optimizer

    meta = flagship_meta()
    n_layers = meta["init_kwargs"]["n_layers"]
    t0 = time.perf_counter()
    model = model_from_metadata(
        meta, device="cuda", generator=torch.Generator().manual_seed(SEED + 2)
    )
    in_std = float(load_data_processor(FLAGSHIP).in_normalizer.std.ravel()[0])
    n_train, n_test = TRAIN_BATCHES * TRAIN_BATCH, TEST_BATCHES * TRAIN_BATCH
    x, y = make_pairs(n_train + n_test, in_std, SEED + 3)
    processor = DefaultDataProcessor(
        UnitGaussianNormalizer(dim=[0, 2, 3]).fit(x[:n_train]),
        UnitGaussianNormalizer(dim=[0, 2, 3]).fit(y[:n_train]),
    )
    train_loader = DataLoader(TensorDataset(x[:n_train], y[:n_train]), TRAIN_BATCH,
                              shuffle=True, seed=SEED)
    test_loaders = {128: DataLoader(TensorDataset(x[n_train:], y[n_train:]), TRAIN_BATCH)}
    h1, l2 = H1Loss(d=2), LpLoss(d=2)
    log(f"train: flagship FNO with seeded weights, {n_train} + {n_test} pairs of 128², "
        f"normalizers fitted, in {time.perf_counter() - t0:.1f} s")

    trainer = Trainer(model=model, n_epochs=EPOCHS, data_processor=processor,
                      eval_interval=1, device="cuda")
    optimizer = build_optimizer(OPT, len(train_loader))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    metrics = trainer.train(train_loader, test_loaders, optimizer, training_loss=h1,
                            eval_losses={"h1": h1, "l2": l2})
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches, by_dtype = read_launches(), read_launches_by_dtype()
    only_dtype(by_dtype, "float32")
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    log(f"train: {EPOCHS} epochs of {TRAIN_BATCHES} steps of batch {TRAIN_BATCH} in "
        f"{train_s:.2f} s; metrics {metrics}; kernel launches {launches}; peak device "
        f"memory {peak_mib:.0f} MiB")
    bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f"non-finite training metrics {bad}")
    steps = EPOCHS * TRAIN_BATCHES
    eval_forwards = EPOCHS * TEST_BATCHES  # eval_interval 1: one eval per epoch
    expected = {"mode_contraction": n_layers * (steps + eval_forwards),
                "mode_contraction_dx": n_layers * steps,
                "mode_contraction_dw": n_layers * steps}
    if launches != expected:
        raise AssertionError(f"training launched {launches}, expected {expected}")
    # the Trainer's epoch_time of the last epoch: warm steps, ended by the
    # float() of the summed loss, which waits for the device
    step_ms = 1e3 * metrics["epoch_time"] / TRAIN_BATCHES
    log(f"train: {step_ms:.2f} ms per train step of batch {TRAIN_BATCH} "
        f"({1e3 / step_ms:.2f} steps/s, last epoch's epoch_time)")

    step = compare_step_with_cpu(model, meta, processor, x[n_train:n_train + 2],
                                 y[n_train:n_train + 2])
    out = {"launches": launches, "launches_by_dtype": by_dtype, "metrics": metrics,
           "train_s": train_s,
           "step_ms": step_ms, "steps_per_s": 1e3 / step_ms, "peak_mib": peak_mib,
           "steps": steps, "eval_forwards": eval_forwards, **step}
    out["profile"] = profile_steps(model, processor, x[:2 * TRAIN_BATCH], y[:2 * TRAIN_BATCH])
    return out


def one_step(model, processor, x, y, device, mixed_precision: bool = False, loss=None):
    """One Trainer.train step of the given batch (H1 at d=2 unless ``loss``
    says otherwise); returns (loss, grads)."""
    from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
    from neuraloperator_tpu_torch.losses import H1Loss
    from neuraloperator_tpu_torch.training import Trainer, build_optimizer

    loader = DataLoader(TensorDataset(x, y), len(x))
    trainer = Trainer(model=model, n_epochs=1, data_processor=processor, device=device,
                      mixed_precision=mixed_precision)
    metrics = trainer.train(loader, {}, build_optimizer(OPT, 1),
                            training_loss=loss or H1Loss(d=2))
    return metrics["train_err"], {n: p.grad.detach().float().cpu()
                                  for n, p in model.named_parameters()}


def compare_step_with_cpu(model, meta, processor, x, y) -> dict:
    """One train step on the card against the same step on the CPU."""
    cpu_model = cpu_copy(model, meta)
    t0 = time.perf_counter()
    loss_gpu, grads_gpu = one_step(model, processor, x, y, "cuda")
    loss_cpu, grads_cpu = one_step(cpu_model, processor, x, y, "cpu")
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    grad_err = {}
    for name, ref in grads_cpu.items():
        ref = ref.double()
        grad_err[name] = float((grads_gpu[name].double() - ref).norm() / ref.norm())
    worst = max(grad_err, key=grad_err.get)
    log(f"train: one step of batch {len(x)}, card vs CPU in {time.perf_counter() - t0:.1f} s: "
        f"loss {loss_gpu:.7f} vs {loss_cpu:.7f} (rel {loss_err:.2e}, tol {STEP_LOSS_TOL:.0e}); "
        f"gradients rel_l2 max {grad_err[worst]:.2e} ({worst}, tol {STEP_GRAD_TOL:.0e}) "
        f"over {len(grad_err)} parameters")
    if not loss_err <= STEP_LOSS_TOL:
        raise AssertionError(f"card and CPU losses differ: rel {loss_err}")
    misses = {k: v for k, v in grad_err.items() if not v <= STEP_GRAD_TOL}
    if misses:
        raise AssertionError(f"card and CPU gradients differ: {misses}")
    return {"step_loss_rel_err": loss_err, "step_grad_rel_l2_max": grad_err[worst],
            "step_grad_worst": worst}


def profile_steps(model, processor, x, y) -> dict:
    """Device time by kernel over two train steps of batch 8 (torch.profiler)."""
    from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
    from neuraloperator_tpu_torch.losses import H1Loss
    from neuraloperator_tpu_torch.training import Trainer, build_optimizer

    loader = DataLoader(TensorDataset(x, y), TRAIN_BATCH)
    trainer = Trainer(model=model, n_epochs=1, data_processor=processor, device="cuda")
    trainer.train(loader, {}, build_optimizer(OPT, 1), training_loss=H1Loss(d=2))  # warm
    return profile_window(
        f"2 train steps of batch {TRAIN_BATCH}",
        lambda: trainer.train(loader, {}, build_optimizer(OPT, 1), training_loss=H1Loss(d=2)),
    )


def profile_window(label: str, run) -> dict:
    """Device time by kernel over one call of ``run`` (torch.profiler), and
    the device's idle share of the host-clock window."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # kernels only: user annotations (the optimizer's range, for one) span
    # kernels that are listed themselves. The profiler's raw events are read:
    # building its FunctionEvent tree (``prof.events()``) takes seconds per
    # window on the host, and nothing here needs it
    spans, kernels = {}, {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_hidden_event", lambda: False)()):
            continue
        name = e.name()
        bucket = spans if e.is_user_annotation() or name.startswith("Optimizer.") else kernels
        bucket[name] = bucket.get(name, 0.0) + e.duration_ns() / 1e6
    if not kernels:
        log(f"profile: {label}: the profiler recorded no device kernels; device time "
            f"not measured")
        return {"wall_ms": wall_ms}
    total = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    by_kind = {}
    for name, ms in kernels.items():
        kind = next((k for k, words in KERNEL_KINDS if any(w in name for w in words)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    log(f"profile: {label}: wall {wall_ms:.2f} ms, kernels "
        f"{total:.2f} ms ({total / wall_ms:.1%}; idle {1 - total / wall_ms:.1%}); "
        f"annotated spans (ms) {spans}; kernel ms by kind "
        f"{ {k: round(v, 3) for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])} }")
    for key, ms in top:
        print(f"    {ms:9.3f} ms  {ms / total:6.1%}  {key[:110]}", flush=True)
    return {"wall_ms": wall_ms, "device_ms": total, "spans": spans, "top": top,
            "by_kind": by_kind}


def generate_splits() -> dict:
    """The recipe's training split and the evaluation's test split, written
    by the port's generate_ns_data entry point into its default directory."""
    from neuraloperator_tpu_torch.scripts import eval_ns_checkpoint as ev
    from neuraloperator_tpu_torch.scripts import generate_ns_data

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = generate_ns_data.main([
        "--res", str(EVAL_RES), "--train-traj", str(RECIPE_TRAIN_TRAJ),
        "--test-traj", str(ev.TEST_TRAJECTORIES), "--device", "cuda",
    ])
    solver_s = time.perf_counter() - t0
    steps = round(ev.SOLVER["T"] / ev.SOLVER["dt"])
    log(f"data: {RECIPE_TRAIN_TRAJ} + {ev.TEST_TRAJECTORIES} trajectories x {steps} steps "
        f"of {EVAL_RES}² generated on the card in {solver_s:.2f} s: "
        f"{', '.join(p.name for p in written.values())} in {written['test'].parent}")
    return {"solver_s": solver_s}


class EpochOrders:
    """A loader whose n-th pass visits the samples in ``orders[n]`` (the last
    order again past the end), in batches of ``batch``; ``arrays`` are
    ``x``, ``y`` and any per-sample extras."""

    def __init__(self, x, y, orders, batch: int, **extras):
        self.arrays = {"x": x, "y": y, **extras}
        self.orders, self.batch = orders, batch
        self.passes = 0

    def __len__(self) -> int:
        return len(self.arrays["x"]) // self.batch

    def __iter__(self):
        order = self.orders[min(self.passes, len(self.orders) - 1)]
        self.passes += 1
        for i in range(0, len(order) - self.batch + 1, self.batch):
            idx = order[i:i + self.batch]
            yield {k: v[idx] for k, v in self.arrays.items()}


def run_recipe_entry_point(argv, record: list, script=None) -> dict:
    """``script.main(argv)`` (``train_navier_stokes`` by default), recording
    each evaluation's metrics with the Trainer that ran it."""
    from neuraloperator_tpu_torch.scripts import train_navier_stokes
    from neuraloperator_tpu_torch.training import Trainer

    evaluate_all = Trainer.evaluate_all

    def recording(self, eval_step, test_loaders):
        metrics = evaluate_all(self, eval_step, test_loaders)
        record.append((self, metrics))
        return metrics

    Trainer.evaluate_all = recording
    try:
        return (script or train_navier_stokes).main(argv)
    finally:
        Trainer.evaluate_all = evaluate_all


def saved_count(save_dir) -> int:
    from neuraloperator_tpu_torch.serialization import read_msgpack

    return int(np.asarray(read_msgpack(Path(save_dir) / "optimizer.msgpack")["0"]["count"]))


def recipe() -> dict:
    """The flagship recipe through the port's entry point, then the graphed
    staged epoch against the loader loop; returns the numbers."""
    from neuraloperator_tpu_torch.data.transforms import load_data_processor
    from neuraloperator_tpu_torch.models import from_checkpoint
    from neuraloperator_tpu_torch.scripts import eval_ns_checkpoint as ev
    from neuraloperator_tpu_torch.training.training_state import load_training_state, read_manifest

    n_layers = flagship_meta()["init_kwargs"]["n_layers"]
    steps_per_epoch = RECIPE_PAIRS // TRAIN_BATCH
    batches_per_eval = EVAL_PAIRS // EVAL_BATCH
    save_dir = Path(tempfile.mkdtemp(prefix="recipe-"))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        evals: list = []
        t0 = time.perf_counter()
        final = run_recipe_entry_point(
            [*RECIPE_FLAGS, "--opt.n_epochs", str(RECIPE_EPOCHS), "--save_dir", str(save_dir),
             "--warm_start_from", str(FLAGSHIP), "--warm_start_name", CHECKPOINT], evals)
        fine_tune_s = time.perf_counter() - t0
        fine_tune = [m for _, m in evals]
        manifest = read_manifest(save_dir)
        count_saved = saved_count(save_dir)
        log(f"recipe: fine-tune of {RECIPE_EPOCHS} epochs x {steps_per_epoch} graphed steps in "
            f"{fine_tune_s:.1f} s; evaluations {fine_tune}; final {final}; manifest "
            f"{manifest}; saved optimizer count {count_saved}")
        # (1) the published weights kept their quality through the fine-tune,
        # past the first evaluation's warm-restart bump
        for i, m in enumerate(fine_tune):
            factor = FIRST_EVAL_FACTOR if i == 0 else 1.0
            if not (m["128_l2"] <= factor * REL_L2_BOUND
                    and m["128_h1"] <= factor * REL_H1_BOUND):
                raise AssertionError(f"(1) fine-tune evaluation {i} scores {m} (bounds "
                                     f"{factor} x {REL_L2_BOUND}, {REL_H1_BOUND})")
        if not manifest["best_metric"] <= REL_L2_BOUND:
            raise AssertionError(f"(1) the fine-tune's best 128_l2 is {manifest['best_metric']}")

        resumed_evals: list = []
        t0 = time.perf_counter()
        resumed_final = run_recipe_entry_point(
            [*RECIPE_FLAGS, "--opt.n_epochs", str(RECIPE_RESUMED_EPOCHS), "--save_dir",
             str(save_dir), "--resume_from_dir", str(save_dir)], resumed_evals)
        resume_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches, by_dtype = read_launches(), read_launches_by_dtype()
        only_dtype(by_dtype, "float32")
        trainer = resumed_evals[-1][0]
        manifest_after = read_manifest(save_dir)
        log(f"recipe: resumed run to epoch {RECIPE_RESUMED_EPOCHS} in {resume_s:.1f} s; "
            f"evaluations {[m for _, m in resumed_evals]}; final {resumed_final}; manifest "
            f"{manifest_after}; kernel launches {launches}")
        # (2) the relaunch goes on where the fine-tune stopped
        total_steps = RECIPE_RESUMED_EPOCHS * steps_per_epoch
        if not (trainer.start_epoch == RECIPE_EPOCHS
                and count_saved == RECIPE_EPOCHS * steps_per_epoch
                and int(trainer.optimizer.count) == total_steps == saved_count(save_dir)):
            raise AssertionError(
                f"(2) the resumed run started at epoch {trainer.start_epoch} from count "
                f"{count_saved} and ended at {int(trainer.optimizer.count)}")
        # (3) the stored best is never raised by the resumed run
        if not manifest_after["best_metric"] <= manifest["best_metric"]:
            raise AssertionError(f"(3) best metric {manifest['best_metric']} -> "
                                 f"{manifest_after['best_metric']}")
        # (4) the best weights rebuild from their files and score their metric
        best = from_checkpoint(save_dir, "best_model", device="cuda")
        best.load_state_dict(load_training_state(save_dir, "best_model", best.state_dict(),
                                                 device="cuda")[0])
        xs, ys = ev.load_test_split(EVAL_RES, EVAL_PAIRS, device="cuda")
        rescored = ev.evaluate(best.eval(), load_data_processor(save_dir), xs, ys, EVAL_BATCH,
                               device="cuda")
        reload_err = abs(rescored["rel_l2"] - manifest_after["best_metric"]) / \
            manifest_after["best_metric"]
        log(f"recipe (4): best_model rebuilt by from_checkpoint scores {rescored}, manifest "
            f"best {manifest_after['best_metric']:.6e}: relative difference {reload_err:.2e} "
            f"(tol {BEST_RELOAD_TOL:.0e})")
        if not reload_err <= BEST_RELOAD_TOL:
            raise AssertionError(f"(4) the reloaded best scores {rescored}")
        # (5) every kernel of the step ran once per layer and step, from the replays
        n_evals = len(evals) + len(resumed_evals)
        expected = {"mode_contraction": n_layers * (total_steps + n_evals * batches_per_eval),
                    "mode_contraction_dx": n_layers * total_steps,
                    "mode_contraction_dw": n_layers * total_steps}
        if launches != expected:
            raise AssertionError(f"(5) the recipe launched {launches}, expected {expected}")
        del best, trainer, evals, resumed_evals
        log(f"recipe: peak device memory of the fine-tune and the resumed run "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
        graph = graphed_against_eager()
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        log(f"recipe: peak device memory {peak_mib:.0f} MiB")
        return {"launches": launches, "launches_by_dtype": by_dtype, "fine_tune": fine_tune,
                "fine_tune_final": final,
                "resumed_final": resumed_final, "manifest": manifest_after,
                "fine_tune_s": fine_tune_s, "resume_s": resume_s,
                "graphed_step_ms_fine_tune": 1e3 * final["epoch_time"] / steps_per_epoch,
                "best_reload_rel_diff": reload_err, "peak_mib": peak_mib, **graph}
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)


def graphed_against_eager() -> dict:
    """The staged epochs as replayed CUDA graphs against the loader loop,
    from the published weights over the same batches; step times, the idle
    share of graphed steps and the seconds per save."""
    from neuraloperator_tpu_torch import convert
    from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset, load_pt_as_numpy
    from neuraloperator_tpu_torch.data.datasets import navier_stokes
    from neuraloperator_tpu_torch.losses import H1Loss
    from neuraloperator_tpu_torch.serialization import write_msgpack
    from neuraloperator_tpu_torch.training import Trainer, build_optimizer

    split = load_pt_as_numpy(navier_stokes.DATA_ROOT / f"nsforcing_train_{EVAL_RES}.pt")
    x, y = split["x"][:RECIPE_PAIRS, None], split["y"][:RECIPE_PAIRS, None]
    shuffle = np.random.default_rng(GRAPH_SEED)
    orders = [shuffle.permutation(RECIPE_PAIRS) for _ in range(GRAPH_EPOCHS)]
    steps = RECIPE_PAIRS // TRAIN_BATCH
    runs = {}
    for staged in (True, False):
        model, processor = load_flagship_on("cuda")
        if staged:
            loader = DataLoader(TensorDataset(x, y), TRAIN_BATCH)
        else:
            ynorm = runs[True][1].staged_step.data["_loss_ynorm_sq"].cpu().numpy()
            loader = EpochOrders(x, y, [orders[0], *orders], TRAIN_BATCH,
                                 _loss_ynorm_sq=ynorm)
        trainer = Trainer(model=model, n_epochs=GRAPH_EPOCHS, data_processor=processor,
                          device="cuda")
        metrics = trainer.train(loader, {}, build_optimizer(OPT, steps),
                                training_loss=H1Loss(d=2), device_dataset=staged,
                                shuffle_seed=GRAPH_SEED)
        torch.cuda.synchronize()
        runs[staged] = (metrics, trainer)
    (graphed, g_trainer), (eager, e_trainer) = runs[True], runs[False]
    loss_err = abs(graphed["train_err"] - eager["train_err"]) / abs(eager["train_err"])
    want = dict(e_trainer.model.named_parameters())
    param_err = {}
    for name, p in g_trainer.model.named_parameters():
        ref = want[name].detach().double()
        param_err[name] = float((p.detach().double() - ref).norm() / ref.norm())
    worst = max(param_err, key=param_err.get)
    step_ms = {"graphed": 1e3 * graphed["epoch_time"] / steps,
               "loop": 1e3 * eager["epoch_time"] / steps}
    log(f"recipe: {GRAPH_EPOCHS} staged epochs as replayed CUDA graphs vs the loader loop over "
        f"the same batches from the published weights: train_err {graphed['train_err']:.8f} "
        f"vs {eager['train_err']:.8f} (rel {loss_err:.2e}), parameters rel_l2 max "
        f"{param_err[worst]:.2e} ({worst}) (tol {GRAPH_TOL:.0e}); step ms of the last epoch "
        f"{step_ms}")
    if not (loss_err <= GRAPH_TOL and param_err[worst] <= GRAPH_TOL):
        raise AssertionError(f"the graphed epochs depart from the loader loop: loss "
                             f"{loss_err}, {worst} {param_err[worst]}")
    staged = g_trainer.staged_step
    order = torch.from_numpy(orders[0][:GRAPH_PROFILE_STEPS * TRAIN_BATCH].reshape(
        GRAPH_PROFILE_STEPS, TRAIN_BATCH)).to(staged.index.device)

    def replays():
        for i in range(GRAPH_PROFILE_STEPS):
            staged(order[i])

    replays()  # warm
    profile = profile_window(f"{GRAPH_PROFILE_STEPS} graphed train steps of batch "
                             f"{TRAIN_BATCH}", replays)
    # seconds per save: the two files the periodic save writes, as it writes them
    save_s = {}
    with tempfile.TemporaryDirectory(prefix="save-") as tmp:
        for name, tree in (("model.msgpack", lambda: convert.to_flax_params(
                                g_trainer.model.state_dict())),
                           ("optimizer.msgpack", g_trainer.optimizer.state_dict)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            write_msgpack(Path(tmp) / name, tree())
            save_s[name] = time.perf_counter() - t0
            save_s[name.replace(".msgpack", "_mb")] = (Path(tmp) / name).stat().st_size / 1e6
    log(f"recipe: seconds per save {save_s}")
    return {"graph_loss_rel_err": loss_err, "graph_param_rel_l2_max": param_err[worst],
            "step_ms": step_ms, "graphed_profile": profile, "save_s": save_s}


def mixed_flagship_on(device: str):
    """The published weights in the flagship with bf16 spectral weights and
    "mixed" blocks (``MIXED_MODEL``), in eval mode on ``device``."""
    from neuraloperator_tpu_torch.models import model_from_metadata
    from neuraloperator_tpu_torch.training.training_state import load_training_state

    meta = flagship_meta()
    meta["init_kwargs"].update(MIXED_MODEL)
    model = model_from_metadata(meta, device="meta").to_empty(device=device)
    model.load_state_dict(load_training_state(FLAGSHIP, CHECKPOINT, model.state_dict(),
                                              device=device)[0])
    return model.eval(), meta


def rel_l2_t(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm())


def mixed_serve(processor, served: dict) -> dict:
    """(1) bf16 weights on f32 requests, then the mixed model on bf16 inputs.

    The serve phase's requests (white noise at the input's scale) are
    answered and counted; then the first 24 inputs of the test split
    (Gaussian random vorticity, the inputs of the JAX package's probe that
    the bounds come from). Both sets are held to the f32 answers, and their
    first CPU_REQUEST_GROUPS groups to the CPU's answers under the same
    policy. White noise carries high
    frequencies that these weights barely pass, so its answers are small
    and bf16 noise is large beside them: on it the bf16 pipelines are held
    only to NOISE_F32_TOL."""
    from neuraloperator_tpu_torch.scripts import eval_ns_checkpoint as ev
    from neuraloperator_tpu_torch.serving import CompiledForward

    n_layers = flagship_meta()["init_kwargs"]["n_layers"]
    requests, f32_answers = served["_requests"], served["_answers"]
    xs, _ = ev.load_test_split(EVAL_RES, sum(REQUESTS), device="cuda")
    bounds = np.cumsum((0, *REQUESTS))
    fields = [torch.from_numpy(xs[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
    pre, post = processor.in_normalizer.transform, processor.out_normalizer.inverse_transform
    example = torch.zeros(1, 1, 128, 128)
    out = {}
    # (a) the published weights cast to bf16, f32 arithmetic: K1's f32 variant
    model, _ = load_flagship_on("cuda")
    cpu_model, _ = load_flagship_on("cpu")
    f32_srv = CompiledForward(model, example, batch_sizes=BUCKETS, device="cuda",
                              preprocess_fn=pre, postprocess_fn=post)
    f32_fields = [f32_srv(x) for x in fields]
    # (b) the same weights in the mixed model, inputs cast to bf16 after the
    # normalizer and the output taken in f32 before it (the half policy): bf16 K1
    mixed_model, _ = mixed_flagship_on("cuda")
    mixed_cpu, _ = mixed_flagship_on("cpu")
    cases = {
        "bf16_weights": (model, cpu_model, dict(preprocess_fn=pre, postprocess_fn=post),
                         "float32", MIXED_SERVE_F32_TOL),
        "mixed_policy": (mixed_model, mixed_cpu,
                         dict(preprocess_fn=lambda x: pre(x).to(torch.bfloat16),
                              postprocess_fn=lambda y: post(y.float())),
                         "bfloat16", MIXED_POLICY_F32_TOL),
    }
    for case, (card_model, host_model, fns, variant, f32_tol) in cases.items():
        srv = CompiledForward(card_model, example, batch_sizes=BUCKETS, device="cuda",
                              param_dtype=torch.bfloat16, **fns)
        reset_launches()
        answers = []
        for x in requests:
            answers.append(srv(x))
            torch.cuda.synchronize()
        launches, by_dtype = read_launches(), read_launches_by_dtype()
        only_dtype(by_dtype, variant)
        expected = {"mode_contraction": n_layers * len(REQUESTS),
                    "mode_contraction_dx": 0, "mode_contraction_dw": 0}
        if launches != expected:
            raise AssertionError(f"mixed serve {case} launched {launches}, expected {expected}")
        host = CompiledForward(host_model, example,
                               batch_sizes=(max(REQUESTS[:CPU_REQUEST_GROUPS]),),
                               device="cpu", param_dtype=torch.bfloat16, **fns)
        on_fields = [srv(x) for x in fields]
        # each set of answers against the CPU's (its first groups) and
        # against the f32 answers (all of them)
        vs_cpu = [rel_l2_t(a, host(x)) for x, a in zip(fields[:CPU_REQUEST_GROUPS],
                                                      on_fields)]
        noise_vs_cpu = [rel_l2_t(a, host(x)) for x, a in zip(
            requests[:CPU_REQUEST_GROUPS], answers)]
        vs_f32 = [rel_l2_t(a, f) for a, f in zip(on_fields, f32_fields)]
        noise_vs_f32 = [rel_l2_t(a, f) for a, f in zip(answers, f32_answers)]
        # f32 arithmetic over the same bf16 weights: the serve phase's bound on
        # every request; two bf16 pipelines: MIXED_SERVE_CPU_TOL on the test
        # inputs and NOISE_F32_TOL on white noise
        cpu_tol, noise_cpu_tol = ((SERVE_TOL, SERVE_TOL) if case == "bf16_weights"
                                  else (MIXED_SERVE_CPU_TOL, NOISE_F32_TOL))
        finite = all(bool(torch.isfinite(a).all()) for a in answers + on_fields)
        latency_ms = {b: 1e3 * srv.latency_probe(batch_size=b, iters=20) for b in BUCKETS}
        log(f"mixed serve ({case}): {len(REQUESTS)} requests, launches {by_dtype}; rel_l2 "
            f"max on the test inputs: vs the CPU under the same policy {max(vs_cpu):.3e} (tol "
            f"{cpu_tol:.0e}), vs the f32 answers {max(vs_f32):.3e} (tol {f32_tol:.0e}); on the "
            f"white-noise requests: vs the CPU {max(noise_vs_cpu):.3e} (tol "
            f"{noise_cpu_tol:.0e}), vs f32 {max(noise_vs_f32):.3e} (tol {NOISE_F32_TOL:.0e}); "
            f"latency_probe ms {latency_ms}")
        if not finite:
            raise AssertionError(f"mixed serve {case}: non-finite answers")
        if not (max(vs_cpu) <= cpu_tol and max(noise_vs_cpu) <= noise_cpu_tol):
            raise AssertionError(f"mixed serve {case}: card and CPU differ: {vs_cpu}, "
                                 f"{noise_vs_cpu}")
        if not (max(vs_f32) <= f32_tol and max(noise_vs_f32) <= NOISE_F32_TOL):
            raise AssertionError(f"mixed serve {case}: far from the f32 answers: {vs_f32}, "
                                 f"{noise_vs_f32}")
        out[case] = {"launches": launches, "launches_by_dtype": by_dtype,
                     "rel_l2_vs_cpu": vs_cpu, "rel_l2_vs_f32": vs_f32,
                     "white_noise_rel_l2_vs_cpu": noise_vs_cpu,
                     "white_noise_rel_l2_vs_f32": noise_vs_f32, "latency_ms": latency_ms}
    return out


def mixed_eval(processor, f32_figures: dict) -> dict:
    """(2) the published weights in the mixed flagship on the 2000 test pairs."""
    from neuraloperator_tpu_torch.scripts import eval_ns_checkpoint as ev

    n_layers = flagship_meta()["init_kwargs"]["n_layers"]
    model, _ = mixed_flagship_on("cuda")
    xs, ys = ev.load_test_split(EVAL_RES, EVAL_PAIRS, device="cuda")
    reset_launches()
    t0 = time.perf_counter()
    figures = ev.evaluate(model, processor, xs, ys, EVAL_BATCH, device="cuda",
                          mixed_precision=True)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches, by_dtype = read_launches(), read_launches_by_dtype()
    log(f"mixed eval: {figures['pairs']} pairs at batch {EVAL_BATCH} in {eval_s:.3f} s: "
        f"rel_l2 {figures['rel_l2']:.6e} (bound {MIXED_L2_BOUND:.0e}), rel_h1 "
        f"{figures['rel_h1']:.6e} (bound {MIXED_H1_BOUND:.1e}); f32 {f32_figures}; "
        f"launches {by_dtype}")
    only_dtype(by_dtype, "bfloat16")
    expected = {"mode_contraction": n_layers * (EVAL_PAIRS // EVAL_BATCH),
                "mode_contraction_dx": 0, "mode_contraction_dw": 0}
    if launches != expected:
        raise AssertionError(f"the mixed evaluation launched {launches}, expected {expected}")
    if not (figures["rel_l2"] <= MIXED_L2_BOUND and figures["rel_h1"] <= MIXED_H1_BOUND):
        raise AssertionError(f"the mixed evaluation scores {figures}")
    head = slice(0, EVAL_CPU_PAIRS)
    t0 = time.perf_counter()
    on_card = ev.evaluate(model, processor, xs[head], ys[head], EVAL_BATCH, device="cuda",
                          mixed_precision=True)
    cpu_model, _ = mixed_flagship_on("cpu")
    on_cpu = ev.evaluate(cpu_model, processor, xs[head], ys[head], EVAL_BATCH, device="cpu",
                         mixed_precision=True)
    diff = {k: abs(on_card[k] - on_cpu[k]) / abs(on_cpu[k]) for k in ("rel_l2", "rel_h1")}
    log(f"mixed eval: first {EVAL_CPU_PAIRS} pairs, card {on_card} vs CPU {on_cpu} in "
        f"{time.perf_counter() - t0:.1f} s: relative differences {diff} "
        f"(tol {MIXED_EVAL_CPU_TOL})")
    if not max(diff.values()) <= MIXED_EVAL_CPU_TOL:
        raise AssertionError(f"the mixed evaluation on the card departs from the CPU: {diff}")
    return {"launches": launches, "launches_by_dtype": by_dtype, **figures, "eval_s": eval_s,
            "eval_rel_diff_vs_cpu": diff}


def mixed_train(f32_step_ms: float) -> dict:
    """(3) the mixed recipe through train_navier_stokes, the saved weights
    reloaded, the graphed step's time, idle share and peak memory."""
    from neuraloperator_tpu_torch.models import from_checkpoint
    from neuraloperator_tpu_torch.scripts import eval_ns_checkpoint as ev
    from neuraloperator_tpu_torch.serialization import read_msgpack
    from neuraloperator_tpu_torch.data.transforms import load_data_processor
    from neuraloperator_tpu_torch.training.training_state import load_training_state

    n_layers = flagship_meta()["init_kwargs"]["n_layers"]
    steps_per_epoch = RECIPE_PAIRS // TRAIN_BATCH
    # the recipe's flags with the mixed policy on, and one evaluation, at the end
    flags = list(RECIPE_FLAGS)
    for flag, value in {**MIXED_FLAGS, "--eval_interval": "25"}.items():
        if flag in flags:
            flags[flags.index(flag) + 1] = value
        else:
            flags += [flag, value]
    save_dir = Path(tempfile.mkdtemp(prefix="mixed-"))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        evals: list = []
        t0 = time.perf_counter()
        final = run_recipe_entry_point(
            [*flags, "--opt.n_epochs", str(MIXED_EPOCHS), "--save_dir", str(save_dir),
             "--warm_start_from", str(FLAGSHIP), "--warm_start_name", CHECKPOINT], evals)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches, by_dtype = read_launches(), read_launches_by_dtype()
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        trainer = evals[-1][0]
        step_ms = 1e3 * final["epoch_time"] / steps_per_epoch
        log(f"mixed train: {MIXED_EPOCHS} epochs x {steps_per_epoch} graphed steps in "
            f"{train_s:.1f} s; final {final}; launches {by_dtype}; graphed mixed step "
            f"{step_ms:.2f} ms vs the recipe's f32 {f32_step_ms:.2f} ms; peak device memory "
            f"{peak_mib:.0f} MiB")
        bad = {k: v for k, v in final.items() if not math.isfinite(v)}
        if bad:
            raise AssertionError(f"non-finite mixed training metrics {bad}")
        if not (final["128_l2"] <= MIXED_L2_BOUND and final["128_h1"] <= MIXED_H1_BOUND):
            raise AssertionError(f"the mixed run's evaluation scores {final}")
        only_dtype(by_dtype, "bfloat16")
        steps = MIXED_EPOCHS * steps_per_epoch
        expected = {"mode_contraction": n_layers * (steps + len(evals) * (EVAL_PAIRS // EVAL_BATCH)),
                    "mode_contraction_dx": n_layers * steps,
                    "mode_contraction_dw": n_layers * steps}
        if launches != expected or trainer.staged_step.graph is None:
            raise AssertionError(f"the mixed run launched {launches}, expected {expected}")
        saved = read_msgpack(save_dir / "model.msgpack")
        w_dtype = saved["fno_blocks"]["conv_0"]["w_weight"].dtype
        if w_dtype != torch.bfloat16:
            raise AssertionError(f"model.msgpack holds {w_dtype} spectral weights")
        rebuilt = from_checkpoint(save_dir, "model", device="cuda")
        rebuilt.load_state_dict(load_training_state(save_dir, "model", rebuilt.state_dict(),
                                                    device="cuda")[0])
        xs, ys = ev.load_test_split(EVAL_RES, EVAL_PAIRS, device="cuda")
        rescored = ev.evaluate(rebuilt.eval(), load_data_processor(save_dir), xs, ys, EVAL_BATCH,
                               device="cuda", mixed_precision=True)
        reload_err = abs(rescored["rel_l2"] - final["128_l2"]) / final["128_l2"]
        log(f"mixed train: model.msgpack holds bf16 spectral weights; rebuilt by "
            f"from_checkpoint it scores {rescored} against the run's 128_l2 "
            f"{final['128_l2']:.6e}: relative difference {reload_err:.2e} "
            f"(tol {MIXED_RELOAD_TOL:.0e})")
        if not reload_err <= MIXED_RELOAD_TOL:
            raise AssertionError(f"the reloaded mixed weights score {rescored}")
        del rebuilt
        staged = trainer.staged_step
        order = torch.from_numpy(np.random.default_rng(GRAPH_SEED).permutation(RECIPE_PAIRS)[
            :GRAPH_PROFILE_STEPS * TRAIN_BATCH].reshape(GRAPH_PROFILE_STEPS, TRAIN_BATCH)
        ).to(staged.index.device)

        def replays(n):
            for i in range(n):
                staged(order[i])

        replays(GRAPH_PROFILE_STEPS)  # warm
        idle = profile_window(f"{GRAPH_PROFILE_STEPS} graphed mixed train steps of batch "
                              f"{TRAIN_BATCH}", lambda: replays(GRAPH_PROFILE_STEPS))
        two = profile_window(f"2 graphed mixed train steps of batch {TRAIN_BATCH}",
                             lambda: replays(2))
        return {"launches": launches, "launches_by_dtype": by_dtype, "final": final,
                "train_s": train_s, "graphed_step_ms": step_ms, "f32_graphed_step_ms": f32_step_ms,
                "peak_mib": peak_mib, "reload_rel_diff": reload_err,
                "graphed_profile": idle, "two_replays_profile": two}
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)


def mixed_step(processor) -> dict:
    """(4) one mixed train step of batch 2, card against CPU: from the
    published weights on two test pairs, and from seeded weights on two
    synthetic pairs.

    At the published weights the H1 loss is the bf16 rounding noise itself
    (rel_h1 6e-2 against the f32 forward's 3.5e-4), and any two bf16
    pipelines decorrelate at their first rounding flip (on the CPU, one bf16
    ulp on 1% of the inputs moves such a gradient by 53%), so there only the
    loss is held to MIXED_STEP_LOSS_TOL and the gradients to
    MIXED_STEP_NOISE_GRAD_TOL; seeded weights give a gradient the data
    drives, held to MIXED_STEP_GRAD_TOL."""
    from neuraloperator_tpu_torch.models import model_from_metadata
    from neuraloperator_tpu_torch.scripts import eval_ns_checkpoint as ev

    xs, ys = ev.load_test_split(EVAL_RES, 2, device="cuda")
    model, meta = mixed_flagship_on("cuda")
    seeded = model_from_metadata(meta, device="cuda",
                                 generator=torch.Generator().manual_seed(SEED + 2))
    in_std = float(processor.in_normalizer.std.ravel()[0])
    cases = {"published": (model, mixed_flagship_on("cpu")[0], xs, ys, MIXED_STEP_NOISE_GRAD_TOL),
             "seeded": (seeded, cpu_copy(seeded, meta), *make_pairs(2, in_std, SEED + 3),
                        MIXED_STEP_GRAD_TOL)}
    out = {}
    for case, (card_model, host_model, x, y, grad_tol) in cases.items():
        t0 = time.perf_counter()
        loss_gpu, grads_gpu = one_step(card_model, processor, x, y, "cuda", mixed_precision=True)
        loss_cpu, grads_cpu = one_step(host_model, processor, x, y, "cpu", mixed_precision=True)
        loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
        names = sorted(grads_cpu)
        floor = 1e-2 * float(torch.cat([grads_cpu[n].double().ravel() for n in names]).norm())
        grad_err = {n: float((grads_gpu[n].double() - grads_cpu[n].double()).norm()
                             / max(float(grads_cpu[n].double().norm()), floor)) for n in names}
        total = rel_l2_t(torch.cat([grads_gpu[n].ravel() for n in names]),
                         torch.cat([grads_cpu[n].ravel() for n in names]))
        worst = max(grad_err, key=grad_err.get)
        log(f"mixed step ({case}): batch 2, card vs CPU in {time.perf_counter() - t0:.1f} s: "
            f"loss {loss_gpu:.7f} vs {loss_cpu:.7f} (rel {loss_err:.2e}, tol "
            f"{MIXED_STEP_LOSS_TOL:.0e}); gradients rel_l2 all {total:.2e}, per leaf max "
            f"{grad_err[worst]:.2e} ({worst}) (tol {grad_tol:g})")
        if not loss_err <= MIXED_STEP_LOSS_TOL:
            raise AssertionError(f"mixed step ({case}): card and CPU losses differ: {loss_err}")
        misses = {k: v for k, v in grad_err.items() if not v <= grad_tol}
        if case == "published":
            misses = {} if total <= grad_tol else misses
        if misses or not total <= grad_tol:
            raise AssertionError(f"mixed step ({case}): card and CPU gradients differ: "
                                 f"{total}, {misses}")
        out[case] = {"loss_rel_err": loss_err, "grad_rel_l2": total,
                     "grad_leaf_max": grad_err[worst], "grad_worst": worst}
    return out


def mixed(processor, served: dict, evaluated: dict, recipe_run: dict) -> dict:
    """The mixed phase; its launches summed over its four parts."""
    parts = {"serve": mixed_serve(processor, served),
             "eval": mixed_eval(processor, {k: evaluated[k] for k in ("rel_l2", "rel_h1")}),
             "train": mixed_train(recipe_run["step_ms"]["graphed"])}
    parts["step"] = mixed_step(processor)
    counted = [*parts["serve"].values(), parts["eval"], parts["train"]]
    by_dtype = {name: {dt: sum(p["launches_by_dtype"][name][dt] for p in counted)
                       for dt in ("float32", "bfloat16")} for name in kernel_specs()}
    return {"launches": {name: sum(c.values()) for name, c in by_dtype.items()},
            "launches_by_dtype": by_dtype, **parts}


def superres(processor) -> dict:
    """(10) zero-shot super-resolution of the published weights through the
    port's eval_ns_superres entry point, on test trajectories solved on the
    card at 256² and 512² by the port's generate_ns_data."""
    from neuraloperator_tpu_torch.data.datasets import navier_stokes
    from neuraloperator_tpu_torch.config import make_config_from_cli
    from neuraloperator_tpu_torch.scripts import eval_ns_superres, generate_ns_data
    from neuraloperator_tpu_torch.scripts import eval_ns_checkpoint as ev
    from neuraloperator_tpu_torch.scripts._checkpoint_cli import load_fno

    n_layers = flagship_meta()["init_kwargs"]["n_layers"]
    solver_s = {}
    for res, n_traj in SUPERRES_TRAJ.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate_ns_data.main(["--res", str(res), "--train-traj", "0", "--test-traj",
                               str(n_traj), "--device", "cuda"])
        solver_s[res] = time.perf_counter() - t0
        log(f"superres: {n_traj} test trajectories x 50 000 steps of {res}² generated on the "
            f"card in {solver_s[res]:.2f} s")
    argv = ["--save_dir", str(FLAGSHIP), "--save_name", CHECKPOINT, "--train_res", "128",
            "--eval_res", f"[{','.join(map(str, SUPERRES_RES))}]", "--max_pairs",
            str(SUPERRES_PAIRS), "--batch", str(SUPERRES_BATCH), *script_architecture()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    figures = eval_ns_superres.main(argv)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches, by_dtype = read_launches(), read_launches_by_dtype()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    log(f"superres: {figures} in {eval_s:.2f} s (weights loaded included); launches "
        f"{launches}; peak device memory {peak_mib:.0f} MiB")
    only_dtype(by_dtype, "float32")
    n_traj = {EVAL_RES: ev.TEST_TRAJECTORIES, **SUPERRES_TRAJ}
    pairs = {res: min(SUPERRES_PAIRS, 50 * n_traj[res]) for res in SUPERRES_RES}
    if {res: f["pairs"] for res, f in figures.items()} != pairs:
        raise AssertionError(f"superres scored {figures}, expected pairs {pairs}")
    expected = {"mode_contraction": n_layers * sum(-(-n // SUPERRES_BATCH)
                                                   for n in pairs.values()),
                "mode_contraction_dx": 0, "mode_contraction_dw": 0}
    if launches != expected:
        raise AssertionError(f"superres launched {launches}, expected {expected}")
    bounds = {128: (REL_L2_BOUND, REL_H1_BOUND), **SUPERRES_BOUNDS}
    for res, (l2_bound, h1_bound) in bounds.items():
        if not (figures[res]["rel_l2"] <= l2_bound and figures[res]["rel_h1"] <= h1_bound):
            raise AssertionError(f"superres at {res}²: {figures[res]} (bounds {l2_bound}, "
                                 f"{h1_bound})")
    # the first pairs at 256², card against CPU
    config = make_config_from_cli(eval_ns_superres.SRConfig, argv)
    path = navier_stokes.DATA_ROOT / "ns_raw" / "nsforcing_traj_test_256.npy"
    xs, ys = eval_ns_superres.load_pairs(path, SUPERRES_CPU_PAIRS)
    t0 = time.perf_counter()
    on_card = ev.evaluate(load_fno(config, "cuda"), processor, xs, ys, SUPERRES_BATCH, "cuda",
                          drop_last=False)
    on_cpu = ev.evaluate(load_fno(config, "cpu"), processor, xs, ys, SUPERRES_BATCH, "cpu",
                         drop_last=False)
    diff = {k: abs(on_card[k] - on_cpu[k]) / abs(on_cpu[k]) for k in ("rel_l2", "rel_h1")}
    log(f"superres: first {SUPERRES_CPU_PAIRS} pairs at 256², card {on_card} vs CPU {on_cpu} "
        f"in {time.perf_counter() - t0:.1f} s: relative differences {diff} (tol "
        f"{EVAL_CPU_TOL:.0e})")
    if not max(diff.values()) <= EVAL_CPU_TOL:
        raise AssertionError(f"superres on the card departs from the CPU: {diff}")
    return {"launches": launches, "launches_by_dtype": by_dtype, "figures": figures,
            "solver_s": solver_s, "eval_s": eval_s, "peak_mib": peak_mib,
            "rel_diff_vs_cpu": diff}


def rollout(processor) -> dict:
    """(11) the 10-step rollout of the published weights through the port's
    eval_ns_rollout entry point, then its pushforward fine-tune, then one
    rollout train step card against CPU."""
    from neuraloperator_tpu_torch.scripts import eval_ns_checkpoint as ev
    from neuraloperator_tpu_torch.scripts import eval_ns_rollout

    n_layers = flagship_meta()["init_kwargs"]["n_layers"]
    argv = ["--save_dir", str(FLAGSHIP), "--save_name", CHECKPOINT, "--res", str(EVAL_RES),
            "--horizon", str(ROLLOUT_HORIZON), "--n_traj", str(ev.TEST_TRAJECTORIES),
            "--batch", str(TRAIN_BATCH), *script_architecture()]
    rollout_batches = -(-ev.TEST_TRAJECTORIES // TRAIN_BATCH)
    reset_launches()
    t0 = time.perf_counter()
    before = eval_ns_rollout.main(argv)["rollout_l2"]
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    launches, eval_by_dtype = read_launches(), read_launches_by_dtype()
    log(f"rollout: {ev.TEST_TRAJECTORIES} trajectories x {ROLLOUT_HORIZON} steps in "
        f"{rollout_s:.2f} s: rel_l2 per step {before.tolist()}; launches {launches}")
    expected = {"mode_contraction": n_layers * ROLLOUT_HORIZON * rollout_batches,
                "mode_contraction_dx": 0, "mode_contraction_dw": 0}
    if launches != expected:
        raise AssertionError(f"the rollout launched {launches}, expected {expected}")
    for t, bound in ROLLOUT_BOUNDS.items():
        if not before[t - 1] <= bound:
            raise AssertionError(f"rollout t={t}: {before[t - 1]} (bound {bound})")

    windows = RECIPE_TRAIN_TRAJ * (50 + 1 - ROLLOUT_K)
    steps = windows // TRAIN_BATCH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    tuned = eval_ns_rollout.main([*argv, "--pushforward_epochs", "1", "--rollout_steps",
                                  str(ROLLOUT_K), "--train_traj", str(RECIPE_TRAIN_TRAJ)])
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    launches, by_dtype = read_launches(), read_launches_by_dtype()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    metrics, after = tuned["pushforward_metrics"], tuned["pushforward_rollout_l2"]
    step_ms = 1e3 * metrics["epoch_time"] / steps
    log(f"rollout: pushforward fine-tune, 1 epoch of {steps} steps of K={ROLLOUT_K} at batch "
        f"{TRAIN_BATCH} on {windows} windows, in {tune_s:.1f} s (both rollouts included): {metrics}, "
        f"{step_ms:.2f} ms per step; rel_l2 per step after {after.tolist()}; launches "
        f"{launches}; peak device memory {peak_mib:.0f} MiB")
    only_dtype(by_dtype, "float32")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite pushforward losses: {metrics}")
    if not np.array_equal(tuned["rollout_l2"], before):
        raise AssertionError("the same rollout scored differently in two runs")
    if not after[-1] <= PUSHFORWARD_T10_BOUND:
        raise AssertionError(f"the pushforward fine-tune took t={ROLLOUT_HORIZON} from "
                             f"{before[-1]} to {after[-1]} (bound {PUSHFORWARD_T10_BOUND})")
    per_step = n_layers * ROLLOUT_K * steps
    expected = {"mode_contraction": per_step + 2 * n_layers * ROLLOUT_HORIZON * rollout_batches,
                "mode_contraction_dx": per_step, "mode_contraction_dw": per_step}
    if launches != expected:
        raise AssertionError(f"the pushforward fine-tune launched {launches}, expected "
                             f"{expected}")
    step = rollout_step_with_cpu(processor)
    # both runs of the entry point; the step against the CPU is a check
    total = {name: {dt: eval_by_dtype[name][dt] + by_dtype[name][dt]
                    for dt in ("float32", "bfloat16")} for name in by_dtype}
    return {"launches": {name: sum(c.values()) for name, c in total.items()},
            "launches_by_dtype": total,
            "rollout_l2": before.tolist(), "pushforward_rollout_l2": after.tolist(),
            "pushforward_metrics": metrics, "pushforward_step_ms": step_ms,
            "rollout_s": rollout_s, "pushforward_s": tune_s, "peak_mib": peak_mib, **step}


def script_architecture() -> list:
    """The evaluation scripts' architecture flags: the flagship's."""
    kw = flagship_meta()["init_kwargs"]
    return ["--n_modes", str(kw["n_modes"][0]), "--hidden_channels", str(kw["hidden_channels"]),
            "--projection_channel_ratio", str(kw["projection_channel_ratio"])]


def rollout_step_with_cpu(processor) -> dict:
    """One rollout train step (K=2, batch 2) of seeded weights on two windows
    of the training trajectories, on the card and on the CPU."""
    from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset, navier_stokes
    from neuraloperator_tpu_torch.data.datasets.ns_solver import trajectories_to_windows
    from neuraloperator_tpu_torch.losses import H1Loss
    from neuraloperator_tpu_torch.models import model_from_metadata
    from neuraloperator_tpu_torch.training import Trainer, adamw

    traj = np.load(navier_stokes.DATA_ROOT / "ns_raw" / f"nsforcing_traj_train_{EVAL_RES}.npy",
                   mmap_mode="r")
    x, y = trajectories_to_windows(np.array(traj[:1, :ROLLOUT_STEP_K + 2]), ROLLOUT_STEP_K)
    x, y = x[:2], y[:2]
    meta = flagship_meta()
    model = model_from_metadata(meta, device="cuda",
                                generator=torch.Generator().manual_seed(SEED + 2))
    cpu_model = cpu_copy(model, meta)
    results = {}
    t0 = time.perf_counter()
    for device, m in (("cuda", model), ("cpu", cpu_model)):
        trainer = Trainer(model=m, n_epochs=1, data_processor=processor, device=device)
        metrics = trainer.train(DataLoader(TensorDataset(x, y), 2), {}, adamw(1e-4),
                                training_loss=H1Loss(d=2), rollout_steps=ROLLOUT_STEP_K)
        results[device] = (metrics["train_err"], {n: p.grad.detach().float().cpu()
                                                  for n, p in m.named_parameters()})
    (loss_gpu, grads_gpu), (loss_cpu, grads_cpu) = results["cuda"], results["cpu"]
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    grad_err = {n: float((grads_gpu[n].double() - g.double()).norm() / g.double().norm())
                for n, g in grads_cpu.items()}
    worst = max(grad_err, key=grad_err.get)
    log(f"rollout: one step of K={ROLLOUT_STEP_K}, batch 2, card vs CPU in "
        f"{time.perf_counter() - t0:.1f} s: loss {loss_gpu:.7f} vs {loss_cpu:.7f} (rel "
        f"{loss_err:.2e}, tol {STEP_LOSS_TOL:.0e}); gradients rel_l2 max {grad_err[worst]:.2e} "
        f"({worst}, tol {STEP_GRAD_TOL:.0e})")
    if not loss_err <= STEP_LOSS_TOL:
        raise AssertionError(f"rollout step: card and CPU losses differ: {loss_err}")
    misses = {k: v for k, v in grad_err.items() if not v <= STEP_GRAD_TOL}
    if misses:
        raise AssertionError(f"rollout step: card and CPU gradients differ: {misses}")
    return {"step_loss_rel_err": loss_err, "step_grad_rel_l2_max": grad_err[worst]}


class Tee:
    """A text stream that keeps what is written to it and passes it on."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def text(self) -> str:
        return "".join(self.parts)


def replay_ms(staged, n: int) -> float:
    """Host-clock ms per replay of the staged step over ``n`` replays, warm."""
    staged_samples = len(staged.data["x"])
    order = (torch.arange(n * TRAIN_BATCH, device=staged.index.device)
             % staged_samples).reshape(n, TRAIN_BATCH)
    for i in range(n):
        staged(order[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        staged(order[i])
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def replays_draw_new_noise(trainer) -> float:
    """Two replays of the stochastically rounded graphed step from one saved
    state (parameters, optimizer state, count): the share of parameter
    elements they round apart. Raises unless some differ, each by at most
    one bf16 ulp."""
    staged, optimizer = trainer.staged_step, trainer.optimizer
    params = list(trainer.model.parameters())
    tensors = [*params, optimizer.count, optimizer.lr, optimizer.bias_correction,
               *(t for s in optimizer.state.values() for t in s.values())]
    saved = [t.detach().clone() for t in tensors]
    index = torch.arange(TRAIN_BATCH, device=staged.index.device)
    results = []
    for _ in range(2):
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        staged(index)
        torch.cuda.synchronize()
        results.append(torch.cat([p.detach().float().ravel() for p in params]))
    first, second = results
    apart = first != second
    within_ulp = bool(((first - second).abs() <= first.abs() * 2.0 ** -7).all())
    if not (bool(apart.any()) and within_ulp):
        raise AssertionError(f"two replays from one state: {int(apart.sum())} elements apart, "
                             f"within one ulp: {within_ulp}")
    del saved
    return float(apart.double().mean())


def option_run(name: str, flags: list, mixed_final: dict) -> dict:
    """One option of the options phase: a graphed epoch warm-started from the
    published weights, its checks, then one more epoch resumed from its files."""
    import ast

    from neuraloperator_tpu_torch.serialization import read_msgpack
    from neuraloperator_tpu_torch.training.training_state import read_manifest

    n_layers = flagship_meta()["init_kwargs"]["n_layers"]
    steps_per_epoch = RECIPE_PAIRS // TRAIN_BATCH
    batches_per_eval = EVAL_PAIRS // EVAL_BATCH
    save_dir = Path(tempfile.mkdtemp(prefix=f"{name}-"))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        evals: list = []
        tee = Tee(sys.stdout)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            first = run_recipe_entry_point(
                [*flags, "--opt.n_epochs", "1", "--save_dir", str(save_dir),
                 "--warm_start_from", str(FLAGSHIP), "--warm_start_name", CHECKPOINT], evals)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches, by_dtype = read_launches(), read_launches_by_dtype()
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        # the run's Trainer (an EMA run evaluates the EMA through another)
        trainer = next(t for t, _ in evals if t.staged_step is not None)
        optimizer = trainer.optimizer
        out = {"first": first, "train_s": train_s, "peak_mib": peak_mib}
        only_dtype(by_dtype, "bfloat16")
        expected = {"mode_contraction": n_layers * (steps_per_epoch
                                                    + len(evals) * batches_per_eval),
                    "mode_contraction_dx": n_layers * steps_per_epoch,
                    "mode_contraction_dw": n_layers * steps_per_epoch}
        if launches != expected or trainer.staged_step.graph is None:
            raise AssertionError(f"{name}: launched {launches}, expected {expected}")
        if not all(math.isfinite(v) for v in first.values()):
            raise AssertionError(f"{name}: non-finite metrics {first}")
        # the saved optimizer state is the live one, and reads back into it, to the bit
        live = flat_state(optimizer.state_dict())
        saved = flat_state(read_msgpack(save_dir / "optimizer.msgpack"))
        optimizer.load_state_dict(read_msgpack(save_dir / "optimizer.msgpack"))
        reread = flat_state(optimizer.state_dict())
        same = set(live) == set(saved) == set(reread) and all(
            torch.equal(live[k], saved[k]) and torch.equal(live[k], reread[k]) for k in live)
        if not same:
            raise AssertionError(f"{name}: optimizer.msgpack does not round-trip to the bit")
        if name == "factored8":
            codes = {k: v for k, v in live.items() if k.endswith(".codes")}
            if not codes or any(v.dtype != torch.int8 for v in codes.values()):
                raise AssertionError(f"{name}: the saved state holds no int8 codes")
            out["int8_leaves"] = len(codes)
        if name == "stochastic_rounding":
            dtypes = {str(p.dtype) for p in trainer.model.parameters()}
            if dtypes != {"torch.bfloat16"}:
                raise AssertionError(f"{name}: parameters in {dtypes}")
            out["replays_apart_share"] = replays_draw_new_noise(trainer)
        if name == "ema":
            lines = [ln for ln in tee.text().splitlines() if ln.startswith("ema: ")]
            ema = ast.literal_eval(lines[-1][len("ema: "):]) if lines else {}
            if not (ema and all(math.isfinite(v) for v in ema.values())):
                raise AssertionError(f"{name}: the EMA evaluation printed {lines}")
            out["ema"] = ema
        out["graphed_step_ms"] = replay_ms(trainer.staged_step, GRAPH_PROFILE_STEPS)
        log(f"options ({name}): 1 epoch of {steps_per_epoch} graphed steps in {train_s:.1f} s; "
            f"final {first}; launches {by_dtype}; optimizer.msgpack round-trips to the bit; "
            f"graphed step {out['graphed_step_ms']:.2f} ms (host clock, {GRAPH_PROFILE_STEPS} "
            f"warm replays); peak device memory {peak_mib:.0f} MiB; "
            f"{ {k: v for k, v in out.items() if k in ('int8_leaves', 'replays_apart_share', 'ema')} }")
        del trainer, optimizer, evals, live, saved, reread

        resumed_evals: list = []
        reset_launches()
        with contextlib.redirect_stdout(Tee(sys.stdout)):
            resumed = run_recipe_entry_point(
                [*flags, "--opt.n_epochs", "2", "--save_dir", str(save_dir),
                 "--resume_from_dir", str(save_dir)], resumed_evals)
        torch.cuda.synchronize()
        resumed_by_dtype = read_launches_by_dtype()
        only_dtype(resumed_by_dtype, "bfloat16")
        by_dtype = {k: {dt: n + resumed_by_dtype[k][dt] for dt, n in c.items()}
                    for k, c in by_dtype.items()}
        launches = {k: sum(c.values()) for k, c in by_dtype.items()}
        expected = {k: 2 * n for k, n in expected.items()}
        if launches != expected:
            raise AssertionError(f"{name}: the run and its resumed one launched {launches}, "
                                 f"expected {expected}")
        trainer = next(t for t, _ in resumed_evals if t.staged_step is not None)
        if not (trainer.start_epoch == 1 and int(trainer.optimizer.count) == 2 * steps_per_epoch
                and read_manifest(save_dir)["epoch"] == 1):
            raise AssertionError(f"{name}: the resumed run started at epoch "
                                 f"{trainer.start_epoch} and ended at count "
                                 f"{int(trainer.optimizer.count)}")
        bounds = {k: OPTIONS_EVAL_FACTOR * mixed_final[k] for k in ("128_l2", "128_h1")}
        log(f"options ({name}): resumed to epoch 2: final {resumed} (bounds {bounds}, twice "
            f"the mixed fine-tune's)")
        if not all(math.isfinite(v) for v in resumed.values()):
            raise AssertionError(f"{name}: non-finite metrics after the resume {resumed}")
        if not all(resumed[k] <= b for k, b in bounds.items()):
            raise AssertionError(f"{name}: the resumed run scores {resumed} (bounds {bounds})")
        out["resumed"] = resumed
        out["launches"], out["launches_by_dtype"] = launches, by_dtype
        return out
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)


def flat_state(tree) -> dict:
    """An optimizer state tree as ``{dotted name: CPU tensor}``."""
    from neuraloperator_tpu_torch.convert import as_tensor, flatten_flax

    return {k: as_tensor(v).detach().cpu() for k, v in flatten_flax(tree).items()}


def options(mixed_run: dict) -> dict:
    """(12) the recipes' optimizer options through train_navier_stokes with
    the mixed flags: factored8, stochastic rounding and EMA."""
    flags = list(RECIPE_FLAGS)
    for flag, value in {**MIXED_FLAGS, "--eval_interval": "25"}.items():
        if flag in flags:
            flags[flags.index(flag) + 1] = value
        else:
            flags += [flag, value]
    mixed_final = mixed_run["train"]["final"]
    runs = {}
    for name, option in OPTIONS.items():
        extra = list(flags)
        for flag, value in option.items():
            if flag in extra:
                extra[extra.index(flag) + 1] = value
            else:
                extra += [flag, value]
        runs[name] = option_run(name, extra, mixed_final)
    mixed_ms = mixed_run["train"]["graphed_profile"]["wall_ms"] / GRAPH_PROFILE_STEPS
    log(f"options: graphed step ms (host clock over {GRAPH_PROFILE_STEPS} warm replays) "
        f"{ {n: round(r['graphed_step_ms'], 3) for n, r in runs.items()} } beside the mixed "
        f"phase's {mixed_ms:.3f} ms ({GRAPH_PROFILE_STEPS} profiled replays) and "
        f"{mixed_run['train']['graphed_step_ms']:.3f} ms (its last epoch)")
    by_dtype = {name: {dt: sum(r["launches_by_dtype"][name][dt] for r in runs.values())
                       for dt in ("float32", "bfloat16")} for name in kernel_specs()}
    return {"launches": {name: sum(c.values()) for name, c in by_dtype.items()},
            "launches_by_dtype": by_dtype, "mixed_graphed_step_ms": mixed_ms, **runs}


def served_bytes(served) -> dict:
    """The bytes a CompiledForward keeps for its weights, by kind."""
    out = {"int8_codes": 0, "scales": 0, "unquantized": 0}
    for codes, scale in served._params.values():
        if scale is None:
            out["unquantized"] += codes.numel() * codes.element_size()
        else:
            out["int8_codes"] += codes.numel() * codes.element_size()
            out["scales"] += scale.numel() * scale.element_size()
    return out


def int8_serve(processor, served: dict) -> dict:
    """(1) the published weights served as int8 codes and scales."""
    from neuraloperator_tpu_torch.scripts import eval_ns_checkpoint as ev
    from neuraloperator_tpu_torch.serving import CompiledForward

    n_layers = flagship_meta()["init_kwargs"]["n_layers"]
    requests, f32_answers = served["_requests"], served["_answers"]
    fns = dict(preprocess_fn=processor.in_normalizer.transform,
               postprocess_fn=processor.out_normalizer.inverse_transform)
    example = torch.zeros(1, 1, 128, 128)
    model, _ = load_flagship_on("cuda")
    f32_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    srv = CompiledForward(model, example, batch_sizes=BUCKETS, quantize="int8", device="cuda",
                          **fns)
    scorer = CompiledForward(model, example, batch_sizes=(EVAL_BATCH,), quantize="int8",
                             device="cuda")
    del model
    torch.cuda.empty_cache()
    resident = served_bytes(srv)
    log(f"int8 serve: resident weight bytes {resident} ({sum(resident.values()) / 1e6:.1f} MB) "
        f"against {f32_bytes / 1e6:.1f} MB of f32 weights; first runs (s) "
        f"{srv.compile_seconds}")
    reset_launches()
    answers = []
    for x in requests:
        answers.append(srv(x))
        torch.cuda.synchronize()
    launches, by_dtype = read_launches(), read_launches_by_dtype()
    only_dtype(by_dtype, "float32")
    expected = {"mode_contraction": n_layers * len(REQUESTS),
                "mode_contraction_dx": 0, "mode_contraction_dw": 0}
    if launches != expected:
        raise AssertionError(f"the int8 serve launched {launches}, expected {expected}")
    cpu_model, _ = load_flagship_on("cpu")
    host = CompiledForward(cpu_model, example,
                           batch_sizes=sorted(set(REQUESTS[:CPU_REQUEST_GROUPS])),
                           quantize="int8", device="cpu", **fns)
    del cpu_model
    vs_cpu = [rel_l2_t(a, host(x)) for x, a in zip(requests[:CPU_REQUEST_GROUPS], answers)]
    vs_f32 = [rel_l2_t(a, f) for a, f in zip(answers, f32_answers)]
    finite = all(bool(torch.isfinite(a).all()) for a in answers)
    latency_ms = {b: 1e3 * srv.latency_probe(batch_size=b, iters=20) for b in BUCKETS}
    log(f"int8 serve: {len(REQUESTS)} requests, launches {by_dtype}; rel_l2 vs the CPU port's "
        f"int8 answers to the first {CPU_REQUEST_GROUPS} max {max(vs_cpu):.3e} (tol "
        f"{SERVE_TOL:.0e}); vs the f32 answers "
        f"{[f'{e:.3e}' for e in vs_f32]}; latency_probe ms {latency_ms}")
    if not finite:
        raise AssertionError("the int8 serve gave non-finite answers")
    if not max(vs_cpu) <= SERVE_TOL:
        raise AssertionError(f"int8 answers on the card and the CPU differ: {vs_cpu}")
    xs, ys = ev.load_test_split(EVAL_RES, EVAL_PAIRS, device="cuda")
    reset_launches()
    t0 = time.perf_counter()
    figures = ev.evaluate(scorer, processor, xs, ys, EVAL_BATCH, device="cuda")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches, eval_by_dtype = read_launches(), read_launches_by_dtype()
    only_dtype(eval_by_dtype, "float32")
    log(f"int8 eval: {figures['pairs']} pairs at batch {EVAL_BATCH} in {eval_s:.3f} s: rel_l2 "
        f"{figures['rel_l2']:.6e} (bound {INT8_L2_BOUND:.3e}), rel_h1 {figures['rel_h1']:.6e} "
        f"(bound {INT8_H1_BOUND:.3e}); launches {eval_launches}")
    if eval_launches["mode_contraction"] != n_layers * (EVAL_PAIRS // EVAL_BATCH):
        raise AssertionError(f"the int8 evaluation launched {eval_launches}")
    if not (figures["rel_l2"] <= INT8_L2_BOUND and figures["rel_h1"] <= INT8_H1_BOUND):
        raise AssertionError(f"the int8 evaluation scores {figures}")
    total = {name: {dt: by_dtype[name][dt] + eval_by_dtype[name][dt] for dt in by_dtype[name]}
             for name in by_dtype}
    return {"launches_by_dtype": total, "resident_bytes": resident, "f32_bytes": f32_bytes,
            "rel_l2_vs_cpu": vs_cpu, "rel_l2_vs_f32": vs_f32, "latency_ms": latency_ms,
            "eval": figures, "eval_s": eval_s}


_LOAD_EXPORTED = """
import json, sys, time
import torch
torch.backends.cuda.matmul.allow_tf32 = True
t0 = time.perf_counter()
from neuraloperator_tpu_torch.ops import spectral_contraction as tsc
from neuraloperator_tpu_torch.serving import load_exported
import_s = time.perf_counter() - t0
# warm: the card's context and torch.export's save and load, on a toy module
t0 = time.perf_counter()
toy = torch.export.export(torch.nn.Linear(2, 2).cuda(), (torch.zeros(1, 2, device="cuda"),))
path = sys.argv[1] + "/toy.pt2"
torch.export.save(toy, path)
torch.export.load(path).module()(torch.zeros(1, 2, device="cuda"))
torch.cuda.synchronize()
print(json.dumps({"import_s": import_s, "warm_s": time.perf_counter() - t0,
                  "allow_tf32": torch.backends.cuda.matmul.allow_tf32}), flush=True)
for line in sys.stdin:
    reports = []
    for artifact, inputs, answers in json.loads(line):
        t0 = time.perf_counter()
        forward = load_exported(artifact)
        load_s = time.perf_counter() - t0
        xs = torch.load(inputs)
        tsc.reset_launch_counts()
        torch.save([forward(x.cuda()).cpu() for x in xs], answers)
        torch.cuda.synchronize()
        reports.append({"load_s": load_s, "launches": tsc.launch_counts(by_dtype=True)})
        del forward
    print(json.dumps(reports), flush=True)
"""


class FreshProcess:
    """One new python3 process that switches TF32 on, warms torch.export on a
    toy module while this one goes on, then loads and runs the artifacts it
    is sent, one after the other, until its input closes. The exported
    artifacts of phases 12 and 14 share it: a process's first load of an
    artifact took some 15 s, a later one 2 s."""

    def __init__(self):
        self.proc, self.started, self.stderr, self.work = None, None, None, None

    def start(self) -> None:
        if self.proc is None:
            self.stderr = tempfile.TemporaryFile(mode="w+")
            self.work = tempfile.mkdtemp(prefix="fresh-")
            self.proc = subprocess.Popen(
                [sys.executable, "-c", _LOAD_EXPORTED, self.work], cwd=ROOT, text=True,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.stderr,
                env={**os.environ, "PYTHONPATH": str(ROOT)})

    def answer(self, jobs, work: Path) -> tuple:
        """Each ``(artifact, inputs)`` of ``jobs`` loaded and run by the
        process: the answers and the report of each, the process's report
        (its imports' and warm-up's seconds, TF32) and this call's wall
        seconds, the wait for the process's warm-up included."""
        t0 = time.perf_counter()
        self.start()
        if self.started is None:
            self.started = json.loads(self._line())
        spec = []
        for i, (artifact, inputs) in enumerate(jobs):
            torch.save(inputs, work / f"inputs{i}.pt")
            spec.append([str(artifact), str(work / f"inputs{i}.pt"),
                         str(work / f"answers{i}.pt")])
        self.proc.stdin.write(json.dumps(spec) + "\n")
        self.proc.stdin.flush()
        reports = json.loads(self._line())
        answers = [torch.load(work / f"answers{i}.pt") for i in range(len(jobs))]
        return list(zip(answers, reports)), self.started, time.perf_counter() - t0

    def _line(self) -> str:
        line = self.proc.stdout.readline()
        if not line:
            self.close()
            self.stderr.seek(0)
            err = self.stderr.read()
            raise AssertionError(f"the fresh process loading the artifacts failed: "
                                 f"{err[-3000:]}")
        return line

    def close(self) -> None:
        if self.proc is not None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
            self.proc = None
            shutil.rmtree(self.work, ignore_errors=True)


FRESH = FreshProcess()
atexit.register(FRESH.close)


def artifact_graph_and_answers(label: str, artifact: Path, eager, n_layers: int,
                               in_std: float) -> tuple:
    """The artifact's graph checked (one contraction operator per layer, no
    einsum); the inputs it is to answer, and ``eager``'s answers to them."""
    graph = torch.export.load(str(artifact)).graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    ops = targets.count("neuraloperator_tpu_torch.mode_contraction.default")
    einsums = [t for t in targets if "einsum" in t]
    if ops != n_layers or einsums:
        raise AssertionError(f"{label}: the exported graph holds {ops} contraction operators "
                             f"and {einsums}")
    gen = torch.Generator().manual_seed(SEED + 20)
    inputs = [in_std * torch.randn(n, 1, 128, 128, generator=gen) for n in EXPORT_BATCHES]
    return ops, inputs, [eager(x).cpu() for x in inputs]


def check_artifact_answers(label: str, ops: int, want, answers, report: dict, process: dict,
                           wall_s: float, n_layers: int) -> dict:
    """A fresh process's answers to an artifact against ``want``, and its launches."""
    errs = [rel_l2_t(a, w) for a, w in zip(answers, want)]
    k1 = report["launches"]["mode_contraction"]
    log(f"{label}: graph holds {ops} contraction operators and no einsum; a fresh process "
        f"(TF32 on: {process['allow_tf32']}; its imports {process['import_s']:.2f} s and "
        f"warm-up {process['warm_s']:.2f} s at the script's start; {wall_s:.1f} s for the "
        f"call) loaded it in {report['load_s']:.2f} s and answered batches "
        f"{EXPORT_BATCHES}: rel_l2 vs eager {errs} (tol {EXPORT_TOL:.0e}); K1 launches {k1}")
    if not (process["allow_tf32"] and max(errs) <= EXPORT_TOL):
        raise AssertionError(f"{label}: the loaded artifact departs from eager: {errs}")
    expected = {"float32": n_layers * len(EXPORT_BATCHES), "bfloat16": 0}
    if k1 != expected or any(sum(c.values()) for n, c in report["launches"].items()
                             if n != "mode_contraction"):
        raise AssertionError(f"{label}: the fresh process launched {report['launches']}")
    return {"operators": ops, "rel_l2_vs_eager": errs, "load_s": report["load_s"],
            "process_s": wall_s, "launches_by_dtype": report["launches"]}


def export_phase(processor) -> dict:
    """(2) export_forward of the published weights and serve_model --export
    --bf16, both loaded, one after the other, by one fresh process."""
    from neuraloperator_tpu_torch.scripts import serve_model
    from neuraloperator_tpu_torch.serving import CompiledForward, export_forward

    n_layers = flagship_meta()["init_kwargs"]["n_layers"]
    in_std = float(processor.in_normalizer.std.ravel()[0])
    fns = dict(preprocess_fn=processor.in_normalizer.transform,
               postprocess_fn=processor.out_normalizer.inverse_transform)
    example = torch.zeros(1, 1, 128, 128)
    out = {}
    work = Path(tempfile.mkdtemp(prefix="export-"))
    try:
        model, _ = load_flagship_on("cuda")
        artifact = work / "fno.pt2"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = export_forward(model, example, path=artifact, **fns)
        export_s = time.perf_counter() - t0
        log(f"export: export_forward (symbolic batch) of the published weights: "
            f"{len(blob) / 1e6:.1f} MB in {export_s:.2f} s")
        eager = CompiledForward(model, example, batch_sizes=EXPORT_BATCHES, device="cuda", **fns)
        del blob, model
        f32_ops, f32_inputs, f32_want = artifact_graph_and_answers("export", artifact, eager,
                                                                   n_layers, in_std)
        del eager
        # serve_model --export --bf16 on the published checkpoint, under its names
        ckpt = work / "ckpt"
        ckpt.mkdir()
        for name in (f"{CHECKPOINT}.msgpack", "data_processor.json", "manifest.json"):
            (ckpt / name).symlink_to(FLAGSHIP / name)
        shutil.copy(FLAGSHIP / "model_metadata.json", ckpt / f"{CHECKPOINT}_metadata.json")
        bf16_artifact = work / "fno_bf16.pt2"
        t0 = time.perf_counter()
        result = serve_model.main(["--ckpt_dir", str(ckpt), "--name", CHECKPOINT, "--shape",
                                   "[1,128,128]", "--buckets", "[1,8]", "--bf16", "true",
                                   "--probe_iters", "5", "--export", str(bf16_artifact),
                                   "--device", "cuda"])
        script_s = time.perf_counter() - t0
        model, _ = load_flagship_on("cuda")
        eager = CompiledForward(model, example, batch_sizes=EXPORT_BATCHES, device="cuda",
                                param_dtype=torch.bfloat16, **fns)
        del model
        bf16_label = "serve_model --export --bf16"
        bf16_ops, bf16_inputs, bf16_want = artifact_graph_and_answers(
            bf16_label, bf16_artifact, eager, n_layers, in_std)
        del eager
        # both artifacts answered by one fresh process, one after the other
        ((f32_answers, f32_report), (bf16_answers, bf16_report)), process, wall_s = \
            FRESH.answer([(artifact, f32_inputs), (bf16_artifact, bf16_inputs)], work)
        out["f32"] = {"mb": artifact.stat().st_size / 1e6, "export_s": export_s,
                      **check_artifact_answers("export", f32_ops, f32_want, f32_answers,
                                               f32_report, process, wall_s, n_layers)}
        out["bf16"] = {"mb": result["export_mb"], "script_s": script_s,
                       "latency_ms": result["latency_ms"],
                       **check_artifact_answers(bf16_label, bf16_ops, bf16_want, bf16_answers,
                                                bf16_report, process, wall_s, n_layers)}
        log(f"export: artifact MB f32 {out['f32']['mb']:.1f}, bf16 {out['bf16']['mb']:.1f}")
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def quantize_export(processor, served: dict) -> dict:
    """(12) int8 serving and exported forwards; the launches of the int8
    serve and evaluation, and those the fresh process counted running the
    two artifacts."""
    parts = {"int8": int8_serve(processor, served), "export": export_phase(processor)}
    counted = [parts["int8"], parts["export"]["f32"], parts["export"]["bf16"]]
    by_dtype = {name: {dt: sum(c["launches_by_dtype"][name][dt] for c in counted)
                       for dt in ("float32", "bfloat16")} for name in kernel_specs()}
    return {"launches": {name: sum(c.values()) for name, c in by_dtype.items()},
            "launches_by_dtype": by_dtype, **parts}


def train_step_launches(model, processor, x, y) -> tuple:
    """One Trainer step on the card: (loss, grads, launches by dtype, peak MiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    loss, grads = one_step(model, processor, x, y, "cuda")
    torch.cuda.synchronize()
    return loss, grads, read_launches_by_dtype(), torch.cuda.max_memory_allocated() / 2**20


def graphed_vs_loop(meta, processor, x, y) -> dict:
    """Two staged epochs as replayed CUDA graphs against the loader loop over
    the same batches, from the same seeded weights; the graphed step's ms."""
    from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
    from neuraloperator_tpu_torch.losses import H1Loss
    from neuraloperator_tpu_torch.models import model_from_metadata
    from neuraloperator_tpu_torch.training import Trainer, build_optimizer

    n = len(x)
    shuffle = np.random.default_rng(GRAPH_SEED)
    orders = [shuffle.permutation(n) for _ in range(GRAPH_EPOCHS)]
    runs = {}
    for staged in (True, False):
        model = model_from_metadata(meta, device="cuda",
                                    generator=torch.Generator().manual_seed(SEED + 4))
        if staged:
            loader = DataLoader(TensorDataset(x, y), TRAIN_BATCH)
        else:
            ynorm = runs[True][1].staged_step.data["_loss_ynorm_sq"].cpu().numpy()
            loader = EpochOrders(x, y, [orders[0], *orders], TRAIN_BATCH, _loss_ynorm_sq=ynorm)
        trainer = Trainer(model=model, n_epochs=GRAPH_EPOCHS, data_processor=processor,
                          device="cuda")
        metrics = trainer.train(loader, {}, build_optimizer(OPT, n // TRAIN_BATCH),
                                training_loss=H1Loss(d=2), device_dataset=staged,
                                shuffle_seed=GRAPH_SEED)
        torch.cuda.synchronize()
        runs[staged] = (metrics, trainer)
    (graphed, g_trainer), (eager, e_trainer) = runs[True], runs[False]
    loss_err = abs(graphed["train_err"] - eager["train_err"]) / abs(eager["train_err"])
    want = dict(e_trainer.model.named_parameters())
    param_err = {name: rel_l2_t(p, want[name]) for name, p in g_trainer.model.named_parameters()}
    worst = max(param_err, key=param_err.get)
    if not (g_trainer.staged_step.graph is not None and loss_err <= GRAPH_TOL
            and param_err[worst] <= GRAPH_TOL):
        raise AssertionError(f"the graphed steps depart from the loop: loss {loss_err}, "
                             f"{worst} {param_err[worst]}")
    return {"loss_rel_err": loss_err, "param_rel_l2_max": param_err[worst],
            "step_ms": replay_ms(g_trainer.staged_step, GRAPH_PROFILE_STEPS),
            "launches_per_replay": g_trainer.staged_step._launches_per_replay}


def remat_phase(processor, recipe_step_ms: float) -> dict:
    """(1) one eager step with and without remat from the same seeded
    weights, then remat's graphed steps against the loop."""
    from neuraloperator_tpu_torch.models import model_from_metadata

    meta = flagship_meta()
    n_layers = meta["init_kwargs"]["n_layers"]
    in_std = float(processor.in_normalizer.std.ravel()[0])
    x, y = make_pairs(REMAT_STEPS * TRAIN_BATCH, in_std, SEED + 5)
    steps = {}
    for remat in (False, True):
        meta["init_kwargs"]["remat"] = remat
        model = model_from_metadata(meta, device="cuda",
                                    generator=torch.Generator().manual_seed(SEED + 4))
        steps[remat] = train_step_launches(model, processor, x[:TRAIN_BATCH], y[:TRAIN_BATCH])
        del model
    (loss, grads, plain_launches, plain_peak), (r_loss, r_grads, launches, peak) = \
        steps[False], steps[True]
    diff = {n: float((r_grads[n] - g).abs().max()) for n, g in grads.items()}
    equal = r_loss == loss and not any(diff.values())
    log(f"remat: one step of batch {TRAIN_BATCH} from the same seeded weights: loss {r_loss:.8f} "
        f"vs {loss:.8f}, gradients equal to the bit: {equal} (max |diff| {max(diff.values())}); "
        f"launches {launches} vs {plain_launches}; peak device memory {peak:.0f} MiB vs "
        f"{plain_peak:.0f} MiB")
    if not equal:
        raise AssertionError(f"remat changed the step: loss {r_loss} vs {loss}, {diff}")
    want = {"mode_contraction": {"float32": 2 * n_layers, "bfloat16": 0},
            "mode_contraction_dx": {"float32": n_layers, "bfloat16": 0},
            "mode_contraction_dw": {"float32": n_layers, "bfloat16": 0}}
    if launches != want or plain_launches["mode_contraction"]["float32"] != n_layers:
        raise AssertionError(f"remat's step launched {launches} (plain {plain_launches})")
    meta["init_kwargs"]["remat"] = True
    graph = graphed_vs_loop(meta, processor, x, y)
    log(f"remat: {GRAPH_EPOCHS} graphed epochs vs the loop: loss rel {graph['loss_rel_err']:.2e}, "
        f"parameters rel_l2 max {graph['param_rel_l2_max']:.2e} (tol {GRAPH_TOL:.0e}); launches "
        f"per replay {graph['launches_per_replay']}; graphed step {graph['step_ms']:.2f} ms "
        f"(host clock, {GRAPH_PROFILE_STEPS} warm replays) beside the recipe's "
        f"{recipe_step_ms:.2f} ms")
    if graph["launches_per_replay"]["mode_contraction"]["float32"] != 2 * n_layers:
        raise AssertionError(f"remat's replay launches {graph['launches_per_replay']}")
    return {"launches_by_dtype": launches, "plain_launches_by_dtype": plain_launches,
            "peak_mib": peak, "plain_peak_mib": plain_peak, "graph": graph}


def stack_layers(state: dict, n_layers: int) -> dict:
    """An unrolled FNO's state_dict in the scanned layout, stacked in numpy."""
    stacked = {k: v for k, v in state.items() if not k.startswith("fno_blocks.")}
    for sub in ("conv", "fno_skip", "channel_mlp_skip", "channel_mlp"):
        keys = {k.split(".", 2)[2] for k in state if k.startswith(f"fno_blocks.{sub}_0.")}
        for key in keys:
            stacked[f"fno_blocks.layers.{sub}.{key}"] = torch.from_numpy(np.stack(
                [state[f"fno_blocks.{sub}_{i}.{key}"].cpu().numpy() for i in range(n_layers)]))
    return stacked


def scan_phase(processor, recipe_step_ms: float) -> dict:
    """(2) the published weights stacked into the scanned layout, the scanned
    recipe through train_navier_stokes with a resume, its saved weights
    rebuilt, and one scan+remat step card against CPU."""
    from neuraloperator_tpu_torch.data.transforms import load_data_processor
    from neuraloperator_tpu_torch.models import from_checkpoint, model_from_metadata
    from neuraloperator_tpu_torch.scripts import eval_ns_checkpoint as ev
    from neuraloperator_tpu_torch.training.training_state import load_training_state, read_manifest

    meta = flagship_meta()
    n_layers = meta["init_kwargs"]["n_layers"]
    model, _ = load_flagship_on("cuda")
    scan_meta = flagship_meta()
    scan_meta["init_kwargs"]["scan_layers"] = True
    scanned = model_from_metadata(scan_meta, device="meta").to_empty(device="cuda")
    scanned.load_state_dict(stack_layers(model.state_dict(), n_layers))
    xs, _ = ev.load_test_split(EVAL_RES, TRAIN_BATCH, device="cuda")
    x = processor.in_normalizer.transform(torch.from_numpy(xs).cuda())
    with torch.no_grad():
        fwd_err = rel_l2_t(scanned.eval()(x), model.eval()(x))
    log(f"scan: the published weights stacked into the scanned layout: forward of "
        f"{TRAIN_BATCH} test inputs vs the unrolled model rel_l2 {fwd_err:.3e} (tol 1e-6)")
    if not fwd_err <= 1e-6:
        raise AssertionError(f"the scanned forward departs from the unrolled one: {fwd_err}")
    del model, scanned

    steps_per_epoch = RECIPE_PAIRS // TRAIN_BATCH
    batches_per_eval = EVAL_PAIRS // EVAL_BATCH
    flags = [*RECIPE_FLAGS, "--model.scan_layers", "true"]
    save_dir = Path(tempfile.mkdtemp(prefix="scan-"))
    try:
        reset_launches()
        evals: list = []
        t0 = time.perf_counter()
        first = run_recipe_entry_point(
            [*flags, "--opt.n_epochs", "1", "--save_dir", str(save_dir)], evals)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        count_saved = saved_count(save_dir)
        del evals
        resumed_evals: list = []
        resumed = run_recipe_entry_point(
            [*flags, "--opt.n_epochs", "2", "--save_dir", str(save_dir), "--resume_from_dir",
             str(save_dir)], resumed_evals)
        torch.cuda.synchronize()
        launches, by_dtype = read_launches(), read_launches_by_dtype()
        trainer = resumed_evals[-1][0]
        log(f"scan: train_navier_stokes --model.scan_layers true, 1 epoch of {steps_per_epoch} "
            f"graphed steps in {first_s:.1f} s: {first}; resumed to epoch 2: {resumed}; saved "
            f"optimizer count {count_saved} -> {saved_count(save_dir)}; launches {launches}")
        if not (trainer.start_epoch == 1 and count_saved == steps_per_epoch
                and int(trainer.optimizer.count) == 2 * steps_per_epoch == saved_count(save_dir)
                and read_manifest(save_dir)["epoch"] == 1):
            raise AssertionError(f"the scanned run resumed at epoch {trainer.start_epoch} from "
                                 f"count {count_saved}")
        if not all(math.isfinite(v) for v in (*first.values(), *resumed.values())):
            raise AssertionError(f"non-finite scanned metrics {first}, {resumed}")
        only_dtype(by_dtype, "float32")
        n_steps, n_evals = 2 * steps_per_epoch, 2
        expected = {"mode_contraction": n_layers * (n_steps + n_evals * batches_per_eval),
                    "mode_contraction_dx": n_layers * n_steps,
                    "mode_contraction_dw": n_layers * n_steps}
        if launches != expected or trainer.staged_step.graph is None:
            raise AssertionError(f"the scanned run launched {launches}, expected {expected}")
        step_ms = replay_ms(trainer.staged_step, GRAPH_PROFILE_STEPS)
        log(f"scan: graphed step {step_ms:.2f} ms (host clock, {GRAPH_PROFILE_STEPS} warm "
            f"replays) beside the recipe's {recipe_step_ms:.2f} ms")
        del trainer, resumed_evals
        rebuilt = from_checkpoint(save_dir, "model", device="cuda")
        if not rebuilt.scan_layers:
            raise AssertionError("model_metadata.json did not rebuild a scanned model")
        rebuilt.load_state_dict(load_training_state(save_dir, "model", rebuilt.state_dict(),
                                                    device="cuda")[0])
        xs, ys = ev.load_test_split(EVAL_RES, EVAL_PAIRS, device="cuda")
        rescored = ev.evaluate(rebuilt.eval(), load_data_processor(save_dir), xs, ys,
                               EVAL_BATCH, device="cuda")
        reload_err = abs(rescored["rel_l2"] - resumed["128_l2"]) / resumed["128_l2"]
        log(f"scan: model.msgpack rebuilt by from_checkpoint scores {rescored} against the "
            f"run's 128_l2 {resumed['128_l2']:.6e}: relative difference {reload_err:.2e} "
            f"(tol {BEST_RELOAD_TOL:.0e})")
        if not reload_err <= BEST_RELOAD_TOL:
            raise AssertionError(f"the rebuilt scanned weights score {rescored}")
        del rebuilt
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    step_meta = flagship_meta()
    step_meta["init_kwargs"].update(scan_layers=True, remat=True)
    model = model_from_metadata(step_meta, device="cuda",
                                generator=torch.Generator().manual_seed(SEED + 2))
    in_std = float(processor.in_normalizer.std.ravel()[0])
    step = compare_step_with_cpu(model, step_meta, processor, *make_pairs(2, in_std, SEED + 3))
    return {"launches": launches, "launches_by_dtype": by_dtype, "forward_rel_l2": fwd_err,
            "first": first, "resumed": resumed, "graphed_step_ms": step_ms,
            "reload_rel_diff": reload_err, **step}


def remat_scan(processor, recipe_run: dict) -> dict:
    """(13) remat and scan_layers at full width; the scanned recipe's
    launches are the path's (remat's are counted per step)."""
    recipe_ms = recipe_run["step_ms"]["graphed"]
    remat = remat_phase(processor, recipe_ms)
    scan = scan_phase(processor, recipe_ms)
    by_dtype = {name: {dt: scan["launches_by_dtype"][name][dt]
                       + remat["launches_by_dtype"][name][dt] for dt in ("float32", "bfloat16")}
                for name in kernel_specs()}
    return {"launches": {name: sum(c.values()) for name, c in by_dtype.items()},
            "launches_by_dtype": by_dtype, "remat": remat, "scan": scan}


def tfno_meta() -> dict:
    """The flagship's architecture with the TFNO flags' spectral weights, as
    train_navier_stokes builds it from them."""
    meta = flagship_meta()
    meta["init_kwargs"].update(factorization="tucker", rank=0.1)
    return meta


def no_launches(launches: dict, label: str) -> None:
    if any(launches.values()):
        raise AssertionError(f"{label} launched {launches}: this path runs none of K1-K3")


def tfno_train(processor, recipe_step_ms: float, save_dir: Path) -> dict:
    """(1) train_navier_stokes with the TFNO flags, 2 graphed epochs and 1
    resumed; the saved weights rebuilt and rescored; the graphed step's
    time, idle share and peak memory; an evaluation forward at batch 16."""
    from neuraloperator_tpu_torch.data.transforms import load_data_processor
    from neuraloperator_tpu_torch.models import from_checkpoint
    from neuraloperator_tpu_torch.scripts import eval_ns_checkpoint as ev
    from neuraloperator_tpu_torch.training.training_state import load_training_state
    from neuraloperator_tpu_torch.utils import count_model_params

    steps_per_epoch = RECIPE_PAIRS // TRAIN_BATCH
    flags = [*RECIPE_FLAGS, *TFNO_FLAGS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    evals: list = []
    t0 = time.perf_counter()
    first = run_recipe_entry_point(
        [*flags, "--opt.n_epochs", str(TFNO_EPOCHS), "--save_dir", str(save_dir)], evals)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    count_saved = saved_count(save_dir)
    n_params = count_model_params(evals[-1][0].model)
    del evals
    resumed_evals: list = []
    t0 = time.perf_counter()
    resumed = run_recipe_entry_point(
        [*flags, "--opt.n_epochs", str(TFNO_EPOCHS + 1), "--save_dir", str(save_dir),
         "--resume_from_dir", str(save_dir)], resumed_evals)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    train_peak_mib = torch.cuda.max_memory_allocated() / 2**20
    launches = read_launches()
    trainer = resumed_evals[-1][0]
    step_ms = 1e3 * first["epoch_time"] / steps_per_epoch  # a warm epoch: captured before it
    log(f"tfno train: train_navier_stokes {' '.join(TFNO_FLAGS)}: {n_params} parameters; "
        f"{TFNO_EPOCHS} epochs x {steps_per_epoch} graphed steps in {first_s:.1f} s: {first}; "
        f"resumed to epoch {TFNO_EPOCHS + 1} in {resume_s:.1f} s: {resumed}; saved optimizer "
        f"count {count_saved} -> {saved_count(save_dir)}; launches {launches}; graphed TFNO "
        f"step {step_ms:.2f} ms (the first run's last epoch_time) vs the recipe's FNO "
        f"{recipe_step_ms:.2f} ms; peak device memory {train_peak_mib:.0f} MiB")
    if n_params != TFNO_PARAMS:
        raise AssertionError(f"the TFNO holds {n_params} parameters, not {TFNO_PARAMS}")
    if not all(math.isfinite(v) for v in (*first.values(), *resumed.values())):
        raise AssertionError(f"non-finite TFNO metrics {first}, {resumed}")
    if not (trainer.start_epoch == TFNO_EPOCHS and count_saved == TFNO_EPOCHS * steps_per_epoch
            and int(trainer.optimizer.count) == (TFNO_EPOCHS + 1) * steps_per_epoch
            == saved_count(save_dir)):
        raise AssertionError(f"the TFNO run resumed at epoch {trainer.start_epoch} from count "
                             f"{count_saved}")
    if trainer.staged_step.graph is None:
        raise AssertionError("the TFNO step was not captured as a CUDA graph")
    no_launches(launches, "the TFNO recipe")
    replay = replay_ms(trainer.staged_step, GRAPH_PROFILE_STEPS)
    staged = trainer.staged_step
    order = (torch.arange(GRAPH_PROFILE_STEPS * TRAIN_BATCH, device=staged.index.device)
             % len(staged.data["x"])).reshape(GRAPH_PROFILE_STEPS, TRAIN_BATCH)

    def replays():
        for i in range(GRAPH_PROFILE_STEPS):
            staged(order[i])

    profile = profile_window(f"{GRAPH_PROFILE_STEPS} graphed TFNO train steps of batch "
                             f"{TRAIN_BATCH}", replays)
    model = trainer.model.eval()
    del trainer, resumed_evals
    # an evaluation forward at batch 16, where the JAX plan builds its
    # 1.4G-element intermediate
    xs, ys = ev.load_test_split(EVAL_RES, EVAL_PAIRS, device="cuda")
    x16 = processor.in_normalizer.transform(torch.from_numpy(xs[:EVAL_BATCH]).cuda())
    with torch.no_grad():
        model(x16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mib = torch.cuda.memory_allocated() / 2**20
        t0 = time.perf_counter()
        for _ in range(10):
            model(x16)
        torch.cuda.synchronize()
    eval_ms = 1e3 * (time.perf_counter() - t0) / 10
    eval_peak_mib = torch.cuda.max_memory_allocated() / 2**20
    log(f"tfno train: graphed step {replay:.2f} ms (host clock, {GRAPH_PROFILE_STEPS} warm "
        f"replays); evaluation forward at batch {EVAL_BATCH}: {eval_ms:.2f} ms, peak device "
        f"memory {eval_peak_mib:.0f} MiB ({eval_peak_mib - base_mib:.0f} MiB above the "
        f"{base_mib:.0f} MiB held before it)")
    del model
    rebuilt = from_checkpoint(save_dir, "model", device="cuda")
    rebuilt.load_state_dict(load_training_state(save_dir, "model", rebuilt.state_dict(),
                                                device="cuda")[0])
    rescored = ev.evaluate(rebuilt.eval(), load_data_processor(save_dir), xs, ys, EVAL_BATCH,
                           device="cuda")
    reload_err = abs(rescored["rel_l2"] - resumed["128_l2"]) / resumed["128_l2"]
    log(f"tfno train: model.msgpack rebuilt by from_checkpoint scores {rescored} against the "
        f"run's 128_l2 {resumed['128_l2']:.6e}: relative difference {reload_err:.2e} (tol "
        f"{BEST_RELOAD_TOL:.0e})")
    if not (rebuilt.fno_blocks.conv_0.spec.kind == "tucker" and reload_err <= BEST_RELOAD_TOL):
        raise AssertionError(f"the rebuilt TFNO scores {rescored}")
    return {"first": first, "resumed": resumed, "first_s": first_s, "resume_s": resume_s,
            "graphed_step_ms": step_ms, "replay_ms": replay, "recipe_step_ms": recipe_step_ms,
            "train_peak_mib": train_peak_mib, "graphed_profile": profile,
            "eval16_ms": eval_ms, "eval16_peak_mib": eval_peak_mib,
            "eval16_base_mib": base_mib, "reload_rel_diff": reload_err, "n_params": n_params}


def tfno_against_cpu_and_reconstructed(processor, save_dir: Path) -> dict:
    """(2) one step of batch 2 and a batch-3 forward from seeded weights,
    card against CPU; (3) the trained weights contracted "reconstructed"
    against "factorized": 16 test pairs' forward, one train step's
    gradients, and the launches of each."""
    from neuraloperator_tpu_torch.models import model_from_metadata
    from neuraloperator_tpu_torch.scripts import eval_ns_checkpoint as ev
    from neuraloperator_tpu_torch.training.training_state import load_training_state

    n_layers = flagship_meta()["init_kwargs"]["n_layers"]
    meta = tfno_meta()
    in_std = float(processor.in_normalizer.std.ravel()[0])
    seeded = model_from_metadata(meta, device="cuda",
                                 generator=torch.Generator().manual_seed(SEED + 2))
    x3 = torch.from_numpy(make_pairs(3, in_std, SEED + 6)[0])
    with torch.no_grad():
        fwd_err = rel_l2_t(seeded.eval()(x3.cuda()), cpu_copy(seeded, meta).eval()(x3))
    log(f"tfno: batch-3 forward of the seeded TFNO, card vs CPU: rel_l2 {fwd_err:.3e} (tol "
        f"{TFNO_FORWARD_TOL:.0e})")
    if not fwd_err <= TFNO_FORWARD_TOL:
        raise AssertionError(f"the TFNO forward on the card departs from the CPU: {fwd_err}")
    reset_launches()
    step = compare_step_with_cpu(seeded.train(), meta, processor,
                                 *make_pairs(2, in_std, SEED + 3))
    no_launches(read_launches(), "the factorized TFNO step")
    del seeded

    models = {}
    for impl in ("factorized", "reconstructed"):
        impl_meta = tfno_meta()
        impl_meta["init_kwargs"]["implementation"] = impl
        model = model_from_metadata(impl_meta, device="meta").to_empty(device="cuda")
        model.load_state_dict(load_training_state(save_dir, "model", model.state_dict(),
                                                  device="cuda")[0])
        models[impl] = model.eval()
    xs, ys = ev.load_test_split(EVAL_RES, TFNO_IMPL_PAIRS, device="cuda")
    x = processor.in_normalizer.transform(torch.from_numpy(xs).cuda())
    outs, fwd_launches = {}, {}
    for impl, model in models.items():
        reset_launches()
        with torch.no_grad():
            outs[impl] = model(x)
        torch.cuda.synchronize()
        fwd_launches[impl] = read_launches()
    impl_err = rel_l2_t(outs["reconstructed"], outs["factorized"])
    steps, step_launches = {}, {}
    for impl, model in models.items():
        reset_launches()
        steps[impl] = one_step(model.train(), processor, xs[:TRAIN_BATCH], ys[:TRAIN_BATCH],
                               "cuda")
        torch.cuda.synchronize()
        step_launches[impl] = read_launches_by_dtype()
    names = sorted(steps["factorized"][1])
    grad_err = {n: rel_l2_t(steps["reconstructed"][1][n], steps["factorized"][1][n])
                for n in names}
    worst = max(grad_err, key=grad_err.get)
    log(f"tfno: trained weights contracted reconstructed vs factorized: forward of "
        f"{TFNO_IMPL_PAIRS} test pairs rel_l2 {impl_err:.3e} (tol {TFNO_IMPL_TOL:.0e}); "
        f"launches per forward {fwd_launches}; one step of batch {TRAIN_BATCH}: loss "
        f"{steps['reconstructed'][0]:.7f} vs {steps['factorized'][0]:.7f}, gradients rel_l2 max "
        f"{grad_err[worst]:.2e} ({worst}, tol {TFNO_IMPL_GRAD_TOL:.0e}); launches {step_launches}")
    if not impl_err <= TFNO_IMPL_TOL:
        raise AssertionError(f"reconstructed and factorized forwards differ: {impl_err}")
    no_launches(fwd_launches["factorized"], "the factorized forward")
    no_launches({k: sum(v.values()) for k, v in step_launches["factorized"].items()},
                "the factorized step")
    if fwd_launches["reconstructed"] != {"mode_contraction": n_layers, "mode_contraction_dx": 0,
                                         "mode_contraction_dw": 0}:
        raise AssertionError(f"the reconstructed forward launched {fwd_launches}")
    only_dtype(step_launches["reconstructed"], "float32")
    if {k: v["float32"] for k, v in step_launches["reconstructed"].items()} != \
            {"mode_contraction": n_layers, "mode_contraction_dx": n_layers,
             "mode_contraction_dw": n_layers}:
        raise AssertionError(f"the reconstructed step launched {step_launches}")
    misses = {k: v for k, v in grad_err.items() if not v <= TFNO_IMPL_GRAD_TOL}
    if misses:
        raise AssertionError(f"reconstructed and factorized gradients differ: {misses}")
    by_dtype = {name: {dt: c + (fwd_launches["reconstructed"][name] if dt == "float32" else 0)
                       for dt, c in counts.items()}
                for name, counts in step_launches["reconstructed"].items()}
    return {"forward_card_vs_cpu": fwd_err, **step, "impl_forward_rel_l2": impl_err,
            "impl_grad_rel_l2_max": grad_err[worst], "impl_grad_worst": worst,
            "forward_launches": fwd_launches, "step_launches": step_launches,
            "launches_by_dtype": by_dtype}


def tfno_serve_export(processor, save_dir: Path) -> dict:
    """(4) serve_model on the saved TFNO; (5) export_forward of it, answered
    by the fresh python3 process of phase 12 (FRESH)."""
    from neuraloperator_tpu_torch.models import from_checkpoint
    from neuraloperator_tpu_torch.scripts import serve_model
    from neuraloperator_tpu_torch.serving import CompiledForward, export_forward
    from neuraloperator_tpu_torch.training.training_state import load_training_state

    t0 = time.perf_counter()
    reset_launches()
    served = serve_model.main(["--ckpt_dir", str(save_dir), "--name", "model", "--shape",
                               "[1,128,128]", "--buckets", str(list(BUCKETS)).replace(" ", ""),
                               "--probe_iters", "20", "--device", "cuda"])
    serve_s = time.perf_counter() - t0
    no_launches(read_launches(), "serve_model on the TFNO")
    log(f"tfno serve: serve_model in {serve_s:.1f} s: latency ms per bucket "
        f"{served['latency_ms']}, resident weights {served['weight_bytes'] / 1e6:.1f} MB; "
        f"ragged request {served['ragged']}")
    if not (served["ragged"]["finite"] and served["weight_bytes"] == 4 * TFNO_PARAMS):
        raise AssertionError(f"serve_model on the TFNO: {served}")

    model = from_checkpoint(save_dir, "model", device="cuda")
    model.load_state_dict(load_training_state(save_dir, "model", model.state_dict(),
                                              device="cuda")[0])
    fns = dict(preprocess_fn=processor.in_normalizer.transform,
               postprocess_fn=processor.out_normalizer.inverse_transform)
    example = torch.zeros(1, 1, 128, 128)
    work = Path(tempfile.mkdtemp(prefix="tfno-export-"))
    try:
        artifact = work / "tfno.pt2"
        t0 = time.perf_counter()
        blob = export_forward(model, example, path=artifact, **fns)
        export_s = time.perf_counter() - t0
        graph = torch.export.load(str(artifact)).graph
        targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
        ops = targets.count("neuraloperator_tpu_torch.mode_contraction.default")
        einsum_like = sum(1 for t in targets if "einsum" in t or "bmm" in t)
        eager = CompiledForward(model, example, batch_sizes=EXPORT_BATCHES, device="cuda", **fns)
        gen = torch.Generator().manual_seed(SEED + 21)
        in_std = float(processor.in_normalizer.std.ravel()[0])
        inputs = [in_std * torch.randn(n, 1, 128, 128, generator=gen) for n in EXPORT_BATCHES]
        want = [eager(x).cpu() for x in inputs]
        ((answers, report),), process, wall_s = FRESH.answer([(artifact, inputs)], work)
        errs = [rel_l2_t(a, w) for a, w in zip(answers, want)]
        log(f"tfno export: export_forward (symbolic batch) {len(blob) / 1e6:.1f} MB in "
            f"{export_s:.2f} s; graph holds {ops} contraction operators and {einsum_like} "
            f"einsum/bmm nodes; the fresh process of phase 12 (TF32 on: "
            f"{process['allow_tf32']}; {wall_s:.1f} s for the call) loaded it in "
            f"{report['load_s']:.2f} s and answered batches {EXPORT_BATCHES}: rel_l2 vs eager "
            f"{errs} (tol {EXPORT_TOL:.0e}); launches {report['launches']}")
        if not (ops == 0 and process["allow_tf32"] and max(errs) <= EXPORT_TOL):
            raise AssertionError(f"the TFNO artifact departs from eager: {ops} operators, {errs}")
        no_launches({n: sum(c.values()) for n, c in report["launches"].items()},
                    "the TFNO artifact")
        return {"latency_ms": served["latency_ms"], "weight_bytes": served["weight_bytes"],
                "serve_s": serve_s, "export_mb": len(blob) / 1e6, "export_s": export_s,
                "load_s": report["load_s"], "process_s": wall_s, "rel_l2_vs_eager": errs}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def tfno_mixed(tfno_step_ms: float) -> dict:
    """(6) one graphed epoch of the TFNO under the mixed flags."""
    steps_per_epoch = RECIPE_PAIRS // TRAIN_BATCH
    flags = [*RECIPE_FLAGS, *TFNO_FLAGS]
    for flag, value in MIXED_FLAGS.items():
        if flag in flags:
            flags[flags.index(flag) + 1] = value
        else:
            flags += [flag, value]
    save_dir = Path(tempfile.mkdtemp(prefix="tfno-mixed-"))
    try:
        reset_launches()
        evals: list = []
        t0 = time.perf_counter()
        final = run_recipe_entry_point([*flags, "--opt.n_epochs", "1", "--save_dir",
                                        str(save_dir)], evals)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        trainer = evals[-1][0]
        step_ms = replay_ms(trainer.staged_step, GRAPH_PROFILE_STEPS)
        w_dtype = trainer.model.fno_blocks.conv_0.w_core.dtype
        log(f"tfno mixed: 1 graphed epoch of {steps_per_epoch} steps with "
            f"{' '.join(f'{k} {v}' for k, v in MIXED_FLAGS.items())} in {run_s:.1f} s: {final}; "
            f"core stored {w_dtype}; graphed mixed TFNO step {step_ms:.2f} ms (host clock, "
            f"{GRAPH_PROFILE_STEPS} warm replays) vs the f32 TFNO's {tfno_step_ms:.2f} ms")
        if not all(math.isfinite(v) for v in final.values()):
            raise AssertionError(f"non-finite mixed TFNO metrics {final}")
        if trainer.staged_step.graph is None or w_dtype != torch.bfloat16:
            raise AssertionError("the mixed TFNO step was not graphed over bf16 factors")
        no_launches(read_launches(), "the mixed TFNO run")
        return {"final": final, "run_s": run_s, "graphed_step_ms": step_ms}
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)


def plan_macs(eq: str, shapes) -> int:
    """Complex multiply-adds of the complex einsum's plan for ``eq`` at ``shapes``."""
    from neuraloperator_tpu_torch.ops import complex_einsum as ce

    dims = {}
    for sub, shape in zip(eq.split("->")[0].split(","), shapes):
        dims.update(zip(sub, shape))
    return sum(math.prod(dims[c] for c in set(pair.split("->")[0].replace(",", "")))
               for _, pairs in ce.plan(eq, tuple(shapes)) for pair in pairs if "," in pair)


def graphed(fn) -> torch.cuda.CUDAGraph:
    """``fn`` captured as a CUDA graph, after two warm-up calls on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def tucker_contraction_times() -> dict:
    """Device ms of one flagship TFNO layer's mode contraction, seeded
    factors, at batches 8 (the step) and 16 (the evaluation): the Tucker
    einsum chain ("factorized") and the weight rebuilt then contracted by
    K1 ("reconstructed"), forward alone and forward with backward; beside
    the chain's complex MACs (from its plan) and their time at the f32 peak.
    The operands (at most 17 MB) stay in L2, as a layer's may. Each call
    is timed as a CUDA graph replay, as the graphed step runs it: launched
    one by one, the chain's some 60 kernels per forward fill the launch
    queue behind ``device_ms``'s device-side wait."""
    from neuraloperator_tpu_torch._timing import device_ms
    from neuraloperator_tpu_torch.layers import SpectralConv
    from neuraloperator_tpu_torch.ops.contractions import contract_block

    conv = SpectralConv(CHANNELS, CHANNELS, (64, 64), factorization="tucker", rank=0.1,
                        device="cuda", generator=torch.Generator().manual_seed(SEED + 7))
    spec = conv.spec
    i, o, *modes = spec.shape
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    out = {}
    for batch in (TRAIN_BATCH, EVAL_BATCH):
        x = tuple(torch.randn(batch, i, *modes, generator=gen, device="cuda") for _ in range(2))
        g = tuple(torch.randn(batch, o, *modes, generator=gen, device="cuda") for _ in range(2))
        for impl in ("factorized", "reconstructed"):
            # the factors are read inside each call: a view taken outside
            # would run its backward on the stream it was taken on
            def fwd(impl=impl):
                with torch.no_grad():
                    contract_block(x, spec, conv.factors(), implementation=impl)

            def fwd_bwd(impl=impl):
                torch.autograd.backward(
                    contract_block(x, spec, conv.factors(), implementation=impl), g)

            out[f"{impl} B={batch}"] = {
                "fwd_ms": device_ms(graphed(fwd).replay, [()], iters=20)[0],
                "fwd_bwd_ms": device_ms(graphed(fwd_bwd).replay, [()], iters=20)[0]}
        # contract_tucker's equation for a 2-D layer; three real products per
        # complex MAC (Karatsuba), two flops each
        macs = plan_macs("abcd,fghi,bf,eg,ch,di->aecd",
                         [(batch, i, *modes), spec.ranks, *zip(spec.shape, spec.ranks)])
        out[f"factorized B={batch}"].update(
            complex_macs=macs, peak_ms=6 * macs / PEAK_FLOPS[torch.float32] * 1e3)
    log(f"tfno: one layer's contraction at the flagship's shapes, device ms: "
        f"{ {k: {n: round(v, 4) for n, v in d.items()} for k, d in out.items()} }")
    return out


def tfno(processor, recipe_run: dict) -> dict:
    """(14) the Tucker TFNO at the flagship's width through the train, serve
    and export entry points; its kernel launches are the reconstructed
    path's (the factorized path launches none, which each part checks)."""
    save_dir = Path(tempfile.mkdtemp(prefix="tfno-"))
    try:
        trained = tfno_train(processor, recipe_run["step_ms"]["graphed"], save_dir)
        checks = tfno_against_cpu_and_reconstructed(processor, save_dir)
        served = tfno_serve_export(processor, save_dir)
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    mixed_run = tfno_mixed(trained["replay_ms"])
    contraction = tucker_contraction_times()
    by_dtype = {name: {"float32": 0, "bfloat16": 0, **checks["launches_by_dtype"][name]}
                for name in kernel_specs()}
    return {"launches": {name: sum(c.values()) for name, c in by_dtype.items()},
            "launches_by_dtype": by_dtype, "train": trained, "checks": checks,
            "serve_export": served, "mixed": mixed_run, "contraction": contraction}


def grad_errors(card: dict, cpu: dict) -> dict:
    """Per-leaf relative l2 of card gradients against CPU ones, each against
    the larger of the leaf's norm and 1% of the whole gradient's."""
    total = sum(float(g.double().square().sum()) for g in cpu.values()) ** 0.5
    return {name: float((card[name].double() - ref.double()).norm())
            / max(float(ref.double().norm()), 1e-2 * total) for name, ref in cpu.items()}


def darcy_model(device: str, **kwargs):
    """The Darcy recipe's FNO (config.DarcyConfig's model section) with
    ``kwargs`` on top, seeded weights."""
    from neuraloperator_tpu_torch.config import DarcyConfig
    from neuraloperator_tpu_torch.models import get_model

    config = DarcyConfig().to_dict()
    config["model"].update(kwargs)
    return get_model(config, device=device, generator=torch.Generator().manual_seed(SEED + 20))


def darcy() -> dict:
    """(15) the Darcy recipe through the port's scripts.train_darcy on the card."""
    import re

    from neuraloperator_tpu_torch.config import DarcyConfig
    from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
    from neuraloperator_tpu_torch.data.datasets import darcy as tdarcy
    from neuraloperator_tpu_torch.losses import H1Loss
    from neuraloperator_tpu_torch.scripts import train_darcy
    from neuraloperator_tpu_torch.training import Trainer, build_optimizer

    cfg = DarcyConfig()
    n_layers = cfg.model.n_layers
    t0 = time.perf_counter()
    train_loader, test_loaders, processor = tdarcy.load_darcy_flow_small(
        n_train=cfg.data.n_train, n_tests=cfg.data.n_tests,
        batch_size=cfg.data.batch_size, test_batch_sizes=cfg.data.test_batch_sizes,
        test_resolutions=cfg.data.test_resolutions)
    read_s = time.perf_counter() - t0
    steps = len(train_loader)
    evals_per_epoch = sum(len(loader) for loader in test_loaders.values())
    log(f"darcy: {len(train_loader.dataset)} training pairs at 16², tests "
        f"{ {r: len(l.dataset) for r, l in test_loaders.items()} } read by "
        f"load_darcy_flow_small in {read_s:.1f} s from {tdarcy.DATA_ROOT.name} (darcy_files)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    record: list = []
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        metrics = run_recipe_entry_point(["--opt.n_epochs", str(DARCY_EPOCHS)], record,
                                         script=train_darcy)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches, by_dtype = read_launches(), read_launches_by_dtype()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    only_dtype(by_dtype, "float32")
    train_errs = [float(v) for v in re.findall(r"train=([0-9.eE+-]+)", tee.text())]
    n_params = int(re.findall(r"^model parameters: (\d+)$", tee.text(), re.M)[-1])
    log(f"darcy: {DARCY_EPOCHS} epochs of {steps} steps in {train_s:.1f} s; train losses "
        f"{train_errs}; final {metrics}; {n_params} parameters; launches {launches}; peak "
        f"{peak_mib:.0f} MiB")
    bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
    if bad or len(train_errs) != DARCY_EPOCHS or not all(map(math.isfinite, train_errs)):
        raise AssertionError(f"darcy: non-finite metrics {bad} or train losses {train_errs}")
    if not train_errs[-1] < train_errs[0]:
        raise AssertionError(f"darcy: the training loss did not fall: {train_errs}")
    misses = {k: (metrics[k], b) for k, b in DARCY_BOUNDS.items() if not metrics[k] <= b}
    if misses:
        raise AssertionError(f"darcy: evaluations above their bounds {misses}")
    expected = {"mode_contraction": n_layers * DARCY_EPOCHS * (steps + evals_per_epoch),
                "mode_contraction_dx": n_layers * DARCY_EPOCHS * steps,
                "mode_contraction_dw": n_layers * DARCY_EPOCHS * steps}
    if launches != expected or len(record) != DARCY_EPOCHS:
        raise AssertionError(f"darcy: launched {launches} over {len(record)} evaluations, "
                             f"expected {expected}")
    # the Trainer's epoch_time of the last epoch: warm loop steps, ended by
    # the float() of the summed loss, which waits for the device
    step_ms = 1e3 * metrics["epoch_time"] / steps
    model = record[-1][0].model
    arrays = train_loader.dataset.arrays
    n_prof = DARCY_PROFILE_STEPS * cfg.data.batch_size
    loader = DataLoader(TensorDataset(arrays["x"][:n_prof], arrays["y"][:n_prof]),
                        cfg.data.batch_size)
    h1 = H1Loss(d=2)

    def loop_steps():
        trainer = Trainer(model=model, n_epochs=1, data_processor=processor, device="cuda")
        trainer.train(loader, {}, build_optimizer(cfg.opt, len(loader)), training_loss=h1)

    loop_steps()  # warm
    profile = profile_window(f"{DARCY_PROFILE_STEPS} darcy loop steps of batch "
                             f"{cfg.data.batch_size}", loop_steps)

    # one step of batch 2, card against CPU from the same weights
    cpu_model = darcy_model("cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x2, y2 = arrays["x"][:2], arrays["y"][:2]
    loss_gpu, grads_gpu = one_step(model, processor, x2, y2, "cuda")
    loss_cpu, grads_cpu = one_step(cpu_model, processor, x2, y2, "cpu")
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    grad_err = grad_errors(grads_gpu, grads_cpu)
    worst = max(grad_err, key=grad_err.get)
    log(f"darcy: {step_ms:.3f} ms per loop step of batch {cfg.data.batch_size} (last "
        f"epoch); one step of batch 2, card vs CPU: loss rel {loss_err:.2e} (tol "
        f"{STEP_LOSS_TOL:.0e}), gradients max {grad_err[worst]:.2e} ({worst}, tol "
        f"{STEP_GRAD_TOL:.0e})")
    if not loss_err <= STEP_LOSS_TOL or not grad_err[worst] <= STEP_GRAD_TOL:
        raise AssertionError(f"darcy: card and CPU steps differ: loss {loss_err}, "
                             f"gradients {grad_err}")
    return {"launches": launches, "launches_by_dtype": by_dtype, "metrics": metrics,
            "train_errs": train_errs, "n_params": n_params, "read_s": read_s,
            "train_s": train_s, "step_ms": step_ms, "peak_mib": peak_mib, "profile": profile,
            "steps_per_epoch": steps, "evals_per_epoch": evals_per_epoch,
            "step_loss_rel_err": loss_err, "step_grad_rel_l2_max": grad_err[worst]}


def option_against_cpu(name: str, kwargs: dict, call: dict, blocks: bool = False) -> dict:
    """One layer option at the Darcy width, card against CPU: the forward,
    one step's H1 gradients, and the launches of the card's step."""
    from neuraloperator_tpu_torch.layers import FNOBlocks
    from neuraloperator_tpu_torch.losses import H1Loss

    from neuraloperator_tpu_torch.config import DarcyConfig

    width, n_layers = DARCY_CHANNELS, DarcyConfig().model.n_layers
    gen = torch.Generator().manual_seed(SEED + 21)
    if blocks:  # AdaIN's embedding is an argument of the blocks, not of the FNO
        def build(device):
            return FNOBlocks(width, width, (16, 16), n_layers=n_layers, device=device,
                             generator=torch.Generator().manual_seed(SEED + 22), **kwargs)

        x = torch.randn(TRAIN_BATCH, width, 16, 16, generator=gen)
        emb = torch.randn(kwargs["ada_in_features"], generator=gen)
    else:
        def build(device):
            return darcy_model(device, **kwargs)

        x = torch.randn(TRAIN_BATCH, 1, 16, 16, generator=gen)
        if kwargs.get("complex_data"):
            x = torch.complex(x, torch.randn(TRAIN_BATCH, 1, 16, 16, generator=gen))
    model = build("cuda")
    cpu_model = build("meta").to_empty(device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    for (_, b), (_, cb) in zip(model.named_buffers(), cpu_model.named_buffers()):
        cb.copy_(b.cpu())
    h1 = H1Loss(d=2)
    outs, grads, target = [], [], None
    for m, device in ((model, "cuda"), (cpu_model, "cpu")):
        if device == "cuda":
            torch.cuda.synchronize()
            reset_launches()
        if blocks:
            out = x.to(device)
            for i in range(n_layers):
                out = m(out, i, ada_in_embedding=emb.to(device))
        else:
            out = m(x.to(device), **call)
        flat = torch.cat([out.real, out.imag], dim=1) if out.is_complex() else out
        if target is None:
            target = 1.0 + torch.randn(flat.shape, generator=gen)
        h1(flat, target.to(device)).backward()
        if device == "cuda":
            torch.cuda.synchronize()
            launches, by_dtype = read_launches(), read_launches_by_dtype()
        outs.append(out.detach().cpu().to(torch.complex128))
        grads.append({n: p.grad.detach().cpu() for n, p in m.named_parameters()})
    fwd_err = float((outs[0] - outs[1]).norm() / outs[1].norm())
    grad_err = grad_errors(grads[0], grads[1])
    worst = max(grad_err, key=grad_err.get)
    stats_err = max([float((b.cpu() - cb).norm() / cb.norm()) for (_, b), (_, cb)
                     in zip(model.named_buffers(), cpu_model.named_buffers())] or [0.0])
    # the blocks' input is the data: the first layer's K2 has no gradient to make
    expected = {"mode_contraction": n_layers,
                "mode_contraction_dx": n_layers - 1 if blocks else n_layers,
                "mode_contraction_dw": n_layers}
    log(f"options: {name}: output {tuple(outs[0].shape)}, forward rel_l2 {fwd_err:.2e}, "
        f"gradients max {grad_err[worst]:.2e} ({worst}), running statistics "
        f"{stats_err:.2e}; launches {launches}")
    if not (fwd_err <= OPTION_FORWARD_TOL and grad_err[worst] <= OPTION_GRAD_TOL
            and stats_err <= OPTION_FORWARD_TOL):
        raise AssertionError(f"options: {name}: card and CPU differ: forward {fwd_err}, "
                             f"gradients {grad_err}, statistics {stats_err}")
    if launches != expected:
        raise AssertionError(f"options: {name}: launched {launches}, expected {expected}")
    return {"forward_rel_l2": fwd_err, "grad_rel_l2_max": grad_err[worst],
            "stats_rel_l2": stats_err, "launches": launches, "launches_by_dtype": by_dtype,
            "shape": list(outs[0].shape)}


def fft_path_at_flagship_width() -> dict:
    """The published weights forward on a last axis over 512 points: card
    against CPU, K1 once per layer, and the rFFT and irFFT in the profile."""
    from torch.profiler import ProfilerActivity, profile

    model, _ = load_flagship_on("cuda")
    cpu_model, _ = load_flagship_on("cpu")
    n_layers = flagship_meta()["init_kwargs"]["n_layers"]
    x = torch.randn(*FFT_SHAPE, generator=torch.Generator().manual_seed(SEED + 23))
    with torch.no_grad():
        model(x.cuda())  # warm: cuFFT plans, DFT matrices
        torch.cuda.synchronize()
        reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = model(x.cuda())
            torch.cuda.synchronize()
            forward_ms = 1e3 * (time.perf_counter() - t0)
        launches, by_dtype = read_launches(), read_launches_by_dtype()
        want = cpu_model(x)
    err = rel_l2_t(out.cpu(), want)
    ops = {e.key: e for e in prof.key_averages()}
    fft_ops = {k: round(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
                        / 1e3, 4) for k, e in ops.items() if "fft" in k.lower()}
    fft_kernels = sorted({e.name for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and "fft" in e.name.lower()})
    log(f"options: FFT path at the flagship's width, input {FFT_SHAPE}: card vs CPU rel_l2 "
        f"{err:.2e} (tol {SERVE_TOL:.0e}); forward {forward_ms:.2f} ms (host clock, "
        f"profiled); launches {launches}; FFT ops (device ms) {fft_ops}; kernels "
        f"{[k[:60] for k in fft_kernels[:6]]}")
    if not err <= SERVE_TOL:
        raise AssertionError(f"the FFT path differs from the CPU: rel_l2 {err}")
    if launches != {"mode_contraction": n_layers, "mode_contraction_dx": 0,
                    "mode_contraction_dw": 0}:
        raise AssertionError(f"the FFT path launched {launches}")
    if not any("r2c" in k for k in fft_ops) or not any("c2r" in k for k in fft_ops):
        raise AssertionError(f"no rFFT and irFFT in the profile: {sorted(ops)}")
    return {"rel_l2": err, "forward_ms": forward_ms, "launches": launches,
            "launches_by_dtype": by_dtype, "fft_ops_ms": fft_ops, "fft_kernels": fft_kernels}


def layer_options() -> dict:
    """(16) each new layer option at the Darcy width, card against CPU, and
    the FFT path at the flagship's width."""
    cases = {name: option_against_cpu(name, kwargs, call)
             for name, (kwargs, call) in OPTION_CASES.items()}
    cases["ada_in"] = option_against_cpu("ada_in", {"norm": "ada_in", "ada_in_features": 8},
                                         {}, blocks=True)
    fft = fft_path_at_flagship_width()
    launches, by_dtype = sum_launches([*cases.values(), fft])
    only_dtype(by_dtype, "float32")
    return {"launches": launches, "launches_by_dtype": by_dtype, "cases": cases,
            "fft_path": fft}


@contextlib.contextmanager
def darcy_files():
    """The Darcy recipe's files, made on the host by the port's
    ``load_darcy_flow_small`` into a temporary ``DATA_ROOT`` (1000 training
    pairs at 16², 100 test pairs at 16² and 32²); yields the seconds it took."""
    from neuraloperator_tpu_torch.data.datasets import darcy as tdarcy

    data_dir = Path(tempfile.mkdtemp(prefix="darcy-files-"))
    default_root, tdarcy.DATA_ROOT = tdarcy.DATA_ROOT, data_dir
    try:
        t0 = time.perf_counter()
        tdarcy.load_darcy_flow_small(n_train=1000, n_tests=[100, 50], batch_size=8,
                                     test_batch_sizes=[16, 16], test_resolutions=[16, 32])
        gen_s = time.perf_counter() - t0
        log(f"darcy files: generated on the host in {gen_s:.1f} s into {data_dir.name}")
        yield gen_s
    finally:
        tdarcy.DATA_ROOT = default_root
        shutil.rmtree(data_dir, ignore_errors=True)


def family_run(family: str) -> dict:
    """One family through ``scripts.train_family_quality`` on the card."""
    import re

    from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
    from neuraloperator_tpu_torch.data.datasets import darcy as tdarcy
    from neuraloperator_tpu_torch.losses import H1Loss
    from neuraloperator_tpu_torch.scripts import train_family_quality as tfq
    from neuraloperator_tpu_torch.training import Trainer, adamw

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    record: list = []
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        metrics = run_recipe_entry_point(["--family", family, "--n_epochs", str(FAMILY_EPOCHS),
                                          "--n_train", str(FAMILY_N_TRAIN[family])],
                                         record, script=tfq)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches, by_dtype = read_launches(), read_launches_by_dtype()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    only_dtype(by_dtype, "float32")
    trainer = record[-1][0]
    model, processor = trainer.model, trainer.data_processor
    line = json.loads([ln for ln in tee.text().splitlines() if ln.startswith("{")][-1])
    train_errs = [float(v) for v in re.findall(r"train=([0-9.eE+-]+)", tee.text())]
    log(f"families: {family}: {FAMILY_EPOCHS} epochs in {train_s:.1f} s; train losses "
        f"{train_errs}; final {metrics}; {line['n_params']} parameters; launches {launches}; "
        f"peak {peak_mib:.0f} MiB")
    if line["n_params"] != FAMILY_PARAMS[family]:
        raise AssertionError(f"families: {family} has {line['n_params']} parameters, "
                             f"expected {FAMILY_PARAMS[family]}")
    bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
    if bad or len(train_errs) != FAMILY_EPOCHS or not all(map(math.isfinite, train_errs)):
        raise AssertionError(f"families: {family}: non-finite metrics {bad} or train losses "
                             f"{train_errs}")
    if not train_errs[-1] < train_errs[0]:
        raise AssertionError(f"families: {family}: the training loss did not fall: {train_errs}")
    misses = {k: (metrics[k], b) for k, b in FAMILY_BOUNDS[family].items()
              if not metrics[k] <= b}
    if misses:
        raise AssertionError(f"families: {family}: evaluations above their bounds {misses}")
    # the script's loader: steps of 8 (50 an epoch on 400 pairs); each
    # epoch evaluated on 100 + 50 test pairs in batches of 16
    steps, evals = FAMILY_N_TRAIN[family] // 8, math.ceil(100 / 16) + math.ceil(50 / 16)
    layers = FAMILY_SPECTRAL_LAYERS[family]
    expected = {"mode_contraction": layers * FAMILY_EPOCHS * (steps + evals),
                "mode_contraction_dx": layers * FAMILY_EPOCHS * steps,
                "mode_contraction_dw": layers * FAMILY_EPOCHS * steps}
    if launches != expected or len(record) != FAMILY_EPOCHS:
        raise AssertionError(f"families: {family}: launched {launches} over {len(record)} "
                             f"evaluations, expected {expected}")
    # the last epoch's loop steps, ended by the float() of the summed loss
    step_ms = 1e3 * metrics["epoch_time"] / steps
    train_loader, _, _ = tdarcy.load_darcy_flow_small(
        n_train=1000, n_tests=[100, 50], batch_size=8, test_batch_sizes=[16, 16],
        test_resolutions=[16, 32], encode_input=family == "codano")
    arrays = train_loader.dataset.arrays
    n_prof = FAMILY_PROFILE_STEPS * 8
    loader = DataLoader(TensorDataset(arrays["x"][:n_prof], arrays["y"][:n_prof]), 8)
    lr = 1e-3 if family == "codano" else 3e-3

    def loop_steps():
        t = Trainer(model=model, n_epochs=1, data_processor=processor, device="cuda")
        t.train(loader, {}, adamw(lr, weight_decay=1e-4), training_loss=H1Loss(d=2))

    # warm from the run: the same steps' shapes, plans and caches
    profile = profile_window(f"{FAMILY_PROFILE_STEPS} {family} loop steps of batch 8",
                             loop_steps)

    # one step of batch 2, card against CPU from the same weights
    cpu_model = tfq.build_model(family, 16, device="meta").to_empty(device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x2, y2 = arrays["x"][:2], arrays["y"][:2]
    loss_gpu, grads_gpu = one_step(model, processor, x2, y2, "cuda")
    loss_cpu, grads_cpu = one_step(cpu_model, processor, x2, y2, "cpu")
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    grad_err = grad_errors(grads_gpu, grads_cpu)
    worst = max(grad_err, key=grad_err.get)
    log(f"families: {family}: {step_ms:.3f} ms per loop step of batch 8 (last epoch); one "
        f"step of batch 2, card vs CPU: loss rel {loss_err:.2e} (tol {STEP_LOSS_TOL:.0e}), "
        f"gradients max {grad_err[worst]:.2e} ({worst}, tol {STEP_GRAD_TOL:.0e})")
    if not loss_err <= STEP_LOSS_TOL or not grad_err[worst] <= STEP_GRAD_TOL:
        raise AssertionError(f"families: {family}: card and CPU steps differ: loss {loss_err}, "
                             f"gradients {grad_err}")
    return {"launches": launches, "launches_by_dtype": by_dtype, "metrics": metrics,
            "train_errs": train_errs, "n_params": line["n_params"], "train_s": train_s,
            "step_ms": step_ms, "peak_mib": peak_mib, "profile": profile,
            "step_loss_rel_err": loss_err, "step_grad_rel_l2_max": grad_err[worst]}


def sum_launches(runs) -> tuple:
    """The launch counts of several runs, summed, and by dtype."""
    runs = list(runs)
    by_dtype = {name: {dt: sum(r["launches_by_dtype"][name][dt] for r in runs)
                       for dt in ("float32", "bfloat16")} for name in kernel_specs()}
    return {name: sum(c.values()) for name, c in by_dtype.items()}, by_dtype


def families() -> dict:
    """(17) UNO, LocalNO and CODANO through the port's train_family_quality on the card."""
    runs = {family: family_run(family) for family in FAMILIES}
    launches, by_dtype = sum_launches(runs.values())
    return {"launches": launches, "launches_by_dtype": by_dtype, "runs": runs}


def uqno() -> dict:
    """(18) the port's train_uqno_darcy on the card, at its defaults but for
    UQNO_EPOCHS epochs of each model."""
    import re

    from neuraloperator_tpu_torch.losses import PointwiseQuantileLoss
    from neuraloperator_tpu_torch.scripts import train_uqno_darcy as tuq

    cfg = tuq.UQNOConfig(base_epochs=UQNO_EPOCHS, residual_epochs=UQNO_EPOCHS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        result = tuq.main(["--base_epochs", str(cfg.base_epochs),
                           "--residual_epochs", str(cfg.residual_epochs)])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, by_dtype = read_launches(), read_launches_by_dtype()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    only_dtype(by_dtype, "float32")
    base_losses = [float(v) for v in re.findall(r"train=([0-9.eE+-]+)", tee.text())]
    log(f"uqno: {run_s:.1f} s; base losses {base_losses[0]:.4f} -> {base_losses[-1]:.4f}; "
        f"residual quantile losses {result['residual_losses'][0]:.5f} -> "
        f"{result['residual_losses'][-1]:.5f}; calibration domain_idx {result['domain_idx']} "
        f"function_idx {result['function_idx']} scale {result['scale']:.6f}; coverage "
        f"pointwise {result['pointwise']:.6f} function {result['function']:.4f}, mean band "
        f"{result['band_width']:.6f}; launches {launches}; peak {peak_mib:.0f} MiB")
    # the base's Trainer prints its loss at each evaluation: epoch 0, every
    # tenth and the last
    n_evals = len({e for e in range(cfg.base_epochs) if e % 10 == 0 or e == cfg.base_epochs - 1})
    losses = base_losses + result["residual_losses"]
    if len(base_losses) != n_evals or not all(map(math.isfinite, losses)):
        raise AssertionError(f"uqno: non-finite or missing losses {losses}")
    if not (base_losses[-1] < base_losses[0]
            and result["residual_losses"][-1] < result["residual_losses"][0]):
        raise AssertionError(f"uqno: a training loss did not fall: {losses}")
    # the calibration indices, computed on the host from the split's sizes
    host_idx = tuq.get_coeff_quantile_idx(cfg.alpha, cfg.delta, cfg.n_calib_residual, 16 * 16)
    if (result["domain_idx"], result["function_idx"]) != host_idx:
        raise AssertionError(f"uqno: calibration indices {result['domain_idx']}, "
                             f"{result['function_idx']} against {host_idx} on the host")
    low = {k: (result[k], UQNO_JAX[k] - UQNO_SLACK[k]) for k in UQNO_SLACK
           if not result[k] >= UQNO_JAX[k] - UQNO_SLACK[k]}
    if low:
        raise AssertionError(f"uqno: coverage below the JAX run's less the slack: {low}")
    # K1 per layer of each FNO forward, K2/K3 per layer of each step: the base
    # through the Trainer (its steps and its evaluations), the base's predictions on the residual split, the
    # residual's steps, and the UQNO's predictions (both FNOs) on the
    # calibration and test splits
    n_layers = 4

    def batches(n):
        return math.ceil(n / UQNO_BATCH)

    base_steps = cfg.base_epochs * batches(cfg.n_train_solution)
    res_steps = cfg.residual_epochs * batches(cfg.n_train_residual)
    forwards = (base_steps + n_evals * batches(100) + batches(cfg.n_train_residual)
                + res_steps + 2 * (batches(cfg.n_calib_residual) + batches(100)))
    expected = {"mode_contraction": n_layers * forwards,
                "mode_contraction_dx": n_layers * (base_steps + res_steps),
                "mode_contraction_dw": n_layers * (base_steps + res_steps)}
    if launches != expected:
        raise AssertionError(f"uqno: launched {launches}, expected {expected}")
    # the UQNO's solution gets no gradient: one quantile-loss step through it
    model = result["uqno"].train()
    model.zero_grad(set_to_none=True)  # the training steps' last gradients
    x = torch.randn(2, 1, 16, 16, generator=torch.Generator().manual_seed(SEED + 30)).cuda()
    solution, band = model(x)
    PointwiseQuantileLoss(cfg.alpha)(band, solution).backward()
    base_grads = [n for n, p in model.base_model.named_parameters() if p.grad is not None]
    residual_grads = [p.grad for p in model.residual_model.parameters()]
    if solution.requires_grad or base_grads or any(g is None for g in residual_grads):
        raise AssertionError(f"uqno: the base got gradients ({base_grads}) or the residual "
                             "missed some")
    log(f"uqno: the solution is detached; the base has no gradient, the residual's "
        f"{len(residual_grads)} leaves have theirs")
    return {"launches": launches, "launches_by_dtype": by_dtype, "run_s": run_s,
            "peak_mib": peak_mib, "base_losses": base_losses,
            **{k: v for k, v in result.items() if k != "uqno"}}


def sfno() -> dict:
    """(19) the port's train_sfno_swe at its defaults on the card."""
    import re

    from neuraloperator_tpu_torch.data.datasets import (
        DataLoader,
        TensorDataset,
        load_spherical_swe,
    )
    from neuraloperator_tpu_torch.losses import LpLoss
    from neuraloperator_tpu_torch.ops import sht as tsht
    from neuraloperator_tpu_torch.scripts import train_sfno_swe as tsfno
    from neuraloperator_tpu_torch.training import Trainer, adamw

    cfg = tsfno.SWEConfig()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    record: list = []
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        metrics = run_recipe_entry_point([], record, script=tsfno)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, by_dtype = read_launches(), read_launches_by_dtype()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    no_launches(launches, "sfno: train_sfno_swe")
    trainer = record[-1][0]
    model = trainer.model
    train_errs = [float(v) for v in re.findall(r"train=([0-9.eE+-]+)", tee.text())]
    n_params = int(re.findall(r"^model parameters: (\d+)$", tee.text(), re.M)[-1])
    steps = math.ceil(cfg.n_train / cfg.batch_size)
    step_ms = 1e3 * metrics["epoch_time"] / steps
    log(f"sfno: {cfg.n_epochs} epochs of {steps} steps in {run_s:.1f} s (data made on the host "
        f"included); train losses {train_errs}; final {metrics}; {n_params} parameters; "
        f"{step_ms:.3f} ms per loop step of batch {cfg.batch_size} (last epoch); launches "
        f"{launches}; peak {peak_mib:.0f} MiB")
    if n_params != SFNO_PARAMS:
        raise AssertionError(f"sfno: {n_params} parameters, expected {SFNO_PARAMS}")
    bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
    if bad or not train_errs or not all(map(math.isfinite, train_errs)):
        raise AssertionError(f"sfno: non-finite metrics {bad} or train losses {train_errs}")
    if not train_errs[-1] < train_errs[0]:
        raise AssertionError(f"sfno: the training loss did not fall: {train_errs}")
    misses = {k: (metrics[k], b) for k, b in SFNO_BOUNDS.items() if not metrics[k] <= b}
    if misses:
        raise AssertionError(f"sfno: evaluations above twice the JAX figures {misses}")

    # 10 loop steps of batch 32 from the trained weights, profiled, on the
    # script's training pairs (its generator draws them first: made again)
    loader, _, _ = load_spherical_swe(n_train=cfg.n_train, n_test=0, batch_size=cfg.batch_size,
                                      test_batch_sizes=(), train_resolution=(cfg.nlat, cfg.nlon),
                                      test_resolutions=())
    arrays = loader.dataset.arrays
    n_prof = SFNO_PROFILE_STEPS * cfg.batch_size
    reps = math.ceil(n_prof / len(arrays["x"]))
    prof_loader = DataLoader(TensorDataset(np.concatenate([arrays["x"]] * reps)[:n_prof],
                                           np.concatenate([arrays["y"]] * reps)[:n_prof]),
                             cfg.batch_size)
    l2 = LpLoss(d=2, reduction="sum")

    def loop_steps():
        t = Trainer(model=model, n_epochs=1, device="cuda")
        t.train(prof_loader, {}, adamw(cfg.learning_rate, weight_decay=1e-4), training_loss=l2)

    loop_steps()  # warm
    profile = profile_window(f"{SFNO_PROFILE_STEPS} sfno loop steps of batch {cfg.batch_size}",
                             loop_steps)

    # one step of batch 2, card against CPU from the same weights
    cpu_model = tsfno.build_model(cfg, device="meta").to_empty(device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x2, y2 = arrays["x"][:2], arrays["y"][:2]
    loss_gpu, grads_gpu = one_step(model, None, x2, y2, "cuda", loss=l2)
    loss_cpu, grads_cpu = one_step(cpu_model, None, x2, y2, "cpu", loss=l2)
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    grad_err = grad_errors(grads_gpu, grads_cpu)
    worst = max(grad_err, key=grad_err.get)
    log(f"sfno: one step of batch 2, card vs CPU: loss rel {loss_err:.2e} (tol "
        f"{STEP_LOSS_TOL:.0e}), gradients max {grad_err[worst]:.2e} ({worst}, tol "
        f"{STEP_GRAD_TOL:.0e})")
    if not loss_err <= STEP_LOSS_TOL or not grad_err[worst] <= STEP_GRAD_TOL:
        raise AssertionError(f"sfno: card and CPU steps differ: loss {loss_err}, "
                             f"gradients {grad_err}")

    # the SHT and its inverse on the card against the CPU, both grids
    reset_launches()
    x = torch.randn(2, 3, cfg.nlat, cfg.nlon, generator=torch.Generator().manual_seed(SEED + 40))
    lmax, mmax = cfg.n_modes[0], cfg.n_modes[1] // 2
    sht_err = {}
    for grid in ("equiangular", "legendre-gauss"):
        card = tsht.sht(x.cuda(), lmax, mmax, grid)
        host = tsht.sht(x, lmax, mmax, grid)
        back_card = tsht.isht(card, 2 * cfg.nlat, 2 * cfg.nlon, grid).cpu()
        back_host = tsht.isht(host, 2 * cfg.nlat, 2 * cfg.nlon, grid)
        sht_err[grid] = (rel_l2(card.real.cpu(), card.imag.cpu(), host.real, host.imag),
                         rel_l2(back_card, torch.zeros_like(back_card), back_host,
                                torch.zeros_like(back_host)))
    log(f"sfno: sht / isht (to {2 * cfg.nlat}x{2 * cfg.nlon}), card vs CPU, rel_l2 {sht_err} "
        f"(tol {SHT_TOL:.0e})")
    if not all(e <= SHT_TOL for pair in sht_err.values() for e in pair):
        raise AssertionError(f"sfno: the SHT differs between card and CPU: {sht_err}")
    no_launches(read_launches(), "sfno: the SHT")
    return {"launches": launches, "launches_by_dtype": by_dtype,
            "metrics": metrics, "train_errs": train_errs, "n_params": n_params,
            "run_s": run_s, "step_ms": step_ms, "peak_mib": peak_mib, "profile": profile,
            "step_loss_rel_err": loss_err, "step_grad_rel_l2_max": grad_err[worst],
            "sht_rel_l2": sht_err}


def mhd() -> dict:
    """(20a) the port's train_mhd64 at its defaults on the card."""
    import re

    from neuraloperator_tpu_torch.losses import H1Loss
    from neuraloperator_tpu_torch.models import get_model
    from neuraloperator_tpu_torch.scripts import train_mhd64 as tmhd

    cfg = tmhd.MHDConfig()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    record: list = []
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        metrics = run_recipe_entry_point([], record, script=tmhd)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, by_dtype = read_launches(), read_launches_by_dtype()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    only_dtype(by_dtype, "float32")
    train_errs = [float(v) for v in re.findall(r"train=([0-9.eE+-]+)", tee.text())]
    n_params = int(re.findall(r"^params: (\d+)$", tee.text(), re.M)[-1])
    steps = math.ceil(cfg.data.n_train / cfg.data.batch_size)
    evals = math.ceil(cfg.data.n_test / cfg.data.batch_size)
    step_ms = 1e3 * metrics["epoch_time"] / steps
    log(f"mhd: {cfg.opt.n_epochs} epochs of {steps} steps in {run_s:.1f} s; train losses "
        f"{train_errs}; final {metrics}; {n_params} parameters; {step_ms:.3f} ms per loop step "
        f"of batch {cfg.data.batch_size} (last epoch); launches {launches}; peak "
        f"{peak_mib:.0f} MiB")
    bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
    if bad or len(train_errs) != cfg.opt.n_epochs or not all(map(math.isfinite, train_errs)):
        raise AssertionError(f"mhd: non-finite metrics {bad} or train losses {train_errs}")
    layers, epochs = cfg.model.n_layers, cfg.opt.n_epochs
    expected = {"mode_contraction": layers * epochs * (steps + evals),
                "mode_contraction_dx": layers * epochs * steps,
                "mode_contraction_dw": layers * epochs * steps}
    if launches != expected:
        raise AssertionError(f"mhd: launched {launches}, expected {expected}")

    # one step of batch 2, card against CPU from the same weights
    model = record[-1][0].model
    cpu_model = get_model(cfg.to_dict(), device="meta").to_empty(device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x2, y2 = tmhd._synthetic_mhd(2, cfg.data.resolution, seed=SEED + 50)
    h1 = H1Loss(d=3)
    loss_gpu, grads_gpu = one_step(model, None, x2, y2, "cuda", loss=h1)
    loss_cpu, grads_cpu = one_step(cpu_model, None, x2, y2, "cpu", loss=h1)
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    grad_err = grad_errors(grads_gpu, grads_cpu)
    worst = max(grad_err, key=grad_err.get)
    log(f"mhd: one step of batch 2, card vs CPU: loss rel {loss_err:.2e} (tol "
        f"{STEP_LOSS_TOL:.0e}), gradients max {grad_err[worst]:.2e} ({worst}, tol "
        f"{STEP_GRAD_TOL:.0e})")
    if not loss_err <= STEP_LOSS_TOL or not grad_err[worst] <= STEP_GRAD_TOL:
        raise AssertionError(f"mhd: card and CPU steps differ: loss {loss_err}, "
                             f"gradients {grad_err}")
    return {"launches": launches, "launches_by_dtype": by_dtype, "metrics": metrics,
            "train_errs": train_errs, "n_params": n_params, "run_s": run_s,
            "step_ms": step_ms, "peak_mib": peak_mib, "step_loss_rel_err": loss_err,
            "step_grad_rel_l2_max": grad_err[worst]}


def multivar() -> dict:
    """(20b) the port's train_codano_multivar, cut to MULTIVAR_FLAGS, on the card."""
    from neuraloperator_tpu_torch.scripts import train_codano_multivar as tmulti

    cfg = tmulti.parse_args(MULTIVAR_FLAGS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    result = tmulti.main(MULTIVAR_FLAGS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, by_dtype = read_launches(), read_launches_by_dtype()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    only_dtype(by_dtype, "float32")
    arms = result["arms"]
    figures = {arm: {k: v for k, v in row.items() if k in ("test_l2", "test_l2_2var",
                                                               "zero_shot_l2")}
               for arm, row in arms.items()}
    log(f"multivar: {run_s:.1f} s; test figures {figures}; launches {launches}; peak "
        f"{peak_mib:.0f} MiB")
    values = [v for row in figures.values() for v in row.values()]
    if len(arms) != 6 or not all(map(math.isfinite, values)):
        raise AssertionError(f"multivar: missing or non-finite figures {figures}")
    if arms["fno_ft_budget"]["n_params"] != arms["fno_full"]["n_params"]:
        raise AssertionError(f"multivar: the FNO arms differ: {arms}")
    # K1-K3 only on the FNO arms (CODANO's Tucker layers contract by
    # einsums): K1 per layer and forward (steps, then one test forward per
    # logged epoch and one at the end), K2/K3 per layer and step
    steps = cfg.n_train // cfg.batch

    def evals(epochs):
        return len({e for e in range(epochs) if e % 25 == 0 or e == epochs - 1}) + 1

    runs = (cfg.ft_epochs, cfg.full_epochs)
    expected = {"mode_contraction": cfg.n_layers * sum(e * steps + evals(e) for e in runs),
                "mode_contraction_dx": cfg.n_layers * steps * sum(runs),
                "mode_contraction_dw": cfg.n_layers * steps * sum(runs)}
    if launches != expected:
        raise AssertionError(f"multivar: launched {launches}, expected {expected}")
    return {"launches": launches, "launches_by_dtype": by_dtype, "run_s": run_s,
            "peak_mib": peak_mib, "arms": arms}


def mhd_multivar() -> dict:
    """(20) train_mhd64 and train_codano_multivar; the path's launches are both runs'."""
    runs = {"mhd": mhd(), "multivar": multivar()}
    launches, by_dtype = sum_launches(runs.values())
    return {"launches": launches, "launches_by_dtype": by_dtype, **runs}


@contextlib.contextmanager
def burgers_files():
    """A temporary ``burgers.DATA_ROOT``: the Burgers scripts make their
    pairs and space-time files there, on the host, and read them back."""
    from neuraloperator_tpu_torch.data.datasets import burgers as tburgers

    data_dir = Path(tempfile.mkdtemp(prefix="burgers-files-"))
    default_root, tburgers.DATA_ROOT = tburgers.DATA_ROOT, data_dir
    try:
        yield data_dir
    finally:
        tburgers.DATA_ROOT = default_root
        shutil.rmtree(data_dir, ignore_errors=True)


def entry_point_run(module, record=None, argv=()) -> dict:
    """``module.main(argv)`` on the card (its defaults unless ``argv`` says
    otherwise): its launches counted, its output kept, the model its
    ``build_model`` made kept; with a ``record`` list, each Trainer
    evaluation recorded into it."""
    built, build = [], module.build_model

    def keep(*args, **kwargs):
        built.append(build(*args, **kwargs))
        return built[-1]

    module.build_model = keep
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            result = (module.main(list(argv)) if record is None
                      else run_recipe_entry_point(list(argv), record, script=module))
    finally:
        module.build_model = build
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, by_dtype = read_launches(), read_launches_by_dtype()
    only_dtype(by_dtype, "float32")
    return {"result": result, "model": built[-1], "text": tee.text(), "run_s": run_s,
            "launches": launches, "launches_by_dtype": by_dtype,
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20}


def check_burgers_run(script: str, run: dict, figures: dict, expected: dict) -> None:
    """Finite figures within their bounds, and the launches the batches ask."""
    bad = {k: v for k, v in figures.items() if not math.isfinite(v)}
    misses = {k: (figures[k], b) for k, b in BURGERS_BOUNDS[script].items()
              if not figures[k] <= b}
    if bad or misses:
        raise AssertionError(f"burgers: {script}: non-finite figures {bad} or figures above "
                             f"twice the JAX script's {misses}")
    if run["launches"] != expected:
        raise AssertionError(f"burgers: {script}: launched {run['launches']}, expected "
                             f"{expected}")


def loop_step(model, loss_of):
    """One eager step of AdamW at lr 1e-3 on ``loss_of(model)``, its loss read
    on the host as the scripts read it."""
    from neuraloperator_tpu_torch.training import adamw

    opt = adamw(1e-3).bind(model.named_parameters())

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loss_of(model)
        loss.backward()
        opt.step()
        return float(loss)

    return step


def steps_ms(step, n: int) -> float:
    """Host-clock ms per call of ``step`` over ``n`` calls, after a warm one."""
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def burgers_fno1d() -> dict:
    """(21a) train_burgers at its defaults: the FNO-1D through the Trainer."""
    from neuraloperator_tpu_torch.scripts import train_burgers as tfno1d

    cfg = tfno1d.BurgersConfig()
    record: list = []
    run = entry_point_run(tfno1d, record)
    metrics = run["result"]
    steps = math.ceil(cfg.data.n_train / cfg.data.batch_size)
    evals = math.ceil(cfg.data.n_tests[0] / cfg.data.test_batch_sizes[0])
    layers, epochs = cfg.model.n_layers, cfg.opt.n_epochs
    expected = {"mode_contraction": layers * (epochs * steps + len(record) * evals),
                "mode_contraction_dx": layers * epochs * steps,
                "mode_contraction_dw": layers * epochs * steps}
    step_ms = 1e3 * metrics["epoch_time"] / steps
    log(f"burgers: train_burgers: {epochs} epochs of {steps} steps in {run['run_s']:.1f} s "
        f"(pairs made on the host included); final {metrics}; {step_ms:.3f} ms per loop "
        f"step of batch {cfg.data.batch_size} (last epoch); launches {run['launches']}; peak "
        f"{run['peak_mib']:.0f} MiB")
    check_burgers_run("train_burgers", run, {k: metrics[k] for k in ("16_h1", "16_l2")},
                      expected)
    return {"metrics": metrics, "run_s": run["run_s"], "step_ms": step_ms,
            "launches": run["launches"], "launches_by_dtype": run["launches_by_dtype"],
            "peak_mib": run["peak_mib"]}


def burgers_pino() -> dict:
    """(21b) train_burgers_pino at its defaults: the custom ReLoBRaLo loop."""
    from neuraloperator_tpu_torch.data.datasets import burgers as tburgers
    from neuraloperator_tpu_torch.data.datasets import load_pt_as_numpy
    from neuraloperator_tpu_torch.losses import BurgersEqnLoss, ICLoss, LpLoss
    from neuraloperator_tpu_torch.scripts import train_burgers_pino as tpino

    cfg = tpino.PINOConfig()
    run = entry_point_run(tpino)
    result = run["result"]
    steps = math.ceil(cfg.n_train / cfg.batch_size)
    evals = math.ceil(cfg.n_test / cfg.batch_size)
    layers = run["model"].n_layers
    expected = {"mode_contraction": layers * (cfg.n_epochs * steps + evals),
                "mode_contraction_dx": layers * cfg.n_epochs * steps,
                "mode_contraction_dw": layers * cfg.n_epochs * steps}
    data = load_pt_as_numpy(tburgers.DATA_ROOT / f"burgers_pino_train_{cfg.resolution}.pt")
    x = torch.from_numpy(data["x"][:cfg.batch_size, None]).cuda()
    y = torch.from_numpy(data["y"][:cfg.batch_size, None]).cuda()
    losses = (LpLoss(d=2), ICLoss(), BurgersEqnLoss(visc=cfg.visc,
                                                    domain_length=[1.0, 2 * math.pi]))

    def total(model):
        out = model(x)
        return losses[0](out, y) + losses[1](out, y) + losses[2](out)

    step_ms = steps_ms(loop_step(run["model"], total), 10)
    log(f"burgers: train_burgers_pino: {cfg.n_epochs} epochs of {steps} steps in "
        f"{run['run_s']:.1f} s (space-time files made on the host included); test l2 "
        f"{result['test_l2']:.6f}, last epoch's parts {result['parts']}, weights "
        f"{result['weights']}; {step_ms:.3f} ms per loop step of batch {cfg.batch_size} "
        f"(10 steps after the run); launches {run['launches']}; peak {run['peak_mib']:.0f} MiB")
    check_burgers_run("train_burgers_pino", run, {"test_l2": result["test_l2"]}, expected)
    return {"result": result, "run_s": run["run_s"], "step_ms": step_ms,
            "launches": run["launches"], "launches_by_dtype": run["launches_by_dtype"],
            "peak_mib": run["peak_mib"]}


def burgers_rno() -> dict:
    """(21c) train_burgers_rno at its defaults; one step and a rollout card
    against CPU; the loop step's profile."""
    from neuraloperator_tpu_torch.losses import LpLoss
    from neuraloperator_tpu_torch.scripts import train_burgers_rno as trno

    cfg = trno.RNOConfig()
    run = entry_point_run(trno)
    result, model = run["result"], run["model"]
    steps = math.ceil(cfg.n_train / cfg.batch_size)
    per = RNO_LAUNCHES_PER_FORWARD
    expected = {"mode_contraction": per * (cfg.n_epochs * steps + 1),
                "mode_contraction_dx": per * cfg.n_epochs * steps,
                "mode_contraction_dw": per * cfg.n_epochs * steps}
    log(f"burgers: train_burgers_rno: {cfg.n_epochs} epochs of {steps} steps in "
        f"{run['run_s']:.1f} s (trajectories made on the host included); test l2 "
        f"{result['test_l2']:.6f}; train l2 by epoch {[round(v, 4) for v in result['train_l2']]}; "
        f"launches {run['launches']} ({per} K1 a forward); peak {run['peak_mib']:.0f} MiB")
    check_burgers_run("train_burgers_rno", run, {"test_l2": result["test_l2"]}, expected)

    # one step of batch 8, card against CPU from the trained weights
    x_train, y_train, x_test, _ = trno.make_data(cfg)
    xb, yb = torch.from_numpy(x_train[:cfg.batch_size]), torch.from_numpy(y_train[:cfg.batch_size])
    cpu_model = trno.build_model(device="meta").to_empty(device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    l2 = LpLoss(d=1)

    def loss_and_grads(m, device):
        m.zero_grad(set_to_none=True)
        loss = l2(m(xb.to(device)), yb.to(device))
        loss.backward()
        return float(loss), {n: p.grad.detach().float().cpu() for n, p in m.named_parameters()}

    loss_gpu, grads_gpu = loss_and_grads(model, "cuda")
    loss_cpu, grads_cpu = loss_and_grads(cpu_model, "cpu")
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    grad_err = grad_errors(grads_gpu, grads_cpu)
    worst = max(grad_err, key=grad_err.get)
    # the rollout of the test windows, card against CPU
    with torch.no_grad():
        roll_card = model.predict(torch.from_numpy(x_test).cuda(), RNO_ROLLOUT_STEPS)
        roll_cpu = cpu_model.predict(torch.from_numpy(x_test), RNO_ROLLOUT_STEPS)
    roll_err = [rel_l2_t(roll_card[:, s], roll_cpu[:, s]) for s in range(RNO_ROLLOUT_STEPS)]
    log(f"burgers: RNO step of batch {cfg.batch_size}, card vs CPU: loss rel {loss_err:.2e} "
        f"(tol {STEP_LOSS_TOL:.0e}), gradients max {grad_err[worst]:.2e} ({worst}, tol "
        f"{STEP_GRAD_TOL:.0e}) over {len(grad_err)} parameters; {RNO_ROLLOUT_STEPS}-step "
        f"rollout of {len(x_test)} windows rel_l2 by step {[f'{e:.2e}' for e in roll_err]} "
        f"(tol {SERVE_TOL:.0e})")
    if not loss_err <= STEP_LOSS_TOL or not grad_err[worst] <= STEP_GRAD_TOL:
        raise AssertionError(f"burgers: RNO card and CPU steps differ: loss {loss_err}, "
                             f"gradients {grad_err}")
    if not all(e <= SERVE_TOL for e in roll_err) or roll_card.shape != roll_cpu.shape:
        raise AssertionError(f"burgers: RNO rollouts differ between card and CPU: {roll_err}")

    # the eager loop step of batch 8, timed and profiled, from the trained weights
    xb, yb = xb.cuda(), yb.cuda()
    step = loop_step(model, lambda m: l2(m(xb), yb))
    step_ms = steps_ms(step, RNO_TIMED_STEPS)
    reset_launches()
    profile = profile_window(f"{RNO_PROFILE_STEPS} RNO loop steps of batch {cfg.batch_size}",
                             lambda: [step() for _ in range(RNO_PROFILE_STEPS)])
    per_step = {k: v / RNO_PROFILE_STEPS for k, v in read_launches().items()}
    log(f"burgers: RNO loop step {step_ms:.3f} ms at batch {cfg.batch_size}; K1-K3 launches a "
        f"step {per_step}")
    return {"result": result, "run_s": run["run_s"], "step_ms": step_ms,
            "launches": run["launches"], "launches_by_dtype": run["launches_by_dtype"],
            "peak_mib": run["peak_mib"], "profile": profile,
            "step_loss_rel_err": loss_err, "step_grad_rel_l2_max": grad_err[worst],
            "rollout_rel_l2": roll_err}


def extended_scale(fd, u, orders) -> float:
    """The largest derivative of ``fd``'s continued field on its whole domain
    over ``orders`` (on the CPU): where its f32 FFT rounds."""
    from neuraloperator_tpu_torch.losses import FourierDiff

    n_add = fd.FC.n_additional_pts
    length = [lo * (n + n_add) / n for lo, n in zip(fd.L, u.shape[-fd.dim:])]
    ext = fd.FC.extend(u, dim=fd.dim)
    full = FourierDiff(fd.dim, L=length)
    return max(float(full.derivative(ext, o).abs().max()) for o in orders)


def burgers_losses() -> dict:
    """(21d) BurgersEqnLoss (value and gradient) and FourierDiff without and
    with continuation, card against CPU in f32, on a smooth (t, x) field."""
    from neuraloperator_tpu_torch.losses import BurgersEqnLoss, FourierDiff

    gen = torch.Generator().manual_seed(SEED + 60)
    t = torch.linspace(0, 1, 16)[:, None]
    xs = (2 * math.pi / 16) * torch.arange(16)[None, :]
    amp = torch.randn(4, 1, 3, generator=gen)
    u = sum(amp[:, :, k, None, None] * torch.sin((k + 1) * xs - t * (k + 1)) for k in range(3))
    u = (u + 0.5 * t).float()  # not periodic in time
    eqn = BurgersEqnLoss(visc=0.05, domain_length=[1.0, 2 * math.pi])
    errs = {}
    card = u.clone().cuda().requires_grad_()
    host = u.clone().requires_grad_()
    loss_card, loss_host = eqn(card), eqn(host)
    loss_card.backward()
    loss_host.backward()
    errs["eqn_loss"] = abs(float(loss_card) - float(loss_host)) / abs(float(loss_host))
    errs["eqn_grad"] = rel_l2_t(card.grad, host.grad)
    units = [(1, 0), (0, 1), (2, 0), (0, 2)]
    for use_fc in (False, "legendre", "gram"):
        fd = FourierDiff(2, L=(1.0, 2 * math.pi), use_fc=use_fc)
        for name, run, orders in (("dx", lambda f, a: f.dx(a), units[:1]),
                                  ("dy2", lambda f, a: f.dy(a, 2), units[3:]),
                                  ("laplacian", lambda f, a: f.laplacian(a), units[2:])):
            want = run(fd, u)
            got = run(fd, u.cuda()).cpu()
            scale = float(want.abs().max()) if not use_fc else extended_scale(fd, u, orders)
            errs[f"{use_fc or 'periodic'}_{name}"] = float((got - want).abs().max()) / scale
    log(f"burgers: BurgersEqnLoss and FourierDiff, card vs CPU: {errs} (tol "
        f"{BURGERS_LOSS_TOL:.0e}; with continuation {BURGERS_FC_TOL:.0e} of the largest "
        f"derivative on the continued domain)")
    if not all(e <= (BURGERS_FC_TOL if k.startswith(("legendre", "gram")) else BURGERS_LOSS_TOL)
               for k, e in errs.items()):
        raise AssertionError(f"burgers: losses differ between card and CPU: {errs}")
    return errs


def burgers() -> dict:
    """(21) the three Burgers scripts, the RNO checks and the losses; the
    path's launches are the three scripts'."""
    t0 = time.perf_counter()
    with burgers_files():
        runs = {"train_burgers": burgers_fno1d(), "train_burgers_pino": burgers_pino()}
    runs["train_burgers_rno"] = burgers_rno()
    launches, by_dtype = sum_launches(runs.values())
    losses = burgers_losses()
    phase_s = time.perf_counter() - t0
    log(f"burgers: phase in {phase_s:.1f} s; launches {launches}")
    return {"launches": launches, "launches_by_dtype": by_dtype, "losses": losses,
            "phase_s": phase_s, **runs}


def neighbor_sets_against(card: dict, cpu: dict, data, queries, radius: float) -> dict:
    """Padded neighbour lists of one search on the card and on the CPU,
    compared as sets: how many queries' sets differ, and the largest gap
    between a differing point's float64 squared distance and the query's
    cut (its k-th squared distance within the radius, or the radius
    squared), which must stay within ``NEIGHBOR_TIE_MARGIN``."""
    data, queries = data.double().cpu(), queries.double().cpu()
    exact = ((queries[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    m, n = exact.shape
    k = cpu["neighbors_index"].shape[1]

    def members(found):
        idx, mask = found["neighbors_index"].cpu(), found["neighbors_mask"].cpu()
        out = torch.zeros(m, n, dtype=torch.bool)
        rows = torch.arange(m)[:, None].expand(m, k)
        out[rows[mask], idx[mask]] = True
        return out

    diff = members(card) ^ members(cpu)
    r2 = radius ** 2
    kth = torch.where(exact <= r2, exact, torch.full_like(exact, math.inf)).sort(dim=1).values
    cut = kth[:, k - 1]
    gap = torch.minimum((exact - torch.where(torch.isfinite(cut), cut, r2)[:, None]).abs(),
                        (exact - r2).abs())
    worst = float(torch.where(diff, gap, torch.zeros_like(gap)).max())
    return {"queries": m, "differing": int(diff.any(dim=1).sum()), "max_tie_gap": worst,
            "kept_card": int(card["neighbors_mask"].sum()),
            "kept_cpu": int(cpu["neighbors_mask"].sum())}


def check_gno_run(script: str, run: dict, figures: list, train: list, expected: dict) -> None:
    """Finite figures within their bounds, a falling training loss, and the
    launches the steps and evaluations ask."""
    bad = [v for v in figures + train if not math.isfinite(v)]
    misses = [(v, b) for v, b in zip(figures, GNO_BOUNDS[script]) if not v <= b]
    if bad or misses or not train[-1] < train[0]:
        raise AssertionError(f"gno: {script}: non-finite figures {bad}, figures above twice "
                             f"the JAX script's {misses}, or a training loss that did not "
                             f"fall {train}")
    if run["launches"] != expected:
        raise AssertionError(f"gno: {script}: launched {run['launches']}, expected {expected}")


def card_against_cpu_step(model, build_cpu, loss_of, label: str, phase: str = "gno") -> dict:
    """One step's loss and gradients from the same weights, card against CPU;
    ``loss_of(model, device)`` computes the loss on ``device``."""
    cpu_model = build_cpu()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    results = {}
    for m, device in ((model, "cuda"), (cpu_model, "cpu")):
        m.zero_grad(set_to_none=True)
        loss = loss_of(m, device)
        loss.backward()
        results[device] = (float(loss), {n: p.grad.detach().float().cpu()
                                         for n, p in m.named_parameters()})
    (loss_gpu, grads_gpu), (loss_cpu, grads_cpu) = results["cuda"], results["cpu"]
    model.zero_grad(set_to_none=True)
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    grad_err = grad_errors(grads_gpu, grads_cpu)
    worst = max(grad_err, key=grad_err.get)
    log(f"{phase}: {label}, card vs CPU: loss {loss_gpu:.7f} vs {loss_cpu:.7f} (rel "
        f"{loss_err:.2e}, tol {STEP_LOSS_TOL:.0e}); gradients max {grad_err[worst]:.2e} "
        f"({worst}, tol {STEP_GRAD_TOL:.0e}) over {len(grad_err)} parameters")
    if not loss_err <= STEP_LOSS_TOL or not grad_err[worst] <= STEP_GRAD_TOL:
        raise AssertionError(f"{phase}: {label}: card and CPU differ: loss {loss_err}, "
                             f"gradients {grad_err}")
    return {"loss_rel_err": loss_err, "grad_rel_l2_max": grad_err[worst], "grad_worst": worst}


def gno_carcfd(module, model_name: str) -> dict:
    """(22a, 22b) a car-CFD script cut to GNO_CUT on the card; then, from
    its trained weights, the loop step's ms, one step card against CPU with
    the CPU's neighbourhoods fed to both, and the padded searches card
    against CPU as sets."""
    from neuraloperator_tpu_torch.data.datasets import load_synthetic_cfd
    from neuraloperator_tpu_torch.layers.neighbor_search import padded_neighbor_search
    from neuraloperator_tpu_torch.losses import LpLoss

    script = module.__name__.rsplit(".", 1)[-1]
    cfg = module.CarConfig(**GNO_CUT, data_source="synthetic")
    run = entry_point_run(module, argv=GNO_CUT_FLAGS)
    result, model = run["result"], run["model"]
    layers = model.fno_n_layers
    steps = cfg.n_train * cfg.n_epochs
    evals = cfg.n_test * (cfg.n_epochs // cfg.eval_interval + 1)
    expected = {"mode_contraction": layers * (steps + evals),
                "mode_contraction_dx": layers * steps, "mode_contraction_dw": layers * steps}
    log(f"gno: {script}: {cfg.n_epochs} epochs of {cfg.n_train} steps in {run['run_s']:.1f} s "
        f"(samples made on the host included); final test l2 {result['test_l2']:.6f}; train "
        f"l2 by epoch {[round(v, 5) for v in result['train_l2']]}; launches "
        f"{run['launches']}; peak {run['peak_mib']:.0f} MiB")
    check_gno_run(script, run, [result["test_l2"]], result["train_l2"], expected)

    sample = load_synthetic_cfd(1)[0]
    l2 = LpLoss(d=1)
    radius, k = cfg.radius, cfg.max_neighbors
    if model_name == "GINO":
        lq = module.latent_queries(cfg.latent_n)
        batch = module.prep(sample, lq, "cuda")
        lq_flat, verts = batch[1].reshape(-1, 3), batch[0][0]
        searches = {"in": (verts, lq_flat), "out": (lq_flat, verts)}

        def loss_of(m, device, nb=None):
            geom, lq_, oq, x, y = (t.to(device) for t in batch)
            kw = {} if nb is None else {"in_neighbors": {k_: v.to(device) for k_, v in
                                                         nb["in"].items()},
                                        "out_neighbors": {k_: v.to(device) for k_, v in
                                                          nb["out"].items()}}
            return l2(m(geom, lq_, oq, x, **kw).permute(0, 2, 1), y.permute(0, 2, 1))
    else:
        batch = module.prep(sample, "cuda")
        searches = {"out": (batch[0].reshape(-1, 3), batch[1])}

        def loss_of(m, device, nb=None):
            in_p, out_p, f, y = (t.to(device) for t in batch)
            kw = {} if nb is None else {"neighbors": {k_: v.to(device) for k_, v in
                                                      nb["out"].items()}}
            return l2(m(in_p, out_p, f, **kw).T[None], y.T[None])

    step = loop_step(model, lambda m: loss_of(m, "cuda"))
    step_ms = steps_ms(step, GNO_TIMED_STEPS)
    found = {side: {"cuda": padded_neighbor_search(data, queries, radius, k),
                    "cpu": padded_neighbor_search(data.cpu(), queries.cpu(), radius, k)}
             for side, (data, queries) in searches.items()}
    sets = {side: neighbor_sets_against(f["cuda"], f["cpu"], *searches[side], radius)
            for side, f in found.items()}
    log(f"gno: {script}: loop step {step_ms:.3f} ms (host clock, {GNO_TIMED_STEPS} steps "
        f"after the run); padded search card vs CPU as sets {sets} (margin "
        f"{NEIGHBOR_TIE_MARGIN:.0e})")
    if any(v["max_tie_gap"] > NEIGHBOR_TIE_MARGIN for v in sets.values()):
        raise AssertionError(f"gno: {script}: the card's neighbour sets differ from the CPU's "
                             f"beyond near ties: {sets}")
    shared = {side: f["cpu"] for side, f in found.items()}
    step_check = card_against_cpu_step(
        model, lambda: module.build_model(cfg, device="meta").to_empty(device="cpu"),
        lambda m, device: loss_of(m, device, shared), f"{model_name} step with shared neighbours")
    return {"result": result, "run_s": run["run_s"], "step_ms": step_ms,
            "launches": run["launches"], "launches_by_dtype": run["launches_by_dtype"],
            "peak_mib": run["peak_mib"], "neighbor_sets": sets, "step_check": step_check,
            "model": model, "loss_of": loss_of}


def gno_poisson(interior: bool) -> dict:
    """(22c, 22d) train_poisson at its defaults, without or with the physics
    loss, on the card and then on the CPU from the same init; with the
    physics loss, the interior loss and its gradient card against CPU."""
    from neuraloperator_tpu_torch.data.datasets import NonlinearPoissonDataset
    from neuraloperator_tpu_torch.losses import LpLoss, PoissonInteriorLoss
    from neuraloperator_tpu_torch.scripts import train_poisson as tpois

    cfg = tpois.PoissonConfig()
    label = "train_poisson_interior" if interior else "train_poisson"
    run = entry_point_run(tpois, argv=POISSON_INTERIOR_FLAGS if interior else ())
    result, model = run["result"], run["model"]
    # each step runs the model once for the data loss and once more inside
    # the physics loss, whose graph the backward goes through too
    per_step = 2 if interior else 1
    layers, steps = model.fno_n_layers, cfg.n_train * cfg.n_epochs
    expected = {"mode_contraction": layers * (per_step * steps + cfg.n_test),
                "mode_contraction_dx": layers * per_step * steps,
                "mode_contraction_dw": layers * per_step * steps}
    log(f"gno: {label}: {cfg.n_epochs} epochs of {cfg.n_train} steps in {run['run_s']:.1f} s; "
        f"test l2 {result['test_l2']}; loss by epoch "
        f"{[round(v, 5) for v in result['train_loss']]}; launches {run['launches']}; peak "
        f"{run['peak_mib']:.0f} MiB")
    check_gno_run(label, run, result["test_l2"], result["train_loss"], expected)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        host = tpois.main([*(POISSON_INTERIOR_FLAGS if interior else ()), "--device", "cpu"])
    host_s = time.perf_counter() - t0
    figures, host_figures = (r["test_l2"] + r["train_loss"] for r in (result, host))
    host_err = max(abs(a - b) / abs(b) for a, b in zip(figures, host_figures))
    log(f"gno: {label}: the script on the CPU from the same init in {host_s:.1f} s: test l2 "
        f"{host['test_l2']}; card vs CPU, figures and epoch losses, worst rel {host_err:.3e} "
        f"(bound {POISSON_CPU_TOL:.0e})")
    if not host_err <= POISSON_CPU_TOL:
        raise AssertionError(f"gno: {label}: card and CPU runs differ: {figures} against "
                             f"{host_figures}")

    ds = NonlinearPoissonDataset(n_train=1, n_test=0)
    f_grid, queries, y, src, nb = tpois.prep(ds.train_data[0], "cuda")
    n_phys = cfg.n_physics_points
    l2, interior_loss = LpLoss(d=1), PoissonInteriorLoss()

    def loss_of(m, device):
        in_p = tpois.grid_points(device)
        f, q, yy, s = (t.to(device) for t in (f_grid, queries, y, src))
        data = l2(m(in_p, q, f).T[None], yy.T[None])
        if not interior:
            return data
        return data + 0.1 * interior_loss(lambda qq: m(in_p, qq, f)[:, 0],
                                          output_queries=q[nb:nb + n_phys],
                                          output_source_terms_domain=s[:n_phys])

    step_ms = steps_ms(loop_step(model, lambda m: loss_of(m, "cuda")), GNO_TIMED_STEPS)
    log(f"gno: {label}: loop step {step_ms:.3f} ms (host clock, {GNO_TIMED_STEPS} steps "
        f"after the run)")
    out = {"result": result, "run_s": run["run_s"], "step_ms": step_ms,
           "launches": run["launches"], "launches_by_dtype": run["launches_by_dtype"],
           "peak_mib": run["peak_mib"], "cpu_run": {"test_l2": host["test_l2"],
                                                    "rel_err": host_err, "s": host_s}}
    if interior:
        out["step_check"] = card_against_cpu_step(
            model, lambda: tpois.build_model(device="meta").to_empty(device="cpu"),
            lambda m, device: 0.1 * interior_loss(
                lambda qq: m(tpois.grid_points(device), qq, f_grid.to(device))[:, 0],
                output_queries=queries[nb:nb + n_phys].to(device),
                output_source_terms_domain=src[:n_phys].to(device)),
            "Poisson interior loss")
    return out


def gno() -> dict:
    """(22) the GNO family's three entry points, the card-against-CPU
    checks and a profile of GINO loop steps; the path's launches are the
    four script runs'."""
    from neuraloperator_tpu_torch.scripts import train_fnogno_carcfd as tfnogno
    from neuraloperator_tpu_torch.scripts import train_gino_carcfd as tgino

    t0 = time.perf_counter()
    runs = {"train_gino_carcfd": gno_carcfd(tgino, "GINO"),
            "train_fnogno_carcfd": gno_carcfd(tfnogno, "FNOGNO"),
            "train_poisson": gno_poisson(interior=False),
            "train_poisson_interior": gno_poisson(interior=True)}
    launches, by_dtype = sum_launches(runs.values())

    # the models and their loss closures stay out of the returned record
    (model, loss_of), _ = ((runs[s].pop("model"), runs[s].pop("loss_of"))
                           for s in ("train_gino_carcfd", "train_fnogno_carcfd"))
    step = loop_step(model, lambda m: loss_of(m, "cuda"))
    reset_launches()
    profile = profile_window(f"{GNO_PROFILE_STEPS} GINO loop steps",
                             lambda: [step() for _ in range(GNO_PROFILE_STEPS)])
    per_step = {k: v / GNO_PROFILE_STEPS for k, v in read_launches().items()}
    phase_s = time.perf_counter() - t0
    log(f"gno: GINO loop step K1-K3 launches a step {per_step}; phase in {phase_s:.1f} s; "
        f"launches {launches}")
    return {"launches": launches, "launches_by_dtype": by_dtype, "profile": profile,
            "phase_s": phase_s, **runs}


def ot_maps_against_numpy() -> dict:
    """(23d) one body's OT maps by the card's Sinkhorn against the numpy
    plain version, and the seconds of each (and of the torch solver on the
    host)."""
    from neuraloperator_tpu_torch.data.datasets import load_synthetic_cfd
    from neuraloperator_tpu_torch.data.datasets import ot_datamodule as otdm
    from neuraloperator_tpu_torch.scripts import train_otno_carcfd as totno

    cfg = totno.OTConfig()
    verts = load_synthetic_cfd(1)[0]["vertices"].astype(np.float32)
    center = verts.mean(0)
    verts = (verts - center) / np.abs(verts - center).max()
    seconds = {}
    for device in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dm = otdm.OTDataModule(verts, cfg.latent_size, reg=cfg.reg, n_iters=totno.OT_ITERS,
                               device=device)
        torch.cuda.synchronize()
        seconds[f"torch_{device}"] = time.perf_counter() - t0
        if device == "cuda":
            card = dm
    n_lat = cfg.latent_size ** 2
    t0 = time.perf_counter()
    C = otdm.cost_matrix(otdm.latent_sphere(verts, cfg.latent_size), verts)
    plan = otdm.sinkhorn_log(np.full(n_lat, 1.0 / n_lat), np.full(len(verts), 1.0 / len(verts)),
                             C, reg=cfg.reg, n_iters=totno.OT_ITERS)
    seconds["numpy"] = time.perf_counter() - t0
    got = card.plan.cpu().numpy()
    plan_err = float(np.abs(got - plan).max() / plan.max())
    ties, worst = {}, 0.0
    for name, axis in (("ind_enc", 1), ("ind_dec", 0)):
        mine, want = getattr(card, name).cpu().numpy(), plan.argmax(axis=axis)
        diff = np.nonzero(mine != want)[0]
        for i in diff:
            line = plan[i] if axis == 1 else plan[:, i]
            worst = max(worst, abs(line[want[i]] - line[mine[i]]) / line.max())
        ties[name] = int(len(diff))
    log(f"otno: OT maps of one {len(verts)}-vertex body ({n_lat} latent cells, reg {cfg.reg}, "
        f"{totno.OT_ITERS} iterations): card {seconds['torch_cuda']:.3f} s, host torch "
        f"{seconds['torch_cpu']:.3f} s, host numpy {seconds['numpy']:.3f} s; plan vs numpy "
        f"{plan_err:.2e} (tol {OT_PLAN_TOL:.0e}); maps differing {ties} (worst gap {worst:.1e}, "
        f"margin {OT_TIE_MARGIN:.0e})")
    if not plan_err <= OT_PLAN_TOL or worst > OT_TIE_MARGIN:
        raise AssertionError(f"otno: the card's OT plan differs from numpy's: {plan_err}, maps "
                             f"{ties}, worst gap {worst}")
    return {"seconds": seconds, "plan_rel_err": plan_err, "differing_maps": ties,
            "worst_tie_gap": worst}


def reference_state_dict(model) -> dict:
    """A reference neuralop (PyTorch) state dict holding a dense FNO's
    weights (soft-gating channel-MLP skips, linear FNO skips): Conv1d
    weights (out, in, 1) and complex spectral weights."""
    import re

    sd = {}
    for name, value in model.state_dict().items():
        v = value.detach().cpu()
        key = re.sub(r"^(lifting|projection)\.([wb])(\d+)$",
                     lambda m: f"{m[1]}.fcs.{m[3]}." + ("weight" if m[2] == "w" else "bias"),
                     name)
        key = re.sub(r"channel_mlp_(\d+)\.([wb])(\d+)$",
                     lambda m: f"channel_mlp.{m[1]}.fcs.{m[3]}."
                     + ("weight" if m[2] == "w" else "bias"), key)
        key = re.sub(r"conv_(\d+)\.w_weight$", r"convs.\1.weight.tensor", key)
        key = re.sub(r"conv_(\d+)\.bias$", r"convs.\1.bias", key)
        key = re.sub(r"fno_skip_(\d+)\.weight$", r"fno_skips.\1.conv.weight", key)
        key = re.sub(r"channel_mlp_skip_(\d+)\.weight$", r"channel_mlp_skips.\1.weight", key)
        if key.endswith("weight.tensor"):
            v = torch.complex(v[0], v[1])
        elif re.search(r"(fcs\.\d+|conv)\.weight$", key):
            v = v[..., None]
        sd[key] = v
    return sd


def rel_max(card: torch.Tensor, cpu: torch.Tensor) -> float:
    cpu = cpu.detach().double()
    return float((card.detach().cpu().double() - cpu).abs().max() / cpu.abs().max())


def spectral_divergence(u: torch.Tensor) -> float:
    """Largest |kx û0 + ky û1| of (b, 2, h, w) fields (numpy, float64),
    relative to the largest wavenumber times the largest mode."""
    u = u.detach().cpu().double().numpy()
    h, w = u.shape[-2:]
    uh = np.fft.rfftn(u, axes=(-2, -1), norm="forward")
    kx = np.fft.fftfreq(h, d=1.0 / h)[:, None]
    ky = np.fft.rfftfreq(w, d=1.0 / w)[None, :]
    k_max = float(np.sqrt(kx ** 2 + ky ** 2).max())
    return float(np.abs(kx * uh[:, 0] + ky * uh[:, 1]).max() / (k_max * np.abs(uh).max()))


def part2(otno_model) -> dict:
    """(23f) the modules no model builds and the checkpoint odds, card
    against CPU: the legacy convolutions, the spectral projection, the
    attention kernel integral with and without rotary embeddings, an FNO
    through ``torch_import``, and a ``save_checkpoint`` round trip."""
    from neuraloperator_tpu_torch.layers import attention_kernel_integral as attn
    from neuraloperator_tpu_torch.layers import legacy_spectral_convolution as legacy
    from neuraloperator_tpu_torch.layers import spectral_projection as proj
    from neuraloperator_tpu_torch.layers.embeddings import RotaryEmbedding2D
    from neuraloperator_tpu_torch.models import (
        FNO,
        from_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )
    from neuraloperator_tpu_torch.models import torch_import

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED)
    errors = {}

    def both(build, *inputs, **kwargs):
        cpu = build("cpu")
        card = build("meta").to_empty(device="cuda")
        card.load_state_dict(cpu.state_dict())
        return card(*(t.cuda() for t in inputs), **kwargs), cpu(*inputs, **kwargs)

    convs = {
        "SpectralConv1d": (lambda d: legacy.SpectralConv1d(32, 32, 16, device=d, generator=gen),
                           (8, 32, 256), {}),
        "SpectralConv2d": (lambda d: legacy.SpectralConv2d(32, 32, (16, 16), device=d,
                                                           generator=gen), (8, 32, 64, 64), {}),
        "SpectralConv3d": (lambda d: legacy.SpectralConv3d(16, 16, (8, 8, 8), device=d,
                                                           generator=gen),
                           (4, 16, 32, 32, 32), {}),
        "JointFactorizedSpectralConv": (
            lambda d: legacy.JointFactorizedSpectralConv(32, 32, (16, 16), n_layers=4,
                                                         device=d, generator=gen),
            (8, 32, 64, 64), {"layer_index": 3}),
    }
    for name, (build, shape, kwargs) in convs.items():
        x = torch.randn(*shape, generator=gen)
        errors[name] = rel_max(*both(build, x, **kwargs))
    for rotary in (False, True):
        pe = RotaryEmbedding2D(8) if rotary else None
        u, pos = torch.randn(2, 2048, 64, generator=gen), torch.rand(2, 2048, 2, generator=gen)
        card, cpu = both(lambda d: attn.AttentionKernelIntegral(64, 64, 4, 16, device=d,
                                                                generator=gen), u, pos,
                         positional_embedding_module=pe)
        errors[f"AttentionKernelIntegral{' rotary' if rotary else ''}"] = rel_max(card, cpu)
    u = torch.randn(4, 2, 128, 128, generator=gen)
    card, cpu = proj.spectral_projection_divergence_free(u.cuda()), \
        proj.spectral_projection_divergence_free(u)
    errors["spectral_projection_divergence_free"] = rel_max(card, cpu)
    spec = proj.projected_spectrum(u.cuda())
    col = spec[..., 0]  # the real field's DC column: Hermitian in kx
    hermitian = float((col - col.flip(-1).roll(1, -1).conj()).abs().max() / spec.abs().max())
    divergence = {"card": spectral_divergence(card), "cpu": spectral_divergence(cpu),
                  "input": spectral_divergence(u)}

    source = FNO((16, 16), 3, 1, 32, device="cpu", generator=gen)
    card_fno = FNO((16, 16), 3, 1, 32, device="meta").to_empty(device="cuda")
    card_fno.load_state_dict(torch_import.convert_reference_state_dict(
        reference_state_dict(source), card_fno.state_dict()))
    x = torch.randn(4, 3, 64, 64, generator=gen)
    with torch.no_grad():
        errors["FNO through torch_import"] = rel_max(card_fno(x.cuda()), source(x))

    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(otno_model, tmp, "otno")
        again = load_checkpoint(from_checkpoint(tmp, "otno", device="cuda"), tmp, "otno")
    state = otno_model.state_dict()
    round_trip = all(torch.equal(v, state[k]) for k, v in again.state_dict().items())
    part_s = time.perf_counter() - t0
    log(f"otno: part 2 card vs CPU, max relative error {errors} (tol {PART2_TOL:.0e}); spectral "
        f"divergence card {divergence['card']:.1e} CPU {divergence['cpu']:.1e} (input "
        f"{divergence['input']:.2f}; tol {DIVERGENCE_TOL:.0e}); projected spectrum's Hermitian "
        f"defect on the card {hermitian:.1e} (tol {HERMITIAN_TOL:.0e}); save_checkpoint -> "
        f"load_checkpoint on the card equal to the bit: {round_trip}; {part_s:.1f} s")
    bad = {k: v for k, v in errors.items() if not v <= PART2_TOL}
    if (bad or not round_trip or hermitian > HERMITIAN_TOL
            or max(divergence["card"], divergence["cpu"]) > DIVERGENCE_TOL):
        raise AssertionError(f"otno: part 2 failed: errors {bad}, round trip {round_trip}, "
                             f"Hermitian defect {hermitian}, divergence {divergence}")
    return {"rel_err": errors, "divergence": divergence, "hermitian_defect": hermitian,
            "round_trip": round_trip, "s": part_s}


def otno() -> dict:
    """(23) train_otno_carcfd cut to OTNO_CUT on the card (23a) and on this
    machine's CPU from the same init (23b); one step card against CPU (23c);
    the OT maps against numpy (23d); the loop step and a profile (23e); and
    the modules no model builds (23f). The path's launches are the card
    run's."""
    from neuraloperator_tpu_torch.data.datasets import load_synthetic_cfd
    from neuraloperator_tpu_torch.losses import LpLoss
    from neuraloperator_tpu_torch.scripts import train_otno_carcfd as totno

    t0 = time.perf_counter()
    cfg = totno.OTConfig(**OTNO_CUT, data_source="synthetic")
    run = entry_point_run(totno, argv=OTNO_CUT_FLAGS)
    result, model = run["result"], run["model"]
    steps = cfg.n_train * cfg.n_epochs
    evals = cfg.n_test * (cfg.n_epochs // cfg.eval_interval + 1)
    expected = {"mode_contraction": model.n_layers * (steps + evals),
                "mode_contraction_dx": model.n_layers * steps,
                "mode_contraction_dw": model.n_layers * steps}
    train_l2 = result["train_l2"]
    log(f"otno: {cfg.n_epochs} epochs of {cfg.n_train} steps in {run['run_s']:.1f} s (bodies "
        f"made on the host and the OT maps of {result['ot_meshes']} included; the maps "
        f"{result['ot_s']:.2f} s); final test l2 {result['test_l2']:.6f} (bound "
        f"{2 * OTNO_JAX}); train l2 by epoch {[round(v, 5) for v in train_l2]}; launches "
        f"{run['launches']}; peak {run['peak_mib']:.0f} MiB")
    bad = [v for v in [result["test_l2"], *train_l2] if not math.isfinite(v)]
    if bad or not result["test_l2"] <= 2 * OTNO_JAX or not train_l2[-1] < train_l2[0]:
        raise AssertionError(f"otno: non-finite figures {bad}, test l2 {result['test_l2']} "
                             f"above twice the JAX script's, or a training loss that did not "
                             f"fall {train_l2}")
    if run["launches"] != expected:
        raise AssertionError(f"otno: launched {run['launches']}, expected {expected}")

    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        host = totno.main([*OTNO_CUT_FLAGS, "--device", "cpu"])
    host_s = time.perf_counter() - t1
    figures = [result["test_l2"], *result["evals"].values(), *train_l2]
    host_figures = [host["test_l2"], *host["evals"].values(), *host["train_l2"]]
    host_err = max(abs(a - b) / abs(b) for a, b in zip(figures, host_figures))
    log(f"otno: the script on the CPU from the same init in {host_s:.1f} s (its OT maps "
        f"{host['ot_s']:.2f} s): test l2 {host['test_l2']:.6f}; card vs CPU, figures and epoch "
        f"losses, worst rel {host_err:.3e} (bound {OTNO_CPU_TOL:.0e})")
    if not host_err <= OTNO_CPU_TOL:
        raise AssertionError(f"otno: card and CPU runs differ: {figures} against {host_figures}")

    l2 = LpLoss(d=1)
    x, ind, y = totno.prep(load_synthetic_cfd(1)[0], cfg, "cuda")

    def loss_of(m, device):
        return l2(m(x.to(device), ind.to(device))[None], y.to(device)[None])

    step_check = card_against_cpu_step(
        model, lambda: totno.build_model(cfg, device="meta").to_empty(device="cpu"), loss_of,
        "OTNO step", phase="otno")
    maps = ot_maps_against_numpy()
    step = loop_step(model, lambda m: loss_of(m, "cuda"))
    step_ms = steps_ms(step, OTNO_TIMED_STEPS)
    reset_launches()
    profile = profile_window(f"{OTNO_PROFILE_STEPS} OTNO loop steps",
                             lambda: [step() for _ in range(OTNO_PROFILE_STEPS)])
    per_step = {k: v / OTNO_PROFILE_STEPS for k, v in read_launches().items()}
    log(f"otno: loop step {step_ms:.3f} ms (host clock, {OTNO_TIMED_STEPS} steps after the "
        f"run); K1-K3 launches a step {per_step}")
    second = part2(model)
    phase_s = time.perf_counter() - t0
    log(f"otno: phase in {phase_s:.1f} s; launches {run['launches']}")
    return {"launches": run["launches"], "launches_by_dtype": run["launches_by_dtype"],
            "result": result, "run_s": run["run_s"], "peak_mib": run["peak_mib"],
            "cpu_run": {"test_l2": host["test_l2"], "rel_err": host_err, "s": host_s,
                        "ot_s": host["ot_s"]},
            "step_check": step_check, "ot_maps": maps, "step_ms": step_ms,
            "profile": profile, "part2": second, "phase_s": phase_s}


def patched_processor():
    """The patched recipe's data processor: the published normalizers inside
    an MGPatchingDataProcessor of one level at the recipe's padding."""
    from neuraloperator_tpu_torch.data.transforms import (
        MGPatchingDataProcessor,
        load_data_processor,
    )

    dp = load_data_processor(FLAGSHIP)
    return MGPatchingDataProcessor(levels=1, padding_fraction=0.078125,
                                   in_normalizer=dp.in_normalizer,
                                   out_normalizer=dp.out_normalizer)


def seeded_flagship(device: str, seed: int, **init_kwargs):
    """The flagship FNO with ``init_kwargs`` on top, its weights drawn on the
    host from ``seed`` and then placed on ``device``."""
    from neuraloperator_tpu_torch.models import model_from_metadata

    meta = flagship_meta()
    meta["init_kwargs"].update(init_kwargs)
    model = model_from_metadata(meta, device="cpu", generator=torch.Generator().manual_seed(seed))
    return model.to(device)


def patched_recipe(recipe_run: dict) -> dict:
    """(24a) the patched recipe through train_navier_stokes: graphed epochs,
    then one on the loader loop resumed from their saved state; launches,
    figures, step ms, peak memory and the idle share of graphed steps."""
    n_layers = flagship_meta()["init_kwargs"]["n_layers"]
    steps_per_epoch = RECIPE_PAIRS // TRAIN_BATCH
    eval_batches = PATCH_TEST_PAIRS // EVAL_BATCH
    save_dir = Path(tempfile.mkdtemp(prefix="patched-"))
    evals: list = []
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        tee = Tee(sys.stdout)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            graphed = run_recipe_entry_point(
                [*PATCH_FLAGS, "--opt.n_epochs", str(PATCH_EPOCHS), "--device_dataset", "true",
                 "--save_dir", str(save_dir), "--save_every", str(PATCH_EPOCHS)], evals)
        graphed_s = time.perf_counter() - t0
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        n_graphed = len(evals)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            loop = run_recipe_entry_point(
                [*PATCH_FLAGS, "--opt.n_epochs", str(PATCH_EPOCHS + 1), "--device_dataset",
                 "false", "--resume_from_dir", str(save_dir), "--save_dir", str(save_dir)],
                evals)
        loop_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches, by_dtype = read_launches(), read_launches_by_dtype()
        only_dtype(by_dtype, "float32")
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    resumed_at = evals[-1][0].start_epoch
    staged = evals[0][0].staged_step
    if staged is None or staged.graph is None:
        raise AssertionError("patching: the staged step was not captured as a CUDA graph")
    order = torch.arange(PATCH_PROFILE_STEPS * TRAIN_BATCH, device="cuda").reshape(
        PATCH_PROFILE_STEPS, TRAIN_BATCH)

    def replays():
        for i in range(PATCH_PROFILE_STEPS):
            staged(order[i])

    replays()  # warm
    profile = profile_window(f"{PATCH_PROFILE_STEPS} graphed patched steps of {PATCH_BATCH} "
                             f"patches", replays)
    figures = [m for _, m in evals]
    del staged, evals
    train_errs = [float(v) for v in re.findall(r"train=([0-9.eE+-]+)", tee.text())]
    steps = (PATCH_EPOCHS + 1) * steps_per_epoch
    expected = {"mode_contraction": n_layers * (steps + len(figures) * eval_batches),
                "mode_contraction_dx": n_layers * steps,
                "mode_contraction_dw": n_layers * steps}
    step_ms = {"graphed": 1e3 * graphed["epoch_time"] / steps_per_epoch,
               "loop": 1e3 * loop["epoch_time"] / steps_per_epoch,
               "unpatched_graphed": recipe_run["step_ms"]["graphed"],
               "unpatched_loop": recipe_run["step_ms"]["loop"]}
    log(f"patching: {PATCH_EPOCHS} graphed epochs of {steps_per_epoch} steps ({PATCH_BATCH} "
        f"patches of 84² a step) in {graphed_s:.1f} s, {n_graphed} evaluations of "
        f"{PATCH_TEST_PAIRS} pairs ({PATCH_EVAL_BATCH} patches a batch), final {graphed}; the "
        f"loop epoch, resumed at epoch {resumed_at}, in {loop_s:.1f} s, final {loop}; "
        f"train_err by epoch {train_errs}; evaluations {figures}; step ms {step_ms}; peak "
        f"{peak_mib:.0f} MiB; launches {launches}")
    values = [*train_errs, *(v for m in figures for v in m.values())]
    bad = [v for v in values if not math.isfinite(v)]
    if bad or len(train_errs) != PATCH_EPOCHS + 1 or not train_errs[-1] < train_errs[0]:
        raise AssertionError(f"patching: non-finite figures {bad} or a training loss that did "
                             f"not fall: {train_errs}")
    if resumed_at != PATCH_EPOCHS or len(figures) != PATCH_EPOCHS + 1:
        raise AssertionError(f"patching: the loop run resumed at epoch {resumed_at} after "
                             f"{len(figures)} evaluations")
    if launches != expected:
        raise AssertionError(f"patching: launched {launches}, expected {expected}")
    return {"launches": launches, "launches_by_dtype": by_dtype, "graphed": graphed,
            "loop": loop, "train_err": train_errs, "evaluations": figures, "step_ms": step_ms,
            "peak_mib": peak_mib, "profile": profile, "graphed_s": graphed_s, "loop_s": loop_s}


def train_pairs(n: int, res: int = EVAL_RES):
    """The first ``n`` training pairs of phase 5's split, (n, 1, res, res)
    numpy arrays, subsampled from 128² when ``res`` is smaller."""
    from neuraloperator_tpu_torch.data.datasets import load_pt_as_numpy, navier_stokes

    split = load_pt_as_numpy(navier_stokes.DATA_ROOT / f"nsforcing_train_{EVAL_RES}.pt")
    step = EVAL_RES // res
    return (np.ascontiguousarray(split[k][:n, None, ::step, ::step]) for k in ("x", "y"))


def patched_checks() -> dict:
    """(24b) one patched step card against CPU, the patched staged epoch
    against the loop, and patch/unpatch on the card to the bit."""
    from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
    from neuraloperator_tpu_torch.losses import H1Loss
    from neuraloperator_tpu_torch.training import Trainer, build_optimizer

    processor = patched_processor()
    x, y = train_pairs(2 * TRAIN_BATCH * PATCH_GRAPH_STEPS)
    h1 = H1Loss(d=2)

    def loss_of(m, device):
        sample = processor.preprocess({"x": torch.from_numpy(x[:1]).to(device),
                                       "y": torch.from_numpy(y[:1]).to(device)}, train=True)
        out, sample = processor.postprocess(m(sample["x"]), sample, train=True)
        return h1(out, sample["y"])

    model = seeded_flagship("cuda", SEED + 24, in_channels=2)
    step = card_against_cpu_step(model, lambda: seeded_flagship("cpu", SEED + 24,
                                                                in_channels=2),
                                 loss_of, "one patched step of 1 field (4 patches)",
                                 phase="patching")

    # the patched staged epoch as replayed CUDA graphs against the loop
    n = TRAIN_BATCH * PATCH_GRAPH_STEPS
    order = np.random.default_rng(GRAPH_SEED).permutation(n)
    runs = {}
    for staged in (True, False):
        m = seeded_flagship("cuda", SEED + 24, in_channels=2)
        loader = (DataLoader(TensorDataset(x[:n], y[:n]), TRAIN_BATCH) if staged
                  else EpochOrders(x[:n], y[:n], [order, order], TRAIN_BATCH))
        trainer = Trainer(model=m, n_epochs=1, data_processor=processor, device="cuda")
        metrics = trainer.train(loader, {}, build_optimizer(OPT, PATCH_GRAPH_STEPS),
                                training_loss=h1, device_dataset=staged,
                                shuffle_seed=GRAPH_SEED)
        torch.cuda.synchronize()
        runs[staged] = (metrics, {k: p.detach().float().cpu()
                                  for k, p in m.named_parameters()})
    (graphed, g_params), (eager, e_params) = runs[True], runs[False]
    loss_err = abs(graphed["train_err"] - eager["train_err"]) / abs(eager["train_err"])
    param_err = grad_errors(g_params, e_params)
    worst = max(param_err, key=param_err.get)
    log(f"patching: {PATCH_GRAPH_STEPS} patched steps graphed vs the loop: train_err "
        f"{graphed['train_err']:.8f} vs {eager['train_err']:.8f} (rel {loss_err:.2e}), "
        f"parameters max {param_err[worst]:.2e} ({worst}; each leaf against the larger of "
        f"its norm and 1% of the whole) (tol {GRAPH_TOL:.0e})")
    if not (loss_err <= GRAPH_TOL and param_err[worst] <= GRAPH_TOL):
        raise AssertionError(f"patching: the graphed patched step departs from the loop: "
                             f"loss {loss_err}, {worst} {param_err[worst]}")

    # patch, then unpatch the fine channel: the fields back to the bit
    patcher = processor.patcher
    xc = torch.from_numpy(x[:TRAIN_BATCH]).cuda()
    px, _ = patcher.patch(xc, xc)
    back, _ = patcher.unpatch(px[:, :1], None, evaluation=True)
    cpu_px, _ = patcher.patch(xc.cpu(), xc.cpu())
    exact = bool(torch.equal(back, xc)) and bool(torch.equal(px.cpu(), cpu_px))
    log(f"patching: patch {tuple(xc.shape)} -> {tuple(px.shape)} on the card, the fine "
        f"channel unpatched back to the fields to the bit and the patches equal to the "
        f"CPU's: {exact}")
    if not exact or tuple(px.shape) != (4 * TRAIN_BATCH, 2, 84, 84):
        raise AssertionError(f"patching: patch/unpatch on the card: {tuple(px.shape)}, {exact}")
    del model
    return {"step": step, "graph_loss_rel_err": loss_err,
            "graph_param_rel_max": param_err[worst], "patch_round_trip": exact}


def incremental_example() -> dict:
    """(24c) the incremental FNO example whole on the card, on the small
    Darcy set its loader makes on the host into a temporary ``DATA_ROOT``
    (the card run's seconds include that), its figure held to the JAX
    example's; then 5 epochs under each of INCREMENTAL_GROWTH's flags, where
    the modes grow, on the card and on the CPU."""
    from neuraloperator_tpu_torch.data.datasets import darcy as tdarcy
    from neuraloperator_tpu_torch.scripts import train_incremental_fno_darcy as inc

    runs = {}
    data_dir = Path(tempfile.mkdtemp(prefix="incremental-darcy-"))
    default_root, tdarcy.DATA_ROOT = tdarcy.DATA_ROOT, data_dir
    try:
        for label, flags in (("default", []), *INCREMENTAL_GROWTH.items()):
            for device in ("cuda",) if label == "default" else ("cuda", "cpu"):
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    runs[label, device] = inc.main(["--device", device, *flags])
                runs[label, device]["s"] = time.perf_counter() - t0
    finally:
        tdarcy.DATA_ROOT = default_root
        shutil.rmtree(data_dir, ignore_errors=True)
    card = runs["default", "cuda"]
    log(f"patching: incremental FNO example (default) on the card in {card['s']:.1f} s: "
        f"train_err {card['train_err']:.5f}, 16_l2 {card['16_l2']:.5f} (bound "
        f"{2 * INCREMENTAL_JAX:.5f}), modes by epoch {card['modes_by_epoch']}, final "
        f"{card['final_modes']}")
    if not (math.isfinite(card["train_err"]) and card["16_l2"] <= 2 * INCREMENTAL_JAX):
        raise AssertionError(f"patching: incremental example figures (default) {card}")
    result = {"default": {"card": {k: card[k] for k in ("train_err", "16_l2", "final_modes",
                                                        "s")},
                          "modes_by_epoch": card["modes_by_epoch"]}}
    for label in INCREMENTAL_GROWTH:
        card, host = runs[label, "cuda"], runs[label, "cpu"]
        err = max(abs(card[k] - host[k]) / abs(host[k]) for k in ("train_err", "16_l2"))
        log(f"patching: incremental FNO example ({label} {' '.join(INCREMENTAL_GROWTH[label])}) "
            f"on the card in {card['s']:.1f} s: train_err {card['train_err']:.5f}, 16_l2 "
            f"{card['16_l2']:.5f}, modes by epoch {card['modes_by_epoch']}, final "
            f"{card['final_modes']}; on the CPU in {host['s']:.1f} s: train_err "
            f"{host['train_err']:.5f}, 16_l2 {host['16_l2']:.5f}, modes "
            f"{host['modes_by_epoch']}, final {host['final_modes']} (figures rel {err:.2e}, "
            f"tol {INCREMENTAL_CPU_TOL:.0e})")
        if (card["modes_by_epoch"] != host["modes_by_epoch"]
                or card["final_modes"] != host["final_modes"]):
            raise AssertionError(f"patching: the incremental example's modes differ between "
                                 f"the card and the CPU ({label})")
        if not err <= INCREMENTAL_CPU_TOL:
            raise AssertionError(f"patching: incremental example ({label}) card vs CPU: "
                                 f"{card} vs {host}")
        if not card["final_modes"] > card["modes_by_epoch"][0]:
            raise AssertionError(f"patching: the modes did not grow ({label}): {card}")
        if not (math.isfinite(card["train_err"]) and math.isfinite(host["train_err"])):
            raise AssertionError(f"patching: incremental example figures ({label}) {card}, "
                                 f"{host}")
        result[label] = {
            "card": {k: card[k] for k in ("train_err", "16_l2", "final_modes", "s")},
            "cpu": {k: host[k] for k in ("train_err", "16_l2", "final_modes", "s")},
            "modes_by_epoch": card["modes_by_epoch"], "figures_rel_err": err}
    return result


class RecordingScheduler:
    """A per-epoch scheduler that records each epoch's training error and
    passes it to ``inner`` (whose ``factor`` it reports), if any."""

    needs_metric = True

    def __init__(self, inner=None):
        self.inner, self.metrics = inner, []

    @property
    def factor(self) -> float:
        return 1.0 if self.inner is None else self.inner.factor

    def step(self, metric) -> None:
        self.metrics.append(metric)
        if self.inner is not None:
            self.inner.step(metric)


def losses_card_and_cpu(label: str, transform, n_steps: int, seed: int,
                        scheduler=None) -> dict:
    """``n_steps`` Trainer steps on one batch of 2 pairs at OPTION_RES², card
    and CPU from one seeded init of the flagship over OPTION_MODES: each
    step's loss, within STEP_LOSS_TOL."""
    import copy

    from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
    from neuraloperator_tpu_torch.data.transforms import load_data_processor
    from neuraloperator_tpu_torch.losses import H1Loss
    from neuraloperator_tpu_torch.training import Trainer

    x, y = train_pairs(2, OPTION_RES)
    runs = {}
    for device in ("cuda", "cpu"):
        model = seeded_flagship(device, seed, n_modes=OPTION_MODES)
        recorder = RecordingScheduler(copy.deepcopy(scheduler))
        trainer = Trainer(model=model, n_epochs=n_steps, device=device,
                          data_processor=load_data_processor(FLAGSHIP))
        trainer.train(DataLoader(TensorDataset(x, y), 2), {}, transform,
                      scheduler=recorder, training_loss=H1Loss(d=2))
        runs[device] = (recorder.metrics, trainer.optimizer, recorder.factor)
    (card, card_opt, factor), (host, host_opt, host_factor) = runs["cuda"], runs["cpu"]
    err = max(abs(a - b) / abs(b) for a, b in zip(card, host))
    log(f"patching: {label}, {n_steps} steps card vs CPU: losses {[f'{v:.7f}' for v in card]} "
        f"vs {[f'{v:.7f}' for v in host]} (worst rel {err:.2e}, tol {STEP_LOSS_TOL:.0e}); "
        f"epoch factor {factor} / {host_factor}")
    if not (err <= STEP_LOSS_TOL and factor == host_factor and len(card) == n_steps):
        raise AssertionError(f"patching: {label}: card and CPU differ: {card} vs {host}")
    return {"losses": card, "cpu_losses": host, "rel_err": err, "factor": factor,
            "card_opt": card_opt, "cpu_opt": host_opt}


def galore_transform():
    from neuraloperator_tpu_torch.training import step_lr, tensor_galore_adamw

    return tensor_galore_adamw(step_lr(3e-5, 50, 0.5, 1), rank=GALORE_RANK,
                               update_proj_gap=GALORE_GAP, weight_decay=1e-4)


def galore_updates(transform, seed: int) -> dict:
    """GaLore's steps in lockstep: before each step the CPU takes the card's
    parameters and optimizer state, both take the step on the same batch,
    and each leaf's update is held to GALORE_UPDATE_TOL, card against CPU.
    A projected leaf past it is a known difference where the step's gradient
    (the CPU's, in float64) has singular values below GALORE_VANISH of its
    largest among those its factor keeps; any other leaf past it fails."""
    from neuraloperator_tpu_torch.data.transforms import load_data_processor
    from neuraloperator_tpu_torch.losses import H1Loss
    from neuraloperator_tpu_torch.training.tensor_galore import _unfold

    x, y = train_pairs(2, OPTION_RES)
    processor, h1 = load_data_processor(FLAGSHIP), H1Loss(d=2)
    models = {d: seeded_flagship(d, seed, n_modes=OPTION_MODES) for d in ("cuda", "cpu")}
    opts = {d: transform.bind(m.named_parameters()) for d, m in models.items()}
    steps = []
    for step in range(GALORE_STEPS):
        with torch.no_grad():
            for p, q in zip(models["cuda"].parameters(), models["cpu"].parameters()):
                q.copy_(p)
        opts["cpu"].load_state_dict(opts["cuda"].state_dict())
        before = {k: p.detach().double().cpu() for k, p in models["cuda"].named_parameters()}
        for device, model in models.items():
            model.train()
            opts[device].zero_grad(set_to_none=True)
            sample = processor.preprocess({"x": torch.from_numpy(x).to(device),
                                           "y": torch.from_numpy(y).to(device)}, train=True)
            out, sample = processor.postprocess(model(sample["x"]), sample, train=True)
            h1(out, sample["y"]).backward()
            opts[device].step()
        update = {d: {k: p.detach().double().cpu() - before[k]
                      for k, p in m.named_parameters()} for d, m in models.items()}
        err = grad_errors(update["cuda"], update["cpu"])
        opt, spectra = opts["cpu"], {}
        for name, p in zip(opt.names, opt.param_groups[0]["params"]):
            for mode, u in enumerate(opt.state[p]["factors"]):
                if u.shape[1] < p.shape[mode]:  # a factor from the SVD, not the identity
                    s = torch.linalg.svdvals(_unfold(p.grad.double(), mode))
                    kept = s[:u.shape[1]] / s[0]
                    spectra.setdefault(name, []).append(
                        {"mode": mode, "kept": u.shape[1], "smallest_kept": float(kept[-1]),
                         "vanishing": int((kept < GALORE_VANISH).sum())})
        known = {n: {"update_rel_err": e, "spectra": spectra[n]} for n, e in err.items()
                 if e > GALORE_UPDATE_TOL and any(m["vanishing"] for m in spectra.get(n, ()))}
        others = {n: e for n, e in err.items() if n not in known}
        worst = max(others, key=others.get)
        refresh = step % GALORE_GAP == 0
        log(f"patching: GaLore step {step + 1}{' (a refresh)' if refresh else ''} from the "
            f"card's state, card vs CPU, each leaf's update against the larger of its norm "
            f"and 1% of the whole: max {others[worst]:.2e} ({worst}, tol "
            f"{GALORE_UPDATE_TOL:.0e}) over {len(others)} leaves; known differences (kept "
            f"singular values below {GALORE_VANISH:.0e} of the largest): {known}")
        if not others[worst] <= GALORE_UPDATE_TOL:
            raise AssertionError(f"patching: GaLore's update of {worst} at step {step + 1} "
                                 f"differs between the card and the CPU: {others[worst]}")
        steps.append({"refresh": refresh, "update_rel_max": others[worst],
                      "update_worst": worst, "known_differences": known})
    return steps


def galore_and_options() -> dict:
    """(24d) Tensor-GaLore and the optimizer options, card against CPU."""
    from neuraloperator_tpu_torch.training import (
        ReduceLROnPlateau,
        adamw,
        reduce_on_plateau,
        step_lr,
    )

    galore = losses_card_and_cpu(
        f"Tensor-GaLore (rank {GALORE_RANK}, a refresh every {GALORE_GAP} steps)",
        galore_transform(), GALORE_STEPS, SEED + 25)
    opt = galore["card_opt"]
    factored = [n for n, p in zip(opt.names, opt.param_groups[0]["params"])
                if opt.state[p]["factors"]]
    # the factors of the second refresh, card against CPU (signs fixed on both;
    # logged: where singular values nearly tie, the two SVDs pick other bases)
    factor_err = {}
    for name, p, q in zip(opt.names, opt.param_groups[0]["params"],
                          galore["cpu_opt"].param_groups[0]["params"]):
        for k, (a, b) in enumerate(zip(opt.state[p]["factors"],
                                       galore["cpu_opt"].state[q]["factors"])):
            factor_err[f"{name}.{k}"] = float((a.cpu().double() - b.double()).norm()
                                              / b.double().norm())
    worst = max(factor_err, key=factor_err.get)
    log(f"patching: GaLore projected {len(factored)} leaves ({factored[:4]} ...); factors of "
        f"the last refresh card vs CPU, rel_l2 max {factor_err[worst]:.2e} ({worst}), median "
        f"{float(np.median(list(factor_err.values()))):.2e}")
    galore["updates"] = galore_updates(galore_transform(), SEED + 25)
    base = dict(learning_rate=step_lr(3e-5, 50, 0.5, 1), weight_decay=1e-4,
                factored_second_moment=True, mu_dtype=torch.bfloat16)
    options = {}
    options["max_grad_norm"] = losses_card_and_cpu(
        "AdamW with max_grad_norm 0.01 (every step clipped)", adamw(**base, max_grad_norm=0.01),
        OPTION_STEPS, SEED + 26)
    options["ReduceLROnPlateau"] = losses_card_and_cpu(
        "ReduceLROnPlateau(patience 0, threshold 0.5): the third epoch at half rate, the "
        "factor 0.25 after it",
        adamw(**base), OPTION_STEPS, SEED + 26,
        scheduler=ReduceLROnPlateau(factor=0.5, patience=0, threshold=0.5))
    options["reduce_on_plateau"] = losses_card_and_cpu(
        "reduce_on_plateau(patience 1, rtol 0.5): the second step's update halved, the "
        "third's quartered",
        reduce_on_plateau(adamw(**base), factor=0.5, patience=1, rtol=0.5),
        OPTION_STEPS, SEED + 26)
    scales = [float(r["card_opt"].plateau_state["scale"]) for r in
              (options["reduce_on_plateau"],)] + [float(
                  options["reduce_on_plateau"]["cpu_opt"].plateau_state["scale"])]
    if options["ReduceLROnPlateau"]["factor"] != 0.25 or scales != [0.25, 0.25]:
        raise AssertionError(f"patching: plateau factors {options['ReduceLROnPlateau']['factor']}"
                             f", scales {scales}")
    strip = ("card_opt", "cpu_opt")
    return {"galore": {**{k: v for k, v in galore.items() if k not in strip},
                       "projected_leaves": len(factored),
                       "factor_rel_l2_max": max(factor_err.values())},
            "options": {n: {k: v for k, v in r.items() if k not in strip}
                        for n, r in options.items()}}


@torch.no_grad()
def throughput_meter(model, x) -> dict:
    """``ThroughputMeter`` over METER_FORWARDS forwards after one of warm-up:
    its ms a forward within METER_TOL of CUDA events' over the same span,
    which it matches only if it waits for the card before reading the clock
    (its launches alone take a fraction of that)."""
    from neuraloperator_tpu_torch.training import ThroughputMeter

    meter = ThroughputMeter(warmup_steps=1)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    model(x)
    meter.step(len(x))  # the end of the warm-up: the clock starts once the card is idle
    start.record()
    for _ in range(METER_FORWARDS):
        model(x)
        meter.step(len(x))
    end.record()
    meter_ms = 1e3 / meter.steps_per_sec
    samples_per_s = meter.samples_per_sec
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / METER_FORWARDS
    rel = abs(meter_ms - event_ms) / event_ms
    log(f"patching: ThroughputMeter over {METER_FORWARDS} forwards of {len(x)} fields: "
        f"{meter_ms:.3f} ms a forward ({samples_per_s:.1f} samples/s), CUDA events "
        f"{event_ms:.3f} ms (rel {rel:.2e}, tol {METER_TOL})")
    if not rel <= METER_TOL:
        raise AssertionError(f"patching: ThroughputMeter {meter_ms} ms vs events {event_ms} ms")
    return {"meter_ms": meter_ms, "event_ms": event_ms, "samples_per_s": samples_per_s}


def prefetch_trace_compress() -> dict:
    """(24e) PrefetchLoader against the plain loader, ThroughputMeter against
    CUDA events, a trace naming K1, and compress_checkpoint on the published
    weights."""
    from neuraloperator_tpu_torch.data.datasets import DataLoader, PrefetchLoader, TensorDataset
    from neuraloperator_tpu_torch.scripts import compress_checkpoint
    from neuraloperator_tpu_torch.serialization import read_msgpack, write_msgpack
    from neuraloperator_tpu_torch.training import trace

    x, y = train_pairs(4 * TRAIN_BATCH)
    plain = DataLoader(TensorDataset(x, y), TRAIN_BATCH, shuffle=True, seed=SEED)
    pre = PrefetchLoader(DataLoader(TensorDataset(x, y), TRAIN_BATCH, shuffle=True, seed=SEED))
    same = True
    for _ in range(2):
        got, want = list(pre), list(plain)
        same &= len(got) == len(want) == len(plain)
        for a, b in zip(got, want):
            same &= all(a[k].is_cuda and np.array_equal(a[k].cpu().numpy(), b[k]) for k in b)
    log(f"patching: PrefetchLoader over 2 epochs of {len(plain)} batches, the plain loader's "
        f"batches on the card to the bit: {same}")
    if not same:
        raise AssertionError("patching: PrefetchLoader's batches differ from the loader's")

    model = seeded_flagship("cuda", SEED + 27, n_modes=OPTION_MODES)
    meter = throughput_meter(model, torch.from_numpy(x[:TRAIN_BATCH]).cuda())
    with tempfile.TemporaryDirectory(prefix="trace-") as tmp:
        with trace(tmp):
            with torch.no_grad():
                model(torch.from_numpy(x[:2]).cuda())
        text = (Path(tmp) / "trace.json").read_text()
    named = "channel_contraction_kernel" in text
    log(f"patching: profiling.trace of one forward: trace.json of {len(text) / 1e6:.1f} MB, "
        f"names K1 (channel_contraction_kernel): {named}")
    if not named:
        raise AssertionError("patching: the trace does not name K1")
    del model

    results = {}
    with tempfile.TemporaryDirectory(prefix="compress-") as tmp:
        tree = read_msgpack(FLAGSHIP / f"{CHECKPOINT}.msgpack")

        def expand(t):
            if isinstance(t, dict):
                return {k: expand(v) for k, v in t.items()}
            return np.asarray(t, np.float32) if isinstance(t, np.ndarray) else t

        write_msgpack(Path(tmp) / "best_model.msgpack", expand(tree))
        shutil.copy(FLAGSHIP / "model_metadata.json", Path(tmp) / "best_model_metadata.json")
        for key, dtype, device in (("f16", "f16", "cuda"), ("bf16", "bf16", "cuda"),
                                   ("bf16_cpu", "bf16", "cpu")):
            with contextlib.redirect_stdout(io.StringIO()):
                results[key] = compress_checkpoint.main(
                    ["--dir", tmp, "--name", "best_model", "--dtype", dtype,
                     "--spatial", str(EVAL_RES), "--batch", "2", "--device", device])
        round_trip = ((Path(tmp) / "best_model_f16.msgpack").read_bytes()
                      == (FLAGSHIP / f"{CHECKPOINT}.msgpack").read_bytes())
    bf16, bf16_cpu = (results[k]["eval_rel_l2_bf16_vs_f32"] for k in ("bf16", "bf16_cpu"))
    log(f"patching: compress_checkpoint of the published weights' f32 expansion: f16 "
        f"{results['f16']['out_bytes']} bytes, byte for byte {CHECKPOINT}.msgpack: "
        f"{round_trip}, eval rel_l2 {results['f16']['eval_rel_l2_f16_vs_f32']:.2e}; bf16 "
        f"{results['bf16']['out_bytes']} bytes, eval rel_l2 {bf16:.4e} on the card, "
        f"{bf16_cpu:.4e} on the CPU")
    # f16 -> f32 -> f16 is exact, so both forwards run the same weights; the
    # bf16 figure is the distance between two forwards, each a few f32 ulps
    # from the other device's, so the card's within 1e-3 of the CPU's
    if not (round_trip and results["f16"]["eval_rel_l2_f16_vs_f32"] <= 1e-7
            and bf16 > 0 and abs(bf16 - bf16_cpu) <= 1e-3 * bf16_cpu):
        raise AssertionError(f"patching: compress_checkpoint: {results}, f16 round trip "
                             f"{round_trip}")
    return {"prefetch_same": same, "meter": meter, "trace_names_k1": named,
            "compress": results}


def patching(recipe_run: dict) -> dict:
    """(24) the patched recipe (24a; the path's launches), then the checks
    and the rest of the training and data modules (24b-24e)."""
    t0 = time.perf_counter()
    run = patched_recipe(recipe_run)
    checks = patched_checks()
    incremental = incremental_example()
    optimizers = galore_and_options()
    extras = prefetch_trace_compress()
    phase_s = time.perf_counter() - t0
    log(f"patching: phase in {phase_s:.1f} s; launches {run['launches']}")
    return {**run, "checks": checks, "incremental": incremental, **optimizers, **extras,
            "phase_s": phase_s}


def well_trajectories(n: int, length: int, seed: int):
    """``n`` trajectories of ``length`` steps at WELL_RES³ in the_well's layout
    (n, length, res, res, res, 3), made by train_mhd64's synthetic fields
    (a band-limited first step and its diffused second) and its diffusion
    step after them; one constant field each (n, res, res, res, 1), a
    band-limited scalar of the same generator."""
    from neuraloperator_tpu_torch.scripts import train_mhd64 as tmhd

    first, second = tmhd._synthetic_mhd(n, WELL_RES, seed=seed)
    steps = [first, second]
    while len(steps) < length:
        steps.append(np.stack([tmhd.diffuse(u) for u in steps[-1]]).astype(np.float32))
    fields = np.moveaxis(np.stack(steps[:length], axis=1), 2, -1)
    constants = np.moveaxis(tmhd._synthetic_mhd(n, WELL_RES, seed=seed + 1)[0][:, :1], 1, -1)
    return np.ascontiguousarray(fields), np.ascontiguousarray(constants)


def well_model(device: str, channels: int):
    """train_mhd64's FNO-3D (MHDConfig: n_modes 8³, hidden 16) taking the
    ``channels`` the processor lays out, its weights seeded."""
    from neuraloperator_tpu_torch.models import get_model
    from neuraloperator_tpu_torch.scripts import train_mhd64 as tmhd

    cfg = tmhd.MHDConfig()
    cfg.model.data_channels = channels
    return get_model(cfg.to_dict(), device=device,
                     generator=torch.Generator().manual_seed(SEED + 60))


def well() -> dict:
    """(26) the_well's schema on the card (see the module docstring)."""
    from neuraloperator_tpu_torch.data.datasets import DataLoader, DictDataset
    from neuraloperator_tpu_torch.data.transforms import (
        TheWellDataProcessor,
        UnitGaussianNormalizer,
    )
    from neuraloperator_tpu_torch.losses import H1Loss, LpLoss
    from neuraloperator_tpu_torch.ops import spectral_contraction as tsc
    from neuraloperator_tpu_torch.scripts import train_mhd64 as tmhd
    from neuraloperator_tpu_torch.training import Trainer, adamw, build_optimizer, step_lr

    t0 = time.perf_counter()
    n_in, c = WELL_STEPS_IN, 3
    train_f, train_c = well_trajectories(WELL_TRAIN_TRAJ, n_in + WELL_WINDOWS, SEED + 61)
    test_f, test_c = well_trajectories(WELL_TEST_TRAJ, n_in + WELL_ROLLOUT, SEED + 62)
    windows = [{"input_fields": train_f[i, t:t + n_in],
                "output_fields": train_f[i, t + n_in:t + n_in + 1],
                "constant_fields": train_c[i]}
               for i in range(WELL_TRAIN_TRAJ) for t in range(WELL_WINDOWS)]
    trajectories = [{"output_fields": test_f[i], "constant_fields": test_c[i]}
                    for i in range(WELL_TEST_TRAJ)]
    # channel-wise statistics of the training fields on (b, c, t, spatial)
    data_norm = UnitGaussianNormalizer(dim=[0, 2, 3, 4, 5]).fit(np.moveaxis(train_f, -1, 1))
    const_norm = UnitGaussianNormalizer(dim=[0, 2, 3, 4]).fit(np.moveaxis(train_c, -1, 1))
    processor = TheWellDataProcessor(data_normalizer=data_norm, const_normalizer=const_norm,
                                     n_steps_input=n_in, n_steps_rollout=WELL_ROLLOUT)
    channels = n_in * c + 1
    data_s = time.perf_counter() - t0
    cfg = tmhd.MHDConfig()
    model = well_model("cuda", channels)
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    steps = len(windows) // WELL_BATCH
    evals = WELL_ROLLOUT * math.ceil(WELL_TEST_TRAJ / WELL_BATCH)
    transform = adamw(step_lr(cfg.opt.learning_rate, cfg.opt.step_size, cfg.opt.gamma, steps),
                      weight_decay=cfg.opt.weight_decay)
    h1, l2 = H1Loss(d=3), LpLoss(d=3, p=2)
    record = RecordingScheduler()
    trainer = Trainer(model=model, n_epochs=WELL_EPOCHS, data_processor=processor,
                      device="cuda", eval_interval=WELL_EPOCHS)
    shapes, launch = set(), tsc._launch

    def recording(kind, a, b, out_shape, dims):
        shapes.add((kind, tuple(dims)))
        return launch(kind, a, b, out_shape, dims)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tsc._launch = recording
    try:
        t1 = time.perf_counter()
        metrics = trainer.train(DataLoader(DictDataset(windows), WELL_BATCH, shuffle=True), {},
                                transform, scheduler=record, training_loss=h1)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        rollout = trainer.evaluate(None, DataLoader(DictDataset(trajectories), WELL_BATCH),
                                   "well", mode="autoregression",
                                   eval_losses={"h1": h1, "l2": l2})
        torch.cuda.synchronize()
        rollout_s = time.perf_counter() - t1
    finally:
        tsc._launch = launch
    launches, by_dtype = read_launches(), read_launches_by_dtype()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    step_ms = 1e3 * metrics["epoch_time"] / steps
    only_dtype(by_dtype, "float32")
    layers = cfg.model.n_layers
    M = math.prod(cfg.model.n_modes[:-1]) * (cfg.model.n_modes[-1] // 2 + 1)
    hidden = cfg.model.hidden_channels
    want_shapes = {(kind, (WELL_BATCH, hidden, hidden, M)) for kind in ("fwd", "dx", "dw")}
    expected = {"mode_contraction": layers * (WELL_EPOCHS * steps + evals),
                "mode_contraction_dx": layers * WELL_EPOCHS * steps,
                "mode_contraction_dw": layers * WELL_EPOCHS * steps}
    log(f"well: {len(windows)} windows of {WELL_TRAIN_TRAJ} trajectories ({n_in} input steps, "
        f"time as channels, one constant field: {channels} channels) and {WELL_TEST_TRAJ} "
        f"trajectories of {n_in + WELL_ROLLOUT} steps at {WELL_RES}³ made in {data_s:.1f} s; "
        f"{WELL_EPOCHS} epochs of {steps} loop steps in {train_s:.1f} s: train losses "
        f"{record.metrics}, {step_ms:.3f} ms a step (last epoch); the rollout of "
        f"{WELL_ROLLOUT} steps in {rollout_s:.2f} s: {rollout} (horizon "
        f"{trainer._last_rollout_T}); launches {launches} at {sorted(shapes)}; peak "
        f"{peak_mib:.0f} MiB")
    values = [*record.metrics, *rollout.values()]
    if not (all(map(math.isfinite, values)) and len(record.metrics) == WELL_EPOCHS
            and record.metrics[-1] < record.metrics[0]
            and trainer._last_rollout_T == WELL_ROLLOUT):
        raise AssertionError(f"well: non-finite or not falling: {record.metrics}, {rollout}")
    if launches != expected or shapes != want_shapes:
        raise AssertionError(f"well: launched {launches} at {sorted(shapes)}, expected "
                             f"{expected} at {sorted(want_shapes)}")

    # one step and one rolled-out batch, card against CPU from the same
    # weights: the step from the seeded init, the rollout from the trained
    trained = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    window = {k: np.stack([w[k] for w in windows[:WELL_BATCH]]) for k in windows[0]}
    test = {k: np.stack([t[k] for t in trajectories[:WELL_BATCH]]) for k in trajectories[0]}

    def on(device, weights):
        m = well_model(device, channels)
        m.load_state_dict(weights)
        return m, Trainer(model=m, n_epochs=1, data_processor=processor, device=device)

    t1 = time.perf_counter()
    found = {}
    for device in ("cuda", "cpu"):
        m, tr = on(device, state)
        loss = tr.train([window], {}, build_optimizer(OPT, 1), training_loss=h1)["train_err"]
        grads = {n: p.grad.detach().float().cpu() for n, p in m.named_parameters()}
        m, tr = on(device, trained)
        found[device] = (loss, grads, tr.evaluate(None, [test], "well", mode="autoregression",
                                                  eval_losses={"h1": h1, "l2": l2}))
    (loss_gpu, grads_gpu, roll_gpu), (loss_cpu, grads_cpu, roll_cpu) = found["cuda"], found["cpu"]
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    grad_err = grad_errors(grads_gpu, grads_cpu)
    worst = max(grad_err, key=grad_err.get)
    roll_err = {k: abs(roll_gpu[k] - v) / abs(v) for k, v in roll_cpu.items()}
    log(f"well: card vs CPU in {time.perf_counter() - t1:.1f} s: one step of batch "
        f"{WELL_BATCH}: loss rel {loss_err:.2e} (tol {STEP_LOSS_TOL:.0e}), gradients max "
        f"{grad_err[worst]:.2e} ({worst}, tol {STEP_GRAD_TOL:.0e}); one rolled-out batch of "
        f"{WELL_ROLLOUT} steps from the trained weights: {roll_gpu} vs {roll_cpu} (rel "
        f"{roll_err}, tol {WELL_ROLLOUT_TOL:.0e})")
    if not (loss_err <= STEP_LOSS_TOL and grad_err[worst] <= STEP_GRAD_TOL
            and max(roll_err.values()) <= WELL_ROLLOUT_TOL):
        raise AssertionError(f"well: card and CPU differ: loss {loss_err}, gradients "
                             f"{grad_err[worst]} ({worst}), rollout {roll_err}")
    profiled = profile_window(
        f"well: {WELL_PROFILE_STEPS} loop steps of batch {WELL_BATCH} at {WELL_RES}³",
        lambda: Trainer(model=model, n_epochs=1, data_processor=processor, device="cuda").train(
            DataLoader(DictDataset(windows[:WELL_PROFILE_STEPS * WELL_BATCH]), WELL_BATCH), {},
            transform, training_loss=h1))
    idle = 1 - profiled["device_ms"] / profiled["wall_ms"] if "device_ms" in profiled else None
    phase_s = time.perf_counter() - t0
    log(f"well: phase in {phase_s:.1f} s; step {step_ms:.3f} ms, idle share "
        f"{'not measured' if idle is None else f'{idle:.1%}'}, peak {peak_mib:.0f} MiB, the "
        f"rollout {rollout_s:.2f} s")
    return {"launches": launches, "launches_by_dtype": by_dtype, "train_errs": record.metrics,
            "rollout": rollout, "rollout_s": rollout_s, "step_ms": step_ms, "idle": idle,
            "peak_mib": peak_mib, "step_loss_rel_err": loss_err,
            "step_grad_rel_l2_max": grad_err[worst], "rollout_rel_err": roll_err,
            "phase_s": phase_s}


def dist_script_run(label: str, flags: list, zero: bool = False) -> dict:
    """(25a/b) one train_navier_stokes run on the loader loop: its metrics,
    the trained parameters, the launches, the step ms and the peak memory;
    ``zero`` builds its Trainer with ``zero_sharding=True``."""
    from neuraloperator_tpu_torch.training import Trainer

    init = Trainer.__init__

    def with_zero(self, *args, **kwargs):
        init(self, *args, **{**kwargs, "zero_sharding": True})

    record: list = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    if zero:
        Trainer.__init__ = with_zero
    try:
        final = run_recipe_entry_point([*DIST_FLAGS, *flags], record)
    finally:
        Trainer.__init__ = init
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    trainer = record[-1][0]
    steps = DIST_PAIRS // TRAIN_BATCH
    out = {"metrics": final, "run_s": run_s, "steps": steps,
           "step_ms": 1e3 * final["epoch_time"] / steps,
           "launches": read_launches(), "launches_by_dtype": read_launches_by_dtype(),
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
           "optimizer": type(trainer.optimizer).__name__,
           "mesh": None if trainer.mesh is None else repr(trainer.mesh),
           "params": {n: p.detach().cpu() for n, p in trainer.model.named_parameters()}}
    log(f"distribution: {label}: {steps} loop steps and an evaluation of {DIST_TESTS} pairs "
        f"in {run_s:.1f} s, step {out['step_ms']:.3f} ms, metrics {final}, optimizer "
        f"{out['optimizer']}, mesh {out['mesh']}, launches {out['launches']}, peak "
        f"{out['peak_mib']:.0f} MiB")
    return out


def dist_rank_step(rank: int, world: int, x, y, state, loss_one, grads_one) -> dict:
    """(25c) one rank of two on the card: one data-parallel step of the
    flagship from ``state`` on its 4 of the 8 rows, replicated and under
    ZeRO, held here to one rank's step on the 8 rows (``loss_one``,
    ``grads_one``) and to each other; then the step's ms over
    DIST_TIMED_STEPS more steps, and the peak memory of each."""
    from neuraloperator_tpu_torch.data.transforms import load_data_processor
    from neuraloperator_tpu_torch.losses import H1Loss
    from neuraloperator_tpu_torch.models import model_from_metadata
    from neuraloperator_tpu_torch.parallel import mesh as mesh_lib
    from neuraloperator_tpu_torch.training import Trainer, build_optimizer

    started = time.time()
    torch.cuda.set_device(0)
    mesh = mesh_lib.init(1, device="cuda")
    processor = load_data_processor(FLAGSHIP)
    model = model_from_metadata(flagship_meta(), device="cuda")
    out = {"backend": torch.distributed.get_backend(), "mesh": repr(mesh), "started": started}
    runs = {}
    for zero in (False, True):
        model.load_state_dict(state)
        trainer = Trainer(model=model, n_epochs=1, data_processor=processor, device="cuda",
                          mesh=mesh, zero_sharding=zero)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        metrics = trainer.train([{"x": x, "y": y}], {}, build_optimizer(OPT, 1),
                                training_loss=H1Loss(d=2))
        torch.cuda.synchronize()
        runs[zero] = {"loss": metrics["train_err"], "launches": read_launches(),
                      "optimizer": type(trainer.optimizer).__name__,
                      "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                      "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                      "params": {n: p.detach().cpu() for n, p in model.named_parameters()}}
        if not zero:
            timed = trainer.train([{"x": x, "y": y}] * DIST_TIMED_STEPS, {},
                                  build_optimizer(OPT, DIST_TIMED_STEPS),
                                  training_loss=H1Loss(d=2))
            out["step_ms"] = 1e3 * timed["epoch_time"] / DIST_TIMED_STEPS
    rep, cut = runs[False], runs[True]
    errs = grad_errors(rep["grads"], grads_one)
    worst = max(errs, key=errs.get)
    out.update(loss_rel_err=abs(rep["loss"] - loss_one) / abs(loss_one),
               grad_err_max=errs[worst], grad_worst=worst, peak_mib=rep["peak_mib"],
               zero_peak_mib=cut["peak_mib"], launches=rep["launches"],
               zero_launches=cut["launches"], zero_optimizer=cut["optimizer"],
               zero_loss_equal=cut["loss"] == rep["loss"],
               zero_unequal=[n for n, p in rep["params"].items()
                             if not torch.equal(p, cut["params"][n])],
               work_s=time.time() - started)
    return out


def _device_memory(device: torch.device, reset: bool = False) -> tuple:
    """(peak, resident) of this process's allocations on ``device`` in MiB
    (after a synchronize), the peak reset after reading when ``reset``;
    zeros on the CPU (the rehearsal of the rank functions)."""
    if device.type != "cuda":
        return 0.0, 0.0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return peak, torch.cuda.memory_allocated() / 2**20


def dist_model_rank(rank: int, world: int, meta: dict, device: str, x, y, state, loss_one,
                    grads_one, save_root: str) -> dict:
    """(25d) one rank of two at mesh (data 1, model 2): the model built from
    ``meta`` with ``state``, whole and then sharded by the Trainer, one step
    on the 8 rows each (the whole one is this process's baseline peak); the
    sharded step's loss and gathered gradients against one rank's whole step
    (``loss_one``, ``grads_one``), its launches and their shapes, the
    spectral values this rank holds, DIST_TIMED_STEPS timed steps; then the
    resume check through the orbax counterpart (async) and a msgpack save
    at model size 2 under ``save_root``. ``device`` is "cuda" on the card."""
    import gc

    from neuraloperator_tpu_torch.data.transforms import load_data_processor
    from neuraloperator_tpu_torch.losses import H1Loss
    from neuraloperator_tpu_torch.models import model_from_metadata
    from neuraloperator_tpu_torch.ops import spectral_contraction as tsc
    from neuraloperator_tpu_torch.parallel import mesh as mesh_lib
    from neuraloperator_tpu_torch.training import (
        Trainer,
        build_optimizer,
        load_training_state_orbax,
        save_training_state,
        save_training_state_orbax,
    )

    started = time.time()
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(0)
        device = torch.device("cuda", 0)
    processor = load_data_processor(FLAGSHIP)
    batch = [{"x": x, "y": y}]
    out = {"backend": torch.distributed.get_backend(), "started": started}

    def flagship():
        model = model_from_metadata(meta, device=device)
        model.load_state_dict(state)
        return model

    # a whole step without a mesh: the baseline peak of this process (and
    # what the step leaves allocated: parameters, gradients, state)
    gc.collect()
    model = flagship()
    _device_memory(device, reset=True)
    whole = Trainer(model=model, n_epochs=1, data_processor=processor, device=device)
    whole.train(batch, {}, build_optimizer(OPT, 1), training_loss=H1Loss(d=2))
    out["whole_peak_mib"], out["whole_resident_mib"] = _device_memory(device)
    del model, whole
    gc.collect()

    mesh = mesh_lib.init(DIST_MODEL_SIZE, device=device)
    out["mesh"] = repr(mesh)
    model = flagship()
    shapes = []
    launch = tsc._launch

    def recording(kind, a, b, out_shape, dims):
        shapes.append((kind, tuple(dims)))
        return launch(kind, a, b, out_shape, dims)

    _device_memory(device, reset=True)
    reset_launches()
    tsc._launch = recording
    try:
        trainer = Trainer(model=model, n_epochs=1, data_processor=processor, device=device,
                          mesh=mesh)
        metrics = trainer.train(batch, {}, build_optimizer(OPT, 1), training_loss=H1Loss(d=2))
    finally:
        tsc._launch = launch
    out["peak_mib"], out["resident_mib"] = _device_memory(device)
    out["launches"] = read_launches()
    out["shapes"] = sorted(set(shapes))
    grads = mesh_lib.gather_state_dict(
        model, {n: p.grad.detach() for n, p in model.named_parameters()})
    errs = grad_errors({n: g.float().cpu() for n, g in grads.items()}, grads_one)
    worst = max(errs, key=errs.get)
    sharded = model.model_parallel_params
    held = dict(model.named_parameters())
    out.update(loss_rel_err=abs(metrics["train_err"] - loss_one) / abs(loss_one),
               grad_err_max=errs[worst], grad_worst=worst, sharded=sorted(sharded),
               spectral_held=sum(held[n].numel() for n in sharded),
               spectral_whole=sum(math.prod(s.shape) for s in sharded.values()),
               params_held=sum(p.numel() for p in model.parameters()))
    timed = trainer.train(batch * DIST_TIMED_STEPS, {}, build_optimizer(OPT, DIST_TIMED_STEPS),
                          training_loss=H1Loss(d=2))
    out["step_ms"] = 1e3 * timed["epoch_time"] / DIST_TIMED_STEPS
    # a dense weight's slice (2, I, O, m1, m2): the shape K1-K3 run at
    w = held[sorted(sharded)[0]]
    B, I, O, M = len(x), w.shape[1], w.shape[2], math.prod(w.shape[3:])
    if device.type == "cuda":
        def operand(*shape):
            return torch.zeros(shape, device=device)

        xs, ws, gs = operand(B, I, M), operand(I, O, M), operand(B, O, M)
        out["plans"] = {"mode_contraction": tsc.mode_contraction_plan(xs, xs, ws, ws),
                        "mode_contraction_dx": tsc.mode_contraction_plan(gs, gs, ws, ws,
                                                                         dx=True),
                        "mode_contraction_dw": tsc.mode_contraction_dw_plan(xs, xs, gs, gs)}
    out["slice_shape"] = (B, I, O, M)
    del trainer, model, grads, held
    gc.collect()

    # the resume check: the Trainer's step on a sharded model and its
    # optimizer, 3 steps straight against 2, the async save, a restore into
    # fresh modules and 1 step
    def stepper():
        model = flagship()
        trainer = Trainer(model=model, n_epochs=1, data_processor=processor, device=device,
                          mesh=mesh)
        mesh_lib.shard_params(model, mesh)
        trainer.optimizer = build_optimizer(OPT, 1).bind(
            model.named_parameters(), model_parallel=mesh_lib.model_parallel_layout(model))
        step = trainer._build_train_step(H1Loss(d=2))
        put = trainer._put(batch[0])
        return model, trainer.optimizer, lambda: step(put, 1.0)

    model, opt, step = stepper()
    for _ in range(sum(DIST_RESUME_STEPS)):
        step()
    # each rank holds its own slices to the bit: compared where they are
    straight = {k: v.clone() for k, v in model.state_dict().items()}
    del model, opt, step
    model, opt, step = stepper()
    for _ in range(DIST_RESUME_STEPS[0]):
        step()
    root = Path(save_root)
    t0 = time.perf_counter()
    save_training_state_orbax(root / "dcp", model, opt, epoch=DIST_RESUME_STEPS[0] - 1,
                              async_save=True)
    out["dcp_save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_training_state(root / "msgpack", "model", model, opt.state_dict(),
                        epoch=DIST_RESUME_STEPS[0] - 1)
    out["msgpack_save_s"] = time.perf_counter() - t0
    saved = mesh_lib.gather_state_dict(model)  # every rank joins the gathers
    if rank == 0:
        out["saved"] = {k: v.cpu() for k, v in saved.items()}
    del saved
    del model, opt, step
    model, opt, step = stepper()
    t0 = time.perf_counter()
    _, restored_opt, epoch = load_training_state_orbax(root / "dcp", model, opt)
    out["dcp_load_s"] = time.perf_counter() - t0
    for _ in range(DIST_RESUME_STEPS[1]):
        step()
    resumed = model.state_dict()
    out.update(resume_epoch=epoch, resume_opt_in_place=restored_opt is opt,
               resume_unequal=[n for n, v in straight.items() if not torch.equal(v, resumed[n])],
               files=sorted(f.name for f in (root / "dcp" / "orbax").iterdir()),
               work_s=time.time() - started)
    return out


def galore_axis_transform():
    """Tensor-GaLore for 25(d): rank GALORE_AXIS_RANK, phase 24's rate, and
    every leaf of two or more dims projected (``min_dim_size_to_project=2``:
    the spectral weights' real/imaginary axis of 2 counts, as in JAX)."""
    from neuraloperator_tpu_torch.training import step_lr, tensor_galore_adamw

    return tensor_galore_adamw(step_lr(3e-5, 50, 0.5, 1), rank=GALORE_AXIS_RANK,
                               update_proj_gap=GALORE_GAP, weight_decay=1e-4,
                               min_dim_size_to_project=2)


def galore_state_bytes(opt) -> int:
    """The bytes of a Tensor-GaLore optimizer's state held by this rank."""
    return sum(t.numel() * t.element_size() for st in opt.state.values()
               for t in (*st["factors"], st["m"], st["v"]))


def galore_known(opt, names) -> dict:
    """Why each of the projected leaves ``names`` of the whole optimizer
    ``opt`` (after its step) may move by more than rounding: a matrix both
    of whose factors truncate (its core is diagonal, and Adam turns the
    rounding off the diagonal into steps of full size), or a truncated mode
    whose kept singular values of the step's gradient lie within
    GALORE_AXIS_SPREAD of its largest of each other, of the first one
    dropped or of zero (a rounding of 1e-7 of the gradient turns their
    vectors by up to 1e-7 / that spacing, and Adam makes each direction a
    step of full size)."""
    from neuraloperator_tpu_torch.training.tensor_galore import _unfold

    params = dict(zip(opt.names, opt.param_groups[0]["params"]))
    out = {}
    for name in names:
        p = params[name]
        factors = opt.state[p]["factors"]
        cut = [k for k, u in enumerate(factors) if u.shape[1] < p.shape[k]]
        if p.ndim == 2 and len(cut) == 2:
            out[name] = "a matrix truncated on both sides (a diagonal core)"
            continue
        for k in cut:
            s = torch.linalg.svdvals(_unfold(p.grad.double(), k))
            s = torch.cat([s / s[0], s.new_zeros(1)])[:factors[k].shape[1] + 1]
            spacing = float((s[:-1] - s[1:]).min())
            if spacing < GALORE_AXIS_SPREAD:
                out[name] = (f"mode {k}'s kept singular values lie {spacing:.1e} apart (of "
                             f"the largest)")
    return out


def galore_stepper(meta, state, device, processor, batch, mesh=None, how=None):
    """(model, optimizer, step) of the flagship from ``state`` under
    ``galore_axis_transform``: whole (``how`` None), its slices at the
    mesh's model size (``"model"``) or its state cut over the mesh's data
    ranks (``"zero"``); ``step()`` is one Trainer step on ``batch``."""
    from neuraloperator_tpu_torch.losses import H1Loss
    from neuraloperator_tpu_torch.models import model_from_metadata
    from neuraloperator_tpu_torch.parallel import mesh as mesh_lib
    from neuraloperator_tpu_torch.parallel.zero import bind_zero
    from neuraloperator_tpu_torch.training import Trainer

    model = model_from_metadata(meta, device=device)
    model.load_state_dict(state)
    trainer = Trainer(model=model, n_epochs=1, data_processor=processor, device=device,
                      mesh=mesh)
    if how == "model":
        mesh_lib.shard_params(model, mesh)
        opt = galore_axis_transform().bind(model.named_parameters(),
                                           model_parallel=mesh_lib.model_parallel_layout(model))
    elif how == "zero":
        opt = bind_zero(galore_axis_transform(), model.named_parameters(), mesh)
    else:
        opt = galore_axis_transform().bind(model.named_parameters())
    trainer.optimizer = opt
    step = trainer._build_train_step(H1Loss(d=2))
    put = trainer._put(batch)
    return model, opt, lambda: step(put, 1.0)


def galore_lockstep(sharded, whole, gather) -> list:
    """GALORE_AXIS_STEPS steps of a sharded Tensor-GaLore run (``sharded``:
    (model, optimizer, step)) in lockstep with one rank's whole-leaf run
    (``whole``): before each step the whole run takes the sharded run's
    parameters (``gather()``, whole) and state (its ``state_dict``, the
    whole tree). Each step's losses and its largest update error per leaf
    (against the larger of the leaf's update norm and 1% of the whole
    update's), leaving out the leaves past GALORE_UPDATE_TOL that
    ``galore_known`` names."""
    (_, opt, step), (wmodel, wopt, wstep) = sharded, whole
    out = []
    for s in range(GALORE_AXIS_STEPS):
        before = {k: v.detach().clone() for k, v in gather().items()}
        wmodel.load_state_dict(before)
        wopt.load_state_dict(opt.state_dict())
        loss, whole_loss = float(step()), float(wstep())
        after = gather()
        names = [n for n, _ in wmodel.named_parameters()]
        update = {n: (after[n].double() - before[n].double()).cpu() for n in names}
        whole_update = {n: (p.detach().double() - before[n].double()).cpu()
                        for n, p in wmodel.named_parameters()}
        err = grad_errors(update, whole_update)
        known = galore_known(wopt, [n for n, e in err.items() if not e <= GALORE_UPDATE_TOL])
        others = {n: e for n, e in err.items() if n not in known}
        worst = max(others, key=others.get)
        out.append({"refresh": s % GALORE_GAP == 0, "loss": loss, "whole_loss": whole_loss,
                    "loss_rel_err": abs(loss - whole_loss) / abs(whole_loss),
                    "update_rel_max": others[worst], "update_worst": worst,
                    "known": {n: (err[n], why) for n, why in known.items()}})
    return out


def dist_galore_rank(rank: int, world: int, meta: dict, device: str, x, y, state) -> dict:
    """(25d) Tensor-GaLore on one rank of two: at mesh (data 1, model 2) on
    the spectral weights' slices, and under ZeRO at (data 2, model 1), each
    in lockstep (``galore_lockstep``) with one rank's whole-leaf run in this
    process from the same weights; the factors this rank holds, its state's
    bytes and the whole run's."""
    import gc

    from neuraloperator_tpu_torch.data.transforms import load_data_processor
    from neuraloperator_tpu_torch.parallel import mesh as mesh_lib

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(0)
        device = torch.device("cuda", 0)
    processor = load_data_processor(FLAGSHIP)
    batch = {"x": x, "y": y}
    whole = galore_stepper(meta, state, device, processor, batch)
    out = {}
    for how, size in (("model", DIST_MODEL_SIZE), ("zero", 1)):
        mesh = mesh_lib.init(size, device=device)
        sharded = galore_stepper(meta, state, device, processor, batch, mesh, how)
        model, opt = sharded[0], sharded[1]

        def gather(model=model):
            return mesh_lib.gather_state_dict(model)

        t0 = time.perf_counter()
        steps = galore_lockstep(sharded, whole, gather)
        out[how] = {"steps": steps, "s": time.perf_counter() - t0, "mesh": repr(mesh),
                    "optimizer": type(opt).__name__,
                    "sliced": sorted(getattr(model, "model_parallel_params", None) or ()),
                    "projected": sorted(n for n, p in zip(opt.names,
                                                          opt.param_groups[0]["params"])
                                        if opt.state[p]["factors"]),
                    "zero_cut": opt.zero_group is not None,
                    "state_bytes": galore_state_bytes(opt),
                    "whole_state_bytes": galore_state_bytes(whole[1]),
                    "factors": {f"{n}.{k}": f.detach().cpu()
                                for n, p in zip(opt.names, opt.param_groups[0]["params"])
                                for k, f in enumerate(opt.state[p]["factors"])}}
        if how == "zero":
            out[how].pop("factors")  # each rank holds its cut of them
        del sharded, model, opt
        gc.collect()
    return out


def galore_axis(ranks: list) -> dict:
    """(25d) the checks of ``dist_galore_rank``'s two ranks: every step's loss
    within STEP_LOSS_TOL and each leaf's update within GALORE_UPDATE_TOL of
    one rank's whole-leaf step, but for known differences, which may not be
    a sliced spectral weight; on the model axis both ranks hold the same
    factors, to the bit; under ZeRO each holds less state than the whole."""
    for how in ("model", "zero"):
        runs = [r[how] for r in ranks]
        for r, run in enumerate(runs):
            for s, step in enumerate(run["steps"]):
                sliced_known = sorted(set(step["known"]) & set(run["sliced"]))
                if not (step["loss_rel_err"] <= STEP_LOSS_TOL
                        and step["update_rel_max"] <= GALORE_UPDATE_TOL and not sliced_known):
                    raise AssertionError(f"distribution: (d) GaLore {how}, rank {r}, step "
                                         f"{s + 1} departs from one rank's whole step: {step}")
        if how == "model":
            unequal = [k for k, f in runs[0]["factors"].items()
                       if not torch.equal(f, runs[1]["factors"][k])]
            sliced = runs[0]["sliced"]
            if (unequal or len(sliced) != flagship_meta()["init_kwargs"]["n_layers"]
                    or not set(sliced) <= set(runs[0]["projected"])):
                raise AssertionError(f"distribution: (d) GaLore's factors differ between the "
                                     f"ranks: {unequal[:5]}; sliced {sliced}, projected "
                                     f"{runs[0]['projected']}")
        elif not (all(run["zero_cut"] and run["state_bytes"] < run["whole_state_bytes"]
                      for run in runs)):
            raise AssertionError(f"distribution: (d) GaLore under ZeRO does not cut its state: "
                                 f"{[(run['state_bytes'], run['whole_state_bytes']) for run in runs]}")
        log(f"distribution: (d) Tensor-GaLore (rank {GALORE_AXIS_RANK}, a refresh every "
            f"{GALORE_GAP} steps) {'at model size ' + str(DIST_MODEL_SIZE) if how == 'model' else 'under ZeRO at data size 2'}, "
            f"{GALORE_AXIS_STEPS} steps in lockstep with one rank's whole-leaf step in "
            f"{[round(run['s'], 1) for run in runs]} s: losses "
            f"{[[st['loss'] for st in run['steps']] for run in runs]}, against the whole step "
            f"rel {[[st['loss_rel_err'] for st in run['steps']] for run in runs]} (tol "
            f"{STEP_LOSS_TOL:.0e}); each leaf's update, max "
            f"{[[(st['update_rel_max'], st['update_worst']) for st in run['steps']] for run in runs]}"
            f" (tol {GALORE_UPDATE_TOL:.0e}); known differences "
            f"{[[st['known'] for st in run['steps']] for run in runs]}; "
            + (f"factors equal on both ranks to the bit ({len(runs[0]['factors'])} factors of "
               f"{len(runs[0]['projected'])} projected leaves, the {len(runs[0]['sliced'])} "
               f"sliced spectral weights among them); "
               if how == "model" else "")
            + f"optimizer state bytes per rank {[run['state_bytes'] for run in runs]} against "
            f"the whole {runs[0]['whole_state_bytes']}")
    return {how: [{k: v for k, v in r[how].items() if k != "factors"} for r in ranks]
            for how in ("model", "zero")}


def galore_zero_world_of_one(in_std: float) -> dict:
    """(25d) Tensor-GaLore through the Trainer under ZeRO on NCCL at world size
    1 (which cuts nothing) against the plain Trainer from the same weights,
    GALORE_AXIS_STEPS steps: the losses and parameters to the bit."""
    from neuraloperator_tpu_torch.data.transforms import load_data_processor
    from neuraloperator_tpu_torch.losses import H1Loss
    from neuraloperator_tpu_torch.parallel import mesh as mesh_lib
    from neuraloperator_tpu_torch.training import Trainer

    x, y = make_pairs(TRAIN_BATCH, in_std, SEED + 8)
    mesh = mesh_lib.init(1, device="cuda")
    processor = load_data_processor(FLAGSHIP)
    reset_launches()
    runs = {}
    for zero in (False, True):
        model = seeded_flagship("cuda", SEED + 7)
        record = RecordingScheduler()
        trainer = Trainer(model=model, n_epochs=GALORE_AXIS_STEPS, data_processor=processor,
                          device="cuda", mesh=mesh if zero else None, zero_sharding=zero)
        trainer.train([{"x": x, "y": y}], {}, galore_axis_transform(), scheduler=record,
                      training_loss=H1Loss(d=2))
        runs[zero] = {"losses": record.metrics, "optimizer": type(trainer.optimizer).__name__,
                      "params": {n: p.detach().cpu() for n, p in model.named_parameters()}}
        del trainer, model
    launches, by_dtype = read_launches(), read_launches_by_dtype()
    unequal = [n for n, p in runs[False]["params"].items()
               if not torch.equal(p, runs[True]["params"][n])]
    log(f"distribution: (d) Tensor-GaLore under ZeRO on {torch.distributed.get_backend()} at "
        f"world size 1 ({runs[True]['optimizer']}), {GALORE_AXIS_STEPS} steps against the "
        f"plain Trainer's: losses {runs[True]['losses']} vs {runs[False]['losses']}, "
        f"parameters unequal {unequal[:5]} of {len(runs[False]['params'])}; launches {launches}")
    if unequal or runs[True]["losses"] != runs[False]["losses"] or \
            len(runs[True]["losses"]) != GALORE_AXIS_STEPS:
        raise AssertionError(f"distribution: (d) GaLore under ZeRO at world size 1 departs "
                             f"from the plain loop: {unequal[:5]}, {runs[True]['losses']} vs "
                             f"{runs[False]['losses']}")
    return {"launches": launches, "launches_by_dtype": by_dtype,
            "losses": runs[True]["losses"]}


def dist_ranks(rank: int, world: int, x, y, state, loss_one, grads_one,
               save_root: str) -> dict:
    """(25c, d) one rank of the two on the card: (c), then (d) and its
    Tensor-GaLore runs in the same process (one spawn for all)."""
    data = dist_rank_step(rank, world, x, y, state, loss_one, grads_one)
    model = dist_model_rank(rank, world, flagship_meta(), "cuda", x, y, state, loss_one,
                            grads_one, save_root)
    galore = dist_galore_rank(rank, world, flagship_meta(), "cuda", x, y, state)
    return {"c": data, "d": model, "g": galore}


def model_axis(ranks: list, ranks_s: float, spawned: float, save_root: str,
               replicated_peak_mib: float) -> dict:
    """(25d) the checks of the two ranks at mesh (data 1, model 2)
    (``dist_model_rank``), and the msgpack save read here, in a world of one."""
    from neuraloperator_tpu_torch.models import model_from_metadata
    from neuraloperator_tpu_torch.training import load_training_state

    meta = flagship_meta()
    n_layers = meta["init_kwargs"]["n_layers"]
    template = model_from_metadata(meta, device="meta").state_dict()
    read, _, epoch = load_training_state(Path(save_root) / "msgpack", "model", template,
                                         device="cpu")
    saved = ranks[0].pop("saved")
    msgpack_unequal = [n for n, v in saved.items() if not torch.equal(v, read[n])]
    want_launches = {"mode_contraction": n_layers, "mode_contraction_dx": n_layers,
                     "mode_contraction_dw": n_layers}
    per_rank = []
    for r, got in enumerate(ranks):
        got["start_s"] = got.pop("started") - spawned
        per_rank.append(got)
        B, I, O, M = got["slice_shape"]
        want_shapes = [(kind, (B, I, O, M)) for kind in ("dw", "dx", "fwd")]
        if not (got["loss_rel_err"] <= STEP_LOSS_TOL and got["grad_err_max"] <= STEP_GRAD_TOL):
            raise AssertionError(f"distribution: (d) rank {r}'s step departs from one rank's "
                                 f"whole step: {got}")
        if not (2 * got["spectral_held"] == got["spectral_whole"] and len(got["sharded"])
                == n_layers and O * DIST_MODEL_SIZE == I):
            raise AssertionError(f"distribution: (d) rank {r} holds {got['spectral_held']} of "
                                 f"{got['spectral_whole']} spectral values in {got['sharded']}")
        if got["launches"] != want_launches or got["shapes"] != want_shapes:
            raise AssertionError(f"distribution: (d) rank {r} launched {got['launches']} at "
                                 f"{got['shapes']}, expected {want_launches} at {want_shapes}")
        if (got["resume_unequal"] or got["resume_epoch"] != DIST_RESUME_STEPS[0] - 1
                or not got["resume_opt_in_place"] or got["backend"] != "gloo"):
            raise AssertionError(f"distribution: (d) rank {r}: the resume from the DCP save "
                                 f"departs from {sum(DIST_RESUME_STEPS)} straight steps: {got}")
    if msgpack_unequal or epoch != DIST_RESUME_STEPS[0] - 1:
        raise AssertionError(f"distribution: (d) the msgpack save at model size 2 read in a "
                             f"world of one differs: {msgpack_unequal[:5]}, epoch {epoch}")
    log(f"distribution: (c) and (d): {DIST_RANKS} ranks on the card (gloo) in {ranks_s:.1f} "
        f"s; (d) at model size {DIST_MODEL_SIZE}: each holds {per_rank[0]['spectral_held']} of "
        f"{per_rank[0]['spectral_whole']} spectral values "
        f"({4 * per_rank[0]['spectral_held'] / 1e6:.1f} of "
        f"{4 * per_rank[0]['spectral_whole'] / 1e6:.1f} MB); the step against one rank's "
        f"whole step: loss {[r['loss_rel_err'] for r in per_rank]}, gradients "
        f"{[(r['grad_err_max'], r['grad_worst']) for r in per_rank]}; K1-K3 at (B, I, O, M) "
        f"{per_rank[0]['slice_shape']}: {per_rank[0]['launches']}, plans "
        f"{per_rank[0].get('plans')}; step ms {[r['step_ms'] for r in per_rank]}; peak MiB "
        f"sharded {[r['peak_mib'] for r in per_rank]}, whole step in the same process "
        f"{[r['whole_peak_mib'] for r in per_rank]}, (c)'s replicated "
        f"{replicated_peak_mib:.1f}; resident after the step MiB sharded "
        f"{[r['resident_mib'] for r in per_rank]}, whole "
        f"{[r['whole_resident_mib'] for r in per_rank]}; the resume from the async DCP save "
        f"equal to the bit to {sum(DIST_RESUME_STEPS)} straight steps (save s "
        f"{[round(r['dcp_save_s'], 3) for r in per_rank]}, load s "
        f"{[round(r['dcp_load_s'], 3) for r in per_rank]}, files {per_rank[0]['files']}); the "
        f"msgpack save ({[round(r['msgpack_save_s'], 3) for r in per_rank]} s) read here to "
        f"the bit ({len(saved)} leaves)")
    return {"ranks": per_rank}


def distribution() -> dict:
    """(25) the distribution phase: (a) train_navier_stokes with and without
    --distributed.use_distributed (NCCL, a world of one) to the bit, (b) the
    same under ZeRO to the bit, (c) two ranks sharing the card (gloo) against
    one rank, replicated and under ZeRO, (d) two ranks at model size 2."""
    import torch.distributed as dist

    from neuraloperator_tpu_torch.data.transforms import load_data_processor
    from neuraloperator_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    n_layers = flagship_meta()["init_kwargs"]["n_layers"]
    plain = dist_script_run("without the flag", [])
    dist_flag = ["--distributed.use_distributed", "true"]
    flagged = dist_script_run("--distributed.use_distributed true", dist_flag)
    backend = dist.get_backend()
    zero = dist_script_run("--distributed.use_distributed true under ZeRO", dist_flag,
                           zero=True)
    # the reductions skip a group of one: NCCL itself, on the world
    probe = torch.ones(4, device="cuda")
    dist.all_reduce(probe)
    if not torch.equal(probe.cpu(), torch.ones(4)):
        raise AssertionError(f"distribution: an all-reduce over one rank gave {probe}")
    steps, evals = plain["steps"], DIST_TESTS // EVAL_BATCH
    expected = {"mode_contraction": n_layers * (steps + evals),
                "mode_contraction_dx": n_layers * steps, "mode_contraction_dw": n_layers * steps}
    for label, run in (("plain", plain), ("distributed", flagged), ("zero", zero)):
        only_dtype(run["launches_by_dtype"], "float32")
        if run["launches"] != expected:
            raise AssertionError(f"distribution: the {label} run launched {run['launches']}, "
                                 f"expected {expected}")
    if not (backend == "nccl" and flagged["mesh"] and zero["optimizer"] == "ZeroAdamW"
            and plain["mesh"] is None):
        raise AssertionError(f"distribution: backend {backend}, meshes {flagged['mesh']} / "
                             f"{plain['mesh']}, ZeRO optimizer {zero['optimizer']}")
    # (a) and (b): no reduction over one rank, no ZeRO cut at data size 1:
    # equal to the bit
    for label, run in (("(a) distributed", flagged), ("(b) ZeRO", zero)):
        metrics = {k: v for k, v in run["metrics"].items() if "time" not in k}
        want = {k: v for k, v in plain["metrics"].items() if "time" not in k}
        unequal = [n for n, p in plain["params"].items() if not torch.equal(p, run["params"][n])]
        if metrics != want or unequal:
            raise AssertionError(f"distribution: {label} departs from the plain run: metrics "
                                 f"{metrics} vs {want}, parameters {unequal[:5]}")
    if zero["peak_mib"] > flagged["peak_mib"]:
        raise AssertionError(f"distribution: (b) ZeRO's peak {zero['peak_mib']:.1f} MiB "
                             f"above (a)'s {flagged['peak_mib']:.1f}")
    log(f"distribution: (a) and (b) equal to the plain run to the bit (metrics and "
        f"{len(plain['params'])} parameters); step ms plain {plain['step_ms']:.3f}, "
        f"distributed {flagged['step_ms']:.3f}, ZeRO {zero['step_ms']:.3f}")
    in_std = float(load_data_processor(FLAGSHIP).in_normalizer.std.ravel()[0])
    galore_zero = galore_zero_world_of_one(in_std)

    # (c) two ranks on the card against one rank on the same 8 rows
    x, y = make_pairs(TRAIN_BATCH, in_std, SEED + 5)
    model = seeded_flagship("cuda", SEED + 7)
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    loss_one, grads_one = one_step(model, load_data_processor(FLAGSHIP), x, y, "cuda")
    save_root = tempfile.mkdtemp(prefix="chip-model-axis-")
    t1, spawned = time.perf_counter(), time.time()
    try:
        both = run_ranks(dist_ranks, DIST_RANKS,
                         (x, y, state, loss_one, grads_one, save_root),
                         timeout_s=DIST_TIMEOUT_S)
        ranks_s = time.perf_counter() - t1
        axis = model_axis([r["d"] for r in both], ranks_s, spawned, save_root,
                          both[0]["c"]["peak_mib"])
        galore = galore_axis([r["g"] for r in both])
    finally:
        shutil.rmtree(save_root, ignore_errors=True)
    ranks = [r["c"] for r in both]
    want_launches = {"mode_contraction": n_layers, "mode_contraction_dx": n_layers,
                     "mode_contraction_dw": n_layers}
    per_rank = []
    for r, got in enumerate(ranks):
        got["start_s"] = got.pop("started") - spawned
        per_rank.append(got)
        if not (got["loss_rel_err"] <= STEP_LOSS_TOL and got["grad_err_max"] <= STEP_GRAD_TOL):
            raise AssertionError(f"distribution: (c) rank {r}'s step departs from one rank's: "
                                 f"{got}")
        if (got["zero_unequal"] or not got["zero_loss_equal"]
                or got["zero_optimizer"] != "ZeroAdamW"
                or got["zero_peak_mib"] > got["peak_mib"]):
            raise AssertionError(f"distribution: (c) rank {r}: ZeRO departs from the "
                                 f"replicated step: {got}")
        if got["launches"] != want_launches or got["zero_launches"] != want_launches:
            raise AssertionError(f"distribution: (c) rank {r} launched {got['launches']} / "
                                 f"{got['zero_launches']}, expected {want_launches}")
        if got["backend"] != "gloo":
            raise AssertionError(f"distribution: (c) rank {r} ran on {got['backend']}")
    log(f"distribution: (c) {DIST_RANKS} ranks on the card (gloo), one step of global "
        f"batch {TRAIN_BATCH} against one rank's: {per_rank}")
    # end the world of one: nothing after this phase runs distributed
    dist.destroy_process_group()
    phase_s = time.perf_counter() - t0
    runs = (plain, flagged, zero, galore_zero)
    launches = {k: sum(r["launches"][k] for r in runs) for k in plain["launches"]}
    by_dtype = {k: {dt: sum(r["launches_by_dtype"][k][dt] for r in runs)
                    for dt in plain["launches_by_dtype"][k]}
                for k in plain["launches_by_dtype"]}
    log(f"distribution: phase in {phase_s:.1f} s; launches {launches}")
    return {"launches": launches, "launches_by_dtype": by_dtype, "backend": backend,
            "step_ms": {"plain": plain["step_ms"], "distributed": flagged["step_ms"],
                        "zero": zero["step_ms"]},
            "peak_mib": {"plain": plain["peak_mib"], "distributed": flagged["peak_mib"],
                         "zero": zero["peak_mib"]},
            "two_ranks": per_rank, "two_ranks_s": ranks_s, "model_axis": axis,
            "galore": {"zero_world_of_one": galore_zero["losses"], **galore},
            "phase_s": phase_s}


def kernel_line(variants, paths) -> list:
    """The {"kernels": [...]} entries: the f32 B=8 variant of each kernel,
    with its launches summed over the paths, by path, by dtype, and by path
    and dtype."""
    kernels = []
    for name, spec in kernel_specs().items():
        own = [v for v in variants if v["name"] == name]
        main = next(v for v in own if v["dtype"] == "float32" and v["batch"] == TRAIN_BATCH
                    and v["shape"]["M"] == MODES and v["shape"]["O"] == CHANNELS)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": f"{PALLAS}:140 (_mode_contraction, dn={spec['dn']}, :{spec['line']})",
            "launches": sum(p["launches"][name] for p in paths.values()),
            "launches_by_path": {path: p["launches"][name] for path, p in paths.items()},
            "launches_by_dtype": {dt: sum(p["launches_by_dtype"][name][dt]
                                          for p in paths.values())
                                  for dt in ("float32", "bfloat16")},
            "launches_by_path_and_dtype": {path: p["launches_by_dtype"][name]
                                           for path, p in paths.items()},
            "max_abs_err": main["max_abs_err"],
            "rel_l2": main["rel_l2"],
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "shape": main["shape"],
            "variants": [{k: v for k, v in x.items() if k != "name"} for x in own],
        })
    return kernels


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available; run it on the GPU machine")
    card = card_line()
    print(card, flush=True)
    log(f"card: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    from neuraloperator_tpu_torch import _native

    FRESH.start()  # it warms up while the kernels build and run
    build = _native.build_library("spectral_contraction")
    ptxas = [ln.strip() for ln in build.log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    log(f"build: spectral_contraction.cu in {build.seconds:.1f} s"
        + ("" if build.seconds else " (reused an earlier build)"))
    for line in ptxas:
        print(f"    {line}", flush=True)

    dtypes = (torch.float32, torch.bfloat16)
    variants = [dict(name="mode_contraction", **check_kernel("mode_contraction", b, dt))
                for dt in dtypes for b in (*BUCKETS, EVAL_BATCH)]
    variants += [dict(name=name, **check_kernel(name, TRAIN_BATCH, dt))
                 for name in ("mode_contraction_dx", "mode_contraction_dw") for dt in dtypes]
    # the Darcy recipe's shapes: 24 x 24 channels over 144 modes, f32, K1 at
    # the step's batch and the evaluation's, K2 and K3 at the step's
    variants += [dict(name=name, recipe="darcy",
                      **check_kernel(name, b, torch.float32,
                                     channels=(DARCY_CHANNELS, DARCY_CHANNELS),
                                     modes=DARCY_MODES))
                 for name, b in (("mode_contraction", TRAIN_BATCH),
                                 ("mode_contraction", DARCY_EVAL_BATCH),
                                 ("mode_contraction_dx", TRAIN_BATCH),
                                 ("mode_contraction_dw", TRAIN_BATCH))]
    # UNO's widest layer (64 -> 32 channels over 40 modes): K1 at the step's
    # batch and the evaluation's, K2 and K3 at the step's; and K2/K3 at the
    # Darcy shapes at UQNO's batch of 16
    variants += [dict(name=name, recipe="uno",
                      **check_kernel(name, b, torch.float32, channels=UNO_CHANNELS,
                                     modes=UNO_MODES))
                 for name, b in (("mode_contraction", TRAIN_BATCH),
                                 ("mode_contraction", DARCY_EVAL_BATCH),
                                 ("mode_contraction_dx", TRAIN_BATCH),
                                 ("mode_contraction_dw", TRAIN_BATCH))]
    variants += [dict(name=name, recipe="uqno",
                      **check_kernel(name, UQNO_BATCH, torch.float32,
                                     channels=(DARCY_CHANNELS, DARCY_CHANNELS),
                                     modes=DARCY_MODES))
                 for name in ("mode_contraction_dx", "mode_contraction_dw")]
    # the FNO-3D of train_mhd64 (16 x 16 channels over 320 modes at batch 2)
    # and the matched FNO of train_codano_multivar (16 x 16 over 40 at 16)
    variants += [dict(name=name, recipe=recipe,
                      **check_kernel(name, batch, torch.float32, channels=(ch, ch), modes=m))
                 for recipe, batch, ch, m in (("mhd", MHD_BATCH, MHD_CHANNELS, MHD_MODES),
                                              ("multivar", MULTIVAR_BATCH, MULTIVAR_CHANNELS,
                                               MULTIVAR_MODES))
                 for name in kernel_specs()]
    # the Burgers scripts' contractions: 24 x 24 channels over 5 modes (the
    # FNO-1D at batch 16, the RNO gates at 8) and over 40 (the PINO FNO at 8)
    variants += [dict(name=name, recipe=recipe,
                      **check_kernel(name, batch, torch.float32,
                                     channels=(BURGERS_CHANNELS, BURGERS_CHANNELS), modes=m))
                 for recipe, batch, m in BURGERS_SHAPES for name in kernel_specs()]
    # the GNO family's FNO layers at batch 1: 32 x 32 channels over 320 modes
    # (GINO, FNOGNO) and 24 x 24 over 40 (the Poisson FNOGNO); OTNO's, 32 x
    # 32 over 12 x 7 = 84
    variants += [dict(name=name, recipe=recipe,
                      **check_kernel(name, batch, torch.float32, channels=(ch, ch), modes=m))
                 for recipe, batch, ch, m in (*GNO_SHAPES, OTNO_SHAPE)
                 for name in kernel_specs()]
    # the patched flagship's: the flagship's channels and modes over 32
    # patches a step (K1-K3, timed) and 64 an evaluation batch (K1, checked)
    variants += [dict(name=name, recipe="patching", **check_kernel(name, PATCH_BATCH,
                                                                   torch.float32))
                 for name in kernel_specs()]
    # the model-sharded flagship's: each rank's out-channel slice, 64 x 32
    # channels over the 2112 modes at the step's batch (phase 25d)
    variants += [dict(name=name, recipe="model_axis",
                      **check_kernel(name, TRAIN_BATCH, torch.float32,
                                     channels=(CHANNELS, CHANNELS // DIST_MODEL_SIZE)))
                 for name in kernel_specs()]
    patched_eval_k1 = check_kernel("mode_contraction", PATCH_EVAL_BATCH, torch.float32,
                                   timed=False)
    k3 = {v["dtype"]: v["ms"] for v in variants if v["name"] == "mode_contraction_dw"
          and v["batch"] == TRAIN_BATCH and v["shape"]["M"] == MODES}
    k1 = next(v["ms"] for v in variants if v["name"] == "mode_contraction"
              and v["batch"] == TRAIN_BATCH and v["dtype"] == "float32"
              and v["shape"]["M"] == MODES)
    log(f"K3 at B={TRAIN_BATCH}: f32 {k3['float32']:.4f} ms, bf16 {k3['bfloat16']:.4f} ms; "
        f"K3 f32 / K1 f32 = {k3['float32'] / k1:.3f}")
    # off the flagship shape (checked, not timed)
    edges = {name: [check_kernel(name, B, dt, channels=ch, modes=m, timed=False)
                    for B, ch, m in shapes for dt in dtypes]
             for name, shapes in (("mode_contraction", K12_EDGE_SHAPES),
                                  ("mode_contraction_dx", K12_EDGE_SHAPES),
                                  ("mode_contraction_dw", K3_EDGE_SHAPES))}
    splits = generate_splits()
    model, processor = load_flagship_on("cuda")
    cpu_model, _ = load_flagship_on("cpu")
    served = serve(model, processor, cpu_model)
    evaluated = evaluate_flagship(model, processor, cpu_model)
    del model, cpu_model
    trained = train()
    recipe_run = recipe()
    mixed_run = mixed(processor, served, evaluated, recipe_run)
    superres_run = superres(processor)
    rollout_run = rollout(processor)
    options_run = options(mixed_run)
    quantize_run = quantize_export(processor, served)
    remat_scan_run = remat_scan(processor, recipe_run)
    tfno_run = tfno(processor, recipe_run)
    with darcy_files() as darcy_files_s:
        darcy_run = darcy()
        layer_options_run = layer_options()
        families_run = families()
        uqno_run = uqno()
    families_run["generate_s"] = darcy_files_s
    sfno_run = sfno()
    mhd_multivar_run = mhd_multivar()
    burgers_run = burgers()
    gno_run = gno()
    otno_run = otno()
    patching_run = patching(recipe_run)
    well_run = well()
    distribution_run = distribution()

    axis_ranks = distribution_run["model_axis"]["ranks"]
    kernels = kernel_line(variants, {"serve": served, "eval": evaluated, "train": trained,
                                     "recipe": recipe_run, "mixed": mixed_run,
                                     "superres": superres_run, "rollout": rollout_run,
                                     "options": options_run, "quantize_export": quantize_run,
                                     "remat_scan": remat_scan_run, "tfno": tfno_run,
                                     "darcy": darcy_run, "layer_options": layer_options_run,
                                     "families": families_run, "uqno": uqno_run,
                                     "sfno": sfno_run, "mhd_multivar": mhd_multivar_run,
                                     "burgers": burgers_run, "gno": gno_run,
                                     "otno": otno_run, "patching": patching_run,
                                     "well": well_run, "distribution": distribution_run})
    for k in kernels:
        k["edge_checks"] = edges[k["name"]]
    kernels[0]["patched_eval_check"] = patched_eval_k1
    log(f"done in {time.perf_counter() - _T0:.1f} s; served latency ms {served['latency_ms']}; "
        f"eval rel_l2 {evaluated['rel_l2']:.6e} rel_h1 {evaluated['rel_h1']:.6e} (solver "
        f"{splits['solver_s']:.1f} s, eval {evaluated['eval_s']:.2f} s); "
        f"train step {trained['step_ms']:.2f} ms, peak {trained['peak_mib']:.0f} MiB; recipe "
        f"step ms {recipe_run['step_ms']}, saves {recipe_run['save_s']}, peak "
        f"{recipe_run['peak_mib']:.0f} MiB; mixed: eval rel_l2 {mixed_run['eval']['rel_l2']:.6e} "
        f"rel_h1 {mixed_run['eval']['rel_h1']:.6e}, graphed step "
        f"{mixed_run['train']['graphed_step_ms']:.2f} ms, peak "
        f"{mixed_run['train']['peak_mib']:.0f} MiB; superres "
        f"{ {r: (f['rel_l2'], f['rel_h1']) for r, f in superres_run['figures'].items()} }, "
        f"solver s {superres_run['solver_s']}; rollout t=1 {rollout_run['rollout_l2'][0]:.6e} "
        f"t=10 {rollout_run['rollout_l2'][-1]:.6e}, after pushforward "
        f"{rollout_run['pushforward_rollout_l2'][-1]:.6e}, peak {rollout_run['peak_mib']:.0f} "
        f"MiB; options graphed step ms "
        f"{ {n: round(options_run[n]['graphed_step_ms'], 3) for n in OPTIONS} }; int8 eval "
        f"rel_l2 {quantize_run['int8']['eval']['rel_l2']:.6e}, served latency ms "
        f"{quantize_run['int8']['latency_ms']}; artifacts MB f32 "
        f"{quantize_run['export']['f32']['mb']:.1f} bf16 {quantize_run['export']['bf16']['mb']:.1f}; "
        f"remat step peak {remat_scan_run['remat']['peak_mib']:.0f} MiB vs "
        f"{remat_scan_run['remat']['plain_peak_mib']:.0f}, graphed remat step "
        f"{remat_scan_run['remat']['graph']['step_ms']:.2f} ms, graphed scan step "
        f"{remat_scan_run['scan']['graphed_step_ms']:.2f} ms; tfno graphed step "
        f"{tfno_run['train']['replay_ms']:.2f} ms (mixed "
        f"{tfno_run['mixed']['graphed_step_ms']:.2f} ms), batch-16 eval forward "
        f"{tfno_run['train']['eval16_ms']:.2f} ms, peak {tfno_run['train']['eval16_peak_mib']:.0f} "
        f"MiB, served latency ms {tfno_run['serve_export']['latency_ms']}, artifact "
        f"{tfno_run['serve_export']['export_mb']:.1f} MB; darcy {darcy_run['metrics']}, "
        f"loop step {darcy_run['step_ms']:.3f} ms, peak {darcy_run['peak_mib']:.0f} MiB; "
        f"layer options worst forward "
        f"{max(c['forward_rel_l2'] for c in layer_options_run['cases'].values()):.2e}, "
        f"FFT path rel_l2 {layer_options_run['fft_path']['rel_l2']:.2e}; families "
        f"{ {f: r['metrics'] for f, r in families_run['runs'].items()} }, loop step ms "
        f"{ {f: round(r['step_ms'], 3) for f, r in families_run['runs'].items()} }; uqno "
        f"coverage {uqno_run['pointwise']:.4f} / {uqno_run['function']:.3f} in "
        f"{uqno_run['run_s']:.1f} s; sfno {sfno_run['metrics']} in {sfno_run['run_s']:.1f} s, "
        f"loop step {sfno_run['step_ms']:.3f} ms; mhd {mhd_multivar_run['mhd']['metrics']}, "
        f"multivar in {mhd_multivar_run['multivar']['run_s']:.1f} s; burgers "
        f"{burgers_run['train_burgers']['metrics']}, pino test l2 "
        f"{burgers_run['train_burgers_pino']['result']['test_l2']:.6f}, rno test l2 "
        f"{burgers_run['train_burgers_rno']['result']['test_l2']:.6f}, loop step ms "
        f"{ {s: round(burgers_run[s]['step_ms'], 3) for s in BURGERS_JAX} }; gno test l2 "
        f"{ {s: gno_run[s]['result']['test_l2'] for s in GNO_JAX} }, loop step ms "
        f"{ {s: round(gno_run[s]['step_ms'], 3) for s in GNO_JAX} }; otno test l2 "
        f"{otno_run['result']['test_l2']:.6f}, loop step {otno_run['step_ms']:.3f} ms, OT maps "
        f"{otno_run['ot_maps']['seconds']['torch_cuda']:.3f} s a body on the card; patched "
        f"recipe train_err {patching_run['train_err']}, step ms {patching_run['step_ms']}, "
        f"peak {patching_run['peak_mib']:.0f} MiB; well train losses "
        f"{well_run['train_errs']}, step {well_run['step_ms']:.3f} ms, rollout "
        f"{well_run['rollout']} in {well_run['rollout_s']:.2f} s; distribution step ms "
        f"{distribution_run['step_ms']}, two ranks "
        f"{[(r['step_ms'], r['peak_mib'], r['zero_peak_mib']) for r in distribution_run['two_ranks']]}"
        f", model axis (step ms, peak MiB, whole step's peak) "
        f"{[(r['step_ms'], r['peak_mib'], r['whole_peak_mib']) for r in axis_ranks]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
