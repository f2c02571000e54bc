#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

From the root of a checkout, with no arguments:

1. checks for a CUDA device and prints the card's name and power limit;
2. builds the port's CUDA kernels (``msca_fused``, ``lowrank_conv``,
   ``parallel_cascade``, ``qmatmul``) from the sources in the checkout, one nvcc
   each, started together, and prints ptxas's registers and spills of
   ``lowrank_conv``'s kernels;
3. holds each kernel against its plain PyTorch version, in float32 with TF32
   off, at the shapes its main path gives it at batch 64 and 224^2, and prints
   errors, median CUDA-event times and each call's bound (the larger of its
   bytes over 3.35 TB/s and its operations over the peak of their type: 67
   TFLOP/s float32, 1,979 TOP/s int8): ``msca_fused`` at the four stage shapes
   of MSCAN-t in the dense-bank and the MscaRep d1+fix forms, with the sums per
   forward of both, and at five ragged shapes (H != W, C = 40, fix_p > H, k0 = 3
   with two k, k_max > 31), its planner's shared memory against the kernel's;
   ``lowrank_conv`` at AlexNet's convs 2-5 in the separable and the full-bases
   forms, the weights packed once as the layer caches them, with cuDNN's dense
   conv of the merged weight W_eff timed beside it, each bound on the kernel's
   3xTF32 route (the mix's three TF32 products at 495 TFLOP/s) and in float32,
   the sums per forward of both forms, and at six ragged shapes in both forms
   (stride 2, H != W, kh != kw, C = 6, N = 10, M = 10, every P off the
   128-pixel tile), its planner's shared memory against the kernel's;
   ``parallel_cascade`` bit for bit at ConvNeXt-T's four stage shapes with one
   and two 7-tap cascades, at MSCAN-t's four stage shapes as the 5-tap conv0 and
   the 21-tap bank cascade of dconv0, and in MSCA's dense-bank form, with cuDNN's
   depthwise conv of the merged kernel timed beside it and the sums per r1, r2
   and dconv0 forward; ``qmatmul`` bit for bit at the 13 shapes of int8
   ConvNeXt-T, with ``torch._int_mm`` on the quantized operands timed beside it,
   and at three ragged shapes (M off every tile, K off 32 and off 4, odd N);
   ``lowrank_conv`` at the scheme-1 shapes of ResNet-18 (its 7 distinct block
   3x3s, M = 4, stride 2 at the first of stages 2-4) and VGG-16 (its 8 distinct
   convs of 2-13, M = 16), each with its plan's shared memory against the
   kernel's, cuDNN's conv of W_eff beside it and the sums per forward
   (kernel times are device times: a sleep kernel holds the stream while the
   host enqueues);
4. drives the port's MSCAN main path once, through its CLI entry point: the
   Runner on ``configs/msca-rep/msca-rep_d1_fix_mscan-t.py`` at full width (13
   MSCA blocks swapped for MscaRep(1, fix), the SVD solved on the card, the
   forward timed at (64, 224, 224, 3) by InferenceTimeHook), checks that every
   forward launched ``msca_fused`` once per MSCA block, and holds the logits
   against the same model run through the plain version; times the dense
   MSCAN-t the same way, checks that one cached MSCA block launches the two
   kernels of ``msca_fused`` and nothing else, and profiles the d1+fix and the
   dense forwards;
5. drives the AlexNet main path the same way: the Runner on
   ``configs/low-rank-exp/low-rank-exp-v1_l2345_svd_dodecomp_alexnet.py`` (convs
   2-5 swapped for separable LowRankExpConvV1 with 8/8/6/4 bases, the SVDs on the
   card, ModelAnalysis and InferenceTimeHook), checks the 4 registered layers,
   that every forward launched ``lowrank_conv`` once per layer, and the logits
   against the plain version and the module path; times the forward with the
   plain version in place and the dense AlexNet, profiles the low-rank
   forward, and captures it with ``deploy.compile_serving`` (a CUDA graph: the
   replay's logits against the eager ones, 4 ``lowrank_conv`` kernels in one
   replay, timed); then runs the non-decomposed config once, so that the full-bases
   body runs on a real path; then checks that one cached LowRankExpConvV1
   forward puts exactly one kernel, ``lowrank_conv``'s, on the card;
6. drives the ConvNeXt-T serving path: the Runner on
   ``configs/convnext/dw-sep-rep_r1_convnext-t.py`` (18 block dwconvs swapped for
   rank-1 cascades, ModelAnalysis and InferenceTimeHook), checks that every
   forward launched ``parallel_cascade`` 18 times, sets every layer scale
   ``gamma`` to 1 (at its 1e-6 init the blocks would hide under any tolerance)
   and holds the logits against the plain version and the module path; times
   the plain version in place and the dense ConvNeXt-T, profiles the forward;
   then ``deploy.quantize_int8`` on two calibration batches (41 modules), checks
   41 ``qmatmul`` and 18 ``parallel_cascade`` launches per int8 forward, holds
   the int8 logits against the same model through the plain versions and
   against the float32 model, times and profiles the int8 forward and captures
   it as a CUDA graph (41 ``qmatmul`` and 18 ``parallel_cascade`` kernels in one
   replay); then runs the rank-2 config once (two cascades per block on a real
   path);
7. drives MSCAN-t with MscaRep(1, fix, decomp_conv0) through the CLI: 13 blocks
   whose conv0 is a cascade, 26 ``parallel_cascade`` launches and no
   ``msca_fused`` launch per forward, logits against the plain version and the
   module path, timed and profiled; for it and for d1+fix, the host time to
   enqueue one forward is printed beside the device time;
8. builds the MSCAN-t headline serving surface of bench.py:161-204 through the
   port's entry points (``apply_app`` of MscaRep(1, fix), then of FfnRep(fix) on
   FFNs 1-6, ``fold_batchnorm``, ``enable_pw_matmul``: 13, 6, 5 and 59 sites)
   beside plain d1+fix from the same seed-0 weights, and gates it: max-abs
   below 5e-3 against plain d1+fix at the init layer scales (bench.py's
   exact-rewrite gate); with layer scales 1 and random BN, logits within 1e-4
   of plain d1+fix and of the surface through ``msca_fused_ref``; 13
   ``msca_fused`` launches per eager forward and no 1x1 conv through
   ``aten::convolution``; a ``deploy.compile_serving`` CUDA graph whose replay
   runs 26 ``msca_fused`` kernels and no transpose the eager forward does not,
   with logits within 1e-6 of eager; 8 seeded batches of 64 served through
   it, against eager.  Prints every 1x1 shape's cuDNN conv against the
   matmul with its bound, FfnRep's merged convs against the fc1 + dconv they
   replace, profiles of the eager forward and the replay, and the eager,
   graph and back-to-back times of dense MSCAN-t, plain d1+fix (both captured
   too), the surface and the dconv0 surface (MscaRep with ``decomp_conv0``:
   26 ``parallel_cascade`` kernels per forward and per replay, gated and
   served the same way);
9. runs one eval-mode backward through a ``CascadeConv``, an ``MSCA`` (MscaRep
   d1+fix) and a ``LowRankExpConvV1`` on the card: their input and parameter
   gradients against the module path's, no kernel launched under autograd,
   one launch each under ``torch.no_grad()``;
10. fine-tunes through the Runner at b = 64, 224^2, float32, TF32 off, on
    Synthetic data from the seed (each run's cuts printed): F1, MSCAN-t asym
    with MscaRep d0+fix (``configs/msca-rep/finetune/msca-rep-d0-fix_l2-asym_mscan-t.py``,
    2 epochs of 4 steps): every loss finite, 13 ``msca_fused`` launches per
    step (the teacher), the teacher's taps within 1e-5 of ``msca_fused_ref``,
    student and teacher eval logits within 1e-4 before the first step, the
    last checkpoint loading back bit for bit; prints the step, teacher,
    optimizer, validation and checkpoint times, img/s, ``msca_fused``'s share
    of a profiled step and the peak memory beside the card's name and power
    limit.  F2, MSCAN-t asym with MscaRep d1+fix on block 1
    (``configs/msca-rep/each_layer/msca-rep_d1_l1_fix_class-t.py``, drop rates
    0, 4 steps): a step's loss and trainable gradient norm on the card within
    1e-4 of the same step on the CPU, a held-out batch's L2 loss lower after
    the steps, 13 ``msca_fused`` launches per validation forward.  F3, AlexNet
    sym layer-wise (``configs/low-rank-exp/low-rank-exp-v1_l2345_svd_dodecomp_l2-sym_alexnet.py``,
    Synthetic for CIFAR-10, 8 epochs of 4 steps): each epoch moves only the new
    branch of its layer, every other parameter bit-equal; the validation
    forward launches ``lowrank_conv`` once per layer (4 before training), and
    once per layer whose bases all channels still share after training;
11. drives the paths of ResNet-18, VGG-16, int8 ResNet-50 and the MSCAN-t
    configs the Dummy app, the Fps hook and the profiler tables run, each
    through the CLI with the launch counts set to 0 before it: P1
    ``configs/resnet/low-rank-exp-v1_blocks_svd_resnet18.py`` (16 block 3x3s
    as separable LowRankExpConvV1 of 4 bases, 16 ``lowrank_conv`` launches per
    forward, logits against the plain version and the module path, timed beside
    dense ResNet-18, profiled; ``fold_batchnorm``'s 20 pairs, the logits again
    and 16 launches after the repack; a compile_serving replay with 16
    ``lowrank_conv`` kernels; the initdecomp config, then given P1's weights as
    a deployment loads them: 16 launches, P1's logits); P2
    ``configs/vgg/low-rank-exp-v1_all_svd_vgg16.py`` (12 sites of 16 bases, 12
    launches per forward, the logits, dense VGG-16 timed, profiled); P3
    ``configs/resnet/serve_int8_resnet50.py`` (the Dummy app: no site; then
    ``fold_batchnorm`` (53) and ``quantize_int8`` (54), 54 ``qmatmul`` launches
    per forward, int8 logits against the plain versions and the float32 model,
    peak memory, a profile, a replay with 54 ``qmatmul`` kernels; each (M, K, N)
    of the forward held bit for bit on its own inputs and timed beside
    ``torch._int_mm``); P4 ``configs/msca-rep/fps/msca-rep_d1_mscan-t_fps.py``
    (``Fps``: 13 ``msca_fused`` launches per forward it drives, its img/s beside
    64 over the same model's median forward), the profiler configs
    ``msca-rep-profile_d1_fix_mscan-t.py`` and ``msca-profile_mscan-t.py`` (a
    trace file, the tables, CONV0/SD_CONVS/CHANNEL_MIX with device time and
    their shares) and ``dummy_mscan-t.py`` (no site; the hooks run);
12. drives the rest of the low-rank family, calibration and QAT through the
    CLI, each solve (``optimize``) and calibration pass timed between two
    synchronizes, the first site solved again on the CPU (what the solve
    reached within 1e-4, the outputs within 1e-2), no port kernel launched by
    a V2-V4 layer: P5
    ``configs/resnet/low-rank-exp-v3_blocks_resnet18.py`` (16 block 3x3s as
    ``LowRankExpConvV3``), timed beside dense ResNet-18, then
    ``fold_batchnorm`` (20 pairs, 16 through ``mix_conv``; logits within 1e-4),
    ``enable_pw_matmul`` and a compile_serving replay (within 1e-6 of eager),
    profiled; P6 the VGG-16 configs ``low-rank-exp-v3_all``, ``-v3_dd``,
    ``-v4_all`` and ``-v2_all`` (the last two calibrate on 2 batches of 8 at
    224^2), each forward beside dense VGG-16 with its Optimize time; P7
    ``configs/low-rank-exp/low-rank-exp-v2_l2345_alexnet.py`` beside dense
    AlexNet; P8 ``configs/quant/int8-qat_ce_alexnet.py`` for 4 steps on
    Synthetic data (8 QAT twins, every loss finite, every observer warm), then
    ``convert_qat_to_int8`` (8 modules): 8 ``qmatmul`` launches per int8
    forward and per replay at AlexNet's 8 shapes, int8 logits against the
    plain versions (1e-3) and against the fake-quant and float32 models
    (0.12), timed beside float32 and profiled, each (M, K, N) bit for bit on
    its own inputs beside ``torch._int_mm``; F4
    ``configs/vgg/low-rank-exp-v3_l2-kd_vgg16.py`` (CIFAR-10 cut to Synthetic)
    for 4 steps, every loss finite, a teacher with no V3 layer;
13. drives width pruning at full width (weights from seed 0, Synthetic data,
    each cut printed, the card's name and power limit beside the numbers):
    first ``msca_fused`` and ``parallel_cascade`` against their plain versions
    at the pruned widths (C = 16/32/80/128 for MscaRep d1+fix and the dconv0
    cascades, 48/128/256/384 for DwSepRep r1).  P9
    ``configs/prune/ffn-prune_dd_l2-asym_mscan-t.py`` through the Runner:
    calibration (2 batches of 8 at 224^2), FfnPrune(0.75) on 13 FFNs (hiddens
    192/384/480/768) solved on the card, each site solved again on the CPU with
    the same taps (how many kept sets differ; the reconstruction error on the
    calibration maps within 1e-3 of the CPU's where the sample has full rank),
    the asym L2 fine-tune cut to 4 steps (every loss finite, 13 ``msca_fused``
    launches per step in the teacher, the teacher equal to the unpruned
    model), the forward (13 launches, logits within 1e-4 of the plain version)
    beside dense MSCAN-t, the Optimize and calibration seconds.  P10 the
    pruned MSCAN-t quad (``prune_trunks(0.5, 64)``, AttnPrune(0.5),
    FfnPrune(0.5, 128); trunks 16/32/64/128, branches 16/32/80/128, hiddens
    128/256/256/512) with MscaRep d1+fix (13 ``msca_fused`` per forward) and
    dconv0 (26 ``parallel_cascade``), folded, 1x1s as matmuls: logits, graph
    replays, eager, graph and back-to-back times beside dense MSCAN-t and the
    unpruned d1+fix form (P16 runs arbitrated_apply).  P11 the
    pruned ConvNeXt-T quad (``prune_trunks(0.5, 128)``, MlpPrune(0.5, 128),
    DwSepRep r1, ``quantize_int8``): 18 ``parallel_cascade`` and 41 ``qmatmul``
    per forward, logits, a replay, every (M, K, N) bit for bit, timed beside
    dense ConvNeXt-T and the unpruned r1 and int8 forms.  P12
    ``configs/prune/trunk-prune_ce_resnet18.py`` and
    ``chain-prune_ce_vgg16.py`` through the Runner (4 trunk groups and 8
    junctions; 14 junctions), the CE fine-tune cut to 4 steps, the last
    checkpoint restored bit for bit through the same config, then
    ``fold_batchnorm`` + ``quantize_int8``: ``qmatmul`` bit for bit at each
    shape, int8 logits, float32 and int8 timed beside the dense model;
14. drives SegNeXt-T (150 classes, weights from seed 0, f32, TF32 off; the
    card's name and power limit beside the numbers): P13 ``msca_fused``
    against its plain version at SegNeXt-T's four stage shapes at b=16, 512^2
    (128^2 and 64^2 take the two-band march), in both bank forms, then
    ``configs/msca-rep/msca-rep_d1_fix_segnext-t.py`` through the CLI (the
    Runner and InferenceTimeHook at (16, 512, 512, 3): 13 ``msca_fused``
    launches per forward, logits within 1e-4 of the plain version and the
    module path), a ``compile_serving`` graph (26 kernels per replay, within
    1e-6 of eager), eager, graph and back-to-back times beside dense SegNeXt-T,
    and profiles; F6 ``configs/msca-rep/finetune/msca-rep-d1-fix_l2-asym_segnext-t.py``
    through the Runner cut to 4 steps and one validation of 2 batches on
    SyntheticSeg (b=16, 512^2, drop path 0): every loss finite, 13 launches per
    step (the teacher) and per validation forward, a step on a 128^2 crop on the
    card within 1e-4 of the CPU's, the last checkpoint bit for bit, the step's
    ms, mIoU and aAcc; P14 the CAM CLI on the dense MSCAN-t classifier for
    ``attn`` and the 11 methods at the first and the last block (every heatmap
    finite and non-negative, 13 ``msca_fused`` launches per forward, re-forwards
    included, ms per heatmap), then each heatmap on a 64^2 image on the card
    against the CPU within 1e-4 (xgradcam and ablationcam amplify rounding: what
    they are given is held instead);
15. P15, deploy mode: ``configs/msca-rep/msca-rep_d1_fix_mscan-t.py`` solved
    through the CLI, then run again by the CLI with ``--checkpoint`` on its
    ``.pt`` (``Runner(deploy=True, skip_optim=True, skip_post=True)``: bare MSCA
    targets, no solve), its logits bit-equal to the solved model's at b=64,
    224^2 and 13 ``msca_fused`` launches per forward; then the inference CLI
    (``ClassInference``) on phase 5's dodecomp AlexNet checkpoint at b=64 with
    ``--decomp --never-lose --quantize int8``: each report's ms (a graph
    replayed back to back) and eager median, MACs and params,
    ``lowrank_conv`` once per factored site per forward in ``approximated``,
    ``decomposed`` and ``never-lose``, ``qmatmul`` once per int8 module per
    forward in ``int8``, and the decision table written;
16. P16, the arbiters, each called twice on a fresh model with the default
    timer (on the card a ``compile_serving`` graph replayed back to back per
    timing, the eager median printed beside each reading, the peak memory
    after each call): ``never_lose_deploy`` on phase 11's solved scheme-1
    VGG-16 loaded in deploy mode (b=64, 224^2): each site's rematerialized
    dense conv within 1e-5 of the factored layer's plain version, the decision
    table with its times, the final logits within 1e-4 of the all-factored
    model's, and the final model re-timed within 3 % of the better form; then
    ``arbitrated_apply(FfnRep(fix=True))`` on MSCAN-t d1+fix grouped by stage:
    the measured table, and a replay from it that times nothing and gives the
    same structure and logits bit for bit; the two calls' decisions agree, or
    the first decision they take apart was, in each call, a reading within 2 %
    of its bar (the best time so far less the margin), both lists printed;
17. P17, the serving planner: ``plan_serving`` on MSCAN-t at the planner's
    default type (bfloat16), then ConvNeXt-T (layer scales 1) in float32, at
    b=64, 224^2, the default candidates (without
    ConvNeXt-T's MlpPrune ones: their greedy selection runs on the host), each
    timed as the default timer times with its launches per forward counted:
    the report rows (graph ms and eager ms) and the winner, dense/float32
    qualified, every built row timed, the launches per forward of the
    candidates whose kernels are known, and ``reuse_plan`` rebuilding the
    winner with no timing call and logits within 1e-4 of the plan's; then
    the plan again: the same winner, or in each call the two winners' rows
    within 2 %;
18. P18, the serving export: ``torch.library.opcheck`` of the four kernels'
    custom ops on the card at one shape of each path, in float32 and in bf16;
    the MSCAN-t headline
    surface at b=64 (``msca_fused``), its dconv0 form at b=128
    (``parallel_cascade``), the dodecomp AlexNet with phase 5's checkpoint
    through ``export_model`` (``lowrank_conv``) and
    ``configs/resnet/serve_int8_resnet50.py`` through ``export_model
    --quantize int8 --symbolic-batch`` (``qmatmul``), each exported, saved,
    loaded and captured as a graph: the custom-op nodes, launches per eager
    forward and per replay (counted in the capture) equal to the live model's,
    the logits within 1e-6 (max-abs relative; int8 bit-equal), the live model
    at that batch against its plain versions (1e-4, int8 1e-3), export s, load
    s, size, graph and back-to-back ms beside the live model's graph; the
    headline surface exported with a symbolic batch serving b = 1, 2, 64, 65
    within 1e-6 of the live forward and 1e-4 of it through ``msca_fused_ref``
    (below the artifact's batch range, 2 on the card, through ``pad_batch`` as
    ``serve`` does); b=1 through ``pad_batch(., 2)`` against b=1 direct, as
    graphs of the live surface; ``serve_mscan`` at b=128 and ``serve
    --artifact`` of the int8 ResNet-50 at b=128 (plain and ``--ship-uint8``),
    32 batches each, their end-to-end img/s against 128 / the graph's
    back-to-back ms, and a b=128 batch of the served int8 graph bit-equal to
    the live model and within 1e-3 of it through ``qmatmul_ref``;
19. P19, bf16 serving: P19a each kernel with bf16 x and out against its
    bf16 plain version at its path's shapes (``parallel_cascade`` at ConvNeXt-T
    r1's and the dconv0 cascades' shapes and ``qmatmul`` at int8 ConvNeXt-T's
    13 and 3 ragged shapes bit for bit; ``msca_fused`` at MSCAN-t's 8 block
    shapes and ``lowrank_conv`` at the dodecomp AlexNet's 4 sites the float32
    kernel's result rounded once, bit for bit, and within one bf16 ulp of the
    plain version, or one ulp plus the float32 results' own difference where
    the result is a cancellation), each timed beside its plain version, its
    bound (2-byte activations) and one PyTorch call in bf16; P19b the headline
    surface cast to bf16 through ``InferenceTimeHook(bf16=True)`` at b=64 (13
    ``msca_fused`` per forward and per replay, logits within 1e-2 of the plain
    versions, their distance from float32, no copy kernel beside a port kernel)
    and dense MSCAN-t in bf16; P19e that surface exported (bf16 avals,
    bit-equal); P19c ``serve_mscan`` at its defaults (bf16, b=128, 26
    ``parallel_cascade`` per forward); P19d the inference CLI with ``--dtype
    bfloat16 --decomp --quantize int8`` on phase 5's AlexNet (4
    ``lowrank_conv`` per forward, ``qmatmul`` once per int8 module);
20. prints one JSON line of kernel results (each kernel's entry lists the later
    paths' launches and sums per forward under ``paths``, the bf16 ones among
    them), then ``{"ok": true, "device": ...}``.

Phases 4-14 run ``InferenceTimeHook`` with its graph slope at HOOK_GRAPH_ITERS
(2 and 8 replays, a fifth of the default; the eager median that their gates
and readings use keeps the config's iterations), and each phase group's wall
time is printed.  Every failed check exits non-zero without the result lines,
as does a run without a CUDA device or outside a checkout of the repository.  Random weights
come from a seeded generator; no network is used.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "convnet_approximater_tpu_torch"
SOURCES = ("msca_fused.cu", "lowrank_conv.cu", "parallel_cascade.cu", "qmatmul.cu")
CONFIG = os.path.join(REPO, "configs", "msca-rep", "msca-rep_d1_fix_mscan-t.py")
ALEX_DODECOMP = os.path.join(REPO, "configs", "low-rank-exp",
                             "low-rank-exp-v1_l2345_svd_dodecomp_alexnet.py")
ALEX_SVD = os.path.join(REPO, "configs", "low-rank-exp", "low-rank-exp-v1_l2345_svd_alexnet.py")
ALEX_NAMES = ["features.3", "features.6", "features.8", "features.10"]
CONVNEXT_R1 = os.path.join(REPO, "configs", "convnext", "dw-sep-rep_r1_convnext-t.py")
CONVNEXT_R2 = os.path.join(REPO, "configs", "convnext", "dw-sep-rep_r2_convnext-t.py")
MSCAN_DCONV0 = os.path.join(REPO, "configs", "msca-rep", "msca-rep_d1_fix_dconv0_mscan-t.py")
# ConvNeXt-T at 224^2: (H = W, C, blocks) of its four stages
CONVNEXT_STAGES = [(56, 96, 3), (28, 192, 3), (14, 384, 9), (7, 768, 3)]
# int8 ConvNeXt-T at b=64: (M, K, N) of each qmatmul call and its calls per forward
QMM_SHAPES = [((200704, 48, 96), 1), ((50176, 384, 192), 1), ((12544, 768, 384), 1),
              ((3136, 1536, 768), 1),
              ((200704, 96, 384), 3), ((50176, 192, 768), 3), ((12544, 384, 1536), 9),
              ((3136, 768, 3072), 3),
              ((200704, 384, 96), 3), ((50176, 768, 192), 3), ((12544, 1536, 384), 9),
              ((3136, 3072, 768), 3),
              ((64, 768, 1000), 1)]
# shapes that no tile divides: M off 64 and 128, K off 32 (and off 4: the wrapper pads it), odd N
QMM_RAGGED = [(1000, 100, 250), (130, 33, 7), (4097, 776, 130)]
GRAD_TOL = 1e-6     # eval-mode gradients against the module path's: the same ops, deterministic
INT8_TOL = 1e-3     # int8 logits against the same int8 model through the plain versions
INT8_F32_TOL = 0.12  # int8 against float32 logits, max-abs relative (tests/test_quant.py's bound)
KERNEL_TOL = 1e-5   # relative (norm) error of a kernel against its plain version
LOGITS_TOL = 1e-4   # relative error of the logits, through the whole network
STAGES = [(56, 32, 3), (28, 64, 3), (14, 160, 5), (7, 256, 2)]  # (H = W, C, blocks) at 224^2
MSCA_KERNELS = ("march_kernel<", "mix_kernel<")  # msca_fused's two kernels, by name
# msca_fused off MSCAN-t's shapes: (B, H, W, C, k0, ks, identity, fix_p); the first three take
# march_kernel<21, 5, 4>, the rest march_any_kernel (the widest bank, the most branches, the
# largest conv0 that MSCA fuses)
MSCA_RAGGED = {"H != W": (4, 20, 37, 32, 5, (21,), False, 10),
               "C = 40": (4, 12, 12, 40, 5, (7, 11, 21), True, 0),
               "fix_p > H": (4, 6, 9, 32, 5, (21,), False, 10),
               "k0 = 3, two k": (4, 16, 17, 32, 3, (9, 13), False, 4),
               "k0 = 7, k_max = 45": (2, 12, 20, 40, 7, (33, 45), True, 3),
               "k_max = 127": (2, 9, 70, 32, 5, (127,), False, 4),
               "eight branches": (2, 10, 11, 40, 5, (3, 5, 7, 9, 11, 13, 15, 15), True, 0),
               "k0 = 31": (2, 12, 12, 32, 31, (7,), True, 0)}
# AlexNet's convs 2-5 at 224^2: (H = W, C, k, padding, M bases of the config, N)
ALEX_CONVS = [(27, 64, 5, 2, 8, 192), (13, 192, 3, 1, 8, 384), (13, 384, 3, 1, 6, 256),
              (13, 256, 3, 1, 4, 256)]
# the scheme-1 3x3s at 224^2: (H = W, C, N, stride, calls per forward); ResNet-18's 16 block
# convs take M = 4 bases, VGG-16's convs 2-13 M = 16
RESNET18_CONVS = [(56, 64, 64, 1, 4), (56, 64, 128, 2, 1), (28, 128, 128, 1, 3),
                  (28, 128, 256, 2, 1), (14, 256, 256, 1, 3), (14, 256, 512, 2, 1),
                  (7, 512, 512, 1, 3)]
VGG16_CONVS = [(224, 64, 64, 1, 1), (112, 64, 128, 1, 1), (112, 128, 128, 1, 1),
               (56, 128, 256, 1, 1), (56, 256, 256, 1, 2), (28, 256, 512, 1, 1),
               (28, 512, 512, 1, 2), (14, 512, 512, 1, 3)]
# lowrank_conv off AlexNet's shapes: (B, H, W, C, M, N, (kh, kw), (sh, sw), (ph, pw)); every
# one has P = B Ho Wo off the 128-pixel tile, all but the 1 x 1 one tiles that cross images
LOWRANK_RAGGED = {"stride 2, C = 6, N = 10": (8, 13, 13, 6, 4, 10, (5, 5), (2, 2), (2, 2)),
                  "H != W": (4, 9, 11, 16, 8, 96, (3, 3), (1, 1), (1, 1)),
                  "kh != kw, stride (1, 2), odd M": (3, 10, 7, 9, 3, 17, (3, 5), (1, 2), (1, 2)),
                  "M = 10 (two slabs)": (2, 6, 5, 20, 10, 40, (3, 3), (1, 1), (1, 1)),
                  "1 x 1 basis, N = 200": (1, 40, 41, 8, 2, 200, (1, 1), (1, 1), (0, 0)),
                  "conv2 at b=5": (5, 27, 27, 64, 8, 192, (5, 5), (1, 1), (2, 2))}
BATCH = 64
EXP_RATIOS = (8, 8, 4, 4)  # MSCAN-t's FFN hidden width over C, per stage
# pointwise convs of the headline MSCAN-t: proj_1, proj_2, channel_mix and fc2 of 13 blocks and
# fc1 of the 7 blocks FfnRep leaves (JAX's enable_pw_matmul on the same structure:
# tests/test_torch_deploy.py)
HEADLINE_PW = 59
EXACT_TOL = 5e-3    # the exact-rewrite gate of bench.py:199-202: max-abs on the logits
REPLAY_TOL = 1e-6   # a graph replay against the eager forward: the same kernels on the same inputs
SERVE_BATCHES = 8
HOOK_GRAPH_ITERS = 2  # n of phases 4-14's graph slopes (n and 4n replays): the default's fifth
# the port's kernels as torch.profiler names them
KERNEL_NAMES = {"msca_fused march": ("march_kernel<", "march_any_kernel"),
                "msca_fused mix": ("mix_kernel<",),
                "parallel_cascade": ("uniform_kernel<", "ring_kernel"),
                "lowrank_conv": ("lowrank_kernel<",),
                "qmatmul": ("qmatmul_kernel<",)}
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_F32 = 67e12      # H100 SXM float32 outside the tensor cores, FLOP/s
PEAK_TF32 = 495e12    # H100 SXM TF32 tensor cores, dense, FLOP/s
PEAK_INT8 = 1979e12   # H100 SXM int8 tensor cores, dense, OP/s


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def is_kernel(event) -> bool:
    """Whether a torch.profiler event is device work, not the span of a
    record_function range on the device (the kernel wrappers open one while
    the profiler records)."""
    import torch

    return (event.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


def rel_err(a, b) -> float:
    return float((a - b).norm() / b.norm())


def bound(nbytes: float, flops: float, peak: float = PEAK_F32):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def msca_cost(H, C, ks, identity, fix_p, k0=5, batch=BATCH):
    """(bytes, FLOP) of one msca_fused call at ``batch``: x read and out
    written once, the weights read once; per element the k0^2 conv0, each
    branch's horizontal and vertical taps with their biases, the identity, the
    C-wide channel mix, its bias and the gate; the border fix on 2 min(H, p) rows."""
    n = batch * H * H * C
    per = 2 * k0 * k0 + 1 + sum(4 * k + 2 for k in ks) + int(identity) + 2 * C + 2
    flops = n * per + 2 * min(H, fix_p) * batch * H * C
    weights = k0 * k0 * C + C + len(ks) * (2 * max(ks) + 2) * C + C * C + C + 2 * fix_p * C
    return 4 * (2 * n + weights), flops


def lowrank_cost(B, H, W, C, M, N, kernel_size, stride, padding, form):
    """(bytes, basis FLOP, mix FLOP) of one lowrank_conv call: x read and y
    written once, the weights read once; the basis passes (kh + kw taps per
    basis and element when separable, kh kw when full) and the mix with its bias."""
    (kh, kw), (sh, sw), (ph, pw) = kernel_size, stride, padding
    Ho, Wo = (H + 2 * ph - kh) // sh + 1, (W + 2 * pw - kw) // sw + 1
    P = B * Ho * Wo
    taps = kh + kw if form == "sep" else kh * kw
    weights = M * taps + M * C * N + N
    return 4 * (B * H * W * C + P * N + weights), 2 * P * C * M * taps, 2 * P * M * C * N + P * N


def lowrank_bound(nbytes: float, basis_flops: float, mix_flops: float):
    """(ms, "bytes" or "operations") of lowrank_conv on its route: the mix as
    3xTF32, three TF32 products per float32 product at 495 TFLOP/s, the basis
    passes in float32 at 67 TFLOP/s."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (basis_flops / PEAK_F32 + 3 * mix_flops / PEAK_TF32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cascade_cost(H, C, ks, identity):
    """(bytes, FLOP) of one parallel_cascade call at batch BATCH: x read and out
    written once, the packed taps and biases read once; per element each
    branch's horizontal and vertical taps with their biases, and the identity."""
    n = BATCH * H * H * C
    flops = n * (sum(4 * k + 2 for k in ks) + int(identity))
    return 4 * (2 * n + len(ks) * (2 * max(ks) + 2) * C), flops


def qmm_cost(M, K, N):
    """(bytes, int8 operations) of one qmatmul call: x (float32) read and y
    (float32) written once, the int8 weight, its scales and the bias read once;
    2 M N K operations of the product."""
    return 4 * M * K + K * N + 4 * (2 * N + 1) + 4 * M * N, 2 * M * N * K


def cuda_ms(fn, iters: int = 25, warmup: int = 3) -> float:
    """Median device milliseconds of ``fn()`` over ``iters`` CUDA-event-timed runs.

    Before each run a sleep kernel holds the stream for about twice the host
    time ``fn`` takes to enqueue its work, so that the events time the device
    work alone and not the Python around a launch (which, at the small shapes,
    is longer than the kernel)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    cycles = int(max(2e6, 4e9 * host_s))  # 2 x the host time at up to 2 GHz
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_pair(kernel, plain, iters: int = 25):
    """Median ms of kernel and plain version, taken in turns: plain, kernel, kernel, plain."""
    p = [cuda_ms(plain, iters)]
    k = [cuda_ms(kernel, iters) for _ in range(2)]
    p.append(cuda_ms(plain, iters))
    return float(np.median(k)), float(np.median(p))


def kernel_inputs(form: str, H: int, C: int, gen, batch: int = BATCH):
    """Random inputs of one MSCA block of MSCAN-t at (batch, H, H, C): the dense
    (7, 11, 21) bank with identity, or the d1+fix single 21-tap cascade with
    fix_p = 10."""
    import torch

    from convnet_approximater_tpu_torch.ops.msca_fused import pack_cascade_weights

    def u(*shape, scale=1.0):
        return (torch.rand(*shape, generator=gen) * 2 - 1) * scale

    ks = (7, 11, 21) if form == "dense" else (21,)
    w1, b1, w2, b2, ks = pack_cascade_weights(
        [u(k, C, scale=k ** -0.5) for k in ks],
        [u(C, scale=0.2) if form == "dense" else None for _ in ks],
        [u(k, C, scale=k ** -0.5) for k in ks],
        [u(C, scale=0.2) for _ in ks])
    fix_p = 10 if form == "d1fix" else 0
    args = [u(batch, H, H, C), u(5, 5, C, scale=0.2), u(C, scale=0.2), w1, b1, w2, b2,
            u(C, C, scale=C ** -0.5), u(C, scale=0.2), u(2, fix_p, C) if fix_p else None]
    args = [a.cuda() if a is not None else None for a in args]
    return args, dict(ks=ks, identity=form == "dense", fix_p=fix_p)


def msca_inputs(B, H, W, C, k0, ks, fix_p, gen):
    """Random inputs of an msca_fused call with every bias, packed as the kernel takes them."""
    import torch

    from convnet_approximater_tpu_torch.ops.msca_fused import pack_cascade_weights

    def u(*shape, scale=1.0):
        return (torch.rand(*shape, generator=gen) * 2 - 1) * scale

    w1, b1, w2, b2, ks = pack_cascade_weights(
        [u(k, C, scale=k ** -0.5) for k in ks], [u(C, scale=0.2) for _ in ks],
        [u(k, C, scale=k ** -0.5) for k in ks], [u(C, scale=0.2) for _ in ks])
    args = [u(B, H, W, C), u(k0, k0, C, scale=0.2), u(C, scale=0.2), w1, b1, w2, b2,
            u(C, C, scale=C ** -0.5), u(C, scale=0.2), u(2, fix_p, C) if fix_p else None]
    return [a.cuda() if a is not None else None for a in args], ks


def check_msca_plan(x, w0, w1, ks):
    """The planner's shared memory against the kernel's for this call; returns the plan."""
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops

    B, H, W, C = x.shape
    p = fused_ops.plan(B, H, W, C, w0.shape[0], tuple(ks))
    smem = fused_ops._library().msca_fused_smem_bytes(p.K, w0.shape[0], w1.shape[0], p.g, p.warps,
                                                      p.tw)
    if smem != p.smem:
        fail(f"msca_fused {(B, H, W, C)}: the planner's shared memory {p.smem} differs from "
             f"the kernel's {smem}")
    return p


def msca_row(form, H, C, blocks, gen, batch: int = BATCH):
    """msca_fused against msca_fused_ref on one MSCA block's random inputs of
    ``form`` (see kernel_inputs) at (batch, H, H, C), timed beside it, with its
    bound and its planner's shared memory checked; the row."""
    import torch

    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops

    args, kw = kernel_inputs(form, H, C, gen, batch)
    y = fused_ops.msca_fused(*args, **kw)
    y_ref = fused_ops.msca_fused_ref(*args, **kw)
    torch.cuda.synchronize()
    err, abs_err = rel_err(y, y_ref), float((y - y_ref).abs().max())
    if not torch.isfinite(y).all() or err > KERNEL_TOL:
        fail(f"msca_fused {form} {(batch, H, H, C)}: rel err {err:.3e} > {KERNEL_TOL}")
    p = check_msca_plan(args[0], args[1], args[3], kw["ks"])
    ms, plain_ms = time_pair(lambda: fused_ops.msca_fused(*args, **kw),
                             lambda: fused_ops.msca_fused_ref(*args, **kw))
    nbytes, flops = msca_cost(H, C, kw["ks"], kw["identity"], kw["fix_p"], batch=batch)
    b_ms, b_by = bound(nbytes, flops)
    row = dict(form=form, shape=(batch, H, H, C), blocks=blocks, rel_err=err,
               max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bytes=nbytes, flops=flops,
               bound_ms=b_ms)
    print(f"msca_fused {form:5s} x{row['shape']}: rel err {err:.3e} (bound "
          f"{KERNEL_TOL}), max abs err {abs_err:.3e}, kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (median of 25 CUDA-event runs, x2); bound {b_ms:.4f} ms "
          f"by {b_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP), "
          f"roofline share {b_ms / ms:.1%}; plan G {p.g}, {p.ntiles} tiles of {p.tw}, "
          f"{p.bands} bands, {p.blocks} blocks, {p.smem} B, {p.launches} launches")
    return row


def check_kernel(gen):
    """msca_fused against msca_fused_ref at MSCAN-t's eight block shapes (the dense
    7/11/21 bank with identity and the d1+fix 21-tap cascade with fix_p = 10) and
    at ragged shapes; per-forward sums of both forms."""
    import torch

    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops

    rows = [msca_row(form, H, C, blocks, gen) for form in ("dense", "d1fix")
            for H, C, blocks in STAGES]
    for form in ("dense", "d1fix"):
        sel = [r for r in rows if r["form"] == form]
        total = {k: sum(r[k] * r["blocks"] for r in sel) for k in ("ms", "plain_ms", "bound_ms")}
        print(f"msca_fused per {form} MSCAN-t forward ({sum(r['blocks'] for r in sel)} calls): "
              f"kernel {total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, bound "
              f"{total['bound_ms']:.4f} ms")
    ragged_gen = torch.Generator().manual_seed(1)  # leaves the later phases' draws as they were
    for name, (B, H, W, C, k0, ks, identity, fix_p) in MSCA_RAGGED.items():
        args, ks = msca_inputs(B, H, W, C, k0, ks, fix_p, ragged_gen)
        kw = dict(ks=ks, identity=identity, fix_p=fix_p)
        y = fused_ops.msca_fused(*args, **kw)
        y_ref = fused_ops.msca_fused_ref(*args, **kw)
        torch.cuda.synchronize()
        err = rel_err(y, y_ref)
        if not torch.isfinite(y).all() or err > KERNEL_TOL:
            fail(f"msca_fused ragged {name} {(B, H, W, C)} k0={k0} ks={ks}: rel err {err:.3e} "
                 f"> {KERNEL_TOL}")
        p = check_msca_plan(args[0], args[1], args[3], ks)
        print(f"msca_fused ragged ({name}) x{(B, H, W, C)} k0={k0} ks={ks} identity={identity} "
              f"fix_p={fix_p}: rel err {err:.3e} (bound {KERNEL_TOL}); "
              f"{'march_kernel' if p.g == fused_ops.FAST_G else 'march_any_kernel'}, K {p.K}, "
              f"{p.ntiles} tiles of {p.tw}, {p.bands} bands of {p.rows}")
        del args, y, y_ref
    return rows


def lowrank_inputs(B, H, W, C, M, N, kernel_size, form, gen):
    """Random inputs of a lowrank_conv call: x, A_mc, b and the bases (v, h or bases)."""
    import torch

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    kh, kw = kernel_size
    taps = dict(v=r(M, kh), h=r(M, kw)) if form == "sep" else dict(bases=r(M, kh, kw))
    return r(B, H, W, C), r(M * C, N, scale=(M * C) ** -0.5), r(N, scale=0.1), taps


def check_lowrank_plan(B, H, W, C, M, N, kernel_size, stride, padding):
    """The planner's shared memory against the kernel's for this call; returns the plan."""
    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops

    p = lowrank_ops.plan(B, H, W, C, M, N, kernel_size, stride, padding)
    smem = lowrank_ops._library().lowrank_conv_smem_bytes(
        p.ms, p.bn, p.stages, p.qpg, p.rw, p.wv, kernel_size[0] * kernel_size[1],
        p.ms * p.slabs)
    if smem != p.smem:
        fail(f"lowrank_conv {(B, H, W, C)}: the planner's shared memory {p.smem} differs from "
             f"the kernel's {smem}")
    return p


def check_lowrank_kernel(gen):
    """lowrank_conv against lowrank_conv_ref at AlexNet's convs 2-5 in the
    separable and the full-bases forms, the weights packed once as the layer
    caches them; beside it cuDNN's dense conv of the merged weight W_eff[n, c]
    = sum_m A_mc[m C + c, n] basis_m, the same function as one library call;
    then the ragged shapes in both forms, the first with no packed weights (the
    wrapper packs them), the others packed."""
    import torch
    import torch.nn.functional as F

    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops

    rows = []
    for H, C, k, pad, M, N in ALEX_CONVS:
        for form in ("sep", "full"):
            x, A, b, taps = lowrank_inputs(BATCH, H, H, C, M, N, (k, k), form, gen)
            kw = dict(kernel_size=(k, k), stride=(1, 1), padding=(pad, pad), **taps)
            packed = lowrank_ops.pack_kernel_weights(A, **taps)
            y = lowrank_ops.lowrank_conv(x, A, b, packed=packed, **kw)
            y_ref = lowrank_ops.lowrank_conv_ref(x, A, b, **kw)
            torch.cuda.synchronize()
            err, abs_err = rel_err(y, y_ref), float((y - y_ref).abs().max())
            if not torch.isfinite(y).all() or err > KERNEL_TOL:
                fail(f"lowrank_conv {form} {(BATCH, H, H, C)} M={M} N={N}: rel err {err:.3e} "
                     f"> {KERNEL_TOL}")
            p = check_lowrank_plan(BATCH, H, H, C, M, N, (k, k), (1, 1), (pad, pad))
            ms, plain_ms = time_pair(lambda: lowrank_ops.lowrank_conv(x, A, b, packed=packed, **kw),
                                     lambda: lowrank_ops.lowrank_conv_ref(x, A, b, **kw))
            basis = taps["bases"] if form == "full" else taps["v"][:, :, None] * taps["h"][:, None]
            w_eff = torch.einsum("mcn,mij->ncij", A.reshape(M, C, N), basis).contiguous()
            xc = x.permute(0, 3, 1, 2)  # an NCHW view of x, channels_last
            y_lib = F.conv2d(xc, w_eff, b, padding=pad).permute(0, 2, 3, 1)
            lib_err = rel_err(y_lib, y_ref)
            lib_ms = library_time(lambda: F.conv2d(xc, w_eff, b, padding=pad))
            nbytes, basis_flops, mix_flops = lowrank_cost(BATCH, H, H, C, M, N, (k, k), (1, 1),
                                                          (pad, pad), form)
            b_ms, b_by = lowrank_bound(nbytes, basis_flops, mix_flops)
            f32_ms, _ = bound(nbytes, basis_flops + mix_flops)
            rows.append(dict(form=form, shape=(BATCH, H, H, C), rel_err=err, max_abs_err=abs_err,
                             ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes,
                             basis_flops=basis_flops, mix_flops=mix_flops, bound_ms=b_ms,
                             f32_bound_ms=f32_ms))
            print(f"lowrank_conv {form:4s} x{(BATCH, H, H, C)} k={k} M={M} N={N}: rel err "
                  f"{err:.3e} (bound {KERNEL_TOL}), max abs err {abs_err:.3e}, kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms (median of 25 CUDA-event runs, x2), cuDNN conv of "
                  f"W_eff {lib_ms:.4f} ms (rel diff {lib_err:.1e}); bound {b_ms:.4f} ms by {b_by} "
                  f"on the 3xTF32 route ({nbytes / 1e6:.1f} MB, {basis_flops / 1e9:.3f} + "
                  f"{mix_flops / 1e9:.3f} GFLOP), {f32_ms:.4f} ms in float32 at 67 TFLOP/s; "
                  f"roofline share {b_ms / ms:.1%} (f32 {f32_ms / ms:.1%}); plan BN {p.bn}, "
                  f"MS {p.ms} x {p.slabs}, {p.qpg} quads x {p.rw} x {p.wv} window, "
                  f"{p.stages} stages, {p.row_tiles} x {p.col_tiles} blocks, {p.smem} B")
            del x, A, b, taps, packed, y, y_ref, y_lib, w_eff, xc
    for form in ("sep", "full"):
        sel = [r for r in rows if r["form"] == form]
        total = {k: sum(r[k] for r in sel)
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms", "f32_bound_ms")}
        print(f"lowrank_conv per {'dodecomp' if form == 'sep' else 'full-bases'} AlexNet forward "
              f"(4 calls): kernel {total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, cuDNN "
              f"conv of W_eff {total['library_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms "
              f"(3xTF32 route), {total['f32_bound_ms']:.4f} ms (float32)")
    ragged_gen = torch.Generator().manual_seed(2)  # leaves the later phases' draws as they were
    for i, (name, (B, H, W, C, M, N, ks, st, pad)) in enumerate(LOWRANK_RAGGED.items()):
        for form in ("sep", "full"):
            x, A, b, taps = lowrank_inputs(B, H, W, C, M, N, ks, form, ragged_gen)
            kw = dict(kernel_size=ks, stride=st, padding=pad, **taps)
            packed = None if i == 0 else lowrank_ops.pack_kernel_weights(A, **taps)
            y = lowrank_ops.lowrank_conv(x, A, b, packed=packed, **kw)
            y_ref = lowrank_ops.lowrank_conv_ref(x, A, b, **kw)
            torch.cuda.synchronize()
            err = rel_err(y, y_ref)
            if not torch.isfinite(y).all() or err > KERNEL_TOL:
                fail(f"lowrank_conv ragged {name} {form} {(B, H, W, C)} M={M} N={N}: rel err "
                     f"{err:.3e} > {KERNEL_TOL}")
            p = check_lowrank_plan(B, H, W, C, M, N, ks, st, pad)
            print(f"lowrank_conv ragged ({name}) {form:4s} x{(B, H, W, C)} M={M} N={N} "
                  f"k={ks} stride={st} pad={pad}: rel err {err:.3e} (bound {KERNEL_TOL}); "
                  f"plan BN {p.bn}, MS {p.ms} x {p.slabs}, {p.qpg} quads x {p.rw} x {p.wv} "
                  f"window, {p.row_tiles} x {p.col_tiles} blocks")
            del x, A, b, taps, packed, y, y_ref
    return rows


def check_lowrank_model_shapes(gen, model, convs, M):
    """lowrank_conv against lowrank_conv_ref at ``model``'s scheme-1 shapes at
    b=64, 224^2 (separable bases, M of the config), the weights packed once as
    the layer caches them, with the planner's shared memory against the
    kernel's and cuDNN's conv of the merged weight W_eff timed beside it;
    times over 10 CUDA-event runs (x2).  Returns the rows, with calls per forward."""
    import torch
    import torch.nn.functional as F

    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops

    rows = []
    for H, C, N, st, calls in convs:
        x, A, b, taps = lowrank_inputs(BATCH, H, H, C, M, N, (3, 3), "sep", gen)
        kw = dict(kernel_size=(3, 3), stride=(st, st), padding=(1, 1), **taps)
        packed = lowrank_ops.pack_kernel_weights(A, **taps)
        y = lowrank_ops.lowrank_conv(x, A, b, packed=packed, **kw)
        y_ref = lowrank_ops.lowrank_conv_ref(x, A, b, **kw)
        torch.cuda.synchronize()
        err, abs_err = rel_err(y, y_ref), float((y - y_ref).abs().max())
        if not torch.isfinite(y).all() or err > KERNEL_TOL:
            fail(f"lowrank_conv {model} {(BATCH, H, H, C)} stride {st} M={M} N={N}: rel err "
                 f"{err:.3e} > {KERNEL_TOL}")
        del y_ref
        p = check_lowrank_plan(BATCH, H, H, C, M, N, (3, 3), (st, st), (1, 1))
        ms, plain_ms = time_pair(lambda: lowrank_ops.lowrank_conv(x, A, b, packed=packed, **kw),
                                 lambda: lowrank_ops.lowrank_conv_ref(x, A, b, **kw), iters=10)
        basis = taps["v"][:, :, None] * taps["h"][:, None]
        w_eff = torch.einsum("mcn,mij->ncij", A.reshape(M, C, N), basis).contiguous()
        xc = x.permute(0, 3, 1, 2)  # an NCHW view of x, channels_last
        lib_err = rel_err(F.conv2d(xc, w_eff, b, stride=st, padding=1).permute(0, 2, 3, 1), y)
        lib_ms = library_time(lambda: F.conv2d(xc, w_eff, b, stride=st, padding=1), iters=10)
        nbytes, basis_flops, mix_flops = lowrank_cost(BATCH, H, H, C, M, N, (3, 3), (st, st),
                                                      (1, 1), "sep")
        b_ms, b_by = lowrank_bound(nbytes, basis_flops, mix_flops)
        rows.append(dict(shape=(BATCH, H, H, C), stride=st, N=N, calls=calls, rel_err=err,
                         max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bytes=nbytes, basis_flops=basis_flops, mix_flops=mix_flops,
                         bound_ms=b_ms, plan=p))
        print(f"lowrank_conv {model} x{(BATCH, H, H, C)} stride {st} M={M} N={N} "
              f"x{calls}/forward: rel err {err:.3e} (bound {KERNEL_TOL}), max abs err "
              f"{abs_err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 10 "
              f"CUDA-event runs, x2), cuDNN conv of W_eff {lib_ms:.4f} ms (rel diff "
              f"{lib_err:.1e}); bound {b_ms:.4f} ms by {b_by} on the 3xTF32 route "
              f"({nbytes / 1e6:.1f} MB, {basis_flops / 1e9:.3f} + {mix_flops / 1e9:.3f} GFLOP), "
              f"roofline share {b_ms / ms:.1%}; plan BN {p.bn}, MS {p.ms} x {p.slabs}, {p.qpg} "
              f"quads x {p.rw} x {p.wv} window, {p.stages} stages, chain {p.chain}, "
              f"{p.row_tiles} x {p.col_tiles} blocks, {p.smem} B (planner = kernel)")
        del x, A, b, taps, packed, y, w_eff, xc
        torch.cuda.empty_cache()
    total = {k: sum(r[k] * r["calls"] for r in rows)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    print(f"lowrank_conv per {model} scheme-1 forward ({sum(r['calls'] for r in rows)} calls): "
          f"kernel {total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, cuDNN conv of W_eff "
          f"{total['library_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms (3xTF32 route)")
    return rows


def check_lowrank_launches(gen):
    """One eval-mode separable LowRankExpConvV1 forward (AlexNet's conv2) under
    torch.profiler, its packing cached by a first forward: exactly one kernel,
    lowrank_conv's, reaches the card.  A sleep kernel opens the profiled window
    and is not counted: a profiler session after the first in a process may not
    record its first kernel."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from convnet_approximater_tpu_torch.layers import LowRankExpConvV1

    layer = LowRankExpConvV1(64, 192, 5, 1, 2, 8, decomp=True)
    with torch.no_grad():  # bases shared by every input channel: the kernel's form
        v, h = torch.randn(8, 5, generator=gen), torch.randn(8, 5, generator=gen)
        layer.s_conv.v_conv.weight.copy_(v.repeat(64, 1)[:, None, :, None])
        layer.s_conv.h_conv.weight.copy_(h.repeat(64, 1)[:, None, None, :])
    layer = layer.cuda().eval()
    x = torch.randn(BATCH, 64, 27, 27, generator=gen).cuda().contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        layer(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            layer(x)
            torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if is_kernel(e)
               and "sleep" not in e.name.lower() and "spin" not in e.name.lower()]
    names = [m.group(0) if (m := re.search(r"lowrank_kernel<[^>]*>", k)) else k[:60] for k in kernels]
    print(f"one cached LowRankExpConvV1 forward {(BATCH, 64, 27, 27)}: {len(kernels)} kernels on "
          f"the card: {', '.join(names)}")
    if len(kernels) != 1 or "lowrank_kernel" not in kernels[0]:
        fail("a LowRankExpConvV1 forward must launch lowrank_conv's kernel and nothing else")


def ptxas_summary(source: str, name: str) -> str:
    """Registers and spills of each ``name<...>`` entry function in the build log."""
    import re

    from convnet_approximater_tpu_torch.ops import build as build_ops

    log = build_ops.library_path(source).with_suffix(".log")
    if not log.exists():
        return "not measured (no build log)"
    stats, entry = {}, None
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            m = re.search(name + r"I((?:Li\d+E)+)(f|13__nv_bfloat16)?E", line)
            types = {"f": ["float"], "13__nv_bfloat16": ["bf16"]}.get(m.group(2), []) if m else []
            entry = (f"{name}<{', '.join(re.findall(r'Li(\d+)E', m.group(1)) + types)}>"
                     if m else None)
        elif entry and "spill stores" in line:
            stats.setdefault(entry, []).append(line.strip().replace("bytes ", ""))
        elif entry and "Used" in line and "registers" in line:
            stats.setdefault(entry, []).insert(0, line.split("Used")[1].split(",")[0].strip())
    return "; ".join(f"{k}: {', '.join(v)}" for k, v in stats.items()) or "not measured"


def library_time(fn, iters: int = 25) -> float:
    """Median ms of the yardstick library call, in two turns."""
    return float(np.median([cuda_ms(fn, iters) for _ in range(2)]))


def cascade_row(form, H, C, ks, blocks, gen):
    """parallel_cascade against parallel_cascade_ref, bit for bit, on random
    inputs at (BATCH, H, H, C) with cascades of ``ks``: DwSepRep's form (no
    first bias, the second bias on the last branch), or with ``form`` "msca"
    MSCA's dense bank (every bias and the identity).  Beside it, cuDNN's
    depthwise conv of the merged k x k kernel sum_j v_j (x) h_j, the same
    function where b1 = 0 (all but the dense bank).  The row."""
    import torch
    import torch.nn.functional as F

    from convnet_approximater_tpu_torch.ops import parallel_cascade as cascade_ops
    from convnet_approximater_tpu_torch.ops.msca_fused import pack_cascade_weights

    def u(*shape, scale=1.0):
        return (torch.rand(*shape, generator=gen) * 2 - 1) * scale

    dense = form == "msca"
    w1, b1, w2, b2, ks = pack_cascade_weights(
        [u(k, C, scale=k ** -0.5) for k in ks],
        [u(C, scale=0.2) if dense else None for _ in ks],
        [u(k, C, scale=k ** -0.5) for k in ks],
        [u(C, scale=0.2) if dense or i == len(ks) - 1 else None for i in range(len(ks))])
    w1, b1, w2, b2 = (t.cuda() for t in (w1, b1, w2, b2))
    x = u(BATCH, H, H, C).cuda()
    kw = dict(ks=ks, identity=dense)
    y = cascade_ops.parallel_cascade(x, w1, b1, w2, b2, **kw)
    y_ref = cascade_ops.parallel_cascade_ref(x, w1, b1, w2, b2, **kw)
    torch.cuda.synchronize()
    err, abs_err = rel_err(y, y_ref), float((y - y_ref).abs().max())
    if not torch.isfinite(y).all() or not torch.equal(y, y_ref):
        fail(f"parallel_cascade {form} {(BATCH, H, H, C)}: rel err {err:.3e}, max abs err "
             f"{abs_err:.3e}; the kernel must give parallel_cascade_ref's bits")
    ms, plain_ms = time_pair(lambda: cascade_ops.parallel_cascade(x, w1, b1, w2, b2, **kw),
                             lambda: cascade_ops.parallel_cascade_ref(x, w1, b1, w2, b2, **kw))
    lib_ms = None
    if not dense:
        merged = torch.einsum("bic,bjc->cij", w2, w1)[:, None]  # (C, 1, k, k)
        xc, bias = x.permute(0, 3, 1, 2), b2.sum(0)  # xc: an NCHW view, channels_last
        y_lib = F.conv2d(xc, merged, bias, padding=max(ks) // 2, groups=C)
        lib_err = rel_err(y_lib.permute(0, 2, 3, 1), y_ref)
        lib_ms = library_time(lambda: F.conv2d(xc, merged, bias, padding=max(ks) // 2,
                                               groups=C))
    nbytes, flops = cascade_cost(H, C, ks, dense)
    b_ms, b_by = bound(nbytes, flops)
    row = dict(form=form, shape=(BATCH, H, H, C), blocks=blocks, rel_err=err,
               max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bytes=nbytes, flops=flops, bound_ms=b_ms)
    lib = (f"cuDNN merged {lib_ms:.4f} ms (rel diff {lib_err:.1e})" if lib_ms is not None
           else "no single library call (b1 and the identity)")
    print(f"parallel_cascade {form:5s} x{row['shape']} ks={ks}: rel err {err:.3e} "
          f"(bound 0: bit for bit), max abs err {abs_err:.3e}, kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, {lib}; bound {b_ms:.4f} ms by {b_by} "
          f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP), roofline share {b_ms / ms:.1%}")
    return row


def check_cascade_kernel(gen):
    """parallel_cascade (:func:`cascade_row`) at ConvNeXt-T's stage shapes with
    one and two 7-tap cascades (DwSepRep r1/r2), at MSCAN-t's four stage
    shapes in the two forms of MscaRep(1, fix, decomp_conv0) (conv0 as a 5-tap
    cascade and the bank as one 21-tap cascade, biased like r1), and in MSCA's
    dense-bank form (7/11/21 with every bias and the identity, the kernel's
    ring path) at MSCAN-t's first stage; the sums per forward."""
    cases = [(f"r{nb}", H, C, (7,) * nb, blocks) for nb in (1, 2)
             for H, C, blocks in CONVNEXT_STAGES]
    cases += [(form, H, C, (k,), blocks) for form, k in (("d0k5", 5), ("d0k21", 21))
              for H, C, blocks in STAGES]
    cases.append(("msca", STAGES[0][0], STAGES[0][1], (7, 11, 21), STAGES[0][2]))
    rows = [cascade_row(form, H, C, ks, blocks, gen) for form, H, C, ks, blocks in cases]
    for name, forms in (("ConvNeXt-T DwSepRep r1", ("r1",)), ("ConvNeXt-T DwSepRep r2", ("r2",)),
                        ("MSCAN-t d1+fix+dconv0", ("d0k5", "d0k21"))):
        sel = [r for r in rows if r["form"] in forms]
        total = {k: sum(r[k] * r["blocks"] for r in sel)
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        print(f"parallel_cascade per {name} forward ({sum(r['blocks'] for r in sel)} calls): "
              f"kernel {total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, cuDNN merged "
              f"{total['library_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms")
    return rows


def check_qmatmul_kernel(gen):
    """qmatmul against qmatmul_ref, bit for bit, at the 13 shapes of int8
    ConvNeXt-T at b=64 and at the ragged shapes (with and without a bias);
    beside it ``torch._int_mm`` on the already-quantized operands (the int8
    product alone: a lower bar than the whole function).  Returns the rows of
    the 13 shapes."""
    import torch

    from convnet_approximater_tpu_torch.ops import qmatmul as qmatmul_ops

    # quotients within a few ulps of every half integer in [-130.5, 130.5], and values
    # beyond the kernel's branch-free range (inf, 1e30), through an identity weight:
    # y = q(x) a, so any rounding difference of the quantizer shows in y
    a = np.float32(0.0123)
    half = (np.arange(-131, 131, dtype=np.float64) + 0.5) * np.float64(a)
    cols = [half.astype(np.float32)]
    for step in (1, 2):
        for d in (np.inf, -np.inf):
            v = cols[0]
            for _ in range(step):
                v = np.nextafter(v, np.float32(d))
            cols.append(v)
    x = np.resize(np.concatenate(cols), (64, 256)).astype(np.float32)
    x[0, :4] = [np.inf, -np.inf, 1e30, -1e30]
    x = torch.from_numpy(x).cuda()
    w, s = qmatmul_ops.pack_qweight(torch.eye(256, dtype=torch.int8).cuda()), torch.ones(256).cuda()
    a = torch.tensor(float(a), device="cuda")
    y, y_ref = qmatmul_ops.qmatmul(x, w, a, s), qmatmul_ops.qmatmul_ref(x, w, a, s)
    torch.cuda.synchronize()
    if not torch.equal(y, y_ref):
        fail(f"qmatmul near-tie quotients: {int((y != y_ref).sum())} of {y.numel()} outputs "
             f"differ from qmatmul_ref")
    print(f"qmatmul near-tie quotients (64, 256) through an identity weight: bit for bit")
    for M, K, N in QMM_RAGGED:
        x = torch.randn(M, K, generator=gen).cuda()
        w = qmatmul_ops.pack_qweight(
            torch.randint(-127, 128, (N, K), generator=gen, dtype=torch.int8).cuda())
        a = torch.tensor(float(x.abs().max()) / 127.0, device="cuda")
        s, b = (torch.rand(N, generator=gen) * 0.01).cuda(), torch.randn(N, generator=gen).cuda()
        for bias in (b, None):
            y = qmatmul_ops.qmatmul(x, w, a, s, bias)
            y_ref = qmatmul_ops.qmatmul_ref(x, w, a, s, bias)
            torch.cuda.synchronize()
            if not torch.equal(y, y_ref):
                fail(f"qmatmul ragged {(M, K, N)} (bias {bias is not None}): max abs err "
                     f"{float((y - y_ref).abs().max()):.3e}; the kernel must give "
                     f"qmatmul_ref's bits")
        p = qmatmul_ops.plan(M, K, N)
        print(f"qmatmul ragged (M, K, N)={(M, K, N)}: bit for bit with and without a bias "
              f"(plan BM {p.bm}, BN {p.bn}, grid {p.grid})")
    rows = []
    for (M, K, N), calls in QMM_SHAPES:
        x = torch.randn(M, K, generator=gen).cuda()
        w_q = torch.randint(-127, 128, (N, K), generator=gen, dtype=torch.int8).cuda()
        w = qmatmul_ops.pack_qweight(w_q)
        a = torch.tensor(float(x.abs().max()) / 127.0, device="cuda")
        s = (torch.rand(N, generator=gen) * 0.01).cuda()
        b = torch.randn(N, generator=gen).cuda()
        y = qmatmul_ops.qmatmul(x, w, a, s, b)
        y_ref = qmatmul_ops.qmatmul_ref(x, w, a, s, b)
        torch.cuda.synchronize()
        err, abs_err = rel_err(y, y_ref), float((y - y_ref).abs().max())
        if not torch.isfinite(y).all() or not torch.equal(y, y_ref):
            fail(f"qmatmul {(M, K, N)}: rel err {err:.3e}, max abs err {abs_err:.3e}; the "
                 f"kernel must give qmatmul_ref's bits")
        ms, plain_ms = time_pair(lambda: qmatmul_ops.qmatmul(x, w, a, s, b),
                                 lambda: qmatmul_ops.qmatmul_ref(x, w, a, s, b))
        x_q, w_t = qmatmul_ops.quantize_activation(x, a), w_q.t().contiguous()
        lib_ms = library_time(lambda: torch._int_mm(x_q, w_t))
        nbytes, ops = qmm_cost(M, K, N)
        b_ms, b_by = bound(nbytes, ops, PEAK_INT8)
        p = qmatmul_ops.plan(M, K, N)
        if qmatmul_ops._library().qmatmul_smem_bytes(p.bm, p.bnw, p.ra, p.sx, p.sb) != p.smem:
            fail(f"qmatmul {(M, K, N)}: the planner's shared memory differs from the kernel's")
        rows.append(dict(shape=(M, K, N), calls=calls, rel_err=err, max_abs_err=abs_err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes, flops=ops,
                         bound_ms=b_ms))
        print(f"qmatmul (M, K, N)={(M, K, N)} x{calls}/forward: rel err {err:.3e} (bound 0: "
              f"bit for bit), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch._int_mm "
              f"{lib_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.3f} G int8 ops), roofline share {b_ms / ms:.1%}; plan BM {p.bm}, "
              f"BN {p.bn}, {p.ntpb} column tiles per block, grid {p.grid}, {p.smem} B of "
              f"shared memory")
        del x, y, y_ref, x_q
    for name, key in (("kernel", "ms"), ("plain", "plain_ms"), ("torch._int_mm", "library_ms"),
                      ("bound", "bound_ms")):
        print(f"qmatmul per int8 ConvNeXt-T forward ({sum(r['calls'] for r in rows)} calls): "
              f"{name} {sum(r[key] * r['calls'] for r in rows):.4f} ms")
    return rows


def check_eval_grad(gen):
    """One eval-mode backward on the card through a CascadeConv (ConvNeXt-T's
    stage-1 bank), an MSCA made by MscaRep(1, fix) (MSCAN-t's stage 1) and a
    separable LowRankExpConvV1 (AlexNet's conv2): under autograd each takes its
    module path (no kernel launch), and its input and parameter gradients equal
    those of the module path in training mode; under torch.no_grad() each
    launches its kernel once."""
    import torch

    from convnet_approximater_tpu_torch.core import MscaRep
    from convnet_approximater_tpu_torch.layers import MSCA, CascadeConv, LowRankExpConvV1
    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops
    from convnet_approximater_tpu_torch.ops import parallel_cascade as cascade_ops

    torch.manual_seed(0)
    lowrank = LowRankExpConvV1(64, 192, 5, 1, 2, 8, decomp=True)
    with torch.no_grad():  # bases shared by every input channel: the kernel's form
        v, h = torch.randn(8, 5, generator=gen), torch.randn(8, 5, generator=gen)
        lowrank.s_conv.v_conv.weight.copy_(v.repeat(64, 1)[:, None, :, None])
        lowrank.s_conv.h_conv.weight.copy_(h.repeat(64, 1)[:, None, None, :])
    cases = [("CascadeConv", CascadeConv(96, 7, 3, bias=True, first_bias=False), (8, 96, 56),
              cascade_ops.parallel_cascade),
             ("MSCA d1+fix", MscaRep(decomp=1, fix=True).initialize(MSCA(32, 5, (7, 11, 21)))
              .new_module, (8, 32, 56), fused_ops.msca_fused),
             ("LowRankExpConvV1", lowrank, (8, 64, 27), lowrank_ops.lowrank_conv)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, layer, (B, C, H), kernel in cases:
            layer = layer.cuda().eval()
            x = torch.randn(B, C, H, H, generator=gen).cuda().contiguous(
                memory_format=torch.channels_last)

            def grads():
                layer.zero_grad(set_to_none=True)
                xg = x.clone().requires_grad_(True)
                y = layer(xg)
                y.backward(torch.ones_like(y))
                return [xg.grad] + [p.grad for p in layer.parameters()], y.detach()

            reset_counts()
            eval_grads, y = grads()
            if kernel.launches != 0 or any(g is None for g in eval_grads):
                fail(f"eval-mode backward through {name}: {kernel.launches} kernel launches "
                     f"under autograd, or a gradient is missing")
            with torch.no_grad():
                y_kernel = layer(x)
            if kernel.launches != 1:
                fail(f"{name} under torch.no_grad() launched its kernel {kernel.launches} times")
            layer.train()
            module_grads, y_module = grads()
            layer.eval()
            errs = [rel_err(g, m) for g, m in zip(eval_grads, module_grads)]
            kernel_err = rel_err(y_kernel, y)
            print(f"eval-mode backward through {name} {(B, H, H, C)}: {len(errs)} gradients "
                  f"(input and parameters), max rel err {max(errs):.3e} against the module path "
                  f"(bound {GRAD_TOL}); no kernel launch under autograd, one under no_grad "
                  f"(forward rel err {kernel_err:.3e} against the autograd forward)")
            if max(errs) > GRAD_TOL or rel_err(y, y_module) > GRAD_TOL or kernel_err > KERNEL_TOL:
                fail(f"eval-mode gradients through {name} differ from the module path's")
            del layer, x
    finally:
        torch.backends.cudnn.deterministic = deterministic


@contextlib.contextmanager
def hook_graphs_cut():
    """The default timer's graph slope at HOOK_GRAPH_ITERS replays (n and 4n)
    and one warm-up replay inside the block: phases 4-14 read the eager
    median, which keeps its iterations."""
    from convnet_approximater_tpu_torch.hooks import inference_time_hook as timer

    real = timer.graph_ms
    with mock.patch.object(timer, "graph_ms", lambda model, size, num_iters=10, warmup=3,
                           *dtype: real(model, size, HOOK_GRAPH_ITERS, 1, *dtype)):
        yield


def reset_counts():
    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops
    from convnet_approximater_tpu_torch.ops import parallel_cascade as cascade_ops
    from convnet_approximater_tpu_torch.ops import qmatmul as qmatmul_ops

    fused_ops.msca_fused.launches = 0
    lowrank_ops.lowrank_conv.launches = 0
    cascade_ops.parallel_cascade.launches = 0
    qmatmul_ops.qmatmul.launches = 0


def run_cli(config, work_dir):
    """The port's CLI on ``config``, seed 0, on the card; (runner, seconds)."""
    import torch

    from convnet_approximater_tpu_torch import main as cli

    t0 = time.perf_counter()
    runner = cli.main(["--config", config, "--device", "cuda", "--seed", "0",
                       "--work-dir", work_dir])
    torch.cuda.synchronize()
    return runner, time.perf_counter() - t0


def forwards_of(runner) -> int:
    """Forwards the hooks ran (ModelAnalysis: 1, InferenceTimeHook: warm-ups + timed)."""
    return sum(getattr(h, "forwards", 0) for h in runner.hooks)


def images(gen, size=224):
    import torch

    return torch.randn(2, 3, size, size, generator=gen).cuda().contiguous(
        memory_format=torch.channels_last)


def check_logits(name, y, against, tol, classes: int = 1000, shape=None):
    """Shape (``shape``, or (2, classes)), finiteness and relative error of the
    logits against each plain run."""
    import torch

    shape = tuple(shape or (2, classes))
    if tuple(y.shape) != shape or not torch.isfinite(y).all():
        fail(f"{name}: logits of shape {tuple(y.shape)} or not finite")
    errs = {k: rel_err(y, v) for k, v in against.items()}
    print(f"{name} logits {shape}: " + ", ".join(
        f"rel err {e:.3e} against {k}" for k, e in errs.items()) + f" (bound {tol})")
    if any(e > tol for e in errs.values()):
        fail(f"{name}: logits disagree with the plain versions")


def run_mscan(gen):
    import torch

    from convnet_approximater_tpu_torch.hooks import InferenceTimeHook, eager_times
    from convnet_approximater_tpu_torch.layers import MSCA
    from convnet_approximater_tpu_torch.models import MSCAN_Classifier
    from convnet_approximater_tpu_torch.nn import init_weights
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops

    reset_counts()
    runner, run_s = run_cli(CONFIG, os.path.join(REPO, "build", "chip_smoke"))
    launches = fused_ops.msca_fused.launches
    model = runner.model
    hook = next(h for h in runner.hooks if isinstance(h, InferenceTimeHook))
    mscas = [m for m in model.modules() if isinstance(m, MSCA)]
    if model.length_switchable != 13 or len(mscas) != 13:
        fail(f"expected 13 MSCA blocks, registered {model.length_switchable}, found {len(mscas)}")
    with torch.no_grad():  # the kernel route: no gradient can be asked
        fusable = all(m.can_fuse() for m in mscas)
    if not fusable:
        fail("an MscaRep'd MSCA block cannot take the fused kernel")
    if launches != 13 * hook.forwards or launches == 0:
        fail(f"msca_fused launched {launches} times in {hook.forwards} forwards, "
             f"expected {13 * hook.forwards}")
    d1_ms = hook.result["eager_median_ms"]
    print(f"main path: Runner on {os.path.relpath(CONFIG, REPO)} in {run_s:.2f} s; "
          f"{hook.forwards} forwards launched msca_fused {launches} times (13 per forward); "
          f"InferenceTimeHook: {hook.result['median_ms']:.3f} ms as a graph back to back, eager "
          f"median {d1_ms:.3f} ms")

    x = images(gen)
    with torch.no_grad():
        y = model(x)
        with mock.patch.object(fused_ops, "msca_fused", fused_ops.msca_fused_ref):
            y_plain = model(x)
            plain_ms = float(np.median(eager_times(model, hook.input_size, "cuda",
                                                    hook.num_iters, hook.warmup)))
        for m in mscas:
            m.train()  # the module path: conv0 -> strip convs -> fix -> channel mix
        y_module = model(x)
        for m in mscas:
            m.eval()
    check_logits("d1+fix", y, {"msca_fused_ref": y_plain, "the module path": y_module},
                 LOGITS_TOL)

    dense = MSCAN_Classifier(num_classes=1000)
    init_weights(dense, torch.Generator().manual_seed(0))
    dense = dense.cuda().to(memory_format=torch.channels_last).eval()
    fused_ops.msca_fused.launches = 0
    dense_times = eager_times(dense, hook.input_size, "cuda", hook.num_iters, hook.warmup)
    if fused_ops.msca_fused.launches != 13 * (hook.num_iters + hook.warmup):
        fail("the dense MSCAN-t forward did not launch msca_fused once per block")
    dense_ms = float(np.median(dense_times))
    b = hook.input_size[0]
    print(f"MSCAN-t d1+fix forward (64, 224, 224, 3) f32: median {d1_ms:.3f} ms "
          f"({b / d1_ms * 1e3:.1f} img/s); with msca_fused_ref in place of the kernel "
          f"{plain_ms:.3f} ms")
    print(f"MSCAN-t dense forward (64, 224, 224, 3) f32: median {dense_ms:.3f} ms "
          f"({b / dense_ms * 1e3:.1f} img/s); dense / d1+fix = {dense_ms / d1_ms:.4f}")
    print(f"MSCAN-t d1+fix forward: {host_enqueue_ms(model, hook.input_size):.3f} ms of host "
          f"time to enqueue it")
    check_block_launches(mscas[0], gen)
    profile_forward("MSCAN-t d1+fix", model, hook.input_size, keep=MSCA_KERNELS)
    profile_forward("MSCAN-t dense", dense, hook.input_size, keep=MSCA_KERNELS)
    del runner, model, dense
    torch.cuda.empty_cache()
    return launches


def check_block_launches(msca, gen):
    """One eval-mode MSCA block forward under torch.profiler, its weight layouts
    cached by a first forward: exactly the two msca_fused kernels (the march and
    the mix) reach the card, and no copy of a weight layout."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    C = msca.num_channel
    x = torch.randn(BATCH, C, 56, 56, generator=gen).cuda().contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        msca(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            msca(x)
            torch.cuda.synchronize()
    kernels = sorted(e.name for e in prof.events()
                     if is_kernel(e))
    print(f"one cached d1+fix MSCA block forward {(BATCH, C, 56, 56)}: {len(kernels)} kernels "
          f"on the card: {', '.join(k.split('::')[-1].split('(')[0] for k in kernels)}")
    if len(kernels) != 2 or not ("march_kernel" in kernels[0] and "mix_kernel" in kernels[1]):
        fail("an MSCA block forward must launch the march and the mix kernels and nothing else")


def host_enqueue_ms(model, input_size, n: int = 10) -> float:
    """Median host milliseconds to enqueue one forward on an idle card (no sync
    inside it).  Where this nears the forward's device time, the host bounds it."""
    import torch

    B, H, W, C = input_size
    x = torch.zeros(B, C, H, W, device="cuda").contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        return host_ms(lambda: model(x), n)


def host_ms(fn, n: int = 10) -> float:
    """Median host milliseconds of ``fn()`` on an idle card, after 3 calls."""
    import torch

    times = []
    for i in range(n + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if i >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def profile_forward(name, model, input_size, n: int = 3, keep=()):
    """Device time per forward by kernel, from torch.profiler over ``n`` forwards:
    the 12 largest rows, and every row whose name holds one of ``keep``."""
    import torch

    B, H, W, C = input_size
    x = torch.zeros(B, C, H, W, device="cuda").contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        profile_calls(f"{name} forward {tuple(input_size)}", lambda: model(x), n, keep)


def profile_calls(name, fn, n: int = 3, keep=()):
    """Device time per call of ``fn()`` by kernel, from torch.profiler over ``n``
    calls after one: the 12 largest rows, and every row whose name holds one of
    ``keep``.  Returns the device ms per call (None when the profiler recorded
    no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for e in prof.key_averages():
        if not is_kernel(e):
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        rows.append((us / 1e3 / n, e.count // n, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    if not rows:
        print("profile: torch.profiler recorded no device time (not measured)")
        return None
    print(f"profile of the {name} (torch.profiler, {n} calls): device time {total:.3f} ms per "
          f"call, wall {wall_ms:.3f} ms under the profiler; by kernel (ms per call, launches "
          f"per call):")
    for i, (ms, count, kname) in enumerate(rows):
        if i < 12 or any(k in kname for k in keep):
            print(f"  {ms:8.4f} ms  x{count:<3d} {kname[:100]}")
    return total


def run_alexnet(gen, config, separable: bool, work_dir: str, extras: bool):
    """Drive AlexNet with LowRankExpConvV1 on convs 2-5 through the CLI and
    check it; with ``extras``, also time the plain version in place and the
    dense AlexNet and profile the forward.  Returns the kernel's launch count."""
    import torch

    from convnet_approximater_tpu_torch.hooks import InferenceTimeHook, eager_times
    from convnet_approximater_tpu_torch.layers import LowRankExpConvV1
    from convnet_approximater_tpu_torch.models import AlexNet
    from convnet_approximater_tpu_torch.nn import init_weights
    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops

    name = os.path.relpath(config, REPO)
    reset_counts()
    runner, run_s = run_cli(config, work_dir)
    launches = lowrank_ops.lowrank_conv.launches
    model = runner.model
    forwards = forwards_of(runner)
    hook = next(h for h in runner.hooks if isinstance(h, InferenceTimeHook))
    layers = [m for m in model.modules() if isinstance(m, LowRankExpConvV1)]
    if model.switchable_names != ALEX_NAMES or len(layers) != 4:
        fail(f"{name}: registered {model.switchable_names}, expected {ALEX_NAMES}")
    with torch.no_grad():  # the kernel route: no gradient can be asked
        dispatched = all(m.uses_kernel() for m in layers)
    if not dispatched:
        fail(f"{name}: a LowRankExpConvV1 layer does not dispatch to lowrank_conv")
    if not all(hasattr(m.s_conv, "v_conv") == separable for m in layers):
        fail(f"{name}: expected {'separable' if separable else 'full'} bases in every layer")
    if launches != 4 * forwards or launches == 0:
        fail(f"{name}: lowrank_conv launched {launches} times in {forwards} forwards, "
             f"expected {4 * forwards}")
    with open(os.path.join(work_dir, "run.log")) as f:
        macs_line = [ln.strip() for ln in f if "Model MACs: " in ln]
    if not macs_line:
        fail(f"{name}: ModelAnalysis logged no 'Model MACs' line")
    low_ms = hook.result["eager_median_ms"]
    print(f"main path: Runner on {name} in {run_s:.2f} s; {forwards} forwards launched "
          f"lowrank_conv {launches} times (4 per forward); {macs_line[0].split(' - ')[-1]}")

    x = images(gen)
    with torch.no_grad():
        y = model(x)
        with mock.patch.object(lowrank_ops, "lowrank_conv",
                               lambda *a, packed=None, **k: lowrank_ops.lowrank_conv_ref(*a, **k)):
            y_plain = model(x)
            if extras:
                plain_ms = float(np.median(eager_times(model, hook.input_size, "cuda",
                                                        hook.num_iters, hook.warmup)))
        for m in layers:
            m.train()  # the module path: s_conv -> d_conv
        y_module = model(x)
        for m in layers:
            m.eval()
    check_logits(name, y, {"lowrank_conv_ref": y_plain, "the module path": y_module},
                 LOGITS_TOL, classes=10)
    b = hook.input_size[0]
    print(f"AlexNet low-rank forward {tuple(hook.input_size)} f32 ({name}): median "
          f"{low_ms:.3f} ms ({b / low_ms * 1e3:.1f} img/s)")
    if extras:
        dense = AlexNet()
        init_weights(dense, torch.Generator().manual_seed(0))
        dense = dense.cuda().to(memory_format=torch.channels_last).eval()
        dense_ms = float(np.median(eager_times(dense, hook.input_size, "cuda",
                                                hook.num_iters, hook.warmup)))
        print(f"AlexNet low-rank forward with lowrank_conv_ref in place of the kernel: median "
              f"{plain_ms:.3f} ms")
        print(f"AlexNet dense forward {tuple(hook.input_size)} f32: median {dense_ms:.3f} ms "
              f"({b / dense_ms * 1e3:.1f} img/s); dense / low-rank = {dense_ms / low_ms:.4f}")
        del dense
        profile_forward("low-rank AlexNet", model, hook.input_size)
        compiled, put = check_graph(f"{name} graph", model, {"lowrank_conv": 4}, 30)[:2]
        paced = pace(model, compiled, seeded_batch(30))
        print(f"AlexNet low-rank forward as a graph: median "
              f"{time_graph(compiled, put, hook.input_size):.3f} ms; back to back "
              f"{paced[0]:.3f} ms eager, {paced[1]:.3f} ms graph; host time to enqueue one "
              f"replay {host_ms(compiled):.3f} ms, one eager forward "
              f"{host_enqueue_ms(model, hook.input_size):.3f} ms")
        del compiled, put
    del runner, model
    torch.cuda.empty_cache()
    return launches


def set_gamma(model, value: float = 1.0):
    """Every ConvNeXt layer scale to ``value``: at its 1e-6 init each block adds
    about 1e-6 of its output to the residual stream, below any logits tolerance."""
    import torch

    from convnet_approximater_tpu_torch.models import LayerScale

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LayerScale):
                m.gamma.fill_(value)


def through_plain(model, x):
    """``model(x)`` with parallel_cascade and qmatmul swapped for their plain versions."""
    from convnet_approximater_tpu_torch.ops import parallel_cascade as cascade_ops
    from convnet_approximater_tpu_torch.ops import qmatmul as qmatmul_ops

    with mock.patch.object(cascade_ops, "parallel_cascade", cascade_ops.parallel_cascade_ref), \
            mock.patch.object(qmatmul_ops, "qmatmul", qmatmul_ops.qmatmul_ref):
        return model(x)


def module_path(model, types, x):
    """``model(x)`` with the modules of ``types`` in training mode (their module path)."""
    mods = [m for m in model.modules() if isinstance(m, types)]
    for m in mods:
        m.train()
    try:
        return model(x)
    finally:
        for m in mods:
            m.eval()


def drive_convnext(gen, config, nb):
    """The Runner on a ConvNeXt-T DwSepRep config: 18 banks of ``nb`` cascades, 18
    parallel_cascade launches per forward, the logits (gamma = 1) against the
    plain version and the module path.  Returns (model, hook, launches)."""
    import torch

    from convnet_approximater_tpu_torch.hooks import InferenceTimeHook
    from convnet_approximater_tpu_torch.layers import CascadeConv, ParallelConv
    from convnet_approximater_tpu_torch.ops import parallel_cascade as cascade_ops

    name = os.path.relpath(config, REPO)
    work_dir = os.path.join(REPO, "build", f"chip_smoke_convnext_r{nb}")
    reset_counts()
    runner, run_s = run_cli(config, work_dir)
    launches = cascade_ops.parallel_cascade.launches
    model, forwards = runner.model, forwards_of(runner)
    hook = next(h for h in runner.hooks if isinstance(h, InferenceTimeHook))
    kind = CascadeConv if nb == 1 else ParallelConv
    banks = [model.get_switchable_module(i) for i in range(model.length_switchable)]
    if model.length_switchable != 18 or not all(type(b) is kind for b in banks):
        fail(f"{name}: expected 18 {kind.__name__} blocks, registered {model.length_switchable}")
    with torch.no_grad():  # the kernel route: no gradient can be asked
        dispatched = all(b.uses_kernel() and len(b.bank()[0]) == nb for b in banks)
    if not dispatched:
        fail(f"{name}: a strip bank does not dispatch to parallel_cascade")
    if launches != 18 * forwards or launches == 0:
        fail(f"{name}: parallel_cascade launched {launches} times in {forwards} forwards, "
             f"expected {18 * forwards}")
    with open(os.path.join(work_dir, "run.log")) as f:
        macs_line = [ln.strip() for ln in f if "Model MACs: " in ln]
    if not macs_line:
        fail(f"{name}: ModelAnalysis logged no 'Model MACs' line")
    ms = hook.result["eager_median_ms"]
    print(f"main path: Runner on {name} in {run_s:.2f} s; {forwards} forwards launched "
          f"parallel_cascade {launches} times (18 per forward); {macs_line[0].split(' - ')[-1]}")
    print(f"ConvNeXt-T DwSepRep r{nb} forward {tuple(hook.input_size)} f32: median {ms:.3f} ms "
          f"({hook.input_size[0] / ms * 1e3:.1f} img/s)")
    set_gamma(model)
    x = images(gen)
    with torch.no_grad():
        check_logits(f"ConvNeXt-T r{nb} (gamma = 1)", model(x), {
            "parallel_cascade_ref": through_plain(model, x),
            "the module path": module_path(model, (CascadeConv, ParallelConv), x)}, LOGITS_TOL)
    return model, hook, launches


def run_convnext(gen):
    """The ConvNeXt-T DwSepRep r1 path and its int8 serving form, then the r2
    config.  Returns the launch counts of parallel_cascade (r1 CLI run) and
    qmatmul (int8 forwards)."""
    import torch

    from convnet_approximater_tpu_torch import deploy
    from convnet_approximater_tpu_torch.hooks import eager_times
    from convnet_approximater_tpu_torch.layers import QuantConv2d, QuantLinear
    from convnet_approximater_tpu_torch.models import ConvNeXt
    from convnet_approximater_tpu_torch.nn import init_weights
    from convnet_approximater_tpu_torch.ops import parallel_cascade as cascade_ops
    from convnet_approximater_tpu_torch.ops import qmatmul as qmatmul_ops

    model, hook, launches = drive_convnext(gen, CONVNEXT_R1, 1)
    ms, b = hook.result["eager_median_ms"], hook.input_size[0]
    with torch.no_grad(), mock.patch.object(cascade_ops, "parallel_cascade",
                                            cascade_ops.parallel_cascade_ref):
        plain_ms = float(np.median(eager_times(model, hook.input_size, "cuda", hook.num_iters,
                                                hook.warmup)))
    dense = ConvNeXt(num_classes=1000)
    init_weights(dense, torch.Generator().manual_seed(0))
    dense = dense.cuda().to(memory_format=torch.channels_last).eval()
    dense_ms = float(np.median(eager_times(dense, hook.input_size, "cuda", hook.num_iters,
                                            hook.warmup)))
    del dense
    print(f"ConvNeXt-T r1 forward with parallel_cascade_ref in place of the kernel: median "
          f"{plain_ms:.3f} ms")
    print(f"ConvNeXt-T dense forward {tuple(hook.input_size)} f32: median {dense_ms:.3f} ms "
          f"({b / dense_ms * 1e3:.1f} img/s); dense / r1 = {dense_ms / ms:.4f}")
    profile_forward("ConvNeXt-T DwSepRep r1", model, hook.input_size)

    # int8 serving: calibrate on two normal batches, quantize every dense conv and Linear
    calib_gen = torch.Generator().manual_seed(7)
    calib = [torch.randn(b, 3, 224, 224, generator=calib_gen).cuda()
             .contiguous(memory_format=torch.channels_last) for _ in range(2)]
    x = images(gen)
    with torch.no_grad():
        y_f32 = model(x)
    t0 = time.perf_counter()
    n = deploy.quantize_int8(model, calib)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    quantized = [m for m in model.modules() if isinstance(m, (QuantConv2d, QuantLinear))]
    if n != 41 or len(quantized) != 41:
        fail(f"quantize_int8 quantized {n} modules ({len(quantized)} found), expected 41")
    reset_counts()
    int8_times = eager_times(model, hook.input_size, "cuda", hook.num_iters, hook.warmup)
    forwards = hook.num_iters + hook.warmup
    q_launches = qmatmul_ops.qmatmul.launches
    c_launches = cascade_ops.parallel_cascade.launches
    if q_launches != 41 * forwards or c_launches != 18 * forwards:
        fail(f"int8 forwards launched qmatmul {q_launches} and parallel_cascade {c_launches} "
             f"times in {forwards} forwards, expected 41 and 18 per forward")
    int8_ms = float(np.median(int8_times))
    print(f"int8: quantize_int8 quantized {n} modules in {quant_s:.2f} s (2 calibration "
          f"batches); {forwards} forwards launched qmatmul {q_launches} and "
          f"parallel_cascade {c_launches} times (41 and 18 per forward)")
    with torch.no_grad():
        y_q = model(x)
        check_logits("int8 ConvNeXt-T r1 (gamma = 1)", y_q,
                     {"qmatmul_ref and parallel_cascade_ref": through_plain(model, x)}, INT8_TOL)
    int8_err = float((y_q - y_f32).abs().max() / y_f32.abs().max())
    print(f"int8 against float32 logits: max abs relative {int8_err:.4f} (bound {INT8_F32_TOL})")
    if not int8_err <= INT8_F32_TOL:
        fail("int8 logits drift too far from the float32 model's")
    print(f"ConvNeXt-T DwSepRep r1 int8 forward {tuple(hook.input_size)}: median {int8_ms:.3f} ms "
          f"({b / int8_ms * 1e3:.1f} img/s); float32 r1 / int8 = {ms / int8_ms:.4f}, "
          f"dense / int8 = {dense_ms / int8_ms:.4f}")
    profile_forward("int8 ConvNeXt-T DwSepRep r1", model, hook.input_size)
    compiled, put = check_graph("int8 ConvNeXt-T r1 graph", model,
                                {"qmatmul": 41, "parallel_cascade": 18}, 31)[:2]
    paced = pace(model, compiled, seeded_batch(31))
    print(f"int8 ConvNeXt-T r1 forward as a graph: median "
          f"{time_graph(compiled, put, hook.input_size):.3f} ms; back to back "
          f"{paced[0]:.3f} ms eager, {paced[1]:.3f} ms graph; host time to enqueue one "
          f"replay {host_ms(compiled):.3f} ms, one eager forward "
          f"{host_enqueue_ms(model, hook.input_size):.3f} ms")
    del model, calib, compiled, put
    torch.cuda.empty_cache()

    drive_convnext(gen, CONVNEXT_R2, 2)
    torch.cuda.empty_cache()
    return launches, q_launches


def run_mscan_dconv0(gen):
    """MSCAN-t with MscaRep(1, fix, decomp_conv0): conv0 and the bank of every
    block are cascades on the module path, two parallel_cascade calls per block."""
    import torch

    from convnet_approximater_tpu_torch.hooks import InferenceTimeHook
    from convnet_approximater_tpu_torch.layers import MSCA, CascadeConv
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops
    from convnet_approximater_tpu_torch.ops import parallel_cascade as cascade_ops

    name = os.path.relpath(MSCAN_DCONV0, REPO)
    reset_counts()
    runner, run_s = run_cli(MSCAN_DCONV0, os.path.join(REPO, "build", "chip_smoke_dconv0"))
    launches, fused = cascade_ops.parallel_cascade.launches, fused_ops.msca_fused.launches
    model, forwards = runner.model, forwards_of(runner)
    hook = next(h for h in runner.hooks if isinstance(h, InferenceTimeHook))
    mscas = [m for m in model.modules() if isinstance(m, MSCA)]
    with torch.no_grad():  # the kernel route: no gradient can be asked
        routed = len(mscas) == 13 and all(isinstance(m.conv0, CascadeConv) and not m.can_fuse()
                                          and m.conv0.uses_kernel() for m in mscas)
    if not routed:
        fail(f"{name}: expected 13 MSCA blocks with a cascade conv0 on the module path")
    if launches != 26 * forwards or launches == 0 or fused != 0:
        fail(f"{name}: parallel_cascade launched {launches} times and msca_fused {fused} times "
             f"in {forwards} forwards, expected 26 and 0 per forward")
    ms = hook.result["eager_median_ms"]
    print(f"main path: Runner on {name} in {run_s:.2f} s; {forwards} forwards launched "
          f"parallel_cascade {launches} times (26 per forward), msca_fused {fused} times")
    x = images(gen)
    with torch.no_grad():
        check_logits("MSCAN-t d1+fix+dconv0", model(x), {
            "parallel_cascade_ref": through_plain(model, x),
            "the module path": module_path(model, MSCA, x)}, LOGITS_TOL)
    print(f"MSCAN-t d1+fix+dconv0 forward {tuple(hook.input_size)} f32: median {ms:.3f} ms "
          f"({hook.input_size[0] / ms * 1e3:.1f} img/s); "
          f"{host_enqueue_ms(model, hook.input_size):.3f} ms of host time to enqueue it")
    profile_forward("MSCAN-t d1+fix+dconv0", model, hook.input_size)
    del runner, model
    torch.cuda.empty_cache()


def seeded_batch(seed: int, batch: int = BATCH, device="cuda", size: int = 224):
    """A (batch, 3, size, size) channels_last batch of normal values from ``seed``."""
    import torch

    x = torch.randn(batch, 3, size, size, generator=torch.Generator().manual_seed(seed))
    return x.to(device).contiguous(memory_format=torch.channels_last)


def kernels_of(fn):
    """The kernels one call of ``fn`` (after one more) puts on the card, by
    name, from torch.profiler.  Two calls run in the profiled window, each
    after a sleep kernel, and the kernels after the second sleep count: a
    profiler session after the first in a process may not record the first
    kernels of its window (a ResNet-18 replay once showed 53 of its 58)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if is_kernel(e)), key=lambda e: e.time_range.start)
    sleeps = [i for i, e in enumerate(events) if "sleep" in e.name.lower() or "spin" in e.name.lower()]
    if not sleeps:  # a dropped first sleep leaves the second, the one that matters
        fail("kernels_of: the profiler recorded neither sleep kernel")
    return [e.name for e in events[sleeps[-1] + 1:]]


def count_kernels(names, labels):
    """How many of ``names`` match each label of KERNEL_NAMES in ``labels``."""
    return {label: sum(any(k in n for k in KERNEL_NAMES[label]) for n in names)
            for label in labels}


def check_graph(name, model, expect: dict, seed: int, batch: int = BATCH, size: int = 224):
    """``deploy.compile_serving`` of ``model`` at (batch, size^2): the replay's
    logits against the eager forward's on a seeded batch (relative error <=
    REPLAY_TOL), and ``expect``'s kernels in one replay.  Returns (compiled,
    put, kernel names of one replay)."""
    import torch

    from convnet_approximater_tpu_torch.deploy import compile_serving

    x = seeded_batch(seed, batch, size=size)
    t0 = time.perf_counter()
    compiled, put = compile_serving(model, x)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    with torch.no_grad():
        y_eager = model(x)
    y = compiled(*put(x))
    err = rel_err(y, y_eager)
    names = kernels_of(compiled)  # a replay and the copy of its logits
    counts = count_kernels(names, expect)
    print(f"{name}: compile_serving (warm-up and capture) in {capture_s:.2f} s; replay against "
          f"eager logits {tuple(y.shape)}: rel err {err:.3e} (bound {REPLAY_TOL}), "
          f"{'bit-equal' if torch.equal(y, y_eager) else 'not bit-equal'}; one replay put "
          f"{len(names)} kernels on the card: " + ", ".join(
              f"{k} {v} (expected {expect[k]})" for k, v in counts.items()))
    if not torch.isfinite(y).all() or err > REPLAY_TOL:
        fail(f"{name}: the graph replay disagrees with the eager forward")
    if counts != expect:
        fail(f"{name}: one replay did not run the expected kernels")
    return compiled, put, names


def time_graph(compiled, put, input_size, num_iters: int = 10, warmup: int = 3):
    """Median ms of ``compiled()`` (a replay and the copy of its logits) over
    ``num_iters`` CUDA-event-timed calls after ``warmup``, on an input of ones,
    as ``eager_times`` times the eager forward."""
    import torch

    B, H, W, C = input_size
    put(torch.ones(B, C, H, W, device="cuda").contiguous(memory_format=torch.channels_last))
    for _ in range(warmup):
        compiled()
    times = []
    for _ in range(num_iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        compiled()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def back_to_back_ms(fn, n: int = 10) -> float:
    """Milliseconds per call of ``n`` calls of ``fn`` enqueued back to back
    between two CUDA events, after 3: the pace of a serving loop, where the
    host enqueues a call while the card runs the one before."""
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def mscan_base(random_norms: bool):
    """MSCAN-t (1000 classes) with seed-0 weights on the card, channels_last, eval.
    With ``random_norms`` every layer scale is 1 and every BN's affine and running
    stats come from a seeded generator: at the 1e-2 init scales and identity
    stats a wrong fold or border fix would hide under the tolerance."""
    import torch

    from convnet_approximater_tpu_torch.models import MSCAN_Classifier
    from convnet_approximater_tpu_torch.nn import BatchNorm2d, channels_last, init_weights

    model = MSCAN_Classifier(num_classes=1000)
    init_weights(model, torch.Generator().manual_seed(0))
    if random_norms:
        g = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if "layer_scale" in name:
                    p.fill_(1.0)
            for m in model.modules():
                if isinstance(m, BatchNorm2d):
                    C = m.num_features
                    m.weight.copy_(torch.rand(C, generator=g) + 0.5)
                    m.bias.copy_(torch.randn(C, generator=g) * 0.3)
                    m.running_mean.copy_(torch.randn(C, generator=g) * 0.5)
                    m.running_var.copy_(torch.rand(C, generator=g) * 1.5 + 0.5)
    return channels_last(model.cuda()).eval()


def serving_surface(base, decomp_conv0: bool):
    """(plain, surface) from ``base`` through the port's entry points: plain is
    ``apply_app(MscaRep(1, fix[, decomp_conv0]))``; surface is the same, then
    ``apply_app(FfnRep(fix), [IndicesFilter((1, ..., 6))])``, ``fold_batchnorm``
    and ``enable_pw_matmul``, the rewrites of bench.py:177-189.  Checks the
    counts of sites."""
    import copy

    import torch

    from convnet_approximater_tpu_torch.core import FfnRep, MscaRep
    from convnet_approximater_tpu_torch.deploy import enable_pw_matmul, fold_batchnorm
    from convnet_approximater_tpu_torch.deploy_planner import apply_app
    from convnet_approximater_tpu_torch.filters import IndicesFilter

    plain = copy.deepcopy(base)
    n_msca = apply_app(plain, MscaRep(decomp=1, fix=True, decomp_conv0=decomp_conv0), [],
                       torch.Generator().manual_seed(0))
    surface = copy.deepcopy(plain)
    counts = (n_msca,
              apply_app(surface, FfnRep(fix=True), [IndicesFilter((1, 2, 3, 4, 5, 6))],
                        torch.Generator().manual_seed(1)),
              fold_batchnorm(surface), enable_pw_matmul(surface))
    print(f"serving surface{' (dconv0)' if decomp_conv0 else ''}: {counts[0]} MSCA sites "
          f"(MscaRep), {counts[1]} FfnRep sites, {counts[2]} BN folds, {counts[3]} pointwise "
          f"convs as matmuls (expected 13, 6, 5, {HEADLINE_PW})")
    if counts != (13, 6, 5, HEADLINE_PW):
        fail("the serving surface's rewrites found other sites than the JAX package's")
    return plain, surface


def count_pw_convs(model, x):
    """(1x1 convs run by aten::convolution, aten::linear calls) in one eager
    forward, from the op shapes torch.profiler records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        model(x)
    convs = [e for e in prof.events() if e.name == "aten::convolution"]
    pw = sum(1 for e in convs if len(e.input_shapes) > 1 and len(e.input_shapes[1]) == 4
             and e.input_shapes[1][2:] == [1, 1])
    return pw, sum(1 for e in prof.events() if e.name == "aten::linear")


def pw_table(gen):
    """Every 1x1 conv shape of the headline MSCAN-t at b=64, 224^2: cuDNN's conv
    on the channels_last map against the matmul over its NHWC view, in turns
    (conv, matmul, matmul, conv), with each shape's bound; the sums per headline
    forward, by the calls each shape makes there (proj_1 and proj_2 in 13
    blocks, fc1 in the 7 FfnRep leaves, fc2 in 13).  Returns the rows."""
    import torch

    from convnet_approximater_tpu_torch.nn import Conv2d, init_weights

    rows = []
    for stage, ((H, C, blocks), ratio) in enumerate(zip(STAGES, EXP_RATIOS)):
        hidden = C * ratio
        merged = sum(1 for b in range(sum(s[2] for s in STAGES[:stage]),
                                      sum(s[2] for s in STAGES[:stage + 1])) if b < 6)
        for cin, cout, calls in ((C, C, 2 * blocks), (C, hidden, blocks - merged),
                                 (hidden, C, blocks)):
            conv = Conv2d(cin, cout, 1)
            init_weights(conv, gen)
            conv = conv.cuda().eval()
            x = torch.randn(BATCH, cin, H, H, generator=gen).cuda().contiguous(
                memory_format=torch.channels_last)
            with torch.no_grad():
                y_conv = conv(x)
                conv.pw_matmul = True
                y_mm = conv(x)

                def run(mm):
                    conv.pw_matmul = mm
                    return conv(x)

                mm_ms, conv_ms = time_pair(lambda: run(True), lambda: run(False))
            nbytes = 4 * (BATCH * H * H * (cin + cout) + cin * cout + cout)
            flops = 2 * BATCH * H * H * cin * cout
            b_ms, b_by = bound(nbytes, flops)
            rows.append(dict(shape=(BATCH, H, H, cin, cout), calls=calls, conv_ms=conv_ms,
                             mm_ms=mm_ms, bound_ms=b_ms, rel_err=rel_err(y_mm, y_conv)))
            print(f"1x1 ({cin} -> {cout}) at (64, {H}, {H}) x{calls}/headline forward: cuDNN "
                  f"conv {conv_ms:.4f} ms, matmul {mm_ms:.4f} ms ({conv_ms / mm_ms:.2f}x), "
                  f"bound {b_ms:.4f} ms by {b_by}; matmul against conv rel diff "
                  f"{rows[-1]['rel_err']:.1e}")
            del conv, x, y_conv, y_mm
    total = {k: sum(r[k] * r["calls"] for r in rows) for k in ("conv_ms", "mm_ms", "bound_ms")}
    losers = [r["shape"] for r in rows if r["mm_ms"] > r["conv_ms"]]
    print(f"1x1 convs per headline forward ({sum(r['calls'] for r in rows)} calls): cuDNN "
          f"{total['conv_ms']:.4f} ms, matmul {total['mm_ms']:.4f} ms, bound "
          f"{total['bound_ms']:.4f} ms; the matmul loses at {losers or 'no shape'}")
    return rows


def ffn_rep_cost(plain, surface, gen):
    """Device ms of FFNs 1-6: the merged conv with its border fix in the surface
    against fc1 + dconv in plain d1+fix (fc1 as cuDNN's conv, and as the matmul),
    with the bound of each."""
    import torch

    from convnet_approximater_tpu_torch.layers import MergedFFN
    from convnet_approximater_tpu_torch.models.mscan import FFN

    ffns = [m for m in plain.modules() if isinstance(m, FFN)][:6]
    merged = [m for m in surface.modules() if isinstance(m, MergedFFN)]
    if len(merged) != 6:
        fail(f"expected 6 MergedFFN blocks, found {len(merged)}")
    total = np.zeros(5)
    for i, (f, m) in enumerate(zip(ffns, merged)):
        H = STAGES[0][0] if i < 3 else STAGES[1][0]
        C, M, P = f.num_channel, f.hidden_channel, BATCH * H * H
        x = torch.randn(BATCH, C, H, H, generator=gen).cuda().contiguous(
            memory_format=torch.channels_last)

        def fc1_dconv(mm):
            f.fc1.pw_matmul = mm
            return f.dconv(f.fc1(x))

        with torch.no_grad():
            merged_ms, cudnn_ms = time_pair(lambda: m.fix(m.conv(x)), lambda: fc1_dconv(False))
            mm_ms = cuda_ms(lambda: fc1_dconv(True))
        f.fc1.pw_matmul = False
        merged_bound = bound(4 * (P * (C + M) + 9 * C * M), 2 * 9 * P * C * M)[0]
        plain_bound = bound(4 * (P * (C + M) + C * M + 9 * M), 2 * P * M * (C + 9))[0]
        total += (merged_ms, cudnn_ms, mm_ms, merged_bound, plain_bound)
        print(f"FFN {i + 1} (64, {H}, {H}, {C} -> {M}): merged 3x3 conv + fix {merged_ms:.4f} ms "
              f"(bound {merged_bound:.4f}); fc1 + dconv in plain d1+fix {cudnn_ms:.4f} ms, with "
              f"fc1 as the matmul {mm_ms:.4f} ms (bound {plain_bound:.4f})")
    print(f"FfnRep on FFNs 1-6: merged convs {total[0]:.4f} ms per forward (bound {total[3]:.4f}) "
          f"against fc1 + dconv {total[1]:.4f} ms, {total[2]:.4f} ms with fc1 as the matmul "
          f"(bound {total[4]:.4f})")


def serve(name, model, compiled, put, seed: int):
    """Eight seeded batches of 64 from the host through ``put``/``compiled``; the
    loop's img/s, each batch's host-to-device copy included; the argmax and
    the logits of each batch against the eager forward."""
    import torch

    batches = [seeded_batch(seed + i, device="cpu") for i in range(SERVE_BATCHES)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = [compiled(*put(x)) for x in batches]
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    errs, argmax_ok = [], True
    with torch.no_grad():
        for x, y in zip(batches, served):
            y_eager = model(x.cuda().contiguous(memory_format=torch.channels_last))
            errs.append(rel_err(y, y_eager))
            argmax_ok &= torch.equal(y.argmax(1), y_eager.argmax(1))
    n = SERVE_BATCHES * BATCH
    print(f"{name}: served {SERVE_BATCHES} batches of {BATCH} in {loop_s * 1e3:.3f} ms = "
          f"{n / loop_s:.1f} img/s (host-to-device copies included); argmax "
          f"{'equal to' if argmax_ok else 'DIFFERENT from'} eager's, max logits rel err "
          f"{max(errs):.3e} (bound {REPLAY_TOL})")
    if not argmax_ok or max(errs) > REPLAY_TOL:
        fail(f"{name}: served logits disagree with the eager forward")


def pace(model, compiled, x):
    """(eager, graph) milliseconds per forward of ``model`` on ``x`` back to back."""
    import torch

    with torch.no_grad():
        return back_to_back_ms(lambda: model(x)), back_to_back_ms(compiled)


def run_headline():
    """The MSCAN-t headline serving surface (bench.py:161-204) and its dconv0
    form, built through the port's entry points, gated, captured with
    deploy.compile_serving, served and timed eager and as graphs."""
    import copy

    import torch

    from convnet_approximater_tpu_torch.deploy import enable_pw_matmul, fold_batchnorm
    from convnet_approximater_tpu_torch.hooks import eager_times
    from convnet_approximater_tpu_torch.layers import MSCA
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops
    from convnet_approximater_tpu_torch.ops import parallel_cascade as cascade_ops

    gen = torch.Generator().manual_seed(11)
    size = (BATCH, 224, 224, 3)
    x2 = seeded_batch(20, batch=2)

    # gate 1, the exact-rewrite gate of bench.py:199-202, at the init layer scales
    plain, surface = serving_surface(mscan_base(random_norms=False), decomp_conv0=False)
    with torch.no_grad():
        err = float((surface(x2) - plain(x2)).abs().max())
    print(f"exact-rewrite gate: max|dy| of the headline surface against plain d1+fix "
          f"{err:.3e} (bound {EXACT_TOL})")
    if not err < EXACT_TOL:
        fail("the headline rewrites drifted from plain d1+fix")
    del plain, surface

    # gate 2, layer scales 1 and random BN: against plain d1+fix and msca_fused_ref
    base = mscan_base(random_norms=True)
    plain, surface = serving_surface(base, decomp_conv0=False)
    with torch.no_grad():
        y = surface(x2)
        with mock.patch.object(fused_ops, "msca_fused", fused_ops.msca_fused_ref):
            y_ref = surface(x2)
        check_logits("headline surface (layer scales 1, random BN)", y,
                     {"plain d1+fix": plain(x2), "msca_fused_ref": y_ref}, LOGITS_TOL)

    # gate 3, launches: 13 msca_fused calls per eager forward, no 1x1 conv through cuDNN
    reset_counts()
    times = {"surface": eager_times(surface, size, "cuda", 10, 3)}
    launches = fused_ops.msca_fused.launches
    print(f"headline surface: 13 forwards launched msca_fused {launches} times "
          f"(13 per forward)")
    if launches != 13 * 13:
        fail(f"the headline forwards launched msca_fused {launches} times, expected {13 * 13}")
    x = seeded_batch(21)
    pw, linears = count_pw_convs(surface, x)
    # channel_mix is a weight of msca_fused, so 13 of the flagged convs run no forward of their own
    print(f"headline eager forward: {pw} 1x1 convs through aten::convolution, {linears} "
          f"aten::linear calls (expected 0 and {HEADLINE_PW - 13 + 1}: the matmuls and the head)")
    if pw != 0 or linears != HEADLINE_PW - 13 + 1:
        fail("a pointwise conv of the headline surface did not run as a matmul")

    # gate 4 and serving: the graph
    compiled, put, names = check_graph("headline surface", surface,
                                       {"msca_fused march": 13, "msca_fused mix": 13}, 22)
    with torch.no_grad():
        eager = kernels_of(lambda: surface(x))
    transposes = [sum("nchwToNhwc" in n or "nhwcToNchw" in n for n in k) for k in (names, eager)]
    print(f"headline surface: {transposes[0]} NCHW/NHWC transposes in one replay, "
          f"{transposes[1]} in one eager forward (the convs that are not 1x1)")
    if transposes[0] > transposes[1]:
        fail("the headline replay runs transposes the eager forward does not")
    serve("headline surface", surface, compiled, put, 100)
    graphs = {"surface": time_graph(compiled, put, size)}
    host = {"surface": (host_enqueue_ms(surface, size), host_ms(compiled))}
    paced = {"surface": pace(surface, compiled, x)}
    with torch.no_grad():  # the kernel route: no gradient can be asked
        profile_calls("headline surface eager forward (64, 224, 224, 3)", lambda: surface(x),
                      keep=MSCA_KERNELS)
    profile_calls("headline surface graph replay (64, 224, 224, 3)", compiled, keep=MSCA_KERNELS)
    del compiled, put

    pw_rows = pw_table(gen)
    ffn_rep_cost(plain, surface, gen)

    # the same rewrites without FfnRep, to read what the merge costs end to end
    unmerged = copy.deepcopy(plain)
    if (fold_batchnorm(unmerged), enable_pw_matmul(unmerged)) != (5, 13 * 5):
        fail("fold_batchnorm and enable_pw_matmul found other sites on plain d1+fix")
    with torch.no_grad():
        check_logits("d1+fix, folded, 1x1 as matmuls (no FfnRep)", unmerged(x2),
                     {"plain d1+fix": plain(x2)}, LOGITS_TOL)
    for key, model in (("plain d1+fix", plain), ("no FfnRep", unmerged), ("dense", base)):
        times[key] = eager_times(model, size, "cuda", 10, 3)
        compiled, put = check_graph(f"MSCAN-t {key}", model, {"msca_fused march": 13}, 23)[:2]
        graphs[key] = time_graph(compiled, put, size)
        host[key] = (host_enqueue_ms(model, size), host_ms(compiled))
        paced[key] = pace(model, compiled, x)
        del compiled, put
    del plain, surface, unmerged

    # the dconv0 serving surface (scripts/serve_mscan.py:61-70)
    plain, surface = serving_surface(base, decomp_conv0=True)
    with torch.no_grad():
        check_logits("dconv0 surface (layer scales 1, random BN)", surface(x2), {
            "plain d1+fix+dconv0": plain(x2), "parallel_cascade_ref": through_plain(surface, x2),
            "the module path": module_path(surface, MSCA, x2)}, LOGITS_TOL)
    reset_counts()
    times["dconv0"] = eager_times(surface, size, "cuda", 10, 3)
    launches, fused = cascade_ops.parallel_cascade.launches, fused_ops.msca_fused.launches
    print(f"dconv0 surface: 13 forwards launched parallel_cascade {launches} times (26 per "
          f"forward), msca_fused {fused} times")
    if launches != 26 * 13 or fused != 0:
        fail("the dconv0 surface did not launch parallel_cascade 26 times per forward")
    compiled, put, _ = check_graph("dconv0 surface", surface,
                                   {"parallel_cascade": 26, "msca_fused march": 0}, 24)
    serve("dconv0 surface", surface, compiled, put, 200)
    graphs["dconv0"] = time_graph(compiled, put, size)
    host["dconv0"] = (host_enqueue_ms(surface, size), host_ms(compiled))
    paced["dconv0"] = pace(surface, compiled, x)
    with torch.no_grad():
        profile_calls("dconv0 surface eager forward (64, 224, 224, 3)", lambda: surface(x))
    profile_calls("dconv0 surface graph replay (64, 224, 224, 3)", compiled)
    del compiled, put, plain, surface, base
    torch.cuda.empty_cache()

    for key in ("dense", "plain d1+fix", "no FfnRep", "surface", "dconv0"):
        eager_ms = float(np.median(times[key]))
        print(f"MSCAN-t {key} forward (64, 224, 224, 3) f32: eager median {eager_ms:.3f} ms, "
              f"graph median {graphs[key]:.3f} ms ({BATCH / graphs[key] * 1e3:.1f} img/s); "
              f"back to back {paced[key][0]:.3f} ms eager, {paced[key][1]:.3f} ms graph; host "
              f"time to enqueue one eager forward {host[key][0]:.3f} ms, one replay "
              f"{host[key][1]:.3f} ms")
    for label, key in (("M1 (plain d1+fix)", "plain d1+fix"), ("headline", "surface"),
                       ("no FfnRep", "no FfnRep"), ("dconv0", "dconv0")):
        print(f"dense / {label}: eager {np.median(times['dense']) / np.median(times[key]):.4f}, "
              f"graph {graphs['dense'] / graphs[key]:.4f}; back to back eager "
              f"{paced['dense'][0] / paced[key][0]:.4f}, graph "
              f"{paced['dense'][1] / paced[key][1]:.4f}")
    return pw_rows


# -- 10. fine-tuning ------------------------------------------------------------
FT_D0 = os.path.join(REPO, "configs", "msca-rep", "finetune", "msca-rep-d0-fix_l2-asym_mscan-t.py")
FT_D1 = os.path.join(REPO, "configs", "msca-rep", "each_layer", "msca-rep_d1_l1_fix_class-t.py")
FT_ALEX = os.path.join(REPO, "configs", "low-rank-exp",
                       "low-rank-exp-v1_l2345_svd_dodecomp_l2-sym_alexnet.py")
FT_STEPS = 4          # steps per epoch: the hook's default Synthetic(256) at batch 64
FT_TAP_TOL = 1e-5     # the teacher's taps through msca_fused against msca_fused_ref
FT_CPU_TOL = 1e-4     # a step's loss and gradient norm on the card against the CPU's
FT_CPU_BATCH = 8      # images of the first training batch the CPU step is run on
MSCA_BLOCKS = 13


@contextlib.contextmanager
def uncounted():
    """Launches inside the block (checks against the plain versions, and
    measurements) leave every kernel's launch count as it was."""
    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops
    from convnet_approximater_tpu_torch.ops import parallel_cascade as cascade_ops
    from convnet_approximater_tpu_torch.ops import qmatmul as qmatmul_ops

    fns = (fused_ops.msca_fused, lowrank_ops.lowrank_conv, cascade_ops.parallel_cascade,
           qmatmul_ops.qmatmul)
    saved = [f.launches for f in fns]
    try:
        yield
    finally:
        for f, n in zip(fns, saved):
            f.launches = n


class FinetuneProbe:
    """Instrumentation of one L2Reconstruct run through the Runner: the
    launches of ``counter``'s kernel in each training step and each
    validation forward, each step's loss and CUDA-event time, each checkpoint
    save's host time, and callbacks before the first epoch (``first``, given
    the train loader), around every epoch (``before_epoch``/``after_epoch``)
    and after the hook (``last``)."""

    def __init__(self, counter, first=None, before_epoch=None, after_epoch=None, last=None):
        self.counter = counter
        self.first, self.before_epoch, self.after_epoch, self.last = (
            first, before_epoch, after_epoch, last)
        self.step_calls, self.eval_calls, self.losses, self.events, self.saves = (
            [], [], [], [], [])

    def patches(self):
        import torch

        from convnet_approximater_tpu_torch.hooks import finetune as ft

        probe = self
        train_step = ft.L2Reconstruct.train_step
        one_epoch = ft.L2Reconstruct._train_one_epoch
        after_optimize = ft.L2Reconstruct.after_optimize
        save, eval_batch = ft.CheckpointSaver.save_checkpoint, ft.eval_batch

        def counting(fn, calls):
            def wrapped(*args, **kwargs):
                n = probe.counter.launches
                out = fn(*args, **kwargs)
                calls.append(probe.counter.launches - n)
                return out
            return wrapped

        def step(hook, *args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            n = probe.counter.launches
            start.record()
            out = train_step(hook, *args, **kwargs)
            end.record()
            probe.step_calls.append(probe.counter.launches - n)
            probe.events.append((start, end))
            probe.losses.append(out[0])
            return out

        def epoch(hook, e, loader, *args, **kwargs):
            if e == 0 and probe.first:
                with uncounted():
                    probe.first(hook, loader)
            if probe.before_epoch:
                probe.before_epoch(hook, e)
            out = one_epoch(hook, e, loader, *args, **kwargs)
            if probe.after_epoch:
                with uncounted():
                    probe.after_epoch(hook, e)
            return out

        def hook_run(hook):
            after_optimize(hook)
            if probe.last:
                kept = [(v, len(v)) for v in (probe.losses, probe.events, probe.step_calls)]
                with uncounted():
                    probe.last(hook)
                for v, n in kept:  # the run's steps only, not the measurements'
                    del v[n:]

        def timed_save(saver, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = save(saver, *args, **kwargs)
            probe.saves.append(time.perf_counter() - t0)
            return out

        return [mock.patch.object(ft, "eval_batch", counting(eval_batch, self.eval_calls)),
                mock.patch.object(ft.L2Reconstruct, "train_step", step),
                mock.patch.object(ft.L2Reconstruct, "_train_one_epoch", epoch),
                mock.patch.object(ft.L2Reconstruct, "after_optimize", hook_run),
                mock.patch.object(ft.CheckpointSaver, "save_checkpoint", timed_save)]

    def step_ms(self):
        import torch

        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def run_finetune_cfg(config, work_dir, probe, edit_hook, hook_type="L2Reconstruct",
                     **cfg_updates):
    """The Runner on ``config`` on the card, seed 0, its ``hook_type`` hook's
    arguments edited by ``edit_hook`` (the listed cuts), under ``probe``;
    (runner, seconds)."""
    import copy

    import torch

    from convnet_approximater_tpu_torch.runner import Runner
    from convnet_approximater_tpu_torch.utils import build_logger, get_cfg, init_cfg, update_cfg

    init_cfg(config)
    cfg = get_cfg()
    hooks = copy.deepcopy(list(cfg.hooks))
    edit_hook(next(h for h in hooks if h["type"] == hook_type))
    os.makedirs(work_dir, exist_ok=True)
    build_logger(os.path.join(work_dir, "run.log"))
    update_cfg(hooks=hooks, work_dir=work_dir, config_name=cfg.name, seed=0, **cfg_updates)
    patches = probe.patches()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        runner = Runner(device="cuda", generator=torch.Generator().manual_seed(0))
        runner.run()
    torch.cuda.synchronize()
    return runner, time.perf_counter() - t0


def held_out(num_classes: int, n: int = BATCH, seed: int = 7):
    """One batch of ``n`` Synthetic images at 224^2 that no training step sees."""
    from convnet_approximater_tpu_torch.data import Loader, Synthetic

    ds = Synthetic(n, (224, 224, 3), num_classes, seed=seed, split="validation")
    return next(iter(Loader(ds, n, device="cuda", prefetch=0)))


def probe_step(hook, images, labels, model=None, teacher=None):
    """``(loss, global norm of the trainable gradients)`` of a training step on a
    batch, computed as the step computes it, with no update; the BatchNorm
    state is saved and restored around it and the gradients cleared."""
    import torch

    from convnet_approximater_tpu_torch.layers import release_taps

    model = model if model is not None else hook.runner.model
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    for p in model.parameters():
        p.grad = None
    loss, _, _ = hook.loss(images, labels, model=model, teacher=teacher)
    loss.backward()
    trainable = hook.trainable(-1)
    gnorm = torch.stack([p.grad.pow(2).sum() for n, p in model.named_parameters()
                         if n in trainable and p.grad is not None]).sum().sqrt()
    with torch.no_grad():
        for n, b in model.named_buffers():
            b.copy_(buffers[n])
    for p in model.parameters():
        p.grad = None
    release_taps(model)
    model.eval()
    return loss.item(), gnorm.item()


def smi_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def check_ckpt_loads_back(hook, model, work_dir, label="F1"):
    """The last checkpoint the hook wrote holds the model's weights bit for bit."""
    from convnet_approximater_tpu_torch.convert import load_jax_flat, params_to_jax
    from convnet_approximater_tpu_torch.utils import load_flat

    path = os.path.join(work_dir, "last.ckpt.npz")
    flat = load_flat(path)
    want = params_to_jax(model.state_dict())
    if set(k for k in flat if k.split("/")[0] in ("params", "state")) != set(want):
        fail(f"{path}: its params/state keys differ from the model's")
    if any(not np.array_equal(flat[k], v) for k, v in want.items()):
        fail(f"{path}: a weight does not load back bit for bit")
    import copy

    clone = copy.deepcopy(model)
    load_jax_flat(clone, flat)
    sd, back = model.state_dict(), clone.state_dict()
    if any(not (sd[k] == back[k]).all() for k in sd):
        fail(f"{path}: loading it into the model changes a weight")
    meta = (int(flat["meta/epoch"]), float(flat["meta/metric"]))
    print(f"{label} checkpoint {os.path.relpath(path, REPO)}: {len(want)} weights and "
          f"{sum(k.startswith('opt/') for k in flat)} optimizer leaves, epoch {meta[0]}; "
          f"loads back bit for bit")


def run_ft_d0():
    """F1: MSCAN-t asym, the exact rewrite (MscaRep d0+fix on all 13 blocks)."""
    import torch

    from convnet_approximater_tpu_torch.classification import eval_batch
    from convnet_approximater_tpu_torch.layers import release_taps
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops

    work_dir = os.path.join(REPO, "build", "chip_smoke_ft_d0")
    x, y = held_out(10)
    stats = {}

    def first(hook, loader):
        student, teacher = hook.runner.model, hook.teacher
        with torch.no_grad():
            y_student = student.eval()(x)
            y_teacher = teacher(x)
            _, taps = hook.teacher_pass(x)
            with mock.patch.object(fused_ops, "msca_fused", fused_ops.msca_fused_ref):
                _, taps_ref = hook.teacher_pass(x)
        err = rel_err(y_student, y_teacher)
        tap_err = max(rel_err(taps[k], taps_ref[k]) for k in taps)
        print(f"F1 before the first step: student (d0+fix, module path) against teacher "
              f"(dense, msca_fused) eval logits {tuple(y_student.shape)}: rel err {err:.3e} "
              f"(bound {LOGITS_TOL}); the teacher's {len(taps)} taps against msca_fused_ref: "
              f"max rel err {tap_err:.3e} (bound {FT_TAP_TOL})")
        if len(taps) != MSCA_BLOCKS or err > LOGITS_TOL or tap_err > FT_TAP_TOL:
            fail("F1: the teacher is not the original model on the kernel route")

    def last(hook):
        model = hook.runner.model
        check_ckpt_loads_back(hook, model, work_dir)
        stats["peak"] = torch.cuda.max_memory_allocated()
        # one steady step profiled, then its parts timed alone
        mask = hook.trainable(-1)
        step = lambda: hook.train_step(x, y, mask)
        stats["step_prof"] = profile_share("one F1 training step", step)
        stats["teacher_ms"] = cuda_ms(lambda: hook.teacher_pass(x), iters=10)
        loss, _, _ = hook.loss(x, y)
        loss.backward()
        stats["opt_ms"] = cuda_ms(lambda: hook.optimizer.step(mask), iters=10)
        hook.optimizer.zero_grad()
        release_taps(model)
        stats["val_ms"] = cuda_ms(lambda: eval_batch(model, x, y), iters=10)

    probe = FinetuneProbe(fused_ops.msca_fused, first=first, last=last)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    runner, run_s = run_finetune_cfg(FT_D0, work_dir, probe,
                                     lambda h: h["sche_args"].update(epochs=2))
    launches = fused_ops.msca_fused.launches
    hook = runner.hooks[0]
    steps = len(probe.losses)
    losses = [float(v) for v in probe.losses]
    print(f"F1 {os.path.relpath(FT_D0, REPO)} through the Runner in {run_s:.2f} s, cut: "
          f"sche_args.epochs 20 -> 2 ({FT_STEPS} steps each on the hook's default "
          f"Synthetic(256), b = {BATCH}, 224^2, f32, TF32 off); {steps} steps, losses "
          f"{', '.join(f'{v:.6g}' for v in losses)}")
    if steps != 2 * FT_STEPS or not all(np.isfinite(losses)):
        fail("F1: a loss is not finite, or the run took another number of steps")
    print(f"F1 msca_fused launches: {probe.step_calls} per training step, all in the "
          f"teacher's forward (each call is 2 kernels), {probe.eval_calls} per validation "
          f"forward of the d0+fix student (a dense 21x21 bank: the module path); {launches} "
          f"in the run")
    if (probe.step_calls != [MSCA_BLOCKS] * steps
            or launches != MSCA_BLOCKS * steps + sum(probe.eval_calls)):
        fail(f"F1: the teacher must launch msca_fused {MSCA_BLOCKS} times per step")
    times = probe.step_ms()[1:]
    step_ms = float(np.median(times))
    prof_ms, msca_ms = stats["step_prof"]
    smi = smi_line()
    print(f"F1 fine-tune of MSCAN-t d0+fix asym, b = {BATCH}, 224^2, f32 [{smi}]: "
          f"median {step_ms:.3f} ms per training step over steps 2-{steps} (CUDA events), "
          f"{BATCH / step_ms * 1e3:.1f} img/s; teacher forward {stats['teacher_ms']:.3f} ms; "
          f"optimizer step {stats['opt_ms']:.3f} ms; validation {stats['val_ms']:.3f} ms per "
          f"batch of {BATCH}; checkpoint save {', '.join(f'{s:.3f}' for s in probe.saves)} s; "
          f"max_memory_allocated {stats['peak'] / 2**30:.2f} GiB")
    if prof_ms is not None:
        print(f"F1 one training step under torch.profiler [{smi}]: {prof_ms:.3f} ms of device "
              f"time, msca_fused (march + mix) {msca_ms:.3f} ms = "
              f"{100 * msca_ms / prof_ms:.2f} % of it")
    del runner, hook
    torch.cuda.empty_cache()
    return launches


def profile_share(name, fn, n: int = 2):
    """(device ms of one ``fn()``, device ms of msca_fused's kernels in it),
    from torch.profiler over ``n`` calls after one, with the 10 largest kernels
    printed; (None, None) when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if not is_kernel(e):
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        rows.append((us / 1e3 / n, e.count // n, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    if not rows:
        print(f"profile of {name}: torch.profiler recorded no device time (not measured)")
        return None, None
    print(f"profile of {name} (torch.profiler, {n} calls): {total:.3f} device ms per call; "
          f"the 10 largest kernels (ms per call, launches per call):")
    for ms, count, kname in rows[:10]:
        print(f"  {ms:8.3f} ms  x{count:<4d} {kname[:100]}")
    return total, sum(r[0] for r in rows if any(k in r[2] for k in MSCA_KERNELS))


def run_ft_d1():
    """F2: MSCAN-t asym, inexact (MscaRep d1+fix on block 1), drop rates 0."""
    import copy

    import torch

    from convnet_approximater_tpu_torch.layers import drop_generator
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops
    from convnet_approximater_tpu_torch.utils import get_cfg, init_cfg

    work_dir = os.path.join(REPO, "build", "chip_smoke_ft_d1")
    x_held, y_held = held_out(10)
    held = {}

    def first(hook, loader):
        held["before"] = probe_step(hook, x_held, y_held)[0]
        x, y = (t[:FT_CPU_BATCH] for t in next(iter(loader)))
        gpu = probe_step(hook, x, y)
        with drop_generator(hook.runner.model, None):
            cpu_model = copy.deepcopy(hook.runner.model).cpu()
        cpu_teacher = copy.deepcopy(hook.teacher).cpu()
        t0 = time.perf_counter()
        cpu = probe_step(hook, x.cpu(), y.cpu(), model=cpu_model, teacher=cpu_teacher)
        errs = [abs(a - b) / abs(b) for a, b in zip(gpu, cpu)]
        print(f"F2 the first training batch's first {FT_CPU_BATCH} images, one step with no "
              f"update: loss {gpu[0]:.7g} on the card, {cpu[0]:.7g} on the CPU (rel err "
              f"{errs[0]:.3e}); trainable gradient norm {gpu[1]:.7g} and {cpu[1]:.7g} (rel err "
              f"{errs[1]:.3e}); bound {FT_CPU_TOL}; CPU step {time.perf_counter() - t0:.2f} s")
        if max(errs) > FT_CPU_TOL:
            fail("F2: the step on the card disagrees with the same step on the CPU")

    def last(hook):
        held["after"] = probe_step(hook, x_held, y_held)[0]

    probe = FinetuneProbe(fused_ops.msca_fused, first=first, last=last)
    init_cfg(FT_D1)
    model_cfg = dict(get_cfg().model, drop_path_rate=0.0, drop_rate=0.0)
    reset_counts()
    runner, run_s = run_finetune_cfg(FT_D1, work_dir, probe,
                                     lambda h: h["sche_args"].update(epochs=1), model=model_cfg)
    launches = fused_ops.msca_fused.launches
    steps = len(probe.losses)
    print(f"F2 {os.path.relpath(FT_D1, REPO)} through the Runner in {run_s:.2f} s, cuts: "
          f"drop_path_rate 0.1 -> 0, sche_args.epochs 20 -> 1 ({steps} steps, b = {BATCH}); "
          f"held-out L2 loss (b = {BATCH}) {held['before']:.7g} before, {held['after']:.7g} "
          f"after; msca_fused launches {probe.step_calls} per training step, "
          f"{probe.eval_calls} per validation forward; {launches} in the run")
    if steps != FT_STEPS or not held["after"] < held["before"]:
        fail("F2: 4 steps did not lower the held-out L2 loss")
    if probe.eval_calls != [MSCA_BLOCKS] * len(probe.eval_calls) or not probe.eval_calls:
        fail(f"F2: the validation forward must launch msca_fused {MSCA_BLOCKS} times")
    times = probe.step_ms()[1:]
    print(f"F2 fine-tune of MSCAN-t d1+fix (block 1) asym [{smi_line()}]: median "
          f"{float(np.median(times)):.3f} ms per training step over steps 2-{steps}")
    del runner
    torch.cuda.empty_cache()
    return launches


def run_ft_alexnet():
    """F3: AlexNet sym, layer-wise (convs 2-5 as separable LowRankExpConvV1,
    epoch_behavior [0, 0, 1, 1, 2, 2, 3, 3])."""
    import torch

    from convnet_approximater_tpu_torch.classification import eval_batch
    from convnet_approximater_tpu_torch.layers import LowRankExpConvV1
    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops

    work_dir = os.path.join(REPO, "build", "chip_smoke_ft_alexnet")
    x, y = held_out(10)
    snaps, shared, before_calls = {}, [], []

    def first(hook, loader):
        model = hook.runner.model
        n = lowrank_ops.lowrank_conv.launches
        eval_batch(model.eval(), x, y)
        before_calls.append(lowrank_ops.lowrank_conv.launches - n)

    def before_epoch(hook, e):
        snaps[e] = {n: p.detach().clone() for n, p in hook.runner.model.named_parameters()}

    def after_epoch(hook, e):
        model = hook.runner.model
        layer = model.switchable_names[hook.epoch_behavior[e]]
        before = snaps.pop(e)
        moved = {n for n, p in model.named_parameters() if not torch.equal(p, before[n])}
        branch = {n for n, _ in model.named_parameters() if n.startswith(f"{layer}.new.")}
        if not moved or not moved <= branch:
            fail(f"F3 epoch {e}: parameters outside {layer}.new moved, or none moved: "
                 f"{sorted(moved - branch)[:4]}")
        with torch.no_grad():
            shared.append(sum(m.bases_shared() for m in model.modules()
                              if isinstance(m, LowRankExpConvV1)))
        print(f"F3 epoch {e}: {len(moved)} of the {len(branch)} parameters of {layer}.new "
              f"moved, every other parameter (and every old branch) bit-equal")

    def edit(h):
        h["dataset_args"].update(dataset=None)
        h["other_args"].update(max_steps_per_epoch=FT_STEPS, checkpoint_hist=1)

    def last(hook):
        profile_share("one F3 training step (layer 3's epochs)",
                      lambda: hook.train_step(x, y, hook.trainable(3)))

    probe = FinetuneProbe(lowrank_ops.lowrank_conv, first=first, before_epoch=before_epoch,
                          after_epoch=after_epoch, last=last)
    reset_counts()
    runner, run_s = run_finetune_cfg(FT_ALEX, work_dir, probe, edit)
    launches = lowrank_ops.lowrank_conv.launches
    hook = runner.hooks[0]
    norms = ", ".join(f"{r['train_norm']:.6g}" for r in
                      summary_rows(os.path.join(work_dir, "summary.csv")))
    ckpt_mib = os.path.getsize(os.path.join(work_dir, "last.ckpt.npz")) / 2**20
    print(f"F3 {os.path.relpath(FT_ALEX, REPO)} through the Runner in {run_s:.2f} s, cuts: "
          f"dataset CIFAR10 -> None (Synthetic, 10 classes: no CIFAR-10 in the repository), "
          f"{FT_STEPS} steps per epoch, checkpoint_hist 10 -> 1 (each checkpoint of AlexNet "
          f"with its optimizer state is {ckpt_mib:.0f} MiB); logged L2 norm per epoch (not "
          f"gated): {norms}")
    per_epoch = len(probe.eval_calls) // max(len(shared), 1)
    print(f"F3 lowrank_conv launches per validation forward: {before_calls} before training, "
          f"then {probe.eval_calls} ({per_epoch} batches per epoch) after epochs 0-7; "
          f"{probe.step_calls} per training step; layers whose bases are still shared by "
          f"every input channel after each epoch: {shared} (a trained layer's bases differ "
          f"per channel, so it takes the module path); {launches} in the run")
    if (before_calls != [4] or len(shared) != 8 or per_epoch == 0
            or probe.eval_calls != [s for s in shared for _ in range(per_epoch)]):
        fail("F3: the validation forward must launch lowrank_conv once per layer whose bases "
             "the kernel can express (4 before training)")
    times = probe.step_ms()[1:]
    print(f"F3 fine-tune of AlexNet scheme-1 sym [{smi_line()}]: median "
          f"{float(np.median(times)):.3f} ms per training step over steps 2-{len(times) + 1}; "
          f"checkpoint save median {float(np.median(probe.saves)):.3f} s")
    del runner, hook
    torch.cuda.empty_cache()
    return launches


def summary_rows(path):
    lines = open(path).read().strip().split("\n")
    header = lines[0].split(",")
    return [dict(zip(header, map(float, line.split(",")))) for line in lines[1:]]


def run_finetune():
    """F1-F3, each driven with the launch counts at 0 and read after it."""
    return run_ft_d0(), run_ft_d1(), run_ft_alexnet()


# -- 11. ResNet-18, VGG-16, int8 ResNet-50 and the MSCAN-t hook configs ------------------

RESNET18 = os.path.join(REPO, "configs", "resnet", "low-rank-exp-v1_blocks_svd_resnet18.py")
RESNET18_INIT = os.path.join(REPO, "configs", "resnet",
                             "low-rank-exp-v1_blocks_svd_initdecomp_resnet18.py")
VGG16 = os.path.join(REPO, "configs", "vgg", "low-rank-exp-v1_all_svd_vgg16.py")
RESNET50_INT8 = os.path.join(REPO, "configs", "resnet", "serve_int8_resnet50.py")
MSCAN_FPS = os.path.join(REPO, "configs", "msca-rep", "fps", "msca-rep_d1_mscan-t_fps.py")
MSCAN_PROFILES = [os.path.join(REPO, "configs", "msca-rep", "profiler", c)
                  for c in ("msca-rep-profile_d1_fix_mscan-t.py", "msca-profile_mscan-t.py")]
MSCAN_DUMMY = os.path.join(REPO, "configs", "msca-rep", "dummy_mscan-t.py")
# the 16 block 3x3s of ResNet-18 in the switchable walk's order
RESNET18_SITES = [f"layer{i}.{j}.conv{k}" for i in (1, 2, 3, 4) for j in (0, 1) for k in (1, 2)]
VGG16_SITES = [f"features.{i}" for i in (2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)]
MSCA_STAGES = ("CONV0", "SD_CONVS", "CHANNEL_MIX")
INPUT = (BATCH, 224, 224, 3)


def through_lowrank_ref(model, x):
    """``model(x)`` with lowrank_conv swapped for its plain version."""
    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops

    with mock.patch.object(lowrank_ops, "lowrank_conv",
                           lambda *a, packed=None, **k: lowrank_ops.lowrank_conv_ref(*a, **k)):
        return model(x)


def drive_scheme1(gen, config, sites, M, classes):
    """The Runner on a scheme-1 config through the CLI: the registered sites,
    separable LowRankExpConvV1s of M bases that all dispatch to lowrank_conv,
    one launch per site per forward, the logits against the plain version and
    the module path.  Returns (runner, launches, logits on ``images(gen)``, x)."""
    import torch

    from convnet_approximater_tpu_torch.layers import LowRankExpConvV1
    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops

    name = os.path.relpath(config, REPO)
    work_dir = os.path.join(REPO, "build", "chip_smoke_" + os.path.basename(config)[:-3])
    reset_counts()
    runner, run_s = run_cli(config, work_dir)
    launches = lowrank_ops.lowrank_conv.launches
    model, forwards = runner.model, forwards_of(runner)
    layers = list(model.switchable_modules())
    if model.switchable_names != sites or not all(
            isinstance(m, LowRankExpConvV1) and m.num_base == M and hasattr(m.s_conv, "v_conv")
            for m in layers):
        fail(f"{name}: registered {model.switchable_names}, expected {len(sites)} separable "
             f"LowRankExpConvV1 of {M} bases at {sites}")
    with torch.no_grad():  # the kernel route: no gradient can be asked
        dispatched = all(m.uses_kernel() for m in layers)
    if not dispatched:
        fail(f"{name}: a LowRankExpConvV1 layer does not dispatch to lowrank_conv")
    if launches != len(sites) * forwards or launches == 0:
        fail(f"{name}: lowrank_conv launched {launches} times in {forwards} forwards, "
             f"expected {len(sites) * forwards}")
    with open(os.path.join(work_dir, "run.log")) as f:
        macs_line = [ln.strip() for ln in f if "Model MACs: " in ln]
    if not macs_line:
        fail(f"{name}: ModelAnalysis logged no 'Model MACs' line")
    print(f"main path: Runner on {name} in {run_s:.2f} s; {forwards} forwards launched "
          f"lowrank_conv {launches} times ({len(sites)} per forward); "
          f"{macs_line[0].split(' - ')[-1]}")
    x = images(gen)
    with torch.no_grad():
        y = model(x)
        check_logits(name, y, {"lowrank_conv_ref": through_lowrank_ref(model, x),
                               "the module path": module_path(model, LowRankExpConvV1, x)},
                     LOGITS_TOL, classes=classes)
    return runner, launches, y, x


def time_dense(name, model, low_ms):
    """Time a dense model of seed-0 weights beside its compressed form's median."""
    import torch

    from convnet_approximater_tpu_torch.hooks import eager_times
    from convnet_approximater_tpu_torch.nn import init_weights

    init_weights(model, torch.Generator().manual_seed(0))
    model = model.cuda().to(memory_format=torch.channels_last).eval()
    dense_ms = float(np.median(eager_times(model, INPUT, "cuda")))
    print(f"{name} dense forward {INPUT} f32: median {dense_ms:.3f} ms "
          f"({BATCH / dense_ms * 1e3:.1f} img/s); dense / compressed = {dense_ms / low_ms:.4f}")
    del model
    torch.cuda.empty_cache()
    return dense_ms


def run_resnet18(gen):
    """P1: the scheme-1 ResNet-18 through the CLI, timed beside dense ResNet-18,
    profiled; then fold_batchnorm (20 pairs, 16 through LowRankExpConvV1.d_conv),
    the logits again, a compile_serving replay with 16 lowrank_conv kernels; then
    the initdecomp config through the CLI, given P1's weights as a deployment
    would load them.  Returns lowrank_conv's launches in the CLI run."""
    import torch

    from convnet_approximater_tpu_torch import deploy
    from convnet_approximater_tpu_torch.convert import load_jax_flat, params_to_jax
    from convnet_approximater_tpu_torch.hooks import InferenceTimeHook
    from convnet_approximater_tpu_torch.models import ResNet
    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops

    runner, launches, y, x = drive_scheme1(gen, RESNET18, RESNET18_SITES, 4, 1000)
    model = runner.model
    hook = next(h for h in runner.hooks if isinstance(h, InferenceTimeHook))
    low_ms = hook.result["eager_median_ms"]
    print(f"ResNet-18 scheme-1 forward {INPUT} f32: median {low_ms:.3f} ms "
          f"({BATCH / low_ms * 1e3:.1f} img/s)")
    time_dense("ResNet-18", ResNet(18, 1000), low_ms)
    profile_forward("ResNet-18 scheme-1", model, INPUT, keep=("lowrank_kernel",))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}

    n = deploy.fold_batchnorm(model)
    reset_counts()
    with torch.no_grad():
        y_fold = model(x)
    folded = lowrank_ops.lowrank_conv.launches
    print(f"ResNet-18 scheme-1: fold_batchnorm folded {n} pairs (expected 20); one forward "
          f"after it launched lowrank_conv {folded} times (expected 16)")
    if n != 20 or folded != 16:
        fail("ResNet-18 scheme-1: the fold or the repacked kernel weights went wrong")
    check_logits("ResNet-18 scheme-1 after fold_batchnorm", y_fold, {"before the fold": y},
                 LOGITS_TOL)
    compiled, put = check_graph("ResNet-18 scheme-1 graph", model, {"lowrank_conv": 16}, 40)[:2]
    paced = pace(model, compiled, seeded_batch(40))
    print(f"ResNet-18 scheme-1 (folded) as a graph: median "
          f"{time_graph(compiled, put, INPUT):.3f} ms; back to back {paced[0]:.3f} ms eager, "
          f"{paced[1]:.3f} ms graph; eager median "
          f"{float(np.median(eager_times_cuda(model))):.3f} ms")
    del compiled, put, runner, model
    torch.cuda.empty_cache()

    reset_counts()
    runner, run_s = run_cli(RESNET18_INIT, os.path.join(REPO, "build", "chip_smoke_initdecomp"))
    model, forwards = runner.model, forwards_of(runner)
    if model.switchable_names != RESNET18_SITES or not all(
            hasattr(m.s_conv, "v_conv") for m in model.switchable_modules()):
        fail(f"{os.path.relpath(RESNET18_INIT, REPO)}: expected 16 separable layers")
    print(f"main path: Runner on {os.path.relpath(RESNET18_INIT, REPO)} in {run_s:.2f} s (no "
          f"solve; the separable layers keep their random per-channel init, so they take the "
          f"module path: lowrank_conv launched {lowrank_ops.lowrank_conv.launches} times in "
          f"{forwards} forwards)")
    load_jax_flat(model, params_to_jax(state))  # the solved weights, as a deployment loads them
    reset_counts()
    with torch.no_grad():
        y_init = model(x)
    if lowrank_ops.lowrank_conv.launches != 16:
        fail(f"initdecomp with P1's weights launched lowrank_conv "
             f"{lowrank_ops.lowrank_conv.launches} times in one forward, expected 16")
    check_logits("initdecomp ResNet-18 with P1's weights (16 launches)", y_init,
                 {"P1 before the fold": y}, LOGITS_TOL)
    del runner, model
    torch.cuda.empty_cache()
    return launches


def eager_times_cuda(model):
    from convnet_approximater_tpu_torch.hooks import eager_times

    return eager_times(model, INPUT, "cuda")


def run_vgg16(gen):
    """P2: the scheme-1 VGG-16 through the CLI (12 sites, 16 bases), timed beside
    dense VGG-16 and profiled.  Returns lowrank_conv's launches in the CLI run."""
    import torch

    from convnet_approximater_tpu_torch.hooks import InferenceTimeHook
    from convnet_approximater_tpu_torch.models import VGG

    runner, launches, _, _ = drive_scheme1(gen, VGG16, VGG16_SITES, 16, 10)
    model = runner.model
    hook = next(h for h in runner.hooks if isinstance(h, InferenceTimeHook))
    low_ms = hook.result["eager_median_ms"]
    print(f"VGG-16 scheme-1 forward {INPUT} f32: median {low_ms:.3f} ms "
          f"({BATCH / low_ms * 1e3:.1f} img/s)")
    time_dense("VGG-16", VGG(16, 10), low_ms)
    profile_forward("VGG-16 scheme-1", model, INPUT, keep=("lowrank_kernel",))
    del runner, model
    torch.cuda.empty_cache()
    return launches


def record_qmatmul_calls(model, x):
    """({(M, K, N): arguments of its first call}, {(M, K, N): calls}) of qmatmul in
    one eval forward of ``model(x)``, run through qmatmul_ref (the kernel's bits,
    and no launch to count)."""
    import torch

    from convnet_approximater_tpu_torch.ops import qmatmul as qmatmul_ops

    first, calls = {}, {}

    def recorder(x2d, w, a, s, b=None):
        key = (x2d.shape[0], x2d.shape[1], w.shape[0])
        calls[key] = calls.get(key, 0) + 1
        if key not in first:
            first[key] = (x2d.clone(), w, a, s, b)
        return qmatmul_ops.qmatmul_ref(x2d, w, a, s, b)

    with mock.patch.object(qmatmul_ops, "qmatmul", recorder), torch.no_grad():
        model(x)
    return first, calls


def check_qmatmul_calls(name, first, calls):
    """qmatmul against qmatmul_ref, bit for bit, on the recorded inputs of each
    (M, K, N) of ``name``'s forward (a K off the kernel's step is padded by the
    wrapper); beside it ``torch._int_mm`` on the quantized operands (K and N
    padded to multiples of 8 with zeros, as it requires).  Returns the rows, with calls per forward."""
    import torch
    import torch.nn.functional as F

    from convnet_approximater_tpu_torch.ops import qmatmul as qmatmul_ops

    rows = []
    for (M, K, N), (x, w, a, s, b) in sorted(first.items()):
        y, y_ref = qmatmul_ops.qmatmul(x, w, a, s, b), qmatmul_ops.qmatmul_ref(x, w, a, s, b)
        torch.cuda.synchronize()
        err, abs_err = rel_err(y, y_ref), float((y - y_ref).abs().max())
        if not torch.isfinite(y).all() or not torch.equal(y, y_ref):
            fail(f"qmatmul {name} {(M, K, N)}: rel err {err:.3e}, max abs err {abs_err:.3e}; "
                 f"the kernel must give qmatmul_ref's bits")
        ms, plain_ms = time_pair(lambda: qmatmul_ops.qmatmul(x, w, a, s, b),
                                 lambda: qmatmul_ops.qmatmul_ref(x, w, a, s, b), iters=10)
        k8, n8 = -(-K // 8) * 8, -(-N // 8) * 8
        x_q = F.pad(qmatmul_ops.quantize_activation(x, a), (0, k8 - K))
        w_t = F.pad(w[:, :k8].t(), (0, n8 - N)).contiguous()
        lib_ms = library_time(lambda: torch._int_mm(x_q, w_t), iters=10)
        nbytes, ops = qmm_cost(M, K, N)
        b_ms, b_by = bound(nbytes, ops, PEAK_INT8)
        p = qmatmul_ops.plan(M, K, N)
        if qmatmul_ops._library().qmatmul_smem_bytes(p.bm, p.bnw, p.ra, p.sx, p.sb) != p.smem:
            fail(f"qmatmul {(M, K, N)}: the planner's shared memory differs from the kernel's")
        c = calls[(M, K, N)]
        rows.append(dict(shape=(M, K, N), calls=c, rel_err=err, max_abs_err=abs_err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes, flops=ops,
                         bound_ms=b_ms))
        print(f"qmatmul {name} (M, K, N)={(M, K, N)} x{c}/forward: bit for bit on the "
              f"forward's own inputs, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 10 "
              f"CUDA-event runs, x2), torch._int_mm {lib_ms:.4f} ms; bound {b_ms:.4f} ms by "
              f"{b_by} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} G int8 ops), roofline share "
              f"{b_ms / ms:.1%}; plan BM {p.bm}, BN {p.bn}, {p.ntpb} column tiles per block, "
              f"grid {p.grid}, {p.smem} B")
        del y, y_ref, x_q, w_t
    for label, key in (("kernel", "ms"), ("plain", "plain_ms"), ("torch._int_mm", "library_ms"),
                       ("bound", "bound_ms")):
        print(f"qmatmul per {name} forward ({sum(r['calls'] for r in rows)} calls): "
              f"{label} {sum(r[key] * r['calls'] for r in rows):.4f} ms")
    return rows


def run_resnet50_int8(gen):
    """P3: the Runner on serve_int8_resnet50.py (Dummy: no site), then
    fold_batchnorm (53 pairs) and quantize_int8 on two seeded calibration
    batches (every groups == 1 conv and the fc: 54), one qmatmul launch per
    quantized module per forward, the int8 logits against the plain versions and
    the float32 model, the peak memory and a profile (the im2col of
    QuantConv2d), a compile_serving replay; each (M, K, N) of the forward held
    bit for bit and timed.  Returns (qmatmul's launches, the shape rows)."""
    import torch

    from convnet_approximater_tpu_torch import deploy
    from convnet_approximater_tpu_torch.layers import QuantConv2d, QuantLinear
    from convnet_approximater_tpu_torch.ops import qmatmul as qmatmul_ops

    name = os.path.relpath(RESNET50_INT8, REPO)
    reset_counts()
    runner, run_s = run_cli(RESNET50_INT8, os.path.join(REPO, "build", "chip_smoke_resnet50"))
    model = runner.model
    if model.length_switchable != 0:
        fail(f"{name}: Dummy registered {model.length_switchable} sites, expected none")
    f32_ms = float(np.median(eager_times_cuda(model)))
    n_fold = deploy.fold_batchnorm(model)
    fold_ms = float(np.median(eager_times_cuda(model)))
    x = images(gen)
    with torch.no_grad():
        y_f32 = model(x)
    calib_gen = torch.Generator().manual_seed(8)
    calib = [torch.randn(BATCH, 3, 224, 224, generator=calib_gen).cuda()
             .contiguous(memory_format=torch.channels_last) for _ in range(2)]
    t0 = time.perf_counter()
    n = deploy.quantize_int8(model, calib)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    del calib
    quantized = [m for m in model.modules() if isinstance(m, (QuantConv2d, QuantLinear))]
    print(f"main path: Runner on {name} in {run_s:.2f} s (Dummy: {model.length_switchable} "
          f"sites); fold_batchnorm folded {n_fold} pairs (expected 53); quantize_int8 "
          f"quantized {n} modules in {quant_s:.2f} s (expected 54: 53 convs and the fc)")
    if n_fold != 53 or n != 54 or len(quantized) != 54:
        fail(f"{name}: folded {n_fold} pairs and quantized {n} modules ({len(quantized)} found)")
    first, calls = record_qmatmul_calls(model, seeded_batch(41))
    if sum(calls.values()) != 54:
        fail(f"{name}: one int8 forward made {sum(calls.values())} qmatmul calls, expected 54")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    int8_ms = float(np.median(eager_times_cuda(model)))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = qmatmul_ops.qmatmul.launches
    print(f"int8 ResNet-50: 13 forwards launched qmatmul {launches} times (54 per forward); "
          f"peak device memory {peak:.2f} GiB (weights, {BATCH} images and QuantConv2d's "
          f"unfolded columns)")
    if launches != 54 * 13:
        fail(f"{name}: qmatmul launched {launches} times in 13 forwards, expected {54 * 13}")
    with torch.no_grad():
        y_q = model(x)
        check_logits("int8 ResNet-50", y_q, {"qmatmul_ref": through_plain(model, x)}, INT8_TOL)
    int8_err = float((y_q - y_f32).abs().max() / y_f32.abs().max())
    print(f"int8 ResNet-50 against float32 logits: max abs relative {int8_err:.4f} (bound "
          f"{INT8_F32_TOL})")
    if not int8_err <= INT8_F32_TOL:
        fail("int8 ResNet-50 logits drift too far from the float32 model's")
    print(f"ResNet-50 forward {INPUT}: float32 {f32_ms:.3f} ms, folded {fold_ms:.3f} ms, int8 "
          f"{int8_ms:.3f} ms ({BATCH / int8_ms * 1e3:.1f} img/s); float32 / int8 = "
          f"{f32_ms / int8_ms:.4f}")
    profile_forward("int8 ResNet-50", model, INPUT, keep=("qmatmul_kernel", "im2col"))
    compiled, put = check_graph("int8 ResNet-50 graph", model, {"qmatmul": 54}, 42)[:2]
    paced = pace(model, compiled, seeded_batch(42))
    print(f"int8 ResNet-50 as a graph: median {time_graph(compiled, put, INPUT):.3f} ms; back "
          f"to back {paced[0]:.3f} ms eager, {paced[1]:.3f} ms graph")
    del compiled, put
    rows = check_qmatmul_calls("int8 ResNet-50", first, calls)
    del first, runner, model
    torch.cuda.empty_cache()
    return launches, rows


def run_mscan_configs():
    """P4: the MSCAN-t hook configs through the CLI: Fps over MscaRep d1
    (13 msca_fused launches per forward it drives; its img/s beside 64 over the
    same model's median forward), the two profiler configs (a trace file, the
    tables, and CONV0/SD_CONVS/CHANNEL_MIX with device time) and dummy_mscan-t
    (no site; the hooks run).  Returns msca_fused's launches in the Fps run."""
    import torch

    from convnet_approximater_tpu_torch.hooks import Fps, InferenceTimeHook
    from convnet_approximater_tpu_torch.hooks.inference_time_hook import CAPTURE_FORWARDS
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops
    from convnet_approximater_tpu_torch.utils.trace import device_records, range_times

    name = os.path.relpath(MSCAN_FPS, REPO)
    reset_counts()
    runner, run_s = run_cli(MSCAN_FPS, os.path.join(REPO, "build", "chip_smoke_fps"))
    launches = fused_ops.msca_fused.launches
    hook = next(h for h in runner.hooks if isinstance(h, Fps))
    if runner.model.length_switchable != 13 or launches != 13 * hook.forwards or launches == 0:
        fail(f"{name}: {runner.model.length_switchable} sites; msca_fused launched {launches} "
             f"times in {hook.forwards} forwards, expected 13 per forward")
    ms = float(np.median(eager_times_cuda(runner.model)))
    fps = hook.result["average_fps"]
    print(f"main path: Runner on {name} in {run_s:.2f} s; Fps drove {hook.forwards} forwards "
          f"({hook.repeat_times} runs of {hook.total_iters}, {hook.num_warmup} untimed each) "
          f"and msca_fused launched {launches} times (13 per forward)")
    print(f"Fps (MSCAN-t MscaRep d1, b={hook.dataset_args.get('batch_size')}, Synthetic through "
          f"Loader): average {fps:.2f} img/s (variance {hook.result['fps_variance']}); the same "
          f"model's median forward {ms:.3f} ms = {BATCH / ms * 1e3:.1f} img/s; Fps / that = "
          f"{fps / (BATCH / ms * 1e3):.4f} (the rest is the loader's share)")
    del runner, hook
    torch.cuda.empty_cache()

    for config in MSCAN_PROFILES:
        name = os.path.relpath(config, REPO)
        work_dir = os.path.join(REPO, "build", "chip_smoke_" + os.path.basename(config)[:-3])
        runner, run_s = run_cli(config, work_dir)
        hook = next(h for h in runner.hooks if isinstance(h, InferenceTimeHook))
        trace = hook.result.get("trace")
        if not trace or not os.path.isfile(trace) or not os.path.getsize(trace):
            fail(f"{name}: no trace file under {work_dir}/traces")
        print(f"main path: Runner on {name} in {run_s:.2f} s; forward "
              f"{hook.result['median_ms']:.3f} ms as a graph back to back, eager median "
              f"{hook.result['eager_median_ms']:.3f} ms; trace {os.path.relpath(trace, REPO)} "
              f"({os.path.getsize(trace) / 1e6:.1f} MB)")
        for group, table in hook.result["tables"].items():
            print(f"profile by {group} ({name}, one forward {INPUT}):\n{table}")
        prof = hook.result["profile"]
        records, on_device = device_records(prof)
        total = sum(r.us for r in records)
        stages = {k: range_times(prof).get(k, [0.0, 0])[0] for k in MSCA_STAGES}
        print(f"{name}: MSCA stages over the 13 blocks, device ms (share of the forward's "
              f"{total / 1e3:.3f} device ms; of the three): " + ", ".join(
                  f"{k} {v / 1e3:.3f} ({v / total:.1%}; {v / sum(stages.values()):.1%})"
                  for k, v in stages.items()))
        if not on_device or not all(v > 0 for v in stages.values()):
            fail(f"{name}: a stage range has no device time")
        del runner, hook, prof
        torch.cuda.empty_cache()

    name = os.path.relpath(MSCAN_DUMMY, REPO)
    reset_counts()
    runner, run_s = run_cli(MSCAN_DUMMY, os.path.join(REPO, "build", "chip_smoke_dummy"))
    forwards, fused = forwards_of(runner), fused_ops.msca_fused.launches
    print(f"main path: Runner on {name} in {run_s:.2f} s; {runner.model.length_switchable} "
          f"sites; the hooks ran {forwards} forwards of dense MSCAN-t, msca_fused launched "
          f"{fused} times (13 per forward)")
    # ModelAnalysis' forward, then InferenceTimeHook's 3 warm-ups, 10 timed forwards and the
    # graph capture's forwards
    expected = 1 + 3 + 10 + CAPTURE_FORWARDS
    if runner.model.length_switchable != 0 or forwards != expected or fused != 13 * forwards:
        fail(f"{name}: expected no site and {expected} forwards of 13 msca_fused launches")
    del runner
    torch.cuda.empty_cache()
    return launches


# -- 12. the rest of the low-rank family, calibration and QAT ----------------------

RESNET18_V3 = os.path.join(REPO, "configs", "resnet", "low-rank-exp-v3_blocks_resnet18.py")
VGG16_V234 = [os.path.join(REPO, "configs", "vgg", f"low-rank-exp-{v}_vgg16.py")
              for v in ("v3_all", "v3_dd", "v4_all", "v2_all")]
ALEX_V2 = os.path.join(REPO, "configs", "low-rank-exp", "low-rank-exp-v2_l2345_alexnet.py")
QAT_ALEX = os.path.join(REPO, "configs", "quant", "int8-qat_ce_alexnet.py")
FT_V3_KD = os.path.join(REPO, "configs", "vgg", "low-rank-exp-v3_l2-kd_vgg16.py")
# the first site's solve on the card against the same solve on the CPU: what the solve
# reports it reached (V2's ALS error after each iteration, else the retained energy), and
# the layers' outputs, against a wrong layout of a factor (an O(1) error).  Random weights
# have flat spectra, so a truncated subspace is fixed only to float32 rounding over the gap
# between neighbouring singular values, and the iterative solves (30 ALS steps, 3 HOOI
# sweeps) stop before they converge, on a path rounding steers: seen 2.0e-5 in V4's energy
# and 6.6e-4 in V2's outputs between the two devices
OBJECTIVE_TOL = 1e-4
SOLVE_OUTPUT_TOL = 1e-2
# (M, K, N) of the 8 qmatmul calls of one int8 AlexNet forward at b=64, 224^2: the
# 11x11/4 stem, convs 2-5 (im2col rows), the three Linears (10 classes)
ALEX_QMM_SHAPES = {(193600, 363, 64), (46656, 1600, 192), (10816, 1728, 384),
                   (10816, 3456, 256), (10816, 2304, 256), (64, 9216, 4096), (64, 4096, 1024),
                   (64, 1024, 10)}


@contextlib.contextmanager
def solve_probe(stats):
    """Times every V2-V4 ``optimize`` (one site's solve) and CalibrationHook's
    pass on the card, each between two synchronizes, into ``stats``
    ("solves", "calibration"), and keeps a CPU copy of the first site's source
    conv and calibration moment ("src", "xcov") and what its solve reached
    ("objective"), to solve again on the CPU."""
    import copy

    import torch

    from convnet_approximater_tpu_torch.core import LowRankExpV2, LowRankExpV3, LowRankExpV4
    from convnet_approximater_tpu_torch.hooks import CalibrationHook

    def timed(fn, key, keep=False):
        def wrapped(self, *args):
            first = keep and not stats[key]
            if first:
                stats["src"] = copy.deepcopy(args[0].old_module).cpu()
                xcov = getattr(self, "_xcov", {}).get(0)
                stats["xcov"] = None if xcov is None else xcov.detach().cpu().clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *args)
            torch.cuda.synchronize()
            stats[key].append(time.perf_counter() - t0)
            if first:
                stats["objective"] = solve_objective(self)
            return out
        return wrapped

    stats.update(solves=[], calibration=[])
    with contextlib.ExitStack() as stack:
        for app in (LowRankExpV2, LowRankExpV3, LowRankExpV4):
            stack.enter_context(mock.patch.object(app, "optimize",
                                                  timed(app.optimize, "solves", keep=True)))
        stack.enter_context(mock.patch.object(
            CalibrationHook, "after_initialize",
            timed(CalibrationHook.after_initialize, "calibration")))
        yield stats


def solve_objective(app):
    """What an app's last solve reports it reached, as float64 on the CPU: V2's
    ALS error after each iteration (its retained energy without ALS), V3's and
    V4's retained energy."""
    import torch

    errors = getattr(app, "errors", None)
    if errors is not None and len(errors):
        return errors.detach().cpu().double()
    energy = app.energy_kept if hasattr(app, "energy_kept") else app.pc_energy
    return torch.tensor([energy], dtype=torch.float64)


def check_solve_on_cpu(name, runner, stats):
    """The first site as the card solved it against the same app solving the
    same conv (and calibration moment) on the CPU: what each solve reached
    (``solve_objective``) within OBJECTIVE_TOL, and the layers' outputs on a
    seeded (2, C, 32, 32) input within SOLVE_OUTPUT_TOL.  Singular vectors may
    differ in sign between the two LAPACKs; the layers' outputs do not."""
    import torch

    from convnet_approximater_tpu_torch.core import build_app
    from convnet_approximater_tpu_torch.utils import get_cfg

    app = build_app(dict(get_cfg().app))
    if stats["xcov"] is not None:
        app.set_calibration(0, stats["xcov"])
    sub = app.initialize(stats["src"], torch.Generator().manual_seed(0))
    app.optimize(sub)
    cpu_layer = app.postprocess(sub).eval()
    card_layer = next(iter(runner.model.switchable_modules()))
    x = torch.randn(2, stats["src"].in_channels, 32, 32,
                    generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        err = rel_err(card_layer(x.cuda()).cpu(), cpu_layer(x))
    card, cpu = stats["objective"], solve_objective(app)
    obj_err = float(((card - cpu).abs() / cpu.abs().clamp_min(1e-30)).max())
    what = (f"the ALS error after each of {len(cpu)} iterations" if len(cpu) > 1
            else "the retained energy")
    print(f"{name}: site 0 ({runner.model.switchable_names[0]}, "
          f"{'calibrated' if stats['xcov'] is not None else 'plain'} solve) on the card against "
          f"the same solve on the CPU: {what} {float(card[-1]):.7g} and {float(cpu[-1]):.7g}, "
          f"max rel err {obj_err:.3e} (bound {OBJECTIVE_TOL}); outputs rel err {err:.3e} "
          f"(bound {SOLVE_OUTPUT_TOL})")
    if not (obj_err <= OBJECTIVE_TOL and err <= SOLVE_OUTPUT_TOL):
        fail(f"{name}: the solve on the card disagrees with the CPU's")


def drive_low_rank(config, sites, layer_type, gen, classes):
    """The Runner on a V2-V4 config through the CLI with the solves timed: the
    registered sites, each a ``layer_type`` at the config's rank, no kernel
    launched (the factors are plain convs), the first site's solve against the
    CPU's, finite logits.  Returns (runner, stats, seconds, logits on
    ``images(gen)``, x)."""
    import torch

    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops
    from convnet_approximater_tpu_torch.ops import qmatmul as qmatmul_ops

    name = os.path.relpath(config, REPO)
    work_dir = os.path.join(REPO, "build", "chip_smoke_" + os.path.basename(config)[:-3])
    stats = {}
    reset_counts()
    with solve_probe(stats):
        runner, run_s = run_cli(config, work_dir)
    model, app = runner.model, runner.app
    layers = list(model.switchable_modules())

    def rank(b):
        if layer_type.__name__ == "LowRankExpConvV4" and not isinstance(b, (tuple, list)):
            return (b, b)
        return tuple(b) if isinstance(b, (tuple, list)) else b

    if (model.switchable_names != sites or not all(isinstance(m, layer_type) for m in layers)
            or [m.num_base for m in layers] != [rank(b) for b in app.num_bases]):
        fail(f"{name}: registered {model.switchable_names} as "
             f"{sorted({type(m).__name__ for m in layers})}, expected {len(sites)} "
             f"{layer_type.__name__} at {sites} with the config's ranks")
    if lowrank_ops.lowrank_conv.launches or qmatmul_ops.qmatmul.launches:
        fail(f"{name}: a kernel launched; the V2-V4 factors are plain convs")
    calib = (f"; CalibrationHook's pass {stats['calibration'][0]:.3f} s"
             if stats["calibration"] else "")
    print(f"main path: Runner on {name} in {run_s:.2f} s; {len(sites)} "
          f"{layer_type.__name__} sites; Optimize (the solves, on the card) "
          f"{sum(stats['solves']):.3f} s in all, the slowest site {max(stats['solves']):.3f} s"
          f"{calib} [{smi_line()}]")
    check_solve_on_cpu(name, runner, stats)
    x = images(gen)
    with torch.no_grad():
        y = model(x)
    if tuple(y.shape) != (2, classes) or not torch.isfinite(y).all():
        fail(f"{name}: logits of shape {tuple(y.shape)} or not finite")
    return runner, stats, run_s, y, x


def hook_or_timed_ms(runner):
    """The median forward at INPUT: InferenceTimeHook's when the config has one."""
    from convnet_approximater_tpu_torch.hooks import InferenceTimeHook

    hook = next((h for h in runner.hooks if isinstance(h, InferenceTimeHook)), None)
    if hook is not None:
        return hook.result["eager_median_ms"]
    return float(np.median(eager_times_cuda(runner.model)))


def run_resnet18_v3(gen):
    """P5: ResNet-18 V3 through the CLI (16 block 3x3s as a dense k x k basis
    and a 1x1 mix), timed beside dense ResNet-18; then fold_batchnorm (20
    pairs, 16 through mix_conv), enable_pw_matmul, and a compile_serving graph."""
    import torch

    from convnet_approximater_tpu_torch import deploy
    from convnet_approximater_tpu_torch.layers import LowRankExpConvV3
    from convnet_approximater_tpu_torch.models import ResNet
    from convnet_approximater_tpu_torch.nn import Identity

    runner, _, _, y, x = drive_low_rank(RESNET18_V3, RESNET18_SITES, LowRankExpConvV3, gen, 1000)
    model = runner.model
    low_ms = hook_or_timed_ms(runner)
    print(f"ResNet-18 V3 forward {INPUT} f32: median {low_ms:.3f} ms "
          f"({BATCH / low_ms * 1e3:.1f} img/s)")
    time_dense("ResNet-18 (against V3)", ResNet(18, 1000), low_ms)
    n = deploy.fold_batchnorm(model)
    through = sum(isinstance(model.get_submodule(s[:-len("convK")] + "bn" + s[-1]), Identity)
                  for s in RESNET18_SITES)
    with torch.no_grad():
        y_fold = model(x)
    print(f"ResNet-18 V3: fold_batchnorm folded {n} pairs (expected 20), {through} of them "
          f"through a site's mix_conv (expected 16)")
    if n != 20 or through != 16:
        fail("ResNet-18 V3: fold_batchnorm folded other pairs")
    check_logits("ResNet-18 V3 after fold_batchnorm", y_fold, {"before the fold": y}, LOGITS_TOL)
    fold_ms = float(np.median(eager_times_cuda(model)))
    n_pw = deploy.enable_pw_matmul(model)
    with torch.no_grad():
        y_pw = model(x)
    check_logits(f"ResNet-18 V3 folded, {n_pw} 1x1 convs as matmuls", y_pw,
                 {"before the fold": y}, LOGITS_TOL)
    pw_ms = float(np.median(eager_times_cuda(model)))
    if n_pw < 16:
        fail(f"ResNet-18 V3: enable_pw_matmul set {n_pw} convs, expected the 16 mix_convs at least")
    compiled, put = check_graph("ResNet-18 V3 (folded, 1x1s as matmuls) graph", model, {}, 50)[:2]
    graph_ms = time_graph(compiled, put, INPUT)
    paced = pace(model, compiled, seeded_batch(50))
    print(f"ResNet-18 V3 forward {INPUT} f32 [{smi_line()}]: Runner {low_ms:.3f} ms, folded "
          f"{fold_ms:.3f} ms, with {n_pw} 1x1s as matmuls {pw_ms:.3f} ms, as a graph "
          f"{graph_ms:.3f} ms; back to back {paced[0]:.3f} ms eager, {paced[1]:.3f} ms graph")
    profile_forward("ResNet-18 V3 (folded, 1x1s as matmuls)", model, INPUT)
    del compiled, put, runner, model
    torch.cuda.empty_cache()


def run_vgg16_v234(gen):
    """P6: VGG-16 V3, V3 data-driven, V4 and V2 data-driven through the CLI
    (the last two calibrate on 2 batches of 8 at 224^2), each timed beside
    dense VGG-16, with its Optimize phase's wall time."""
    import torch

    from convnet_approximater_tpu_torch.layers import (LowRankExpConvV2, LowRankExpConvV3,
                                                       LowRankExpConvV4)
    from convnet_approximater_tpu_torch.models import VGG

    types = (LowRankExpConvV3, LowRankExpConvV3, LowRankExpConvV4, LowRankExpConvV2)
    rows = []
    for config, layer_type in zip(VGG16_V234, types):
        runner, stats, run_s, _, _ = drive_low_rank(config, VGG16_SITES, layer_type, gen, 10)
        rows.append((os.path.relpath(config, REPO), hook_or_timed_ms(runner),
                     sum(stats["solves"]), sum(stats["calibration"]), run_s))
        del runner
        torch.cuda.empty_cache()
    dense_ms = time_dense("VGG-16 (against V3)", VGG(16, 10), rows[0][1])
    for name, ms, solve_s, calib_s, run_s in rows:
        print(f"VGG-16 {name} forward {INPUT} f32 [{smi_line()}]: median {ms:.3f} ms "
              f"({BATCH / ms * 1e3:.1f} img/s); dense {dense_ms:.3f} ms, dense / this = "
              f"{dense_ms / ms:.4f}; Optimize {solve_s:.3f} s, calibration {calib_s:.3f} s, "
              f"the Runner {run_s:.2f} s")


def run_alexnet_v2(gen):
    """P7: AlexNet V2 through the CLI (convs 2-5 as scheme-2 vertical and
    horizontal convs), timed beside dense AlexNet."""
    import torch

    from convnet_approximater_tpu_torch.layers import LowRankExpConvV2
    from convnet_approximater_tpu_torch.models import AlexNet

    runner, stats, _, _, _ = drive_low_rank(ALEX_V2, ALEX_NAMES, LowRankExpConvV2, gen, 10)
    ms = hook_or_timed_ms(runner)
    dense_ms = time_dense("AlexNet (against V2)", AlexNet(), ms)
    print(f"AlexNet V2 forward {INPUT} f32 [{smi_line()}]: median {ms:.3f} ms "
          f"({BATCH / ms * 1e3:.1f} img/s); dense {dense_ms:.3f} ms; Optimize "
          f"{sum(stats['solves']):.3f} s")
    del runner
    torch.cuda.empty_cache()


def run_qat_alexnet(gen):
    """P8: the QAT config through the Runner for a few steps on Synthetic
    data, then convert_qat_to_int8 (8 modules), an int8 forward of 8 qmatmul
    launches at AlexNet's shapes against the plain version, the fake-quant
    model and float32, timed and profiled, a compile_serving replay of 8
    qmatmul kernels, and each (M, K, N) bit for bit on its own inputs.
    Returns (qmatmul's launches in the timed int8 forwards, the shape rows)."""
    import copy

    import torch

    from convnet_approximater_tpu_torch import deploy
    from convnet_approximater_tpu_torch.layers import QATConv2d, QATLinear
    from convnet_approximater_tpu_torch.models.switchable import set_submodule
    from convnet_approximater_tpu_torch.ops import qmatmul as qmatmul_ops

    name = os.path.relpath(QAT_ALEX, REPO)
    work_dir = os.path.join(REPO, "build", "chip_smoke_qat")

    def edit(h):
        h["sche_args"].update(epochs=1)
        h["other_args"] = dict(h.get("other_args") or {}, max_steps_per_epoch=FT_STEPS,
                               checkpoint_hist=1)

    probe = FinetuneProbe(qmatmul_ops.qmatmul)
    reset_counts()
    runner, run_s = run_finetune_cfg(QAT_ALEX, work_dir, probe, edit)
    model = runner.model
    swapped = next(h for h in runner.hooks if type(h).__name__ == "PrepareQAT").swapped
    twins = [(p, m) for p, m in model.named_modules() if isinstance(m, (QATConv2d, QATLinear))]
    losses = [float(v) for v in probe.losses]
    print(f"P8 {name} through the Runner in {run_s:.2f} s, cuts: sche_args.epochs 5 -> 1 "
          f"({FT_STEPS} steps on the hook's default Synthetic(256), b = {BATCH}, 224^2, f32, "
          f"TF32 off), checkpoint_hist 10 -> 1; PrepareQAT swapped {swapped} modules; losses "
          f"{', '.join(f'{v:.6g}' for v in losses)}; qmatmul launches per training step "
          f"{probe.step_calls} (the twins train on the module path)")
    if (swapped != 8 or len(twins) != 8 or len(losses) != FT_STEPS
            or not all(np.isfinite(losses)) or any(probe.step_calls)):
        fail("P8: PrepareQAT must swap 8 modules and the steps must give finite losses")
    if not all(float(m.act_absmax) > 0 for _, m in twins):
        fail("P8: an observer saw no training batch")
    print("P8 learned input scales (act_absmax / 127): " + ", ".join(
        f"{p} {float(m.act_absmax) / 127.0:.4g}" for p, m in twins))
    step_ms = float(np.median(probe.step_ms()[1:]))
    dense = copy.deepcopy(model)
    for p, m in twins:
        set_submodule(dense, p, dense.get_submodule(p).dense())
    x = images(gen)
    with torch.no_grad():
        y_fq = model.eval()(x)
        y_f32 = dense.eval()(x)
    f32_ms = float(np.median(eager_times_cuda(dense)))
    del dense
    n = deploy.convert_qat_to_int8(model)
    first, calls = record_qmatmul_calls(model, seeded_batch(43))
    print(f"P8 convert_qat_to_int8 converted {n} modules (expected 8); one int8 forward "
          f"calls qmatmul at {sorted(calls)}")
    if n != 8 or set(calls) != ALEX_QMM_SHAPES or sum(calls.values()) != 8:
        fail(f"P8: expected 8 int8 modules and qmatmul at {sorted(ALEX_QMM_SHAPES)}")
    reset_counts()
    int8_ms = float(np.median(eager_times_cuda(model)))
    launches = qmatmul_ops.qmatmul.launches
    if launches != 8 * 13:
        fail(f"P8: qmatmul launched {launches} times in 13 int8 forwards, expected {8 * 13}")
    with torch.no_grad():
        y_q = model(x)
        check_logits("int8 QAT AlexNet", y_q, {"qmatmul_ref": through_plain(model, x)},
                     INT8_TOL, classes=10)
    errs = {k: float((y_q - v).abs().max() / v.abs().max())
            for k, v in (("the fake-quant model", y_fq), ("float32", y_f32))}
    print("int8 QAT AlexNet logits, max abs relative: " + ", ".join(
        f"{e:.4f} against {k}" for k, e in errs.items()) + f" (bound {INT8_F32_TOL})")
    if not all(e <= INT8_F32_TOL for e in errs.values()):
        fail("P8: the int8 logits drift too far from the fake-quant and float32 models'")
    print(f"AlexNet QAT [{smi_line()}]: training step median {step_ms:.3f} ms over steps "
          f"2-{len(losses)} ({BATCH / step_ms * 1e3:.1f} img/s); forward {INPUT}: float32 "
          f"{f32_ms:.3f} ms, int8 {int8_ms:.3f} ms (13 forwards launched qmatmul {launches} "
          f"times); float32 / int8 = {f32_ms / int8_ms:.4f}")
    profile_forward("int8 QAT AlexNet", model, INPUT, keep=("qmatmul_kernel", "im2col"))
    compiled, put = check_graph("int8 QAT AlexNet graph", model, {"qmatmul": 8}, 44)[:2]
    paced = pace(model, compiled, seeded_batch(44))
    print(f"int8 QAT AlexNet as a graph: median {time_graph(compiled, put, INPUT):.3f} ms; back "
          f"to back {paced[0]:.3f} ms eager, {paced[1]:.3f} ms graph")
    del compiled, put
    rows = check_qmatmul_calls("int8 QAT AlexNet", first, calls)
    del first, runner, model
    torch.cuda.empty_cache()
    return launches, rows


def run_ft_v3_kd():
    """F4: VGG-16 V3 asym L2+KD for a few steps on Synthetic data: every loss
    finite, a float teacher of 12 dense convs in place of the sites."""
    import torch

    from convnet_approximater_tpu_torch.layers import LowRankExpConvV3
    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops

    name = os.path.relpath(FT_V3_KD, REPO)
    work_dir = os.path.join(REPO, "build", "chip_smoke_ft_v3_kd")

    def edit(h):
        h["dataset_args"].update(dataset=None)
        h["sche_args"].update(epochs=1)
        h["other_args"].update(max_steps_per_epoch=FT_STEPS, checkpoint_hist=1, log_interval=1)

    probe = FinetuneProbe(lowrank_ops.lowrank_conv)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    runner, run_s = run_finetune_cfg(FT_V3_KD, work_dir, probe, edit)
    hook = next(h for h in runner.hooks if type(h).__name__ == "L2Reconstruct")
    losses = [float(v) for v in probe.losses]
    sites = sum(isinstance(m, LowRankExpConvV3) for m in runner.model.switchable_modules())
    in_teacher = sum(isinstance(m, LowRankExpConvV3) for m in hook.teacher.modules())
    batch = hook.dataset_args.batch_size
    print(f"F4 {name} through the Runner in {run_s:.2f} s, cuts: dataset CIFAR10 -> None "
          f"(Synthetic, 10 classes: no CIFAR-10 in the repository), sche_args.epochs 8 -> 1, "
          f"{FT_STEPS} steps at the config's b = {batch}, checkpoint_hist 10 -> 1; {sites} V3 "
          f"sites in the student, {in_teacher} in the teacher; losses "
          f"{', '.join(f'{v:.6g}' for v in losses)}")
    if len(losses) != FT_STEPS or not all(np.isfinite(losses)) or sites != 12 or in_teacher:
        fail("F4: a loss is not finite, or the student or teacher is not the expected model")
    step_ms = float(np.median(probe.step_ms()[1:]))
    print(f"F4 fine-tune of VGG-16 V3 asym L2+KD [{smi_line()}]: median {step_ms:.3f} ms per "
          f"training step over steps 2-{len(losses)} ({batch / step_ms * 1e3:.1f} img/s); "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del runner, hook
    torch.cuda.empty_cache()


# -- 13. width pruning: P9-P12 ---------------------------------------------------
FFN_PRUNE = os.path.join(REPO, "configs", "prune", "ffn-prune_dd_l2-asym_mscan-t.py")
TRUNK_R18 = os.path.join(REPO, "configs", "prune", "trunk-prune_ce_resnet18.py")
CHAIN_VGG = os.path.join(REPO, "configs", "prune", "chain-prune_ce_vgg16.py")
# (H = W, C, blocks) of the pruned MSCAN-t quad's MSCA branches and ConvNeXt-T's trunks
PRUNED_STAGES = [(56, 16, 3), (28, 32, 3), (14, 80, 5), (7, 128, 2)]
PRUNED_CONVNEXT = [(56, 48, 3), (28, 128, 3), (14, 256, 9), (7, 384, 3)]
SOLVE_TOL = 1e-3  # a site's reconstruction error solved on the card against the CPU's,
# relative, where the calibration sample has at least as many pixels as hidden channels


def pruned_kernel_rows():
    """msca_fused (d1+fix) and parallel_cascade (dconv0's 5- and 21-tap
    cascades, and DwSepRep r1) against their plain versions at the widths of
    the pruned MSCAN-t and ConvNeXt-T quads; the sums per forward."""
    import torch

    gen = torch.Generator().manual_seed(13)
    msca = [msca_row("d1fix", H, C, blocks, gen) for H, C, blocks in PRUNED_STAGES]
    cascade = [cascade_row(form, H, C, (k,), blocks, gen)
               for form, k in (("d0k5", 5), ("d0k21", 21)) for H, C, blocks in PRUNED_STAGES]
    cascade += [cascade_row("r1", H, C, (7,), blocks, gen) for H, C, blocks in PRUNED_CONVNEXT]
    for name, kernel, rows in (("pruned MSCAN-t d1+fix", "msca_fused", msca),
                               ("pruned MSCAN-t dconv0", "parallel_cascade", cascade[:8]),
                               ("pruned ConvNeXt-T r1", "parallel_cascade", cascade[8:])):
        total = {k: sum(r[k] * r["blocks"] for r in rows if r.get(k) is not None)
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        print(f"{kernel} per {name} forward ({sum(r['blocks'] for r in rows)} calls): kernel "
              f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms"
              + (f", cuDNN merged {total['library_ms']:.4f} ms" if kernel != "msca_fused" else "")
              + f", bound {total['bound_ms']:.4f} ms")
    return msca, cascade


def through_all_plain(model, x):
    """``model(x)`` with every kernel of the port swapped for its plain version."""
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops

    with mock.patch.object(fused_ops, "msca_fused", fused_ops.msca_fused_ref):
        return through_plain(model, x)


def counted_forwards(model):
    """(msca_fused, parallel_cascade, qmatmul) launches and the median ms of
    eager_times' 13 forwards of ``model`` at INPUT."""
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops
    from convnet_approximater_tpu_torch.ops import parallel_cascade as cascade_ops
    from convnet_approximater_tpu_torch.ops import qmatmul as qmatmul_ops

    reset_counts()
    ms = float(np.median(eager_times_cuda(model)))
    return (fused_ops.msca_fused.launches, cascade_ops.parallel_cascade.launches,
            qmatmul_ops.qmatmul.launches), ms


def solve_on_cpu(src, tgt, x):
    """FfnPrune(0.75)'s solve of one site again on the CPU with the card's taps
    ``x``: (the same kept set, the card's reconstruction error of the site's
    output on its calibration maps, the CPU's), both errors evaluated on the
    CPU."""
    import copy

    import torch

    from convnet_approximater_tpu_torch.core import FfnPrune

    src, tgt, x = (copy.deepcopy(src).cpu().eval(), copy.deepcopy(tgt).cpu().eval(),
                   x.detach().cpu())
    app = FfnPrune(keep_ratio=0.75)
    app.set_calibration(0, x)
    sub = app.initialize(src)
    app.optimize(sub)
    with torch.no_grad():
        ref = src(x)
        return (torch.equal(tgt.fc1.weight, sub.new.fc1.weight), rel_err(tgt(x), ref),
                rel_err(sub.new.eval()(x), ref))


def run_ffn_prune():
    """P9: configs/prune/ffn-prune_dd_l2-asym_mscan-t.py through the Runner:
    CalibrationHook (2 batches of 8 at 224^2, raw maps), FfnPrune(0.75) on 13
    FFNs solved on the card (each site solved again on the CPU with the same
    taps), the asym L2 fine-tune cut to 4 steps and InferenceTimeHook; the
    teacher against the unpruned model, msca_fused's launches, the logits
    against the plain version, dense MSCAN-t timed beside it.  Returns
    msca_fused's launches in the run."""
    import torch

    from convnet_approximater_tpu_torch.core import FfnPrune
    from convnet_approximater_tpu_torch.hooks import CalibrationHook, InferenceTimeHook
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops

    work_dir = os.path.join(REPO, "build", "chip_smoke_ffn_prune")
    x, y = held_out(10)
    stats = {"optimize_s": 0.0}
    optimize, calibrate = FfnPrune.optimize, CalibrationHook.after_initialize

    def timed(fn, key, add=False):
        def wrapped(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            stats[key] = stats.get(key, 0.0) * add + time.perf_counter() - t0
            return out
        return wrapped

    def first(hook, loader):
        student, teacher, app = hook.runner.model, hook.teacher, hook.runner.app
        dense = mscan_base(random_norms=False)  # seed 0: the model before FfnPrune
        with torch.no_grad():
            y_t, y_d = teacher(x), dense(x)
        err = rel_err(y_t, y_d)
        print(f"P9 teacher against the unpruned MSCAN-t (seed 0) eval logits "
              f"{tuple(y_t.shape)}: rel err {err:.3e} (bound {REPLAY_TOL}), "
              f"{'bit-equal' if torch.equal(y_t, y_d) else 'not bit-equal'}")
        if err > REPLAY_TOL:
            fail("P9: the teacher is not the unpruned model")
        del dense
        t0 = time.perf_counter()
        sites = list(zip(teacher.switchable_modules(), student.switchable_modules()))
        checks = [solve_on_cpu(t.old, s.new, app._raw[i]) for i, (t, s) in enumerate(sites)]
        # a sample of fewer pixels than hidden channels (stage 4: 16 x 7 x 7 = 784 for
        # 1024) leaves the covariance rank-deficient, and the greedy selection near its
        # rank picks among gains of the order of float32 rounding (the app warns)
        full = [app._raw[i].shape[0] * app._raw[i].shape[2] * app._raw[i].shape[3]
                >= t.old.hidden_channel for i, (t, _) in enumerate(sites)]
        differ = sum(not same for same, _, _ in checks)
        diffs = [abs(card - cpu) / cpu for _, card, cpu in checks]
        worst = max(d for d, f in zip(diffs, full) if f)
        print(f"P9 the 13 solves again on the CPU with the card's taps "
              f"({time.perf_counter() - t0:.2f} s): {differ} sites picked another kept set "
              f"({sum(not same for (same, _, _), f in zip(checks, full) if f)} of the "
              f"{sum(full)} with a full-rank sample); reconstruction error of each site's "
              f"output on its calibration maps, card / CPU: " + ", ".join(
                  f"{card:.4e}/{cpu:.4e}" for _, card, cpu in checks)
              + f"; max relative difference {worst:.3e} where the sample has full rank (bound "
              f"{SOLVE_TOL}), {max(diffs):.3e} over all 13")
        if worst > SOLVE_TOL:
            fail("P9: a solve on the card reconstructs worse than the CPU's")

    probe = FinetuneProbe(fused_ops.msca_fused, first=first)
    reset_counts()
    with mock.patch.object(FfnPrune, "optimize", timed(optimize, "optimize_s", add=True)), \
            mock.patch.object(CalibrationHook, "after_initialize", timed(calibrate, "calib_s")):
        runner, run_s = run_finetune_cfg(FFN_PRUNE, work_dir, probe,
                                         lambda h: h["sche_args"].update(epochs=1))
    launches = fused_ops.msca_fused.launches
    model, name = runner.model, os.path.relpath(FFN_PRUNE, REPO)
    hooks = {type(h).__name__: h for h in runner.hooks}
    timer = hooks["InferenceTimeHook"]
    steps, losses = len(probe.losses), [float(v) for v in probe.losses]
    hidden = [m.hidden_channel for m in model.switchable_modules()]
    smi = smi_line()
    print(f"P9 {name} through the Runner in {run_s:.2f} s [{smi}], cut: sche_args.epochs 20 -> "
          f"1 ({FT_STEPS} steps on the hook's default Synthetic(256), b = {BATCH}, 224^2, f32, "
          f"TF32 off); calibration {hooks['CalibrationHook'].calibrated} in "
          f"{stats['calib_s']:.3f} s; Optimize (greedy selection and refit of 13 sites) "
          f"{stats['optimize_s']:.3f} s; FFN hiddens {hidden}; losses "
          f"{', '.join(f'{v:.6g}' for v in losses)}")
    if hidden != [192] * 3 + [384] * 3 + [480] * 5 + [768] * 2:
        fail("P9: FfnPrune(0.75) kept other widths than 192/384/480/768")
    if steps != FT_STEPS or not all(np.isfinite(losses)):
        fail("P9: a loss is not finite, or the run took another number of steps")
    forwards = forwards_of(runner)
    want = MSCA_BLOCKS * (2 + steps + len(probe.eval_calls) + forwards)
    print(f"P9 msca_fused launches: {probe.step_calls} per training step (the teacher), "
          f"{probe.eval_calls} per validation forward, {launches} in the run (13 per forward: 2 "
          f"calibration, {steps} teacher, {len(probe.eval_calls)} validation and {forwards} "
          f"timed forwards)")
    if probe.step_calls != [MSCA_BLOCKS] * steps or launches != want:
        fail(f"P9: msca_fused launched {launches} times, expected {want}")
    (fused, _, _), ms = counted_forwards(model)
    if fused != MSCA_BLOCKS * 13:
        fail(f"P9: 13 forwards of the pruned model launched msca_fused {fused} times")
    x2 = images(torch.Generator().manual_seed(9))
    with torch.no_grad():
        check_logits("P9 FfnPrune(0.75) MSCAN-t", model(x2),
                     {"msca_fused_ref": through_all_plain(model, x2)}, LOGITS_TOL)
    step_ms = float(np.median(probe.step_ms()[1:]))
    hook_ms = timer.result["eager_median_ms"]
    dense_ms = float(np.median(eager_times_cuda(mscan_base(random_norms=False))))
    print(f"P9 FfnPrune(0.75) MSCAN-t forward {INPUT} f32 [{smi}]: InferenceTimeHook median "
          f"{hook_ms:.3f} ms, again {ms:.3f} ms ({BATCH / ms * 1e3:.1f} img/s); dense MSCAN-t "
          f"{dense_ms:.3f} ms; dense / pruned = {dense_ms / ms:.4f}; L2 training step median "
          f"{step_ms:.3f} ms over steps 2-{steps}")
    del runner, model
    torch.cuda.empty_cache()
    return launches


def mscan_quad_widths(model):
    """(trunk widths, MSCA branch widths, FFN hiddens) of each stage's first block."""
    blocks = [layer[1][0] for layer in model.backbone.layers]
    return ([b.num_channel for b in blocks], [b.attn.inner_channel for b in blocks],
            [b.mlp.hidden_channel for b in blocks])


def run_pruned_mscan():
    """P10: the pruned MSCAN-t quad of bench.py:336-345 in float32 without
    FfnRep's arbitration: prune_trunks(0.5, round_to=64), AttnPrune(0.5),
    FfnPrune(0.5, round_to=128), then MscaRep(1, fix) or MscaRep(1, fix,
    decomp_conv0), fold_batchnorm and enable_pw_matmul; launches, logits
    against the plain versions and the module path, a graph replay of each,
    and both timed eager, as graphs and back to back beside dense MSCAN-t and
    the unpruned d1+fix surface.  Returns ({form: launches}, timings)."""
    import copy

    import torch

    from convnet_approximater_tpu_torch.core import AttnPrune, FfnPrune, MscaRep
    from convnet_approximater_tpu_torch.deploy import (enable_pw_matmul, fold_batchnorm,
                                                       prune_trunks)
    from convnet_approximater_tpu_torch.deploy_planner import apply_app
    from convnet_approximater_tpu_torch.layers import MSCA

    base = mscan_base(random_norms=True)
    pruned = copy.deepcopy(base)
    t0 = time.perf_counter()
    counts = (prune_trunks(pruned, 0.5, round_to=64),
              apply_app(pruned, AttnPrune(keep_ratio=0.5), []),
              apply_app(pruned, FfnPrune(keep_ratio=0.5, round_to=128), []))
    torch.cuda.synchronize()
    widths = mscan_quad_widths(pruned)
    print(f"P10 pruned MSCAN-t quad: prune_trunks {counts[0]} groups, AttnPrune {counts[1]} "
          f"and FfnPrune {counts[2]} sites in {time.perf_counter() - t0:.2f} s; trunks "
          f"{widths[0]}, MSCA branches {widths[1]}, FFN hiddens {widths[2]}")
    if counts != (4, 13, 13) or widths != ([16, 32, 64, 128], [16, 32, 80, 128],
                                           [128, 256, 256, 512]):
        fail("P10: the pruned quad has other sites or widths than the JAX passes give")
    forms = {}
    for key, src, d0 in (("unpruned d1+fix", base, False), ("pruned d1+fix", pruned, False),
                         ("pruned dconv0", pruned, True)):
        model = copy.deepcopy(src)
        n = (apply_app(model, MscaRep(decomp=1, fix=True, decomp_conv0=d0), []),
             fold_batchnorm(model), enable_pw_matmul(model))
        if n != (13, 5, 65):
            fail(f"P10 {key}: MscaRep, fold_batchnorm and enable_pw_matmul found {n} sites, "
                 f"expected (13, 5, 65)")
        forms[key] = model
    del pruned
    x2, x = seeded_batch(60, batch=2), seeded_batch(61)
    launches, times = {}, {}
    expect = {"pruned d1+fix": ({"msca_fused march": 13, "msca_fused mix": 13}, (13, 0)),
              "pruned dconv0": ({"parallel_cascade": 26, "msca_fused march": 0}, (0, 26))}
    for key, model in [("dense", base)] + list(forms.items()):
        (fused, cascade, _), eager_ms = counted_forwards(model)
        if key in expect:
            per = expect[key][1]
            if (fused, cascade) != (per[0] * 13, per[1] * 13):
                fail(f"P10 {key}: 13 forwards launched msca_fused {fused} and "
                     f"parallel_cascade {cascade} times, expected {per} per forward")
            launches[key] = fused or cascade
            with torch.no_grad():
                check_logits(f"P10 {key} (layer scales 1, random BN)", model(x2), {
                    "the plain versions": through_all_plain(model, x2),
                    "the module path": module_path(model, MSCA, x2)}, LOGITS_TOL)
        compiled, put = check_graph(f"P10 {key}", model,
                                    expect.get(key, ({"msca_fused march": 13},))[0], 62)[:2]
        times[key] = (eager_ms, time_graph(compiled, put, INPUT), *pace(model, compiled, x))
        if key.startswith("pruned"):
            profile_calls(f"P10 {key} graph replay {INPUT}", compiled, keep=MSCA_KERNELS)
        del compiled, put
    smi = smi_line()
    for key, (eager_ms, graph_ms, b2b_eager, b2b_graph) in times.items():
        print(f"P10 MSCAN-t {key} forward {INPUT} f32 [{smi}]: eager median {eager_ms:.3f} ms, "
              f"graph {graph_ms:.3f} ms ({BATCH / graph_ms * 1e3:.1f} img/s); back to back "
              f"{b2b_eager:.3f} ms eager, {b2b_graph:.3f} ms graph; dense / this: eager "
              f"{times['dense'][0] / eager_ms:.4f}, graph {times['dense'][1] / graph_ms:.4f}")
    print("P10 FfnRep's arbitration (arbitrated_apply) runs on unpruned MSCAN-t in P16")
    del base, forms
    torch.cuda.empty_cache()
    return launches, times


def run_pruned_convnext():
    """P11: the pruned ConvNeXt-T quad of bench.py:361-372 in float32:
    prune_trunks(0.5, round_to=128), MlpPrune(0.5, round_to=128), DwSepRep(1)
    on the dwconvs, quantize_int8 on two calibration batches; launches, logits
    (gamma = 1) against the plain versions and the float32 model, a graph
    replay, every qmatmul (M, K, N) of the forward bit for bit; timed beside
    dense ConvNeXt-T and the unpruned r1 and int8 forms.  Returns
    (parallel_cascade's and qmatmul's launches, qmatmul's rows, timings)."""
    import copy

    import torch

    from convnet_approximater_tpu_torch import deploy
    from convnet_approximater_tpu_torch.core import DwSepRep, MlpPrune
    from convnet_approximater_tpu_torch.deploy_planner import apply_app
    from convnet_approximater_tpu_torch.filters import DepthwiseConvFilter
    from convnet_approximater_tpu_torch.layers import CascadeConv, ParallelConv
    from convnet_approximater_tpu_torch.models import ConvNeXt
    from convnet_approximater_tpu_torch.nn import channels_last, init_weights

    base = ConvNeXt(num_classes=1000)
    init_weights(base, torch.Generator().manual_seed(0))
    base = channels_last(base.cuda()).eval()
    set_gamma(base)
    pruned = copy.deepcopy(base)
    counts = (deploy.prune_trunks(pruned, 0.5, round_to=128),
              apply_app(pruned, MlpPrune(keep_ratio=0.5, round_to=128), []),
              apply_app(pruned, DwSepRep(ranks=1), [DepthwiseConvFilter()]))
    dims = [stage[0].dim for stage in pruned.stages]
    hidden = [stage[0].hidden for stage in pruned.stages]
    print(f"P11 pruned ConvNeXt-T quad: prune_trunks {counts[0]} groups, MlpPrune {counts[1]} "
          f"and DwSepRep(1) {counts[2]} sites; trunks {dims}, MLP hiddens {hidden}")
    if counts != (4, 18, 18) or dims != [48, 128, 256, 384] or hidden != [256, 384, 768, 1536]:
        fail("P11: the pruned quad has other sites or widths than the JAX passes give")
    unpruned = copy.deepcopy(base)
    if apply_app(unpruned, DwSepRep(ranks=1), [DepthwiseConvFilter()]) != 18:
        fail("P11: DwSepRep(1) found another number of dwconvs on ConvNeXt-T")
    x2 = seeded_batch(70, batch=2)
    times = {"dense": counted_forwards(base)[1], "unpruned r1": counted_forwards(unpruned)[1]}
    (_, cascade, _), times["pruned r1"] = counted_forwards(pruned)
    if cascade != 18 * 13:
        fail(f"P11: 13 forwards launched parallel_cascade {cascade} times, expected {18 * 13}")
    with torch.no_grad():
        y_f32 = pruned(x2)
        check_logits("P11 pruned ConvNeXt-T r1 (gamma = 1)", y_f32, {
            "parallel_cascade_ref": through_plain(pruned, x2),
            "the module path": module_path(pruned, (CascadeConv, ParallelConv), x2)}, LOGITS_TOL)
    calib_gen = torch.Generator().manual_seed(71)
    calib = [torch.randn(BATCH, 3, 224, 224, generator=calib_gen).cuda()
             .contiguous(memory_format=torch.channels_last) for _ in range(2)]
    n = (deploy.quantize_int8(pruned, calib), deploy.quantize_int8(unpruned, calib))
    del calib
    if n != (41, 41):
        fail(f"P11: quantize_int8 quantized {n} modules, expected 41 in each")
    first, calls = record_qmatmul_calls(pruned, seeded_batch(72))
    times["unpruned int8"] = counted_forwards(unpruned)[1]
    del unpruned
    (_, cascade, q_launches), times["pruned int8"] = counted_forwards(pruned)
    if q_launches != 41 * 13 or cascade != 18 * 13 or sum(calls.values()) != 41:
        fail(f"P11: 13 int8 forwards launched qmatmul {q_launches} and parallel_cascade "
             f"{cascade} times, expected 41 and 18 per forward")
    with torch.no_grad():
        y_q = pruned(x2)
        check_logits("P11 pruned int8 ConvNeXt-T (gamma = 1)", y_q,
                     {"qmatmul_ref and parallel_cascade_ref": through_plain(pruned, x2)}, INT8_TOL)
    int8_err = float((y_q - y_f32).abs().max() / y_f32.abs().max())
    print(f"P11 pruned int8 against float32 logits: max abs relative {int8_err:.4f} (bound "
          f"{INT8_F32_TOL})")
    if not int8_err <= INT8_F32_TOL:
        fail("P11: int8 logits drift too far from the float32 model's")
    compiled, put = check_graph("P11 pruned int8 ConvNeXt-T", pruned,
                                {"qmatmul": 41, "parallel_cascade": 18}, 73)[:2]
    times["pruned int8 graph"] = time_graph(compiled, put, INPUT)
    del compiled, put
    profile_forward("P11 pruned int8 ConvNeXt-T", pruned, INPUT, keep=("qmatmul_kernel",))
    rows = check_qmatmul_calls("pruned int8 ConvNeXt-T", first, calls)
    smi = smi_line()
    print(f"P11 ConvNeXt-T forwards {INPUT} [{smi}]: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in times.items()) + f"; dense / pruned r1 = "
          f"{times['dense'] / times['pruned r1']:.4f}, dense / pruned int8 = "
          f"{times['dense'] / times['pruned int8']:.4f}, unpruned int8 / pruned int8 = "
          f"{times['unpruned int8'] / times['pruned int8']:.4f}")
    del base, pruned, first
    torch.cuda.empty_cache()
    return cascade, q_launches, rows, times


def run_pruned_classic(config, passes, model_fn, n_fold, n_quant, classes, seed):
    """P12: a prune config through the Runner (its structure passes, the CE
    fine-tune cut to 4 steps), its last checkpoint restored bit for bit through
    the same config, then fold_batchnorm + quantize_int8 (bench.py:374-384):
    qmatmul launches, int8 logits against the plain versions and float32, each
    (M, K, N) bit for bit; float32 and int8 timed beside the dense model.
    Returns (qmatmul's launches, its rows)."""
    import torch

    from convnet_approximater_tpu_torch import deploy
    from convnet_approximater_tpu_torch.ops import qmatmul as qmatmul_ops
    from convnet_approximater_tpu_torch.runner import Runner
    from convnet_approximater_tpu_torch.utils import init_cfg, update_cfg

    name = os.path.relpath(config, REPO)
    tag = os.path.basename(config)[:-3]
    work_dir = os.path.join(REPO, "build", f"chip_smoke_{tag}")
    probe = FinetuneProbe(qmatmul_ops.qmatmul)
    runner, run_s = run_finetune_cfg(config, work_dir, probe,
                                     lambda h: h["sche_args"].update(epochs=1))
    model = runner.model.eval()
    with open(os.path.join(work_dir, "run.log")) as f:
        log = f.read()
    steps, losses = len(probe.losses), [float(v) for v in probe.losses]
    step_ms = float(np.median(probe.step_ms()[1:]))
    smi = smi_line()
    print(f"P12 {name} through the Runner in {run_s:.2f} s [{smi}], cut: sche_args.epochs -> 1 "
          f"({FT_STEPS} steps on the hook's default Synthetic(256), b = {BATCH}, 224^2, f32, "
          f"TF32 off); " + "; ".join(f"{p}" for p in passes) + f"; losses "
          f"{', '.join(f'{v:.6g}' for v in losses)}; CE training step median {step_ms:.3f} ms "
          f"over steps 2-{steps} ({BATCH / step_ms * 1e3:.1f} img/s)")
    if any(f"structure pass {p}" not in log for p in passes):
        fail(f"P12 {name}: the Runner's log lacks one of {passes}")
    if steps != FT_STEPS or not all(np.isfinite(losses)):
        fail(f"P12 {name}: a loss is not finite, or the run took another number of steps")
    init_cfg(config)
    update_cfg(work_dir=work_dir + "_restored", config_name=tag, seed=0)
    restored = Runner(device="cuda", generator=torch.Generator().manual_seed(1))
    restored.restore(os.path.join(work_dir, "last.ckpt.npz"))
    want, got = model.state_dict(), restored.model.state_dict()
    if set(want) != set(got) or any(not torch.equal(want[k], got[k]) for k in want):
        fail(f"P12 {name}: the last checkpoint does not restore bit for bit through the config")
    print(f"P12 {name}: last.ckpt.npz restored through the same config (passes replayed, "
          f"another seed) bit for bit: {len(want)} tensors")
    del restored
    x = images(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        y_f32 = model(x)
    f32_ms = float(np.median(eager_times_cuda(model)))
    folded = deploy.fold_batchnorm(model)
    calib_gen = torch.Generator().manual_seed(seed + 1)
    calib = [torch.randn(BATCH, 3, 224, 224, generator=calib_gen).cuda()
             .contiguous(memory_format=torch.channels_last) for _ in range(2)]
    quantized = deploy.quantize_int8(model, calib)
    del calib
    if (folded, quantized) != (n_fold, n_quant):
        fail(f"P12 {name}: folded {folded} and quantized {quantized}, expected {n_fold} and "
             f"{n_quant}")
    first, calls = record_qmatmul_calls(model, seeded_batch(seed + 2))
    (_, _, launches), int8_ms = counted_forwards(model)
    if launches != n_quant * 13 or sum(calls.values()) != n_quant:
        fail(f"P12 {name}: 13 int8 forwards launched qmatmul {launches} times, expected "
             f"{n_quant * 13}")
    with torch.no_grad():
        y_q = model(x)
        check_logits(f"P12 int8 {tag}", y_q, {"qmatmul_ref": through_plain(model, x)}, INT8_TOL,
                     classes=classes)
    int8_err = float((y_q - y_f32).abs().max() / y_f32.abs().max())
    print(f"P12 {tag}: fold_batchnorm {folded} pairs, quantize_int8 {quantized} modules, "
          f"{launches} qmatmul launches in 13 forwards; int8 against float32 logits: max abs "
          f"relative {int8_err:.4f} (bound {INT8_F32_TOL})")
    if not int8_err <= INT8_F32_TOL:
        fail(f"P12 {name}: int8 logits drift too far from the float32 model's")
    print(f"P12 {tag} forward {INPUT} [{smi}]: pruned float32 {f32_ms:.3f} ms, pruned int8 "
          f"{int8_ms:.3f} ms; float32 / int8 = {f32_ms / int8_ms:.4f}")
    time_dense(f"P12 {tag}: the unpruned", model_fn(), f32_ms)
    profile_forward(f"P12 pruned int8 {tag}", model, INPUT, keep=("qmatmul_kernel", "im2col"))
    rows = check_qmatmul_calls(f"pruned int8 {tag}", first, calls)
    del runner, model, first
    torch.cuda.empty_cache()
    return launches, rows


def run_pruning():
    """P9-P12; returns what the kernels line needs."""
    from convnet_approximater_tpu_torch.models import VGG, ResNet

    out = dict(rows=pruned_kernel_rows(), p9=run_ffn_prune(), p10=run_pruned_mscan(),
               p11=run_pruned_convnext())
    out["p12"] = [
        ("int8 trunk+chain-pruned ResNet-18", *run_pruned_classic(
            TRUNK_R18, ("prune_trunks: 4 sites", "prune_chains: 8 sites"),
            lambda: ResNet(18, 1000), 20, 21, 1000, 80)),
        ("int8 chain-pruned VGG-16", *run_pruned_classic(
            CHAIN_VGG, ("prune_chains: 14 sites",), lambda: VGG(16, 10), 0, 16, 10, 90))]
    return out


# -- 14. P13, F6 and P14: SegNeXt-T serving and fine-tuning, and CAM ---------------------

SEG_CONFIG = os.path.join(REPO, "configs", "msca-rep", "msca-rep_d1_fix_segnext-t.py")
SEG_FT = os.path.join(REPO, "configs", "msca-rep", "finetune",
                      "msca-rep-d1-fix_l2-asym_segnext-t.py")
SEG_BATCH = 16
SEG_INPUT = (SEG_BATCH, 512, 512, 3)
SEG_CLASSES = 150
SEG_STAGES = [(128, 32, 3), (64, 64, 3), (32, 160, 5), (16, 256, 2)]  # (H = W, C, blocks), 512^2
SEG_FT_STEPS = 4
SEG_FT_EVAL = 2
SEG_CPU_CROP = 128  # the CPU step's images: this crop of the first training batch's first 2
CAM_BLOCKS = (0, 12)  # the first and the last of MSCAN-t's 13 MSCA blocks
CAM_TOL = 1e-4
CAM_SCORE_TOL = 1e-5  # ablationcam's re-forward scores, relative to its base score
# a heatmap farther than CAM_TOL from the CPU's is held to a float64 forward of the
# same model: the card's distance to it at most CAM_COND times the CPU's own (both
# are float32 roundings in different orders; a kernel fault is far larger)
CAM_COND = 10.0


def run_segnext(gen):
    """P13: msca_fused at SegNeXt-T's four stage shapes at b=16, 512^2 (dense bank
    and d1+fix); the CLI on configs/msca-rep/msca-rep_d1_fix_segnext-t.py (the
    Runner's four phases and InferenceTimeHook at (16, 512, 512, 3)): 13
    msca_fused launches per forward, the logits against the plain version and
    the module path; then a compile_serving graph (26 kernels per replay, the
    replay against eager), eager, graph and back-to-back times beside dense
    SegNeXt-T, and a profile.  Returns (launches in the CLI run, kernel rows)."""
    import torch

    from convnet_approximater_tpu_torch.hooks import InferenceTimeHook, eager_times
    from convnet_approximater_tpu_torch.layers import MSCA
    from convnet_approximater_tpu_torch.nn import channels_last, init_weights
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops
    from convnet_approximater_tpu_torch.segmentation import SegNeXt

    kgen = torch.Generator().manual_seed(14)
    rows = [msca_row(form, H, C, blocks, kgen, batch=SEG_BATCH)
            for form in ("dense", "d1fix") for H, C, blocks in SEG_STAGES]
    for form in ("dense", "d1fix"):
        sel = [r for r in rows if r["form"] == form]
        total = {k: sum(r[k] * r["blocks"] for r in sel) for k in ("ms", "plain_ms", "bound_ms")}
        print(f"msca_fused per {form} SegNeXt-T forward (b = {SEG_BATCH}, 512^2, "
              f"{sum(r['blocks'] for r in sel)} calls): kernel {total['ms']:.4f} ms, plain "
              f"{total['plain_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms")

    reset_counts()
    runner, run_s = run_cli(SEG_CONFIG, os.path.join(REPO, "build", "chip_smoke_segnext"))
    launches = fused_ops.msca_fused.launches
    model = runner.model
    hook = next(h for h in runner.hooks if isinstance(h, InferenceTimeHook))
    mscas = [m for m in model.modules() if isinstance(m, MSCA)]
    if type(model).__name__ != "SegNeXt" or model.length_switchable != MSCA_BLOCKS \
            or len(mscas) != MSCA_BLOCKS or tuple(hook.input_size) != SEG_INPUT:
        fail(f"P13: expected SegNeXt with {MSCA_BLOCKS} MSCA blocks timed at {SEG_INPUT}")
    with torch.no_grad():
        if not all(m.can_fuse() for m in mscas):
            fail("P13: an MscaRep'd MSCA block of SegNeXt-T cannot take the fused kernel")
    if launches != MSCA_BLOCKS * hook.forwards or launches == 0:
        fail(f"P13: msca_fused launched {launches} times in {hook.forwards} forwards, "
             f"expected {MSCA_BLOCKS * hook.forwards}")
    d1_ms = hook.result["eager_median_ms"]
    print(f"P13 SegNeXt-T: the CLI on {os.path.relpath(SEG_CONFIG, REPO)} in {run_s:.2f} s "
          f"(MscaRep d1+fix on 13 blocks, the SVDs on the card, {SEG_CLASSES} classes, random "
          f"weights from seed 0); {hook.forwards} forwards launched msca_fused {launches} "
          f"times ({MSCA_BLOCKS} per forward)")

    x = torch.randn(2, 3, 512, 512, generator=gen).cuda().contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad(), uncounted():
        y = model(x)
        with mock.patch.object(fused_ops, "msca_fused", fused_ops.msca_fused_ref):
            y_plain = model(x)
            plain_ms = float(np.median(eager_times(model, SEG_INPUT, "cuda", hook.num_iters,
                                                    hook.warmup)))
        y_module = module_path(model, (MSCA,), x)
    check_logits("P13 SegNeXt-T d1+fix", y, {"msca_fused_ref": y_plain,
                                             "the module path": y_module},
                 LOGITS_TOL, shape=(2, SEG_CLASSES, 64, 64))
    expect = {"msca_fused march": MSCA_BLOCKS, "msca_fused mix": MSCA_BLOCKS}
    with uncounted():
        compiled, put, _ = check_graph("P13 SegNeXt-T d1+fix", model, expect, seed=14,
                                       batch=SEG_BATCH, size=512)
        graph_ms = time_graph(compiled, put, SEG_INPUT)
        b2b_ms = back_to_back_ms(compiled)
        enqueue_ms = host_enqueue_ms(model, SEG_INPUT)
        profile_forward("P13 SegNeXt-T d1+fix", model, SEG_INPUT, keep=MSCA_KERNELS)
    del compiled, put, runner
    torch.cuda.empty_cache()

    dense = SegNeXt(num_classes=SEG_CLASSES)
    init_weights(dense, torch.Generator().manual_seed(0))
    dense = channels_last(dense.cuda()).eval()
    with uncounted():
        fused_ops.msca_fused.launches = 0
        dense_ms = float(np.median(eager_times(dense, SEG_INPUT, "cuda", hook.num_iters,
                                                hook.warmup)))
        if fused_ops.msca_fused.launches != MSCA_BLOCKS * (hook.num_iters + hook.warmup):
            fail("P13: the dense SegNeXt-T forward did not launch msca_fused once per block")
        dcompiled, dput, _ = check_graph("P13 dense SegNeXt-T", dense, expect, seed=15,
                                         batch=SEG_BATCH, size=512)
        dense_graph_ms = time_graph(dcompiled, dput, SEG_INPUT)
        dense_b2b_ms = back_to_back_ms(dcompiled)
        profile_forward("P13 dense SegNeXt-T", dense, SEG_INPUT, keep=MSCA_KERNELS)
    smi = smi_line()
    b = SEG_BATCH
    print(f"M19 SegNeXt-T d1+fix forward {SEG_INPUT} f32 [{smi}]: eager median {d1_ms:.3f} ms "
          f"({b / d1_ms * 1e3:.1f} img/s), with msca_fused_ref in place of the kernel "
          f"{plain_ms:.3f} ms, {enqueue_ms:.3f} ms of host time to enqueue it; as a graph "
          f"{graph_ms:.3f} ms, back to back {b2b_ms:.3f} ms per call")
    print(f"M19 dense SegNeXt-T forward {SEG_INPUT} f32 [{smi}]: eager median {dense_ms:.3f} "
          f"ms, graph {dense_graph_ms:.3f} ms, back to back {dense_b2b_ms:.3f} ms; dense / "
          f"d1+fix = {dense_ms / d1_ms:.4f} eager, {dense_graph_ms / graph_ms:.4f} as graphs, "
          f"{dense_b2b_ms / b2b_ms:.4f} back to back")
    del dcompiled, dput, dense
    torch.cuda.empty_cache()
    return launches, rows


class SegProbe(FinetuneProbe):
    """FinetuneProbe of a SegL2Reconstruct run: its validation streams a
    confusion matrix, not ``eval_batch``, so the launches of each validation
    are counted per forward in ``eval_calls``."""

    def patches(self):
        from convnet_approximater_tpu_torch.segmentation.finetune import SegL2Reconstruct

        probe, validate = self, SegL2Reconstruct._validate

        def counted(hook, loader):
            n = probe.counter.launches
            out = validate(hook, loader)
            batches = min(len(loader), hook.other_args.max_eval_batches or len(loader))
            probe.eval_calls.append((probe.counter.launches - n) / batches)
            return out

        return super().patches() + [mock.patch.object(SegL2Reconstruct, "_validate", counted)]


def run_ft_seg():
    """F6: configs/msca-rep/finetune/msca-rep-d1-fix_l2-asym_segnext-t.py through the
    Runner (SyntheticSeg at b=16, 512^2, 150 classes; cut to 4 steps and one
    validation of 2 batches): every loss finite, 13 msca_fused launches per
    step (the asym teacher) and per validation forward, a step on the card
    against the same step on the CPU (drop rates 0 for that step), the last
    checkpoint bit for bit;
    the step's median ms, mIoU and aAcc.  Returns msca_fused's launches in the run."""
    import copy

    import torch

    from convnet_approximater_tpu_torch.layers import DropPath, drop_generator
    from convnet_approximater_tpu_torch.nn import Dropout
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops

    work_dir = os.path.join(REPO, "build", "chip_smoke_ft_seg")
    c = SEG_CPU_CROP

    def first(hook, loader):
        x, y = next(iter(loader))
        x = x[:2, :, :c, :c].contiguous(memory_format=torch.channels_last)
        y = y[:2, :c, :c].contiguous()
        student = hook.runner.model
        # drop rates 0 for this step alone: the card's and the CPU's masks differ
        rates = {m: "drop_prob" if isinstance(m, DropPath) else "p" for m in student.modules()
                 if isinstance(m, (DropPath, Dropout))}
        saved = {m: getattr(m, a) for m, a in rates.items()}
        for m, a in rates.items():
            setattr(m, a, 0.0)
        try:
            gpu = probe_step(hook, x, y)
            with drop_generator(student, None):
                cpu_model = copy.deepcopy(student).cpu()
            cpu_teacher = copy.deepcopy(hook.teacher).cpu()
            t0 = time.perf_counter()
            cpu = probe_step(hook, x.cpu(), y.cpu(), model=cpu_model, teacher=cpu_teacher)
        finally:
            for m, a in rates.items():
                setattr(m, a, saved[m])
        errs = [abs(a - b) / abs(b) for a, b in zip(gpu, cpu)]
        print(f"F6 one step with no update on a {c}^2 crop of the first training batch's first "
              f"2 images (SegNeXt-T, drop rates 0): loss {gpu[0]:.7g} on the card, {cpu[0]:.7g} "
              f"on the CPU (rel err {errs[0]:.3e}); trainable gradient norm {gpu[1]:.7g} and "
              f"{cpu[1]:.7g} (rel err {errs[1]:.3e}); bound {FT_CPU_TOL}; CPU step "
              f"{time.perf_counter() - t0:.2f} s")
        if max(errs) > FT_CPU_TOL:
            fail("F6: the step on the card disagrees with the same step on the CPU")

    def last(hook):
        check_ckpt_loads_back(hook, hook.runner.model, work_dir, label="F6")

    def edit(h):
        h["sche_args"].update(epochs=1)
        h["other_args"].update(max_steps_per_epoch=SEG_FT_STEPS, max_eval_batches=SEG_FT_EVAL)

    probe = SegProbe(fused_ops.msca_fused, first=first, last=last)
    reset_counts()
    runner, run_s = run_finetune_cfg(SEG_FT, work_dir, probe, edit, hook_type="SegL2Reconstruct")
    launches = fused_ops.msca_fused.launches
    steps = len(probe.losses)
    losses = [float(v) for v in probe.losses]
    row = summary_rows(os.path.join(work_dir, "summary.csv"))[-1]
    print(f"F6 {os.path.relpath(SEG_FT, REPO)} through the Runner in {run_s:.2f} s, cuts: "
          f"sche_args.epochs 20 -> 1 of {SEG_FT_STEPS} steps (max_steps_per_epoch) and "
          f"{SEG_FT_EVAL} validation batches (max_eval_batches) on the hook's default "
          f"SyntheticSeg(128 / 64) at b = {SEG_BATCH}, 512^2, {SEG_CLASSES} classes; "
          f"{steps} steps, losses "
          f"{', '.join(f'{v:.6g}' for v in losses)}; validation loss {row['eval_loss']:.6g}, "
          f"mIoU {row['eval_miou']:.6g}, aAcc {row['eval_aacc']:.6g}")
    if steps != SEG_FT_STEPS or not all(np.isfinite(losses)) or not np.isfinite(row["eval_loss"]):
        fail("F6: a loss is not finite, or the run took another number of steps")
    print(f"F6 msca_fused launches: {probe.step_calls} per training step (the asym teacher), "
          f"{probe.eval_calls} per validation forward; {launches} in the run")
    if (probe.step_calls != [MSCA_BLOCKS] * steps or probe.eval_calls != [MSCA_BLOCKS]
            or launches != MSCA_BLOCKS * (steps + SEG_FT_EVAL)):
        fail(f"F6: the teacher and each validation forward must launch msca_fused "
             f"{MSCA_BLOCKS} times")
    times = probe.step_ms()[1:]
    print(f"F6 SegNeXt-T d1+fix L2 + CE step, asym, b = {SEG_BATCH}, 512^2, f32 "
          f"[{smi_line()}]: median {float(np.median(times)):.3f} ms per training step over "
          f"steps 2-{steps} (CUDA events), {SEG_BATCH / float(np.median(times)) * 1e3:.1f} "
          f"img/s; checkpoint save {', '.join(f'{t:.3f}' for t in probe.saves)} s")
    del runner
    torch.cuda.empty_cache()
    return launches


def run_cam():
    """P14: the CAM CLI on the MSCAN-t classifier of CONFIG (its dense model,
    weights from seed 0) on the card, for attn and the 11 methods at the first
    and the last MSCA block, on the CLI's 224^2 image: every heatmap finite and
    non-negative, msca_fused's launches per heatmap (13 per forward: the
    capture, and each re-forward batch of scorecam and ablationcam), the ms per
    heatmap; then each (method, block) on the same image on the card and on
    the CPU (the plain versions): what each method was given within 1e-4
    (ablationcam's scores within 1e-5 of its base score), and each heatmap
    within 1e-4, or, where the method is ill-conditioned at this input, no
    more than 10x as far as the CPU's from a float64 forward's heatmap.
    Returns msca_fused's launches in the CLI runs."""
    import copy

    import torch

    from convnet_approximater_tpu_torch.layers import MSCA
    from convnet_approximater_tpu_torch.models import build_model
    from convnet_approximater_tpu_torch.nn import channels_last, init_weights
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops
    from convnet_approximater_tpu_torch.utils import get_cfg, init_cfg
    from convnet_approximater_tpu_torch.visualization import cam

    methods = ("attn",) + tuple(cam.CAM_METHODS)
    out = os.path.join(REPO, "build", "chip_smoke_cam")
    launches, total = {}, 0
    t_run = time.perf_counter()
    for block in CAM_BLOCKS:
        for method in methods:
            reset_counts()
            heat = cam.main(["--config", CONFIG, "--block", str(block), "--method", method,
                             "--out", out])
            launches[(method, block)] = fused_ops.msca_fused.launches
            total += launches[(method, block)]
            if not (np.isfinite(heat).all() and (heat >= 0).all()):
                fail(f"P14 {method} at block {block}: the heatmap is not finite and non-negative")
    run_s = time.perf_counter() - t_run

    init_cfg(CONFIG)
    model = build_model(get_cfg().model)
    init_weights(model, torch.Generator().manual_seed(0))
    model.register_switchable(MSCA, [])
    widths = [model.get_switchable_module(b).num_channel for b in CAM_BLOCKS]
    for block, C in zip(CAM_BLOCKS, widths):
        chunks = -(-C // cam.SCORE_CHUNK)
        for method in methods:
            reforwards = {"scorecam": chunks, "ablationcam": 1 + chunks}.get(method, 0)
            if launches[(method, block)] != MSCA_BLOCKS * (1 + reforwards):
                fail(f"P14 {method} at block {block}: msca_fused launched "
                     f"{launches[(method, block)]} times, expected "
                     f"{MSCA_BLOCKS * (1 + reforwards)} (13 per forward)")

    # the same heatmaps again, warm, each timed between two synchronizes
    img = np.random.RandomState(0).randint(0, 256, (224, 224, 3)).astype(np.float32)
    x224 = torch.from_numpy((img / 255.0 - 0.5) / 0.5).permute(2, 0, 1)[None].cuda()
    x224 = x224.contiguous(memory_format=torch.channels_last)
    card = channels_last(copy.deepcopy(model).cuda()).eval()
    heat_ms = {}
    with uncounted():
        for key in launches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cam.heatmap(card, x224, key[1], key[0])  # a numpy array: the card's work is done
            heat_ms[key] = (time.perf_counter() - t0) * 1e3
    smi = smi_line()
    print(f"P14 CAM CLI (python -m convnet_approximater_tpu_torch.visualization.cam) on the "
          f"dense MSCAN-t of {os.path.relpath(CONFIG, REPO)}, seed-0 weights, the CLI's "
          f"RandomState(0) 224^2 image: {len(launches)} CLI runs in {run_s:.2f} s [{smi}]; ms "
          f"per heatmap (a second, warm call, host clock around it) and msca_fused launches "
          f"in the CLI run:")
    for method in methods:
        print(f"  {method:20s} " + "   ".join(
            f"block {b} (C = {C}): {heat_ms[(method, b)]:9.3f} ms, {launches[(method, b)]:3d} "
            f"launches" for b, C in zip(CAM_BLOCKS, widths)))

    models = {"cpu": channels_last(model).eval(), "cuda": card}
    xs = {"cpu": x224.cpu().contiguous(memory_format=torch.channels_last), "cuda": x224}
    with torch.no_grad():
        cls = {d: int(m(xs[d])[0].argmax()) for d, m in models.items()}
    if cls["cpu"] != cls["cuda"]:
        fail(f"P14: the top class differs, {cls['cuda']} on the card and {cls['cpu']} on the CPU")
    inputs = {}  # (method, device) -> what the method was given: feats, grads, scores

    def recording(name, fn, kind):
        def wrapped(feats, *args, **kwargs):
            key = (name, feats.device.type)
            inputs[key] = [feats.detach().cpu()]
            if kind == "grad":
                inputs[key].append(args[0].detach().cpu())
            if kind in ("score", "override"):  # the re-forwards' class scores
                outs, score_fn = [], args[-1] if kind == "score" else args[0]

                def rec(*a):
                    out = score_fn(*a)
                    outs.append(out.detach().cpu())
                    return out

                args = (args[0], rec) if kind == "score" else (rec,)
                h = fn(feats, *args, **kwargs)
                inputs[key].append(torch.cat(outs))
                return h
            return fn(feats, *args, **kwargs)
        return wrapped

    patched = {n: (recording(n, fn, k), k) for n, (fn, k) in cam.CAM_METHODS.items()
               if k != "model"}
    c64 = channels_last(copy.deepcopy(card).double()).eval()  # module path, float64
    errs = []
    t_cmp = time.perf_counter()
    with uncounted(), mock.patch.dict(cam.CAM_METHODS, patched):
        for block in CAM_BLOCKS:
            for method in methods:
                h = {d: cam.heatmap(models[d], xs[d], block, method) for d in models}
                err = float(np.linalg.norm(h["cuda"] - h["cpu"])
                            / max(np.linalg.norm(h["cpu"]), 1e-12))
                got = list(zip(inputs.get((method, "cuda"), []), inputs.get((method, "cpu"), [])))
                in_errs = [rel_err(a, b) for a, b in got]
                tols = [CAM_TOL] * len(in_errs)
                extra, heat_ok = "", err <= CAM_TOL
                if method == "ablationcam":  # its scores against the base score
                    (sc, sp), base = got[-1], abs(float(got[-1][1][0]))
                    in_errs[-1], tols[-1] = float((sc - sp).abs().max()) / base, CAM_SCORE_TOL
                    extra = (f", drops {rel_err(sc[0] - sc[1:], sp[0] - sp[1:]):.3e} apart (the "
                             f"largest {float((sp[0] - sp[1:]).abs().max()) / base:.3e} of the "
                             f"base score)")
                if not heat_ok:  # ill-conditioned here? both against a float64 forward
                    with mock.patch.object(fused_ops, "msca_fused", fused_ops.msca_fused_ref):
                        h64 = cam.heatmap(c64, x224.double(), block, method)
                    d64 = {d: float(np.linalg.norm(h[d] - h64) / np.linalg.norm(h64)) for d in h}
                    heat_ok = d64["cuda"] <= CAM_COND * d64["cpu"]
                    extra += (f"; against a float64 forward: card {d64['cuda']:.3e}, CPU "
                              f"{d64['cpu']:.3e}")
                    if method == "ablationcam":  # the drops too
                        s64 = inputs[(method, "cuda")][-1]
                        drop = {d: rel_err(v[0] - v[1:], s64[0] - s64[1:])
                                for d, v in (("cuda", sc), ("cpu", sp))}
                        heat_ok = heat_ok and drop["cuda"] <= CAM_COND * drop["cpu"]
                        extra += f" (drops: card {drop['cuda']:.3e}, CPU {drop['cpu']:.3e})"
                ok = (np.isfinite(h["cuda"]).all() and (method == "attn" or (h["cuda"] >= 0).all())
                      and all(e <= t for e, t in zip(in_errs, tols)) and heat_ok)
                errs.append(f"{method} block {block}: heat {err:.3e}" + (
                    f", inputs {', '.join(f'{e:.3e}' for e in in_errs)}" if in_errs else "")
                    + extra)
                if not ok:
                    fail(f"P14 {method} at block {block}: the card disagrees with the CPU "
                         f"({errs[-1]})")
    print(f"P14 the card against the CPU on the CLI's RandomState(0) 224^2 image (top class "
          f"{cls['cuda']} on both; {time.perf_counter() - t_cmp:.2f} s): relative error of "
          f"each heatmap (bound {CAM_TOL}, or where it is missed, the card's distance to a "
          f"float64 forward's heatmap (the module path) at most {CAM_COND:g}x the CPU's) and "
          f"of what each method was given (feats, grads, scorecam's class probabilities: "
          f"bound {CAM_TOL}; ablationcam's scores against its base score: bound "
          f"{CAM_SCORE_TOL}): " + "; ".join(errs))
    del models, card
    torch.cuda.empty_cache()
    return total


# -- P15-P17: deploy mode, ClassInference, the arbiters and the serving planner
P15_ROUND_TRIP_SEED = 150  # the seeded batch of the deploy round trip's logits
ARBITER_MARGIN = 0.03      # never_lose_deploy's default margin: t_final against the better form
REMAT_TOL = 1e-5           # a rematerialized dense conv against its factored layer's plain version
REMAT_BATCH = 8            # images whose site inputs the per-site gate takes
PLANNER_SKIP = {"ConvNeXt-T": ("mlpprune",)}
# P17's serving types: MSCAN-t at the planner's default (bfloat16), ConvNeXt-T in float32, so
# that both types stay planned
PLAN_DTYPES = {"MSCAN-t": "bfloat16", "ConvNeXt-T": "float32"}
DECISION_SPREAD = 0.02     # two calls may decide apart only where the rows lie this close
BOUNDARY_BAND = 0.02       # arbitrated_apply's default: a group this near its bar is timed twice
DEVICE = "cuda"  # where P15-P17 run: the card


def kernel_counts() -> dict:
    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops
    from convnet_approximater_tpu_torch.ops import parallel_cascade as cascade_ops
    from convnet_approximater_tpu_torch.ops import qmatmul as qmatmul_ops

    return {"msca_fused": fused_ops.msca_fused.launches,
            "lowrank_conv": lowrank_ops.lowrank_conv.launches,
            "parallel_cascade": cascade_ops.parallel_cascade.launches,
            "qmatmul": qmatmul_ops.qmatmul.launches}


@contextlib.contextmanager
def forwards_counted(model):
    """A list that gets one entry per top-level forward of ``model`` in the block."""
    seen = []
    handle = model.register_forward_pre_hook(lambda m, i: seen.append(1))
    try:
        yield seen
    finally:
        handle.remove()


def checkpoint_in(work_dir: str) -> str:
    """The Runner's ``.pt`` that an earlier phase's CLI run wrote into ``work_dir``."""
    found = sorted(f for f in os.listdir(work_dir) if f.endswith(".pt"))
    if len(found) != 1:
        fail(f"expected one .pt checkpoint in {work_dir}, found {found}")
    return os.path.join(work_dir, found[0])


def run_deploy_round_trip():
    """P15, the Runner: MSCAN-t MscaRep d1+fix solved through the CLI, its .pt
    loaded back by the CLI with --checkpoint (deploy, skip_optim, skip_post):
    no solve, the logits bit-equal to the solved model's at b=64, 224^2, 13
    msca_fused launches per forward of the deploy run's hooks.  Returns the
    deploy run's launches."""
    import torch

    from convnet_approximater_tpu_torch import main as cli
    from convnet_approximater_tpu_torch.layers import MSCA

    solved, solve_s = run_cli(CONFIG, os.path.join(REPO, "build", "chip_smoke_p15_solve"))
    ckpt = solved.output_path
    x = seeded_batch(P15_ROUND_TRIP_SEED)
    with torch.no_grad(), uncounted():
        y_solved = solved.model(x)
    del solved
    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    runner = cli.main(["--config", CONFIG, "--device", DEVICE, "--seed", "0", "--work-dir",
                       os.path.join(REPO, "build", "chip_smoke_p15_deploy"), "--checkpoint", ckpt])
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    launches, forwards = kernel_counts()["msca_fused"], forwards_of(runner)
    model = runner.model
    if not (runner.deploy and runner.skip_optim and runner.skip_post) or not all(
            type(m) is MSCA for m in model.switchable_modules()) or model.length_switchable != 13:
        fail("P15: the deploy run did not build 13 bare MSCA targets in deploy mode")
    if launches != 13 * forwards or launches == 0:
        fail(f"P15: the deploy run's {forwards} forwards launched msca_fused {launches} times, "
             f"expected {13 * forwards}")
    with torch.no_grad(), uncounted():
        y = model(x)
    same = torch.equal(y, y_solved)
    print(f"P15 deploy round trip of {os.path.relpath(CONFIG, REPO)}: solve run {solve_s:.2f} s, "
          f"deploy run {deploy_s:.2f} s (Runner(deploy=True, skip_optim=True, skip_post=True) "
          f"on {os.path.relpath(ckpt, REPO)}); {forwards} forwards launched msca_fused "
          f"{launches} times (13 per forward); logits at {INPUT} bit-equal to the solved "
          f"model's: {same} [{smi_line()}]")
    if not same:
        fail(f"P15: the deployed logits differ from the solved model's by "
             f"{rel_err(y, y_solved):.3e} (relative); no solve ran, so they must be equal")
    del runner, model
    torch.cuda.empty_cache()
    return launches


def run_inference_cli():
    """P15, ClassInference: the inference CLI on the dodecomp AlexNet's .pt of
    phase 5 at b=64, 224^2, with --decomp --never-lose --quantize int8.  Each
    report's median ms, MACs and params; lowrank_conv once per factored site
    per forward in approximated, decomposed and never-lose (as many as the
    arbiter kept decomposed), qmatmul once per int8 module per forward in int8;
    the decision table written.  Returns ({report: launches}, qmatmul modules)."""
    import torch

    from convnet_approximater_tpu_torch import inference as inference_cli
    from convnet_approximater_tpu_torch.layers import LowRankExpConvV1, QuantConv2d, QuantLinear
    from convnet_approximater_tpu_torch.runner import ClassInference

    ckpt = checkpoint_in(os.path.join(REPO, "build", "chip_smoke_alexnet"))
    work_dir = os.path.join(REPO, "build", "chip_smoke_p15_inference")
    table_path = os.path.join(work_dir, "never_lose_decisions.json")
    if os.path.exists(table_path):
        os.remove(table_path)
    seen = {}
    report = ClassInference._report

    def counted(self, tag, model):
        with torch.no_grad():
            factored = sum(isinstance(m, LowRankExpConvV1) and m.uses_kernel()
                           for m in model.modules())
        reset_counts()
        with forwards_counted(model) as forwards:
            report(self, tag, model)
        seen[tag] = dict(forwards=len(forwards), factored=factored, launches=kernel_counts())

    t0 = time.perf_counter()
    with mock.patch.object(ClassInference, "_report", counted):
        run = inference_cli.main(["--config", ALEX_DODECOMP, "--checkpoint", ckpt, "--batch",
                                  str(BATCH), "--decomp", "--never-lose", "--quantize", "int8",
                                  "--device", DEVICE, "--seed", "0", "--work-dir", work_dir])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if list(run.reports) != ["original", "approximated", "decomposed", "never-lose", "int8"]:
        fail(f"P15: ClassInference made the reports {list(run.reports)}")
    if not os.path.exists(table_path):
        fail(f"P15: --never-lose wrote no {table_path}")
    with open(table_path) as f:
        table = json.load(f)
    kept = table["kept_decomposed"]
    int8_modules = sum(isinstance(m, (QuantConv2d, QuantLinear)) for m in run.new_model.modules())
    print(f"P15 inference CLI on {os.path.relpath(ALEX_DODECOMP, REPO)} with "
          f"{os.path.relpath(ckpt, REPO)} at ({BATCH}, 224, 224, 3), --decomp --never-lose "
          f"--quantize int8: {run_s:.2f} s [{smi_line()}]")
    for row in table["layers"]:
        print(f"P15 never-lose: {row['name']} -> {row['kept']}")
    print(f"P15 never-lose: t_decomposed {table['t_decomposed'] * 1e3:.3f} ms, t_dense "
          f"{table['t_dense'] * 1e3:.3f} ms, t_final {table['t_final'] * 1e3:.3f} ms, "
          f"{kept} of 4 kept decomposed; table in {os.path.relpath(table_path, REPO)}")
    want = {"approximated": 4, "decomposed": 4, "never-lose": kept}
    for tag, r in run.reports.items():
        s = seen[tag]
        per = {k: v / s["forwards"] for k, v in s["launches"].items()}
        print(f"P15 report {tag}: {r['ms']:.3f} ms as a graph back to back "
              f"({BATCH / r['ms'] * 1e3:.1f} img/s), eager median {r['eager_ms']:.3f} ms, "
              f"MACs {r['macs'] / 1e6:.2f} M, params {r['params'] / 1e6:.2f} M; launches per "
              f"forward over {s['forwards']} forwards: " + ", ".join(
                  f"{k} {v:g}" for k, v in per.items()))
        if tag in want and (s["factored"] != want[tag]
                            or s["launches"]["lowrank_conv"] != want[tag] * s["forwards"]):
            fail(f"P15 {tag}: {s['factored']} factored sites take the kernel and lowrank_conv "
                 f"launched {s['launches']['lowrank_conv']} times in {s['forwards']} forwards; "
                 f"expected {want[tag]} per forward")
    q = seen["int8"]
    if int8_modules == 0 or q["launches"]["qmatmul"] != int8_modules * q["forwards"]:
        fail(f"P15 int8: qmatmul launched {q['launches']['qmatmul']} times in {q['forwards']} "
             f"forwards for {int8_modules} int8 modules")
    launches = {tag: s["launches"] for tag, s in seen.items()}
    del run
    torch.cuda.empty_cache()
    return launches, int8_modules


@contextlib.contextmanager
def timings_recorded():
    """A list that gets each ``forward_times`` result (graph ms, eager median)
    of the default timer in the block, in order."""
    from convnet_approximater_tpu_torch.hooks import inference_time_hook as timer

    seen, real = [], timer.forward_times

    def spy(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    with mock.patch.object(timer, "forward_times", spy):
        yield seen


def timings_line(seen) -> str:
    return ", ".join(f"{t['ms']:.3f} (eager {t['eager_median_ms']:.3f})" for t in seen)


def near_tie(a: float, b: float) -> bool:
    """Whether two readings lie within DECISION_SPREAD of the smaller."""
    return abs(a - b) <= DECISION_SPREAD * min(a, b)


def arbiter_decisions(label, res, secs, forms, group_fn=None, band=None) -> list:
    """The decisions of one call of an arbiter (never_lose_deploy, ``forms``
    ("decomposed", "dense"); arbitrated_apply, ("applied", "original")) in the
    order it took them, rebuilt from its timings (``secs``, seconds, as the
    arbiter took them): the first holds the whole model in the new form
    against the bar t_old x (1 - margin); where that misses, each group
    (``group_fn`` of the site's name; one site each by default) is timed in
    the new form against t_best x (1 - margin), and with ``band`` a reading
    within ``band`` x t_best of its bar is averaged with the next, as
    arbitrated_apply's boundary band takes it.  Each decision is (what, the
    reading, t_best, the bar, the outcome).  Fails where the rebuilt
    decisions are not the call's."""
    m, (new, old) = ARBITER_MARGIN, forms
    names = [r["name"] for r in res["layers"]]
    whole = secs[0] < secs[1] * (1 - m)
    decisions = [("every site at once", secs[0], secs[1], secs[1] * (1 - m),
                  f"all {new}" if whole else "one group at a time")]
    kept, used = {n: new for n in names} if whole else {}, 2
    if not whole:
        groups = {}
        for n in names:
            groups.setdefault(n if group_fn is None else group_fn(n), []).append(n)
        best = secs[1]
        for key, members in groups.items():
            if used >= len(secs):
                fail(f"{label}: fewer timings than groups")
            t, bar = secs[used], best * (1 - m)
            used += 1
            if band is not None and abs(t - bar) <= band * best and used < len(secs):
                t, used = 0.5 * (t + secs[used]), used + 1
            outcome = new if t < bar else old
            decisions.append((str(key), t, best, bar, outcome))
            kept.update({n: outcome for n in members})
            best = t if t < bar else best
    if used != len(secs) or kept != {r["name"]: r["kept"] for r in res["layers"]}:
        fail(f"{label}: its timings do not rebuild its decisions")
    return decisions


def hold_decisions(label, calls) -> None:
    """Both calls' decisions, printed in order, are the same, or the first
    one they take apart (up to it both held the same model) was a near tie in
    each call: its reading within DECISION_SPREAD of its bar.  What follows
    it is decided on different models and is not compared."""
    apart = next((i for i, (a, b) in enumerate(zip(*calls)) if a[0] != b[0] or a[4] != b[4]),
                 None)
    if apart is None and len(calls[0]) != len(calls[1]):
        apart = min(len(c) for c in calls)
    print(f"{label}: the two calls' decisions agree: {apart is None}")
    for call, decisions in enumerate(calls, 1):
        for i, (what, t, best, bar, outcome) in enumerate(decisions):
            print(f"{label} call {call}, decision {i}: {what} -> {outcome}: reading "
                  f"{t * 1e3:.3f} ms, best so far {best * 1e3:.3f}, bar {bar * 1e3:.3f} "
                  f"(x {1 - ARBITER_MARGIN})" + ("  [the first taken apart]" if i == apart else ""))
    if apart is None:
        return
    rows = [c[apart] if apart < len(c) else None for c in calls]
    if any(r is None or not near_tie(r[1], r[3]) for r in rows):
        fail(f"{label}: the calls first decided apart at decision {apart}, and a call's reading "
             f"there lies more than {DECISION_SPREAD:.0%} from its bar: {rows}")


def peak_gib() -> float:
    import torch

    return torch.cuda.max_memory_allocated() / 2 ** 30


def run_never_lose():
    """P16, never_lose_deploy on the solved scheme-1 VGG-16 of phase 11 (its .pt
    loaded in deploy mode through ClassInference.build_approximated), b=64,
    224^2, twice, each on a freshly loaded model, with the default timer (a
    graph replayed back to back per timing, the eager median beside it): each
    site's rematerialized dense conv within 1e-5 of the factored layer's plain
    version on its own input (8 images), the decision table with t_decomposed,
    t_dense and t_final, the final logits within 1e-4 of the all-factored
    model's, lowrank_conv once per site kept decomposed, and the final model
    re-timed within 3 % of the better of the two forms; the two calls' decisions
    agree, or the first decision the two calls take apart was, in each call,
    a reading within 2 % of its bar (arbiter_decisions).  Returns
    (the first arbiter's launches, the final model's per forward)."""
    import torch

    from convnet_approximater_tpu_torch import deploy
    from convnet_approximater_tpu_torch.hooks import time_forward
    from convnet_approximater_tpu_torch.layers import LowRankExpConvV1
    from convnet_approximater_tpu_torch.runner import ClassInference
    from convnet_approximater_tpu_torch.utils import init_cfg

    ckpt = checkpoint_in(os.path.join(REPO, "build", "chip_smoke_low-rank-exp-v1_all_svd_vgg16"))

    def deployed():
        init_cfg(VGG16)
        return ClassInference(ckpt, batch_size=BATCH, device=DEVICE).build_approximated()

    model = deployed()
    sites = list(model.switchable_modules())
    if model.switchable_names != VGG16_SITES or not all(
            isinstance(m, LowRankExpConvV1) for m in sites):
        fail(f"P16: the deployed VGG-16 has sites {model.switchable_names}")
    inputs = {}
    handles = [m.register_forward_pre_hook(lambda mod, inp, i=i: inputs.__setitem__(i, inp[0]))
               for i, m in enumerate(sites)]
    with torch.no_grad(), uncounted():
        model(seeded_batch(160, batch=REMAT_BATCH))
        for h in handles:
            h.remove()
        errs = []
        for i, m in enumerate(sites):
            dense = deploy.rematerialize_dense(m)
            errs.append(rel_err(dense(inputs[i]), through_lowrank_ref(m, inputs[i])))
        x = seeded_batch(161)
        y_factored = model(x)
    del inputs
    print(f"P16 rematerialize_dense at VGG-16's 12 sites, ({REMAT_BATCH}, 224, 224, 3): dense "
          f"conv against the factored layer's plain version, rel err max {max(errs):.3e} "
          f"(bound {REMAT_TOL}): " + ", ".join(f"{e:.2e}" for e in errs))
    if max(errs) > REMAT_TOL:
        fail("P16: a rematerialized dense conv disagrees with its factored layer")

    results = []
    for call in (1, 2):
        if call == 2:
            del model
            torch.cuda.empty_cache()
            model = deployed()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with forwards_counted(model) as forwards, timings_recorded() as seen:
            res = deploy.never_lose_deploy(model, INPUT)
        torch.cuda.synchronize()
        arbiter_s = time.perf_counter() - t0
        if call == 1:
            arbiter_launches = kernel_counts()["lowrank_conv"]
        t_dec, t_dense, t_final = res["t_decomposed"], res["t_dense"], res["t_final"]
        kept = res["kept_decomposed"]
        print(f"P16 never_lose_deploy VGG-16 at {INPUT}, call {call}: t_decomposed "
              f"{t_dec * 1e3:.3f} ms, t_dense {t_dense * 1e3:.3f} ms, t_final {t_final * 1e3:.3f} "
              f"ms (graphs back to back), {kept} of 12 kept decomposed; {arbiter_s:.2f} s of host "
              f"time, {len(seen)} timings, {len(forwards)} eager forwards; each timing's graph ms "
              f"(eager median ms): {timings_line(seen)}; peak memory {peak_gib():.2f} GiB "
              f"[{smi_line()}]")
        results.append(arbiter_decisions("P16 never_lose_deploy", res,
                                         [t["ms"] / 1e3 for t in seen], ("decomposed", "dense")))
        if call == 1:
            with torch.no_grad(), uncounted():
                y = model(x)
            check_logits("P16 VGG-16 after never_lose_deploy", y,
                         {"the all-factored model": y_factored}, LOGITS_TOL, classes=10,
                         shape=(BATCH, 10))
            reset_counts()
            with forwards_counted(model) as forwards:
                t_re = float(np.median(time_forward(model, INPUT, DEVICE, 10, 2))) / 1e3
            per_forward = kernel_counts()["lowrank_conv"] / len(forwards)
            bound_s = min(t_dec, t_dense) * (1 + ARBITER_MARGIN)
            print(f"P16 the final VGG-16 re-timed: {t_re * 1e3:.3f} ms as a graph back to back "
                  f"(bound {bound_s * 1e3:.3f} ms = min(t_decomposed, t_dense) x "
                  f"{1 + ARBITER_MARGIN}); lowrank_conv {per_forward:g} per forward")
            if per_forward != kept:
                fail(f"P16: the final model launched lowrank_conv {per_forward} times per "
                     f"forward, {kept} sites kept decomposed")
            if t_re > bound_s:
                fail("P16: the final model is slower than the better of its two forms")
            del y
    hold_decisions("P16 never_lose_deploy", results)
    del model, y_factored
    torch.cuda.empty_cache()
    return arbiter_launches, per_forward


def run_arbitrated():
    """P16, arbitrated_apply(FfnRep(fix=True)) on MSCAN-t after MscaRep d1+fix,
    grouped by stage, b=64, 224^2, twice on fresh models with the default
    timer: the first writes its table, a replay from it on a
    fresh model times nothing, and its structure and logits are the measured
    run's, bit for bit;
    the two calls' decisions agree, or the first decision the two calls take
    apart was, in each call, a reading within 2 % of its bar
    (arbiter_decisions).  Returns msca_fused's launches in the first measured run."""
    import copy

    import torch

    from convnet_approximater_tpu_torch.core import FfnRep, MscaRep
    from convnet_approximater_tpu_torch.deploy import arbitrated_apply
    from convnet_approximater_tpu_torch.deploy_planner import apply_app

    base = mscan_base(random_norms=False)
    out_dir = os.path.join(REPO, "build", "chip_smoke_p16")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "ffnrep_decisions.json")

    def stage(name):
        return name.rsplit(".", 3)[0]

    def prepared():
        model = copy.deepcopy(base)
        if apply_app(model, MscaRep(decomp=1, fix=True), [],
                     torch.Generator().manual_seed(0)) != 13:
            fail("P16: MscaRep found another number of MSCA blocks on MSCAN-t")
        return model

    results, decided = [], []
    for call in (1, 2):
        model = prepared()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with forwards_counted(model) as forwards, timings_recorded() as seen:
            res = arbitrated_apply(model, FfnRep(fix=True), [], INPUT, group_fn=stage,
                                   decisions_path=path if call == 1 else
                                   os.path.join(out_dir, "ffnrep_decisions_2.json"),
                                   retime=True)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = kernel_counts()["msca_fused"]
        if launches != 13 * len(forwards) or not forwards:
            fail(f"P16 arbitrated_apply: {len(forwards)} forwards launched msca_fused {launches} "
                 f"times, expected 13 per forward")
        print(f"P16 arbitrated_apply(FfnRep, by stage) on MSCAN-t d1+fix at {INPUT}, call {call}: "
              f"t_applied {res['t_applied'] * 1e3:.3f} ms, t_original "
              f"{res['t_original'] * 1e3:.3f} ms, t_final {res['t_final'] * 1e3:.3f} ms (graphs "
              f"back to back), {res['kept_applied']} of 13 FFNs merged; {run_s:.2f} s of host time "
              f"(the 13 FfnRep solves and {len(seen)} timings); each timing's graph ms (eager "
              f"median ms): {timings_line(seen)}; msca_fused {launches} launches in "
              f"{len(forwards)} eager forwards; peak memory {peak_gib():.2f} GiB [{smi_line()}]")
        results.append(res)
        decided.append(arbiter_decisions("P16 arbitrated_apply", res, [t["ms"] / 1e3 for t in seen],
                                     ("applied", "original"), stage, BOUNDARY_BAND))
        if call == 1:
            measured, measured_launches = model, launches
        else:
            del model
    hold_decisions("P16 arbitrated_apply", decided)
    model, res = measured, results[0]
    calls = []
    replay = prepared()
    res2 = arbitrated_apply(replay, FfnRep(fix=True), [], INPUT, group_fn=stage,
                            decisions_path=path, time_fn=lambda m, s: calls.append(1) or 1.0)
    x = seeded_batch(162)
    with torch.no_grad(), uncounted():
        same = torch.equal(replay(x), model(x))
    kinds = [type(m).__name__ for m in model.switchable_modules()]
    print(f"P16 replay from {os.path.relpath(path, REPO)}: {len(calls)} timing calls, "
          f"structure equal {kinds == [type(m).__name__ for m in replay.switchable_modules()]}, "
          f"logits bit-equal {same}")
    if calls or not res2.get("replayed") or res2["decisions"] != res["decisions"]:
        fail("P16: the replay timed, or gave another decision table")
    if kinds != [type(m).__name__ for m in replay.switchable_modules()] or not same:
        fail("P16: the replayed model differs from the measured one")
    del base, model, replay
    torch.cuda.empty_cache()
    return measured_launches


def plan_model(name):
    """(make, the plan's launch gates) of P17's two models at full width, seed 0."""
    import torch

    from convnet_approximater_tpu_torch.models import ConvNeXt
    from convnet_approximater_tpu_torch.nn import channels_last, init_weights

    if name == "MSCAN-t":
        return (lambda: mscan_base(random_norms=False),
                {"dense/float32": {"msca_fused": 13, "parallel_cascade": 0},
                 "dense/bfloat16": {"msca_fused": 13, "parallel_cascade": 0},
                 "v3/e=0.9": {"msca_fused": 13}, "tucker/e=0.9": {"msca_fused": 13},
                 "mscarep/d1+fix+dconv0+arb-ffnrep": {"msca_fused": 0, "parallel_cascade": 26},
                 "ffnprune/0.5+mscarep": {"msca_fused": 0, "parallel_cascade": 26},
                 "trunk+attnprune+ffnprune/0.5+mscarep": {"msca_fused": 0,
                                                          "parallel_cascade": 26},
                 "int8": {"msca_fused": 0, "parallel_cascade": 13}})

    def make():
        model = ConvNeXt(num_classes=1000)
        init_weights(model, torch.Generator().manual_seed(0))
        model = channels_last(model.to(DEVICE)).eval()
        set_gamma(model)  # at the 1e-6 init the blocks would hide from the agreement gate
        return model

    return make, {"dense/float32": {"parallel_cascade": 0, "qmatmul": 0},
                  "dwsep/r=1": {"parallel_cascade": 18}, "dwsep/r=1+int8": {"parallel_cascade": 18}}


def print_plan(name, plan, eager, call):
    print(f"P17 {name} call {call} {'surface':<42}{'ms':>10}{'eager ms':>10}{'img/s':>10}"
          f"{'agree':>8}{'qualified':>10}  note")
    for r in plan["report"]:
        ms = f"{r['ms']:.3f}" if r["ms"] is not None else "-"
        em = f"{eager[r['name']]:.3f}" if r["name"] in eager else "-"
        ips = f"{r['img_per_s']:.1f}" if r["img_per_s"] else "-"
        agree = f"{r['agree']:.4f}" if r["agree"] is not None else "-"
        print(f"P17 {name} call {call} {r['name']:<42}{ms:>10}{em:>10}{ips:>10}{agree:>8}"
              f"{str(r['qualified']):>10}  {r['note']}")
    print(f"P17 {name} call {call} winner: {plan['winner']} ({plan['speedup_vs_dense']:.4f}x "
          f"dense/{plan['dtype']})")


def run_plan(name):
    """P17 on one model, called twice: plan_serving at b=64, 224^2, at the
    model's type of PLAN_DTYPES (MSCAN-t at the planner's default, bfloat16),
    with the default candidates (less PLANNER_SKIP's), each timed as the
    default time_fn times (a graph replayed back to back, 10 and 40 replays
    after 3, the eager median of 10 after 3 beside it) and its
    launches per forward counted there.  Gates on the first call: the dense
    candidate of that type qualifies, every built row has a time, the kernels'
    launches per forward of each candidate, int8's qmatmul once per int8
    module; reuse_plan of plan_to_json rebuilds the winner with no timing
    call, its logits within 1e-4 of the plan's (bf16: within BF16_REL_TOL).  The second call's winner is the first's, or in each call the two
    winners' rows lie within 2 %.  Returns ({candidate: launches per forward},
    the first plan, the second call's winner)."""
    import torch

    from convnet_approximater_tpu_torch import deploy_planner as planner
    from convnet_approximater_tpu_torch.hooks import forward_times
    from convnet_approximater_tpu_torch.layers import QuantConv2d, QuantLinear

    make, gates = plan_model(name)
    skip = PLANNER_SKIP.get(name, ())
    dtype = getattr(torch, PLAN_DTYPES[name])
    dense_name = f"dense/{PLAN_DTYPES[name]}"
    cands = [c for c in planner.default_candidates(make(), dtype=dtype, input_shape=INPUT)
             if not any(s in c[0] for s in skip)]
    plans = []
    for call in (1, 2):
        per_forward, int8_modules, built_s, calls, eager = {}, {}, {}, [], {}
        last = [0.0]

        def time_fn(cand, model, shape, dtype):
            # the host time since the last timing is this candidate's build and agreement
            built_s[cand] = time.perf_counter() - last[0]
            calls.append(cand)
            reset_counts()
            with forwards_counted(model) as forwards:
                t = forward_times(model, shape, 10, 3, dtype=dtype)
            eager[cand] = t["eager_median_ms"]
            per_forward[cand] = {k: v / len(forwards) for k, v in kernel_counts().items()}
            int8_modules[cand] = sum(isinstance(m, (QuantConv2d, QuantLinear))
                                     for m in model.modules())
            last[0] = time.perf_counter()
            return t["ms"] / 1e3

        torch.cuda.reset_peak_memory_stats()
        t0 = last[0] = time.perf_counter()
        plan = planner.plan_serving(make, INPUT, dtype=dtype, candidates=cands, time_fn=time_fn)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        print(f"P17 plan_serving {name} at {INPUT} {plan['dtype']}, call {call}: {len(cands)} "
              f"candidates"
              + (f" (skipped: the {', '.join(skip)} candidates)" if skip else "")
              + f", {plan_s:.2f} s of host time, {len(calls)} timing calls, peak memory "
                f"{peak_gib():.2f} GiB [{smi_line()}]")
        print_plan(name, plan, eager, call)
        plans.append(plan)
        if call == 2:
            break
        first_per_forward = per_forward
        for cand, per in per_forward.items():
            print(f"P17 {name} {cand}: launches per forward " + ", ".join(
                f"{k} {v:g}" for k, v in per.items()) + f"; {int8_modules[cand]} int8 modules; "
                  f"built and graded in {built_s[cand]:.2f} s of host time")
        rows = plan["report"][1:]
        if not any(r["name"] == dense_name and r["qualified"] for r in rows):
            fail(f"P17 {name}: {dense_name} did not qualify")
        if any(r["ms"] is None and not r["note"].startswith("skipped") for r in rows):
            fail(f"P17 {name}: a candidate that built has no time")
        for cand, want in gates.items():
            got = per_forward.get(cand)
            if got is not None and any(got[k] != v for k, v in want.items()):
                fail(f"P17 {name} {cand}: launches per forward {got}, expected {want}")
        for cand, per in per_forward.items():
            if "int8" in cand and (int8_modules[cand] == 0
                                   or per["qmatmul"] != int8_modules[cand]):
                fail(f"P17 {name} {cand}: qmatmul {per['qmatmul']} per forward for "
                     f"{int8_modules[cand]} int8 modules")

        replay_calls = []
        again = planner.plan_serving(make, INPUT, dtype=dtype, candidates=cands,
                                     time_fn=lambda *a: replay_calls.append(1) or 1.0,
                                     reuse_plan=json.loads(json.dumps(
                                         planner.plan_to_json(plan))))
        x = seeded_batch(170).to(dtype)
        with torch.no_grad(), uncounted():
            err = f32_rel(again["model"](x), plan["model"](x))
        tol = LOGITS_TOL if dtype == torch.float32 else BF16_REL_TOL
        print(f"P17 {name} reuse_plan: winner {again['winner']}, replayed "
              f"{again.get('replayed')}, {len(replay_calls)} timing calls; logits against the "
              f"plan's winner rel err {err:.3e} (bound {tol})")
        if replay_calls or not again.get("replayed") or again["winner"] != plan["winner"]:
            fail(f"P17 {name}: reuse_plan timed, or rebuilt another winner")
        if err > tol:
            fail(f"P17 {name}: the rebuilt winner's logits differ from the plan's")
        del again
        torch.cuda.empty_cache()
    winners = [p["winner"] for p in plans]
    print(f"P17 {name}: the two calls' winners agree: {winners[0] == winners[1]} ({winners})")
    if winners[0] != winners[1]:
        for call, p in enumerate(plans, 1):
            ms = {r["name"]: r["ms"] for r in p["report"][1:]}
            if not near_tie(ms[winners[0]], ms[winners[1]]):
                fail(f"P17 {name}: the calls chose {winners}, and call {call} has them "
                     f"{ms[winners[0]]:.3f} and {ms[winners[1]]:.3f} ms apart by more than "
                     f"{DECISION_SPREAD:.0%}")
    for p in plans[1:]:
        del p["model"]
    torch.cuda.empty_cache()
    return first_per_forward, plans[0], winners[1]


def run_planner():
    """P17: the serving planner on MSCAN-t, then ConvNeXt-T, each twice."""
    out = {}
    for name in ("MSCAN-t", "ConvNeXt-T"):
        t0 = time.perf_counter()
        per_forward, plan, second = run_plan(name)
        out[name] = dict(per_forward=per_forward, winner=plan["winner"], second=second,
                         seconds=time.perf_counter() - t0)
        del plan
    print(f"P17 in {sum(v['seconds'] for v in out.values()):.2f} s (P15-P17 took 40-55 s on the "
          f"eager timer, one call each): " + ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in out.items()))
    return out


# -- P18: the serving export, the serving CLIs and the batch wrappers
P18_DIR = os.path.join(REPO, "build", "chip_smoke_p18")
EXPORT_TOL = 1e-6   # an artifact's logits against its live model's: max-abs over the largest
SYMBOLIC_BATCHES = (1, 2, 64, 65)
SERVE_BATCH = 128
P18_SERVE_BATCHES = 32


def max_rel(a, b) -> float:
    """Max-abs difference over the largest magnitude of ``b``."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def run_opcheck():
    """P18a: torch.library.opcheck of each kernel's op on the card, at one
    shape of its path (schema, fake kernel under static and dynamic shapes,
    dispatch).  Its launches are not counted."""
    import torch

    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops
    from convnet_approximater_tpu_torch.ops import parallel_cascade as cascade_ops
    from convnet_approximater_tpu_torch.ops import qmatmul as qmatmul_ops
    from convnet_approximater_tpu_torch.ops.msca_fused import pack_cascade_weights

    gen = torch.Generator().manual_seed(18)

    def u(*shape, scale=1.0):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * scale).cuda()

    args, kw = kernel_inputs("d1fix", 56, 32, gen)
    H, C, k, pad, M, N = ALEX_CONVS[0]
    x, A_mc, b, taps = lowrank_inputs(BATCH, H, H, C, M, N, (k, k), "sep", gen)
    packed = lowrank_ops.pack_kernel_weights(A_mc, **taps)
    w1, b1, w2, b2, ks = pack_cascade_weights([u(21, 32, scale=21 ** -0.5)], [u(32, scale=0.2)],
                                              [u(21, 32, scale=21 ** -0.5)], [u(32, scale=0.2)])
    w_q = torch.randint(-127, 128, (64, 64), generator=gen, dtype=torch.int8).cuda()
    cases = {
        "msca_fused, MSCAN-t stage 1 d1+fix (64, 56, 56, 32)": (
            fused_ops.msca_fused_op, (*args, list(kw["ks"]), kw["identity"], kw["fix_p"])),
        f"lowrank_conv, AlexNet conv 2 separable {(BATCH, H, H, C)}": (
            lowrank_ops.lowrank_conv_op, (x, A_mc, b, taps["v"], taps["h"], None, packed["w"],
                                          packed["taps"], [k, k], [1, 1], [pad, pad])),
        "parallel_cascade, MSCAN-t stage 1 dconv0 bank (64, 56, 56, 32)": (
            cascade_ops.parallel_cascade_op, (u(BATCH, 56, 56, 32), w1, b1, w2, b2, list(ks),
                                              False)),
        "qmatmul, int8 ResNet-50 layer1 1x1 (200704, 64, 64)": (
            qmatmul_ops.qmatmul_op, (u(200704, 64), qmatmul_ops.pack_qweight(w_q),
                                     torch.tensor(0.02, device="cuda"), u(64).abs(), u(64))),
    }
    for name, (op, op_args) in list(cases.items()):  # each op again on bf16 x
        cases[f"{name}, bf16 x"] = (op, (op_args[0].bfloat16(),) + tuple(op_args[1:]))
    t0 = time.perf_counter()
    with uncounted():
        for name, (op, op_args) in cases.items():
            try:
                torch.library.opcheck(op, op_args)
            except Exception as e:  # noqa: BLE001 -- reported, then the run fails
                fail(f"P18a opcheck of {name}: {type(e).__name__}: {e}")
            print(f"P18a torch.library.opcheck on the card: {name}: passed")
    torch.cuda.synchronize()
    print(f"P18a the four ops' opcheck (float32 and bf16 x) in {time.perf_counter() - t0:.2f} s")


def export_artifact(name, model, x, symbolic: bool = False):
    """export -> save -> load of ``model``'s eval forward at ``x``: (loaded
    module, export s, load s, bytes)."""
    import torch

    from convnet_approximater_tpu_torch import deploy

    os.makedirs(P18_DIR, exist_ok=True)
    path = os.path.join(P18_DIR, name.replace(" ", "_").replace("/", "-") + ".pt2")
    t0 = time.perf_counter()
    with uncounted():
        deploy.export_serving(model, (x,), path=path, symbolic_batch=symbolic)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = deploy.load_serving(path)
    load_s = time.perf_counter() - t0
    return loaded, export_s, load_s, os.path.getsize(path), path


def captured(model, x):
    """``deploy.compile_serving`` of ``model`` at ``x``, and the kernels'
    launches in its capture forward: what each replay of the graph runs,
    counted by the wrappers (the graph replays what the capture recorded).
    Returns (compiled, put, {kernel: launches}); leaves the counts as they were."""
    from convnet_approximater_tpu_torch import deploy

    real, seen = deploy._capture, {}

    def spy(graph, m, static):
        reset_counts()
        out = real(graph, m, static)
        seen.update({k: v for k, v in kernel_counts().items() if v})
        return out

    with uncounted(), mock.patch.object(deploy, "_capture", spy):
        compiled, put = deploy.compile_serving(model, x)
    return compiled, put, seen


def held_plain(name, model, x, plain_fn, tol, y) -> float:
    """``y`` against ``plain_fn(model, x)`` (the kernels swapped for their plain
    versions, no kernel launched) by relative error, gated at ``tol``."""
    import torch

    with torch.no_grad(), uncounted():
        reset_counts()
        y_plain = plain_fn(model, x)
        launched = {k: v for k, v in kernel_counts().items() if v}
    err = rel_err(y, y_plain)
    if launched or not torch.isfinite(y_plain).all() or err > tol:
        fail(f"{name}: against the plain versions rel err {err:.3e} (bound {tol}), kernels "
             f"launched on the plain path {launched}")
    return err


def hold_artifact(name, model, loaded, x, want_ops, exact: bool, setup: str, plain_fn, tol):
    """The loaded artifact against its live model at ``x``: the custom-op
    nodes, the launches per eager forward and the kernels per replay (the
    capture's launches) equal to the live model's and to ``want_ops``, logits
    within EXPORT_TOL (bit-equal when ``exact``), the replay within EXPORT_TOL
    of live, and the live logits against ``plain_fn`` (every kernel of the
    path at this batch against its plain version) within ``tol``; graph ms
    and back-to-back ms of both.  Returns the artifact's launches per forward."""
    import torch

    from convnet_approximater_tpu_torch import deploy

    ops = deploy.custom_op_counts(loaded)
    launches = {}
    outs = {}
    for who, m in (("live", model), ("artifact", loaded)):
        reset_counts()
        with torch.no_grad():
            outs[who] = m(x)
        torch.cuda.synchronize()
        launches[who] = {k: v for k, v in kernel_counts().items() if v}
    err, same = max_rel(outs["artifact"], outs["live"]), torch.equal(outs["artifact"], outs["live"])
    plain_err = held_plain(f"P18b {name}", model, x, plain_fn, tol, outs["live"])
    B, C, H, W = x.shape
    times, replay = {}, {}
    for who, m in (("live", model), ("artifact", loaded)):
        compiled, put, replay[who] = captured(m, x)
        y = compiled(x)
        times[who] = (time_graph(compiled, put, (B, H, W, C)), back_to_back_ms(compiled))
        if who == "artifact":
            replay_err = max_rel(y, outs["live"])
        del compiled, put, y
    torch.cuda.empty_cache()
    print(f"P18b {name} at {tuple(x.shape)}: {setup}; custom-op nodes {ops}; launches per eager "
          f"forward live {launches['live']}, artifact {launches['artifact']}; kernel launches "
          f"per replay (the capture's) live {replay['live']}, artifact {replay['artifact']}; "
          f"logits max-abs relative {err:.3e} ({'bit-equal' if same else 'not bit-equal'}; bound "
          f"{'bit-equal' if exact else EXPORT_TOL}), the artifact's replay {replay_err:.3e}; live "
          f"against the plain versions rel err {plain_err:.3e} (bound {tol}); graph ms (a replay "
          f"and its copy, median) live {times['live'][0]:.3f}, artifact "
          f"{times['artifact'][0]:.3f}; back to back live {times['live'][1]:.3f}, artifact "
          f"{times['artifact'][1]:.3f} [{smi_line()}]")
    if ops != want_ops or launches["artifact"] != launches["live"] or \
            launches["artifact"] != want_ops:
        fail(f"P18b {name}: the artifact's ops {ops} or launches {launches} differ from the "
             f"live model's {want_ops}")
    if replay["artifact"] != replay["live"] or replay["live"] != want_ops:
        fail(f"P18b {name}: a replay of the artifact runs {replay['artifact']}, the live "
             f"model's {replay['live']}, expected {want_ops}")
    if not torch.isfinite(outs["artifact"]).all() or (not same if exact else err > EXPORT_TOL) \
            or replay_err > EXPORT_TOL:
        fail(f"P18b {name}: the artifact's logits differ from the live model's")
    return launches["artifact"], times


def run_exports():
    """P18b-d: the four exported surfaces at full width, the symbolic batch,
    and the serving loops.  Returns {path: launches per forward or in the run}."""
    import torch

    from convnet_approximater_tpu_torch import deploy, export_model, serve, serve_mscan
    from convnet_approximater_tpu_torch.serve import graph_per_batch_size

    out = {}
    t_phase = time.perf_counter()
    # P18b: the headline surface (msca_fused) and its dconv0 form at b=128 (parallel_cascade)
    base = mscan_base(random_norms=True)
    for decomp_conv0, batch in ((False, BATCH), (True, SERVE_BATCH)):
        _, surface = serving_surface(base, decomp_conv0)
        name = "MSCAN-t dconv0 surface" if decomp_conv0 else "MSCAN-t headline surface"
        x = seeded_batch(180, batch=batch)
        loaded, export_s, load_s, size, _ = export_artifact(name, surface, x)
        want = {"parallel_cascade": 26} if decomp_conv0 else {"msca_fused": 13}
        out[name], _ = hold_artifact(name, surface, loaded, x, want, False,
                                     f"export {export_s:.2f} s, load {load_s:.2f} s, "
                                     f"{size / 2 ** 20:.1f} MiB", through_all_plain, LOGITS_TOL)
        if not decomp_conv0:
            headline = surface
        del loaded, surface
        torch.cuda.empty_cache()
    # P18b: the dodecomp AlexNet through export_model, its checkpoint from phase 5
    ckpt = checkpoint_in(os.path.join(REPO, "build", "chip_smoke_alexnet"))
    alex_path = os.path.join(P18_DIR, "alexnet_dodecomp.pt2")
    t0 = time.perf_counter()
    with uncounted():
        res = export_model.main(["--config", ALEX_DODECOMP, "--checkpoint", ckpt, "--out",
                                 alex_path, "--batch", str(BATCH), "--seed", "0",
                                 "--dtype", "float32"])
    cli_s = time.perf_counter() - t0
    out["AlexNet dodecomp artifact"], _ = hold_artifact(
        "AlexNet dodecomp (export_model)", res["model"], res["artifact"],
        seeded_batch(181), {"lowrank_conv": 4}, False,
        f"export_model CLI {cli_s:.2f} s (its gate: max-abs {res['err']:.3e}), "
        f"{res['bytes'] / 2 ** 20:.1f} MiB", through_lowrank_ref, LOGITS_TOL)
    del res
    # P18b: int8 ResNet-50 through export_model --quantize int8, a symbolic batch
    r50_path = os.path.join(P18_DIR, "resnet50_int8.pt2")
    t0 = time.perf_counter()
    with uncounted():
        res = export_model.main(["--config", RESNET50_INT8, "--out", r50_path, "--batch",
                                 str(BATCH), "--quantize", "int8", "--symbolic-batch",
                                 "--seed", "0", "--dtype", "float32"])
    cli_s = time.perf_counter() - t0
    out["int8 ResNet-50 artifact"], _ = hold_artifact(
        "int8 ResNet-50 (export_model --quantize int8)", res["model"], res["artifact"],
        seeded_batch(182), {"qmatmul": 54}, True,
        f"export_model CLI {cli_s:.2f} s (its gate: max-abs {res['err']:.3e}), "
        f"{res['bytes'] / 2 ** 20:.1f} MiB", through_plain, INT8_TOL)
    r50_live = res["model"]  # held against serve's b=128 batches in P18d
    del res
    torch.cuda.empty_cache()
    print(f"P18b in {time.perf_counter() - t_phase:.2f} s")

    # P18c: the headline surface exported with a symbolic batch
    t0 = time.perf_counter()
    loaded, export_s, load_s, size, _ = export_artifact("MSCAN-t headline symbolic batch",
                                                        headline, seeded_batch(183), True)
    least = loaded.batch_range[0]
    served = deploy.pad_batch(graph_per_batch_size(loaded), least)  # as serve does
    errs, plain_errs = {}, {}
    reset_counts()
    for b in SYMBOLIC_BATCHES:
        x = seeded_batch(184 + b, batch=b)
        with torch.no_grad(), uncounted():
            y_live = headline(x)
        y = served(x)
        errs[b] = max_rel(y, y_live)
        plain_errs[b] = held_plain(f"P18c b={b}", headline, x, through_all_plain, LOGITS_TOL, y)
    sym_launches = kernel_counts()["msca_fused"]
    sizes = len({max(b, least) for b in SYMBOLIC_BATCHES})
    print(f"P18c MSCAN-t headline surface exported with a symbolic batch (export {export_s:.2f} "
          f"s, load {load_s:.2f} s, {size / 2 ** 20:.1f} MiB; in_avals {loaded.in_avals}, "
          f"batch range {loaded.batch_range}: below {least} through pad_batch): one graph per "
          f"batch size, against the live forward at that batch, max-abs relative "
          + ", ".join(f"b={b} {e:.3e}" for b, e in errs.items()) + f" (bound {EXPORT_TOL}); "
          f"against the live surface through msca_fused_ref, rel err "
          + ", ".join(f"b={b} {e:.3e}" for b, e in plain_errs.items()) + f" (bound {LOGITS_TOL}); "
          f"msca_fused launched {sym_launches} times in the {sizes} captures (4 forwards each)")
    if max(errs.values()) > EXPORT_TOL or sym_launches != 13 * 4 * sizes:
        fail("P18c: the symbolic-batch artifact disagrees with the live forward")
    out["MSCAN-t headline symbolic batch, 4 batch sizes"] = sym_launches
    del loaded, served
    # P18d: b=1 through pad_batch(., 2) against b=1 direct, graphs of the live surface
    graphs = graph_per_batch_size(headline)
    x1 = seeded_batch(190, batch=1)
    padded = deploy.pad_batch(graphs, 2)
    with uncounted():
        y_direct, y_pad = graphs(x1), padded(x1)
        direct_ms = back_to_back_ms(lambda: graphs(x1), n=50)
        pad_ms = back_to_back_ms(lambda: padded(x1), n=50)
    print(f"P18d MSCAN-t headline surface at b=1: direct {direct_ms:.3f} ms per request, "
          f"pad_batch(., 2) {pad_ms:.3f} ms (back to back, 50 requests; the graphs at b=1 and "
          f"b=2); padded against direct max-abs relative {max_rel(y_pad, y_direct):.3e} "
          f"[{smi_line()}]")
    if max_rel(y_pad, y_direct) > EXPORT_TOL:
        fail("P18d: pad_batch at b=1 changed the logits")
    print(f"P18c-d in {time.perf_counter() - t0:.2f} s")
    del graphs, padded, headline, base
    torch.cuda.empty_cache()

    # P18d: the serving loops
    t0 = time.perf_counter()
    reset_counts()
    res = serve_mscan.main(["--batch", str(SERVE_BATCH), "--batches", str(P18_SERVE_BATCHES),
                            "--dtype", "float32"])
    out["serve_mscan, b=128, 32 batches"] = kernel_counts()["parallel_cascade"]
    b2b = back_to_back_ms(res["compiled"])
    loops = [("serve_mscan (MSCAN-t dconv0 surface)", res["img_per_s"], b2b)]
    del res
    for ship in (False, True):
        reset_counts()
        res = serve.main(["--artifact", r50_path, "--batch", str(SERVE_BATCH), "--batches",
                          str(P18_SERVE_BATCHES)] + (["--ship-uint8"] if ship else []))
        out[f"serve int8 ResNet-50, b=128, 32 batches{', --ship-uint8' if ship else ''}"] = \
            kernel_counts()["qmatmul"]
        x = seeded_batch(191, batch=SERVE_BATCH)
        compiled, _ = deploy.compile_serving(res["module"], x)
        if not ship:  # the served program at b=128 against the live model and the plain versions
            y = compiled(x)
            with torch.no_grad(), uncounted():
                same = torch.equal(y, r50_live(x))
            plain_err = held_plain("P18d serve int8 ResNet-50 at b=128", r50_live, x,
                                   through_plain, INT8_TOL, y)
            print(f"P18d serve int8 ResNet-50: a b={SERVE_BATCH} batch through the served graph "
                  f"against the live int8 model: {'bit-equal' if same else 'not bit-equal'}; "
                  f"against it through qmatmul_ref rel err {plain_err:.3e} (bound {INT8_TOL})")
            if not same:
                fail("P18d: the served int8 ResNet-50 differs from the live model at b=128")
            del y
        loops.append((f"serve --artifact int8 ResNet-50{' --ship-uint8' if ship else ''}",
                      res["img_per_s"], back_to_back_ms(compiled)))
        del res, compiled
        torch.cuda.empty_cache()
    del r50_live
    for name, ips, b2b in loops:
        device_ips = SERVE_BATCH / b2b * 1e3
        print(f"P18d {name}: {ips:.1f} img/s end to end at b={SERVE_BATCH} against "
              f"{device_ips:.1f} img/s from the graph back to back ({b2b:.3f} ms per batch): "
              f"the host side (loader, H2D) costs {max(0.0, 1 - ips / device_ips):.1%} "
              f"[{smi_line()}]")
    print(f"P18d serving loops in {time.perf_counter() - t0:.2f} s; P18 in "
          f"{time.perf_counter() - t_phase:.2f} s")
    return out


# -- P19: bf16 serving -----------------------------------------------------
P19_DIR = os.path.join(REPO, "build", "chip_smoke_p19")
BF16_REL_TOL = 1e-2   # plan_serving's bf16 gate: relative Frobenius norm of the logits
P19_SERVE_BATCHES = 8


def f32_rel(a, b) -> float:
    """Relative Frobenius norm of ``a - b`` against ``b``, in float32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def bf16_ulps(a, b) -> int:
    """The most bf16 ulps between two bf16 tensors, element by element: the bit
    patterns mapped to integers in the order of the values they encode."""
    import torch

    def ordered(t):
        u = t.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
        mag = u & 0x7FFF
        return torch.where(u >= 0x8000, -mag, mag)

    return int((ordered(a) - ordered(b)).abs().max())


def bf16_row(name, shape, kernel, plain, library, exact, cost, peak=PEAK_F32, weight: int = 1):
    """One bf16 kernel call against its bf16 plain version, timed beside it and
    beside ``library`` (one PyTorch call in bf16, or None); the row.  ``cost``
    holds the call's ``bytes`` (x and out at 2 bytes an element) and its
    ``flops`` (lowrank_conv: ``basis_flops`` and ``mix_flops``), bounded as the
    float32 rows are (:func:`rows_bound`).

    ``exact`` True: ``torch.equal``.  Otherwise ``exact`` is (the float32
    kernel, the float32 plain version) on the same inputs upcast, and the bf16
    kernel must give the float32 kernel's result rounded to bf16, bit for bit
    (the same arithmetic, one rounding); each element then lies within one bf16
    ulp of the plain version's, or, where the float32 result is a cancellation
    (a value far below its terms), within one ulp plus the two float32 results'
    own difference there.  The elements beyond one ulp are counted."""
    import torch

    y, y_ref = kernel(), plain()
    torch.cuda.synchronize()
    if y.dtype != torch.bfloat16 or y_ref.dtype != torch.bfloat16:
        fail(f"P19a {name} {shape}: outputs {y.dtype} and {y_ref.dtype}, not bfloat16")
    ulps, same = bf16_ulps(y, y_ref), torch.equal(y, y_ref)
    abs_err = float((y.float() - y_ref.float()).abs().max())
    if not torch.isfinite(y.float()).all() or (exact is True and not same):
        fail(f"P19a {name} {shape}: {ulps} bf16 ulps from its plain version; bit-equal "
             f"required")
    over = 0
    if exact is not True:
        k32, r32 = exact[0](), exact[1]()
        rounded = torch.equal(y, k32.to(torch.bfloat16))
        diff = (y.float() - y_ref.float()).abs()
        scale = torch.maximum(y.float().abs(), y_ref.float().abs())
        over = int((diff > scale * 2 ** -7).sum())  # one bf16 ulp is at most |v| 2^-7
        allowed = scale * 2 ** -7 + (k32 - r32).abs()
        worst = float((diff - allowed).max())
        print(f"P19a {name} bf16 {shape}: the float32 kernel rounded once "
              f"{'gives' if rounded else 'does NOT give'} its bits; {over} of {y.numel()} "
              f"elements beyond one ulp of the plain version (the most {ulps} ulps), each "
              f"within one ulp plus the float32 results' own difference: "
              f"{'yes' if worst <= 0 else f'no, by {worst:.3e}'}")
        if not rounded or worst > 0:
            fail(f"P19a {name} {shape}: the bf16 kernel is not the float32 kernel rounded once, "
                 f"or an element lies beyond its bound")
        del k32, r32, diff, scale, allowed
    ms, plain_ms = time_pair(kernel, plain)
    lib_ms = library_time(library) if library is not None else None
    b_ms, b_by = rows_bound([cost], lambda r: 1, peak)
    lib = f"library {lib_ms:.4f} ms" if lib_ms is not None else "no single library call"
    print(f"P19a {name} bf16 {shape}: {'bit-equal' if same else f'{ulps} ulp'} to its bf16 "
          f"plain version (max abs {abs_err:.3e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"{lib}; bound {b_ms:.4f} ms by {b_by} (2-byte activations), roofline share "
          f"{b_ms / ms:.1%}")
    return dict(cost, name=name, shape=shape, calls=weight, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, peak=peak, max_abs_err=abs_err, ulps=ulps,
                beyond_one_ulp=over, bound_ms=b_ms)


def bf16_msca_rows(gen):
    """msca_fused in bf16 at MSCAN-t's four stage shapes in both bank forms."""
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops

    rows = []
    for form in ("dense", "d1fix"):
        for H, C, blocks in STAGES:
            args, kw = kernel_inputs(form, H, C, gen)
            args[0] = args[0].bfloat16()
            up = [args[0].float()] + args[1:]
            nbytes, flops = msca_cost(H, C, kw["ks"], kw["identity"], kw["fix_p"])
            nx = 2 * 2 * BATCH * H * H * C
            row = bf16_row(f"msca_fused {form}", (BATCH, H, H, C),
                           lambda: fused_ops.msca_fused(*args, **kw),
                           lambda: fused_ops.msca_fused_ref(*args, **kw), None,
                           (lambda: fused_ops.msca_fused(*up, **kw),
                            lambda: fused_ops.msca_fused_ref(*up, **kw)),
                           dict(bytes=nbytes - nx, flops=flops), weight=blocks)
            rows.append(dict(row, form=form))
            del args
    return rows


def bf16_cascade_rows(gen):
    """parallel_cascade in bf16 at ConvNeXt-T's r1 shapes and MSCAN-t's dconv0
    cascades (k = 5 and 21), beside cuDNN's bf16 depthwise conv of the merged kernel."""
    import torch
    import torch.nn.functional as F

    from convnet_approximater_tpu_torch.ops import parallel_cascade as cascade_ops
    from convnet_approximater_tpu_torch.ops.msca_fused import pack_cascade_weights

    def u(*shape, scale=1.0):
        return (torch.rand(*shape, generator=gen) * 2 - 1) * scale

    cases = [("r1", H, C, 7, blocks) for H, C, blocks in CONVNEXT_STAGES]
    cases += [(form, H, C, k, blocks) for form, k in (("d0k5", 5), ("d0k21", 21))
              for H, C, blocks in STAGES]
    rows = []
    for form, H, C, k, blocks in cases:
        w1, b1, w2, b2, ks = pack_cascade_weights([u(k, C, scale=k ** -0.5)], [None],
                                                  [u(k, C, scale=k ** -0.5)], [u(C, scale=0.2)])
        w1, b1, w2, b2 = (t.cuda() for t in (w1, b1, w2, b2))
        x = u(BATCH, H, H, C).cuda().bfloat16()
        merged = torch.einsum("bic,bjc->cij", w2, w1)[:, None].bfloat16()
        xc, bias = x.permute(0, 3, 1, 2), b2.sum(0).bfloat16()
        nbytes, flops = cascade_cost(H, C, ks, False)
        nx = 2 * 2 * BATCH * H * H * C
        row = bf16_row(f"parallel_cascade {form}", (BATCH, H, H, C),
                       lambda: cascade_ops.parallel_cascade(x, w1, b1, w2, b2, ks=ks,
                                                            identity=False),
                       lambda: cascade_ops.parallel_cascade_ref(x, w1, b1, w2, b2, ks=ks,
                                                                identity=False),
                       lambda: F.conv2d(xc, merged, bias, padding=k // 2, groups=C), True,
                       dict(bytes=nbytes - nx, flops=flops), weight=blocks)
        rows.append(dict(row, form=form))
        del x, xc
    return rows


def bf16_lowrank_rows(gen):
    """lowrank_conv in bf16 at the dodecomp AlexNet's four sites, beside cuDNN's
    bf16 conv of W_eff."""
    import torch
    import torch.nn.functional as F

    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops

    rows = []
    for H, C, k, pad, M, N in ALEX_CONVS:
        x, A, b, taps = lowrank_inputs(BATCH, H, H, C, M, N, (k, k), "sep", gen)
        x = x.bfloat16()
        kw = dict(kernel_size=(k, k), stride=(1, 1), padding=(pad, pad), **taps)
        packed = lowrank_ops.pack_kernel_weights(A, **taps)
        basis = taps["v"][:, :, None] * taps["h"][:, None]
        w_eff = torch.einsum("mcn,mij->ncij", A.reshape(M, C, N), basis).bfloat16().contiguous()
        xc, bb = x.permute(0, 3, 1, 2), b.bfloat16()
        nbytes, basis_flops, mix_flops = lowrank_cost(BATCH, H, H, C, M, N, (k, k), (1, 1),
                                                      (pad, pad), "sep")
        Ho = H + 2 * pad - k + 1
        nx = 2 * (BATCH * H * H * C + BATCH * Ho * Ho * N)
        xf = x.float()
        row = bf16_row("lowrank_conv sep", (BATCH, H, H, C),
                       lambda: lowrank_ops.lowrank_conv(x, A, b, packed=packed, **kw),
                       lambda: lowrank_ops.lowrank_conv_ref(x, A, b, **kw),
                       lambda: F.conv2d(xc, w_eff, bb, padding=pad),
                       (lambda: lowrank_ops.lowrank_conv(xf, A, b, packed=packed, **kw),
                        lambda: lowrank_ops.lowrank_conv_ref(xf, A, b, **kw)),
                       dict(bytes=nbytes - nx, basis_flops=basis_flops, mix_flops=mix_flops))
        rows.append(row)
        del x, xc, xf, packed
    return rows


def bf16_qmatmul_rows(gen):
    """qmatmul in bf16 at int8 ConvNeXt-T's 13 shapes (beside torch._int_mm on
    the same int8 operands) and the three ragged ones."""
    import torch

    from convnet_approximater_tpu_torch.ops import qmatmul as qmatmul_ops

    for M, K, N in QMM_RAGGED:
        x = torch.randn(M, K, generator=gen).cuda().bfloat16()
        w = qmatmul_ops.pack_qweight(
            torch.randint(-127, 128, (N, K), generator=gen, dtype=torch.int8).cuda())
        a = torch.tensor(float(x.float().abs().max()) / 127.0, device="cuda")
        s, b = (torch.rand(N, generator=gen) * 0.01).cuda(), torch.randn(N, generator=gen).cuda()
        for bias in (b, None):
            y, y_ref = qmatmul_ops.qmatmul(x, w, a, s, bias), qmatmul_ops.qmatmul_ref(x, w, a, s,
                                                                                       bias)
            torch.cuda.synchronize()
            if y.dtype != torch.bfloat16 or not torch.equal(y, y_ref):
                fail(f"P19a qmatmul bf16 ragged {(M, K, N)} (bias {bias is not None}): "
                     f"{bf16_ulps(y, y_ref)} ulps from qmatmul_ref; bit-equal required")
        print(f"P19a qmatmul bf16 ragged (M, K, N)={(M, K, N)}: bit-equal with and without a bias")
    rows = []
    for (M, K, N), calls in QMM_SHAPES:
        x = torch.randn(M, K, generator=gen).cuda().bfloat16()
        w_q = torch.randint(-127, 128, (N, K), generator=gen, dtype=torch.int8).cuda()
        w = qmatmul_ops.pack_qweight(w_q)
        a = torch.tensor(float(x.float().abs().max()) / 127.0, device="cuda")
        s = (torch.rand(N, generator=gen) * 0.01).cuda()
        b = torch.randn(N, generator=gen).cuda()
        x_q, w_t = qmatmul_ops.quantize_activation(x, a), w_q.t().contiguous()
        nx = 2 * (M * K + M * N)
        rows.append(bf16_row("qmatmul", (M, K, N), lambda: qmatmul_ops.qmatmul(x, w, a, s, b),
                             lambda: qmatmul_ops.qmatmul_ref(x, w, a, s, b),
                             lambda: torch._int_mm(x_q, w_t), True,
                             dict(bytes=nx + K * N + 4 * (2 * N + 1), flops=2 * M * N * K),
                             PEAK_INT8, weight=calls))
        del x, x_q
    return rows


def bf16_sum(label, rows):
    total = {k: sum(r[k] * r["calls"] for r in rows) for k in ("ms", "plain_ms", "bound_ms")}
    lib = [r["library_ms"] for r in rows]
    lib_s = (f"library {sum(t * r['calls'] for t, r in zip(lib, rows)):.4f} ms"
             if None not in lib else "no library call")
    print(f"P19a {label} in bf16 ({sum(r['calls'] for r in rows)} calls): kernel "
          f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, {lib_s}, bound "
          f"{total['bound_ms']:.4f} ms [{smi_line()}]")


def run_bf16_kernels():
    """P19a: each kernel in bf16 against its bf16 plain version at its path's
    shapes, timed beside its plain version, its bound and its library call in
    bf16.  Returns {kernel: rows}."""
    import torch

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(19)
    with uncounted():
        rows = dict(msca_fused=bf16_msca_rows(gen), parallel_cascade=bf16_cascade_rows(gen),
                    lowrank_conv=bf16_lowrank_rows(gen), qmatmul=bf16_qmatmul_rows(gen))
    bf16_sum("msca_fused per MSCAN-t d1+fix forward",
             [r for r in rows["msca_fused"] if r["form"] == "d1fix"])
    bf16_sum("parallel_cascade per ConvNeXt-T r1 forward",
             [r for r in rows["parallel_cascade"] if r["form"] == "r1"])
    bf16_sum("parallel_cascade per MSCAN-t dconv0 forward",
             [r for r in rows["parallel_cascade"] if r["form"] != "r1"])
    bf16_sum("lowrank_conv per dodecomp AlexNet forward", rows["lowrank_conv"])
    bf16_sum("qmatmul per int8 ConvNeXt-T forward", rows["qmatmul"])
    print(f"P19a in {time.perf_counter() - t0:.2f} s")
    return rows


def copies_beside_kernels(names):
    """(copy kernels in the list, copy kernels right before or after a port kernel):
    a cast or layout copy shows as an elementwise copy kernel."""
    port = [any(k in n for ks in KERNEL_NAMES.values() for k in ks) for n in names]
    copy = ["copy" in n.lower() for n in names]
    beside = sum(1 for i, c in enumerate(copy) if c and (
        (i > 0 and port[i - 1]) or (i + 1 < len(names) and port[i + 1])))
    return sum(copy), beside


def run_bf16_headline():
    """P19b: the headline d1+fix surface cast to bf16 (``cast_floating``) timed
    through ``InferenceTimeHook(bf16=True)`` at b=64, 224^2 (13 msca_fused
    launches per forward and per replay), its logits against the same bf16
    model through the plain versions and against the float32 surface, no copy
    kernel beside a port kernel in a profiled forward; dense MSCAN-t in bf16
    timed beside it.  Returns (msca_fused launches per forward, the bf16 surface)."""
    import copy
    from types import SimpleNamespace

    import torch

    from convnet_approximater_tpu_torch.hooks import InferenceTimeHook
    from convnet_approximater_tpu_torch.hooks.inference_time_hook import forward_times
    from convnet_approximater_tpu_torch.utils.dtype import cast_floating, serving_dtype

    t0 = time.perf_counter()
    base = mscan_base(random_norms=True)
    _, surface32 = serving_surface(base, False)
    surface = cast_floating(copy.deepcopy(surface32), torch.bfloat16)
    x = seeded_batch(192)
    xb = x.to(torch.bfloat16)
    reset_counts()
    with torch.no_grad():
        y = surface(xb)
    eager = kernel_counts()["msca_fused"]
    with torch.no_grad(), uncounted():
        plain_err = f32_rel(y, through_all_plain(surface, xb))
        f32_err = f32_rel(y, surface32(x))
    work = os.path.join(P19_DIR, "headline")
    runner = SimpleNamespace(model=surface, device=torch.device("cuda"),
                             cfg=SimpleNamespace(work_dir=work, config_name="bf16", name="bf16"))
    hook = InferenceTimeHook(runner, 50, infer_cfg=dict(input_size=INPUT, bf16=True))
    reset_counts()
    with forwards_counted(surface) as forwards:
        hook.after_run()
    per_forward = kernel_counts()["msca_fused"] / len(forwards)
    _, _, replay = captured(surface, xb)
    with torch.no_grad(), uncounted():
        names = kernels_of(lambda: surface(xb))
    copies, beside = copies_beside_kernels(names)
    print(f"P19b MSCAN-t headline surface in bf16 (serving type {serving_dtype(surface)}): "
          f"InferenceTimeHook(bf16=True) at {INPUT}: {hook.result['median_ms']:.3f} ms as a "
          f"graph back to back, eager median {hook.result['eager_median_ms']:.3f} ms "
          f"({BATCH / hook.result['median_ms'] * 1e3:.1f} img/s); msca_fused {per_forward:g} "
          f"per forward over {len(forwards)} forwards, {eager} in one eager forward, "
          f"{replay.get('msca_fused')} per replay; logits {tuple(y.shape)} {y.dtype} against "
          f"the bf16 model through the plain versions rel norm {plain_err:.3e} (bound "
          f"{BF16_REL_TOL}), against the float32 surface {f32_err:.3e}; a profiled forward: "
          f"{len(names)} kernels, {copies} copy kernels, {beside} beside a port kernel "
          f"[{smi_line()}]")
    if eager != 13 or per_forward != 13 or replay.get("msca_fused") != 13:
        fail("P19b: the bf16 headline surface does not launch msca_fused 13 times a forward")
    if not torch.isfinite(y.float()).all() or y.dtype != torch.bfloat16 or \
            plain_err > BF16_REL_TOL or beside:
        fail("P19b: the bf16 headline logits, or a copy beside a kernel")
    dense = cast_floating(copy.deepcopy(base), torch.bfloat16)
    reset_counts()
    t = forward_times(dense, INPUT, 10, 3, dtype=torch.bfloat16)
    t32 = forward_times(base, INPUT, 10, 3)
    s32 = forward_times(surface32, INPUT, 10, 3)
    print(f"P19b dense MSCAN-t in bf16: {t['ms']:.3f} ms as a graph back to back, eager median "
          f"{t['eager_median_ms']:.3f} ms, msca_fused {kernel_counts()['msca_fused']} launches "
          f"over {t['forwards']} forwards; dense bf16 over the bf16 surface "
          f"{t['ms'] / hook.result['median_ms']:.3f}x; in float32 in the same run: dense "
          f"{t32['ms']:.3f} ms, surface {s32['ms']:.3f} ms (graph back to back) [{smi_line()}]")
    print(f"P19b in {time.perf_counter() - t0:.2f} s")
    del dense, base, surface32
    torch.cuda.empty_cache()
    return per_forward, surface, hook.result["median_ms"]


def run_bf16_serve_mscan():
    """P19c: ``serve_mscan`` at its defaults (bfloat16, b=128, the dconv0
    surface) for P19_SERVE_BATCHES batches: 26 parallel_cascade per capture
    forward, img/s end to end against the graph back to back."""
    import torch

    from convnet_approximater_tpu_torch import serve_mscan
    from convnet_approximater_tpu_torch.utils.dtype import serving_dtype

    t0 = time.perf_counter()
    reset_counts()
    res = serve_mscan.main(["--batches", str(P19_SERVE_BATCHES)])
    launches = kernel_counts()["parallel_cascade"]
    b2b = back_to_back_ms(res["compiled"])
    device_ips = res["batch"] / b2b * 1e3
    print(f"P19c serve_mscan at its defaults ({serving_dtype(res['model'])}, b={res['batch']}, "
          f"{P19_SERVE_BATCHES} batches): {res['img_per_s']:.1f} img/s end to end against "
          f"{device_ips:.1f} img/s from the graph back to back ({b2b:.3f} ms per batch): the "
          f"host side (loader, H2D, the cast) costs "
          f"{max(0.0, 1 - res['img_per_s'] / device_ips):.1%}; "
          f"parallel_cascade {launches} launches in the capture's 4 forwards "
          f"[{smi_line()}]")
    if serving_dtype(res["model"]) != torch.bfloat16 or launches != 26 * 4:
        fail("P19c: serve_mscan did not serve bf16 through 26 parallel_cascade a forward")
    print(f"P19c in {time.perf_counter() - t0:.2f} s")
    out = dict(launches=launches, img_per_s=res["img_per_s"], b2b=b2b)
    del res
    torch.cuda.empty_cache()
    return out


def run_bf16_inference():
    """P19d: the inference CLI with ``--dtype bfloat16 --decomp --quantize
    int8`` on phase 5's dodecomp AlexNet at b=64: every report tagged
    ``/bfloat16``, lowrank_conv 4 per forward in approximated and decomposed,
    qmatmul once per int8 module per forward in int8.  Returns {tag: launches}."""
    import torch

    from convnet_approximater_tpu_torch import inference as inference_cli
    from convnet_approximater_tpu_torch.layers import QuantConv2d, QuantLinear
    from convnet_approximater_tpu_torch.runner import ClassInference

    t0 = time.perf_counter()
    ckpt = checkpoint_in(os.path.join(REPO, "build", "chip_smoke_alexnet"))
    seen = {}
    report = ClassInference._report

    def counted(self, tag, model):
        reset_counts()
        with forwards_counted(model) as forwards:
            report(self, tag, model)
        seen[tag] = dict(forwards=len(forwards), launches=kernel_counts())

    with mock.patch.object(ClassInference, "_report", counted):
        run = inference_cli.main(["--config", ALEX_DODECOMP, "--checkpoint", ckpt, "--batch",
                                  str(BATCH), "--decomp", "--quantize", "int8", "--dtype",
                                  "bfloat16", "--device", DEVICE, "--seed", "0", "--work-dir",
                                  os.path.join(P19_DIR, "inference")])
    int8_modules = sum(isinstance(m, (QuantConv2d, QuantLinear)) for m in run.new_model.modules())
    want = ["original/bfloat16", "approximated/bfloat16", "decomposed/bfloat16", "int8/bfloat16"]
    out = {}
    for (tag, r), s in zip(run.reports.items(), seen.values()):
        per = {k: v / s["forwards"] for k, v in s["launches"].items() if v}
        out[tag] = per
        print(f"P19d ClassInference report {tag}: {r['ms']:.3f} ms as a graph back to back "
              f"({BATCH / r['ms'] * 1e3:.1f} img/s), eager median {r['eager_ms']:.3f} ms, MACs "
              f"{r['macs'] / 1e6:.2f} M; launches per forward over {s['forwards']} forwards: "
              + (", ".join(f"{k} {v:g}" for k, v in per.items()) or "none"))
    if list(run.reports) != want or run.fold_bn is not True:
        fail(f"P19d: ClassInference(dtype='bfloat16') made the reports {list(run.reports)}")
    for tag in want[1:3]:
        if out[tag].get("lowrank_conv") != 4:
            fail(f"P19d {tag}: lowrank_conv {out[tag]} per forward, expected 4")
    if int8_modules == 0 or out[want[3]].get("qmatmul") != int8_modules:
        fail(f"P19d int8: qmatmul {out[want[3]]} per forward for {int8_modules} int8 modules")
    print(f"P19d in {time.perf_counter() - t0:.2f} s [{smi_line()}]")
    del run
    torch.cuda.empty_cache()
    return out


def run_bf16_export(surface):
    """P19e: the bf16 headline surface exported at b=64 (``deploy.export_serving``,
    as ``export_model`` writes it): bf16 avals, 13 msca_fused nodes and
    launches, the artifact's logits bit-equal to the live bf16 model's."""
    import torch

    from convnet_approximater_tpu_torch import deploy

    t0 = time.perf_counter()
    xb = seeded_batch(193).to(torch.bfloat16)
    loaded, export_s, load_s, size, _ = export_artifact("MSCAN-t headline bf16", surface, xb)
    ops = deploy.custom_op_counts(loaded)
    reset_counts()
    with torch.no_grad():
        y_art = loaded(xb)
    launches = kernel_counts()["msca_fused"]
    with torch.no_grad(), uncounted():
        y_live = surface(xb)
    same = torch.equal(y_art, y_live)
    avals = (loaded.in_avals[-1].dtype, loaded.out_avals[0].dtype)
    print(f"P19e the bf16 headline surface exported at b={BATCH}: export {export_s:.2f} s, load "
          f"{load_s:.2f} s, {size / 2 ** 20:.1f} MiB; avals in/out {avals}; custom-op nodes "
          f"{ops}, msca_fused {launches} per forward; logits against the live bf16 model "
          f"{'bit-equal' if same else 'NOT bit-equal'}; {time.perf_counter() - t0:.2f} s")
    if avals != (torch.bfloat16, torch.bfloat16) or ops != {"msca_fused": 13} or \
            launches != 13 or not same:
        fail("P19e: the bf16 artifact's avals, ops or logits differ from the live model's")
    del loaded
    torch.cuda.empty_cache()
    return launches


def run_bf16():
    """P19: bf16 serving, a-e.  Returns what the kernels line reads."""
    t0 = time.perf_counter()
    rows = run_bf16_kernels()
    headline, surface, headline_ms = run_bf16_headline()
    exported = run_bf16_export(surface)
    del surface
    serve = run_bf16_serve_mscan()
    inference = run_bf16_inference()
    print(f"P19 in {time.perf_counter() - t0:.2f} s")
    return dict(rows=rows, headline=headline, exported=exported, serve=serve,
                inference=inference)


def bf16_path(name, rows, **counts):
    """A kernels-line path entry of a kernel's bf16 form: its P19a rows per
    forward of their path (calls per forward as weights), the bound at 2-byte
    activations, the most error and ulps."""
    return dict(per_forward(rows, lambda r: r["calls"], dict(path=name, **counts)),
                max_abs_err=max(r["max_abs_err"] for r in rows),
                max_ulps=max(r["ulps"] for r in rows))


def rows_bound(rows, weight, peak: float = PEAK_F32):
    """(ms, "bytes" or "operations") of rows weighted by ``weight``; lowrank_conv's
    rows (``mix_flops``) with the mix on its 3xTF32 route."""
    nbytes = sum(r["bytes"] * weight(r) for r in rows)
    if "mix_flops" in rows[0]:
        return lowrank_bound(nbytes, sum(r["basis_flops"] * weight(r) for r in rows),
                             sum(r["mix_flops"] * weight(r) for r in rows))
    return bound(nbytes, sum(r["flops"] * weight(r) for r in rows), peak)


def per_forward(rows, weight, kernel, peak: float = PEAK_F32):
    """The kernels-line entry of one forward: rows weighted by calls per forward."""
    b_ms, b_by = rows_bound(rows, weight, rows[0].get("peak", peak))
    library = [r.get("library_ms") for r in rows]
    return dict(kernel, ms=sum(r["ms"] * weight(r) for r in rows),
                plain_ms=sum(r["plain_ms"] * weight(r) for r in rows),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=(None if None in library
                            else sum(t * weight(r) for t, r in zip(library, rows))))


class Laps:
    """Prints the wall time since the last lap (the first: since it was made)."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def __call__(self, label: str):
        now = time.perf_counter()
        print(f"wall time: {label} in {now - self.last:.2f} s")
        self.last = now

    def total(self) -> float:
        return time.perf_counter() - self.start


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA device")
    lap = Laps()
    if not all(os.path.isfile(os.path.join(REPO, PACKAGE, "csrc", s)) for s in SOURCES):
        fail(f"{PACKAGE}/ not found beside chip_smoke.py: run it from a checkout of the repository")
    sys.path.insert(0, REPO)

    # -- 1. the card ------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
          f"{torch.cuda.device_count()} device(s)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for cuDNN and matmul: the plain versions run in full float32")

    # -- 2. build ---------------------------------------------------------
    from convnet_approximater_tpu_torch.ops import build as build_ops
    from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops
    from convnet_approximater_tpu_torch.ops import parallel_cascade as cascade_ops
    from convnet_approximater_tpu_torch.ops import qmatmul as qmatmul_ops

    t0 = time.perf_counter()
    seconds = build_ops.build_all(SOURCES)
    for ops in (fused_ops, lowrank_ops, cascade_ops, qmatmul_ops):
        ops.build()
    print(f"built {', '.join(f'{s} in {t:.2f} s' for s, t in seconds.items())} "
          f"(one nvcc each, in parallel; {time.perf_counter() - t0:.2f} s in all)")
    print(f"ptxas, lowrank_conv.cu: {ptxas_summary('lowrank_conv.cu', 'lowrank_kernel')}")

    # -- 3. kernels against their plain versions at the main paths' shapes
    gen = torch.Generator().manual_seed(0)
    msca_rows = check_kernel(gen)
    lowrank_rows = check_lowrank_kernel(gen)
    cascade_rows = check_cascade_kernel(gen)
    qmm_rows = check_qmatmul_kernel(gen)
    resnet18_rows = check_lowrank_model_shapes(torch.Generator().manual_seed(4), "ResNet-18",
                                               RESNET18_CONVS, 4)
    vgg16_rows = check_lowrank_model_shapes(torch.Generator().manual_seed(5), "VGG-16",
                                            VGG16_CONVS, 16)

    lap("1.-3. the card, the build, the kernels against their plain versions")
    earlier = contextlib.ExitStack()  # phases 4-14: the hooks' graph slopes cut
    earlier.enter_context(hook_graphs_cut())

    # -- 4.-8. the main paths ---------------------------------------------
    msca_launches = run_mscan(gen)
    lowrank_launches = run_alexnet(gen, ALEX_DODECOMP, True,
                                   os.path.join(REPO, "build", "chip_smoke_alexnet"), extras=True)
    run_alexnet(gen, ALEX_SVD, False, os.path.join(REPO, "build", "chip_smoke_alexnet_full"),
                extras=False)
    check_lowrank_launches(torch.Generator().manual_seed(3))
    cascade_launches, qmm_launches = run_convnext(gen)
    run_mscan_dconv0(gen)
    run_headline()
    lap("4.-8. the main paths")

    # -- 9. gradients through eval-mode kernel layers ---------------------
    check_eval_grad(gen)
    lap("9. eval-mode gradients")

    # -- 10. fine-tuning: F1-F3 -------------------------------------------
    run_finetune()
    lap("10. F1-F3")

    # -- 11. P1-P4: ResNet-18 and VGG-16 scheme-1, int8 ResNet-50, MSCAN-t configs
    resnet18_launches = run_resnet18(gen)
    vgg16_launches = run_vgg16(gen)
    r50_launches, r50_rows = run_resnet50_int8(gen)
    fps_launches = run_mscan_configs()
    lap("11. P1-P4")

    # -- 12. P5-P8 and F4: V2-V4 with calibration, and QAT through int8 ---
    run_resnet18_v3(gen)
    run_vgg16_v234(gen)
    run_alexnet_v2(gen)
    qat_launches, qat_rows = run_qat_alexnet(gen)
    run_ft_v3_kd()
    lap("12. P5-P8, F4")

    # -- 13. P9-P12: width pruning ------------------------------------------
    pruning = run_pruning()
    lap("13. P9-P12")

    # -- 14. P13, F6 and P14: SegNeXt-T serving and fine-tuning, and CAM -----
    seg_launches, seg_rows = run_segnext(gen)
    ft_seg_launches = run_ft_seg()
    cam_launches = run_cam()
    lap("14. P13, F6, P14")
    earlier.close()

    # -- 15.-17. P15-P17: deploy mode and ClassInference, the arbiters, the planner
    t0 = time.perf_counter()
    p15_launches = run_deploy_round_trip()
    p15_reports, p15_int8 = run_inference_cli()
    lap("15. P15")
    t15 = time.perf_counter()
    p16_arbiter, p16_final = run_never_lose()
    p16_ffnrep = run_arbitrated()
    lap("16. P16")
    t16 = time.perf_counter()
    p17 = run_planner()
    lap("17. P17")
    t17 = time.perf_counter()
    print(f"P15-P17 on the graph timer: P15 {t15 - t0:.2f} s, P16 {t16 - t15:.2f} s (two calls "
          f"of each arbiter), P17 {t17 - t16:.2f} s (two calls of each plan); {t17 - t0:.2f} s "
          f"in all, against 40-55 s on the eager timer with one call each")

    # -- 18. P18: the ops on the card, exported surfaces, the symbolic batch, serving loops
    run_opcheck()
    p18 = run_exports()
    lap("18. P18")

    # -- 19. P19: bf16 serving --------------------------------------------
    p19 = run_bf16()
    lap("19. P19")
    print(f"wall time in all: {lap.total():.2f} s from the check for the card")

    # -- 18. results ------------------------------------------------------
    # each entry is one forward at b=64, 224^2: the time per call times the calls per forward
    # (parallel_cascade: the DwSepRep r1 forward of ConvNeXt-T; qmatmul: its int8 forward)
    blocks = {H: n for H, _, n in STAGES}
    kernels = [
        per_forward([r for r in msca_rows if r["form"] == "d1fix"],
                    lambda r: blocks[r["shape"][1]], dict(
                        name="msca_fused", route="cuda", source=f"{PACKAGE}/csrc/msca_fused.cu",
                        replaces="convnet_approximater_tpu/ops/pallas/msca_kernels.py:267",
                        launches=msca_launches,
                        max_abs_err=max(r["max_abs_err"] for r in msca_rows))),
        per_forward([r for r in lowrank_rows if r["form"] == "sep"], lambda r: 1, dict(
            name="lowrank_conv", route="cuda", source=f"{PACKAGE}/csrc/lowrank_conv.cu",
            replaces="convnet_approximater_tpu/ops/pallas/lowrank_kernels.py:123",
            launches=lowrank_launches,
            max_abs_err=max(r["max_abs_err"] for r in lowrank_rows))),
        per_forward([r for r in cascade_rows if r["form"] == "r1"], lambda r: r["blocks"], dict(
            name="parallel_cascade", route="cuda", source=f"{PACKAGE}/csrc/parallel_cascade.cu",
            replaces="convnet_approximater_tpu/ops/pallas/msca_kernels.py:173",
            launches=cascade_launches,
            max_abs_err=max(r["max_abs_err"] for r in cascade_rows))),
        per_forward(qmm_rows, lambda r: r["calls"], dict(
            name="qmatmul", route="cuda", source=f"{PACKAGE}/csrc/qmatmul.cu",
            replaces="scripts/exp_pallas_qmatmul.py:61", launches=qmm_launches,
            max_abs_err=max(r["max_abs_err"] for r in qmm_rows)), peak=PEAK_INT8),
    ]
    # the later paths' launches and per-forward sums, beside the first path's
    calls = lambda r: r["calls"]  # noqa: E731
    path_keys = ("launches", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels[0]["paths"] = [dict(path="MSCAN-t MscaRep d1 under Fps", launches=fps_launches)]
    kernels[1]["paths"] = [
        {k: v for k, v in dict(per_forward(rows, calls, dict(launches=launches)), path=path)
         .items() if k in path_keys + ("path",)}
        for path, rows, launches in (("ResNet-18 scheme-1", resnet18_rows, resnet18_launches),
                                     ("VGG-16 scheme-1", vgg16_rows, vgg16_launches))]
    kernels[3]["paths"] = [
        {k: v for k, v in dict(per_forward(rows, calls, dict(launches=launches),
                                           peak=PEAK_INT8), path=path).items()
         if k in path_keys + ("path",)}
        for path, rows, launches in (("int8 ResNet-50", r50_rows, r50_launches),
                                     ("int8 QAT AlexNet", qat_rows, qat_launches))]
    # P9-P12, the width-pruned paths
    p_msca, p_cascade = pruning["rows"]
    p10_launches, p11 = pruning["p10"][0], pruning["p11"]
    blocks = lambda r: r["blocks"]  # noqa: E731

    def path(name, rows, weight, launches, peak=PEAK_F32):
        entry = dict(per_forward(rows, weight, dict(launches=launches), peak=peak), path=name)
        return {k: v for k, v in entry.items() if k in path_keys + ("path",)}

    kernels[0]["paths"] += [
        dict(path="MSCAN-t FfnPrune(0.75) config (P9)", launches=pruning["p9"]),
        path("pruned MSCAN-t quad, MscaRep d1+fix (P10)", p_msca, blocks,
             p10_launches["pruned d1+fix"])]
    kernels[2]["paths"] = [
        path("pruned MSCAN-t quad, MscaRep dconv0 (P10)", p_cascade[:8], blocks,
             p10_launches["pruned dconv0"]),
        path("pruned ConvNeXt-T quad, DwSepRep r1 (P11)", p_cascade[8:], blocks, p11[0])]
    kernels[3]["paths"] += [path("pruned int8 ConvNeXt-T (P11)", p11[2], calls, p11[1], PEAK_INT8)]
    kernels[3]["paths"] += [path(f"{name} (P12)", rows, calls, launches, PEAK_INT8)
                            for name, launches, rows in pruning["p12"]]
    kernels[0]["paths"] += [
        path("SegNeXt-T MscaRep d1+fix, b=16, 512^2 (P13)",
             [r for r in seg_rows if r["form"] == "d1fix"], blocks, seg_launches),
        dict(path="SegNeXt-T L2 fine-tune, 4 steps and 2 validation batches (F6)",
             launches=ft_seg_launches),
        dict(path="CAM CLI on MSCAN-t, 24 heatmaps (P14)", launches=cam_launches)]
    # P15-P17: the deploy paths, each with its launches (per forward where it says so)
    p17_mscan, p17_convnext = p17["MSCAN-t"]["per_forward"], p17["ConvNeXt-T"]["per_forward"]

    def planned(name, per, cand, kernel):
        return dict(path=f"plan_serving {name} candidate {cand}, per forward (P17)",
                    launches=per.get(cand, {}).get(kernel))

    kernels[0]["paths"] += [
        dict(path="MSCAN-t d1+fix deploy run of its checkpoint (P15)", launches=p15_launches),
        dict(path="arbitrated_apply(FfnRep) on MSCAN-t d1+fix, its timed forwards (P16)",
             launches=p16_ffnrep),
        planned("MSCAN-t", p17_mscan, "dense/float32", "msca_fused")]
    kernels[1]["paths"] += [
        dict(path=f"ClassInference AlexNet report {tag}, 18 forwards (P15)",
             launches=p15_reports[tag]["lowrank_conv"])
        for tag in ("approximated", "decomposed", "never-lose")] + [
        dict(path="never_lose_deploy on VGG-16 scheme-1, its timed forwards (P16)",
             launches=p16_arbiter),
        dict(path="VGG-16 after never_lose_deploy, per forward (P16)", launches=p16_final)]
    kernels[2]["paths"] += [
        planned("MSCAN-t", p17_mscan, "mscarep/d1+fix+dconv0+arb-ffnrep", "parallel_cascade"),
        planned("ConvNeXt-T", p17_convnext, "dwsep/r=1", "parallel_cascade")]
    kernels[3]["paths"] += [
        dict(path=f"ClassInference AlexNet report int8, 18 forwards, {p15_int8} int8 modules "
                  f"(P15)", launches=p15_reports["int8"]["qmatmul"]),
        planned("MSCAN-t", p17_mscan, "int8", "qmatmul"),
        planned("ConvNeXt-T", p17_convnext, "int8", "qmatmul")]
    # P18: the exported artifacts (launches per eager forward of the loaded program) and the
    # serving loops (launches in the run: the captures' forwards; replays launch uncounted)
    kernels[0]["paths"] += [
        dict(path="exported MSCAN-t headline surface at b=64, per forward (P18b)",
             launches=p18["MSCAN-t headline surface"]["msca_fused"]),
        dict(path="MSCAN-t headline artifact with a symbolic batch, the captures at b = 1, 2, "
                  "64, 65 (P18c)",
             launches=p18["MSCAN-t headline symbolic batch, 4 batch sizes"])]
    kernels[1]["paths"] += [
        dict(path="exported dodecomp AlexNet (export_model), per forward (P18b)",
             launches=p18["AlexNet dodecomp artifact"]["lowrank_conv"])]
    kernels[2]["paths"] += [
        dict(path="exported MSCAN-t dconv0 surface at b=128, per forward (P18b)",
             launches=p18["MSCAN-t dconv0 surface"]["parallel_cascade"]),
        dict(path="serve_mscan at b=128, 32 batches: the capture's 4 forwards (P18d)",
             launches=p18["serve_mscan, b=128, 32 batches"])]
    kernels[3]["paths"] += [
        dict(path="exported int8 ResNet-50 (export_model --quantize int8), per forward (P18b)",
             launches=p18["int8 ResNet-50 artifact"]["qmatmul"])] + [
        dict(path=f"{k}: the capture's 4 forwards (P18d)", launches=v)
        for k, v in p18.items() if k.startswith("serve int8 ResNet-50")]
    kernels[0]["max_abs_err"] = max([kernels[0]["max_abs_err"]] +
                                    [r["max_abs_err"] for r in p_msca + seg_rows])
    kernels[1]["max_abs_err"] = max([kernels[1]["max_abs_err"]] + [
        r["max_abs_err"] for r in resnet18_rows + vgg16_rows])
    kernels[2]["max_abs_err"] = max([kernels[2]["max_abs_err"]] +
                                    [r["max_abs_err"] for r in p_cascade])
    kernels[3]["max_abs_err"] = max([kernels[3]["max_abs_err"]] + [
        r["max_abs_err"] for r in r50_rows + qat_rows + p11[2]
        + [r for _, _, rows in pruning["p12"] for r in rows]])
    # P19: each kernel's bf16 form, per forward of its path, beside its float32 paths
    bf16 = p19["rows"]
    # (where the bf16 path a CLI runs has other shapes than P19a's rows, the rows stand alone,
    # with their calls per forward, and the CLI path's launches beside them)
    cascade_bf16 = lambda r1: [r for r in bf16["parallel_cascade"] if (r["form"] == "r1") == r1]  # noqa: E731,E501
    kernels[0]["paths"] += [
        bf16_path("bf16: MSCAN-t d1+fix at b=64, 224^2 (P19a rows), launches per forward of the "
                  "same bf16 surface under InferenceTimeHook(bf16=True) (P19b)",
                  [r for r in bf16["msca_fused"] if r["form"] == "d1fix"],
                  launches=p19["headline"]),
        dict(path="bf16: the exported headline surface, per forward (P19e)",
             launches=p19["exported"])]
    kernels[1]["paths"] += [
        bf16_path("bf16: dodecomp AlexNet's 4 sites at b=64, 224^2 (P19a rows), launches per "
                  "forward of the same model in ClassInference approximated/bfloat16 (P19d)",
                  bf16["lowrank_conv"],
                  launches=p19["inference"]["approximated/bfloat16"]["lowrank_conv"])]
    kernels[2]["paths"] += [
        bf16_path("bf16: MSCAN-t dconv0 cascades at b=64, 224^2 (P19a, the kernel alone)",
                  cascade_bf16(False), launches=None,
                  calls_per_forward=sum(r["calls"] for r in cascade_bf16(False))),
        dict(path="bf16: serve_mscan at its defaults, b=128: the capture's 4 forwards (P19c)",
             launches=p19["serve"]["launches"]),
        bf16_path("bf16: ConvNeXt-T DwSepRep r1 at b=64, 224^2 (P19a, the kernel alone)",
                  cascade_bf16(True), launches=None,
                  calls_per_forward=sum(r["calls"] for r in cascade_bf16(True)))]
    kernels[3]["paths"] += [
        bf16_path("bf16: int8 ConvNeXt-T's 13 shapes at b=64, 224^2 (P19a, the kernel alone)",
                  bf16["qmatmul"], launches=None,
                  calls_per_forward=sum(r["calls"] for r in bf16["qmatmul"])),
        dict(path="bf16: ClassInference int8/bfloat16 on the dodecomp AlexNet, per forward "
                  "(P19d)", launches=p19["inference"]["int8/bfloat16"]["qmatmul"])]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
