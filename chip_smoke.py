"""GPU smoke test of convkan_tpu_torch: serves and trains KAN-VGG16_small,
with B-spline KAN convs, with WavKAN convs, with ChebyKAN convs and with
GRAMKAN convs, then the B-spline model as train.py builds it (BatchNorm2d,
also served with its norms folded), trains BASELINE config 4's WavKAN
stack at batch 2048, serves and trains KAN-MobileNetV3-small at 224 x 224
(config 5's single-chip model) with FastKAN, B-spline (hardswish) and
ChebyKAN convs, serves and trains KAN-EfficientNetV2-s at 224 x 224
(config 5's other half, with remat and stochastic depth) with FastKAN and
B-spline convs, and serves and trains KAN-VGG16_small with each of the ten
static bases (Jacobi, Bernstein, Bessel, Fibonacci, Fourier, Gegenbauer,
Hermite, Laguerre, Lucas, Taylor) and with Legendre's (the plain route),
on one CUDA card through the hand-written kernels and checks every step.

    python3 chip_smoke.py

Phases (the first failed check exits non-zero):
  1. setup: the card's name and power limit, TF32 off, the kernels built
     from csrc/ (one nvcc per source, started together; build time and the
     compiler's register/spill report);
  2. kernel vs its plain PyTorch version on the card, at the 9 distinct
     VGG16_small conv shapes (batch 64), a batch-1 case, an input scaled
     to +-3 with exact knot values, a GELU case, and the tile's ragged
     edges (batch 1023, O = 48, C = 5, 1x1 and 3x3 planes, the 2x2 layer
     at batch 1024 with its channel splits) (rtol = atol = 1e-4: float32
     sums of up to 10,368 products taken in another order);
  3. the model: VGG16_small with seeded weights on the card against the
     same state_dict on the CPU (logits within 1e-3, and not the same for
     every image), 13 launches per forward;
  4. serving, the main path: launch counts are zeroed, an InferenceEngine
     with buckets (1, 8, 64) starts, the HTTP server answers 8 concurrent
     clients x 4 single-image requests and one 64-image request, the
     answers are checked against engine.predict, and the counts are read;
  5. times with CUDA events: predict at batch 1024 (images/s) and, per conv
     shape at batch 1024, the kernel, its plain version, one cuDNN conv over
     a materialized basis (a yardstick the port never calls), the bound on
     the (pixel, tap) pairs whose input lies in the image and the rows of
     E non-zero at x (SPAN_ROWS; the dense bound, every pair and row,
     beside it) and the share of the bound the kernel reaches;
  6. backward kernels vs their plain versions on the card, at the 9
     VGG16_small conv shapes (batch 64), ragged shapes (C = 13 with O = 5,
     O = 48, batch 1023; for the data-gradient tile batches 37 and 41 on
     4x4 and 3x3 planes, odd H, kernel 5 with pad 2, pad 0, and kernels
     37 x 37 whose tiles are the fallbacks at the edge of shared memory:
     32 pixel slots, and 64 or 32 without the table of g offsets) and the 2x2
     layer at batch 1024, and a GELU case; each case prints its
     data-gradient tile, its weight-gradient tile and its reduction's
     launch (VW, Gw, Gc, blocks): each kernel wrapper (data gradient,
     weight-gradient partials, their reduction) and the autograd path's
     dx, d base_w, d poly_w, against float64 autograd of the plain version
     (tolerance at BWD_TOL); the reduction bit-exact against its plain
     version in the kernel's grouped order, and the reduced dW against
     float64 (BWD_TOL);
  7. training, the main path: launch counts are zeroed, three train steps
     of VGG16_small (batch 16, dropout 0.5 at the head) run on the GPU and
     on the CPU from one state_dict with the same crop offsets, flips and
     dropout masks; losses and parameter updates are compared, the GPU's
     first-step gradients against the same step in float64 on the CPU
     (GRAD_TOL), every KAN conv's poly_w gradient must be non-zero, a
     control (the readings of a step that did not update, and of a zero
     gradient) must fail those checks (so in every train phase), and
     the counts read: per step 13
     forward, 12 data-gradient (the first conv's input is the image), 13
     weight-gradient and 13 reduction launches;
  8. times: the train step at batch 1024 (images/s, median of 12 steps
     after warm-up, each ending in a host readback of the loss) and, per
     conv shape at batch 1024, each backward kernel, its plain version,
     one cuDNN convolution_backward over a materialized basis (a yardstick
     the port never calls), the bound (as phase 5's) and the dense bound;
     for the data gradient also its tile (skip or dense TH/NB, NG, CC, OC,
     stages, table, blocks), the multiply-adds it issues over those of the
     interior pairs with every row, the share of the bound it reaches and
     its rate on issued work; for the weight gradient its tile (CC, BN, PW,
     threads, S, blocks), the same issued/interior, the share and the
     rate; for the
     reduction, first its result on
     these batch-1024 partials bit-exact against its plain version and two
     calls bit-identical, then its launch, its time beside sum(0)'s on a
     cold L2 (the share of the bound) and on a warm one.
WavKAN (the psi-conv kernels, mexican_hat unless a case says otherwise):
  9. forward kernel vs its plain version (rtol = atol = TOL): the 9
     VGG16_small shapes at batch 64, all 5 wavelets at one shape and on
     each compiled width (8x8, 4x4, 2x2), batch 1, ragged shapes (odd
     planes on the generic strips, C = 13 and 20: not a multiple of the
     chunk, O = 5 and 9: not of 4), pads 0 and 2, x scaled to +-3, and the
     three BASELINE config-4 shapes 3->32@32x32, 32->64@16x16,
     64->128@8x8; translation and scale moved off their 0 / 1 init; two
     calls bit-identical in every case, each case's launch (FWD_TILE)
     printed;
 10. backward kernels (data gradient, parameter partials, reduction) and
     the autograd path's dx, dw, dt, ds against float64 autograd of the
     plain version (BWD_TOL; the reduction bit-exact against its grouped
     plain version, the reduced dw/dt/ds against float64 at BWD_TOL), at
     the 9 VGG16_small shapes (the parameter kernel's compiled row widths
     32, 16, 8, 4, 2; the data gradient's 8, 4, 2), all 5 wavelets (also
     on the data gradient's compiled 4x4 and 2x2 rows), and the generic
     rows and ragged tiles (W = 5, 7, 11; C = 13, 5, 3; H = 1, 3, 5; O = 5,
     9, 20; pads 0 and 2); the data gradient and the parameter partials of
     two calls bit-identical; each case prints both kernels' launches
     (DX_TILE, PARAM_TILE);
 11. the WavKAN VGG16_small (head on the last 2x2 map, see WAV_MODEL):
     logits on the GPU vs the CPU (MODEL_TOL), 13 forward launches;
 12. serving, the main path, as phase 4 with the WavKAN model (served
     logits vs predict within MODEL_TOL);
 13. training, the main path, as phase 7 with the WavKAN model, but each
     GPU step starts from the CPU run's state before it (in float32 the
     model's three-step trajectory is chaotic: two float32 runs that sum
     in other orders part by more than LOSS_RTOL by the third step; and
     the CPU's is reproducible, the GPU's not: cuDNN), and
     every step's GPU gradients are held to float64 from the same start:
     per step 13 forward, 12 data-gradient, 13 parameter and 13 reduction
     launches, and every conv's wavelet_w, scale and translation gets a
     gradient;
 14. times: predict and the train step at batch 1024 (images/s) and, per
     conv shape at batch 1024, each WavKAN kernel, its plain version, one
     cuDNN grouped convolution (forward, or convolution_backward) over a
     materialized psi (a yardstick the port never calls) and the bound;
     for the forward also its result at batch 1024 (one band of RB = H
     rows, the launch the train step and predict run) against its plain
     version on the same inputs (TOL) and two calls bit-identical, its
     launch (compiled width, strip width, output
     channels and tile slots of a block, band rows, bands, threads,
     blocks, blocks per SM, waves, shared memory), the psi and tap FMAs it
     issues over the interior ones, the share of the bound and its rate
     on issued taps, and the 13-conv forward at batch 1 (the serving
     path's small batches); for the parameter kernel also its launch (channels per thread,
     threads, row slots, rows per step, pipeline, compiled width, splits,
     blocks, blocks per SM, waves, shared memory), and for the data
     gradient its (compiled width, pixels x rows of a tile, channel
     groups, tile positions and images of a block, threads, blocks, blocks
     per SM, waves, shared memory): each with the (pixel, tap, o, c) it
     issues over the interior ones, the share of the bound it reaches
     and its rate on issued work; the reduction as in phase 8, and an
     empty kernel's time (the launch floor).  The issued work (and the
     rates and *_over_interior ratios taken from it) is modelled from the
     launch configuration (wav_fwd_issued, wav_dx_issued, param_issued,
     dx_pairs), not counted on the card; the forward's model is held
     against a replay of the kernel's loops by
     tests/test_torch_wav_fwd_kernel.py.
ChebyKAN (the KAN-conv kernels' Chebyshev instantiations, degree 3, no
base path; the phases reuse the KAN phases' functions with the basis
descriptor):
 15. the forward kernel against its plain version (TOL), the data gradient
     and the reduced weight gradient against float64 autograd of the plain
     version (BWD_TOL; the reduction bit-exact against its grouped plain
     version; the autograd path's dx and d poly_w too) at the 9 VGG16_small
     shapes at batch 64 (and the weight-gradient partials split by split),
     once more at batch 1024 (the tiles the step launches), and with |x| up
     to 10 (the clamp of tanh holds t: dx exactly 0 there); every kernel's
     result of two calls bit-identical;
 16. the ChebyKAN VGG16_small (head on the last 2x2 map, see CHEBY_MODEL):
     logits of the GPU and of the CPU in float32 against the CPU in float64
     (the GPU within CHEBY_F32 times the CPU's distance + MODEL_TOL: the
     model's float32 logits are worse conditioned than MODEL_TOL), 13
     forward launches;
 17. serving, the main path, as phase 4 (served logits vs predict within
     phase 16's tolerance);
 18. training, the main path, as phase 13 (three steps in lockstep, every
     step's gradients held to float64): per step 13 forward, 12
     data-gradient, 13 weight-gradient and 13 reduction launches;
 19. times: predict and the train step at batch 1024 (images/s) and, per
     conv shape at batch 1024, each Chebyshev kernel (forward, data
     gradient, weight gradient, reduction) as phases 5 and 8 time the
     B-spline's, with bounds over all 4 rows (every T_n is non-zero), and
     the 13-conv forward at batch 1.
GRAMKAN (the KAN-conv kernels' Gram instantiations, degree 3, SiLU on every
row, a base path, and the learnable operand beta (4 values) read by every
kernel from device memory; the data-gradient kernel also writes beta's
gradient in per-block partials, reduced by the same ordered reduction):
 20. the forward kernel against its plain version (TOL), the data
     gradient, the reduced weight gradient and beta's partials and reduced
     gradient against float64 autograd of the plain version (BWD_TOL; beta's
     within DBETA_TOL of the sum of |terms| it adds, entries 0 and 3
     exactly 0), the launch that stores no dx (the first conv's) and the
     autograd path's beta gradient bit-identical to them, at the 9
     VGG16_small shapes at batch 64 and once more at batch 1024, beta at
     GRAM_BETA_SCALE times its init std; every kernel's result of two
     calls bit-identical;
 21. the GRAMKAN VGG16_small (train.py's (1, 1) head: SiLU follows each
     norm, so the logits see the image): logits on the GPU vs the CPU
     (MODEL_TOL; its float32 logits lie within 1e-5 of float64 on the
     CPU, tools/f32_spread.py), 13 forward launches;
 22. serving, the main path, as phase 4;
 23. training, the main path, as phase 7 (first-step gradients of every
     parameter, beta_weights included, against float64), with beta's
     entries 0 and 3 exactly 0 in every conv: per step 13 forward, 13
     data-gradient (the first conv's for beta alone), 13 weight-gradient
     and 26 reduction launches (dW and beta per conv);
 24. times: predict and the train step at batch 1024 (images/s) and, per
     conv shape at batch 1024, each Gram kernel as phase 19 times the
     Chebyshev ones, with bounds over all 5 rows (the data gradient's adds
     its beta terms) and beta's reduction timed with dW's, and the 13-conv
     forward at batch 1.
BatchNorm, path A (PATH_A: KAN-VGG16_small as train.py builds it, B-spline
grid 5 order 3, --kan_norm_layer BatchNorm2d, the (1, 1) head; the
B-spline kernels):
 25. the model on the GPU vs the CPU from one state_dict, a train-mode
     forward (batch statistics, the same head dropout mask) then an
     eval-mode one (running statistics): logits within MODEL_TOL, the
     running statistics within STATS_TOL, 13 forward launches each;
 26. training, the main path, as phase 7 in lockstep, and each step's
     running statistics GPU vs CPU (STATS_TOL); each gradient within
     GRAD_TOL of float64, or within F32_SPREAD x the spread float32 itself
     shows at the same start (see F32_NOISE): per step 13 forward, 12
     data-gradient, 13 weight-gradient and 13 reduction launches;
 27. serving, the main path, as phase 4 from phase 26's trained state,
     without and with its 13 BatchNorms folded into the conv weights
     (fold_batch_norms, what serve.py --fold_bn runs): served logits vs the
     CPU's eval logits and folded vs unfolded (MODEL_TOL), 13 launches per
     forward folded too; the serving CLI's --fold_bn against its unfolded
     engine (seeded); then predict at batch 1024 unfolded and folded and
     the train step at batch 1024 beside phase 8's InstanceNorm one.
BASELINE config 4, path B (bench.py's stack: three WavKANConv2DLayers
3->32@32x32, 32->64@16x16, 64->128@8x8, mexican_hat, BatchNorm, 2x2
max-pools, average pool, Linear 100; CIFAR-100 at batch 2048):
 28. the WavKAN kernels at the three shapes at batch 64 and 2048 against
     their plain versions: forward (TOL), data gradient, parameter partials,
     reduction and the autograd path against float64 (BWD_TOL; references
     over chunks of CONFIG4_CHUNK images), two calls bit-identical;
 29. training, the main path, three steps of the stack in lockstep at
     batch CONFIG4_CHECK_BATCH GPU vs CPU (losses, gradients vs float64,
     updates, running statistics): per step 3 forward, 2 data-gradient, 3
     parameter and 3 reduction launches;
 30. times: the train step at batch 2048 (images/s, median of 12 after 3
     warm-up steps, peak memory; its 15 steps' launches asserted) and, per
     shape at batch 2048, each WavKAN kernel as phase 14 times them (entries
     named with CONFIG4_SUFFIX).
KAN-MobileNetV3-small, path C (train.py --model MobileNetV3KAN --arch
small --imagenet_preprocessing; width 1.0, 224 x 224, 10 classes; its 22
1x1 KAN convs on the kernels, the strided stem on the plain route;
FastKAN's 23 convs all on the plain route):
 31. the kernels at its 17 distinct 1x1 shapes (k = 1, pad 0, batch 64),
     B-spline with hardswish and Chebyshev: forward against the plain
     version (TOL), the backward kernels and the autograd path against
     float64 (BWD_TOL), the reductions bit-exact; x scaled to +-4 with the
     knots and the hardswish kinks -3, 3 among its values once;
 32. the KAN, ChebyKAN and FastKAN models seeded on the CPU, their curved
     basis terms scaled to MNV3_CURVE (float32 is badly conditioned at the
     init: see MNV3_CURVE) and their running statistics set to a batch's,
     moved to the card: eval logits at batch 4 against the CPU (MODEL_TOL)
     and not the same for every image, 22 forward launches and 1
     plain-route conv per forward (FastKAN: 0 and 23);
 33. serving, the main path, with FastKAN and KAN convs: the serving
     CLI's engine with a state made as phase 32's behind the HTTP server (3
     single-image requests and one of 4 images of 224 x 224 uint8) against
     predict and the CPU (MODEL_TOL) with its launches counted, and the
     same argv as ``python -m convkan_tpu_torch.serve`` in a process of
     its own against predict of the same seeded weights;
 34. training, the main path: three train steps per family (imagenet=True,
     augment=False, AdamW with steps_per_epoch 100; curved terms at
     MNV3_CURVE) in lockstep GPU vs CPU at batch 8, as phase 26 holds them
     (losses, gradients against float64 within GRAD_TOL or F32_SPREAD x
     float32's spread, updates, running statistics, the control), 22
     launches of each kernel and 1 plain route per step;
 35. times: bench.py's config-5 train step at batch 512 (median of 12
     after 3 warm-up steps, host readback; peak memory; the 15 steps'
     launches) and predict at batch 512, per family; each KAN-conv kernel
     per 1x1 shape at batch 512 (entries named with MNV3_SUFFIX) against
     its bound (pixels x the rows of E non-zero at x, or bytes), its plain
     version and cuDNN over a materialized basis; the step's time outside
     the kernels.
KAN-EfficientNetV2-s, path D (bench.py's config-5 EfficientNetV2, train.py
--model EfficientNetV2KAN --arch s; 224 x 224, 10 classes, remat; its 77
stride-1 KAN convs on the kernels, the 38 projections with the identity
base path (the B-spline and Gram instantiations of base_activation=None),
its 3 strided KAN convs on the plain route; FastKAN's 80 all on the plain
route):
 36. the identity instantiations (B-spline, Gram with beta) at each of its
     20 distinct kernel shapes (3x3 at 112x112, 56x56, 28x28; 1x1 up to
     C = O = 1536) at batch 8, and the SiLU B-spline at the shapes no
     earlier path reached (112x112, C or O >= 768): forward against the
     plain version (TOL), the backward kernels and the autograd path
     against float64 (BWD_TOL; beta's partials as phase 20), the reductions
     bit-exact;
 37. the KAN and FastKAN EfficientNetV2-s (curved terms at MNV3_CURVE,
     running statistics set to a batch's) and the GRAMKAN kan_tiny (32 x
     32) seeded on the CPU and moved to the card: eval logits GPU vs CPU
     (MODEL_TOL) and not the same for every image; 77 kernel forwards and 3
     plain routes per forward (FastKAN 0 and 80, kan_tiny 9 and 2);
 38. serving, the main path, as phase 33, with ``--model EfficientNetV2KAN
     --arch s`` (FastKAN and KAN): the CLI's engine over HTTP and the CLI
     itself as a subprocess;
 39. training, the main path: three train steps of the GRAMKAN s model
     and of the B-spline one (curved terms at MNV3_CURVE; remat,
     stochastic depth EFFV2_SD) at batch EFFV2_TRAIN_BATCH of
     EFFV2_TRAIN_SIZE x EFFV2_TRAIN_SIZE images in lockstep GPU vs CPU, as
     phase 34 holds them (losses, updates, running statistics, the
     control; GRAMKAN's every-step gradients against float64, within
     GRAD_TOL or F32_SPREAD x float32's spread, beta's entries 0 and 3
     exactly 0; the B-spline model's gradients printed, not held: see
     EFFV2_TRAIN; its 77 kernel convs' kernels on its first step's own
     tensors, with remat, within BWD_TOL of float64); per step 153 forward
     launches (the blocks' recompute runs 76 of the 77 again), 77
     data-gradient and weight-gradient launches, 77 reductions (Gram 154),
     5 plain routes; then GPU remat=True against
     remat=False from one start (DropPath masks and running statistics
     equal, gradients within REMAT_TOL; a plain torch.utils.checkpoint
     wrapper, the control, must fail);
 40. times: bench.py's config-5 EfficientNetV2 step at batch
     EFFV2_TIME_BATCH (FastKAN, and KAN on the kernels; with remat and
     without; median of EFFV2_STEPS after EFFV2_WARMUP, peak memory, the
     launches) and predict at that batch; each KAN-conv kernel per shape
     (entries named with EFFV2_SUFFIX: the identity B-spline and Gram at
     the projections' shapes, the SiLU B-spline at the others') against
     its bound, its plain version and cuDNN over a materialized basis; the
     KAN step's time outside the kernels.
KAN-VGG16_small with the static bases, path E (train.py --model VGGKAN
--arch VGG16_small --kan_conv <key> for the ten keys of STATIC_FAMILIES:
base_activation "silu", degree 3, Fourier's grid 5, InstanceNorm, the
(1, 1) head; the KAN-conv kernels' five static instantiations, codes 7-11
of csrc/kan_basis.cuh: Recur3<4, SiLU> for Bessel, Fibonacci, Gegenbauer,
Hermite, Laguerre and Lucas, their coefficients passed as parameters,
Recur3<4, identity> for Jacobi, Recur3<3, SiLU> for Taylor, Bernstein<3>,
Fourier<5, SiLU>; LegendreKAN on the plain route):
 41. each family's instantiation at the 9 distinct VGG16_small shapes at
     batch 64 (and, for the family each instantiation is timed with, the
     first and last shapes at batch 1024), x U(-2, 2): the forward against
     the plain version (TOL), the backward kernels and the autograd path
     against float64 (BWD_TOL), the reductions bit-exact, two calls
     bit-identical; the exact zeros kept (STATIC_ZERO: Bernstein's rows
     have a derivative of exactly 0, Fibonacci's row 0 and Gegenbauer's
     rows 1-3 at alpha_param 0 are 0: with those rows of poly_w zeroed the
     data gradient, and where the value is 0 the forward, are
     bit-identical, and their weight-gradient rows exactly 0);
 42. each family's seeded model (and LegendreKAN's) at batch 1024 on the
     card: the logits of the first STATIC_MODEL_CHECK images against the
     CPU's float32 and float64 (the GPU within CHEBY_F32 x the CPU float32's
     distance + MODEL_TOL), not the same for every image, 13 forward
     launches of the family's basis (launches_by_basis; LegendreKAN: 13
     plain-route convs, no launch); predict at batch 1024 (images/s);
 43. serving, the main path, as phase 4 for each of the ten (served logits
     vs predict within phase 42's tolerance), only the family's basis
     launched;
 44. training, the main path: three lockstep steps of each family's model
     (FourierKAN's poly_w at STATIC_CURVE) GPU vs CPU as phase 26 holds
     them (losses, every gradient but the PReLU slopes, STATIC_UNHELD,
     within GRAD_TOL of float64 or F32_SPREAD x float32's spread at the
     same start, the slopes' readings printed; updates; the control): per
     step 13 forward, 12 data-gradient, 13 weight-gradient and 13
     reduction launches, all of the family's basis (LegendreKAN: 13
     plain-route convs per step);
 45. times: each family's train step at batch 1024 (median of 12 after 3)
     and, per conv shape at batch 1024, each kernel of the five
     instantiations (entries named "[static <tag>]", STATIC_TAGS; each
     timed with the family of STATIC_TIMED) against its plain version,
     cuDNN over a materialized basis and the bound over every row of E
     (the dense rows: every row of these bases is computed).
Every time is device time from CUDA events in a preloaded queue (cuda_ms:
a sleep kernel holds the card until the host has issued all timed calls);
a kernel's timing that the host held back fails, any other is listed
under "host_bound" in its kernel's entry.

Prints a {"kernels": [...]} line, then the contract line
{"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import collections
import copy
import functools
import itertools
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

PEAK_FP32_FLOPS = 67e12     # H100 SXM, FP32 outside the tensor cores, 700 W
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
# rows of the expanded input E = [B_0(x) .. B_{K-1}(x), act(x)] that a
# (pixel, channel) needs: the ORDER + 1 = 4 B-splines that are non-zero on
# x's knot span (every x of the timed inputs, U(-1, 1), lies inside the
# grid) and act(x).  The KAN-conv bounds count these 5 of the K + 1 = 9
# rows: the forward and dW multiply by E, dx by its derivative B' (zero
# off the same span), so no other product changes a result.  The dense
# bounds count every row of every (pixel, tap) pair.
SPAN_ROWS = 3 + 2
# the reductions' cold-L2 timing reads copies of the partials that fill 4x
# the H100's 50 MB L2
COLD_L2_BYTES = 4 * 50 * 2**20
TOL = 1e-4                  # kernel vs plain version, float32
MODEL_TOL = 1e-3            # 13 layers of float32 GPU vs CPU
# (H, C, O) of the VGG16_small convs in order; 13 layers, 9 distinct shapes
VGG16_SMALL_CONVS = [(32, 3, 16), (32, 16, 16), (16, 16, 32), (16, 32, 32),
                     (8, 32, 64), (8, 64, 64), (8, 64, 64), (4, 64, 128),
                     (4, 128, 128), (4, 128, 128), (2, 128, 128),
                     (2, 128, 128), (2, 128, 128)]
REPLACES = "convkan_tpu/kernels/wide_kan_conv.py:300"
ALSO_REPLACES = "convkan_tpu/kernels/fused_kan_conv.py:167"
BWD_REPLACES = "convkan_tpu/kernels/wide_kan_conv.py:344"
# the weight-gradient tile's entries of dw_launch_config that phases 6 and 8
# print
DW_TILE = ("CC", "BN", "PW", "threads", "S", "blocks")
# the ordered reduction's launch (reduce_launch_config) that phases 6, 8, 10
# and 14 print
RED_TILE = ("VW", "Gw", "Gc", "blocks")
RED_SOURCE = "convkan_tpu_torch/csrc/ordered_sum.cuh"
# the WavKAN parameter kernel's launch (param_launch_config) that phases 10
# and 14 print
PARAM_TILE = ("CT", "threads", "RS", "RB", "pipe", "compiled", "S", "blocks",
              "blocks_per_sm", "waves", "smem")
# the WavKAN forward's launch (fwd_launch_config) that phases 9 and 14 print
FWD_TILE = ("WT", "TW", "OG", "NT", "RB", "bands", "threads", "blocks",
            "blocks_per_sm", "waves", "smem")
# the WavKAN data gradient's launch (dx_launch_config) that phases 10 and 14
# print
DX_TILE = ("WT", "P", "RT", "CG", "NPB", "NIB", "threads", "blocks",
           "blocks_per_sm", "waves", "smem")
# backward kernels vs float64 autograd of the plain version: a dW entry sums
# up to B*H*W = 65,536 float32 products at batch 64 (dx: k*k*(K+1)*O <=
# 10,368) in another order, an error of ~sqrt(n) * 2^-24 of the sum of
# |terms|; allowed: BWD_TOL of the largest reference entry + BWD_TOL relative
BWD_TOL = 1e-4
# train step GPU vs CPU, float32.  VGG16_small is ill-conditioned in float32
# (InstanceNorm over 2x2 planes amplifies rounding): at some training
# states a float32 gradient, on the GPU and on the CPU alike, lies up to
# 0.19 of a parameter's largest entry from float64 (tools/
# train_grad_spread.py: WavKAN steps 1-2 started from the GPU's states,
# which vary from run to run because cuDNN's data gradient of the WavKAN
# base conv is not deterministic).  So: the GPU's gradients are held to
# float64 on the CPU from the same start, within GRAD_TOL of each
# parameter's largest entry (the CPU's float32 reading is printed
# beside), from starts that are the same in every run (the CPU's float32
# trajectory, in lockstep); losses within LOSS_RTOL relative; and, since AdamW
# moves every entry by about lr per step whatever its gradient's size
# (entries near 0 flip sign between the runs), the runs' parameter updates
# must agree to UPDATE_TOL in relative L2 distance
GRAD_TOL, LOSS_RTOL, UPDATE_TOL = 0.1, 1e-3, 0.5
# With train-mode BatchNorm (phase 26) the seeded VGG16_small's float32
# gradients lie further than GRAD_TOL from float64 at some of its lockstep
# states on the CPU alone: with its KAN convs' outputs multiplied by
# 1 + 1e-6 N(0, 1) (the size of float32 sums taken in another order)
# KanConvND_4.prelu's step-1 gradient moves by 0.305 of its value, and at
# batch 64 plain float32 reads 0.164 on the first step (tools/f32_spread.py
# --kan_conv KAN --kan_norm_layer BatchNorm2d --steps 3 [--batch 64]).  A
# PReLU slope's gradient is one sum of a term per negative activation, and
# the terms cancel.  So with ``f32_floor`` a train phase measures that
# spread at each of its starts (F32_NOISE, one CPU float32 run per seed of
# F32_NOISE_SEEDS) and holds each GPU gradient to float64 within the larger
# of GRAD_TOL and F32_SPREAD times the spread of the same parameter and
# step (F32_SPREAD as CHEBY_F32 for logits)
F32_NOISE, F32_NOISE_SEEDS, F32_SPREAD = 1e-6, (11, 12, 13), 2
TRAIN_STEPS, TRAIN_BATCH, TIME_BATCH = 3, 16, 1024
WAV_REPLACES = "convkan_tpu/kernels/fused_wav_conv.py:351"
WAV_BWD_REPLACES = "convkan_tpu/kernels/fused_wav_conv.py:405"
WAVELETS = ("mexican_hat", "morlet", "dog", "meyer", "shannon")
# (H, C, O) of the three WavKAN convs of the BASELINE config-4 stack
CONFIG4_CONVS = [(32, 3, 32), (16, 32, 64), (8, 64, 128)]
# one exp per psi on the SFU: 132 SMs x 16 per clock at 1.98 GHz (H100 SXM)
PEAK_EXP = 132 * 16 * 1.98e9
# The WavKAN phases' model keeps the 2x2 map of its last conv as features.
# With the default (1, 1) head the last op of the trunk is InstanceNorm
# (no PReLU after it, unlike the KAN conv), whose per-channel mean is 0, so
# the average pool gives features that are exactly 0: the logits are the
# Linear bias for every image and the trunk gets no gradient (the JAX model
# alike).  The convs, and so the kernels' shapes and launches, are the same.
WAV_MODEL = {"expected_feature_shape": (2, 2)}
# The ChebyKAN phases' model keeps the 2x2 map too: a ChebyKAN conv has no
# PReLU after its InstanceNorm either (the same degenerate (1, 1) head).
CHEBY_MODEL = {"expected_feature_shape": (2, 2)}
# all 4 rows of the Chebyshev E of degree 3 are non-zero at every x (T_0 = 1):
# its bounds count every row of the interior pairs
CHEBY_ROWS = 4
# The ChebyKAN VGG16_small's float32 logits are worse conditioned than
# MODEL_TOL: on the CPU alone, float32 lies 2.1e-3 to 3.7e-3 from float64 at
# the seeded init (5 seeds, 64 images; a 1e-7 relative change of the input
# moves its float32 logits by 4.7e-3), against 3.4e-5 for the B-spline
# model and 2.6e-4 for WavKAN's.  Phase 16 holds the GPU's logits to
# float64 within CHEBY_F32 times the CPU float32's distance, plus MODEL_TOL.
CHEBY_F32 = 2
# all 5 rows of the Gram E of degree 3 (SiLU(p_0) .. SiLU(p_3), SiLU(x)) are
# non-zero at every x: its bounds count every row of the interior pairs
GRAM_ROWS = 5
# beta in the Gram kernel phases: GRAM_BETA_SCALE times its init std
# 1/(9 C (degree+1)), so that the beta terms of the recurrence (c_2 beta_1
# = 2.25 beta_1, c_3 beta_2 = 33.3 beta_2) are not negligible
GRAM_BETA_SCALE = 100
# d beta against float64: one entry sums up to B*H*W*C terms (16.8 M at
# 32x32x16, batch 1024), which can cancel, so each partial row and each
# reduced entry is held within DBETA_TOL of the sum of |terms| it adds,
# not of |d beta|
DBETA_TOL = 1e-4
# the d beta epilogue's work per interior (pixel, channel) at degree 3: a
# multiply-add for each of the 3 non-zero dp_n/dbeta[j] ((n, j) = (2, 1),
# (3, 1), (3, 2)), added to the data gradient's bound
GRAM_DBETA_FLOPS = 2 * 3
# Path A: KAN-VGG16_small as train.py builds it, B-spline grid 5 order 3,
# its --kan_norm_layer BatchNorm2d default (affine, running statistics; the
# (1, 1) head, as train.py)
PATH_A = {"kan_norm_layer": "BatchNorm2d"}
# BatchNorm's running statistics GPU vs CPU, each buffer within STATS_TOL of
# its largest entry: they are means over B*H*W of the activations (of their
# squares for var), whose GPU and CPU values the model phases hold to
# MODEL_TOL at the logits; an average does not amplify those differences,
# and in lockstep each reading is of one step's move from the same start
STATS_TOL = 1e-3
# Path B: BASELINE config 4's stack (bench.py measure_wavkan): three
# WavKANConv2DLayers (mexican_hat, fast, BatchNorm) with 2x2 max-pools, an
# average pool and a Linear 100 head, CIFAR-100 at batch 2048.  Its
# GPU-vs-CPU steps run at CONFIG4_CHECK_BATCH (the CPU's plain float32 and
# float64 steps at 2048 would materialize psi tensors of 4.3 and 8.6 GB per
# layer); the kernels and the timed step run at CONFIG4_BATCH
CONFIG4_BATCH, CONFIG4_CHECK_BATCH, CONFIG4_CLASSES = 2048, 64, 100
# the float64 references of the config-4 kernel checks run over chunks of
# this many images
CONFIG4_CHUNK = 256
CONFIG4_SUFFIX = "[config4]"
# Path C: KAN-MobileNetV3-small, BASELINE config 5's single-chip model
# (bench.py:439-495), width 1.0, 224 x 224, 10 classes: (H, C, O) of its 22
# 1x1 stride-1 KAN convs in order (the strided 3x3 stem, 3 -> 16, takes the
# plain route).  The KAN (hardswish base path) and ChebyKAN models run them
# on the KAN-conv kernels; FastKAN, config 5's own family, which no kernel
# carries (its input norm's statistics must leave out the pad), runs every
# conv on the plain route, as the JAX package runs it on XLA.
MNV3_CONVS = [(56, 16, 16), (56, 16, 72), (28, 72, 24), (28, 24, 88),
              (28, 88, 24), (28, 24, 96), (14, 96, 40), (14, 40, 240),
              (14, 240, 40), (14, 40, 240), (14, 240, 40), (14, 40, 120),
              (14, 120, 48), (14, 48, 144), (14, 144, 48), (14, 48, 288),
              (7, 288, 96), (7, 96, 576), (7, 576, 96), (7, 96, 576),
              (7, 576, 96), (7, 96, 576)]
MNV3_FAMILIES = ("KAN", "ChebyKAN", "FastKAN")
# kernel checks, model logits, lockstep train steps (the CPU's float32 and
# float64 steps at 224 x 224), and bench.py's timed batch
MNV3_CHECK_BATCH, MNV3_MODEL_BATCH, MNV3_TRAIN_BATCH, MNV3_TIME_BATCH = \
    64, 4, 8, 512
# At the seeded init, MobileNetV3-small's train-mode forward is badly
# conditioned: each KAN conv's curved basis terms (the RBF of FastKAN, the
# B-spline's, the Chebyshev degrees >= 2) magnify a relative error of their
# input about 2x, each conv's BatchNorm up to 2x more, so float32 rounding
# grows along the 23 convs.  On the CPU alone (tools/f32_spread.py
# --model MobileNetV3KAN --curve 1), float32 lies from float64 by 4.4e-3
# of FastKAN's loss, 3.3 of a gradient's largest entry and 9.4e-2 of a
# running statistic (ChebyKAN: 3.1e-5, 0.15, 4.4e-3; KAN: 1.2e-6, 0.50,
# 3.1e-5).  With those terms at MNV3_CURVE of their init (--curve 0.1; the
# base path and Chebyshev's T_0, T_1 unchanged) the same readings are
# 7.6e-9, 3.7e-3, 6.3e-6 (ChebyKAN 2.6e-7, 8.8e-5, 1.4e-4; KAN 3.2e-9,
# 0.086 (a PReLU slope, as phase 26), 2.5e-6).  So phases 32-34 start from
# that state (``mnv3_smooth``), where the fixed tolerances can tell a fault
# from rounding; phases 32 and 33 also set every running statistic to a
# batch's (``mnv3_calibrate``): with the init's (0 and 1) the eval-mode
# logits hardly depend on the image.
MNV3_CURVE = 0.1
# the path's entries of the kernels line end so
MNV3_SUFFIX = {"hardswish": "[mnv3 hardswish]", "cheby3": "[mnv3 cheby3]"}
# Path D: KAN-EfficientNetV2-s, the other half of BASELINE config 5
# (bench.py:373-426: arch s, 224 x 224, 10 classes, remat), 80 KAN convs.
# (H, C, O, k) of its 77 stride-1 KAN convs in order (the strided stem, 3 ->
# 24, and the first, strided, 3x3 convs of stages 2 and 3 take the plain
# route); the 38 projections (1x1, after a Fused-MBConv expansion or ending
# an MBConv block) have the identity base path, the others SiLU.  FastKAN,
# bench.py's family, runs all 80 on the plain route.
EFFV2_CONVS = (
    [(112, 24, 24, 3)] * 2
    + [(56, 96, 48, 1)] + [(56, 48, 192, 3), (56, 192, 48, 1)] * 3
    + [(28, 192, 64, 1)] + [(28, 64, 256, 3), (28, 256, 64, 1)] * 3
    + [(28, 64, 256, 1), (14, 256, 128, 1)]
    + [(14, 128, 512, 1), (14, 512, 128, 1)] * 5
    + [(14, 128, 768, 1), (14, 768, 160, 1)]
    + [(14, 160, 960, 1), (14, 960, 160, 1)] * 8
    + [(14, 160, 960, 1), (7, 960, 256, 1)]
    + [(7, 256, 1536, 1), (7, 1536, 256, 1)] * 14
    + [(7, 256, 1280, 1)])
# the projections among them: a 1x1 conv whose output is narrower than its
# input (every other 1x1 conv expands; the 3x3 convs are expansions)
EFFV2_PROJ = [k == 1 and O < C for _, C, O, k in EFFV2_CONVS]
EFFV2_FAMILIES = ("KAN", "GRAMKAN", "FastKAN")
# kernel checks, model logits, lockstep train steps (at EFFV2_TRAIN_SIZE:
# the CPU's float32 and float64 steps of the s model), bench.py's timed batch
EFFV2_CHECK_BATCH, EFFV2_MODEL_BATCH, EFFV2_TRAIN_BATCH, EFFV2_TIME_BATCH = \
    8, 2, 8, 128
EFFV2_TRAIN_SIZE = 64
# stochastic depth of the train phases' model: the builder's default
EFFV2_SD = 0.2
# phase 39's families (``effv2_train_model``: GRAMKAN at its init, the
# B-spline with its curved terms at MNV3_CURVE, as phase 34) and whether
# their gradients are held against float64 (and float32's spread read).
# The B-spline model's are not: at EFFV2_TRAIN_SIZE its last stage runs
# at 2 x 2, each BatchNorm there over 32 values, and its float32 gradients
# lie far from float64 (the PReLU slopes, each a cancelling sum, up to 4.7
# under F32_NOISE on the CPU, so a zero gradient would pass; one conv's
# weights 0.14 on the card with its kernels, 0.012 on the plain route,
# though every kernel on the step's own tensors is within 3e-6 of
# float64: tools/f32_spread.py --model EfficientNetV2KAN --kan_conv KAN
# --curve 0.1 [--card]).  Its kernels are held on the step's own tensors
# instead (``conv_kernel_readings``)
EFFV2_TRAIN = {"GRAMKAN": True, "KAN": False}
# timed steps of phase 40 (after warm-up steps)
EFFV2_WARMUP, EFFV2_STEPS = 2, 5
# GPU remat=True against remat=False (phase 39): each gradient within this
# of its largest entry (the forward is the same computation on the same
# inputs; cuDNN's backward algorithms may sum in another order)
REMAT_TOL = 1e-4
EFFV2_SUFFIX = {"identity": "[effv2 identity]",
                "gram_identity": "[effv2 gram identity]",
                "silu": "[effv2 silu]"}
# Path E: KAN-VGG16_small as train.py builds it with each static basis
# (--kan_conv <key>: base_activation "silu", degree 3, Fourier's grid 5,
# InstanceNorm, the (1, 1) head: PReLU or SiLU follows every norm), its 13
# convs on the KAN-conv kernels' static instantiations; key -> the family
STATIC_FAMILIES = {"JacobiKAN": "jacobi", "BersnsteinKAN": "bernstein",
                   "BesselKAN": "bessel", "FibonacciKAN": "fibonacci",
                   "FourierKAN": "fourier", "GegenbauerKAN": "gegenbauer",
                   "HermiteKAN": "hermite", "LaguerreKAN": "laguerre",
                   "LucasKAN": "lucas", "TaylorKAN": "taylor"}
# the five instantiations by their code (kernels/kan_conv2d.py COMPILED):
# the tag their entries end in, and the family each is timed with
STATIC_TAGS = {7: "recur3 silu", 8: "recur3 identity", 9: "taylor",
               10: "bernstein", 11: "fourier"}
STATIC_TIMED = {"recur3 silu": "HermiteKAN", "recur3 identity": "JacobiKAN",
                "taylor": "TaylorKAN", "bernstein": "BersnsteinKAN",
                "fourier": "FourierKAN"}
# exact zeros the kernels must keep (the basis rows, and whether their
# values or only their derivatives are 0): Bernstein's rows are 1 with a
# derivative of exactly 0, Fibonacci's row 0 is 0, and Gegenbauer's rows
# 1-3 at alpha_param 0 (the factory's and VGG's default)
STATIC_ZERO = {"BersnsteinKAN": ((0, 1, 2, 3), "derivative"),
               "FibonacciKAN": ((0,), "value"),
               "GegenbauerKAN": ((1, 2, 3), "value")}
# the images of phase 42's batch-1024 forward that the CPU recomputes
STATIC_MODEL_CHECK = 64
# At the seeded init FourierKAN's float32 train step is chaotic: on the CPU
# alone, its weight gradients lie up to 1.5 times their largest entry from
# float64 (a relative change of 1e-7 of the input moves its logits by
# 7e-3; tools/f32_spread.py --kan_conv FourierKAN --steps 3).  Its train
# phase scales the convs' poly_w by STATIC_CURVE (mnv3_smooth: the base
# path stays), where float32's spread at the lockstep starts is 2.4e-2
# (--curve 0.1) and the fixed tolerances tell a fault from rounding
STATIC_CURVE = {"FourierKAN": 0.1}
# A PReLU slope's gradient is one sum of a term per negative activation,
# which cancels: at path E's lockstep starts plain float32 lies 25 times
# its value from float64 on the CPU (HermiteKAN's KanConvND_0.prelu, step
# 1) and F32_NOISE moves it by up to 35 (tools/f32_spread.py --kan_conv
# HermiteKAN --steps 3), where no limit both holds it and lets a zero
# gradient fail.  Path E's train phase prints the slopes' readings and
# holds every other gradient (their spread reaches 0.19 at most: TaylorKAN)
STATIC_UNHELD = (".prelu",)


# readings that cuda_ms could not hold to device time: kernel name -> fields
HOST_BOUND: dict[str, set] = {}


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


@functools.cache
def sleep_cycles_per_ms() -> float:
    """SM clock cycles per ms of torch.cuda._sleep on this card (measured
    once, by events around a 20M-cycle sleep)."""
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def cuda_ms(fn, iters: int = 20, warmup: int = 3, what=None) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters` calls
    in a preloaded queue: a sleep kernel enqueued before the start event
    holds the card until the host has issued every call, so the events read
    device time only, not the rate at which the host issues calls (a
    wrapper, torch.empty and a ctypes launch can take longer on the host
    than a small kernel on the card).  The sleep lasts twice the host's
    issue time of the calls plus 1 ms; if the host still took longer, the
    sleep is lengthened (up to 1 s) and the run repeated (up to 3 times
    for a kernel, once for any other reading).  If the host outlasted the
    sleep even then, the card may have waited on it: a kernel's time
    (``what`` None) fails; any other reading (``what`` = (kernel name,
    field): a plain version or a library call, which may queue more
    launches than the queue holds or wait on the card) is printed as
    host-bound, recorded in HOST_BOUND and returned."""
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        per_call = time.perf_counter() - t0   # the last one: warm
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    for _ in range(4 if what is None else 2):
        sleep_ms = min(2e3 * iters * per_call + 1.0, 1000.0)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(sleep_ms * sleep_cycles_per_ms()))
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        issued_ms = 1e3 * (time.perf_counter() - t0)
        end.record()
        torch.cuda.synchronize()
        if issued_ms < sleep_ms:
            return start.elapsed_time(end) / iters
        per_call = issued_ms / 1e3 / iters
    ms = start.elapsed_time(end) / iters
    check(what is not None, f"kernel timing host-bound: the host issued "
                            f"{iters} calls in {issued_ms:.3f} ms, longer "
                            f"than the {sleep_ms:.3f} ms sleep")
    print(f"[timer] host-bound reading of {what[0]} {what[1]}: "
          f"{ms:.4f} ms (the host issued {iters} calls in {issued_ms:.3f} "
          f"ms, longer than the {sleep_ms:.3f} ms sleep)", flush=True)
    HOST_BOUND.setdefault(what[0], set()).add(what[1])
    return ms


def cold_copies(t):
    """A function that returns, call after call, the next of enough copies
    of ``t`` to fill COLD_L2_BYTES, round and round: none is still in L2
    when read again."""
    return itertools.cycle([t.clone() for _ in range(
        -(-COLD_L2_BYTES // (t.element_size() * t.numel())) + 1)]).__next__


def reduce_work(S: int, N: int) -> tuple:
    """(adds, bytes) of the ordered reduction of (S, N) partials: each
    partial read once, the sum written once."""
    return S * N, 4 * (S + 1) * N


def reduction_times(name, reduce, reference, part) -> dict:
    """One ordered reduction at one shape of the main path: its result
    bit-exact against the plain version in the kernel's order, and two
    calls bit-identical; then its time and sum(0)'s on a cold L2 (each call
    reads the next of enough copies of the partials to fill COLD_L2_BYTES,
    so none finds its input in L2, as the bytes bound at HBM rate assumes)
    and on a warm one (the same partials every call, as in a step right
    after the weight kernel wrote them), and the plain version's."""
    got = reduce(part)
    check(torch.equal(got, reference(part)) and torch.equal(got,
                                                             reduce(part)),
          f"{name} not bit-exact against its plain version, or not "
          f"bit-identical run to run, at (S, N) = {tuple(part.shape)}")
    nxt = cold_copies(part)
    times = {
        "ms": cuda_ms(lambda: reduce(nxt())),
        "library_ms": cuda_ms(lambda: nxt().sum(0),
                              what=(name, "library_ms")),
        "warm_l2_ms": cuda_ms(lambda: reduce(part)),
        "library_warm_l2_ms": cuda_ms(lambda: part.sum(0),
                                      what=(name, "library_warm_l2_ms")),
        # one call: S launches of adds, under the launch queue's depth
        "plain_ms": cuda_ms(lambda: reference(part), iters=1, warmup=1,
                            what=(name, "plain_ms"))}
    return times


def conv_extra(gen, C, basis):
    """The basis's learnable operand for a conv of C input channels (None
    without one): Gram's beta N(0, GRAM_BETA_SCALE x its init std
    1/(9 C (degree+1)))."""
    if basis is None or not basis.n_extra:
        return None
    std = GRAM_BETA_SCALE / (9 * C * (basis.order + 1))
    return torch.randn(basis.n_extra, generator=gen) * std


def extra_check(kc, basis, x, w_all, g, k, pad, extra, epart, de):
    """The data gradient's extra partials ``epart`` and their reduction
    ``de`` against float64 autograd of the plain version, term by term:
    each partial row within DBETA_TOL of the sum of |terms| it adds (rows
    grouped as the kernel's blocks, ``extra_blocks``), the reduction
    bit-exact against its plain version in the kernel's order and within
    DBETA_TOL of the sum of |terms| of its entry; entries 0 and 3 exactly
    0.  Returns (max |err| / sum of |terms| of the partials and of the
    reduction, ok)."""
    B, H, W, C = x.shape
    terms = kc.extra_terms_reference(x.double(), w_all.double(), g.double(),
                                     basis, k, pad, extra.double())
    cfg = kc.dx_launch_config(B, H, W, C, g.shape[-1], k, pad, basis.R)
    idx = kc.extra_blocks(B, H, W, C, cfg).reshape(-1).to(terms.device)
    flat = terms.reshape(-1, basis.n_extra)
    want = torch.zeros(epart.shape, dtype=torch.float64,
                       device=terms.device).index_add_(0, idx, flat)
    scale = torch.zeros_like(want).index_add_(0, idx, flat.abs())
    e_part = ((epart.double() - want).abs()
              / scale.clamp_min(1e-300)).max().item()
    total, total_abs = want.sum(0), scale.sum(0)
    e_red = ((de.double() - total).abs() / total_abs.clamp_min(1e-300)) \
        .max().item()
    zero = [0, basis.n_extra - 1]
    ok = e_part <= DBETA_TOL and e_red <= DBETA_TOL and \
        torch.equal(de, kc.reduce_reference(epart)) and \
        not epart[:, zero].any() and not de[zero].any()
    return e_part, e_red, ok


def conv_inputs(gen, B, H, C, O, scale=1.0, k=3, basis=None):
    """x U(-scale, scale), base_w (None without a base path) and poly_w
    N(0, 0.1) for ``basis`` (default: the B-spline, K = 8)."""
    K = 8 if basis is None else basis.K
    x = (torch.rand(B, H, H, C, generator=gen) * 2 - 1) * scale
    bw = None if basis is not None and basis.act is None else \
        torch.randn(k, k, C, O, generator=gen) * 0.1
    pw = torch.randn(k, k, C * K, O, generator=gen) * 0.1
    return x, bw, pw


def interior_pairs(H: int, k: int = 3, pad: int = 1) -> int:
    """(output pixel, tap) pairs of one HxH image whose input pixel lies in
    the image: the products a pass needs (pad values are zero)."""
    Ho = H + 2 * pad - k + 1
    rows = sum(1 for d in range(k) for i in range(Ho) if 0 <= i + d - pad < H)
    return rows * rows


def bwd_close(got, want):
    """max |got - want| and whether every entry is within BWD_TOL of the
    largest reference entry plus BWD_TOL relative (see BWD_TOL)."""
    d = (got.double() - want.double()).abs()
    lim = BWD_TOL * want.abs().max().double() + BWD_TOL * want.abs().double()
    return d.max().item(), bool((d <= lim).all())


def dw_tile(cfg) -> str:
    return ", ".join(f"{key} {cfg[key]}" for key in DW_TILE)


def dx_tile(kc, cfg) -> str:
    """The data-gradient tile: skip or dense (rows per image slot TH,
    image slots NB), image groups NG, channels CC, output channels per
    chunk OC, chunks in flight, the g offsets' table or none, blocks."""
    return ", ".join(f"{key} {cfg[key]}" for key in (*kc.DX_TILE, "blocks"))


def dx_pairs(kc, cfg, B, H, W, k, pad) -> int:
    """(pixel, tap) pairs the data-gradient kernel computes per channel
    block of its tile ``cfg``: dense, every tap of every pixel slot of
    every block (pad pairs and idle slots included); skip, the taps whose
    g lies on the output plane, for whole groups of DX_GROUP images."""
    if not cfg["skip"]:
        return cfg["tiles"] * kc.DX_PIXELS * k * k
    Ho, Wo = H + 2 * pad - k + 1, W + 2 * pad - k + 1
    taps = sum(0 <= i + pad - di < Ho and 0 <= j + pad - dj < Wo
               for i, j, di, dj in itertools.product(
                   range(H), range(W), range(k), range(k)))
    return kc.DX_GROUP * -(-B // kc.DX_GROUP) * taps


def red_tile(cfg) -> str:
    """The ordered reduction's launch: float4 or float columns, thread rows,
    cluster ranks, blocks."""
    return ", ".join(f"{key} {cfg[key]}" for key in RED_TILE)


def red_row(row, rcfg, red, total, layers):
    """Adds to a reduction's row of one shape its launch, its and sum(0)'s
    warm-L2 times, its share of the bound (cold L2) and its time over
    sum(0)'s; adds the warm times x ``layers`` to ``total``."""
    row.update({
        "config": {key: rcfg[key] for key in RED_TILE},
        "warm_l2_ms": round(red["warm_l2_ms"], 4),
        "library_warm_l2_ms": round(red["library_warm_l2_ms"], 4),
        "bound_share": round(row["bound_ms"] / red["ms"], 4),
        "vs_sum": round(red["ms"] / red["library_ms"], 4)})
    for key in ("warm_l2_ms", "library_warm_l2_ms"):
        total[key] += layers * red[key]


def print_red_totals(tag, name, t, card, batch=TIME_BATCH):
    print(f"{tag} {name} per train step at batch {batch}, device time: "
          f"cold L2 {t['ms']:.4f} ms (sum(0) {t['library_ms']:.4f} ms), "
          f"{100 * t['bound_ms'] / t['ms']:.1f}% of the bound "
          f"{t['bound_ms']:.4f} ms; warm L2 {t['warm_l2_ms']:.4f} ms (sum(0) "
          f"{t['library_warm_l2_ms']:.4f} ms); plain {t['plain_ms']:.3f} ms "
          f"(on {card})", flush=True)


def backward_case(kc, basis, x, bw, pw, g, k, pad, partials=True,
                  twice=False, tag="[backward]", extra=None):
    """One backward case on the card: each kernel wrapper (data gradient,
    weight-gradient partials, their reduction) and the autograd path's
    gradients against float64 autograd of the plain version (BWD_TOL); the
    reduction bit-exact against its plain version in the kernel's grouped
    order, and the reduced dW against float64 (BWD_TOL, the grouped order's
    rounding included).  ``partials`` False: the partials are held to
    float64 through the reduced dW only (at batch 1024, where each of the
    splits would take a float64 autograd of its own); ``twice``: the data
    gradient and the partials of two calls must be bit-identical.  Prints
    the case (its data-gradient tile, weight-gradient tile and reduction
    launch) and fails on a disagreement; returns max |err| per kernel, the
    reduced dW's against float64, and dx of the wrapper and of the autograd
    path.  With ``extra`` (the basis's learnable operand) the data gradient
    also writes its partials, which are held to float64 by
    ``extra_check``, as are the reduced gradient of the autograd path's
    operand and of the launch that stores no dx (the first conv's), both
    bit-identical to the partials' reduction; the returned errors then
    carry "dbeta_rel" (the worst of ``extra_check``'s two)."""
    B, H, _, C = x.shape
    O = pw.shape[-1]
    spec = (basis, k, pad)
    ex = () if extra is None else (extra,)
    ex64 = () if extra is None else (extra.double(),)
    w_all = kc.pack_w_all(bw, pw, C=C, K=basis.K, k=k, O=O,
                          degree_major=basis.degree_major)
    cfg = kc.dw_launch_config(B, H, H, C, O, k, pad, basis.R)
    xcfg = kc.dx_launch_config(B, H, H, C, O, k, pad, basis.R)

    def data_grad():
        if extra is None:
            return kc.input_grad(x, w_all, g, *spec), None
        return kc.input_extra_grad(x, w_all, g, *spec, extra)

    dx, epart = data_grad()
    part = kc.weight_partials(x, g, *spec, *ex)
    dw = kc.reduce_partials(part)
    if twice:
        dx2, epart2 = data_grad()
        same = torch.equal(dx, dx2) and torch.equal(
            part, kc.weight_partials(x, g, *spec, *ex)) and \
            (extra is None or torch.equal(epart, epart2))
    else:
        same = True
    torch.cuda.synchronize()
    e_dx, ok_dx = bwd_close(dx, kc.input_grad_reference(
        x.double(), w_all.double(), g.double(), *spec, *ex64))
    e_red = (dw - kc.reduce_reference(part)).abs().max().item()
    e64, ok64 = bwd_close(dw, kc.weight_grad_reference(
        x.double(), g.double(), *spec, *ex64))
    e_dw, ok_dw = bwd_close(part, kc.weight_partials_reference(
        x.double(), g.double(), *spec, cfg["S"], cfg["ips"], *ex64)) \
        if partials else (e64, ok64)
    rcfg = kc.reduce_launch_config(part.shape[0], part[0].numel())
    base = bw is not None
    ts = (x, bw, pw) if base else (x, pw)
    ts += ex

    def conv(fn, leaves):
        return fn(leaves[0], leaves[1] if base else None,
                  leaves[2 if base else 1], *spec, *leaves[len(ts) - len(ex):])

    leaves = [t.clone().requires_grad_(True) for t in ts]
    got = torch.autograd.grad(conv(kc.kan_conv2d, leaves), leaves, g)
    ref = [t.double().requires_grad_(True) for t in ts]
    want = torch.autograd.grad(conv(kc.kan_conv2d_reference, ref), ref,
                               g.double())
    auto = [bwd_close(a, b) for a, b in zip(got[:len(ts) - len(ex)], want)]
    ok = ok_dx and ok_dw and e_red == 0.0 and ok64 and same and \
        all(o for _, o in auto)
    extra_msg = ""
    if extra is not None:
        de = kc.reduce_partials(epart)
        e_ep, e_de, ok_de = extra_check(kc, basis, x, w_all, g, k, pad, extra,
                                        epart, de)
        # the first conv's launch (dx not stored), and the autograd path's
        _, epart0 = kc.input_extra_grad(x, w_all, g, *spec, extra,
                                        need_dx=False)
        same_de = torch.equal(epart0, epart) and torch.equal(got[-1], de)
        ok = ok and ok_de and same_de
        extra_msg = (f"; dbeta partials {e_ep:.3e}, reduced {e_de:.3e} of "
                     f"the sum of |terms| (entries 0 and {basis.n_extra - 1} "
                     f"exactly 0: {ok_de}; dx-free launch and autograd "
                     f"{'bit-identical' if same_de else 'DIFFERENT'})")
    print(f"{tag} B={B} {H}x{H} C={C} O={O} {basis} k={k} pad={pad} "
          f"(dx tile {dx_tile(kc, xcfg)}; dW tile {dw_tile(cfg)}; reduce "
          f"{red_tile(rcfg)}): "
          f"dx {e_dx:.3e}, dW partials {e_dw:.3e}"
          f"{'' if partials else ' (reduced)'}, reduce {e_red:.1e} "
          f"(reduced dW vs float64 {e64:.3e}); "
          f"autograd {'dx/dbase_w/dpoly_w' if base else 'dx/dpoly_w'} "
          f"{'/'.join(f'{e:.3e}' for e, _ in auto)}"
          f"{'' if not twice else '; two calls bit-identical' if same else '; two calls DIFFERENT'}"
          f"{extra_msg} {'ok' if ok else 'FAIL'}", flush=True)
    for t in (dx, part, *got):
        check(bool(torch.isfinite(t).all()), "backward output not finite")
    check(ok, f"backward kernels disagree with the plain version (B={B} "
              f"H={H} C={C} O={O} {basis} k={k} pad={pad})")
    errs = {"kan_conv2d_bwd_dx": max(e_dx, auto[0][0]),
            "kan_conv2d_bwd_dw": max(e_dw, *(e for e, _ in auto[1:])),
            "kan_conv2d_bwd_dw_reduce": e_red}
    if extra is not None:
        errs["dbeta_rel"] = max(e_ep, e_de)
    return errs, e64, dx, got[0]


def phase_backward(kc, knots, gen, dev):
    """6. each backward kernel and the autograd path against float64
    autograd of the plain version on the card (``backward_case``);
    returns max |err| per kernel."""
    cases = [(64, H, C, O, "silu", 3, 1)
             for H, C, O in dict.fromkeys(VGG16_SMALL_CONVS)]
    cases += [(3, 7, 13, 5, "silu", 3, 1), (8, 16, 16, 32, "gelu", 3, 1)]
    # ragged edges of the weight-gradient tile: B not a multiple of the
    # split, 216-column tiles, C not a multiple of the channel chunk, and
    # the 2x2 layer at the real batch
    cases += [(1023, 8, 32, 64, "silu", 3, 1), (64, 8, 16, 48, "silu", 3, 1),
              (64, 16, 13, 32, "silu", 3, 1),
              (1024, 2, 128, 128, "silu", 3, 1)]
    # ... and of the data-gradient tile: B not a multiple of the image group
    # (pad taps skipped at 4x4 and 3x3), odd H with C % 8 and O = 5, O = 48,
    # kernel 5 with pad 2, pad 0 (Ho < H)
    cases += [(37, 4, 16, 32, "silu", 3, 1), (41, 3, 6, 8, "gelu", 3, 1),
              (3, 9, 13, 5, "silu", 3, 1), (5, 8, 8, 48, "silu", 3, 1),
              (2, 8, 6, 16, "silu", 5, 2), (3, 6, 8, 12, "silu", 3, 0)]
    # ... and its fallbacks at the edge of shared memory: kernels 37 x 37
    # with 32 pixel slots, and with 64 or 32 slots and no table of g offsets
    cases += [(1, 9, 1, 1, "silu", 37, 18), (1, 14, 1, 1, "gelu", 37, 18),
              (1, 22, 1, 1, "silu", 37, 18)]
    errs = dict.fromkeys(("kan_conv2d_bwd_dx", "kan_conv2d_bwd_dw",
                          "kan_conv2d_bwd_dw_reduce"), 0.0)
    red64 = 0.0
    for B, H, C, O, act, k, pad in cases:
        x, bw, pw = conv_inputs(gen, B, H, C, O, k=k)
        Ho = H + 2 * pad - k + 1
        g = torch.randn(B, Ho, Ho, O, generator=gen)
        x, bw, pw, g = (t.to(dev) for t in (x, bw, pw, g))
        case, e64, _, _ = backward_case(
            kc, kc.bspline_basis(knots, 3, act), x, bw, pw, g, k, pad)
        red64 = max(red64, e64)
        for name, e in case.items():
            errs[name] = max(errs[name], e)
    print(f"[backward] reduced dW vs float64 autograd: max |err| "
          f"{red64:.3e} (within BWD_TOL in every case)", flush=True)
    return errs


def train_model(kan_conv, **model_kw):
    """The phases' VGG16_small (seeded, on the CPU)."""
    from convkan_tpu_torch.models.vgg import vggkan
    return vggkan(3, 10, arch="VGG16_small", kan_conv=kan_conv,
                  classifier_type="Linear",
                  generator=torch.Generator().manual_seed(2), device="cpu",
                  **model_kw)


def train_batches():
    """TRAIN_STEPS seeded batches: (uint8 images, labels, crops, flips)."""
    from convkan_tpu_torch.train.data import _synthetic, crop_params
    x, y = _synthetic("CIFAR10", TRAIN_STEPS * TRAIN_BATCH, seed=4)
    crops = torch.Generator().manual_seed(6)
    batches = []
    for i in range(TRAIN_STEPS):
        sl = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
        offs, flips = crop_params(TRAIN_BATCH, "cpu", crops)
        batches.append((torch.from_numpy(x[sl]), torch.from_numpy(y[sl]),
                        offs, flips))
    return batches


def _snapshot(model, state):
    return ({n: t.detach().cpu().clone()
             for n, t in model.state_dict().items()},
            copy.deepcopy(state.optimizer.state_dict()))


def train_run(model, device, batches, starts=None, make_step=None,
              steps_per_epoch=2):
    """The train steps of ``batches`` on ``device``; with ``starts``, step i
    starts from the parameters, buffers (BatchNorm's running statistics) and
    optimizer state starts[i].  ``make_step``: the model's step (default:
    the CIFAR-10 ``make_train_step``); AdamW's schedule decays once every
    ``steps_per_epoch`` steps.  Returns the losses, each step's
    gradients (on the CPU) and the snapshots before the first step and
    after each."""
    from convkan_tpu_torch.train.loop import make_train_step
    from convkan_tpu_torch.train.state import create_train_state
    # a CPU generator on both sides: the same dropout masks (the GPU run
    # copies each mask to the card)
    state = create_train_state(model, 1e-3, 1e-3, 0.8,
                               steps_per_epoch=steps_per_epoch,
                               generator=torch.Generator().manual_seed(7))
    step = make_step(model) if make_step else \
        make_train_step(model, "CIFAR10", augment=True)
    losses, grads, ends = [], [], [_snapshot(model, state)]
    for i, (xb, yb, o, f) in enumerate(batches):
        if starts is not None:  # start where the GPU run's step i did
            model.load_state_dict(starts[i][0])
            state.optimizer.load_state_dict(starts[i][1])
        losses.append(step(state, xb.to(device), yb.to(device),
                           offsets=o, flips=f).item())
        grads.append({n: p.grad.detach().cpu().clone()
                      for n, p in model.named_parameters()})
        ends.append(_snapshot(model, state))
    return losses, grads, ends


def f32_spread(model_cpu, batches, starts, steps, make_step, refs,
               steps_per_epoch=2):
    """{(step, parameter): max over F32_NOISE_SEEDS of max |g - ref| / max
    |ref|} of CPU float32 steps from ``starts`` with every KAN and WavKAN
    conv output (either route of a KAN conv) multiplied by 1 + F32_NOISE
    N(0, 1): how far float32 sums in another order lie from float64
    (``refs``) at those states."""
    from convkan_tpu_torch.nn import kan_conv as nk
    from convkan_tpu_torch.nn import wav_conv as nw

    sites = {nk: "kan_conv2d", nw: "wav_conv2d", nk.KanConvND: "_plain_conv"}
    plain = {m: getattr(m, n) for m, n in sites.items()}
    spread: dict = {}
    try:
        for seed in F32_NOISE_SEEDS:
            gen = torch.Generator().manual_seed(seed)
            for m, n in sites.items():
                def noisy(*a, _f=plain[m], **k):
                    y = _f(*a, **k)
                    return y * (1 + F32_NOISE * torch.randn(
                        y.shape, generator=gen, dtype=y.dtype))
                setattr(m, n, noisy)
            _, grads, _ = train_run(copy.deepcopy(model_cpu), "cpu",
                                    batches[:len(steps)],
                                    starts[:len(steps)], make_step,
                                    steps_per_epoch)
            for e, i, n in grad_readings(grads, refs, steps):
                spread[(i, n)] = max(spread.get((i, n), 0.0), e)
    finally:
        for m, n in sites.items():
            setattr(m, n, plain[m])
    return spread


def update_readings(begin, got, want, params):
    """(relative L2 distance of the update begin -> got from begin ->
    want over ``params``, max |got - want| over them, and the worst
    (max |diff| / max |want|, buffer) over the other entries: BatchNorm's
    running statistics; None without buffers)."""
    num = den = worst = 0.0
    stats = None
    for name, t in got.items():
        if name not in params:
            e = ((t - want[name]).abs().max() / want[name].abs().max()).item()
            stats = max(stats, (e, name)) if stats else (e, name)
            continue
        moved = want[name] - begin[name]
        num += ((t - begin[name]) - moved).square().sum().item()
        den += moved.square().sum().item()
        worst = max(worst, (t - want[name]).abs().max().item())
    return (num / den) ** 0.5, worst, stats


def grad_readings(grads, refs, steps):
    """(max |got - want| / max |want|, step, parameter) for every parameter
    of every step in ``steps``, largest first."""
    return sorted(((((grads[i][n] - g).abs().max() / g.abs().max()).item(),
                    i, n) for i in steps for n, g in refs[i].items()),
                  reverse=True)


def train_compare(mod, dev, kan_conv, lockstep=False, gpu_starts=False,
                  build=None, batches=None, make_step=None, f32_floor=False,
                  steps_per_epoch=2, **model_kw):
    """The train phases' runs and readings.  Three train steps of the
    seeded VGG16_small on the GPU and on the CPU (float32) with the same
    batches, crops, flips and dropout masks, and the compared steps in
    float64 on the CPU.  With ``lockstep`` every step is compared: the
    GPU's step i starts from the CPU run's parameters and optimizer state
    before it (the CPU's float32 trajectory is reproducible; the GPU's is
    not, since cuDNN's data gradient of the WavKAN base conv is not
    deterministic) or, with ``gpu_starts``, the CPU's from the GPU's; else
    each side runs its own steps and the first is compared.  Float64
    starts each step where the GPU did.  Returns the losses, the GPU
    steps' launch counts (``mod``; with its plain-route count where that is
    not 0), the gradient readings of the GPU
    against float64, the CPU against float64 and the GPU against the CPU,
    each (max |diff| / max |reference|, step, parameter) at its worst,
    the updates' relative L2 distance and max |diff| (GPU vs CPU) of the
    parameters, the buffers' (BatchNorm's running statistics) reading (max
    |GPU - CPU| / max |CPU| after each compared step, with its step and
    buffer; None without buffers), the same two readings of a control (the
    start of each compared update in place of the GPU's end: a step that
    neither updated nor moved a statistic), the GPU's gradients and the GPU
    model.  ``build``, ``batches`` and ``make_step`` replace the seeded
    VGG16_small, ``train_batches()`` and the CIFAR-10 step
    (``steps_per_epoch``: AdamW's schedule); with ``f32_floor`` also the
    float32 spread at the compared starts (``f32_spread``, under
    "spread"), else None."""
    model_cpu = build() if build else train_model(kan_conv, **model_kw)
    model_gpu = copy.deepcopy(model_cpu).to(dev)
    batches = batches or train_batches()
    run = functools.partial(train_run, make_step=make_step,
                            steps_per_epoch=steps_per_epoch)
    steps = range(TRAIN_STEPS) if lockstep else range(1)
    cpu_first = lockstep and not gpu_starts
    if cpu_first:
        losses_cpu, grads_cpu, snaps_cpu = run(model_cpu, "cpu", batches)
    mod.reset_launches()
    losses_gpu, grads_gpu, snaps_gpu = run(
        model_gpu, dev, batches, snaps_cpu[:-1] if cpu_first else None)
    torch.cuda.synchronize()
    counts = dict(mod.launches)
    counts.update({k: v for k, v in getattr(mod, "plain_calls", {}).items()
                   if v})
    if not cpu_first:
        losses_cpu, grads_cpu, snaps_cpu = run(
            model_cpu, "cpu", batches, snaps_gpu[:-1] if lockstep else None)
    # where the GPU's step i started
    starts = snaps_cpu if cpu_first else snaps_gpu
    _, grads_64, _ = run(copy.deepcopy(model_cpu).double(), "cpu",
                         batches[:len(steps)], starts[:len(steps)])
    spread = f32_spread(model_cpu, batches, starts, steps, make_step,
                        grads_64, steps_per_epoch) if f32_floor else None
    # (start, GPU end, CPU end) of each compared update
    spans = [(starts[i][0], snaps_gpu[i + 1][0], snaps_cpu[i + 1][0], i)
             for i in steps] if lockstep else \
        [(snaps_cpu[0][0], snaps_gpu[-1][0], snaps_cpu[-1][0],
          TRAIN_STEPS - 1)]
    params = {n for n, _ in model_cpu.named_parameters()}
    rel = worst = 0.0
    stats = control = None
    for begin, got, want, i in spans:
        r_i, w_i, s_i = update_readings(begin, got, want, params)
        rel, worst = max(rel, r_i), max(worst, w_i)
        if s_i is not None:
            stats = max(stats, (s_i[0], i, s_i[1])) if stats else \
                (s_i[0], i, s_i[1])
        r_0, _, s_0 = update_readings(begin, begin, want, params)
        c_i = (r_0, None if s_0 is None else s_0[0])
        control = c_i if control is None else \
            (min(control[0], c_i[0]), None if c_i[1] is None
             else min(control[1], c_i[1]))
    return {"losses_gpu": losses_gpu, "losses_cpu": losses_cpu,
            "counts": counts,
            "gpu_vs_f64": grad_readings(grads_gpu, grads_64, steps)[0],
            "gpu_readings": grad_readings(grads_gpu, grads_64, steps),
            "spread": spread,
            "cpu_readings": grad_readings(grads_cpu, grads_64, steps),
            "cpu_vs_f64": grad_readings(grads_cpu, grads_64, steps)[0],
            "gpu_vs_cpu": grad_readings(grads_gpu, grads_cpu, steps)[0],
            "update_rel": rel, "update_worst": worst, "stats": stats,
            "control": control,
            "grads_gpu": grads_gpu, "grads_64": grads_64,
            "model_gpu": model_gpu}


def phase_train(mod, dev, kan_conv, want_counts, grad_params, lockstep=False,
                zero_entries=(), n_convs=13, hold_grads=True, unheld=(),
                label=f"VGG16_small batch {TRAIN_BATCH}", **kw):
    """7 / 13 / 18 / 23 / 26 / 29 / 34. the training main path, by
    ``train_compare`` (``kw``: its model, batches and step, or the model's
    keywords): the losses (LOSS_RTOL), the GPU's gradients against float64
    (GRAD_TOL), the updates (UPDATE_TOL) and, with BatchNorm, the running
    statistics after each compared step (STATS_TOL); a step that did not
    update (and moved no statistic), or a zero gradient, must fail those
    checks (the control); with ``hold_grads`` False the gradients'
    readings are printed and not held (phase 39's B-spline model); those
    of the parameters whose names end in one of ``unheld`` are printed and
    neither held nor counted in the control's limit (path E's PReLU
    slopes, see STATIC_UNHELD).  Each of the model's ``n_convs`` KAN or
    WavKAN
    convs' ``grad_params`` must get a non-zero gradient, each
    (parameter, index) of ``zero_entries`` an exactly zero one (with its
    parameter's reading printed), and ``mod``'s launch counts must be
    ``want_counts`` per step.  Returns the launch counts of the GPU steps
    and the GPU model after them."""
    r = train_compare(mod, dev, kan_conv, lockstep, **kw)
    losses_gpu, losses_cpu, counts = (r["losses_gpu"], r["losses_cpu"],
                                      r["counts"])
    print(f"[train] {kan_conv} {label}, {TRAIN_STEPS} "
          f"steps{' in lockstep' if lockstep else ''}: losses GPU "
          f"{losses_gpu} CPU {losses_cpu}", flush=True)
    for lg, lc in zip(losses_gpu, losses_cpu):
        check(abs(lg - lc) <= LOSS_RTOL * abs(lc),
              f"train loss on the GPU {lg} vs the CPU {lc}")
    if unheld:
        free = [(e, i, n) for e, i, n in r["gpu_readings"]
                if n.endswith(unheld)]
        cpu_free = {(i, n): e for e, i, n in r["cpu_readings"]
                    if n.endswith(unheld)}
        print(f"[train] not held ({', '.join(unheld)}): GPU (CPU float32) "
              f"gradients vs float64, the worst: " + ", ".join(
                  f"{n} step {i} {e:.3e} ({cpu_free[(i, n)]:.3e})"
                  for e, i, n in free[:4]), flush=True)
        for key in ("gpu_readings", "cpu_readings"):
            r[key] = [t for t in r[key] if not t[2].endswith(unheld)]
        r["gpu_vs_f64"], r["cpu_vs_f64"] = r["gpu_readings"][0], \
            r["cpu_readings"][0]
        if r["spread"] is not None:
            r["spread"] = {k: v for k, v in r["spread"].items()
                           if not k[1].endswith(unheld)}
    worst_g, worst_step, worst_name = r["gpu_vs_f64"]
    cpu_g, cpu_step, cpu_name = r["cpu_vs_f64"]
    rel, worst = r["update_rel"], r["update_worst"]
    which = "every" if len(r["grads_64"]) > 1 else "first"
    print(f"[train] {which}-step gradients vs "
          f"float64 on the CPU: GPU max |diff| {worst_g:.3e} of each "
          f"parameter's largest entry (step {worst_step}, {worst_name}); "
          f"CPU float32 {cpu_g:.3e} (step {cpu_step}, {cpu_name}); GPU vs "
          f"CPU float32 {r['gpu_vs_cpu'][0]:.3e}", flush=True)
    print(f"[train] GPU vs CPU: parameter updates "
          f"{'of each step' if lockstep else f'over {TRAIN_STEPS} steps'} "
          f"differ by {rel:.3e} in relative L2 (max |diff| {worst:.3e})",
          flush=True)
    # a zero gradient reads 1 against any reference
    grad_limit = GRAD_TOL
    if r["spread"] is None:
        check(worst_g <= GRAD_TOL or not hold_grads,
              "GPU gradients differ from float64")
    else:
        # each gradient within GRAD_TOL, or within F32_SPREAD x the float32
        # spread at its start (see F32_NOISE)
        spread = r["spread"]
        cpu = {(i, n): e for e, i, n in r["cpu_readings"]}
        over = [(e, i, n, spread[(i, n)]) for e, i, n in r["gpu_readings"]
                if e > GRAD_TOL]
        top = max(spread.items(), key=lambda kv: kv[1])
        grad_limit = max(GRAD_TOL, F32_SPREAD * top[1])
        print(f"[train] float32 spread at the same starts (conv outputs x "
              f"(1 + {F32_NOISE:g} N(0, 1)), seeds {F32_NOISE_SEEDS}): max "
              f"{top[1]:.3e} (step {top[0][0]}, {top[0][1]}); GPU readings "
              f"over GRAD_TOL (CPU float32's, the spread): "
              + (", ".join(f"{n} step {i} {e:.3e} ({cpu[(i, n)]:.3e}, "
                           f"{f:.3e})" for e, i, n, f in over) or "none"),
              flush=True)
        check(not hold_grads or all(e <= F32_SPREAD * f
                                    for e, _, _, f in over),
              "GPU gradients differ from float64 by more than GRAD_TOL and "
              f"{F32_SPREAD} x float32's spread at the same start")
    check(rel <= UPDATE_TOL, "parameter updates differ between GPU and CPU")
    if r["stats"] is not None:
        e, st, name = r["stats"]
        print(f"[train] running statistics GPU vs CPU after "
              f"{'each step' if lockstep else f'{TRAIN_STEPS} steps'}: max "
              f"|diff| {e:.3e} of the buffer's largest entry (step {st}, "
              f"{name})", flush=True)
        check(e <= STATS_TOL, "running statistics differ between GPU and "
                              "CPU")
    c_upd, c_stats = r["control"]
    print(f"[train] control, a step that did nothing: update {c_upd:.3e} "
          f"(UPDATE_TOL {UPDATE_TOL}), running statistics "
          + ("-" if c_stats is None else
             f"{c_stats:.3e} (STATS_TOL {STATS_TOL})")
          + (f"; a zero gradient 1 (limit {grad_limit:.3e})" if hold_grads
             else "; gradients not held"), flush=True)
    check(c_upd > UPDATE_TOL and (c_stats is None or c_stats > STATS_TOL)
          and (grad_limit < 1 or not hold_grads),
          "the control passes the checks")
    convs = [(n, m) for n, m in r["model_gpu"].named_modules()
             if type(m).__name__ in ("KanConvND", "WavKANConvND")]
    check(len(convs) == n_convs, f"{len(convs)} convs in the model")
    for name, m in convs:
        for pn in grad_params:
            grad = getattr(m, pn).grad
            check(grad is not None and bool(grad.abs().sum() > 0),
                  f"{name}.{pn} got no gradient on the GPU")
        for pn, i in zero_entries:
            check(getattr(m, pn).grad[i] == 0,
                  f"{name}.{pn}[{i}] got a non-zero gradient on the GPU")
    for pn in dict.fromkeys(p for p, _ in zero_entries):
        worst = max((e, st, n) for e, st, n in grad_readings(
            r["grads_gpu"], r["grads_64"], range(len(r["grads_64"])))
            if n.endswith("." + pn))
        print(f"[train] {pn}: GPU gradients vs float64 max |diff| "
              f"{worst[0]:.3e} of the parameter's largest entry (step "
              f"{worst[1]}, {worst[2]}); entries "
              f"{[i for q, i in zero_entries if q == pn]} exactly 0 in "
              f"every conv", flush=True)
    print(f"[train] {kan_conv} kernel launches on the main path "
          f"({TRAIN_STEPS} steps): {counts}", flush=True)
    check(counts == {k: TRAIN_STEPS * v for k, v in want_counts.items()},
          f"expected per step {want_counts}, got {counts} in {TRAIN_STEPS}")
    return counts, r["model_gpu"]


def time_train_step(kan_conv, dev, card, label=None, **model_kw):
    """Median images/s of the VGG16_small train step at batch TIME_BATCH
    (printed as ``label``, default ``kan_conv``)."""
    from convkan_tpu_torch.models.vgg import vggkan
    from convkan_tpu_torch.train.data import _synthetic
    from convkan_tpu_torch.train.loop import make_train_step
    from convkan_tpu_torch.train.state import create_train_state

    model = vggkan(3, 10, arch="VGG16_small", kan_conv=kan_conv,
                   classifier_type="Linear",
                   generator=torch.Generator().manual_seed(3), device=dev,
                   **model_kw)
    # CIFAR-10's 50,000 images in full batches; generator on the card
    state = create_train_state(model, steps_per_epoch=50000 // TIME_BATCH)
    step = make_train_step(model, "CIFAR10", augment=True)
    x, y = _synthetic("CIFAR10", TIME_BATCH, seed=8)
    x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    for _ in range(3):
        step(state, x, y).item()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(12):
        t0 = time.perf_counter()
        step(state, x, y).item()  # host readback: the step is done
        runs.append(TIME_BATCH / (time.perf_counter() - t0))
    ips = statistics.median(runs)
    print(f"[time] {label or kan_conv} train step batch {TIME_BATCH}: median "
          f"{ips:.1f} images/s ({1e3 * TIME_BATCH / ips:.3f} ms) over "
          f"{len(runs)} steps (min {min(runs):.1f}, max {max(runs):.1f}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"on {card}", flush=True)
    return ips


def phase_train_times(kc, basis, rows_nz, kan_conv, gen, dev, card,
                      tag="[time]", suffix="", **model_kw):
    """8 / 19. the train step at batch TIME_BATCH (of the ``kan_conv`` model)
    and the backward kernels per conv shape for ``basis``, whose bound
    counts ``rows_nz`` rows of E per interior pair (host-bound readings
    recorded under the kernel's name + ``suffix``); returns (images/s,
    per-kernel totals, rows).  A basis with a learnable operand (Gram's
    beta, ``conv_extra``): its data-gradient kernel also writes the
    operand's partials (and runs, with dx not stored, at the first conv
    too), and the reduction's times add the partials' reduction to dW's."""
    ips = time_train_step(kan_conv, dev, card, **model_kw)

    names = ("kan_conv2d_bwd_dx", "kan_conv2d_bwd_dw",
             "kan_conv2d_bwd_dw_reduce")
    totals = {n: dict.fromkeys(("ms", "plain_ms", "library_ms", "op_ms",
                                "byte_ms"), 0.0) for n in names}
    for name in names[:2]:
        totals[name]["dense_bound_ms"] = 0.0
    totals["kan_conv2d_bwd_dw_reduce"].update(warm_l2_ms=0.0,
                                              library_warm_l2_ms=0.0)
    rows = []
    B, K, R = TIME_BATCH, basis.K, basis.R
    for H, C, O in dict.fromkeys(VGG16_SMALL_CONVS):
        x, bw, pw = (None if t is None else t.to(dev) for t in conv_inputs(
            gen, B, H, C, O, basis=basis))
        beta = conv_extra(gen, C, basis)
        ex = () if beta is None else (beta.to(dev),)
        g = torch.randn(B, H, H, O, generator=gen).to(dev)
        spec = (basis, 3, 1)
        w_all = kc.pack_w_all(bw, pw, C=C, K=K, k=3, O=O,
                              degree_major=basis.degree_major)
        cfg = kc.dw_launch_config(B, H, H, C, O, 3, 1, R)
        part = kc.weight_partials(x, g, *spec, *ex)
        rcfg = kc.reduce_launch_config(part.shape[0], part[0].numel())
        red = reduction_times("kan_conv2d_bwd_dw_reduce" + suffix,
                              kc.reduce_partials, kc.reduce_reference, part)
        first = (H, C, O) == VGG16_SMALL_CONVS[0]
        if ex:
            # the operand's partials: the first conv's launch stores no dx
            _, epart = kc.input_extra_grad(x, w_all, g, *spec, *ex)
            ered = reduction_times("kan_conv2d_bwd_dw_reduce" + suffix,
                                   kc.reduce_partials, kc.reduce_reference,
                                   epart)

            def data_grad():
                return kc.input_extra_grad(x, w_all, g, *spec, *ex,
                                           need_dx=not first)

            def data_grad_plain():
                return (kc.input_grad_reference(x, w_all, g, *spec, *ex),
                        kc.extra_grad_reference(x, w_all, g, *spec, *ex))
        else:
            def data_grad():
                return kc.input_grad(x, w_all, g, *spec)

            def data_grad_plain():
                return kc.input_grad_reference(x, w_all, g, *spec)
        ms = {
            "kan_conv2d_bwd_dx": (
                cuda_ms(data_grad),
                cuda_ms(data_grad_plain, iters=3, warmup=1,
                        what=("kan_conv2d_bwd_dx" + suffix, "plain_ms"))),
            "kan_conv2d_bwd_dw": (
                cuda_ms(lambda: kc.weight_partials(x, g, *spec, *ex)),
                cuda_ms(lambda: kc.weight_grad_reference(x, g, *spec, *ex),
                        iters=3, warmup=1,
                        what=("kan_conv2d_bwd_dw" + suffix, "plain_ms"))),
            "kan_conv2d_bwd_dw_reduce": (red["ms"], red["plain_ms"]),
        }
        if ex:  # one reduction of dW and one of the operand per conv
            red_extra = {key: ered[key] for key in ("ms", "library_ms",
                                                    "warm_l2_ms")}
            red = {key: red[key] + ered[key] for key in red}
            ms["kan_conv2d_bwd_dw_reduce"] = (red["ms"], red["plain_ms"])
        # yardsticks the port never calls: cuDNN's backward over an already
        # materialized basis (dE and dW of the convolution), and one sum
        E = kc.expand(x, basis, *ex).permute(0, 3, 1, 2).contiguous()
        w = w_all.reshape(R * C, 3, 3, O).permute(3, 0, 1, 2).contiguous()
        gn = g.permute(0, 3, 1, 2).contiguous()

        def conv_bwd(mask):
            return torch.ops.aten.convolution_backward(
                gn, E, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                mask)

        lib = {"kan_conv2d_bwd_dx": cuda_ms(lambda: conv_bwd(
                   [True, False, False]), iters=10,
                   what=("kan_conv2d_bwd_dx" + suffix, "library_ms")),
               "kan_conv2d_bwd_dw": cuda_ms(lambda: conv_bwd(
                   [False, True, False]), iters=10,
                   what=("kan_conv2d_bwd_dw" + suffix, "library_ms")),
               "kan_conv2d_bwd_dw_reduce": red["library_ms"]}
        n = VGG16_SMALL_CONVS.count((H, C, O))
        del E, gn
        D, TO, S = R * C, 9 * O, cfg["S"]
        # the bound: interior pairs x the rows non-zero at x (rows_nz);
        # issued work is read against interior pairs x every row, and the
        # dense bound counts every pair and row
        flops = 2 * B * interior_pairs(H) * rows_nz * C * O
        interior_macs = B * interior_pairs(H) * D * O
        dense_flops = 2 * B * H * H * 9 * D * O
        work = {
            "kan_conv2d_bwd_dx": (flops, 4 * (2 * x.numel() + w_all.numel()
                                              + g.numel())),
            "kan_conv2d_bwd_dw": (flops, 4 * (x.numel() + g.numel()
                                              + S * D * TO)),
            "kan_conv2d_bwd_dw_reduce": reduce_work(S, D * TO),
        }
        row = {"H": H, "C": C, "O": O, "batch": B, "layers": n, "S": S}
        if ex:
            # the operand's terms in the data gradient's epilogue; its
            # partials written there and reduced; the first conv's launch
            # reads g and x and writes no dx
            Se, NE = epart.shape
            work["kan_conv2d_bwd_dx"] = (
                flops + GRAM_DBETA_FLOPS * B * H * H * C,
                4 * ((1 if first else 2) * x.numel() + w_all.numel()
                     + g.numel() + Se * NE))
            ew = reduce_work(Se, NE)
            work["kan_conv2d_bwd_dw_reduce"] = tuple(
                a + b for a, b in zip(work["kan_conv2d_bwd_dw_reduce"], ew))
            row["extra_reduce"] = {"S": Se, "N": NE, **{
                key: round(v, 4) for key, v in red_extra.items()}}
        for name in names:
            layers = n - 1 if name == "kan_conv2d_bwd_dx" and first and \
                not ex else n
            op_ms = work[name][0] / PEAK_FP32_FLOPS * 1e3
            byte_ms = work[name][1] / PEAK_BYTES * 1e3
            row[name] = {"layers": layers, "ms": round(ms[name][0], 4),
                         "plain_ms": round(ms[name][1], 4),
                         "library_ms": round(lib[name], 4),
                         "bound_ms": round(max(op_ms, byte_ms), 4)}
            for key, v in (("ms", ms[name][0]), ("plain_ms", ms[name][1]),
                           ("library_ms", lib[name]), ("op_ms", op_ms),
                           ("byte_ms", byte_ms)):
                totals[name][key] += layers * v
        # the weight gradient's tile and what it issues: every input pixel
        # times every row (whole channels of its chunks) and column (whole
        # column tiles) of dW, pad pairs included
        issued = B * H * H * -(-C // cfg["CC"]) * cfg["CC"] * R * \
            -(-9 * O // cfg["BN"]) * cfg["BN"]
        dw_row = row["kan_conv2d_bwd_dw"]
        dw_row.update({
            "tile": {key: cfg[key] for key in DW_TILE},
            "issued_over_interior": round(issued / interior_macs, 4),
            "bound_share": round(dw_row["bound_ms"] / ms[
                "kan_conv2d_bwd_dw"][0], 4),
            "tflops_issued": round(2 * issued / ms["kan_conv2d_bwd_dw"][0]
                                  / 1e9, 2)})
        # the data gradient's tile and what it issues: its (pixel, tap)
        # pairs (pad pairs and idle pixel slots included) times whole
        # channel blocks, R and whole chunks of output channels
        xcfg = kc.dx_launch_config(B, H, H, C, O, 3, 1, R)
        x_issued = dx_pairs(kc, xcfg, B, H, H, 3, 1) * \
            -(-C // xcfg["CC"]) * xcfg["CC"] * R * \
            -(-O // xcfg["OC"]) * xcfg["OC"]
        x_ms = ms["kan_conv2d_bwd_dx"][0]
        dx_row = row["kan_conv2d_bwd_dx"]
        dx_row.update({
            "tile": {key: xcfg[key] for key in (*kc.DX_TILE, "blocks")},
            "issued_over_interior": round(x_issued / interior_macs, 4),
            "bound_share": round(dx_row["bound_ms"] / x_ms, 4),
            "tflops_issued": round(2 * x_issued / x_ms / 1e9, 2)})
        for name in names[:2]:
            dense_ms = max(dense_flops / PEAK_FP32_FLOPS * 1e3,
                           work[name][1] / PEAK_BYTES * 1e3)
            row[name]["dense_bound_ms"] = round(dense_ms, 4)
            totals[name]["dense_bound_ms"] += row[name]["layers"] * dense_ms
        red_row(row["kan_conv2d_bwd_dw_reduce"], rcfg, red,
                totals["kan_conv2d_bwd_dw_reduce"], n)
        rows.append(row)
        print(f"{tag} {json.dumps(row)}", flush=True)
    for name in names:
        t = totals[name]
        t["bound_ms"] = max(t["op_ms"], t["byte_ms"])
        if name == "kan_conv2d_bwd_dw_reduce":
            print_red_totals(tag, name, t, card)
            continue
        dense = f" (dense {t['dense_bound_ms']:.3f} ms)" \
            if "dense_bound_ms" in t else ""
        print(f"{tag} {name} per train step at batch {B}: kernel "
              f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, library "
              f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms"
              f"{dense}, {100 * t['bound_ms'] / t['ms']:.1f}% of the bound "
              f"(on {card})", flush=True)
    return ips, totals, rows


def phase_model(mod, kan_conv, fwd_name, dev, imgs, f64=False, **model_kw):
    """3 / 11 / 16. VGG16_small with seeded weights on the card against the
    same state_dict on the CPU (MODEL_TOL); returns the GPU model (eval
    mode) and the tolerance its logits were held to.  With ``f64`` (a model
    whose float32 logits are worse conditioned than MODEL_TOL, see
    CHEBY_F32) the GPU's and the CPU's float32 logits are both held to the
    CPU's float64 ones, the GPU's within CHEBY_F32 times the CPU's float32
    distance plus MODEL_TOL."""
    from convkan_tpu_torch.models.vgg import vggkan
    from convkan_tpu_torch.train.data import normalize_batch

    model_cpu = vggkan(3, 10, arch="VGG16_small", kan_conv=kan_conv,
                       classifier_type="Linear",
                       generator=torch.Generator().manual_seed(0),
                       device="cpu", **model_kw).eval()
    model_gpu = copy.deepcopy(model_cpu).to(dev)
    with torch.inference_mode():
        want = model_cpu(normalize_batch(torch.from_numpy(imgs), "CIFAR10"))
        mod.reset_launches()
        got = model_gpu(normalize_batch(torch.from_numpy(imgs).to(dev),
                                        "CIFAR10")).cpu()
        torch.cuda.synchronize()
    n_launch = mod.launches[fwd_name]
    check(sum(mod.launches.values()) == n_launch,
          f"inference launched a backward kernel: {mod.launches}")
    err = (got - want).abs().max().item()
    print(f"[model] {kan_conv} VGG16_small logits {tuple(got.shape)} GPU vs "
          f"CPU max|err| {err:.3e}; kernel launches per forward {n_launch}",
          flush=True)
    check(bool(torch.isfinite(got).all()), "model logits not finite")
    check((got - got[0]).abs().max().item() > 1e-3,
          "the logits are the same for every image")
    check(n_launch == 13, f"expected 13 kernel launches, got {n_launch}")
    if not f64:
        check(torch.allclose(got, want, rtol=MODEL_TOL, atol=MODEL_TOL),
              "model logits on the GPU disagree with the CPU")
        return model_gpu, MODEL_TOL
    with torch.inference_mode():
        exact = copy.deepcopy(model_cpu).double()(normalize_batch(
            torch.from_numpy(imgs), "CIFAR10").double())
    e_cpu = (want.double() - exact).abs().max().item()
    e_gpu = (got.double() - exact).abs().max().item()
    tol = CHEBY_F32 * e_cpu + MODEL_TOL
    print(f"[model] {kan_conv} logits vs float64 on the CPU: GPU max|err| "
          f"{e_gpu:.3e}, CPU float32 {e_cpu:.3e} (allowed: {CHEBY_F32} x the "
          f"CPU's + MODEL_TOL = {tol:.3e})", flush=True)
    check(e_gpu <= tol, "model logits on the GPU further from float64 than "
                        "the CPU's float32 allows")
    return model_gpu, tol


def phase_serve(mod, kan_conv, fwd_name, imgs, tol=TOL, model=None,
                **model_kw):
    """4 / 12 / 17 / 22 / 27. serving, the main path: launch counts are
    zeroed, an InferenceEngine starts (with ``model``, or a seeded
    VGG16_small), the HTTP server answers 8 concurrent clients x 4
    single-image requests and one 64-image request (``imgs``), the answers
    are checked against engine.predict (within ``tol``: the two run the
    model at other batch sizes, so cuDNN and cuBLAS sum in other orders),
    and the counts are read.  Returns the forward launches and the served
    logits of ``imgs``."""
    from convkan_tpu_torch.models.vgg import vggkan
    from convkan_tpu_torch.serve import InferenceEngine, make_server

    mod.reset_launches()
    if model is None:
        model = vggkan(3, 10, arch="VGG16_small", kan_conv=kan_conv,
                       classifier_type="Linear",
                       generator=torch.Generator().manual_seed(1),
                       device="cuda", **model_kw)
    engine = InferenceEngine(model, "CIFAR10", (32, 32, 3),
                             buckets=(1, 8, 64), batch_timeout_ms=5.0,
                             device="cuda")
    server = make_server(engine, model.model_name, "127.0.0.1", 0)
    srv_thread = threading.Thread(target=server.serve_forever, daemon=True)
    srv_thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def post(batch):
        req = urllib.request.Request(
            url + "/predict", data=json.dumps(
                {"instances": batch.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    req_imgs = np.random.RandomState(2).randint(0, 256, (32, 32, 32, 3),
                                                np.uint8)
    answers: dict = {}
    errors: list = []

    def client(c):
        try:
            for r in range(4):
                i = c * 4 + r
                answers[i] = post(req_imgs[i:i + 1])
        except Exception as e:  # collected and reported below
            errors.append(f"client {c}: {type(e).__name__}: {e}")

    try:
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=120)
        check(not any(t.is_alive() for t in clients), "HTTP clients hung")
        check(not errors, f"HTTP errors: {errors}")
        check(len(answers) == 32, f"{len(answers)} of 32 answers")
        big = post(imgs)
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            metrics = json.loads(r.read())
        n_main = mod.launches[fwd_name]
    finally:
        server.shutdown()
        server.server_close()
        srv_thread.join(timeout=10)
        engine.close()
    direct = engine.predict(req_imgs)
    single = np.array([answers[i]["predictions"][0] for i in range(32)])
    serr = float(np.abs(single - direct).max())
    berr = float(np.abs(np.array(big["predictions"])
                        - engine.predict(imgs)).max())
    print(f"[serve] {model.model_name}: 32 single-image requests from 8 "
          f"clients, max|err| vs predict {serr:.3e}; 64-image request "
          f"max|err| {berr:.3e}", flush=True)
    print(f"[serve] /metrics {json.dumps(metrics)}", flush=True)
    print(f"[serve] kernel launches on the main path: {n_main}", flush=True)
    check(serr <= tol and berr <= tol, "served logits disagree with predict")
    check(big["batch"] == 64 and metrics["requests"] == 33,
          "server counted the wrong requests")
    steps = metrics["device_batches"] + len(engine.buckets)  # + warm-up
    check(n_main == 13 * steps, f"{n_main} launches for {steps} forwards")
    return n_main, np.array(big["predictions"])


def time_predict(model_gpu, kan_conv, card):
    """predict at batch 1024: median images/s of 10 calls."""
    from convkan_tpu_torch.serve import InferenceEngine

    bench = InferenceEngine(model_gpu, "CIFAR10", (32, 32, 3),
                            buckets=(1024,), device="cuda")
    try:
        x1024 = np.random.RandomState(3).randint(0, 256, (1024, 32, 32, 3),
                                                 np.uint8)
        runs = []
        for _ in range(10):
            t0 = time.perf_counter()
            bench.predict(x1024)  # returns host numpy: the device is done
            runs.append(1024 / (time.perf_counter() - t0))
    finally:
        bench.close()
    ips = statistics.median(runs)
    print(f"[time] {kan_conv} predict batch 1024: median {ips:.1f} "
          f"images/s over {len(runs)} runs (min {min(runs):.1f}, max "
          f"{max(runs):.1f}) on {card}", flush=True)
    return ips


# ---------------------------------------------------------------- WavKAN
def wav_inputs(gen, B, H, W, C, O, scale=1.0):
    """x, w, translation 0.5 N, scale 1 + 0.3 U (off their 0 / 1 init)."""
    x = torch.randn(B, H, W, C, generator=gen) * scale
    w = torch.randn(3, 3, C, O, generator=gen) * 0.1
    t = 0.5 * torch.randn(O, C, generator=gen)
    s = 1.0 + 0.3 * torch.rand(O, C, generator=gen)
    return x, w, t, s


def phase_wav_forward(wc, gen, dev):
    """9. the forward kernel against its plain version, and two calls
    bit-identical; returns max |err|."""
    cases = [(64, H, H, C, O, "mexican_hat", 1.0, 1)
             for H, C, O in dict.fromkeys(VGG16_SMALL_CONVS)]
    cases += [(16, 16, 16, 16, 32, w, 1.0, 1) for w in WAVELETS]
    # each compiled width (its pad taps left out) in every wavelet
    cases += [(6, H, H, C, 24, w, 1.0, 1) for H, C in ((8, 16), (4, 32),
                                                     (2, 64))
              for w in WAVELETS]
    cases += [(1, 32, 32, 3, 16, "mexican_hat", 1.0, 1),    # batch 1
              (1, 2, 2, 128, 128, "mexican_hat", 1.0, 1),   # batch 1, 2x2
              (3, 7, 5, 13, 5, "mexican_hat", 1.0, 1),      # ragged
              (2, 11, 13, 5, 9, "shannon", 1.0, 1),         # generic, odd
              (3, 8, 8, 20, 9, "morlet", 1.0, 1),           # C, O ragged
              (3, 4, 4, 5, 16, "mexican_hat", 1.0, 0),      # pad 0
              (2, 3, 5, 4, 12, "dog", 1.0, 2),              # pad 2
              (8, 8, 8, 32, 64, "mexican_hat", 3.0, 1)]     # x scaled
    cases += [(64, H, H, C, O, "mexican_hat", 1.0, 1)
              for H, C, O in CONFIG4_CONVS]
    max_err = 0.0
    for B, H, W, C, O, wt, scale, pad in cases:
        x, w, t, s = (a.to(dev) for a in wav_inputs(gen, B, H, W, C, O,
                                                    scale))
        y = wc.wav_conv2d(x, w, t, s, wavelet_type=wt, padding=pad)
        same = torch.equal(y, wc.wav_conv2d(x, w, t, s, wavelet_type=wt,
                                            padding=pad))
        torch.cuda.synchronize()
        ref = wc.wav_conv2d_reference(x, w, t, s, wavelet_type=wt,
                                      padding=pad)
        err = (y - ref).abs().max().item()
        ok = torch.allclose(y, ref, rtol=TOL, atol=TOL)
        cfg = wc.fwd_launch_config(B, H, W, C, O, 3, pad)
        print(f"[wav kernel] B={B} {H}x{W} C={C} O={O} x*{scale} {wt} "
              f"pad={pad} ({wav_fwd_tile(cfg)}): max|err| {err:.3e}, two "
              f"calls {'bit-identical' if same else 'DIFFERENT'} "
              f"{'ok' if ok and same else 'FAIL'}", flush=True)
        check(bool(torch.isfinite(y).all()), "WavKAN kernel output not "
                                             "finite")
        check(ok, f"WavKAN kernel disagrees with the plain version (B={B} "
                  f"{H}x{W} C={C} O={O} {wt} pad={pad})")
        check(same, f"WavKAN kernel: two calls differ (B={B} {H}x{W} C={C} "
                    f"O={O} {wt} pad={pad})")
        max_err = max(max_err, err)
    return max_err


def phase_wav_backward(wc, gen, dev):
    """10. each backward kernel and the autograd path against float64
    autograd of the plain version; returns max |err| per kernel."""
    cases = [(64, H, H, C, O, "mexican_hat", 1)
             for H, C, O in dict.fromkeys(VGG16_SMALL_CONVS)]
    cases += [(8, 8, 8, 16, 32, w, 1) for w in WAVELETS[1:]]
    # the parameter kernel's generic rows (W = 5, 7; pads 0 and 2) and
    # ragged tiles: C = 13, 5, 3 (not a multiple of its 4 channels per
    # thread), H = 1 (both outer g rows off the frame), O = 5 and 20 (idle
    # lanes, 4-byte copies), a ragged last split
    cases += [(3, 7, 5, 13, 5, "mexican_hat", 1),
              (5, 5, 7, 5, 16, "mexican_hat", 1),
              (9, 1, 8, 6, 32, "mexican_hat", 1),
              (4, 6, 4, 3, 8, "mexican_hat", 1),
              (37, 3, 2, 13, 20, "mexican_hat", 1),
              (3, 4, 4, 5, 16, "mexican_hat", 0),
              (2, 3, 5, 4, 12, "mexican_hat", 2)]
    # the data gradient's compiled rows of 4 and 2 in every wavelet, compiled
    # widths at odd H (8 and 4 wide) and one taken by the generic tile (2 wide,
    # H = 5),
    # O = 9 (4-byte copies of g, a partial chunk), width 11 at pad 0
    cases += [(6, H, H, C, 32, w, 1) for H, C in ((4, 32), (2, 64))
              for w in WAVELETS[1:]]
    cases += [(5, 3, 8, 16, 20, "mexican_hat", 1),
              (4, 5, 4, 16, 9, "mexican_hat", 1),
              (4, 5, 2, 16, 9, "mexican_hat", 1),
              (3, 5, 11, 12, 13, "shannon", 0)]
    errs = dict.fromkeys(wc.KERNELS[1:], 0.0)
    red64 = 0.0   # the reduced gradients against float64, as in phase 6
    for B, H, W, C, O, wt, pad in cases:
        x, w, t, s = (a.to(dev) for a in wav_inputs(gen, B, H, W, C, O))
        g = torch.randn(B, H + 2 * pad - 2, W + 2 * pad - 2, O,
                        generator=gen).to(dev)
        spec = (wt, pad)
        wf = w
        if wt == "shannon":  # the kernels take the window folded into w
            wf = w * torch.from_numpy(wc.hamming_window(C)).to(w)[:, None]
        cfg = wc.param_launch_config(B, H, W, C, O, 3, pad)
        xcfg = wc.dx_launch_config(B, H, W, C, O, 3, pad)
        dx = wc.input_grad(x, wf, t, s, g, *spec)
        dx_same = torch.equal(dx, wc.input_grad(x, wf, t, s, g, *spec))
        part = wc.param_partials(x, wf, t, s, g, *spec)
        same = torch.equal(part, wc.param_partials(x, wf, t, s, g, *spec))
        red = wc.reduce_partials(part)
        torch.cuda.synchronize()
        d64 = [a.double() for a in (x, wf, t, s, g)]
        e_dx, ok_dx = bwd_close(dx, wc.input_grad_reference(*d64, *spec))
        e_p, ok_p = bwd_close(part, wc.param_partials_reference(
            *d64, *spec, cfg["S"], cfg["ips"]))
        e_red = (red - wc.reduce_reference(part)).abs().max().item()
        e64, ok64 = bwd_close(red, wc.param_grads_reference(*d64, *spec))
        red64 = max(red64, e64)
        rcfg = wc.reduce_launch_config(*part.shape)
        leaves = [a.clone().requires_grad_(True) for a in (x, w, t, s)]
        got = torch.autograd.grad(wc.wav_conv2d(
            *leaves, wavelet_type=wt, padding=pad), leaves, g)
        ref = [a.double().requires_grad_(True) for a in (x, w, t, s)]
        want = torch.autograd.grad(wc.wav_conv2d_reference(
            *ref, wavelet_type=wt, padding=pad), ref, g.double())
        auto = [bwd_close(a, b) for a, b in zip(got, want)]
        ok = ok_dx and dx_same and ok_p and same and e_red == 0.0 and \
            ok64 and all(o for _, o in auto)
        print(f"[wav backward] B={B} {H}x{W} C={C} O={O} {wt} pad={pad} "
              f"(dx tile {wav_dx_tile(xcfg)}; param tile {param_tile(cfg)}; "
              f"reduce {red_tile(rcfg)}): dx {e_dx:.3e}, dx of two calls "
              f"{'bit-identical' if dx_same else 'DIFFERENT'}, param "
              f"partials of two calls "
              f"{'bit-identical' if same else 'DIFFERENT'}, "
              f"param partials {e_p:.3e}, reduce {e_red:.1e} (reduced vs "
              f"float64 {e64:.3e}); autograd dx/dw/dt/ds "
              f"{'/'.join(f'{e:.3e}' for e, _ in auto)} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        for a in (dx, part, *got):
            check(bool(torch.isfinite(a).all()), "backward output not finite")
        check(ok, f"WavKAN backward kernels disagree with the plain version "
                  f"(B={B} {H}x{W} C={C} O={O} {wt} pad={pad})")
        for name, e in (("wav_conv2d_bwd_dx", max(e_dx, auto[0][0])),
                        ("wav_conv2d_bwd_param",
                         max(e_p, *(a for a, _ in auto[1:]))),
                        ("wav_conv2d_bwd_reduce", e_red)):
            errs[name] = max(errs[name], e)
    print(f"[wav backward] reduced dw/dt/ds vs float64 autograd: max |err| "
          f"{red64:.3e} (within BWD_TOL in every case)", flush=True)
    return errs


def wav_bound(name, B, H, C, O, S, N):
    """(operations ms, bytes ms) of one WavKAN kernel at batch B: taps whose
    input lies in the image (the pad's psi is 0), one exp per psi."""
    fmas = B * interior_pairs(H) * C * O
    exps = B * H * H * C * O
    x, g, p = B * H * H * C, B * H * H * O, 9 * C * O + 2 * O * C
    ops_ms = {
        "wav_conv2d_fwd": max(2 * fmas / PEAK_FP32_FLOPS, exps / PEAK_EXP),
        "wav_conv2d_bwd_dx": max(2 * fmas / PEAK_FP32_FLOPS, exps / PEAK_EXP),
        "wav_conv2d_bwd_param": max(4 * fmas / PEAK_FP32_FLOPS,
                                    exps / PEAK_EXP),
        "wav_conv2d_bwd_reduce": reduce_work(S, N)[0] / PEAK_FP32_FLOPS,
    }[name] * 1e3
    nbytes = {"wav_conv2d_fwd": 4 * (x + p + g),
              "wav_conv2d_bwd_dx": 4 * (2 * x + p + g),
              "wav_conv2d_bwd_param": 4 * (x + g + p + S * N),
              "wav_conv2d_bwd_reduce": reduce_work(S, N)[1]}[name]
    return ops_ms, nbytes / PEAK_BYTES * 1e3


def wav_fwd_tile(cfg) -> str:
    """The WavKAN forward's launch: compiled width (0: strips with a
    halo), strip width, output channels and tile slots of a block, band
    rows, bands, threads, blocks, blocks per SM, waves, shared memory."""
    return ", ".join(f"{key} {cfg[key]}" for key in FWD_TILE[:-2]) + \
        f", waves {cfg['waves']:.2f}, smem {cfg['smem']} B"


def wav_fwd_issued(cfg, B, H, W, C, O, pad=1) -> tuple:
    """(psi, tap FMAs) the WavKAN forward issues, modelled from its launch
    configuration (not counted on the card): per virtual row of each band
    inside the image, the strip's staged columns on the image (psi) and,
    per tap row whose output row is in the band, its taps (the compiled
    widths: those on the row; the strips: every column), x whole quads of
    4 channels x B x O.  tests/test_torch_wav_fwd_kernel.py holds it
    against the counts of a replay of the kernel's loops."""
    Ho, Wo = H + 2 * pad - 2, W + 2 * pad - 2
    TW, TWH, RB = cfg["TW"], cfg["TWH"], cfg["RB"]
    taps = 3 * TW - 2 if cfg["compiled"] else 3 * TW
    cq = 4 * sum(-(-min(cfg["CC"], C - c0) // 4)
                 for c0 in range(0, C, cfg["CC"]))
    psi = fma = 0
    for i0 in range(0, Ho, RB):
        i1 = min(i0 + RB, Ho)
        for V in range(max(i0, pad), min(i1 + 2, H + pad)):
            rows = sum(i0 <= V - di < i1 for di in range(3))
            for j0 in range(0, Wo, TW):
                c0 = j0 - pad if not cfg["compiled"] else 0
                psi += sum(0 <= c0 + q < W for q in range(TWH))
                fma += taps * rows
    return B * O * cq * psi, B * O * cq * fma


def param_tile(cfg) -> str:
    """The parameter kernel's launch: channels per thread, threads, row
    slots, rows per step, cp.async pipeline, compiled row width, splits,
    blocks, blocks per SM, waves and shared memory."""
    return ", ".join(f"{key} {cfg[key]}" for key in PARAM_TILE[:-2]) + \
        f", waves {cfg['waves']:.2f}, smem {cfg['smem']} B"


def wav_dx_tile(cfg) -> str:
    """The WavKAN data gradient's launch: compiled width (0: segments of
    8), pixels and rows of a tile, channel groups, tile positions and
    images of a block, threads, blocks, blocks per SM, waves, shared
    memory."""
    return ", ".join(f"{key} {cfg[key]}" for key in DX_TILE[:-2]) + \
        f", waves {cfg['waves']:.2f}, smem {cfg['smem']} B"


def wav_dx_issued(cfg, B, H, W, C, O, pad=1) -> int:
    """(pixel, tap, o, c) the WavKAN data gradient issues: compiled widths
    the taps whose g lies on the frame; the generic tile every tap of the
    pixels of whole segments of 8; x whole groups of 4 channels."""
    Ho, Wo = H + 2 * pad - 2, W + 2 * pad - 2
    if cfg["compiled"]:
        rows = sum(0 <= h + pad - di < Ho for h in range(H) for di in range(3))
        cols = sum(0 <= j + pad - dj < Wo for j in range(W) for dj in range(3))
        taps = rows * cols
    else:
        taps = 9 * H * -(-W // cfg["P"]) * cfg["P"]
    return B * taps * O * -(-C // cfg["CT"]) * cfg["CT"]


def param_issued(cfg, B, H, W, C, O, pad=1) -> int:
    """(pixel, tap, o, c) the parameter kernel issues: the taps of each row
    (compiled widths: those whose g lies on the frame; else every column of
    the rows on the frame) x whole o tiles x whole channel tiles."""
    Ho, Wo = H + 2 * pad - 2, W + 2 * pad - 2
    rows = [sum(0 <= h + pad - di < Ho for di in range(3)) for h in range(H)]
    if cfg["compiled"]:
        cols = sum(0 <= j + pad - dj < Wo for j in range(W) for dj in range(3))
    else:
        cols = 3 * W
    ctile = cfg["CT"] * cfg["CG"]
    return B * sum(rows) * cols * -(-O // cfg["OC"]) * cfg["OC"] * \
        -(-C // ctile) * ctile


def phase_wav_times(wc, gen, dev, card, convs=VGG16_SMALL_CONVS,
                    B=TIME_BATCH, tag="[wav time]", suffix=""):
    """14 / 30. per conv shape of ``convs`` (in order, a shape once per
    layer) at batch ``B``: each WavKAN kernel, its plain version, a cuDNN
    grouped convolution over a materialized psi and the bound, and the
    forward's result against its plain version (host-bound readings
    recorded under the kernel's name + ``suffix``); returns (per-kernel
    totals, rows)."""
    F = torch.nn.functional
    totals = {n: dict.fromkeys(("ms", "plain_ms", "library_ms", "op_ms",
                                "byte_ms"), 0.0) for n in wc.KERNELS}
    totals["wav_conv2d_bwd_reduce"].update(warm_l2_ms=0.0,
                                           library_warm_l2_ms=0.0)
    totals["wav_conv2d_fwd"].update(batch1_ms=0.0, max_abs_err=0.0)
    rows = []
    spec = ("mexican_hat", 1)
    for H, C, O in dict.fromkeys(convs):
        x, w, t, s = (a.to(dev) for a in wav_inputs(gen, B, H, H, C, O))
        g = torch.randn(B, H, H, O, generator=gen).to(dev)
        cfg = wc.param_launch_config(B, H, H, C, O, 3, 1)
        part = wc.param_partials(x, w, t, s, g, *spec)
        rcfg = wc.reduce_launch_config(*part.shape)
        red = reduction_times("wav_conv2d_bwd_reduce" + suffix,
                              wc.reduce_partials, wc.reduce_reference, part)
        ms = {
            "wav_conv2d_fwd": (
                cuda_ms(lambda: wc.wav_conv2d(x, w, t, s,
                                              wavelet_type=spec[0],
                                              padding=1)),
                cuda_ms(lambda: wc.wav_conv2d_reference(
                    x, w, t, s, wavelet_type=spec[0], padding=1),
                    iters=3, warmup=1,
                    what=("wav_conv2d_fwd" + suffix, "plain_ms"))),
            "wav_conv2d_bwd_dx": (
                cuda_ms(lambda: wc.input_grad(x, w, t, s, g, *spec)),
                cuda_ms(lambda: wc.input_grad_reference(x, w, t, s, g, *spec),
                        iters=3, warmup=1,
                        what=("wav_conv2d_bwd_dx" + suffix, "plain_ms"))),
            "wav_conv2d_bwd_param": (
                cuda_ms(lambda: wc.param_partials(x, w, t, s, g, *spec)),
                cuda_ms(lambda: wc.param_grads_reference(x, w, t, s, g,
                                                         *spec),
                        iters=3, warmup=1,
                        what=("wav_conv2d_bwd_param" + suffix,
                              "plain_ms"))),
            "wav_conv2d_bwd_reduce": (red["ms"], red["plain_ms"]),
        }
        # the forward's batch-TIME_BATCH launch (one band of RB = H rows)
        # against its plain version on the same inputs, two calls
        # bit-identical
        y = wc.wav_conv2d(x, w, t, s, wavelet_type=spec[0], padding=1)
        same = torch.equal(y, wc.wav_conv2d(x, w, t, s, wavelet_type=spec[0],
                                            padding=1))
        ref = wc.wav_conv2d_reference(x, w, t, s, wavelet_type=spec[0],
                                      padding=1)
        f_err = (y - ref).abs().max().item()
        check(bool(torch.isfinite(y).all()), "WavKAN kernel output not finite")
        check(torch.allclose(y, ref, rtol=TOL, atol=TOL),
              f"WavKAN kernel disagrees with the plain version (B={B} "
              f"{H}x{H} C={C} O={O}, max|err| {f_err:.3e})")
        check(same, f"WavKAN kernel: two calls differ (B={B} {H}x{H} C={C} "
                    f"O={O})")
        totals["wav_conv2d_fwd"]["max_abs_err"] = max(
            totals["wav_conv2d_fwd"]["max_abs_err"], f_err)
        del y, ref
        # yardsticks the port never calls: cuDNN's grouped conv (groups=O)
        # over an already materialized psi, forward and backward, and one
        # sum
        psi = wc.PSI[spec[0]][0](wc._z(x, t, s))          # (B,H,W,O,C)
        psi = psi.permute(0, 3, 4, 1, 2).reshape(B, O * C, H, H) \
            .contiguous()
        wn = w.permute(3, 2, 0, 1).contiguous()            # (O, C, 3, 3)
        gn = g.permute(0, 3, 1, 2).contiguous()

        def conv_bwd(mask):
            return torch.ops.aten.convolution_backward(
                gn, psi, wn, None, [1, 1], [1, 1], [1, 1], False, [0, 0], O,
                mask)

        lib = {"wav_conv2d_fwd": cuda_ms(
                   lambda: F.conv2d(psi, wn, padding=1, groups=O), iters=5,
                   what=("wav_conv2d_fwd" + suffix, "library_ms")),
               "wav_conv2d_bwd_dx": cuda_ms(lambda: conv_bwd(
                   [True, False, False]), iters=5,
                   what=("wav_conv2d_bwd_dx" + suffix, "library_ms")),
               "wav_conv2d_bwd_param": cuda_ms(lambda: conv_bwd(
                   [False, True, False]), iters=5,
                   what=("wav_conv2d_bwd_param" + suffix, "library_ms")),
               "wav_conv2d_bwd_reduce": red["library_ms"]}
        del psi, gn
        n = convs.count((H, C, O))
        row = {"H": H, "C": C, "O": O, "batch": B, "layers": n,
               "S": cfg["S"]}
        for name in wc.KERNELS:
            layers = n - 1 if name == "wav_conv2d_bwd_dx" and \
                (H, C, O) == convs[0] else n
            op_ms, byte_ms = wav_bound(name, B, H, C, O, cfg["S"], cfg["N"])
            row[name] = {"layers": layers, "ms": round(ms[name][0], 4),
                         "plain_ms": round(ms[name][1], 4),
                         "library_ms": round(lib[name], 4),
                         "bound_ms": round(max(op_ms, byte_ms), 4)}
            for key, v in (("ms", ms[name][0]), ("plain_ms", ms[name][1]),
                           ("library_ms", lib[name]), ("op_ms", op_ms),
                           ("byte_ms", byte_ms)):
                totals[name][key] += layers * v
        # the forward's launch and what it issues (2 flops a tap), and its
        # time at batch 1
        fcfg = wc.fwd_launch_config(B, H, H, C, O, 3, 1)
        f_psi, f_fma = wav_fwd_issued(fcfg, B, H, H, C, O)
        f_ms = ms["wav_conv2d_fwd"][0]
        f_row = row["wav_conv2d_fwd"]
        x1, w1, t1, s1 = (a.to(dev) for a in wav_inputs(gen, 1, H, H, C, O))
        b1_ms = cuda_ms(lambda: wc.wav_conv2d(x1, w1, t1, s1,
                                              wavelet_type=spec[0],
                                              padding=1))
        totals["wav_conv2d_fwd"]["batch1_ms"] += n * b1_ms
        f_row.update({
            "tile": {key: fcfg[key] for key in FWD_TILE},
            "psi_over_interior": round(f_psi / (B * H * H * C * O), 4),
            "fma_over_interior": round(
                f_fma / (B * interior_pairs(H) * C * O), 4),
            "bound_share": round(f_row["bound_ms"] / f_ms, 4),
            "tflops_issued": round(2 * f_fma / f_ms / 1e9, 2),
            "max_abs_err": f_err,
            "batch1_ms": round(b1_ms, 4),
            "batch1_tile": {key: wc.fwd_launch_config(1, H, H, C, O, 3, 1)[
                key] for key in ("OG", "RB", "bands", "blocks")}})
        # the data gradient's launch and what it issues (2 flops a tap)
        xcfg = wc.dx_launch_config(B, H, H, C, O, 3, 1)
        x_issued = wav_dx_issued(xcfg, B, H, H, C, O)
        x_ms = ms["wav_conv2d_bwd_dx"][0]
        x_row = row["wav_conv2d_bwd_dx"]
        x_row.update({
            "tile": {key: xcfg[key] for key in DX_TILE},
            "issued_over_interior": round(
                x_issued / (B * interior_pairs(H) * C * O), 4),
            "bound_share": round(x_row["bound_ms"] / x_ms, 4),
            "tflops_issued": round(2 * x_issued / x_ms / 1e9, 2)})
        # the parameter kernel's launch and what it issues
        issued = param_issued(cfg, B, H, H, C, O)
        p_ms = ms["wav_conv2d_bwd_param"][0]
        p_row = row["wav_conv2d_bwd_param"]
        p_row.update({
            "tile": {key: cfg[key] for key in PARAM_TILE},
            "issued_over_interior": round(
                issued / (B * interior_pairs(H) * C * O), 4),
            "bound_share": round(p_row["bound_ms"] / p_ms, 4),
            "tflops_issued": round(4 * issued / p_ms / 1e9, 2)})
        red_row(row["wav_conv2d_bwd_reduce"], rcfg, red,
                totals["wav_conv2d_bwd_reduce"], n)
        rows.append(row)
        print(f"{tag} {json.dumps(row)}", flush=True)
    for name in wc.KERNELS:
        t = totals[name]
        t["bound_ms"] = max(t["op_ms"], t["byte_ms"])
        if name == "wav_conv2d_bwd_reduce":
            print_red_totals(tag, name, t, card, B)
            continue
        print(f"{tag} {name} per {'forward' if name == 'wav_conv2d_fwd' else 'train step'} "
              f"at batch {B}: kernel {t['ms']:.3f} ms, plain "
              f"{t['plain_ms']:.3f} ms, cuDNN over materialized psi "
              f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms, "
              f"{100 * t['bound_ms'] / t['ms']:.1f}% of the bound (on "
              f"{card})", flush=True)
        if name == "wav_conv2d_fwd":
            print(f"{tag} {name} per forward at batch 1: kernel "
                  f"{t['batch1_ms']:.4f} ms (on {card})", flush=True)
    # the launch floor: an empty kernel (a sleep of 0 cycles) in a
    # preloaded queue, one per conv as per step
    empty = cuda_ms(lambda: torch.cuda._sleep(0), iters=100)
    print(f"{tag} empty kernel {1e3 * empty:.2f} us per launch, "
          f"{len(convs) * empty:.4f} ms for {len(convs)} launches (the "
          f"reductions' floor; on {card})", flush=True)
    totals["empty_kernel_ms"] = empty
    return totals, rows


def phase_forward_times(kc, basis, rows_nz, gen, dev, card, tag="[time]",
                        suffix="", batch1=False):
    """5 / 19. per conv shape at batch TIME_BATCH: the forward kernel for
    ``basis``, its plain version, one cuDNN conv over a materialized basis
    (a yardstick the port never calls), the bound on the (pixel, tap) pairs
    whose input lies in the image (a pad tap adds zero, as the backward's
    bounds count them) and ``rows_nz`` rows of E per channel (the dense
    bound, every pair and row, beside it) and the share of the bound the
    kernel reaches; with ``batch1`` also each shape's kernel at batch 1
    (single requests on the serving path).  A basis with a learnable
    operand takes ``conv_extra``'s.  Returns (totals, rows)."""
    name = "kan_conv2d_fwd" + suffix
    shapes = []
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
              "op_ms": 0.0, "byte_ms": 0.0, "dense_bound_ms": 0.0,
              **({"batch1_ms": 0.0} if batch1 else {})}
    B, K, R = TIME_BATCH, basis.K, basis.R
    spec = (basis, 3, 1)
    for H, C, O in dict.fromkeys(VGG16_SMALL_CONVS):
        x, bw, pw = (None if t is None else t.to(dev) for t in conv_inputs(
            gen, B, H, C, O, basis=basis))
        beta = conv_extra(gen, C, basis)
        ex = () if beta is None else (beta.to(dev),)
        k_ms = cuda_ms(lambda: kc.kan_conv2d(x, bw, pw, *spec, *ex))
        p_ms = cuda_ms(lambda: kc.kan_conv2d_reference(x, bw, pw, *spec,
                                                       *ex),
                       iters=5, warmup=1, what=(name, "plain_ms"))
        E = kc.expand(x, basis, *ex).permute(0, 3, 1, 2).contiguous()
        w = kc.pack_w_all(bw, pw, C=C, K=K, k=3, O=O,
                          degree_major=basis.degree_major)
        w = w.reshape(R * C, 3, 3, O).permute(3, 0, 1, 2).contiguous()
        l_ms = cuda_ms(lambda: torch.nn.functional.conv2d(E, w, padding=1),
                       what=(name, "library_ms"))
        del E
        flops = 2 * B * interior_pairs(H) * rows_nz * C * O
        dense_flops = 2 * B * H * H * 9 * R * C * O
        nbytes = 4 * (x.numel() + pw.numel() + B * H * H * O
                      + (0 if bw is None else bw.numel()))
        op_ms = flops / PEAK_FP32_FLOPS * 1e3
        byte_ms = nbytes / PEAK_BYTES * 1e3
        bound_ms = max(op_ms, byte_ms)
        dense_bound_ms = max(dense_flops / PEAK_FP32_FLOPS * 1e3, byte_ms)
        cfg = kc.launch_config(B, H, H, C, O, 3, 1, R)
        n = VGG16_SMALL_CONVS.count((H, C, O))
        row = {"H": H, "C": C, "O": O, "batch": B, "layers": n,
               "tile": {key: cfg[key] for key in kc.FWD_TILE + ("blocks",)},
               "kernel_ms": round(k_ms, 4), "plain_ms": round(p_ms, 4),
               "library_ms": round(l_ms, 4), "bound_ms": round(bound_ms, 4),
               "dense_bound_ms": round(dense_bound_ms, 4),
               "bound_share": round(bound_ms / k_ms, 4),
               "gflops": round(flops / 1e9, 3),
               "dense_gflops": round(dense_flops / 1e9, 3),
               "tflops": round(flops / k_ms / 1e9, 2)}
        if batch1:
            x1, bw1, pw1 = (None if t is None else t.to(dev) for t in
                            conv_inputs(gen, 1, H, C, O, basis=basis))
            b1_ms = cuda_ms(lambda: kc.kan_conv2d(x1, bw1, pw1, *spec, *ex))
            row["batch1_ms"] = round(b1_ms, 4)
            totals["batch1_ms"] += n * b1_ms
        shapes.append(row)
        for key, v in (("ms", k_ms), ("plain_ms", p_ms),
                       ("bound_ms", bound_ms), ("library_ms", l_ms),
                       ("op_ms", op_ms), ("byte_ms", byte_ms),
                       ("dense_bound_ms", dense_bound_ms)):
            totals[key] += n * v
        print(f"{tag} {json.dumps(row)}", flush=True)
    print(f"{tag} per forward of the 13 convs at batch {B}: kernel "
          f"{totals['ms']:.3f} ms, plain {totals['plain_ms']:.3f} ms, cuDNN "
          f"over materialized E {totals['library_ms']:.3f} ms, bound "
          f"{totals['bound_ms']:.3f} ms on interior pairs and "
          f"{rows_nz} rows of E (dense "
          f"{totals['dense_bound_ms']:.3f} ms), "
          f"{100 * totals['bound_ms'] / totals['ms']:.1f}% of the bound "
          f"(on {card})", flush=True)
    if batch1:
        print(f"{tag} per forward of the 13 convs at batch 1: kernel "
              f"{totals['batch1_ms']:.4f} ms (on {card})", flush=True)
    return totals, shapes


def phase_cheby_kernels(kc, gen, dev):
    """15. the Chebyshev instantiations against their plain versions: the
    forward (TOL) and ``backward_case`` (BWD_TOL against float64) at the 9
    VGG16_small shapes at batch 64 and at batch 1024 (there the partials are
    held to float64 through the reduced dW), with |x| up to 10 in one case
    per batch (dx exactly 0 where the clamp holds t), every kernel's result
    of two calls bit-identical.  Returns max |err| per kernel (the
    forward's under "kan_conv2d_fwd")."""
    basis = kc.cheby_basis(3)
    cases = [(B, H, C, O, 1.0) for B in (64, TIME_BATCH)
             for H, C, O in dict.fromkeys(VGG16_SMALL_CONVS)]
    cases += [(64, 8, 32, 64, 10.0), (TIME_BATCH, 4, 64, 128, 10.0)]
    errs = dict.fromkeys(kc.KERNELS, 0.0)
    red64 = 0.0
    for B, H, C, O, scale in cases:
        x, _, pw = conv_inputs(gen, B, H, C, O, scale, basis=basis)
        g = torch.randn(B, H, H, O, generator=gen)
        x, pw, g = (t.to(dev) for t in (x, pw, g))
        y = kc.kan_conv2d(x, None, pw, basis, 3, 1)
        same = torch.equal(y, kc.kan_conv2d(x, None, pw, basis, 3, 1))
        torch.cuda.synchronize()
        ref = kc.kan_conv2d_reference(x, None, pw, basis, 3, 1)
        err = (y - ref).abs().max().item()
        ok = torch.allclose(y, ref, rtol=TOL, atol=TOL)
        cfg = kc.launch_config(B, H, H, C, O, 3, 1, basis.R)
        print(f"[cheby kernel] B={B} {H}x{H} C={C} O={O} x*{scale} "
              f"(BN {cfg['BN']}, {'skip' if cfg['skip'] else 'dense'}, CC "
              f"{cfg['CC']}, S {cfg['S']}, {cfg['blocks']} blocks): "
              f"max|err| {err:.3e}, two calls "
              f"{'bit-identical' if same else 'DIFFERENT'} "
              f"{'ok' if ok and same else 'FAIL'}", flush=True)
        check(bool(torch.isfinite(y).all()), "Chebyshev kernel output not "
                                             "finite")
        check(ok, f"Chebyshev kernel disagrees with the plain version (B={B} "
                  f"H={H} C={C} O={O} x*{scale})")
        check(same, f"Chebyshev kernel: two calls differ (B={B} H={H} C={C} "
                    f"O={O})")
        errs["kan_conv2d_fwd"] = max(errs["kan_conv2d_fwd"], err)
        del y, ref
        case, e64, dx, dx_auto = backward_case(
            kc, basis, x, None, pw, g, 3, 1, partials=B < TIME_BATCH,
            twice=True, tag="[cheby backward]")
        red64 = max(red64, e64)
        for name, e in case.items():
            errs[name] = max(errs[name], e)
        if scale > 8.5:  # past |x| ~ 8.3 the clamp holds t: dx is 0
            clamped = x.abs() > 8.5
            check(bool(clamped.any()) and not dx[clamped].any()
                  and not dx_auto[clamped].any(),
                  "Chebyshev dx not 0 where the clamp holds t")
            print(f"[cheby backward] dx exactly 0 at the "
                  f"{int(clamped.sum())} inputs past the clamp", flush=True)
    print(f"[cheby backward] reduced dW vs float64 autograd: max |err| "
          f"{red64:.3e} (within BWD_TOL in every case)", flush=True)
    return errs


def phase_gram_kernels(kc, gen, dev):
    """20. the Gram instantiations against their plain versions, with beta
    at GRAM_BETA_SCALE times its init std (``conv_extra``): the forward
    (TOL) and ``backward_case`` (BWD_TOL against float64; beta's partials
    and its reduced gradient against float64 within DBETA_TOL of the sum
    of |terms|, entries 0 and 3 exactly 0, the dx-free launch of the first
    conv and the autograd path's bit-identical to them) at the 9
    VGG16_small shapes at batch 64 and once more at batch 1024 (the tiles
    the step launches; there the weight partials are held to float64
    through the reduced dW), every kernel's result of two calls
    bit-identical.  Returns max |err| per kernel (the forward's under
    "kan_conv2d_fwd", beta's relative one under "dbeta_rel")."""
    basis = kc.gram_basis(3)
    cases = [(B, H, C, O) for B in (64, TIME_BATCH)
             for H, C, O in dict.fromkeys(VGG16_SMALL_CONVS)]
    errs = dict.fromkeys((*kc.KERNELS, "dbeta_rel"), 0.0)
    red64 = 0.0
    for B, H, C, O in cases:
        x, bw, pw = conv_inputs(gen, B, H, C, O, basis=basis)
        beta = conv_extra(gen, C, basis)
        g = torch.randn(B, H, H, O, generator=gen)
        x, bw, pw, beta, g = (t.to(dev) for t in (x, bw, pw, beta, g))
        y = kc.kan_conv2d(x, bw, pw, basis, 3, 1, beta)
        same = torch.equal(y, kc.kan_conv2d(x, bw, pw, basis, 3, 1, beta))
        torch.cuda.synchronize()
        ref = kc.kan_conv2d_reference(x, bw, pw, basis, 3, 1, beta)
        err = (y - ref).abs().max().item()
        ok = torch.allclose(y, ref, rtol=TOL, atol=TOL)
        cfg = kc.launch_config(B, H, H, C, O, 3, 1, basis.R)
        print(f"[gram kernel] B={B} {H}x{H} C={C} O={O} beta "
              f"{[round(v, 5) for v in beta.tolist()]} (BN {cfg['BN']}, "
              f"{'skip' if cfg['skip'] else 'dense'}, CC {cfg['CC']}, S "
              f"{cfg['S']}, {cfg['blocks']} blocks): max|err| {err:.3e}, "
              f"two calls {'bit-identical' if same else 'DIFFERENT'} "
              f"{'ok' if ok and same else 'FAIL'}", flush=True)
        check(bool(torch.isfinite(y).all()), "Gram kernel output not finite")
        check(ok, f"Gram kernel disagrees with the plain version (B={B} "
                  f"H={H} C={C} O={O})")
        check(same, f"Gram kernel: two calls differ (B={B} H={H} C={C} "
                    f"O={O})")
        errs["kan_conv2d_fwd"] = max(errs["kan_conv2d_fwd"], err)
        del y, ref
        case, e64, _, _ = backward_case(
            kc, basis, x, bw, pw, g, 3, 1, partials=B < TIME_BATCH,
            twice=True, tag="[gram backward]", extra=beta)
        red64 = max(red64, e64)
        for name, e in case.items():
            errs[name] = max(errs[name], e)
    print(f"[gram backward] reduced dW vs float64 autograd: max |err| "
          f"{red64:.3e} (within BWD_TOL in every case); dbeta within "
          f"{errs['dbeta_rel']:.3e} of the sum of |terms| (DBETA_TOL "
          f"{DBETA_TOL:g})", flush=True)
    return errs


# ------------------------------------------------------ BatchNorm, path A
def phase_bn_model(mod, dev, imgs):
    """25. path A's model (PATH_A, seeded as train_model) on the card
    against the same state_dict on the CPU, a train-mode forward (the
    batch's statistics; the head's dropout mask from one CPU generator on
    both sides) and then an eval-mode one (the running statistics, which
    the train-mode forward moved on both sides): logits within MODEL_TOL
    (those of train mode not the same for every image), the running
    statistics within STATS_TOL, 13 forward launches each."""
    from convkan_tpu_torch.train.data import normalize_batch

    model_cpu = train_model("KAN", **PATH_A)
    model_gpu = copy.deepcopy(model_cpu).to(dev)
    x = normalize_batch(torch.from_numpy(imgs), "CIFAR10")
    for train in (True, False):
        mod.reset_launches()
        with torch.no_grad():
            want = model_cpu.train(train)(x, torch.Generator().manual_seed(5))
            got = model_gpu.train(train)(
                x.to(dev), torch.Generator().manual_seed(5)).cpu()
            torch.cuda.synchronize()
        n = mod.launches["kan_conv2d_fwd"]
        err = (got - want).abs().max().item()
        stats = max(((b.cpu() - a).abs().max() / a.abs().max()).item()
                    for a, b in zip(model_cpu.buffers(), model_gpu.buffers()))
        mode = "train" if train else "eval"
        print(f"[bn model] KAN VGG16_small BatchNorm2d {mode}"
              f" mode, logits {tuple(got.shape)} GPU vs CPU max|err| "
              f"{err:.3e}; running statistics max|diff| {stats:.3e} of the "
              f"buffer's largest entry; kernel launches {n}", flush=True)
        check(bool(torch.isfinite(got).all()), "logits not finite")
        check(sum(mod.launches.values()) == n == 13,
              f"expected 13 forward launches, got {mod.launches}")
        check(torch.allclose(got, want, rtol=MODEL_TOL, atol=MODEL_TOL),
              "BatchNorm model logits on the GPU disagree with the CPU")
        check(stats <= STATS_TOL, "running statistics differ between GPU "
                                  "and CPU")
        if train:
            check((got - got[0]).abs().max().item() > 1e-3,
                  "the train-mode logits are the same for every image")


def phase_bn_serve(mod, trained, imgs):
    """27. path A serving from the trained state (phase 26's GPU model, its
    running statistics moved by three steps), without and with folding each
    BatchNorm into its conv's weights (fold_batch_norms, what --fold_bn
    runs): the served logits (phase_serve) against the CPU's eval logits of
    the same state, folded against unfolded on the card (MODEL_TOL), the
    folded forward launching the kernel once per conv; then the serving
    CLI's --fold_bn (seeded weights): 13 norms folded, its logits against
    the unfolded CLI engine's.  Returns the launches of the two served
    runs and the two served models."""
    from convkan_tpu_torch.serve import build_engine, build_parser
    from convkan_tpu_torch.train.data import normalize_batch
    from convkan_tpu_torch.utils.fold_bn import fold_batch_norms

    state = {k: v.detach().cpu().clone()
             for k, v in trained.state_dict().items()}
    model_cpu = train_model("KAN", **PATH_A)
    model_cpu.load_state_dict(state)
    with torch.inference_mode():
        want = model_cpu.eval()(normalize_batch(torch.from_numpy(imgs),
                                                "CIFAR10")).numpy()
    served, launches, models = {}, {}, {}
    for fold in (False, True):
        model = train_model("KAN", **PATH_A)
        model.load_state_dict(state)
        if fold:
            check(fold_batch_norms(model) == 13, "not every BatchNorm folded")
        models[fold] = model.to("cuda")
        launches[fold], served[fold] = phase_serve(
            mod, "KAN", "kan_conv2d_fwd", imgs, tol=MODEL_TOL, model=model)
    e_cpu = float(np.abs(served[False] - want).max())
    e_fold = float(np.abs(served[True] - served[False]).max())
    e_fold_cpu = float(np.abs(served[True] - want).max())
    print(f"[bn serve] trained state: served logits vs CPU eval max|err| "
          f"{e_cpu:.3e}; folded vs unfolded on the card {e_fold:.3e} (vs CPU "
          f"{e_fold_cpu:.3e}); launches unfolded {launches[False]}, folded "
          f"{launches[True]}", flush=True)
    check(np.allclose(served[False], want, rtol=MODEL_TOL, atol=MODEL_TOL),
          "served logits disagree with the CPU's eval logits")
    check(np.allclose(served[True], served[False], rtol=MODEL_TOL,
                      atol=MODEL_TOL), "folded logits disagree with unfolded")
    cli = ["--arch", "VGG16_small", "--init_random", "--buckets", "1,64"]
    outs = []
    for extra in ([], ["--fold_bn"]):
        engine, _ = build_engine(build_parser().parse_args(cli + extra))
        try:
            mod.reset_launches()
            outs.append(engine.predict(imgs))
            n = mod.launches["kan_conv2d_fwd"]
            norms = [m.norm for n_, m in engine.model.named_children()
                     if n_.startswith("KanConvND")]
        finally:
            engine.close()
        check(n == 13, f"{n} forward launches of the CLI engine")
        if extra:
            check(all(bool(((b.var + 1e-5) == 1).all()) for b in norms),
                  "--fold_bn left a BatchNorm unfolded")
    e_cli = float(np.abs(outs[1] - outs[0]).max())
    print(f"[bn serve] CLI --fold_bn (seeded): logits vs the unfolded CLI "
          f"engine max|err| {e_cli:.3e}", flush=True)
    check(np.allclose(outs[1], outs[0], rtol=MODEL_TOL, atol=MODEL_TOL),
          "--fold_bn logits disagree with the unfolded engine")
    return launches, models


# ---------------------------------------------- BASELINE config 4, path B
class _WavNet(torch.nn.Module):
    """bench.py's config-4 stack (its ``WavNet``), from the port's modules
    and named as flax names it: WavKANConvND_0..2, Linear_0."""

    def __init__(self, generator, device):
        from convkan_tpu_torch.nn.wav_conv import WavKANConv2DLayer
        from convkan_tpu_torch.ops.layers import Linear

        super().__init__()
        c_in = 3
        for i, c in enumerate(c for _, _, c in CONFIG4_CONVS):
            self.add_module(f"WavKANConvND_{i}", WavKANConv2DLayer(
                c_in, c, 3, padding=1, wavelet_type="mexican_hat",
                wav_version="fast", generator=generator, device=device))
            c_in = c
        self.Linear_0 = Linear(c_in, CONFIG4_CLASSES, generator=generator,
                               device=device)

    def forward(self, x, generator=None):
        from convkan_tpu_torch.ops.pooling import adaptive_avg_pool, max_pool

        for i in range(len(CONFIG4_CONVS)):
            x = max_pool(getattr(self, f"WavKANConvND_{i}")(x), 2, 2)
        return self.Linear_0(adaptive_avg_pool(x, (1, 1)).flatten(1))


def config4_model(device="cpu", seed=11):
    return _WavNet(torch.Generator().manual_seed(seed), device)


def config4_batches(B, steps=TRAIN_STEPS, seed=12):
    """bench.py's data: U[0, 1) float images, CIFAR-100 labels (no crops,
    no flips)."""
    gen = torch.Generator().manual_seed(seed)
    return [(torch.rand(B, 32, 32, 3, generator=gen),
             torch.randint(0, CONFIG4_CLASSES, (B,), generator=gen),
             None, None) for _ in range(steps)]


def config4_step(model):
    """bench.py's config-4 step: a train-mode forward (each BatchNorm moves
    its running statistics), cross-entropy, backward, one AdamW update."""
    from convkan_tpu_torch.train.metrics import cross_entropy_loss

    dtype = next(model.parameters()).dtype

    def step(state, x, labels, offsets=None, flips=None):
        model.train()
        loss = cross_entropy_loss(model(x.to(dtype)), labels)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()
        return loss.detach()

    return step


def phase_config4_kernels(wc, gen, dev):
    """28. config 4's three WavKAN shapes at batch 64 and CONFIG4_BATCH:
    the forward against its plain version (TOL), the data gradient, the
    parameter partials, their reduction and the autograd path's dx, dw,
    dt, ds against float64 autograd of the plain version (BWD_TOL; the
    references over chunks of CONFIG4_CHUNK images, the partials split by
    split, the reduced gradients as the float64 sum of the partials'); the
    reduction bit-exact against its plain version; every kernel's result of
    two calls bit-identical.  Returns max |err| per kernel."""
    errs = dict.fromkeys(wc.KERNELS, 0.0)
    spec = ("mexican_hat", 1)
    for B in (64, CONFIG4_BATCH):
        for H, C, O in CONFIG4_CONVS:
            x, w, t, s = (a.to(dev) for a in wav_inputs(gen, B, H, H, C, O))
            g = torch.randn(B, H, H, O, generator=gen).to(dev)
            y = wc.wav_conv2d(x, w, t, s, wavelet_type=spec[0], padding=1)
            dx = wc.input_grad(x, w, t, s, g, *spec)
            part = wc.param_partials(x, w, t, s, g, *spec)
            red = wc.reduce_partials(part)
            same = torch.equal(y, wc.wav_conv2d(
                x, w, t, s, wavelet_type=spec[0], padding=1)) and \
                torch.equal(dx, wc.input_grad(x, w, t, s, g, *spec)) and \
                torch.equal(part, wc.param_partials(x, w, t, s, g, *spec))
            leaves = [a.clone().requires_grad_(True) for a in (x, w, t, s)]
            got = torch.autograd.grad(wc.wav_conv2d(
                *leaves, wavelet_type=spec[0], padding=1), leaves, g)
            torch.cuda.synchronize()
            e_fwd, ok_fwd, dx64 = 0.0, True, []
            for i in range(0, B, CONFIG4_CHUNK):
                sl = slice(i, i + CONFIG4_CHUNK)
                with torch.no_grad():
                    ref = wc.wav_conv2d_reference(
                        x[sl], w, t, s, wavelet_type=spec[0], padding=1)
                e_fwd = max(e_fwd, (y[sl] - ref).abs().max().item())
                ok_fwd &= torch.allclose(y[sl], ref, rtol=TOL, atol=TOL)
                dx64.append(wc.input_grad_reference(
                    *(a.double() for a in (x[sl], w, t, s, g[sl])), *spec))
            dx64 = torch.cat(dx64)
            cfg = wc.param_launch_config(B, H, H, C, O, 3, 1)
            part64 = wc.param_partials_reference(
                *(a.double() for a in (x, w, t, s, g)), *spec, cfg["S"],
                cfg["ips"])
            red64 = part64.sum(0)
            e_dx, ok_dx = bwd_close(dx, dx64)
            e_p, ok_p = bwd_close(part, part64)
            e_red = (red - wc.reduce_reference(part)).abs().max().item()
            e64, ok64 = bwd_close(red, red64)
            auto = [bwd_close(a, b) for a, b in zip(
                got, (dx64, *wc.split_param_grads(red64, 3, C, O)))]
            ok = ok_fwd and ok_dx and ok_p and e_red == 0.0 and ok64 and \
                same and all(o for _, o in auto)
            print(f"[config4 kernels] B={B} {H}x{H} C={C} O={O} (fwd "
                  f"{wav_fwd_tile(wc.fwd_launch_config(B, H, H, C, O, 3, 1))};"
                  f" dx "
                  f"{wav_dx_tile(wc.dx_launch_config(B, H, H, C, O, 3, 1))}"
                  f"; param {param_tile(cfg)}): forward {e_fwd:.3e}, dx "
                  f"{e_dx:.3e}, param partials {e_p:.3e}, reduce {e_red:.1e} "
                  f"(reduced vs float64 {e64:.3e}); autograd dx/dw/dt/ds "
                  f"{'/'.join(f'{e:.3e}' for e, _ in auto)}; two calls "
                  f"{'bit-identical' if same else 'DIFFERENT'} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            for a in (y, dx, part, *got):
                check(bool(torch.isfinite(a).all()), "config-4 kernel output "
                                                      "not finite")
            check(ok, f"WavKAN kernels disagree with their plain versions at "
                      f"config 4's B={B} {H}x{H} C={C} O={O}")
            for name, e in (("wav_conv2d_fwd", e_fwd),
                            ("wav_conv2d_bwd_dx", max(e_dx, auto[0][0])),
                            ("wav_conv2d_bwd_param",
                             max(e_p, *(a for a, _ in auto[1:]))),
                            ("wav_conv2d_bwd_reduce", e_red)):
                errs[name] = max(errs[name], e)
            del x, y, dx, part, got, dx64, part64
    return errs


def time_config4_step(wc, dev, card):
    """30. the config-4 train step at CONFIG4_BATCH, as bench.py steps it
    (create_train_state with steps_per_epoch 100): median images/s of 12
    steps after 3 warm-up ones, each ending in a host readback of the loss,
    and the peak memory; the launch counts of these 15 steps (zeroed just
    before) must be 15 x (3, 2, 3, 3).  Returns (images/s, counts)."""
    from convkan_tpu_torch.train.state import create_train_state

    model = config4_model(device=dev, seed=13)
    state = create_train_state(model, steps_per_epoch=100)
    step = config4_step(model)
    (x, y, _, _), = config4_batches(CONFIG4_BATCH, steps=1, seed=14)
    x, y = x.to(dev), y.to(dev)
    wc.reset_launches()
    for _ in range(3):
        step(state, x, y).item()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(12):
        t0 = time.perf_counter()
        loss = step(state, x, y).item()  # host readback: the step is done
        runs.append(CONFIG4_BATCH / (time.perf_counter() - t0))
    torch.cuda.synchronize()
    counts = dict(wc.launches)
    ips = statistics.median(runs)
    print(f"[config4 time] train step batch {CONFIG4_BATCH}: median "
          f"{ips:.1f} images/s ({1e3 * CONFIG4_BATCH / ips:.3f} ms) over "
          f"{len(runs)} steps (min {min(runs):.1f}, max {max(runs):.1f}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"last loss {loss:.4f}; launches in 15 steps {counts} (on {card})",
          flush=True)
    check(np.isfinite(loss), "config-4 loss not finite")
    want = {"wav_conv2d_fwd": 3, "wav_conv2d_bwd_dx": 2,
            "wav_conv2d_bwd_param": 3, "wav_conv2d_bwd_reduce": 3}
    check(counts == {k: 15 * v for k, v in want.items()},
          f"config-4 step at batch {CONFIG4_BATCH}: expected per step "
          f"{want}, got {counts} in 15 steps")
    return ips, counts


# ------------------------------------------- KAN-MobileNetV3: path C
def mnv3_model(kan_conv, device="cpu", seed=21, bench=False):
    """MobileNetV3-small at width 1.0, 10 classes, seeded: as train.py
    builds it (--model MobileNetV3KAN --arch small
    --imagenet_preprocessing: BatchNorm2d without affine, head dropout
    0.5), or with ``bench`` as bench.py's config 5 (affine BatchNorm, head
    dropout 0.2)."""
    from convkan_tpu_torch.models.mobilenetv3 import mobilenet_v3_kan

    kw = {} if bench else dict(dropout=0.5, norm_layer="BatchNorm2d",
                               kan_norm_layer="BatchNorm2d", affine=False)
    return mobilenet_v3_kan("small", num_classes=10, kan_conv=kan_conv,
                            generator=torch.Generator().manual_seed(seed),
                            device=device, **kw)


def mnv3_smooth(model, curve=MNV3_CURVE):
    """``model`` with each KAN conv's curved basis terms scaled by
    ``curve``: all of poly_w for the B-spline and RBF families (their base
    path stays), the Chebyshev rows of degree >= 2 (T_0 and T_1 stay)."""
    with torch.no_grad():
        for m in model.modules():
            if type(m).__name__ != "KanConvND":
                continue
            w = m.poly_w
            if m.family == "cheby":   # rows c * K + degree
                w.view(*w.shape[:2], -1, m.num_basis, w.shape[-1])[
                    ..., 2:, :] *= curve
            else:
                w.mul_(curve)
    return model


def mnv3_calibrate(model, x):
    """Set every BatchNorm's running statistics to those of one train-mode
    forward of ``x`` (momentum 1 for it; the head's dropout draws from a
    seeded generator) and return the model in eval mode."""
    from convkan_tpu_torch.utils.norms import BatchNorm

    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    momenta = [m.momentum for m in norms]
    for m in norms:
        m.momentum = 1.0
    with torch.no_grad():
        model.train()(x, torch.Generator().manual_seed(0))
    for m, mom in zip(norms, momenta):
        m.momentum = mom
    return model.eval()


def mnv3_bases(kc) -> dict:
    """The two bases path C's kernels run: MobileNetV3's B-spline (grid 5,
    order 3) with its hardswish base path, and Chebyshev of degree 3."""
    from convkan_tpu_torch.basis.bspline import make_bspline_grid

    knots = tuple(float(v) for v in make_bspline_grid(5, 3))
    return {"hardswish": kc.bspline_basis(knots, 3, "hardswish"),
            "cheby3": kc.cheby_basis(3)}


def mnv3_want(kan_conv):
    """Launches per forward (and per backward kernel per train step) and
    plain-route convs per forward of the MobileNetV3-small: the 22 1x1
    convs on the kernels and the strided stem on the plain route, or (for
    FastKAN, which no kernel carries) all 23 on the plain route."""
    n = 0 if kan_conv == "FastKAN" else len(MNV3_CONVS)
    return n, len(MNV3_CONVS) + 1 - n


def seeded_images(n, seed, size=224):
    """Seeded size x size uint8 images (bench.py's config 5 feeds 224)."""
    return np.random.RandomState(seed).randint(0, 256, (n, size, size, 3),
                                               np.uint8)


def phase_mnv3_kernels(kc, gen, dev):
    """31. the KAN-conv kernels at every 1x1 shape of MobileNetV3-small
    (k = 1, pad 0, batch MNV3_CHECK_BATCH) for the B-spline with hardswish
    and for Chebyshev: the forward against the plain version (TOL), the
    backward kernels by ``backward_case`` (data gradient, weight-gradient
    partials and the autograd path against float64, BWD_TOL; the reduction
    bit-exact in the kernel's order); and one case of x scaled to +-4 with
    the knots and -3, 3 among its values.  Returns max |err| per kernel and
    basis."""
    from convkan_tpu_torch.basis.bspline import make_bspline_grid

    knots = tuple(float(v) for v in make_bspline_grid(5, 3))
    errs = {}
    for tag, basis in mnv3_bases(kc).items():
        err = {"kan_conv2d_fwd": 0.0, "kan_conv2d_bwd_dx": 0.0,
               "kan_conv2d_bwd_dw": 0.0, "kan_conv2d_bwd_dw_reduce": 0.0}
        cases = [(MNV3_CHECK_BATCH, H, C, O, 1.0)
                 for H, C, O in dict.fromkeys(MNV3_CONVS)]
        cases.append((16, 14, 48, 144, 4.0))
        for B, H, C, O, scale in cases:
            x, bw, pw = conv_inputs(gen, B, H, C, O, scale, k=1, basis=basis)
            if scale > 1:   # exact knots and the hardswish kinks occur
                x.view(-1)[:len(knots) + 2] = torch.tensor(knots + (-3.0,
                                                                    3.0))
            g = torch.randn(B, H, H, O, generator=gen)
            x, pw, g = x.to(dev), pw.to(dev), g.to(dev)
            bw = None if bw is None else bw.to(dev)
            y = kc.kan_conv2d(x, bw, pw, basis, 1, 0)
            ref = kc.kan_conv2d_reference(x, bw, pw, basis, 1, 0)
            e = (y - ref).abs().max().item()
            ok = torch.allclose(y, ref, rtol=TOL, atol=TOL)
            cfg = kc.launch_config(B, H, H, C, O, 1, 0, basis.R)
            print(f"[mnv3 kernel] {tag} B={B} {H}x{H} C={C} O={O} k=1 "
                  f"x*{scale} (BN {cfg['BN']}, CC {cfg['CC']}, S {cfg['S']}, "
                  f"{cfg['blocks']} blocks): forward max|err| {e:.3e} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            check(bool(torch.isfinite(y).all()) and ok,
                  f"kernel disagrees with the plain version ({tag} B={B} "
                  f"H={H} C={C} O={O})")
            err["kan_conv2d_fwd"] = max(err["kan_conv2d_fwd"], e)
            case, _, _, _ = backward_case(kc, basis, x, bw, pw, g, 1, 0,
                                          tag="[mnv3 backward]")
            for name, e in case.items():
                err[name] = max(err[name], e)
        errs[tag] = err
        print(f"[mnv3 kernel] {tag}: max |err| {json.dumps(err)}",
              flush=True)
    return errs


def mnv3_prep(x_uint8, served=False):
    """Path C's float batch of 224 x 224 uint8 images: ``imagenet_batch``
    (the train and eval steps' form), or with ``served`` the serving
    engine's (the dataset's normalization, no resize)."""
    from convkan_tpu_torch.train.data import imagenet_batch, normalize_batch

    x = torch.from_numpy(x_uint8)
    return normalize_batch(x, "CIFAR10") if served else \
        imagenet_batch(x, False, "CIFAR10")


def mnv3_eval_model(kan_conv, served=False):
    """Phases 32 and 33's model: ``mnv3_model`` smoothed (``mnv3_smooth``)
    with its running statistics set by ``mnv3_calibrate`` from 8 seeded
    images in the form ``mnv3_prep(served)`` gives, in eval mode on the
    CPU."""
    return mnv3_calibrate(mnv3_smooth(mnv3_model(kan_conv)),
                          mnv3_prep(seeded_images(8, 30), served))


def phase_mnv3_model(kc, dev):
    """32. the KAN, ChebyKAN and FastKAN MobileNetV3-small (``mnv3_eval_
    model`` on the CPU, moved to the card): eval logits of MNV3_MODEL_BATCH
    images (imagenet_batch) on the card against the CPU (MODEL_TOL) and not
    the same for every image, the kernel launches and plain-route convs of
    one forward."""
    x = mnv3_prep(seeded_images(MNV3_MODEL_BATCH, 31))
    for fam in MNV3_FAMILIES:
        cpu = mnv3_eval_model(fam)
        gpu = copy.deepcopy(cpu).to(dev)
        with torch.inference_mode():
            kc.reset_launches()
            got = gpu(x.to(dev)).cpu()
            torch.cuda.synchronize()
            counts = dict(kc.launches, **kc.plain_calls)
            want = cpu(x)
        n_fwd, n_plain = mnv3_want(fam)
        err = (got - want).abs().max().item()
        spread = (got - got[0]).abs().max().item()
        print(f"[mnv3 model] {fam} MobileNetV3-small logits "
              f"{tuple(got.shape)} GPU vs CPU max|err| {err:.3e} (spread "
              f"over the images {spread:.3e}); one forward: {counts}",
              flush=True)
        check(bool(torch.isfinite(got).all()), "model logits not finite")
        check(counts == {**dict.fromkeys(kc.KERNELS, 0),
                         "kan_conv2d_fwd": n_fwd, kc.PLAIN: n_plain},
              f"{fam}: expected {n_fwd} forward launches and {n_plain} "
              f"plain-route convs, got {counts}")
        check(torch.allclose(got, want, rtol=MODEL_TOL, atol=MODEL_TOL),
              f"{fam} logits on the GPU disagree with the CPU")
        check(spread > 1e-3, f"{fam}: the logits are the same for every "
                             "image")


def phase_mnv3_serve(kc, fam):
    """33. serving, the main path, of MobileNetV3-small (``serve_224``)."""
    return serve_224(kc, fam, "MobileNetV3KAN", "small", mnv3_eval_model,
                     mnv3_want(fam), "[mnv3 serve]")


def serve_224(kc, fam, model_name, arch, eval_model, per_forward, tag):
    """33 / 38. serving, the main path: the CLI's engine (``build_engine``
    of the argv below, in this process) serving the state of
    ``eval_model(fam, served=True)`` (loaded with strict=True) behind the
    HTTP server, launch counts zeroed first; 3 single-image requests and
    one of 4 images; the answers against ``predict`` and against the CPU
    model's eval logits (MODEL_TOL), not the same for every image, and the
    counts read (``per_forward``: kernel forwards and plain routes per
    forward).
    Then the same argv run as ``python -m convkan_tpu_torch.serve`` in a
    process of its own (its seeded weights) answers one request of 4
    images, against the in-process engine's ``predict`` of the same seeded
    weights (MODEL_TOL).  Returns the forward launches of the HTTP run and
    its launches by basis (``kc.launches_by_basis``)."""
    from convkan_tpu_torch.serve import build_engine, build_parser, \
        make_server

    argv = ["--model", model_name, "--arch", arch,
            "--imagenet_preprocessing", "--kan_conv", fam, "--init_random",
            "--seed", "5", "--buckets", "1,4"]
    imgs = seeded_images(4, 33)
    model = eval_model(fam, served=True)
    with torch.inference_mode():
        want = model(mnv3_prep(imgs, served=True)).numpy()

    def post(url, batch):
        req = urllib.request.Request(
            url + "/predict", data=json.dumps(
                {"instances": batch.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return np.array(json.loads(r.read())["predictions"])

    engine, name = build_engine(build_parser().parse_args(argv))
    seeded = engine.predict(imgs)
    engine.model.load_state_dict(model.state_dict(), strict=True)
    kc.reset_launches()
    before = engine.metrics()["device_batches"]
    server = make_server(engine, name, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        single = np.concatenate([post(url, imgs[i:i + 1]) for i in range(3)])
        four = post(url, imgs)
        counts = dict(kc.launches, **kc.plain_calls)
        by_basis = dict(kc.launches_by_basis)
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            metrics = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    direct = engine.predict(imgs)
    engine.close()
    e_http = max(float(np.abs(single - direct[:3]).max()),
                 float(np.abs(four - direct).max()))
    e_cpu = max(float(np.abs(single - want[:3]).max()),
                float(np.abs(four - want).max()))
    spread = float(np.abs(four - four[0]).max())
    n_fwd, n_plain = per_forward
    steps = metrics["device_batches"] - before
    print(f"{tag} {name}, calibrated state: 3 single-image requests "
          f"and one of 4, max|err| vs predict {e_http:.3e}, vs the CPU "
          f"{e_cpu:.3e} (spread over the images {spread:.3e}); {steps} "
          f"forwards, counts {counts}", flush=True)
    check(e_http <= MODEL_TOL, "served logits disagree with predict")
    check(np.allclose(np.concatenate([single, four]),
                      np.concatenate([want[:3], want]), rtol=MODEL_TOL,
                      atol=MODEL_TOL),
          "served logits disagree with the CPU's eval logits")
    check(spread > 1e-3, "the served logits are the same for every image")
    check(counts["kan_conv2d_fwd"] == n_fwd * steps and
          counts[kc.PLAIN] == n_plain * steps and
          sum(counts.values()) == (n_fwd + n_plain) * steps,
          f"{counts} for {steps} forwards")
    proc = subprocess.Popen(
        [sys.executable, "-m", "convkan_tpu_torch.serve", *argv, "--port",
         "0"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = ""
        deadline = time.monotonic() + 600
        while "serving " not in line:
            line = proc.stdout.readline()
            check(line != "" and time.monotonic() < deadline,
                  f"the serving CLI stopped before serving: {line!r}")
        cli_url = line.strip().rsplit(" on ", 1)[1]
        e_cli = float(np.abs(post(cli_url, imgs) - seeded).max())
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    print(f"{tag} python -m convkan_tpu_torch.serve {' '.join(argv)}:"
          f" {line.strip()}; its 4-image answer vs predict of the same "
          f"seeded weights max|err| {e_cli:.3e}", flush=True)
    check(e_cli <= MODEL_TOL, "the serving CLI disagrees with predict")
    return counts["kan_conv2d_fwd"], by_basis


def mnv3_batches(B, steps=TRAIN_STEPS, seed=34):
    """bench.py's config-5 data: 224 x 224 uint8 images, 10 classes (no
    crops, no flips)."""
    rng = np.random.RandomState(seed)
    return [(torch.from_numpy(seeded_images(B, seed + i)),
             torch.from_numpy(rng.randint(0, 10, B).astype(np.int64)),
             None, None) for i in range(steps)]


def config5_step(model):
    """bench.py's config-5 train step: imagenet=True, augment=False."""
    from convkan_tpu_torch.train.loop import make_train_step
    return make_train_step(model, "CIFAR10", augment=False, imagenet=True)


def phase_mnv3_train(kc, dev, fam):
    """34. training, the main path, three steps of MobileNetV3-small
    (``mnv3_smooth`` of the seeded model) at batch MNV3_TRAIN_BATCH in
    lockstep GPU vs CPU (``phase_train``, as phase 26 holds path A:
    losses, gradients vs float64 within GRAD_TOL or F32_SPREAD x float32's
    spread, updates, running statistics (FastKAN's input norms among
    them), the control; every KAN conv's poly_w gets a gradient) with the
    launches per step: 22 of each KAN-conv kernel and 1 plain route
    (FastKAN: 23 plain routes)."""
    n_fwd, n_plain = mnv3_want(fam)
    want = {**dict.fromkeys(kc.KERNELS, n_fwd), kc.PLAIN: n_plain}
    counts, _ = phase_train(
        kc, dev, fam, want, ["poly_w"], lockstep=True, f32_floor=True,
        n_convs=len(MNV3_CONVS) + 1,
        label=f"MobileNetV3-small 224x224 batch {MNV3_TRAIN_BATCH}",
        build=lambda: mnv3_smooth(mnv3_model(fam, seed=22)),
        batches=mnv3_batches(MNV3_TRAIN_BATCH), make_step=config5_step,
        steps_per_epoch=100)
    return counts


def time_config5_step(kc, label, log, model, dev, B, warmup, steps, want,
                      predict_runs, seed, card):
    """35 / 40. bench.py's config-5 step of ``model`` (AdamW with
    steps_per_epoch 100, ``config5_step``, 224 x 224 uint8 images) at
    batch ``B``: median images/s of ``steps`` steps after ``warmup``, each
    ending in a host readback of the loss, the peak device memory and the
    launches of all of them, which must be ``want`` ({name: per step}) per
    step; with ``predict_runs``, ``predict`` at the same batch (median of
    as many runs).  A batch that does not fit in the card's memory is
    halved until one does, and said so.  Returns (batch, step images/s,
    predict images/s or None, launches, launches by basis
    (``kc.launches_by_basis``), peak GiB)."""
    from convkan_tpu_torch.serve import InferenceEngine
    from convkan_tpu_torch.train.state import create_train_state

    y = torch.from_numpy(np.random.RandomState(seed + 1).randint(0, 10, B)) \
        .to(dev)
    while True:
        try:
            state = create_train_state(model, steps_per_epoch=100)
            step = config5_step(model)
            x = torch.from_numpy(seeded_images(B, seed)).to(dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kc.reset_launches()
            for _ in range(warmup):
                step(state, x, y[:B]).item()
            break
        except torch.cuda.OutOfMemoryError:
            print(f"{log} {label}: batch {B} does not fit in the card's "
                  f"memory (peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB); "
                  "halving the batch", flush=True)
            state = step = x = None
            torch.cuda.empty_cache()
            B //= 2
    y = y[:B]
    runs = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step(state, x, y).item()
        runs.append(B / (time.perf_counter() - t0))
    n = warmup + steps
    counts = dict(kc.launches, **kc.plain_calls)
    by_basis = dict(kc.launches_by_basis)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ips = statistics.median(runs)
    check(counts == {k: n * v for k, v in want.items()},
          f"{label} config-5 step: {counts} in {n} steps")
    pips = None
    if predict_runs:
        model.eval()
        engine = InferenceEngine(model, "CIFAR10", (224, 224, 3),
                                 buckets=(B,), device="cuda")
        try:
            xs = seeded_images(B, seed + 2)
            pruns = []
            for _ in range(predict_runs):
                t0 = time.perf_counter()
                engine.predict(xs)
                pruns.append(B / (time.perf_counter() - t0))
        finally:
            engine.close()
        pips = statistics.median(pruns)
        model.train()
    print(f"{log} {label} train step batch {B}: median {ips:.1f} images/s "
          f"({1e3 * B / ips:.3f} ms) over {steps} steps (min "
          f"{min(runs):.1f}, max {max(runs):.1f}); peak memory {peak:.2f} "
          f"GiB; {n} steps' counts {counts}"
          + ("" if pips is None else
             f"; predict batch {B}: median {pips:.1f} images/s (min "
             f"{min(pruns):.1f}, max {max(pruns):.1f})")
          + f" (on {card})", flush=True)
    del state, step, x, y
    torch.cuda.empty_cache()
    return B, ips, pips, counts, by_basis, peak


def time_mnv3(kc, fam, dev, card):
    """35. bench.py's config-5 step of MobileNetV3-small
    (``mnv3_model(fam, bench=True)``) at batch MNV3_TIME_BATCH
    (``time_config5_step``: 12 steps after 3 warm-up steps, predict the
    median of 10), then the device times of the ImageNet preprocessing and
    of the stem's forward and backward.  Returns (batch, step images/s,
    predict images/s, launches, {"prep_ms", "stem_ms"})."""
    from convkan_tpu_torch.train.data import imagenet_batch

    model = mnv3_model(fam, device=dev, seed=23, bench=True)
    n_fwd, n_plain = mnv3_want(fam)
    B, ips, pips, counts, _, _ = time_config5_step(
        kc, f"{fam} MobileNetV3-small 224x224", "[mnv3 time]", model, dev,
        MNV3_TIME_BATCH, 3, 12,
        {**dict.fromkeys(kc.KERNELS, n_fwd), kc.PLAIN: n_plain}, 10, 35,
        card)
    # two parts of the step outside the kernels: the ImageNet preprocessing
    # (resize to 256, centre crop) and the strided stem on the plain route
    # (its basis materialized at 224 x 224), forward and backward
    x = torch.from_numpy(seeded_images(B, 35)).to(dev)
    xin = imagenet_batch(x, False, "CIFAR10")
    gy = torch.randn_like(model.KanConvND_0(xin))
    parts = {"prep_ms": cuda_ms(lambda: imagenet_batch(x, False, "CIFAR10"),
                                iters=5, what=(f"mnv3 {fam}", "prep_ms")),
             "stem_ms": cuda_ms(lambda: model.KanConvND_0(xin).backward(gy),
                                iters=3, warmup=1,
                                what=(f"mnv3 {fam}", "stem_ms"))}
    print(f"[mnv3 time] {fam} at batch {B}: imagenet_batch "
          f"{parts['prep_ms']:.3f} ms, the stem's forward and backward "
          f"(plain route) {parts['stem_ms']:.3f} ms (on {card})", flush=True)
    del model, x, xin, gy
    torch.cuda.empty_cache()
    return B, ips, pips, counts, parts


def phase_kernel_times(kc, log, suffix, basis, rows_nz, convs, gen, dev,
                       card, B, iters=(5, 1)):
    """35 / 40. each KAN-conv kernel of ``basis`` at the distinct shapes of
    ``convs`` ((H, C, O, k) of a model's convs of this basis, in order) at
    batch ``B`` (x U(-1, 1), Gram's beta as phase 20's): device time
    (``cuda_ms`` of ``iters[0]`` runs), the plain version (``iters[1]``),
    the library call over a materialized basis (cuDNN's conv, its dE and
    dW; ``sum(0)`` on a cold L2 for the reduction) and the bound: the
    interior (pixel, tap) pairs times the ``rows_nz`` rows of E non-zero at
    x (with Gram's beta terms in the data gradient) at the FP32 peak, or the
    bytes each input read once and each output written once at HBM rate,
    the larger.  Entries are named with ``suffix``, lines start with
    ``log``.  Returns (per-kernel totals over ``convs`` in one train step,
    rows)."""
    names = kc.KERNELS
    totals = {n: dict.fromkeys(("ms", "plain_ms", "library_ms", "op_ms",
                                "byte_ms"), 0.0) for n in names}
    rows = []
    K, R = basis.K, basis.R
    it, plain_it = iters
    for H, C, O, k in dict.fromkeys(convs):
        pad = k // 2
        spec = (basis, k, pad)
        x, bw, pw = conv_inputs(gen, B, H, C, O, k=k, basis=basis)
        extra = conv_extra(gen, C, basis)
        g = torch.randn(B, H, H, O, generator=gen)
        x, pw, g = x.to(dev), pw.to(dev), g.to(dev)
        bw = None if bw is None else bw.to(dev)
        ex = () if extra is None else (extra.to(dev),)
        w_all = kc.pack_w_all(bw, pw, C=C, K=K, k=k, O=O,
                              degree_major=basis.degree_major)
        cfg = kc.dw_launch_config(B, H, H, C, O, k, pad, R)
        part = kc.weight_partials(x, g, *spec, *ex)
        red = reduction_times("kan_conv2d_bwd_dw_reduce" + suffix,
                              kc.reduce_partials, kc.reduce_reference, part)
        del part
        E = kc.expand(x, basis, *ex).permute(0, 3, 1, 2).contiguous()
        w = w_all.reshape(R * C, k, k, O).permute(3, 0, 1, 2).contiguous()
        gn = g.permute(0, 3, 1, 2).contiguous()

        def conv_bwd(mask):
            return torch.ops.aten.convolution_backward(
                gn, E, w, None, [1, 1], [pad, pad], [1, 1], False, [0, 0],
                1, mask)

        ms = {
            "kan_conv2d_fwd": (
                cuda_ms(lambda: kc.kan_conv2d(x, bw, pw, *spec, *ex),
                        iters=it),
                cuda_ms(lambda: kc.kan_conv2d_reference(x, bw, pw, *spec,
                                                        *ex),
                        iters=plain_it, warmup=1,
                        what=("kan_conv2d_fwd" + suffix, "plain_ms")),
                cuda_ms(lambda: torch.nn.functional.conv2d(E, w, padding=pad),
                        iters=it, what=("kan_conv2d_fwd" + suffix,
                                        "library_ms"))),
            "kan_conv2d_bwd_dx": (
                cuda_ms(lambda: kc.input_grad(x, w_all, g, *spec, *ex),
                        iters=it),
                cuda_ms(lambda: kc.input_grad_reference(x, w_all, g, *spec,
                                                        *ex),
                        iters=plain_it, warmup=1,
                        what=("kan_conv2d_bwd_dx" + suffix, "plain_ms")),
                cuda_ms(lambda: conv_bwd([True, False, False]), iters=it,
                        what=("kan_conv2d_bwd_dx" + suffix, "library_ms"))),
            "kan_conv2d_bwd_dw": (
                cuda_ms(lambda: kc.weight_partials(x, g, *spec, *ex),
                        iters=it),
                cuda_ms(lambda: kc.weight_grad_reference(x, g, *spec, *ex),
                        iters=plain_it, warmup=1,
                        what=("kan_conv2d_bwd_dw" + suffix, "plain_ms")),
                cuda_ms(lambda: conv_bwd([False, True, False]), iters=it,
                        what=("kan_conv2d_bwd_dw" + suffix, "library_ms"))),
            "kan_conv2d_bwd_dw_reduce": (red["ms"], red["plain_ms"],
                                         red["library_ms"]),
        }
        del E, gn
        torch.cuda.empty_cache()
        n = convs.count((H, C, O, k))
        D, S = R * C, cfg["S"]
        flops = 2 * B * interior_pairs(H, k, pad) * rows_nz * C * O
        dx_flops = flops + (GRAM_DBETA_FLOPS * B * H * H * C
                            if basis.n_extra else 0)
        work = {
            "kan_conv2d_fwd": (flops, 4 * (x.numel() + w_all.numel()
                                           + B * H * H * O)),
            "kan_conv2d_bwd_dx": (dx_flops, 4 * (2 * x.numel()
                                                 + w_all.numel()
                                                 + g.numel())),
            "kan_conv2d_bwd_dw": (flops, 4 * (x.numel() + g.numel()
                                              + S * D * k * k * O)),
            "kan_conv2d_bwd_dw_reduce": reduce_work(S, D * k * k * O)}
        row = {"H": H, "C": C, "O": O, "k": k, "batch": B, "layers": n,
               "S": S}
        for name in names:
            op_ms = work[name][0] / PEAK_FP32_FLOPS * 1e3
            byte_ms = work[name][1] / PEAK_BYTES * 1e3
            k_ms, p_ms, l_ms = ms[name]
            row[name] = {"ms": round(k_ms, 4), "plain_ms": round(p_ms, 4),
                         "library_ms": round(l_ms, 4),
                         "bound_ms": round(max(op_ms, byte_ms), 4),
                         "bound_share": round(max(op_ms, byte_ms) / k_ms, 4)}
            for key, v in (("ms", k_ms), ("plain_ms", p_ms),
                           ("library_ms", l_ms), ("op_ms", op_ms),
                           ("byte_ms", byte_ms)):
                totals[name][key] += n * v
        rows.append(row)
        print(f"{log} {json.dumps(row)}", flush=True)
        del x, g, w_all
    for name in names:
        t = totals[name]
        t["bound_ms"] = max(t["op_ms"], t["byte_ms"])
        print(f"{log} {name} per train step ({len(convs)} convs) at batch "
              f"{B}: kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
              f"library {t['library_ms']:.3f} ms, bound "
              f"{t['bound_ms']:.3f} ms, "
              f"{100 * t['bound_ms'] / t['ms']:.1f}% of the bound (on "
              f"{card})", flush=True)
    torch.cuda.empty_cache()
    return totals, rows


# ------------------------------------------ KAN-EfficientNetV2-s: path D
def effv2_model(kan_conv, device="cpu", seed=41, remat=True, **kw):
    """EfficientNetV2-s, 10 classes, seeded, as bench.py builds it
    (efficientnetv2_kan(arch="s", kan_conv=...): BatchNorm without affine,
    head dropout 0.2, stochastic depth 0.2, remat) and as train.py --model
    EfficientNetV2KAN --arch s builds it (the same defaults); ``kw``
    overrides a builder default."""
    from convkan_tpu_torch.models.efficientnetv2 import efficientnetv2_kan

    return efficientnetv2_kan(arch="s", num_classes=10, kan_conv=kan_conv,
                              remat=remat,
                              generator=torch.Generator().manual_seed(seed),
                              device=device, **kw)


def effv2_tiny(kan_conv, device="cpu", seed=41):
    """EfficientNetV2 kan_tiny (32 x 32 inputs, the golden's family), 10
    classes, seeded."""
    from convkan_tpu_torch.models.efficientnetv2 import \
        efficientnetv2_kan_small

    return efficientnetv2_kan_small(
        arch="kan_tiny", num_classes=10, kan_conv=kan_conv,
        generator=torch.Generator().manual_seed(seed), device=device)


def effv2_bases(kc) -> dict:
    """The bases path D's kernels run: the B-spline (grid 5, order 3) with
    the identity base path (the projections) and with SiLU (the other
    convs), and the Gram basis of degree 3 with the identity on every row
    (a GRAMKAN model's projections)."""
    from convkan_tpu_torch.basis.bspline import make_bspline_grid

    knots = tuple(float(v) for v in make_bspline_grid(5, 3))
    return {"identity": kc.bspline_basis(knots, 3, "identity"),
            "gram_identity": kc.gram_basis(3, "identity"),
            "silu": kc.bspline_basis(knots, 3, "silu")}


def effv2_want(kan_conv, remat_steps=False):
    """Kernel forwards and plain-route convs of one forward of the s model
    (KAN, GRAMKAN: the 77 stride-1 convs on the kernels, 3 strided ones on
    the plain route; FastKAN: 0 and 80), or with ``remat_steps`` of one
    train step with remat, whose backward runs the 78 convs of the blocks
    again (all but the stem and the head: 76 and 2 more; FastKAN 0 and
    78)."""
    n = 0 if kan_conv == "FastKAN" else len(EFFV2_CONVS)
    n_fwd, n_plain = n, len(EFFV2_CONVS) + 3 - n
    if remat_steps:     # the blocks hold all but the stem (plain) and head
        again = n_fwd - (n > 0)
        n_fwd, n_plain = n_fwd + again, n_plain + len(EFFV2_CONVS) + 1 - again
    return n_fwd, n_plain


def effv2_convs(tag):
    """The (H, C, O, k) of the s model's kernel convs, in order, that
    ``tag``'s basis runs: the projections for the identity bases, the
    other convs for SiLU."""
    proj = tag != "silu"
    return [s for s, p in zip(EFFV2_CONVS, EFFV2_PROJ) if p == proj]


def phase_effv2_kernels(kc, gen, dev):
    """36. the KAN-conv kernels' identity instantiations (B-spline, Gram
    with beta) at every distinct kernel shape of EfficientNetV2-s (batch
    EFFV2_CHECK_BATCH), and the SiLU B-spline at the shapes no earlier path
    reached (the 3x3 conv at 112 x 112, C or O >= 768): the forward against
    the plain version (TOL), the backward kernels by ``backward_case`` (the
    data gradient, the weight-gradient partials and the autograd path
    against float64 (BWD_TOL), the reduction bit-exact in the kernel's
    order; beta's partials held to float64 by ``extra_check``).  Returns
    max |err| per kernel and basis."""
    errs = {}
    for tag, basis in effv2_bases(kc).items():
        err = dict.fromkeys(kc.KERNELS, 0.0)
        shapes = list(dict.fromkeys(EFFV2_CONVS)) if tag != "silu" else \
            [s for s in dict.fromkeys(EFFV2_CONVS)
             if s[0] == 112 or max(s[1], s[2]) >= 768]
        for H, C, O, k in shapes:
            B, pad = EFFV2_CHECK_BATCH, k // 2
            x, bw, pw = conv_inputs(gen, B, H, C, O, k=k, basis=basis)
            extra = conv_extra(gen, C, basis)
            g = torch.randn(B, H, H, O, generator=gen)
            x, bw, pw, g = x.to(dev), bw.to(dev), pw.to(dev), g.to(dev)
            ex = () if extra is None else (extra.to(dev),)
            y = kc.kan_conv2d(x, bw, pw, basis, k, pad, *ex)
            ref = kc.kan_conv2d_reference(x, bw, pw, basis, k, pad, *ex)
            e = (y - ref).abs().max().item()
            ok = torch.allclose(y, ref, rtol=TOL, atol=TOL)
            cfg = kc.launch_config(B, H, H, C, O, k, pad, basis.R)
            print(f"[effv2 kernel] {tag} B={B} {H}x{H} C={C} O={O} k={k} "
                  f"(BN {cfg['BN']}, CC {cfg['CC']}, S {cfg['S']}, "
                  f"{cfg['blocks']} blocks): forward max|err| {e:.3e} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            check(bool(torch.isfinite(y).all()) and ok,
                  f"kernel disagrees with the plain version ({tag} B={B} "
                  f"H={H} C={C} O={O} k={k})")
            err["kan_conv2d_fwd"] = max(err["kan_conv2d_fwd"], e)
            case, _, _, _ = backward_case(kc, basis, x, bw, pw, g, k, pad,
                                          tag="[effv2 backward]",
                                          extra=ex[0] if ex else None)
            for name, e in case.items():
                err[name] = max(err.get(name, 0.0), e)
        errs[tag] = err
        print(f"[effv2 kernel] {tag}: max |err| {json.dumps(err)}",
              flush=True)
    return errs


def effv2_eval_model(kan_conv, served=False):
    """Phases 37 and 38's model on the CPU in eval mode: ``effv2_model``
    (GRAMKAN: ``effv2_tiny``) smoothed (``mnv3_smooth``) with its running
    statistics set by ``mnv3_calibrate`` from 8 seeded images in the form
    ``mnv3_prep(served)`` gives (kan_tiny: 32 x 32, normalized)."""
    if kan_conv == "GRAMKAN":
        from convkan_tpu_torch.train.data import normalize_batch
        return mnv3_calibrate(mnv3_smooth(effv2_tiny(kan_conv)),
                              normalize_batch(torch.from_numpy(
                                  seeded_images(8, 40, 32)), "CIFAR10"))
    return mnv3_calibrate(mnv3_smooth(effv2_model(kan_conv)),
                          mnv3_prep(seeded_images(8, 40), served))


def phase_effv2_model(kc, dev):
    """37. the KAN and FastKAN EfficientNetV2-s and the GRAMKAN kan_tiny
    (``effv2_eval_model`` on the CPU, moved to the card): eval logits of
    EFFV2_MODEL_BATCH images on the card against the CPU (MODEL_TOL) and
    not the same for every image, and the kernel launches and plain-route
    convs of one forward: 77 and 3 (FastKAN 0 and 80; kan_tiny 9 and 2).
    Returns the forwards' launches by basis (``kc.launches_by_basis``)."""
    from convkan_tpu_torch.train.data import normalize_batch

    by_basis = collections.Counter()
    for fam in EFFV2_FAMILIES:
        cpu = effv2_eval_model(fam)
        gpu = copy.deepcopy(cpu).to(dev)
        tiny = fam == "GRAMKAN"
        x = normalize_batch(torch.from_numpy(seeded_images(
            EFFV2_MODEL_BATCH, 41, 32)), "CIFAR10") if tiny else \
            mnv3_prep(seeded_images(EFFV2_MODEL_BATCH, 41))
        with torch.inference_mode():
            kc.reset_launches()
            got = gpu(x.to(dev)).cpu()
            torch.cuda.synchronize()
            counts = dict(kc.launches, **kc.plain_calls)
            by_basis.update(kc.launches_by_basis)
            want = cpu(x)
        n_fwd, n_plain = (9, 2) if tiny else effv2_want(fam)
        err = (got - want).abs().max().item()
        spread = (got - got[0]).abs().max().item()
        arch = "kan_tiny" if tiny else "s"
        print(f"[effv2 model] {fam} EfficientNetV2-{arch}"
              f" logits {tuple(got.shape)} GPU vs CPU max|err| {err:.3e} "
              f"(spread over the images {spread:.3e}); one forward: {counts}",
              flush=True)
        check(bool(torch.isfinite(got).all()), "model logits not finite")
        check(counts == {**dict.fromkeys(kc.KERNELS, 0),
                         "kan_conv2d_fwd": n_fwd, kc.PLAIN: n_plain},
              f"{fam}: expected {n_fwd} forward launches and {n_plain} "
              f"plain-route convs, got {counts}")
        check(torch.allclose(got, want, rtol=MODEL_TOL, atol=MODEL_TOL),
              f"{fam} logits on the GPU disagree with the CPU")
        check(spread > 1e-3, f"{fam}: the logits are the same for every "
                             "image")
    return by_basis


def effv2_batches(B, steps=TRAIN_STEPS, seed=44, size=EFFV2_TRAIN_SIZE):
    """Seeded size x size uint8 images and labels (no crops, no flips)."""
    rng = np.random.RandomState(seed)
    return [(torch.from_numpy(seeded_images(B, seed + i, size)),
             torch.from_numpy(rng.randint(0, 10, B).astype(np.int64)),
             None, None) for i in range(steps)]


def effv2_step(model):
    """Phase 39's step: the dataset's normalization of its
    EFFV2_TRAIN_SIZE images (imagenet=False, augment=False)."""
    from convkan_tpu_torch.train.loop import make_train_step
    return make_train_step(model, "CIFAR10", augment=False)


def effv2_train_model(kan_conv="GRAMKAN"):
    """Phase 39's model: the seeded EfficientNetV2-s (remat, stochastic
    depth EFFV2_SD), GRAMKAN at its init, the B-spline smoothed
    (``mnv3_smooth``; see EFFV2_TRAIN)."""
    model = effv2_model(kan_conv, seed=42, stochastic_depth_prob=EFFV2_SD)
    return model if kan_conv == "GRAMKAN" else mnv3_smooth(model)


def conv_kernel_readings(kc, model, batches, make_step, dev):
    """39 (cont.). The KAN-conv kernels on a train step's own tensors: one
    step of ``model`` on the card (``train_run``, the first of
    ``batches``), each KAN conv's input, weights and output gradient kept,
    then its forward, data-gradient and weight-gradient kernels on them
    against float64 autograd of its plain version (max |diff| over the
    largest float64 entry).  Returns [(the worst of the three, conv name,
    basis key, forward, dx, dW)], worst first."""
    from convkan_tpu_torch.nn import kan_conv as nk

    where, calls = [None], []
    hooks = [m.register_forward_pre_hook(
        lambda _m, _i, name=name: where.__setitem__(0, name))
        for name, m in model.named_modules() if isinstance(m, nk.KanConvND)]
    conv = nk.kan_conv2d

    def record(x, base_w, poly_w, basis, k, pad, extra=None):
        y = conv(x, base_w, poly_w, basis, k, pad, extra)
        e = {"name": where[0], "spec": (basis, k, pad),
             "y": y.detach().clone(),
             "args": [None if t is None else t.detach().clone()
                      for t in (x, base_w, poly_w, extra)]}
        calls.append(e)
        if y.requires_grad:   # under remat, the forward's call is the one
            y.register_hook(  # backpropagated through
                lambda g, e=e: e.__setitem__("g", g.detach().contiguous()))
        return y

    nk.kan_conv2d = record
    try:
        train_run(model, dev, batches[:1], make_step=make_step,
                  steps_per_epoch=100)
    finally:
        nk.kan_conv2d = conv
        for h in hooks:
            h.remove()

    def rel(a, b):
        return ((a.double().cpu() - b).abs().max() / b.abs().max()).item()

    rows = []
    for e in calls:
        if "g" not in e:
            continue
        x, bw, pw, ex = e["args"]
        basis, k, pad = e["spec"]
        d = [None if t is None else t.double().cpu().requires_grad_()
             for t in (x, bw, pw, ex)]
        ref = kc.kan_conv2d_reference(*d[:3], basis, k, pad, d[3])
        ref.backward(e["g"].double().cpu())
        pack = functools.partial(kc.pack_w_all, C=x.shape[-1], K=basis.K,
                                 k=k, O=pw.shape[-1],
                                 degree_major=basis.degree_major)
        dx = kc.input_grad(x, pack(bw, pw), e["g"], basis, k, pad, ex)
        dw = kc.weight_grad(x, e["g"], basis, k, pad, ex)
        read = (rel(e["y"], ref.detach()), rel(dx, d[0].grad),
                rel(dw, pack(None if bw is None else d[1].grad, d[2].grad)))
        rows.append((max(read), e["name"], basis.key, *read))
    return sorted(rows, reverse=True)


def phase_effv2_train(kc, dev):
    """39. training, the main path: three train steps of each EFFV2_TRAIN
    EfficientNetV2-s (``effv2_train_model``: remat, DropPath on) at batch
    EFFV2_TRAIN_BATCH of EFFV2_TRAIN_SIZE images in lockstep GPU vs CPU
    (``phase_train``, as phase 34 holds path C: every step's loss,
    update, running statistics and, for GRAMKAN, gradients against
    float64 within GRAD_TOL or F32_SPREAD x float32's spread (the B-spline
    model's readings printed, not held: see EFFV2_TRAIN); the control;
    GRAMKAN: beta's entries 0 and 3 exactly 0 in every conv).  Out of
    lockstep the float32 trajectories part within the three steps (AdamW
    moves an entry whose gradient is rounding by +-lr either way).  The
    launches per step: 153 forwards (77, and 76 again in the blocks'
    recompute), 77 data-gradient and weight-gradient launches, 77
    reductions (GRAMKAN: 154, dW and beta per conv), 5 plain routes (3, and
    2 in the recompute).  Then, for the B-spline model, the 77 kernel
    convs' kernels on its first step's own tensors
    (``conv_kernel_readings``, with remat) within BWD_TOL of float64.
    Returns the launches by basis (``kc.launches_by_basis``) of the
    lockstep GPU steps."""
    n_fwd, n_plain = effv2_want("KAN", remat_steps=True)
    n = len(EFFV2_CONVS)
    by_basis = collections.Counter()
    for fam, hold_grads in EFFV2_TRAIN.items():
        gram = fam == "GRAMKAN"
        want = {"kan_conv2d_fwd": n_fwd, "kan_conv2d_bwd_dx": n,
                "kan_conv2d_bwd_dw": n,
                "kan_conv2d_bwd_dw_reduce": (1 + gram) * n, kc.PLAIN: n_plain}
        batches = effv2_batches(EFFV2_TRAIN_BATCH)
        counts, _ = phase_train(
            kc, dev, fam, want,
            ["base_w", "poly_w"] + ["beta_weights"] * gram, lockstep=True,
            f32_floor=hold_grads, hold_grads=hold_grads,
            zero_entries=[("beta_weights", 0), ("beta_weights", 3)] * gram,
            n_convs=n + 3,
            label=f"EfficientNetV2-s {EFFV2_TRAIN_SIZE}x{EFFV2_TRAIN_SIZE} "
                  f"batch {EFFV2_TRAIN_BATCH}, remat, stochastic depth "
                  f"{EFFV2_SD}",
            build=functools.partial(effv2_train_model, fam),
            batches=batches, make_step=effv2_step, steps_per_epoch=100)
        # phase_train's CPU runs launch nothing: the counters still hold
        # its GPU steps
        got = collections.Counter(kc.launches_by_basis)
        check(all(sum(v for (k, _), v in got.items() if k == name) ==
                  counts[name] for name in kc.KERNELS),
              f"launches by basis {dict(got)} against {counts}")
        by_basis.update(got)
        if hold_grads:
            continue
        rows = conv_kernel_readings(kc, effv2_train_model(fam).to(dev),
                                    batches, effv2_step, dev)
        print(f"[train] {fam} kernels on the first step's own tensors vs "
              f"float64 (forward, dx, dW; max |diff| over the largest "
              f"entry), {len(rows)} convs, the worst 4: "
              + "; ".join(f"{nm} {key[-1]} {f:.3e} {dx:.3e} {dw:.3e}"
                          for _, nm, key, f, dx, dw in rows[:4]), flush=True)
        check(len(rows) == n and rows[0][0] <= BWD_TOL,
              f"{fam}: the kernels on the step's own tensors")
    return by_basis


def effv2_remat_step(kc, model, dev, wrapper=None):
    """One train step of ``model`` on the card from a fresh seeded state
    (the batch of phase 39's first step): its gradients, each DropPath's
    mask at each call (the recompute's too: each block is recomputed
    whole, without torch's early stop), the running statistics, the
    launches (and by basis) and the peak memory.  ``wrapper`` replaces the
    blocks' checkpoint_block (the control)."""
    from torch.utils.checkpoint import set_checkpoint_early_stop

    from convkan_tpu_torch.models import efficientnetv2 as effv2
    from convkan_tpu_torch.ops.layers import DropPath
    from convkan_tpu_torch.train.state import create_train_state

    masks = {}
    hooks = [m.register_forward_hook(
        lambda _m, i, o, n=n: masks.setdefault(n, []).append(
            (o != 0).flatten(1).any(1).cpu()))
        for n, m in model.named_modules()
        if isinstance(m, DropPath) and m.drop_prob > 0]
    state = create_train_state(model, 1e-3, 1e-3, 0.8, steps_per_epoch=100,
                               generator=torch.Generator().manual_seed(7))
    xb, yb, _, _ = effv2_batches(EFFV2_TRAIN_BATCH, steps=1)[0]
    plain = effv2.checkpoint_block
    if wrapper is not None:
        effv2.checkpoint_block = wrapper
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kc.reset_launches()
        with set_checkpoint_early_stop(False):
            effv2_step(model)(state, xb.to(dev), yb.to(dev)).item()
        counts = dict(kc.launches, **kc.plain_calls)
        by_basis = dict(kc.launches_by_basis)
    finally:
        effv2.checkpoint_block = plain
        for h in hooks:
            h.remove()
    peak = torch.cuda.max_memory_allocated() / 2**30
    grads = {n: p.grad.detach().cpu().clone()
             for n, p in model.named_parameters()}
    stats = {n: b.detach().cpu().clone() for n, b in model.named_buffers()}
    return grads, masks, stats, counts, peak, by_basis


def effv2_remat_compare(kc, dev):
    """39 (cont.). GPU remat=True against remat=False from one start (the
    same weights, batch and generator): the DropPath masks of the forward
    equal and each recompute's equal to its forward's, the running
    statistics equal (moved once), every gradient within REMAT_TOL of its
    largest entry (cuDNN's backward algorithms may sum in another order),
    the launches 153/77 against 77/77 forwards.  The control, a plain
    torch.utils.checkpoint wrapper (masks drawn again in the recompute,
    statistics moved twice), must fail the masks' and the statistics'
    checks.  Returns the launches by basis of the two compared steps."""
    from torch.utils.checkpoint import checkpoint

    base = effv2_train_model()
    runs = {}
    for remat in (True, False):
        m = copy.deepcopy(base).to(dev)
        m.remat = remat
        runs[remat] = effv2_remat_step(kc, m, dev)
        del m

    def plain_checkpoint(block, x, generator=None):
        return checkpoint(lambda inp: block(inp, generator), x,
                          use_reentrant=False)

    m = copy.deepcopy(base).to(dev)
    control = effv2_remat_step(kc, m, dev, wrapper=plain_checkpoint)
    del m
    torch.cuda.empty_cache()
    (g1, m1, s1, c1, p1, b1), (g0, m0, s0, c0, p0, b0) = \
        runs[True], runs[False]

    def readings(g, masks, stats):
        grad = max(((g[n] - r).abs().max() / r.abs().max().clamp_min(
            1e-30)).item() for n, r in g0.items())
        same_masks = sorted(masks) == sorted(m0) and all(
            all(torch.equal(u, m0[n][0]) for u in masks[n]) for n in m0)
        stat = max(((stats[n] - r).abs().max() / r.abs().max().clamp_min(
            1e-30)).item() for n, r in s0.items())
        return grad, same_masks, stat

    grad, same_masks, stat = readings(g1, m1, s1)
    c_grad, c_masks, c_stat = readings(*control[:3])
    dropped = sum(int((~v[0]).sum()) for v in m0.values())
    print(f"[effv2 remat] one step GPU remat=True vs remat=False: gradients "
          f"max |diff| {grad:.3e} of the largest entry, DropPath masks "
          f"{'equal' if same_masks else 'DIFFERENT'} ({len(m0)} DropPaths, "
          f"{dropped} samples dropped; recompute calls per DropPath "
          f"{sorted({len(v) for v in m1.values()})}), running statistics "
          f"{stat:.3e}; launches {c1} vs {c0}; peak memory {p1:.2f} vs "
          f"{p0:.2f} GiB; control (plain torch.utils.checkpoint): gradients "
          f"{c_grad:.3e}, masks {'equal' if c_masks else 'different'}, "
          f"statistics {c_stat:.3e}", flush=True)
    n_fwd, n_plain = effv2_want("GRAMKAN", remat_steps=True)
    check(grad <= REMAT_TOL and same_masks and stat == 0.0 and dropped > 0,
          "remat=True and remat=False disagree on the GPU")
    check(c1["kan_conv2d_fwd"] == n_fwd and c1[kc.PLAIN] == n_plain and
          c1["kan_conv2d_bwd_dx"] == c0["kan_conv2d_bwd_dx"] and
          c0["kan_conv2d_fwd"] == len(EFFV2_CONVS) and c0[kc.PLAIN] == 3,
          f"launches with and without remat: {c1}, {c0}")
    check(not c_masks and c_stat > 0.0,
          "the control (a plain checkpoint wrapper) passes the checks")
    return collections.Counter(b1) + collections.Counter(b0)


def time_effv2(kc, fam, dev, card, remat=True, predict=True):
    """40. bench.py's config-5 EfficientNetV2 step (``effv2_model(fam,
    remat=...)``) at batch EFFV2_TIME_BATCH (``time_config5_step``:
    EFFV2_STEPS steps after EFFV2_WARMUP; with ``predict`` also predict,
    the median of 5).  Returns what that returns."""
    model = effv2_model(fam, device=dev, seed=43, remat=remat)
    n_fwd, n_plain = effv2_want(fam, remat_steps=remat)
    n_bwd = 0 if fam == "FastKAN" else len(EFFV2_CONVS)
    out = time_config5_step(
        kc, f"{fam} remat={remat} EfficientNetV2-s 224x224", "[effv2 time]",
        model, dev, EFFV2_TIME_BATCH, EFFV2_WARMUP, EFFV2_STEPS,
        {**dict.fromkeys(kc.KERNELS, n_bwd), "kan_conv2d_fwd": n_fwd,
         kc.PLAIN: n_plain}, 5 if predict else 0, 45, card)
    del model
    torch.cuda.empty_cache()
    return out


def effv2_summary(kc, effv2_k, effv2_time, batch, card):
    """40 (cont.). The KAN remat step's time against its KAN-conv kernels'
    (the per-shape device times of ``phase_kernel_times`` at
    ``batch`` times the layers; the blocks' convs run forward twice, all
    but the head conv), and every timed step's peak memory."""
    B, ips = effv2_time[("KAN", True)][:2]
    step_ms = 1e3 * B / ips
    fwd = sum(effv2_k[tag][0]["kan_conv2d_fwd"]["ms"]
              for tag in ("identity", "silu"))
    head = [r for r in effv2_k["silu"][1] if (r["H"], r["C"], r["O"]) ==
            EFFV2_CONVS[-1][:3]][0]["kan_conv2d_fwd"]["ms"]
    bwd = sum(effv2_k[tag][0][name]["ms"] for tag in ("identity", "silu")
              for name in kc.KERNELS if name != "kan_conv2d_fwd")
    k_ms = 2 * fwd - head + bwd
    print(f"[effv2 time] KAN remat train step {step_ms:.3f} ms at batch {B}:"
          f" KAN-conv kernels {k_ms:.3f} ms (forward {fwd:.3f} x 2 less the "
          f"head conv's {head:.3f} (the recompute), backward {bwd:.3f}; "
          f"per-shape device times x layers at batch {batch}), the "
          f"rest {step_ms - k_ms:.3f} ms; peak memory "
          + ", ".join(f"{f} remat={r} {t[5]:.2f} GiB at batch {t[0]}"
                      for (f, r), t in effv2_time.items())
          + f" (on {card})", flush=True)


# ------------------------------ KAN-VGG16_small, static bases: path E
def static_basis(key):
    """The basis of ``key``'s convs as VGG16_small builds them."""
    from convkan_tpu_torch.nn.kan_conv import KanConvND
    return KanConvND(STATIC_FAMILIES[key], 4, 4, 3, base_activation="silu",
                     device="cpu").basis


def static_tag(kc, key) -> str:
    """The instantiation (STATIC_TAGS) that ``key``'s convs run."""
    return STATIC_TAGS[kc.COMPILED[static_basis(key).key]]


def zero_rows_check(kc, key, basis, x, bw, pw, g):
    """STATIC_ZERO's rows of ``key`` on the card: with those rows of poly_w
    zeroed the data gradient is bit-identical (their derivative is exactly
    0), and where their values are 0 the forward too, and their rows of
    the weight gradient are exactly 0."""
    rows, what = STATIC_ZERO[key]
    C, O, K = x.shape[-1], pw.shape[-1], basis.K
    pz = pw.clone()
    pz.view(3, 3, C, K, O)[:, :, :, list(rows)] = 0   # rows c*K + kk
    spec = (basis, 3, 1)
    w_all = kc.pack_w_all(bw, pw, C=C, K=K, k=3, O=O)
    wz = kc.pack_w_all(bw, pz, C=C, K=K, k=3, O=O)
    ok = torch.equal(kc.input_grad(x, w_all, g, *spec),
                     kc.input_grad(x, wz, g, *spec))
    if what == "value":
        dw = kc.weight_grad(x, g, *spec).view(basis.R, C, -1)
        ok = ok and not dw[list(rows)].any() and torch.equal(
            kc.kan_conv2d(x, bw, pw, *spec), kc.kan_conv2d(x, bw, pz, *spec))
    print(f"[static kernel] {key}: rows {list(rows)} (their {what} exactly "
          f"0): data gradient unchanged with them zeroed"
          + (", forward unchanged, their weight gradient exactly 0"
             if what == "value" else "") + f" {'ok' if ok else 'FAIL'}",
          flush=True)
    check(ok, f"{key}: the exact zeros of rows {list(rows)} are not kept")


def phase_static_kernels(kc, gen, dev):
    """41. each family's instantiation against its plain version: the
    forward (TOL) and ``backward_case`` (the data gradient and the weight
    partials against float64 within BWD_TOL, the reduction bit-exact, the
    autograd path's gradients) at the 9 distinct VGG16_small shapes at
    batch 64, x U(-2, 2), every kernel's result of two calls
    bit-identical; the timed family of each instantiation also at the
    first and the last shape at batch 1024 (the tiles of the step; the
    partials held to float64 through the reduced dW); STATIC_ZERO's exact
    zeros.  Returns max |err| per kernel by instantiation tag."""
    errs = {}
    for key in STATIC_FAMILIES:
        basis = static_basis(key)
        tag = static_tag(kc, key)
        e = errs.setdefault(tag, dict.fromkeys(kc.KERNELS, 0.0))
        cases = [(64, H, C, O) for H, C, O in dict.fromkeys(
            VGG16_SMALL_CONVS)]
        if STATIC_TIMED[tag] == key:
            cases += [(TIME_BATCH, *VGG16_SMALL_CONVS[0]),
                      (TIME_BATCH, *VGG16_SMALL_CONVS[-1])]
        for B, H, C, O in cases:
            x, bw, pw = conv_inputs(gen, B, H, C, O, 2.0, basis=basis)
            g = torch.randn(B, H, H, O, generator=gen)
            x, bw, pw, g = (t.to(dev) for t in (x, bw, pw, g))
            y = kc.kan_conv2d(x, bw, pw, basis, 3, 1)
            same = torch.equal(y, kc.kan_conv2d(x, bw, pw, basis, 3, 1))
            torch.cuda.synchronize()
            ref = kc.kan_conv2d_reference(x, bw, pw, basis, 3, 1)
            err = (y - ref).abs().max().item()
            ok = torch.allclose(y, ref, rtol=TOL, atol=TOL)
            cfg = kc.launch_config(B, H, H, C, O, 3, 1, basis.R)
            print(f"[static kernel] {key} ({basis}) B={B} {H}x{H} C={C} "
                  f"O={O} (BN {cfg['BN']}, "
                  f"{'skip' if cfg['skip'] else 'dense'}, CC {cfg['CC']}, "
                  f"S {cfg['S']}, {cfg['blocks']} blocks): max|err| "
                  f"{err:.3e}, two calls "
                  f"{'bit-identical' if same else 'DIFFERENT'} "
                  f"{'ok' if ok and same else 'FAIL'}", flush=True)
            check(bool(torch.isfinite(y).all()), f"{key} kernel output not "
                                                 "finite")
            check(ok and same, f"{key} kernel disagrees with the plain "
                               f"version, or two calls differ (B={B} H={H} "
                               f"C={C} O={O})")
            e["kan_conv2d_fwd"] = max(e["kan_conv2d_fwd"], err)
            del y, ref
            case, _, _, _ = backward_case(
                kc, basis, x, bw, pw, g, 3, 1, partials=B < TIME_BATCH,
                twice=True, tag=f"[static backward] {key}")
            for name, v in case.items():
                e[name] = max(e[name], v)
            if key in STATIC_ZERO and B < TIME_BATCH and H == 16:
                zero_rows_check(kc, key, basis, x, bw, pw, g)
    return errs


def static_model(key, seed, curve=1.0, device="cpu"):
    """Path E's seeded VGG16_small of ``key`` (train.py's build: the (1, 1)
    head), its poly_w scaled by ``curve`` (``mnv3_smooth``)."""
    from convkan_tpu_torch.models.vgg import vggkan
    return mnv3_smooth(vggkan(3, 10, arch="VGG16_small", kan_conv=key,
                              classifier_type="Linear",
                              generator=torch.Generator().manual_seed(seed),
                              device=device), curve)


def phase_static_model(kc, key, dev, imgs):
    """42. ``key``'s seeded VGG16_small on the card at batch 1024: its
    logits of the first STATIC_MODEL_CHECK images against the CPU's float32
    and float64 (the GPU within CHEBY_F32 times the CPU float32's distance
    from float64 plus MODEL_TOL), not the same for every image; 13 kernel
    forwards, all of the family's basis (LegendreKAN: 13 plain-route convs
    and no launch; its squash takes the batch's min and max, so its GPU
    logits held are those of the CPU's batch).  Returns the GPU model
    (eval mode), the launches by basis and the tolerance the logits were
    held to."""
    from convkan_tpu_torch.train.data import normalize_batch

    model_cpu = static_model(key, 0).eval()
    model_gpu = copy.deepcopy(model_cpu).to(dev)
    x = normalize_batch(torch.from_numpy(imgs), "CIFAR10")
    n = STATIC_MODEL_CHECK
    legendre = key == "LegendreKAN"
    with torch.inference_mode():
        kc.reset_launches()
        got = model_gpu(x.to(dev)).cpu()
        torch.cuda.synchronize()
        by_basis = collections.Counter(kc.launches_by_basis)
        plain = kc.plain_calls[kc.PLAIN]
        # Legendre's squash is a min-max over the batch: the GPU runs the
        # CPU's batch for the comparison
        part = model_gpu(x[:n].to(dev)).cpu() if legendre else got[:n]
        want = model_cpu(x[:n])
        exact = copy.deepcopy(model_cpu).double()(x[:n].double())
    e_cpu = (want.double() - exact).abs().max().item()
    e_gpu = (part.double() - exact).abs().max().item()
    tol = CHEBY_F32 * e_cpu + MODEL_TOL
    want_basis = {} if legendre else \
        {("kan_conv2d_fwd", static_basis(key).key): 13}
    print(f"[static model] {key} VGG16_small logits {tuple(got.shape)}: "
          f"the first {n} vs float64 on the CPU, GPU max|err| {e_gpu:.3e}, "
          f"CPU float32 {e_cpu:.3e} (allowed {tol:.3e}); launches "
          f"{dict(by_basis)}, plain-route convs {plain}", flush=True)
    check(bool(torch.isfinite(got).all()), f"{key} logits not finite")
    check((got - got[0]).abs().max().item() > 1e-3,
          f"{key}: the logits are the same for every image")
    check(e_gpu <= tol, f"{key} logits on the GPU further from float64 than "
                        "the CPU's float32 allows")
    check(dict(by_basis) == want_basis and plain == 13 * legendre,
          f"{key}: expected {want_basis} launches and {13 * legendre} "
          f"plain-route convs per forward")
    return model_gpu, by_basis, tol


def static_train(kc, dev, key):
    """44. three lockstep train steps of ``key``'s VGG16_small (poly_w at
    STATIC_CURVE) as phase 26 holds them: losses, every gradient but the
    PReLU slopes (STATIC_UNHELD, printed) within GRAD_TOL of float64 or
    F32_SPREAD x float32's spread at the same start, updates, the
    control; per step 13 forward, 12 data-gradient, 13 weight-gradient and
    13 reduction launches, all of the family's basis (LegendreKAN: no
    launch, 13 plain-route convs).  Returns the launches by basis."""
    curve = STATIC_CURVE.get(key, 1.0)
    legendre = key == "LegendreKAN"
    want = dict.fromkeys(kc.KERNELS, 0) if legendre else \
        {"kan_conv2d_fwd": 13, "kan_conv2d_bwd_dx": 12,
         "kan_conv2d_bwd_dw": 13, "kan_conv2d_bwd_dw_reduce": 13}
    if legendre:
        want[kc.PLAIN] = 13
    phase_train(kc, dev, key, want, ["base_w", "poly_w"], lockstep=True,
                f32_floor=True, unheld=STATIC_UNHELD,
                label=f"VGG16_small batch {TRAIN_BATCH}, poly_w x {curve:g}",
                build=lambda: static_model(key, 2, curve))
    by_basis = collections.Counter(kc.launches_by_basis)
    keys = {k for _, k in by_basis}
    check(keys == (set() if legendre else {static_basis(key).key}),
          f"{key}: the train steps launched the bases {keys}")
    return by_basis


def kernel_entry(name, source, replaces, launches, err, t, times_are,
                 shapes, **extra):
    """One kernel's entry of the {"kernels": [...]} line; ``launches`` per
    main path ({"serve": n, "train": n, ...}), ``t`` the timing totals;
    ``host_bound`` lists the fields whose reading the host may have set
    (see cuda_ms)."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, **extra,
            "launches": sum(launches.values()),
            "launches_by_path": launches, "max_abs_err": err,
            "ms": round(t["ms"], 4), "plain_ms": round(t["plain_ms"], 4),
            "bound_ms": round(t["bound_ms"], 4),
            "bound_by": "operations" if t["op_ms"] >= t["byte_ms"]
            else "bytes",
            "library_ms": round(t["library_ms"], 4), "times_are": times_are,
            "host_bound": sorted(HOST_BOUND.get(name, ())),
            "shapes": shapes}


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    from convkan_tpu_torch.basis.bspline import make_bspline_grid
    from convkan_tpu_torch.device import set_full_f32
    from convkan_tpu_torch.kernels import build
    from convkan_tpu_torch.kernels import kan_conv2d as kc
    from convkan_tpu_torch.kernels import wav_conv2d as wc

    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(name):
        """Prints the seconds since the last lap: each path's share."""
        now = time.perf_counter()
        print(f"[time] {name}: {now - t_lap[0]:.1f} s", flush=True)
        t_lap[0] = now

    # ---------------------------------------------------------- 1. setup
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    set_full_f32()
    sources = (kc.SOURCE, kc.BWD_SOURCE, wc.SOURCE, wc.BWD_SOURCE)
    for src in sources:  # build from the checkout's sources
        build.library_path(src).unlink(missing_ok=True)
    t0 = time.perf_counter()
    took = {}

    def build_one(src):
        t = time.perf_counter()
        build.build(src)
        took[src] = round(time.perf_counter() - t, 1)

    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        list(pool.map(build_one, sources))
    print(f"[build] {', '.join(sources)} (in parallel): "
          f"{time.perf_counter() - t0:.2f} s; each {took}", flush=True)
    for src in sources:
        log = build.library_path(src).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or \
                    "spill" in line:
                print(f"[build] {src}: {line.strip()}")
    lap("setup and build")

    dev = torch.device("cuda")
    knots = tuple(float(v) for v in make_bspline_grid(5, 3))
    silu = kc.bspline_basis(knots, 3, "silu")
    gen = torch.Generator().manual_seed(0)

    # ------------------------------------------ 2. kernel vs plain version
    cases = [(64, H, C, O, 1.0, "silu")
             for H, C, O in dict.fromkeys(VGG16_SMALL_CONVS)]
    cases += [(1, 32, 16, 16, 1.0, "silu"), (8, 8, 32, 64, 3.0, "silu"),
              (8, 16, 16, 32, 3.0, "gelu")]
    # ragged edges of the tile: B not a multiple of the image group, O not
    # of the column tile, C not of the chunk, 1x1 and 3x3 planes (skipped
    # pad taps), and the 2x2 layer at the real batch (16 channel splits)
    cases += [(1023, 8, 32, 64, 1.0, "silu"), (64, 8, 16, 48, 1.0, "silu"),
              (64, 16, 5, 16, 1.0, "silu"), (256, 1, 16, 32, 1.0, "silu"),
              (64, 3, 6, 9, 3.0, "gelu"), (1024, 2, 128, 128, 1.0, "silu")]
    max_err = 0.0
    for B, H, C, O, scale, act in cases:
        x, bw, pw = conv_inputs(gen, B, H, C, O, scale)
        if scale > 1:  # exact knots and out-of-grid values occur
            flat = x.view(-1)
            flat[: 4 * len(knots)] = torch.tensor(knots).repeat(4)
        x, bw, pw = x.to(dev), bw.to(dev), pw.to(dev)
        basis = kc.bspline_basis(knots, 3, act)
        y = kc.kan_conv2d(x, bw, pw, basis, 3, 1)
        torch.cuda.synchronize()
        ref = kc.kan_conv2d_reference(x, bw, pw, basis, 3, 1)
        err = (y - ref).abs().max().item()
        ok = torch.allclose(y, ref, rtol=TOL, atol=TOL)
        cfg = kc.launch_config(B, H, H, C, O, 3, 1, basis.R)
        print(f"[kernel] B={B} {H}x{H} C={C} O={O} x*{scale} {act} "
              f"(BN {cfg['BN']}, {'skip' if cfg['skip'] else 'dense'}, CC "
              f"{cfg['CC']}, S {cfg['S']}, {cfg['blocks']} blocks): "
              f"max|err| {err:.3e} {'ok' if ok else 'FAIL'}", flush=True)
        check(bool(torch.isfinite(y).all()), "kernel output not finite")
        check(ok, f"kernel disagrees with the plain version (B={B} H={H} "
                  f"C={C} O={O} {act})")
        max_err = max(max_err, err)

    # ---------------------------------------------------------- 3. model
    imgs = np.random.RandomState(0).randint(0, 256, (64, 32, 32, 3), np.uint8)
    model_gpu, _ = phase_model(kc, "KAN", "kan_conv2d_fwd", dev, imgs)
    # ------------------------------------------- 4. serving (main path)
    n_main, _ = phase_serve(kc, "KAN", "kan_conv2d_fwd", imgs)

    # ---------------------------------------------------------- 5. times
    predict_ips = time_predict(model_gpu, "KAN", card)
    del model_gpu
    totals, shapes = phase_forward_times(kc, silu, SPAN_ROWS, gen, dev, card)

    # ------------------------------------ 6. backward kernels vs plain
    bwd_err = phase_backward(kc, knots, gen, dev)
    # ------------------------------------------ 7. training (main path)
    train_want = {"kan_conv2d_fwd": 13, "kan_conv2d_bwd_dx": 12,
                  "kan_conv2d_bwd_dw": 13, "kan_conv2d_bwd_dw_reduce": 13}
    train_counts, _ = phase_train(kc, dev, "KAN", train_want, ["poly_w"])
    # ---------------------------------------------- 8. training times
    ips, bwd, bwd_rows = phase_train_times(kc, silu, SPAN_ROWS, "KAN", gen,
                                           dev, card)
    step_ms = 1e3 * TIME_BATCH / ips
    kernel_ms = totals["ms"] + sum(t["ms"] for t in bwd.values())
    print(f"[time] train step {step_ms:.3f} ms at batch {TIME_BATCH}: KAN-conv "
          f"kernels {kernel_ms:.3f} ms (forward {totals['ms']:.3f}, backward "
          f"{kernel_ms - totals['ms']:.3f}; per-shape CUDA-event times x "
          f"layers), the rest {step_ms - kernel_ms:.3f} ms (on {card})",
          flush=True)

    lap("B-spline KAN")
    # ------------------------------------------------------------ WavKAN
    wav_fwd_err = phase_wav_forward(wc, gen, dev)                    # 9
    wav_bwd_err = phase_wav_backward(wc, gen, dev)                   # 10
    wav_model, _ = phase_model(wc, "WavKAN", "wav_conv2d_fwd", dev,  # 11
                               imgs, **WAV_MODEL)
    # the WavKAN model's float32 logits are worse conditioned than the KAN
    # model's: served logits are held to MODEL_TOL, as phase 11 holds them
    wav_serve, _ = phase_serve(wc, "WavKAN", "wav_conv2d_fwd", imgs,  # 12
                               tol=MODEL_TOL, **WAV_MODEL)
    wav_train, _ = phase_train(                                      # 13
        wc, dev, "WavKAN", {"wav_conv2d_fwd": 13, "wav_conv2d_bwd_dx": 12,
                            "wav_conv2d_bwd_param": 13,
                            "wav_conv2d_bwd_reduce": 13},
        ["wavelet_w", "scale", "translation"], lockstep=True, **WAV_MODEL)
    wav_predict_ips = time_predict(wav_model, "WavKAN", card)        # 14
    del wav_model
    wav_ips = time_train_step("WavKAN", dev, card, **WAV_MODEL)
    wav_totals, wav_rows = phase_wav_times(wc, gen, dev, card)
    wav_fwd_err = max(wav_fwd_err,
                      wav_totals["wav_conv2d_fwd"].pop("max_abs_err"))
    wav_step_ms = 1e3 * TIME_BATCH / wav_ips
    empty_ms = wav_totals.pop("empty_kernel_ms")
    wav_kernel_ms = sum(t["ms"] for t in wav_totals.values())
    print(f"[wav time] train step {wav_step_ms:.3f} ms at batch {TIME_BATCH}:"
          f" psi-conv kernels {wav_kernel_ms:.3f} ms (forward "
          f"{wav_totals['wav_conv2d_fwd']['ms']:.3f}), the rest "
          f"{wav_step_ms - wav_kernel_ms:.3f} ms; predict "
          f"{wav_predict_ips:.1f} images/s (on {card})", flush=True)

    lap("WavKAN")
    # ---------------------------------------------------------- ChebyKAN
    cheby = kc.cheby_basis(3)
    suffix = f"[{cheby.kind}{cheby.order}]"   # its entries' names end so
    cheby_err = phase_cheby_kernels(kc, gen, dev)                    # 15
    cheby_model, cheby_tol = phase_model(                            # 16
        kc, "ChebyKAN", "kan_conv2d_fwd", dev, imgs, f64=True, **CHEBY_MODEL)
    # served logits held to phase 16's tolerance: the engine's batches run
    # other tiles (other sums) than predict's, at the same float32 floor
    cheby_serve, _ = phase_serve(kc, "ChebyKAN", "kan_conv2d_fwd",   # 17
                                 imgs, tol=cheby_tol, **CHEBY_MODEL)
    cheby_train, _ = phase_train(kc, dev, "ChebyKAN", train_want,     # 18
                                 ["poly_w"], lockstep=True, **CHEBY_MODEL)
    cheby_predict_ips = time_predict(cheby_model, "ChebyKAN", card)   # 19
    del cheby_model
    cheby_fwd, cheby_shapes = phase_forward_times(
        kc, cheby, CHEBY_ROWS, gen, dev, card, tag="[cheby time]",
        suffix=suffix, batch1=True)
    cheby_ips, cheby_bwd, cheby_rows = phase_train_times(
        kc, cheby, CHEBY_ROWS, "ChebyKAN", gen, dev, card,
        tag="[cheby time]", suffix=suffix, **CHEBY_MODEL)
    cheby_step_ms = 1e3 * TIME_BATCH / cheby_ips
    cheby_kernel_ms = cheby_fwd["ms"] + sum(t["ms"]
                                            for t in cheby_bwd.values())
    print(f"[cheby time] train step {cheby_step_ms:.3f} ms at batch "
          f"{TIME_BATCH}: Chebyshev KAN-conv kernels {cheby_kernel_ms:.3f} ms "
          f"(forward {cheby_fwd['ms']:.3f}), the rest "
          f"{cheby_step_ms - cheby_kernel_ms:.3f} ms; predict "
          f"{cheby_predict_ips:.1f} images/s (on {card})", flush=True)

    lap("ChebyKAN")
    # ----------------------------------------------------------- GRAMKAN
    gram = kc.gram_basis(3)
    gsuffix = f"[{gram.kind}{gram.order}]"    # its entries' names end so
    gram_err = phase_gram_kernels(kc, gen, dev)                       # 20
    gram_model, _ = phase_model(kc, "GRAMKAN", "kan_conv2d_fwd", dev,  # 21
                                imgs)
    gram_serve, _ = phase_serve(kc, "GRAMKAN", "kan_conv2d_fwd",      # 22
                                imgs)
    # the first conv's data-gradient kernel runs for beta's gradient alone
    # (dx not stored); a reduction each for dW and d beta per conv
    gram_want = {"kan_conv2d_fwd": 13, "kan_conv2d_bwd_dx": 13,
                 "kan_conv2d_bwd_dw": 13, "kan_conv2d_bwd_dw_reduce": 26}
    gram_train, _ = phase_train(                                      # 23
        kc, dev, "GRAMKAN", gram_want, ["base_w", "poly_w", "beta_weights"],
        zero_entries=[("beta_weights", 0), ("beta_weights", 3)])
    gram_predict_ips = time_predict(gram_model, "GRAMKAN", card)      # 24
    del gram_model
    gram_fwd, gram_shapes = phase_forward_times(
        kc, gram, GRAM_ROWS, gen, dev, card, tag="[gram time]",
        suffix=gsuffix, batch1=True)
    gram_ips, gram_bwd, gram_rows = phase_train_times(
        kc, gram, GRAM_ROWS, "GRAMKAN", gen, dev, card, tag="[gram time]",
        suffix=gsuffix)
    gram_step_ms = 1e3 * TIME_BATCH / gram_ips
    gram_kernel_ms = gram_fwd["ms"] + sum(t["ms"] for t in gram_bwd.values())
    print(f"[gram time] train step {gram_step_ms:.3f} ms at batch "
          f"{TIME_BATCH}: Gram KAN-conv kernels {gram_kernel_ms:.3f} ms "
          f"(forward {gram_fwd['ms']:.3f}, dx and dbeta "
          f"{gram_bwd['kan_conv2d_bwd_dx']['ms']:.3f}, dW "
          f"{gram_bwd['kan_conv2d_bwd_dw']['ms']:.3f}, reductions "
          f"{gram_bwd['kan_conv2d_bwd_dw_reduce']['ms']:.3f}), the rest "
          f"{gram_step_ms - gram_kernel_ms:.3f} ms; predict "
          f"{gram_predict_ips:.1f} images/s (on {card})", flush=True)

    lap("GRAMKAN")
    # ------------------------------------- BatchNorm: path A (train.py)
    phase_bn_model(kc, dev, imgs)                                     # 25
    bn_train, bn_trained = phase_train(                               # 26
        kc, dev, "KAN", train_want, ["poly_w"], lockstep=True,
        f32_floor=True,
        label=f"VGG16_small BatchNorm2d batch {TRAIN_BATCH}", **PATH_A)
    bn_serve, bn_models = phase_bn_serve(kc, bn_trained, imgs)        # 27
    del bn_trained
    bn_predict = {fold: time_predict(
        m, "KAN BatchNorm2d" + (" folded" if fold else ""), card)
        for fold, m in bn_models.items()}
    del bn_models
    bn_ips = time_train_step("KAN", dev, card, label="KAN BatchNorm2d",
                             **PATH_A)
    print(f"[bn time] path A train step at batch {TIME_BATCH}: {bn_ips:.1f} "
          f"images/s with BatchNorm2d, {ips:.1f} with InstanceNorm (phase 8, "
          f"this run); predict {bn_predict[False]:.1f} images/s, folded "
          f"{bn_predict[True]:.1f} (on {card})", flush=True)

    lap("path A")
    # ----------------------------------- BASELINE config 4: path B
    c4_err = phase_config4_kernels(wc, gen, dev)                      # 28
    c4_want = {"wav_conv2d_fwd": 3, "wav_conv2d_bwd_dx": 2,
               "wav_conv2d_bwd_param": 3, "wav_conv2d_bwd_reduce": 3}
    c4_train, _ = phase_train(                                        # 29
        wc, dev, "WavKAN", c4_want, ["wavelet_w", "scale", "translation"],
        lockstep=True, n_convs=len(CONFIG4_CONVS),
        label=f"config-4 stack batch {CONFIG4_CHECK_BATCH}",
        build=config4_model, batches=config4_batches(CONFIG4_CHECK_BATCH),
        make_step=config4_step)
    c4_ips, c4_counts = time_config4_step(wc, dev, card)              # 30
    c4_totals, c4_rows = phase_wav_times(
        wc, gen, dev, card, convs=CONFIG4_CONVS, B=CONFIG4_BATCH,
        tag="[config4 time]", suffix=CONFIG4_SUFFIX)
    c4_err["wav_conv2d_fwd"] = max(
        c4_err["wav_conv2d_fwd"],
        c4_totals["wav_conv2d_fwd"].pop("max_abs_err"))
    c4_totals.pop("empty_kernel_ms")
    c4_kernel_ms = sum(t["ms"] for t in c4_totals.values())
    c4_step_ms = 1e3 * CONFIG4_BATCH / c4_ips
    print(f"[config4 time] train step {c4_step_ms:.3f} ms at batch "
          f"{CONFIG4_BATCH}: psi-conv kernels {c4_kernel_ms:.3f} ms (forward "
          f"{c4_totals['wav_conv2d_fwd']['ms']:.3f}), the rest "
          f"{c4_step_ms - c4_kernel_ms:.3f} ms (on {card})", flush=True)

    lap("path B")
    # ------------------------------ KAN-MobileNetV3-small: path C
    mnv3_err = phase_mnv3_kernels(kc, gen, dev)                      # 31
    phase_mnv3_model(kc, dev)                                        # 32
    mnv3_serve = {fam: phase_mnv3_serve(kc, fam)[0]                  # 33
                  for fam in ("FastKAN", "KAN")}
    mnv3_train = {fam: phase_mnv3_train(kc, dev, fam)                # 34
                  for fam in MNV3_FAMILIES}
    mnv3_time = {fam: time_mnv3(kc, fam, dev, card)                  # 35
                 for fam in MNV3_FAMILIES}
    mnv3_batch = min(t[0] for t in mnv3_time.values())
    mnv3_rows_nz = {"hardswish": SPAN_ROWS, "cheby3": CHEBY_ROWS}
    mnv3_k = {tag: phase_kernel_times(
        kc, f"[mnv3 time] {tag}", MNV3_SUFFIX[tag], basis, mnv3_rows_nz[tag],
        [(H, C, O, 1) for H, C, O in MNV3_CONVS], gen, dev, card, mnv3_batch,
        iters=(10, 2))
        for tag, basis in mnv3_bases(kc).items()}
    for fam, tag in (("KAN", "hardswish"), ("ChebyKAN", "cheby3")):
        B, ips, _, _, parts = mnv3_time[fam]
        t = mnv3_k[tag][0]
        step_ms = 1e3 * B / ips
        k_ms = sum(v["ms"] for v in t.values())
        print(f"[mnv3 time] {fam} train step {step_ms:.3f} ms at batch {B}: "
              f"KAN-conv kernels {k_ms:.3f} ms (forward "
              f"{t['kan_conv2d_fwd']['ms']:.3f}, dx "
              f"{t['kan_conv2d_bwd_dx']['ms']:.3f}, dW "
              f"{t['kan_conv2d_bwd_dw']['ms']:.3f}, reductions "
              f"{t['kan_conv2d_bwd_dw_reduce']['ms']:.3f}; per-shape device "
              f"times x layers at batch {mnv3_batch}), the rest "
              f"{step_ms - k_ms:.3f} ms, of it the stem "
              f"{parts['stem_ms']:.3f} and imagenet_batch "
              f"{parts['prep_ms']:.3f} (on {card})", flush=True)

    lap("path C")
    # ----------------------------- KAN-EfficientNetV2-s: path D
    # the launches of each main-path run by basis (kc.launches_by_basis)
    effv2_err = phase_effv2_kernels(kc, gen, dev)                    # 36
    effv2_runs = {"model": phase_effv2_model(kc, dev)}               # 37
    effv2_runs["serve"] = sum(                                       # 38
        (collections.Counter(serve_224(
            kc, fam, "EfficientNetV2KAN", "s", effv2_eval_model,
            effv2_want(fam), "[effv2 serve]")[1])
         for fam in ("FastKAN", "KAN")), collections.Counter())
    effv2_runs["train"] = phase_effv2_train(kc, dev)                 # 39
    effv2_runs["remat_compare"] = effv2_remat_compare(kc, dev)
    effv2_time = {(fam, remat): time_effv2(kc, fam, dev, card,       # 40
                                           remat=remat, predict=remat)
                  for fam in ("FastKAN", "KAN") for remat in (True, False)}
    effv2_batch = min(t[0] for t in effv2_time.values())
    effv2_runs[f"train_batch{effv2_time[('KAN', True)][0]}"] = sum(
        (collections.Counter(t[4]) for t in effv2_time.values()),
        collections.Counter())
    effv2_rows_nz = {"identity": SPAN_ROWS, "gram_identity": GRAM_ROWS,
                     "silu": SPAN_ROWS}
    effv2_k = {tag: phase_kernel_times(
        kc, f"[effv2 time] {tag}", EFFV2_SUFFIX[tag], basis,
        effv2_rows_nz[tag], effv2_convs(tag), gen, dev, card, effv2_batch)
        for tag, basis in effv2_bases(kc).items()}
    effv2_summary(kc, effv2_k, effv2_time, effv2_batch, card)

    lap("path D")
    # ------------------ KAN-VGG16_small with the static bases: path E
    # the launches of each main-path run by basis (kc.launches_by_basis)
    static_err = phase_static_kernels(kc, gen, dev)                  # 41
    static_runs = collections.defaultdict(collections.Counter)
    imgs1024 = np.random.RandomState(5).randint(
        0, 256, (TIME_BATCH, 32, 32, 3), np.uint8)
    static_predict, static_tol = {}, {}
    for key in (*STATIC_FAMILIES, "LegendreKAN"):                    # 42
        model_gpu, by_basis, static_tol[key] = phase_static_model(
            kc, key, dev, imgs1024)
        static_runs["model"] += by_basis
        static_predict[key] = time_predict(model_gpu, key, card)
        del model_gpu
    for key in STATIC_FAMILIES:                                      # 43
        # served logits held to phase 42's tolerance: the engine's batches
        # run other tiles (other sums) than predict's, and FourierKAN's
        # seeded float32 trunk amplifies that rounding (STATIC_CURVE)
        n_serve, _ = phase_serve(kc, key, "kan_conv2d_fwd", imgs,
                                 tol=static_tol[key])
        keys = {k for _, k in kc.launches_by_basis}
        check(keys == {static_basis(key).key},
              f"{key}: serving launched the bases {keys}")
        static_runs["serve"][("kan_conv2d_fwd",
                              static_basis(key).key)] += n_serve
    for key in (*STATIC_FAMILIES, "LegendreKAN"):                    # 44
        static_runs["train"] += static_train(kc, dev, key)
    static_ips = {key: time_train_step(key, dev, card)               # 45
                  for key in STATIC_FAMILIES}
    static_k = {tag: phase_kernel_times(
        kc, f"[static time] {tag}", f"[static {tag}]",
        static_basis(key), static_basis(key).R,
        [(H, C, O, 3) for H, C, O in VGG16_SMALL_CONVS], gen, dev, card,
        TIME_BATCH) for tag, key in STATIC_TIMED.items()}
    for tag, key in STATIC_TIMED.items():
        t = static_k[tag][0]
        step_ms = 1e3 * TIME_BATCH / static_ips[key]
        k_ms = sum(v["ms"] for v in t.values())
        print(f"[static time] {key} train step {step_ms:.3f} ms at batch "
              f"{TIME_BATCH}: KAN-conv kernels ({tag}) {k_ms:.3f} ms "
              f"(forward {t['kan_conv2d_fwd']['ms']:.3f}, dx "
              f"{t['kan_conv2d_bwd_dx']['ms']:.3f}, dW "
              f"{t['kan_conv2d_bwd_dw']['ms']:.3f}, reductions "
              f"{t['kan_conv2d_bwd_dw_reduce']['ms']:.3f}), the rest "
              f"{step_ms - k_ms:.3f} ms; predict {static_predict[key]:.1f} "
              f"images/s (on {card})", flush=True)
    lap("path E")
    print(f"[time] total {time.perf_counter() - t_start:.1f} s", flush=True)

    def kan_entries(suffix, fwd, shapes_, fwd_err, n_serve, counts, bwd_,
                    rows_, bwd_err_, predict, fwd_extra):
        """The four KAN-conv kernels' entries of one basis."""
        entries = [kernel_entry(
            "kan_conv2d_fwd" + suffix, "convkan_tpu_torch/csrc/" + kc.SOURCE,
            REPLACES, {"serve": n_serve, "train": counts["kan_conv2d_fwd"]},
            fwd_err, fwd, "sum over the 13 VGG16_small convs at batch 1024",
            shapes_, also_replaces=ALSO_REPLACES,
            dense_bound_ms=round(fwd["dense_bound_ms"], 4),
            predict_images_per_s=round(predict, 1), **fwd_extra)]
        # the reduction's kernel lives in csrc/ordered_sum.cuh, built into
        # the backward source's library behind its C entry
        red = "kan_conv2d_bwd_dw_reduce"
        entries += [kernel_entry(
            name + suffix, RED_SOURCE if name == red
            else "convkan_tpu_torch/csrc/" + kc.BWD_SOURCE, BWD_REPLACES,
            {"serve": 0, "train": counts[name]}, bwd_err_[name], t,
            f"sum over the VGG16_small convs of one train step at batch "
            f"{TIME_BATCH}",
            [{k: r[k] for k in ("H", "C", "O", "S")} | r[name]
             for r in rows_],
            **{key: round(t[key], 4) for key in ("dense_bound_ms",
                                                 "warm_l2_ms",
                                                 "library_warm_l2_ms")
               if key in t},
            **({"entry_source": "convkan_tpu_torch/csrc/" + kc.BWD_SOURCE}
               if name == red else {}))
            for name, t in bwd_.items()]
        return entries

    kernels = kan_entries("", totals, shapes, max_err, n_main, train_counts,
                          bwd, bwd_rows, bwd_err, predict_ips, {})
    for entry in kernels:   # path A runs the same B-spline kernels
        name = entry["name"]
        entry["launches_by_path"].update(
            bn_serve=bn_serve[False] if name == "kan_conv2d_fwd" else 0,
            bn_serve_folded=bn_serve[True] if name == "kan_conv2d_fwd" else 0,
            bn_train=bn_train[name])
        entry["launches"] = sum(entry["launches_by_path"].values())
        if name == "kan_conv2d_fwd":
            entry["bn_predict_images_per_s"] = round(bn_predict[False], 1)
            entry["bn_folded_predict_images_per_s"] = round(
                bn_predict[True], 1)
        entry["bn_train_images_per_s"] = round(bn_ips, 1)
    red_names = ("kan_conv2d_bwd_dw_reduce", "wav_conv2d_bwd_reduce")
    for name in wc.KERNELS:
        fwd = name == "wav_conv2d_fwd"
        src = "convkan_tpu_torch/csrc/" + (wc.SOURCE if fwd else
                                            wc.BWD_SOURCE)
        extra = {"entry_source": src, "empty_kernel_ms_x13": round(
            13 * empty_ms, 4), **{key: round(wav_totals[name][key], 4) for key
                                  in ("warm_l2_ms", "library_warm_l2_ms")}} \
            if name in red_names else {}
        if fwd:
            extra = {"batch1_ms": round(wav_totals[name]["batch1_ms"], 4)}
        kernels.append(kernel_entry(
            name, RED_SOURCE if name in red_names else src,
            WAV_REPLACES if fwd else WAV_BWD_REPLACES,
            {"serve": wav_serve if fwd else 0, "train": wav_train[name]},
            wav_fwd_err if fwd else wav_bwd_err[name], wav_totals[name],
            f"sum over the 13 WavKAN VGG16_small convs of one "
            f"{'forward' if fwd else 'train step'} at batch {TIME_BATCH}",
            [{k: r[k] for k in ("H", "C", "O", "S")} | r[name]
             for r in wav_rows], **extra))
    for name in wc.KERNELS:   # config 4's shapes (path B)
        fwd = name == "wav_conv2d_fwd"
        src = "convkan_tpu_torch/csrc/" + (wc.SOURCE if fwd else
                                            wc.BWD_SOURCE)
        extra = {"entry_source": src} if name in red_names else {}
        kernels.append(kernel_entry(
            name + CONFIG4_SUFFIX, RED_SOURCE if name in red_names else src,
            WAV_REPLACES if fwd else WAV_BWD_REPLACES,
            {"serve": 0, "train": c4_train[name],
             "train_batch2048": c4_counts[name]},
            c4_err[name], c4_totals[name],
            f"sum over config 4's 3 WavKAN convs of one "
            f"{'forward' if fwd else 'train step'} at batch {CONFIG4_BATCH}",
            [{k: r[k] for k in ("H", "C", "O", "S")} | r[name]
             for r in c4_rows], train_images_per_s=round(c4_ips, 1),
            **extra))
    kernels += kan_entries(
        suffix, cheby_fwd, cheby_shapes, cheby_err["kan_conv2d_fwd"],
        cheby_serve, cheby_train, cheby_bwd, cheby_rows, cheby_err,
        cheby_predict_ips,
        {"batch1_ms": round(cheby_fwd["batch1_ms"], 4),
         "train_images_per_s": round(cheby_ips, 1)})
    gram_entries = kan_entries(
        gsuffix, gram_fwd, gram_shapes, gram_err["kan_conv2d_fwd"],
        gram_serve, gram_train, gram_bwd, gram_rows, gram_err,
        gram_predict_ips,
        {"batch1_ms": round(gram_fwd["batch1_ms"], 4),
         "train_images_per_s": round(gram_ips, 1)})
    for entry in gram_entries:  # beta's gradient: the data-gradient kernel
        if entry["name"] == "kan_conv2d_bwd_dx" + gsuffix:
            entry["dbeta_err_over_sum_abs_terms"] = gram_err["dbeta_rel"]
    kernels += gram_entries
    for tag, fam in (("hardswish", "KAN"), ("cheby3", "ChebyKAN")):
        totals_c, rows_c = mnv3_k[tag]
        B, ips, pips, timed, _ = mnv3_time[fam]
        for name in kc.KERNELS:
            fwd = name == "kan_conv2d_fwd"
            src = "convkan_tpu_torch/csrc/" + (kc.SOURCE if fwd else
                                                kc.BWD_SOURCE)
            red = name == "kan_conv2d_bwd_dw_reduce"
            kernels.append(kernel_entry(
                name + MNV3_SUFFIX[tag], RED_SOURCE if red else src,
                REPLACES if fwd else BWD_REPLACES,
                {"serve": mnv3_serve.get(fam, 0) if fwd else 0,
                 "train": mnv3_train[fam][name],
                 f"train_batch{B}": timed[name]},
                mnv3_err[tag][name], totals_c[name],
                f"sum over MobileNetV3-small's 22 1x1 convs of one train "
                f"step at batch {mnv3_batch}",
                [{k: r[k] for k in ("H", "C", "O", "S")} | r[name]
                 for r in rows_c], train_images_per_s=round(ips, 1),
                predict_images_per_s=round(pips, 1),
                **({"also_replaces": ALSO_REPLACES} if fwd else {}),
                **({"entry_source": src} if red else {})))
    # path D's launches per basis, as its runs counted them
    for tag, basis in effv2_bases(kc).items():
        totals_d, rows_d = effv2_k[tag]
        for name in kc.KERNELS:
            fwd = name == "kan_conv2d_fwd"
            src = "convkan_tpu_torch/csrc/" + (kc.SOURCE if fwd else
                                                kc.BWD_SOURCE)
            red = name == "kan_conv2d_bwd_dw_reduce"
            launches = {path: c[(name, basis.key)]
                        for path, c in effv2_runs.items()}
            check(sum(launches.values()) > 0,
                  f"{name}{EFFV2_SUFFIX[tag]} ran on no main path")
            kernels.append(kernel_entry(
                name + EFFV2_SUFFIX[tag], RED_SOURCE if red else src,
                REPLACES if fwd else BWD_REPLACES, launches,
                effv2_err[tag][name], totals_d[name],
                f"sum over EfficientNetV2-s's "
                f"{sum(r['layers'] for r in rows_d)} convs of this basis in "
                f"one train step at batch {effv2_batch}",
                [{k: r[k] for k in ("H", "C", "O", "k", "S")} | r[name]
                 for r in rows_d],
                **({"train_images_per_s": {
                    f"{f} remat={r}": round(t[1], 1)
                    for (f, r), t in effv2_time.items()},
                    "predict_images_per_s": {
                        f: round(effv2_time[(f, True)][2], 1)
                        for f in ("FastKAN", "KAN")},
                    "peak_gib": {f"{f} remat={r}": round(t[5], 2)
                                 for (f, r), t in effv2_time.items()},
                    "also_replaces": ALSO_REPLACES} if fwd else {}),
                **({"entry_source": src} if red else {})))
    # path E's five instantiations, each of the families that run it
    for tag, timed in STATIC_TIMED.items():
        totals_e, rows_e = static_k[tag]
        fams = [k for k in STATIC_FAMILIES if static_tag(kc, k) == tag]
        keys = {static_basis(k).key for k in fams}
        for name in kc.KERNELS:
            fwd = name == "kan_conv2d_fwd"
            src = "convkan_tpu_torch/csrc/" + (kc.SOURCE if fwd else
                                                kc.BWD_SOURCE)
            red = name == "kan_conv2d_bwd_dw_reduce"
            launches = {path: sum(c[(name, k)] for k in keys)
                        for path, c in static_runs.items()}
            check(sum(launches.values()) > 0,
                  f"{name}[static {tag}] ran on no main path")
            kernels.append(kernel_entry(
                name + f"[static {tag}]", RED_SOURCE if red else src,
                REPLACES if fwd else BWD_REPLACES, launches,
                static_err[tag][name], totals_e[name],
                f"sum over the 13 {timed} VGG16_small convs of one "
                f"{'forward' if fwd else 'train step'} at batch "
                f"{TIME_BATCH}",
                [{k: r[k] for k in ("H", "C", "O", "S")} | r[name]
                 for r in rows_e], families=fams, timed_with=timed,
                train_images_per_s={k: round(static_ips[k], 1)
                                    for k in fams},
                **({"predict_images_per_s": {
                    k: round(static_predict[k], 1) for k in fams},
                    "also_replaces": ALSO_REPLACES} if fwd else {}),
                **({"entry_source": src} if red else {})))
    # path D's GRAMKAN models also ran the Gram SiLU instantiation (their
    # convs other than the projections)
    for entry in gram_entries:
        name = entry["name"][:-len(gsuffix)]
        entry["launches_by_path"].update({
            f"effv2_{path}": c[(name, gram.key)]
            for path, c in effv2_runs.items() if c[(name, gram.key)]})
        entry["launches"] = sum(entry["launches_by_path"].values())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
