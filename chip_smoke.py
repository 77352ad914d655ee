#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

    python3 chip_smoke.py

Phases, a few lines each (any failure raises, exits non-zero and prints no
result line):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the CUDA kernels from `mp_former_tpu_torch/csrc/` with nvcc;
3. K1 (deformable sampling) against its plain version and against the plain
   function that does the kernel's folded arithmetic, at the slice's shapes,
   float32 and bfloat16, with locations outside the map;
4. K3 (masked cross-attention) against its plain version at the decoder's
   three key lengths, with the ResNet recipes' 100 queries and the Swin-L
   recipes' 200 (13 tiles of 16 rows, two blocks a (batch, head)), float32
   and bfloat16, on the strided head views the decoder hands it and on
   contiguous copies, with masks shared by the heads and per head, fully
   masked rows, a batch of two, and against the plain function that repeats
   the kernel's tiles and 3xTF32 products; in float32 also on values sharing
   an offset with the weights spread over 16384 keys (the Swin-L step's
   features), within 1e-5 of that function;
4a. `test_canvases`: K1 and K3 at the test canvases of the Cityscapes
   (1024x2048: K1 on 43008 queries, K3 on 32768 keys) and Mapillary Vistas
   (1536x2048: 64512 and 49152) recipes, float32 and bfloat16, against their
   plain versions at phase K1's and K3's limits times the plain output's
   largest entry where that is below 1, timed beside the bound and SDPA;
4b. `video_canvases` (slice 6, A20a): K3 at 100 and 200 queries over the
   keys of a 36-frame clip's three levels (a 720x1280 video at the YouTube-VIS
   recipes' MIN_SIZE_TEST 360 is a 384x640 canvas: S = 8640, 34560 and
   138240, mask shared by the heads) and K1 on the clip's batch of 36 frames
   of 5040 queries, float32 and bfloat16, held and timed as in 4a;
5. K2 (tap weighting) against its plain version at both call shapes of the
   800x1088 canvas, float32 and bfloat16, and at a ragged small shape;
6. the row-gather kernels against their plain versions at the shapes of
   `tools/probe_torch_row_gather.py`, then that tool's own run, counted;
7. slice 1: the released R50 COCO instance recipe at full width with
   seeded random weights serves 4 requests through `Predictor`; checks the
   outputs, that every request launched K1 6 times and K3 9 times, and that
   the kernel forward agrees with the same model run through the plain ops;
8. slice 2: the TPU recipe (head-shared sampling, tap weighting; float32)
   serves the same 4 requests: K2 18 launches per request, K3 9, K1 none;
   the kernel forward against the plain ops;
9. the per-head engine through the patch-table gather and K2
   (`TPU.PALLAS_TAP_WEIGHTING True`) with slice 1's weights: one request, K2
   18 launches, K1 none; its outputs against slice 1's K1 route;
10. evaluation: `inference_on_dataset` over 8 in-memory records on the
    slice-2 model, segm AP through the kernels and through the plain ops;
10a. `TPU.COMPUTE_DTYPE bfloat16` (the JAX package's AMP-equivalent mode):
    `slice_bf16`, slice 1's model and requests in bfloat16 (K1 6 and K3 9
    launches a request), and `slice2_bf16`, the TPU recipe as its YAML says
    (K2 18, K3 9): every launch in bfloat16 (K1 on a bfloat16 value with
    float32 locations and weights), and on every request the bfloat16 forward
    through the kernels no further from the float32 forward through the plain
    ops than 1.5 x the bfloat16 plain forward's distance + 1e-3 (logits and
    masks, relative to the float32 output's largest entry); device busy ms
    per request in float32 and bfloat16; `eval_bf16`, the 8 records through
    the bfloat16 TPU recipe, segm AP through the kernels within 0.5 of AP
    through the plain ops, the float32 AP beside them;
10b. `slice_swin`, `slice_swin_bf16` (slice 5, A17): the Swin-L COCO
    instance recipe at full width (embed 192, depths 2-2-18-2, heads
    6-12-24-48, window 12, 200 queries, the MSDeformAttn pixel decoder over
    384 / 768 / 1536 channels, the vanilla decoder; seeded weights) serves
    the same 4 requests as phase 7 (K1 6 and K3 9 launches a request, the
    kernel forward against the plain ops), then in bfloat16 as phase 10a;
    the device busy ms, the backbone's device span (`stage::backbone`) and
    the peak memory of a warm request in both types;
10c. slice 6 (A20a), video serving: three synthetic videos of 720x1280 (2,
    5 and 36 frames, `.npy`, written by `tools/make_synthetic_ytvis_torch.py`
    under `output/chip_smoke_ytvis/`); `slice_video`: the R50 YouTube-VIS
    2019 recipe at full width (40 classes, 100 queries, seeded weights) serves
    each clip whole (`prep_clip`, the forward, `inference_video`): K1 6 and
    K3 9 launches a clip, the top-10 tubes at 720x1280; a clip's host ms,
    device busy ms and peak memory; the kernel forward against the plain ops
    given the kernel path's attention decisions (`paired_outputs`);
    `slice_video_bf16`: the same in `TPU.COMPUTE_DTYPE bfloat16` (every launch
    in bfloat16, held as in 10a); `eval_ytvis`: 4 clips of 360x640 (2, 3, 5
    and 8 frames) whose ground truth is rewritten from the seeded model's own
    first tubes through the plain ops, scored by
    `mp_former_tpu_torch.train_net_video.main --eval-only` (K1 6 and K3 9
    launches a clip): tube AP through the kernels within 0.5 of tube AP
    through the plain ops; `slice_video_swin`: the Swin-L YouTube-VIS 2019
    recipe (200 queries, MIN_SIZE_TEST 480: a 480x864 canvas, K3 over up to
    233280 keys) serves the 36-frame clip as `slice_video` does;
11. K1's backward kernel against `ms_deform_attn_backward_plain` and against
    autograd of the plain forward, at the 800x1088 canvas, at the training
    shape (B = 8, 512x512) and at the released batch's (B = 16, 1024x1024),
    model-like locations with some off the map, float32, bfloat16, and a
    bfloat16 value with float32 locations and weights (what a bfloat16 model
    hands them); the forward kernel at the same shapes against its plain
    version, timed beside its bound;
12. K3's backward kernel against `masked_attention_backward_plain`, against
    autograd of the plain forward and against the plain function that repeats
    its tiled arithmetic, at the training shapes (B = 8, Q = 120, S = 256 /
    1024 / 4096), at B = 1, Q = 100, S = 13600, and with the Swin-L recipes'
    200 queries at B = 1, S = 850 / 3400 / 13600 and at their training
    batch's largest level (B = 16, S = 16384): per-head masks with a DN
    block, a fully blocked row, strided views; two calls give equal bits; the
    forward that writes the row statistics against the plain version, its
    output, the statistics and the float32 output the backward takes delta
    from; in bfloat16 also where delta matters most (weights spread over 4096
    keys, dO orthogonal to O): each gradient no further from the float32
    plain backward than autograd of the plain bfloat16 forward;
12a. K2's backward kernel (`K2_bwd`) against `weight_taps_backward_plain` at
    both call shapes of a training step of the TPU recipe (B = 8, 512x512,
    5376 queries: head-shared rows, M = 8, and the per-head patch tables, B * M
    = 64), float32 and bfloat16, bitwise reproducible, timed beside its bound,
    its plain version and the two PyTorch calls that compute the same
    function, with K2's forward at those shapes; then the per-head
    patch-table route's gradients (K2 and its backward) against the K1
    route's at the training shape;
13. slice 3, training: the released training recipe (DN `points`, NUM_DN 1,
    noise 0, ALL_LY_DN, label noise 0.2) at full width and depth, B = 8 images
    of 512x512 from the seeded generator: step 0's losses and gradients through
    the kernels against the same step through autograd of the plain ops, then
    1 warm and 3 timed steps through `Trainer`; checks the 61 loss keys, the
    launches per step (K1 12, K1 backward 6, K3 9, K3 backward 9, K2 0) and
    that the parameters moved;
13a. `train_bf16`: the same in bfloat16: step 0 through the kernels against
    autograd of the plain ops, both bfloat16 (losses within 2e-2 relative;
    the gradient of every parameter whose float32 gradient is clear of
    rounding noise at a cosine of at least 0.99), every launch in bfloat16,
    then 4 steps through `Trainer` (K1 12, K1 backward 6, K3 9, K3 backward 9
    a step) with float32 parameters, gradients and AdamW state; s/step and
    peak memory beside the float32 phase's;
13b. `train_tpu`: the TPU recipe (head-shared sampling through K2, DN
    `points` as phase 13) trains, first in float32 as phase 13 (step 0
    against the plain ops at its tolerances, 4 steps through `Trainer`), then
    as its YAML says in bfloat16 (`train_tpu_bf16`, by phase 13a's rules):
    K2 36, K2 backward 18, K3 9, K3 backward 9, K1 none a step; s/step, device
    busy ms a step and peak memory in both types;
14. slice 3, a training run that scores itself (`train_coco`): a seeded
    COCO-format dataset written to `output/chip_smoke_coco/` by
    `tools/make_synthetic_coco_torch.py` (64 train images of 640x640, 8 val
    images of 480x480, 20 classes, `.npy` images, polygon ground truth with
    some uncompressed-RLE and crowd annotations), registered as
    `coco_2017_train` / `coco_2017_val`; `Trainer(cfg)` with no loader passed
    trains the released recipe (B = 8, LSJ at 512x512, 100 target slots,
    ground truth at 1/4 of the canvas) for 12 steps from
    `build_train_loader`, and `Trainer.test` evaluates the 8 val images after
    steps 6 and 12; checks the launches (per step K1 12, K1 backward 6, K3 9,
    K3 backward 9, K2 0; per evaluated image K1 6, K3 9), the 61 finite loss
    keys and `data_time` of the `metrics.json` lines, two finite segm APs and
    at most 3 checkpoints on disk; prints s/step, data time, the batch copy
    pinned against pageable and the evaluation's s/image;
15. `accum`: `TPU.GRAD_ACCUM_STEPS 2` on phase 13's recipe, batch and
    weights, step 0 (two micro-batches through `engine/train_step.py`)
    against the plain ops at phase 13's tolerances, launches K1 24, K1
    backward 12, K3 and K3 backward 18; then the same batch with accum 1 and
    2, nothing drawn and equal no-object weight in the micro-batches: every
    loss term within 1e-4;
16. `remat`: `TPU.REMAT_ENCODER` on against off, step 0 of phase 13: model
    outputs bitwise equal, losses within 1e-6, gradients within 1e-5 of each
    parameter's largest entry, K1 12 against 6 launches; peak memory and
    device busy ms of a step in both; then in bfloat16 with `TPU.REMAT_POLICY
    dots`, every launch bfloat16: the gradients with remat on against off,
    beside two runs without remat (the spread) and a recompute made wrong by
    one bfloat16 step (the control), as the card chooses cuDNN's algorithms
    and with them fixed; remat within REMAT_GRAD_TOL of each parameter's
    largest entry and REMAT_L2_TOL in the L2 norm of all gradients, the
    control beyond them;
17. `train_tpu_bs16`: the TPU recipe as its YAML says (bfloat16, head-shared
    sampling, remat) at 16 images of 1024x1024: 2 steps, K2 36 and K2
    backward 18 launches a step, s/step and peak memory; the first step
    keeps one launch of every kernel at each of its shapes, held against
    the plain versions (K2 on taps of 16 x 86016 x 1024, K3 up to 16384
    keys);
18. `train_net_accum2`, `train_net_accum1`: the released recipe launched as
    its users launch it, `mp_former_tpu_torch.train_net.main` with the
    overrides of run_50ep_no_noise_all_ly.sh, at its own batch (16 images,
    LSJ at 1024) from phase 14's dataset, `TPU.GRAD_ACCUM_STEPS` 2 and then
    1 (the monolithic step fits on 80 GB): 3 steps (K1 6 (1 + remat) accum,
    K1 backward 6 accum, K3 and K3 backward 9 accum launches a step), the
    second step's launches held against the plain versions at their own
    shapes as in phase 17, then `--eval-only --resume` on 4 val images (K1
    6, K3 9 an image); s/step, device busy ms of the last step, peak memory,
    data_time and segm AP;
19. `eval_panoptic` (slice 4, A16a): the COCO panoptic recipe at full width
    (133 classes, 100 queries, 9 decoder layers, seeded weights) over phase
    14's 8 val images, written again as a COCO panoptic dataset whose ground
    truth is the model's own predictions through the plain ops
    (OBJECT_MASK_THRESHOLD 0.0, OVERLAP_THRESHOLD 0.3, as
    tests/test_e2e_pq_miou_oracle.py; fails if the plain ops make no
    segment or no thing segment); `run_evaluation` through the kernels
    (instance, semantic and panoptic post-processing from one forward; K1 6
    and K3 9 launches an image) scores PQ and mIoU of at least 98, AP beside
    them; the seconds an image of the forward, each task's post-processing
    and each evaluator;
20. `train_panoptic`: the panoptic launcher as its users launch it,
    `train_net.main` with the overrides of
    run_50ep_no_noise_all_ly_panoptic.sh at its own batch (16 images, LSJ at
    1024, `coco_panoptic_lsj`) from the panoptic split of phase 14's dataset,
    as phase 18 (3 steps, the launches a step, the second step's held against
    the plain versions), then `--eval-only --resume` on 4 images of
    `coco_2017_val_panoptic_with_sem_seg` at the recipe's thresholds: finite
    PQ, mIoU and AP;
21. `write_segm` (slice 4, A16b): ADE20K (16 + 4 images of 512x683),
    Cityscapes (8 + 4 of 1024x2048) and Mapillary Vistas (8 + 4 of
    1536x2048) in their own layouts, `.npy` files, written by
    `tools/make_synthetic_segm_torch.py` under `output/chip_smoke_segm/`
    ($DETECTRON2_DATASETS of the whole run, so the builtin names read them);
22. `eval_cityscapes`: the Cityscapes panoptic recipe at full width (19
    classes, the vanilla decoder, the three TEST switches, seeded weights)
    over the 4 val images, their ground truth (labelTrainIds, labelIds,
    panoptic ids and json, instanceIds) rewritten from the model's own
    plain-op predictions under `output/chip_smoke_cityscapes_oracle/`;
    the weights' shared means taken out and each query's mask cut to the
    few pixels where it stands out (`part_queries`), so that the queries
    part the image (at least 20 segments and 5 instances of 3 thing
    classes); `run_evaluation` through the kernels (K1 6
    and K3 9 launches an image): PQ, the Cityscapes IoU and the Cityscapes
    AP at least 98; the seconds an image of each part;
23. `train_ade20k_sem`, `train_cityscapes_inst`, `train_mapillary_pan`: the
    ADE20K semantic, Cityscapes instance and Mapillary Vistas panoptic
    recipes through `train_net.main` as their YAML says (16 crops of
    512x512 through `mask_former_semantic`, of 512x1024 through
    `mask_former_instance` with the polygons of `_gtFine_polygons.json`, of
    1024x1024 through `mask_former_panoptic`; colour augmentation,
    WarmupPolyLR), as phase 18 (3 steps, the launches, the second step's held
    against the plain versions), then `--eval-only --resume` on 4 val images
    at the recipe's test size: finite mIoU; AP; PQ (the recipe's
    `mapillary_vistas_panoptic_val` has no semantic ground truth and the
    recipe switches instance inference off);
24. `swin_step` (slice 5, A17): step 0 of the Swin-L recipe on 2 generated
    images of 1024x1024 through the kernels against autograd of the plain
    ops at phase 13's tolerances, every backbone parameter's gradient among
    them; then `train_swin` and `train_swin_accum4`: the Swin-L recipe
    through `train_net.main` as phase 18 at its own batch (16 images, LSJ at
    1024, float32) from phase 14's dataset, once with each block recomputed
    in the backward (`MODEL.SWIN.USE_CHECKPOINT True`) and once in 4
    micro-batches (`TPU.GRAD_ACCUM_STEPS 4`), the two ways it fits on the
    card: 5 steps each (the second's launches held against the plain
    versions, the third and fourth timed, the last profiled: device busy ms
    and the port's kernels' share), the peak memory of both and which has
    the lower s/step, the launches a step (K1 12, K1 backward 6, K3 and K3
    backward 9 a micro-batch), and `--eval-only --resume` on 4 val images;
25. `video_train_canvases` (slice 6, A20b, video training): K1 and K1's
    backward on the 32 frames of the YouTube-VIS recipes' training batch (16
    clips of 2 frames on the clip mapper's static 480x1344 canvas: 13230
    queries a frame), K3 and K3's backward at B = 16 with 100 and 200 queries
    over the keys of both frames of a level (S = 1260, 5040, 20160), the
    mask shared by the heads; float32 and bfloat16, against the plain
    versions, timed beside the bound and SDPA's forward and backward;
26. `video_step`: the R50 YouTube-VIS 2019 recipe at full width (seeded
    weights), step 0 on 2 clips of 2 frames of a synthetic train split of
    720x1280 videos (`tools/make_synthetic_ytvis_torch.py --split train`,
    beside `eval_ytvis`'s clips) through `YTVISDatasetMapper` and
    `collate_clips`, through the kernels against the plain ops given the
    kernel path's attention and ReLU decisions, as phase 24 (K1 12, K1
    backward 6, K3 and K3 backward 9 launches);
27. `train_video`, `train_video_bf16`, `train_video_swin`: the R50 recipe
    as its YAML says, in float32 and in `TPU.COMPUTE_DTYPE bfloat16` (what the
    recipe's `SOLVER.AMP.ENABLED` means in the JAX package), and the Swin-L
    recipe (200 queries, `MODEL.SWIN.USE_CHECKPOINT True`), through
    `train_net_video.main` at their own batch from that split, as phase 18
    (3 steps, the second's launches held against the plain versions, the
    last profiled: s/step, device busy ms, peak memory, data_time), then
    `--eval-only --resume` on `eval_ytvis`'s 4 clips: finite tube AP;
28. A18, after `remat`: `train_variants`, the LYSmooth decoder
    (LAST_Q_RATIO 0.5) with pre-norm layers and DROPOUT 0.1 (the deformable
    encoder's) in training mode under TPU.REMAT_ENCODER, at phase 13's batch:
    step 0 against the plain ops given the kernel path's attention and ReLU
    decisions (the dropout masks from the same generator seeded anew), then
    against the same step with remat off (outputs bitwise equal, gradients
    within 1e-5); `train_dn_modes`: the DN modes at phase 13's batch with
    NUM_DN 5 over 20 slots (100 DN rows before the 100 learnable queries),
    noise 0.2, ALL_LY_DN, label noise 0.2, for `points` with HEAD_DN,
    `shift`, `scale`, `shift_scale`, `patch`, `points_MAE`, `base`, `lb`,
    `mask`, and `mask` with HEAD_DN, each on a model built from its config
    at the seeded init: step 0 against the plain ops as in `train_variants`
    (K1 12, K1 backward 6, K3 and K3 backward 9 launches), 3 steps through
    `Trainer` (device busy ms of a step, peak memory); the step 0 launches of
    `points` and `mask` with HEAD_DN, `patch` and `points_MAE` held against
    the plain versions on their own inputs (K3 at 200 queries, K3's backward
    against float64 beside the float32 plain backward's distance), then K3 and its
    backward at that shape (B = 8, 200 queries, S = 256 / 1024 / 4096, a
    per-head 100-row DN block), timed beside the bound, the plain versions
    and SDPA;
29. `train_net_dn_default`, after `train_net_accum1`: the DN_query recipe
    with the decoder `eval.sh` names and nothing else (DN_MODE `base`, NUM_DN
    5, noise 0.2) through `train_net.main` as phase 18;
30. `slice_maskformer1`, after `train_mapillary_pan`: MaskFormer-v1 on the
    ADE20K semantic recipe (BasePixelDecoder, StandardTransformerDecoder on
    res5, 6 decoder layers, DROPOUT 0.1; and TransformerEncoderPixelDecoder
    with 6 encoder layers on `transformer_encoder`) serves 4 requests each
    (no kernel on this path: its JAX twin runs no Pallas kernel), and each
    per-pixel baseline head runs one forward; `train_maskformer1`: the first
    configuration through `train_net.main` at the recipe's batch (16 crops of
    512x512) from phase 21's data as phase 23, then `--eval-only --resume`:
    finite mIoU;
31. A16c, A19 and A22, after `train_video`, forward only: `eval_lvis` (8
    synthetic LVIS v1 images of 512x512 from `tools/make_synthetic_lvis_torch.py`,
    their ground truth joined by the plain ops' best detection of each of an
    image's first 3 classes, not exhaustively annotated (`write_lvis_oracle`),
    through `run_evaluation` with the released instance recipe at 1203 classes
    and 300 detections an image: K1 6 and K3 9 launches an image; AP above 0,
    and AP, APr, APc and APf through the kernels against the plain ops given
    the kernel path's decisions), `tta_semantic` (`SemanticSegmentorWithTTA` with the
    ADE20K R50 semantic recipe's TEST.AUG, 12 passes on a 512x683 image: K1 72
    and K3 108 launches; the averaged probabilities against the plain ops)
    and `demo` (`demo.demo` on two `.npy` images and `predict.main` on one with
    the COCO panoptic recipe, `demo_video.demo` on an 8-frame 720x1280 clip
    with the R50 YouTube-VIS 2019 recipe: K1 6 and K3 9 a forward, their PNGs
    written; `forward_raw` against the plain ops);
32. A21, after `train_coco`, data parallelism through the port's
    `parallel/` code (`launch`, DDP in `Trainer`, the rank-free draws of
    `parallel/rows.py`, `sharded_eval_loop`): `ddp_train`, two ranks on the
    one card over gloo (which carries CUDA tensors for all-reduce and
    broadcast; NCCL takes one card a rank) run 2 steps of phase 13's recipe
    at B = 8 (4 images a rank) with `GRAD_ACCUM_STEPS` 1 and 2; step 1 hands
    each rank the one-process step's attention masks, ReLU decisions and
    assignments (its rows of them, `PairedAttention`, `PairedRelu`), and the
    ranks' loss dicts of both steps and all-reduced gradients of step 1 are
    held against the one-process steps on the 8 images; K1 12, K1 backward
    6, K3 9, K3 backward 9 a rank and micro-batch; `ddp_eval`, on the same
    ranks, `run_evaluation` of `train_coco`'s 8 val images with the seeded
    model: every AP key equal to the one-process run's, each image's
    detections equal, K1 6 and K3 9 an image; `ddp_nccl`, one rank in an
    NCCL group: `Trainer` wraps the model in DDP, and its step's gradients
    equal the undistributed step's; `torch.cuda.nccl.version()` printed.

Every training phase recomputes the pixel decoder's encoder layers in the
backward, as the recipes' `TPU.REMAT_ENCODER` default says: K1 (or K2) runs
once more a step than the encoder has layers (levels), its backward once.

Each kernel phase also computes the kernel's bound (the least time the card
could take: bytes over the memory rate or operations over the peak rate,
whichever is larger) and times the one PyTorch call that computes the same
function, where there is one; the port itself never calls it. Every time is
read on two clocks (`mp_former_tpu_torch/utils/cuda_timing.py`): `ms`,
`plain_ms` and `library_ms` are device times (the calls captured into a CUDA
graph and replayed), `issue_ms`, `plain_issue_ms` and `library_issue_ms` the
host's time to issue one eager call; an eager caller pays the larger. Then a
JSON line with each kernel's launches, error, times and bound, the card's name
and power limit, and last the result line `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import math
import os
import sys
import time
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = "configs/coco/instance-segmentation/maskformer2_R50_bs16_12ep_DN_query.yaml"
TPU_CONFIG = "configs/coco/instance-segmentation/maskformer2_R50_bs16_50ep_DN_query_tpu.yaml"
SEED = 0
# the slice's levels at an 800x1088 canvas: res5, res4, res3 (H, W)
MSDA_SHAPES = [(25, 34), (50, 68), (100, 136)]
ATTN_KEYS = [850, 3400, 13600]
# the decoder's queries: the ResNet recipes' 100, the Swin-L recipes' 200 (13
# tiles of 16 rows, two blocks a (batch, head))
K3_QUERIES = (100, 200)
REQUESTS = [(480, 640), (640, 480), (427, 640), (640, 427)]
# kernel vs plain tolerances (max abs error). float32: the two sum in other
# orders and round the sampling coordinate differently (loc*W-0.5 against
# grid_sample's ((2loc-1)+1)*W/2-0.5), a few ulp of outputs of magnitude ~1.
# bfloat16: the kernel's output is rounded to bfloat16 (8 bits of mantissa).
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the backward kernels against their plain versions, relative to each
# gradient's largest entry. float32: other summation orders (atomics in K1's
# grad_value and K3's dq), and in K3 the forward's 3xTF32 row statistics
# against float32 recomputation (~1e-6). bfloat16: outputs rounded to 8 bits.
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# K3's float32 backward against its plain version in float64 (the DN modes'
# steps): the kernel lies up to ~3x further from float64 than the float32
# plain backward on the same inputs (3xTF32 products, other summation
# orders; at the seeded init dq within 1.4e-5 of its largest entry, the
# float32 plain backward 1.3e-5). The limit is BWD_TOL or this factor times
# the float32 plain backward's own distance, whichever is larger.
F64_CONTROL_FACTOR = 4.0
# against autograd of the plain forward: grid_sample rounds the sampling
# coordinate differently (see TOL), which moves a point across a pixel border
# now and then; there grad_loc, the slope of the bilinear surface, jumps. So
# grad_loc may miss on one entry in 100000.
AUTOGRAD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
TRAIN_SHAPES = [(16, 16), (32, 32), (64, 64)]   # res5, res4, res3 of a 512x512 image
BS16_SHAPES = [(32, 32), (64, 64), (128, 128)]  # and of the released batch's 1024x1024
TRAIN_BATCH, TRAIN_SIZE, TRAIN_MAX_INSTANCES = 8, 512, 20
# the released training recipe, as run_50ep_no_noise_all_ly.sh sets it
TRAIN_OVERRIDES = ["MODEL.MASK_FORMER.DN_MODE", "points", "MODEL.DN.NUM_DN", "1",
                   "MODEL.DN.NOISE_SCALE", "0.0", "MODEL.MASK_FORMER.ALL_LY_DN", "True",
                   "MODEL.MASK_FORMER.LB_NOISE_RATIO", "0.2", "SOLVER.IMS_PER_BATCH", "8",
                   "SEED", "0"]
# step 0 through the kernels against the same step through autograd of the
# plain ops (same weights, batch, draws and assignments): each loss relative to
# its value; each parameter's gradient relative to the largest gradient entry
# of that parameter. The attention masks are thresholds (sigmoid < 0.5 of
# resized logits), so a forward difference of 1e-4 flips a pixel now and then,
# which shows in the gradients of the layers behind it: 5e-3 there, three
# times the worst such run read (1.7e-3, an FFN behind the first thresholded
# mask). The parameters next to K1 and K3 (the deformable attention's and the
# cross-attention's projections) are held to 1e-3.
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_KERNEL_GRAD_TOL = 1e-3, 5e-3, 1e-3
TRAIN_KERNEL_LEAVES = ("sampling_offsets", "attention_weights", "value_proj", "output_proj",
                       "transformer_cross_attention_layers")
# published peaks of one H100 SXM at its full 700 W power limit: HBM bytes/s,
# float32 FLOP/s outside the tensor cores, dense TF32 and bfloat16 tensor-core
# FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}


_STARTED = time.perf_counter()


def log(phase: str, **fields) -> None:
    """One line of a phase's fields, ending with the script's seconds so far
    (`at_s`), which split its 1200 s budget between the phases."""
    fields["at_s"] = f"{time.perf_counter() - _STARTED:.1f}"
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def bound(n_bytes: float, flops: float, dtype: str) -> dict:
    """The least time the card could take for `n_bytes` moved (each input read
    once, each output written once) and `flops` operations of type `dtype`."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def mean(values) -> float:
    return sum(values) / len(values)


def timed(kernel, plain, library=None, calls: int = 20, plain_calls: int = 0) -> dict:
    """Both clocks of a kernel, its plain version and the library call
    (`plain_calls`: fewer calls a graph for a plain version with large
    intermediates)."""
    from mp_former_tpu_torch.utils.cuda_timing import two_clocks

    k = two_clocks(kernel, calls)
    pl = two_clocks(plain, plain_calls or calls, iters=10 if plain_calls else 50)
    lb = two_clocks(library, calls) if library is not None else {}
    return {"ms": k["ms"], "issue_ms": k["issue_ms"],
            "plain_ms": pl["ms"], "plain_issue_ms": pl["issue_ms"],
            "library_ms": lb.get("ms"), "library_issue_ms": lb.get("issue_ms")}


def fmt_times(t: dict) -> dict:
    """The fields of `timed` for a log line."""
    return {k: (f"{v:.5f}" if isinstance(v, float) else v) for k, v in t.items()}


def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script "
                         "runs the port on a CUDA card only")
    sys.path.insert(0, REPO)
    from mp_former_tpu_torch.utils.cuda_timing import card_string

    card = card_string()
    log("device", card=repr(card), torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count())
    return card


def phase_build() -> None:
    from mp_former_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    lib_path = cuda_build.build()
    cuda_build.library()
    build_log = (lib_path.parent / "build.log").read_text()
    for line in build_log.splitlines():
        if "Used" in line or "spill" in line:
            log("ptxas", info=line.strip())
    log("build", seconds=f"{time.perf_counter() - t0:.2f}", lib=os.path.relpath(lib_path, REPO))


def phase_k1(torch, card: str) -> dict:
    from mp_former_tpu_torch.ops import msda_cuda

    g = torch.Generator(device="cuda").manual_seed(SEED)
    B, M, D, P = 1, 8, 32, 4
    L = len(MSDA_SHAPES)
    S = sum(h * w for h, w in MSDA_SHAPES)
    value = torch.randn((B, S, M, D), generator=g, device="cuda")
    # 10% of the range lies outside [0, 1]: taps off the map read zero
    loc = torch.rand((B, S, M, L, P, 2), generator=g, device="cuda") * 1.2 - 0.1
    attn = torch.randn((B, S, M, L * P), generator=g, device="cuda").softmax(-1)
    attn = attn.view(B, S, M, L, P)
    # points with a tap on the map: 4 taps and the attention weight, one
    # multiply-add each per channel; the others cost nothing
    sizes = torch.tensor([[w, h] for h, w in MSDA_SHAPES], device="cuda").view(1, 1, 1, L, 1, 2)
    base = (loc * sizes - 0.5).floor()
    on_map = ((base >= -1) & (base <= sizes - 1)).all(-1).sum().item()
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        v, lo, a = (t.to(dtype).contiguous() for t in (value, loc, attn))
        got = msda_cuda.msda_fwd(v, MSDA_SHAPES, lo, a)
        want = msda_cuda.ms_deform_attn_plain(v.float(), MSDA_SHAPES, lo.float(), a.float())
        torch.cuda.synchronize()
        folded = msda_cuda.ms_deform_attn_folded(v.float(), MSDA_SHAPES, lo.float(), a.float())
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        folded_err = (got.float() - folded).abs().max().item()
        del want, folded
        times = timed(lambda: msda_cuda.msda_fwd(v, MSDA_SHAPES, lo, a),
                      lambda: msda_cuda.ms_deform_attn_plain(v, MSDA_SHAPES, lo, a))
        bnd = bound(nbytes(v, lo, a, got), on_map * 5 * 2 * D, name)
        log("K1", dtype=name, shape=f"B{B}xQ{S}xM{M}xD{D}xL{L}xP{P}", max_abs_err=f"{err:.3e}",
            max_abs_err_vs_folded=f"{folded_err:.3e}", tol=TOL[name], **fmt_times(times),
            bound_ms=f"{bnd['bound_ms']:.4f}", bound_by=bnd["bound_by"],
            points_on_map=f"{on_map}/{B * S * M * L * P}", card=repr(card))
        if not max(err, folded_err) <= TOL[name]:
            raise AssertionError(f"K1 {name}: max abs error {err} against the plain version, "
                                 f"{folded_err} against the folded one, above {TOL[name]}")
        res[name] = {"max_abs_err": err, **times, **bnd}
    return res


def phase_k3(torch, card: str) -> dict:
    import torch.nn.functional as F

    from mp_former_tpu_torch.ops import masked_attention_cuda as mac

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    H, D = 8, 32

    def head_views(B, Q, S, dtype):
        """q, k, v as `MultiheadAttention` hands them to the kernel: the
        (B, H, N, D) views of (B, N, H * D) projections, not copies."""
        return tuple(torch.randn((B, n, H * D), generator=g, device="cuda").to(dtype)
                     .view(B, n, H, D).transpose(1, 2) for n in (Q, S, S))

    def max_err(got, want):
        torch.cuda.synchronize()
        return (got.float() - want.float()).abs().max().item()

    res = {}
    for dtype, Q in itertools.product((torch.float32, torch.bfloat16), K3_QUERIES):
        name = str(dtype).split(".")[1]
        errs, times, bounds = [], [], []
        for S in ATTN_KEYS:
            B = 1
            q, k, v = head_views(B, Q, S, dtype)
            mask = torch.rand((B, Q, S), generator=g, device="cuda") < 0.7
            mask[:, :5] = True  # fully masked rows: uniform over all keys
            mask_h = torch.rand((B, H, Q, S), generator=g, device="cuda") < 0.7
            err = 0.0
            for m in (mask, mask_h):
                want = mac.masked_attention_plain(q.float(), k.float(), v.float(), m)
                # where the keys lie (strided views) and as contiguous copies
                err = max(err, max_err(mac.masked_attn_fwd(q, k, v, m), want),
                          max_err(mac.masked_attn_fwd(q.contiguous(), k.contiguous(),
                                                      v.contiguous(), m), want))
            # a batch of two, strided, with a row masked in every chunk but one
            q2, k2, v2 = head_views(2, Q, S, dtype)
            mask2 = torch.rand((2, Q, S), generator=g, device="cuda") < 0.7
            mask2[:, :5] = True
            mask2[:, 5, 64:] = True
            got = mac.masked_attn_fwd(q2, k2, v2, mask2)
            batch_err = max_err(got, mac.masked_attention_plain(q2.float(), k2.float(),
                                                                v2.float(), mask2))
            # the same tiles, chunks and 3xTF32 products in plain PyTorch
            tiled_err = max_err(got, mac.masked_attention_tiled(
                q2, k2, v2, mask2, sms=torch.cuda.get_device_properties(0).multi_processor_count))
            del q2, k2, v2, mask2, got
            # the one library call for the same function: an additive -1e9
            # mask, made outside the timed call
            additive = torch.zeros((B, 1, Q, S), dtype=dtype, device="cuda")
            additive.masked_fill_(mask[:, None], -1e9)
            lib = F.scaled_dot_product_attention(q, k, v, attn_mask=additive)
            want = mac.masked_attention_plain(q.float(), k.float(), v.float(), mask)
            lib_err = (lib.float() - want).abs().max().item()
            if not lib_err <= TOL[name]:
                raise AssertionError(f"K3 {name} S={S}: the library call computes another "
                                     f"function (max abs error {lib_err})")
            t = timed(lambda: mac.masked_attn_fwd(q, k, v, mask),
                      lambda: mac.masked_attention_plain(q, k, v, mask),
                      lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=additive))
            # q k^T and p v: 2 * 2 * Q * S * D per head. float32 runs them on the
            # tensor cores as 3xTF32: three times the operations, at the TF32 peak
            flops = 4.0 * B * H * Q * S * D
            n_bytes = nbytes(q, k, v, mask) + q.numel() * q.element_size()
            bnd = (bound(n_bytes, 3 * flops, "tf32") if dtype == torch.float32
                   else bound(n_bytes, flops, name))
            log("K3", dtype=name, shape=f"B{B}xH{H}xQ{Q}xS{S}xD{D}", layout="strided head views",
                max_abs_err=f"{err:.3e}", batch_of_2_max_abs_err=f"{batch_err:.3e}",
                max_abs_err_vs_tiled=f"{tiled_err:.3e}", tol=TOL[name], **fmt_times(t),
                bound_ms=f"{bnd['bound_ms']:.5f}", bound_by=bnd["bound_by"],
                library="F.scaled_dot_product_attention", card=repr(card))
            if not max(err, batch_err, tiled_err) <= TOL[name]:
                raise AssertionError(f"K3 {name} S={S}: max abs error {err} (batch of two "
                                     f"{batch_err}, against the tiled plain function "
                                     f"{tiled_err}) above {TOL[name]}")
            errs.append(max(err, batch_err))
            times.append(t)
            bounds.append(bnd)
        # one decoder cycle visits each level once: report the mean per call
        res[(name, Q)] = {"max_abs_err": max(errs),
                     **{key: mean([t[key] for t in times]) for key in times[0]},
                     "bound_ms": mean([b["bound_ms"] for b in bounds]),
                     "bound_by": bounds[-1]["bound_by"]}
    offset_check(torch, card, g)
    return res


# K3 float32 against the plain function of its own arithmetic, where a sum
# over the keys that rounds one way at every add drifts: "the same arithmetic
# but for ex2.approx (2^-22) and summation order" (tests/test_torch_kernels_gpu.py)
TILED_TOL = 1e-5


def offset_check(torch, card: str, g) -> None:
    """K3 in float32 where the decoder's features put it: a query's weight
    spread over the keys, the values sharing an offset (3 + 0.25 N(0, 1), as
    the Swin-L step's features), S = 16384 (its training batch's finest
    level), 200 queries. The kernel within TILED_TOL of its tiled arithmetic
    (`masked_attention_tiled`), each relative to max(1, the largest entry);
    the three against float64 are logged."""
    from mp_former_tpu_torch.ops import masked_attention_cuda as mac

    B, H, Q, S, D = 2, 8, 200, 16384, 32
    q = 0.3 * torch.randn((B, H, Q, D), generator=g, device="cuda")
    k = torch.randn((B, H, S, D), generator=g, device="cuda")
    v = 3.0 + 0.25 * torch.randn((B, H, S, D), generator=g, device="cuda")
    mask = torch.rand((B, Q, S), generator=g, device="cuda") < 0.1
    logits = torch.einsum("bhqd,bhsd->bhqs", q.double(), k.double()) / math.sqrt(D)
    exact = torch.einsum("bhqs,bhsd->bhqd", logits.masked_fill_(mask[:, None], -1e9).softmax(-1),
                         v.double())
    del logits
    got = mac.masked_attn_fwd(q, k, v, mask)
    tiled = mac.masked_attention_tiled(q, k, v, mask)
    errs = {name: scaled_err(x.double(), exact) for name, x in (
        ("kernel", got), ("plain", mac.masked_attention_plain(q, k, v, mask)), ("tiled", tiled))}
    err = scaled_err(got, tiled)
    log("K3", dtype="float32", shape=f"B{B}xH{H}xQ{Q}xS{S}xD{D}",
        inputs="weights spread, values 3 + 0.25 N(0, 1)", max_err_vs_tiled=f"{err:.3e}",
        tol=TILED_TOL, **{f"{n}_err_vs_float64": f"{e:.3e}" for n, e in errs.items()},
        card=repr(card))
    if not err <= TILED_TOL:
        raise AssertionError(f"K3 float32 on values with a common offset: {err} from its own "
                             f"tiled arithmetic, above {TILED_TOL} (against float64: {errs})")


# the canvases of the Cityscapes (1024x2048) and Mapillary Vistas (a 4:3
# image at MIN_SIZE_TEST 2048 capped by MAX_SIZE_TEST 2048: 1536x2048) test
# resolutions: K1's levels res5, res4, res3 (its queries are their pixels) and
# K3's keys at the largest, the 1/8 level
TEST_CANVASES = {"cityscapes": (1024, 2048), "mapillary": (1536, 2048)}


def scaled_tol(tol: float, want) -> tuple:
    """(`tol` times the largest entry of the plain output `want` where that is
    below 1, else `tol`; that entry): an error limit that scales with outputs
    much smaller than 1 and is never looser than `tol`."""
    out_max = want.abs().max().item()
    return tol * min(1.0, out_max), out_max


def canvas_levels(h: int, w: int) -> list:
    return [(h // s, w // s) for s in (32, 16, 8)]


def hold_k1_at(torch, g, shapes, batch: int, dtype) -> dict:
    """K1 on `batch` images of the encoder's tokens at levels `shapes`, seeded
    locations with 10% of their range off the map, against its plain version
    at TOL times the plain output's largest entry where that is below 1
    (`scaled_tol`); timed beside the plain version and the bound."""
    from mp_former_tpu_torch.ops import msda_cuda

    M, D, P = 8, 32, 4
    L, S = len(shapes), sum(a * b for a, b in shapes)
    value = torch.randn((batch, S, M, D), generator=g, device="cuda")
    loc = torch.rand((batch, S, M, L, P, 2), generator=g, device="cuda") * 1.2 - 0.1
    attn = torch.randn((batch, S, M, L * P), generator=g, device="cuda").softmax(-1)
    attn = attn.view(batch, S, M, L, P)
    sizes = torch.tensor([[b, a] for a, b in shapes], device="cuda").view(1, 1, 1, L, 1, 2)
    base = (loc * sizes - 0.5).floor()
    on_map = ((base >= -1) & (base <= sizes - 1)).all(-1).sum().item()
    name = str(dtype).split(".")[1]
    v, lo, a = (t.to(dtype).contiguous() for t in (value, loc, attn))
    del value, loc, attn
    got = msda_cuda.msda_fwd(v, shapes, lo, a)
    want = msda_cuda.ms_deform_attn_plain(v.float(), shapes, lo.float(), a.float())
    err = (got.float() - want).abs().max().item()
    tol, out_max = scaled_tol(TOL[name], want)
    del want
    times = timed(lambda: msda_cuda.msda_fwd(v, shapes, lo, a),
                  lambda: msda_cuda.ms_deform_attn_plain(v, shapes, lo, a), plain_calls=2)
    bnd = bound(nbytes(v, lo, a, got), on_map * 5 * 2 * D, name)
    return {"shape": f"B{batch}xQ{S}xM{M}xD{D}xL{L}xP{P}", "queries": S, "batch": batch,
            "max_abs_err": err, "plain_max_abs": out_max, "tol": tol, **times, **bnd}


def hold_k3_at(torch, g, Q: int, keys: int, dtype, batch: int = 1, dn: int = 0) -> dict:
    """K3 on Q queries over `keys` keys (the strided head views of `batch`
    images' projections) with a mask shared by the heads, as the decoder
    hands it (with `dn`, a mask per head whose first `dn` rows, the DN block,
    differ by head, as under HEAD_DN), 5 rows fully masked, against its plain
    version at TOL times the plain output's largest entry where that is
    below 1 (`scaled_tol`; over 10^4 keys and more the outputs are averages,
    a few hundredths at most, and an absolute limit would pass a kernel that
    lost a chunk of keys); SDPA on
    an additive mask held to the same limit; timed beside the plain version,
    the bound and SDPA."""
    import torch.nn.functional as F

    from mp_former_tpu_torch.ops import masked_attention_cuda as mac

    H, D = 8, 32
    name = str(dtype).split(".")[1]
    q, k, v = (torch.randn((batch, n, H * D), generator=g, device="cuda").to(dtype)
               .view(batch, n, H, D).transpose(1, 2) for n in (Q, keys, keys))
    mask = torch.rand((batch, Q, keys), generator=g, device="cuda") < 0.7
    if dn:
        mask = mask[:, None].expand(batch, H, Q, keys).clone()
        mask[:, :, :dn] = torch.rand((batch, H, dn, keys), generator=g, device="cuda") < 0.9
    mask[..., :5, :] = True  # fully masked rows
    want = mac.masked_attention_plain(q.float(), k.float(), v.float(), mask)
    err = (mac.masked_attn_fwd(q, k, v, mask).float() - want).abs().max().item()
    tol, out_max = scaled_tol(TOL[name], want)
    additive = torch.zeros((batch, H if dn else 1, Q, keys), dtype=dtype, device="cuda")
    additive.masked_fill_(mask if dn else mask[:, None], -1e9)
    lib_err = (F.scaled_dot_product_attention(q, k, v, attn_mask=additive).float()
               - want).abs().max().item()
    del want
    times = timed(lambda: mac.masked_attn_fwd(q, k, v, mask),
                  lambda: mac.masked_attention_plain(q, k, v, mask),
                  lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=additive),
                  plain_calls=2 if batch * keys > 50000 else 5)
    flops = 4.0 * batch * H * Q * keys * D
    n_bytes = nbytes(q, k, v, mask) + q.numel() * q.element_size()
    bnd = (bound(n_bytes, 3 * flops, "tf32") if dtype == torch.float32
           else bound(n_bytes, flops, name))
    return {"shape": f"B{batch}xH{H}xQ{Q}xS{keys}xD{D}", "queries": Q, "keys": keys,
            "max_abs_err": err, "library_max_abs_err": lib_err, "plain_max_abs": out_max,
            "tol": tol, **times, **bnd}


def log_canvas_row(phase: str, kernel: str, where: str, dtype: str, row: dict, card: str) -> None:
    extra = ({"library_max_abs_err": f"{row['library_max_abs_err']:.3e}",
              "library": "F.scaled_dot_product_attention"} if kernel == "K3" else {})
    log(phase, kernel=kernel, canvas=where, dtype=dtype, shape=row["shape"],
        max_abs_err=f"{row['max_abs_err']:.3e}", plain_max_abs=f"{row['plain_max_abs']:.3e}",
        tol=f"{row['tol']:.3e}",
        **fmt_times({k: row[k] for k in ("ms", "issue_ms", "plain_ms", "plain_issue_ms",
                                          "library_ms", "library_issue_ms")}),
        bound_ms=f"{row['bound_ms']:.5f}", bound_by=row["bound_by"], **extra, card=repr(card))
    if not (row["max_abs_err"] <= row["tol"] and row.get("library_max_abs_err", 0.0) <= row["tol"]):
        raise AssertionError(f"{phase} {kernel} {where} {dtype}: max abs error "
                             f"{row['max_abs_err']} (SDPA {row.get('library_max_abs_err')}) "
                             f"against the plain version, limit {row['tol']}")


def phase_test_canvases(torch, card: str) -> dict:
    """K1 and K3 at the test canvases of the Cityscapes and Mapillary Vistas
    recipes, float32 and bfloat16, against their plain versions: K1 on one
    image's 43008 and 64512 queries, K3 on 100 queries over the 1/8 level's
    32768 and 49152 keys (`hold_k1_at`, `hold_k3_at`)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    res = {}
    for canvas, (h, w) in TEST_CANVASES.items():
        shapes = canvas_levels(h, w)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            for kernel, row in (("K1", hold_k1_at(torch, g, shapes, 1, dtype)),
                                ("K3", hold_k3_at(torch, g, 100, shapes[-1][0] * shapes[-1][1],
                                                  dtype))):
                log_canvas_row("test_canvases", kernel, f"{canvas} {h}x{w}", name, row, card)
                res[(kernel, canvas, name)] = row
            torch.cuda.empty_cache()
    log("test_canvases", ok=True)
    return res


# a 36-frame clip of a 720x1280 video at the YouTube-VIS recipes'
# MIN_SIZE_TEST 360 is a 384x640 canvas: its levels 12x20, 24x40 and 48x80
# give K1 36 frames of 5040 queries and K3 the keys of a level in every frame
VIDEO_CANVAS = (384, 640)
VIDEO_CANVAS_FRAMES = 36


def phase_video_canvases(torch, card: str) -> dict:
    """K3 at 100 and 200 queries (the ResNet and Swin-L video recipes) over
    the keys of the three levels of a 36-frame clip (8640, 34560, 138240),
    and K1 on the clip's batch of 36 x 5040 queries, float32 and bfloat16,
    as `phase_test_canvases` holds and times them."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    shapes = canvas_levels(*VIDEO_CANVAS)
    where = f"{VIDEO_CANVAS_FRAMES} frames of {VIDEO_CANVAS[0]}x{VIDEO_CANVAS[1]}"
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        row = hold_k1_at(torch, g, shapes, VIDEO_CANVAS_FRAMES, dtype)
        log_canvas_row("video_canvases", "K1", where, name, row, card)
        res[("K1", where, name)] = row
        for Q in K3_QUERIES:
            for h, w in shapes:
                row = hold_k3_at(torch, g, Q, VIDEO_CANVAS_FRAMES * h * w, dtype)
                log_canvas_row("video_canvases", "K3", where, name, row, card)
                res[("K3", f"{where}, {Q} queries", name)] = row
        torch.cuda.empty_cache()
    log("video_canvases", ok=True)
    return res


def test_canvas_rows(res: dict, kernel: str) -> list:
    """`phase_test_canvases`' measurements of one kernel, for the JSON line."""
    return [{"canvas": canvas, "dtype": dtype, **row}
            for (k, canvas, dtype), row in res.items() if k == kernel]


def phase_k2(torch, card: str) -> dict:
    from mp_former_tpu_torch.ops import tap_weighting as tw

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    Q = sum(h * w for h, w in MSDA_SHAPES)
    D, T = 32, 4
    # (name, B, Q, P, M): the two call shapes of one level at the 800x1088
    # canvas (every level is sampled by all Q queries), and two ragged ones
    cases = [("headshare", 1, Q, 4, 8), ("per_head", 8, Q, 4, 1),
             ("ragged", 3, 100, 12, 1), ("ragged_heads", 2, 101, 3, 8)]
    res = {}
    for case, B, q, P, M in cases:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            taps = torch.randn((B, P * q, T * M * D), generator=g, device="cuda").to(dtype)
            # far from uniform, so a wrong row or lane order shows
            w = (torch.rand((B, P * q, T * M), generator=g, device="cuda") ** 3).to(dtype)
            got = tw.weight_taps(taps, w, P, M, D)
            want = tw.weight_taps_plain(taps.float(), w.float(), P, M, D)
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            # float32: sums of T*P products in another order, the tolerance grows
            # with P. bfloat16: the output is rounded to 8 bits of mantissa,
            # half an ulp of the largest output (taps are normal, so outputs
            # reach ~10)
            tol = (TOL[name] * max(1, P // 4) if dtype == torch.float32
                   else 2.0 ** -8 * want.abs().max().item())
            del want
            taps6, w5 = taps.view(B, P, q, T, M, D), w.view(B, P, q, T, M)
            lib = torch.einsum("bpqtmd,bpqtm->bqmd", taps6, w5).reshape(B, q, M * D)
            lib_err = (lib.float() - got.float()).abs().max().item()
            del lib
            if not lib_err <= 4 * tol:
                raise AssertionError(f"K2 {case} {name}: the library call computes another "
                                     f"function (max abs difference {lib_err})")
            # few calls a graph: the plain version and einsum write a product
            # as large as the taps
            t = timed(lambda: tw.weight_taps(taps, w, P, M, D),
                      lambda: tw.weight_taps_plain(taps, w, P, M, D),
                      lambda: torch.einsum("bpqtmd,bpqtm->bqmd", taps6, w5), calls=5)
            bnd = bound(nbytes(taps, w, got), 2.0 * taps.numel(), name)
            log("K2", case=case, dtype=name, shape=f"B{B}xQ{q}xP{P}xT{T}xM{M}xD{D}",
                max_abs_err=f"{err:.3e}", tol=f"{tol:.3e}", **fmt_times(t),
                bound_ms=f"{bnd['bound_ms']:.4f}", bound_by=bnd["bound_by"],
                library="torch.einsum", card=repr(card))
            if not err <= tol:
                raise AssertionError(f"K2 {case} {name}: max abs error {err} above {tol}")
            res[(case, name)] = {"max_abs_err": err, **t, **bnd}
            del taps, w, got, taps6, w5
    return res


def phase_row_gather(torch, card: str) -> dict:
    import importlib.util

    from mp_former_tpu_torch.ops import row_gather as rg

    spec = importlib.util.spec_from_file_location(
        "probe_torch_row_gather", os.path.join(REPO, "tools", "probe_torch_row_gather.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)

    # the kernels against their plain versions (exact for the gather), timed
    res = {}
    for r in probe.run_probes(card, SEED):
        table = r["rows"] * r["width"] * r["element_size"]
        gathered = r["n"] * r["width"] * r["element_size"]
        out = (r["slots"] or r["n"]) * r["width"] * r["element_size"]
        # each input byte once: no more of the table than there is
        bnd = bound(r["n"] * r["index_size"] + min(table, gathered) + out, 0.0, "float32")
        log("row_gather", probe=r["probe"], op=r["op"], bound_ms=f"{bnd['bound_ms']:.6f}",
            bound_by=bnd["bound_by"], note="tables fit the L2 and stay warm between calls")
        res[r["probe"]] = {k: r[k] for k in (
            "max_abs_err", "ms", "issue_ms", "plain_ms", "plain_issue_ms", "library_ms",
            "library_issue_ms")} | bnd
    # the tool's own path, counted
    rg.GATHER_LAUNCHES = rg.SUM_LAUNCHES = 0
    probe.main(["--iters", "5", "--seed", str(SEED + 1)])
    launches = {"row_gather": rg.GATHER_LAUNCHES, "row_gather_sum": rg.SUM_LAUNCHES}
    log("row_gather", tool="tools/probe_torch_row_gather.py", **launches)
    if not all(launches.values()):
        raise AssertionError(f"the probe tool did not launch every row-gather kernel: {launches}")
    return {"launches": launches, **res}


def load_cfg(config: str, overrides, released_decoder: bool = True):
    """The recipe `config` with `overrides`; `released_decoder`: with the DN
    decoder, as eval.sh runs the released recipe (the ADE20K, Cityscapes
    and Mapillary Vistas recipes run their own, the vanilla one)."""
    from mp_former_tpu_torch.config import build_cfg

    decoder = (["MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME",
                "MultiScaleMaskedTransformerDecoderMaskDN"] if released_decoder else [])
    # with the video recipes' keys; the others leave them be
    return build_cfg(os.path.join(REPO, config), decoder + list(overrides), video=True)


def slice_cfg():
    return load_cfg(CONFIG, [])


def slice2_cfg():
    # the TPU recipe asks for bfloat16 compute; this phase runs it in float32,
    # phase slice2_bf16 as the YAML says
    return load_cfg(TPU_CONFIG, ["TPU.COMPUTE_DTYPE", "float32"])


def seeded_model(torch, cfg):
    from mp_former_tpu_torch.models import build_model

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        return build_model(cfg)  # reference inits, seeded


# substrings of the port's CUDA kernels' names (csrc/*.cu) in a profiler trace
PORT_KERNEL_NAMES = ("msda_fwd", "msda_bwd", "masked_attn", "tap_weight", "row_gather")


def kernel_counts(backward: bool = False) -> dict:
    """The launch counts of the model's kernels; with `backward` also those of
    the three backward kernels (the serving phases compare the forward ones)."""
    from mp_former_tpu_torch.ops import masked_attention_cuda as mac
    from mp_former_tpu_torch.ops import msda_cuda
    from mp_former_tpu_torch.ops import tap_weighting as tw

    counts = {"msda_fwd": msda_cuda.LAUNCHES, "tap_weight_fwd": tw.LAUNCHES,
              "masked_attn_fwd": mac.LAUNCHES}
    if backward:
        counts.update(msda_bwd=msda_cuda.BWD_LAUNCHES, masked_attn_bwd=mac.BWD_LAUNCHES,
                      tap_weight_bwd=tw.BWD_LAUNCHES)
    return counts


def reset_kernel_counts() -> None:
    from mp_former_tpu_torch.ops import masked_attention_cuda as mac
    from mp_former_tpu_torch.ops import msda_cuda
    from mp_former_tpu_torch.ops import tap_weighting as tw

    msda_cuda.LAUNCHES = tw.LAUNCHES = mac.LAUNCHES = 0
    msda_cuda.BWD_LAUNCHES = mac.BWD_LAUNCHES = tw.BWD_LAUNCHES = 0


@contextlib.contextmanager
def plain_ops():
    """Every kernel of the model replaced by its plain version, and the three
    autograd Functions by autograd of the plain versions; fails if a kernel is
    launched all the same."""
    from mp_former_tpu_torch.ops import masked_attention_cuda as mac
    from mp_former_tpu_torch.ops import ms_deform_attn as msda_mod
    from mp_former_tpu_torch.ops import msda_cuda
    from mp_former_tpu_torch.ops import tap_weighting as tw

    before = kernel_counts(backward=True)
    with mock.patch.object(msda_mod, "msda_fwd", msda_cuda.ms_deform_attn_plain), \
            mock.patch.object(msda_cuda.MSDeformAttnFunction, "apply",
                              msda_cuda.ms_deform_attn_plain), \
            mock.patch.object(tw, "tap_weight_fwd", tw.weight_taps_plain), \
            mock.patch.object(tw.TapWeightingFunction, "apply", tw.weight_taps_plain), \
            mock.patch.object(mac, "masked_attn_fwd", mac.masked_attention_plain), \
            mock.patch.object(mac.MaskedAttentionFunction, "apply", mac.masked_attention_plain):
        yield
    if kernel_counts(backward=True) != before:
        raise AssertionError("the plain-op path launched a kernel")


def check_instances(cfg, requests, outs) -> None:
    topk = cfg.TEST.DETECTIONS_PER_IMAGE
    for (h, w), out in zip(requests, outs):
        inst = out["instances"]
        if inst["masks"].shape != (topk, h, w) or inst["scores"].shape != (topk,) \
                or inst["classes"].shape != (topk,):
            raise AssertionError(f"request {h}x{w}: instance shapes "
                                 f"{ {k: v.shape for k, v in inst.items()} }")
        if not np.isfinite(inst["scores"]).all():
            raise AssertionError(f"request {h}x{w}: non-finite scores")
        if not ((inst["classes"] >= 0) & (inst["classes"] < cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)).all():
            raise AssertionError(f"request {h}x{w}: class ids out of range")


def serve(torch, phase: str, cfg, predictor, images, requests, per_request: dict, card: str,
          warm_passes: int) -> dict:
    """The main path, counted: every image once through `predictor`, the
    kernels' counts set to 0 just before and read just after."""
    predictor(images[0])  # warm-up: cuDNN handles, allocator
    torch.cuda.synchronize()
    reset_kernel_counts()
    latencies, outs = [], []
    t_all = time.perf_counter()
    for img in images:
        t0 = time.perf_counter()
        outs.append(predictor(img))  # returns host arrays: ends in a sync
        latencies.append(time.perf_counter() - t0)
    total = time.perf_counter() - t_all
    launches = kernel_counts()
    n = len(images)
    expected = {k: v * n for k, v in per_request.items()}
    log(phase, requests=n, launches=launches, expected=expected)
    if launches != expected:
        raise AssertionError(f"{phase}: kernel launches {launches}, expected {expected}")
    check_instances(cfg, requests, outs)
    log(phase, pass_="first (each new canvas shape pays cuDNN plan and allocator set-up)",
        img_per_s=f"{n / total:.3f}", latency_ms=[round(t * 1e3, 2) for t in latencies],
        card=repr(card))
    # the same requests again, every shape now seen once
    for rep in range(warm_passes):
        latencies = []
        t_all = time.perf_counter()
        for img in images:
            t0 = time.perf_counter()
            predictor(img)
            latencies.append(time.perf_counter() - t0)
        total = time.perf_counter() - t_all
        log(phase, pass_=f"warm {rep + 1}/{warm_passes}", img_per_s=f"{n / total:.3f}",
            latency_ms=[round(t * 1e3, 2) for t in latencies], card=repr(card))
    return launches


def compare_outputs(torch, phase: str, what: str, cfg, canvas, got: dict, want: dict) -> None:
    """pred_logits within 1e-3, pred_masks within 1e-2, and no mask pixel on
    the other side of 0 unless its logit is within 5e-2 of 0. `canvas` is an
    image (1, H, W, 3) or a clip (1, T, H, W, 3)."""
    got_cls, want_cls = got["pred_logits"].float(), want["pred_logits"].float()
    got_msk, want_msk = got["pred_masks"].float(), want["pred_masks"].float()
    if got_msk.shape != (1, cfg.MODEL.MASK_FORMER.NUM_OBJECT_QUERIES, *canvas.shape[1:-3],
                         canvas.shape[-3] // 4, canvas.shape[-2] // 4):
        raise AssertionError(f"{phase}: pred_masks shape {tuple(got_msk.shape)}")
    if not (torch.isfinite(got_cls).all() and torch.isfinite(got_msk).all()):
        raise AssertionError(f"{phase}: non-finite kernel-path outputs")
    cls_err = (got_cls - want_cls).abs().max().item()
    msk_err = (got_msk - want_msk).abs().max().item()
    near0 = want_msk.abs() < 5e-2
    disagree = (((got_msk > 0) != (want_msk > 0)) & ~near0).sum().item()
    log(phase, compare=what, canvas=tuple(canvas.shape[1:-1]),
        logits_max_abs_err=f"{cls_err:.3e}", logits_tol=1e-3,
        masks_max_abs_err=f"{msk_err:.3e}", masks_tol=1e-2,
        threshold_disagreements_off_zero=disagree,
        mask_logit_range=f"[{want_msk.min().item():.2f}, {want_msk.max().item():.2f}]")
    if not (cls_err < 1e-3 and msk_err < 1e-2 and disagree == 0):
        raise AssertionError(f"{phase}: {what} disagree")


def phase_slice(torch, card: str, phase: str, cfg, per_request: dict, warm_passes: int):
    """A full-width model with seeded weights serves REQUESTS through
    `Predictor`; then the same forward through the plain ops on the card."""
    from mp_former_tpu_torch.engine.predictor import Predictor

    model = seeded_model(torch, cfg)
    predictor = Predictor(cfg, model=model, device="cuda")
    rng = np.random.RandomState(SEED)
    images = [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for h, w in REQUESTS]
    launches = serve(torch, phase, cfg, predictor, images, REQUESTS, per_request, card,
                     warm_passes)
    canvas, _ = predictor.preprocess(images[0])
    with torch.inference_mode():
        k_out = model(canvas)
        with plain_ops():
            p_out = model(canvas)
    compare_outputs(torch, phase, "kernel vs plain ops", cfg, canvas, k_out, p_out)
    return launches, predictor, images, canvas, k_out


def phase_tap_weighting_route(torch, card: str, slice1_predictor, image, canvas, k1_out) -> dict:
    """Slice 1's model and weights with `TPU.PALLAS_TAP_WEIGHTING True`: the
    per-head engine through the patch-table gather and K2 instead of K1."""
    from mp_former_tpu_torch.engine.convert import load_weights
    from mp_former_tpu_torch.engine.predictor import Predictor
    from mp_former_tpu_torch.models import build_model

    cfg = load_cfg(CONFIG, ["TPU.PALLAS_TAP_WEIGHTING", "True"])
    model = build_model(cfg)
    load_weights(model, slice1_predictor.model.state_dict())
    predictor = Predictor(cfg, model=model, device="cuda")
    launches = serve(torch, "tap_weighting_route", cfg, predictor, [image], REQUESTS[:1],
                     {"msda_fwd": 0, "tap_weight_fwd": 18, "masked_attn_fwd": 9}, card, 1)
    with torch.inference_mode():
        out = predictor.model(canvas)
    compare_outputs(torch, "tap_weighting_route", "patch-table gather + K2 vs K1", cfg, canvas,
                    out, k1_out)
    return launches


def phase_eval(torch, card: str, cfg, predictor) -> dict:
    """`inference_on_dataset` over 8 in-memory records; the ground truth is
    the model's own three best predictions per image, so the AP is far from
    0 and moves with any change in the masks."""
    from mp_former_tpu_torch.engine.eval_loop import inference_on_dataset
    from mp_former_tpu_torch.evaluation.coco_eval import COCOEvaluator

    rng = np.random.RandomState(SEED + 3)
    records = []
    for i, (h, w) in enumerate(REQUESTS * 2):
        img = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        inst = predictor(img)["instances"]
        annos = [{"category_id": int(inst["classes"][j]), "iscrowd": 0,
                  "area": float(inst["masks"][j].sum()), "segmentation": inst["masks"][j]}
                 for j in np.argsort(-inst["scores"])[:3] if inst["masks"][j].sum() > 40]
        records.append({"image": img, "image_id": i, "height": h, "width": w,
                        "annotations": annos})
    n_gt = sum(len(r["annotations"]) for r in records)
    if n_gt < len(records):
        raise AssertionError(f"evaluation: only {n_gt} usable ground-truth masks")
    topk = cfg.TEST.DETECTIONS_PER_IMAGE
    reset_kernel_counts()
    t0 = time.perf_counter()
    kernel = inference_on_dataset(cfg, predictor, records, COCOEvaluator(records, topk))["segm"]
    seconds = time.perf_counter() - t0
    launches = kernel_counts()
    with plain_ops():
        plain = inference_on_dataset(cfg, predictor, records, COCOEvaluator(records, topk))["segm"]
    log("evaluation", records=len(records), gt_masks=n_gt, launches=launches,
        kernel_path_AP=f"{kernel['AP']:.4f}", plain_path_AP=f"{plain['AP']:.4f}",
        kernel_path_AP50=f"{kernel['AP50']:.4f}", plain_path_AP50=f"{plain['AP50']:.4f}",
        tol=0.01, seconds_kernel_path=f"{seconds:.2f}", card=repr(card))
    aps = (kernel["AP"], plain["AP"])
    if not (all(np.isfinite(aps)) and min(aps) > 0 and abs(aps[0] - aps[1]) <= 0.01):
        raise AssertionError(f"evaluation: AP {aps[0]} through the kernels, {aps[1]} through "
                             "the plain ops")
    expected = {"msda_fwd": 0, "tap_weight_fwd": 18 * len(records),
                "masked_attn_fwd": 9 * len(records)}
    if launches != expected:
        raise AssertionError(f"evaluation: kernel launches {launches}, expected {expected}")
    return {"kernel": kernel, "plain": plain, "records": records}


@contextlib.contextmanager
def watching_wrappers(watch):
    """Each of the six kernel wrappers replaced, in the region, by one that
    calls `watch(kernel, args, kwargs)` and then the wrapper (K1's forward
    where both `ms_deform_attn` and `MSDeformAttnFunction` call it)."""
    from mp_former_tpu_torch.ops import masked_attention_cuda as mac
    from mp_former_tpu_torch.ops import ms_deform_attn as msda_mod
    from mp_former_tpu_torch.ops import msda_cuda
    from mp_former_tpu_torch.ops import tap_weighting as tw

    def watched(kernel, fn):
        def wrapper(*args, **kwargs):
            watch(kernel, args, kwargs)
            return fn(*args, **kwargs)
        return wrapper

    k1 = watched("msda_fwd", msda_cuda.msda_fwd)
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(msda_mod, "msda_fwd", k1))
        for module, kernel in ((msda_cuda, "msda_fwd"), (msda_cuda, "msda_bwd"),
                               (tw, "tap_weight_fwd"), (tw, "tap_weight_bwd"),
                               (mac, "masked_attn_fwd"), (mac, "masked_attn_bwd")):
            wrapper = k1 if kernel == "msda_fwd" else watched(kernel, getattr(module, kernel))
            stack.enter_context(mock.patch.object(module, kernel, wrapper))
        yield


@contextlib.contextmanager
def launch_types():
    """Records the types each kernel wrapper is called with in the region:
    {kernel: {type}}; K1's and its backward's read "value/locations"."""
    def name(t):
        return str(t.dtype).split(".")[1]

    types = {"msda_fwd": lambda a: f"{name(a[0])}/{name(a[2])}",
             "msda_bwd": lambda a: f"{name(a[1])}/{name(a[3])}",
             "masked_attn_bwd": lambda a: name(a[1])}
    seen = {}
    with watching_wrappers(lambda kernel, args, kwargs: seen.setdefault(kernel, set()).add(
            types.get(kernel, lambda a: name(a[0]))(args))):
        yield seen


# what a bfloat16 model hands each kernel: K1 a bfloat16 value with float32
# locations and weights (the JAX package's float32 sampling arithmetic)
BF16_TYPES = {"msda_fwd": {"bfloat16/float32"}, "msda_bwd": {"bfloat16/float32"},
              "tap_weight_fwd": {"bfloat16"}, "tap_weight_bwd": {"bfloat16"},
              "masked_attn_fwd": {"bfloat16"}, "masked_attn_bwd": {"bfloat16"}}


def check_bf16_types(phase: str, seen: dict) -> None:
    log(phase, launch_types={k: sorted(v) for k, v in seen.items()})
    wrong = {k: v for k, v in seen.items() if v != BF16_TYPES[k]}
    if wrong:
        raise AssertionError(f"{phase}: kernels launched in other types than bfloat16: {wrong}")


def hold_bf16(torch, phase: str, what: str, k16: dict, p16: dict, p32: dict) -> dict:
    """The bfloat16 outputs through the kernels (`k16`) no further from the
    float32 outputs through the plain ops (`p32`) than the bfloat16 outputs
    through the plain ops (`p16`) are: err(k16) <= 1.5 x err(p16) + 1e-3 for
    the class and the mask logits, each error the largest difference relative
    to p32's largest entry. Returns {key: (err(k16), err(p16))}."""
    if k16["pred_masks"].dtype != torch.bfloat16 or p32["pred_masks"].dtype != torch.float32:
        raise AssertionError(f"{phase}: output types {k16['pred_masks'].dtype}, "
                             f"{p32['pred_masks'].dtype}")
    errs = {}
    for key in ("pred_logits", "pred_masks"):
        scale = p32[key].abs().max().item()
        kernel = (k16[key].float() - p32[key]).abs().max().item() / scale
        plain = (p16[key].float() - p32[key]).abs().max().item() / scale
        if not (math.isfinite(kernel) and kernel <= 1.5 * plain + 1e-3):
            raise AssertionError(f"{phase}: {what} {key}: bf16 kernels {kernel:.3e}, bf16 plain "
                                 f"ops {plain:.3e} from float32")
        errs[key] = (kernel, plain)
    return errs


def phase_slice_bf16(torch, card: str, phase: str, cfg, per_request: dict, images,
                     f32_predictor):
    """`TPU.COMPUTE_DTYPE bfloat16`: the float32 phase's model (the same
    seeded weights) serves the same requests in bfloat16, counted, every
    launch in bfloat16. On every request the bfloat16 forward through the
    kernels is held against the float32 forward through the plain ops no
    further than the bfloat16 forward through the plain ops is:
    err(bf16 kernels) <= 1.5 x err(bf16 plain) + 1e-3, each the largest
    difference relative to the float32 output's largest entry. Also device
    busy ms per request in both types."""
    from mp_former_tpu_torch.engine.predictor import Predictor
    from mp_former_tpu_torch.utils.cuda_timing import busy_ms

    model = seeded_model(torch, cfg)
    if model.compute_dtype != torch.bfloat16:
        raise AssertionError(f"{phase}: the model does not read TPU.COMPUTE_DTYPE bfloat16")
    predictor = Predictor(cfg, model=model, device="cuda")
    with launch_types() as seen:
        launches = serve(torch, phase, cfg, predictor, images, REQUESTS, per_request, card, 1)
    check_bf16_types(phase, seen)
    worst = {}
    with torch.inference_mode():
        for (h, w), img in zip(REQUESTS, images):
            canvas, _ = predictor.preprocess(img)
            k16 = model(canvas)
            with plain_ops():
                p16 = model(canvas)
                model.compute_dtype = torch.float32
                p32 = model(canvas)
                model.compute_dtype = torch.bfloat16
            for key, errs in hold_bf16(torch, phase, f"request {h}x{w}", k16, p16,
                                       p32).items():
                w0 = worst.get(key, (0.0, 0.0))
                worst[key] = (max(w0[0], errs[0]), max(w0[1], errs[1]))
    log(phase, compare="bf16 kernels and bf16 plain ops against float32 plain ops, worst "
        "request, relative to the float32 output's largest entry",
        **{f"{k}_kernels": f"{v[0]:.3e}" for k, v in worst.items()},
        **{f"{k}_plain": f"{v[1]:.3e}" for k, v in worst.items()}, bound="1.5 x plain + 1e-3")
    busy32 = busy_ms(lambda: f32_predictor(images[0]))
    busy16 = busy_ms(lambda: predictor(images[0]))
    log(phase, request=f"{REQUESTS[0][0]}x{REQUESTS[0][1]}",
        device_busy_ms_per_request_float32=f"{busy32:.3f}",
        device_busy_ms_per_request_bfloat16=f"{busy16:.3f}", card=repr(card))
    return launches, predictor


def phase_eval_bf16(torch, card: str, cfg, predictor, evaluation: dict) -> dict:
    """The 8 records of the evaluation phase (their ground truth the float32
    model's own predictions) through the bfloat16 model: segm AP through the
    kernels within 0.5 of AP through the plain ops, both bfloat16; the
    float32 AP beside them."""
    from mp_former_tpu_torch.engine.eval_loop import inference_on_dataset
    from mp_former_tpu_torch.evaluation.coco_eval import COCOEvaluator

    records, topk = evaluation["records"], cfg.TEST.DETECTIONS_PER_IMAGE
    reset_kernel_counts()
    with launch_types() as seen:
        kernel = inference_on_dataset(cfg, predictor, records, COCOEvaluator(records, topk))["segm"]
    launches = kernel_counts()
    check_bf16_types("eval_bf16", seen)
    with plain_ops():
        plain = inference_on_dataset(cfg, predictor, records, COCOEvaluator(records, topk))["segm"]
    log("eval_bf16", records=len(records), launches=launches,
        kernel_path_AP=f"{kernel['AP']:.4f}", plain_path_AP=f"{plain['AP']:.4f}",
        float32_kernel_path_AP=f"{evaluation['kernel']['AP']:.4f}", tol=0.5, card=repr(card))
    aps = (kernel["AP"], plain["AP"])
    if not (all(np.isfinite(aps)) and min(aps) > 0 and abs(aps[0] - aps[1]) <= 0.5):
        raise AssertionError(f"eval_bf16: AP {aps[0]} through the kernels, {aps[1]} through "
                             "the plain ops")
    expected = {"msda_fwd": 0, "tap_weight_fwd": 18 * len(records),
                "masked_attn_fwd": 9 * len(records)}
    if launches != expected:
        raise AssertionError(f"eval_bf16: kernel launches {launches}, expected {expected}")
    return launches


def rel_err(got, want) -> float:
    """max |got - want| relative to want's largest entry."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


def rel_err64(got, want) -> float:
    """`rel_err` taken in float64, for a float64 reference."""
    want = want.double()
    return ((got.double() - want).abs().max() / want.abs().max().clamp(min=1e-300)).item()


def model_like_locations(torch, g, B, shapes, M, P):
    """Sampling locations as the pixel decoder makes them: every token of every
    level is a query at its pixel centre, each point a few pixels off it
    (queries near an edge sample off the map), and 2% of the points far off."""
    refs = []
    for h, w in shapes:
        ry = (torch.arange(h, device="cuda", dtype=torch.float32) + 0.5) / h
        rx = (torch.arange(w, device="cuda", dtype=torch.float32) + 0.5) / w
        gy, gx = torch.meshgrid(ry, rx, indexing="ij")
        refs.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    ref = torch.cat(refs, 0)                                       # (Q, 2)
    Q, L = ref.shape[0], len(shapes)
    sizes = torch.tensor([[w, h] for h, w in shapes], device="cuda",
                         dtype=torch.float32).view(1, 1, 1, L, 1, 2)
    offsets = torch.randn((B, Q, M, L, P, 2), generator=g, device="cuda") * 3.0
    loc = ref.view(1, Q, 1, 1, 1, 2) + offsets / sizes
    far = torch.rand((B, Q, M, L, P, 1), generator=g, device="cuda") < 0.02
    return torch.where(far, loc + 2.0, loc)


def hold_k1_bwd_at(torch, card: str, phase: str, where: str, g, shapes, batch: int, dtype,
                   sampling=None, plain_calls: int = 2) -> dict:
    """K1's backward on `batch` images of the encoder's tokens at levels
    `shapes` (model-like locations, some off the map), the value and the
    gradient in `dtype`, locations and weights in `sampling` (`dtype` if
    None; the bfloat16 model's mix is a bfloat16 value with float32
    sampling, held to bfloat16's tolerances): the forward at this shape
    against the plain version (TOL), the three gradients against the plain
    backward (BWD_TOL of each gradient's largest entry) and against autograd
    of the plain forward (AUTOGRAD_TOL; grad_loc entry by entry); timed
    beside the plain backward (`plain_calls` a graph) and the bound; logged
    under `phase`. Returns the row."""
    from mp_former_tpu_torch.ops import msda_cuda
    from mp_former_tpu_torch.utils.cuda_timing import two_clocks

    M, D, P = 8, 32, 4
    L, S = len(shapes), sum(h * w for h, w in shapes)
    sampling = sampling or dtype
    name = str(dtype).split(".")[1]
    kind = name if sampling == dtype else f"{name}/{str(sampling).split('.')[1]}"
    value = torch.randn((batch, S, M, D), generator=g, device="cuda").to(dtype)
    loc = model_like_locations(torch, g, batch, shapes, M, P).to(sampling)
    attn = torch.randn((batch, S, M, L * P), generator=g, device="cuda").softmax(-1)
    attn = attn.view(batch, S, M, L, P).to(sampling)
    go = torch.randn((batch, S, M * D), generator=g, device="cuda").to(dtype)
    sizes = torch.tensor([[w, h] for h, w in shapes], device="cuda").view(1, 1, 1, L, 1, 2)
    base = (loc.float() * sizes - 0.5).floor()
    on_map = ((base >= -1) & (base <= sizes - 1)).all(-1).sum().item()
    del base
    fwd = msda_cuda.msda_fwd(value, shapes, loc, attn)
    fwd_err = (fwd.float() - msda_cuda.ms_deform_attn_plain(
        value.float(), shapes, loc.float(), attn.float())).abs().max().item()
    fwd_ms = two_clocks(lambda: msda_cuda.msda_fwd(value, shapes, loc, attn))["ms"]
    fwd_bound = bound(nbytes(value, loc, attn, fwd), on_map * 5 * 2 * D, name)
    got = msda_cuda.msda_bwd(go, value, shapes, loc, attn)
    want = msda_cuda.ms_deform_attn_backward_plain(go.float(), value.float(), shapes,
                                                   loc.float(), attn.float())
    errs = [rel_err(x, w) for x, w in zip(got, want)]
    abs_err = max((x.float() - w).abs().max().item() for x, w in zip(got, want))
    del want
    leaves = [t.float().clone().requires_grad_() for t in (value, loc, attn)]
    auto = torch.autograd.grad(msda_cuda.ms_deform_attn_plain(leaves[0], shapes, leaves[1],
                                                              leaves[2]), leaves, go.float())
    auto_errs = [rel_err(got[0], auto[0]), rel_err(got[2], auto[2])]
    loc_miss = ((got[1].float() - auto[1]).abs()
                > AUTOGRAD_TOL[name] * auto[1].abs().max()).float().mean().item()
    del auto, leaves
    times = timed(lambda: msda_cuda.msda_bwd(go, value, shapes, loc, attn),
                  lambda: msda_cuda.ms_deform_attn_backward_plain(go, value, shapes, loc, attn),
                  calls=10, plain_calls=plain_calls)
    # per tap on the map: the dot product with g and the add of w * g
    bnd = bound(nbytes(go, value, loc, attn, got[1], got[2]) + value.numel() * 4,
                on_map * 4 * 4 * D, name)
    row = {"shape": f"B{batch}xQ{S}xM{M}xD{D}xL{L}xP{P}", "dtype": kind, "queries": S,
           "batch": batch, "rel_errs": errs, "max_abs_err": abs_err, "tol": BWD_TOL[name],
           "points_on_map": f"{on_map}/{batch * S * M * L * P}", **times, **bnd}
    log(phase, kernel="K1_bwd", canvas=where, dtype=kind, shape=row["shape"],
        rel_err_value_loc_attn=[f"{e:.2e}" for e in errs], tol=BWD_TOL[name],
        max_abs_err=f"{abs_err:.3e}", forward_max_abs_err=f"{fwd_err:.3e}",
        forward_tol=TOL[name], rel_err_vs_autograd_value_attn=[f"{e:.2e}" for e in auto_errs],
        grad_loc_share_off_vs_autograd=f"{loc_miss:.2e}", autograd_tol=AUTOGRAD_TOL[name],
        grad_value_reproducible="to rounding only (float32 atomics, in no fixed order)",
        **fmt_times(times), bound_ms=f"{bnd['bound_ms']:.5f}", bound_by=bnd["bound_by"],
        points_on_map=row["points_on_map"], forward_ms=f"{fwd_ms:.5f}",
        forward_bound_ms=f"{fwd_bound['bound_ms']:.5f}", forward_bound_by=fwd_bound["bound_by"],
        card=repr(card))
    if not fwd_err <= TOL[name]:
        raise AssertionError(f"{phase} K1 forward {where} {kind}: max abs error {fwd_err} "
                             f"against the plain version, above {TOL[name]}")
    if not max(errs) <= BWD_TOL[name]:
        raise AssertionError(f"{phase} K1 backward {where} {kind}: relative errors {errs} "
                             f"against the plain backward, above {BWD_TOL[name]}")
    if not (max(auto_errs) <= AUTOGRAD_TOL[name] and loc_miss <= 1e-5):
        raise AssertionError(f"{phase} K1 backward {where} {kind}: against autograd of the "
                             f"plain forward {auto_errs}, grad_loc off on {loc_miss} of entries")
    return row


def phase_k1_bwd(torch, card: str) -> dict:
    """K1's backward at one 800x1088 canvas, the released recipe's training
    batch (8 images of 512x512) and its bs16@1024 batch, in float32, bfloat16
    and the bfloat16 model's mix (`hold_k1_bwd_at`)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    res = {}
    for case, B, shapes in (("canvas", 1, MSDA_SHAPES), ("train", TRAIN_BATCH, TRAIN_SHAPES),
                            ("bs16", 16, BS16_SHAPES)):
        for dtype, sampling in ((torch.float32,) * 2, (torch.bfloat16,) * 2,
                                (torch.bfloat16, torch.float32)):
            # the plain backward gathers 48 taps a query: ~17 GB at bs16, one call a graph
            row = hold_k1_bwd_at(torch, card, "K1_bwd", case, g, shapes, B, dtype, sampling,
                                 plain_calls=1 if case == "bs16" else 2)
            res[(case, row["dtype"])] = row
            torch.cuda.empty_cache()
    return res


def bf16_reference_errs(torch, go, q, k, v, mask, want) -> list:
    """How far autograd of the plain forward in bfloat16 (the arithmetic of
    the einsum form the JAX package trains through,
    `mp_former_tpu/models/transformer_decoder/primitives.py:72-80`) lies from
    the float32 gradients `want`: the bound of K3's bfloat16 backward."""
    from mp_former_tpu_torch.ops import masked_attention_cuda as mac

    leaves = [t.detach().bfloat16().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(mac.masked_attention_plain(*leaves, mask), leaves, go.bfloat16())
    return [rel_err(x, w) for x, w in zip(ref, want)]


def spread_delta_check(torch, card: str, g) -> None:
    """K3's bfloat16 backward where delta = rowsum(dO * O) matters most: the
    weights spread over 4096 keys, k and v sharing an offset (as the
    decoder's features do), dO with no component along O, so that dP - delta
    nearly cancels and dQ sums delta's error over the keys. The kernel takes
    delta from the forward's float32 output; each gradient must lie no
    further from the float32 plain backward than autograd of the plain
    bfloat16 forward does (`bf16_reference_errs`)."""
    from mp_former_tpu_torch.ops import masked_attention_cuda as mac

    B, H, Q, S, D = 8, 8, 120, 4096, 32
    q = 0.3 * torch.randn((B, H, Q, D), generator=g, device="cuda")
    k = (torch.randn((1, H, 1, D), generator=g, device="cuda")
         + torch.randn((B, H, S, D), generator=g, device="cuda"))
    v = (3.0 * torch.randn((1, H, 1, D), generator=g, device="cuda")
         + torch.randn((B, H, S, D), generator=g, device="cuda"))
    mask = torch.rand((B, Q, S), generator=g, device="cuda") < 0.3
    q, k, v = (t.bfloat16() for t in (q, k, v))
    out = mac.masked_attention_plain(q.float(), k.float(), v.float(), mask)
    go = torch.randn((B, H, Q, D), generator=g, device="cuda")
    go = (go - (go * out).sum(-1, keepdim=True) / (out * out).sum(-1, keepdim=True) * out
          ).bfloat16()
    want = mac.masked_attention_backward_plain(go.float(), q.float(), k.float(), v.float(), mask)
    bounds = bf16_reference_errs(torch, go, q, k, v, mask, want)
    _, stats, out32 = mac.masked_attn_fwd(q, k, v, mask, with_stats=True)
    errs = [rel_err(x, w) for x, w in zip(mac.masked_attn_bwd(go, q, k, v, mask, out32, stats),
                                          want)]
    log("K3_bwd", dtype="bfloat16", shape=f"B{B}xH{H}xQ{Q}xS{S}xD{D}",
        inputs="weights spread, shared offsets of k and v, dO orthogonal to O",
        rel_err_dq_dk_dv=[f"{e:.2e}" for e in errs],
        bound_bf16_autograd=[f"{e:.2e}" for e in bounds], card=repr(card))
    if not all(e <= b for e, b in zip(errs, bounds)):
        raise AssertionError(f"K3 backward bfloat16 on spread weights: {errs} against the float32 "
                             f"plain backward, beyond the bfloat16 reference's {bounds}")


# K3's backward at the released recipe's training shapes (B = 8, 512x512: 100
# queries and 20 DN rows, S = 256 / 1024 / 4096), at the 800x1088 canvas
# (S = 13600), and with the Swin-L recipes' 200 queries at that canvas and at
# their training batch's largest level (16 images of 1024x1024: S = 16384)
K3_BWD_SHAPES = ((8, 120, 256), (8, 120, 1024), (8, 120, 4096), (1, 100, 13600),
                 (1, 200, 850), (1, 200, 3400), (1, 200, 13600), (16, 200, 16384))


def hold_k3_bwd_at(torch, card: str, phase: str, where: str, g, B: int, Q: int, S: int, dtype,
                   dn: int = 0, tiled: bool = False, calls: int = 10,
                   plain_calls: int = 2) -> dict:
    """K3's forward with statistics and its backward on the strided head
    views of B images' (B, N, H * D) projections, Q queries over S keys, as
    the decoders hand them: with `dn`, a mask per head whose learnable
    queries' rows are shared by the heads and whose first `dn` rows (the DN
    block) are per head (the image decoder's); without, one mask shared by
    the heads (the video decoder's); rows 0-4 blocked everywhere. Held: the
    float32 output rounds to the output; the output and the statistics
    against the plain version (TOL); the gradients against the plain
    backward (BWD_TOL of each gradient's largest entry) and nothing to a
    blocked row's q; two calls equal bit for bit; with `tiled`, against the
    kernel's tiled arithmetic in PyTorch; through the Function against
    autograd of the plain forward (AUTOGRAD_TOL); SDPA's backward, on the
    mask with key 0 of the blocked rows open, against the plain backward on
    that mask. Timed beside the plain backward (`plain_calls` a graph), the
    bound and SDPA's backward; logged under `phase`. Returns the row."""
    import torch.nn.functional as F

    from mp_former_tpu_torch.ops import masked_attention_cuda as mac
    from mp_former_tpu_torch.utils.cuda_timing import two_clocks

    H, D, blocked = 8, 32, 5
    name = str(dtype).split(".")[1]
    q, k, v = (torch.randn((B, n, H * D), generator=g, device="cuda").to(dtype)
               .view(B, n, H, D).transpose(1, 2) for n in (Q, S, S))
    go = torch.randn((B, Q, H, D), generator=g, device="cuda").to(dtype).transpose(1, 2)
    shared = torch.rand((B, 1, Q, S), generator=g, device="cuda") < 0.7
    if dn:
        mask = shared.expand(B, H, Q, S).clone()
        mask[:, :, :dn] = torch.rand((B, H, dn, S), generator=g, device="cuda") < 0.9
    else:
        mask = shared[:, 0].clone()
    del shared
    mask[..., :blocked, :] = True
    mask4 = mask.view(B, -1, Q, S)
    out, stats, out32 = mac.masked_attn_fwd(q, k, v, mask, with_stats=True)
    # the float32 output the backward takes delta from: out before its rounding
    rounds = torch.equal(out32.to(dtype), out)
    # the forward that writes the statistics is an instantiation of its own:
    # its output against the plain version, and the statistics against the
    # plain logits' row maximum (base 2, relative: a row blocked everywhere
    # has -1e9 log2 e) and log2 of the row's sum
    fwd_err = (out.float() - mac.masked_attention_plain(
        q.float(), k.float(), v.float(), mask)).abs().max().item()
    logits = (torch.einsum("bhqd,bhsd->bhqs", q.float(), k.float()) / math.sqrt(D)
              ).masked_fill_(mask4, -1e9)
    row_max = logits.amax(-1)
    log2_sum = (logits - row_max[..., None]).exp_().sum(-1).log2()
    row_max = row_max * math.log2(math.e)
    max_err = ((stats[..., 0] - row_max).abs() / row_max.abs().clamp(min=1.0)).max().item()
    sum_err = (stats[..., 1].log2() - log2_sum).abs().max().item()
    del logits, row_max, log2_sum, out
    got = mac.masked_attn_bwd(go, q, k, v, mask, out32, stats)
    want = mac.masked_attention_backward_plain(go.float(), q.float(), k.float(), v.float(), mask)
    errs = [rel_err(x, w) for x, w in zip(got, want)]
    abs_err = max((x.float() - w).abs().max().item() for x, w in zip(got, want))
    blocked_dq = got[0][:, :, :blocked].abs().max().item()
    del want
    # dq is summed over the key chunks in a fixed order: two calls, equal bits
    reproducible = all(torch.equal(a, b) for a, b in
                       zip(got, mac.masked_attn_bwd(go, q, k, v, mask, out32, stats)))
    tiled_errs = ([rel_err(x, w) for x, w in zip(
        got, mac.masked_attention_backward_tiled(go, q, k, v, mask, out32, stats))]
        if tiled else [0.0])
    # through the Function, against autograd of the plain forward
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    mac.masked_attention(*leaves, mask).backward(go)
    plain_leaves = [t.detach().float().clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(mac.masked_attention_plain(*plain_leaves, mask), plain_leaves,
                               go.float())
    auto_errs = [rel_err(leaf.grad, w) for leaf, w in zip(leaves, auto)]
    del auto, leaves, plain_leaves
    # the one library call for the same function: the backward of SDPA with an
    # additive -1e9 mask. On a row blocked everywhere SDPA's backward computes
    # something else (its forward does not), so the library gets the mask with
    # key 0 of those rows open, and is held against the plain backward on it
    lib_mask = mask.clone()
    lib_mask[..., :blocked, 0] = False
    additive = torch.zeros(mask4.shape, dtype=dtype, device="cuda")
    additive.masked_fill_(lib_mask.view(B, -1, Q, S), -1e9)
    lib_leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib = torch.autograd.grad(F.scaled_dot_product_attention(*lib_leaves, attn_mask=additive),
                              lib_leaves, go)
    lib_want = mac.masked_attention_backward_plain(go.float(), q.float(), k.float(), v.float(),
                                                   lib_mask)
    lib_err = max(rel_err(x, w) for x, w in zip(lib, lib_want))
    del lib, lib_want, lib_leaves, lib_mask
    t = timed(lambda: mac.masked_attn_bwd(go, q, k, v, mask, out32, stats),
              lambda: mac.masked_attention_backward_plain(go, q, k, v, mask),
              calls=calls, plain_calls=plain_calls)

    # a backward cannot be captured apart from its forward (the engine ties it
    # to the forward's stream): the library's time is forward and backward
    # together less the forward alone, each by graph replay
    def lib_forward(backward=False):
        # fresh leaves: autograd ties a leaf to the stream it was made on
        fresh = [x.detach().requires_grad_(backward) for x in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*fresh, attn_mask=additive)
        return torch.autograd.grad(lib_out, fresh, go) if backward else lib_out

    both = two_clocks(lambda: lib_forward(backward=True), calls)
    alone = two_clocks(lib_forward, calls)
    t["library_ms"] = both["ms"] - alone["ms"]
    t["library_issue_ms"] = both["issue_ms"] - alone["issue_ms"]
    # five products of 2 Q S D operations per head; as in the forward's bound,
    # float32 accuracy on the tensor cores is 3xTF32: three times the
    # operations at the TF32 peak
    flops = 5 * 2.0 * B * H * Q * S * D
    n_bytes = nbytes(q, k, v, out32, go, mask, stats, *got)
    bnd = (bound(n_bytes, 3 * flops, "tf32") if dtype == torch.float32
           else bound(n_bytes, flops, name))
    row = {"shape": f"B{B}xH{H}xQ{Q}xS{S}xD{D}", "queries": Q, "keys": S, "rel_errs": errs,
           "max_abs_err": abs_err, "tol": BWD_TOL[name], **t, **bnd}
    log(phase, kernel="K3_bwd", canvas=where, dtype=name, shape=row["shape"],
        layout="strided head views, " + (f"per-head mask with a {dn}-row DN block" if dn
                                         else "mask shared by the heads"),
        rel_err_dq_dk_dv=[f"{e:.2e}" for e in errs], tol=BWD_TOL[name],
        max_abs_err=f"{abs_err:.3e}", blocked_row_max_abs_dq=blocked_dq,
        forward_max_abs_err=f"{fwd_err:.3e}", stats_max_rel_err=f"{max_err:.3e}",
        stats_log2_sum_abs_err=f"{sum_err:.3e}", forward_tol=TOL[name],
        rel_err_vs_autograd=[f"{e:.2e}" for e in auto_errs], autograd_tol=AUTOGRAD_TOL[name],
        **({"rel_err_vs_tiled_arithmetic": [f"{e:.2e}" for e in tiled_errs]} if tiled else {}),
        bitwise_reproducible=reproducible, library_rel_err=f"{lib_err:.3e}", **fmt_times(t),
        bound_ms=f"{bnd['bound_ms']:.5f}", bound_by=bnd["bound_by"],
        library="backward of F.scaled_dot_product_attention (forward and backward less the "
                "forward)", card=repr(card))
    at = f"{phase} K3 {where} {name} B={B} Q={Q} S={S}"
    if not (rounds and max(fwd_err, max_err, sum_err) <= TOL[name]):
        raise AssertionError(f"{at}: the float32 output rounds to the output: {rounds}; output "
                             f"{fwd_err}, row maximum {max_err}, log2 of the row sum {sum_err} "
                             f"against the plain version, above {TOL[name]}")
    if not (reproducible and max(tiled_errs) <= BWD_TOL[name]):
        raise AssertionError(f"{at}: two backward calls differ ({reproducible=}), or "
                             f"{tiled_errs} against the kernel's tiled arithmetic")
    if not (max(errs) <= BWD_TOL[name] and blocked_dq == 0.0):
        raise AssertionError(f"{at}: backward relative errors {errs} against the plain "
                             f"backward above {BWD_TOL[name]}, or a gradient {blocked_dq} to "
                             "the q of a row blocked everywhere")
    if not (max(auto_errs) <= AUTOGRAD_TOL[name] and lib_err <= AUTOGRAD_TOL[name]):
        raise AssertionError(f"{at}: backward {auto_errs} against autograd of the plain "
                             f"forward, or the library call computes another function "
                             f"(relative error {lib_err})")
    return row


def phase_k3_bwd(torch, card: str) -> dict:
    """K3's backward at K3_BWD_SHAPES with the image decoder's 20-row DN block
    (`hold_k3_bwd_at`, held also against the tiled arithmetic), float32 and
    bfloat16; in bfloat16 also `spread_delta_check`."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        per_shape = []
        for B, Q, S in K3_BWD_SHAPES:
            per_shape.append(hold_k3_bwd_at(torch, card, "K3_bwd", "DN block", g, B, Q, S, dtype,
                                            dn=20, tiled=True))
            torch.cuda.empty_cache()
        if dtype == torch.bfloat16:
            spread_delta_check(torch, card, g)
        # a training step visits each of the three training lengths three times:
        # report their mean per call (the S = 13600 shape is checked, not averaged)
        train = per_shape[:3]
        res[name] = {"max_abs_err": max(r["max_abs_err"] for r in per_shape),
                     **{key: mean([r[key] for r in train])
                        for key in ("ms", "issue_ms", "plain_ms", "plain_issue_ms", "library_ms",
                                    "library_issue_ms", "bound_ms")},
                     "bound_by": train[-1]["bound_by"]}
        res[(name, 200)] = [r for r in per_shape if r["queries"] == 200]
    return res


# K2's backward against its plain version, relative to each gradient's
# largest entry: float32 sums the D products of grad_w in another order;
# bfloat16 rounds grad_w's float32 sum to 8 bits of mantissa
K2_BWD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def phase_k2_bwd(torch, card: str) -> dict:
    """K2's backward kernel at the two call shapes of a training step (B = 8,
    512x512: every one of the 5376 encoder tokens samples every level, P = 4;
    head-shared rows M = 8, and the per-head patch tables, B * M = 64 with M =
    1), float32 and bfloat16, against `weight_taps_backward_plain`; two calls
    give equal bits; timed beside its plain version, its bound and the two
    PyTorch calls that compute the same function (no single one does); K2's
    forward at the same shapes, timed beside its bound. Then the gradients of
    the per-head patch-table route (`ms_deform_attn(..., pallas_weighting=True)`:
    K2 and its backward) against the K1 route's (`MSDeformAttnFunction`) at
    the training shape: one function."""
    from mp_former_tpu_torch.ops import msda_cuda
    from mp_former_tpu_torch.ops import tap_weighting as tw
    from mp_former_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from mp_former_tpu_torch.utils.cuda_timing import two_clocks

    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    Q = sum(h * w for h, w in TRAIN_SHAPES)
    D, T, P = 32, 4, 4
    res = {}
    for case, B, M in (("headshare", TRAIN_BATCH, 8), ("per_head", TRAIN_BATCH * 8, 1)):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            taps = torch.randn((B, P * Q, T * M * D), generator=g, device="cuda").to(dtype)
            # far from uniform, so a wrong row or lane order shows
            w = (torch.rand((B, P * Q, T * M), generator=g, device="cuda") ** 3).to(dtype)
            go = torch.randn((B, Q, M * D), generator=g, device="cuda").to(dtype)
            got = tw.tap_weight_bwd(taps, w, go, P, M, D)
            torch.cuda.synchronize()
            want = tw.weight_taps_backward_plain(taps.float(), w.float(), go.float(), P, M, D)
            errs = [rel_err(x, y) for x, y in zip(got, want)]
            abs_err = max((x.float() - y).abs().max().item() for x, y in zip(got, want))
            del want
            again = tw.tap_weight_bwd(taps, w, go, P, M, D)
            reproducible = all(torch.equal(x, y) for x, y in zip(got, again))
            del again
            # no single PyTorch call computes this: g * w broadcast over the
            # taps, and torch.einsum for the sum over d
            taps6 = taps.view(B, P, Q, T, M, D)
            w6, g6 = w.view(B, P, Q, T, M, 1), go.view(B, 1, Q, 1, M, D)
            g4 = go.view(B, Q, M, D)

            def library():
                return g6 * w6, torch.einsum("bpqtmd,bqmd->bpqtm", taps6, g4)

            lib = library()
            lib_err = max(rel_err(x.reshape(y.shape), y) for x, y in zip(lib, got))
            del lib
            t = timed(lambda: tw.tap_weight_bwd(taps, w, go, P, M, D),
                      lambda: tw.weight_taps_backward_plain(taps, w, go, P, M, D), library,
                      calls=5, plain_calls=2)
            # per lane of the taps: a product for grad_taps, a multiply-add for grad_w
            bnd = bound(nbytes(taps, w, go, *got), 3.0 * taps.numel(), name)
            fwd = tw.tap_weight_fwd(taps, w, P, M, D)
            fwd_err = rel_err(fwd, tw.weight_taps_plain(taps.float(), w.float(), P, M, D))
            fwd_t = two_clocks(lambda: tw.tap_weight_fwd(taps, w, P, M, D), calls=5)
            fwd_bound = bound(nbytes(taps, w, fwd), 2.0 * taps.numel(), name)
            log("K2_bwd", case=case, dtype=name, shape=f"B{B}xQ{Q}xP{P}xT{T}xM{M}xD{D}",
                rel_err_taps_w=[f"{e:.2e}" for e in errs], tol=K2_BWD_TOL[name],
                max_abs_err=f"{abs_err:.3e}", bitwise_reproducible=reproducible,
                library_rel_err=f"{lib_err:.2e}", **fmt_times(t),
                bound_ms=f"{bnd['bound_ms']:.4f}", bound_by=bnd["bound_by"],
                library="g * w broadcast + torch.einsum (two calls)",
                forward_rel_err=f"{fwd_err:.2e}", forward_ms=f"{fwd_t['ms']:.5f}",
                forward_issue_ms=f"{fwd_t['issue_ms']:.5f}",
                forward_bound_ms=f"{fwd_bound['bound_ms']:.4f}", card=repr(card))
            if not (max(errs) <= K2_BWD_TOL[name] and reproducible):
                raise AssertionError(f"K2 backward {case} {name}: relative errors {errs} against "
                                     f"the plain backward above {K2_BWD_TOL[name]}, or two calls "
                                     f"differ ({reproducible=})")
            if not (fwd_err <= BWD_TOL[name] and lib_err <= BWD_TOL[name]):
                raise AssertionError(f"K2 {case} {name}: forward {fwd_err} against the plain "
                                     f"version, or the library calls {lib_err} against the "
                                     "backward kernel")
            res[(case, name)] = {"max_abs_err": abs_err, **t, **bnd, "forward_ms": fwd_t["ms"],
                                 "forward_bound_ms": fwd_bound["bound_ms"]}
            del taps, w, go, got, taps6, w6, g6, g4, fwd

    # the per-head patch-table route (K2) against the K1 route: one function
    M, L = 8, len(TRAIN_SHAPES)
    value = torch.randn((TRAIN_BATCH, Q, M, D), generator=g, device="cuda")
    loc = model_like_locations(torch, g, TRAIN_BATCH, TRAIN_SHAPES, M, P)
    attn = torch.randn((TRAIN_BATCH, Q, M, L * P), generator=g, device="cuda").softmax(-1)
    attn = attn.view(TRAIN_BATCH, Q, M, L, P)
    grad_out = torch.randn((TRAIN_BATCH, Q, M * D), generator=g, device="cuda")
    grads, launches = {}, {}
    for route, pw in (("K2", True), ("K1", False)):
        leaves = [t.clone().requires_grad_() for t in (value, loc, attn)]
        reset_kernel_counts()
        ms_deform_attn(leaves[0], TRAIN_SHAPES, leaves[1], leaves[2],
                       pallas_weighting=pw).backward(grad_out)
        launches[route] = kernel_counts(backward=True)
        grads[route] = [t.grad for t in leaves]
    want_launches = {"K2": {"tap_weight_fwd": L, "tap_weight_bwd": L},
                     "K1": {"msda_fwd": 1, "msda_bwd": 1}}
    route_errs = [rel_err(grads["K2"][0], grads["K1"][0]), rel_err(grads["K2"][2], grads["K1"][2])]
    loc_miss = ((grads["K2"][1] - grads["K1"][1]).abs()
                > AUTOGRAD_TOL["float32"] * grads["K1"][1].abs().max()).float().mean().item()
    log("K2_bwd", compare="per-head patch-table route (K2) vs K1 route, gradients",
        shape=f"B{TRAIN_BATCH}xQ{Q}xM{M}xD{D}xL{L}xP{P}",
        rel_err_value_attn=[f"{e:.2e}" for e in route_errs], tol=BWD_TOL["float32"],
        grad_loc_share_off=f"{loc_miss:.2e}", loc_tol=AUTOGRAD_TOL["float32"],
        launches={k: {n: c for n, c in v.items() if c} for k, v in launches.items()})
    for route, want in want_launches.items():
        if {n: c for n, c in launches[route].items() if c} != want:
            raise AssertionError(f"K2_bwd: the {route} route launched {launches[route]}")
    if not (max(route_errs) <= BWD_TOL["float32"] and loc_miss <= 1e-5):
        raise AssertionError(f"K2_bwd: the patch-table route's gradients against the K1 route's: "
                             f"{route_errs}, grad_loc off on {loc_miss} of entries")
    return res


# launches of one training step with one micro-batch and the encoder not
# recomputed: the released recipe (K1 in the 6 encoder layers, K3 in the 9
# decoder layers, one backward each) and the TPU recipe (head-shared sampling
# through K2: 6 encoder layers x 3 levels)
TRAIN_EXPECTED = {"msda_fwd": 6, "tap_weight_fwd": 0, "masked_attn_fwd": 9, "msda_bwd": 6,
                  "masked_attn_bwd": 9, "tap_weight_bwd": 0}
TRAIN_TPU_EXPECTED = {"msda_fwd": 0, "tap_weight_fwd": 18, "masked_attn_fwd": 9, "msda_bwd": 0,
                      "masked_attn_bwd": 9, "tap_weight_bwd": 18}


def step_expected(base: dict, remat: bool, accum: int = 1) -> dict:
    """A step's launches: `base` once a micro-batch (TPU.GRAD_ACCUM_STEPS),
    and the encoder's forward kernels (K1, K2) once more in the backward where
    TPU.REMAT_ENCODER recomputes its layers."""
    again = ("msda_fwd", "tap_weight_fwd") if remat else ()
    return {k: v * accum * (2 if k in again else 1) for k, v in base.items()}


class NoUpdate:
    """An optimizer and a schedule that update nothing, so that `train_step`
    leaves a step's gradients in `.grad` and the weights as they were."""

    def __init__(self, model):
        self.model = model
        self.param_groups = [{"params": [p for p in model.parameters() if p.requires_grad]}]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.model.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        pass


def loss_and_gradients(torch, model, criterion, batch, assignments=None, accum: int = 1):
    """Step 0 through `engine/train_step.py:train_step` without the update:
    (losses, {name: gradient}, the matcher's assignments, one a micro-batch).
    The draws come from a generator seeded anew, and the matcher's points are
    drawn whether or not `assignments` are handed in, so two calls see the
    same noise."""
    from mp_former_tpu_torch.engine.train_step import train_step

    generator = torch.Generator(device="cuda").manual_seed(SEED)
    solved, handed, solve = [], iter(assignments or ()), criterion.assign

    def assign(costs):
        solved.append(next(handed) if assignments is not None else solve(costs))
        return solved[-1]

    criterion.assign = assign
    stay = NoUpdate(model)
    try:
        losses = train_step(model, criterion, stay, stay, batch, generator, accum=accum)
    finally:
        del criterion.assign
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return ({k: v.item() for k, v in losses.items() if k != "total_loss"}, grads, solved)


def hold_step(torch, phase: str, k_losses, k_grads, p_losses, p_grads) -> None:
    """Step 0 through the kernels against the same step through autograd of
    the plain ops, at phase train's tolerances (TRAIN_*_TOL)."""
    loss_err = max(abs(k_losses[k] - p_losses[k]) / max(abs(p_losses[k]), 1e-6) for k in p_losses)
    if k_grads.keys() != p_grads.keys():
        raise AssertionError(f"{phase}: the two paths give gradients to different parameters")
    grad_errs = sorted(((rel_err(k_grads[n], p_grads[n]), n) for n in p_grads), reverse=True)
    within = sum(e <= 1e-3 for e, _ in grad_errs)
    kernel_errs = [(e, n) for e, n in grad_errs if any(s in n for s in TRAIN_KERNEL_LEAVES)]
    log(phase, compare="step 0, kernels vs autograd of the plain ops", losses=len(k_losses),
        loss_max_rel_err=f"{loss_err:.3e}", loss_tol=TRAIN_LOSS_TOL,
        gradients=len(grad_errs), grad_max_rel_err=f"{grad_errs[0][0]:.3e}",
        grad_tol=TRAIN_GRAD_TOL, gradients_within_1e_3=within,
        gradients_next_to_kernels=len(kernel_errs),
        kernel_grad_max_rel_err=f"{kernel_errs[0][0]:.3e}", kernel_grad_tol=TRAIN_KERNEL_GRAD_TOL,
        worst=[(n, f"{e:.2e}") for e, n in grad_errs[:3]])
    if not (loss_err <= TRAIN_LOSS_TOL and grad_errs[0][0] <= TRAIN_GRAD_TOL
            and kernel_errs and kernel_errs[0][0] <= TRAIN_KERNEL_GRAD_TOL):
        raise AssertionError(f"{phase}: step 0 through the kernels and through the plain ops "
                             f"disagree: losses {loss_err}, gradients {grad_errs[:3]}, next "
                             f"to the kernels {kernel_errs[:3]}")
    if not all(torch.isfinite(g).all() for g in k_grads.values()):
        raise AssertionError(f"{phase}: non-finite gradients")


def restore_kernel_counts(counts: dict) -> None:
    """Set the launch counts back to `counts` (as `kernel_counts(backward=True)`
    read them), after launches that only compare a kernel with its plain
    version."""
    from mp_former_tpu_torch.ops import masked_attention_cuda as mac
    from mp_former_tpu_torch.ops import msda_cuda
    from mp_former_tpu_torch.ops import tap_weighting as tw

    msda_cuda.LAUNCHES, tw.LAUNCHES = counts["msda_fwd"], counts["tap_weight_fwd"]
    mac.LAUNCHES, msda_cuda.BWD_LAUNCHES = counts["masked_attn_fwd"], counts["msda_bwd"]
    mac.BWD_LAUNCHES, tw.BWD_LAUNCHES = counts["masked_attn_bwd"], counts["tap_weight_bwd"]


@contextlib.contextmanager
def recording_launches():
    """While open, the first launch of each kernel wrapper at each signature
    (the shapes and types of its arguments) keeps a detached copy of its
    arguments on the card: {(kernel, signature): (args, kwargs)}. The launch
    and its count go on as they were."""
    import torch

    recorded = {}

    def record(kernel, args, kwargs):
        sig = (kernel, tuple((tuple(a.shape), a.dtype) if torch.is_tensor(a) else repr(a)
                             for a in args))
        if sig not in recorded:
            recorded[sig] = (tuple(a.detach().clone() if torch.is_tensor(a) else a
                                   for a in args), dict(kwargs))

    with watching_wrappers(record):
        yield recorded


def scaled_err(got, want) -> float:
    """max |got - want| over max(1, want's largest entry): absolute on
    outputs of unit scale (as the kernel phases hold them), relative beyond."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp(min=1.0)).item()


def hold_recorded(torch, phase: str, recorded: dict, card: str,
                  k3_bwd_vs_float64: bool = False) -> None:
    """Every launch `recording_launches` kept from a training step, run again
    through its wrapper on the same inputs on the card and held against the
    kernel's plain version: a forward within TOL (`scaled_err`), a backward
    within BWD_TOL (K2's within K2_BWD_TOL) of each gradient's largest entry
    (K3's in float32 on the float32 output the kernel is handed; in bfloat16
    against the float32 plain backward, within the larger of BWD_TOL and the
    distance of autograd of the plain bfloat16 forward). With
    `k3_bwd_vs_float64`, K3's float32 backward is held against the plain
    backward in float64 instead, within the larger of BWD_TOL and
    F64_CONTROL_FACTOR times the float64 distance of the float32 plain
    backward (the control, logged beside it). The launches made here are not
    counted."""
    from mp_former_tpu_torch.ops import masked_attention_cuda as mac
    from mp_former_tpu_torch.ops import msda_cuda
    from mp_former_tpu_torch.ops import tap_weighting as tw

    counts = kernel_counts(backward=True)
    launched = {k for k, v in counts.items() if v}
    if {k for k, _ in recorded} != launched:
        raise AssertionError(f"{phase}: kernels recorded {sorted({k for k, _ in recorded})}, "
                             f"launched {sorted(launched)}")

    def f32(*ts):
        return [t.float() if torch.is_tensor(t) else t for t in ts]

    def dtype_of(t):
        return str(t.dtype).split(".")[1]

    for (kernel, _), (args, kwargs) in sorted(recorded.items(), key=lambda r: r[0][0]):
        extra = {}
        if kernel == "msda_fwd":
            v, shapes, lo, a = args
            name, shape = dtype_of(v), f"B{v.shape[0]}xS{v.shape[1]}xQ{lo.shape[1]}xL{len(shapes)}"
            errs = [scaled_err(msda_cuda.msda_fwd(*args),
                               msda_cuda.ms_deform_attn_plain(*f32(v, shapes, lo, a)))]
            tol = TOL[name]
        elif kernel == "msda_bwd":
            go, v, shapes, lo, a = args
            name, shape = dtype_of(v), f"B{v.shape[0]}xS{v.shape[1]}xQ{lo.shape[1]}xL{len(shapes)}"
            errs = [rel_err(x, y) for x, y in zip(
                msda_cuda.msda_bwd(*args),
                msda_cuda.ms_deform_attn_backward_plain(*f32(go, v, shapes, lo, a)))]
            tol = BWD_TOL[name]
        elif kernel == "masked_attn_fwd":
            q, k, v, mask = args
            name, shape = dtype_of(q), "B{}xH{}xQ{}xS{}xD{}".format(*q.shape[:3], *k.shape[2:])
            out = mac.masked_attn_fwd(*args, **kwargs)
            out = out[0] if isinstance(out, tuple) else out
            errs = [scaled_err(out, mac.masked_attention_plain(*f32(q, k, v), mask))]
            tol = TOL[name]
        elif kernel == "masked_attn_bwd":
            go, q, k, v, mask, out32, stats = args
            name, shape = dtype_of(q), "B{}xH{}xQ{}xS{}xD{}".format(*q.shape[:3], *k.shape[2:])
            got = mac.masked_attn_bwd(*args)
            # bfloat16: against the float32 plain backward, which recomputes the
            # output, within BWD_TOL or no further than autograd of the plain
            # bfloat16 forward lies from it. float32: on the float32 output the
            # kernel is handed (where the weights spread over 16384 keys, dq
            # follows the last bits of O: the recomputed output's distance is
            # logged beside it), or against float64 (F64_CONTROL_FACTOR)
            tol = BWD_TOL[name]
            if k3_bwd_vs_float64 and name == "float32":
                exact = mac.masked_attention_backward_plain(
                    *(t.double() for t in (go, q, k, v)), mask)
                control = mac.masked_attention_backward_plain(*f32(go, q, k, v), mask, out=out32)
                errs = [rel_err64(x, y) for x, y in zip(got, exact)]
                controls = [rel_err64(x, y) for x, y in zip(control, exact)]
                extra["against"] = "the plain backward in float64"
                extra["control_f32_plain_errs"] = [f"{e:.2e}" for e in controls]
                tol = [max(tol, F64_CONTROL_FACTOR * e) for e in controls]
                del exact, control
            else:
                recomputed = mac.masked_attention_backward_plain(*f32(go, q, k, v), mask)
                if name == "bfloat16":
                    errs = [rel_err(x, y) for x, y in zip(got, recomputed)]
                    refs = bf16_reference_errs(torch, go, q, k, v, mask, recomputed)
                    extra["rel_errs_bf16_autograd"] = [f"{e:.2e}" for e in refs]
                    tol = [max(tol, e) for e in refs]
                else:
                    errs = [rel_err(x, y) for x, y in zip(got, mac.masked_attention_backward_plain(
                        *f32(go, q, k, v), mask, out=out32))]
                    extra["rel_errs_vs_recomputed_output"] = [
                        f"{rel_err(x, y):.2e}" for x, y in zip(got, recomputed)]
                del recomputed
        elif kernel == "tap_weight_fwd":
            taps, w, P, M, D = args
            name, shape = dtype_of(taps), f"B{taps.shape[0]}xPQ{taps.shape[1]}xTMD{taps.shape[2]}"
            errs = [scaled_err(tw.tap_weight_fwd(*args),
                               tw.weight_taps_plain(*f32(taps, w), P, M, D))]
            tol = TOL[name]
        else:  # tap_weight_bwd
            taps, w, g, P, M, D = args
            name, shape = dtype_of(taps), f"B{taps.shape[0]}xPQ{taps.shape[1]}xTMD{taps.shape[2]}"
            errs = [rel_err(x, y) for x, y in zip(
                tw.tap_weight_bwd(*args), tw.weight_taps_backward_plain(*f32(taps, w, g), P, M, D))]
            tol = K2_BWD_TOL[name]
        torch.cuda.synchronize()
        tols = tol if isinstance(tol, list) else [tol] * len(errs)
        extra.setdefault("against", "the plain version on the step's own inputs")
        log(phase, hold=kernel, dtype=name, shape=shape, errs=[f"{e:.2e}" for e in errs],
            tol=[f"{t:.2e}" for t in tols], **extra, card=repr(card))
        if not all(e <= t for e, t in zip(errs, tols)):
            raise AssertionError(f"{phase}: {kernel} {name} at {shape} against its plain version "
                                 f"on the step's inputs: {errs}, above {tol}")
        torch.cuda.empty_cache()
    restore_kernel_counts(counts)


def step_busy_ms(trainer, batches) -> float:
    """Device busy ms of one `Trainer` step (profiled over 2, one warm first)."""
    from mp_former_tpu_torch.utils.cuda_timing import busy_ms

    return busy_ms(lambda: trainer.run_step(next(batches)), calls=2)


def phase_train(torch, card: str, phase: str = "train", config: str = CONFIG,
                overrides=(), base: dict = TRAIN_EXPECTED, busy: bool = False) -> dict:
    """Slice 3: the released training recipe at full width and depth (or,
    as phase `train_tpu`, the TPU recipe in float32), the encoder recomputed
    in the backward as the recipes' default says; `busy` also reads the
    device busy ms of a step."""
    import shutil

    from mp_former_tpu_torch.data.synthetic import synthetic_batches
    from mp_former_tpu_torch.engine.trainer import Trainer

    out_dir = os.path.join(REPO, "output", f"chip_smoke_{phase}")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = load_cfg(config, [*TRAIN_OVERRIDES, *overrides, "OUTPUT_DIR", out_dir])
    batches = synthetic_batches(TRAIN_BATCH, TRAIN_SIZE, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
                                TRAIN_MAX_INSTANCES, seed=SEED)
    trainer = Trainer(cfg, batches, model=seeded_model(torch, cfg), device="cuda")
    model, criterion = trainer.model, trainer.criterion
    first = next(batches).to("cuda")

    # step 0 through the kernels and through autograd of the plain ops
    expected = step_expected(base, cfg.TPU.REMAT_ENCODER)
    reset_kernel_counts()
    k_losses, k_grads, assignments = loss_and_gradients(torch, model, criterion, first)
    launches = kernel_counts(backward=True)
    if launches != expected:
        raise AssertionError(f"{phase}: kernel launches of one step {launches}, expected "
                             f"{expected}")
    with plain_ops():
        p_losses, p_grads, _ = loss_and_gradients(torch, model, criterion, first, assignments)
    hold_step(torch, phase, k_losses, k_grads, p_losses, p_grads)
    del k_grads, p_grads
    model.zero_grad(set_to_none=True)

    # the main path: 1 warm step and 3 timed steps through the trainer
    watched = {n: p.detach().clone() for n, p in model.named_parameters()
               if p.requires_grad and n.endswith(("query_feat.weight", "res5.2.conv3.weight",
                                                  "value_proj.weight", "in_proj_weight"))}
    reset_kernel_counts()
    criterion.matcher_host_seconds = 0.0
    torch.cuda.synchronize()
    seconds, metrics = [], None
    for step, batch in zip(range(4), itertools.chain([first], batches)):
        if step == 1:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = trainer.run_step(batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = kernel_counts(backward=True)
    expected = {k: 4 * v for k, v in expected.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    metrics = {k: float(v) for k, v in metrics.items()}
    log(phase, steps=4, launches=launches, expected=expected)
    log(phase, warm_step_s=f"{seconds[0]:.3f}", timed_steps_s=[f"{t:.4f}" for t in seconds[1:]],
        peak_memory_allocated_GiB=f"{peak_gb:.2f}",
        matcher_host_s_per_step=f"{criterion.matcher_host_seconds / 4:.4f}",
        total_loss=f"{metrics['total_loss']:.3f}", lr=trainer.scheduler.get_last_lr()[-1],
        batch=f"{TRAIN_BATCH}x{TRAIN_SIZE}x{TRAIN_SIZE}", card=repr(card))
    if launches != expected:
        raise AssertionError(f"{phase}: kernel launches {launches}, expected {expected}")
    keys = [k + d + s for k in ("loss_ce", "loss_mask", "loss_dice") for d in ("", "_dn")
            for s in ("", *(f"_{i}" for i in range(cfg.MODEL.MASK_FORMER.DEC_LAYERS - 1)))]
    missing = [k for k in (*keys, "total_loss") if k not in metrics]
    if missing or len(metrics) != 61 or not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{phase}: {len(metrics)} loss keys, missing {missing}, or a "
                             "non-finite loss")
    moved = {n: (p.detach() - watched[n]).abs().max().item()
             for n, p in model.named_parameters() if n in watched}
    if not moved or not all(v > 0 for v in moved.values()):
        raise AssertionError(f"{phase}: parameters did not move: {moved}")
    busy_ms = step_busy_ms(trainer, batches) if busy else None
    if busy:
        log(phase, device_busy_ms_per_step=f"{busy_ms:.3f}", card=repr(card))
    log(phase, parameters_watched=len(moved), all_moved=True, ok=True)
    return launches, {"step_s": seconds[1:], "peak_GiB": peak_gb, "busy_ms": busy_ms}


def cosine(a, b) -> float:
    return (a.double().flatten() @ b.double().flatten()
            / (a.double().norm() * b.double().norm()).clamp(min=1e-300)).item()


def phase_train_bf16(torch, card: str, f32: dict, phase: str = "train_bf16",
                     config: str = CONFIG, base: dict = TRAIN_EXPECTED,
                     busy: bool = False) -> dict:
    """The training phase's recipe (`config`), batches and seeded weights with
    `TPU.COMPUTE_DTYPE bfloat16`: step 0 through the kernels against the same
    step through autograd of the plain ops, both bfloat16 (every loss within
    2e-2 of the plain one, relative; the gradient of every parameter whose
    float32 gradient is clear of rounding noise, above 1e-3 of the largest,
    at a cosine of at least 0.99 with the plain one), every launch in
    bfloat16; then 1 warm and 3 timed steps through `Trainer` with parameters,
    gradients and AdamW state float32; s/step and peak memory beside the
    float32 phase's; with `busy` the device busy ms of a step in both."""
    import shutil

    from mp_former_tpu_torch.data.synthetic import synthetic_batches
    from mp_former_tpu_torch.engine.trainer import Trainer

    out_dir = os.path.join(REPO, "output", f"chip_smoke_{phase}")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = load_cfg(config, [*TRAIN_OVERRIDES, "TPU.COMPUTE_DTYPE", "bfloat16",
                            "OUTPUT_DIR", out_dir])
    batches = synthetic_batches(TRAIN_BATCH, TRAIN_SIZE, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
                                TRAIN_MAX_INSTANCES, seed=SEED)
    trainer = Trainer(cfg, batches, model=seeded_model(torch, cfg), device="cuda")
    model, criterion = trainer.model, trainer.criterion
    if model.compute_dtype != torch.bfloat16:
        raise AssertionError(f"{phase}: the model does not read TPU.COMPUTE_DTYPE bfloat16")
    first = next(batches).to("cuda")
    expected = step_expected(base, cfg.TPU.REMAT_ENCODER)

    reset_kernel_counts()
    with launch_types() as seen:
        k_losses, k_grads, assignments = loss_and_gradients(torch, model, criterion, first)
    launches = kernel_counts(backward=True)
    check_bf16_types(phase, seen)
    if launches != expected:
        raise AssertionError(f"{phase}: kernel launches of one step {launches}, expected "
                             f"{expected}")
    with plain_ops():
        p_losses, p_grads, _ = loss_and_gradients(torch, model, criterion, first, assignments)
    model.compute_dtype = torch.float32
    f_losses, f_grads, _ = loss_and_gradients(torch, model, criterion, first, assignments)
    model.compute_dtype = torch.bfloat16
    loss_err = max(abs(k_losses[k] - p_losses[k]) / max(abs(p_losses[k]), 1e-6) for k in p_losses)
    f32_loss_err = max(abs(k_losses[k] - f_losses[k]) / max(abs(f_losses[k]), 1e-6)
                       for k in f_losses)
    if not all(torch.isfinite(g).all() and g.dtype == torch.float32 for g in k_grads.values()):
        raise AssertionError(f"{phase}: non-finite or non-float32 gradients")
    largest = max(g.abs().max().item() for g in f_grads.values())
    clear = [n for n, g in f_grads.items() if g.abs().max().item() > 1e-3 * largest]
    cos_plain = sorted((cosine(k_grads[n], p_grads[n]), n) for n in clear)
    cos_f32 = sorted((cosine(k_grads[n], f_grads[n]), n) for n in clear)
    log(phase, compare="step 0, bf16 kernels vs bf16 autograd of the plain ops",
        losses=len(k_losses), loss_max_rel_err=f"{loss_err:.3e}", loss_tol=2e-2,
        gradients_clear_of_noise=len(clear), gradients=len(f_grads),
        grad_min_cosine=f"{cos_plain[0][0]:.5f}", grad_cosine_tol=0.99,
        worst=[(n, f"{c:.5f}") for c, n in cos_plain[:3]])
    log(phase, compare="step 0, bf16 kernels vs float32 kernels (information)",
        loss_max_rel_err=f"{f32_loss_err:.3e}", grad_min_cosine=f"{cos_f32[0][0]:.5f}",
        worst=[(n, f"{c:.5f}") for c, n in cos_f32[:3]])
    if not (loss_err <= 2e-2 and len(clear) > 100 and cos_plain[0][0] >= 0.99):
        raise AssertionError(f"{phase}: step 0 through the kernels and through the plain ops "
                             f"disagree: losses {loss_err}, gradients {cos_plain[:3]}")
    del k_grads, p_grads, f_grads
    model.zero_grad(set_to_none=True)

    reset_kernel_counts()
    criterion.matcher_host_seconds = 0.0
    torch.cuda.synchronize()
    seconds = []
    with launch_types() as seen:
        for step, batch in zip(range(4), itertools.chain([first], batches)):
            if step == 1:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            metrics = trainer.run_step(batch)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
    launches = kernel_counts(backward=True)
    check_bf16_types(phase, seen)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = {k: 4 * v for k, v in expected.items()}
    log(phase, steps=4, launches=launches, expected=expected)
    log(phase, timed_steps_s_bfloat16=[f"{t:.4f}" for t in seconds[1:]],
        timed_steps_s_float32=[f"{t:.4f}" for t in f32["step_s"]],
        peak_memory_allocated_GiB_bfloat16=f"{peak_gb:.2f}",
        peak_memory_allocated_GiB_float32=f"{f32['peak_GiB']:.2f}",
        total_loss=f"{float(metrics['total_loss']):.3f}",
        batch=f"{TRAIN_BATCH}x{TRAIN_SIZE}x{TRAIN_SIZE}", card=repr(card))
    if launches != expected:
        raise AssertionError(f"{phase}: kernel launches {launches}, expected {expected}")
    if len(metrics) != 61 or not all(np.isfinite(float(v)) for v in metrics.values()):
        raise AssertionError(f"{phase}: loss keys missing or a non-finite loss")
    opt = trainer.optimizer
    state = [t for p in opt.param_groups for q in p["params"] for t in (q, q.grad,
             *opt.state[q].values()) if torch.is_tensor(t) and t.is_floating_point()]
    if not all(t.dtype == torch.float32 for t in state):
        raise AssertionError(f"{phase}: parameters, gradients or AdamW state not float32")
    if busy:
        log(phase, device_busy_ms_per_step_bfloat16=f"{step_busy_ms(trainer, batches):.3f}",
            device_busy_ms_per_step_float32=f"{f32['busy_ms']:.3f}", card=repr(card))
    log(phase, float32_parameters_gradients_adamw_state=len(state), ok=True)
    return launches


COCO_ROOT = os.path.join(REPO, "output", "chip_smoke_coco")
COCO_TRAIN_IMAGES, COCO_VAL_IMAGES, COCO_CLASSES = 64, 8, 20
COCO_STEPS, COCO_EVAL_PERIOD, COCO_CHECKPOINT_PERIOD = 12, 6, 3
COCO_EVAL_EXPECTED = {"msda_fwd": 6, "tap_weight_fwd": 0, "masked_attn_fwd": 9, "msda_bwd": 0,
                      "masked_attn_bwd": 0, "tap_weight_bwd": 0}


def uncompressed_rle(mask) -> dict:
    """(H, W) bool -> COCO's uncompressed RLE (column-major runs, background
    first)."""
    flat = mask.T.reshape(-1).astype(np.uint8)
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    return {"size": list(mask.shape), "counts": ([0] if flat[0] else []) + runs}


def write_coco(root: str) -> dict:
    """The phase's dataset; every 5th annotation's polygons become
    uncompressed RLE and every 11th (from the 4th) a crowd annotation, so that
    every branch of the mapper and the evaluator runs. The same images also in
    the COCO panoptic layout (`--panoptic`: id maps, semantic maps, json) for
    phases eval_panoptic and train_panoptic."""
    from mp_former_tpu_torch.native import polygons_to_mask
    from tools.make_synthetic_coco_torch import write_dataset

    counts = {}
    for split, n, size, seed in (("train2017", COCO_TRAIN_IMAGES, 640, SEED),
                                 ("val2017", COCO_VAL_IMAGES, 480, SEED + 1)):
        path = write_dataset(root, n, size, COCO_CLASSES, split, seed, panoptic=True)
        with open(path) as f:
            data = json.load(f)
        for k, a in enumerate(data["annotations"]):
            if k % 5 == 1:
                a["segmentation"] = uncompressed_rle(polygons_to_mask(a["segmentation"], size, size))
            elif k % 11 == 3:
                a["iscrowd"] = 1
        with open(path, "w") as f:
            json.dump(data, f)
        kinds = [("rle" if isinstance(a["segmentation"], dict) else "polygon")
                 + ("_crowd" if a["iscrowd"] else "") for a in data["annotations"]]
        counts[split] = {k: kinds.count(k) for k in sorted(set(kinds))}
    return counts


def copy_ms(torch, batch, non_blocking: bool, reps: int = 5) -> float:
    """Median host time of one batch copy to the card, synchronised."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch.to("cuda", non_blocking=non_blocking)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


# an attention decision the plain ops take otherwise than the kernels must sit
# on a mask logit within this of 0 (the logits' limit of `compare_outputs`)
ATTN_FLIP_MARGIN = 1e-3


class PairedAttention:
    """The decoder's attention masks of a run through the kernels, kept, and
    handed to a later run through the plain ops. The decoder's attention mask
    thresholds mask logits (sigmoid < 0.5): a logit that the two paths put on
    either side of 0 changes the keys a query reads, and the outputs after
    it by more than the kernels' error; with trained weights, or many
    queries, such a logit turns up now and then. `flips` counts the
    attention decisions the plain ops take otherwise, `margin` is the
    largest |mask logit| among them."""

    def __init__(self, model):
        self.decoder = model.sem_seg_head.predictor
        self.heads = self.decoder.forward_prediction_heads
        self.kept, self.flips, self.margin = [], 0, 0.0

    def _record(self, output, mask_features, size, *extra):
        out = self.heads(output, mask_features, size, *extra)
        self.kept.append(out[2])
        return out

    def _replay(self, output, mask_features, size, *extra):
        from mp_former_tpu_torch.utils.interp import resize

        cls, msk, attn = self.heads(output, mask_features, size, *extra)
        k_attn = self.kept.pop(0)
        differ = attn != k_attn
        if differ.any():
            logits = resize(msk.detach().float(), size, "bilinear").flatten(2)
            self.flips += int(differ.sum())
            self.margin = max(self.margin, logits[differ].abs().max().item())
        return cls, msk, k_attn

    def recording(self):
        return mock.patch.object(self.decoder, "forward_prediction_heads", self._record)

    def replaying(self):
        return mock.patch.object(self.decoder, "forward_prediction_heads", self._replay)


# a ReLU input that the two paths put on either side of 0 flips its
# derivative, and the gradients behind it by more than the kernels' error
# (R50's step at B = 8 found one at 1.7e-3 of an FFN's largest gradient; the
# Swin-L step's 200 queries and 2048-wide FFNs at 6.7e-2); the forwards
# differ by ~1e-5 of entries of unit scale, so a decision taken otherwise
# must sit within this of 0
RELU_FLIP_MARGIN = 1e-3


class PairedRelu:
    """The ReLU decisions (input > 0) of the decoder's and the pixel
    decoder's layers (`F.relu` in `transformer_decoder/primitives.py` and
    `pixel_decoder/msdeformattn.py`) in a run through the kernels, kept, and
    taken by a later run through the plain ops (its ReLU is then x times the
    kept decision, whose derivative is the kernel path's). `flips` and
    `margin` as in `PairedAttention`."""

    def __init__(self):
        self.kept, self.flips, self.margin = [], 0, 0.0

    def _record(self, x, inplace=False):
        import torch.nn.functional as F

        self.kept.append(x.detach() > 0)
        return F.relu(x, inplace=inplace)

    def _replay(self, x, inplace=False):
        kept = self.kept.pop(0)
        differ = (x.detach() > 0) != kept
        if differ.any():
            self.flips += int(differ.sum())
            self.margin = max(self.margin, x.detach()[differ].abs().max().item())
        return x * kept.to(x.dtype)

    @contextlib.contextmanager
    def _patched(self, relu):
        import torch.nn.functional as F

        from mp_former_tpu_torch.models.pixel_decoder import msdeformattn
        from mp_former_tpu_torch.models.transformer_decoder import primitives

        class Functional:
            """torch.nn.functional with another relu."""

            def __getattr__(self, name):
                return relu if name == "relu" else getattr(F, name)

        with mock.patch.object(primitives, "F", Functional()), \
                mock.patch.object(msdeformattn, "F", Functional()):
            yield

    def recording(self):
        return self._patched(self._record)

    def replaying(self):
        return self._patched(self._replay)


def paired_outputs(torch, model, canvas) -> tuple:
    """The model's outputs through the kernels, and through the plain ops
    given the kernel path's attention masks (`PairedAttention`). Returns
    (kernel outputs, plain outputs, the count of attention decisions the
    plain ops take otherwise, the largest |mask logit| among them)."""
    pairing = PairedAttention(model)
    with torch.inference_mode():
        with pairing.recording():
            k_out = model(canvas)
        with plain_ops(), pairing.replaying():
            p_out = model(canvas)
    return k_out, p_out, pairing.flips, pairing.margin


def hold_evaluation(torch, cfg, model, kernel_segm: dict) -> dict:
    """The evaluation's shapes held against the plain ops: the val images'
    800x800 canvas gives K1 Q = S = 13125 and K3 S = 625 / 2500 / 10000,
    which phases K1 and K3 do not run. For each val image, the model's
    outputs through the kernels against the plain ops given the same
    attention masks (`paired_outputs`, `compare_outputs`; an attention
    decision the plain ops take otherwise sits within ATTN_FLIP_MARGIN of 0),
    and the `Predictor`'s instances: sorted scores within 1e-3, and over the
    detections that keep their rank, class and score (within 1e-4) the masks'
    pooled IoU at least 0.99. Then the plain path's instances scored by the
    evaluator against the last `Trainer.test` (the same weights): segm AP
    within 0.01."""
    from mp_former_tpu_torch.data.catalog import DatasetCatalog
    from mp_former_tpu_torch.engine.eval_loop import read_image
    from mp_former_tpu_torch.engine.predictor import Predictor
    from mp_former_tpu_torch.evaluation.build import build_evaluator

    records = DatasetCatalog.get("coco_2017_val")[:COCO_VAL_IMAGES]
    predictor = Predictor(cfg, model=model, device="cuda")
    evset = build_evaluator(cfg, "coco_2017_val", records)
    evset.reset()
    score_err, inter, union, kept = 0.0, 0, 0, 0
    for rec in records:
        image = read_image(rec)
        canvas, _ = predictor.preprocess(image)
        k_out, p_out, n_flips, margin = paired_outputs(torch, model, canvas)
        what = f"val image {rec['image_id']}: kernel vs plain ops"
        log("train_coco", compare=what, attention_decisions_taken_otherwise=n_flips,
            their_largest_abs_mask_logit=f"{margin:.3e}", margin=ATTN_FLIP_MARGIN)
        if margin > ATTN_FLIP_MARGIN:
            raise AssertionError(f"train_coco: {what}: an attention decision differs at a mask "
                                 f"logit of {margin}")
        compare_outputs(torch, "train_coco", what, cfg, canvas, k_out, p_out)
        hw = (rec["height"], rec["width"])
        k = predictor(image, hw)["instances"]
        with plain_ops():
            p = predictor(image, hw)["instances"]
        evset.process(rec, {"instance": (p["scores"], p["classes"], p["masks"])})
        score_err = max(score_err, float(np.abs(np.sort(k["scores"]) - np.sort(p["scores"])).max()))
        same = (k["classes"] == p["classes"]) & (np.abs(k["scores"] - p["scores"]) < 1e-4)
        inter += int((k["masks"][same] & p["masks"][same]).sum())
        union += int((k["masks"][same] | p["masks"][same]).sum())
        kept += int(same.sum())
    plain_segm = evset.evaluate()["segm"]
    iou = inter / union if union else 1.0  # all kept masks empty on both sides: the same
    log("train_coco", compare="evaluation, kernel vs plain ops", images=len(records),
        canvas=tuple(canvas.shape[1:3]), sorted_scores_max_abs_err=f"{score_err:.3e}",
        scores_tol=1e-3, detections_kept=kept, mask_pixels_union=union,
        masks_pooled_iou=f"{iou:.6f}", iou_min=0.99,
        kernel_AP=f"{kernel_segm['AP']:.4f}", plain_AP=f"{plain_segm['AP']:.4f}", ap_tol=0.01)
    if not (score_err < 1e-3 and kept > 0 and iou >= 0.99
            and abs(kernel_segm["AP"] - plain_segm["AP"]) <= 0.01):
        raise AssertionError("train_coco: the evaluation disagrees between the kernels and the "
                             "plain ops")
    return {"scores_err": score_err, "masks_iou": iou, "plain_segm": plain_segm}


def phase_train_coco(torch, card: str) -> dict:
    """Slice 3, the rest: a training run from a COCO-format dataset on disk,
    scored by `Trainer.test` every COCO_EVAL_PERIOD steps."""
    import shutil

    from mp_former_tpu_torch.data.catalog import MetadataCatalog
    from mp_former_tpu_torch.data.datasets.coco import register_all_coco
    from mp_former_tpu_torch.data.datasets.register_all import register_all_coco_panoptic
    from mp_former_tpu_torch.data.loader import build_train_loader
    from mp_former_tpu_torch.data.synthetic import synthetic_batch
    from mp_former_tpu_torch.engine.trainer import Trainer
    from mp_former_tpu_torch.structures import Batch, Targets

    out_dir = os.path.join(REPO, "output", "chip_smoke_train_coco")
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.rmtree(COCO_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    kinds = write_coco(COCO_ROOT)
    log("train_coco", dataset=os.path.relpath(COCO_ROOT, REPO), annotations=kinds,
        write_s=f"{time.perf_counter() - t0:.2f}")
    # the names under this root, before anything imports the builtin
    # registrations (which would register them under $DETECTRON2_DATASETS)
    register_all_coco(COCO_ROOT)
    register_all_coco_panoptic(COCO_ROOT)
    for name in ("coco_2017_train", "coco_2017_val", "coco_2017_train_panoptic",
                 "coco_2017_val_panoptic_with_sem_seg"):
        meta = MetadataCatalog.get(name)
        if not (meta.get("json_file") or meta.get("panoptic_json")).startswith(COCO_ROOT):
            raise AssertionError(f"train_coco: {name} is registered elsewhere: {vars(meta)}")
    cfg = load_cfg(CONFIG, [*TRAIN_OVERRIDES, "INPUT.IMAGE_SIZE", str(TRAIN_SIZE),
                            "SOLVER.MAX_ITER", str(COCO_STEPS),
                            "SOLVER.CHECKPOINT_PERIOD", str(COCO_CHECKPOINT_PERIOD),
                            "TEST.EVAL_PERIOD", str(COCO_EVAL_PERIOD), "OUTPUT_DIR", out_dir])
    cfg.defrost()
    cfg.TEST.MAX_EVAL_IMAGES = COCO_VAL_IMAGES  # read as the JAX trainer reads it: TEST.get
    cfg.freeze()
    if (cfg.INPUT.DATASET_MAPPER_NAME, cfg.TPU.MAX_INSTANCES, cfg.DATASETS.TRAIN,
            cfg.DATASETS.TEST) != ("coco_instance_lsj", 100, ("coco_2017_train",),
                                   ("coco_2017_val",)):
        raise AssertionError("train_coco: the recipe's data settings changed")
    trainer = Trainer(cfg, model=seeded_model(torch, cfg), device="cuda")

    step_s, shapes = [], []
    run_step = trainer.run_step

    def timed_step(batch):
        if not shapes:
            shapes.append({"images": (tuple(batch.images.shape), str(batch.images.dtype),
                                      batch.images.is_pinned()),
                           "masks": (tuple(batch.targets.masks.shape),
                                     str(batch.targets.masks.dtype))})
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_step(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    results, eval_s, eval_launches = [], [], {k: 0 for k in COCO_EVAL_EXPECTED}
    test = trainer.test

    def timed_test(max_images=None):
        before = kernel_counts(backward=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        results.append(test(max_images))
        torch.cuda.synchronize()
        eval_s.append(time.perf_counter() - t)
        for k, v in kernel_counts(backward=True).items():
            eval_launches[k] += v - before[k]
        return results[-1]

    trainer.run_step, trainer.test = timed_step, timed_test
    # the main path, counted
    reset_kernel_counts()
    t0 = time.perf_counter()
    trainer.train()
    total_s = time.perf_counter() - t0
    launches = kernel_counts(backward=True)
    train_launches = {k: launches[k] - eval_launches[k] for k in launches}
    n_eval = COCO_VAL_IMAGES * len(results)
    expected_train = {k: COCO_STEPS * v
                      for k, v in step_expected(TRAIN_EXPECTED, cfg.TPU.REMAT_ENCODER).items()}
    expected_eval = {k: n_eval * v for k, v in COCO_EVAL_EXPECTED.items()}
    log("train_coco", steps=COCO_STEPS, train_launches=train_launches, expected=expected_train)
    log("train_coco", evaluations=len(results), images=n_eval, eval_launches=eval_launches,
        expected=expected_eval)
    if train_launches != expected_train or eval_launches != expected_eval or len(results) != 2:
        raise AssertionError(f"train_coco: launches {train_launches} / {eval_launches} over "
                             f"{len(results)} evaluations, expected {expected_train} / "
                             f"{expected_eval} over 2")
    want_shapes = {"images": ((TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3), "torch.uint8", True),
                   "masks": ((TRAIN_BATCH, 100, TRAIN_SIZE // 4, TRAIN_SIZE // 4), "torch.bool")}
    if shapes[0] != want_shapes:
        raise AssertionError(f"train_coco: loader batch {shapes[0]}, expected {want_shapes}")

    with open(os.path.join(out_dir, "metrics.json")) as f:
        lines = [json.loads(x) for x in f.read().splitlines()]
    keys = [k + d + s for k in ("loss_ce", "loss_mask", "loss_dice") for d in ("", "_dn")
            for s in ("", *(f"_{i}" for i in range(cfg.MODEL.MASK_FORMER.DEC_LAYERS - 1)))]
    for line in lines:
        losses = {k: v for k, v in line.items() if k.startswith("loss_") or k == "total_loss"}
        missing = [k for k in (*keys, "total_loss") if k not in losses]
        if missing or len(losses) != 61 or not all(np.isfinite(v) for v in line.values()) \
                or "data_time" not in line:
            raise AssertionError(f"train_coco: metrics line {line.get('iteration')}: "
                                 f"{len(losses)} loss keys, missing {missing}, data_time "
                                 f"{line.get('data_time')}, or a non-finite value")
    if [x["iteration"] for x in lines] != [0, COCO_STEPS - 1]:
        raise AssertionError(f"train_coco: metrics lines {[x['iteration'] for x in lines]}")
    aps = [r["segm"]["AP"] for r in results]
    if not all(np.isfinite(aps)):
        raise AssertionError(f"train_coco: segm AP {aps}")
    ckpts = sorted(f for f in os.listdir(os.path.join(out_dir, "checkpoints"))
                   if f.endswith(".pth"))
    if len(ckpts) > 3 or ckpts[-1] != f"model_{COCO_STEPS:07d}.pth":
        raise AssertionError(f"train_coco: checkpoints {ckpts}")
    hold_evaluation(torch, cfg, trainer.model, results[-1]["segm"])

    # the batch copy: a loader batch pinned and pageable, and phase train's batch
    loader = build_train_loader(cfg, pin_memory=True)
    try:
        pinned = next(loader)
    finally:
        loader.close()
    pageable = Batch(pinned.images.clone(), Targets(*(t.clone() for t in pinned.targets)))
    if pageable.images.is_pinned() or not pinned.images.is_pinned():
        raise AssertionError("train_coco: the copy comparison lost its pinned/pageable split")
    generated = synthetic_batch(np.random.RandomState(SEED), TRAIN_BATCH, TRAIN_SIZE,
                                COCO_CLASSES, TRAIN_MAX_INSTANCES)
    copies = {"pinned_ms": copy_ms(torch, pinned, True),
              "pageable_ms": copy_ms(torch, pageable, False),
              "generated_pageable_ms": copy_ms(torch, generated, False)}
    mb = {"loader_batch_MB": nbytes(pinned.images, *pinned.targets) / 1e6,
          "generated_batch_MB": nbytes(generated.images, *generated.targets) / 1e6}

    first_data, last = lines[0]["data_time"], lines[-1]
    steady_data = (last["data_time"] * COCO_STEPS - first_data) / (COCO_STEPS - 1)
    res = {"s_per_step": mean(step_s[1:]), "first_step_s": step_s[0],
           "data_time_s": last["data_time"], "data_time_first_s": first_data,
           "data_time_steady_s": steady_data, **copies, **mb,
           "eval_s_per_image": [t / COCO_VAL_IMAGES for t in eval_s], "segm_AP": aps,
           "wall_s": total_s}
    log("train_coco", s_per_step=f"{res['s_per_step']:.4f}",
        steps_s=[f"{t:.4f}" for t in step_s], card=repr(card))
    log("train_coco", data_time_s=f"{last['data_time']:.4f}", first_step_data_s=f"{first_data:.4f}",
        data_time_after_first_s=f"{steady_data:.4f}", card=repr(card))
    log("train_coco", batch_copy_pinned_ms=f"{copies['pinned_ms']:.3f}",
        batch_copy_pageable_ms=f"{copies['pageable_ms']:.3f}",
        loader_batch_MB=f"{mb['loader_batch_MB']:.1f}",
        generated_batch_pageable_ms=f"{copies['generated_pageable_ms']:.3f}",
        generated_batch_MB=f"{mb['generated_batch_MB']:.1f}", card=repr(card))
    log("train_coco", eval_s_per_image=[f"{t:.4f}" for t in res["eval_s_per_image"]],
        segm_AP=[f"{a:.4f}" for a in aps], checkpoints=ckpts, train_wall_s=f"{total_s:.2f}",
        card=repr(card))
    log("train_coco", ok=True)
    return train_launches


ACCUM = 2
# remat on against off: the forward is the same operations on the same inputs
# (the model's outputs bitwise equal); the class losses differ in their last
# bits, as two runs of the same step do (CUDA's cross-entropy reduction adds
# in no fixed order), 1e-6 relative; the gradients by the order of the
# float32 atomic adds of K1's backward and of the point sampling's
# grid_sample backward (each call its own), 1e-5 of each parameter's largest
# gradient entry. In bfloat16 those orders flip roundings of the bfloat16
# gradients now and then: two runs of the same step without remat differ by
# up to 8.9e-3 of an entry and 8.8e-4 in the L2 norm of all gradients, the
# same with cuDNN's algorithms fixed (an H100, PERF.md), while a recompute
# wrong by one bfloat16 step (REMAT_CONTROL_STEP, phase remat's control)
# reads 2.9e-2 to 3.2e-2 and 7.5e-3: the limits lie between.
REMAT_LOSS_TOL = 1e-6
REMAT_GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
REMAT_L2_TOL = 3e-3
REMAT_CONTROL_STEP = 2.0 ** -7
# the bs16@1024 phases: the released batch at the recipes' LSJ size
BS16, BS16_SIZE = 16, 1024
BS16_STEPS, TRAIN_NET_STEPS, TRAIN_NET_EVAL_IMAGES = 2, 3, 4
# the step whose kernel launches are held against the plain versions at
# their own shapes (`hold_recorded`); the peak memory is read over the steps
# after it. The released recipe's is the second, after an update has moved
# the sampling offsets off the pixel grid they start on (at a location on a
# pixel edge the kernel and the plain version may round to neighbouring
# cells, whose location gradients differ); the TPU recipe's kernels take no
# locations: its first
TRAIN_NET_HOLD_STEP, BS16_HOLD_STEP = 1, 0
TRAIN_NET_ACCUMS = (2, 1)
# run_50ep_no_noise_all_ly.sh's overrides of the released config
RELEASED_SH = ["MODEL.DN.NUM_DN", "1", "MODEL.DN.NOISE_SCALE", "0.0",
               "MODEL.MASK_FORMER.DN_MODE", "points", "MODEL.MASK_FORMER.ALL_LY_DN", "True",
               "MODEL.MASK_FORMER.LB_NOISE_RATIO", "0.2",
               "MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME",
               "MultiScaleMaskedTransformerDecoderMaskDN"]


def phase_accum(torch, card: str) -> dict:
    """`TPU.GRAD_ACCUM_STEPS 2` on phase train's recipe, batch and weights:
    step 0 (two micro-batches of 4) through the kernels against the plain
    ops at phase train's tolerances, the launches of the accumulated step
    counted; then the same batch with accum 1 and 2 where nothing is drawn
    (no label noise, importance ratio 1) and every image keeps as many
    instances as the fewest has, so that the micro-batches carry equal
    no-object weight: every loss term within 1e-4, relative."""
    from mp_former_tpu_torch.data.synthetic import synthetic_batches
    from mp_former_tpu_torch.engine.trainer import Trainer
    from mp_former_tpu_torch.structures import Batch

    out_dir = os.path.join(REPO, "output", "chip_smoke_accum")
    cfg = load_cfg(CONFIG, [*TRAIN_OVERRIDES, "TPU.GRAD_ACCUM_STEPS", str(ACCUM),
                            "OUTPUT_DIR", out_dir])
    batches = synthetic_batches(TRAIN_BATCH, TRAIN_SIZE, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
                                TRAIN_MAX_INSTANCES, seed=SEED)
    trainer = Trainer(cfg, batches, model=seeded_model(torch, cfg), device="cuda")
    model, criterion = trainer.model, trainer.criterion
    first = next(batches).to("cuda")
    expected = step_expected(TRAIN_EXPECTED, cfg.TPU.REMAT_ENCODER, ACCUM)
    reset_kernel_counts()
    k_losses, k_grads, assignments = loss_and_gradients(torch, model, criterion, first,
                                                        accum=ACCUM)
    launches = kernel_counts(backward=True)
    log("accum", accum=ACCUM, launches=launches, expected=expected)
    if launches != expected or len(assignments) != ACCUM:
        raise AssertionError(f"accum: kernel launches of one step {launches}, expected "
                             f"{expected}; {len(assignments)} matcher calls")
    with plain_ops():
        p_losses, p_grads, _ = loss_and_gradients(torch, model, criterion, first, assignments,
                                                  accum=ACCUM)
    hold_step(torch, "accum", k_losses, k_grads, p_losses, p_grads)
    del k_grads, p_grads, trainer, model

    # accum 1 against 2 on the same batch, nothing drawn, equal no-object weight
    from mp_former_tpu_torch.models.criterion import build_criterion

    cfg0 = load_cfg(CONFIG, [*TRAIN_OVERRIDES, "MODEL.MASK_FORMER.LB_NOISE_RATIO", "0.0",
                             "MODEL.MASK_FORMER.IMPORTANCE_SAMPLE_RATIO", "1.0",
                             "OUTPUT_DIR", out_dir])
    model0 = seeded_model(torch, cfg0).to("cuda")
    crit0 = build_criterion(cfg0)
    n = int(first.targets.valid.sum(-1).min())
    valid = first.targets.valid.clone()
    valid[:, n:] = False
    even = Batch(first.images, first.targets._replace(valid=valid))
    acc, acc_grads, parts = loss_and_gradients(torch, model0, crit0, even, accum=ACCUM)
    whole = torch.empty((parts[0].shape[0], TRAIN_BATCH, parts[0].shape[2]),
                        dtype=parts[0].dtype, device=parts[0].device)
    for k, part in enumerate(parts):
        whole[:, k::ACCUM] = part  # micro-batch k holds rows k, k + accum, ...
    mono, mono_grads, _ = loss_and_gradients(torch, model0, crit0, even, [whole])
    errs = {k: abs(acc[k] - mono[k]) / max(abs(mono[k]), 1e-6) for k in mono}
    kinds = {kind: max(e for k, e in errs.items() if k.startswith(kind))
             for kind in ("loss_ce", "loss_mask", "loss_dice")}
    grad_err = max(rel_err(acc_grads[k], mono_grads[k]) for k in mono_grads)
    log("accum", compare=f"accum {ACCUM} vs 1, same batch and assignments, nothing drawn",
        instances_per_image=n, losses=len(errs),
        **{f"{k}_max_rel_err": f"{v:.3e}" for k, v in kinds.items()}, loss_tol=1e-4,
        grad_max_rel_err_information=f"{grad_err:.3e}")
    if max(kinds.values()) > 1e-4:
        raise AssertionError(f"accum: accumulated losses against the monolithic step: {kinds}")
    log("accum", ok=True)
    return launches


def phase_remat(torch, card: str) -> dict:
    """`TPU.REMAT_ENCODER` on against off on phase train's recipe, batch and
    weights (B = 8, 512x512): step 0's model outputs bitwise equal, losses
    within REMAT_LOSS_TOL, gradients within REMAT_GRAD_TOL, the launches of
    both counted; peak memory and device busy ms of a `Trainer` step in
    both; then in bfloat16 with `TPU.REMAT_POLICY dots`, every launch (the
    recompute's too) in bfloat16, the gradients within REMAT_GRAD_TOL and
    REMAT_L2_TOL, beside the spread of two runs without remat and a
    recompute wrong by one bfloat16 step, which must fail them; both as the
    card chooses cuDNN's algorithms and with them fixed."""
    from mp_former_tpu_torch.data.synthetic import synthetic_batches
    from mp_former_tpu_torch.engine.trainer import Trainer

    out_dir = os.path.join(REPO, "output", "chip_smoke_remat")
    cfg = load_cfg(CONFIG, [*TRAIN_OVERRIDES, "OUTPUT_DIR", out_dir])
    if not cfg.TPU.REMAT_ENCODER or cfg.TPU.REMAT_POLICY != "full":
        raise AssertionError("remat: the recipe's default is no longer REMAT_ENCODER True, full")
    batches = synthetic_batches(TRAIN_BATCH, TRAIN_SIZE, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
                                TRAIN_MAX_INSTANCES, seed=SEED)
    trainer = Trainer(cfg, batches, model=seeded_model(torch, cfg), device="cuda")
    model, criterion = trainer.model, trainer.criterion
    encoder = model.sem_seg_head.pixel_decoder.transformer
    first = next(batches).to("cuda")
    outputs = []

    def step0(remat: bool, assignments=None):
        encoder.remat = remat
        del outputs[:]
        hook = model.register_forward_hook(lambda m, args, out: outputs.append(
            [out["pred_logits"].detach().clone(), out["pred_masks"].detach().clone()]))
        reset_kernel_counts()
        try:
            losses, grads, solved = loss_and_gradients(torch, model, criterion, first, assignments)
        finally:
            hook.remove()
        launches = kernel_counts(backward=True)
        want = step_expected(TRAIN_EXPECTED, remat)
        if launches != want:
            raise AssertionError(f"remat {remat}: kernel launches of one step {launches}, "
                                 f"expected {want}")
        return losses, grads, solved, outputs[0], launches

    def compare(what, on, off, tol):
        same_out = all(torch.equal(a, b) for a, b in zip(on[3], off[3]))
        loss_err = max(abs(on[0][k] - v) / max(abs(v), 1e-6) for k, v in off[0].items())
        errs = sorted(((rel_err(on[1][k], off[1][k]), k) for k in off[1]), reverse=True)
        grad_err = errs[0][0]
        log("remat", compare=what, outputs_bitwise_equal=same_out,
            loss_max_rel_err=f"{loss_err:.3e}", loss_tol=REMAT_LOSS_TOL,
            gradients=len(off[1]), grad_max_rel_err=f"{grad_err:.3e}", grad_tol=tol,
            worst=[(k, f"{e:.2e}") for e, k in errs[:3]],
            launches_on=on[4], launches_off=off[4])
        if not (same_out and on[0].keys() == off[0].keys() and loss_err <= REMAT_LOSS_TOL
                and on[1].keys() == off[1].keys() and grad_err <= tol):
            raise AssertionError(f"remat: {what}: outputs equal {same_out}, losses {loss_err}, "
                                 f"gradients {grad_err}")

    on = step0(True)
    off = step0(False, on[2])
    compare("float32, full, step 0", on, off, REMAT_GRAD_TOL["float32"])
    res = {"launches": on[4]}
    del on, off
    model.zero_grad(set_to_none=True)
    for remat in (True, False):
        encoder.remat = remat
        torch.cuda.reset_peak_memory_stats()
        busy = step_busy_ms(trainer, batches)
        res[remat] = {"busy_ms": busy, "peak_GiB": torch.cuda.max_memory_allocated() / 2 ** 30}
    log("remat", dtype="float32", busy_ms_remat_on=f"{res[True]['busy_ms']:.3f}",
        busy_ms_remat_off=f"{res[False]['busy_ms']:.3f}",
        peak_GiB_remat_on=f"{res[True]['peak_GiB']:.2f}",
        peak_GiB_remat_off=f"{res[False]['peak_GiB']:.2f}",
        batch=f"{TRAIN_BATCH}x{TRAIN_SIZE}x{TRAIN_SIZE}", card=repr(card))

    # bfloat16, REMAT_POLICY dots (the JAX package's dots_saveable)
    model.compute_dtype = torch.bfloat16
    encoder.remat_policy = "dots"
    with launch_types() as seen:
        on = step0(True)
        off = step0(False, on[2])
    check_bf16_types("remat", seen)
    # what the comparison must tell apart: two runs of the same step without
    # remat (the spread), and a recompute that is wrong by one bfloat16 step
    # (the control), as the card runs them and with cuDNN's algorithms fixed
    again = step0(False, on[2])
    with wrong_recompute(torch, encoder, REMAT_CONTROL_STEP):
        bad = step0(True, on[2])
    with fixed_cudnn(torch):
        on_d, off_d, again_d = (step0(r, on[2]) for r in (True, False, False))
        with wrong_recompute(torch, encoder, REMAT_CONTROL_STEP):
            bad_d = step0(True, on[2])
    readings = {}
    for setting, (a, b, c, d) in (("as_chosen", (on, off, again, bad)),
                                  ("cudnn_fixed", (on_d, off_d, again_d, bad_d))):
        for what, x, y in (("remat", a, b), ("spread", c, b), ("control", d, b)):
            readings[f"{setting}_{what}"] = grad_errs(torch, x[1], y[1])
    log("remat", dtype="bfloat16", policy="dots",
        control=f"each encoder layer's input x (1 + {REMAT_CONTROL_STEP:.4g}) in the recompute",
        **{k: "max_rel={:.3e} l2_rel={:.3e}".format(*v) for k, v in readings.items()},
        tol=REMAT_GRAD_TOL["bfloat16"], l2_tol=REMAT_L2_TOL, card=repr(card))
    compare("bfloat16, dots, step 0", on, off, REMAT_GRAD_TOL["bfloat16"])
    for setting in ("as_chosen", "cudnn_fixed"):
        max_rel, l2 = readings[f"{setting}_remat"]
        c_max, c_l2 = readings[f"{setting}_control"]
        if not (max_rel <= REMAT_GRAD_TOL["bfloat16"] and l2 <= REMAT_L2_TOL):
            raise AssertionError(f"remat: bfloat16 {setting}: gradients {max_rel}, {l2} (L2)")
        if c_max <= REMAT_GRAD_TOL["bfloat16"] and c_l2 <= REMAT_L2_TOL:
            raise AssertionError(f"remat: bfloat16 {setting}: the wrong recompute passes the "
                                 f"check ({c_max}, {c_l2} (L2))")
    log("remat", ok=True)
    return res["launches"]


def grad_errs(torch, got: dict, want: dict) -> tuple:
    """(the largest over parameters of max |got - want| relative to want's
    largest entry, the L2 norm of all differences over that of all of want)."""
    diff = sum(float((got[k].float() - want[k].float()).pow(2).sum()) for k in want)
    norm = sum(float(want[k].float().pow(2).sum()) for k in want)
    return max(rel_err(got[k], want[k]) for k in want), math.sqrt(diff / norm)


@contextlib.contextmanager
def fixed_cudnn(torch):
    """cuDNN's deterministic algorithms, chosen without benchmarking."""
    was = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = False, True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = was


@contextlib.contextmanager
def wrong_recompute(torch, encoder, step: float):
    """The encoder's recompute made wrong on purpose: each layer's input
    times (1 + step) while the checkpoint recomputes it, and only then (the
    forward is untouched, the recomputed activations are of the same shapes
    and types)."""
    base = encoder._remat_context().get("context_fn")
    recomputing = [False]

    @contextlib.contextmanager
    def flagged(ctx):
        with ctx:
            recomputing[0] = True
            try:
                yield
            finally:
                recomputing[0] = False

    def context_fn():
        fwd, rec = base() if base else (contextlib.nullcontext(), contextlib.nullcontext())
        return fwd, flagged(rec)

    def off_by_a_step(module, args):
        if recomputing[0]:
            return ((args[0].float() * (1.0 + step)).to(args[0].dtype), *args[1:])
        return None

    hooks = [layer.register_forward_pre_hook(off_by_a_step) for layer in encoder.encoder.layers]
    try:
        with mock.patch.object(encoder, "_remat_context", lambda: {"context_fn": context_fn}):
            yield
    finally:
        for h in hooks:
            h.remove()


def phase_train_tpu_bs16(torch, card: str) -> dict:
    """The TPU recipe as its YAML says (bfloat16, head-shared sampling
    through K2, REMAT_ENCODER True) at the released batch, 16 images of
    1024x1024 from the seeded generator, with phase train's DN overrides:
    BS16_STEPS steps through `Trainer`, K2 36 and K2 backward 18 launches a
    step; step BS16_HOLD_STEP keeps one launch of each kernel at each of
    its shapes, held against the plain versions after the step
    (`hold_recorded`); s/step, and the peak memory of the steps after it."""
    from mp_former_tpu_torch.data.synthetic import synthetic_batches
    from mp_former_tpu_torch.engine.trainer import Trainer

    out_dir = os.path.join(REPO, "output", "chip_smoke_train_tpu_bs16")
    cfg = load_cfg(TPU_CONFIG, [*TRAIN_OVERRIDES, "SOLVER.IMS_PER_BATCH", str(BS16),
                                "INPUT.IMAGE_SIZE", str(BS16_SIZE), "OUTPUT_DIR", out_dir])
    if (cfg.TPU.COMPUTE_DTYPE, cfg.TPU.SAMPLING_ENGINE, cfg.TPU.REMAT_ENCODER) != (
            "bfloat16", "headshare", True):
        raise AssertionError("train_tpu_bs16: the TPU recipe's YAML changed")
    batches = synthetic_batches(BS16, BS16_SIZE, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
                                TRAIN_MAX_INSTANCES, seed=SEED)
    trainer = Trainer(cfg, batches, model=seeded_model(torch, cfg), device="cuda")
    torch.cuda.synchronize()
    reset_kernel_counts()
    seconds = []
    for step, batch in enumerate(itertools.islice(batches, BS16_STEPS)):
        t0 = time.perf_counter()
        with recording_launches() if step == BS16_HOLD_STEP else contextlib.nullcontext() as kept:
            metrics = trainer.run_step(batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if step == BS16_HOLD_STEP:
            hold_recorded(torch, "train_tpu_bs16", kept, card)
            del kept
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    launches = kernel_counts(backward=True)
    expected = {k: BS16_STEPS * v for k, v in step_expected(TRAIN_TPU_EXPECTED, True).items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log("train_tpu_bs16", steps=BS16_STEPS, launches=launches, expected=expected)
    log("train_tpu_bs16", steps_s=[f"{t:.4f}" for t in seconds], held_step=BS16_HOLD_STEP,
        peak_memory_allocated_GiB_after_the_hold=f"{peak_gb:.2f}",
        total_loss=f"{float(metrics['total_loss']):.3f}",
        batch=f"{BS16}x{BS16_SIZE}x{BS16_SIZE}", card=repr(card))
    if launches != expected:
        raise AssertionError(f"train_tpu_bs16: kernel launches {launches}, expected {expected}")
    if len(metrics) != 61 or not all(np.isfinite(float(v)) for v in metrics.values()):
        raise AssertionError("train_tpu_bs16: loss keys missing or a non-finite loss")
    log("train_tpu_bs16", ok=True)
    return launches


def default_scores(config: str):
    """The scores an evaluation of `config`'s launcher prints: segm AP, and
    for the COCO panoptic one PQ and mIoU."""
    def scores(results):
        out = {"segm_AP": results["segm"]["AP"]}
        if config == PAN_CONFIG:
            out.update(PQ=results.get("panoptic_seg", {}).get("All", {}).get("PQ", math.nan),
                       mIoU=results.get("sem_seg", {}).get("mIoU", math.nan))
        return out
    return scores


def phase_train_net(torch, card: str, accum: int, config: str = CONFIG, phase: str = "",
                    recipe=RELEASED_SH, scores=None, steps: int = TRAIN_NET_STEPS,
                    video: bool = False, base: dict = TRAIN_EXPECTED, loss_keys: int = 61,
                    eval_base: dict = None) -> tuple:
    """The released recipe launched as its users launch it: `train_net.main`
    with the overrides of run_50ep_no_noise_all_ly.sh, full width and depth,
    its own batch (16 images, LSJ at 1024) from phase train_coco's dataset
    on disk, `TPU.GRAD_ACCUM_STEPS accum`, remat as the defaults say;
    `steps` steps, then `--eval-only --resume` on
    TRAIN_NET_EVAL_IMAGES val images. Counts the launches a step (K1
    6 (1 + remat) accum, K1 backward 6 accum, K3 and K3 backward 9 accum)
    and an evaluated image; step TRAIN_NET_HOLD_STEP keeps one launch of
    each kernel at each of its shapes, held against the plain versions after the step
    (`hold_recorded`); prints s/step, device busy ms of the last step, the
    peak memory of the steps after the hold, data_time and segm AP. With
    `config` PAN_CONFIG (phase train_panoptic), the COCO panoptic launcher
    run_50ep_no_noise_all_ly_panoptic.sh (the same overrides): 133 classes,
    `coco_panoptic_lsj` from the panoptic split of phase train_coco's
    dataset, and the evaluation of the val split with semantic ground truth
    at the recipe's own thresholds also gives finite PQ and mIoU. `recipe`:
    the launcher's overrides of `config` (none for a recipe launched as its
    YAML says), `scores` results -> the finite scores to print
    (`default_scores`). Returns the launches of the steps and of the
    evaluation, and the steps' seconds (the profiled last left out), the last
    step's device busy ms, the peak memory and the last data_time. With
    `video`, the video entry point `train_net_video.main` instead, whose
    batch is SOLVER.IMS_PER_BATCH clips of its clip mapper, evaluated on
    TRAIN_NET_EVAL_IMAGES clips (`--max-eval-videos`: K1 6 and K3 9 a clip).
    `base`, `loss_keys`, `eval_base`: the launches a step (before remat and
    accumulation), the count of loss keys and total_loss of a metrics line,
    the launches an evaluated image, of a path other than the released
    recipe's (MaskFormer-v1's runs no kernel)."""
    import shutil

    from torch.profiler import ProfilerActivity, profile

    from mp_former_tpu_torch import train_net, train_net_video
    from mp_former_tpu_torch.engine.trainer import Trainer
    from mp_former_tpu_torch.utils.cuda_timing import device_busy_us

    phase = phase or f"train_net_accum{accum}"
    out_dir = os.path.join(REPO, "output", f"chip_smoke_{phase}")
    shutil.rmtree(out_dir, ignore_errors=True)
    opts = ["--config-file", os.path.join(REPO, config)]
    overrides = [*recipe, "SOLVER.MAX_ITER", str(steps),
                 "TPU.GRAD_ACCUM_STEPS", str(accum), "SEED", str(SEED), "OUTPUT_DIR", out_dir]
    entry = train_net_video if video else train_net
    parse = entry.default_argument_parser().parse_args
    seconds, busy, kernels = [], [], []
    run_step = Trainer.run_step

    def timed_step(trainer, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = trainer.iteration
        if step == steps - 1:  # the last step, profiled (the device only, as `busy_ms`)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = run_step(trainer, batch)
                torch.cuda.synchronize()
            events = prof.key_averages()
            busy.append(device_busy_us(events) / 1e3)
            kernels.append(sum(e.self_device_time_total for e in events
                               if e.device_type.name == "CUDA" and any(
                                   n in e.key for n in PORT_KERNEL_NAMES)) / 1e3)
        else:
            with (recording_launches() if step == TRAIN_NET_HOLD_STEP
                  else contextlib.nullcontext()) as kept:
                out = run_step(trainer, batch)
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if step == TRAIN_NET_HOLD_STEP:
            hold_recorded(torch, phase, kept, card)
            del kept
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        return out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    torch.manual_seed(SEED)  # the model's initialisation
    with mock.patch.object(Trainer, "run_step", timed_step):
        entry.main(parse([*opts, *overrides]))
    launches = kernel_counts(backward=True)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(os.path.join(out_dir, "config.yaml")) as f:
        dumped = f.read()
    remat = "REMAT_ENCODER: true" in dumped
    per_step = step_expected(base, remat, accum)
    expected = {k: steps * v for k, v in per_step.items()}
    with open(os.path.join(out_dir, "metrics.json")) as f:
        lines = [json.loads(x) for x in f.read().splitlines()]
    cfg = load_cfg(config, overrides, released_decoder=False)
    if video:
        batch = (f"{cfg.SOLVER.IMS_PER_BATCH} clips x {cfg.INPUT.SAMPLING_FRAME_NUM} frames on "
                 "{}x{}".format(*video_train_canvas(cfg)))
    else:
        crop = (cfg.INPUT.CROP.SIZE if cfg.INPUT.CROP.ENABLED
                else (cfg.INPUT.IMAGE_SIZE, cfg.INPUT.IMAGE_SIZE))
        batch = f"{cfg.SOLVER.IMS_PER_BATCH}x{crop[0]}x{crop[1]}"
    log(phase, steps=steps, batch=batch,
        mapper="YTVISDatasetMapper" if video else cfg.INPUT.DATASET_MAPPER_NAME, accum=accum,
        remat=remat, launches=launches, expected=expected)
    log(phase, steps_s=[f"{t:.4f}" for t in seconds[:-1]],
        profiled_last_step_s=f"{seconds[-1]:.4f}", device_busy_ms_last_step=f"{busy[0]:.1f}",
        port_kernels_ms_last_step=f"{kernels[0]:.1f}",
        port_kernels_share=f"{kernels[0] / busy[0]:.4f}",
        peak_memory_allocated_GiB_after_the_hold=f"{peak_gb:.2f}",
        data_time_s=f"{lines[-1]['data_time']:.4f}",
        total_loss=f"{lines[-1]['total_loss']:.3f}", card=repr(card))
    if launches != expected or not remat or len(seconds) != steps:
        raise AssertionError(f"{phase}: launches {launches}, expected {expected} (remat "
                             f"{remat}), {len(seconds)} steps")
    losses = [k for k in lines[-1] if k.startswith("loss_") or k == "total_loss"]
    if not all(np.isfinite(v) for x in lines for v in x.values()) or len(losses) != loss_keys:
        raise AssertionError(f"{phase}: metrics.json lines {lines}")

    reset_kernel_counts()
    t0 = time.perf_counter()
    results = entry.main(parse([*opts, "--eval-only", "--resume",
                                "--max-eval-videos" if video else "--max-eval-images",
                                str(TRAIN_NET_EVAL_IMAGES), *overrides]))
    eval_s = time.perf_counter() - t0
    launches_eval = kernel_counts(backward=True)
    expected_eval = {k: TRAIN_NET_EVAL_IMAGES * v
                     for k, v in (eval_base or COCO_EVAL_EXPECTED).items()}
    scores = (scores or default_scores(config))(results)
    log(phase, evaluated=TRAIN_NET_EVAL_IMAGES, launches=launches_eval, expected=expected_eval,
        results=sorted(results), **{k: f"{v:.4f}" for k, v in scores.items()},
        eval_only_s=f"{eval_s:.2f}", card=repr(card))
    if launches_eval != expected_eval or not all(np.isfinite(v) for v in scores.values()):
        raise AssertionError(f"{phase}: evaluation launches {launches_eval}, expected "
                             f"{expected_eval}; {scores}")
    log(phase, ok=True)
    return launches, launches_eval, {"step_s": seconds[:-1], "busy_ms": busy[0],
                                     "kernels_ms": kernels[0],
                                     "peak_GiB": peak_gb, "data_time_s": lines[-1]["data_time"]}


# launched by run_50ep_no_noise_all_ly_panoptic.sh, whose overrides are
# RELEASED_SH (byte-identical DN flags)
PAN_CONFIG = "configs/coco/panoptic-segmentation/maskformer2_R50_bs16_50ep.yaml"
PAN_THINGS = 80  # COCO panoptic's 133 classes: 80 things first, then 53 stuff
PAN_ORACLE_ROOT = os.path.join(REPO, "output", "chip_smoke_panoptic_oracle")
PAN_ORACLE_NAME = "chip_smoke_panoptic_oracle"
# the oracle's thresholds (tests/test_e2e_pq_miou_oracle.py): random weights
# score near 1 / (K + 1), so every query is kept, and the overlap rule runs
PAN_ORACLE_OVERRIDES = ["MODEL.MASK_FORMER.TEST.OBJECT_MASK_THRESHOLD", "0.0",
                        "MODEL.MASK_FORMER.TEST.OVERLAP_THRESHOLD", "0.3"]
# PQ and mIoU through the kernels against ground truth made by the plain
# ops: 100 up to the pixels whose logits the two paths put on either side of
# a threshold (sigmoid 0.5, the argmax), which phase train_coco finds rare
PAN_ORACLE_MIN = 98.0


def write_panoptic_oracle(torch, cfg, model, records) -> tuple:
    """`records` (val images with their height and width) rewritten as a COCO
    panoptic dataset whose ground truth is the model's own predictions
    through the plain ops at the oracle's thresholds: the id maps and
    segments, the thing segments as instances (uncompressed RLE), the
    semantic argmax; all 133 classes, the first PAN_THINGS things. Registered
    as PAN_ORACLE_NAME; returns (segments, instances) counted."""
    import shutil

    from mp_former_tpu_torch.data.datasets.register_all import register_coco_panoptic
    from mp_former_tpu_torch.engine.eval_loop import read_image
    from mp_former_tpu_torch.engine.predictor import Predictor

    num_classes = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
    is_thing = np.arange(num_classes) < PAN_THINGS
    predictor = Predictor(cfg, model=model, device="cuda", is_thing=is_thing)
    shutil.rmtree(PAN_ORACLE_ROOT, ignore_errors=True)
    for d in ("pan", "sem", "annotations"):
        os.makedirs(os.path.join(PAN_ORACLE_ROOT, d))
    images, pan_annotations, instances = [], [], []
    for rec in records:
        image = read_image(rec)
        with plain_ops():
            out = predictor(image, (rec["height"], rec["width"]),
                            tasks=["semantic", "panoptic"], sem_seg_labels=True)
        pan_map, segments = out["panoptic_seg"]
        stem = os.path.basename(rec["file_name"])
        np.save(os.path.join(PAN_ORACLE_ROOT, "pan", stem), pan_map.astype(np.uint32))
        np.save(os.path.join(PAN_ORACLE_ROOT, "sem", stem), out["sem_seg"].astype(np.uint8))
        images.append({"id": rec["image_id"], "file_name": stem, "height": rec["height"],
                       "width": rec["width"]})
        segs = [{"id": seg["id"], "category_id": seg["category_id"] + 1, "iscrowd": 0,
                 "area": int((pan_map == seg["id"]).sum())} for seg in segments]
        pan_annotations.append({"image_id": rec["image_id"], "file_name": stem,
                                "segments_info": segs})
        instances += [{"id": len(instances) + 1, "image_id": rec["image_id"],
                       "category_id": seg["category_id"] + 1, "iscrowd": 0, "bbox": [0, 0, 1, 1],
                       "area": int((pan_map == seg["id"]).sum()),
                       "segmentation": uncompressed_rle(pan_map == seg["id"])}
                      for seg in segments if seg["isthing"]]
    categories = [{"id": c + 1, "name": f"class-{c}", "isthing": int(is_thing[c])}
                  for c in range(num_classes)]
    ann = os.path.join(PAN_ORACLE_ROOT, "annotations")
    for kind, annotations in (("panoptic", pan_annotations), ("instances", instances)):
        with open(os.path.join(ann, f"{kind}_val2017.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations, "categories": categories}, f)
    register_coco_panoptic(PAN_ORACLE_NAME, os.path.join(ann, "panoptic_val2017.json"),
                           os.path.dirname(records[0]["file_name"]),
                           os.path.join(PAN_ORACLE_ROOT, "pan"),
                           semseg_root=os.path.join(PAN_ORACLE_ROOT, "sem"),
                           instances_json=os.path.join(ann, "instances_val2017.json"),
                           ignore_label=255)
    return sum(len(a["segments_info"]) for a in pan_annotations), len(instances)


def postprocess_seconds(torch, cfg, model, records, dataset: str = PAN_ORACLE_NAME) -> dict:
    """Mean host seconds an image of each part of `dataset`'s evaluation,
    synchronised after each: the forward, each task's post-processing on the
    card and the host (the panoptic one with its sequential merge loop), and
    each task's evaluator `process`."""
    from mp_former_tpu_torch.data.catalog import MetadataCatalog
    from mp_former_tpu_torch.engine import predictor as pred
    from mp_former_tpu_torch.engine.eval_loop import read_image
    from mp_former_tpu_torch.evaluation.build import build_evaluator, is_thing_array

    t = cfg.MODEL.MASK_FORMER.TEST
    k = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
    is_thing = is_thing_array(cfg, MetadataCatalog.get(dataset))
    predictor = pred.Predictor(cfg, model=model, device="cuda", is_thing=is_thing)
    evset = build_evaluator(cfg, dataset)
    evset.reset()
    entries = {e.task: e for e in evset.entries}
    times = {}

    def clock(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(key, []).append(time.perf_counter() - t0)
        return out

    for rec in records:
        image = read_image(rec)
        hw = (rec["height"], rec["width"])
        logits, masks, size = clock("forward", lambda: predictor.forward_raw(image))
        with torch.inference_mode():
            inst = clock("post_instance", lambda: pred.postprocess_instance(
                logits, masks, size, *hw, k, cfg.TEST.DETECTIONS_PER_IMAGE))
            inst = (inst.scores.float().cpu().numpy(), inst.pred_classes.cpu().numpy(),
                    inst.pred_masks.cpu().numpy())
            sem = clock("post_semantic", lambda: pred.postprocess_semantic(
                logits, masks, size, *hw, pred.semantic_before_inference(cfg)).argmax(0).cpu()
                .numpy())
            pan = clock("post_panoptic_with_host_merge", lambda: pred.postprocess_panoptic(
                logits, masks, size, *hw, k, t.OBJECT_MASK_THRESHOLD, t.OVERLAP_THRESHOLD,
                is_thing))
        for task, data in (("instance", inst), ("semantic", sem), ("panoptic", pan)):
            clock(f"evaluator_{task}", lambda: entries[task].process(rec, data))
    return {key: mean(v) for key, v in times.items()}


def phase_eval_panoptic(torch, card: str) -> dict:
    """Slice 4 (A16a), scored: the COCO panoptic recipe at full width (133
    classes, seeded weights) over phase train_coco's 8 val images, whose
    ground truth is rewritten from the model's own plain-op predictions at the
    oracle's thresholds (`write_panoptic_oracle`); then `run_evaluation`
    through the kernels, counted: K1 6 and K3 9 launches an image; PQ and
    mIoU at least PAN_ORACLE_MIN, AP printed beside them; then each part's
    seconds an image (`postprocess_seconds`)."""
    from mp_former_tpu_torch.data.catalog import DatasetCatalog
    from mp_former_tpu_torch.engine.eval_loop import run_evaluation

    cfg = load_cfg(PAN_CONFIG, [*RELEASED_SH, *PAN_ORACLE_OVERRIDES])
    if (cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES, cfg.MODEL.MASK_FORMER.NUM_OBJECT_QUERIES) != (133, 100):
        raise AssertionError("eval_panoptic: the recipe's width changed")
    model = seeded_model(torch, cfg).to("cuda").eval()
    records = DatasetCatalog.get("coco_2017_val_panoptic_with_sem_seg")[:COCO_VAL_IMAGES]
    t0 = time.perf_counter()
    n_segments, n_instances = write_panoptic_oracle(torch, cfg, model, records)
    log("eval_panoptic", images=len(records), oracle_segments=n_segments,
        oracle_instances=n_instances, write_s=f"{time.perf_counter() - t0:.2f}")
    # at random weights the queries' masks are nearly one map (correlation 0.998
    # between queries at the reference init), so a few segments win the argmax:
    # PQ holds those, mIoU every pixel
    if n_segments == 0 or n_instances == 0:
        raise AssertionError(f"eval_panoptic: the plain ops made {n_segments} segments and "
                             f"{n_instances} thing segments: the oracle would be vacuous")
    reset_kernel_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        results = run_evaluation(cfg, model, PAN_ORACLE_NAME)
    seconds = time.perf_counter() - t0
    launches = kernel_counts(backward=True)
    expected = {k: len(records) * v for k, v in COCO_EVAL_EXPECTED.items()}
    pq, miou, ap = (results["panoptic_seg"]["All"]["PQ"], results["sem_seg"]["mIoU"],
                    results["segm"]["AP"])
    log("eval_panoptic", launches=launches, expected=expected, PQ=f"{pq:.4f}",
        PQ_things=f"{results['panoptic_seg']['Things']['PQ']:.4f}",
        PQ_stuff=f"{results['panoptic_seg']['Stuff']['PQ']:.4f}", mIoU=f"{miou:.4f}",
        segm_AP=f"{ap:.4f}", min_PQ_mIoU=PAN_ORACLE_MIN,
        s_per_image=f"{seconds / len(records):.4f}", card=repr(card))
    if launches != expected:
        raise AssertionError(f"eval_panoptic: kernel launches {launches}, expected {expected}")
    if not (pq >= PAN_ORACLE_MIN and miou >= PAN_ORACLE_MIN and np.isfinite(ap)):
        raise AssertionError(f"eval_panoptic: PQ {pq}, mIoU {miou} through the kernels against "
                             f"the plain ops' own predictions, below {PAN_ORACLE_MIN}; AP {ap}")
    parts = postprocess_seconds(torch, cfg, model, records)
    log("eval_panoptic", seconds_per_image={k: f"{v:.4f}" for k, v in parts.items()},
        canvas="800x800 (480x480 images at MIN_SIZE_TEST 800)", card=repr(card))
    restore_kernel_counts(launches)
    log("eval_panoptic", ok=True)
    return {"launches": launches, "PQ": pq, "mIoU": miou, "AP": ap, "seconds": parts}


# slice 4 (A16b): the ADE20K, Cityscapes and Mapillary Vistas recipes on
# datasets written by tools/make_synthetic_segm_torch.py under SEGM_ROOT, which
# the builtin registrations read ($DETECTRON2_DATASETS, set by `main`)
SEGM_ROOT = os.path.join(REPO, "output", "chip_smoke_segm")
# (dataset, split, images, height, width, seed): each dataset's typical size
SEGM_DATA = [("ade20k", "train", 16, 512, 683, SEED), ("ade20k", "val", 4, 512, 683, SEED + 1),
             ("cityscapes", "train", 8, 1024, 2048, SEED),
             ("cityscapes", "val", 4, 1024, 2048, SEED + 1),
             ("mapillary", "train", 8, 1536, 2048, SEED),
             ("mapillary", "val", 4, 1536, 2048, SEED + 1)]
ADE_SEM_CONFIG = "configs/ade20k/semantic-segmentation/maskformer2_R50_bs16_160k.yaml"
CS_INST_CONFIG = "configs/cityscapes/instance-segmentation/maskformer2_R50_bs16_90k.yaml"
CS_PAN_CONFIG = "configs/cityscapes/panoptic-segmentation/maskformer2_R50_bs16_90k.yaml"
MAP_PAN_CONFIG = "configs/mapillary-vistas/panoptic-segmentation/maskformer_R50_bs16_300k.yaml"
CS_ORACLE_ROOT = os.path.join(REPO, "output", "chip_smoke_cityscapes_oracle")
CS_ORACLE_NAME = "chip_smoke_cityscapes_oracle"
# `part_queries`: the class logits scaled by CS_SHARPEN; the mask logits
# spread by CS_MASK_STEEPNESS over the pixels, less CS_MASK_STEEPNESS x
# CS_MASK_Z; the means read and subtracted CS_PART_ROUNDS times
CS_SHARPEN = 50.0
CS_MASK_STEEPNESS = 10.0
CS_MASK_Z = 3.0
CS_PART_ROUNDS = 3
# the least the oracle must hold over the 4 images: panoptic segments,
# painted instances, and thing classes among them (the seeded weights after
# `part_queries` give 29, 6 and 4 on the H100, PERF.md)
CS_ORACLE_MIN = {"segments": 20, "instances": 5, "thing_classes": 3}


def phase_write_segm() -> dict:
    """SEGM_DATA written by the tool; the builtin names of the three datasets
    must read them."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from mp_former_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
    from mp_former_tpu_torch.data.datasets import builtin  # noqa: F401  (registration)
    from tools.make_synthetic_segm_torch import write_dataset

    shutil.rmtree(SEGM_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SEGM_DATA)) as pool:  # numpy leaves the GIL in its loops
        list(pool.map(lambda spec: write_dataset(SEGM_ROOT, *spec), SEGM_DATA))
    counts = {}
    for name in ("ade20k_sem_seg_train", "cityscapes_fine_instance_seg_train",
                 "cityscapes_fine_panoptic_val", "mapillary_vistas_panoptic_train",
                 "mapillary_vistas_panoptic_val"):
        root = MetadataCatalog.get(name).get("image_root")
        if not root.startswith(SEGM_ROOT):
            raise AssertionError(f"write_segm: {name} is registered at {root}")
        counts[name] = len(DatasetCatalog.get(name))
    log("write_segm", root=os.path.relpath(SEGM_ROOT, REPO), records=counts,
        write_s=f"{time.perf_counter() - t0:.2f}")
    return counts


def write_cityscapes_oracle(torch, cfg, model, records) -> tuple:
    """`records` (Cityscapes panoptic val records) with ground truth rewritten
    from the model's own predictions through the plain ops at the oracle's
    thresholds: labelTrainIds (the semantic argmax) and their labelIds, the
    panoptic id maps and json (createPanopticImgs' layout, categories by
    labelId), and instanceIds on which the instance predictions score AP 100
    (`tools/make_synthetic_segm_torch.py:instance_ids_from_predictions`);
    registered as CS_ORACLE_NAME over the same images. Returns the segments
    counted and the painted instances by labelId."""
    import shutil

    from mp_former_tpu_torch.data.catalog import MetadataCatalog
    from mp_former_tpu_torch.data.datasets.cityscapes_labels import EVAL_LABELS
    from mp_former_tpu_torch.data.datasets.register_all import register_cityscapes_panoptic
    from mp_former_tpu_torch.engine.eval_loop import read_image
    from mp_former_tpu_torch.engine.predictor import Predictor
    from mp_former_tpu_torch.evaluation.build import is_thing_array
    from tools.make_synthetic_segm_torch import instance_ids_from_predictions

    meta = MetadataCatalog.get("cityscapes_fine_panoptic_val")
    predictor = Predictor(cfg, model=model, device="cuda", is_thing=is_thing_array(cfg, meta))
    shutil.rmtree(CS_ORACLE_ROOT, ignore_errors=True)
    gt_root = os.path.join(CS_ORACLE_ROOT, "gtFine")
    pan_dir = os.path.join(gt_root, "cityscapes_panoptic_val")
    os.makedirs(pan_dir)
    label_ids = np.array([lab.id for lab in EVAL_LABELS], np.uint8)
    thing_label_ids = np.array([lab.id if lab.hasInstances else -1 for lab in EVAL_LABELS])
    images, annotations, predictions, stems = [], [], [], []
    for rec in records:
        with plain_ops():
            out = predictor(read_image(rec), (rec["height"], rec["width"]),
                            tasks=["instance", "semantic", "panoptic"], sem_seg_labels=True)
        stem = os.path.basename(rec["file_name"])[: -len("_leftImg8bit.npy")]
        city = stem.split("_")[0]
        os.makedirs(os.path.join(gt_root, "val", city), exist_ok=True)
        base = os.path.join(gt_root, "val", city, stem + "_gtFine_")
        sem = out["sem_seg"].astype(np.uint8)
        np.save(base + "labelTrainIds.npy", sem)
        np.save(base + "labelIds.npy", label_ids[sem])
        pan_map, segments = out["panoptic_seg"]
        np.save(os.path.join(pan_dir, stem + "_gtFine_panoptic.npy"), pan_map.astype(np.uint32))
        images.append({"id": stem, "file_name": stem + "_leftImg8bit.png",
                       "height": rec["height"], "width": rec["width"]})
        annotations.append({"image_id": stem, "file_name": stem + "_gtFine_panoptic.png",
                            "segments_info": [
                                {"id": seg["id"], "category_id": int(label_ids[seg["category_id"]]),
                                 "iscrowd": 0, "area": int((pan_map == seg["id"]).sum())}
                                for seg in segments]})
        inst = out["instances"]
        predictions.append((inst["scores"], inst["classes"], inst["masks"]))
        stems.append(base)
    painted = {}
    for base, ids in zip(stems, instance_ids_from_predictions(predictions, thing_label_ids)):
        np.save(base + "instanceIds.npy", ids)
        for label_id in np.unique(ids[ids >= 1000]) // 1000:
            painted[int(label_id)] = painted.get(int(label_id), 0) + 1
    categories = [{"id": lab.id, "name": lab.name, "isthing": int(lab.hasInstances)}
                  for lab in EVAL_LABELS]
    with open(os.path.join(gt_root, "cityscapes_panoptic_val.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations, "categories": categories}, f)
    register_cityscapes_panoptic(CS_ORACLE_NAME, meta.get("image_root"), gt_root, "val")
    return sum(len(a["segments_info"]) for a in annotations), painted


def part_queries(torch, cfg, model, record) -> list:
    """Weights whose predictions part the image and the queries, for an
    oracle that says something. At the seeded init the mask features (a 1x1
    convolution of ReLU outputs) share a large mean over the pixels, and the
    mask embeddings and the class logits a large mean over the queries: each
    query's mask covers about the same half of the image or all of it, most
    queries take one class, and one query takes every pixel. Read on
    `record`'s image through the plain ops (the last layer's embeddings and
    logits), the three means are subtracted through the biases of the mask
    features' convolution, the mask embedding's last layer and the class
    head; the mask embedding is scaled so that the median query's logits
    spread by CS_MASK_STEEPNESS over the pixels; and one feature channel is
    given up to an offset of -CS_MASK_STEEPNESS * CS_MASK_Z in every query's mask
    logits (its weights zeroed, a constant -1 feature against a constant
    embedding), so each mask is the few pixels where the query's projection
    is far above its mean and masks seldom overlap. CS_PART_ROUNDS times, since
    the masks steer the decoder's attention and so its queries; then the
    class logits are scaled by CS_SHARPEN (as tests/test_torch_segm_eval.py
    does). Returns each round's norms of the means and spreads read."""
    from mp_former_tpu_torch.engine.eval_loop import read_image
    from mp_former_tpu_torch.engine.predictor import Predictor

    pixel, head = model.sem_seg_head.pixel_decoder, model.sem_seg_head.predictor
    conv, last = pixel.mask_features, head.mask_embed.layers[2]
    k = conv.bias.shape[0] - 1  # the channel given up to the offset
    predictor = Predictor(cfg, model=model, device="cuda")
    image = read_image(record)
    seen, rounds_read = {}, []
    hooks = [conv.register_forward_hook(lambda m, i, o: seen.update(f=o[0, :k])),
             head.mask_embed.register_forward_hook(lambda m, i, o: seen.update(e=o[0, :, :k]))]
    try:
        for _ in range(CS_PART_ROUNDS):
            with plain_ops(), torch.no_grad():
                logits = predictor.forward_raw(image)[0]
            f = seen["f"] - seen["f"].mean((1, 2), keepdim=True)
            e = seen["e"] - seen["e"].mean(0)
            spread = torch.einsum("qc,chw->qhw", e, f).flatten(1).std(1).median().item()
            rounds_read.append({"mask_feature_mean": seen["f"].mean((1, 2)).norm().item(),
                                "mask_embedding_mean": seen["e"].mean(0).norm().item(),
                                "class_logit_mean": logits.mean(0).norm().item(),
                                "mask_logit_spread": spread})
            scale = CS_MASK_STEEPNESS / spread
            with torch.no_grad():
                conv.bias[:k] -= seen["f"].mean((1, 2))
                conv.weight[k] = 0
                conv.bias[k] = -1.0
                last.bias[:k] -= seen["e"].mean(0)
                last.weight[:k] *= scale
                last.bias[:k] *= scale
                last.weight[k] = 0
                last.bias[k] = CS_MASK_STEEPNESS * CS_MASK_Z
                head.class_embed.bias -= logits.mean(0)
    finally:
        for hook in hooks:
            hook.remove()
    with torch.no_grad():
        head.class_embed.weight.mul_(CS_SHARPEN)
        head.class_embed.bias.mul_(CS_SHARPEN)
    return rounds_read


def phase_eval_cityscapes(torch, card: str) -> dict:
    """Slice 4 (A16b), scored: the Cityscapes panoptic recipe at full width
    (19 classes, the vanilla decoder, the three TEST switches, seeded
    weights) over the 4 synthetic 1024x2048 val images, their ground truth
    rewritten from the model's own plain-op predictions
    (`write_cityscapes_oracle`) by weights that part the image
    (`part_queries`), the oracle's counts at least CS_ORACLE_MIN; `run_evaluation`
    through the kernels, counted (K1 6 and K3 9 launches an image): PQ, the
    Cityscapes IoU and the Cityscapes AP at least PAN_ORACLE_MIN; then each
    part's seconds an image (`postprocess_seconds`)."""
    from mp_former_tpu_torch.data.catalog import DatasetCatalog
    from mp_former_tpu_torch.engine.eval_loop import run_evaluation

    cfg = load_cfg(CS_PAN_CONFIG, PAN_ORACLE_OVERRIDES, released_decoder=False)
    t = cfg.MODEL.MASK_FORMER.TEST
    if (cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES, cfg.MODEL.MASK_FORMER.NUM_OBJECT_QUERIES,
            cfg.MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME, t.PANOPTIC_ON, t.INSTANCE_ON,
            t.SEMANTIC_ON) != (19, 100, "MultiScaleMaskedTransformerDecoder", True, True, True):
        raise AssertionError("eval_cityscapes: the recipe changed")
    model = seeded_model(torch, cfg).to("cuda").eval()
    records = DatasetCatalog.get("cityscapes_fine_panoptic_val")
    parted = part_queries(torch, cfg, model, records[0])
    log("eval_cityscapes", sharpen=CS_SHARPEN, steepness=CS_MASK_STEEPNESS, z=CS_MASK_Z,
        read=[{k: f"{v:.4g}" for k, v in r.items()} for r in parted])
    t0 = time.perf_counter()
    n_segments, painted = write_cityscapes_oracle(torch, cfg, model, records)
    counts = {"segments": n_segments, "instances": sum(painted.values()),
              "thing_classes": len(painted)}
    log("eval_cityscapes", images=len(records), canvas="1024x2048", oracle=counts,
        instances_by_label_id=painted, minimum=CS_ORACLE_MIN,
        write_s=f"{time.perf_counter() - t0:.2f}")
    if any(counts[k] < v for k, v in CS_ORACLE_MIN.items()):
        raise AssertionError(f"eval_cityscapes: the plain ops' predictions hold {counts}, "
                             f"fewer than {CS_ORACLE_MIN}: the oracle would say little")
    reset_kernel_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        results = run_evaluation(cfg, model, CS_ORACLE_NAME)
    seconds = time.perf_counter() - t0
    launches = kernel_counts(backward=True)
    expected = {k: len(records) * v for k, v in COCO_EVAL_EXPECTED.items()}
    pq, iou, ap = (results["panoptic_seg"]["All"]["PQ"], results["sem_seg"]["IoU"],
                   results["segm"]["AP"])
    pan = results["panoptic_seg"]["All"]
    log("eval_cityscapes", launches=launches, expected=expected, PQ=f"{pq:.4f}",
        SQ=f"{pan['SQ']:.4f}", RQ=f"{pan['RQ']:.4f}",
        IoU=f"{iou:.4f}", iIoU=f"{results['sem_seg']['iIoU']:.4f}", AP=f"{ap:.4f}",
        AP50=f"{results['segm']['AP50']:.4f}", minimum=PAN_ORACLE_MIN,
        s_per_image=f"{seconds / len(records):.4f}", card=repr(card))
    if launches != expected:
        raise AssertionError(f"eval_cityscapes: kernel launches {launches}, expected {expected}")
    if not min(pq, iou, ap) >= PAN_ORACLE_MIN:
        raise AssertionError(f"eval_cityscapes: PQ {pq}, IoU {iou}, AP {ap} through the kernels "
                             f"against the plain ops' own predictions, below {PAN_ORACLE_MIN}")
    parts = postprocess_seconds(torch, cfg, model, records, CS_ORACLE_NAME)
    log("eval_cityscapes", seconds_per_image={k: f"{v:.4f}" for k, v in parts.items()},
        canvas="1024x2048", card=repr(card))
    restore_kernel_counts(launches)
    log("eval_cityscapes", ok=True)
    return {"launches": launches, "PQ": pq, "IoU": iou, "AP": ap, "seconds": parts}


# the three recipes launched as their users launch them (no overrides but the
# run's length, seed and directory): one of each mapper kind at its own batch
SEGM_TRAIN = {
    "train_ade20k_sem": (ADE_SEM_CONFIG, lambda r: {"mIoU": r["sem_seg"]["mIoU"]}),
    "train_cityscapes_inst": (CS_INST_CONFIG, lambda r: {"AP": r["segm"]["AP"],
                                                         "AP50": r["segm"]["AP50"]}),
    # its DATASETS.TEST carries no semantic ground truth, as the JAX package
    # registers it (ROADMAP §C), and the recipe switches instance inference
    # off (INSTANCE_ON False): PQ alone
    "train_mapillary_pan": (MAP_PAN_CONFIG, lambda r: {"PQ": r["panoptic_seg"]["All"]["PQ"]}),
}


# slice 5 (A17): the Swin-L COCO instance recipe (200 queries, the vanilla
# decoder), launched as its YAML says but for the weights: its ImageNet-22k
# file is not in the repository, so the model starts from seeded weights
SWIN_CONFIG = ("configs/coco/instance-segmentation/swin/"
               "maskformer2_swin_large_IN21k_384_bs16_100ep.yaml")
SERVE_EXPECTED = {"msda_fwd": 6, "tap_weight_fwd": 0, "masked_attn_fwd": 9}
# the two ways to fit its training batch (16 x 1024^2) on 80 GB: each block
# recomputed in the backward (MODEL.SWIN.USE_CHECKPOINT), or 4 micro-batches
SWIN_TRAIN = (("train_swin", ["MODEL.SWIN.USE_CHECKPOINT", "True"], 1),
              ("train_swin_accum4", [], 4))
SWIN_STEP_BATCH = 2
# steps of the Swin-L training phases: the first warms up, the second is held
# against the plain versions, the last is profiled, the two between are timed
SWIN_TRAIN_STEPS = 5


@contextlib.contextmanager
def stage_ranges(model):
    """The backbone's forward, the pixel decoder's and the transformer
    decoder's each inside a `stage::<name>` range, whose device span a
    `torch.profiler` trace shows."""
    from torch.profiler import record_function

    def ranged(name, fn):
        def wrapper(*args, **kwargs):
            with record_function(f"stage::{name}"):
                return fn(*args, **kwargs)
        return wrapper

    head = model.sem_seg_head
    with mock.patch.object(model.backbone, "forward", ranged("backbone", model.backbone.forward)), \
            mock.patch.object(head.pixel_decoder, "forward_features",
                              ranged("pixel_decoder", head.pixel_decoder.forward_features)), \
            mock.patch.object(head.predictor, "forward",
                              ranged("decoder", head.predictor.forward)):
        yield


def serving_profile(torch, predictor, image, calls: int = 3) -> dict:
    """A warm request's device busy ms, the backbone's device span in it and
    the peak memory of the requests, by `torch.profiler` over `calls`."""
    from torch.profiler import ProfilerActivity, profile

    from mp_former_tpu_torch.utils.cuda_timing import device_busy_us

    with stage_ranges(predictor.model):
        predictor(image)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                predictor(image)
            torch.cuda.synchronize()
    events = prof.key_averages()
    span = [e for e in events if e.key == "stage::backbone"]
    busy = device_busy_us(events) / 1e3 / calls
    backbone = span[0].device_time_total / 1e3 / span[0].count
    return {"device_busy_ms": busy, "backbone_device_span_ms": backbone,
            "backbone_share": backbone / busy,
            "peak_GiB": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_slice_swin(torch, card: str) -> tuple:
    """The Swin-L recipe at full width (embed 192, depths 2-2-18-2, window 12,
    200 queries, the MSDeformAttn pixel decoder over 384 / 768 / 1536
    channels, the vanilla decoder) serves REQUESTS through `Predictor` as
    phase slice does (K1 6 and K3 9 launches a request, the kernel forward
    against the plain ops), then in `TPU.COMPUTE_DTYPE bfloat16` as phase
    slice_bf16 does; the device busy ms, the backbone's device span and the
    peak memory of a warm 480x640 request in both types. The kernel forward
    is held against the plain ops given the kernel path's attention masks
    (`paired_outputs`, as phase train_coco holds its evaluation): an
    attention decision the plain ops take otherwise must sit within
    ATTN_FLIP_MARGIN of 0."""
    cfg = load_cfg(SWIN_CONFIG, [], released_decoder=False)
    swin = cfg.MODEL.SWIN
    if (swin.EMBED_DIM, tuple(swin.DEPTHS), swin.WINDOW_SIZE,
            cfg.MODEL.MASK_FORMER.NUM_OBJECT_QUERIES) != (192, (2, 2, 18, 2), 12, 200):
        raise AssertionError(f"slice_swin: {SWIN_CONFIG} is not Swin-L with 200 queries")
    from mp_former_tpu_torch.engine.predictor import Predictor

    model = seeded_model(torch, cfg)
    predictor = Predictor(cfg, model=model, device="cuda")
    rng = np.random.RandomState(SEED)
    images = [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for h, w in REQUESTS]
    launches = serve(torch, "slice_swin", cfg, predictor, images, REQUESTS, SERVE_EXPECTED,
                     card, warm_passes=2)
    # 200 queries at random weights put a few mask logits within the kernels'
    # error of 0: the plain ops take the kernel path's attention masks
    for img in images:
        canvas, _ = predictor.preprocess(img)
        k_out, p_out, n_flips, margin = paired_outputs(torch, model, canvas)
        what = f"request {img.shape[0]}x{img.shape[1]}: kernel vs plain ops"
        log("slice_swin", compare=what, attention_decisions_taken_otherwise=n_flips,
            their_largest_abs_mask_logit=f"{margin:.3e}", margin=ATTN_FLIP_MARGIN)
        if margin > ATTN_FLIP_MARGIN:
            raise AssertionError(f"slice_swin: {what}: an attention decision differs at a mask "
                                 f"logit of {margin}")
        compare_outputs(torch, "slice_swin", what, cfg, canvas, k_out, p_out)
    prof = serving_profile(torch, predictor, images[0])
    log("slice_swin", request=f"{REQUESTS[0][0]}x{REQUESTS[0][1]}",
        **{k: f"{v:.3f}" for k, v in prof.items()}, card=repr(card))
    cfg16 = load_cfg(SWIN_CONFIG, ["TPU.COMPUTE_DTYPE", "bfloat16"], released_decoder=False)
    launches16, predictor16 = phase_slice_bf16(torch, card, "slice_swin_bf16", cfg16,
                                               SERVE_EXPECTED, images, predictor)
    prof16 = serving_profile(torch, predictor16, images[0])
    log("slice_swin_bf16", request=f"{REQUESTS[0][0]}x{REQUESTS[0][1]}",
        **{k: f"{v:.3f}" for k, v in prof16.items()}, card=repr(card))
    return launches, launches16


def paired_step(torch, card: str, phase: str, model, criterion, batch, what: str) -> dict:
    """Step 0 of `model` on `batch` through the kernels and through autograd
    of the plain ops, at phase train's tolerances (`hold_step`): every
    gradient, the backbone's among them, which reach it through K1's and
    K3's backward kernels. The plain ops take the kernel path's attention
    masks (`PairedAttention`) and ReLU decisions (`PairedRelu`), each
    decision taken otherwise within its margin of 0. Counts the launches
    (K1 12 with the encoder recomputed, K1 backward 6, K3 and K3 backward 9)
    and returns them."""
    expected = step_expected(TRAIN_EXPECTED, model.sem_seg_head.pixel_decoder.transformer.remat)
    pairing, relus = PairedAttention(model), PairedRelu()
    reset_kernel_counts()
    with pairing.recording(), relus.recording():
        k_losses, k_grads, assignments = loss_and_gradients(torch, model, criterion, batch)
    launches = kernel_counts(backward=True)
    if launches != expected:
        raise AssertionError(f"{phase}: kernel launches {launches}, expected {expected}")
    model.zero_grad(set_to_none=True)
    with plain_ops(), pairing.replaying(), relus.replaying():
        p_losses, p_grads, _ = loss_and_gradients(torch, model, criterion, batch, assignments)
    log(phase, attention_decisions_taken_otherwise=pairing.flips,
        their_largest_abs_mask_logit=f"{pairing.margin:.3e}", margin=ATTN_FLIP_MARGIN,
        relu_decisions_taken_otherwise=relus.flips,
        their_largest_abs_input=f"{relus.margin:.3e}", relu_margin=RELU_FLIP_MARGIN)
    if pairing.margin > ATTN_FLIP_MARGIN or relus.margin > RELU_FLIP_MARGIN:
        raise AssertionError(f"{phase}: an attention decision differs at a mask logit of "
                             f"{pairing.margin}, a ReLU decision at an input of {relus.margin}")
    backbone = [(rel_err(k_grads[n], p_grads[n]), n) for n in p_grads
                if n.startswith("backbone.")]
    log(phase, batch=what, launches=launches, backbone_gradients=len(backbone),
        backbone_grad_max_rel_err=f"{max(backbone)[0]:.3e}", worst_backbone=max(backbone)[1],
        card=repr(card))
    hold_step(torch, phase, k_losses, k_grads, p_losses, p_grads)
    trained = [n for n, p in model.named_parameters() if n.startswith("backbone.")
               and p.requires_grad]
    if len(backbone) != len(trained):
        raise AssertionError(f"{phase}: a backbone parameter got no gradient")
    log(phase, ok=True)
    return launches


def phase_swin_step(torch, card: str) -> dict:
    """Step 0 of the Swin-L recipe on SWIN_STEP_BATCH generated images of
    1024x1024 (its LSJ canvas) against the plain ops (`paired_step`)."""
    from mp_former_tpu_torch.data.synthetic import synthetic_batches
    from mp_former_tpu_torch.models.criterion import build_criterion

    cfg = load_cfg(SWIN_CONFIG, ["SEED", str(SEED)], released_decoder=False)
    model = seeded_model(torch, cfg).to("cuda")
    batch = next(synthetic_batches(SWIN_STEP_BATCH, BS16_SIZE, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
                                   TRAIN_MAX_INSTANCES, seed=SEED)).to("cuda")
    return paired_step(torch, card, "swin_step", model, build_criterion(cfg), batch,
                       f"{SWIN_STEP_BATCH}x{BS16_SIZE}x{BS16_SIZE}")


def phase_train_swin(torch, card: str) -> dict:
    """The Swin-L recipe through `train_net.main` at its own batch (16
    images, LSJ at 1024) from phase train_coco's dataset, float32, as phase
    train_net_accum1 runs the released recipe (SWIN_TRAIN_STEPS steps, the
    second's launches held against the plain versions, the last profiled,
    then `--eval-only --resume` on 4 val images), once for each way in
    SWIN_TRAIN of fitting the batch on the card; the timed steps' seconds,
    device busy ms and peak memory of both, and which has the lower s/step."""
    paths, stats = {}, {}
    for phase, overrides, accum in SWIN_TRAIN:
        paths[phase], paths[phase + "_eval"], stats[phase] = phase_train_net(
            torch, card, accum, SWIN_CONFIG, phase, recipe=overrides, steps=SWIN_TRAIN_STEPS)
        torch.cuda.empty_cache()
    timed = {phase: st["step_s"][TRAIN_NET_HOLD_STEP + 1:] for phase, st in stats.items()}
    log("train_swin", compare="ways to fit 16 x 1024^2 of Swin-L on the card",
        **{f"{phase}_timed_steps_s": [f"{t:.4f}" for t in ts] for phase, ts in timed.items()},
        **{f"{phase}_peak_GiB": f"{st['peak_GiB']:.2f}" for phase, st in stats.items()},
        **{f"{phase}_busy_ms": f"{st['busy_ms']:.1f}" for phase, st in stats.items()},
        lower_s_per_step=min(timed, key=lambda phase: mean(timed[phase])), card=repr(card))
    return paths


# slice 6 (A20a): the YouTube-VIS recipes serve whole clips. Synthetic
# videos from tools/make_synthetic_ytvis_torch.py at a YouTube-VIS video's
# 720x1280, of 2, 5 and 36 frames (36: the longest clips the JAX loop's
# length buckets name, `mp_former_tpu/video/eval_loop.py:42`)
YTVIS_CONFIG = "configs/youtubevis_2019/video_maskformer2_R50_bs16_8ep.yaml"
YTVIS_SWIN_CONFIG = ("configs/youtubevis_2019/swin/"
                     "video_maskformer2_swin_large_IN21k_384_bs16_8ep.yaml")
VIDEO_ROOT = os.path.join(REPO, "output", "chip_smoke_ytvis")
VIDEO_SIZE = (720, 1280)
VIDEO_LENGTHS = (2, 5, 36)
# eval_ytvis: a few clips at 360x640 (the recipes' test size, no resize),
# their ground truth the plain path's own first tubes (at most
# VIDEO_ORACLE_TUBES a clip, each present in every frame)
VIDEO_ORACLE_ROOT = os.path.join(REPO, "output", "chip_smoke_ytvis_oracle")
VIDEO_ORACLE_SIZE = (360, 640)
VIDEO_ORACLE_LENGTHS = (2, 3, 5, 8)
VIDEO_ORACLE_TUBES = 3
VIDEO_AP_TOL = 0.5


def write_clips(root: str, lengths, size, seed: int) -> tuple:
    """Synthetic YouTube-VIS videos of `lengths` frames at `size` (40
    classes, the recipes' count) as the `ytvis_2019_val` layout under `root`:
    (json path, records)."""
    import shutil

    from mp_former_tpu_torch.video.ytvis import load_ytvis_json
    from tools.make_synthetic_ytvis_torch import write_dataset

    shutil.rmtree(root, ignore_errors=True)
    json_file = write_dataset(root, videos=len(lengths), frames=tuple(lengths), height=size[0],
                              width=size[1], classes=40, split="valid", seed=seed)
    return json_file, load_ytvis_json(json_file, os.path.join(root, "ytvis_2019", "valid",
                                                              "JPEGImages"))


def serve_clip(torch, cfg, model, item) -> tuple:
    """One prepared clip (`prep_clip`) through the whole-clip path of
    `inference_on_video_dataset`: the forward and `inference_video`, whose
    tubes reach the host (scores, classes, tubes)."""
    from torch.profiler import record_function

    from mp_former_tpu_torch.video.eval_loop import inference_video

    rec = item["rec"]
    out = model(torch.from_numpy(item["clip"])[None].to("cuda"))
    with record_function("stage::postprocess"):
        return inference_video(out["pred_logits"][0], out["pred_masks"][0],
                               (item["rh"], item["rw"]), rec["height"], rec["width"],
                               cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)


def clip_profile(torch, cfg, model, item) -> dict:
    """A warm clip through `serve_clip` under `torch.profiler`: its device
    busy ms, the device span of each stage (`stage_ranges`, and
    `inference_video` with its copy of the tubes as `postprocess`; the clip's
    copy to the card is in no stage) and the port's kernels' device ms."""
    from torch.profiler import ProfilerActivity, profile

    from mp_former_tpu_torch.utils.cuda_timing import device_busy_us

    with stage_ranges(model):
        serve_clip(torch, cfg, model, item)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            serve_clip(torch, cfg, model, item)
            torch.cuda.synchronize()
    events = prof.key_averages()
    out = {"device_busy_ms": device_busy_us(events) / 1e3}
    out.update({e.key: e.device_time_total / 1e3 for e in events if e.key.startswith("stage::")})
    out["port_kernels_ms"] = sum(e.self_device_time_total for e in events
                                 if e.device_type.name == "CUDA"
                                 and any(n in e.key for n in PORT_KERNEL_NAMES)) / 1e3
    return out


def phase_slice_video(torch, card: str, phase: str, cfg, records) -> dict:
    """The video recipe `cfg` at full width with seeded weights serves each
    record's whole clip through `prep_clip` and `serve_clip`, counted: K1 6
    (the pixel decoder's encoder on the clip's frames as one batch) and K3 9
    (the decoder's cross-attention over the keys of all frames of a level)
    launches a clip, whatever its length; the top-10 tubes at the video's
    size. A clip's host ms (first and warm, the tubes on the host), device
    busy ms and peak memory. The kernel forward is held against the plain
    ops: in float32 given the kernel path's attention decisions
    (`paired_outputs`, each decision taken otherwise within ATTN_FLIP_MARGIN
    of 0), in bfloat16 by `hold_bf16` (every launch in bfloat16). The device
    time of a warm clip is split by stage (`clip_profile`). Returns the
    launches of all clips."""
    from mp_former_tpu_torch.video.eval_loop import prep_clip

    model = seeded_model(torch, cfg).to("cuda")
    bf16 = model.compute_dtype == torch.bfloat16
    total = dict.fromkeys(SERVE_EXPECTED, 0)
    for rec in records:
        t0 = time.perf_counter()
        item = prep_clip(cfg, rec)
        prep_ms = (time.perf_counter() - t0) * 1e3
        clip = torch.from_numpy(item["clip"])[None].to("cuda")
        what = f"clip of {item['t']} frames, canvas {tuple(clip.shape[2:4])}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()
        t0 = time.perf_counter()
        with torch.inference_mode(), launch_types() as seen:
            scores, classes, tubes = serve_clip(torch, cfg, model, item)
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = kernel_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if launches != SERVE_EXPECTED:
            raise AssertionError(f"{phase}: {what}: kernel launches {launches}, expected "
                                 f"{SERVE_EXPECTED}")
        for k, v in launches.items():
            total[k] += v
        if bf16:
            check_bf16_types(phase, seen)
        if tubes.shape != (10, item["t"], rec["height"], rec["width"]) or tubes.dtype != bool \
                or not np.isfinite(scores).all() \
                or not ((classes >= 0) & (classes < cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)).all():
            raise AssertionError(f"{phase}: {what}: tubes {tubes.shape} {tubes.dtype}, scores "
                                 f"{scores}, classes {classes}")
        with torch.inference_mode():
            t0 = time.perf_counter()
            serve_clip(torch, cfg, model, item)
            warm_ms = (time.perf_counter() - t0) * 1e3
            prof = clip_profile(torch, cfg, model, item)
        log(phase, clip=what, launches=launches, prep_ms=f"{prep_ms:.1f}",
            host_ms_first=f"{first_ms:.1f}", host_ms_warm=f"{warm_ms:.1f}",
            **{k.replace("stage::", "device_ms_"): f"{v:.2f}" for k, v in prof.items()},
            peak_GiB=f"{peak:.2f}", tube_bytes_to_host=tubes.nbytes, card=repr(card))
        if bf16:
            with torch.inference_mode():
                k16 = model(clip)
                with plain_ops():
                    p16 = model(clip)
                    model.compute_dtype = torch.float32
                    p32 = model(clip)
                    model.compute_dtype = torch.bfloat16
            errs = hold_bf16(torch, phase, what, k16, p16, p32)
            log(phase, compare=f"{what}: bf16 kernels and bf16 plain ops against float32 plain "
                "ops, relative to the float32 output's largest entry",
                **{f"{k}_kernels": f"{v[0]:.3e}" for k, v in errs.items()},
                **{f"{k}_plain": f"{v[1]:.3e}" for k, v in errs.items()},
                bound="1.5 x plain + 1e-3")
            del k16, p16, p32
        else:
            k_out, p_out, n_flips, margin = paired_outputs(torch, model, clip)
            log(phase, compare=f"{what}: kernel vs plain ops",
                attention_decisions_taken_otherwise=n_flips,
                their_largest_abs_mask_logit=f"{margin:.3e}", margin=ATTN_FLIP_MARGIN)
            if margin > ATTN_FLIP_MARGIN:
                raise AssertionError(f"{phase}: {what}: an attention decision differs at a "
                                     f"mask logit of {margin}")
            compare_outputs(torch, phase, f"{what}: kernel vs plain ops", cfg, clip, k_out, p_out)
            del k_out, p_out
        del clip, tubes
        torch.cuda.empty_cache()
    log(phase, ok=True)
    return total


def phase_eval_ytvis(torch, card: str) -> dict:
    """The R50 video recipe scored through its entry point: VIDEO_ORACLE_LENGTHS
    clips written by the tool, their ground truth rewritten (compressed RLE)
    from the seeded model's own first tubes through the plain ops, the
    weights saved; `train_net_video.main --eval-only` with MODEL.WEIGHTS on
    `ytvis_2019_val` registered from the written root, counted (K1 6 and K3
    9 launches a clip); tube AP through the kernels within VIDEO_AP_TOL of
    tube AP through the plain ops (`inference_on_video_dataset`)."""
    from mp_former_tpu_torch import train_net_video
    from mp_former_tpu_torch.video.eval_loop import inference_on_video_dataset, prep_clip
    from mp_former_tpu_torch.video.ytvis import load_ytvis_json
    from tools.make_synthetic_ytvis_torch import rle_string

    cfg = load_cfg(YTVIS_CONFIG, [], released_decoder=False)
    model = seeded_model(torch, cfg).to("cuda")
    json_file, records = write_clips(VIDEO_ORACLE_ROOT, VIDEO_ORACLE_LENGTHS, VIDEO_ORACLE_SIZE,
                                     SEED + 2)
    with open(json_file) as f:
        data = json.load(f)
    data["annotations"] = []
    with torch.inference_mode(), plain_ops():
        for rec in records:
            _, classes, tubes = serve_clip(torch, cfg, model, prep_clip(cfg, rec))
            present = [j for j in range(len(tubes)) if tubes[j].any(axis=(1, 2)).all()]
            for j in present[:VIDEO_ORACLE_TUBES]:
                data["annotations"].append({
                    "id": len(data["annotations"]) + 1, "video_id": rec["video_id"],
                    "category_id": int(classes[j]) + 1, "iscrowd": 0,
                    "segmentations": [rle_string(m) for m in tubes[j]],
                    "areas": [float(m.sum()) for m in tubes[j]]})
    if not data["annotations"]:
        raise AssertionError("eval_ytvis: the plain ops made no tube present in every frame: "
                             "the oracle would be vacuous")
    with open(json_file, "w") as f:
        json.dump(data, f)
    weights = os.path.join(VIDEO_ORACLE_ROOT, "model_final.pth")
    torch.save({"model": model.state_dict()}, weights)
    args = train_net_video.default_argument_parser().parse_args(
        ["--config-file", os.path.join(REPO, YTVIS_CONFIG), "--eval-only", "MODEL.WEIGHTS",
         weights, "OUTPUT_DIR", os.path.join(VIDEO_ORACLE_ROOT, "out")])
    root = os.environ["DETECTRON2_DATASETS"]
    os.environ["DETECTRON2_DATASETS"] = VIDEO_ORACLE_ROOT  # read by register_all_ytvis
    try:
        reset_kernel_counts()
        t0 = time.perf_counter()
        kernel = train_net_video.main(args)["segm"]
        seconds = time.perf_counter() - t0
        launches = kernel_counts()
    finally:
        os.environ["DETECTRON2_DATASETS"] = root
    expected = {k: v * len(records) for k, v in SERVE_EXPECTED.items()}
    records = load_ytvis_json(json_file, os.path.join(VIDEO_ORACLE_ROOT, "ytvis_2019", "valid",
                                                      "JPEGImages"))
    with plain_ops():
        plain = inference_on_video_dataset(cfg, model, records)["segm"]
    log("eval_ytvis", videos=len(records), frames=list(VIDEO_ORACLE_LENGTHS),
        size=f"{VIDEO_ORACLE_SIZE[0]}x{VIDEO_ORACLE_SIZE[1]}",
        oracle_tubes=len(data["annotations"]), launches=launches, expected=expected,
        kernel_AP=f"{kernel['AP']:.4f}", plain_AP=f"{plain['AP']:.4f}", tol=VIDEO_AP_TOL,
        entry_point_s=f"{seconds:.2f}", card=repr(card))
    if launches != expected:
        raise AssertionError(f"eval_ytvis: kernel launches {launches}, expected {expected}")
    if not (np.isfinite(kernel["AP"]) and plain["AP"] > 0
            and abs(kernel["AP"] - plain["AP"]) <= VIDEO_AP_TOL):
        raise AssertionError(f"eval_ytvis: tube AP {kernel['AP']} through the kernels, "
                             f"{plain['AP']} through the plain ops")
    log("eval_ytvis", ok=True)
    return launches


# slice 6, training (A20b): the YouTube-VIS recipes train on the JAX clip
# mapper's static canvas, max(MIN_SIZE_TRAIN) by MAX_SIZE_TRAIN rounded up
# to 32 (480x1344: levels 15x42, 30x84 and 60x168), 16 clips of 2 frames a
# batch, from a synthetic train split of 720x1280 videos written beside
# eval_ytvis's clips (so `ytvis_2019_train` and `ytvis_2019_val` read one root)
VIDEO_TRAIN_VIDEOS, VIDEO_TRAIN_LENGTH = 16, 3
VIDEO_STEP_CLIPS = 2
VIDEO_TRAIN = (("train_video", YTVIS_CONFIG, []),
               ("train_video_bf16", YTVIS_CONFIG, ["TPU.COMPUTE_DTYPE", "bfloat16"]),
               # 32 frames of Swin-L fit with each block recomputed in the backward
               ("train_video_swin", YTVIS_SWIN_CONFIG, ["MODEL.SWIN.USE_CHECKPOINT", "True"]))


def video_train_canvas(cfg) -> tuple:
    """The clip mapper's canvas of a landscape video (`video/ytvis.py:
    YTVISDatasetMapper`): max(MIN_SIZE_TRAIN) by MAX_SIZE_TRAIN, each rounded
    up to 32."""
    return ((max(cfg.INPUT.MIN_SIZE_TRAIN) + 31) // 32 * 32,
            (cfg.INPUT.MAX_SIZE_TRAIN + 31) // 32 * 32)


def phase_video_train_canvases(torch, card: str) -> dict:
    """K1, K3 and their backward kernels at the shapes of the YouTube-VIS
    recipes' training batch (16 clips of 2 frames on the 480x1344 canvas):
    K1 and its backward on 32 frames of 13230 queries, K3 and its backward
    at B = 16 with 100 and 200 queries over the keys of both frames of each
    level (S = 1260, 5040, 20160), the mask shared by the heads; float32 and
    bfloat16, held against the plain versions (forwards at TOL times the
    plain output's largest entry where that is below 1, backwards at BWD_TOL
    of each gradient's largest entry) and timed beside the bound and SDPA's
    forward and backward."""
    cfg = load_cfg(YTVIS_CONFIG, [], released_decoder=False)
    h, w = video_train_canvas(cfg)
    clips, t = cfg.SOLVER.IMS_PER_BATCH, cfg.INPUT.SAMPLING_FRAME_NUM
    if (h, w, clips, t) != (480, 1344, 16, 2):
        raise AssertionError(f"video_train_canvases: {YTVIS_CONFIG} gives {clips} clips of {t} "
                             f"frames on {h}x{w}")
    shapes = canvas_levels(h, w)
    where = f"{clips} clips x {t} frames of {h}x{w}"
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        row = hold_k1_at(torch, g, shapes, clips * t, dtype)
        log_canvas_row("video_train_canvases", "K1", where, name, row, card)
        res[("K1", where, name)] = row
        res[("K1_bwd", where, name)] = hold_k1_bwd_at(
            torch, card, "video_train_canvases", where, g, shapes, clips * t, dtype,
            plain_calls=1)
        torch.cuda.empty_cache()
        for Q in K3_QUERIES:
            for lh, lw in shapes:
                at = f"{where}, {Q} queries, S = {t * lh * lw}"
                row = hold_k3_at(torch, g, Q, t * lh * lw, dtype, batch=clips)
                log_canvas_row("video_train_canvases", "K3", at, name, row, card)
                res[("K3", at, name)] = row
                res[("K3_bwd", at, name)] = hold_k3_bwd_at(
                    torch, card, "video_train_canvases", at, g, clips, Q, t * lh * lw, dtype,
                    calls=5, plain_calls=1)
                torch.cuda.empty_cache()
    log("video_train_canvases", ok=True)
    return res


def write_video_train() -> str:
    """The synthetic train split of the video training phases: VIDEO_TRAIN_VIDEOS
    videos of VIDEO_TRAIN_LENGTH frames of 720x1280 (40 classes) under
    VIDEO_ORACLE_ROOT, beside eval_ytvis's clips; returns its json."""
    from tools.make_synthetic_ytvis_torch import write_dataset

    t0 = time.perf_counter()
    json_file = write_dataset(VIDEO_ORACLE_ROOT, videos=VIDEO_TRAIN_VIDEOS,
                              frames=(VIDEO_TRAIN_LENGTH,), height=VIDEO_SIZE[0],
                              width=VIDEO_SIZE[1], classes=40, split="train", seed=SEED + 3)
    log("write_video_train", json=json_file, videos=VIDEO_TRAIN_VIDEOS,
        frames=VIDEO_TRAIN_LENGTH, size=f"{VIDEO_SIZE[0]}x{VIDEO_SIZE[1]}",
        seconds=f"{time.perf_counter() - t0:.1f}")
    return json_file


def phase_video_step(torch, card: str, json_file: str) -> dict:
    """Step 0 of the R50 YouTube-VIS 2019 recipe at full width (seeded
    weights) on VIDEO_STEP_CLIPS clips of the train split through
    `YTVISDatasetMapper` and `collate_clips` (2 frames on the 480x1344
    canvas, ground truth at full resolution), through the kernels against
    the plain ops given the kernel path's attention and ReLU decisions
    (`paired_step`, the tube criterion's random points drawn alike). The
    seeded weights are the reference init's: the encoder's sampling-offset
    weights are 0, so every sampling location is a pixel centre of its own
    level, where the derivative in the location jumps, and the kernels and
    the plain ops must round the pixel coordinate alike (ROADMAP C9, C11)."""
    from mp_former_tpu_torch.video.criterion import build_video_criterion
    from mp_former_tpu_torch.video.ytvis import (YTVISDatasetMapper, collate_clips,
                                                 load_ytvis_json)

    cfg = load_cfg(YTVIS_CONFIG, ["SEED", str(SEED)], released_decoder=False)
    records = load_ytvis_json(json_file, os.path.join(VIDEO_ORACLE_ROOT, "ytvis_2019", "train",
                                                      "JPEGImages"))
    mapper = YTVISDatasetMapper(cfg, max_instances=cfg.TPU.MAX_INSTANCES)
    samples = [mapper(rec, np.random.RandomState(SEED + i))
               for i, rec in enumerate(records[:VIDEO_STEP_CLIPS])]
    batch = collate_clips(samples).to("cuda")
    model = seeded_model(torch, cfg).to("cuda")
    what = "{} clips x {} frames of {}x{}, {} slots".format(*batch.images.shape[:4],
                                                          batch.targets.num_instances)
    return paired_step(torch, card, "video_step", model, build_video_criterion(cfg), batch, what)


def phase_train_video(torch, card: str) -> dict:
    """The video recipes of VIDEO_TRAIN through `train_net_video.main` as
    their YAML says, at their own batch (16 clips of 2 frames, the 480x1344
    canvas) from the synthetic train split, as phase train_net_accum1 runs
    the released recipe (3 steps, the second's launches held against the
    plain versions, the last profiled), then `--eval-only --resume` on
    eval_ytvis's 4 clips: finite tube AP. `ytvis_2019_{train,val}` read
    VIDEO_ORACLE_ROOT."""
    paths = {}
    root = os.environ["DETECTRON2_DATASETS"]
    os.environ["DETECTRON2_DATASETS"] = VIDEO_ORACLE_ROOT  # read by register_all_ytvis
    try:
        for phase, config, overrides in VIDEO_TRAIN:
            paths[phase], paths[phase + "_eval"], _ = phase_train_net(
                torch, card, 1, config, phase, recipe=overrides, video=True)
            torch.cuda.empty_cache()
    finally:
        os.environ["DETECTRON2_DATASETS"] = root
    return paths


# A18: MP-Former's mask-piloted (DN) modes at phase train's batch (B = 8,
# 512x512): the released recipe's config with the MaskDN decoder, NUM_DN 5
# over TPU.DN_MAX_GT 20 slots (100 DN rows in front of the 100 learnable
# queries: K3 on 200), noise 0.2, ALL_LY_DN, label noise 0.2; each run's
# model built from its own config (DN_MODE, HEAD_DN) at the seeded init.
# The runs in DN_MODE_HELD keep their step's launches and hold them against
# the plain versions on their own inputs, K3's backward against float64:
# per-head DN rows (`points`, `mask`) and rows with a few open keys (`patch`,
# `points_MAE`)
DN_MODES_OVERRIDES = ["MODEL.DN.NUM_DN", "5", "MODEL.DN.NOISE_SCALE", "0.2",
                      "MODEL.MASK_FORMER.ALL_LY_DN", "True",
                      "MODEL.MASK_FORMER.LB_NOISE_RATIO", "0.2", "TPU.DN_MAX_GT", "20",
                      "SOLVER.IMS_PER_BATCH", str(TRAIN_BATCH), "SEED", str(SEED)]
DN_MODE_RUNS = (("points", True), ("shift", False), ("scale", False), ("shift_scale", False),
                ("patch", False), ("points_MAE", False), ("base", False), ("lb", False),
                ("mask", False), ("mask", True))
DN_MODE_HELD = (("points", True), ("patch", False), ("points_MAE", False), ("mask", True))
DN_QUERIES = 200
# the modes' steps after step 0: one timed, one warm, one profiled
DN_MODE_STEPS = 3


def phase_train_dn_modes(torch, card: str) -> tuple:
    """Each run of DN_MODE_RUNS on a model built from its config (`DN_MODE`
    and `HEAD_DN` set there) at the seeded init: step 0 through the kernels
    against autograd of the plain ops given the kernel path's attention and
    ReLU decisions (`paired_step`: K1 12, K1 backward 6, K3 and K3 backward 9
    launches; both passes draw the DN noise from a generator seeded anew),
    then DN_MODE_STEPS steps through `Trainer`, the launches counted: the
    first one's seconds, the device busy ms of the last (profiled) and the
    peak memory, a line a mode. The runs of DN_MODE_HELD keep their step 0's
    launches, held against the plain versions on the step's own inputs
    (`hold_recorded`, K3's backward against float64), where K3 sees 200
    queries (per head under HEAD_DN); then K3 and its backward at that shape
    (B = 8, Q = 200, the three levels' keys, a per-head 100-row DN block),
    float32, timed beside the bound, the plain versions and SDPA. Returns
    the launches of all steps, the per-mode numbers and the K3 rows."""
    import gc
    import shutil

    from mp_former_tpu_torch.data.synthetic import synthetic_batches
    from mp_former_tpu_torch.engine.trainer import Trainer
    from mp_former_tpu_torch.utils.cuda_timing import busy_ms

    phase = "train_dn_modes"
    out_dir = os.path.join(REPO, "output", f"chip_smoke_{phase}")
    shutil.rmtree(out_dir, ignore_errors=True)

    def mode_cfg(mode, head_dn):
        return load_cfg(CONFIG, [*DN_MODES_OVERRIDES, "MODEL.MASK_FORMER.DN_MODE", mode,
                                 "MODEL.MASK_FORMER.HEAD_DN", str(head_dn), "OUTPUT_DIR", out_dir])

    cfg = mode_cfg(*DN_MODE_RUNS[0])
    batches = synthetic_batches(TRAIN_BATCH, TRAIN_SIZE, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
                                TRAIN_MAX_INSTANCES, seed=SEED)
    first = next(batches).to("cuda")
    batch = f"{TRAIN_BATCH}x{TRAIN_SIZE}x{TRAIN_SIZE}"
    total = dict.fromkeys(kernel_counts(backward=True), 0)
    runs = {}
    for mode, head_dn in DN_MODE_RUNS:
        cfg = mode_cfg(mode, head_dn)
        trainer = Trainer(cfg, batches, model=seeded_model(torch, cfg), device="cuda")
        model = trainer.model
        run = mode + (" HEAD_DN" if head_dn else "")
        held = (mode, head_dn) in DN_MODE_HELD
        with (recording_launches() if held else contextlib.nullcontext()) as kept:
            launches = paired_step(torch, card, phase, model, criterion=trainer.criterion,
                                   batch=first, what=f"{batch}, DN_MODE {run}")
        if held:
            shapes = sorted({sig for k, sig in kept if k == "masked_attn_fwd"})
            log(phase, mode=run, k3_q_k_v_mask_shapes=[[a[0] for a in sig[:4]] for sig in shapes])
            # under HEAD_DN the first layer's mask is per head, and every
            # layer's where the mode refreshes the DN rows (`points`)
            per_head = [len(sig[3][0]) == 4 for sig in shapes]
            if not (all(sig[0][0][2] == DN_QUERIES for sig in shapes)
                    and any(per_head) == head_dn):
                raise AssertionError(f"{phase} {run}: K3 did not see {DN_QUERIES} queries with "
                                     f"a {'per-head' if head_dn else 'shared'} mask: {shapes}")
            hold_recorded(torch, phase, kept, card, k3_bwd_vs_float64=True)
            del kept
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run_step(next(batches))
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        # one warm step and one profiled (the profiler adds seconds of host time)
        busy = busy_ms(lambda: trainer.run_step(next(batches)), calls=1)
        steps = kernel_counts(backward=True)
        expected = {k: DN_MODE_STEPS * v for k, v in launches.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(phase, mode=run, steps=DN_MODE_STEPS, launches=steps, expected=expected,
            device_busy_ms_profiled_step=f"{busy:.3f}", first_step_s=f"{step_s:.4f}",
            peak_memory_allocated_GiB=f"{peak:.2f}", card=repr(card))
        if steps != expected:
            raise AssertionError(f"{phase} {run}: launches {steps}, expected {expected}")
        for k, v in launches.items():
            total[k] += v + steps[k]
        runs[run] = {"busy_ms": busy, "step_s": step_s, "peak_GiB": peak}
        del trainer, model
        gc.collect()
        torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(SEED + 18)
    k3_rows = {"K3": [], "K3_bwd": []}
    dn = DN_QUERIES - cfg.MODEL.MASK_FORMER.NUM_OBJECT_QUERIES
    for h, w in TRAIN_SHAPES:
        row = hold_k3_at(torch, g, DN_QUERIES, h * w, torch.float32, batch=TRAIN_BATCH, dn=dn)
        log_canvas_row(phase, "K3", "DN modes, per-head DN block", "float32", row, card)
        k3_rows["K3"].append(row)
        k3_rows["K3_bwd"].append(hold_k3_bwd_at(
            torch, card, phase, "DN modes, per-head DN block", g, TRAIN_BATCH, DN_QUERIES, h * w,
            torch.float32, dn=dn))
        torch.cuda.empty_cache()
    log(phase, modes=len(runs), ok=True)
    return total, runs, k3_rows


def phase_train_variants(torch, card: str) -> dict:
    """The decoder variants at phase train's batch and weights' seed: the
    LYSmooth decoder (LAST_Q_RATIO 0.5; no recipe sets it) with pre-norm
    layers and DROPOUT 0.1 in the deformable encoder, in training mode,
    under TPU.REMAT_ENCODER. Step 0 through the kernels against autograd of
    the plain ops (`paired_step`; the dropout masks drawn from the same
    generator seeded anew), then against the same step with remat off (the
    masks are drawn before the recomputed region): outputs bitwise equal,
    losses within REMAT_LOSS_TOL, gradients within REMAT_GRAD_TOL; the
    dropout acted (the training forward differs from the eval forward)."""
    from mp_former_tpu_torch.data.synthetic import synthetic_batches
    from mp_former_tpu_torch.models.criterion import build_criterion

    phase = "train_variants"
    cfg = load_cfg(CONFIG, [*TRAIN_OVERRIDES, "MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME",
                            "MultiScaleMaskedTransformerDecoderMaskDNLYSmooth",
                            "MODEL.MASK_FORMER.LAST_Q_RATIO", "0.5",
                            "MODEL.MASK_FORMER.PRE_NORM", "True",
                            "MODEL.MASK_FORMER.DROPOUT", "0.1", "TPU.REMAT_ENCODER", "True"])
    model = seeded_model(torch, cfg).to("cuda").train()
    criterion = build_criterion(cfg)
    batch = next(synthetic_batches(TRAIN_BATCH, TRAIN_SIZE, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
                                   TRAIN_MAX_INSTANCES, seed=SEED)).to("cuda")
    encoder = model.sem_seg_head.pixel_decoder.transformer
    if not (encoder.remat and encoder.encoder.layers[0].dropout == 0.1
            and model.sem_seg_head.predictor.last_q_ratio == 0.5
            and model.sem_seg_head.predictor.transformer_ffn_layers[0].normalize_before):
        raise AssertionError(f"{phase}: the cfg did not reach the model")
    launches = paired_step(torch, card, phase, model, criterion, batch,
                           f"{TRAIN_BATCH}x{TRAIN_SIZE}x{TRAIN_SIZE}, LYSmooth 0.5, pre-norm, "
                           "dropout 0.1, remat")
    outputs = []
    hook = model.register_forward_hook(lambda m, args, out: outputs.append(
        out["pred_masks"].detach().clone()))
    try:
        on = loss_and_gradients(torch, model, criterion, batch)
        encoder.remat = False
        reset_kernel_counts()
        off = loss_and_gradients(torch, model, criterion, batch, on[2])
        off_launches = kernel_counts(backward=True)
        with torch.no_grad():
            model.eval()
            eval_masks = model(batch.images)["pred_masks"]
            model.train()
    finally:
        hook.remove()
        encoder.remat = True
    same_out = torch.equal(outputs[0], outputs[1])
    dropped = (outputs[0] - eval_masks).abs().max().item()
    loss_err = max(abs(on[0][k] - v) / max(abs(v), 1e-6) for k, v in off[0].items())
    errs = sorted(((rel_err(on[1][k], off[1][k]), k) for k in off[1]), reverse=True)
    log(phase, compare="remat on against off, dropout 0.1", outputs_bitwise_equal=same_out,
        loss_max_rel_err=f"{loss_err:.3e}", loss_tol=REMAT_LOSS_TOL, gradients=len(errs),
        grad_max_rel_err=f"{errs[0][0]:.3e}", grad_tol=REMAT_GRAD_TOL["float32"],
        worst=[(k, f"{e:.2e}") for e, k in errs[:3]], launches_remat_off=off_launches,
        train_vs_eval_masks_max_abs_diff=f"{dropped:.3e}", card=repr(card))
    if not (same_out and on[0].keys() == off[0].keys() and loss_err <= REMAT_LOSS_TOL
            and on[1].keys() == off[1].keys() and errs[0][0] <= REMAT_GRAD_TOL["float32"]
            and off_launches == step_expected(TRAIN_EXPECTED, False) and dropped > 1e-3):
        raise AssertionError(f"{phase}: remat on against off with dropout: outputs equal "
                             f"{same_out}, losses {loss_err}, gradients {errs[:3]}, launches "
                             f"{off_launches}; dropout changed the masks by {dropped}")
    log(phase, ok=True)
    return launches


# MaskFormer-v1 (A18): the ADE20K semantic R50 recipe with the values
# mp_former_tpu/config/defaults.py gives the v1 keys; its JAX twin runs no
# Pallas kernel (plain XLA attention), so the path launches none here
V1_OVERRIDES = ["MODEL.SEM_SEG_HEAD.PIXEL_DECODER_NAME", "BasePixelDecoder",
                "MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME", "StandardTransformerDecoder",
                "MODEL.MASK_FORMER.TRANSFORMER_IN_FEATURE", "res5",
                "MODEL.MASK_FORMER.DEC_LAYERS", "6", "MODEL.MASK_FORMER.DROPOUT", "0.1"]
V1_VARIANTS = {"maskformer1": V1_OVERRIDES,
               "maskformer1_tx": [*V1_OVERRIDES, "MODEL.SEM_SEG_HEAD.PIXEL_DECODER_NAME",
                                  "TransformerEncoderPixelDecoder",
                                  "MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS", "6",
                                  "MODEL.MASK_FORMER.TRANSFORMER_IN_FEATURE",
                                  "transformer_encoder"]}
NO_KERNELS = {"msda_fwd": 0, "tap_weight_fwd": 0, "masked_attn_fwd": 0, "msda_bwd": 0,
              "masked_attn_bwd": 0, "tap_weight_bwd": 0}


def phase_slice_maskformer1(torch, card: str) -> dict:
    """Both MaskFormer-v1 configurations (V1_VARIANTS) at full width with
    seeded weights serve REQUESTS through `Predictor` (semantic
    segmentation, 150 classes): no kernel launched, finite probabilities at
    each request's size, warm latency and device busy ms of a request, the
    peak memory; then each per-pixel baseline head (on the first
    configuration) runs one forward of a 512x512 image: finite per-pixel
    logits (1, 150, 512, 512)."""
    from mp_former_tpu_torch.engine.predictor import Predictor
    from mp_former_tpu_torch.utils.cuda_timing import busy_ms

    phase = "slice_maskformer1"
    rng = np.random.RandomState(SEED)
    images = [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for h, w in REQUESTS]
    out = {}
    for name, overrides in V1_VARIANTS.items():
        cfg = load_cfg(ADE_SEM_CONFIG, overrides, released_decoder=False)
        predictor = Predictor(cfg, model=seeded_model(torch, cfg), device="cuda")
        predictor(images[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts()
        latencies = []
        for img in images:
            t0 = time.perf_counter()
            sem = predictor(img)["sem_seg"]
            latencies.append(time.perf_counter() - t0)
            if sem.shape != (150, *img.shape[:2]) or not np.isfinite(sem).all():
                raise AssertionError(f"{phase} {name}: sem_seg {sem.shape}")
        launches = kernel_counts(backward=True)
        busy = busy_ms(lambda: predictor(images[0]), calls=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(phase, config=name, requests=len(images), launches=launches,
            latency_ms=[round(t * 1e3, 2) for t in latencies],
            device_busy_ms_request_0=f"{busy:.3f}", peak_memory_allocated_GiB=f"{peak:.2f}",
            card=repr(card))
        if launches != NO_KERNELS:
            raise AssertionError(f"{phase} {name}: launches {launches}, the path has no kernel")
        out[name] = launches
        del predictor
        torch.cuda.empty_cache()
    canvas = torch.from_numpy(rng.randint(0, 256, (1, 512, 512, 3)).astype(np.uint8)).cuda()
    for head in ("PerPixelBaselineHead", "PerPixelBaselinePlusHead"):
        cfg = load_cfg(ADE_SEM_CONFIG, [*V1_OVERRIDES, "MODEL.SEM_SEG_HEAD.NAME", head],
                       released_decoder=False)
        model = seeded_model(torch, cfg).to("cuda")
        with torch.inference_mode():
            logits = model(canvas)["sem_seg_logits"]
        log(phase, head=head, sem_seg_logits=tuple(logits.shape),
            finite=bool(torch.isfinite(logits).all()))
        if logits.shape != (1, 150, 512, 512) or not torch.isfinite(logits).all():
            raise AssertionError(f"{phase} {head}: sem_seg_logits {tuple(logits.shape)}")
        del model
    log(phase, ok=True)
    return out


# A16c, A19, A22: LVIS evaluation, semantic test-time augmentation and the
# demo, video-demo and predict entry points, forward only through K1 and K3
LVIS_IMAGES, LVIS_SIZE, LVIS_CATEGORIES = 8, 512, 1203
LVIS_OVERRIDES = ["MODEL.SEM_SEG_HEAD.NUM_CLASSES", str(LVIS_CATEGORIES),
                  "TEST.DETECTIONS_PER_IMAGE", "300", "DATASETS.TEST", "('lvis_v1_val',)"]
LVIS_AP_TOL = 0.01
TTA_IMAGE = (512, 683)  # an ADE20K image's size, as phase write_segm writes them
DEMO_ROOT = os.path.join(REPO, "output", "chip_smoke_demo")
DEMO_IMAGES = ((480, 640), (640, 480))
DEMO_CLIP = (8, 720, 1280)


def paired_plain(torch, model):
    """Context managers (kernel run, plain run): the second replays the
    first's attention and ReLU decisions through the plain ops
    (`PairedAttention`, `PairedRelu`); `check(phase)` then requires every
    decision taken otherwise to sit within its margin of 0."""
    attn, relu = PairedAttention(model), PairedRelu()

    @contextlib.contextmanager
    def kernel_run():
        with attn.recording(), relu.recording():
            yield

    @contextlib.contextmanager
    def plain_run():
        with plain_ops(), attn.replaying(), relu.replaying():
            yield

    def check(phase: str) -> dict:
        out = {"attention_flips": attn.flips, "attention_margin": attn.margin,
               "relu_flips": relu.flips, "relu_margin": relu.margin}
        log(phase, decisions_taken_otherwise={k: (f"{v:.3e}" if isinstance(v, float) else v)
                                              for k, v in out.items()},
            margins=(ATTN_FLIP_MARGIN, RELU_FLIP_MARGIN))
        if attn.margin > ATTN_FLIP_MARGIN or relu.margin > RELU_FLIP_MARGIN:
            raise AssertionError(f"{phase}: a decision differs away from 0: {out}")
        if attn.kept or relu.kept:
            raise AssertionError(f"{phase}: the plain run took fewer decisions than the kernel run")
        return out

    return kernel_run, plain_run, check


LVIS_ORACLE_CLASSES = 3


def row_run_polygons(mask) -> list:
    """(H, W) bool -> COCO polygons, one rectangle a run of pixels in a row:
    the rasteriser (pycocotools' rule) fills [x0, x1) x [y, y + 1) of each,
    so their union gives back the mask but for a few pixels of the narrowest
    runs."""
    polygons = []
    for y, row in enumerate(mask):
        edges = np.diff(np.concatenate([[0], row.astype(np.int8), [0]]))
        for x0, x1 in zip(np.nonzero(edges == 1)[0], np.nonzero(edges == -1)[0]):
            polygons.append([float(x0), float(y), float(x1), float(y), float(x1), float(y + 1),
                             float(x0), float(y + 1)])
    return polygons


def write_lvis_oracle(torch, cfg, model, records, json_file: str) -> tuple:
    """Ground truth the seeded model scores on: for each of the first
    LVIS_ORACLE_CLASSES classes among an image's detections through the plain
    ops (masks of at least 64 pixels), the best detection of that class,
    added to the LVIS json beside the shapes' polygons as its mask's row runs
    (`row_run_polygons`). Its category joins the image's positive set, leaves
    its negative set and is marked not exhaustively annotated: at random
    weights the queries' masks are nearly one map and the classes nearly one
    ranking, so the class's other detections cover the same pixels, and
    LVIS ignores them rather than count them false. Returns the count added
    and the least IoU of a written polygon set, rasterised back, with its
    mask."""
    from mp_former_tpu_torch.engine.eval_loop import read_image
    from mp_former_tpu_torch.engine.predictor import Predictor
    from mp_former_tpu_torch.native import polygons_to_mask

    predictor = Predictor(cfg, model=model, device="cuda")
    with open(json_file) as f:
        data = json.load(f)
    images = {img["id"]: img for img in data["images"]}
    aid = max(a["id"] for a in data["annotations"]) + 1
    added, ious = 0, []
    for rec in records:
        with plain_ops():
            inst = predictor(read_image(rec), (rec["height"], rec["width"]),
                             tasks=["instance"])["instances"]
        img = images[rec["image_id"]]
        taken = set()
        for j in np.argsort(-inst["scores"]):
            m, cat = inst["masks"][j], int(inst["classes"][j]) + 1  # contiguous id -> LVIS id
            if cat in taken or m.sum() < 64:
                continue
            if len(taken) == LVIS_ORACLE_CLASSES:
                break
            taken.add(cat)
            ys, xs = np.nonzero(m)
            polygons = row_run_polygons(m)
            back = polygons_to_mask(polygons, *m.shape)
            ious.append(float((back & m).sum() / (back | m).sum()))
            data["annotations"].append({
                "id": aid, "image_id": rec["image_id"], "category_id": cat,
                "bbox": [float(xs.min()), float(ys.min()), float(xs.max() - xs.min() + 1),
                         float(ys.max() - ys.min() + 1)],
                "area": float(m.sum()), "segmentation": polygons})
            img["neg_category_ids"] = [c for c in img["neg_category_ids"] if c != cat]
            if cat not in img["not_exhaustive_category_ids"]:
                img["not_exhaustive_category_ids"].append(cat)
            aid += 1
            added += 1
    with open(json_file, "w") as f:
        json.dump(data, f)
    return added, min(ious, default=0.0)


def phase_eval_lvis(torch, card: str) -> dict:
    """A16c: LVIS v1 scored through the port. `tools/make_synthetic_lvis_torch.py`
    writes LVIS_IMAGES images of LVIS_SIZE^2 (the COCO tool's shapes and exact
    polygons; 1203 categories, r / c / f each with ground truth, negative and
    not-exhaustive sets) where the builtin `lvis_v1_val` reads them, and
    `write_lvis_oracle` adds ground truth the seeded model can score on; the
    released instance recipe at full width with 1203 classes and 300
    detections an image (seeded weights) runs `run_evaluation` through the
    kernels, counted (K1 6 and K3 9 an image): AP above 0; then the same
    images through the plain ops given the kernel path's decisions into a
    second LVIS evaluator: AP, APr, APc and APf within LVIS_AP_TOL, the sorted
    scores within 1e-3 of the image's largest score, and the masks of the
    detections that keep their rank, class and score (within 1e-4 of the
    largest) a pooled IoU of at least 0.99."""
    from mp_former_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
    from mp_former_tpu_torch.data.datasets.register_all import register_all
    from mp_former_tpu_torch.engine.eval_loop import read_image, run_evaluation
    from mp_former_tpu_torch.engine.predictor import Predictor
    from mp_former_tpu_torch.evaluation.build import build_evaluator
    from tools.make_synthetic_lvis_torch import write_lvis

    t0 = time.perf_counter()
    json_file = write_lvis(SEGM_ROOT, "val", LVIS_IMAGES, LVIS_SIZE, COCO_CLASSES, SEED + 5)
    register_all(SEGM_ROOT)  # the builtin names, where nothing registered them yet
    if MetadataCatalog.get("lvis_v1_val").get("json_file") != json_file:
        raise AssertionError("eval_lvis: lvis_v1_val does not read the written split")
    cfg = load_cfg(CONFIG, LVIS_OVERRIDES)
    model = seeded_model(torch, cfg).to("cuda").eval()
    added, least_iou = write_lvis_oracle(torch, cfg, model, DatasetCatalog.get("lvis_v1_val"),
                                         json_file)
    records = DatasetCatalog.get("lvis_v1_val")
    log("eval_lvis", images=len(records), json=os.path.relpath(json_file, REPO),
        annotations=sum(len(r["annotations"]) for r in records), oracle_annotations=added,
        oracle_least_iou=f"{least_iou:.4f}", write_s=f"{time.perf_counter() - t0:.2f}")
    if added < len(records) or least_iou < 0.95:
        raise AssertionError(f"eval_lvis: {added} oracle annotations, least IoU {least_iou}: "
                             "AP would be vacuous")
    reset_kernel_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        kernel = run_evaluation(cfg, model, "lvis_v1_val")["segm"]
    seconds = time.perf_counter() - t0
    launches = kernel_counts(backward=True)
    expected = {k: len(records) * v for k, v in COCO_EVAL_EXPECTED.items()}
    if launches != expected:
        raise AssertionError(f"eval_lvis: kernel launches {launches}, expected {expected}")

    predictor = Predictor(cfg, model=model, device="cuda")
    evset = build_evaluator(cfg, "lvis_v1_val", records)
    evset.reset()
    kernel_run, plain_run, check = paired_plain(torch, model)
    # the scores are a softmax over 1204 logits times a mask score, so near
    # 1e-3 at this init: they are held relative to each image's largest
    score_err, top_scores, inter, union, kept = 0.0, [], 0, 0, 0
    for rec in records:
        image = read_image(rec)
        hw = (rec["height"], rec["width"])
        with kernel_run():
            k = predictor(image, hw, tasks=["instance"])["instances"]
        with plain_run():
            p = predictor(image, hw, tasks=["instance"])["instances"]
        evset.process(rec, {"instance": (p["scores"], p["classes"], p["masks"])})
        top = float(p["scores"].max())
        top_scores.append(top)
        score_err = max(score_err,
                        float(np.abs(np.sort(k["scores"]) - np.sort(p["scores"])).max()) / top)
        same = (k["classes"] == p["classes"]) & (np.abs(k["scores"] - p["scores"]) < 1e-4 * top)
        inter += int((k["masks"][same] & p["masks"][same]).sum())
        union += int((k["masks"][same] | p["masks"][same]).sum())
        kept += int(same.sum())
    flips = check("eval_lvis")
    plain = evset.evaluate()["segm"]
    per_category = evset.entries[0].evaluator._ap.per_category_ap()
    log("eval_lvis", plain_path_ap_by_category={c + 1: round(v, 2) for c, v in per_category.items()
                                                if np.isfinite(v)})
    iou = inter / union if union else 1.0
    keys = ("AP", "APr", "APc", "APf", "AP50")
    log("eval_lvis", launches=launches, expected=expected,
        kernel_path={k: f"{kernel[k]:.4f}" for k in keys},
        plain_path={k: f"{plain[k]:.4f}" for k in keys}, ap_tol=LVIS_AP_TOL,
        largest_score_by_image=[f"{t:.4e}" for t in top_scores],
        sorted_scores_max_err_rel_to_largest=f"{score_err:.3e}", scores_rel_tol=1e-3,
        same_detection_rel_tol=1e-4, detections_kept=kept,
        masks_pooled_iou=f"{iou:.6f}", iou_min=0.99,
        s_per_image=f"{seconds / len(records):.4f}", card=repr(card))
    finite = all(np.isfinite(kernel[k]) and np.isfinite(plain[k]) for k in keys[:4])
    if not (finite and kernel["AP"] > 0
            and all(abs(kernel[k] - plain[k]) <= LVIS_AP_TOL for k in keys[:4])
            and score_err < 1e-3 and kept > 0 and iou >= 0.99):
        raise AssertionError("eval_lvis: the LVIS evaluation disagrees between the kernels and "
                             "the plain ops")
    restore_kernel_counts(launches)
    log("eval_lvis", ok=True)
    return {"launches": launches, "kernel": kernel, "plain": plain, "s_per_image":
            seconds / len(records), **flips}


def phase_tta_semantic(torch, card: str) -> dict:
    """A19: `SemanticSegmentorWithTTA` with the ADE20K R50 semantic recipe's
    own TEST.AUG (6 short sides x flip = 12 passes) at full width (seeded
    weights) on one 512x683 image: K1 6 and K3 9 launches a pass, counted;
    the seconds an image; then the same passes through the plain ops given
    the kernel run's attention and ReLU decisions: the averaged class
    probabilities within TOL["float32"] of their largest entry."""
    from mp_former_tpu_torch.test_time_augmentation import SemanticSegmentorWithTTA, tta_size

    cfg = load_cfg(ADE_SEM_CONFIG, [], released_decoder=False)
    model = seeded_model(torch, cfg).to("cuda").eval()
    tta = SemanticSegmentorWithTTA(cfg, model)
    n_passes = len(tta.min_sizes) * (2 if tta.flip else 1)
    image = np.random.RandomState(SEED + 6).randint(0, 256, (*TTA_IMAGE, 3), dtype=np.uint8)
    tta(image)  # warm: each pass's canvas once
    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.perf_counter()
    probs = tta(image)
    seconds = time.perf_counter() - t0
    launches = kernel_counts(backward=True)
    expected = {k: n_passes * v for k, v in COCO_EVAL_EXPECTED.items()}
    if launches != expected:
        raise AssertionError(f"tta_semantic: kernel launches {launches}, expected {expected}")
    kernel_run, plain_run, check = paired_plain(torch, model)
    with kernel_run():
        k_probs = tta(image)
    with plain_run():
        p_probs = tta(image)
    flips = check("tta_semantic")
    scale = max(1.0, float(np.abs(p_probs).max()))
    err = float(np.abs(k_probs - p_probs).max()) / scale
    shape = (cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES, *TTA_IMAGE)
    log("tta_semantic", passes=n_passes, sizes=tta.min_sizes, max_size=tta.max_size,
        flip=tta.flip, canvases=[tta_size(*TTA_IMAGE, s, tta.max_size) for s in tta.min_sizes],
        launches=launches, expected=expected, probs_shape=probs.shape,
        kernel_vs_plain_rel_err=f"{err:.3e}", tol=TOL["float32"],
        repeat_max_abs_diff=f"{float(np.abs(probs - k_probs).max()):.3e}",
        s_per_image=f"{seconds:.4f}", card=repr(card))
    if not (probs.shape == shape and np.isfinite(probs).all() and probs.min() >= 0
            and err <= TOL["float32"]):
        raise AssertionError(f"tta_semantic: probabilities {probs.shape} against {shape}, "
                             f"kernel against plain {err}")
    restore_kernel_counts(launches)
    log("tta_semantic", ok=True)
    return {"launches": launches, "passes": n_passes, "s_per_image": seconds, "rel_err": err,
            **flips}


def demo_run(phase: str, run, forwards: int, stems) -> dict:
    """One entry point's `run()` counted: K1 6 and K3 9 launches a forward
    (times `forwards`), and its output files (`stems` and an image
    extension)."""
    reset_kernel_counts()
    t0 = time.perf_counter()
    run()
    seconds = time.perf_counter() - t0
    launches = kernel_counts(backward=True)
    expected = {k: forwards * v for k, v in COCO_EVAL_EXPECTED.items()}
    # a PNG through zlib without cv2; where cv2 is installed the JAX demos'
    # own names (a video's frames as .jpg)
    found = [next((stem + ext for ext in (".png", ".jpg") if os.path.isfile(stem + ext)), None)
             for stem in stems]
    missing = [s for s, f in zip(stems, found) if f is None]
    log("demo", run=phase, launches=launches, expected=expected, files=len(stems),
        missing=missing, written=sorted({os.path.splitext(f)[1] for f in found if f}),
        seconds=f"{seconds:.2f}")
    if launches != expected or missing:
        raise AssertionError(f"demo: {phase}: launches {launches} (expected {expected}), "
                             f"missing {missing}")
    magic = {".png": b"\x89PNG\r\n\x1a\n", ".jpg": b"\xff\xd8\xff"}
    for f in found:
        want = magic[os.path.splitext(f)[1]]
        with open(f, "rb") as fh:
            if fh.read(len(want)) != want:
                raise AssertionError(f"demo: {phase}: {f} is not what its extension says")
    return launches


def phase_demo(torch, card: str) -> dict:
    """A22: the demos as a user runs them, on `.npy` inputs under
    DEMO_ROOT, with the COCO panoptic recipe (`predict.py`'s default: 133
    classes, 100 queries) and the R50 YouTube-VIS 2019 recipe at full width,
    their seeded weights through MODEL.WEIGHTS as reference `.pth` files:
    `demo.demo` on two images (instance and semantic drawings), `predict.main`
    on one (instance, semantic, panoptic), `demo_video.demo` on an 8-frame
    720x1280 clip (8 drawn frames); K1 6 and K3 9 launches a forward each.
    Where cv2 is installed the drawings carry the JAX demo's labels and the
    video frames are `.jpg`; without cv2 every drawing is a PNG without
    labels. Then the image demo's
    `forward_raw` through the kernels against the plain ops given the kernel
    path's decisions (`compare_outputs`' limits)."""
    from mp_former_tpu_torch import predict
    from mp_former_tpu_torch.demo import demo
    from mp_former_tpu_torch.demo.predictor import Predictor as DemoPredictor
    from mp_former_tpu_torch.demo_video import demo as demo_video

    os.makedirs(DEMO_ROOT, exist_ok=True)
    rng = np.random.RandomState(SEED + 7)
    images = []
    for i, hw in enumerate(DEMO_IMAGES):
        images.append(os.path.join(DEMO_ROOT, f"image{i}.npy"))
        np.save(images[-1], rng.randint(0, 256, (*hw, 3), dtype=np.uint8))
    clip = os.path.join(DEMO_ROOT, "clip.npy")
    np.save(clip, rng.randint(0, 256, (*DEMO_CLIP, 3), dtype=np.uint8))
    weights = {}
    for name, config, released in (("panoptic", PAN_CONFIG, False),
                                   ("video", YTVIS_CONFIG, False)):
        weights[name] = os.path.join(DEMO_ROOT, f"{name}.pth")
        torch.save({"model": seeded_model(torch, load_cfg(config, [], released)).state_dict()},
                   weights[name])
    out = os.path.join(DEMO_ROOT, "out")
    launches = {}
    launches["demo_image"] = demo_run(
        "demo.demo", lambda: demo.main(["--config-file", os.path.join(REPO, PAN_CONFIG),
                                        "--input", *images, "--output", out,
                                        "MODEL.WEIGHTS", weights["panoptic"]]),
        len(images), [os.path.join(out, f"image{i}_{t}") for i in range(len(images))
                      for t in ("instance", "semantic")])
    prefix = os.path.join(DEMO_ROOT, "prediction")
    launches["predict"] = demo_run(
        "predict.main", lambda: predict.main(["--image", images[0], "--config-file",
                                              os.path.join(REPO, PAN_CONFIG), "--weights",
                                              weights["panoptic"], "--output", prefix]),
        1, [f"{prefix}_{t}" for t in ("instance", "semantic", "panoptic")])
    vout = os.path.join(DEMO_ROOT, "video")
    launches["demo_video"] = demo_run(
        "demo_video.demo", lambda: demo_video.main(
            ["--config-file", os.path.join(REPO, YTVIS_CONFIG), "--input", clip, "--output",
             vout, "--max-frames", str(DEMO_CLIP[0]), "MODEL.WEIGHTS", weights["video"]]),
        1, [os.path.join(vout, f"frame_{t:04d}") for t in range(DEMO_CLIP[0])])

    cfg = load_cfg(PAN_CONFIG, ["MODEL.WEIGHTS", weights["panoptic"]], released_decoder=False)
    pred = DemoPredictor(cfg)
    model = pred.engine.model
    image = np.load(images[0])
    canvas, _ = pred.engine.preprocess(image)
    kernel_run, plain_run, check = paired_plain(torch, model)
    with kernel_run():
        k_raw = pred.forward_raw(image)
    with plain_run():
        p_raw = pred.forward_raw(image)
    flips = check("demo")
    compare_outputs(torch, "demo", "forward_raw, kernel vs plain ops", cfg, canvas,
                    {"pred_logits": torch.from_numpy(k_raw[0])[None],
                     "pred_masks": torch.from_numpy(k_raw[1])[None]},
                    {"pred_logits": torch.from_numpy(p_raw[0])[None],
                     "pred_masks": torch.from_numpy(p_raw[1])[None]})
    log("demo", ok=True, card=repr(card))
    return {"launches": launches, **flips}


# A21: data parallelism. Two ranks share the one card over gloo; each takes
# its block of 4 of phase train's B = 8 images
DDP_ROOT = os.path.join(REPO, "output", "chip_smoke_ddp")
DDP_RANKS, DDP_ACCUMS, DDP_STEPS = 2, (1, 2), 2
DDP_VAL = "chip_smoke_ddp_val"
DDP_ORACLE_JSON = os.path.join(DDP_ROOT, "oracle_val.json")
DDP_ORACLE_TOP = 3  # detections of each image that become its ground truth


def ddp_cfg(accum: int):
    return load_cfg(CONFIG, [*TRAIN_OVERRIDES, "TPU.GRAD_ACCUM_STEPS", str(accum),
                             "DATASETS.TEST", f"('{DDP_VAL}',)",
                             "OUTPUT_DIR", os.path.join(DDP_ROOT, f"accum{accum}")])


def pack_bools(t) -> tuple:
    return np.packbits(t.cpu().numpy().reshape(-1)), tuple(t.shape)


def unpack_bools(torch, packed) -> "torch.Tensor":
    bits, shape = packed
    n = int(np.prod(shape))
    return torch.from_numpy(np.unpackbits(bits)[:n].reshape(shape).astype(bool)).cuda()


def recorded_step(torch, trainer, batch) -> dict:
    """One `Trainer` step with its decisions kept: the losses, the gradients,
    the decoder's attention masks and the ReLU decisions (in call order, a
    micro-batch after the other), the matcher's assignments a micro-batch."""
    pairing, relu = PairedAttention(trainer.model), PairedRelu()
    solved, solve = [], trainer.criterion.assign

    def assign(costs):
        solved.append(solve(costs))
        return solved[-1]

    trainer.criterion.assign = assign
    try:
        with pairing.recording(), relu.recording():
            metrics = trainer.run_step(batch)
    finally:
        del trainer.criterion.assign
    grads = {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()
             if p.grad is not None}
    return {"losses": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "attn": pairing.kept, "relu": relu.kept, "assign": solved}


def rank_rows(record: dict, accum: int, rank: int, ranks: int = DDP_RANKS) -> dict:
    """Rank `rank`'s rows (of `ranks`) of a one-process step's decisions:
    micro-batch m of the one-process step holds rows m, m + accum, ... of the
    batch, and the rank's block of the batch is a block of each micro-batch."""
    rows = TRAIN_BATCH // accum // ranks
    mine = slice(rank * rows, (rank + 1) * rows)
    out = {}
    for key in ("attn", "relu"):
        per_micro = len(record[key]) // accum
        if per_micro * accum != len(record[key]):
            raise AssertionError(f"ddp_train: {len(record[key])} {key} calls over {accum} "
                                 "micro-batches")
        out[key] = [pack_bools(t[mine]) for t in record[key]]
    out["assign"] = [a[:, mine].cpu() for a in record["assign"]]
    return out


@contextlib.contextmanager
def replaying(torch, trainer, decisions: dict):
    """The model and criterion take the handed decisions (`rank_rows`) in
    call order; yields the pairings, whose `flips` and `margin` count the
    decisions this run would have taken otherwise."""
    pairing, relu = PairedAttention(trainer.model), PairedRelu()
    pairing.kept = [unpack_bools(torch, t) for t in decisions["attn"]]
    relu.kept = [unpack_bools(torch, t) for t in decisions["relu"]]
    handed = iter(a.cuda() for a in decisions["assign"])
    trainer.criterion.assign = lambda costs: next(handed)
    try:
        with pairing.replaying(), relu.replaying():
            yield pairing, relu
    finally:
        del trainer.criterion.assign
    if pairing.kept or relu.kept or next(handed, None) is not None:
        raise AssertionError("the step took fewer decisions than were handed to it")


def register_ddp_val(json_file: str) -> None:
    from mp_former_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
    from mp_former_tpu_torch.data.datasets.coco import register_coco_instances

    DatasetCatalog._registry.pop(DDP_VAL, None)
    MetadataCatalog._meta.pop(DDP_VAL, None)
    register_coco_instances(DDP_VAL, json_file, os.path.join(COCO_ROOT, "coco", "val2017"))


def write_ddp_oracle(detections: dict, num_classes: int) -> None:
    """`train_coco`'s val images with the seeded model's own DDP_ORACLE_TOP
    best detections of each as ground truth (uncompressed RLE, one category
    a model class), so that AP measures something at random weights."""
    with open(os.path.join(COCO_ROOT, "coco", "annotations", "instances_val2017.json")) as f:
        data = json.load(f)
    annotations = []
    for image in data["images"]:
        scores, classes, packed = detections[image["id"]]
        masks = np.unpackbits(packed)[:len(scores) * image["height"] * image["width"]].reshape(
            len(scores), image["height"], image["width"]).astype(bool)
        for k in np.argsort(-scores, kind="stable")[:DDP_ORACLE_TOP]:
            ys, xs = np.nonzero(masks[k])
            if not len(ys):
                continue
            annotations.append({
                "id": len(annotations) + 1, "image_id": image["id"],
                "category_id": int(classes[k]) + 1, "iscrowd": 0, "area": int(len(ys)),
                "bbox": [int(xs.min()), int(ys.min()), int(np.ptp(xs)) + 1, int(np.ptp(ys)) + 1],
                "segmentation": uncompressed_rle(masks[k])})
    data["annotations"] = annotations
    data["categories"] = [{"id": c + 1, "name": f"class-{c}"} for c in range(num_classes)]
    with open(DDP_ORACLE_JSON, "w") as f:
        json.dump(data, f)


def ddp_detections(torch, cfg, model) -> tuple:
    """`run_evaluation` of DDP_VAL; (its results, each image's detections:
    scores, classes, packed masks)."""
    from mp_former_tpu_torch.engine.eval_loop import run_evaluation
    from mp_former_tpu_torch.evaluation.build import EvaluatorSet

    seen, process = {}, EvaluatorSet.process

    def keep(self, record, outputs):
        scores, classes, masks = outputs["instance"]
        seen[record["image_id"]] = (np.asarray(scores), np.asarray(classes),
                                    np.packbits(np.asarray(masks).reshape(-1)))
        return process(self, record, outputs)

    with mock.patch.object(EvaluatorSet, "process", keep), torch.no_grad():
        results = run_evaluation(cfg, model, DDP_VAL)
    return results, seen


def ddp_worker(out_dir: str) -> None:
    """One of the DDP_RANKS ranks of phases ddp_train and ddp_eval: every
    accumulation setting of DDP_ACCUMS (DDP_STEPS steps, the first taking the
    handed decisions), then the evaluation; what the parent holds, saved."""
    import torch

    from mp_former_tpu_torch.engine.trainer import Trainer
    from mp_former_tpu_torch.parallel.dist import get_rank, get_world_size
    from mp_former_tpu_torch.structures import Batch, Targets

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = get_rank(), get_world_size()
    batches = torch.load(os.path.join(out_dir, "batches.pt"), weights_only=False)
    rows = slice(rank * TRAIN_BATCH // world, (rank + 1) * TRAIN_BATCH // world)
    local = [Batch(b.images[rows], Targets(*(t[rows] for t in b.targets))) for b in batches]
    out = {"rank": rank, "world": world}
    start = seeded_model(torch, ddp_cfg(1))  # the accumulation settings share the model
    for accum in DDP_ACCUMS:
        cfg = ddp_cfg(accum)
        decisions = torch.load(os.path.join(out_dir, f"accum{accum}_rank{rank}.pt"),
                               weights_only=False)
        trainer = Trainer(cfg, iter(()), model=copy.deepcopy(start), device="cuda")
        losses, counts = [], []
        for step, batch in enumerate(local):
            reset_kernel_counts()
            t0 = time.perf_counter()
            with replaying(torch, trainer, decisions) if step == 0 else \
                    contextlib.nullcontext((None, None)) as (pairing, relu):
                metrics = trainer.run_step(batch)
            torch.cuda.synchronize()
            losses.append({k: float(v) for k, v in metrics.items()})
            counts.append(kernel_counts(backward=True))
            if step == 0:
                out[f"accum{accum}_flips"] = (pairing.flips, pairing.margin, relu.flips,
                                              relu.margin)
                out[f"accum{accum}_grads"] = {n: p.grad.detach().cpu() for n, p in
                                              trainer.model.named_parameters()
                                              if p.grad is not None} if rank == 0 else \
                    {n: float(p.grad.abs().sum()) for n, p in trainer.model.named_parameters()
                     if p.grad is not None}
            out[f"accum{accum}_step{step}_s"] = time.perf_counter() - t0
        out[f"accum{accum}_losses"], out[f"accum{accum}_counts"] = losses, counts
        out[f"accum{accum}_ddp"] = type(trainer.step_model).__name__
        del trainer
        torch.cuda.empty_cache()
    register_ddp_val(DDP_ORACLE_JSON)
    cfg = ddp_cfg(1)
    model = start.cuda()
    reset_kernel_counts()
    t0 = time.perf_counter()
    out["eval"], out["detections"] = ddp_detections(torch, cfg, model)
    out["eval_s"] = time.perf_counter() - t0
    out["eval_counts"] = kernel_counts()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def hold_ddp_step(torch, phase: str, got_losses, got_grads, want: dict) -> dict:
    """A distributed step's losses and all-reduced gradients against the
    one-process step's (phase train's tolerances)."""
    loss_err = max(abs(got_losses[k] - v) / max(abs(v), 1e-6) for k, v in want["losses"].items())
    if got_losses.keys() != want["losses"].keys() or got_grads.keys() != want["grads"].keys():
        raise AssertionError(f"{phase}: other losses or gradients than the one-process step's")
    errs = sorted(((rel_err(got_grads[n].cuda(), g), n) for n, g in want["grads"].items()),
                  reverse=True)
    if not (loss_err <= TRAIN_LOSS_TOL and errs[0][0] <= TRAIN_GRAD_TOL):
        raise AssertionError(f"{phase}: the distributed step is not the one-process step: "
                             f"losses {loss_err:.3e}, gradients {errs[:3]}")
    return {"loss_max_rel_err": loss_err, "grad_max_rel_err": errs[0][0],
            "worst": [(n, f"{e:.2e}") for e, n in errs[:3]], "gradients": len(errs)}


def phase_ddp(torch, card: str) -> dict:
    """Phases ddp_train and ddp_eval (item 32): the one-process steps and
    evaluation here, then the two ranks through `launch`, held against them."""
    import shutil

    from mp_former_tpu_torch.data.synthetic import synthetic_batches
    from mp_former_tpu_torch.engine.trainer import Trainer
    from mp_former_tpu_torch.parallel.dist import launch

    t_phase = time.perf_counter()
    shutil.rmtree(DDP_ROOT, ignore_errors=True)
    os.makedirs(DDP_ROOT)
    gen = synthetic_batches(TRAIN_BATCH, TRAIN_SIZE, 80, TRAIN_MAX_INSTANCES, seed=SEED + 2)
    batches = [next(gen) for _ in range(DDP_STEPS)]
    torch.save(batches, os.path.join(DDP_ROOT, "batches.pt"))
    one = {}
    start = seeded_model(torch, ddp_cfg(1))  # the accumulation settings share the model
    for accum in DDP_ACCUMS:
        cfg = ddp_cfg(accum)
        trainer = Trainer(cfg, iter(()), model=copy.deepcopy(start), device="cuda")
        first = recorded_step(torch, trainer, batches[0])
        for rank in range(DDP_RANKS):
            torch.save(rank_rows(first, accum, rank),
                       os.path.join(DDP_ROOT, f"accum{accum}_rank{rank}.pt"))
        second = {k: float(v) for k, v in trainer.run_step(batches[1]).items()}
        one[accum] = {"first": first, "second": second}
        if accum != 1:  # phase ddp_nccl takes accum 1's decisions
            del first["attn"], first["relu"]
        del trainer, first
        torch.cuda.empty_cache()
        log("ddp_train", one_process_accum=accum, at=f"{time.perf_counter() - t_phase:.1f}")
    # the ground truth of the evaluation: the one-process run's own best detections
    register_ddp_val(os.path.join(COCO_ROOT, "coco", "annotations", "instances_val2017.json"))
    cfg = ddp_cfg(1)
    model = start.cuda()
    write_ddp_oracle(ddp_detections(torch, cfg, model)[1], cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)
    register_ddp_val(DDP_ORACLE_JSON)
    reset_kernel_counts()
    one_eval, one_dets = ddp_detections(torch, cfg, model)
    one_eval_counts = kernel_counts()
    if not one_eval["segm"]["AP"] > 10:
        raise AssertionError(f"ddp_eval: the oracle scores AP {one_eval['segm']['AP']}")
    log("ddp_eval", one_process=True, at=f"{time.perf_counter() - t_phase:.1f}")
    del model, start
    torch.cuda.empty_cache()
    t_ranks = time.perf_counter()
    launch(ddp_worker, DDP_RANKS, backend="gloo", args=(DDP_ROOT,))
    ranks_s = time.perf_counter() - t_ranks
    ranks = [torch.load(os.path.join(DDP_ROOT, f"rank{r}.pt"), weights_only=False)
             for r in range(DDP_RANKS)]

    launches = {}
    for accum in DDP_ACCUMS:
        phase = f"ddp_train_accum{accum}"
        expected = step_expected(TRAIN_EXPECTED, True, accum)
        for r in ranks:
            if r[f"accum{accum}_counts"] != [expected] * DDP_STEPS:
                raise AssertionError(f"{phase}: rank {r['rank']} launched "
                                     f"{r[f'accum{accum}_counts']} in its steps, expected "
                                     f"{expected} each")
            if r[f"accum{accum}_ddp"] != "DistributedDataParallel":
                raise AssertionError(f"{phase}: rank {r['rank']} stepped "
                                     f"{r[f'accum{accum}_ddp']}, not DDP")
            flips = r[f"accum{accum}_flips"]
            if max(flips[1], flips[3]) > max(ATTN_FLIP_MARGIN, RELU_FLIP_MARGIN):
                raise AssertionError(f"{phase}: rank {r['rank']} would take a decision "
                                     f"otherwise far from 0: {flips}")
        rank0 = ranks[0]
        held = hold_ddp_step(torch, phase, rank0[f"accum{accum}_losses"][0],
                             rank0[f"accum{accum}_grads"], one[accum]["first"])
        # both ranks hold the all-reduced gradients
        sums = {n: float(g.abs().sum()) for n, g in rank0[f"accum{accum}_grads"].items()}
        other = ranks[1][f"accum{accum}_grads"]
        if sums.keys() != other.keys() or any(abs(sums[n] - other[n]) > 1e-6 * max(sums[n], 1e-30)
                                              for n in sums):
            raise AssertionError(f"{phase}: the ranks hold different gradients")
        second_err = max(abs(r[f"accum{accum}_losses"][1][k] - v) / max(abs(v), 1e-6)
                         for r in ranks for k, v in one[accum]["second"].items())
        if any(r[f"accum{accum}_losses"][1] != ranks[0][f"accum{accum}_losses"][1]
               for r in ranks) or second_err > TRAIN_LOSS_TOL:
            raise AssertionError(f"{phase}: step 2's losses {second_err:.3e} from the "
                                 "one-process step's, or the ranks' differ")
        launches[phase] = rank0[f"accum{accum}_counts"][0]
        log(phase, ranks=DDP_RANKS, backend="gloo", batch=f"{TRAIN_BATCH}x{TRAIN_SIZE}",
            rows_a_rank=TRAIN_BATCH // DDP_RANKS, steps=DDP_STEPS,
            launches_a_rank_and_step=launches[phase], expected=expected,
            step1_loss_max_rel_err=f"{held['loss_max_rel_err']:.3e}",
            step1_grad_max_rel_err=f"{held['grad_max_rel_err']:.3e}", tol=TRAIN_GRAD_TOL,
            gradients=held["gradients"], worst=held["worst"],
            step2_loss_max_rel_err=f"{second_err:.3e}", loss_tol=TRAIN_LOSS_TOL,
            decisions_taken_otherwise=[r[f"accum{accum}_flips"] for r in ranks],
            rank_step_s=[[f"{r[f'accum{accum}_step{s}_s']:.3f}" for s in range(DDP_STEPS)]
                         for r in ranks], card=repr(card))

    n = len(one_dets)
    for r in ranks:
        mine = len(r["detections"])
        if r["eval_counts"] != {k: v * mine for k, v in COCO_EVAL_EXPECTED.items()
                                if k in r["eval_counts"]}:
            raise AssertionError(f"ddp_eval: rank {r['rank']} launched {r['eval_counts']} "
                                 f"over {mine} images")
        if json.dumps(r["eval"], sort_keys=True) != json.dumps(one_eval, sort_keys=True):
            raise AssertionError(f"ddp_eval: rank {r['rank']} merged {r['eval']}, one "
                                 f"process {one_eval}")
    dets = {k: v for r in ranks for k, v in r["detections"].items()}
    if sorted(dets) != sorted(one_dets) or n != COCO_VAL_IMAGES:
        raise AssertionError(f"ddp_eval: images {sorted(dets)}, one process {sorted(one_dets)}")
    score_err = max(float(np.abs(dets[i][0] - one_dets[i][0]).max()) for i in dets)
    other_classes = sum(int(not np.array_equal(dets[i][1], one_dets[i][1])) for i in dets)
    pixels = sum(dets[i][2].size * 8 for i in dets)
    other_pixels = sum(int(np.unpackbits(dets[i][2] ^ one_dets[i][2]).sum()) for i in dets)
    log("ddp_eval", ranks=DDP_RANKS, images=n, images_a_rank=[len(r["detections"]) for r in ranks],
        launches_a_rank=[r["eval_counts"] for r in ranks], one_process=one_eval_counts,
        AP=f"{one_eval['segm']['AP']:.4f}", every_key_equal=True,
        score_max_abs_err=f"{score_err:.3e}", images_with_other_classes=other_classes,
        mask_pixels_other=other_pixels, mask_pixels=pixels,
        rank_eval_s=[f"{r['eval_s']:.2f}" for r in ranks], card=repr(card))
    if score_err > 1e-5 or other_classes or other_pixels > 1e-5 * pixels:
        raise AssertionError(f"ddp_eval: detections differ from one process: scores "
                             f"{score_err}, classes in {other_classes} images, "
                             f"{other_pixels} mask pixels")
    launches["ddp_eval"] = ranks[0]["eval_counts"]
    log("ddp", two_ranks_s=f"{ranks_s:.1f}", phase_s=f"{time.perf_counter() - t_phase:.1f}")
    return {"launches": launches, "one": one[1]["first"], "batch": batches[0]}


def phase_ddp_nccl(torch, card: str, one: dict, batch) -> dict:
    """One rank in an NCCL group: `Trainer` wraps the model in DDP, and the
    step (given the one-process step's decisions) gives its gradients."""
    import socket

    import torch.distributed as dist

    from mp_former_tpu_torch.engine.trainer import Trainer

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        cfg = ddp_cfg(1)
        trainer = Trainer(cfg, iter(()), model=seeded_model(torch, cfg), device="cuda")
        if type(trainer.step_model).__name__ != "DistributedDataParallel":
            raise AssertionError("ddp_nccl: Trainer did not wrap the model in DDP")
        decisions = rank_rows(one, 1, 0, ranks=1)
        reset_kernel_counts()
        with replaying(torch, trainer, decisions) as (pairing, relu):
            metrics = trainer.run_step(batch)
        launches = kernel_counts(backward=True)
        grads = {n: p.grad.detach() for n, p in trainer.model.named_parameters()
                 if p.grad is not None}
        held = hold_ddp_step(torch, "ddp_nccl", {k: float(v) for k, v in metrics.items()},
                             grads, one)
    finally:
        dist.destroy_process_group()
    expected = step_expected(TRAIN_EXPECTED, True)
    log("ddp_nccl", backend="nccl", nccl=torch.cuda.nccl.version(), world_size=1,
        launches=launches, expected=expected,
        loss_max_rel_err=f"{held['loss_max_rel_err']:.3e}",
        grad_max_rel_err=f"{held['grad_max_rel_err']:.3e}", tol=TRAIN_GRAD_TOL,
        decisions_taken_otherwise=(pairing.flips, pairing.margin, relu.flips, relu.margin),
        card=repr(card))
    if launches != expected:
        raise AssertionError(f"ddp_nccl: launches {launches}, expected {expected}")
    return launches


def main() -> int:
    import torch

    card = phase_device(torch)
    # the builtin registrations (imported by the first training phase) read the
    # ADE20K, Cityscapes and Mapillary Vistas datasets of phase write_segm
    os.environ["DETECTRON2_DATASETS"] = SEGM_ROOT
    phase_build()
    k1 = phase_k1(torch, card)
    k3 = phase_k3(torch, card)
    canvases = phase_test_canvases(torch, card)
    video_canvases = phase_video_canvases(torch, card)
    k2 = phase_k2(torch, card)
    gather = phase_row_gather(torch, card)
    # reference numerics: float32 convolutions and matmuls in full float32
    # (cuDNN's default is TF32, which keeps ~3 decimal digits)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    s1, predictor1, images, canvas, k1_out = phase_slice(
        torch, card, "slice", slice_cfg(),
        {"msda_fwd": 6, "tap_weight_fwd": 0, "masked_attn_fwd": 9}, warm_passes=1)
    cfg2 = slice2_cfg()
    s2, predictor2, _, _, _ = phase_slice(
        torch, card, "slice2", cfg2,
        {"msda_fwd": 0, "tap_weight_fwd": 18, "masked_attn_fwd": 9}, warm_passes=1)
    route = phase_tap_weighting_route(torch, card, predictor1, images[0], canvas, k1_out)
    evaluation = phase_eval(torch, card, cfg2, predictor2)
    # TPU.COMPUTE_DTYPE bfloat16: the released recipe switched to it, the TPU
    # recipe as its YAML says
    s1_bf16, _ = phase_slice_bf16(
        torch, card, "slice_bf16", load_cfg(CONFIG, ["TPU.COMPUTE_DTYPE", "bfloat16"]),
        {"msda_fwd": 6, "tap_weight_fwd": 0, "masked_attn_fwd": 9}, images, predictor1)
    cfg2_bf16 = load_cfg(TPU_CONFIG, [])
    s2_bf16, predictor2_bf16 = phase_slice_bf16(
        torch, card, "slice2_bf16", cfg2_bf16,
        {"msda_fwd": 0, "tap_weight_fwd": 18, "masked_attn_fwd": 9}, images, predictor2)
    eval_bf16 = phase_eval_bf16(torch, card, cfg2_bf16, predictor2_bf16, evaluation)
    del predictor1, predictor2, predictor2_bf16, k1_out
    torch.cuda.empty_cache()
    # slice 5 (A17): the Swin-L recipe serves, float32 and bfloat16
    s_swin, s_swin_bf16 = phase_slice_swin(torch, card)
    torch.cuda.empty_cache()
    # slice 6 (A20a): the YouTube-VIS recipes serve whole clips, float32 and
    # bfloat16, and the R50 recipe scores itself through its entry point
    _, clips = write_clips(VIDEO_ROOT, VIDEO_LENGTHS, VIDEO_SIZE, SEED + 1)
    video_paths = {"slice_video": phase_slice_video(torch, card, "slice_video",
                                                    load_cfg(YTVIS_CONFIG, [], False), clips)}
    torch.cuda.empty_cache()
    video_paths["slice_video_bf16"] = phase_slice_video(
        torch, card, "slice_video_bf16",
        load_cfg(YTVIS_CONFIG, ["TPU.COMPUTE_DTYPE", "bfloat16"], False), clips)
    torch.cuda.empty_cache()
    video_paths["eval_ytvis"] = phase_eval_ytvis(torch, card)
    torch.cuda.empty_cache()
    swin_clip = [c for c in clips if c["length"] == max(VIDEO_LENGTHS)]
    video_paths["slice_video_swin"] = phase_slice_video(
        torch, card, "slice_video_swin", load_cfg(YTVIS_SWIN_CONFIG, [], False), swin_clip)
    torch.cuda.empty_cache()
    k1_bwd = phase_k1_bwd(torch, card)
    k3_bwd = phase_k3_bwd(torch, card)
    k2_bwd = phase_k2_bwd(torch, card)
    torch.cuda.empty_cache()
    train, train_f32 = phase_train(torch, card)
    torch.cuda.empty_cache()
    train_bf16 = phase_train_bf16(torch, card, train_f32)
    torch.cuda.empty_cache()
    # the TPU recipe trains: head-shared sampling through K2 and its backward
    train_tpu, train_tpu_f32 = phase_train(torch, card, "train_tpu", TPU_CONFIG,
                                           ["TPU.COMPUTE_DTYPE", "float32"], TRAIN_TPU_EXPECTED,
                                           busy=True)
    torch.cuda.empty_cache()
    train_tpu_bf16 = phase_train_bf16(torch, card, train_tpu_f32, "train_tpu_bf16", TPU_CONFIG,
                                      TRAIN_TPU_EXPECTED, busy=True)
    torch.cuda.empty_cache()
    train_coco = phase_train_coco(torch, card)
    torch.cuda.empty_cache()
    # A21: two ranks train and evaluate, then one rank in an NCCL group
    ddp = phase_ddp(torch, card)
    torch.cuda.empty_cache()
    ddp["launches"]["ddp_nccl"] = phase_ddp_nccl(torch, card, ddp["one"], ddp["batch"])
    del ddp["one"]
    torch.cuda.empty_cache()
    accum = phase_accum(torch, card)
    torch.cuda.empty_cache()
    remat = phase_remat(torch, card)
    torch.cuda.empty_cache()
    # A18: the decoder variants and the DN modes at phase train's batch
    train_variants = phase_train_variants(torch, card)
    torch.cuda.empty_cache()
    train_dn_modes, _, dn_k3 = phase_train_dn_modes(torch, card)
    torch.cuda.empty_cache()
    train_tpu_bs16 = phase_train_tpu_bs16(torch, card)
    torch.cuda.empty_cache()
    # the released recipe at its own batch through the entry point: micro-batches
    # of 8, then the monolithic step, which fits on 80 GB (PERF.md)
    train_net_paths = {}
    for a in TRAIN_NET_ACCUMS:
        train_net_paths[f"train_net_accum{a}"], train_net_paths[f"train_net_accum{a}_eval"], _ = \
            phase_train_net(torch, card, a)
        torch.cuda.empty_cache()
    # the DN_query recipe with the decoder eval.sh names and nothing else: DN_MODE base
    train_net_paths["train_net_dn_default"], train_net_paths["train_net_dn_default_eval"], _ = \
        phase_train_net(torch, card, 1, CONFIG, "train_net_dn_default",
                        recipe=["MODEL.MASK_FORMER.TRANSFORMER_DECODER_NAME",
                                "MultiScaleMaskedTransformerDecoderMaskDN"])
    torch.cuda.empty_cache()
    # slice 4 (A16a): COCO panoptic, scored against its own plain-op predictions,
    # then the panoptic launcher at its own batch
    eval_panoptic = phase_eval_panoptic(torch, card)
    torch.cuda.empty_cache()
    train_net_paths["train_panoptic"], train_net_paths["train_panoptic_eval"], _ = \
        phase_train_net(torch, card, 1, PAN_CONFIG, "train_panoptic")
    torch.cuda.empty_cache()
    # slice 4 (A16b): ADE20K, Cityscapes and Mapillary Vistas
    phase_write_segm()
    eval_cityscapes = phase_eval_cityscapes(torch, card)
    torch.cuda.empty_cache()
    for phase, (config, scores) in SEGM_TRAIN.items():
        train_net_paths[phase], train_net_paths[phase + "_eval"], _ = phase_train_net(
            torch, card, 1, config, phase, recipe=(), scores=scores)
        torch.cuda.empty_cache()
    # MaskFormer-v1 (A18) serves and trains from the ADE20K data
    maskformer1 = phase_slice_maskformer1(torch, card)
    torch.cuda.empty_cache()
    train_net_paths["train_maskformer1"], train_net_paths["train_maskformer1_eval"], _ = \
        phase_train_net(torch, card, 1, ADE_SEM_CONFIG, "train_maskformer1", recipe=V1_OVERRIDES,
                        scores=SEGM_TRAIN["train_ade20k_sem"][1], base=NO_KERNELS,
                        loss_keys=6 * 3 * 2 + 1, eval_base=NO_KERNELS)
    torch.cuda.empty_cache()
    # slice 5 (A17): the Swin-L recipe's step against the plain ops, then its
    # training batch through the entry point
    swin_step = phase_swin_step(torch, card)
    torch.cuda.empty_cache()
    swin_paths = phase_train_swin(torch, card)
    torch.cuda.empty_cache()
    # slice 6 (A20b): the video recipes train, K1, K3 and their backward
    # kernels at the shapes of their batch first
    video_train_canvases = phase_video_train_canvases(torch, card)
    torch.cuda.empty_cache()
    train_json = write_video_train()
    video_paths["video_step"] = phase_video_step(torch, card, train_json)
    torch.cuda.empty_cache()
    video_paths.update(phase_train_video(torch, card))
    torch.cuda.empty_cache()
    # A16c, A19, A22: LVIS scored, semantic test-time augmentation, the demos
    eval_lvis = phase_eval_lvis(torch, card)
    torch.cuda.empty_cache()
    tta_semantic = phase_tta_semantic(torch, card)
    torch.cuda.empty_cache()
    demos = phase_demo(torch, card)
    by_path = {"slice": s1, "slice2": s2, "tap_weighting_route": route, "train": train,
               "train_coco": train_coco, "slice_bf16": s1_bf16, "slice2_bf16": s2_bf16,
               "eval_bf16": eval_bf16, "train_bf16": train_bf16, "train_tpu": train_tpu,
               "train_tpu_bf16": train_tpu_bf16, "accum": accum, "remat": remat,
               "train_tpu_bs16": train_tpu_bs16, "eval_panoptic": eval_panoptic["launches"],
               "eval_cityscapes": eval_cityscapes["launches"], **train_net_paths,
               "slice_swin": s_swin, "slice_swin_bf16": s_swin_bf16, "swin_step": swin_step,
               **swin_paths, **video_paths, "train_variants": train_variants,
               "train_dn_modes": train_dn_modes,
               **{f"slice_{k}": v for k, v in maskformer1.items()},
               "eval_lvis": eval_lvis["launches"], "tta_semantic": tta_semantic["launches"],
               **demos["launches"], **ddp["launches"]}
    csrc = "mp_former_tpu_torch/csrc/"
    kernels = [
        {"name": "msda_fwd", "route": "cuda", "source": csrc + "msda_fwd.cu",
         "replaces": "mp_former_tpu/ops/msda_pallas.py:134", "launches": s1["msda_fwd"],
         **k1["float32"], "at_test_canvases": test_canvas_rows(canvases, "K1"),
         "at_video_canvases": test_canvas_rows(video_canvases, "K1"),
         "at_video_train_canvases": test_canvas_rows(video_train_canvases, "K1")},
        {"name": "masked_attn_fwd", "route": "cuda", "source": csrc + "masked_attn_fwd.cu",
         "replaces": "mp_former_tpu/ops/fused_masked_attention.py:63",
         "launches": s1["masked_attn_fwd"], **k3[("float32", 100)],
         "at_q200": k3[("float32", 200)], "at_test_canvases": test_canvas_rows(canvases, "K3"),
         "at_video_canvases": test_canvas_rows(video_canvases, "K3"),
         "at_video_train_canvases": test_canvas_rows(video_train_canvases, "K3"),
         "at_dn_modes": [{"dtype": "float32", "mask": "per-head DN block", **r}
                         for r in dn_k3["K3"]]},
        {"name": "tap_weight_fwd", "route": "cuda", "source": csrc + "tap_weight_fwd.cu",
         "replaces": "mp_former_tpu/ops/tap_weighting.py:244", "launches": s2["tap_weight_fwd"],
         **k2[("headshare", "float32")]},
        {"name": "row_gather", "route": "cuda", "source": csrc + "row_gather.cu",
         "replaces": "tools/bench_sampling_engines.py:259; tools/probe_msda_kernel.py:39",
         "launches": gather["launches"]["row_gather"], **gather["P3"]},
        {"name": "row_gather_sum", "route": "cuda", "source": csrc + "row_gather.cu",
         "replaces": "tools/bench_sampling_engines.py:279",
         "launches": gather["launches"]["row_gather_sum"], **gather["P2"]},
        {"name": "msda_bwd", "route": "cuda", "source": csrc + "msda_bwd.cu",
         "replaces": "mp_former_tpu/ops/msda_pallas.py:249 (the VJP of the kernel at :134, "
                     "a recompute through XLA)",
         "launches": train["msda_bwd"], **k1_bwd[("train", "float32")],
         "at_bs16": k1_bwd[("bs16", "float32")],
         "at_video_train_canvases": test_canvas_rows(video_train_canvases, "K1_bwd")},
        {"name": "masked_attn_bwd", "route": "cuda", "source": csrc + "masked_attn_bwd.cu",
         "replaces": "mp_former_tpu/ops/fused_masked_attention.py:63 (no VJP: training takes "
                     "the einsum branch, mp_former_tpu/models/transformer_decoder/"
                     "primitives.py:72)",
         "launches": train["masked_attn_bwd"], **k3_bwd["float32"],
         "at_q200": k3_bwd[("float32", 200)],
         "at_video_train_canvases": test_canvas_rows(video_train_canvases, "K3_bwd"),
         "at_dn_modes": [{"dtype": "float32", "mask": "per-head DN block", **r}
                         for r in dn_k3["K3_bwd"]]},
        {"name": "tap_weight_bwd", "route": "cuda", "source": csrc + "tap_weight_bwd.cu",
         "replaces": "mp_former_tpu/ops/tap_weighting.py:284 (the custom_vjp's _bwd, plain XLA)",
         "launches": train_tpu["tap_weight_bwd"],
         "library": "g * w broadcast + torch.einsum (two calls; no single call computes it)",
         **k2_bwd[("headshare", "float32")]},
    ]
    for kern in kernels:
        kern["launches_by_path"] = {p: c[kern["name"]] for p, c in by_path.items()
                                    if kern["name"] in c}
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
