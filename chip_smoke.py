#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (``mx_rcnn_tpu_torch``) on one NVIDIA
GPU (built for Hopper, ``sm_90a``).

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each printing its own lines:

1. Device and build: the card's name and power limit (``nvidia-smi``), then
   ``nvcc`` builds every kernel source of the port (``csrc/*.cu``) and the
   host C++ compiler its mask library (``csrc/mxr_native.cpp``), all
   started together.
2. Kernels vs plain versions on the same CUDA inputs: the NMS case matrix
   of ``scripts/check_pallas.py`` and the sweep's cases (chains across
   block edges, ``max_out`` cuts inside and at the edge of a block,
   invalid rows; :func:`sweep_cases`), kept indices identical to
   ``nms_padded``; the mask's threshold-band cases (IoUs at and one float32
   step beside the threshold, clamped unions, coordinates at 1e5 and 1e-3,
   thresholds 0 and 1; :func:`mask_band_cases`), ``nms_mask``'s words
   bitwise equal to ``suppression_mask_plain``'s; and the assign case
   matrix (:func:`assign_cases`: padded gt with one valid at the end, holes
   or none valid, exact ties between gt and across tiles, every anchor
   outside, N below, at and off a multiple of one tile, B = 3; plus cases
   at the main path's anchor count): the chained pair's four outputs
   bitwise equal to the dense path, each kernel's bitwise equal to its own
   plain version.
3. The inference slice at full width: ResNet-101 Faster R-CNN, VOC (21
   classes), 600×1000 bucket, TEST config, bfloat16, seeded random weights.
   Four raw RGB uint8 images in batches of two go through stage → device
   prep → ``Predictor`` → ``im_detect`` → ``per_class_nms`` →
   ``detections_to_records``; both NMS kernels must launch once per batch.
   One batch is rerun in float32 (TF32 off) and ``propose``'s kept
   indices are held against the plain NMS on the same RPN outputs.
4. The training slice at full width: the same network with the TRAIN
   config, ``ASSIGN_FUSED=True``, ``FLIP=True``, bfloat16 compute on
   float32 parameters, ``SyntheticDataset`` at 600×1000 through
   ``AnchorLoader`` → ``fit`` (``BATCH`` images per step).  Every step's
   losses must be finite and each of the four kernels must launch exactly
   once per step; frozen leaves stay bitwise, trainable ones move.  Then
   ``FIT_STEPS`` steps on one fixed batch must lower the loss, the weights
   are saved de-normalized and served by ``Predictor``.  One float32 train
   forward (TF32 off) with the fused assign and one with the dense path,
   from the same weights, batch and draws, must give identical RPN labels
   and equal losses.
5. Times: each kernel with CUDA events around replays of a CUDA graph of
   ``KERNEL_RUN`` calls (its device time; ``eager_ms`` is the same calls
   made eagerly, host overhead included), its plain version with CUDA
   events around eager calls (median of ``REPS`` runs after warm-up), and
   the least time the card could take (bound): the NMS pair at the
   inference shape (6000 → 300) and at the training shape (12000 → 2000)
   on the model's RPN boxes and at the training shape on identical boxes
   (every IoU 1), the assign pair on the training batch and at
   G = 100 valid gt for N = 21 888 and FPN's N = 155 520 (each assign row
   also carries the pair's summed time and the pair's bound); and the
   median train step wall time with the fused and the dense assign.
6. The evaluation slice at full width: ``python -m
   mx_rcnn_tpu_torch.test``'s ``test_rcnn`` with the weights the training
   slice saved (ResNet-101, VOC's 21 classes, 600×1000, TEST config,
   bfloat16 compute) on a VOC2007-layout devkit it writes (four 375×500
   and 500×375 images, PNG bytes under ``.jpg`` names, so no JPEG decoder
   is needed; whether PIL is importable is printed), two images a batch,
   in three modes: serial host post-process, overlapped host
   post-process, overlapped ``--device-postprocess``.  Each mode's mAP
   lies in [0, 1]; the overlapped detections are bit-identical to the
   serial ones; every device-route detection matches a host-route one
   (score 1e-6, box 1e-3 px; the host keeps more only in ties at the
   cap); the NMS kernels launch once a batch on the host route and twice
   on the device route; ``reeval`` of the cache gives the same score.  At
   the post-process's shape (B·20 rows of 300, 100 kept) the kernels'
   kept rows equal ``nms_padded_batch``'s and are timed with their bound;
   the synchronising CUDA calls of one batch's dispatch are listed.
7. The serving slice at full width, on the same checkpoint and flags:
   ``serve.driver.build_engine`` (``Predictor`` → ``ServeEngine``), then
   ``make_server`` on a Unix socket in host-NMS mode and in ``--serve-e2e``
   mode (one ``Predictor``), serve batch 2, ``max_delay_ms`` 10:
   ``warmup`` first-dispatches 2 programs; 240 requests from 4 client
   threads at six raw sizes in both orientations (the devkit's drawing;
   the last, 1200×1600, pre-shrunk on the host) all answer 200 with the
   offline ``Predictor`` path's records on the same pixels in the batch
   row each request rode (score 1e-6, box 1e-3 px; whether the two rows
   differ is printed), and every size has detections there; no first
   dispatch after warmup; one h2d copy, dispatch and readback a batch; the
   NMS kernels launch once a batch in host-NMS mode and twice in e2e mode.
   Per mode, the traffic's requests/s, the p50/p99 of the engine's
   ``serve/{queue_wait,service_time,request_time,host_prep}`` histograms
   (bucketed) and of the clients' round trips (exact), the mean of each batch phase (``serve/{h2d,forward,readback,
   postprocess}`` spans, host clock; the forward call returns once its
   launches are queued, so the readback holds the wait for the card),
   batch fill and readback bytes a batch are printed.  Then ``python -m
   mx_rcnn_tpu_torch.serve --serve-e2e`` as a process: ready on
   ``/readyz``, four requests answered, ``/metrics?format=prom`` read,
   exit code 0 on SIGTERM.
8. The alternate-training slice at full width: ``python -m
   mx_rcnn_tpu_torch.train_alternate``'s ``alternate_train`` with the
   training slice's checkpoint as ``--pretrained`` (ResNet-101, 600×1000,
   TRAIN config, ``ASSIGN_FUSED=True``, ``FLIP=True``, bf16 compute on
   float32 parameters), ``SyntheticDataset`` of ``TRAIN_IMAGES`` images (8
   records), ``BATCH`` images a step, ``ALT_STEPS`` steps a training
   stage.  The driver's stage functions are wrapped so that every kernel
   count is set to 0 just before each stage and read just after it, and
   each stage is timed, model build included: the assign pair once a step
   in stages 1 and 4,
   the NMS pair once a record in stages 2 and 5, no kernel in stages 3 and
   6.  Each stage starts from the weights the JAX driver gives it, its
   losses are finite, its frozen leaves stay bitwise and its trainable
   ones move; every record gets at most ``TEST.RPN_POST_NMS_TOP_N``
   proposals inside its image, its batch's RoIs in score order; on stage
   5's first batch the kernels' kept rows equal ``nms_padded``'s on the
   same RPN outputs, and the pair is timed there (batch 1, 6000 → 300)
   beside its plain version and bound; the combined checkpoint holds stage
   4's backbone and RPN and stage 6's head bitwise, and a ``Predictor`` on
   it detects, the NMS pair once a batch.
9. The host input pipeline at full width (the training slice's network,
   TRAIN config, fused assign, bf16 compute), on the devkit's PNG files
   decoded by the port: ``2007_trainval`` (``TRAIN_SIZES``: eight images
   in both orientations, flipped to 16 records) and ``2007_pipe``
   (``PIPE_EVAL_IMAGES`` images, the same files under new ids).
   ``AnchorLoader`` at 0, 2 and 4 worker processes, one seed, a first epoch
   and then ``PIPE_RATE_BATCHES`` batches, and ``ROIIter``
   (``PIPE_PROPOSALS`` cached proposals a record) for two epochs: every
   batch bitwise equal to the serial producer's, and ``AnchorLoader``'s
   batches/s alone after the first epoch;
   ``fit`` for ``PIPE_STEPS`` steps from the training slice's checkpoint,
   serial and through 2 workers, the assign pair once a step and step 1's
   metrics bitwise equal; ``fit``'s step wall over ``PIPE_FIT_EPOCHS``
   epochs at 0 and 2 workers × ``--prefetch`` 0 and 2, the assign pair
   once a step; ``train_alternate`` on ``2007_trainval`` at ``--prefetch``
   0 and 2, each stage's wall, the assign pair once a step in the RPN
   stages and the NMS pair once a record in the proposal stages; the test
   driver's serial loop on ``2007_pipe`` at ``--prefetch 0`` and ``2``,
   the detections bit-identical, the NMS pair once a batch, loader wait and
   images/s of each; the server in host-NMS mode with ``--loader-workers
   2`` (the prep pool), as many requests as phase 7 over the serving
   slice's sizes answered with the offline records of their batch row,
   ``serve/host_prep`` p50/p99 beside the caller-thread figures of phase 7,
   and after ``stop()`` no worker alive and the ring gone from
   ``/dev/shm``, whose size is printed with the ring's bytes.
10. Training that survives a real run (``resilience_slice``), at the
   training slice's width from its checkpoint: ``python -m
   mx_rcnn_tpu_torch.train_end2end``'s inputs, ``RES_IMAGES`` synthetic
   images (one epoch of ``RES_STEPS`` steps at ``BATCH``).  ``fit`` with
   a step checkpoint every ``RES_SAVE_EVERY`` steps under ``--nan-policy
   skip``, twice: the largest difference between the two is the bound
   every resumed run is held to (0: bitwise).  SIGTERM from the batch
   callback after ``RES_PREEMPT_AT`` steps: a clean return with a step
   checkpoint, then ``auto_resume`` to the reference's state, the four
   kernels once a step of each run.  The driver as a process, SIGTERM once
   its first step checkpoint appears: exit 0, and rerun, the reference's
   epoch file.  ``MXR_FAULT_NAN_STEP`` under ``skip`` (parameters and
   momentum bitwise through the poisoned step), ``halt`` (raises, dumps)
   and ``rollback`` (restores, goes on finite).  One step's synchronising
   calls with the sentinel off, on and under ``skip`` (equal) and each
   one's median step wall.  A torchvision ``resnet101`` state_dict of
   seeded random tensors through ``utils/convert_torch.py`` and
   ``--pretrained``: every backbone and ``head_body`` leaf laid over, a
   ``Predictor`` on it detects.  The step checkpoint's bytes and its save
   and load times are printed.
11. COCO at full width (``coco_slice``): a set in val2017's layout written
   from the seed (8 images at 640×480, 480×640, 500×375 and 427×640, PNG
   bytes under ``.jpg`` names, COCO's 80 sparse category ids, a crowd, a
   zero-area and a past-the-edge box, an image of 110 boxes).  ``python -m
   mx_rcnn_tpu_torch.train_end2end --dataset coco``'s ``train_net`` from
   the training slice's checkpoint (ResNet-101, 81 classes, the 800×1333
   bucket padded to 800×1344, ``ASSIGN_FUSED``, ``FLIP``, ``COCO_STEPS``
   steps of ``BATCH``): each kernel once a step, the peak memory and the
   step walls.  ``python -m mx_rcnn_tpu_torch.test --dataset coco`` on
   the host route and with ``--device-postprocess``: the 12 COCO stats,
   the routes' records matched, images/s, ``COCOEval``'s host seconds;
   the ground truth as detections scores AP = AR100 = 1.  The server in
   both modes (replies equal to the offline records of their batch row),
   then ``python -m mx_rcnn_tpu_torch.demo`` on one image against the
   host route at batch 1.  The NMS pair at the post-process's 160 rows ×
   300 and the assign pair at 37 800 anchors with G = 100, each against
   its plain version, timed, with its bound.
12. FPN and Mask R-CNN inference at full width (``fpn_slice``): phase 11's
   set written again with a polygon for every non-crowd annotation and a
   compressed crowd RLE; seeded random weights of ResNet-101-FPN Mask
   R-CNN (81 classes, the 800×1344 bucket, TEST 6000 → 300 with 100
   detections an image, ``ROI_SAMPLING_RATIO`` 2, bf16).  ``python -m
   mx_rcnn_tpu_torch.test --network resnet101_fpn_mask --dataset coco``
   serial on the host route (the native C++ paste) and with
   ``--device-postprocess`` (the device paste): box and segm stats, the NMS
   pair once a batch in ``propose_fpn`` and once more on the device route,
   the routes' boxes matched, images/s, the mask passes' host seconds an
   image, peak memory, ``COCOEval`` segm's host seconds, the gt masks as
   detections at segm AP = AR100 = 1; one batch's detections through the
   three ``MASK_PASTE`` modes, each mask within ``MASK_FLIP_BOUND`` pixels
   of the numpy paste's; ``propose_fpn``'s joint NMS in float32 against
   ``nms_padded``, the NMS pair timed at the joint shape (B · 5 619 →
   300); the serve driver refusing the network by name.
13. FPN and Mask R-CNN training at full width (``fpn_train_slice``):
   phase 12's set with one more non-crowd annotation as an RLE dict;
   ``python -m mx_rcnn_tpu_torch.train_end2end --network
   resnet101_fpn_mask --dataset coco`` (ResNet-101 C2–C5, 256-channel
   neck, 81 classes, 800×1344, TRAIN 12000 → 2000, 256 anchors and 128
   RoIs an image, ``MAX_GT`` 100, 28×28 mask targets, bf16, the fused
   assign, flipped records) on seeded random weights: every loss and
   ``MaskLoss`` finite, each kernel once a step, the mask head, neck and
   RPN moved, the frozen leaves bitwise, step walls, loader wait, peak
   memory, the ``uint8`` ``gt_masks`` bytes a batch; ``test`` on the
   checkpoint (box and segm stats).  On the first step's own inputs: the
   assign pair over the 268 569 concatenated anchors bitwise against the
   dense path (and at G = 100 valid gt), the joint proposal's B · 10 419
   candidates through the NMS pair, the kept rows equal to
   ``nms_padded``'s, each pair timed with its bound; the mask targets on
   the card against the CPU outside the 0.5 band.  ``train_alternate
   --network resnet101_fpn --dataset coco``: each stage's wall and
   launches, the combined model with stage 4's neck, its box stats;
   ``train_alternate --network resnet101_fpn_mask`` refused with the JAX
   package's message.
14. One ``{"kernels": [...]}`` JSON line (each row's ``shape`` names the
   shape it was timed at: the training path's, then COCO's, then FPN's
   joint proposal, then FPN training's anchors and joint proposal), then
   the last line ``{"ok": true, "device": {...}}``.

Exits nonzero, printing no result, when CUDA is unavailable or any phase
fails.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types
import zlib

import numpy as np
import torch

# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SOURCES = {"nms_mask": "mx_rcnn_tpu_torch/csrc/nms_bitmask.cu",
           "nms_sweep": "mx_rcnn_tpu_torch/csrc/nms_bitmask.cu",
           "assign_gtmax": "mx_rcnn_tpu_torch/csrc/assign_iou.cu",
           "assign_rows": "mx_rcnn_tpu_torch/csrc/assign_iou.cu"}
REPLACES = {"nms_mask": "mx_rcnn_tpu/kernels/nms_pallas.py:62",
            "nms_sweep": "mx_rcnn_tpu/kernels/nms_pallas.py:99",
            "assign_gtmax": "mx_rcnn_tpu/kernels/assign_pallas.py:54",
            "assign_rows": "mx_rcnn_tpu/kernels/assign_pallas.py:54"}
# f32 operations of one IoU decision: min, max, sub, add per axis (8), two
# clamps, the product, union add and sub, its clamp, the divide, the compare
IOU_OPS = 16
# kernel launches per timed run (see cuda_median_ms)
KERNEL_RUN = 10
# the raw sizes of the slice's requests (h, w): landscape, all inside the
# 608×1024 bucket
RAW_SIZES = ((375, 500), (480, 640), (333, 500), (427, 640))
# images per batch on the slice, and so the B of the main path's NMS shapes
BATCH = 2
# timed runs per kernel and per plain version (the median is reported)
REPS = 20
# random weights cannot absorb the raw 0..255 pixel scale of the reference
# contract (PIXEL_STDS=1): with it the RPN deltas blow up through exp(dw)
# and the proposals collapse onto the image's edges.  The slices normalise
# as the JAX package's synthetic serving and training do
# (mx_rcnn_tpu/tools/common.py)
PIXEL_STDS = (127.0, 127.0, 127.0)
# synthetic images of the training slice (flipped too: twice the records);
# fit runs one epoch over them, BATCH per step
TRAIN_IMAGES = 4
# steps on one fixed batch that must lower the loss, and the steps timed
# per assign route (ABBA order) for the step wall time
FIT_STEPS = 20
TIMED_STEPS = 3
# FPN's concatenated anchors at the 608×1024 bucket (P2..P6 at strides 4 to
# 64, 3 anchors per cell): the shape assign_pallas.py was written for, on
# no path of the port (the FPN presets train at 800×1344:
# FPN_TRAIN_ANCHORS); timed at G = 100 beside the main path's anchors
FPN_ANCHORS = 155_520
FPN_STRIDES = (4, 8, 16, 32, 64)
# IoU threshold of the sweep cases' chains (neighbours overlap at 0.29)
CHAIN_THRESH = 0.25
LOSS_KEYS = ("rpn_cls_loss", "rpn_bbox_loss", "rcnn_cls_loss",
             "rcnn_bbox_loss")
# the evaluation slice's devkit: VOC's usual sizes (h, w) in both
# orientations, landscape first so that each batch of two holds one; its
# image set is 2007_<EVAL_SPLIT>; the classes its objects are drawn from
EVAL_SIZES = ((375, 500), (375, 500), (500, 375), (500, 375))
EVAL_SPLIT = "smoke"
# the input-pipeline slice's training images in the same devkit (image set
# 2007_<TRAIN_SPLIT>), both orientations, landscape first; flipped, twice
# the records
TRAIN_SIZES = ((375, 500), (333, 500), (480, 640), (427, 640), (500, 375),
               (500, 333), (640, 480), (640, 427))
TRAIN_SPLIT = "trainval"
EVAL_CLASSES = ("aeroplane", "bicycle", "bird", "car", "dog", "person")
# the test driver's flags for the slice: the full network at the TEST
# config, pixels scaled as the training slice scaled them
EVAL_FLAGS = ["--network", "resnet101", "--dataset", "PascalVOC",
              "--cfg", f"network__PIXEL_STDS={PIXEL_STDS!r}"]
# the serving slice's raw sizes (h, w), both orientations; the last is
# larger than the 608×1024 bucket (the host pre-shrink); its requests a
# mode, sent by its client threads over the server's Unix socket (enough
# that a p99 is not just the slowest request: the 3rd slowest of 240)
SERVE_SIZES = ((375, 500), (500, 375), (600, 1000), (1000, 600), (480, 640),
               (1200, 1600))
SERVE_REQUESTS = 240
SERVE_CLIENTS = 4
# the alternate-training slice: the training slice's network, TRAIN config
# and fused assign on the synthetic dataset (TRAIN_IMAGES images, flipped),
# BATCH images a step, ALT_STEPS steps in each of its four training stages
ALT_FLAGS = ["--network", "resnet101", "--dataset", "PascalVOC",
             "--cfg", "tpu__ASSIGN_FUSED=True"]
ALT_STEPS = 2
# the input-pipeline slice: the worker count held against the serial
# producer, the counts whose loader rate is printed and the batches each
# rate is read over (after a first epoch), cached proposals per record for
# ROIIter, fit's steps for the bitwise check, the epochs of the timed fit
# runs (the first one not timed) and the prefetch depths they compare, the
# images of the eval split 2007_<PIPE_EVAL_SPLIT> (TRAIN_SIZES' images
# again under new ids), and the requests through the prep pool (phase 7's
# count, so that both p99 are read over as many requests); the rate
# batches, fit epochs and eval images are cut so that the whole smoke stays
# near half its time limit as phases are added
PIPE_WORKERS = 2
PIPE_RATE_WORKERS = (0, 2, 4)
PIPE_RATE_BATCHES = 64
PIPE_PROPOSALS = 64
PIPE_STEPS = 2
PIPE_FIT_EPOCHS = 3
PIPE_PREFETCH = (0, 2)
PIPE_EVAL_SPLIT = "pipe"
PIPE_EVAL_IMAGES = 24
PIPE_REQUESTS = SERVE_REQUESTS
# the resilience slice: the synthetic images of one epoch of RES_STEPS
# steps at BATCH (flipped), a step checkpoint every RES_SAVE_EVERY steps,
# the SIGTERM after RES_PREEMPT_AT steps, NaN images at consumed batch
# RES_NAN_AT, the step wall over 2 × RES_TIMED_STEPS steps a variant
RES_IMAGES = 6
RES_STEPS = 6
RES_SAVE_EVERY = 2
RES_PREEMPT_AT = 3
RES_NAN_AT = 3
RES_TIMED_STEPS = 15
RES_FLAGS = ["--network", "resnet101", "--dataset", "PascalVOC",
             "--synthetic", "--synthetic_images", str(RES_IMAGES),
             "--batch_images", str(BATCH), "--cfg", "tpu__ASSIGN_FUSED=True",
             "--end_epoch", "1", "--frequent", "1"]
RES_PROC_TIMEOUT_S = 600
# the COCO slice: a set of val2017's layout written from the seed, its
# images (h, w) at COCO's usual sizes, landscape first so that a batch of
# two holds one orientation; COCO's 80 sparse category ids; the image
# with more non-crowd boxes than MAX_GT; the training steps of the driver
# run, the requests a serving mode, and the driver flags (the training
# ones add the fused assign)
COCO_SPLIT = "val2017"
COCO_SIZES = ((480, 640), (375, 500), (480, 640), (375, 500), (640, 480),
              (640, 427), (640, 480), (640, 427))
COCO_IDS = tuple(i for i in range(1, 91)
                 if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83))
COCO_MANY = 110
COCO_STEPS = 4
COCO_REQUESTS = 16
COCO_STATS = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10",
              "AR100", "ARs", "ARm", "ARl")
COCO_FLAGS = ["--network", "resnet101", "--dataset", "coco",
              "--cfg", f"network__PIXEL_STDS={PIXEL_STDS!r}"]
# the FPN / Mask R-CNN slice: the test driver's flags (ResNet-101-FPN Mask
# R-CNN on the COCO preset, pixels scaled as the other slices), and the
# pixels a mask may differ by between two paste modes (float32 products
# rounded in another order flip pixels within an ulp of 0.5; the CPU
# tests' bound)
FPN_FLAGS = ["--network", "resnet101_fpn_mask", "--dataset", "coco",
             "--cfg", f"network__PIXEL_STDS={PIXEL_STDS!r}"]
MASK_FLIP_BOUND = 3
# the FPN / Mask R-CNN training slice: the drivers' flags but the network
# (the COCO preset, the fused assign, pixels scaled as the other slices),
# the end-to-end run's steps, the steps of each alternate training stage,
# the concatenated P2–P6 anchors of the 800×1344 bucket (3 a cell at
# strides 4 … 64: 201 600 + 50 400 + 12 600 + 3 150 + 819), the joint
# proposal's candidates at the TRAIN config (12000 // 5 = 2 400 a level,
# P6 has 819), and the band around 0.5 inside which a mask target pixel may
# threshold either way between two libraries' float32 sums
FPN_TRAIN_FLAGS = ["--dataset", "coco",
                   "--cfg", f"network__PIXEL_STDS={PIXEL_STDS!r}",
                   "--cfg", "tpu__ASSIGN_FUSED=True"]
FPN_TRAIN_STEPS = 4
FPN_ALT_STEPS = 2
FPN_TRAIN_ANCHORS = 268_569
FPN_TRAIN_CANDIDATES = 4 * 2_400 + 819
MASK_TARGET_BAND = 1e-5
# phase 14, VGG-16 Faster R-CNN: the VOC devkit of write_devkit; the 600×1000
# bucket pads to 608×1008 at stride 16 (IMAGE_STRIDE 0), 38 × 63 × 9 anchors.
# The random head's class scores sit below 1/21 after a few steps (the
# background takes the rest), so detections are kept from 0.001: the
# served replies are held to offline records that are not empty
VGG_FLAGS = ["--network", "vgg16", "--dataset", "PascalVOC",
             "--cfg", "network__PIXEL_STDS=(127.0,127.0,127.0)",
             "--cfg", "TEST__THRESH=0.001",
             "--cfg", "tpu__ASSIGN_FUSED=True"]
VGG_STEPS = 4
VGG_ALT_STEPS = 2
VGG_REQUESTS = 16
VGG_ANCHORS = 21_546
VGG_PARAMS = 137_078_239
# the float32 R-CNN forward on the card against CPU copies (TF32 off)
VGG_F32_RTOL = 1e-4


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def gen(n, seed, spread=800.0, size=150.0):
    """``scripts/check_pallas.py``'s case generator: score-sorted boxes."""
    rng = np.random.RandomState(seed)
    ctr = rng.rand(n, 2) * spread
    wh = rng.rand(n, 2) * size + 10
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)
    scores = np.sort(rng.rand(n).astype(np.float32))[::-1].copy()
    return boxes, scores


def chain_boxes(n: int, chains=()) -> np.ndarray:
    """(n, 4) float32 boxes, 10-pixel squares in one row, in score order.
    Inside each index range [a, b) of ``chains`` the boxes step 6 pixels,
    so each overlaps only its two neighbours (IoU 55/187 = 0.29 with the
    legacy +1 areas) and greedy NMS at ``CHAIN_THRESH`` keeps a, a+2, ...
    (A kept, B removed, C kept); every other box stands 20 pixels from the
    one before and overlaps nothing."""
    step = np.full(n, 20.0)
    step[0] = 0.0
    for a, b in chains:
        step[a + 1:b] = 6.0
    x = np.cumsum(step)
    return np.stack([x, np.zeros(n), x + 10.0, np.full(n, 10.0)],
                    1).astype(np.float32)


def sweep_cases() -> dict:
    """The sweep's case matrix: {name: (boxes (B, n, 4) float32 in score
    order, valid (B, n) bool, max_out, thresh)}.  Chains across the 63/64
    and 127/128 block edges; the max_out cut inside a block, at a block's
    last row and past n; all boxes disjoint; invalid rows first and inside
    chains; n of 1, 63, 64, 65 and 4097; three images with different
    holes."""
    cases = {}

    def add(name, boxes, valid, max_out, thresh=CHAIN_THRESH):
        boxes = boxes if boxes.ndim == 3 else boxes[None]
        valid = valid if valid.ndim == 2 else valid[None]
        cases[name] = (boxes, valid, max_out, thresh)

    ones = lambda n: np.ones(n, bool)
    edges = chain_boxes(200, [(58, 70), (121, 134)])
    add("chains-across-63-64-and-127-128", edges, ones(200), 300)
    v = ones(200)
    v[[62, 66, 127]] = False   # the parity flips after each: 63 is kept
    add("invalid-rows-inside-chains", edges, v, 300)
    v = ones(130)
    v[0] = False
    add("invalid-first-row", chain_boxes(130, [(0, 130)]), v, 300)
    chain = chain_boxes(300, [(0, 300)])
    add("chain-cut-inside-a-block", chain, ones(300), 40)  # last kept: 78
    # rows 0, 1, 3, ..., 63: the cut falls on block 0's last row
    add("chain-cut-at-a-block-edge", chain_boxes(300, [(1, 300)]), ones(300),
        33)
    add("disjoint", chain_boxes(130), ones(130), 300)
    for max_out in (64, 100, 128):
        add(f"disjoint-cut-at-{max_out}", chain_boxes(200), ones(200), max_out)
    for n in (1, 63, 64, 65, 4097):
        add(f"n={n}-chain", chain_boxes(n, [(0, n)]), ones(n), n // 2 + 3)
        add(f"n={n}-random", gen(n, n)[0],
            np.random.RandomState(n).rand(n) > 0.02, 300, 0.7)
    holes = np.ones((3, 257), bool)
    holes[0, 64] = False
    holes[1, [0, 63, 128]] = False
    holes[2, 100:140] = False
    add("B=3-chains-holes-per-image",
        np.stack([chain_boxes(257, [(0, 257)])] * 3), holes, 300)
    add("B=3-random-holes-per-image",
        np.stack([gen(1000, s)[0] for s in range(3)]),
        np.stack([np.random.RandomState(100 + s).rand(1000) > 0.05
                  for s in range(3)]), 300, 0.7)
    return cases


def iou32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float32 IoU of (..., 4) boxes, rounded operation by operation in the
    order of ``ops/boxes.py:bbox_overlaps`` (legacy +1 areas, union clamped
    at 1e-14)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    one = np.float32(1)
    iw = np.maximum(np.minimum(a[..., 2], b[..., 2])
                    - np.maximum(a[..., 0], b[..., 0]) + one, np.float32(0))
    ih = np.maximum(np.minimum(a[..., 3], b[..., 3])
                    - np.maximum(a[..., 1], b[..., 1]) + one, np.float32(0))
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0] + one) * (a[..., 3] - a[..., 1] + one)
    area_b = (b[..., 2] - b[..., 0] + one) * (b[..., 3] - b[..., 1] + one)
    return inter / np.maximum(area_a + area_b - inter, np.float32(1e-14))


def band_pairs(t: float, o: float, dx: float, dy: float) -> list:
    """Pairs of boxes (a, b) whose float32 IoU straddles ``t``: box a is
    [o, o, o+dx, o+dy]; box b moves one float32 coordinate (its x1, its x2
    or its y1) ulp by ulp across the point where the IoU crosses t.  Kept
    per coordinate: the last pair with IoU <= t, the first with IoU > t,
    every pair with IoU == float32(t), and the pairs 2^k ulps (k = 0..8)
    either side of the crossing."""
    t32 = np.float32(t)
    a = np.float32([o, o, o + dx, o + dy])
    walks = (  # b as a function of the walked value v, and v's range
        (lambda v: [v, a[1], v + np.float32(dx), a[3]], a[0], a[2] + 1),
        (lambda v: [a[0], a[1], v, a[3]], a[0] - 1, a[2]),
        (lambda v: [a[0], v, a[2], v + np.float32(dy)], a[1], a[3] + 1))
    bits = lambda v: int(np.float32(v).view(np.int32))
    at = lambda i: np.int32(i).view(np.float32)
    pairs = []
    for walk, lo, hi in walks:
        box = lambda i: np.float32(walk(at(i)))
        over = lambda i: bool(iou32(a, box(i)) > t32)
        lo, hi = bits(lo), bits(hi)
        if over(lo) == over(hi):
            continue
        while hi - lo > 1:           # bisection over adjacent float32s
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if over(mid) == over(lo) else (lo, mid)
        keep = {lo, hi}
        under, other = (hi, lo) if over(lo) else (lo, hi)
        i = under                    # the pairs at exactly float32(t)
        while iou32(a, box(i)) == t32:
            keep.add(i)
            i += under - other
        keep |= {x + s * 2 ** k for x in (lo, hi) for s in (-1, 1)
                 for k in range(9)}
        pairs += [(a, box(i)) for i in sorted(keep)]
    return pairs


def mask_band_cases() -> dict:
    """The mask's threshold-band case family: {name: (boxes (1, n, 4)
    float32, thresh)}.  IoUs at and next to each threshold, found by
    walking a coordinate ulp by ulp (:func:`band_pairs`), at thresholds
    0.7, 0.5, 0.3, 0.25, 0.01 and 0.99 and n of 65, 127 and 4097 (a last,
    partial tile of 1, 63 and 1 columns, beside the diagonal tiles);
    zero-area, inverted and tiny boxes whose union is clamped at 1e-14;
    coordinates at the scale of 1e5 and of 1e-3; thresholds 0.0 and 1.0.
    Rows cycle through the pairs, so every tile holds pairs of the band."""
    cases = {}

    def rows(pairs, n):
        flat = np.stack([box for pair in pairs for box in pair])
        return np.resize(flat, (n, 4))[None].astype(np.float32)

    def band(t):                     # the pairs nearest t first
        pairs = [p for o, dx, dy in ((10.0, 99.0, 99.0), (300.5, 47.0, 131.0),
                                     (1000.25, 15.0, 15.0))
                 for p in band_pairs(t, o, dx, dy)]
        return sorted(pairs, key=lambda p: abs(float(iou32(*p)) - t))

    for t in (0.7, 0.5, 0.3, 0.25, 0.01, 0.99):
        pairs = band(t)
        for n in (65, 127, 4097):
            cases[f"band-t={t}-n={n}"] = (rows(pairs, n), t)
    rng = np.random.RandomState(6)
    # legacy width x2 - x1 + 1 of 0, < 0, and 2^-24 or 2^-23 (areas under
    # 1e-14, so the union is clamped), beside ordinary boxes
    x1 = rng.randint(0, 40, 127).astype(np.float32)
    y1 = rng.randint(0, 40, 127).astype(np.float32)
    ext = np.float32([0.0, -1.0, -3.5, -1.0 + 2.0 ** -24, -1.0 + 2.0 ** -23,
                      -0.5, 9.0, 30.0])
    deg = np.stack([x1, y1, x1 + rng.choice(ext, 127),
                    y1 + rng.choice(ext, 127)], 1)
    deg[::7] = [0, 0, -1 + 2.0 ** -24, -1 + 2.0 ** -24]   # identical tiny ones
    cases["degenerate-boxes-t=0.3"] = (deg[None].astype(np.float32), 0.3)
    for scale, t, side in ((1e5, 0.7, 99.0), (1e-3, 0.999, 2e-3)):
        base = (scale * (1 + rng.rand(60, 2))).astype(np.float32)
        rand = np.concatenate(
            [base, base + (scale * rng.rand(60, 2)).astype(np.float32)], 1)
        pairs = band_pairs(t, scale, side, side) + list(
            zip(rand[::2], rand[1::2]))
        cases[f"scale-{scale:g}-t={t}"] = (rows(pairs, 127), t)
    for t in (0.0, 1.0):             # no fast decision in the kernel
        pairs = band(0.7) + [(b, b) for b in deg[:20]]
        cases[f"t={t}-n=127"] = (rows(pairs, 127), t)
    return cases


def cuda_median_ms(fn, per_rep: int = 1, warmup: int = 3) -> float:
    """Median over ``REPS`` timed runs of the device time of one call, each
    run ``per_rep`` calls back to back between two CUDA events (several
    calls keep the queue full, so the host's launch overhead between the
    events does not count as kernel time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


def graph_median_ms(fn, per_rep: int = KERNEL_RUN) -> float:
    """Device time of one call: ``per_rep`` calls captured once in a CUDA
    graph, the graph replayed between two CUDA events ``REPS`` times
    (median over ``per_rep``).  Eager calls of a small kernel measure the
    host's Python and launch overhead between launches instead; the
    replay leaves that out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_rep):
            fn()
    return cuda_median_ms(graph.replay) / per_rep


# ---- phase 2 ----------------------------------------------------------------

def check_nms_matrix(nms_cuda, nms_padded, dev) -> int:
    """Every case of check_pallas.py's matrix and of :func:`sweep_cases`:
    the kernels' kept indices must equal the plain version's.  Returns the
    number of cases."""
    def one(name, boxes, scores, max_out, thresh, valid):
        b = torch.from_numpy(boxes).to(dev)
        s = torch.from_numpy(scores).to(dev)
        v = torch.from_numpy(valid).to(dev)
        ki, km = nms_cuda.nms_bitmask(b[None], v[None], max_out, thresh)
        ri, rm = nms_padded(b, s, max_out, thresh, valid=v)
        if not torch.equal(ki[0][km[0]], ri[rm]):
            fail(f"NMS mismatch [{name}] n={len(boxes)} max_out={max_out} "
                 f"thresh={thresh}: kept {int(km.sum())} vs {int(rm.sum())}")
        if ki[0][~km[0]].any():
            fail(f"NMS [{name}]: a padded slot is not 0")

    cases = 0
    for seed in range(5):
        for n, max_out, thresh in ((2048, 300, 0.7), (6000, 300, 0.7),
                                   (12000, 2000, 0.7), (4000, 100, 0.3),
                                   (100, 300, 0.5), (4097, 300, 0.7),
                                   (4000, 300, 0.99), (4000, 300, 0.01)):
            boxes, scores = gen(n, seed)
            valid = np.random.RandomState(seed).rand(n) > 0.02
            one(f"seed {seed}", boxes, scores, max_out, thresh, valid)
            cases += 1
    box1 = np.tile(np.float32([[10., 10., 60., 60.]]), (512, 1))
    sc1 = np.sort(np.random.RandomState(0).rand(512).astype(np.float32))[::-1]
    sc1 = sc1.copy()
    for name, args in {
            "identical-boxes": (box1, sc1, 300, 0.7, np.ones(512, bool)),
            "all-invalid": (box1, sc1, 300, 0.7, np.zeros(512, bool)),
            "single-box": (box1[:1], sc1[:1], 300, 0.7, np.ones(1, bool))
    }.items():
        one(name, *args)
        cases += 1
    # batched, with a different invalid hole in each image
    bb = torch.from_numpy(np.stack([gen(2048, s)[0] for s in range(3)])).to(dev)
    vv = torch.from_numpy(np.stack([
        np.random.RandomState(100 + s).rand(2048) > 0.05
        for s in range(3)])).to(dev)
    ki, km = nms_cuda.nms_bitmask(bb, vv, 300, 0.7)
    for b in range(3):
        s = torch.from_numpy(gen(2048, b)[1]).to(dev)
        ri, rm = nms_padded(bb[b], s, 300, 0.7, valid=vv[b])
        if not torch.equal(ki[b][km[b]], ri[rm]):
            fail(f"NMS mismatch [batched b={b}]: kept {int(km[b].sum())} vs "
                 f"{int(rm.sum())}")
    cases += 1
    for name, (boxes, valid, max_out, thresh) in sweep_cases().items():
        bb = torch.from_numpy(boxes).to(dev)
        vv = torch.from_numpy(valid).to(dev)
        ki, km = nms_cuda.nms_bitmask(bb, vv, max_out, thresh)
        order = torch.arange(bb.shape[1], 0, -1, dtype=torch.float32,
                             device=dev)
        for b in range(bb.shape[0]):
            ri, rm = nms_padded(bb[b], order, max_out, thresh, valid=vv[b])
            if not (torch.equal(ki[b], ri) and torch.equal(km[b], rm)):
                fail(f"NMS mismatch [{name}, image {b}]: kept "
                     f"{int(km[b].sum())} vs {int(rm.sum())}")
        cases += 1
    # past the sweep's 48 KB of default shared memory (n = 110 000): a mask
    # in which each odd row removes the next, row 64w+63 across the edge
    n = 110_000
    words = torch.zeros((1, n, nms_cuda.col_blocks(n)), dtype=torch.int64,
                        device=dev)
    odd = torch.arange(1, n - 1, 2, device=dev)
    words[0, odd, (odd + 1) // 64] = torch.ones_like(odd) << ((odd + 1) % 64)
    want = torch.cat([odd.new_zeros(1), odd, odd.new_full((1,), n - 1)])
    ki, km = nms_cuda.nms_sweep(words, torch.ones((1, n), dtype=torch.bool,
                                                  device=dev), len(want) + 7)
    k = len(want)
    if not (torch.equal(ki[0, :k].long(), want) and km[0, :k].all()
            and not km[0, k:].any() and not ki[0, k:].any()):
        fail("nms_sweep past 48 KB of shared memory: wrong rows kept")
    return cases + 1


def check_mask_band(nms_cuda, nms_padded, dev) -> int:
    """Every case of :func:`mask_band_cases`: ``nms_mask``'s upper words
    bitwise equal to ``suppression_mask_plain``'s, and ``nms_bitmask``'s
    kept rows equal to ``nms_padded``'s.  Returns the number of cases."""
    cases = mask_band_cases()
    for name, (boxes, thresh) in cases.items():
        bb = torch.from_numpy(boxes).to(dev)
        n = bb.shape[1]
        diff = (nms_cuda.nms_mask(bb, thresh)
                ^ nms_cuda.suppression_mask_plain(bb, thresh))
        up = upper_blocks(n, nms_cuda.col_blocks(n), dev)
        if diff[:, up].any():
            fail(f"nms_mask disagrees with its plain version [{name}] in "
                 f"{int((diff[:, up] != 0).sum())} words")
        valid = torch.ones((1, n), dtype=torch.bool, device=dev)
        ki, km = nms_cuda.nms_bitmask(bb, valid, 300, thresh)
        order = torch.arange(n, 0, -1, dtype=torch.float32, device=dev)
        ri, rm = nms_padded(bb[0], order, 300, thresh, valid=valid[0])
        if not (torch.equal(ki[0], ri) and torch.equal(km[0], rm)):
            fail(f"NMS mismatch [{name}]: kept {int(km.sum())} vs "
                 f"{int(rm.sum())}")
    return len(cases)


def assign_case(rng, anchors, im_hw, n_gt, g, size=(20.0, 60.0)):
    """``tests/test_assign_fused.py``'s case on any anchor set: ``n_gt``
    random gt boxes of side size[0] + U·size[1] inside an im_hw image,
    padded to ``g``; the inside mask of that image."""
    im_h, im_w = im_hw
    span = size[0] + size[1]
    gt = np.zeros((g, 4), np.float32)
    for i in range(n_gt):
        x1, y1 = rng.rand(2) * np.array([im_w - span, im_h - span])
        gt[i] = [x1, y1, x1 + size[0] + rng.rand() * size[1],
                 y1 + size[0] + rng.rand() * size[1]]
    valid = np.arange(g) < n_gt
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[:, 2] < im_w) & (anchors[:, 3] < im_h))
    return gt, valid, inside


def assign_cases(all_anchors, generate_anchors) -> dict:
    """The assign case matrix at CPU-test sizes: name → (anchors (N, 4), gt
    (B, G, 4), gt_valid (B, G), inside (B, N)).  Padded gt with one valid
    at the end, holes or none valid; exact ties between gt and across
    tiles; every anchor outside; N below one 256-anchor tile, N a
    multiple of it and not; B = 3."""
    base = generate_anchors(scales=(1, 2, 4))
    small = all_anchors(10, 12, 16, base)          # N = 1080 = 4 · 256 + 56
    hw = (160, 192)
    cases = {}

    def add(name, anchors, per):
        cases[name] = (anchors,) + tuple(np.stack([p[k] for p in per])
                                         for k in range(3))

    for seed, n_gt in enumerate((0, 1, 5, 16)):
        add(f"{n_gt} of 16 gt", small,
            [assign_case(np.random.RandomState(seed), small, hw, n_gt, 16)])
    gt, valid, inside = assign_case(np.random.RandomState(7), small, hw, 3,
                                    16)
    gt[1] = gt[0]                                    # exact ties
    add("duplicate gt", small, [(gt, valid, inside)])
    add("all outside", small, [(gt, valid, np.zeros_like(inside))])
    gt, valid, inside = assign_case(np.random.RandomState(8), small, hw, 100,
                                    100)
    add("last of 100 valid", small, [(gt, np.arange(100) == 99, inside)])
    add("none of 100 valid", small, [(gt, np.zeros(100, bool), inside)])
    holes = np.arange(100) < 40
    holes[[0, 5, 6, 7, 8, 33]] = False
    add("holes in 100", small, [(gt, holes, inside)])
    # the whole image as a gt: every inside anchor of one shape ties for
    # its maximum, across tiles; and a copy of one anchor (IoU 1)
    gt = np.zeros((16, 4), np.float32)
    gt[0] = [0, 0, hw[1] - 1, hw[0] - 1]
    gt[1] = small[500]
    valid = np.arange(16) < 2
    add("gt max tied across tiles", small, [(gt, valid, inside)])
    gt = np.zeros((16, 4), np.float32)
    gt[0] = [400, 400, 430, 420]                     # overlaps no anchor
    gt[1] = small[777]
    add("gt overlapping nothing", small, [(gt, valid, inside)])
    tiny = all_anchors(3, 5, 16, base)               # N = 135
    add("N=135 below one tile", tiny,
        [assign_case(np.random.RandomState(9), tiny, (48, 80), 4, 16,
                     (8.0, 24.0))])
    whole = all_anchors(16, 16, 16, base)            # N = 2304 = 9 · 256
    add("N=2304 nine tiles", whole,
        [assign_case(np.random.RandomState(10), whole, (256, 256), 8, 16)])
    per = [assign_case(np.random.RandomState(20 + b), small, hw, n, 16)
           for b, n in enumerate((3, 9, 6))]
    per[1][1][2] = False                             # a hole in the run
    add("B=3 with holes", small, per)
    return cases


def check_assign(assign_cuda, name, args) -> None:
    """One case through the kernels on the card: the chained pair
    (``assign_reduce``) bitwise equal to the dense path, and each kernel
    bitwise equal to its own plain version on the same inputs."""
    def same(got, want, what):
        for x, y in zip(got, want, strict=True):
            if x.dtype != y.dtype or not torch.equal(x, y):
                fail(f"{what} disagrees with its plain version [{name}]")

    same(assign_cuda.assign_reduce(*args),
         assign_cuda.assign_reduce_plain(*args), "assign_reduce")
    phase1 = assign_cuda.assign_gtmax(*args)
    same(phase1, assign_cuda.gtmax_partials_plain(*args), "assign_gtmax")
    same([assign_cuda.assign_rows(*args, *phase1[2:])],
         [assign_cuda.rows_plain(*args, *phase1[2:])], "assign_rows")


def check_assign_matrix(assign_cuda, all_anchors, generate_anchors, dev,
                        main_anchors, main_hw) -> int:
    """:func:`assign_cases` and cases at the main path's anchor count
    through :func:`check_assign`.  Returns the number of cases."""
    def on_card(*arrays):
        return tuple(torch.from_numpy(x).to(dev) for x in arrays)

    cases = assign_cases(all_anchors, generate_anchors)
    big = (40.0, 360.0)
    for g in (100, 128):
        gt, valid, inside = assign_case(np.random.RandomState(g), main_anchors,
                                        main_hw, g, g, big)
        cases[f"G={g} main"] = (main_anchors, gt[None], valid[None],
                                inside[None])
        if g == 100:
            cases["last of 100 valid, main"] = (
                main_anchors, gt[None], (np.arange(g) == g - 1)[None],
                inside[None])
    per = [assign_case(np.random.RandomState(30 + b), main_anchors, main_hw,
                       n, 100, big) for b, n in enumerate((3, 40, 17))]
    valid = np.stack([p[1] for p in per])
    valid[1, 5:9] = False                            # holes in the valid run
    valid[2, 0] = False
    cases["B=3 holes main"] = (main_anchors, np.stack([p[0] for p in per]),
                               valid, np.stack([p[2] for p in per]))
    per = [assign_case(np.random.RandomState(40 + b), main_anchors, main_hw,
                       6, 100, big) for b in range(BATCH)]
    cases["main path shape"] = (main_anchors,) + tuple(
        np.stack([p[i] for p in per]) for i in range(3))
    for name, arrays in cases.items():
        check_assign(assign_cuda, name, on_card(*arrays))
    return len(cases)


# ---- times ------------------------------------------------------------------

def upper_blocks(n: int, cb: int, dev) -> torch.Tensor:
    """(n, cb) bool: the words the mask kernel writes (its row's own
    64-row block and every block right of it)."""
    return (torch.arange(cb, device=dev)[None, :]
            >= (torch.arange(n, device=dev) // 64)[:, None])


def mask_bound(b: int, n: int, cb: int):
    """(bytes, ops) the suppression mask must move and compute: boxes read
    once, the upper-triangle words written once, n(n-1)/2 IoUs."""
    rows = np.minimum(64, n - 64 * np.arange(cb))
    words = int(np.sum(rows * (cb - np.arange(cb))))
    return b * (n * 16 + words * 8), b * n * (n - 1) // 2 * IOU_OPS


def sweep_bound(keep_idx, keep_mask, n: int, cb: int, max_out: int):
    """(bytes, ops) of the sweep on this run's data: the valid flags, the
    words of every kept row from its own block on (read and ORed once),
    the outputs."""
    kept = keep_idx[keep_mask].to(torch.int64)
    words = int((cb - kept // 64).sum())
    b = keep_idx.shape[0]
    return b * n + words * 8 + b * max_out * 5, words


def bound_of(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(nms_cuda, boxes, valid, max_out, thresh):
    """Both kernels and their plain versions on the same inputs: results
    compared, times and bounds measured.  Returns one dict per kernel."""
    b, n, _ = boxes.shape
    cb = nms_cuda.col_blocks(n)
    dev = boxes.device
    shifts = torch.arange(64, dtype=torch.int64, device=dev)

    words = nms_cuda.nms_mask(boxes, thresh)
    plain_words = nms_cuda.suppression_mask_plain(boxes, thresh)
    up = upper_blocks(n, cb, dev)
    diff = (words ^ plain_words)[:, up]
    mask_err = float(((diff[..., None] >> shifts) & 1).max()) if diff.numel() \
        else 0.0
    ki, km = nms_cuda.nms_sweep(words, valid, max_out)
    pi, pm = nms_cuda.sweep_plain(words, valid, max_out)
    sweep_err = float(max((ki.long() - pi.long()).abs().max(),
                          (km.long() - pm.long()).abs().max()))
    mask = lambda: nms_cuda.nms_mask(boxes, thresh)
    sweep = lambda: nms_cuda.nms_sweep(words, valid, max_out)
    mask_plain_ms = cuda_median_ms(
        lambda: nms_cuda.suppression_mask_plain(boxes, thresh))
    sweep_plain_ms = cuda_median_ms(
        lambda: nms_cuda.sweep_plain(words, valid, max_out))
    mb, mb_by = bound_of(*mask_bound(b, n, cb))
    sb, sb_by = bound_of(*sweep_bound(ki, km, n, cb, max_out))
    return [
        {"name": "nms_mask", "max_abs_err": mask_err,
         "ms": graph_median_ms(mask),
         "eager_ms": cuda_median_ms(mask, KERNEL_RUN),
         "plain_ms": mask_plain_ms, "bound_ms": mb, "bound_by": mb_by,
         "library_ms": None},
        {"name": "nms_sweep", "max_abs_err": sweep_err,
         "ms": graph_median_ms(sweep),
         "eager_ms": cuda_median_ms(sweep, KERNEL_RUN),
         "plain_ms": sweep_plain_ms, "bound_ms": sb, "bound_by": sb_by,
         "library_ms": None, "kept": [int(x) for x in km.sum(1)]},
    ]


def fpn_anchors(all_anchors, generate_anchors, hw=(608, 1024)):
    """The FPN presets' concatenated P2..P6 anchors of one bucket."""
    out = np.concatenate([
        all_anchors(-(-hw[0] // st), -(-hw[1] // st), st,
                    generate_anchors(base_size=st, scales=(8,)))
        for st in FPN_STRIDES])
    if len(out) != FPN_ANCHORS:
        fail(f"expected {FPN_ANCHORS} FPN anchors, built {len(out)}")
    return out


def assign_bounds(anchors, gt_valid, inside, gt_max, partials, tile):
    """{kernel: (bytes, ops)} of the assign pair on these inputs, and of
    the pair as a whole under "pair", counting what the function needs:
    anchors, flags and gt read once, the four outputs written once with
    argmax as the int32 of the TPU kernel's contract (the design's
    per-tile partials are not the function's traffic), and one IoU for
    every (anchor, valid gt) pair.  assign_gtmax: the inputs, three
    outputs and every IoU.  assign_rows: the inputs and gt_max read, the
    tie flag written, and the IoUs of the inside anchors of the tiles
    whose partial equals a positive gt_max, for that gt (no other tile
    can tie)."""
    b, g = gt_valid.shape
    n = anchors.shape[0]
    n_valid = gt_valid.sum(1).to(torch.int64)
    inputs = n * 16 + b * n + b * g * 17
    pair_ops = int((n * n_valid).sum()) * IOU_OPS
    tiles = partials.shape[1]
    ins = torch.nn.functional.pad(inside, (0, tiles * tile - n)).view(
        b, tiles, tile)
    cand = ((partials == gt_max[:, None, :]) & gt_valid[:, None, :]
            & (gt_max[:, None, :] > 0))                         # (B, T, G)
    rows_ops = int((ins.sum(2, dtype=torch.int64)[:, :, None]
                    * cand).sum()) * IOU_OPS
    return {"assign_gtmax": (inputs + b * n * 8 + b * g * 4, pair_ops),
            "assign_rows": (inputs + b * g * 4 + b * n, rows_ops),
            "pair": (inputs + b * n * 9 + b * g * 4, pair_ops)}


def time_assign(assign_cuda, anchors, gt, valid, inside):
    """Both assign kernels and their plain versions on the same inputs:
    results compared bitwise (each kernel with its own plain version, the
    chained pair with the dense path), times and bounds measured; each
    row carries the pair's summed time and the pair's bound."""
    args = (anchors, gt, valid, inside)
    phase1 = assign_cuda.assign_gtmax(*args)
    gm, parts = phase1[2:]
    gtmax_err = max(float((x.double() - y.double()).abs().max())
                    for x, y in zip(phase1, assign_cuda.gtmax_partials_plain(
                        *args), strict=True))
    tie = assign_cuda.assign_rows(*args, gm, parts)
    rows_err = float((tie != assign_cuda.rows_plain(*args, gm, parts))
                     .sum())
    if any(not torch.equal(x, y) for x, y in zip(
            phase1[:3] + (tie,), assign_cuda.assign_reduce_plain(*args),
            strict=True)):
        fail(f"the assign pair disagrees with the dense path at "
             f"N={anchors.shape[0]}, G={gt.shape[1]}")
    bounds = assign_bounds(anchors, valid, inside, gm, parts,
                           assign_cuda.TILE)
    out = []
    for name, err, fn, plain in (
            ("assign_gtmax", gtmax_err,
             lambda: assign_cuda.assign_gtmax(*args),
             lambda: assign_cuda.gtmax_partials_plain(*args)),
            ("assign_rows", rows_err,
             lambda: assign_cuda.assign_rows(*args, gm, parts),
             lambda: assign_cuda.rows_plain(*args, gm, parts))):
        t, by = bound_of(*bounds[name])
        out.append({"name": name, "max_abs_err": err,
                    "ms": graph_median_ms(fn),
                    "eager_ms": cuda_median_ms(fn, KERNEL_RUN),
                    "plain_ms": cuda_median_ms(plain), "bound_ms": t,
                    "bound_by": by, "library_ms": None})
    pair_t, pair_by = bound_of(*bounds["pair"])
    for row in out:
        row.update(pair_ms=out[0]["ms"] + out[1]["ms"], pair_bound_ms=pair_t,
                   pair_bound_by=pair_by)
    return out


# ---- the slice --------------------------------------------------------------

def run_slice(port, predictor, cfg, images, batch_size: int):
    """Stage → prep → predict → im_detect → per_class_nms → records, batch
    by batch; returns (records per image, wall seconds per batch)."""
    image_mod, tester, post = port
    stride = max(cfg.network.IMAGE_STRIDE, cfg.network.RPN_FEAT_STRIDE)
    te = cfg.TEST
    records, walls = [], []
    for i in range(0, len(images), batch_size):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        staged = [image_mod.stage_raw_to_bucket(im, cfg.tpu.SCALES[0], stride)
                  for im in images[i:i + batch_size]]
        batch = {"images": np.stack([s[0] for s in staged]),
                 "raw_hw": np.stack([s[1] for s in staged]),
                 "prep_ratio": np.stack([s[2] for s in staged]),
                 "im_info": np.stack([s[3] for s in staged])}
        dets = tester.im_detect(predictor, predictor.batch_put(batch))
        for scores, boxes, valid in dets:
            if not (np.isfinite(scores).all() and np.isfinite(boxes).all()):
                fail("non-finite scores or boxes out of im_detect")
            if not valid.any():
                fail("an image got no valid RoI")
            per_cls = post.per_class_nms(scores, boxes, valid,
                                         cfg.NUM_CLASSES, te.THRESH, te.NMS,
                                         te.MAX_PER_IMAGE)
            records.append(post.detections_to_records(per_cls))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return records, walls


# ---- the training slice -------------------------------------------------------

def train_slice(P, port, tcfg, dev, seed: int, ckpt_dir: str) -> dict:
    """SyntheticDataset → AnchorLoader → fit for one epoch, every kernel
    counter set to 0 just before ``fit`` and read just after; then
    ``FIT_STEPS`` steps on one fixed batch, and the weights saved
    de-normalized under ``ckpt_dir`` (epoch ``FIT_STEPS``) and served by
    ``Predictor``.  Returns what the later phases reuse."""
    scale = tcfg.tpu.SCALES[0]
    ds = P.SyntheticDataset(num_images=TRAIN_IMAGES,
                            num_classes=tcfg.NUM_CLASSES, height=scale[0],
                            width=scale[1], seed=seed)
    roidb = ds.filter_roidb(ds.append_flipped_images(ds.gt_roidb()))
    loader = P.AnchorLoader(roidb, tcfg, BATCH, seed=seed)
    tmodel = P.build_model(tcfg)
    tparams = P.random_params(tmodel, seed=seed)
    counters = {"nms_mask": P.nms_cuda.nms_mask,
                "nms_sweep": P.nms_cuda.nms_sweep,
                "assign_gtmax": P.assign_cuda.assign_gtmax,
                "assign_rows": P.assign_cuda.assign_rows}
    seen, step_walls = [], []
    last = [0.0]

    def on_step(epoch, step, metrics):
        # frequent=1: fit fetches (and so synchronises) after every step
        now = time.perf_counter()
        seen.append(metrics)
        step_walls.append(now - last[0])
        last[0] = now

    prefix = os.path.join(ckpt_dir, "e2e")
    for f in counters.values():
        f.launches = 0
    last[0] = time.perf_counter()
    state = P.fit(tcfg, tmodel, tparams, loader, end_epoch=1,
                  prefix=prefix, seed=seed, frequent=1, device=dev,
                  batch_end_callback=on_step)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    steps = len(seen)
    if steps != loader.steps_per_epoch:
        fail(f"fit reported {steps} steps of {loader.steps_per_epoch}")
    for name, count in launches.items():
        if count != steps:
            fail(f"{name} launched {count} times in {steps} train steps")
    for i, m in enumerate(seen):
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"non-finite train metrics at step {i}: {m}")
    trained = P.export_jax_params(tmodel)
    changed = {k for k in state.mask
               if not np.array_equal(trained[k], tparams[k])}
    frozen = {k for k, t in state.mask.items() if not t}
    if changed & frozen:
        fail(f"{len(changed & frozen)} frozen leaves moved, e.g. "
             f"{sorted(changed & frozen)[:3]}")
    if len(changed) != len(state.mask) - len(frozen):
        fail(f"{len(state.mask) - len(frozen) - len(changed)} trainable "
             f"leaves did not move")
    log("train_slice", network=tcfg.network.NETWORK,
        classes=tcfg.NUM_CLASSES, dtype=tcfg.tpu.COMPUTE_DTYPE,
        assign_fused=tcfg.tpu.ASSIGN_FUSED, records=len(roidb),
        steps=steps, launches=launches, frozen_leaves=len(frozen),
        trainable_moved=len(changed), step_wall_s=step_walls,
        total_loss=[m["total_loss"] for m in seen])

    # the loss must fall on one fixed batch; fit left its put hook on the
    # loader, so the batch comes out on the card
    it = iter(loader)
    fixed = next(it)
    it.close()
    if not fixed["images"].is_cuda:
        fail("fit's put hook did not put the loader's batch on the card")
    gen = torch.Generator(device=dev).manual_seed(seed)
    step_fn = P.make_train_step(tcfg)
    losses = []
    for _ in range(FIT_STEPS):
        _, m = step_fn(state, fixed, generator=gen)
        losses.append(float(m["total_loss"]))
    tail = float(np.mean(losses[-5:]))
    if not np.isfinite(losses).all() or tail >= losses[0]:
        fail(f"the loss did not fall on one batch: first {losses[0]}, "
             f"mean of the last 5 {tail}")
    log("train_fixed_batch", steps=FIT_STEPS, first=losses[0],
        last5_mean=tail, losses=losses)

    # saved de-normalized, served by Predictor
    path = P.epoch_path(prefix, FIT_STEPS)
    P.save_params_npz(path, P.denormalize_for_save(
        P.export_jax_params(tmodel), tcfg))
    served = P.tester.Predictor(P.build_model(tcfg), path, tcfg,
                                device=dev)
    records, walls = run_slice(
        port, served, tcfg, [r["image_array"] for r in roidb[:BATCH]],
        BATCH)
    log("train_served", records_per_image=[len(r) for r in records],
        batch_wall_s=walls)
    return {"cfg": tcfg, "model": tmodel, "state": state, "fixed": fixed,
            "gen": gen, "step_fn": step_fn, "launches": launches,
            "prefix": prefix, "epoch": FIT_STEPS}


def check_fused_vs_dense(P, ctx, dev) -> None:
    """The train step's forward in float32 (TF32 off) from the trained
    weights, on the fixed batch with one set of draws: the fused assign
    kernels and the dense path must give identical RPN labels and equal
    losses."""
    tcfg, fixed = ctx["cfg"], ctx["fixed"]
    cfg32 = tcfg.replace(tpu=dataclasses.replace(tcfg.tpu,
                                                 COMPUTE_DTYPE="float32"))
    model32 = P.build_model(cfg32)
    P.load_jax_params(model32, P.export_jax_params(ctx["model"]))
    model32.to(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    stride = max(tcfg.network.IMAGE_STRIDE, tcfg.network.RPN_FEAT_STRIDE)
    hb, wb = P.image_mod.bucket_shape(tcfg.tpu.SCALES[0], stride)
    feat = tcfg.network.RPN_FEAT_STRIDE
    n_anchors = (hb // feat) * (wb // feat) * tcfg.network.NUM_ANCHORS
    n_rois = tcfg.TRAIN.RPN_POST_NMS_TOP_N + tcfg.tpu.MAX_GT
    draws = {"rpn": P.uniform_draws((BATCH, n_anchors), dev, ctx["gen"]),
             "rcnn": P.uniform_draws((BATCH, n_rois), dev, ctx["gen"])}
    outs = {}
    for fused in (True, False):
        model32.cfg = cfg32.replace(tpu=dataclasses.replace(
            cfg32.tpu, ASSIGN_FUSED=fused))
        n0 = P.assign_cuda.assign_rows.launches
        with torch.no_grad():
            total, aux = model32(fixed["images"], fixed["im_info"],
                                 fixed["gt_boxes"], fixed["gt_classes"],
                                 fixed["gt_valid"], draws=draws)
        ran = P.assign_cuda.assign_rows.launches - n0
        if ran != int(fused):
            fail(f"ASSIGN_FUSED={fused} launched the assign kernels {ran} "
                 f"times")
        outs[fused] = (aux["rpn_label"],
                       [float(aux[k]) for k in LOSS_KEYS] + [float(total)])
    if not torch.equal(outs[True][0], outs[False][0]):
        fail("float32: the fused assign and the dense path give different "
             "RPN labels")
    rel = [abs(a - b) / max(abs(b), 1e-30)
           for a, b in zip(outs[True][1], outs[False][1])]
    if max(rel) > 1e-6:
        fail(f"float32: losses differ between the fused and the dense "
             f"assign ({outs[True][1]} vs {outs[False][1]})")
    log("train_float32_fused_vs_dense", labels_identical=True,
        fg_labels=int((outs[True][0] == 1).sum()), losses_fused=outs[True][1],
        losses_dense=outs[False][1], bitwise=max(rel) == 0.0)


def train_times(P, ctx, dev, main_anchors) -> list:
    """The median train step wall time with the fused and the dense assign
    (ABBA order on the fixed batch), then every kernel of the training path
    against its plain version on the main path's inputs, and the assign
    pair at G = 100 valid gt at the main path's and FPN's anchor counts.
    Returns the kernels' rows."""
    tcfg, tmodel, fixed = ctx["cfg"], ctx["model"], ctx["fixed"]
    step_fn, state, gen = ctx["step_fn"], ctx["state"], ctx["gen"]
    dense_cfg = tcfg.replace(tpu=dataclasses.replace(tcfg.tpu,
                                                     ASSIGN_FUSED=False))
    walls = {True: [], False: []}
    for fused in (True, False, False, True):
        tmodel.cfg = tcfg if fused else dense_cfg
        run = []
        for _ in range(TIMED_STEPS + 1):       # the first is a warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_fn(state, fixed, generator=gen)
            torch.cuda.synchronize()
            run.append(time.perf_counter() - t0)
        walls[fused] += run[1:]
    tmodel.cfg = tcfg
    log("train_step_wall", assign_fused_median_s=statistics.median(walls[True]),
        assign_dense_median_s=statistics.median(walls[False]),
        fused_s=walls[True], dense_s=walls[False])

    # the kernels' main-path inputs: the trained model's RPN on the batch
    tr = tcfg.TRAIN
    with torch.no_grad():
        feat = tmodel.backbone(fixed["images"])
        cls, bbox = tmodel.rpn(feat)
        anchors = tmodel._anchors_for(feat.shape[1], feat.shape[2], dev)
        boxes, _, valid = P.proposal_candidates(
            P.fg_prob(cls), bbox, anchors, fixed["im_info"],
            pre_nms_top_n=tr.RPN_PRE_NMS_TOP_N, min_size=tr.RPN_MIN_SIZE)
    del feat, cls, bbox
    im_h, im_w = fixed["im_info"][:, 0:1], fixed["im_info"][:, 1:2]
    inside = ((anchors[None, :, 0] >= 0) & (anchors[None, :, 1] >= 0)
              & (anchors[None, :, 2] < im_w) & (anchors[None, :, 3] < im_h))
    kernels = time_kernels(P.nms_cuda, boxes, valid, tr.RPN_POST_NMS_TOP_N,
                           tr.RPN_NMS_THRESH)
    kernels += time_assign(P.assign_cuda, anchors, fixed["gt_boxes"],
                           fixed["gt_valid"], inside)
    for k in kernels:
        if k["max_abs_err"] != 0.0:
            fail(f"{k['name']} disagrees with its plain version on the "
                 f"training path's inputs (max abs err {k['max_abs_err']})")
        k.update(route="cuda", source=SOURCES[k["name"]],
                 replaces=REPLACES[k["name"]],
                 launches=ctx["launches"][k["name"]],
                 shape=f"train: B={int(boxes.shape[0])}, "
                       f"{int(boxes.shape[1])} -> {tr.RPN_POST_NMS_TOP_N}"
                 if k["name"].startswith("nms") else
                 f"train: N={int(anchors.shape[0])}, "
                 f"G={int(fixed['gt_boxes'].shape[1])}, the batch's gt")
    log("times_train", shape={
        "B": BATCH, "anchors": int(anchors.shape[0]),
        "gt": int(fixed["gt_boxes"].shape[1]),
        "valid_gt": [int(x) for x in fixed["gt_valid"].sum(1)],
        "nms_n": int(boxes.shape[1]), "max_out": tr.RPN_POST_NMS_TOP_N},
        kernels=kernels)

    # the same shape on collapsed boxes (the matrix's identical-boxes case):
    # every IoU is 1, far from the threshold
    same = torch.tensor([10.0, 10.0, 60.0, 60.0], device=dev).expand(
        boxes.shape).contiguous()
    rows = time_kernels(P.nms_cuda, same, torch.ones_like(valid),
                        tr.RPN_POST_NMS_TOP_N, tr.RPN_NMS_THRESH)
    for k in rows:
        if k["max_abs_err"] != 0.0:
            fail(f"{k['name']} disagrees with its plain version on "
                 f"identical boxes")
    log("times_identical", shape={"B": int(same.shape[0]),
                                  "nms_n": int(same.shape[1]),
                                  "max_out": tr.RPN_POST_NMS_TOP_N},
        kernels=rows)

    # G = 100 valid gt, the most the training config pads to
    for a in (main_anchors, fpn_anchors(P.all_anchors, P.generate_anchors)):
        per = [assign_case(np.random.RandomState(50 + b), a, (600, 1000),
                           100, 100, (40.0, 360.0)) for b in range(BATCH)]
        rows = time_assign(P.assign_cuda, torch.from_numpy(a).to(dev), *(
            torch.from_numpy(np.stack([p[i] for p in per])).to(dev)
            for i in range(3)))
        for k in rows:
            if k["max_abs_err"] != 0.0:
                fail(f"{k['name']} disagrees with its plain version at "
                     f"N={len(a)}, G=100")
        log("times_assign_g100", shape={"B": BATCH, "anchors": len(a),
                                        "gt": 100}, kernels=rows)
    return kernels


# ---- the evaluation slice -----------------------------------------------------

def png_bytes(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 → PNG bytes, 8-bit RGB, the rows' filter types
    cycling None, Sub, Up, Average, Paeth, so the port's decoder meets each
    (no image library needed)."""
    h, w, c = img.shape
    x = img.astype(np.int32)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]                             # left
    b = np.zeros_like(x)
    b[1:] = x[:-1]                                   # up
    ul = np.zeros_like(x)
    ul[1:, 1:] = x[:-1, :-1]
    p = a + b - ul
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
    ftype = np.arange(h) % 5
    pred = np.select([ftype[:, None, None] == t for t in range(1, 5)],
                     [a, b, (a + b) >> 1, paeth], 0)
    rows = np.concatenate([ftype[:, None], ((x - pred) & 0xFF).reshape(
        h, w * c)], 1).astype(np.uint8)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def boxes_image(rng, h: int, w: int):
    """Low-contrast noise with 1-3 solid rectangles, each given a VOC class
    of ``EVAL_CLASSES`` → (uint8 (h, w, 3) image, [(x1, y1, bw, bh, cls)])
    in 0-based pixels."""
    img = (rng.randn(h, w, 3) * 20 + 127).clip(0, 255).astype(np.uint8)
    boxes = []
    for _ in range(rng.randint(1, 4)):
        bw, bh = rng.randint(w // 5, w // 2), rng.randint(h // 5, h // 2)
        x1, y1 = rng.randint(0, w - bw), rng.randint(0, h - bh)
        cls = EVAL_CLASSES[rng.randint(len(EVAL_CLASSES))]
        img[y1:y1 + bh, x1:x1 + bw] = rng.randint(40, 255, 3)
        boxes.append((x1, y1, bw, bh, cls))
    return img, boxes


def write_devkit(root: str, seed: int) -> str:
    """A VOC2007-layout devkit under ``root`` with the images of
    ``EVAL_SIZES`` and then of ``TRAIN_SIZES`` (landscape first, so a batch
    of two holds one orientation) drawn by :func:`boxes_image`, each image
    PNG bytes under its ``.jpg`` name, one XML annotation per image,
    ``ImageSets/Main/<EVAL_SPLIT>.txt`` and ``<TRAIN_SPLIT>.txt``; then
    ``<PIPE_EVAL_SPLIT>.txt`` over ``PIPE_EVAL_IMAGES`` new ids, the
    ``TRAIN_SIZES`` files again in their order (a batch of two still holds
    one orientation).  Returns the devkit path."""
    rng = np.random.RandomState(seed)
    devkit = os.path.join(root, "VOCdevkit")
    voc = os.path.join(devkit, "VOC2007")
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets",
                                                           "Main")):
        os.makedirs(os.path.join(voc, sub), exist_ok=True)
    sizes = EVAL_SIZES + TRAIN_SIZES
    ids = [f"{i:06d}" for i in range(len(sizes))]
    for idx, (h, w) in zip(ids, sizes):
        img, boxes = boxes_image(rng, h, w)
        xml = [f"<annotation><filename>{idx}.jpg</filename><size><width>"
               f"{w}</width><height>{h}</height><depth>3</depth></size>"]
        for x1, y1, bw, bh, cls in boxes:
            xml.append(f"<object><name>{cls}</name><difficult>0</difficult>"
                       f"<bndbox><xmin>{x1 + 1}</xmin><ymin>{y1 + 1}</ymin>"
                       f"<xmax>{x1 + bw}</xmax><ymax>{y1 + bh}</ymax>"
                       f"</bndbox></object>")
        with open(os.path.join(voc, "JPEGImages", idx + ".jpg"), "wb") as f:
            f.write(png_bytes(img))
        with open(os.path.join(voc, "Annotations", idx + ".xml"), "w") as f:
            f.write("".join(xml) + "</annotation>")
    n = len(EVAL_SIZES)
    more = [f"{len(sizes) + i:06d}" for i in range(PIPE_EVAL_IMAGES)]
    for i, idx in enumerate(more):
        src = ids[n + i % len(TRAIN_SIZES)]
        for sub, ext in (("JPEGImages", ".jpg"), ("Annotations", ".xml")):
            shutil.copyfile(os.path.join(voc, sub, src + ext),
                            os.path.join(voc, sub, idx + ext))
    for split, part in ((EVAL_SPLIT, ids[:n]), (TRAIN_SPLIT, ids[n:]),
                        (PIPE_EVAL_SPLIT, more)):
        with open(os.path.join(voc, "ImageSets", "Main", split + ".txt"),
                  "w") as f:
            f.write("\n".join(part) + "\n")
    return devkit


def match_routes(host, device, cap: int) -> int:
    """Every device-route detection must match a host-route detection of
    the same image and class (score within 1e-6, box within 1e-3 px); the
    host route may keep more only in rows tied at the cap.  Returns the
    number of matched detections."""
    matched = 0
    for i in range(len(host[1])):
        extra = []
        for k in range(1, len(host)):
            h, d = host[k][i], device[k][i]
            used = np.zeros(len(h), bool)
            for row in d:
                hit = np.flatnonzero(
                    ~used & (np.abs(h[:, 4] - row[4]) <= 1e-6)
                    & (np.abs(h[:, :4] - row[:4]).max(1) <= 1e-3))
                if not len(hit):
                    fail(f"device detection {row.tolist()} of class {k} in "
                         f"image {i} has no host counterpart")
                used[hit[0]] = True
            matched += len(d)
            extra.append(h[~used, 4])
        extra = np.concatenate(extra)
        n_host = sum(len(host[k][i]) for k in range(1, len(host)))
        if not n_host:
            continue
        cut = min(host[k][i][:, 4].min() for k in range(1, len(host))
                  if len(host[k][i]))
        if len(extra) and (n_host <= cap or np.abs(extra - cut).max() > 1e-6):
            fail(f"image {i}: the host route keeps {len(extra)} detections "
                 f"the device route does not, not all tied at the cap")
    return matched


def sync_report(P, predictor, batch, te) -> dict:
    """The synchronising CUDA calls (``torch.cuda.set_sync_debug_mode``)
    in one batch's ``batch_put`` + ``predict`` + ``predict_detections``:
    any of them stalls the host inside the dispatch and collapses the
    overlapped loop.  A copy from pageable host memory, the kind
    ``Predictor._put`` avoids, runs first as the control that the detector
    sees one.  Returns the distinct warnings of each, reported, not
    failed on."""
    import warnings

    def syncs(fn) -> list:
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return sorted({str(w.message).splitlines()[0] for w in caught
                       if "prototype feature" not in str(w.message)})

    def dispatch():
        put = predictor.batch_put(batch)
        predictor.predict(put["images"], put["im_info"])
        predictor.predict_detections(put["images"], put["im_info"],
                                     te.MAX_PER_IMAGE, te.THRESH)

    return {"pageable_copy_control": syncs(
                lambda: torch.as_tensor(batch["im_info"]).to("cuda")),
            "dispatch": syncs(dispatch)}


def eval_slice(P, prefix: str, epoch: int, work: str, seed: int,
               device=None, flags=EVAL_FLAGS) -> dict:
    """``python -m mx_rcnn_tpu_torch.test``'s ``test_rcnn`` on a devkit
    written by :func:`write_devkit`, with the weights the training slice
    saved, in three modes: serial host post-process (``--eval-inflight
    0``), overlapped host post-process (the default) and overlapped
    ``--device-postprocess``; a serial warm-up first.  The NMS counters are
    set to 0 just before each mode and read just after.  Returns the
    figures the later phases report."""
    try:
        import PIL  # noqa: F401 — reported, not needed: the devkit is PNG
        has_pil = True
    except ImportError:
        has_pil = False
    devkit = write_devkit(work, seed)
    common = flags + ["--image_set", f"2007_{EVAL_SPLIT}",
                      "--root_path", os.path.join(work, "data"),
                      "--dataset_path", devkit]
    args = common + ["--prefix", prefix, "--epoch", str(epoch),
                     "--batch_images", str(BATCH)]
    if device is not None:
        args += ["--device", str(device)]
    modes = {"warm-up": ["--eval-inflight", "0"],
             "serial": ["--eval-inflight", "0"],
             "pipelined": [],
             "pipelined+devpost": ["--device-postprocess"]}
    n_batches = -(-len(EVAL_SIZES) // BATCH)
    stats, boxes, launches = {}, {}, {}
    for mode, extra in modes.items():
        cache = os.path.join(work, f"dets-{mode}.pkl")
        P.nms_cuda.nms_mask.launches = P.nms_cuda.nms_sweep.launches = 0
        out = P.test_driver.test_rcnn(P.test_driver.parse_args(
            args + extra + ["--dets_cache", cache]))
        launches[mode] = {"nms_mask": P.nms_cuda.nms_mask.launches,
                          "nms_sweep": P.nms_cuda.nms_sweep.launches}
        want = n_batches * (2 if "devpost" in mode else 1)
        for name, count in launches[mode].items():
            if count != want:
                fail(f"eval [{mode}]: {name} launched {count} times in "
                     f"{n_batches} batches, expected {want}")
        if not (np.isfinite(out["mAP"]) and 0.0 <= out["mAP"] <= 1.0):
            fail(f"eval [{mode}]: mAP {out['mAP']} is not in [0, 1]")
        with open(cache, "rb") as f:
            boxes[mode] = pickle.load(f)
        stats[mode] = out
    for k in range(1, len(boxes["serial"])):
        for i, (a, b) in enumerate(zip(boxes["pipelined"][k],
                                       boxes["serial"][k], strict=True)):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                fail(f"eval: the overlapped loop's detections of class {k} "
                     f"in image {i} differ from the serial loop's")
    cfg = P.config_from_args(P.test_driver.parse_args(args), train=False)
    matched = match_routes(boxes["serial"], boxes["pipelined+devpost"],
                           cfg.TEST.MAX_PER_IMAGE)
    re = P.reeval.reeval(P.reeval.parse_args(
        common + ["--detections", os.path.join(work, "dets-serial.pkl")]))
    if re != {k: v for k, v in stats["serial"].items()
              if k != "eval_pipeline"}:
        fail("reeval of the serial det_cache gives another score")
    log("eval_slice", network=cfg.network.NETWORK, classes=cfg.NUM_CLASSES,
        dtype=cfg.tpu.COMPUTE_DTYPE, images=len(EVAL_SIZES),
        sizes=[list(s) for s in EVAL_SIZES], batch=BATCH, pil=has_pil,
        launches=launches, device_matched=matched,
        mAP={m: s["mAP"] for m, s in stats.items()},
        pipelined_bit_identical=True, reeval_identical=True,
        pipeline={m: s["eval_pipeline"] for m, s in stats.items()})
    return {"cfg": cfg, "args": args, "stats": stats, "launches": launches}


def postprocess_times(P, ev, dev, phase: str = "times_postprocess") -> list:
    """The NMS pair at the device post-process's shape (B·(K−1) rows of
    ``TEST.RPN_POST_NMS_TOP_N`` candidates, ``max_per_image`` kept) on the
    first batch of the evaluation's dataset: the kernels'
    ``keep_idx``/``keep_mask`` identical to ``nms_padded_batch`` on the
    same CUDA inputs, then timed against their plain versions
    (:func:`time_kernels`), and the synchronising calls of one batch's
    dispatch reported, under ``phase``.  Returns the rows."""
    cfg, te = ev["cfg"], ev["cfg"].TEST
    targs = P.test_driver.parse_args(ev["args"])
    predictor = P.tester.Predictor(P.build_model(cfg),
                                   P.load_eval_params(targs), cfg, device=dev)
    roidb = P.get_imdb(targs, cfg, test=True).gt_roidb()
    batch = next(iter(P.TestLoader(roidb, cfg, batch_size=BATCH)))
    put = predictor.batch_put(batch)
    rois, roi_valid, cls_prob, deltas, _ = predictor.predict(
        put["images"], put["im_info"])
    rows = P.per_class_rows(rois, roi_valid, cls_prob, deltas,
                            torch.as_tensor(put["im_info"], device=dev),
                            num_classes=cfg.NUM_CLASSES, thresh=te.THRESH)
    b, k1, r, _ = rows[0].shape
    bs, ss, sv = P.rank_rows(*(t.reshape(b * k1, r, *t.shape[3:])
                               for t in rows))
    ki, km = P.nms_cuda.nms_bitmask(bs, sv, te.MAX_PER_IMAGE, te.NMS)
    pi, pm = P.nms_padded_batch(bs, ss, te.MAX_PER_IMAGE, te.NMS, sv)
    if not (torch.equal(ki, pi) and torch.equal(km, pm)):
        fail("the NMS kernels keep other rows than nms_padded_batch at the "
             "post-process shape")
    kernels = time_kernels(P.nms_cuda, bs, sv, te.MAX_PER_IMAGE, te.NMS)
    for kern in kernels:
        if kern["max_abs_err"] != 0.0:
            fail(f"{kern['name']} disagrees with its plain version at the "
                 f"post-process shape")
    syncs = sync_report(P, predictor, batch, te)
    log(phase, shape={"rows": b * k1, "n": r, "max_out": te.MAX_PER_IMAGE,
                      "thresh": te.NMS},
        candidates=int(sv.sum()), identical=True,
        launches=ev["launches"],
        kernels=kernels, syncs=syncs)
    return kernels


# ---- the serving slice --------------------------------------------------------

def records_equal(got, want) -> bool:
    """The same count and classes in score order, scores within 1e-6,
    boxes within 1e-3 px (the eval phase's tolerance)."""
    return len(got) == len(want) and all(
        d["cls"] == e["cls"] and abs(d["score"] - e["score"]) <= 1e-6
        and np.abs(np.subtract(d["bbox"], e["bbox"])).max() <= 1e-3
        for d, e in zip(got, want))


def offline_records(P, predictor, cfg, img, e2e: bool) -> list:
    """One image through the offline ``Predictor`` path in both rows of a
    batch of two (the image paired with itself): ``batch_put`` →
    ``predict`` → host decode and ``per_class_nms``, or
    ``predict_detections`` (the device post-process) →
    ``device_dets_to_per_class``.  Returns the records of row 0 and of row
    1: the library's convolutions and matmuls may split a batch's rows
    into tiles differently, so an image's last bits can depend on its
    row, and a served request is held against the row it rode."""
    te = cfg.TEST
    stride = max(cfg.network.IMAGE_STRIDE, cfg.network.RPN_FEAT_STRIDE)
    s, hw, r, info = P.image_mod.stage_raw_to_bucket(img, cfg.tpu.SCALES[0],
                                                     stride)
    batch = predictor.batch_put({
        "images": np.stack([s, s]), "raw_hw": np.stack([hw, hw]),
        "prep_ratio": np.stack([r, r]), "im_info": np.stack([info, info])})
    if e2e:
        dets, valid = predictor.predict_detections(
            batch["images"], batch["im_info"], te.MAX_PER_IMAGE, te.THRESH)
        dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
        per_cls = [P.post.device_dets_to_per_class(dets[b], valid[b],
                                                   cfg.NUM_CLASSES)
                   for b in range(2)]
    else:
        per_cls = [P.post.per_class_nms(scores, boxes, valid,
                                        cfg.NUM_CLASSES, te.THRESH, te.NMS,
                                        te.MAX_PER_IMAGE)
                   for scores, boxes, valid in P.tester.im_detect(predictor,
                                                                  batch)]
    return [P.post.detections_to_records(d) for d in per_cls]


def hist_delta_ms(P, hist, before: dict, q: float):
    """Quantile (ms) of the observations a Hist took since ``before`` (its
    ``to_dict``): the serving traffic without the warmup's requests."""
    now = hist.to_dict()
    counts = [a - b for a, b in zip(now["buckets"], before["buckets"])]
    v = P.quantile_from_counts(P.HIST_LE, counts,
                               now["count"] - before["count"], q)
    return None if v is None else v * 1e3


def serve_mode(P, predictor, engine, cfg, sock: str, images: list,
               e2e: bool, requests: int = SERVE_REQUESTS) -> dict:
    """One mode of the in-process server: ``make_server`` on ``sock``,
    ``warmup`` (2 programs), then ``requests`` requests from
    ``SERVE_CLIENTS`` threads over the socket with the NMS counters set to
    0 just before and read just after; every reply 200, no first dispatch,
    1 h2d copy / dispatch / readback a batch, the NMS kernels 1 (host NMS)
    or 2 (e2e) times a batch, each reply's records equal to the offline
    path's in the batch row it rode (``batch_row``), and every image with
    detections there, so that no size is checked on empty lists.  Latency
    is read from the engine's histograms (bucketed) and from the clients'
    round trips (exact percentiles)."""
    mode = "e2e" if e2e else "host_nms"
    server = P.serve.make_server(engine, unix_socket=sock)
    th = threading.Thread(target=server.serve_forever,
                                        daemon=True)
    try:
        t0 = time.perf_counter()
        compiled = P.serve.warmup(engine)
        warm_s = time.perf_counter() - t0
        if compiled != 2:
            fail(f"serve [{mode}]: warmup first-dispatched {compiled} "
                 f"programs, expected 2 (one per orientation)")
        th.start()
        status, ready = P.serve.unix_http_request(sock, "GET", "/readyz")
        if status != 200:
            fail(f"serve [{mode}]: /readyz {status} after warmup: {ready}")
        base = dict(engine.counters)
        hists0 = {k: h.to_dict() for k, h in engine.hists.items()}
        spans0 = P.telemetry.get().summary()["spans"]
        payloads = [P.serve.encode_image_payload(im) for im in images]
        replies = [None] * requests
        rtt = [None] * requests

        def client(c):
            for i in range(c, requests, SERVE_CLIENTS):
                t = time.perf_counter()
                replies[i] = P.serve.unix_http_request(
                    sock, "POST", "/predict", payloads[i % len(images)],
                    timeout=300)
                rtt[i] = time.perf_counter() - t

        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        torch.cuda.synchronize()
        P.nms_cuda.nms_mask.launches = P.nms_cuda.nms_sweep.launches = 0
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(600)
        wall = time.perf_counter() - t0
        launches = {"nms_mask": P.nms_cuda.nms_mask.launches,
                    "nms_sweep": P.nms_cuda.nms_sweep.launches}
        statuses = [r[0] if r else None for r in replies]
        if statuses != [200] * requests:
            fail(f"serve [{mode}]: statuses {statuses}")
        status, prom = P.serve.unix_http_request(sock, "GET",
                                                 "/metrics?format=prom")
        if status != 200 or "mxr_serve_request_time_seconds_bucket" not in prom:
            fail(f"serve [{mode}]: /metrics?format=prom gave {status}")
    finally:
        if th.is_alive():
            server.shutdown()
        server.server_close()
    c = {k: engine.counters[k] - base[k] for k in (
        "batches", "served", "h2d_transfers", "dispatches", "readbacks",
        "readback_bytes", "recompiles")}
    if engine.counters["recompiles"] != engine.counters["warmup_programs"] \
            or c["recompiles"]:
        fail(f"serve [{mode}]: {c['recompiles']} first dispatches after "
             f"warmup")
    n = c["batches"]
    if not (c["h2d_transfers"] == c["dispatches"] == c["readbacks"] == n):
        fail(f"serve [{mode}]: transfers/dispatches/readbacks {c} for {n} "
             f"batches")
    want = n * (2 if e2e else 1)
    for name, count in launches.items():
        if count != want:
            fail(f"serve [{mode}]: {name} launched {count} times in {n} "
                 f"batches, expected {want}")
    offline = [offline_records(P, predictor, cfg, im, e2e) for im in images]
    empty = [images[j].shape[:2] for j, rows in enumerate(offline)
             if not all(rows)]
    if empty:
        fail(f"serve [{mode}]: the offline path finds no detections for "
             f"the sizes {empty}, so their check would compare empty lists")
    rows = [0] * BATCH
    for i, (_, resp) in enumerate(replies):
        row = resp.get("batch_row")
        if row not in range(BATCH):
            fail(f"serve [{mode}] request {i}: batch_row {row!r}")
        rows[row] += 1
        if not records_equal(resp["detections"],
                             offline[i % len(images)][row]):
            fail(f"serve [{mode}] request {i}: the served detections are "
                 f"not the offline path's in row {row}, the row it rode")
    latency = {f"{name.split('/')[1]}_{tag}_ms": hist_delta_ms(
        P, h, hists0[name], q) for name, h in engine.hists.items()
        for q, tag in ((0.5, "p50"), (0.99, "p99"))}
    spans = P.telemetry.get().summary()["spans"]
    phase_ms = {}
    for name in ("serve/h2d", "serve/forward", "serve/readback",
                 "serve/postprocess"):
        s0 = spans0.get(name, {"count": 0, "total_s": 0.0})
        count = spans[name]["count"] - s0["count"]
        phase_ms[name] = (spans[name]["total_s"] - s0["total_s"]) / count \
            * 1e3
    rtt_ms = np.asarray(rtt) * 1e3
    return {"mode": mode, "warmup_programs": compiled, "warmup_s": warm_s,
            "requests": requests, "clients": SERVE_CLIENTS,
            "wall_s": wall, "requests_per_s": requests / wall,
            **latency, "client_rtt_p50_ms": float(np.percentile(rtt_ms, 50)),
            "client_rtt_p99_ms": float(np.percentile(rtt_ms, 99)),
            "client_rtt_max_ms": float(rtt_ms.max()),
            "batch_phase_mean_ms": phase_ms, "requests_per_row": rows,
            "batches": n, "batch_fill": c["served"] / (n * BATCH),
            "readback_bytes_per_batch": c["readback_bytes"] / n,
            "h2d_dispatch_readback_per_batch": [
                c["h2d_transfers"] / n, c["dispatches"] / n,
                c["readbacks"] / n],
            "launches": launches, "records_match_offline": True,
            "rows_differ": [not records_equal(*o) for o in offline],
            "detections_per_image": [len(o[0]) for o in offline]}


def serve_driver_run(P, flags: list, work: str, device=None) -> dict:
    """``python -m mx_rcnn_tpu_torch.serve --serve-e2e`` as a process:
    ready on ``/readyz``, ``SERVE_CLIENTS`` requests answered 200, the
    Prometheus text read, exit code 0 on SIGTERM.  The process is killed
    in any case before this returns."""
    import signal

    sock = os.path.join(work, "driver.sock")
    log_path = os.path.join(work, "driver.log")
    argv = [sys.executable, "-m", "mx_rcnn_tpu_torch.serve", "--serve-e2e",
            "--unix-socket", sock, "--serve-batch", str(BATCH),
            "--max-delay-ms", "10"] + flags
    if device is not None:
        argv += ["--device", str(device)]
    t0 = time.perf_counter()
    with open(log_path, "w") as out:
        proc = subprocess.Popen(argv, cwd=os.path.dirname(
            os.path.abspath(__file__)), stdout=out, stderr=subprocess.STDOUT)
    try:
        while True:
            if proc.poll() is not None:
                break
            try:
                if P.serve.unix_http_request(sock, "GET", "/readyz",
                                             timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            if time.perf_counter() - t0 > 300:
                break
            time.sleep(0.2)
        ready_s = time.perf_counter() - t0
        if proc.poll() is None and ready_s <= 300:
            rng = np.random.RandomState(1)
            statuses = []
            for hw in SERVE_SIZES[:SERVE_CLIENTS]:
                img = rng.randint(0, 256, hw + (3,), np.uint8)
                statuses.append(P.serve.unix_http_request(
                    sock, "POST", "/predict",
                    P.serve.encode_image_payload(img), timeout=300)[0])
            status, prom = P.serve.unix_http_request(
                sock, "GET", "/metrics?format=prom")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        else:
            statuses, status, prom, rc = [], None, "", None
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log_path) as f:
        tail = f.read()[-3000:]
    count = f'mxr_serve_request_time_seconds_count{{rank="0"}} ' \
            f'{2 * BATCH + len(statuses)}'
    if rc != 0 or statuses != [200] * SERVE_CLIENTS or status != 200 or \
            count not in prom:
        print(tail, flush=True)
        fail(f"serve driver: ready after {ready_s:.1f} s, statuses "
             f"{statuses}, /metrics {status}, exit code {rc}")
    return {"ready_s": ready_s, "statuses": statuses, "exit_code": rc,
            "prom_lines": len(prom.splitlines())}


def serve_slice(P, prefix: str, epoch: int, work: str, seed: int,
                device=None, flags=EVAL_FLAGS) -> dict:
    """The serving slice: ``serve.driver.build_engine`` on the training
    slice's checkpoint, the in-process server in host-NMS and then e2e
    mode (:func:`serve_mode`, one ``Predictor`` for both), then the driver
    as a process (:func:`serve_driver_run`)."""
    rng = np.random.RandomState(seed)
    images = [boxes_image(rng, *hw)[0] for hw in SERVE_SIZES]
    # an in-memory sink for the engine's per-batch phase spans
    P.telemetry.configure(work, stream=False)
    common = flags + ["--prefix", prefix, "--epoch", str(epoch),
                      "--serve-batch", str(BATCH), "--max-delay-ms", "10"]
    if device is not None:
        common += ["--device", str(device)]
    out = {}
    args = P.serve_driver.parse_args(common + ["--unix-socket", "unused"])
    cfg = P.config_from_args(args, train=False)
    predictor, engine = P.serve_driver.build_engine(args, cfg)
    try:
        out["host_nms"] = serve_mode(P, predictor, engine, cfg,
                                     os.path.join(work, "host.sock"), images,
                                     e2e=False)
    finally:
        engine.stop()
    engine = P.serve.ServeEngine(predictor, cfg, dataclasses.replace(
        engine.opts, serve_e2e=True)).start()
    try:
        out["e2e"] = serve_mode(P, predictor, engine, cfg,
                                os.path.join(work, "e2e.sock"), images,
                                e2e=True)
    finally:
        engine.stop()
    del predictor, engine
    P.telemetry.shutdown()
    torch.cuda.empty_cache()
    driver = serve_driver_run(P, flags + ["--prefix", prefix, "--epoch",
                                          str(epoch)], work, device)
    if out["e2e"]["readback_bytes_per_batch"] >= \
            out["host_nms"]["readback_bytes_per_batch"]:
        fail("serve: the e2e readback is not smaller than the host-NMS one")
    log("serve_slice", network=cfg.network.NETWORK, dtype=cfg.tpu.COMPUTE_DTYPE,
        sizes=[list(s) for s in SERVE_SIZES], batch=BATCH, max_delay_ms=10,
        modes=out, driver=driver)
    return out

# ---- the alternate-training slice ---------------------------------------------

def _moved_and_frozen(before: dict, after: dict, mask: dict, what: str):
    """Fail unless every frozen leaf is bitwise unchanged and every
    trainable leaf that was not 0 moved (a 0 leaf has nothing to decay,
    and only a gradient moves it); returns (frozen, moved) counts."""
    frozen = {k for k, t in mask.items() if not t}
    moved = {k for k in mask if not np.array_equal(after[k], before[k])}
    if moved & frozen:
        fail(f"{what}: {len(moved & frozen)} frozen leaves moved, e.g. "
             f"{sorted(moved & frozen)[:3]}")
    still = {k for k, t in mask.items() if t and before[k].any()} - moved
    if still:
        fail(f"{what}: {len(still)} trainable leaves did not move, e.g. "
             f"{sorted(still)[:3]}")
    return len(frozen), len(moved)


def alternate_slice(P, pretrained: str, work: str, seed: int,
                    device=None, flags=ALT_FLAGS) -> dict:
    """``train_alternate.alternate_train`` from the training slice's
    weights.  Its stage functions are wrapped to set the kernel counts to
    0 just before each stage and read them just after, to time it (model
    build included) and to keep its weights; the stage tools' ``fit`` and
    ``generate_proposals`` to keep the step metrics and the RPN outputs.
    Then the checks of each stage, the kernels' kept rows against the
    plain NMS on one proposal batch's RPN outputs, the combined checkpoint
    by group and a ``Predictor`` on it."""
    counters = {"nms_mask": P.nms_cuda.nms_mask,
                "nms_sweep": P.nms_cuda.nms_sweep,
                "assign_gtmax": P.assign_cuda.assign_gtmax,
                "assign_rows": P.assign_cuda.assign_rows}
    stages = []

    def sync():
        if device is None:
            torch.cuda.synchronize()

    def start():
        sync()
        for f in counters.values():
            f.launches = 0
        return time.perf_counter()

    def finish(t0, **kw):
        sync()
        kw.update(wall_s=time.perf_counter() - t0,
                  launches={k: f.launches for k, f in counters.items()})
        stages.append(kw)

    pending = {}

    def fit_wrapper(fit):
        # the step metrics and the frozen prefixes of the stage's fit
        def wrapped(cfg, model, params, loader, **kw):
            pending["metrics"] = []
            kw["batch_end_callback"] = \
                lambda e, i, m: pending["metrics"].append(m)
            pending["fixed"] = kw["fixed_prefixes"]
            return fit(cfg, model, params, loader, **kw)
        return wrapped

    def proposals_wrapper(gen):
        # each batch's RPN outputs, and the first batch's network input
        def wrapped(predictor, loader, roidb, cache_path=None):
            outs, first = [], []
            predict_rpn = predictor.predict_rpn

            def recorded(images, im_info):
                if not first:
                    first.append((images, im_info))
                out = predict_rpn(images, im_info)
                outs.append([t.float().cpu().numpy() for t in out]
                            + [np.asarray(im_info)])
                return out

            predictor.predict_rpn = recorded
            pending.update(outs=outs, first=first, predictor=predictor)
            return gen(predictor, loader, roidb, cache_path)
        return wrapped

    def stage_wrapper(stage, graph):
        # one stage as the driver calls it, model build included: the
        # counts set to 0 just before it and read just after
        def wrapped(*a, **kw):
            before = {k: np.array(v) for k, v in kw["params"].items()}
            pending.clear()
            t0 = start()
            out = stage(*a, **kw)
            finish(t0, graph=graph, **pending)
            if graph == "proposals":
                stages[-1].update(records=len(out), first=pending["first"][0],
                                  proposals=[r["proposals"] for r in out])
            else:
                stages[-1].update(before=before, mask=out.mask,
                                  steps=out.step,
                                  after=P.export_jax_params(out.model))
            return out
        return wrapped

    saved = {}
    mods = ((P.train_rpn_mod, "fit", fit_wrapper(P.train_rpn_mod.fit)),
            (P.train_rcnn_mod, "fit", fit_wrapper(P.train_rcnn_mod.fit)),
            (P.test_rpn_mod, "generate_proposals",
             proposals_wrapper(P.test_rpn_mod.generate_proposals)),
            (P.train_alternate, "train_rpn",
             stage_wrapper(P.train_alternate.train_rpn, "rpn")),
            (P.train_alternate, "test_rpn",
             stage_wrapper(P.train_alternate.test_rpn, "proposals")),
            (P.train_alternate, "train_rcnn",
             stage_wrapper(P.train_alternate.train_rcnn, "rcnn")))
    for mod, name, wrapped in mods:
        saved[mod, name] = getattr(mod, name)
        setattr(mod, name, wrapped)
    prefix = os.path.join(work, "alt", "alt")
    argv = flags + ["--synthetic", "--synthetic_images", str(TRAIN_IMAGES),
                    "--batch_images", str(BATCH), "--num-steps",
                    str(ALT_STEPS), "--end_epoch", "1", "--frequent", "1",
                    "--seed", str(seed), "--pretrained", pretrained,
                    "--prefix", prefix]
    if device is not None:
        argv += ["--device", str(device)]
    here = os.getcwd()
    # the synthetic imdb caches its proposals under ./data/cache
    os.makedirs(os.path.join(work, "alt"), exist_ok=True)
    os.chdir(os.path.join(work, "alt"))
    t_all = time.perf_counter()
    try:
        args = P.train_alternate.parse_args(argv)
        final = P.train_alternate.alternate_train(args)
    finally:
        os.chdir(here)
        for (mod, name), f in saved.items():
            setattr(mod, name, f)
    total_s = time.perf_counter() - t_all
    cfg = P.config_from_args(args, train=True)

    names = ["train_rpn", "test_rpn", "train_rcnn", "train_rpn_shared",
             "test_rpn_shared", "train_rcnn_shared"]
    if [s["graph"] for s in stages] != ["rpn", "proposals", "rcnn", "rpn",
                                        "proposals", "rcnn"]:
        fail(f"alternate stages ran as {[s['graph'] for s in stages]}")
    net = cfg.network
    want_fixed = [net.FIXED_PARAMS, None, net.FIXED_PARAMS,
                  net.FIXED_PARAMS_SHARED, None, net.FIXED_PARAMS_SHARED]
    starts = [None, None, stages[0]["before"], stages[2]["after"], None,
              stages[3]["after"]]
    summary = []
    for i, (st, name) in enumerate(zip(stages, names)):
        row = {"stage": name, "wall_s": st["wall_s"],
               "launches": st["launches"]}
        la = st["launches"]
        if st["graph"] == "proposals":
            n = st["records"]
            want = {"nms_mask": n, "nms_sweep": n, "assign_gtmax": 0,
                    "assign_rows": 0}
            row.update(records=n, proposals=[len(p) for p in
                                             st["proposals"]])
            check_proposals(P, cfg, st, name)
        else:
            if st["fixed"] != want_fixed[i]:
                fail(f"{name}: frozen prefixes {st['fixed']}")
            if starts[i] is not None and any(
                    not np.array_equal(st["before"][k], v)
                    for k, v in starts[i].items()):
                fail(f"{name} did not start from the weights the JAX "
                     f"driver gives it")
            n = st["steps"]
            if n != ALT_STEPS or len(st["metrics"]) != n:
                fail(f"{name}: {n} steps, {len(st['metrics'])} fetched")
            for m in st["metrics"]:
                if not all(np.isfinite(v) for v in m.values()):
                    fail(f"{name}: non-finite metrics {m}")
            k = n if st["graph"] == "rpn" else 0
            want = {"nms_mask": 0, "nms_sweep": 0, "assign_gtmax": k,
                    "assign_rows": k}
            frozen, moved = _moved_and_frozen(st["before"], st["after"],
                                              st["mask"], name)
            row.update(steps=n, frozen_leaves=frozen, moved_leaves=moved,
                       total_loss=[m["total_loss"] for m in st["metrics"]])
        if la != want:
            fail(f"{name}: kernel launches {la}, expected {want}")
        summary.append(row)

    # the kernels' kept rows against the plain NMS on one batch's RPN
    # outputs (stage 5's first record), outside every counted window
    st = stages[4]
    kept, boxes, valid = check_kept_rows(P, cfg, st["predictor"],
                                         *st["first"])
    for st in stages:
        st.pop("predictor", None)
    te = cfg.TEST
    times = time_kernels(P.nms_cuda, boxes, valid, te.RPN_POST_NMS_TOP_N,
                         te.RPN_NMS_THRESH)
    for k in times:
        if k["max_abs_err"] != 0.0:
            fail(f"{k['name']} disagrees with its plain version at the "
                 f"proposal stage's shape (max abs err {k['max_abs_err']})")
    del boxes, valid

    # the combined checkpoint: stage 4's backbone and RPN, stage 6's head
    path = P.epoch_path(prefix, 1)
    ckpt = P.load_params_npz(path)
    s4, s6 = stages[3]["after"], stages[5]["after"]
    head = P.denormalize_for_save(s6, cfg)
    if ckpt.keys() != s4.keys():
        fail("the combined checkpoint lacks keys")
    for k, v in ckpt.items():
        ref = head[k] if k.startswith(("head_body/", "rcnn_out/")) else s4[k]
        if not np.array_equal(v, ref):
            fail(f"combined checkpoint: {k} differs from its stage")
        src = s6 if k.startswith(("head_body/", "rcnn_out/")) else s4
        if not np.array_equal(final[k], src[k]):
            fail(f"combine_model: {k} differs from its stage")
    served = P.tester.Predictor(P.build_model(cfg), path, cfg, device=device)
    scale = cfg.tpu.SCALES[0]
    ds = P.SyntheticDataset(num_images=TRAIN_IMAGES,
                            num_classes=cfg.NUM_CLASSES, height=scale[0],
                            width=scale[1])
    images = [r["image_array"] for r in ds.gt_roidb()[:BATCH]]
    P.nms_cuda.nms_mask.launches = P.nms_cuda.nms_sweep.launches = 0
    records, walls = run_slice((P.image_mod, P.tester, P.post), served, cfg,
                               images, BATCH)
    served_launches = {"nms_mask": P.nms_cuda.nms_mask.launches,
                       "nms_sweep": P.nms_cuda.nms_sweep.launches}
    if set(served_launches.values()) != {len(walls)}:
        fail(f"combined Predictor: NMS launches {served_launches} in "
             f"{len(walls)} batches")
    del served
    log("alternate_slice", network=net.NETWORK, dtype=cfg.tpu.COMPUTE_DTYPE,
        assign_fused=cfg.tpu.ASSIGN_FUSED, flip=cfg.TRAIN.FLIP,
        records=stages[1]["records"], batch=BATCH, steps_per_stage=ALT_STEPS,
        stages=summary, kept_rows_equal_plain=kept, total_s=total_s,
        proposal_shape={"B": int(len(kept)), "n": te.RPN_PRE_NMS_TOP_N,
                        "max_out": te.RPN_POST_NMS_TOP_N}, kernels=times,
        served={"records_per_image": [len(r) for r in records],
                "batch_wall_s": walls, "launches": served_launches})
    return {"stages": summary, "total_s": total_s}


def check_proposals(P, cfg, st, name) -> None:
    """Every record: at most ``TEST.RPN_POST_NMS_TOP_N`` proposals inside
    its image, equal to its batch's valid RoIs in the original frame in
    descending score order, whose scores are sorted."""
    cap = cfg.TEST.RPN_POST_NMS_TOP_N
    for i, (props, (rois, scores, valid, info)) in enumerate(
            zip(st["proposals"], st["outs"], strict=True)):
        v = valid[0] > 0
        info = info[0]
        s = scores[0][v]
        if not 0 < len(props) <= cap or len(props) != int(v.sum()):
            fail(f"{name}: record {i} has {len(props)} proposals")
        if np.any(np.diff(s) > 0):
            fail(f"{name}: record {i}'s proposals are not score-sorted")
        want = (rois[0][v] / info[2])[np.argsort(-s)]
        if not np.array_equal(props, want.astype(np.float32)):
            fail(f"{name}: record {i}'s proposals differ from its RoIs")
        h, w = info[0] / info[2], info[1] / info[2]
        if (props.min() < 0 or (props[:, 2] > w).any()
                or (props[:, 3] > h).any()
                or (props[:, 2] < props[:, 0]).any()
                or (props[:, 3] < props[:, 1]).any()):
            fail(f"{name}: record {i} has proposals outside its image")


def check_kept_rows(P, cfg, predictor, images, im_info):
    """The RPN of ``predictor`` on one batch, then ``propose``'s NMS input:
    the kernels' kept indices against ``nms_padded`` on the same boxes,
    and ``propose`` through the kernels against its plain route.  Returns
    the kept counts and the NMS input (boxes, valid)."""
    te = cfg.TEST
    m = predictor.model
    with torch.inference_mode():
        feat = m.backbone(images)
        cls, bbox = m.rpn(feat)
        anchors = m._anchors_for(feat.shape[1], feat.shape[2], feat.device)
        info = torch.as_tensor(im_info, device=feat.device,
                               dtype=torch.float32)
        rpn = (P.fg_prob(cls), bbox, anchors, info)
        boxes, scores, valid = P.proposal_candidates(
            *rpn, pre_nms_top_n=te.RPN_PRE_NMS_TOP_N,
            min_size=te.RPN_MIN_SIZE)
        ki, km = P.nms_cuda.nms_bitmask(boxes, valid, te.RPN_POST_NMS_TOP_N,
                                        te.RPN_NMS_THRESH)
        kept = []
        for b in range(boxes.shape[0]):
            ri, rm = P.nms_padded(boxes[b], scores[b], te.RPN_POST_NMS_TOP_N,
                                  te.RPN_NMS_THRESH, valid=valid[b])
            if not torch.equal(ki[b][km[b]], ri[rm]):
                fail(f"alternate proposals: kernel and plain NMS keep "
                     f"different rows in image {b}")
            kept.append(int(km[b].sum()))
        kw = dict(pre_nms_top_n=te.RPN_PRE_NMS_TOP_N,
                  post_nms_top_n=te.RPN_POST_NMS_TOP_N,
                  nms_thresh=te.RPN_NMS_THRESH, min_size=te.RPN_MIN_SIZE)
        k_rois, _, k_valid = P.propose(*rpn, use_kernel=True, **kw)
        p_rois, _, p_valid = P.propose(*rpn, use_kernel=False, **kw)
    if not (torch.equal(k_valid, p_valid) and torch.equal(k_rois, p_rois)):
        fail("alternate proposals: kernel and plain propose differ")
    return kept, boxes, valid


# ---- the input-pipeline slice -------------------------------------------------

def loader_epochs(loader, epochs: int):
    """``epochs`` passes of a loader → (its host batches, each pass's wall
    seconds); its workers closed after.  The batches are the loader's own
    arrays (each one fresh), kept without a copy inside the timed loop."""
    batches, walls = [], []
    try:
        for _ in range(epochs):
            t0 = time.perf_counter()
            batches.extend(loader)
            walls.append(time.perf_counter() - t0)
    finally:
        loader.close_workers()
    return batches, walls


def batches_differ(got, want) -> str:
    """'' when both lists hold the same batches bitwise, every key and
    dtype; else where they first differ."""
    if len(got) != len(want):
        return f"{len(got)} batches against {len(want)}"
    for i, (a, b) in enumerate(zip(got, want)):
        if list(a) != list(b):
            return f"batch {i}: keys {list(a)} against {list(b)}"
        for k in a:
            if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]):
                return f"batch {i}, key {k}"
    return ""


def shm_report(P) -> dict:
    """``/dev/shm``'s size and what is free, in bytes."""
    try:
        st = os.statvfs(P.workers._SHM_DIR)
    except OSError:
        return {"path": P.workers._SHM_DIR, "size": None, "free": None}
    return {"path": P.workers._SHM_DIR, "size": st.f_blocks * st.f_frsize,
            "free": st.f_bavail * st.f_frsize}


def timed_fit(P, cfg, model, params, roidb, seed: int, device,
              counters: dict) -> dict:
    """``fit`` over ``PIPE_FIT_EPOCHS`` epochs of an ``AnchorLoader`` on
    ``roidb`` (its ``LOADER_WORKERS`` and ``PREFETCH`` from ``cfg``), the
    metrics fetched once an epoch; the assign counters set to 0 just
    before and read just after, once a step.  The step wall is read from
    the end of epoch 0 (pool start-up, first fill) to the end of the
    last."""
    loader = P.AnchorLoader(roidb, cfg, BATCH, seed=seed)
    steps = loader.steps_per_epoch
    marks, seen = [], []

    def on_epoch(e, st, m):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        seen.append(m)

    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    try:
        P.fit(cfg, model, params, loader, end_epoch=PIPE_FIT_EPOCHS,
              seed=seed, frequent=steps, device=device,
              batch_end_callback=on_epoch)
    finally:
        loader.close_workers()
    launches = {k: f.launches for k, f in counters.items()}
    tag = f"workers {cfg.tpu.LOADER_WORKERS}, prefetch {cfg.tpu.PREFETCH}"
    if len(marks) != PIPE_FIT_EPOCHS:
        fail(f"pipeline timed fit [{tag}]: {len(marks)} epochs fetched")
    for name, count in launches.items():
        if count != PIPE_FIT_EPOCHS * steps:
            fail(f"pipeline timed fit [{tag}]: {name} launched {count} times "
                 f"in {PIPE_FIT_EPOCHS * steps} steps")
    if not all(np.isfinite(v) for m in seen for v in m.values()):
        fail(f"pipeline timed fit [{tag}]: non-finite metrics {seen}")
    timed = (PIPE_FIT_EPOCHS - 1) * steps
    return {"steps_timed": timed, "launches": launches,
            "step_ms": (marks[-1] - marks[0]) / timed * 1e3,
            "epoch_s": np.diff(marks).tolist(),
            "total_loss": [m["total_loss"] for m in seen]}


def timed_alternate(P, pretrained: str, root: str, devkit: str, work: str,
                    seed: int, prefetch: int, device=None,
                    flags=ALT_FLAGS + ["--cfg", f"network__PIXEL_STDS="
                                                f"{PIXEL_STDS!r}"]) -> dict:
    """``train_alternate.alternate_train`` on the devkit's ``TRAIN_SPLIT``
    (PNG files, one epoch a stage) at ``--prefetch prefetch``, serial
    loaders: each stage timed, model build included, the kernel counts set
    to 0 just before it and read just after (the assign pair once a step
    in the RPN stages, the NMS pair once a record in the proposal
    stages)."""
    counters = {"nms_mask": P.nms_cuda.nms_mask,
                "nms_sweep": P.nms_cuda.nms_sweep,
                "assign_gtmax": P.assign_cuda.assign_gtmax,
                "assign_rows": P.assign_cuda.assign_rows}
    stages = []

    def timed(stage, graph):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            for f in counters.values():
                f.launches = 0
            t0 = time.perf_counter()
            out = stage(*a, **kw)
            torch.cuda.synchronize()
            n = len(out) if graph == "proposals" else out.step
            stages.append({"graph": graph, "wall_s": time.perf_counter() - t0,
                           "n": n, "launches": {k: f.launches
                                                for k, f in counters.items()}})
            return out
        return wrapped

    saved = {name: getattr(P.train_alternate, name)
             for name in ("train_rpn", "test_rpn", "train_rcnn")}
    for name, graph in (("train_rpn", "rpn"), ("test_rpn", "proposals"),
                        ("train_rcnn", "rcnn")):
        setattr(P.train_alternate, name, timed(saved[name], graph))
    argv = flags + [
        "--image_set", f"2007_{TRAIN_SPLIT}", "--root_path", root, "--dataset_path", devkit,
        "--batch_images", str(BATCH), "--end_epoch", "1", "--frequent",
        "1000", "--seed", str(seed), "--pretrained", pretrained, "--prefix",
        os.path.join(work, f"alt-p{prefetch}", "alt"), "--prefetch",
        str(prefetch)] + (["--device", str(device)] if device else [])
    t0 = time.perf_counter()
    try:
        P.train_alternate.alternate_train(P.train_alternate.parse_args(argv))
    finally:
        for name, f in saved.items():
            setattr(P.train_alternate, name, f)
    total_s = time.perf_counter() - t0
    if [st["graph"] for st in stages] != ["rpn", "proposals", "rcnn"] * 2:
        fail(f"pipeline alternate [prefetch {prefetch}]: stages ran as "
             f"{[st['graph'] for st in stages]}")
    for st in stages:
        n, la = st["n"], st["launches"]
        want = {"nms_mask": 0, "nms_sweep": 0, "assign_gtmax": 0,
                "assign_rows": 0}
        if st["graph"] == "proposals":
            want.update(nms_mask=n, nms_sweep=n)
        elif st["graph"] == "rpn":
            want.update(assign_gtmax=n, assign_rows=n)
        if n < 1 or la != want:
            fail(f"pipeline alternate [prefetch {prefetch}]: {st['graph']} "
                 f"stage of {n} launched {la}, expected {want}")
    return {"total_s": total_s, "stages": stages}


def pipeline_slice(P, tcfg, prefix: str, epoch: int, work: str, seed: int,
                   serve_caller: dict, device=None, flags=EVAL_FLAGS,
                   alt_flags=None) -> dict:
    """The host input pipeline under training, evaluation and serving, at
    the training slice's width, on the devkit's PNG files (decoded by the
    port):

    * ``AnchorLoader`` on ``TRAIN_SPLIT`` at each of ``PIPE_RATE_WORKERS``,
      the same seed, for a first epoch and then ``PIPE_RATE_BATCHES``
      batches, and ``ROIIter`` (``PIPE_PROPOSALS`` cached proposals a
      record) for two epochs: every batch of every epoch bitwise equal to
      the serial producer's; ``AnchorLoader``'s batches/s alone after the
      first epoch (``ROIIter`` adds the proposals in the parent: its rate
      was within 6% of it over 200 batches, PERF.md);
    * ``fit`` for ``PIPE_STEPS`` steps from the training slice's checkpoint,
      serial and at ``PIPE_WORKERS`` workers, the assign counters set to 0
      just before each and read just after: once a step; step 1's metrics
      equal bitwise; then ``fit``'s step wall over ``PIPE_FIT_EPOCHS``
      epochs at 0 and ``PIPE_WORKERS`` workers × each of ``PIPE_PREFETCH``
      (:func:`timed_fit`);
    * ``train_alternate`` on ``TRAIN_SPLIT``, one epoch a stage, at each of
      ``PIPE_PREFETCH`` (:func:`timed_alternate`): the stages' walls;
    * ``test_rcnn``'s serial loop over ``PIPE_EVAL_SPLIT`` at each of
      ``PIPE_PREFETCH``: the detections bit-identical, the NMS pair once a
      batch, loader wait and images/s of each;
    * the server in host-NMS mode with ``--loader-workers PIPE_WORKERS``:
      ``PIPE_REQUESTS`` requests staged in the prep pool answer the offline
      records of their batch row (:func:`serve_mode`); after ``stop()`` the
      workers are gone and the ring unlinked."""
    tstart = time.perf_counter()
    devkit = write_devkit(work, seed)
    root = os.path.join(work, "data")
    imdb = P.PascalVOC(f"2007_{TRAIN_SPLIT}", root, devkit)
    roidb = P.get_train_roidb(imdb, tcfg)

    def with_pipe(workers: int, prefetch: int = 2):
        return tcfg.replace(tpu=dataclasses.replace(
            tcfg.tpu, LOADER_WORKERS=workers, PREFETCH=prefetch))

    rng = np.random.RandomState(seed)
    with_props = []
    for rec in roidb:
        xy = rng.rand(PIPE_PROPOSALS, 2) * [rec["width"] - 40,
                                            rec["height"] - 40]
        wh = rng.rand(PIPE_PROPOSALS, 2) * 30 + 8
        with_props.append(dict(rec, proposals=np.concatenate(
            [xy, xy + wh], 1).astype(np.float32)))

    # ---- the loaders alone ----
    loaders, rates = {}, {}
    for name, cls, records, timed in (
            ("anchor", P.AnchorLoader, roidb, True),
            ("roi", P.ROIIter, with_props, False)):
        want = None
        for workers in PIPE_RATE_WORKERS:
            ld = cls(records, with_pipe(workers), BATCH, seed=seed)
            steps = ld.steps_per_epoch
            epochs = 1 + (-(-PIPE_RATE_BATCHES // steps) if timed else 1)
            batches, walls = loader_epochs(ld, epochs)
            if timed:
                rates[f"{name}_w{workers}"] = {
                    "batches_timed": (epochs - 1) * steps,
                    "first_epoch_s": walls[0],
                    "batches_per_s": (epochs - 1) * steps / sum(walls[1:])}
            if want is None:
                want = batches
                continue
            diff = batches_differ(batches, want)
            if diff:
                fail(f"pipeline: {name} loader at {workers} workers differs "
                     f"from the serial producer at {diff}")
            del batches
        loaders[name] = {"records": len(records), "batches": len(want),
                         "epochs": epochs, "bitwise_equal": True}
        del want
    log("pipeline_loaders", split=TRAIN_SPLIT, records=len(roidb),
        batch=BATCH, loaders=loaders, rates=rates,
        shm=shm_report(P), slot_bytes=P.workers.slot_bytes_for(tcfg),
        ring_bytes={w: max(2 * w + 2, 4) * P.workers.slot_bytes_for(tcfg)
                    for w in PIPE_RATE_WORKERS[1:]})

    # ---- fit through the pool ----
    counters = {"assign_gtmax": P.assign_cuda.assign_gtmax,
                "assign_rows": P.assign_cuda.assign_rows}
    params = P.load_params_npz(P.epoch_path(prefix, epoch))
    model = P.build_model(tcfg)
    fits = {}
    for workers in (0, PIPE_WORKERS):
        cfg_w = with_pipe(workers)
        loader = P.CappedLoader(P.AnchorLoader(roidb, cfg_w, BATCH,
                                               seed=seed), PIPE_STEPS)
        seen = []
        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        try:
            P.fit(cfg_w, model, params, loader, end_epoch=1, seed=seed,
                  frequent=1, device=device,
                  batch_end_callback=lambda e, st, m: seen.append(m))
            torch.cuda.synchronize()
        finally:
            loader.close_workers()
        launches = {k: f.launches for k, f in counters.items()}
        if len(seen) != PIPE_STEPS:
            fail(f"pipeline: fit at {workers} workers took {len(seen)} "
                 f"steps, expected {PIPE_STEPS}")
        for name, count in launches.items():
            if count != PIPE_STEPS:
                fail(f"pipeline: {name} launched {count} times in "
                     f"{PIPE_STEPS} steps at {workers} workers")
        if not all(np.isfinite(v) for m in seen for v in m.values()):
            fail(f"pipeline: non-finite metrics at {workers} workers: {seen}")
        fits[workers] = {"metrics": seen, "launches": launches,
                         "wall_s": time.perf_counter() - t0}
    serial, pooled = fits[0]["metrics"], fits[PIPE_WORKERS]["metrics"]
    if serial[0] != pooled[0]:
        print(json.dumps({"step1_serial": serial[0],
                          f"step1_workers{PIPE_WORKERS}": pooled[0]}),
              flush=True)
        fail("pipeline: fit's step-1 metrics differ between the serial "
             "producer and the worker pool")
    timed = {f"w{w}_p{p}": timed_fit(P, with_pipe(w, p), model, params,
                                     roidb, seed, device, counters)
             for w in (0, PIPE_WORKERS) for p in PIPE_PREFETCH}
    log("pipeline_fit", steps=PIPE_STEPS, workers=[0, PIPE_WORKERS],
        step1_bitwise_equal=True, later_steps_equal=serial == pooled,
        runs=fits, timed_epochs=PIPE_FIT_EPOCHS, timed=timed)
    del model, params
    torch.cuda.empty_cache()

    # ---- alternate training at each prefetch depth ----
    alt_kw = {} if alt_flags is None else {"flags": alt_flags}
    alts = {f"prefetch_{p}": timed_alternate(
        P, P.epoch_path(prefix, epoch), root, devkit, work, seed, p, device,
        **alt_kw) for p in PIPE_PREFETCH}
    log("pipeline_alternate", split=TRAIN_SPLIT, batch=BATCH, runs=alts)
    torch.cuda.empty_cache()

    # ---- evaluation with and without the prefetch thread ----
    args = flags + ["--image_set", f"2007_{PIPE_EVAL_SPLIT}", "--root_path",
                    root, "--dataset_path", devkit, "--prefix", prefix,
                    "--epoch", str(epoch), "--batch_images", str(BATCH),
                    "--eval-inflight", "0"]
    if device is not None:
        args += ["--device", str(device)]
    n_batches = -(-PIPE_EVAL_IMAGES // BATCH)
    evals, boxes = {}, {}
    for prefetch in PIPE_PREFETCH:
        cache = os.path.join(work, f"pipe-dets-{prefetch}.pkl")
        P.nms_cuda.nms_mask.launches = P.nms_cuda.nms_sweep.launches = 0
        out = P.test_driver.test_rcnn(P.test_driver.parse_args(
            args + ["--prefetch", str(prefetch), "--dets_cache", cache]))
        launches = {"nms_mask": P.nms_cuda.nms_mask.launches,
                    "nms_sweep": P.nms_cuda.nms_sweep.launches}
        for name, count in launches.items():
            if count != n_batches:
                fail(f"pipeline eval [prefetch {prefetch}]: {name} launched "
                     f"{count} times in {n_batches} batches")
        with open(cache, "rb") as f:
            boxes[prefetch] = pickle.load(f)
        ep = out["eval_pipeline"]
        evals[prefetch] = {"mAP": out["mAP"], "launches": launches,
                           "loader_wait_s": ep["loader_wait_s"],
                           "imgs_per_sec": ep["imgs_per_sec"],
                           "wall_s": ep["wall_s"]}
    base = boxes[PIPE_PREFETCH[0]]
    for p in PIPE_PREFETCH[1:]:
        for k in range(1, len(base)):
            for i, (a, b) in enumerate(zip(boxes[p][k], base[k],
                                           strict=True)):
                if a.dtype != b.dtype or not np.array_equal(a, b):
                    fail(f"pipeline eval: the detections of class {k} in "
                         f"image {i} at --prefetch {p} differ from the "
                         f"serial loop's")
    log("pipeline_eval", split=PIPE_EVAL_SPLIT, images=PIPE_EVAL_IMAGES,
        batch=BATCH, bit_identical=True,
        modes={f"prefetch_{p}": e for p, e in evals.items()})

    # ---- serving through the prep pool ----
    rng = np.random.RandomState(seed)
    images = [boxes_image(rng, *hw)[0] for hw in SERVE_SIZES]
    P.telemetry.configure(work, stream=False)
    sargs = P.serve_driver.parse_args(
        flags + ["--prefix", prefix, "--epoch", str(epoch), "--serve-batch",
                 str(BATCH), "--max-delay-ms", "10", "--loader-workers",
                 str(PIPE_WORKERS), "--unix-socket", "unused"]
        + (["--device", str(device)] if device is not None else []))
    cfg = P.config_from_args(sargs, train=False)
    predictor, engine = P.serve_driver.build_engine(sargs, cfg)
    pool = engine._pool
    if pool is None or pool.num_workers != PIPE_WORKERS:
        engine.stop()
        fail(f"serve: --loader-workers {PIPE_WORKERS} made no prep pool of "
             f"{PIPE_WORKERS} workers")
    staged = [0]
    prepare = pool.prepare

    def counted(*a, **k):
        staged[0] += 1
        return prepare(*a, **k)

    pool.prepare = counted
    name, ring = pool.shm_name, pool.ring_bytes
    try:
        served = serve_mode(P, predictor, engine, cfg,
                            os.path.join(work, "pool.sock"), images,
                            e2e=False, requests=PIPE_REQUESTS)
    finally:
        engine.stop()
        P.telemetry.shutdown()
    end = time.monotonic() + 10
    while pool.alive_workers() and time.monotonic() < end:
        time.sleep(0.05)
    if pool.alive_workers():
        fail(f"serve: {pool.alive_workers()} prep workers alive after stop()")
    if os.path.exists(os.path.join(P.workers._SHM_DIR, name.lstrip("/"))):
        fail(f"serve: the prep ring {name} is still in /dev/shm after stop()")
    if staged[0] < PIPE_REQUESTS:
        fail(f"serve: {staged[0]} of {PIPE_REQUESTS} requests staged in the "
             f"prep pool")
    caller = serve_caller["host_nms"]
    log("pipeline_serve", workers=PIPE_WORKERS, ring_bytes=ring,
        staged_in_pool=staged[0], requests=PIPE_REQUESTS,
        records_match_offline=True, workers_gone=True, ring_unlinked=True,
        host_prep_ms={"pool": [served["host_prep_p50_ms"],
                               served["host_prep_p99_ms"]],
                      "caller_thread": [caller["host_prep_p50_ms"],
                                        caller["host_prep_p99_ms"]]},
        request_time_ms={"pool": [served["request_time_p50_ms"],
                                  served["request_time_p99_ms"]],
                         "caller_thread": [caller["request_time_p50_ms"],
                                           caller["request_time_p99_ms"]]},
        requests_per_s={"pool": served["requests_per_s"],
                        "caller_thread": caller["requests_per_s"]},
        mode=served)
    del predictor, engine
    torch.cuda.empty_cache()
    log("pipeline_total", seconds=time.perf_counter() - tstart)
    return {"rates": rates, "eval": evals, "serve": served}


# ---- the resilience slice ----------------------------------------------------

def state_arrays(P, st) -> tuple:
    """A ``TrainState``'s parameters and momentum, host arrays by JAX key."""
    return (P.export_jax_params(st.model),
            P.export_momentum(st.model, st.optimizer))


def max_abs_diff(got, want) -> float:
    """The largest absolute difference over dicts of arrays with the same
    keys (inf where the keys differ)."""
    diff = 0.0
    for g, w in zip(got, want):
        if g.keys() != w.keys():
            return float("inf")
        for k in w:
            diff = max(diff, float(np.max(np.abs(
                g[k].astype(np.float64) - w[k].astype(np.float64)))))
    return diff


def torchvision_resnet_state_dict(units, seed: int) -> dict:
    """A torchvision ResNet's state_dict names and shapes (``units``
    bottleneck blocks a stage: ``resnet101``'s are (3, 4, 23, 3)), seeded
    random values drawn so that the random network stays finite: He-normal
    convolutions, the last batch norm of each block near 0 (its branch
    small beside the shortcut), running variances in [0.5, 1.5]."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[name] = torch.randn(o, i, k, k, generator=gen) * (2.0 / (i * k * k)) ** 0.5

    def bn(name, c, scale=1.0):
        sd[name + ".weight"] = torch.rand(c, generator=gen) * scale
        sd[name + ".bias"] = torch.randn(c, generator=gen) * 0.05
        sd[name + ".running_mean"] = torch.randn(c, generator=gen) * 0.05
        sd[name + ".running_var"] = torch.rand(c, generator=gen) + 0.5
        sd[name + ".num_batches_tracked"] = torch.tensor(0)

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    in_ch = 64
    for li, (n, w) in enumerate(zip(units, (64, 128, 256, 512)), start=1):
        for u in range(n):
            p = f"layer{li}.{u}"
            c_in = in_ch if u == 0 else w * 4
            conv(p + ".conv1.weight", w, c_in, 1)
            bn(p + ".bn1", w)
            conv(p + ".conv2.weight", w, w, 3)
            bn(p + ".bn2", w)
            conv(p + ".conv3.weight", w * 4, w, 1)
            bn(p + ".bn3", w * 4, scale=0.1)
            if u == 0:
                conv(p + ".downsample.0.weight", w * 4, c_in, 1)
                bn(p + ".downsample.1", w * 4)
        in_ch = w * 4
    sd["fc.weight"] = torch.randn(1000, 2048, generator=gen) * 0.01
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def sentinel_cases(P, dev) -> dict:
    """The step's all-finite flag on ``dev`` for gradient leaves of the
    sizes of ResNet-101's (one of 2.4 M elements) with one element, in
    the middle of the large leaf, set to NaN, ±inf or 3e38, and for a NaN
    loss; fails unless only the finite cases pass."""
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = ((512, 512, 3, 3), (2048,), (84, 2048))
    cases = {}
    for name, value in (("finite", None), ("nan", float("nan")),
                        ("inf", float("inf")), ("-inf", -float("inf")),
                        ("huge", 3.0e38), ("nan_loss", None)):
        grads = [torch.randn(s, device=dev, generator=gen) for s in shapes]
        total = torch.tensor(float("nan") if name == "nan_loss" else 1.5,
                             device=dev)
        if value is not None:
            grads[0].view(-1)[grads[0].numel() // 2 + 7] = value
        cases[name] = bool(P._all_finite(total, grads))
    want = {k: k in ("finite", "huge") for k in cases}
    if cases != want:
        fail(f"resilience: the all-finite flag on {dev}: {cases}, "
             f"expected {want}")
    return cases


def sentinel_profile(fns, state, batch, gen, sync, on_card) -> dict:
    """One step of each variant under ``torch.profiler``: per operator,
    the calls, host (self CPU) and device (self CUDA) milliseconds; for
    ``on`` and ``skip`` the operators whose call count differs from
    ``off``'s (what the sentinel and the guard add), and each variant's
    totals."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    tables = {}
    for name in ("off", "on", "skip"):
        sync()
        with profile(activities=acts) as prof:
            fns[name](state, batch, generator=gen)
            sync()
        table = {}
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0))
            table[ev.key] = (ev.count, ev.self_cpu_time_total / 1e3,
                             dev_us / 1e3)
        tables[name] = table
    out = {"totals": {k: {"calls": sum(c for c, _, _ in t.values()),
                          "host_ms": sum(h for _, h, _ in t.values()),
                          "device_ms": sum(d for _, _, d in t.values())}
                      for k, t in tables.items()}}
    base = tables["off"]
    for name in ("on", "skip"):
        added = {}
        for op, (c, h, d) in tables[name].items():
            c0, h0, d0 = base.get(op, (0, 0.0, 0.0))
            if c != c0:
                added[op] = {"calls": c - c0, "host_ms": h - h0,
                             "device_ms": d - d0}
        out[f"added_{name}"] = dict(sorted(
            added.items(), key=lambda kv: -kv[1]["host_ms"]))
    return out


def resilience_slice(P, pretrained: str, work: str, seed: int, smi: str,
                     device=None, flags=RES_FLAGS) -> dict:
    """Training that survives a real run, at the training slice's width:
    ``python -m mx_rcnn_tpu_torch.train_end2end``'s inputs (``flags``, the
    synthetic set of ``RES_IMAGES`` images, ``--pretrained`` the training
    slice's checkpoint), one epoch of ``RES_STEPS`` steps.

    * The reference: ``fit`` with a step checkpoint every
      ``RES_SAVE_EVERY`` steps under ``skip``, run twice; the largest
      difference between the two runs' parameters and momentum is the
      bound every resumed run is held to (0: bitwise).
    * Preemption in process: the same run with SIGTERM raised from
      ``batch_end_callback`` after ``RES_PREEMPT_AT`` steps returns with a
      step checkpoint and no epoch file; ``fit(auto_resume)`` finishes the
      epoch, the four kernels launching once a step it runs, and ends at
      the reference's state.
    * Preemption as a process: the driver with ``--save-every-n-steps
      --auto-resume --nan-policy skip`` gets SIGTERM once its first step
      checkpoint appears and exits 0 without an epoch file; run again, it
      writes the reference's epoch file.
    * ``MXR_FAULT_NAN_STEP``: under ``skip`` the poisoned step leaves the
      parameters and momentum bitwise and counts ``train/nan_skipped``;
      ``halt`` raises ``NonFiniteLossError`` and dumps; ``rollback``
      restores the step checkpoint and goes on finite.
    * The sentinel's flag on card tensors: a NaN, an infinity or a huge
      finite value in the middle of a large gradient leaf, or a NaN loss.
    * One step's dispatch with the sentinel off, on, and on under
      ``skip``: the synchronising CUDA calls of each (equal), the step
      wall of each (median and spread), and one profiled step of each:
      the operators whose launches the sentinel and the guard add, with
      their host and device time.
    * The converter: a torchvision state_dict of the network (``resnet101``)
      of seeded random tensors through ``convert_file``, then
      ``--pretrained``:
      every ``backbone`` and ``head_body`` leaf laid over, and a
      ``Predictor`` on the result detects.
    """
    tstart = time.perf_counter()
    dev = torch.device(device or "cuda")
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    # a fresh process's TF32 settings (torch's defaults; earlier phases
    # turned cuDNN's off), so that the driver run as a process below
    # computes as the runs in this one do
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _resilience_runs(P, pretrained, work, seed, smi, dev, on_card,
                                sync, flags, tstart)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def _resilience_runs(P, pretrained, work, seed, smi, dev, on_card, sync,
                     flags, tstart) -> dict:
    """The body of :func:`resilience_slice`."""
    import signal
    import warnings

    base = flags + ["--pretrained", pretrained, "--seed", str(seed)] + (
        [] if on_card else ["--device", "cpu"])
    args = P.train_end2end.parse_args(base)
    cfg = P.config_from_args(args, train=True)
    roidb = P.get_train_roidb(P.get_imdb(args, cfg), cfg)
    model = P.build_model(cfg)
    params = P.init_or_load_params(args, model)
    counters = {"nms_mask": P.nms_cuda.nms_mask,
                "nms_sweep": P.nms_cuda.nms_sweep,
                "assign_gtmax": P.assign_cuda.assign_gtmax,
                "assign_rows": P.assign_cuda.assign_rows}
    skip = P.ResilienceOptions(save_every_n_steps=RES_SAVE_EVERY,
                               nan_policy="skip")
    tel = P.telemetry.configure(os.path.join(work, "res_tel"), stream=False)

    def new_loader(cap=None):
        # the driver's loader (train_end2end.train_net)
        ld = P.AnchorLoader(roidb, cfg, BATCH, shuffle=cfg.TRAIN.SHUFFLE)
        return ld if cap is None else P.CappedLoader(ld, cap)

    def run(prefix, res, cb=None, loader=None):
        seen = []

        def on_step(e, s, m):
            seen.append(m)
            if cb is not None:
                cb(e, s, m)

        sync()
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        st = P.fit(cfg, model, params, loader or new_loader(),
                   end_epoch=args.end_epoch, prefix=prefix, seed=args.seed,
                   frequent=args.frequent, device=dev,
                   batch_end_callback=on_step, resilience=res)
        sync()
        return {"state": st, "seen": seen,
                "wall_s": time.perf_counter() - t0,
                "launches": {k: f.launches for k, f in counters.items()}}

    def launches_once_a_step(r, steps, what):
        for name, count in r["launches"].items():
            if count != steps:
                fail(f"resilience [{what}]: {name} launched {count} times "
                     f"in {steps} steps")

    # ---- the reference, twice ----
    ref_prefix = os.path.join(work, "res_ref", "e2e")
    ref = run(ref_prefix, skip)
    if len(ref["seen"]) != RES_STEPS or ref["state"].step != RES_STEPS:
        fail(f"resilience reference: {len(ref['seen'])} steps fetched of "
             f"{RES_STEPS}")
    launches_once_a_step(ref, RES_STEPS, "reference")
    if not all(m["all_finite"] == 1.0 and np.isfinite(list(m.values())).all()
               for m in ref["seen"]):
        fail(f"resilience reference: non-finite metrics {ref['seen']}")
    want = state_arrays(P, ref["state"])
    ref_epoch = P.load_params_npz(P.epoch_path(ref_prefix, 1))
    again = run(None, skip)
    bound = max_abs_diff(state_arrays(P, again["state"]), want)
    del again

    def within(diff, what):
        if not diff <= bound:
            fail(f"resilience [{what}]: differs from the reference by "
                 f"{diff}, beyond the two references' {bound}")

    # ---- preemption in process ----
    pre_prefix = os.path.join(work, "res_pre", "e2e")
    handler = signal.getsignal(signal.SIGTERM)

    def preempt(e, s, m):
        if s == RES_PREEMPT_AT:
            signal.raise_signal(signal.SIGTERM)

    pre = run(pre_prefix, skip, cb=preempt)
    mgr = P.CheckpointManager(pre_prefix)
    point = mgr.latest_resume_point()
    stopped = pre["state"].step
    if stopped not in (RES_PREEMPT_AT, RES_PREEMPT_AT + 1) or \
            point != ("step", 0, stopped) or mgr.available_epochs():
        fail(f"resilience preemption: stopped at step {stopped}, resume "
             f"point {point}, epochs {mgr.available_epochs()}")
    if signal.getsignal(signal.SIGTERM) is not handler:
        fail("resilience preemption: fit left its SIGTERM handler")
    launches_once_a_step(pre, stopped, "preempted")
    step_file = mgr._step_path(P.encode_step_key(0, stopped))
    ckpt_bytes = os.path.getsize(step_file)
    sync()
    t0 = time.perf_counter()
    mgr.load_step_checkpoint(0, stopped)
    load_ms = (time.perf_counter() - t0) * 1e3
    resumed = run(pre_prefix, dataclasses.replace(skip, auto_resume=True))
    ran = len(resumed["seen"])
    if ran != RES_STEPS - stopped or resumed["state"].step != RES_STEPS:
        fail(f"resilience resume: ran {ran} steps from {stopped}")
    launches_once_a_step(resumed, ran, "resumed")
    inproc_diff = max_abs_diff(state_arrays(P, resumed["state"]), want)
    within(inproc_diff, "in-process resume")
    save_span = tel.summary()["spans"].get("checkpoint/step_save", {})
    log("resilience_resume", seconds=time.perf_counter() - tstart,
        repeat_max_abs_diff=bound,
        reference_launches=ref["launches"], preempted_at=stopped,
        preempted_launches=pre["launches"], resumed_steps=ran,
        resumed_launches=resumed["launches"],
        inprocess_max_abs_diff=inproc_diff, step_ckpt_bytes=ckpt_bytes,
        step_save_ms=(save_span["total_s"] / save_span["count"] * 1e3
                      if save_span else None), step_load_ms=load_ms,
        walls_s={"reference": ref["wall_s"], "preempted": pre["wall_s"],
                 "resumed": resumed["wall_s"]})
    del pre, resumed

    # ---- preemption as a process ----
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    proc_prefix = os.path.join(work, "res_proc", "e2e")
    cmd = [sys.executable, "-m", "mx_rcnn_tpu_torch.train_end2end"] + base + [
        "--prefix", proc_prefix, "--save-every-n-steps", str(RES_SAVE_EVERY),
        "--auto-resume", "--nan-policy", "skip"]
    steps_dir = proc_prefix + "-steps"
    procs = {}
    for name in ("preempted", "finished"):
        log_path = os.path.join(work, f"res_proc_{name}.log")
        t0 = time.perf_counter()
        with open(log_path, "w") as log_f:
            proc = subprocess.Popen(cmd, cwd=repo, env=env, stdout=log_f,
                                    stderr=subprocess.STDOUT)
            try:
                if name == "preempted":
                    while not (os.path.isdir(steps_dir) and any(
                            n.endswith(".npz") for n in os.listdir(steps_dir))):
                        if proc.poll() is not None or \
                                time.perf_counter() - t0 > RES_PROC_TIMEOUT_S:
                            break
                        time.sleep(0.01)
                    proc.send_signal(signal.SIGTERM)
                rc = proc.wait(timeout=RES_PROC_TIMEOUT_S)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        with open(log_path) as f:
            text = f.read()
        tail = text[-3000:]
        # the driver's own log lines, time-stamped: where its wall went
        marks = [line[11:23] + " " + line.split(": ", 1)[-1][:48]
                 for line in text.splitlines() if " INFO " in line]
        procs[name] = {"rc": rc, "wall_s": time.perf_counter() - t0,
                       "resume_point": P.CheckpointManager(
                           proc_prefix).latest_resume_point(),
                       "log_marks": marks[:3] + marks[-6:]}
        if rc != 0:
            fail(f"resilience process [{name}]: exit code {rc}\n{tail}")
        has_epoch = os.path.exists(P.epoch_path(proc_prefix, 1))
        if name == "preempted" and (has_epoch or "preemption requested"
                                    not in tail):
            fail(f"resilience process: the run was not preempted "
                 f"(epoch file {has_epoch})\n{tail}")
    proc_epoch = P.load_params_npz(P.epoch_path(proc_prefix, 1))
    proc_diff = max_abs_diff((proc_epoch,), (ref_epoch,))
    log("resilience_process", seconds=time.perf_counter() - tstart,
        process=procs, process_max_abs_diff=proc_diff)
    within(proc_diff, "process resume")
    for d in (ref_prefix, pre_prefix, proc_prefix):  # ~380 MB a checkpoint
        shutil.rmtree(os.path.dirname(d), ignore_errors=True)

    # ---- the NaN policies (MXR_FAULT_NAN_STEP) ----
    env_key = P.resilience.ENV_NAN_STEP
    os.environ[env_key] = str(RES_NAN_AT)
    guarded = {}
    real_make = P.trainer.make_train_step

    def make(*a, **kw):
        fn = real_make(*a, **kw)
        calls = [0]

        def step(state, batch, **k):
            i = calls[0]
            calls[0] += 1
            if i != RES_NAN_AT:
                return fn(state, batch, **k)
            before = [t.detach().clone() for t in state.model.parameters()]
            bufs = [state.optimizer.state[p].get("momentum_buffer")
                    for g in state.optimizer.param_groups for p in g["params"]]
            before_m = [b.clone() for b in bufs if b is not None]
            out = fn(state, batch, **k)
            after_m = [state.optimizer.state[p].get("momentum_buffer")
                       for g in state.optimizer.param_groups
                       for p in g["params"]]
            guarded["params_kept"] = all(
                torch.equal(a, b) for a, b in zip(state.model.parameters(),
                                                  before))
            guarded["momentum_kept"] = len(before_m) == len(after_m) and all(
                torch.equal(a, b) for a, b in zip(after_m, before_m))
            guarded["momentum_leaves"] = len(before_m)
            return out

        return step

    nan = {}
    try:
        P.trainer.make_train_step = make
        c0 = dict(tel.summary()["counters"])
        r = run(None, P.ResilienceOptions(nan_policy="skip"),
                loader=new_loader(RES_NAN_AT + 2))
        c1 = tel.summary()["counters"]
        flags_seen = [m["all_finite"] for m in r["seen"]]
        skipped = c1.get("train/nan_skipped", 0) - c0.get("train/nan_skipped",
                                                          0)
        if not (guarded.get("params_kept") and guarded.get("momentum_kept")) \
                or skipped != 1 or flags_seen != [1.0] * RES_NAN_AT + [
                    0.0, 1.0]:
            fail(f"resilience skip: {guarded}, nan_skipped {skipped}, "
                 f"all_finite {flags_seen}")
        launches_once_a_step(r, RES_NAN_AT + 2, "skip")
        nan["skip"] = dict(guarded, all_finite=flags_seen)
        P.trainer.make_train_step = real_make

        try:
            run(os.path.join(work, "res_halt", "e2e"),
                P.ResilienceOptions(nan_policy="halt"),
                loader=new_loader(RES_NAN_AT + 2))
            fail("resilience halt: no NonFiniteLossError")
        except P.NonFiniteLossError as e:
            dump = os.path.join(tel.out_dir,
                                f"nan_dump_e0_b{RES_NAN_AT + 1}.json")
            if not os.path.exists(dump):
                fail(f"resilience halt: no dump at {dump} ({e})")
            nan["halt"] = {"raised": str(e).split(";")[0], "dump": True}

        c0 = dict(tel.summary()["counters"])
        r = run(os.path.join(work, "res_rb", "e2e"),
                P.ResilienceOptions(save_every_n_steps=RES_SAVE_EVERY,
                                    nan_policy="rollback"),
                loader=new_loader(RES_NAN_AT + 2))
        c1 = tel.summary()["counters"]
        rolled = c1.get("train/nan_rollback", 0) - c0.get(
            "train/nan_rollback", 0)
        flags_seen = [m["all_finite"] for m in r["seen"]]
        final = P.export_jax_params(r["state"].model)
        if rolled != 1 or flags_seen[-1] != 1.0 or not all(
                np.isfinite(v).all() for v in final.values()):
            fail(f"resilience rollback: nan_rollback {rolled}, all_finite "
                 f"{flags_seen}")
        nan["rollback"] = {"rolled_back": rolled, "all_finite": flags_seen,
                           "step": r["state"].step}
        log("resilience_nan", seconds=time.perf_counter() - tstart, **nan)
        del r, final
    finally:
        P.trainer.make_train_step = real_make
        os.environ.pop(env_key, None)

    # ---- the sentinel's flag on card tensors ----
    finite_cases = sentinel_cases(P, dev)
    log("resilience_sentinel", seconds=time.perf_counter() - tstart,
        cases=finite_cases)

    # ---- the sentinel's cost: synchronising calls and step wall ----
    ld = new_loader()
    ld.put = lambda b: P.batch_put(b, cfg, dev)
    it = iter(ld)
    batch = next(it)
    it.close()
    P.load_jax_params(model, params)
    model.to(dev)
    state = P.create_train_state(cfg, model, ld.steps_per_epoch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    fns = {"off": P.make_train_step(cfg),
           "on": P.make_train_step(cfg, sentinel=True),
           "skip": P.make_train_step(cfg, sentinel=True, skip_nonfinite=True)}

    def sync_sites(fn) -> list:
        """The synchronising CUDA calls of one dispatch of ``fn``, each as
        the source line that made it."""
        sync()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if on_card:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                fn(state, batch, generator=gen)
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode(0)
        sync()
        return sorted(f"{os.path.relpath(w.filename, repo)}:{w.lineno}"
                      for w in caught
                      if "synchroniz" in str(w.message).lower()
                      and "prototype feature" not in str(w.message))

    for fn in fns.values():
        fn(state, batch, generator=gen)  # warm-up
    sites = {k: [] for k in fns}
    for name in ("off", "on", "skip", "skip", "on", "off"):
        sites[name].append(sync_sites(fns[name]))
    syncs = {k: [len(x) for x in v] for k, v in sites.items()}
    where = {k: sorted({x for call in v for x in call})
             for k, v in sites.items()}
    log("resilience_sync", seconds=time.perf_counter() - tstart,
        sync_calls=syncs, sites=where)
    if len({n for v in syncs.values() for n in v}) != 1:
        fail(f"resilience: the sentinel changes the synchronising calls of "
             f"a step's dispatch: {syncs} at {where}")
    walls = {k: [] for k in fns}
    for name in ("off", "on", "skip", "skip", "on", "off"):
        for _ in range(RES_TIMED_STEPS):
            sync()
            t0 = time.perf_counter()
            fns[name](state, batch, generator=gen)
            sync()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    step_ms = {k: statistics.median(v) for k, v in walls.items()}
    spread = {k: {"min": min(v), "p10": float(np.percentile(v, 10)),
                  "p90": float(np.percentile(v, 90)), "max": max(v),
                  "stdev": statistics.stdev(v), "n": len(v)}
              for k, v in walls.items()}
    log("resilience_step_wall", seconds=time.perf_counter() - tstart,
        median_ms=step_ms, spread_ms=spread)
    profile = sentinel_profile(fns, state, batch, gen, sync, on_card)
    log("resilience_profile", seconds=time.perf_counter() - tstart,
        **profile)
    del state, batch

    # ---- the converter and --pretrained ----
    net = cfg.network.NETWORK
    pth = os.path.join(work, f"{net}_torchvision.pth")
    torch.save(torchvision_resnet_state_dict(
        P.convert_torch.RESNET_UNITS[net], seed), pth)
    npz = os.path.join(work, f"{net}_torchvision.npz")
    P.convert_torch.convert_file(pth, net, npz)
    converted = P.load_params_npz(npz)
    conv_args = P.train_end2end.parse_args(
        flags + ["--pretrained", npz, "--seed", str(seed)])
    laid = P.init_or_load_params(conv_args, model)
    body = [k for k in P.param_shapes(model)
            if k.startswith(("backbone/", "head_body/"))]
    overlaid = sum(1 for k in body if k in converted
                   and np.array_equal(laid[k], converted[k]))
    if overlaid != len(body):
        fail(f"converter: {overlaid} of {len(body)} backbone/head_body "
             f"leaves laid over")
    predictor = P.tester.Predictor(P.build_model(cfg), laid, cfg,
                                   device=dev)
    port = (P.image_mod, P.tester, P.post)
    records, _ = run_slice(port, predictor, cfg,
                           [r["image_array"] for r in roidb[:BATCH]], BATCH)
    if not any(records):
        fail("converter: the Predictor on the converted weights detects "
             "nothing")
    P.telemetry.shutdown()
    out = {"card": smi, "network": cfg.network.NETWORK,
           "steps": RES_STEPS, "save_every": RES_SAVE_EVERY,
           "reference_launches": ref["launches"],
           "repeat_max_abs_diff": bound, "bitwise_repeatable": bound == 0.0,
           "preempted_at": stopped, "resumed_steps": ran,
           "inprocess_max_abs_diff": inproc_diff,
           "process": procs, "process_max_abs_diff": proc_diff,
           "step_ckpt_bytes": ckpt_bytes,
           "step_save_ms": (save_span["total_s"] / save_span["count"] * 1e3
                            if save_span else None),
           "step_load_ms": load_ms, "nan": nan,
           "sentinel_cases": finite_cases,
           "sync_calls": syncs, "sync_sites": where, "step_wall_ms": step_ms,
           "step_wall_spread_ms": spread, "profile": profile,
           "converter_overlaid": overlaid,
           "converter_records_per_image": [len(x) for x in records],
           "seconds": time.perf_counter() - tstart}
    log("resilience", **out)
    return out


# ---- the COCO slice -------------------------------------------------------------

def coco_image(rng, h: int, w: int, n: int, cats):
    """Low-contrast noise with ``n`` solid rectangles, each given a
    category id drawn from ``cats`` → (uint8 (h, w, 3) image, [(x, y, bw,
    bh, cat)]) in 0-based pixels; past 8 rectangles they are drawn
    smaller."""
    img = (rng.randn(h, w, 3) * 20 + 127).clip(0, 255).astype(np.uint8)
    lo, hi = (12, 6) if n > 8 else (5, 2)
    boxes = []
    for _ in range(n):
        bw, bh = rng.randint(w // lo, w // hi), rng.randint(h // lo, h // hi)
        x, y = rng.randint(0, w - bw), rng.randint(0, h - bh)
        img[y:y + bh, x:x + bw] = rng.randint(40, 255, 3)
        boxes.append((x, y, bw, bh, int(cats[rng.randint(len(cats))])))
    return img, boxes


def write_coco(root: str, seed: int) -> str:
    """A COCO set in val2017's layout under ``root/coco``: the images of
    ``COCO_SIZES`` drawn by :func:`coco_image` (PNG bytes under ``.jpg``
    names, so no JPEG decoder is needed; sparse image ids in the sizes'
    order), ``annotations/instances_val2017.json`` under COCO's 80 sparse
    category ids.  The first image also holds a box past its right and
    bottom edges, a zero-area box and a crowd box; the second holds
    ``COCO_MANY`` non-crowd boxes of five categories (above ``MAX_GT``).
    Returns the dataset path."""
    rng = np.random.RandomState(seed)
    path = os.path.join(root, "coco")
    os.makedirs(os.path.join(path, COCO_SPLIT))
    os.makedirs(os.path.join(path, "annotations"))
    images, anns = [], []

    def ann(img_id, x, y, bw, bh, cat, area=None, crowd=0):
        anns.append({"id": len(anns) + 1, "image_id": img_id,
                     "category_id": cat,
                     "bbox": [float(x), float(y), float(bw), float(bh)],
                     "area": float(bw * bh if area is None else area),
                     "iscrowd": crowd})

    for i, (h, w) in enumerate(COCO_SIZES):
        img_id = 139 + 97 * i
        many = i == 1
        img, boxes = coco_image(rng, h, w,
                                COCO_MANY if many else rng.randint(1, 4),
                                COCO_IDS[:5] if many else COCO_IDS)
        name = f"{img_id:012d}.jpg"
        with open(os.path.join(path, COCO_SPLIT, name), "wb") as f:
            f.write(png_bytes(img))
        images.append({"id": img_id, "file_name": name, "height": h,
                       "width": w})
        for box in boxes:
            ann(img_id, *box)
        if i == 0:
            ann(img_id, w - 50, h - 40, 120, 90, COCO_IDS[-1])
            ann(img_id, 10, 10, 30, 30, COCO_IDS[1], area=0.0)
            ann(img_id, 0, 0, w // 2, h // 2, COCO_IDS[0], crowd=1)
    with open(os.path.join(path, "annotations",
                           f"instances_{COCO_SPLIT}.json"), "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": [
            {"id": c, "name": f"cat{c}"} for c in COCO_IDS]}, f)
    return path


class WaitTimed:
    """A driver's loader with the consumer's wait in each ``next`` timed
    into ``waits`` (at 0 workers and ``--prefetch 0``: record loading,
    decode, staging and the ``put`` hook, all on fit's thread)."""

    def __init__(self, inner, waits: list):
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_waits", waits)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __setattr__(self, name, value):
        setattr(self._inner, name, value)

    def __iter__(self):
        it = iter(self._inner)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                self._waits.append(time.perf_counter() - t0)
                yield batch
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()


def coco_slice(P, pretrained: str, work: str, seed: int, device=None,
               flags=COCO_FLAGS) -> list:
    """COCO end to end at full width (ResNet-101, 81 classes, the 800×1333
    bucket, bf16 compute) on a set written by :func:`write_coco`, every
    kernel count set to 0 just before each run and read just after:

    * ``python -m mx_rcnn_tpu_torch.train_end2end --dataset coco``'s
      ``train_net`` with ``ASSIGN_FUSED``, ``FLIP``, ``BATCH`` images a
      step, ``COCO_STEPS`` steps, ``--pretrained`` the training slice's
      21-class checkpoint (the class-sized head leaves keep their initial
      values): finite losses, each kernel once a step, the peak of
      ``torch.cuda.max_memory_allocated``, the step walls, fit's wait on
      the loader a step and each image's decode seconds; the record
      with ``COCO_MANY`` boxes loads with ``MAX_GT`` of them;
    * ``python -m mx_rcnn_tpu_torch.test --dataset coco`` on that
      checkpoint, serial, on the host route (a warm-up run first) and with
      ``--device-postprocess``: the 12 COCO stats each, the NMS pair once
      and twice a batch, the routes' records held to each other
      (:func:`match_routes`), the images/s of each; ``COCOEval.evaluate``'s
      host seconds on the host route's results (the same stats), and the
      ground truth written as detections of score 1 scoring AP = AR100 =
      1.0;
    * the server (``serve.driver.build_engine`` with ``--dataset coco``)
      in host-NMS and e2e mode, ``COCO_REQUESTS`` requests each
      (:func:`serve_mode`: the warmup's 2 programs, each reply equal to
      the offline records of its batch row, the NMS pair once / twice a
      batch);
    * ``python -m mx_rcnn_tpu_torch.demo`` on the set's first image at a
      threshold inside a gap of its highest class scores: its detections
      equal the host route's at batch 1 (``im_detect`` → ``per_class_nms`` at that
      threshold, no cap), the NMS pair once;
    * the NMS pair at the device post-process's COCO shape (B·80 rows of
      300, 100 kept; :func:`postprocess_times`) and the assign pair at
      the bucket's 37 800 anchors with G = 100 valid gt
      (:func:`time_assign`), each against its plain version, timed, with
      its bound.

    Returns the kernels' rows at the COCO shapes."""
    tstart = time.perf_counter()
    dev = torch.device(device or "cuda")
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    data = write_coco(work, seed)
    paths = ["--image_set", COCO_SPLIT, "--dataset_path", data,
             "--root_path", os.path.join(work, "coco_cache")]
    on = [] if device is None else ["--device", str(device)]
    counters = {"nms_mask": P.nms_cuda.nms_mask,
                "nms_sweep": P.nms_cuda.nms_sweep,
                "assign_gtmax": P.assign_cuda.assign_gtmax,
                "assign_rows": P.assign_cuda.assign_rows}

    def counted(fn):
        sync()
        for f in counters.values():
            f.launches = 0
        out = fn()
        sync()
        return out, {k: f.launches for k, f in counters.items()}

    # ---- training through the driver ----
    prefix = os.path.join(work, "coco_model", "e2e")
    targs = P.train_end2end.parse_args(flags + paths + on + [
        "--cfg", "tpu__ASSIGN_FUSED=True", "--pretrained", pretrained,
        "--batch_images", str(BATCH), "--num-steps", str(COCO_STEPS),
        "--end_epoch", "1", "--frequent", "1", "--prefix", prefix])
    tcfg = P.config_from_args(targs, train=True)
    stride = max(tcfg.network.IMAGE_STRIDE, tcfg.network.RPN_FEAT_STRIDE)
    bucket = P.image_mod.bucket_shape(tcfg.tpu.SCALES[0], stride)
    if (tcfg.NUM_CLASSES, bucket, tcfg.TRAIN.FLIP) != (81, (800, 1344), True):
        fail(f"coco: {tcfg.NUM_CLASSES} classes, bucket {bucket}, flip "
             f"{tcfg.TRAIN.FLIP}")
    roidb = P.get_imdb(targs, tcfg).gt_roidb()
    many = max(roidb, key=lambda r: len(r["boxes"]))
    sample = P.loader_mod._load_record(many, tcfg, tcfg.tpu.SCALES[0])
    if len(many["boxes"]) != COCO_MANY or \
            int(sample["gt_valid"].sum()) != tcfg.tpu.MAX_GT:
        fail(f"coco: the record of {len(many['boxes'])} boxes loads "
             f"{int(sample['gt_valid'].sum())} gt, MAX_GT "
             f"{tcfg.tpu.MAX_GT}")
    seen, walls, last = [], [], [0.0]
    waits, decodes = [], []

    def on_step(epoch, step, metrics):
        # frequent=1: fit fetches (and so synchronises) after every step
        now = time.perf_counter()
        seen.append(metrics)
        walls.append(now - last[0])
        last[0] = now

    fit, get_image = P.train_end2end.fit, P.loader_mod.get_image

    def fit_timed(cfg, model, params, loader, **k):
        last[0] = time.perf_counter()
        return fit(cfg, model, params, WaitTimed(loader, waits),
                   batch_end_callback=on_step, **k)

    def get_image_timed(*a, **k):
        t0 = time.perf_counter()
        out = get_image(*a, **k)
        decodes.append(time.perf_counter() - t0)
        return out

    base_bytes = torch.cuda.memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    P.train_end2end.fit = fit_timed
    P.loader_mod.get_image = get_image_timed
    try:
        _, train_launches = counted(lambda: P.train_end2end.train_net(targs))
    finally:
        P.train_end2end.fit = fit
        P.loader_mod.get_image = get_image
    peak_bytes = torch.cuda.max_memory_allocated() if on_card else 0
    if len(seen) != COCO_STEPS or len(waits) != COCO_STEPS or \
            len(decodes) != COCO_STEPS * BATCH:
        fail(f"coco train: {len(seen)} steps of {COCO_STEPS}, "
             f"{len(waits)} loader waits, {len(decodes)} images decoded")
    for name, count in train_launches.items():
        if count != COCO_STEPS:
            fail(f"coco train: {name} launched {count} times in "
                 f"{COCO_STEPS} steps")
    if not all(np.isfinite(list(m.values())).all() for m in seen):
        fail(f"coco train: non-finite metrics {seen}")
    trained = P.load_params_npz(P.epoch_path(prefix, 1))
    start = P.load_params_npz(pretrained)
    laid = sorted(k for k in trained if k in start
                  and np.shape(start[k]) == np.shape(trained[k]))
    kept = sorted(k for k in trained if k in start
                  and np.shape(start[k]) != np.shape(trained[k]))
    if not kept or any("cls_score" not in k and "bbox_pred" not in k
                       for k in kept):
        fail(f"coco train: the 21-class leaves kept at init: {kept}")
    log("coco_train", network=tcfg.network.NETWORK,
        classes=tcfg.NUM_CLASSES, bucket=list(bucket),
        dtype=tcfg.tpu.COMPUTE_DTYPE, assign_fused=tcfg.tpu.ASSIGN_FUSED,
        images=len(COCO_SIZES), steps=len(seen),
        launches=train_launches, pretrained_laid_over=len(laid),
        pretrained_kept_init=kept, max_gt=tcfg.tpu.MAX_GT,
        many_boxes=len(many["boxes"]),
        memory_before_bytes=base_bytes, max_memory_allocated_bytes=peak_bytes,
        step_wall_s=walls,
        step_wall_median_s=statistics.median(walls[1:]) if len(walls) > 1
        else None, loader_wait_s=waits, image_decode_s=decodes,
        loader_wait_share=sum(waits) / sum(walls),
        total_loss=[m["total_loss"] for m in seen])
    del trained, start
    if on_card:
        torch.cuda.empty_cache()

    # ---- evaluation through the test driver ----
    eargs = flags + paths + on + ["--prefix", prefix, "--epoch", "1",
                                  "--batch_images", str(BATCH),
                                  "--eval-inflight", "0"]
    modes = {"warm-up": [], "serial": [],
             "serial+devpost": ["--device-postprocess"]}
    n_batches = -(-len(COCO_SIZES) // BATCH)
    stats, boxes, launches = {}, {}, {}
    for mode, extra in modes.items():
        cache = os.path.join(work, f"coco-dets-{mode}.pkl")
        out, launches[mode] = counted(lambda: P.test_driver.test_rcnn(
            P.test_driver.parse_args(eargs + extra + ["--dets_cache",
                                                      cache])))
        want = n_batches * (2 if "devpost" in mode else 1)
        for name in ("nms_mask", "nms_sweep"):
            if launches[mode][name] != want:
                fail(f"coco eval [{mode}]: {name} launched "
                     f"{launches[mode][name]} times in {n_batches} batches, "
                     f"expected {want}")
        keys = tuple(k for k in out if k != "eval_pipeline")
        if keys != COCO_STATS or not all(
                np.isfinite(out[k]) and -1.0 <= out[k] <= 1.0 for k in keys):
            fail(f"coco eval [{mode}]: stats {out}")
        with open(cache, "rb") as f:
            boxes[mode] = pickle.load(f)
        stats[mode] = out
    ecfg = P.config_from_args(P.test_driver.parse_args(eargs), train=False)
    matched = match_routes(boxes["serial"], boxes["serial+devpost"],
                           ecfg.TEST.MAX_PER_IMAGE)
    imdb = P.get_imdb(P.test_driver.parse_args(eargs), ecfg, test=True)
    results = imdb.detections_to_coco(boxes["serial"])
    t0 = time.perf_counter()
    again = P.COCOEval(imdb.ann_file, results).evaluate()
    cocoeval_s = time.perf_counter() - t0
    if again != {k: stats["serial"][k] for k in COCO_STATS}:
        fail("coco eval: COCOEval on the host route's results gives other "
             "stats than the driver")
    with open(imdb.ann_file) as f:
        gt = [a for a in json.load(f)["annotations"] if not a["iscrowd"]]
    perfect = P.COCOEval(imdb.ann_file, [
        {"image_id": a["image_id"], "category_id": a["category_id"],
         "bbox": a["bbox"], "score": 1.0} for a in gt]).evaluate()
    if perfect["AP"] != 1.0 or perfect["AR100"] != 1.0:
        fail(f"coco eval: the ground truth as detections scores {perfect}")
    log("coco_eval", images=len(COCO_SIZES),
        sizes=[list(s) for s in COCO_SIZES], batch=BATCH, launches=launches,
        device_matched=matched, results=len(results),
        detections_per_image={m: [sum(len(b[k][i]) for k in range(1, len(b)))
                                  for i in range(len(COCO_SIZES))]
                              for m, b in boxes.items()},
        stats={m: {k: s[k] for k in COCO_STATS} for m, s in stats.items()},
        imgs_per_sec={m: s["eval_pipeline"]["imgs_per_sec"]
                      for m, s in stats.items()},
        pipeline={m: s["eval_pipeline"] for m, s in stats.items()},
        cocoeval_host_s=cocoeval_s, gt_as_detections=perfect)

    # ---- serving ----
    P.telemetry.configure(work, stream=False)
    sargs = P.serve_driver.parse_args(flags + on + [
        "--prefix", prefix, "--epoch", "1", "--serve-batch", str(BATCH),
        "--max-delay-ms", "10", "--unix-socket", "unused"])
    scfg = P.config_from_args(sargs, train=False)
    rng = np.random.RandomState(seed + 1)
    images = [coco_image(rng, h, w, 3, COCO_IDS)[0]
              for h, w in sorted(set(COCO_SIZES))]
    served = {}
    predictor, engine = P.serve_driver.build_engine(sargs, scfg)
    try:
        served["host_nms"] = serve_mode(P, predictor, engine, scfg,
                                        os.path.join(work, "coco-host.sock"),
                                        images, e2e=False,
                                        requests=COCO_REQUESTS)
    finally:
        engine.stop()
    engine = P.serve.ServeEngine(predictor, scfg, dataclasses.replace(
        engine.opts, serve_e2e=True)).start()
    try:
        served["e2e"] = serve_mode(P, predictor, engine, scfg,
                                   os.path.join(work, "coco-e2e.sock"),
                                   images, e2e=True, requests=COCO_REQUESTS)
    finally:
        engine.stop()
    P.telemetry.shutdown()
    log("coco_serve", classes=scfg.NUM_CLASSES,
        sizes=[list(im.shape[:2]) for im in images], batch=BATCH,
        modes=served)

    # ---- the demo against the host route at batch 1 ----
    path = imdb.image_path(0)
    s, hw, r, info = P.image_mod.stage_raw_to_bucket(
        P.image_mod.get_image(path), scfg.tpu.SCALES[0], stride)
    (scores, dboxes, valid), = P.tester.im_detect(predictor, predictor.batch_put(
        {"images": s[None], "raw_hw": hw[None], "prep_ratio": r[None],
         "im_info": info[None]}))
    # a threshold inside the widest gap between the 200th and the 10th
    # highest distinct class score: some rows above it, many below
    top = np.unique(scores[valid][:, 1:])[-200:-9]
    gap = int(np.argmax(np.diff(top)))
    thresh = float((top[gap] + top[gap + 1]) / 2)
    ref = P.post.per_class_nms(scores, dboxes, valid, scfg.NUM_CLASSES,
                               thresh, scfg.TEST.NMS, 0)
    del predictor, engine
    dets, demo_launches = counted(lambda: P.demo.demo_net(P.demo.parse_args(
        flags + on + ["--prefix", prefix, "--epoch", "1", "--image", path,
                      "--thresh", repr(thresh)])))
    for name, count in demo_launches.items():
        if count != (1 if name.startswith("nms") else 0):
            fail(f"coco demo: {name} launched {count} times")
    got = {k: np.asarray([d for c, d in dets if c == f"class{k}"],
                         np.float32).reshape(-1, 5)
           for k in range(1, scfg.NUM_CLASSES)}
    for k in range(1, scfg.NUM_CLASSES):
        a, b = got[k], ref[k]
        if a.shape != b.shape or (len(a) and (
                np.abs(a[:, 4] - b[:, 4]).max() > 1e-6
                or np.abs(a[:, :4] - b[:, :4]).max() > 1e-3)):
            fail(f"coco demo: class {k} gives {len(a)} detections, the host "
                 f"route {len(b)}, or other values")
    if not dets:
        fail("coco demo: no detection above the threshold")
    log("coco_demo", image=os.path.basename(path), thresh=thresh,
        detections=len(dets), launches=demo_launches, matches_host=True)

    # ---- the kernels at the COCO shapes ----
    if on_card:
        torch.cuda.empty_cache()
    rows = postprocess_times(P, {"cfg": ecfg, "args": eargs,
                                 "launches": launches}, dev,
                             "times_postprocess_coco")
    for k in rows:
        k.update(launches=launches["serial+devpost"][k["name"]],
                 shape=f"coco post-process: {BATCH * 80} rows x "
                       f"{ecfg.TEST.RPN_POST_NMS_TOP_N} -> "
                       f"{ecfg.TEST.MAX_PER_IMAGE}")
    anchors = P.all_anchors(bucket[0] // 16, bucket[1] // 16, 16,
                            P.generate_anchors())
    per = [assign_case(np.random.RandomState(70 + b), anchors, (800, 1333),
                       100, 100, (40.0, 480.0)) for b in range(BATCH)]
    arows = time_assign(P.assign_cuda, torch.from_numpy(anchors).to(dev), *(
        torch.from_numpy(np.stack([p[i] for p in per])).to(dev)
        for i in range(3)))
    for k in arows:
        if k["max_abs_err"] != 0.0:
            fail(f"{k['name']} disagrees with its plain version at "
                 f"N={len(anchors)}, G=100")
        k.update(launches=train_launches[k["name"]],
                 shape=f"coco train: N={len(anchors)}, G=100")
    log("times_assign_coco", shape={"B": BATCH, "anchors": len(anchors),
                                    "gt": 100}, kernels=arows)
    out = rows + arows
    for k in out:
        k.update(route="cuda", source=SOURCES[k["name"]],
                 replaces=REPLACES[k["name"]])
    log("coco_total", seconds=time.perf_counter() - tstart)
    return out


# ---- the FPN / Mask R-CNN slice -----------------------------------------------

def octagon(x: float, y: float, bw: float, bh: float) -> list:
    """A COCO polygon inside the box (x, y, bw, bh): its corners cut at a
    quarter of each side."""
    return [x + bw / 4, y, x + 3 * bw / 4, y, x + bw, y + bh / 4, x + bw,
            y + 3 * bh / 4, x + 3 * bw / 4, y + bh, x + bw / 4, y + bh, x,
            y + 3 * bh / 4, x, y + bh / 4]


def write_coco_masks(P, root: str, seed: int) -> str:
    """:func:`write_coco`'s set under ``root`` with segmentations: each
    non-crowd annotation a polygon (:func:`octagon`), the crowd box a
    compressed crowd RLE of its part inside the image.  Returns the
    dataset path."""
    path = write_coco(root, seed)
    ann_file = os.path.join(path, "annotations", f"instances_{COCO_SPLIT}.json")
    with open(ann_file) as f:
        ann = json.load(f)
    hw = {im["id"]: (im["height"], im["width"]) for im in ann["images"]}
    for a in ann["annotations"]:
        x, y, bw, bh = a["bbox"]
        if a["iscrowd"]:
            h, w = hw[a["image_id"]]
            m = np.zeros((h, w), np.uint8)
            m[int(y):int(y + bh), int(x):int(x + bw)] = 1
            rle = P.mask_rle.encode(m)
            a["segmentation"] = {"size": rle["size"], "counts":
                                 P.mask_rle.counts_to_string(rle["counts"])}
        else:
            a["segmentation"] = [octagon(x, y, bw, bh)]
    with open(ann_file, "w") as f:
        json.dump(ann, f)
    return path


def fpn_slice(P, work: str, seed: int, device=None, flags=FPN_FLAGS) -> list:
    """FPN and Mask R-CNN inference at full width (ResNet-101-FPN Mask
    R-CNN, 81 classes, the 800×1333 bucket padded to 800×1344, TEST 6000 →
    300 with 100 detections an image, ``ROI_SAMPLING_RATIO`` 2, bf16
    compute, seeded random weights) on :func:`write_coco_masks`'s set, the
    NMS counts set to 0 just before each run and read just after:

    * ``python -m mx_rcnn_tpu_torch.test --network resnet101_fpn_mask
      --dataset coco``, serial, on the host route (``MASK_PASTE=
      "native"``; a warm-up run first) and with ``--device-postprocess``
      (the device paste): the box and segm stats, the NMS pair once a
      batch in ``propose_fpn`` and once more on the device route, the
      routes' boxes held to each other (:func:`match_routes`), images/s,
      the mask passes' host seconds an image, peak
      ``max_memory_allocated``; ``COCOEval(iou_type="segm")``'s host
      seconds on the host route's results, and the gt masks as detections
      scoring segm AP = AR100 = 1;
    * on the first batch, the host route's detections through the mask
      pass in each ``MASK_PASTE`` mode (``"host"``, the numpy paste, as
      the oracle): every mask within ``MASK_FLIP_BOUND`` pixels of the
      oracle's, each mode's host seconds an image;
    * ``propose_fpn`` on that batch's RPN outputs in float32 (TF32 off):
      the kernels' kept rows equal ``nms_padded``'s, and ``propose_fpn``
      on the kernels equal to it on the plain NMS; on the bf16 main path's
      joint candidates (B · 5 619) the NMS pair against its plain versions,
      timed, with its bound;
    * the serve driver refuses the FPN network by name.

    Returns the NMS pair's rows at the joint proposal's shape."""
    tstart = time.perf_counter()
    dev = torch.device(device or "cuda")
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    data = write_coco_masks(P, os.path.join(work, "fpn"), seed)
    paths = ["--image_set", COCO_SPLIT, "--dataset_path", data,
             "--root_path", os.path.join(work, "fpn_cache")]
    on = [] if device is None else ["--device", str(device)]
    counters = {"nms_mask": P.nms_cuda.nms_mask,
                "nms_sweep": P.nms_cuda.nms_sweep}

    def counted(fn):
        sync()
        for f in counters.values():
            f.launches = 0
        out = fn()
        sync()
        return out, {k: f.launches for k, f in counters.items()}

    prefix = os.path.join(work, "fpn_model", "mask")
    eargs = flags + paths + on + ["--prefix", prefix, "--epoch", "1",
                                  "--batch_images", str(BATCH),
                                  "--eval-inflight", "0"]
    targs = P.test_driver.parse_args(eargs)
    cfg = P.config_from_args(targs, train=False)
    te, net = cfg.TEST, cfg.network
    stride = max(net.IMAGE_STRIDE, net.RPN_FEAT_STRIDE)
    bucket = P.image_mod.bucket_shape(cfg.tpu.SCALES[0], stride)
    got = (cfg.NUM_CLASSES, bucket, net.HAS_FPN, net.HAS_MASK,
           cfg.tpu.ROI_SAMPLING_RATIO, te.RPN_PRE_NMS_TOP_N,
           te.RPN_POST_NMS_TOP_N, te.MAX_PER_IMAGE, te.MASK_PASTE)
    if got != (81, (800, 1344), True, True, 2, 6000, 300, 100, "native"):
        fail(f"fpn: config {got}")
    t0 = time.perf_counter()
    model = P.build_model(cfg)
    params = P.random_params(model, seed=seed)
    P.save_params_npz(P.epoch_path(prefix, 1), params)
    n_params = int(sum(v.size for v in params.values()))
    del model, params
    weights_s = time.perf_counter() - t0

    try:
        P.serve_driver.build_engine(P.serve_driver.parse_args(
            flags + on + ["--prefix", prefix, "--epoch", "1",
                          "--unix-socket", "unused"]), cfg)
        fail("fpn: the serve driver built an engine for an FPN network")
    except NotImplementedError as e:
        if "serving of an FPN network" not in str(e):
            fail(f"fpn: the serve driver refused with {e}")

    # ---- evaluation through the test driver ----
    seen = []
    evaluate_sds = P.COCODataset.evaluate_sds

    def record(self, detections, masks):
        seen.append((detections, masks))
        return evaluate_sds(self, detections, masks)

    modes = {"warm-up": [], "serial": [],
             "serial+devpost": ["--device-postprocess"]}
    n_batches = -(-len(COCO_SIZES) // BATCH)
    stats, boxes, masks, launches, peaks = {}, {}, {}, {}, {}
    P.COCODataset.evaluate_sds = record
    try:
        for mode, extra in modes.items():
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            out, launches[mode] = counted(lambda: P.test_driver.test_rcnn(
                P.test_driver.parse_args(eargs + extra)))
            peaks[mode] = torch.cuda.max_memory_allocated() if on_card else 0
            want = n_batches * (2 if "devpost" in mode else 1)
            for name in counters:
                if launches[mode][name] != want:
                    fail(f"fpn eval [{mode}]: {name} launched "
                         f"{launches[mode][name]} times in {n_batches} "
                         f"batches, expected {want}")
            for kind in ("bbox", "segm"):
                s_ = out.get(kind, {})
                if tuple(s_) != COCO_STATS or not all(
                        np.isfinite(v) and -1.0 <= v <= 1.0
                        for v in s_.values()):
                    fail(f"fpn eval [{mode}]: {kind} stats {s_}")
            stats[mode] = out
            boxes[mode], masks[mode] = seen.pop()
    finally:
        P.COCODataset.evaluate_sds = evaluate_sds
    matched = match_routes(boxes["serial"], boxes["serial+devpost"],
                           te.MAX_PER_IMAGE)
    n_masks = {m: sum(len(r) for row in mk[1:] for r in row if r)
               for m, mk in masks.items()}
    if n_masks["serial"] != sum(len(b) for row in boxes["serial"][1:]
                                for b in row if b is not None):
        fail("fpn eval: the host route's masks and boxes differ in count")
    imdb = P.get_imdb(targs, cfg, test=True)
    results = imdb.segmentations_to_coco(boxes["serial"], masks["serial"])
    t0 = time.perf_counter()
    again = P.COCOEval(imdb.ann_file, results, iou_type="segm").evaluate()
    cocoeval_segm_s = time.perf_counter() - t0
    if again != stats["serial"]["segm"]:
        fail("fpn eval: COCOEval segm on the host route's results gives other "
             "stats than the driver")
    with open(imdb.ann_file) as f:
        gt = [a for a in json.load(f)["annotations"] if not a["iscrowd"]]
    perfect = P.COCOEval(imdb.ann_file, [
        {"image_id": a["image_id"], "category_id": a["category_id"],
         "segmentation": a["segmentation"], "score": 1.0} for a in gt],
        iou_type="segm").evaluate()
    if perfect["AP"] != 1.0 or perfect["AR100"] != 1.0:
        fail(f"fpn eval: the gt masks as detections score {perfect}")
    pipe = {m: s_["eval_pipeline"] for m, s_ in stats.items()}
    log("fpn_eval", network=net.NETWORK, fpn=True, mask=True,
        classes=cfg.NUM_CLASSES, bucket=list(bucket),
        dtype=cfg.tpu.COMPUTE_DTYPE, parameters=n_params,
        weights_s=weights_s, images=len(COCO_SIZES), batch=BATCH,
        launches=launches,
        launches_per_batch={m: {k: v / n_batches for k, v in c.items()}
                            for m, c in launches.items()},
        device_matched=matched, masks=n_masks,
        stats={m: {k: s_[k] for k in ("bbox", "segm")}
               for m, s_ in stats.items()},
        imgs_per_sec={m: p["imgs_per_sec"] for m, p in pipe.items()},
        mask_pass_s_per_image={m: p["mask_pass_s"] / p["images"]
                               for m, p in pipe.items()},
        mask_paste={m: ("device" if "devpost" in m else "native")
                    for m in pipe},
        max_memory_allocated_bytes=peaks, pipeline=pipe,
        cocoeval_segm_host_s=cocoeval_segm_s, segm_results=len(results),
        gt_masks_as_detections=perfect)

    # ---- the paste modes on one batch, the host numpy paste the oracle ----
    predictor = P.tester.Predictor(P.build_model(cfg),
                                   P.load_eval_params(targs), cfg, device=dev)
    roidb = imdb.gt_roidb()
    loader = P.TestLoader(roidb, cfg, batch_size=BATCH)
    loader.put = predictor.batch_put
    batch = next(iter(loader))
    dets = P.tester.im_detect(predictor, batch)
    token = predictor.feats_token
    k_all = cfg.NUM_CLASSES
    all_boxes = [[None] * len(roidb) for _ in range(k_all)]
    for b, (scores, dboxes, valid) in enumerate(dets):
        pc = P.post.per_class_nms(scores, dboxes, valid, k_all, 1e-3,
                                  te.NMS, te.MAX_PER_IMAGE)
        for k in range(1, k_all):
            all_boxes[k][int(batch["indices"][b])] = pc[k]
    paste_s, pasted = {}, {}
    for mode in ("device", "device", "native", "host"):   # device warmed
        predictor.cfg = cfg.replace(TEST=dataclasses.replace(
            te, MASK_PASTE=mode))
        out = [[None] * len(roidb) for _ in range(k_all)]
        sync()
        t0 = time.perf_counter()
        P.tester._mask_pass(predictor, batch, dets, all_boxes, out, roidb,
                            te.MAX_PER_IMAGE, k_all, token=token)
        sync()
        paste_s[mode] = (time.perf_counter() - t0) / len(dets)
        pasted[mode] = out
    predictor.cfg = cfg
    worst = {"device": 0, "native": 0}
    n_cmp = 0
    for k in range(1, k_all):
        for i in range(len(roidb)):
            for di, ref in enumerate(pasted["host"][k][i] or []):
                oracle = P.mask_rle.decode(ref)
                for mode in worst:
                    d = int(np.sum(P.mask_rle.decode(
                        pasted[mode][k][i][di]) != oracle))
                    worst[mode] = max(worst[mode], d)
                n_cmp += 1
    if not n_cmp or max(worst.values()) > MASK_FLIP_BOUND:
        fail(f"fpn paste modes: {n_cmp} masks, most pixels apart {worst}")
    log("fpn_paste_modes", images=len(dets), masks=n_cmp,
        max_pixels_from_host=worst, host_s_per_image=paste_s,
        bound=MASK_FLIP_BOUND)

    # ---- propose_fpn's joint NMS: kernels against the plain NMS ----
    def joint(pred):
        m = pred.model
        with torch.inference_mode():
            feats = m._pyramid(batch["images"])
            levels = m._rpn_over_levels(feats)
            info = torch.as_tensor(batch["im_info"], device=dev)
            return ([P.fg_prob(c) for c, _, _ in levels],
                    [b_ for _, b_, _ in levels], [a for _, _, a in levels],
                    info)

    cand_kw = dict(pre_nms_top_n=te.RPN_PRE_NMS_TOP_N,
                   min_size=te.RPN_MIN_SIZE)
    main = joint(predictor)
    main_boxes, _, main_valid = P.fpn_candidates(*main, **cand_kw)
    level_sizes = [int(s_.shape[1]) for s_ in main[0]]
    del main, predictor
    cfg32 = cfg.replace(tpu=dataclasses.replace(cfg.tpu,
                                                COMPUTE_DTYPE="float32"))
    pred32 = P.tester.Predictor(P.build_model(cfg32),
                                P.load_eval_params(targs), cfg32, device=dev)
    if on_card and (torch.backends.cudnn.allow_tf32
                    or torch.backends.cuda.matmul.allow_tf32):
        fail("fpn: the float32 Predictor left TF32 on")
    rpn32 = joint(pred32)
    b32, s32, v32 = P.fpn_candidates(*rpn32, **cand_kw)
    ki, km = P.nms_cuda.nms_bitmask(b32, v32, te.RPN_POST_NMS_TOP_N,
                                    te.RPN_NMS_THRESH)
    for b in range(b32.shape[0]):
        ri, rm = P.nms_padded(b32[b], s32[b], te.RPN_POST_NMS_TOP_N,
                              te.RPN_NMS_THRESH, valid=v32[b])
        if not torch.equal(ki[b][km[b]], ri[rm]):
            fail(f"fpn float32 propose: kernel and plain NMS keep different "
                 f"rows in image {b}")
    prop_kw = dict(pre_nms_top_n=te.RPN_PRE_NMS_TOP_N,
                   post_nms_top_n=te.RPN_POST_NMS_TOP_N,
                   nms_thresh=te.RPN_NMS_THRESH, min_size=te.RPN_MIN_SIZE)
    with torch.inference_mode():
        k_out = P.propose_fpn(*rpn32, use_kernel=True, **prop_kw)
        p_out = P.propose_fpn(*rpn32, use_kernel=False, **prop_kw)
    if not all(torch.equal(x, y) for x, y in zip(k_out, p_out)):
        fail("fpn float32 propose_fpn: kernel and plain paths differ")
    del pred32, rpn32
    if on_card:
        torch.cuda.empty_cache()
    n = int(main_boxes.shape[1])
    rows = time_kernels(P.nms_cuda, main_boxes, main_valid,
                        te.RPN_POST_NMS_TOP_N, te.RPN_NMS_THRESH)
    for k in rows:
        if k["max_abs_err"] != 0.0:
            fail(f"{k['name']} disagrees with its plain version at the joint "
                 f"proposal shape (max abs err {k['max_abs_err']})")
        k.update(launches=launches["serial"][k["name"]], route="cuda",
                 source=SOURCES[k["name"]], replaces=REPLACES[k["name"]],
                 shape=f"fpn joint proposal: B={BATCH}, n={n} -> "
                       f"{te.RPN_POST_NMS_TOP_N}")
    log("times_fpn_proposal", shape={"B": BATCH, "n": n,
                                     "levels": level_sizes,
                                     "max_out": te.RPN_POST_NMS_TOP_N},
        kept_float32=[int(x) for x in km.sum(1)], identical=True,
        candidates=int(main_valid.sum()), kernels=rows)
    log("fpn_total", seconds=time.perf_counter() - tstart)
    return rows


def add_rle_annotation(P, path: str) -> dict:
    """One more non-crowd annotation in the image with the fewest, its
    segmentation a compressed RLE dict (a disc), so that training runs the
    rasteriser's RLE branch (crop and nearest resize).  Returns it."""
    ann_file = os.path.join(path, "annotations", f"instances_{COCO_SPLIT}.json")
    with open(ann_file) as f:
        ann = json.load(f)
    count = {im["id"]: 0 for im in ann["images"]}
    for a in ann["annotations"]:
        count[a["image_id"]] += 1
    im = next(i for i in ann["images"] if count[i["id"]] == min(count.values()))
    h, w = im["height"], im["width"]
    yy, xx = np.mgrid[:h, :w]
    m = (((yy - 0.5 * h) ** 2 + (xx - 0.4 * w) ** 2)
         <= (0.2 * min(h, w)) ** 2).astype(np.uint8)
    ys, xs = np.nonzero(m)
    rle = P.mask_rle.encode(m)
    new = {"id": max(a["id"] for a in ann["annotations"]) + 1,
           "image_id": im["id"], "category_id": COCO_IDS[7],
           "bbox": [float(xs.min()), float(ys.min()),
                    float(xs.max() - xs.min() + 1),
                    float(ys.max() - ys.min() + 1)],
           "area": float(m.sum()), "iscrowd": 0,
           "segmentation": {"size": rle["size"], "counts":
                            P.mask_rle.counts_to_string(rle["counts"])}}
    ann["annotations"].append(new)
    with open(ann_file, "w") as f:
        json.dump(ann, f)
    return new


def _detached(x):
    """Tensors (alone or in lists) detached and copied; the rest as is."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_detached(v) for v in x)
    return x


def fpn_train_slice(P, work: str, seed: int, device=None,
                    flags=FPN_TRAIN_FLAGS) -> list:
    """FPN and Mask R-CNN training at full width (ResNet-101 with C2–C5, a
    256-channel neck, 81 classes, the 800×1333 bucket padded to 800×1344,
    TRAIN 12000 → 2000, ``RPN_BATCH_SIZE`` 256, ``BATCH_ROIS`` 128,
    ``MAX_GT`` 100, ``MASK_SIZE`` 28, ``ROI_SAMPLING_RATIO`` 2, bf16 compute
    on float32 parameters, ``ASSIGN_FUSED``, ``FLIP``, seeded random
    weights) on :func:`write_coco_masks`'s set with one more non-crowd
    annotation as an RLE dict (:func:`add_rle_annotation`), every kernel
    count set to 0 just before each run and read just after:

    * ``python -m mx_rcnn_tpu_torch.train_end2end --network
      resnet101_fpn_mask --dataset coco``'s ``train_net``, ``BATCH`` images a
      step, ``FPN_TRAIN_STEPS`` steps: every loss and ``MaskLoss`` finite,
      each kernel once a step, the ``mask_head``, ``neck`` and ``rpn``
      leaves moved and the ``FIXED_PARAMS`` leaves bitwise unchanged, the
      step walls, fit's wait on the loader, the peak of
      ``max_memory_allocated`` and the bytes of a batch's ``gt_masks``;
      the checkpoint evaluated by ``python -m mx_rcnn_tpu_torch.test``
      (serial, host route): box and segm stats;
    * on the first step's own inputs: the assign pair over the 268 569
      concatenated P2–P6 anchors bitwise against the dense path, and at G
      = 100 valid gt; ``propose_fpn``'s joint candidates (B · 10 419) through
      the NMS pair, the kept rows equal to ``nms_padded``'s; each pair
      timed, with its bound; the step's ``mask_targets_for_rois`` on the
      card against the same call on CPU copies, equal but at pixels whose
      float64 sample lies within ``MASK_TARGET_BAND`` of 0.5;
    * ``python -m mx_rcnn_tpu_torch.train_alternate --network resnet101_fpn
      --dataset coco``, ``FPN_ALT_STEPS`` steps a stage: each stage's wall
      and kernel launches (the assign pair once a step in stages 1 and 4,
      the NMS pair once a record in stages 2 and 5, nothing in 3 and 6),
      the combined model's neck and backbone stage 4's and its head stage
      6's, evaluated by ``test`` (box stats); ``train_alternate --network
      resnet101_fpn_mask`` raising the JAX package's message before any
      stage.

    Returns the kernels' rows at the training shapes."""
    tstart = time.perf_counter()
    dev = torch.device(device or "cuda")
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    data = write_coco_masks(P, os.path.join(work, "fpn_train"), seed)
    rle_ann = add_rle_annotation(P, data)
    paths = ["--image_set", COCO_SPLIT, "--dataset_path", data,
             "--root_path", os.path.join(work, "fpn_train_cache")]
    on = [] if device is None else ["--device", str(device)]
    counters = {"nms_mask": P.nms_cuda.nms_mask,
                "nms_sweep": P.nms_cuda.nms_sweep,
                "assign_gtmax": P.assign_cuda.assign_gtmax,
                "assign_rows": P.assign_cuda.assign_rows}

    def counted(fn):
        sync()
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, {k: f.launches for k, f in counters.items()}, \
            time.perf_counter() - t0

    # ---- end-to-end training through the driver ----
    prefix = os.path.join(work, "fpn_train_model", "mask")
    targs = P.train_end2end.parse_args(
        ["--network", "resnet101_fpn_mask"] + flags + paths + on + [
            "--batch_images", str(BATCH), "--num-steps", str(FPN_TRAIN_STEPS),
            "--end_epoch", "1", "--frequent", "1", "--prefix", prefix,
            "--seed", str(seed)])
    tcfg = P.config_from_args(targs, train=True)
    tr, net, tpu = tcfg.TRAIN, tcfg.network, tcfg.tpu
    stride = max(net.IMAGE_STRIDE, net.RPN_FEAT_STRIDE)
    bucket = P.image_mod.bucket_shape(tpu.SCALES[0], stride)
    got = (net.NETWORK, tcfg.NUM_CLASSES, bucket, net.HAS_FPN, net.HAS_MASK,
           net.FPN_OUT_CHANNELS, tr.RPN_PRE_NMS_TOP_N, tr.RPN_POST_NMS_TOP_N,
           tr.RPN_BATCH_SIZE, tr.BATCH_ROIS, tpu.MAX_GT, tr.MASK_SIZE,
           tpu.ROI_SAMPLING_RATIO, tpu.COMPUTE_DTYPE, tpu.ASSIGN_FUSED,
           tr.FLIP)
    if got != ("resnet101", 81, (800, 1344), True, True, 256, 12000, 2000,
               256, 128, 100, 28, 2, "bfloat16", True, True):
        fail(f"fpn train: config {got}")
    roidb = P.get_imdb(targs, tcfg).gt_roidb()
    rle_rec = [(r, j) for r in roidb for j, s_ in enumerate(
        r["segmentation"][:tpu.MAX_GT]) if isinstance(s_, dict)]
    if len(rle_rec) != 1:
        fail(f"fpn train: {len(rle_rec)} non-crowd RLE segmentations")
    rec, j = rle_rec[0]
    crop = P.mask_mod.rasterize_gt_masks(rec["segmentation"], rec["boxes"],
                                         rec["width"], False, tpu.MAX_GT)[j]
    if not 0 < int(crop.sum()) < crop.size:
        fail(f"fpn train: the RLE annotation rasterises to {int(crop.sum())} "
             f"of {crop.size} pixels")

    captured, seen, walls, waits, masks_seen, states = {}, [], [], [], [], []
    last = [0.0]

    def capture(name, fn):
        def wrapped(*a, **k):
            if name not in captured:
                captured[name] = (_detached(a), k)
            return fn(*a, **k)
        return wrapped

    def on_step(epoch, step, metrics):
        now = time.perf_counter()  # frequent=1: fit has synchronised
        seen.append(metrics)
        walls.append(now - last[0])
        last[0] = now

    fit, batch_put = P.train_end2end.fit, P.trainer.batch_put

    def fit_timed(cfg, model, params, loader, **k):
        states.append({k_: np.array(v) for k_, v in params.items()})
        last[0] = time.perf_counter()
        st = fit(cfg, model, params, WaitTimed(loader, waits),
                 batch_end_callback=on_step, **k)
        states.append(st)
        return st

    def batch_put_seen(batch, cfg, device_):
        out = batch_put(batch, cfg, device_)
        masks_seen.append((str(out["gt_masks"].dtype), tuple(
            out["gt_masks"].shape), out["gt_masks"].numel()
            * out["gt_masks"].element_size(), out["gt_masks"].device.type))
        return out

    patched = ((P.train_end2end, "fit", fit_timed),
               (P.trainer, "batch_put", batch_put_seen),
               (P.fpn_mod, "assign_targets",
                capture("assign", P.fpn_mod.assign_targets)),
               (P.fpn_mod, "propose_fpn",
                capture("propose", P.fpn_mod.propose_fpn)),
               (P.fpn_mod, "mask_targets_for_rois",
                capture("mask_targets", P.fpn_mod.mask_targets_for_rois)))
    saved = [(m, n, getattr(m, n)) for m, n, _ in patched]
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for m, n, f in patched:
        setattr(m, n, f)
    try:
        _, train_launches, train_s = counted(
            lambda: P.train_end2end.train_net(targs))
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    peak_bytes = torch.cuda.max_memory_allocated() if on_card else 0
    before, st = states
    if len(seen) != FPN_TRAIN_STEPS or st.step != FPN_TRAIN_STEPS:
        fail(f"fpn train: {len(seen)} steps of {FPN_TRAIN_STEPS}")
    for name, count in train_launches.items():
        if count != FPN_TRAIN_STEPS:
            fail(f"fpn train: {name} launched {count} times in "
                 f"{FPN_TRAIN_STEPS} steps")
    keys = ("RPNLogLoss", "RPNL1Loss", "RCNNLogLoss", "RCNNL1Loss", "MaskLoss")
    if not all(k in m and np.isfinite(m[k]) for m in seen for k in keys):
        fail(f"fpn train: metrics {seen}")
    if not all(m["MaskLoss"] > 0 for m in seen):
        fail(f"fpn train: a zero mask loss {[m['MaskLoss'] for m in seen]}")
    if {d[0] for d in masks_seen} != {"torch.uint8"} or \
            {d[1] for d in masks_seen} != {(BATCH, tpu.MAX_GT, 112, 112)} or \
            {d[3] for d in masks_seen} != {dev.type}:
        fail(f"fpn train: gt_masks on the device {masks_seen}")
    after = P.export_jax_params(st.model)
    n_frozen, n_moved = _moved_and_frozen(before, after, st.mask, "fpn train")
    # every trainable leaf that was not 0 moved (decay alone moves it);
    # a bias that moved from 0 took a gradient: one at least in each group
    for group in ("mask_head/", "neck/", "rpn/"):
        if not any(k.startswith(group) and k.endswith("/bias")
                   and not np.array_equal(after[k], before[k])
                   for k in after):
            fail(f"fpn train: no {group} bias took a gradient")
    del after, before
    log("fpn_train", network=net.NETWORK, fpn=True, mask=True,
        classes=tcfg.NUM_CLASSES, bucket=list(bucket), dtype=tpu.COMPUTE_DTYPE,
        images=len(COCO_SIZES), records=len(roidb) * 2, batch=BATCH,
        steps=len(seen), train_wall_s=train_s, launches=train_launches,
        launches_per_step={k: v / FPN_TRAIN_STEPS
                           for k, v in train_launches.items()},
        frozen_leaves=n_frozen, moved_leaves=n_moved,
        max_memory_allocated_bytes=peak_bytes,
        gt_masks={"dtype": masks_seen[0][0], "shape": list(masks_seen[0][1]),
                  "bytes_per_batch": masks_seen[0][2]},
        rle_annotation=rle_ann["id"], rle_crop_pixels=int(crop.sum()),
        step_wall_s=walls,
        step_wall_median_s=statistics.median(walls[1:]),
        loader_wait_s=waits, loader_wait_share=sum(waits) / sum(walls),
        metrics=seen)
    del st
    states.clear()
    if on_card:
        torch.cuda.empty_cache()

    # ---- the checkpoint through the test driver ----
    eargs = P.test_driver.parse_args(
        ["--network", "resnet101_fpn_mask"] + flags + paths + on + [
            "--prefix", prefix, "--epoch", "1", "--batch_images", str(BATCH),
            "--eval-inflight", "0"])
    out, eval_launches, eval_s = counted(lambda: P.test_driver.test_rcnn(eargs))
    for kind in ("bbox", "segm"):
        s_ = out.get(kind, {})
        if tuple(s_) != COCO_STATS or not all(
                np.isfinite(v) and -1.0 <= v <= 1.0 for v in s_.values()):
            fail(f"fpn train eval: {kind} stats {s_}")
    log("fpn_train_eval", seconds=eval_s, launches=eval_launches,
        stats={k: out[k] for k in ("bbox", "segm")})

    # ---- the kernels on the first step's own inputs ----
    _, anchors, gt_boxes, gt_valid, im_info = captured["assign"][0][:5]
    rows = fpn_train_kernels(P, tcfg, dev, anchors, gt_boxes, gt_valid,
                             im_info, captured["propose"][0],
                             captured["mask_targets"], train_launches)
    del captured

    # ---- alternate training of the box network ----
    fpn_alternate(P, flags, paths, on, work, seed, sync)
    log("fpn_train_total", seconds=time.perf_counter() - tstart)
    return rows


def fpn_train_kernels(P, tcfg, dev, anchors, gt_boxes, gt_valid, im_info,
                      propose_args, mask_args, launches) -> list:
    """The assign and NMS pairs on one training step's own inputs, each
    against its plain version, timed, with its bound; the assign pair also
    at G = 100 valid gt; the step's mask targets on the card against the
    CPU.  Returns the pairs' rows at the step's shapes."""
    tr = tcfg.TRAIN
    n = int(anchors.shape[0])
    if n != FPN_TRAIN_ANCHORS:
        fail(f"fpn train: {n} concatenated anchors, expected "
             f"{FPN_TRAIN_ANCHORS}")
    ab = tr.RPN_ALLOWED_BORDER
    im_h, im_w = im_info[:, 0:1], im_info[:, 1:2]
    inside = ((anchors[None, :, 0] >= -ab) & (anchors[None, :, 1] >= -ab)
              & (anchors[None, :, 2] < im_w + ab)
              & (anchors[None, :, 3] < im_h + ab))
    rows = time_assign(P.assign_cuda, anchors, gt_boxes, gt_valid, inside)
    g = int(gt_boxes.shape[1])
    for k in rows:
        k["shape"] = (f"fpn train: N={n}, G={g}, the batch's gt "
                      f"({[int(x) for x in gt_valid.sum(1)]} valid)")
    an = anchors.cpu().numpy()
    hw = [int(x) for x in im_info[0, :2].tolist()]
    per = [assign_case(np.random.RandomState(70 + b), an, hw, 100, 100,
                       (40.0, 360.0)) for b in range(int(gt_boxes.shape[0]))]
    g100 = time_assign(P.assign_cuda, anchors, *(
        torch.from_numpy(np.stack([p[i] for p in per])).to(dev)
        for i in range(3)))
    log("times_fpn_assign", shape={"B": int(gt_boxes.shape[0]), "anchors": n,
                                   "gt": g}, kernels=rows,
        g100={"gt": 100, "kernels": g100})

    # the joint proposal of the step: its candidates, the kept rows
    scores, deltas, level_anchors, info = propose_args[:4]
    boxes, sc, valid = P.fpn_candidates(
        scores, deltas, level_anchors, info,
        pre_nms_top_n=tr.RPN_PRE_NMS_TOP_N, min_size=tr.RPN_MIN_SIZE)
    b, m = int(boxes.shape[0]), int(boxes.shape[1])
    if boxes.dtype != torch.float32 or m != FPN_TRAIN_CANDIDATES:
        fail(f"fpn train: joint candidates {boxes.dtype} {m}, expected "
             f"float32 {FPN_TRAIN_CANDIDATES}")
    ki, km = P.nms_cuda.nms_bitmask(boxes, valid, tr.RPN_POST_NMS_TOP_N,
                                    tr.RPN_NMS_THRESH)
    for i in range(b):
        ri, rm = P.nms_padded(boxes[i], sc[i], tr.RPN_POST_NMS_TOP_N,
                              tr.RPN_NMS_THRESH, valid=valid[i])
        if not torch.equal(ki[i][km[i]], ri[rm]):
            fail(f"fpn train propose: kernel and plain NMS keep different "
                 f"rows in image {i}")
    nms_rows = time_kernels(P.nms_cuda, boxes, valid, tr.RPN_POST_NMS_TOP_N,
                            tr.RPN_NMS_THRESH)
    for k in nms_rows:
        k["shape"] = (f"fpn train proposal: B={b}, n={m} -> "
                      f"{tr.RPN_POST_NMS_TOP_N}")
    log("times_fpn_train_proposal", shape={"B": b, "n": m, "max_out":
                                           tr.RPN_POST_NMS_TOP_N},
        levels=[int(s_.shape[1]) for s_ in scores],
        kept=[int(x) for x in km.sum(1)], candidates=int(valid.sum()),
        identical=True, kernels=nms_rows)
    rows += nms_rows
    for k in rows:
        if k["max_abs_err"] != 0.0:
            fail(f"{k['name']} disagrees with its plain version on the FPN "
                 f"training step's inputs (max abs err {k['max_abs_err']})")
        k.update(route="cuda", source=SOURCES[k["name"]],
                 replaces=REPLACES[k["name"]], launches=launches[k["name"]])

    # the step's mask targets: the card against CPU copies
    (gm, gtb, rois, gi), kw = mask_args
    card = P.mask_target.mask_targets_for_rois(gm, gtb, rois, gi, **kw)
    cpu_args = [x.cpu() for x in (gm, gtb, rois, gi)]
    host = P.mask_target.mask_targets_for_rois(*cpu_args, **kw)
    out = kw["out_size"]
    my, mx = P.mask_target._frame_coords(cpu_args[1], cpu_args[2],
                                         cpu_args[3], gm.shape[-1], out)
    r = rois.shape[0] * rois.shape[1]
    sel = cpu_args[3].reshape(-1) + torch.arange(
        rois.shape[0]).repeat_interleave(rois.shape[1]) * gm.shape[1]
    v64 = P.mask_target._sample_gather(
        cpu_args[0].reshape((-1,) + tuple(gm.shape[2:]))[sel].double(),
        my.reshape(r, out).double(), mx.reshape(r, out).double(), out,
        gm.shape[-1]).reshape(host.shape)
    off = card.cpu() != host
    outside = off & ((v64 - 0.5).abs() > MASK_TARGET_BAND)
    if outside.any():
        fail(f"fpn train: {int(outside.sum())} mask target pixels differ "
             f"between the card and the CPU outside the 0.5 band")
    log("fpn_mask_targets", rois=r, out_size=out, gt_side=int(gm.shape[-1]),
        gt_dtype=str(gm.dtype), fg_pixels=int(host.sum()),
        differ_in_band=int(off.sum()), band=MASK_TARGET_BAND)
    return rows


def run_alternate(P, argv: list, sync, steps: int, what: str):
    """``train_alternate.alternate_train`` on ``argv``, its stage
    functions wrapped to set the kernel counts to 0 just before each stage
    and read them just after, to time it (model build included) and to
    keep its weights.  Fails unless the stages run in order with ``steps``
    steps each training stage, the assign pair once a step in stages 1 and
    4, the NMS pair once a record in stages 2 and 5, and nothing in 3 and
    6.  Returns ``(stages, final, wall_s)``: one dict a stage (``graph``,
    ``wall_s``, ``launches``, and ``records`` or ``steps`` and
    ``params``) and the combined parameters."""
    counters = {"nms_mask": P.nms_cuda.nms_mask,
                "nms_sweep": P.nms_cuda.nms_sweep,
                "assign_gtmax": P.assign_cuda.assign_gtmax,
                "assign_rows": P.assign_cuda.assign_rows}
    stages = []

    def wrap(stage, graph):
        def wrapped(*a, **kw):
            sync()
            for f in counters.values():
                f.launches = 0
            t0 = time.perf_counter()
            out = stage(*a, **kw)
            sync()
            row = {"graph": graph, "wall_s": time.perf_counter() - t0,
                   "launches": {k: f.launches for k, f in counters.items()}}
            if graph == "proposals":
                row["records"] = len(out)
            else:
                row.update(steps=out.step, params=P.export_jax_params(
                    out.model))
            stages.append(row)
            return out
        return wrapped

    ta = P.train_alternate
    saved = [(n, getattr(ta, n)) for n in ("train_rpn", "test_rpn",
                                           "train_rcnn")]
    for n, f in saved:
        setattr(ta, n, wrap(f, {"train_rpn": "rpn", "test_rpn": "proposals",
                                "train_rcnn": "rcnn"}[n]))
    t0 = time.perf_counter()
    try:
        final = ta.alternate_train(ta.parse_args(argv))
    finally:
        for n, f in saved:
            setattr(ta, n, f)
    wall = time.perf_counter() - t0
    if [s_["graph"] for s_ in stages] != ["rpn", "proposals", "rcnn", "rpn",
                                          "proposals", "rcnn"]:
        fail(f"{what}: stages {[s_['graph'] for s_ in stages]}")
    for i, s_ in enumerate(stages):
        la = s_["launches"]
        want_assign = steps if s_["graph"] == "rpn" else 0
        want_nms = s_.get("records", 0)
        if (la["assign_gtmax"], la["assign_rows"], la["nms_mask"],
                la["nms_sweep"]) != (want_assign,) * 2 + (want_nms,) * 2:
            fail(f"{what} stage {i + 1} ({s_['graph']}): launches {la}")
        if s_["graph"] != "proposals" and s_["steps"] != steps:
            fail(f"{what} stage {i + 1}: {s_['steps']} steps")
    return stages, final, wall


def fpn_alternate(P, flags: list, paths: list, on: list, work: str,
                  seed: int, sync) -> None:
    """``train_alternate --network resnet101_fpn`` (see
    :func:`fpn_train_slice`) through :func:`run_alternate`; the combined
    model by group and through ``test``; the mask network refused."""
    ta = P.train_alternate
    prefix = os.path.join(work, "fpn_alt_model", "alt")
    common = flags + paths + on
    stages, final, alt_s = run_alternate(
        P, ["--network", "resnet101_fpn"] + common + [
            "--num-steps", str(FPN_ALT_STEPS), "--end_epoch", "1",
            "--batch_images", str(BATCH), "--prefix", prefix,
            "--seed", str(seed)], sync, FPN_ALT_STEPS, "fpn alternate")
    s4, s6 = stages[3]["params"], stages[5]["params"]
    neck = [k for k in final if k.startswith("neck/")]
    if not neck or any(k.startswith("mask_head/") for k in final):
        fail(f"fpn alternate: combined groups "
             f"{sorted({k.split('/')[0] for k in final})}")
    for k, v in final.items():
        src = s6 if k.split("/")[0] in ("head_body", "rcnn_out") else s4
        if not np.array_equal(v, src[k]):
            fail(f"fpn alternate: combined {k} is not its stage's")
    for k in neck:  # stage 6 froze the neck (FIXED_PARAMS_SHARED)
        if not np.array_equal(s6[k], s4[k]):
            fail(f"fpn alternate: stage 6 moved the frozen {k}")
    stages_log = [{k: v for k, v in s_.items() if k != "params"}
                  for s_ in stages]
    stages.clear()
    del s4, s6, final
    eargs = P.test_driver.parse_args(
        ["--network", "resnet101_fpn"] + common + [
            "--prefix", prefix, "--epoch", "1", "--batch_images", str(BATCH),
            "--eval-inflight", "0"])
    out = P.test_driver.test_rcnn(eargs)
    bbox = {k: out.get(k) for k in COCO_STATS}
    if not all(v is not None and np.isfinite(v) for v in bbox.values()):
        fail(f"fpn alternate eval: bbox stats {bbox}")
    try:
        ta.alternate_train(ta.parse_args(
            ["--network", "resnet101_fpn_mask"] + common + [
                "--prefix", prefix + "-mask"]))
        fail("fpn alternate: a mask network trained alternately")
    except NotImplementedError as e:
        if str(e) != P.fpn_mod.NO_MASK_ALTERNATE:
            fail(f"fpn alternate: the mask network refused with {e}")
    log("fpn_alternate", network="resnet101", fpn=True, wall_s=alt_s,
        stages=stages_log, neck_leaves=len(neck), bbox=bbox,
        mask_refused=P.fpn_mod.NO_MASK_ALTERNATE)


def torchvision_vgg16_state_dict(seed: int) -> dict:
    """A torchvision ``vgg16``'s state_dict names and shapes, seeded
    random values drawn so that the random network stays finite:
    He-normal convolutions and fc6/fc7, biases 0.01, ``classifier.6``
    N(0, 0.01²)."""
    gen = torch.Generator().manual_seed(seed)
    chans = [(64, 3), (64, 64), (128, 64), (128, 128), (256, 128),
             (256, 256), (256, 256), (512, 256), (512, 512), (512, 512),
             (512, 512), (512, 512), (512, 512)]
    shapes = [(f"features.{i}", (o, c, 3, 3)) for i, (o, c) in zip(
        (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28), chans)]
    shapes += [("classifier.0", (4096, 25088)), ("classifier.3", (4096, 4096))]
    sd = {}
    for name, shape in shapes:
        fan_in = int(np.prod(shape[1:]))
        sd[name + ".weight"] = torch.randn(shape, generator=gen) * (
            2.0 / fan_in) ** 0.5
        sd[name + ".bias"] = torch.full((shape[0],), 0.01)
    sd["classifier.6.weight"] = torch.randn(1000, 4096, generator=gen) * 0.01
    sd["classifier.6.bias"] = torch.zeros(1000)
    return sd


def tied_windows(dtype, dev) -> tuple:
    """(1, 1, 4, 6) positive values, every 2×2 window tied (its maximum two
    or four times), on ``dev``, and the input gradient of a 2×2/2
    max-pool that routes each window's cotangent (1 … 6) to its first
    maximum in row-major order."""
    x = torch.full((1, 1, 4, 6), 0.25)
    ties = {(0, 0): [(0, 0), (1, 1)], (0, 1): [(0, 1), (0, 0)],
            (0, 2): [(1, 0), (1, 1)], (1, 0): [(0, 0), (0, 1), (1, 0), (1, 1)],
            (1, 1): [(0, 1), (1, 0)], (1, 2): [(1, 1), (0, 1)]}
    want = torch.zeros_like(x)
    for (i, j), cells in ties.items():
        for di, dj in cells:
            x[0, 0, 2 * i + di, 2 * j + dj] = 1.5 + i + j
        di, dj = min(cells)
        want[0, 0, 2 * i + di, 2 * j + dj] = 1 + 3 * i + j
    return x.to(dev, dtype), want


def vgg_slice(P, work: str, seed: int, device=None, flags=VGG_FLAGS) -> list:
    """VGG-16 Faster R-CNN at full width (13 convs of 64–512 channels, a
    512-channel RPN, ROIAlign 7×7 at stride 16 with one sample a bin,
    fc6/fc7 of 4 096 with dropout 0.5 in training, 21 classes, the
    600×1000 bucket padded to 608×1008, TRAIN 12000 → 2000, 256 anchors
    and 128 RoIs an image, ``MAX_GT`` 100, bf16 compute on float32
    parameters, ``ASSIGN_FUSED``, ``FLIP``) on :func:`write_devkit`'s
    PNG devkit, every kernel count set to 0 just before each run and read
    just after:

    * a seeded torchvision-layout ``vgg16`` state_dict
      (:func:`torchvision_vgg16_state_dict`) through
      ``utils/convert_torch.py``: its keys are the model's ``backbone``
      and ``head_body`` keys, no more, no fewer;
    * ``python -m mx_rcnn_tpu_torch.train_end2end --network vgg16``'s
      ``train_net`` from it, ``BATCH`` images a step, ``VGG_STEPS`` steps:
      every loss finite, each kernel once a step, the ``conv1_*`` and
      ``conv2_*`` leaves bitwise unchanged and conv3–conv5, fc6, fc7, the
      RPN and the output layer moved; step walls, loader wait, peak
      memory, the parameter count and the checkpoint's bytes;
    * dropout on the card: ``rcnn_train`` in float32 (TF32 off) on the
      first step's batch and the model's own test proposals, with one set
      of injected uniforms and keep masks, against the same call on CPU
      copies (labels identical, losses within ``VGG_F32_RTOL``); masks
      drawn by the card's generator keep 50 ± 1% of 2 × 128 × 4 096;
      ``predict`` twice on one batch bitwise equal;
    * max-pool ties on the card: the backward of a 2×2/2 pool over tied
      positive windows routes each window's gradient to its first
      maximum, in float32 and bf16, as on the CPU;
    * ``python -m mx_rcnn_tpu_torch.test`` on the checkpoint, serial, on
      the host route (a warm-up run first) and ``--device-postprocess``:
      mAP, the NMS pair once and twice a batch, the routes' records held
      to each other (:func:`match_routes`), images/s and batch walls;
    * the server (``serve.driver.build_engine``) in host-NMS and e2e mode,
      ``VGG_REQUESTS`` requests each (:func:`serve_mode`);
    * ``python -m mx_rcnn_tpu_torch.train_alternate --network vgg16``
      from the converted weights, ``VGG_ALT_STEPS`` steps a stage
      (:func:`run_alternate`): stages 4 and 6 keep every ``backbone``
      leaf bitwise (``FIXED_PARAMS_SHARED``), the combined model takes
      stage 4's backbone and RPN and stage 6's head and evaluates in
      ``test``;
    * on the first training step's own inputs: the assign pair at N = 21
      546 (the step's gt, and G = 100 valid gt) and the NMS pair at B ·
      12 000 → 2 000 and B · 6 000 → 300 on the step's RPN boxes, each
      against its plain version (the kept rows also against
      ``nms_padded``), timed, with its bound.

    Returns the kernels' rows at VGG's shapes."""
    tstart = time.perf_counter()
    dev = torch.device(device or "cuda")
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    root = os.path.join(work, "vgg")
    devkit = write_devkit(root, seed)
    paths = ["--dataset_path", devkit, "--root_path",
             os.path.join(root, "data")]
    on = [] if device is None else ["--device", str(device)]
    counters = {"nms_mask": P.nms_cuda.nms_mask,
                "nms_sweep": P.nms_cuda.nms_sweep,
                "assign_gtmax": P.assign_cuda.assign_gtmax,
                "assign_rows": P.assign_cuda.assign_rows}

    def counted(fn):
        sync()
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, {k: f.launches for k, f in counters.items()}, \
            time.perf_counter() - t0

    # ---- torchvision weights through the converter ----
    pth = os.path.join(root, "vgg16.pth")
    torch.save(torchvision_vgg16_state_dict(seed), pth)
    pretrained = os.path.join(root, "vgg16.npz")
    P.convert_torch.convert_file(pth, "vgg16", pretrained)
    converted = P.load_params_npz(pretrained)

    # ---- end-to-end training through the driver ----
    prefix = os.path.join(root, "model", "e2e")
    targs = P.train_end2end.parse_args(flags + paths + on + [
        "--image_set", f"2007_{TRAIN_SPLIT}", "--pretrained", pretrained,
        "--batch_images", str(BATCH), "--num-steps", str(VGG_STEPS),
        "--end_epoch", "1", "--frequent", "1", "--prefix", prefix,
        "--seed", str(seed)])
    tcfg = P.config_from_args(targs, train=True)
    tr, net, tpu = tcfg.TRAIN, tcfg.network, tcfg.tpu
    stride = max(net.IMAGE_STRIDE, net.RPN_FEAT_STRIDE)
    bucket = P.image_mod.bucket_shape(tpu.SCALES[0], stride)
    got = (net.NETWORK, tcfg.NUM_CLASSES, bucket, net.HOST_S2D,
           net.RCNN_FEAT_STRIDE, tr.RPN_PRE_NMS_TOP_N, tr.RPN_POST_NMS_TOP_N,
           tr.RPN_BATCH_SIZE, tr.BATCH_ROIS, tpu.MAX_GT,
           tpu.ROI_SAMPLING_RATIO, tpu.ROI_MODE, tpu.COMPUTE_DTYPE,
           tpu.ASSIGN_FUSED, tr.FLIP, net.FIXED_PARAMS)
    if got != ("vgg16", 21, (608, 1008), False, 16, 12000, 2000, 256, 128,
               100, 1, "avg", "bfloat16", True, True, ("conv1", "conv2")):
        fail(f"vgg: config {got}")
    captured, seen, walls, waits, states, batches = {}, [], [], [], [], []
    last = [0.0]

    def capture(name, fn):
        def wrapped(*a, **k):
            if name not in captured:
                captured[name] = (_detached(a), k)
            return fn(*a, **k)
        return wrapped

    def on_step(epoch, step, metrics):
        now = time.perf_counter()  # frequent=1: fit has synchronised
        seen.append(metrics)
        walls.append(now - last[0])
        last[0] = now

    fit, batch_put = P.train_end2end.fit, P.trainer.batch_put

    def fit_timed(cfg, model, params, loader, **k):
        states.append({k_: np.array(v) for k_, v in params.items()})
        last[0] = time.perf_counter()
        st = fit(cfg, model, params, WaitTimed(loader, waits),
                 batch_end_callback=on_step, **k)
        states.append(st)
        return st

    def batch_put_kept(batch, cfg, device_):
        out = batch_put(batch, cfg, device_)
        if not batches:
            batches.append({k: _detached(v) for k, v in out.items()})
        return out

    det = P.detector_mod
    patched = ((P.train_end2end, "fit", fit_timed),
               (P.trainer, "batch_put", batch_put_kept),
               (det, "assign_targets", capture("assign", det.assign_targets)),
               (det, "propose", capture("propose", det.propose)))
    saved = [(m, n, getattr(m, n)) for m, n, _ in patched]
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for m, n, f in patched:
        setattr(m, n, f)
    try:
        _, train_launches, train_s = counted(
            lambda: P.train_end2end.train_net(targs))
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    peak_bytes = torch.cuda.max_memory_allocated() if on_card else 0
    before, st = states
    model_keys = P.param_shapes(st.model)
    backbone_fc = {k for k in model_keys
                   if k.split("/")[0] in ("backbone", "head_body")}
    if set(converted) != backbone_fc or any(
            converted[k].shape != model_keys[k] for k in converted):
        fail(f"vgg: the converted torchvision keys {sorted(converted)[:4]}… "
             f"are not the model's backbone and head_body keys")
    n_params = sum(int(np.prod(s_)) for s_ in model_keys.values())
    if n_params != VGG_PARAMS:
        fail(f"vgg: {n_params} parameters, expected {VGG_PARAMS}")
    if len(seen) != VGG_STEPS or st.step != VGG_STEPS:
        fail(f"vgg train: {len(seen)} steps of {VGG_STEPS}")
    for name, count in train_launches.items():
        if count != VGG_STEPS:
            fail(f"vgg train: {name} launched {count} times in {VGG_STEPS} "
                 f"steps")
    if not all(np.isfinite(list(m.values())).all() for m in seen):
        fail(f"vgg train: non-finite metrics {seen}")
    after = P.export_jax_params(st.model)
    n_frozen, n_moved = _moved_and_frozen(before, after, st.mask, "vgg train")
    frozen = sorted(k for k, t in st.mask.items() if not t)
    if frozen != sorted(k for k in model_keys if k.startswith(
            ("backbone/conv1_", "backbone/conv2_"))):
        fail(f"vgg train: frozen leaves {frozen}")
    for group in ("backbone/conv3_", "backbone/conv4_", "backbone/conv5_",
                  "head_body/fc6/", "head_body/fc7/", "rpn/", "rcnn_out/"):
        if not any(k.startswith(group) and not np.array_equal(after[k],
                                                              before[k])
                   for k in after):
            fail(f"vgg train: no {group} leaf moved")
    del after, before
    ckpt_bytes = os.path.getsize(P.epoch_path(prefix, 1))
    log("vgg_train", network=net.NETWORK, classes=tcfg.NUM_CLASSES,
        bucket=list(bucket), dtype=tpu.COMPUTE_DTYPE, batch=BATCH,
        steps=len(seen), parameters=n_params, checkpoint_bytes=ckpt_bytes,
        converted_keys=len(converted), train_wall_s=train_s,
        launches=train_launches, frozen_leaves=n_frozen,
        moved_leaves=n_moved, max_memory_allocated_bytes=peak_bytes,
        step_wall_s=walls, step_wall_median_s=statistics.median(walls[1:]),
        loader_wait_s=waits, loader_wait_share=sum(waits) / sum(walls),
        metrics=seen)
    del st
    states.clear()
    if on_card:
        torch.cuda.empty_cache()

    # ---- dropout and max-pool ties on the card ----
    vgg_dropout_checks(P, tcfg, P.epoch_path(prefix, 1), batches[0], dev,
                       seed)
    batches.clear()

    # ---- evaluation through the test driver ----
    eargs = flags + paths + on + ["--image_set", f"2007_{EVAL_SPLIT}",
                                  "--prefix", prefix, "--epoch", "1",
                                  "--batch_images", str(BATCH),
                                  "--eval-inflight", "0"]
    modes = {"warm-up": [], "serial": [],
             "serial+devpost": ["--device-postprocess"]}
    n_batches = -(-len(EVAL_SIZES) // BATCH)
    stats, boxes, eval_launches = {}, {}, {}
    for mode, extra in modes.items():
        cache = os.path.join(root, f"dets-{mode}.pkl")
        out, eval_launches[mode], _ = counted(lambda: P.test_driver.test_rcnn(
            P.test_driver.parse_args(eargs + extra + ["--dets_cache",
                                                      cache])))
        want = n_batches * (2 if "devpost" in mode else 1)
        for name in ("nms_mask", "nms_sweep"):
            if eval_launches[mode][name] != want:
                fail(f"vgg eval [{mode}]: {name} launched "
                     f"{eval_launches[mode][name]} times in {n_batches} "
                     f"batches, expected {want}")
        if not (np.isfinite(out["mAP"]) and 0.0 <= out["mAP"] <= 1.0):
            fail(f"vgg eval [{mode}]: mAP {out['mAP']}")
        with open(cache, "rb") as f:
            boxes[mode] = pickle.load(f)
        stats[mode] = out
    ecfg = P.config_from_args(P.test_driver.parse_args(eargs), train=False)
    matched = match_routes(boxes["serial"], boxes["serial+devpost"],
                           ecfg.TEST.MAX_PER_IMAGE)
    log("vgg_eval", images=len(EVAL_SIZES), batch=BATCH,
        launches=eval_launches, device_matched=matched,
        mAP={m: s_["mAP"] for m, s_ in stats.items()},
        imgs_per_sec={m: s_["eval_pipeline"]["imgs_per_sec"]
                      for m, s_ in stats.items()},
        batch_wall_s={m: s_["eval_pipeline"]["wall_s"] / n_batches
                      for m, s_ in stats.items()},
        pipeline={m: s_["eval_pipeline"] for m, s_ in stats.items()})

    # ---- serving ----
    P.telemetry.configure(root, stream=False)
    sargs = P.serve_driver.parse_args(flags + on + [
        "--prefix", prefix, "--epoch", "1", "--serve-batch", str(BATCH),
        "--max-delay-ms", "10", "--unix-socket", "unused"])
    scfg = P.config_from_args(sargs, train=False)
    rng = np.random.RandomState(seed + 2)
    images = [boxes_image(rng, h, w)[0] for h, w in SERVE_SIZES[:4]]
    served = {}
    predictor, engine = P.serve_driver.build_engine(sargs, scfg)
    try:
        served["host_nms"] = serve_mode(P, predictor, engine, scfg,
                                        os.path.join(root, "host.sock"),
                                        images, e2e=False,
                                        requests=VGG_REQUESTS)
    finally:
        engine.stop()
    engine = P.serve.ServeEngine(predictor, scfg, dataclasses.replace(
        engine.opts, serve_e2e=True)).start()
    try:
        served["e2e"] = serve_mode(P, predictor, engine, scfg,
                                   os.path.join(root, "e2e.sock"), images,
                                   e2e=True, requests=VGG_REQUESTS)
    finally:
        engine.stop()
    P.telemetry.shutdown()
    del predictor, engine
    log("vgg_serve", sizes=[list(im.shape[:2]) for im in images],
        batch=BATCH, modes=served)
    if on_card:
        torch.cuda.empty_cache()

    # ---- alternate training ----
    alt_prefix = os.path.join(root, "alt_model", "alt")
    common = flags + paths + on + ["--image_set", f"2007_{TRAIN_SPLIT}"]
    stages, final, alt_s = run_alternate(
        P, common + ["--pretrained", pretrained, "--num-steps",
                     str(VGG_ALT_STEPS), "--end_epoch", "1",
                     "--batch_images", str(BATCH), "--prefix", alt_prefix,
                     "--seed", str(seed)], sync, VGG_ALT_STEPS,
        "vgg alternate")
    s3, s4, s6 = (stages[i]["params"] for i in (2, 3, 5))
    for k, v in final.items():
        group = k.split("/")[0]
        if not np.array_equal(v, (s6 if group in ("head_body", "rcnn_out")
                                  else s4)[k]):
            fail(f"vgg alternate: combined {k} is not its stage's")
        if group == "backbone" and not (np.array_equal(s4[k], s3[k])
                                        and np.array_equal(s6[k], s4[k])):
            fail(f"vgg alternate: stage 4 or 6 moved the frozen {k}")
    stages_log = [{k: v for k, v in s_.items() if k != "params"}
                  for s_ in stages]
    stages.clear()
    del s3, s4, s6, final
    out, alt_eval_launches, _ = counted(lambda: P.test_driver.test_rcnn(
        P.test_driver.parse_args(flags + paths + on + [
            "--image_set", f"2007_{EVAL_SPLIT}", "--prefix", alt_prefix,
            "--epoch", "1", "--batch_images", str(BATCH),
            "--eval-inflight", "0"])))
    if not (np.isfinite(out["mAP"]) and 0.0 <= out["mAP"] <= 1.0):
        fail(f"vgg alternate eval: mAP {out['mAP']}")
    log("vgg_alternate", wall_s=alt_s, stages=stages_log,
        stage_wall_s=[s_["wall_s"] for s_ in stages_log],
        mAP=out["mAP"], eval_launches=alt_eval_launches)

    # ---- the kernels on the first step's own inputs ----
    if on_card:
        torch.cuda.empty_cache()
    rows = vgg_kernels(P, tcfg, ecfg, captured, train_launches,
                       eval_launches["serial"])
    log("vgg_total", seconds=time.perf_counter() - tstart)
    return rows


def vgg_dropout_checks(P, tcfg, ckpt: str, batch: dict, dev, seed: int):
    """Dropout on the card (see :func:`vgg_slice`) and the max-pool ties.
    ``batch`` is the first training step's, on ``dev``."""
    cfg32 = tcfg.replace(tpu=dataclasses.replace(tcfg.tpu,
                                                 COMPUTE_DTYPE="float32"))
    params = P.normalize_for_train(P.load_params_npz(ckpt), cfg32)
    models = []  # the card's model, then the CPU copy
    for where in (dev, torch.device("cpu")):
        m = P.build_model(cfg32)
        P.load_jax_params(m, params)
        models.append(m.to(where))
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        rois, _, roi_valid = models[0].predict_rpn(batch["images"],
                                                   batch["im_info"])
    gen = torch.Generator().manual_seed(seed)
    n = rois.shape[1] + tcfg.tpu.MAX_GT
    shape = (BATCH, tcfg.TRAIN.BATCH_ROIS, 4096)
    draws = {"rcnn": P.uniform_draws((BATCH, n), "cpu", gen),
             "dropout": tuple(P.dropout_keep(shape, "cpu", gen)
                              for _ in range(2))}
    args = [batch[k] for k in ("images", "im_info")] + [rois, roi_valid] + \
        [batch[k] for k in ("gt_boxes", "gt_classes", "gt_valid")]
    outs = []
    for where, m in zip((dev, torch.device("cpu")), models):
        with torch.no_grad():
            total, aux = m.rcnn_train(
                *[torch.as_tensor(a).to(where) for a in args],
                draws={k: tuple(t.to(where) for t in v)
                       for k, v in draws.items()})
        outs.append((aux["rcnn_label"].cpu(),
                     [float(aux[k]) for k in ("rcnn_cls_loss",
                                              "rcnn_bbox_loss")]
                     + [float(total)]))
    card, host = outs
    if not torch.equal(card[0], host[0]):
        fail("vgg dropout: rcnn_train's labels differ between the card and "
             "the CPU")
    rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(card[1],
                                                               host[1]))
    if rel > VGG_F32_RTOL:
        fail(f"vgg dropout: rcnn_train's losses differ between the card and "
             f"the CPU by {rel} ({card[1]} vs {host[1]})")
    model = models[0]
    del models
    kept = float(P.dropout_keep(
        (2,) + shape[1:], dev, torch.Generator(device=dev).manual_seed(seed))
        .float().mean())
    if abs(kept - 0.5) > 0.01:
        fail(f"vgg dropout: drawn masks keep {kept} of the entries")
    with torch.no_grad():
        p1 = model.predict(batch["images"], batch["im_info"])
        p2 = model.predict(batch["images"], batch["im_info"])
    if not all(torch.equal(a, b) for a, b in zip(p1, p2)):
        fail("vgg dropout: predict twice on one batch differs")
    del model, p1, p2

    ties = {}
    for dtype in (torch.float32, torch.bfloat16):
        grads = []
        for where in (dev, torch.device("cpu")):
            x, want = tied_windows(dtype, where)
            x = x.contiguous(memory_format=torch.channels_last)
            x.requires_grad_()
            y = torch.nn.functional.max_pool2d(x, 2, 2)
            (y.float() * torch.arange(1, 7, dtype=torch.float32, device=where)
             .reshape(1, 1, 2, 3)).sum().backward()
            grads.append(x.grad.float().cpu())
        if not (torch.equal(grads[0], want) and torch.equal(grads[1], want)):
            fail(f"vgg max-pool ties ({dtype}): the gradient does not go to "
                 f"each window's first maximum on the "
                 f"{'card' if not torch.equal(grads[0], want) else 'CPU'}")
        ties[str(dtype)] = True
    log("vgg_dropout", rcnn_train_f32_rel=rel, rtol=VGG_F32_RTOL,
        labels_identical=True, rois=int(rois.shape[1]),
        fg_labels=int((card[0] > 0).sum()), losses_card=card[1],
        losses_cpu=host[1], drawn_keep_fraction=kept,
        predict_bitwise=True, max_pool_ties_first_max=ties)


def vgg_kernels(P, tcfg, ecfg, captured, train_launches, eval_launches
                ) -> list:
    """The assign pair and the NMS pair on the first VGG training step's
    own inputs (see :func:`vgg_slice`).  Returns their rows."""
    tr, te = tcfg.TRAIN, ecfg.TEST
    (_, anchors, gt_boxes, gt_valid, im_info, *_), _ = captured["assign"]
    dev = anchors.device
    n = int(anchors.shape[0])
    if n != VGG_ANCHORS:
        fail(f"vgg: {n} anchors, expected {VGG_ANCHORS}")
    ab = tr.RPN_ALLOWED_BORDER
    im_h, im_w = im_info[:, 0:1], im_info[:, 1:2]
    inside = ((anchors[None, :, 0] >= -ab) & (anchors[None, :, 1] >= -ab)
              & (anchors[None, :, 2] < im_w + ab)
              & (anchors[None, :, 3] < im_h + ab))
    rows = time_assign(P.assign_cuda, anchors, gt_boxes, gt_valid, inside)
    g = int(gt_boxes.shape[1])
    for k in rows:
        k.update(launches=train_launches[k["name"]],
                 shape=f"vgg train: N={n}, G={g}, the batch's gt "
                       f"({[int(x) for x in gt_valid.sum(1)]} valid)")
    an = anchors.cpu().numpy()
    hw = [int(x) for x in im_info[0, :2].tolist()]
    per = [assign_case(np.random.RandomState(80 + b), an, hw, 100, 100,
                       (40.0, 360.0)) for b in range(int(gt_boxes.shape[0]))]
    g100 = time_assign(P.assign_cuda, anchors, *(
        torch.from_numpy(np.stack([p[i] for p in per])).to(dev)
        for i in range(3)))
    for k in g100:
        k.update(launches=train_launches[k["name"]],
                 shape=f"vgg train: N={n}, G=100")
    log("times_vgg_assign", shape={"B": int(gt_boxes.shape[0]),
                                   "anchors": n, "gt": g},
        kernels=rows, g100={"gt": 100, "kernels": g100})
    rows += g100

    (scores, deltas, p_anchors, info), _ = captured["propose"]
    for what, pre, post, thresh, launches in (
            ("train", tr.RPN_PRE_NMS_TOP_N, tr.RPN_POST_NMS_TOP_N,
             tr.RPN_NMS_THRESH, train_launches),
            ("test", te.RPN_PRE_NMS_TOP_N, te.RPN_POST_NMS_TOP_N,
             te.RPN_NMS_THRESH, eval_launches)):
        boxes, sc, valid = P.proposal_candidates(
            scores, deltas, p_anchors, info, pre_nms_top_n=pre,
            min_size=tr.RPN_MIN_SIZE if what == "train" else te.RPN_MIN_SIZE)
        b, m = int(boxes.shape[0]), int(boxes.shape[1])
        if m != pre:
            fail(f"vgg {what} proposal: {m} candidates, expected {pre}")
        ki, km = P.nms_cuda.nms_bitmask(boxes, valid, post, thresh)
        for i in range(b):
            ri, rm = P.nms_padded(boxes[i], sc[i], post, thresh,
                                  valid=valid[i])
            if not torch.equal(ki[i][km[i]], ri[rm]):
                fail(f"vgg {what} proposal: kernel and plain NMS keep "
                     f"different rows in image {i}")
        nms_rows = time_kernels(P.nms_cuda, boxes, valid, post, thresh)
        for k in nms_rows:
            k.update(launches=launches[k["name"]],
                     shape=f"vgg {what} proposal: B={b}, n={m} -> {post}")
        log(f"times_vgg_{what}_proposal", shape={"B": b, "n": m,
                                                 "max_out": post},
            kept=[int(x) for x in km.sum(1)], identical=True,
            kernels=nms_rows)
        rows += nms_rows
    for k in rows:
        if k["max_abs_err"] != 0.0:
            fail(f"{k['name']} disagrees with its plain version at VGG's "
                 f"shape {k['shape']} (max abs err {k['max_abs_err']})")
        k.update(route="cuda", source=SOURCES[k["name"]],
                 replaces=REPLACES[k["name"]])
    return rows


def import_port() -> types.SimpleNamespace:
    """The port's modules and functions the phases use, imported from the
    checkout (after the CUDA check, so that a machine without a card fails
    before importing anything of the port)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mx_rcnn_tpu_torch import serve, telemetry
    from mx_rcnn_tpu_torch import test as test_driver
    from mx_rcnn_tpu_torch import train_alternate
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch import demo
    from mx_rcnn_tpu_torch.data import image as image_mod
    from mx_rcnn_tpu_torch.data import loader as loader_mod
    from mx_rcnn_tpu_torch.data import workers
    from mx_rcnn_tpu_torch.data.loader import AnchorLoader, ROIIter, TestLoader
    from mx_rcnn_tpu_torch import native
    from mx_rcnn_tpu_torch.data.coco_dataset import COCODataset
    from mx_rcnn_tpu_torch.data.pascal_voc import PascalVOC
    from mx_rcnn_tpu_torch.eval import mask_rle
    from mx_rcnn_tpu_torch.data.synthetic import SyntheticDataset
    from mx_rcnn_tpu_torch.eval import tester
    from mx_rcnn_tpu_torch.eval.coco_eval import COCOEval
    from mx_rcnn_tpu_torch.kernels import _build, assign_cuda, nms_cuda
    from mx_rcnn_tpu_torch.data import mask as mask_mod
    from mx_rcnn_tpu_torch.models import detector as detector_mod
    from mx_rcnn_tpu_torch.models import fpn as fpn_mod
    from mx_rcnn_tpu_torch.models.backbones import dropout_keep
    from mx_rcnn_tpu_torch.models.detector import build_model
    from mx_rcnn_tpu_torch.models.losses import fg_prob
    from mx_rcnn_tpu_torch.ops import mask_target
    from mx_rcnn_tpu_torch.ops import postprocess as post
    from mx_rcnn_tpu_torch.ops.anchors import all_anchors, generate_anchors
    from mx_rcnn_tpu_torch.ops.assign_anchor import uniform_draws
    from mx_rcnn_tpu_torch.ops.nms import (nms_padded, nms_padded_batch,
                                           rank_rows)
    from mx_rcnn_tpu_torch.ops.postprocess import per_class_rows
    from mx_rcnn_tpu_torch.ops.proposal import (fpn_candidates, propose,
                                                propose_fpn,
                                                proposal_candidates)
    from mx_rcnn_tpu_torch.serve import driver as serve_driver
    from mx_rcnn_tpu_torch.telemetry import HIST_LE, quantile_from_counts
    from mx_rcnn_tpu_torch.tools import reeval
    from mx_rcnn_tpu_torch.tools import test_rpn as test_rpn_mod
    from mx_rcnn_tpu_torch.tools import train_rcnn as train_rcnn_mod
    from mx_rcnn_tpu_torch.tools import train_rpn as train_rpn_mod
    from mx_rcnn_tpu_torch.tools.common import (CappedLoader,
                                                config_from_args,
                                                get_train_roidb,
                                                load_eval_params)
    from mx_rcnn_tpu_torch import train_end2end
    from mx_rcnn_tpu_torch.tools.common import get_imdb, init_or_load_params
    from mx_rcnn_tpu_torch.train import resilience, trainer
    from mx_rcnn_tpu_torch.train.checkpoint import (CheckpointManager,
                                                    denormalize_for_save,
                                                    epoch_path,
                                                    load_params_npz,
                                                    normalize_for_train,
                                                    save_params_npz)
    from mx_rcnn_tpu_torch.train.optim import export_momentum
    from mx_rcnn_tpu_torch.train.resilience import (NonFiniteLossError,
                                                    ResilienceOptions,
                                                    encode_step_key)
    from mx_rcnn_tpu_torch.train.train_step import (_all_finite,
                                                    create_train_state,
                                                    make_train_step)
    from mx_rcnn_tpu_torch.train.trainer import batch_put, fit
    from mx_rcnn_tpu_torch.utils import convert_torch
    from mx_rcnn_tpu_torch.utils.convert_jax import (export_jax_params,
                                                     load_jax_params,
                                                     param_shapes,
                                                     random_params)

    return types.SimpleNamespace(**locals())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    P = import_port()

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # ---- 1. device and build -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    t0 = time.perf_counter()
    libs = P._build.build()
    if not P.native.available():
        fail("the host mask library did not load")
    log("build", seconds=time.perf_counter() - t0,
        libraries=sorted(p.name for p in libs.values()))

    # ---- 2. kernels vs plain versions on the card ----------------------------
    t0 = time.perf_counter()
    cases = check_nms_matrix(P.nms_cuda, P.nms_padded, dev)
    log("nms_matrix", cases=cases, identical=True,
        seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    cases = check_mask_band(P.nms_cuda, P.nms_padded, dev)
    log("mask_band", cases=cases, identical=True,
        seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    main_anchors = P.all_anchors(608 // 16, 1024 // 16, 16, P.generate_anchors())
    cases = check_assign_matrix(P.assign_cuda, P.all_anchors, P.generate_anchors,
                                dev, main_anchors, (600, 1000))
    log("assign_matrix", cases=cases, identical=True,
        seconds=time.perf_counter() - t0)

    # ---- 3. the inference slice at full width --------------------------------
    cfg = P.generate_config("resnet101", "PascalVOC")
    cfg = cfg.replace(network=dataclasses.replace(cfg.network,
                                                  PIXEL_STDS=PIXEL_STDS))
    model = P.build_model(cfg)
    params = P.random_params(model, seed=args.seed)
    predictor = P.tester.Predictor(model, params, cfg)
    rng = np.random.RandomState(args.seed)
    images = [rng.randint(0, 256, hw + (3,), np.uint8) for hw in RAW_SIZES]
    port = (P.image_mod, P.tester, P.post)
    stride = max(cfg.network.IMAGE_STRIDE, cfg.network.RPN_FEAT_STRIDE)
    run_slice(port, predictor, cfg, images[:BATCH], BATCH)  # warm-up

    P.nms_cuda.nms_mask.launches = P.nms_cuda.nms_sweep.launches = 0
    records, walls = run_slice(port, predictor, cfg, images, BATCH)
    launches = {"nms_mask": P.nms_cuda.nms_mask.launches,
                "nms_sweep": P.nms_cuda.nms_sweep.launches}
    n_batches = len(walls)
    for name, count in launches.items():
        if count != n_batches:
            fail(f"{name} launched {count} times in {n_batches} batches")
    log("slice", network=cfg.network.NETWORK, classes=cfg.NUM_CLASSES,
        bucket=list(P.image_mod.bucket_shape(cfg.tpu.SCALES[0], stride)),
        dtype=cfg.tpu.COMPUTE_DTYPE, images=len(images), batches=n_batches,
        batch_wall_s=walls, launches=launches,
        records_per_image=[len(r) for r in records])

    # the main path's NMS input, for phase 4: the RPN of the same model on
    # the first batch
    def rpn_candidates(pred, c):
        staged = [P.image_mod.stage_raw_to_bucket(im, c.tpu.SCALES[0], stride)
                  for im in images[:BATCH]]
        batch = pred.batch_put({
            "images": np.stack([s[0] for s in staged]),
            "raw_hw": np.stack([s[1] for s in staged]),
            "prep_ratio": np.stack([s[2] for s in staged]),
            "im_info": np.stack([s[3] for s in staged])})
        m = pred.model
        with torch.inference_mode():
            feat = m.backbone(batch["images"])
            cls, bbox = m.rpn(feat)
            anchors = m._anchors_for(feat.shape[1], feat.shape[2], dev)
            info = torch.as_tensor(batch["im_info"], device=dev)
            return P.fg_prob(cls), bbox, anchors, info

    te = cfg.TEST
    cand_kw = dict(pre_nms_top_n=te.RPN_PRE_NMS_TOP_N,
                   min_size=te.RPN_MIN_SIZE)
    main_rpn = rpn_candidates(predictor, cfg)
    rpn_delta_absmax = float(main_rpn[1].abs().max())
    if not np.isfinite(rpn_delta_absmax):
        fail("non-finite RPN deltas on the main path")
    main_boxes, _, main_valid = P.proposal_candidates(*main_rpn, **cand_kw)
    del main_rpn

    # float32 rerun of one batch, TF32 off: propose's kept indices through
    # the kernels against the plain NMS on the same RPN outputs
    cfg32 = cfg.replace(tpu=dataclasses.replace(cfg.tpu,
                                                COMPUTE_DTYPE="float32"))
    pred32 = P.tester.Predictor(P.build_model(cfg32), params, cfg32)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("float32 Predictor left TF32 on")
    rpn32 = rpn_candidates(pred32, cfg32)
    boxes32, scores32, valid32 = P.proposal_candidates(*rpn32, **cand_kw)
    ki, km = P.nms_cuda.nms_bitmask(boxes32, valid32, te.RPN_POST_NMS_TOP_N,
                                  te.RPN_NMS_THRESH)
    for b in range(boxes32.shape[0]):
        ri, rm = P.nms_padded(boxes32[b], scores32[b], te.RPN_POST_NMS_TOP_N,
                            te.RPN_NMS_THRESH, valid=valid32[b])
        if not torch.equal(ki[b][km[b]], ri[rm]):
            fail(f"float32 propose: kernel and plain NMS keep different "
                 f"indices in image {b}")
    prop_kw = dict(pre_nms_top_n=te.RPN_PRE_NMS_TOP_N,
                   post_nms_top_n=te.RPN_POST_NMS_TOP_N,
                   nms_thresh=te.RPN_NMS_THRESH, min_size=te.RPN_MIN_SIZE)
    with torch.inference_mode():
        k_rois, _, k_valid = P.propose(*rpn32, use_kernel=True, **prop_kw)
        p_rois, _, p_valid = P.propose(*rpn32, use_kernel=False, **prop_kw)
    if not (torch.equal(k_valid, p_valid) and torch.equal(k_rois, p_rois)):
        fail("float32 propose: kernel and plain paths give different RoIs")
    records32, walls32 = run_slice(port, pred32, cfg32, images[:BATCH],
                                   BATCH)
    # the same batch with the plain NMS inside propose: same records
    cfg32p = cfg32.replace(TEST=dataclasses.replace(te, CXX_PROPOSAL=False))
    pred32p = P.tester.Predictor(P.build_model(cfg32p), params, cfg32p)
    records32p, _ = run_slice(port, pred32p, cfg32p, images[:BATCH], BATCH)
    for rk, rp in zip(records32, records32p, strict=True):
        if [r["cls"] for r in rk] != [r["cls"] for r in rp] or not (
                np.allclose([r["score"] for r in rk],
                            [r["score"] for r in rp], rtol=0, atol=1e-6)
                and np.allclose([r["bbox"] for r in rk],
                                [r["bbox"] for r in rp], rtol=0, atol=1e-3)):
            fail("float32 records differ between the kernel and plain NMS")
    del pred32p
    log("slice_float32", kept=[int(x) for x in km.sum(1)],
        identical=True, batch_wall_s=walls32,
        records_per_image=[len(r) for r in records32])
    del pred32, rpn32

    # ---- 5a. inference times -------------------------------------------------
    inference = time_kernels(P.nms_cuda, main_boxes, main_valid,
                             te.RPN_POST_NMS_TOP_N, te.RPN_NMS_THRESH)
    for k in inference:
        if k["max_abs_err"] != 0.0:
            fail(f"{k['name']} disagrees with its plain version at the "
                 f"inference shape (max abs err {k['max_abs_err']})")
    log("times_inference", shape={"B": int(main_boxes.shape[0]),
                                  "n": int(main_boxes.shape[1]),
                                  "max_out": te.RPN_POST_NMS_TOP_N},
        rpn_delta_absmax=rpn_delta_absmax, launches=launches,
        kernels=inference)
    del predictor, main_boxes, main_valid

    # ---- 4. the training slice at full width ---------------------------------
    tcfg = P.generate_config(
        "resnet101", "PascalVOC", TRAIN__BATCH_IMAGES=BATCH, TRAIN__FLIP=True,
        tpu__ASSIGN_FUSED=True)
    tcfg = tcfg.replace(network=dataclasses.replace(tcfg.network,
                                                    PIXEL_STDS=PIXEL_STDS))
    with tempfile.TemporaryDirectory() as work:
        ctx = train_slice(P, port, tcfg, dev, args.seed, work)
        check_fused_vs_dense(P, ctx, dev)

        # ---- 5b. training times -----------------------------------------------
        kernels = train_times(P, ctx, dev, main_anchors)
        prefix, epoch = ctx["prefix"], ctx["epoch"]
        del ctx
        torch.cuda.empty_cache()

        # ---- 6. the evaluation slice at full width ----------------------------
        t0 = time.perf_counter()
        ev = eval_slice(P, prefix, epoch, work, args.seed)
        postprocess_times(P, ev, dev)
        log("eval_total", seconds=time.perf_counter() - t0)

        # ---- 7. the serving slice at full width -------------------------------
        t0 = time.perf_counter()
        served = serve_slice(P, prefix, epoch, work, args.seed)
        log("serve_total", seconds=time.perf_counter() - t0)

        # ---- 8. the alternate-training slice at full width --------------------
        torch.cuda.empty_cache()
        alternate_slice(P, P.epoch_path(prefix, epoch), work, args.seed)

        # ---- 9. the host input pipeline at full width -------------------------
        torch.cuda.empty_cache()
        pipeline_slice(P, tcfg, prefix, epoch, work, args.seed, served,
                       device=dev)

        # ---- 10. resilience at full width -------------------------------------
        torch.cuda.empty_cache()
        resilience_slice(P, P.epoch_path(prefix, epoch), work, args.seed, smi)

        # ---- 11. COCO at full width -------------------------------------------
        torch.cuda.empty_cache()
        coco = coco_slice(P, P.epoch_path(prefix, epoch), work, args.seed)

        # ---- 12. FPN and Mask R-CNN inference at full width ---------------
        torch.cuda.empty_cache()
        fpn = fpn_slice(P, work, args.seed)

        # ---- 13. FPN and Mask R-CNN training at full width ----------------
        torch.cuda.empty_cache()
        fpn_train = fpn_train_slice(P, work, args.seed)

        # ---- 14. VGG-16 Faster R-CNN at full width ------------------------
        torch.cuda.empty_cache()
        vgg = vgg_slice(P, work, args.seed)
    log("total", seconds=time.perf_counter() - t_start)

    # ---- 15. the kernels line and the result --------------------------------
    # the main path's rows (the training shape), then the COCO shapes', then
    # FPN's joint proposal, then FPN training's anchors and joint proposal,
    # then VGG's anchors and proposals
    kernels += coco + fpn + fpn_train + vgg
    order = ("name", "shape", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in order}
                                  for kern in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
