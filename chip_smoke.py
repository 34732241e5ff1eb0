#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mvtracker_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--release release/mvtracker_medium_synth.msgpack] [--phases 2,11]

Phases, in order; any failure ends the run with a non-zero exit code:

1. print the card's name and power limit, build the CUDA kernels from
   `mvtracker_torch/csrc/` with nvcc;
2. each kernel against its plain PyTorch version, on the card, at every
   shape the paths below give it (phase 10's k=24 and sentinel shapes too) (4 views x 24 frames x 256^2 with 256
   queries; 5 views x 18 frames x 704x1280 for the large cloud), plus a
   k > N and a far-from-origin kNN case; per
   shape the kernel's device time (launches replayed from a CUDA graph), its
   time called from Python through the wrapper, the plain version's device
   time and the bound; for the correlation kernels, which sum in a fixed
   order, also that two runs on one input give the same bits; and the shapes
   the evaluation path gives K1 and K2 (medium model: k=12, 96 channels);
3. the serving path: the flagship MVTracker in bf16 with seeded random
   weights answers 3 requests (scenes of seeds 0, 1, 2), with launch
   counters showing every kNN and correlation went through the kernels;
4. the fp32 forward through the kernels against the plain CPU path, same
   weights and scene, once for each kNN backend (fused, tiled, exact);
5. the training path: the same flagship model in bf16 with the update
   transformer rematerialised takes 3 train steps through `Trainer.fit` on
   one scene of the serving shape, with launch counters showing every kNN,
   correlation and correlation backward went through the kernels;
6. the fp32 train step (loss and every gradient leaf) through the kernels
   against the plain CPU path, same weights and scene;
7. the large-cloud serving path: the same flagship bf16 model answers 2
   requests of 5 views x 18 frames x 704x1280 (720p cropped to a multiple
   of 32), whose level-0 cloud of 281600 points is past the dispatcher's
   switch, so the tiled kNN kernel serves it; one request again through the
   fused kernel, which must give the same tracks;
8. the direct kNN entries: a neighbourhood query on that scene's level-0
   cloud through `knn(..., backend="exact")` and `backend="tiled"`;
9. the evaluation path: the medium model with the release checkpoint's
   options (vis-geom features, a 128-wide visibility MLP) through the
   release protocol of `release/README.md` by the port's
   `cli/eval_checkpoint.py` (8 calibration and 8 held-out scenes, fp32;
   the CLI turns TF32 off itself), with launch counters; then served at
   the predictor's defaults (384x512 resize, 5x5 support grid per view, 6
   iterations) in bf16, in fp32 with TF32 and in exact fp32, timed, and one
   request of the exact fp32 kernel path against the plain CPU path, both
   with the exact kNN (ties broken alike). The
   weights: with `--release PATH` the released checkpoint, loaded strictly,
   every scene's tracks held against the JAX package's outputs in
   `mvtracker_torch/evaluation/golden/`, the calibrated threshold and the
   held-out metrics against the golden's, and the protocol run again with
   TF32 convolutions and in bf16, which that check must reject; without it
   seeded weights, two protocol scenes held against the plain CPU path;
10. the tracker's options and the config CLIs: (a) a uniform-k medium
    model warm-started into corr_k0=24 through the corr-width migration
    (from a `.pth` of seeded weights, or the release msgpack), held against
    the plain CPU path and, against the uniform model, within the CPU's own
    comparison; (b) that model takes 3 bf16 train steps through
    `Trainer.fit` (K1 at k=24, K2, K3 counted per step); (c) the round-4
    inference knobs (global match, chain velocity, kNN reuse) through the
    predictor, K1 once per level group and window, against the plain CPU
    path (with `--release` also the protocol against a second golden);
    (d) `cli.train` on `configs/mvtracker_longvideo.yaml` for 3 flagship
    steps, `cli.eval` of its checkpoint, one request each through the
    normalized and the point-transformer presets, the latter against the
    plain CPU path; (e) `cli.serve`'s server answering 2 flagship requests
    as the predictor does;
11. the host data path and the real datasets' formats: (a) the native
    library built from `native/datapath.cpp` (the phase fails without it),
    each of its six functions against its numpy version on a flagship-size
    stack, both timed; (b) `configs/mvtracker.yaml` in bf16 with remat
    trains 6 steps through `Trainer.fit` on augmented randomized scenes
    from the disk cache and the prefetching loader, with the watchdog at its
    default, TensorBoard where it imports, and a profiler window over steps
    2 to 4 (K1/K2/K3 launches per step, losses finite); a second run over
    the cache renders nothing; (c) an evaluation hook that raises makes the
    trainer dump its batch, which replays on the card to the plain CPU
    path's loss; (d) two rendered scenes written in the Kubric layout with
    the port's own image writers, read back equal, then 3 steps of
    `cli.train` on them; (e) a Panoptic Studio and a DexYCB scene through
    `cli.eval` (medium model, seeded weights, the predictor's defaults), and
    the same requests held against the plain CPU path;
12. the other model families, none of which runs a kNN or a neighbour
    correlation (their launch counts must stay 0): (a) the triplane
    SpaTracker at `configs/spatracker_multiview.yaml`'s width, seeded
    weights, 3 flagship requests in fp32 (the config's dtype) and one in
    bf16, timed; the splat with PyTorch's default and its deterministic
    index_put_; one fp32 request against the plain CPU path; 3 steps of
    `cli.train` on that config (step times, peak memory); (b)
    `scripts/train_cotracker2d_torch.py` for 30 steps with its JSON, and one
    request of the learned 2D tracker at `configs/cotracker2d.yaml`'s width
    through the multi-view adapter against the plain CPU path; (c)
    `cli.eval` with `configs/cotracker3_offline.yaml` and with
    `monocular_nn` on one rendered scene (no hub cache: the missing
    checkpoint is reported and the NCC tracker runs on the card), and the
    NCC tracks on the card against the CPU's as the share of equal
    positions;
13. the last models: (a) VGGT-1B at its defaults (1.2e9 parameters, seeded
    on the card, fp32) on the 4 views of a rendered flagship scene at t=0:
    3 timed requests at 518^2, one at 518x294 (the positional embedding
    cubic-resized), one of 8 frames, peak memory at S=4 and S=8, the
    cameras aligned to the scene's; the model cut to 4 frame + 4 global
    and 2 DINOv2 blocks at full width against the plain CPU path; no kNN or
    correlation launch;
    (b) that scene written in the generic layout with the port's PNG
    writer, read by `GenericSceneDataset`, 256 uniform and 64 k-means
    queries sampled from its depth, the flagship MVTracker (bf16, seeded)
    serving 3 requests on it (K1, K2 counted; every K1 call of the first
    request held against the exact plain kNN, ties counted), and an fp32
    request against the plain CPU path; (c) Dynamic 3DGS at capacity 32768
    on its first 4 frames (iterations cut, one densification), each K1
    call of the fit (k=4 over the initial cloud, k=21 over all slots) held
    against the exact plain kNN with ties counted, the densification's
    clones and splits counted, densification with a lowered gradient
    threshold (requests past the free slots) against the plain CPU path
    and the rigidity kNN on its twins, tracks with the depth z-test
    through `CachedPredictionPredictor` and `Evaluator`, K1 at k=21,
    M=N=32768 timed against its bound, one full-size render of every slot
    and its gradients against the plain CPU path (computed on a thread beside
    the later phases, held before the kernels line); (d) Shape of Motion (10
    bases) with depth, mask and track supervision (iterations cut), its
    tracks, its K1 calls held against the exact plain kNN and timed;
14. data parallelism, the sharded kNN and the geometric solvers, with the
    ranks as processes on this one card (gloo; each loads the kernels phase
    1 built), started once: 4 ranks run the 4-rank parts, then ranks 0 and
    1 regroup into a world of 2 for the 2-rank parts, all beside this
    process's references, (d), (e) and the NCCL probe: (a) `knn_sharded`
    and `knn_sharded_ring` on 2 and 4 ranks at
    the flagship's level 0 (12 frames x 16384 points, 256 queries: the
    gather-merge; 2048: the ring) and on 2 ranks at the large cloud's
    (281600 points: K4 whole, K1 per half), distances bit-equal to the
    global search and the exact kNN, indices equal to the exact kNN's;
    (b) the flagship MVTracker (bf16, seeded) with a 1 x 2 knn_mesh serving
    a 256- and a 1024-query request, against one process at phase 4's
    limits; (c) the fp32 train step (TF32 off, remat) on 2 x 1 and 2 x 2
    meshes (shard_views, shard_tracks) against one process on the same
    2-scene batch, limits from `scripts/control_torch_parallel.py`, then 3
    timed bf16 flagship steps; (d) `cli.train` with MVTRACKER_DISTRIBUTED=1
    in a world of 1 over NCCL on `configs/mvtracker.yaml` for 3 steps and
    `cli/eval_checkpoint.py --exp_dir` on its checkpoint; (e) ICP
    recovering a known pose on a rendered frame's cloud and the wrist
    z-offset search on its two views, card against the CPU, and bundle
    adjustment card against CPU and over 2 ranks; and once, NCCL with two
    ranks on the one device, to print what it says;
15. the DROID data factory on the port's own file formats (the GPU host has
    neither OpenCV nor h5py): (a) the FFV1 depth-video codec on 60 frames of
    1280x720 (holes, a far band near 65 m), millimetres bit-equal, encode
    and decode ms a frame, and a DROID-shaped trajectory.h5 (300 steps)
    written and read contiguous and chunked; (b) a synthetic episode (2
    external cameras and the wrist camera at 256x192, 40 frames: raw h5 ->
    FK pipeline -> rendered rgb.npz and depth.mkv), built in a process of
    its own from the top of the script, and `load_droid_episode` equal to
    its files; (c) `cli.droid refine` recovering an injected 3 cm wrist
    bias to 1 mm, card against CPU, K1 counted; (d) `cli.droid track`, the
    flagship bf16 with seeded weights on the gripper queries and on 256
    mask-guided depth queries (--chunk_frames 16: 3 chained segments), K1
    and K2 counted, the overlay written, 3 warm requests timed, and one
    fp32 request (TF32 off, exact kNN) against the plain CPU path; (e)
    `cli.droid reproject` with its depth videos read back bit-equal to the
    renders and the z-buffer holding the closest point; (f) `cli.train`
    with dataset=droid, 3 bf16 steps of `configs/mvtracker.yaml`, K1, K2,
    K3 a step;
16. this slice's entry points: (a) `python -m mvtracker_torch.cli.convert`
    (a process of its own) on the seeded flagship's state dict saved under
    "model", then `convert.load_release` of its output strictly into a fresh
    flagship, every leaf bit-equal; `scripts/export_params_msgpack_torch.py
    --dtype bfloat16` on a one-step checkpoint of the medium release model,
    every leaf the step's weight rounded to bf16; (b) `cli.demo` on phase 3's
    scene (seed 0) written as a sample NPZ, the flagship's seeded weights
    from `--ckpt_dir`, `--chunk_frames 16 --mp4`: one K1 launch per kNN
    search and one K2 per correlation, and traj_e / vis_e bit-equal to the
    predictor called directly in this process; (c) the DROID north star,
    `scripts/eval_droid_track_error_torch.py` at the JAX script's settings
    on one episode (2 external cameras and the wrist at 256x192, 48 frames,
    built in a process of its own from the top of the script), seeded
    medium weights written through the port's msgpack encoder (or the
    `--release` file) and loaded strictly: the two medians and the fps, K1
    and K2 a search, and the model's predictor on the card against the
    plain CPU path on the first 16 frames (TF32 off, exact kNN); (d)
    `scripts/train_droid_ft_torch.py`, 3 steps from (c)'s weights on that
    episode with one evaluation, K1, K2 and K3 counted;
17. a JSON line for the kernels, then the result line.

Needs CUDA; exits non-zero without it. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet) for the bound.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Flagship request shape (as the JAX package's benchmark, `bench.py`).
V, T, H, W, N_QUERIES = 4, 24, 256, 256, 256
ITERS = 4
LEVEL_POINTS = (16384, 4096, 1024, 256)  # V * (H/4/2^l) * (W/4/2^l)
WINDOW = 12

# Launches per forward at that shape: 3 windows x 4 iterations.
K1_PER_FWD = 1 + 3 * ITERS * 3  # feat_init + (level 0, level 1, levels 2-3 batched)
K2_PER_FWD = 3 * ITERS * 4  # one per level
# Per train step: the same forward, and one backward launch for every
# correlation launch. Both inputs of every correlation carry gradient, in
# the first iteration of the first window too: the cloud features come from
# the encoder and the track features start as rows gathered from them. The
# rematerialised transformer re-runs neither the kNN nor the correlation.
K3_PER_STEP = K2_PER_FWD
TRAIN_STEPS = 3

# Large-cloud request: 5 cameras at 720p, cropped to 704 rows (a multiple of
# 32, so every pyramid level halves exactly), 2 windows. Level 0 has 5 * 176
# * 320 = 281600 points, past `knn.FUSED_MAX_POINTS` (262144): the dispatcher
# gives it, and the query features' lookup, to the tiled kernel. Levels 1 to
# 3 (70400, 17600, 4400 points) stay with the fused kernel, one call each.
LARGE_V, LARGE_T, LARGE_H, LARGE_W = 5, 18, 704, 1280
LARGE_POINTS = LARGE_V * (LARGE_H // 4) * (LARGE_W // 4)
LARGE_WINDOWS = 2
LARGE_REQUESTS = 2
K4_PER_LARGE = 1 + LARGE_WINDOWS * ITERS  # feat_init + level 0
K1_PER_LARGE = LARGE_WINDOWS * ITERS * 3  # levels 1, 2, 3
K2_PER_LARGE = LARGE_WINDOWS * ITERS * 4
# Direct entry: every 64th point of one frame's level-0 cloud asks for its 16
# nearest neighbours in that cloud (a neighbourhood query, as an
# initialisation from a fused cloud makes).
DIRECT_STRIDE, DIRECT_K = 64, 16
PLAIN_LARGE_ELEMS = 1 << 27  # distance-matrix elements per chunk of the plain versions on a large cloud
# The large request through the tiled kernel against the same request through
# the fused one: both evaluate the same d^2, so without ties the same tracks.
LARGE_SAME_ATOL = 1e-3

# Evaluation path (phase 9): the medium preset of the release checkpoint,
# window 8 (hop 4) over 12 frames, 3 pyramid levels of k=12 neighbours, 96
# channels. The release protocol: 4 views x 12 frames x 128^2, 32 tracks,
# 3 iterations, levels of 4096, 1024 and 256 points (the two small ones
# share one padded kNN call). The predictor's defaults: a 384x512 resize,
# 5x5 support points per view (32 + 100 queries), 6 iterations, levels of
# 49152, 12288 and 3072 points, each searched alone.
EVAL_T, EVAL_WINDOW, EVAL_HOP, EVAL_K, EVAL_C = 12, 8, 4, 12, 96
PROTOCOL_ITERS, PROTOCOL_QUERIES, PROTOCOL_LEVELS = 3, 32, (4096, 1024, 256)
SERVE_ITERS, SERVE_QUERIES, SERVE_LEVELS = 6, 32 + 4 * 25, (49152, 12288, 3072)
SERVE_TIMED = 4  # held-out scenes timed at the defaults, after one first request
PROTOCOL_ARGV = [
    "--model_size", "medium", "--vis_geom", "--vis_head_hidden", "128", "--fp32", "--views", "4", "--res", "128",
    "--iters", "3", "--grid", "0", "--interp", "128", "--texture_detail", "1.0", "--texture_noise", "1.0",
    "--device", "cuda",
]
# Without --release the medium model gets seeded weights (seed 0, the flow
# head scaled by FLOW_HEAD_GAIN so that tracks move by about 3e-3), and
# scenes of both splits are held against the plain CPU path. Readings on
# the CPU alone (median / p90 / max of |gap|), queries moved by 1e-6 or rgb
# + 1e-3, protocol scenes 55501665, 77702331, 77702336: traj up to 1.0e-6 /
# 1.2e-6 / 2.9e-4, vis 3.1e-7 / 7.9e-6 / 2.2e-3; one request at the
# defaults: traj 1.1e-6 / 5.1e-6 / 6.9e-4, vis 8.6e-6 / 8.1e-5 / 1.6e-3.
SEEDED_SCENES = (("calib", 0), ("heldout", 0))
SEEDED_PLAIN_LIMITS = {"traj": {"median": 1e-5, "p90": 1e-4, "max": 3e-3},
                       "vis": {"median": 1e-4, "p90": 1e-3, "max": 2e-2}}
GOLDEN_DIR = ROOT / "mvtracker_torch" / "evaluation" / "golden"
# The trained model amplifies rounding: most entries agree to fp32 rounding,
# a few tracks drift, and a scene can fork. Readings of |port - JAX| against
# the golden (median / p90 / max): the port's CPU path pooled over the 16
# scenes, traj 2.9e-6 / 2.2e-4 / 1.1e-1, vis 4.5e-4 / 5.2e-3 / 7.3e-2; the
# card, traj 3.8e-6 / 3.4e-4 / 3.4e-1, vis 6.3e-4 / 7.5e-3 / 1.6e-1; the
# JAX package's jitted forward against its own eager one on held-out scene
# 0, traj 7.7e-6 / 6.1e-4 / 5.3e-2. Held-out scene 77702336 forks: on the
# CPU, moving every query by 1e-6 moves its traj by 1.7e-4 / 7.8e-3 /
# 3.4e-1 and its vis by 8.9e-3 / 3.8e-2 / 1.5e-1, and the card lands on the
# other branch (`PERF.md`, PR 4). A fault of the port moves every scene, so
# the limits that catch one are pooled over the 16 scenes. Each lies between
# the card's sound reading and the protocol run on the card with TF32
# convolutions (traj 3.6e-5 / 1.9e-3, vis 3.3e-3 / 1.9e-2) or in bf16 (traj
# 1.1e-4 / 5.0e-3, vis 6.7e-3 / 2.6e-2), which `--release` runs as controls
# that the check must reject. The per-scene limits fit one fork; neither
# control breaks them in any scene.
GOLDEN_POOLED_LIMITS = {"traj": {"median": 1.2e-5, "p90": 8e-4}, "vis": {"median": 1.4e-3, "p90": 1.2e-2}}
GOLDEN_SCENE_LIMITS = {"traj": {"median": 5e-4, "p90": 2e-2, "max": 0.5}, "vis": {"median": 2e-2, "p90": 0.1, "max": 0.3}}
# One request at the predictor's defaults, fp32, kernel path against the
# plain CPU path. This setting is more chaotic still: on the CPU alone,
# queries moved by 1e-6 move held-out scene 0's traj by 1.2e-4 / 4.9e-3 /
# 1.2e-1 and its vis by 3.6e-3 / 2.7e-2 / 2.3e-1, rgb + 1e-3 its vis max to
# 3.1e-1. Limits on the median and the 90th percentile only.
DEFAULTS_PLAIN_LIMITS = {"traj": {"median": 1e-3, "p90": 5e-2}, "vis": {"median": 2e-2, "p90": 0.15}}
# Held-out metrics against the golden's (points of AJ and OA, ATE in its
# own units), and the calibrated threshold must be the same.
METRIC_TOL = 0.1
METRICS = (("average_jaccard", "AJ"), ("occlusion_accuracy", "OA"), ("ate_visible", "ATE"))
PROTOCOL_KEY = "iters3_grid0_interp128"  # the JSON row of the protocol's one setting
# A near tie in the calibration sweep: the best two thresholds closer than
# this in AJ; the run then also reports held-out AJ at the golden's threshold.
NEAR_TIE_AJ = 0.05

# Phase 10: the options. corr_k0=24 widens the medium model's level 0.
K0 = 24
# (a) The migrated corr_k0 model against the uniform model it was warm-
# started from, on the card, held against the same comparison on the CPU
# (run in this script): the two models differ by more than rounding, because
# the position and time embeddings added to the transformer's input are
# sin/cos of frequencies set by the input width (`PERF.md`, PR 5). CPU
# reading, seeded weights, protocol scenes 55501665 and 77702331 (median /
# p90 / max): traj 1.8e-4 / 4.2e-4 / 9.5e-4, vis 2.6e-3 / 6.4e-3 / 1.3e-2.
MIGRATION_MARGIN, MIGRATION_SLACK = 1.5, 1e-5
# (c) The round-4 knobs, kernel path against the plain CPU path, seeded
# weights. The global-match init puts tracks near one cloud point, where a
# small change of the features moves them: on the CPU alone rgb + 1e-3
# moves traj by 3.7e-6 / 1.2e-4 / 4.9e-3 and vis by 3.5e-5 / 4.4e-4 /
# 7.5e-3 on those scenes (queries + 1e-6: traj 3.0e-8 / 9.5e-7 / 3.8e-6).
KNOBS_PLAIN_LIMITS = {"traj": {"median": 2e-5, "p90": 5e-4, "max": 2e-2},
                      "vis": {"median": 2e-4, "p90": 3e-3, "max": 5e-2}}
# With `--release`, the protocol with those knobs against the JAX package's
# outputs (`golden/release_protocol_r4knobs.*`). The trained model with the
# global-match init is far more sensitive than without it: the port's CPU
# path against that golden, pooled over the 16 scenes (median / p90 / max),
# traj 1.9e-4 / 1.1e-2 / 7.8e-1, vis 7.3e-3 / 3.6e-2 / 2.6e-1, every scene's
# p90 1e-2 to 2.4e-2 (traj) and 3.4e-2 to 5.1e-2 (vis); the threshold the
# same and held-out AJ / OA / ATE 17.626 / 77.109 / 139.306 against 17.663 /
# 77.134 / 139.309. Limits at about twice those readings.
KNOBS_GOLDEN_POOLED_LIMITS = {"traj": {"median": 4e-4, "p90": 2e-2}, "vis": {"median": 1.5e-2, "p90": 7e-2}}
KNOBS_GOLDEN_SCENE_LIMITS = {"traj": {"median": 1e-3, "p90": 5e-2, "max": 1.5},
                             "vis": {"median": 3e-2, "p90": 0.1, "max": 0.5}}

# Tolerances of the kernel-vs-plain checks.
KNN_RTOL = 1e-5  # both compute d^2 directly in fp32; only rounding differs
KNN_ATOL = 1e-6
CORR_TOL = {"float32": 1e-4, "bfloat16": 1e-3}  # fp32 sums of 128 products, other order
# Correlation backward: fp32 sums of N(0,1) products in another order than the
# plain version's, values up to a few tens. With a bf16 cloud, d_fvec is rounded
# once to bf16 on each side: nearly equal fp32 sums may round to neighbouring
# bf16 values, one step of at most 2^-7 of the value.
CORR_BWD_ATOL = 1e-4
CORR_BWD_BF16_RTOL = 2.0**-7
# fp32 forward through the kernels vs the plain CPU path (TF32 off).
E2E_TRAJ_MAX, E2E_TRAJ_MEDIAN = 2e-4, 1e-5
E2E_VIS_MAX, E2E_VIS_MEDIAN = 5e-4, 1e-5
# fp32 train step through the kernels vs the plain CPU path (TF32 off):
# relative gap of the loss; per gradient leaf max |gap| over the leaf's
# largest entry, and the relative L2 gap. The encoder's conv weights sit
# behind instance norms that amplify fp32 rounding (cuDNN and the CPU's
# convolutions sum in other orders), so they get their own limit; a conv
# bias in front of an instance norm has a zero gradient and both sides
# return rounding noise, held in absolute size against the step's gradient
# norm.
E2E_LOSS_RTOL = 1e-5
# Readings on an H100: loss 1.3e-7; other leaves 3.6e-4; encoder conv weights
# 6.8e-2 in one channel of `fnet.layer3.0.conv1.weight`, 6.1e-3 in relative
# L2; dead biases 2.0e-9 of the gradient norm.
E2E_GRAD_RTOL, E2E_ENC_GRAD_RTOL, E2E_ENC_GRAD_L2 = 1e-3, 2e-1, 2e-2
E2E_DEAD_BIAS_ATOL = 1e-7
# Gain on the flow head's random weights for phases 4 and 6, so that tracks move
# by about a hundredth of a unit and the check sees the updates. Much more
# and the random model turns chaotic: at gain 30 an rgb change of 1e-3 on
# the plain CPU path alone moves the output by 0.25.
FLOW_HEAD_GAIN = 5.0


def log(msg: str) -> None:
    print(msg, flush=True)


def wrapper_ms(fn, reps: int, warmup: int = 2) -> float:
    """ms per call of `fn` called back to back from Python, CUDA events
    around the loop: the device time or the host's work per call (wrapper,
    ctypes, device guard), whichever paces the loop."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, replays: int = 3) -> float:
    """Device ms per call of `fn`: `reps` calls captured in one CUDA graph,
    the graph replayed `replays` times between CUDA events. A replay needs no
    host work per launch, so this is the kernels' own time, back to back."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_knn(knn_ops, ref, query, k, kernel=None, max_elems=1 << 24):
    """Kernel (`knn_cuda` unless given) vs plain on one input; returns the
    max abs distance error."""
    import torch

    d_k, i_k = (kernel or knn_ops.knn_cuda)(ref, query, k)
    n = ref.shape[1]
    d_p, i_p = knn_ops.knn_plain(ref, query, k + 1 if k < n else k, max_elems=max_elems)
    torch.cuda.synchronize()
    d_pk = d_p[..., :k]
    err = (d_k - d_pk).abs()
    tol = KNN_ATOL + KNN_RTOL * d_pk
    if not bool((err <= tol).all()):
        raise AssertionError(f"knn distances differ: max err {err.max().item():.3e}")
    real = min(k, n)
    # Every returned index really lies at the returned distance.
    rows = torch.gather(ref, 1, i_k[..., :real].reshape(ref.shape[0], -1, 1).expand(-1, -1, 3))
    true_d = (rows.reshape(*i_k[..., :real].shape, 3) - query[:, :, None]).pow(2).sum(-1).clamp_min(1e-12).sqrt()
    if not bool(((true_d - d_k[..., :real]).abs() <= KNN_ATOL + KNN_RTOL * true_d).all()):
        raise AssertionError("knn kernel index does not match its distance")
    if k > n:
        if not bool((d_k[..., n:] > 1e8).all() and (i_k[..., n:] == 0).all()):
            raise AssertionError("knn k > N fill contract broken")
        return float(err[..., :n].max())
    # Neighbour sets equal unless the k-th and (k+1)-th d^2 are within tolerance.
    same = (i_k.sort(-1).values == i_p[..., :k].sort(-1).values).all(-1)
    if k < n:
        d2 = d_p.pow(2)
        near_tie = (d2[..., k] - d2[..., k - 1]) <= 2 * (KNN_ATOL + KNN_RTOL * d2[..., k])
        same = same | near_tie
    if not bool(same.all()):
        raise AssertionError("knn neighbour sets differ beyond ties")
    return float(err.max())


def check_knn_exact(knn_ops, ref, query, k, max_elems=1 << 24):
    """The exact kernel vs its plain version: the indices must agree one for
    one (ties to the lower index); returns the max abs distance error."""
    import torch

    d_k, i_k = knn_ops.knn_exact_cuda(ref, query, k)
    d_p, i_p = knn_ops.knn_exact_plain(ref, query, k, max_elems=max_elems)
    torch.cuda.synchronize()
    if not torch.equal(i_k, i_p):
        raise AssertionError(f"exact knn: {int((i_k != i_p).sum())} indices differ from the stable sort's")
    real = min(k, ref.shape[1])  # ranks past the cloud hold the fill on both sides
    err = (d_k - d_p).abs()[..., :real]
    if not bool((err <= KNN_ATOL + KNN_RTOL * d_p[..., :real]).all()):
        raise AssertionError(f"exact knn distances differ: max err {err.max().item():.3e}")
    if not bool((d_k[..., real:] > 1e8).all()):
        raise AssertionError("exact knn k > N fill contract broken")
    return float(err.max())


def knn_bound(b, n, m, k):
    """Least time for a kNN call: its bytes, or 9 fp32 operations per (query,
    point) pair (3 subtractions, 3 products, 2 sums, 1 compare)."""
    nbytes = (b * n * 3 + b * m * 3) * 4 + b * m * k * (4 + 8)
    return bound(nbytes, 9.0 * b * m * n)


def add_row(st, ms, plain, bnd, by, times):
    st["ms"] += ms * times
    st["plain_ms"] += plain * times
    st["bound_ms"] += bnd * times
    st["by"][by] = st["by"].get(by, 0.0) + bnd * times


def phase_kernels(torch, knn_ops, corr_ops, gen):
    """Phase 2: kernel vs plain at the path shapes; returns per-kernel rows."""
    dev = torch.device("cuda")
    stats = {key: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0, "by": {}}
             for key in ("knn", "corr", "corr_bwd", "knn_tiled", "knn_exact")}

    def cloud(b, n):
        return (torch.rand(b, n, 3, generator=gen, device=dev) * 4 - 2).contiguous()

    def queries(b, m):
        return (torch.randn(b, m, 3, generator=gen, device=dev) * 0.5).contiguous()

    s = WINDOW
    knn_shapes = [  # (label, B, N, M, k, launches per forward)
        ("feat_init", T, LEVEL_POINTS[0], N_QUERIES, 1, 1),
        ("level0", s, LEVEL_POINTS[0], N_QUERIES, 16, 3 * ITERS),
        ("level1", s, LEVEL_POINTS[1], N_QUERIES, 16, 3 * ITERS),
        ("levels2-3", 2 * s, LEVEL_POINTS[2], N_QUERIES, 16, 3 * ITERS),
    ]
    st = stats["knn"]
    for label, b, n, m, k, per_fwd in knn_shapes:
        ref, query = cloud(b, n), queries(b, m)
        st["err"] = max(st["err"], check_knn(knn_ops, ref, query, k))
        ms = device_ms(lambda: knn_ops.knn_cuda(ref, query, k), reps=50)
        host = wrapper_ms(lambda: knn_ops.knn_cuda(ref, query, k), reps=50)
        plain = device_ms(lambda: knn_ops.knn_plain(ref, query, k), reps=5)
        bnd, by = knn_bound(b, n, m, k)
        log(f"K1 knn {label}: B={b} N={n} M={m} k={k} kernel_ms={ms:.5f} wrapper_ms={host:.5f} "
            f"plain_ms={plain:.5f} bound_ms={bnd:.5f} ({by}) launches/forward={per_fwd}")
        add_row(st, ms, plain, bnd, by, per_fwd)
    # Edge cases: fewer points than k, and a scene far from the origin.
    st["err"] = max(st["err"], check_knn(knn_ops, cloud(2, 10), queries(2, 50), 16))
    offset = torch.tensor([100.0, -50.0, 200.0], device=dev)
    far_ref = (torch.randn(1, 400, 3, generator=gen, device=dev) * 0.1 + offset).contiguous()
    far_q = (torch.randn(1, 50, 3, generator=gen, device=dev) * 0.1 + offset).contiguous()
    st["err"] = max(st["err"], check_knn(knn_ops, far_ref, far_q, 8))
    log(f"K1 knn checks passed: max abs distance error {st['err']:.3e} (rtol {KNN_RTOL}, atol {KNN_ATOL})")

    # K4, the tiled kNN, at the shapes the large-cloud request gives it, with
    # the fused kernel's time on the same input beside it.
    st = stats["knn_tiled"]
    big = PLAIN_LARGE_ELEMS
    # The third shape is not on the request's path: the direct entry's call
    # with few queries (phase 8), where the cloud is really split.
    for label, b, k, per_req in (("feat_init", LARGE_T, 1, 1), ("level0", s, 16, LARGE_WINDOWS * ITERS),
                                 ("direct, few queries", 1, DIRECT_K, 0)):
        n, m = LARGE_POINTS, N_QUERIES
        ref, query = cloud(b, n), queries(b, m)
        st["err"] = max(st["err"], check_knn(knn_ops, ref, query, k, knn_ops.knn_tiled_cuda, max_elems=big))
        ms = device_ms(lambda: knn_ops.knn_tiled_cuda(ref, query, k), reps=10)
        host = wrapper_ms(lambda: knn_ops.knn_tiled_cuda(ref, query, k), reps=10)
        fused = device_ms(lambda: knn_ops.knn_cuda(ref, query, k), reps=10)
        # Tens of ms of large PyTorch kernels: timed as called, no graph.
        plain = wrapper_ms(lambda: knn_ops.knn_plain(ref, query, k, max_elems=big), reps=2, warmup=1)
        bnd, by = knn_bound(b, n, m, k)
        resident = knn_ops.tiled_resident_blocks(0, k == 1)
        splits, span = knn_ops.tiled_plan(b, n, m, resident)
        log(f"K4 knn_tiled {label}: B={b} N={n} M={m} k={k} resident_blocks={resident} splits={splits} span={span} "
            f"kernel_ms={ms:.5f} "
            f"wrapper_ms={host:.5f} fused_kernel_ms={fused:.5f} plain_ms={plain:.5f} bound_ms={bnd:.5f} ({by}) "
            f"launches/request={per_req}")
        add_row(st, ms, plain, bnd, by, per_req)
    # Edge cases: few queries and many spans, a cloud that ends inside a
    # tile, fewer points than k.
    for b, n, m, k in ((1, 50000, 37, 16), (2, 2049, 9, 20), (2, 10, 50, 16)):
        st["err"] = max(st["err"], check_knn(knn_ops, cloud(b, n), queries(b, m), k, knn_ops.knn_tiled_cuda))
    log(f"K4 knn_tiled checks passed: max abs distance error {st['err']:.3e} (rtol {KNN_RTOL}, atol {KNN_ATOL})")

    # K5, the exact kNN, at the shape of the direct entry, on a cloud where a
    # third of the points are copies of others and half the queries sit on one.
    st = stats["knn_exact"]
    n, m, k = LARGE_POINTS, LARGE_POINTS // DIRECT_STRIDE, DIRECT_K
    ref = cloud(1, n)
    copies = torch.randint(0, n, (n // 3,), generator=gen, device=dev)
    ref[:, torch.randperm(n, generator=gen, device=dev)[: n // 3]] = ref[:, copies]
    query = queries(1, m)
    query[:, : m // 2] = ref[:, copies[: m // 2]]
    st["err"] = max(st["err"], check_knn_exact(knn_ops, ref, query, k, max_elems=big))
    d_exact = knn_ops.knn_exact_cuda(ref, query, k)[0]
    ties = int((d_exact[..., 1:] == d_exact[..., :-1]).sum())
    if ties == 0:
        raise AssertionError("the exact-kNN check input holds no ties")
    ms = device_ms(lambda: knn_ops.knn_exact_cuda(ref, query, k), reps=5)
    host = wrapper_ms(lambda: knn_ops.knn_exact_cuda(ref, query, k), reps=5)
    fused = device_ms(lambda: knn_ops.knn_cuda(ref, query, k), reps=5)
    plain = wrapper_ms(lambda: knn_ops.knn_exact_plain(ref, query, k, max_elems=big), reps=2, warmup=1)
    bnd, by = knn_bound(1, n, m, k)
    log(f"K5 knn_exact direct: B=1 N={n} M={m} k={k} ({ties} tied neighbour pairs) kernel_ms={ms:.5f} "
        f"wrapper_ms={host:.5f} fused_kernel_ms={fused:.5f} plain_ms={plain:.5f} bound_ms={bnd:.5f} ({by}) "
        f"launches/call=1")
    add_row(st, ms, plain, bnd, by, 1)
    for b, n, m, k in ((2, 4099, 33, 1), (2, 700, 17, 32), (2, 6, 11, 8)):
        small = torch.round(cloud(b, n) * 2)  # a lattice: most distances tie
        st["err"] = max(st["err"], check_knn_exact(knn_ops, small, torch.round(queries(b, m) * 2), k))
    log(f"K5 knn_exact checks passed: indices equal the stable sort's; max abs distance error {st['err']:.3e}")

    st = stats["corr"]
    c = 128
    level_idx = []
    for lvl, p in enumerate(LEVEL_POINTS):
        xyz, q = cloud(s, p), queries(s, N_QUERIES)
        _, idx = knn_ops.knn_plain(xyz, q, 16)
        level_idx.append(idx)
        for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            fvec = torch.randn(s, p, c, generator=gen, device=dev).to(dt)
            # The path's track features are fp32 in both models; with a bf16
            # cloud the kernel rounds them to bf16 as they load.
            targets = torch.randn(s, N_QUERIES, c, generator=gen, device=dev)
            idx_t = idx.clone()
            if lvl == 0 and dt_name == "float32":
                idx_t[:, :, -1] = -1  # padding index gives 0
            got = corr_ops.corr_select_cuda(fvec, targets, idx_t)
            want = corr_ops.corr_select_plain(fvec, targets, idx_t)
            err = float((got - want).abs().max())
            if err > CORR_TOL[dt_name]:
                raise AssertionError(f"corr level {lvl} {dt_name}: max err {err:.3e} > {CORR_TOL[dt_name]}")
            if not (torch.equal(corr_ops.corr_select_cuda(fvec, targets, idx_t), got)
                    and torch.equal(corr_ops.corr_select_cuda(fvec, targets.to(dt), idx_t), got)):
                raise AssertionError(f"corr level {lvl} {dt_name}: a second run, or targets cast first, differ")
            st["err"] = max(st["err"], err)
            if dt_name != "bfloat16":
                continue  # the path streams a bf16 cloud; time that
            ms = device_ms(lambda: corr_ops.corr_select_cuda(fvec, targets, idx), reps=100)
            host = wrapper_ms(lambda: corr_ops.corr_select_cuda(fvec, targets, idx), reps=100)
            plain = device_ms(lambda: corr_ops.corr_select_plain(fvec, targets, idx), reps=20)
            rows = sum(int(torch.unique(idx[b]).numel()) for b in range(s))
            # Bytes: the distinct rows (bf16), the targets at the fp32 width the
            # kernel reads them, the int64 indices and the fp32 output.
            nbytes = rows * c * 2 + targets.numel() * 4 + idx.numel() * 8 + idx.numel() * 4
            bnd, by = bound(nbytes, 2.0 * idx.numel() * c)
            per_fwd = 3 * ITERS
            log(f"K2 corr level{lvl}: fvec=[{s},{p},{c}] bf16 targets fp32 idx=[{s},{N_QUERIES},16] "
                f"kernel_ms={ms:.5f} wrapper_ms={host:.5f} plain_ms={plain:.5f} bound_ms={bnd:.5f} ({by}, {rows} "
                f"distinct rows, targets counted at fp32) launches/forward={per_fwd}")
            add_row(st, ms, plain, bnd, by, per_fwd)
    log(f"K2 corr checks passed: max abs error {st['err']:.3e} (tol {CORR_TOL}); a second run and targets cast "
        f"first give the same bits")

    # K3, the correlation backward, at the shapes a train step gives it: the
    # uncast residuals (bf16 cloud, fp32 track features) and an fp32 gradient.
    st = stats["corr_bwd"]
    for lvl, (p, idx) in enumerate(zip(LEVEL_POINTS, level_idx)):
        targets = torch.randn(s, N_QUERIES, c, generator=gen, device=dev)
        g = torch.randn(s, N_QUERIES, 16, generator=gen, device=dev)
        for dt_name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            fvec = torch.randn(s, p, c, generator=gen, device=dev).to(dt)
            idx_t = idx.clone()
            if lvl == 0 and dt_name == "float32":
                idx_t[:, :, -1] = -1  # padding index adds nothing
                idx_t[:, :, -2] = p  # nor does one past the cloud
            d_fvec, d_targets = corr_ops.corr_select_backward_cuda(fvec, targets, idx_t, g)
            again_fvec, again_targets = corr_ops.corr_select_backward_cuda(fvec, targets, idx_t, g)
            want_fvec, want_targets = corr_ops.corr_select_backward_plain(fvec, targets, idx_t, g)
            torch.cuda.synchronize()
            if d_fvec.dtype != dt or d_targets.dtype != torch.float32:
                raise AssertionError(f"corr backward level {lvl}: gradient dtypes {d_fvec.dtype}, {d_targets.dtype}")
            err_t = float((d_targets - want_targets).abs().max())
            gap_f = (d_fvec.float() - want_fvec.float()).abs()
            if dt_name == "float32":
                err_f = float(gap_f.max())
                ok = err_f <= CORR_BWD_ATOL
                st["err"] = max(st["err"], err_f)
            else:  # one bf16 rounding step apart at most
                err_f = float(gap_f.max())
                ok = bool((gap_f <= CORR_BWD_BF16_RTOL * want_fvec.float().abs() + CORR_BWD_ATOL).all())
            if not (ok and err_t <= CORR_BWD_ATOL):
                raise AssertionError(f"corr backward level {lvl} {dt_name}: d_fvec err {err_f:.3e}, d_targets err {err_t:.3e}")
            st["err"] = max(st["err"], err_t)
            # Both gradients are summed in a fixed order.
            if not (torch.equal(again_fvec, d_fvec) and torch.equal(again_targets, d_targets)):
                raise AssertionError(f"corr backward level {lvl} {dt_name}: two runs on one input differ")
            log(f"K3 corr_bwd level{lvl} {dt_name}: d_targets max err {err_t:.3e}, d_fvec max err {err_f:.3e} "
                f"(values up to {float(want_fvec.float().abs().max()):.1f}), two runs give the same bits")
            if dt_name != "bfloat16":
                continue  # the path's residuals are a bf16 cloud and fp32 targets; time that
            ms = device_ms(lambda: corr_ops.corr_select_backward_cuda(fvec, targets, idx, g), reps=50)
            host = wrapper_ms(lambda: corr_ops.corr_select_backward_cuda(fvec, targets, idx, g), reps=50)
            plain = device_ms(lambda: corr_ops.corr_select_backward_plain(fvec, targets, idx, g), reps=10)
            rows = sum(int(torch.unique(idx[b]).numel()) for b in range(s))
            nbytes = (rows * c * 2 + g.numel() * 4 + idx.numel() * 8 + targets.numel() * 4
                      + fvec.numel() * 2 + targets.numel() * 4)  # reads, then the dense d_fvec and d_targets
            bnd, by = bound(nbytes, 4.0 * idx.numel() * c)
            per_step = 3 * ITERS
            log(f"K3 corr_bwd level{lvl}: fvec=[{s},{p},{c}] bf16 targets fp32 g=[{s},{N_QUERIES},16] "
                f"function_ms={ms:.5f} wrapper_ms={host:.5f} "
                f"plain_ms={plain:.5f} bound_ms={bnd:.5f} ({by}, {rows} distinct rows) launches/step={per_step}")
            add_row(st, ms, plain, bnd, by, per_step)
    log(f"K3 corr_bwd checks passed: max abs error {st['err']:.3e} in fp32 (tol {CORR_BWD_ATOL}; a bf16 d_fvec "
        f"within one bf16 step); two runs on one input give the same bits")
    return stats


def phase_kernels_evaluation(torch, knn_ops, corr_ops, gen, stats):
    """Phase 2, continued: K1 and K2 at the shapes the evaluation path gives
    them (medium model; the release protocol in fp32, the predictor's
    defaults in bf16 and fp32), against their plain versions, with times
    and bounds per shape. Adds the errors to `stats`; launches per request
    assume 2 windows (every query of the protocol's scenes starts before
    frame 3)."""
    dev = torch.device("cuda")

    def cloud(b, n):
        return (torch.rand(b, n, 3, generator=gen, device=dev) * 4 - 2).contiguous()

    def queries(b, m):
        return (torch.randn(b, m, 3, generator=gen, device=dev) * 0.5).contiguous()

    s, k, c = EVAL_WINDOW, EVAL_K, EVAL_C
    windows = 2
    knn_shapes = [  # (label, B, N, M, k, launches per request)
        ("protocol feat_init", EVAL_T, PROTOCOL_LEVELS[0], PROTOCOL_QUERIES, 1, 1),
        ("protocol level0", s, PROTOCOL_LEVELS[0], PROTOCOL_QUERIES, k, windows * PROTOCOL_ITERS),
        ("protocol levels1-2", 2 * s, PROTOCOL_LEVELS[1], PROTOCOL_QUERIES, k, windows * PROTOCOL_ITERS),
        ("defaults feat_init", EVAL_T, SERVE_LEVELS[0], SERVE_QUERIES, 1, 1),
        ("defaults level0", s, SERVE_LEVELS[0], SERVE_QUERIES, k, windows * SERVE_ITERS),
        ("defaults level1", s, SERVE_LEVELS[1], SERVE_QUERIES, k, windows * SERVE_ITERS),
        ("defaults level2", s, SERVE_LEVELS[2], SERVE_QUERIES, k, windows * SERVE_ITERS),
    ]
    st = stats["knn"]
    for label, b, n, m, kk, per_req in knn_shapes:
        ref, query = cloud(b, n), queries(b, m)
        st["err"] = max(st["err"], check_knn(knn_ops, ref, query, kk))
        ms = device_ms(lambda: knn_ops.knn_cuda(ref, query, kk), reps=50)
        host = wrapper_ms(lambda: knn_ops.knn_cuda(ref, query, kk), reps=50)
        plain = device_ms(lambda: knn_ops.knn_plain(ref, query, kk), reps=5)
        bnd, by = knn_bound(b, n, m, kk)
        log(f"K1 knn evaluation {label}: B={b} N={n} M={m} k={kk} kernel_ms={ms:.5f} wrapper_ms={host:.5f} "
            f"plain_ms={plain:.5f} bound_ms={bnd:.5f} ({by}) launches/request={per_req}")
    log(f"K1 knn evaluation shapes passed: max abs distance error {st['err']:.3e}")

    st = stats["corr"]
    corr_shapes = [  # (label, P, N, fvec dtype, targets dtype, launches per request)
        *((f"protocol level{lvl}", p, PROTOCOL_QUERIES, torch.float32, torch.float32, windows * PROTOCOL_ITERS)
          for lvl, p in enumerate(PROTOCOL_LEVELS)),
        *((f"defaults level{lvl} {name}", p, SERVE_QUERIES, dt, torch.float32, windows * SERVE_ITERS)
          for lvl, p in enumerate(SERVE_LEVELS) for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32))),
    ]
    for label, p, n, dt, tdt, per_req in corr_shapes:
        xyz, q = cloud(s, p), queries(s, n)
        idx = knn_ops.knn_plain(xyz, q, k)[1]
        fvec = torch.randn(s, p, c, generator=gen, device=dev).to(dt)
        targets = torch.randn(s, n, c, generator=gen, device=dev).to(tdt)
        got = corr_ops.corr_select_cuda(fvec, targets, idx)
        want = corr_ops.corr_select_plain(fvec, targets, idx)
        tol = CORR_TOL["bfloat16" if dt == torch.bfloat16 else "float32"]
        err = float((got - want).abs().max())
        if err > tol or not torch.equal(corr_ops.corr_select_cuda(fvec, targets, idx), got):
            raise AssertionError(f"corr evaluation {label}: max err {err:.3e} (tol {tol}), or a second run differs")
        st["err"] = max(st["err"], err)
        ms = device_ms(lambda: corr_ops.corr_select_cuda(fvec, targets, idx), reps=100)
        host = wrapper_ms(lambda: corr_ops.corr_select_cuda(fvec, targets, idx), reps=100)
        plain = device_ms(lambda: corr_ops.corr_select_plain(fvec, targets, idx), reps=20)
        rows = sum(int(torch.unique(idx[b]).numel()) for b in range(s))
        nbytes = rows * c * fvec.element_size() + targets.numel() * 4 + idx.numel() * 8 + idx.numel() * 4
        bnd, by = bound(nbytes, 2.0 * idx.numel() * c)
        log(f"K2 corr evaluation {label}: fvec=[{s},{p},{c}] {str(dt)[6:]} targets fp32 idx=[{s},{n},{k}] "
            f"kernel_ms={ms:.5f} wrapper_ms={host:.5f} plain_ms={plain:.5f} bound_ms={bnd:.5f} ({by}, {rows} "
            f"distinct rows) launches/request={per_req}")
    log(f"K2 corr evaluation shapes passed: max abs error {st['err']:.3e}; a second run gives the same bits")


def phase_kernels_options(torch, knn_ops, corr_ops, gen, stats):
    """Phase 2, continued: the shapes the tracker's options give the kernels,
    against their plain versions with times and bounds per shape. corr_k0=24
    on the medium model: K1 and K2 at k=24 on level 0 of the release
    protocol and of the predictor's defaults, K3 at K=24 on the protocol's
    training level 0; `corr_filter_invalid_depth`: K1 (and K5) on a cloud
    with half its points and one whole frame at the 1e9 sentinel. Adds the
    errors to `stats`."""
    dev = torch.device("cuda")

    def cloud(b, n):
        return (torch.rand(b, n, 3, generator=gen, device=dev) * 4 - 2).contiguous()

    def queries(b, m):
        return (torch.randn(b, m, 3, generator=gen, device=dev) * 0.5).contiguous()

    s, k, c = EVAL_WINDOW, K0, EVAL_C
    windows = 2
    sentinel = cloud(s, PROTOCOL_LEVELS[0])
    sentinel[:, torch.randperm(PROTOCOL_LEVELS[0], generator=gen, device=dev)[: PROTOCOL_LEVELS[0] // 2]] = 1e9
    sentinel[3] = 1e9  # a frame with no valid depth
    knn_shapes = [  # (label, ref, M, k, launches per request or step)
        ("protocol level0", cloud(s, PROTOCOL_LEVELS[0]), PROTOCOL_QUERIES, k, windows * PROTOCOL_ITERS),
        ("defaults level0", cloud(s, SERVE_LEVELS[0]), SERVE_QUERIES, k, windows * SERVE_ITERS),
        ("protocol level0, sentinel cloud", sentinel, PROTOCOL_QUERIES, k, 0),
        ("protocol level0, sentinel cloud", sentinel, PROTOCOL_QUERIES, EVAL_K, 0),
    ]
    st = stats["knn"]
    for label, ref, m, kk, per_req in knn_shapes:
        b, n = ref.shape[:2]
        query = queries(b, m)
        st["err"] = max(st["err"], check_knn(knn_ops, ref, query, kk))
        if label.endswith("sentinel cloud"):
            # Ties decide there: the exact kernel's indices equal the stable sort's.
            stats["knn_exact"]["err"] = max(stats["knn_exact"]["err"], check_knn_exact(knn_ops, ref, query, kk))
            d = knn_ops.knn_cuda(ref, query, kk)[0]
            if not (bool((d[3] > 1e8).all()) and bool((d[:3] < 1e8).all())):
                raise AssertionError("knn on the sentinel cloud: real points do not come first")
        ms = device_ms(lambda: knn_ops.knn_cuda(ref, query, kk), reps=50)
        host = wrapper_ms(lambda: knn_ops.knn_cuda(ref, query, kk), reps=50)
        plain = device_ms(lambda: knn_ops.knn_plain(ref, query, kk), reps=5)
        bnd, by = knn_bound(b, n, m, kk)
        log(f"K1 knn options {label}: B={b} N={n} M={m} k={kk} kernel_ms={ms:.5f} wrapper_ms={host:.5f} "
            f"plain_ms={plain:.5f} bound_ms={bnd:.5f} ({by}) launches/request={per_req}")
    log(f"K1 knn option shapes passed: max abs distance error {st['err']:.3e}; on the sentinel cloud the exact "
        f"kernel's indices equal the stable sort's")

    st = stats["corr"]
    for label, p, n, per_req in (("protocol level0", PROTOCOL_LEVELS[0], PROTOCOL_QUERIES, windows * PROTOCOL_ITERS),
                                 ("defaults level0", SERVE_LEVELS[0], SERVE_QUERIES, windows * SERVE_ITERS)):
        xyz, q = cloud(s, p), queries(s, n)
        idx = knn_ops.knn_plain(xyz, q, k)[1]
        for dt_name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            fvec = torch.randn(s, p, c, generator=gen, device=dev).to(dt)
            targets = torch.randn(s, n, c, generator=gen, device=dev)
            got = corr_ops.corr_select_cuda(fvec, targets, idx)
            want = corr_ops.corr_select_plain(fvec, targets, idx)
            tol = CORR_TOL["bfloat16" if dt == torch.bfloat16 else "float32"]
            err = float((got - want).abs().max())
            if err > tol or not (torch.equal(corr_ops.corr_select_cuda(fvec, targets, idx), got)
                                 and torch.equal(corr_ops.corr_select_cuda(fvec, targets.to(dt), idx), got)):
                raise AssertionError(f"corr K={k} {label} {dt_name}: max err {err:.3e} (tol {tol}), or a second run "
                                     "or targets cast first differ")
            st["err"] = max(st["err"], err)
            ms = device_ms(lambda: corr_ops.corr_select_cuda(fvec, targets, idx), reps=100)
            host = wrapper_ms(lambda: corr_ops.corr_select_cuda(fvec, targets, idx), reps=100)
            plain = device_ms(lambda: corr_ops.corr_select_plain(fvec, targets, idx), reps=20)
            rows = sum(int(torch.unique(idx[b]).numel()) for b in range(s))
            nbytes = rows * c * fvec.element_size() + targets.numel() * 4 + idx.numel() * 8 + idx.numel() * 4
            bnd, by = bound(nbytes, 2.0 * idx.numel() * c)
            log(f"K2 corr options {label} {dt_name}: fvec=[{s},{p},{c}] targets fp32 idx=[{s},{n},{k}] "
                f"kernel_ms={ms:.5f} wrapper_ms={host:.5f} plain_ms={plain:.5f} bound_ms={bnd:.5f} ({by}, {rows} "
                f"distinct rows) launches/request={per_req}; a second run and targets cast first give the same bits")

    st = stats["corr_bwd"]
    p, n = PROTOCOL_LEVELS[0], PROTOCOL_QUERIES
    xyz, q = cloud(s, p), queries(s, n)
    idx = knn_ops.knn_plain(xyz, q, k)[1]
    targets = torch.randn(s, n, c, generator=gen, device=dev)
    g = torch.randn(s, n, k, generator=gen, device=dev)
    for dt_name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        fvec = torch.randn(s, p, c, generator=gen, device=dev).to(dt)
        d_fvec, d_targets = corr_ops.corr_select_backward_cuda(fvec, targets, idx, g)
        again_fvec, again_targets = corr_ops.corr_select_backward_cuda(fvec, targets, idx, g)
        want_fvec, want_targets = corr_ops.corr_select_backward_plain(fvec, targets, idx, g)
        gap_f = (d_fvec.float() - want_fvec.float()).abs()
        err_t = float((d_targets - want_targets).abs().max())
        if dt_name == "fp32":
            ok = float(gap_f.max()) <= CORR_BWD_ATOL
            st["err"] = max(st["err"], float(gap_f.max()))
        else:
            ok = bool((gap_f <= CORR_BWD_BF16_RTOL * want_fvec.float().abs() + CORR_BWD_ATOL).all())
        if not (ok and err_t <= CORR_BWD_ATOL):
            raise AssertionError(f"corr backward K={k} {dt_name}: d_fvec err {float(gap_f.max()):.3e}, d_targets "
                                 f"err {err_t:.3e}")
        if not (torch.equal(again_fvec, d_fvec) and torch.equal(again_targets, d_targets)):
            raise AssertionError(f"corr backward K={k} {dt_name}: two runs on one input differ")
        st["err"] = max(st["err"], err_t)
        ms = device_ms(lambda: corr_ops.corr_select_backward_cuda(fvec, targets, idx, g), reps=50)
        host = wrapper_ms(lambda: corr_ops.corr_select_backward_cuda(fvec, targets, idx, g), reps=50)
        plain = device_ms(lambda: corr_ops.corr_select_backward_plain(fvec, targets, idx, g), reps=10)
        rows = sum(int(torch.unique(idx[b]).numel()) for b in range(s))
        nbytes = (rows * c * fvec.element_size() + g.numel() * 4 + idx.numel() * 8 + targets.numel() * 4
                  + fvec.numel() * fvec.element_size() + targets.numel() * 4)
        bnd, by = bound(nbytes, 4.0 * idx.numel() * c)
        log(f"K3 corr_bwd options protocol training level0 {dt_name}: fvec=[{s},{p},{c}] targets fp32 g=[{s},{n},{k}] "
            f"function_ms={ms:.5f} wrapper_ms={host:.5f} plain_ms={plain:.5f} bound_ms={bnd:.5f} ({by}, {rows} "
            f"distinct rows) d_fvec max err {float(gap_f.max()):.3e}, d_targets {err_t:.3e}; two runs give the same "
            f"bits; launches/step={windows * PROTOCOL_ITERS}")


def to_device(scene, dev):
    import torch

    return [torch.as_tensor(a, device=dev) for a in scene]


def phase_main_path(torch, MVTracker, random_state_dict, make_scene, knn_ops, corr_ops):
    """Phase 3: 3 flagship-width bf16 requests; returns launch totals."""
    dev = torch.device("cuda")
    before = torch.cuda.memory_allocated()
    model = MVTracker(compute_dtype="bfloat16", device=dev).eval()
    model.load_state_dict(random_state_dict(model, seed=0))
    scenes = [to_device(make_scene(np.random.default_rng(seed), V, T, H, W, N_QUERIES), dev) for seed in range(3)]
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    log(f"allocated before the model {before / 2**20:.1f} MiB; with weights and 3 scenes {resident / 2**20:.1f} MiB")
    torch.cuda.reset_peak_memory_stats()
    knn_ops.knn_cuda.launches = 0
    corr_ops.corr_select_cuda.launches = 0
    times = []
    for seed, scene in enumerate(scenes):
        k1, k2 = knn_ops.knn_cuda.launches, corr_ops.corr_select_cuda.launches
        t0 = time.perf_counter()
        out = model(*scene, iters=ITERS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        traj, vis = out["traj"], out["vis"]
        if traj.shape != (T, N_QUERIES, 3) or vis.shape != (T, N_QUERIES):
            raise AssertionError(f"bad output shapes {tuple(traj.shape)}, {tuple(vis.shape)}")
        if not (bool(torch.isfinite(traj).all()) and bool(torch.isfinite(vis).all())):
            raise AssertionError("non-finite outputs")
        d1 = knn_ops.knn_cuda.launches - k1
        d2 = corr_ops.corr_select_cuda.launches - k2
        if (d1, d2) != (K1_PER_FWD, K2_PER_FWD):
            raise AssertionError(f"request {seed}: {d1} kNN and {d2} corr launches, want {K1_PER_FWD} and {K2_PER_FWD}")
        log(f"request {seed}: {times[-1]:.2f} ms, kNN launches {d1}, corr launches {d2}")
    launches = {"knn": knn_ops.knn_cuda.launches, "corr": corr_ops.corr_select_cuda.launches}
    log(f"main path: {V} views x {T} frames x {H}x{W}, {N_QUERIES} queries, bf16, iters {ITERS}: "
        f"ms per request {[round(x, 2) for x in times]}, median {sorted(times)[1]:.2f}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
        f"({(torch.cuda.max_memory_allocated() - resident) / 2**20:.1f} MiB above the resident weights and scenes)")
    return launches


def phase_end_to_end(torch, MVTracker, random_state_dict, make_scene, knn_ops):
    """Phase 4: fp32 forward through the kernels vs the plain CPU path, once
    for each kNN backend."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = MVTracker(device="cuda").eval()
    sd = random_state_dict(model, seed=1)
    for name in sd:
        if name.startswith("updateformer.flow_head.") and name.endswith("weight"):
            sd[name] = sd[name] * FLOW_HEAD_GAIN
    model.load_state_dict(sd)
    scene = make_scene(np.random.default_rng(3), 2, 18, 96, 96, 48)
    cpu_model = copy.deepcopy(model).cpu()
    out_cpu = cpu_model(*to_device(scene, torch.device("cpu")), iters=ITERS)
    counters = {"fused": knn_ops.knn_cuda, "tiled": knn_ops.knn_tiled_cuda, "exact": knn_ops.knn_exact_cuda}
    for backend, counter in counters.items():
        model.knn_backend = backend
        before = {name: fn.launches for name, fn in counters.items()}
        out_gpu = model(*to_device(scene, torch.device("cuda")), iters=ITERS)
        made = {name: fn.launches - before[name] for name, fn in counters.items()}
        if not (made[backend] > 0 and sum(made.values()) == made[backend]):
            raise AssertionError(f"knn_backend={backend}: kNN launches {made}")
        for key, (tmax, tmed) in (("traj", (E2E_TRAJ_MAX, E2E_TRAJ_MEDIAN)), ("vis", (E2E_VIS_MAX, E2E_VIS_MEDIAN))):
            gap = (out_gpu[key].cpu() - out_cpu[key]).abs()
            log(f"end to end fp32 (2 views x 18 frames x 96x96, 48 queries), kernel path with the {backend} kNN "
                f"({made[backend]} launches) vs plain CPU path: {key} max gap {float(gap.max()):.3e} (limit {tmax}), "
                f"median {float(gap.median()):.3e} (limit {tmed})")
            if not (float(gap.max()) <= tmax and float(gap.median()) <= tmed):
                raise AssertionError(f"end-to-end {key} gap too large with the {backend} kNN")
    moved = (out_cpu["traj"] - torch.as_tensor(scene[2][None, :, 1:])).abs()[out_cpu["vis"] > 0]
    log(f"end to end: tracks moved by median {float(moved.median()):.3e} from their queries")


def leaf_kind(name: str) -> str:
    """How a gradient leaf is held in phase 6: "dead" for a conv bias in
    front of an instance norm, "encoder" for the encoder's other conv
    weights, "plain" for the rest."""
    if not name.startswith("fnet.") or name.startswith(("fnet.conv2.weight", "fnet.conv3.")):
        return "plain"
    return "dead" if name.endswith(".bias") else "encoder"


def phase_train_path(torch, smi, MVTracker, random_state_dict, make_scene, knn_ops, corr_ops):
    """Phase 5: 3 flagship-width bf16 train steps through `Trainer.fit`;
    returns the launch totals."""
    from mvtracker_torch.training import step as step_lib
    from mvtracker_torch.training.train import TrainConfig, Trainer

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    model = MVTracker(compute_dtype="bfloat16", remat=True, remat_encoder=False, device=dev)
    model.load_state_dict(random_state_dict(model, seed=0))
    rng = np.random.default_rng(0)
    scene = make_scene(rng, V, T, H, W, N_QUERIES)
    batch = {
        "rgbs": scene[0][None], "depths": scene[1][None], "query_points": scene[2][None],
        "intrs": scene[3][None], "extrs": scene[4][None],
        "traj_gt": rng.normal(size=(1, T, N_QUERIES, 3)).astype(np.float32),
        "vis_gt": np.ones((1, T, N_QUERIES), np.float32),
        "valid": np.ones((1, T, N_QUERIES), np.float32),
    }
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def same_batch():
        while True:
            yield batch

    with tempfile.TemporaryDirectory() as exp_dir:
        cfg = TrainConfig(train_iters=ITERS, adaptive_iters=False, exp_dir=exp_dir)
        trainer = Trainer(model, cfg)
        state = step_lib.init_state(model, trainer.optimizer)
        start = {name: p.detach().cpu().clone() for name, p in model.named_parameters()}
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        steps = []

        def counters():
            return (knn_ops.knn_cuda.launches, corr_ops.corr_select_cuda.launches,
                    corr_ops.corr_select_backward_cuda.launches)

        def on_step(step, metrics):
            # Called by the trainer after every step: what the step launched
            # and how long it took since the last call, device work included.
            torch.cuda.synchronize()
            now = time.perf_counter()
            made = tuple(n - was for was, n in zip(last["counts"], counters()))
            steps.append(((now - last["time"]) * 1e3, made, {k: float(v) for k, v in metrics.items()}))
            last.update(time=time.perf_counter(), counts=counters())

        knn_ops.knn_cuda.launches = 0
        corr_ops.corr_select_cuda.launches = 0
        corr_ops.corr_select_backward_cuda.launches = 0
        last = {"time": time.perf_counter(), "counts": counters()}
        state = trainer.fit(same_batch(), state=state, max_steps=TRAIN_STEPS, on_step=on_step)
        launches = {"knn": knn_ops.knn_cuda.launches, "corr": corr_ops.corr_select_cuda.launches,
                    "corr_bwd": corr_ops.corr_select_backward_cuda.launches}
        peak = torch.cuda.max_memory_allocated()

    if state.step != TRAIN_STEPS or len(steps) != TRAIN_STEPS:
        raise AssertionError(f"the trainer took {state.step} steps, want {TRAIN_STEPS}")
    want = (K1_PER_FWD, K2_PER_FWD, K3_PER_STEP)
    for i, (ms, counts, metrics) in enumerate(steps):
        if counts != want:
            raise AssertionError(f"train step {i}: (kNN, corr, corr backward) launches {counts}, want {want}")
        if not all(np.isfinite(v) for v in metrics.values()) or not metrics["grad_norm"] > 0:
            raise AssertionError(f"train step {i}: metrics {metrics}")
        log(f"train step {i}: {ms:.2f} ms, loss {metrics['loss']:.6f} (xyz {metrics['xyz_loss']:.6f}, vis "
            f"{metrics['vis_loss']:.6f}), grad_norm {metrics['grad_norm']:.4f}, reproj_dev {metrics['reproj_dev']:.3e}, "
            f"launches kNN/corr/corr_bwd {counts} [{smi}]")
    moved = [name for name, p in model.named_parameters() if not torch.equal(p.detach().cpu(), start[name])]
    if len(moved) != len(start):
        raise AssertionError(f"only {len(moved)} of {len(start)} parameter tensors changed")
    if not all(bool(torch.isfinite(p).all()) for p in model.parameters()):
        raise AssertionError("non-finite parameters after the train steps")
    warm = [ms for ms, _, _ in steps[1:]]
    log(f"training path: 1 scene of {V} views x {T} frames x {H}x{W}, {N_QUERIES} queries, bf16, iters {ITERS}, "
        f"remat=True remat_encoder=False: first step {steps[0][0]:.2f} ms, later steps "
        f"{[round(x, 2) for x in warm]} ms [{smi}]")
    log(f"training memory: resident {(resident - before) / 2**20:.1f} MiB (weights, AdamW state, batch), "
        f"max_memory_allocated {peak / 2**20:.1f} MiB, per step {(peak - resident) / 2**20:.1f} MiB above "
        f"the resident set [{smi}]")
    return launches


def phase_train_end_to_end(torch, MVTracker, random_state_dict, make_scene, corr_ops):
    """Phase 6: fp32 train step (loss and gradients) through the kernels vs
    the plain CPU path."""
    from mvtracker_torch.training import step as step_lib

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = MVTracker(device="cuda")
    sd = random_state_dict(model, seed=1)
    for name in sd:
        if name.startswith("updateformer.flow_head.") and name.endswith("weight"):
            sd[name] = sd[name] * FLOW_HEAD_GAIN
    model.load_state_dict(sd)
    rng = np.random.default_rng(3)
    t, n = 18, 48
    arrays = make_scene(rng, 2, t, 96, 96, n)
    scene = dict(zip(("rgbs", "depths", "query_points", "intrs", "extrs"), arrays))
    scene["traj_gt"] = (arrays[2][None, :, 1:] + rng.normal(size=(t, n, 3)) * 0.1).astype(np.float32)
    scene["vis_gt"] = (rng.random((t, n)) > 0.3).astype(np.float32)
    scene["valid"] = np.ones((t, n), np.float32)
    cpu_model = copy.deepcopy(model).cpu()

    results = {}
    for tag, m in (("gpu", model), ("cpu", cpu_model)):
        before = corr_ops.corr_select_backward_cuda.launches
        total, parts = step_lib.scene_loss(m, scene, ITERS, 0.8, 0.1)
        total.backward()
        used = corr_ops.corr_select_backward_cuda.launches - before
        if (tag == "gpu") != (used > 0):
            raise AssertionError(f"{tag} path made {used} correlation backward launches")
        results[tag] = (float(total.detach()), {k: float(v.detach()) for k, v in parts.items()},
                        {name: p.grad.detach().cpu() for name, p in m.named_parameters()})
    (loss_g, parts_g, grads_g), (loss_c, parts_c, grads_c) = results["gpu"], results["cpu"]
    loss_gap = abs(loss_g - loss_c) / abs(loss_c)
    log(f"train step end to end fp32 (2 views x 18 frames x 96x96, 48 queries), kernel path vs plain CPU path: "
        f"loss {loss_g:.7f} vs {loss_c:.7f}, relative gap {loss_gap:.3e} (limit {E2E_LOSS_RTOL}); "
        f"xyz {parts_g['xyz_loss']:.7f} vs {parts_c['xyz_loss']:.7f}, vis {parts_g['vis_loss']:.7f} vs {parts_c['vis_loss']:.7f}")
    if not loss_gap <= E2E_LOSS_RTOL:
        raise AssertionError("end-to-end loss gap too large")
    grad_norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads_c.values())))
    worst = {"plain": (0.0, ""), "encoder": (0.0, ""), "encoder_l2": (0.0, ""), "dead": (0.0, "")}
    for name, want in grads_c.items():
        gap = (grads_g[name] - want).abs()
        kind = leaf_kind(name)
        if kind == "dead":
            worst["dead"] = max(worst["dead"], (float(gap.max()) / grad_norm, name))
            continue
        if not float(want.abs().max()) > 0:
            raise AssertionError(f"gradient leaf {name} is all zero")
        worst[kind] = max(worst[kind], (float(gap.max() / want.abs().max()), name))
        if kind == "encoder":
            worst["encoder_l2"] = max(worst["encoder_l2"], (float(gap.norm() / want.norm()), name))
    log(f"train step end to end: {len(grads_c)} gradient leaves, gradient norm {grad_norm:.4f}; worst max-gap over "
        f"the leaf's largest entry {worst['plain'][0]:.3e} at {worst['plain'][1]} (limit {E2E_GRAD_RTOL}); encoder conv "
        f"weights {worst['encoder'][0]:.3e} at {worst['encoder'][1]} (limit {E2E_ENC_GRAD_RTOL}), their worst relative "
        f"L2 gap {worst['encoder_l2'][0]:.3e} at {worst['encoder_l2'][1]} (limit {E2E_ENC_GRAD_L2}); zero-gradient "
        f"conv biases {worst['dead'][0]:.3e} of the gradient norm (limit {E2E_DEAD_BIAS_ATOL})")
    if not (worst["plain"][0] <= E2E_GRAD_RTOL and worst["encoder"][0] <= E2E_ENC_GRAD_RTOL
            and worst["encoder_l2"][0] <= E2E_ENC_GRAD_L2 and worst["dead"][0] <= E2E_DEAD_BIAS_ATOL):
        raise AssertionError("end-to-end gradient gap too large")


def phase_large_cloud(torch, smi, MVTracker, random_state_dict, make_scene, knn_ops, corr_ops):
    """Phase 7: the large-cloud serving path; returns (launch totals, the
    level-0 cloud of the last scene's first frame for phase 8)."""
    from mvtracker_torch.utils import geometry as geo

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    model = MVTracker(compute_dtype="bfloat16", device=dev).eval()
    model.load_state_dict(random_state_dict(model, seed=0))
    counters = {"knn": knn_ops.knn_cuda, "knn_tiled": knn_ops.knn_tiled_cuda, "knn_exact": knn_ops.knn_exact_cuda,
                "corr": corr_ops.corr_select_cuda}
    want = {"knn": K1_PER_LARGE, "knn_tiled": K4_PER_LARGE, "knn_exact": 0, "corr": K2_PER_LARGE}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = []
    for seed in range(10, 10 + LARGE_REQUESTS):
        scene = to_device(make_scene(np.random.default_rng(seed), LARGE_V, LARGE_T, LARGE_H, LARGE_W, N_QUERIES), dev)
        before = {name: fn.launches for name, fn in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(*scene, iters=ITERS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        traj, vis = out["traj"], out["vis"]
        if traj.shape != (LARGE_T, N_QUERIES, 3) or vis.shape != (LARGE_T, N_QUERIES):
            raise AssertionError(f"bad output shapes {tuple(traj.shape)}, {tuple(vis.shape)}")
        if not (bool(torch.isfinite(traj).all()) and bool(torch.isfinite(vis).all())):
            raise AssertionError("non-finite outputs")
        made = {name: fn.launches - before[name] for name, fn in counters.items()}
        if made != want:
            raise AssertionError(f"large-cloud request {seed}: launches {made}, want {want}")
        log(f"large-cloud request {seed}: {times[-1]:.2f} ms, launches {made} [{smi}]")
    launches = {name: fn.launches for name, fn in counters.items() if want[name]}
    peak = torch.cuda.max_memory_allocated()

    # The last request again with every kNN through the fused kernel: the two
    # kernels evaluate the same d^2, so the tracks must come out the same.
    model.knn_backend = "fused"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused = model(*scene, iters=ITERS)
    torch.cuda.synchronize()
    fused_ms = (time.perf_counter() - t0) * 1e3
    gaps = {key: float((out[key] - fused[key]).abs().max()) for key in ("traj", "vis")}
    log(f"large-cloud path: {LARGE_V} views x {LARGE_T} frames x {LARGE_H}x{LARGE_W}, level-0 cloud {LARGE_POINTS} "
        f"points, {N_QUERIES} queries, bf16, iters {ITERS}: ms per request {[round(x, 2) for x in times]}; the same "
        f"request through the fused kNN {fused_ms:.2f} ms, max gap traj {gaps['traj']:.3e} vis {gaps['vis']:.3e} "
        f"(limit {LARGE_SAME_ATOL}); max_memory_allocated {peak / 2**20:.1f} MiB [{smi}]")
    if not max(gaps.values()) <= LARGE_SAME_ATOL:
        raise AssertionError("the tiled and the fused kNN give different tracks")

    rgbs, depths, _, intrs, extrs = scene
    one = slice(0, 1)  # the first frame of every view
    xyz, _ = geo.init_pointcloud_from_rgbd(
        depths[None, :, one, ::4, ::4, None], depths[None, :, one, ::4, ::4], intrs[None, :, one], extrs[None, :, one],
        stride=4, level=0,
    )
    return launches, xyz.reshape(1, LARGE_POINTS, 3).contiguous()


def phase_direct_knn(torch, smi, knn_ops, cloud):
    """Phase 8: the kNN entries called directly on a level-0 cloud of the
    large scene; returns the launch totals."""
    query = cloud[:, ::DIRECT_STRIDE].contiguous()
    own = torch.arange(0, cloud.shape[1], DIRECT_STRIDE, device=cloud.device)
    counters = {"knn_tiled": knn_ops.knn_tiled_cuda, "knn_exact": knn_ops.knn_exact_cuda, "knn": knn_ops.knn_cuda}
    for fn in counters.values():
        fn.launches = 0
    results, times = {}, {}
    few = query[:, :N_QUERIES].contiguous()  # a tracker's worth of queries: the tiled kernel splits the cloud
    for backend, q in (("exact", query), ("tiled", query), ("auto", few)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[backend] = knn_ops.knn(cloud, q, DIRECT_K, backend=backend)
        torch.cuda.synchronize()
        times[backend] = (time.perf_counter() - t0) * 1e3
    launches = {name: fn.launches for name, fn in counters.items()}
    if launches != {"knn_tiled": 2, "knn_exact": 1, "knn": 0}:  # `auto` takes the tiled kernel at this size
        raise AssertionError(f"direct kNN entries: launches {launches}")
    d_exact, i_exact = results["exact"]
    if i_exact.shape != (1, query.shape[1], DIRECT_K) or not bool(torch.isfinite(d_exact).all()):
        raise AssertionError("direct kNN entries: bad output")
    # Every query is a point of the cloud: its nearest neighbour is itself, at
    # the floor distance sqrt(1e-12), and the distances ascend.
    if not (torch.equal(i_exact[0, :, 0], own) and bool((d_exact[..., 0] == 1e-6).all())
            and bool((d_exact[..., 1:] >= d_exact[..., :-1]).all())):
        raise AssertionError("direct kNN entries: a point is not its own nearest neighbour")
    if not (torch.equal(results["tiled"][0], d_exact) and torch.equal(results["auto"][0], d_exact[:, :N_QUERIES])):
        raise AssertionError("direct kNN entries: tiled and exact distances differ")
    log(f"direct kNN entries: cloud [1, {cloud.shape[1]}, 3], k={DIRECT_K}, exact and tiled with {query.shape[1]} "
        f"queries, auto with {few.shape[1]}: ms per call (host clock, first call of each) "
        f"{ {k: round(v, 2) for k, v in times.items()} }; exact and tiled agree, every point is its own nearest "
        f"neighbour [{smi}]")
    return {name: count for name, count in launches.items() if count}


def gap_stats(got, want) -> dict:
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).ravel()
    return {"median": float(np.median(d)), "p90": float(np.quantile(d, 0.9)), "max": float(d.max())}


def eval_launches(dp, iters: int, batched_small: bool) -> tuple[int, int]:
    """(K1, K2) launches of one medium-model request on scene `dp`: the query
    features' lookup, then per window and iteration one kNN per level (the
    two small levels of a 128^2 request share one) and one correlation per
    level. The windows are those the model runs from the earliest query."""
    from mvtracker_torch.models.mvtracker import window_starts

    qt_min = int(dp.query_points_3d[:, 0].min())
    w = min(max((EVAL_T - qt_min - 1) // EVAL_HOP, 1), len(window_starts(EVAL_T, EVAL_WINDOW)))
    return 1 + w * iters * (2 if batched_small else 3), w * iters * 3


def golden_gaps(outputs, golden) -> tuple[dict, dict]:
    """|gap| of every scene's traj and vis to the golden's, as
    ({(split, name): {field: stats}}, {field: pooled stats over all scenes})."""
    scenes, pooled = {}, {"traj": [], "vis": []}
    for split in ("calib", "heldout"):
        names = list(golden[f"{split}_seq_names"])
        if sorted(names) != sorted(outputs[split]):
            raise AssertionError(f"{split}: scenes {sorted(outputs[split])} are not the golden's {sorted(names)}")
        for i, name in enumerate(names):
            scenes[split, name] = {}
            for field, got in zip(("traj", "vis"), outputs[split][name]):
                want = golden[f"{split}_{field}"][i]
                pooled[field].append(np.abs(np.asarray(got, np.float64) - want).ravel())
                scenes[split, name][field] = gap_stats(got, want)
    return scenes, {field: gap_stats(np.concatenate(gaps), 0.0) for field, gaps in pooled.items()}


def beyond(gap: dict, limits: dict) -> list:
    return [q for q in limits if gap[q] > limits[q]]


def golden_failures(scenes: dict, pooled: dict, pooled_limits=None, scene_limits=None) -> list:
    """Every limit of the golden check that the gaps break (the release
    protocol's limits unless others are given)."""
    pooled_limits, scene_limits = pooled_limits or GOLDEN_POOLED_LIMITS, scene_limits or GOLDEN_SCENE_LIMITS
    failures = [f"{split} scene {name}: {field} gap {gap} beyond {scene_limits[field]}"
                for (split, name), fields in scenes.items() for field, gap in fields.items()
                if beyond(gap, scene_limits[field])]
    return failures + [f"{field} gap pooled over the 16 scenes {gap} beyond {pooled_limits[field]}"
                       for field, gap in pooled.items() if beyond(gap, pooled_limits[field])]


def fmt_gap(gap: dict) -> str:
    return "/".join(f"{gap[q]:.2e}" for q in ("median", "p90", "max"))


def check_release(eval_checkpoint, result, smi, golden_name="release_protocol", pooled_limits=None,
                  scene_limits=None) -> None:
    """The release weights' protocol against the JAX package's golden
    (`golden_name` in GOLDEN_DIR): every scene's tracks (all read and
    printed before a failure is raised), the calibrated threshold, the
    held-out metrics and CopyCat's row."""
    from mvtracker_torch.evaluation.evaluator import Evaluator

    pooled_limits, scene_limits = pooled_limits or GOLDEN_POOLED_LIMITS, scene_limits or GOLDEN_SCENE_LIMITS
    golden = np.load(GOLDEN_DIR / f"{golden_name}.npz")
    with open(GOLDEN_DIR / f"{golden_name}.json") as f:
        golden_rows = json.load(f)["rows"]
    outputs = result.outputs[PROTOCOL_KEY]
    scenes, pooled = golden_gaps(outputs, golden)
    for (split, name), gap in scenes.items():
        log(f"{golden_name} {split} {name} vs JAX (median/p90/max of |gap|): traj {fmt_gap(gap['traj'])}, "
            f"vis {fmt_gap(gap['vis'])}")
    log(f"{golden_name} vs the JAX package's fp32 CPU outputs, pooled over 16 scenes (median/p90/max): "
        + "; ".join(f"{field} {fmt_gap(pooled[field])} (limits {pooled_limits[field]})" for field in pooled)
        + f"; per-scene limits {scene_limits}")
    failures = golden_failures(scenes, pooled, pooled_limits, scene_limits)
    rows, grow = result.rows[PROTOCOL_KEY], golden_rows[PROTOCOL_KEY]
    sweep = {float(t): v["average_jaccard"] for t, v in rows["calib_threshold_sweep"].items()}
    gsweep = {float(t): v["average_jaccard"] for t, v in grow["calib_threshold_sweep"].items()}
    log(f"calibration sweep AJ, card vs golden: { {t: (sweep[t], gsweep[t]) for t in sorted(sweep)} }")
    th, gth = rows["calibrated_threshold"], grow["calibrated_threshold"]
    top = sorted(sweep.values(), reverse=True)
    if top[0] - top[1] < NEAR_TIE_AJ or th != gth:
        evaluator = Evaluator("kubric-multiview")
        at_golden = eval_checkpoint.sweep_thresholds(evaluator, outputs["heldout"], result.scenes["heldout"], [gth])
        log(f"near tie in the calibration sweep (best two AJ {top[0]} and {top[1]}): held-out AJ at the golden's "
            f"threshold {gth}: {at_golden[gth]['average_jaccard']} (golden {grow['heldout_calibrated']['average_jaccard']})")
    r, g = rows["heldout_calibrated"], grow["heldout_calibrated"]
    copycat, gcopycat = result.rows["copycat"], golden_rows["copycat"]
    log(f"{golden_name} metrics on the card: calibrated threshold {th} (golden {gth}); held-out "
        + ", ".join(f"{short} {r[m]} (golden {g[m]})" for m, short in METRICS)
        + "; CopyCat " + ", ".join(f"{short} {copycat[m]} (golden {gcopycat[m]})" for m, short in METRICS) + f" [{smi}]")
    if failures:
        raise AssertionError("; ".join(failures))
    if th != gth:
        raise AssertionError(f"calibrated threshold {th} differs from the golden's {gth}")
    if not all(abs(r[m] - g[m]) <= METRIC_TOL for m, _ in METRICS) or copycat != gcopycat:
        raise AssertionError(f"held-out metrics beyond {METRIC_TOL} of the golden's, or CopyCat's row differs")


def check_controls(eval_checkpoint, release, smi) -> None:
    """The protocol again in a lower precision than the JAX reference's: the
    fp32 model with TF32 convolutions (PyTorch's default on the GPU), and
    bf16 through the CLI. The golden check must reject both, or its limits
    would not catch a fault of that size."""
    import torch

    from mvtracker_torch.convert import load_release

    golden = np.load(GOLDEN_DIR / "release_protocol.npz")
    argv = PROTOCOL_ARGV + ["--params_msgpack", release]
    fp32_args = eval_checkpoint.build_parser().parse_args(argv)
    bf16_args = eval_checkpoint.build_parser().parse_args([a for a in argv if a != "--fp32"])
    controls = {
        "fp32, TF32 on": lambda: eval_checkpoint.evaluate(load_release(release, eval_checkpoint.build(fp32_args)),
                                                          fp32_args),
        "bf16": lambda: eval_checkpoint.run(bf16_args),
    }
    for control, run in controls.items():
        with torch.no_grad():
            result = run()
        scenes, pooled = golden_gaps(result.outputs[PROTOCOL_KEY], golden)
        worst = {field: max(gaps[field]["p90"] for gaps in scenes.values()) for field in ("traj", "vis")}
        r = result.rows[PROTOCOL_KEY]
        log(f"control {control} vs the golden: pooled " + "; ".join(f"{f} {fmt_gap(pooled[f])}" for f in pooled)
            + f"; largest per-scene p90 traj {worst['traj']:.2e} vis {worst['vis']:.2e}; threshold "
            f"{r['calibrated_threshold']}, held-out " + ", ".join(f"{short} {r['heldout_calibrated'][m]}"
                                                             for m, short in METRICS) + f" [{smi}]")
        failures = golden_failures(scenes, pooled)
        log(f"control {control}: the golden check breaks {len(failures)} limits: {failures[:4]}")
        if not failures:
            raise AssertionError(f"control {control}: the golden check's limits do not reject it")


def request_args(dp):
    return [np.asarray(a, np.float32) for a in (dp.video, dp.videodepth, dp.query_points_3d, dp.intrs, dp.extrs)]


def check_plain(model, predictor_kw, dps, outputs, limits, label) -> None:
    """The card's outputs on scenes `dps` ({name: (traj, vis)} in `outputs`)
    against the same predictor on a CPU copy of `model`."""
    import torch

    from mvtracker_torch.evaluation.evaluator import to_host
    from mvtracker_torch.evaluation.predictor import EvaluationPredictor

    cpu = EvaluationPredictor(copy.deepcopy(model).cpu(), device="cpu", **predictor_kw)
    for dp in dps:
        with torch.no_grad():
            want = cpu(*request_args(dp))
        failures = []
        for field, got in zip(("traj", "vis"), outputs[dp.seq_name]):
            gap = gap_stats(got, to_host(want[field]))
            log(f"{label}, kernel path vs plain CPU path on {dp.seq_name}: {field} gap (median/p90/max) "
                f"{fmt_gap(gap)} (limits {limits[field]})")
            failures += [f"{dp.seq_name} {field} {q}" for q in beyond(gap, limits[field])]
        if failures:
            raise AssertionError(f"{label} kernel path vs plain: {failures}")


def phase_evaluation(torch, smi, knn_ops, corr_ops, release):
    """Phase 9: the medium model through the release protocol by the CLI's
    entry points, then served at the predictor's defaults. `release`: the
    release checkpoint's path, whose protocol is held against the JAX
    package's golden outputs and metrics; None: seeded weights, held against
    the plain CPU path. Returns the protocol run's launch totals."""
    from mvtracker_torch.cli import eval_checkpoint
    from mvtracker_torch.convert import load_release, random_state_dict
    from mvtracker_torch.device import fp32_precision
    from mvtracker_torch.evaluation.evaluator import Evaluator, to_host
    from mvtracker_torch.evaluation.predictor import EvaluationPredictor

    # PyTorch's own defaults, as a user's process has them (phases 4 and 6
    # turned TF32 off): the CLI's --fp32 must turn it off itself.
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    torch.cuda.empty_cache()
    seeded = None

    def load_weights(model):
        nonlocal seeded
        if release:
            return load_release(release, model)
        if seeded is None:
            seeded = random_state_dict(model, seed=0)
            for name in seeded:
                if name.startswith("updateformer.flow_head.") and name.endswith("weight"):
                    seeded[name] = seeded[name] * FLOW_HEAD_GAIN
        return model.load_state_dict(seeded)

    counters = {"knn": knn_ops.knn_cuda, "knn_tiled": knn_ops.knn_tiled_cuda, "knn_exact": knn_ops.knn_exact_cuda,
                "corr": corr_ops.corr_select_cuda, "corr_bwd": corr_ops.corr_select_backward_cuda}
    for fn in counters.values():
        fn.launches = 0
    args = eval_checkpoint.build_parser().parse_args(PROTOCOL_ARGV + (["--params_msgpack", release] if release else []))
    t0 = time.perf_counter()
    with torch.no_grad():
        if release:
            result = eval_checkpoint.run(args)
        else:
            model = eval_checkpoint.build(args)
            load_weights(model)
            result = eval_checkpoint.protocol(model, args)
    protocol_s = time.perf_counter() - t0
    made = {name: fn.launches for name, fn in counters.items()}
    if (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) != (True, False):
        raise AssertionError("the protocol left the process's TF32 settings changed")
    scenes = result.scenes["calib"] + result.scenes["heldout"]
    want_k1 = sum(eval_launches(dp, PROTOCOL_ITERS, True)[0] for dp in scenes)
    want_k2 = sum(eval_launches(dp, PROTOCOL_ITERS, True)[1] for dp in scenes)
    want = {"knn": want_k1, "knn_tiled": 0, "knn_exact": 0, "corr": want_k2, "corr_bwd": 0}
    if made != want:
        raise AssertionError(f"release protocol: launches {made}, want {want}")
    weights = f"release weights {release}" if release else "seeded weights"
    log(f"release protocol, {weights}: {len(scenes)} requests (4 views x 12 frames x 128^2, 32 tracks, fp32, "
        f"iters 3) in {protocol_s:.1f} s with scene rendering; every kNN through K1 and every correlation through "
        f"K2: {made['knn']} and {made['corr']} launches, {made['knn'] / len(scenes):.2f} and "
        f"{made['corr'] / len(scenes):.2f} per request [{smi}]")
    outputs = result.outputs[PROTOCOL_KEY]
    for split in ("calib", "heldout"):
        for traj, vis in outputs[split].values():
            if traj.shape != (EVAL_T, PROTOCOL_QUERIES, 3) or not (np.isfinite(traj).all() and np.isfinite(vis).all()):
                raise AssertionError(f"release protocol: bad outputs {traj.shape}")
    if release:
        check_release(eval_checkpoint, result, smi)
    else:
        r = result.rows[PROTOCOL_KEY]
        log(f"release protocol metrics, seeded weights: calibrated threshold {r['calibrated_threshold']}, held-out "
            + ", ".join(f"{short} {r['heldout_calibrated'][m]}" for m, short in METRICS))
        with fp32_precision(exact=True):
            check_plain(model, dict(interp_shape=(128, 128), grid_size=0, n_iters=PROTOCOL_ITERS),
                        [result.scenes[split][i] for split, i in SEEDED_SCENES],
                        {**outputs["calib"], **outputs["heldout"]}, SEEDED_PLAIN_LIMITS, "release protocol")
        del model
    launches = {"knn": made["knn"], "corr": made["corr"]}

    # Serving the same weights at the predictor's defaults: bf16, fp32 at
    # PyTorch's default precision (TF32 convolutions), and fp32 exact.
    heldout = result.scenes["heldout"]
    exact_model = None
    for dtype, exact in (("bfloat16", False), ("float32", False), ("float32", True)):
        label = f"{dtype}{', TF32 off' if exact else ''}"
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        serve_args = eval_checkpoint.build_parser().parse_args(
            [a for a in PROTOCOL_ARGV if dtype == "float32" or a != "--fp32"])
        model = eval_checkpoint.build(serve_args)
        load_weights(model)
        predictor = EvaluationPredictor(model)  # interp (384, 512), grid 5, 6 iterations
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times, counts = [], []
        with torch.no_grad(), fp32_precision(exact):
            for dp in heldout[: SERVE_TIMED + 1]:
                k1, k2 = knn_ops.knn_cuda.launches, corr_ops.corr_select_cuda.launches
                t0 = time.perf_counter()
                out = predictor(*request_args(dp))
                traj, vis = to_host(out["traj"]), to_host(out["vis"])
                times.append((time.perf_counter() - t0) * 1e3)
                got = (knn_ops.knn_cuda.launches - k1, corr_ops.corr_select_cuda.launches - k2)
                if got != eval_launches(dp, SERVE_ITERS, False):
                    raise AssertionError(f"defaults {label}: launches {got}, want {eval_launches(dp, SERVE_ITERS, False)}")
                if traj.shape != (EVAL_T, PROTOCOL_QUERIES, 3) or not (np.isfinite(traj).all() and np.isfinite(vis).all()):
                    raise AssertionError(f"defaults {label}: bad outputs {traj.shape}")
                counts.append(got)
            peak = torch.cuda.max_memory_allocated()
            summary, _ = Evaluator("kubric-multiview").evaluate_sequence(predictor, heldout[:SERVE_TIMED])
        log(f"defaults serving {label}, {weights} (4 views x 12 frames, 128^2 resized to 384x512, {SERVE_QUERIES} "
            f"queries with the support grid, iters {SERVE_ITERS}): first request {times[0]:.2f} ms, warm requests "
            f"{[round(x, 2) for x in times[1:]]} ms (outputs on the host); Evaluator fps {summary['fps']:.2f} over "
            f"{SERVE_TIMED} scenes (AJ {summary['all_any']['average_jaccard']:.3f}); launches kNN/corr per request "
            f"{counts}; weights {(resident - before) / 2**20:.1f} MiB, max_memory_allocated "
            f"{(peak - resident) / 2**20:.1f} MiB above them [{smi}]")
        if exact:
            exact_model = model
        del model, predictor

    # One request at the defaults, fp32 with TF32 off: kernel path against the
    # plain CPU path, both with the exact kNN (K5 on the card). The 384x512
    # resize repeats depth pixels, so a quarter of the neighbour distances tie
    # exactly; K1 and `torch.topk` break such ties differently, which moves
    # the seeded model by up to 1e-3 on the CPU alone, while the exact kNN
    # takes the lowest index on both sides (`PERF.md`, PR 4).
    exact_model.knn_backend = "exact"
    with torch.no_grad(), fp32_precision(exact=True):
        dp = heldout[0]
        out = EvaluationPredictor(exact_model)(*request_args(dp))
        check_plain(exact_model, {}, [dp], {dp.seq_name: (to_host(out["traj"]), to_host(out["vis"]))},
                    DEFAULTS_PLAIN_LIMITS if release else SEEDED_PLAIN_LIMITS, "defaults fp32")
    del exact_model
    if release:
        torch.cuda.empty_cache()
        if not torch.backends.cudnn.allow_tf32:
            raise AssertionError("the fp32 control needs cuDNN's TF32, PyTorch's default")
        check_controls(eval_checkpoint, release, smi)
    return launches


def seeded_weights(model, seed=0):
    """Seeded weights with the flow head scaled by FLOW_HEAD_GAIN (phases 4,
    6, 9 and 10)."""
    from mvtracker_torch.convert import random_state_dict

    sd = random_state_dict(model, seed=seed)
    for name in sd:
        if name.startswith("updateformer.flow_head.") and name.endswith("weight"):
            sd[name] = sd[name] * FLOW_HEAD_GAIN
    model.load_state_dict(sd)
    return model


def protocol_scenes():
    """Calibration scene 0 and held-out scene 0 of the release protocol."""
    from mvtracker_torch.datasets.loader import SyntheticSceneDataset

    kw = dict(n_views=4, n_frames=EVAL_T, height=128, width=128, n_tracks=PROTOCOL_QUERIES, texture_detail=1.0,
              texture_noise=1.0)
    return [SyntheticSceneDataset(n_scenes=1, cache=True, seed=seed, randomize=True, **kw)[0] for seed in (555, 777)]


def windows_of(query_points, t, window, hop):
    """Windows the model runs for these queries (from the earliest one)."""
    from mvtracker_torch.models.mvtracker import window_starts

    qt_min = int(np.asarray(query_points)[..., 0].min())
    return min(max((t - qt_min - 1) // hop, 1), len(window_starts(t, window)))


def outputs_on(predictor, dps):
    """{seq_name: (traj, vis)} of `predictor` on the scenes, on the host."""
    import torch

    from mvtracker_torch.evaluation.evaluator import to_host

    out = {}
    with torch.no_grad():
        for dp in dps:
            o = predictor(*request_args(dp))
            out[dp.seq_name] = (to_host(o["traj"]), to_host(o["vis"]))
    return out


def check_gaps(got, want, limits, label) -> dict:
    """Per scene |got - want| of traj and vis against `limits`; returns the
    stats, raises after printing them all if any limit is broken."""
    failures, gaps = [], {}
    for name in got:
        for i, field in enumerate(("traj", "vis")):
            gap = gaps[name, field] = gap_stats(got[name][i], want[name][i])
            log(f"{label} on {name}: {field} gap (median/p90/max) {fmt_gap(gap)} (limits {limits[field]})")
            failures += [f"{name} {field} {q}" for q in beyond(gap, limits[field])]
    if failures:
        raise AssertionError(f"{label}: {failures}")
    return gaps


class LogRecords(logging.Handler):
    """Collects the messages logged while the block runs (at INFO and up)."""

    def __enter__(self):
        self.messages = []
        self.root = logging.getLogger()
        self.saved = self.root.level
        self.root.setLevel(logging.INFO)
        self.root.addHandler(self)
        return self

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __exit__(self, *exc):
        self.root.removeHandler(self)
        self.root.setLevel(self.saved)


def phase_options(torch, smi, knn_ops, corr_ops, release):
    """Phase 10: the tracker's options, warm start with the corr-width
    migration, and the config-driven CLIs. Returns {path: launch totals}."""
    import threading
    import urllib.request

    from mvtracker_torch.cli import eval as cli_eval
    from mvtracker_torch.cli import eval_checkpoint
    from mvtracker_torch.cli import serve as cli_serve
    from mvtracker_torch.cli import train as cli_train
    from mvtracker_torch.config import build_model, load_config
    from mvtracker_torch.convert import load_release
    from mvtracker_torch.datasets.loader import PrefetchLoader, SyntheticSceneDataset
    from mvtracker_torch.device import fp32_precision
    from mvtracker_torch.evaluation.predictor import EvaluationPredictor
    from mvtracker_torch.presets import build_model as preset_model
    from mvtracker_torch.scene import make_scene
    from mvtracker_torch.training import step as step_lib
    from mvtracker_torch.training.train import TrainConfig, Trainer

    dev = torch.device("cuda")
    counters = {"knn": knn_ops.knn_cuda, "knn_tiled": knn_ops.knn_tiled_cuda, "knn_exact": knn_ops.knn_exact_cuda,
                "corr": corr_ops.corr_select_cuda, "corr_bwd": corr_ops.corr_select_backward_cuda}

    def reset():
        for fn in counters.values():
            fn.launches = 0
        knn_ops.knn_cuda.launches_by_k = {}

    def made():
        return {name: fn.launches for name, fn in counters.items()}

    def medium(**kw):
        return preset_model("medium", vis_geom=True, vis_head_hidden=128, device=dev, **kw).eval()

    def weights(model):
        return load_release(release, model) if release else seeded_weights(model)

    protocol_kw = dict(interp_shape=(128, 128), grid_size=0, n_iters=PROTOCOL_ITERS)
    plain_limits = GOLDEN_SCENE_LIMITS if release else SEEDED_PLAIN_LIMITS
    paths = {}
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    torch.cuda.empty_cache()
    dps = protocol_scenes()
    windows = [windows_of(dp.query_points_3d, EVAL_T, EVAL_WINDOW, EVAL_HOP) for dp in dps]
    tmp = tempfile.TemporaryDirectory()

    # (a) The corr-width migration: the uniform medium model saved with
    # torch.save (or the release msgpack), warm-started into corr_k0=24.
    t0 = time.perf_counter()
    uniform = weights(medium(compute_dtype="float32", knn_backend="exact"))
    source = release or str(Path(tmp.name) / "uniform.pth")
    if not release:
        torch.save(uniform.state_dict(), source)
    migrated = medium(compute_dtype="float32", corr_k0=K0, knn_backend="exact")
    trainer = Trainer(migrated, TrainConfig(exp_dir=tmp.name))
    with LogRecords() as logs:
        trainer.warm_start(step_lib.init_state(migrated, trainer.optimizer), source, strict=True)
    migration = [m for m in logs.messages if m.startswith("warm-start: migrated input_transform")]
    if not migration:
        raise AssertionError(f"the warm start logged no corr-width migration: {logs.messages}")
    log(f"options (a) warm start from {source}: {migration[0]}")
    reset()
    with fp32_precision(exact=True):
        card_u = outputs_on(EvaluationPredictor(uniform, **protocol_kw), dps)
        reset()
        card_m = outputs_on(EvaluationPredictor(migrated, **protocol_kw), dps)
        paths["options_migration"] = {k: made()[k] for k in ("knn_exact", "corr")}
        want = {"knn_exact": sum(1 + w * PROTOCOL_ITERS * 2 for w in windows),
                "corr": sum(w * PROTOCOL_ITERS * 3 for w in windows)}
        if paths["options_migration"] != want:
            raise AssertionError(f"migrated model: launches {paths['options_migration']}, want {want}")
        cpu_u = outputs_on(EvaluationPredictor(copy.deepcopy(uniform).cpu(), device="cpu", **protocol_kw), dps)
        cpu_m = outputs_on(EvaluationPredictor(copy.deepcopy(migrated).cpu(), device="cpu", **protocol_kw), dps)
    check_gaps(card_m, cpu_m, plain_limits, "options (a) migrated model, kernel path (K5) vs plain CPU path")
    cpu_gap = {(n, f): gap_stats(cpu_m[n][i], cpu_u[n][i]) for n in cpu_m for i, f in enumerate(("traj", "vis"))}
    limits = {key: {q: MIGRATION_MARGIN * v + MIGRATION_SLACK for q, v in g.items()} for key, g in cpu_gap.items()}
    failures = []
    for (name, field), lim in limits.items():
        gap = gap_stats(card_m[name][("traj", "vis").index(field)], card_u[name][("traj", "vis").index(field)])
        log(f"options (a) migrated vs uniform model on the card, {name} {field} (median/p90/max): {fmt_gap(gap)}; "
            f"the same on the CPU {fmt_gap(cpu_gap[name, field])}; limits {fmt_gap(lim)}")
        failures += [f"{name} {field} {q}" for q in beyond(gap, lim)]
    if failures:
        raise AssertionError(f"migrated vs uniform on the card beyond the CPU's comparison: {failures}")
    log(f"options (a) migration: {len(dps)} protocol scenes, fp32 exact, K5 on both sides, "
        f"{time.perf_counter() - t0:.1f} s [{smi}]")
    del uniform, migrated

    # (b) The warm-started corr_k0 model in bf16 takes 3 train steps through
    # Trainer.fit at the protocol's shape.
    t0 = time.perf_counter()
    model = medium(corr_k0=K0).train()
    trainer = Trainer(model, TrainConfig(train_iters=PROTOCOL_ITERS, adaptive_iters=False, warmup_steps=0, telemetry_freq=1,
                                         exp_dir=str(Path(tmp.name) / "options_train"), warm_start_ckpt=source))
    loader = PrefetchLoader(SyntheticSceneDataset(n_scenes=TRAIN_STEPS, cache=True, seed=555, randomize=True,
                                                  n_views=4, n_frames=EVAL_T, height=128, width=128,
                                                  n_tracks=PROTOCOL_QUERIES, texture_detail=1.0, texture_noise=1.0),
                            batch_size=1, shuffle=False, num_workers=1)
    drawn, steps = [], []

    def recording(it):
        for batch in it:
            drawn.append(windows_of(batch["query_points"], EVAL_T, EVAL_WINDOW, EVAL_HOP))
            yield batch

    def on_step(step, metrics):
        torch.cuda.synchronize()
        steps.append((time.perf_counter(), made(), dict(knn_ops.knn_cuda.launches_by_k),
                      {k: float(v) for k, v in metrics.items()}))

    reset()
    with LogRecords() as logs:
        state = trainer.fit(recording(iter(loader)), max_steps=TRAIN_STEPS, on_step=on_step)
    if not any(m.startswith("warm-start: migrated input_transform") for m in logs.messages):
        raise AssertionError("fit did not warm-start from warm_start_ckpt")
    telemetry = [m for m in logs.messages if "mean/med/std" in m]
    paths["options_train"] = {k: made()[k] for k in ("knn", "corr", "corr_bwd")}
    last, last_k, last_t = {k: 0 for k in counters}, {}, t0
    for i, (t, counts, by_k, metrics) in enumerate(steps):
        w = drawn[i]
        step_counts = {k: counts[k] - last[k] for k in ("knn", "corr", "corr_bwd")}
        step_k = {k: by_k.get(k, 0) - last_k.get(k, 0) for k in by_k}
        want = {"knn": 1 + w * PROTOCOL_ITERS * 2, "corr": w * PROTOCOL_ITERS * 3, "corr_bwd": w * PROTOCOL_ITERS * 3}
        want_k = {1: 1, K0: w * PROTOCOL_ITERS, EVAL_K: w * PROTOCOL_ITERS}
        if step_counts != want or step_k != want_k or counts["knn_exact"] != 0:
            raise AssertionError(f"options train step {i}: launches {step_counts} by k {step_k}, want {want} "
                                 f"by k {want_k}")
        if not all(np.isfinite(v) for v in metrics.values()) or not metrics["grad_norm"] > 0:
            raise AssertionError(f"options train step {i}: metrics {metrics}")
        log(f"options (b) train step {i}: {(t - last_t) * 1e3:.2f} ms, loss {metrics['loss']:.6f}, grad_norm "
            f"{metrics['grad_norm']:.4f}, {w} windows: K1/K2/K3 launches {step_counts} (K1 by k {step_k}: "
            f"feat_init k=1, level 0 k={K0}, levels 1-2 together k={EVAL_K}) [{smi}]")
        last, last_k, last_t = counts, by_k, t
    if state.step != TRAIN_STEPS:
        raise AssertionError(f"the trainer took {state.step} steps")
    log(f"options (b) training: corr_k0={K0} medium model, bf16, {TRAIN_STEPS} steps of the protocol's shape in "
        f"{time.perf_counter() - t0:.1f} s; the trainer's telemetry per step (data, then the step to its loss fetch): "
        f"{[m.split(' | ')[-1] for m in telemetry]} [{smi}]")
    del model, trainer, state

    # (c) The round-4 inference knobs (global match, chain velocity 1.0, kNN
    # reuse) through EvaluationPredictor: one kNN call per level group and
    # window instead of per iteration.
    t0 = time.perf_counter()
    knobs = dict(global_match=True, chain_velocity=1.0, knn_reuse=True)
    model = weights(medium(compute_dtype="float32", **knobs))
    reset()
    with fp32_precision(exact=True):
        counted = outputs_on(EvaluationPredictor(model, **protocol_kw), dps)
    paths["options_eval"] = {k: made()[k] for k in ("knn", "corr")}
    want = {"knn": sum(1 + w * 2 for w in windows), "corr": sum(w * PROTOCOL_ITERS * 3 for w in windows)}
    if paths["options_eval"] != want or made()["knn_exact"]:
        raise AssertionError(f"round-4 knobs: launches {made()}, want {want}")
    log(f"options (c) round-4 knobs: K1 launches {paths['options_eval']['knn']} for {len(dps)} requests "
        f"({want['knn'] / len(dps):.1f} a request; "
        f"{sum(1 + w * PROTOCOL_ITERS * 2 for w in windows) / len(dps):.1f} without reuse), K2 "
        f"{paths['options_eval']['corr']}; tracks finite: "
        f"{all(np.isfinite(t).all() and np.isfinite(v).all() for t, v in counted.values())}")
    model.knn_backend = "exact"
    with fp32_precision(exact=True):
        card = outputs_on(EvaluationPredictor(model, **protocol_kw), dps)
        cpu = outputs_on(EvaluationPredictor(copy.deepcopy(model).cpu(), device="cpu", **protocol_kw), dps)
    check_gaps(card, cpu, KNOBS_GOLDEN_SCENE_LIMITS if release else KNOBS_PLAIN_LIMITS,
               "options (c) round-4 knobs, kernel path (K5) vs plain CPU path")
    del model
    if release:
        args = eval_checkpoint.build_parser().parse_args(
            PROTOCOL_ARGV + ["--params_msgpack", release, "--global_match", "--chain_velocity", "1.0", "--knn_reuse"])
        with torch.no_grad():
            result = eval_checkpoint.run(args)
        check_release(eval_checkpoint, result, smi, golden_name="release_protocol_r4knobs",
                      pooled_limits=KNOBS_GOLDEN_POOLED_LIMITS, scene_limits=KNOBS_GOLDEN_SCENE_LIMITS)
    log(f"options (c) evaluation with the round-4 knobs: {time.perf_counter() - t0:.1f} s [{smi}]")

    # (d) The config CLIs at flagship width: train 3 steps of the long-video
    # preset (remat, kNN reuse, bf16) on the data config's synthetic scenes,
    # evaluate the checkpoint, one request each through the normalized and
    # the point-transformer presets.
    exp = str(Path(tmp.name) / "longvideo")
    config = str(ROOT / "configs" / "mvtracker_longvideo.yaml")
    argv = ["--config", config, "--device", "cuda", "trainer.total_steps=3", "trainer.adaptive_iters=false",
            f"trainer.exp_dir={exp}", "trainer.save_ckpt_freq=3", "trainer.telemetry_freq=1"]
    torch.cuda.empty_cache()
    reset()
    t0 = time.perf_counter()
    with LogRecords() as logs:
        state = cli_train.main(argv)
    train_s = time.perf_counter() - t0
    telemetry = [m.split(" | ")[-1] for m in logs.messages if "mean/med/std" in m]
    paths["config_cli_train"] = {k: made()[k] for k in ("knn", "corr", "corr_bwd")}
    per_step = {"knn": 1 + 3 * 3, "corr": 3 * ITERS * 4, "corr_bwd": 3 * ITERS * 4}
    want = {k: v * 3 for k, v in per_step.items()}
    if state.step != 3 or paths["config_cli_train"] != want or made()["knn_exact"] or made()["knn_tiled"]:
        raise AssertionError(f"cli.train: {state.step} steps, launches {made()}, want {want} (3 windows a step)")
    log(f"options (d) cli.train {' '.join(argv[:2])} {' '.join(argv[4:])}: 3 steps in {train_s:.1f} s with the "
        f"scenes' rendering; launches {paths['config_cli_train']} ({per_step} a step); the trainer's telemetry per step "
        f"(data, then the step to its loss fetch): {telemetry} [{smi}]")
    del state
    torch.cuda.empty_cache()
    reset()
    t0 = time.perf_counter()
    with LogRecords() as logs:
        summary = cli_eval.main(["--config", config, "--device", "cuda", f"trainer.exp_dir={exp}",
                                 "eval.max_sequences=1"])
    eval_s = time.perf_counter() - t0
    paths["config_cli_eval"] = {k: made()[k] for k in ("knn", "corr")}
    calls = 2  # the Evaluator runs the first scene of a shape once untimed
    eval_iters = load_config(config).eval.n_iters
    want = {"knn": calls * (1 + 3 * 3), "corr": calls * 3 * eval_iters * 4}
    if "evaluating checkpoint at step 3" not in logs.messages or paths["config_cli_eval"] != want:
        raise AssertionError(f"cli.eval: launches {made()}, want {want}; restored: "
                             f"{[m for m in logs.messages if 'checkpoint' in m]}")
    log(f"options (d) cli.eval restored step 3 and evaluated {summary['n_sequences']} sequences in {eval_s:.1f} s "
        f"(AJ {summary['all_any']['average_jaccard']:.3f}, fps {summary['fps']:.2f}); launches "
        f"{paths['config_cli_eval']}")

    reset()
    requests = {}
    scene = make_scene(np.random.default_rng(30), V, T, H, W, N_QUERIES)
    for name in ("mvtracker_normalized", "mvtracker_ptv3"):
        model = seeded_weights(build_model(load_config(str(ROOT / "configs" / f"{name}.yaml")).model, device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with fp32_precision(exact=True):
            out = model(*to_device(scene, dev), iters=ITERS)
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(out["traj"]).all()) and bool(torch.isfinite(out["vis"]).all())):
            raise AssertionError(f"{name}: non-finite outputs")
        requests[name] = model
        log(f"options (d) {name}: one request of {V} views x {T} frames x {H}x{W}, {N_QUERIES} queries, fp32, "
            f"iters {ITERS}: {(time.perf_counter() - t0) * 1e3:.2f} ms (first) [{smi}]")
    paths["config_requests"] = {k: made()[k] for k in ("knn", "corr")}
    want = {"knn": 2 * K1_PER_FWD, "corr": 2 * K2_PER_FWD}
    if paths["config_requests"] != want:
        raise AssertionError(f"normalized and PTv3 requests: launches {made()}, want {want}")
    model = requests.pop("mvtracker_ptv3")
    del requests
    model.knn_backend = "exact"
    t0 = time.perf_counter()
    with fp32_precision(exact=True):
        got = model(*to_device(scene, dev), iters=ITERS)
        want_out = copy.deepcopy(model).cpu()(*to_device(scene, torch.device("cpu")), iters=ITERS)
    for key, (tmax, tmed) in (("traj", (E2E_TRAJ_MAX, E2E_TRAJ_MEDIAN)), ("vis", (E2E_VIS_MAX, E2E_VIS_MEDIAN))):
        gap = (got[key].cpu() - want_out[key]).abs()
        log(f"options (d) mvtracker_ptv3 fp32 exact at the flagship shape, kernel path (K5) vs plain CPU path: "
            f"{key} max gap {float(gap.max()):.3e} (limit {tmax}), median {float(gap.median()):.3e} (limit {tmed}); "
            f"{time.perf_counter() - t0:.1f} s with the CPU's forward")
        if not (float(gap.max()) <= tmax and float(gap.median()) <= tmed):
            raise AssertionError(f"mvtracker_ptv3 kernel path vs plain: {key} gap too large")
    del model

    # (e) cli/serve.py's server on 127.0.0.1 with the checkpoint of (d)
    # answers 2 requests at the flagship shape, as the predictor does.
    t0 = time.perf_counter()
    args = cli_serve.build_parser().parse_args(["--ckpt_dir", exp, "--device", "cuda"])
    model = cli_serve.load_model(args)
    server, predictor = cli_serve.build_server(model, port=0, interp_shape=None, grid_size=args.grid_size,
                                               n_iters=args.iters, chunk_frames=args.chunk_frames, device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    reset()
    try:
        times = []
        for seed in (40, 41):
            scene = make_scene(np.random.default_rng(seed), V, T, H, W, N_QUERIES)
            buf = io.BytesIO()
            np.savez(buf, **dict(zip(("rgbs", "depths", "query_points", "intrs", "extrs"), scene)))
            t1 = time.perf_counter()
            req = urllib.request.Request(f"http://{host}:{port}/track", data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=300) as resp:
                answer = np.load(io.BytesIO(resp.read()))
            times.append((time.perf_counter() - t1) * 1e3)
            with torch.no_grad():
                direct = predictor(*scene)
            if not (np.array_equal(answer["traj"], direct["traj"].cpu().numpy())
                    and np.array_equal(answer["vis"], direct["vis"].cpu().numpy())):
                raise AssertionError(f"served request {seed}: the answer differs from the predictor's")
        with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    paths["serving_cli"] = {k: made()[k] for k in ("knn", "corr")}
    per_request = {"knn": 1 + 3 * args.iters * 3, "corr": 3 * args.iters * 4}
    want = {k: 4 * v for k, v in per_request.items()}  # 2 served, 2 direct
    if paths["serving_cli"] != want or (health["requests"], health["errors"]) != (2, 0):
        raise AssertionError(f"serving: launches {paths['serving_cli']}, want {want}; healthz {health}")
    log(f"options (e) cli.serve on {host}:{port} with the step-3 checkpoint: 2 requests of {V} views x {T} frames x "
        f"{H}x{W}, {N_QUERIES} queries, fp32, iters {args.iters}: {[round(x, 2) for x in times]} ms each with the "
        f"npz transfer; answers equal the predictor's bit for bit; healthz {health}; "
        f"{time.perf_counter() - t0:.1f} s [{smi}]")
    del model, predictor
    tmp.cleanup()
    return paths


# -- Dataset fixtures for phase 11, written with the port's own image_io
# (the GPU host has no imageio): the on-disk layouts the loaders read.


def rotation_to_quaternion(r: np.ndarray) -> np.ndarray:
    """[3, 3] rotation -> (w, x, y, z)."""
    w = np.sqrt(max(0.0, 1 + r[0, 0] + r[1, 1] + r[2, 2])) / 2
    if w <= 1e-6:
        raise ValueError("rotation too close to a half turn for this conversion")
    return np.array([w, (r[2, 1] - r[1, 2]) / (4 * w), (r[0, 2] - r[2, 0]) / (4 * w), (r[1, 0] - r[0, 1]) / (4 * w)])


def write_kubric_scene(scene, path) -> None:
    """A rendered Datapoint in the Kubric layout: per view RGBA PNGs,
    euclidean-depth float32 TIFFs, tracks_2d.npz and metadata.json (K
    normalised, camera-to-world positions and quaternions, both in Kubric's
    -y/-z camera convention)."""
    from mvtracker_torch.datasets import image_io
    from mvtracker_torch.datasets.kubric import depth_euclidean_to_z

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    v, t, h, w, _ = scene.video.shape
    n = scene.trajectory_3d.shape[1]
    np.savez(path / "tracks_3d.npz", tracks_3d=scene.trajectory_3d)
    np.savez(path / "tracks_segmentation_ids.npz", tracks_segmentation_ids=np.zeros(n, np.int32))
    flip = np.diag([1.0, -1.0, -1.0])
    for vi in range(v):
        vp = path / f"view_{vi}"
        vp.mkdir(exist_ok=True)
        intr = scene.intrs[vi, 0].astype(np.float64)
        positions, quaternions = [], []
        for ti in range(t):
            sq = np.eye(4)
            sq[:3] = flip @ scene.extrs[vi, ti].astype(np.float64)
            c2w = np.linalg.inv(sq)
            positions.append(c2w[:3, 3])
            quaternions.append(rotation_to_quaternion(c2w[:3, :3]))
        focal_length = intr[0, 0] / w  # sensor width 1
        ones = np.ones((1, h, w), np.float32)
        rescale = 1.0 / depth_euclidean_to_z(ones, 1.0, focal_length)[0]
        for ti in range(t):
            rgba = np.concatenate([scene.video[vi, ti].astype(np.uint8), np.full((h, w, 1), 255, np.uint8)], axis=-1)
            image_io.write_png(vp / f"rgba_{ti:05d}.png", rgba)
            image_io.write_tiff(vp / f"depth_{ti:05d}.tiff", (scene.videodepth[vi, ti] * rescale).astype(np.float32))
        np.savez(vp / "tracks_2d.npz", tracks_2d=scene.trajectory[vi, :, :, :2].astype(np.float32),
                 occlusion=~scene.visibility[vi])
        meta = {"camera": {"K": (np.diag([1.0 / w, 1.0 / h, 1.0]) @ intr @ flip).tolist(),
                           "positions": np.asarray(positions).tolist(), "quaternions": np.asarray(quaternions).tolist(),
                           "sensor_width": 1.0, "focal_length": focal_length},
                "metadata": {"resolution": [w, h]}}
        (vp / "metadata.json").write_text(json.dumps(meta))


def write_panoptic_scene(scene, path, cameras) -> None:
    """A rendered Datapoint in the Panoptic Studio layout, view i as camera
    id cameras[i]: PNG frames under ims/<id>/, dynamic3dgs_depth/
    depths_<id>.npy, and tapvid3d_annotations.npz with the per-camera rows
    at the ids."""
    from mvtracker_torch.datasets import image_io

    path = Path(path)
    v, t = scene.video.shape[:2]
    rows = max(cameras) + 1

    def at_ids(a):
        out = np.zeros((rows,) + a.shape[1:], a.dtype)
        out[list(cameras)] = a
        return out

    (path / "dynamic3dgs_depth").mkdir(parents=True, exist_ok=True)
    np.savez(path / "tapvid3d_annotations.npz", trajectories=scene.trajectory_3d,
             trajectories_pixelspace=at_ids(scene.trajectory), per_view_visibilities=at_ids(scene.visibility),
             query_points_3d=scene.query_points_3d, extrinsics=at_ids(scene.extrs), intrinsics=at_ids(scene.intrs))
    for vi, cam in enumerate(cameras):
        d = path / "ims" / str(cam)
        d.mkdir(parents=True, exist_ok=True)
        for ti in range(t):
            image_io.write_png(d / f"{ti:05d}.png", scene.video[vi, ti].astype(np.uint8))
        np.save(path / "dynamic3dgs_depth" / f"depths_{cam:02d}.npy", scene.videodepth[vi])


def write_dexycb_scene(scene, path) -> None:
    """A rendered Datapoint in the DexYCB layout: per view PNG frames under
    rgb/, 16-bit millimetre depth PNGs under depth/, intrinsics_extrinsics.npz;
    tracks_3d.npz with visibilities and queries."""
    from mvtracker_torch.datasets import image_io

    path = Path(path)
    v, t = scene.video.shape[:2]
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "tracks_3d.npz", tracks_3d=scene.trajectory_3d, per_view_visibilities=scene.visibility,
             query_points_3d=scene.query_points_3d)
    for vi in range(v):
        vp = path / f"view_{vi}"
        (vp / "rgb").mkdir(parents=True, exist_ok=True)
        (vp / "depth").mkdir(exist_ok=True)
        for ti in range(t):
            image_io.write_png(vp / "rgb" / f"{ti:05d}.png", scene.video[vi, ti].astype(np.uint8))
            mm = np.clip(np.rint(scene.videodepth[vi, ti] * 1000), 0, 65535).astype(np.uint16)
            image_io.write_png(vp / "depth" / f"{ti:05d}.png", mm)
        np.savez(vp / "intrinsics_extrinsics.npz", K=scene.intrs[vi, 0], extr=scene.extrs[vi, 0])


# Phase 11: the host data path, augmented training, crash replay and the
# real datasets' formats.
# (a) The native data path at a flagship-size stack (4 views x 24 frames x
# 256^2 x 3) against its numpy versions: the libraries sum in float32 in
# their own order, the numpy versions in theirs (`tests/test_torch_native.py`
# holds 1e-4 on values of order 1): on 0..255 held to 2e-3, the integer and
# copy functions exactly. The align-corners resize also rounds its weights
# apart: the library computes each source position in float32 (y * 255 /
# 383 up to 255, an error up to 255 * 2^-24), the numpy version in float64,
# so a weight may differ by 1.5e-5 and a value on 0..255 by up to 3.9e-3
# (an H100 reads 3.4e-3): held to 5e-3.
NATIVE_ATOL = {"gaussian_blur": 2e-3, "bilinear_resize_ac": 5e-3, "photometric_jitter": 2e-3}
AUG_SCENES, AUG_STEPS, AUG_WORKERS = 5, 5, 4  # 5 steps hold the profiler window, steps 2 to 4
PROFILE_START, PROFILE_STEPS = 2, 3
# (c) Crash replay, the loss of the dumped batch through the kernels (fp32,
# TF32 off, exact kNN) against the plain CPU path, relative gap. CPU
# control on the same batch and weights: oneDNN's convolutions against
# PyTorch's own moved the loss by 8.0e-7 (fp32 medium model, protocol
# shape); phase 6 reads 1.3e-7 at the flagship shape.
REPLAY_RTOL = 1e-5
KUBRIC_SCENES, KUBRIC_TRACKS = 2, 1024
# The real-world scenes: 4 cameras x 12 frames at 192x256, 64 tracks.
REAL_T, REAL_H, REAL_W, REAL_TRACKS = EVAL_T, 192, 256, 64
PANOPTIC_CAMERAS = (1, 7, 14, 20)


def timed(fn, reps: int = 3):
    """(result, best wall ms of `reps` calls)."""
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return out, best


def phase_data_path(torch, smi, knn_ops, corr_ops):
    """Phase 11. Returns {path: launch totals}."""
    from mvtracker_torch import native
    from mvtracker_torch.cli import eval as cli_eval
    from mvtracker_torch.cli import train as cli_train
    from mvtracker_torch.config import build_model, load_config
    from mvtracker_torch.convert import random_state_dict
    from mvtracker_torch.datasets import synthetic
    from mvtracker_torch.datasets.augmentations import default_train_augmentations
    from mvtracker_torch.datasets.kubric import KubricMultiViewDataset, load_scene
    from mvtracker_torch.datasets.loader import PrefetchLoader, SyntheticSceneDataset
    from mvtracker_torch.datasets.real_world import dataset_from_name
    from mvtracker_torch.device import fp32_precision
    from mvtracker_torch.evaluation.evaluator import to_host
    from mvtracker_torch.evaluation.predictor import EvaluationPredictor
    from mvtracker_torch.presets import build_model as preset_model
    from mvtracker_torch.training import replay
    from mvtracker_torch.training import step as step_lib
    from mvtracker_torch.training.train import TrainConfig, Trainer

    counters = {"knn": knn_ops.knn_cuda, "knn_tiled": knn_ops.knn_tiled_cuda, "knn_exact": knn_ops.knn_exact_cuda,
                "corr": corr_ops.corr_select_cuda, "corr_bwd": corr_ops.corr_select_backward_cuda}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def made():
        return {name: fn.launches for name, fn in counters.items()}

    paths = {}
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    torch.cuda.empty_cache()

    # (a) The native library, built from native/datapath.cpp into the port's
    # build directory, against the numpy versions.
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native data path did not build (g++ on this host?); see the warning above")
    log(f"data path (a) native library {native.library_path().relative_to(ROOT)} built from "
        f"{native.SOURCE.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    video8 = rng.integers(0, 256, size=(V, T, H, W, 3), dtype=np.uint8)
    video = video8.astype(np.float32)
    frames = video.reshape(-1, H, W, 3)
    depth = np.where(rng.random((V, T, H, W)) < 0.1, 0.0, rng.uniform(0.5, 5.0, (V, T, H, W))).astype(np.float32)
    n = frames.shape[0]
    jitter = (np.full(n, frames.mean(), np.float32), rng.uniform(0.8, 1.2, n).astype(np.float32),
              rng.uniform(0.8, 1.2, n).astype(np.float32), rng.uniform(0.8, 1.2, n).astype(np.float32))
    out_h, out_w = 384, 512
    cases = {
        "gaussian_blur": (lambda: native.gaussian_blur(video.swapaxes(-1, -3), 5, 1.0),
                          lambda: native.gaussian_blur_plain(video.swapaxes(-1, -3), 5, 1.0)),
        "nearest_resize": (lambda: native.nearest_resize(video, out_h, out_w),
                           lambda: native.nearest_resize_plain(video, out_h, out_w)),
        "bilinear_resize_ac": (lambda: native.bilinear_resize_ac(video, out_h, out_w),
                               lambda: native.bilinear_resize_ac_plain(video, out_h, out_w)),
        "normalize_rgb": (lambda: native.normalize_rgb(video8), lambda: native.normalize_rgb_plain(video8)),
        "photometric_jitter": (lambda: native.photometric_jitter(frames, *jitter),
                               lambda: native.photometric_jitter_plain(frames, *jitter)),
        "depth_invalid_fraction": (lambda: native.depth_invalid_fraction(depth),
                                   lambda: native.depth_invalid_fraction_plain(depth)),
    }
    for name, (lib_fn, plain_fn) in cases.items():
        got, lib_ms = timed(lib_fn)
        want, plain_ms = timed(plain_fn, reps=1)
        err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
        log(f"data path (a) {name} at {V} x {T} x {H}x{W}(x3): native {lib_ms:.2f} ms, numpy {plain_ms:.2f} ms, "
            f"max |gap| {err:.3e} (limit {NATIVE_ATOL.get(name, 0.0)}) [{smi}]")
        if not err <= NATIVE_ATOL.get(name, 0.0):
            raise AssertionError(f"native {name} differs from its numpy version by {err}")

    # (b) Augmented training at the flagship width: configs/mvtracker.yaml
    # in bf16 with the transformer rematerialised, seeded weights, on
    # augmented randomized scenes through the disk cache and the prefetching
    # loader, as scripts/train_synthetic.py builds them.
    t0 = time.perf_counter()
    cache_dir = root / "scene_cache"
    scene_kw = dict(n_views=V, n_frames=T, height=H, width=W, n_tracks=N_QUERIES)
    renders = []
    real_render = synthetic.render_scene

    def counted_render(**kw):
        renders.append(kw["seed"])
        return real_render(**kw)

    synthetic.render_scene = counted_render
    try:
        dataset = SyntheticSceneDataset(n_scenes=AUG_SCENES, cache=True, seed=0, randomize=True, augment=True,
                                        disk_cache_dir=str(cache_dir), **scene_kw)
        cfg = load_config(str(ROOT / "configs" / "mvtracker.yaml"), ["model.compute_dtype=bfloat16", "model.remat=true"])
        model = build_model(cfg.model, device="cuda").train()
        model.load_state_dict(random_state_dict(model, seed=0))
        trainer = Trainer(model, TrainConfig(
            train_iters=ITERS, adaptive_iters=False, warmup_steps=0, telemetry_freq=1, save_ckpt_freq=10**6,
            profile_start_step=PROFILE_START, profile_n_steps=PROFILE_STEPS, exp_dir=str(root / "augmented")))
        if trainer.cfg.watchdog_timeout_s != 600.0:
            raise AssertionError("the trainer's watchdog is not at the JAX default")
        loader = PrefetchLoader(dataset, batch_size=1, num_workers=AUG_WORKERS, shuffle=True)
        drawn, steps = [], []

        def recording(it):
            for batch in it:
                drawn.append(windows_of(batch["query_points"], T, WINDOW, WINDOW // 2))
                yield batch

        def on_step(step, metrics):
            torch.cuda.synchronize()
            steps.append((time.perf_counter(), made(), {k: float(v) for k, v in metrics.items()}))

        reset()
        torch.cuda.reset_peak_memory_stats()
        t_fit = time.perf_counter()
        with LogRecords() as logs:
            state = trainer.fit(recording(loader.prefetching_iter()), max_steps=AUG_STEPS, on_step=on_step)
        paths["augmented_train"] = {k: made()[k] for k in ("knn", "corr", "corr_bwd")}
        telemetry = [m.split(" | ")[-1] for m in logs.messages if "mean/med/std" in m]
        memory = [m.split(": ", 1)[-1] for m in logs.messages if "device memory (MiB)" in m]
        last, last_t = {k: 0 for k in counters}, t_fit
        for i, (t, counts, metrics) in enumerate(steps):
            w = drawn[i]
            step_counts = {k: counts[k] - last[k] for k in ("knn", "corr", "corr_bwd")}
            want = {"knn": 1 + w * ITERS * 3, "corr": w * ITERS * 4, "corr_bwd": w * ITERS * 4}
            if step_counts != want or counts["knn_exact"] or counts["knn_tiled"]:
                raise AssertionError(f"augmented step {i}: launches {step_counts}, want {want} ({w} windows)")
            if not all(np.isfinite(v) for v in metrics.values()) or not metrics["grad_norm"] > 0:
                raise AssertionError(f"augmented step {i}: metrics {metrics}")
            log(f"data path (b) augmented step {i}: {(t - last_t) * 1e3:.2f} ms to its end with the batch's wait; "
                f"trainer telemetry (data, then the step to its loss fetch) {telemetry[i]}; loss {metrics['loss']:.6f}, "
                f"grad_norm {metrics['grad_norm']:.4f}; K1/K2/K3 launches {step_counts} ({w} windows); device memory "
                f"{memory[i] if i < len(memory) else 'not logged'} [{smi}]")
            last, last_t = counts, t
        if state.step != AUG_STEPS:
            raise AssertionError(f"the augmented run took {state.step} steps")
        trace = trainer.profile_trace
        if trace is None or not Path(trace).exists():
            raise AssertionError("the profiler window wrote no trace")
        with open(trace, "rb") as f:  # hundreds of MiB: count the device kernels' events without parsing
            kernels = f.read().count(b'"cat": "kernel"')
        tb = root / "augmented" / "tb"
        log(f"data path (b) augmented training: {AUG_STEPS} steps of configs/mvtracker.yaml (bf16, remat) on "
            f"{AUG_SCENES} augmented randomized scenes of {V} x {T} x {H}x{W}, {N_QUERIES} tracks, "
            f"{len(set(renders))} rendered into the disk cache, {AUG_WORKERS} loader workers: "
            f"{time.perf_counter() - t0:.1f} s; watchdog armed at {trainer.cfg.watchdog_timeout_s:.0f} s and "
            f"cancelled; TensorBoard {'on, events in ' + str(tb.relative_to(root)) if trainer.cfg.tensorboard and tb.exists() else 'off (torch.utils.tensorboard not importable here)'}; "
            f"profiler trace of steps {PROFILE_START}-{PROFILE_START + PROFILE_STEPS - 1}: "
            f"{os.path.getsize(trace) / 2**20:.1f} MiB, {kernels} device kernel events; "
            f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB [{smi}]")
        if not kernels:
            raise AssertionError("the profiler trace holds no device kernel")
        del trainer, state

        # The augmentation alone, on a cached scene, native and numpy.
        cached = SyntheticSceneDataset(n_scenes=AUG_SCENES, seed=0, randomize=True, disk_cache_dir=str(cache_dir),
                                       **scene_kw)
        dp, load_ms = timed(lambda: cached[0])
        _, aug_ms = timed(lambda: default_train_augmentations(dp, np.random.default_rng(1)))
        saved = native._lib
        native._lib, native._tried = None, True
        try:
            _, aug_numpy_ms = timed(lambda: default_train_augmentations(dp, np.random.default_rng(1)), reps=1)
        finally:
            native._lib = saved
        log(f"data path (b) one flagship scene: disk-cache read {load_ms:.1f} ms, default_train_augmentations "
            f"{aug_ms:.1f} ms with the native library, {aug_numpy_ms:.1f} ms with its numpy versions [{smi}]")

        # A second run on a fresh dataset over the same cache renders nothing.
        before = len(renders)
        again = SyntheticSceneDataset(n_scenes=AUG_SCENES, seed=0, randomize=True, augment=True,
                                      disk_cache_dir=str(cache_dir), **scene_kw)
        trainer = Trainer(model, TrainConfig(train_iters=ITERS, adaptive_iters=False, warmup_steps=0,
                                             save_ckpt_freq=10**6, exp_dir=str(root / "augmented_again")))
        reset()
        state = trainer.fit(iter(PrefetchLoader(again, batch_size=1, num_workers=AUG_WORKERS, shuffle=True)),
                            max_steps=2)
        if len(renders) != before or state.step != 2:
            raise AssertionError(f"the second run rendered {len(renders) - before} scenes, took {state.step} steps")
        log(f"data path (b) second run over the disk cache: 2 steps, 0 scenes rendered")
        del trainer, state, model
    finally:
        synthetic.render_scene = real_render
    torch.cuda.empty_cache()

    # (c) Crash replay: an evaluation hook that raises at step 2 makes the
    # trainer dump its batch and a checkpoint; the batch replays on the card
    # from that checkpoint and on the plain CPU path with the same weights.
    t0 = time.perf_counter()

    def medium_fp32(device):
        return preset_model("medium", vis_geom=True, vis_head_hidden=128, compute_dtype="float32",
                            knn_backend="exact", device=device).train()

    exp = root / "crash_run"
    crash_ds = SyntheticSceneDataset(n_scenes=3, cache=True, seed=555, randomize=True, n_views=4, n_frames=EVAL_T,
                                     height=128, width=128, n_tracks=PROTOCOL_QUERIES, texture_detail=1.0,
                                     texture_noise=1.0)

    def boom(state, step):
        raise RuntimeError(f"injected failure at step {step}")

    with fp32_precision(exact=True):
        model = seeded_weights(medium_fp32("cuda"))
        trainer = Trainer(model, TrainConfig(train_iters=PROTOCOL_ITERS, adaptive_iters=False, warmup_steps=0,
                                             eval_freq=2, exp_dir=str(exp)))
        try:
            trainer.fit(iter(PrefetchLoader(crash_ds, batch_size=1, shuffle=False, num_workers=1)), eval_fn=boom,
                        max_steps=5)
        except RuntimeError as e:
            if "injected failure at step 2" not in str(e):
                raise
        else:
            raise AssertionError("the injected failure did not reach the caller")
        dumps = sorted(os.listdir(exp / "crash"))
        if dumps != ["batch_step2.npz"]:
            raise AssertionError(f"crash dumps {dumps}")
        batch = replay.load_crash_batch(str(exp / "crash"))
        restored = medium_fp32("cuda")
        restorer = Trainer(restored, TrainConfig(exp_dir=str(exp)))
        _, ckpt_step = restorer.restore_latest(step_lib.init_state(restored, restorer.optimizer))
        reset()
        card = replay.replay(batch, restored, iters=PROTOCOL_ITERS)
        paths["crash_replay"] = {k: made()[k] for k in ("knn_exact", "corr", "corr_bwd")}
        cpu = replay.replay(batch, copy.deepcopy(restored).cpu(), iters=PROTOCOL_ITERS)
    gap = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    log(f"data path (c) crash replay of {dumps[0]} ({', '.join(f'{k} {tuple(v.shape)}' for k, v in batch.items())}) "
        f"from the checkpoint of step {ckpt_step}: card loss {card['loss']:.8f}, plain CPU loss {cpu['loss']:.8f}, "
        f"relative gap {gap:.2e} (limit {REPLAY_RTOL}); non-finite gradients card {card['nonfinite_grad_leaves']} "
        f"CPU {cpu['nonfinite_grad_leaves']}; launches {paths['crash_replay']}; {time.perf_counter() - t0:.1f} s [{smi}]")
    if not (np.isfinite(card["loss"]) and gap <= REPLAY_RTOL and ckpt_step == 2 and not card["nonfinite_grad_leaves"]):
        raise AssertionError("crash replay on the card does not give the plain CPU path's loss")
    del model, trainer, restored, restorer
    torch.cuda.empty_cache()

    # (d) The Kubric format through cli.train: two rendered scenes written in
    # its layout, read back, and 3 flagship steps of configs/mvtracker.yaml.
    t0 = time.perf_counter()
    kroot = root / "kubric"
    rendered = []
    for i in range(KUBRIC_SCENES):
        scene = synthetic.render_scene(seed=70 + i, n_views=V, n_frames=T, height=H, width=W, n_tracks=KUBRIC_TRACKS)
        write_kubric_scene(scene, kroot / f"scene_{i:03d}")
        rendered.append(scene)
    write_s = time.perf_counter() - t0
    for i, scene in enumerate(rendered):
        raw, read_ms = timed(lambda: load_scene(str(kroot / f"scene_{i:03d}"), sanity_check_projection=True), reps=1)
        depth_gap = float(np.max(np.abs(raw["videodepth"] - scene.videodepth) / np.maximum(scene.videodepth, 1e-6)))
        if not (np.array_equal(raw["video"], scene.video.astype(np.uint8).astype(np.float32))
                and np.array_equal(raw["tracks_3d"], scene.trajectory_3d) and depth_gap <= 2e-6
                and np.array_equal(raw["occlusion"], ~scene.visibility)):
            raise AssertionError(f"Kubric scene {i} read back differs (depth relative gap {depth_gap:.2e})")
        log(f"data path (d) Kubric scene {i}: {V} views x {T} frames x {H}x{W} RGBA PNG + float32 TIFF, "
            f"{KUBRIC_TRACKS} tracks; read back in {read_ms:.1f} ms, RGB equal, depth relative gap {depth_gap:.2e} "
            f"(float32 round trip of the euclidean conversion, limit 2e-6) [{smi}]")
    kubric = KubricMultiViewDataset(str(kroot), num_tracks=N_QUERIES, seed=0)
    order = PrefetchLoader(kubric, shuffle=True, seed=0)
    scenes_drawn = [int(order._order(0)[0]), int(order._order(0)[1]), int(order._order(1)[0])]
    windows = [windows_of(kubric[i].query_points_3d, T, WINDOW, WINDOW // 2) for i in scenes_drawn]
    exp = root / "kubric_exp"
    argv = ["--config", str(ROOT / "configs" / "mvtracker.yaml"), "--device", "cuda", "data.dataset=kubric",
            f"data.root={kroot}", "trainer.total_steps=3", f"trainer.exp_dir={exp}", "trainer.telemetry_freq=1"]
    torch.cuda.empty_cache()
    reset()
    t1 = time.perf_counter()
    with LogRecords() as logs:
        state = cli_train.main(argv)
    train_s = time.perf_counter() - t1
    paths["kubric_cli_train"] = {k: made()[k] for k in ("knn", "corr", "corr_bwd")}
    # adaptive_iters with 100 warm-up steps: one iteration a step.
    want = {"knn": sum(1 + w * 3 for w in windows), "corr": sum(w * 4 for w in windows),
            "corr_bwd": sum(w * 4 for w in windows)}
    if state.step != 3 or paths["kubric_cli_train"] != want:
        raise AssertionError(f"cli.train on Kubric: {state.step} steps, launches {made()}, want {want}")
    telemetry = [m.split(" | ")[-1] for m in logs.messages if "mean/med/std" in m]
    log(f"data path (d) cli.train --config configs/mvtracker.yaml data.dataset=kubric trainer.total_steps=3: "
        f"{train_s:.1f} s (fp32, 1 iteration a step in the warm-up), scenes {scenes_drawn} with {windows} windows; "
        f"launches {paths['kubric_cli_train']}; telemetry {telemetry}; writing the scenes {write_s:.1f} s [{smi}]")
    del state
    torch.cuda.empty_cache()

    # (e) Panoptic Studio and DexYCB formats through cli.eval, the medium
    # model with seeded weights at the predictor's defaults.
    t0 = time.perf_counter()
    rroot = root / "real"
    for name, seed in (("panoptic", 80), ("dexycb", 81)):
        scene = synthetic.render_scene(seed=seed, n_views=4, n_frames=REAL_T, height=REAL_H, width=REAL_W,
                                       n_tracks=REAL_TRACKS)
        if name == "panoptic":
            write_panoptic_scene(scene, rroot / "panoptic-multiview" / "seq_0", PANOPTIC_CAMERAS)
        else:
            write_dexycb_scene(scene, rroot / "dex-ycb-multiview" / "seq_0")
    exp = root / "medium_exp"
    medium = seeded_weights(preset_model("medium", vis_geom=True, vis_head_hidden=128, device="cuda"))
    saver = Trainer(medium, TrainConfig(exp_dir=str(exp)))
    saver.save(step_lib.init_state(medium, saver.optimizer), 0)
    medium_argv = ["--config", str(ROOT / "configs" / "mvtracker_medium.yaml"), "--device", "cuda",
                   "model.vis_geom_features=true", "model.vis_head_hidden=128", f"data.root={rroot}",
                   f"trainer.exp_dir={exp}", "eval.interp_shape=[384, 512]"]
    paths["realworld_cli_eval"] = {"knn": 0, "corr": 0}
    for name in ("panoptic-multiview", "dexycb-multiview"):
        dp = dataset_from_name(name, str(rroot))[0]
        reset()
        t1 = time.perf_counter()
        with LogRecords() as logs:
            summary = cli_eval.main(medium_argv + [f"data.dataset={name}", f"eval.setting={name}"])
        eval_s = time.perf_counter() - t1
        counts = {k: made()[k] for k in ("knn", "corr")}
        # The support grid's points start at frame 0, so both windows run.
        k1, k2 = eval_launches(SimpleNamespace(query_points_3d=np.zeros((1, 4))), SERVE_ITERS, False)
        if "evaluating checkpoint at step 0" not in logs.messages or counts != {"knn": 2 * k1, "corr": 2 * k2}:
            raise AssertionError(f"cli.eval on {name}: launches {made()}, want {2 * k1}, {2 * k2} (first call "
                                 "untimed, then timed)")
        for k in counts:
            paths["realworld_cli_eval"][k] += counts[k]
        fps = summary["fps"]
        log(f"data path (e) cli.eval on {name} ({dp.video.shape[0]} views x {dp.video.shape[1]} frames x "
            f"{REAL_H}x{REAL_W}, {dp.query_points_3d.shape[0]} tracks + 5x5 support points a view, 384x512, 6 "
            f"iterations, bf16): AJ {summary['all_any']['average_jaccard']:.3f}, OA "
            f"{summary['all_any']['occlusion_accuracy']:.3f}, ATE {summary['all_any']['ate_visible']:.3f}; timed "
            f"request {dp.video.shape[1] / fps * 1e3:.2f} ms ({fps:.2f} fps); launches {counts}; {eval_s:.1f} s "
            f"[{smi}]")
    exact = medium_fp32("cuda").eval()
    exact.load_state_dict(medium.state_dict())
    del medium
    with torch.no_grad(), fp32_precision(exact=True):
        for name in ("panoptic-multiview", "dexycb-multiview"):
            dp = dataset_from_name(name, str(rroot))[0]
            out = EvaluationPredictor(exact)(*request_args(dp))
            check_plain(exact, {}, [dp], {dp.seq_name: (to_host(out["traj"]), to_host(out["vis"]))},
                        SEEDED_PLAIN_LIMITS, f"data path (e) {name} at the defaults, fp32, exact kNN")
    log(f"data path (e) real-world formats: {time.perf_counter() - t0:.1f} s [{smi}]")
    del exact
    tmp.cleanup()
    return paths


# Phase 12: the other model families. The flagship request shape; seeded
# weights with the flow head x FLOW_HEAD_GAIN (tracks move by a median of
# about 1e-2 units, 7e-3 pixels for the 2D tracker, and no control forks).
SPAT_CONFIG = "configs/spatracker_multiview.yaml"
COT_CONFIG = "configs/cotracker2d.yaml"
ZOO_CONFIG = "configs/cotracker3_offline.yaml"
FAMILY_SEEDS = (60, 61, 62)
FAMILY_TRAIN_STEPS = 3
COT2D_SCRIPT_ARGV = ["--steps", "30", "--train_scenes", "4", "--eval_scenes", "2", "--device", "cuda"]
# Card (fp32, TF32 off) against the plain CPU path. Limits set before the
# first card run from `scripts/control_torch_families.py` on the card
# host's CPU at this shape (median / p90 / max of |gap|):
# - SpaTracker: the splat's deposits in reverse order move traj by
#   0 / 1.5e-8 / 1.8e-7 and vis by 6.0e-8 / 1.2e-7 / 5.4e-7; rgb + 1e-3
#   traj 0 / 1.5e-8 / 2.4e-7, vis 1.2e-7 / 2.4e-7 / 8.9e-7; queries + 1e-6
#   traj 1.0e-6 / 1.0e-6 / 1.2e-6 (the move itself), vis up to 1.7e-6; the
#   tracks move by a median 2.0e-2, so the model does not fork. The limits
#   are the flagship's card-vs-CPU limits of phase 4, room for cuDNN's and
#   the card's matmul rounding, and far below a dropped update;
# - the 2D tracker through the adapter: queries + 1e-6 move traj by 1.2e-5 /
#   1.1e-4 / 4.3e-4 (2D tracks lifted through a depth map of noise, which a
#   rounding-size move of a pixel turns into world units) and vis by 3.0e-6 /
#   8.7e-6 / 4.4e-5; rgb + 1e-3 traj max 2.6e-6, vis max 9.4e-6. Limits at
#   about twice the query control;
# - the NCC tracker on the rendered scene: rgb + 1e-3 leaves all 6144
#   positions equal, but that control does not reach the card's rounding.
#   More than half of the scene's 7x7 windows are flat (one colour): a flat
#   template's zero-mean values are the rounding error of its mean, so which
#   candidate wins there is decided by rounding, in the JAX tracker as here,
#   and the track follows another template from then on. The first card run
#   of this phase (B1) found 0.986328 of positions equal against a limit of
#   0.99 set from that control. The control that reaches the rounding, set
#   after B1: the same CPU tracker in float64 against float32 parts 2 tracks,
#   46 positions (0.9925 equal); two float32 evaluations in other summation
#   orders each part from the exact one, so up to twice that, about 1.5
#   percent, may differ. Limit 0.98.
SPAT_PLAIN_LIMITS = {"traj": {"median": 1e-5, "p90": 1e-4, "max": 2e-4},
                     "vis": {"median": 1e-5, "p90": 1e-4, "max": 5e-4}}
COT_PLAIN_LIMITS = {"traj": {"median": 3e-5, "p90": 3e-4, "max": 1e-3},
                    "vis": {"median": 1e-5, "p90": 3e-5, "max": 1e-4}}
NCC_EQUAL_SHARE_MIN = 0.98


def phase_other_families(torch, smi, knn_ops, corr_ops):
    """Phase 12: the triplane SpaTracker, the learned 2D tracker and the
    monocular zoo through their entry points. Returns {path: launch totals},
    every one of which must be 0."""
    import dataclasses
    import importlib.util

    from mvtracker_torch.cli import eval as cli_eval
    from mvtracker_torch.cli import train as cli_train
    from mvtracker_torch.config import build_dataset, build_model, load_config
    from mvtracker_torch.device import fp32_precision
    from mvtracker_torch.models.cotracker2d import LearnedTracker2D
    from mvtracker_torch.models.monocular import MonocularToMultiViewAdapter, SimpleNNTracker2D, pick_best_view
    from mvtracker_torch.ops.splat import splat_points
    from mvtracker_torch.scene import make_scene

    dev = torch.device("cuda")
    counters = {"knn": knn_ops.knn_cuda, "knn_tiled": knn_ops.knn_tiled_cuda, "knn_exact": knn_ops.knn_exact_cuda,
                "corr": corr_ops.corr_select_cuda, "corr_bwd": corr_ops.corr_select_backward_cuda}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def made():
        return {name: fn.launches for name, fn in counters.items()}

    paths = {}
    tmp = tempfile.TemporaryDirectory()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False  # PyTorch's defaults
    torch.cuda.empty_cache()
    shape = f"{V} views x {T} frames x {H}x{W}, {N_QUERIES} queries, iters {ITERS}"
    scenes = [make_scene(np.random.default_rng(seed), V, T, H, W, N_QUERIES) for seed in FAMILY_SEEDS]

    # (a) The triplane SpaTracker.
    cfg = load_config(str(ROOT / SPAT_CONFIG))
    model = seeded_weights(build_model(cfg.model, device=dev))
    width = (f"{model.fmaps_dim} channels, hidden {model.updateformer.input_transform.out_features}, S="
             f"{model.sliding_window_len}, {model.corr_n_levels} levels of {model.triplane_res}^2 planes, radius "
             f"{model.corr_patch_radius}, {model.support_memory_tokens} memory tokens")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset()
    times = []
    for scene in scenes:
        args = to_device(scene, dev)
        t0 = time.perf_counter()
        out = model(*args, iters=ITERS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if out["traj"].shape != (T, N_QUERIES, 3) or out["vis"].shape != (T, N_QUERIES):
            raise AssertionError(f"spatracker: output shapes {tuple(out['traj'].shape)}, {tuple(out['vis'].shape)}")
        if not (bool(torch.isfinite(out["traj"]).all()) and bool(torch.isfinite(out["vis"]).all())):
            raise AssertionError("spatracker: non-finite outputs")
    paths["spatracker_serving"] = made()
    log(f"other families (a) spatracker_multiview ({width}), fp32, seeded weights, {shape}: ms per request "
        f"{[round(x, 2) for x in times]} (the first cold); max_memory_allocated "
        f"{(torch.cuda.max_memory_allocated() - resident) / 2**20:.1f} MiB above {resident / 2**20:.1f} MiB of "
        f"weights and scene; launches {paths['spatracker_serving']} [{smi}]")
    # The splat alone at this request's level-0 cloud (random points over the
    # plane): PyTorch's default index_put_, as the path runs it, against the
    # one torch.use_deterministic_algorithms selects, timed in turns.
    r, p0 = model.triplane_res, V * (H // model.stride) * (W // model.stride)
    gen = torch.Generator(device=dev).manual_seed(0)
    pts = torch.rand(T, p0, 2, device=dev, generator=gen) * (r - 1)
    feats = torch.randn(T, p0, model.fmaps_dim, device=dev, generator=gen)
    metric = torch.zeros(T, p0, device=dev)

    def splat():
        return splat_points(pts, feats, metric, r, r)

    def splat_ms(deterministic):
        torch.use_deterministic_algorithms(deterministic)
        try:
            return wrapper_ms(splat, reps=10), splat()
        finally:
            torch.use_deterministic_algorithms(False)

    runs = [splat_ms(d) for d in (False, True, True, False)]
    same = all(torch.equal(runs[0][1], other[1]) for other in runs[1:])
    log(f"other families (a) one plane's splat of {T} x {p0} points x {model.fmaps_dim} channels onto {r}^2 (three a "
        f"request): default index_put_ {runs[0][0]:.3f} and {runs[3][0]:.3f} ms, deterministic {runs[1][0]:.3f} and "
        f"{runs[2][0]:.3f} ms (in turns); the four results equal bit for bit: {same} [{smi}]")
    del pts, feats, metric, runs
    bf16 = build_model(dataclasses.replace(cfg.model, compute_dtype="bfloat16"), device=dev)
    bf16.load_state_dict(model.state_dict())
    args = to_device(scenes[0], dev)
    reset()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        out_bf16 = bf16(*args, iters=ITERS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    paths["spatracker_bf16"] = made()
    if not bool(torch.isfinite(out_bf16["traj"]).all()):
        raise AssertionError("spatracker bf16: non-finite outputs")
    del bf16
    with fp32_precision(exact=True):
        got = model(*args, iters=ITERS)
        t0 = time.perf_counter()
        want = copy.deepcopy(model).cpu()(*to_device(scenes[0], torch.device("cpu")), iters=ITERS)
        cpu_s = time.perf_counter() - t0
    log(f"other families (a) spatracker_multiview bf16, scene {FAMILY_SEEDS[0]}: ms {[round(x, 2) for x in times]} "
        f"(first, then warm); traj gap to the fp32 request (median/p90/max) "
        f"{fmt_gap(gap_stats(out_bf16['traj'].cpu(), got['traj'].cpu()))}; launches {paths['spatracker_bf16']} "
        f"[{smi}]")
    check_gaps({"spatracker": (got["traj"].cpu(), got["vis"].cpu())},
               {"spatracker": (want["traj"], want["vis"])}, SPAT_PLAIN_LIMITS,
               f"other families (a) spatracker fp32 (TF32 off) card vs plain CPU path ({cpu_s:.1f} s on the CPU) [{smi}]")
    del model, got, want, out_bf16
    torch.cuda.empty_cache()

    exp = os.path.join(tmp.name, "spatracker")
    argv = ["--config", str(ROOT / SPAT_CONFIG), "--device", "cuda", f"trainer.total_steps={FAMILY_TRAIN_STEPS}",
            f"trainer.save_ckpt_freq={FAMILY_TRAIN_STEPS}", "trainer.adaptive_iters=false", "trainer.telemetry_freq=1",
            f"trainer.exp_dir={exp}"]
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    with LogRecords() as logs:
        state = cli_train.main(argv)
    train_s = time.perf_counter() - t0
    paths["spatracker_cli_train"] = made()
    telemetry = [m.split(" | ")[-1] for m in logs.messages if "mean/med/std" in m]
    if state.step != FAMILY_TRAIN_STEPS:
        raise AssertionError(f"spatracker cli.train: {state.step} steps, want {FAMILY_TRAIN_STEPS}")
    log(f"other families (a) cli.train {SPAT_CONFIG} (fp32, {cfg.trainer.train_iters} iterations, no remat): "
        f"{FAMILY_TRAIN_STEPS} steps in {train_s:.1f} s with the scenes' rendering; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; the trainer's telemetry per step (data, then the step "
        f"to its loss fetch): {telemetry}; launches {paths['spatracker_cli_train']} [{smi}]")
    del state
    torch.cuda.empty_cache()

    # (b) The learned 2D tracker: its training script, then one request.
    spec = importlib.util.spec_from_file_location("train_cotracker2d_torch",
                                                  ROOT / "scripts" / "train_cotracker2d_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    reset()
    t0 = time.perf_counter()
    with LogRecords() as logs:
        report = script.main(COT2D_SCRIPT_ARGV + ["--exp_dir", os.path.join(tmp.name, "cotracker2d")])
    script_s = time.perf_counter() - t0
    paths["cotracker2d_script"] = made()
    telemetry = [m.split(" | ")[-1] for m in logs.messages if "mean/med/std" in m]
    ajs = {k: report[k].get("average_jaccard") for k in ("learned_cotracker2d", "ncc_template", "copycat")}
    if not all(v is not None and np.isfinite(v) for v in ajs.values()):
        raise AssertionError(f"train_cotracker2d_torch: AJ {ajs}")
    log(f"other families (b) scripts/train_cotracker2d_torch.py {' '.join(COT2D_SCRIPT_ARGV)}: {script_s:.1f} s; "
        f"AJ {ajs}; telemetry {telemetry}; launches {paths['cotracker2d_script']} [{smi}]")

    cot_cfg = load_config(str(ROOT / COT_CONFIG))
    adapter = build_model(cot_cfg.model, device=dev)
    seeded_weights(adapter.tracker_2d.model)
    reset()
    times = []
    with fp32_precision(exact=True):
        for _ in range(2):
            t0 = time.perf_counter()
            got = adapter(*to_device(scenes[0], dev))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        paths["cotracker2d_request"] = made()
        cpu_adapter = MonocularToMultiViewAdapter(
            LearnedTracker2D(copy.deepcopy(adapter.tracker_2d.model).cpu(), n_iters=adapter.tracker_2d.n_iters),
            device="cpu")
        want = cpu_adapter(*to_device(scenes[0], torch.device("cpu")))
    check_gaps({"cotracker2d": (got["traj"].cpu(), got["vis"].cpu())}, {"cotracker2d": (want["traj"], want["vis"])},
               COT_PLAIN_LIMITS, f"other families (b) cotracker2d through the adapter, fp32 (TF32 off), {shape}, ms "
               f"{[round(x, 2) for x in times]} (first, then warm), card vs plain CPU path [{smi}]")
    del adapter, cpu_adapter

    # (c) The monocular zoo through cli.eval: no hub cache, so the report is
    # logged and the NCC tracker runs on the card.
    zoo = load_config(str(ROOT / ZOO_CONFIG))
    for name, extra in (("cotracker3_offline", []), ("monocular_nn", ["model.name=monocular_nn"])):
        built = build_model(dataclasses.replace(zoo.model, name=name), device=dev)
        if not (isinstance(built.tracker_2d, SimpleNNTracker2D) and built.device.type == "cuda"):
            raise AssertionError(f"{name}: built {type(built.tracker_2d).__name__} on {built.device}")
        reset()
        t0 = time.perf_counter()
        with LogRecords() as logs:
            summary = cli_eval.main(["--config", str(ROOT / ZOO_CONFIG), "--device", "cuda", "eval.max_sequences=1",
                                     f"trainer.exp_dir={os.path.join(tmp.name, 'zoo')}", *extra])
        eval_s = time.perf_counter() - t0
        paths[f"zoo_cli_eval_{name}"] = made()
        reports = [m for m in logs.messages if "falling back to the in-repo NCC tracker" in m]
        if not reports:
            raise AssertionError(f"{name}: no report of the missing hub checkpoint in the log")
        log(f"other families (c) cli.eval {ZOO_CONFIG} {' '.join(extra)}: {eval_s:.1f} s for one scene of "
            f"{zoo.data.n_views} x {zoo.data.n_frames} x {zoo.data.height}x{zoo.data.width}, {zoo.data.num_tracks} "
            f"tracks (AJ {summary['all_any']['average_jaccard']:.3f}, fps {summary['fps']:.2f}); report: {reports[0]}; "
            f"launches {paths[f'zoo_cli_eval_{name}']} [{smi}]")

    dp = build_dataset(zoo.data)[0]  # the scene cli.eval evaluated
    host = [torch.from_numpy(np.asarray(a, np.float32)) for a in (dp.video, dp.query_points_3d, dp.videodepth,
                                                                  dp.intrs, dp.extrs)]
    view, pix = pick_best_view(*host[1:])
    ncc = SimpleNNTracker2D()
    equal = vis_equal = total = parted = 0
    card_ms = cpu_ms = 0.0
    reset()
    for vi in range(dp.video.shape[0]):
        sel = view == vi
        if not bool(sel.any()):
            continue
        queries = torch.cat([host[1][sel, :1], pix[sel]], dim=1)
        rgbs = host[0][vi].to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracks_g, vis_g = ncc(rgbs, queries.to(dev))
        torch.cuda.synchronize()
        card_ms += (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        tracks_c, vis_c = ncc(host[0][vi], queries)
        cpu_ms += (time.perf_counter() - t0) * 1e3
        same = (tracks_g.cpu() == tracks_c).all(-1)
        equal += int(same.sum())
        parted += int((~same).any(0).sum())
        vis_equal += int((vis_g.cpu() == vis_c).sum())
        total += vis_c.numel()
    paths["ncc_direct"] = made()
    share = equal / total
    log(f"other families (c) NCC tracker on that scene's views, card vs CPU: share of equal positions {share:.6f} "
        f"(limit {NCC_EQUAL_SHARE_MIN}), of equal visibility {vis_equal / total:.6f}, {total} positions, {parted} of "
        f"{dp.query_points_3d.shape[0]} tracks parting somewhere; "
        f"{card_ms:.2f} ms on the card (first calls), {cpu_ms:.2f} ms on the CPU [{smi}]")
    if share < NCC_EQUAL_SHARE_MIN:
        raise AssertionError(f"NCC tracker card vs CPU: {share:.6f} of positions equal")
    tmp.cleanup()
    return paths


# -- Phase 13: the last models ------------------------------------------------------
# VGGT-1B (defaults) on the 4 views of one rendered flagship scene at t = 0.
VGGT_SIZE, VGGT_WIDE = (518, 518), (294, 518)  # (H, W); 294 rows: a 21 x 37 patch grid
VGGT_REQUESTS = 3
# The card-vs-CPU model: full width, 4 frame + 4 global and 2 DINOv2 blocks.
# Depth 4 and not 2: below 3 the DPT heads' taps (layers q-1, 2q-1, 3q-1 and
# depth-1 for q = depth // 4, the JAX rule) name a layer that is not there.
VGGT_CUT = dict(depth=4, vit_depth=2)
# Card vs plain CPU (TF32 off) on that cut model at S = 2, 518^2: per output
# the max |gap| over the output's largest |value|, and the median |gap|
# over the median |value|.
# The CPU control (`scripts/control_torch_last_models.py` on the card host,
# images + 1e-6) moved the outputs by up to 2.1e-5 (max) and 7.2e-6
# (median); the card read 7.9e-6 and 3.2e-6.
VGGT_PLAIN_MAX_REL, VGGT_PLAIN_MEDIAN_REL = 1e-4, 2e-5
GENERIC_SEED = 80  # the rendered flagship scene of phase 13
# The tracker on it (fp32, TF32 off, exact kNN, seeded weights with the flow
# head x5), card vs plain CPU. Phase 4's limits (max 2e-4 / 5e-4, medians
# 1e-5) do not hold on this scene for the CPU alone: a few of the 320 tracks
# fork. Readings (median, p90, max) of the card against the CPU, the same in
# every run of the unchanged path, and of the CPU control
# (`scripts/control_torch_last_models.py --parts generic` on the card host:
# every query moved by 1e-6). The traj median keeps phase 4's limit; every
# other limit is three times the larger reading.
GENERIC_CARD_READINGS = {"traj": (5.96e-7, 2.07e-5, 8.37e-3), "vis": (9.63e-6, 1.53e-4, 3.99e-2)}
GENERIC_CONTROL_READINGS = {"traj": (1.52e-6, 5.04e-5, 2.23e-3), "vis": (1.72e-5, 5.95e-4, 3.38e-2)}
GENERIC_PLAIN_LIMITS = {
    key: {stat: 3 * max(GENERIC_CARD_READINGS[key][i], GENERIC_CONTROL_READINGS[key][i])
          for i, stat in enumerate(("median", "p90", "max"))}
    for key in ("traj", "vis")}
GENERIC_PLAIN_LIMITS["traj"]["median"] = E2E_TRAJ_MEDIAN
GENERIC_UNIFORM, GENERIC_KMEANS = 256, 64  # queries at frame 0; k-means centres at frame T // 2
# The splatting baselines on that scene's first frames; widths as in JAX
# (capacity 32768, 256^2, 10 motion bases). Iterations and frames cut (the
# JAX defaults: 10000 at t = 0, 2000 per later frame, segments of 100,
# densification from 500 every 100; Shape of Motion 2000 iterations over all
# frames). fit_scene densifies where a segment ends on a multiple of 100
# from `densify_start` on: here once, at step 100.
FIT_T = 4
D3_ITERS_FIRST, D3_ITERS_REST, D3_SEGMENT, D3_DENSIFY_START = 100, 10, 50, 50
SOM_ITERS, SOM_SEGMENT = 30, 15
SOM_POINTS = 16384  # foreground + background gaussians, drawn from frame 0's depth
# Densification held card vs plain CPU on the fit's own state and gradient
# statistics, with the threshold lowered so that the requests outnumber the
# free slots by this factor (clones, splits and dropped requests all occur).
DENSIFY_OVERBOOK = 1.25
# The full-size render (every slot of the fitted state at t=0, the free ones
# at opacity logit -1e9 as `train_segment` renders them, at 256^2) and its
# gradients, card vs plain CPU (TF32 off): rgb, alpha, depth max |gap|;
# each gradient leaf's max |gap| over its largest |value|, of a squared loss.
# The CPU controls (chunk 1024 against 512, `scripts/control_torch_last_models.py`
# on the card host): a seeded cloud moved the outputs by up to 2.1e-6 and the
# gradients by 3.6e-7; on this fitted state the squared loss's gradients
# moved by 2.2e-7, the fit's own L1 loss's by 2.5e-2 (colours), because 267
# residuals changed sign at |x|'s kink. So the check uses the squared loss.
RENDER_ATOL, RENDER_GRAD_RTOL = 1e-5, 1e-4


def cut_datapoint(dp, t):
    """The first `t` frames of `dp` and the tracks queried in them."""
    import dataclasses

    keep = dp.query_points_3d[:, 0] < t
    return dataclasses.replace(
        dp, video=dp.video[:, :t], videodepth=dp.videodepth[:, :t], intrs=dp.intrs[:, :t], extrs=dp.extrs[:, :t],
        segmentation=dp.segmentation[:, :t], trajectory=dp.trajectory[:, :t, keep],
        visibility=dp.visibility[:, :t, keep], trajectory_3d=dp.trajectory_3d[:t, keep],
        query_points_3d=dp.query_points_3d[keep], valid=None if dp.valid is None else dp.valid[:t, keep])


def write_generic_scene(dp, path) -> None:
    """`dp` in the generic layout with the port's writer: RGB PNGs, `.npy`
    depth, `cameras.npz`."""
    from mvtracker_torch.datasets.image_io import write_png

    os.makedirs(path)
    np.savez(os.path.join(path, "cameras.npz"), intrinsics=dp.intrs[:, 0], extrinsics=dp.extrs[:, 0])
    for vi in range(dp.video.shape[0]):
        for sub in ("rgb", "depth"):
            os.makedirs(os.path.join(path, f"view_{vi}", sub))
        for ti in range(dp.video.shape[1]):
            write_png(os.path.join(path, f"view_{vi}", "rgb", f"{ti:05d}.png"), dp.video[vi, ti].astype(np.uint8))
            np.save(os.path.join(path, f"view_{vi}", "depth", f"{ti:05d}.npy"), dp.videodepth[vi, ti])


def frame_cloud(torch, dp, t, n_static, dev):
    """World points, colours in [0, 1] and a moving-object flag of every
    valid depth pixel of frame `t` over the views (numpy)."""
    from mvtracker_torch.utils import geometry as geo

    d = torch.as_tensor(dp.videodepth[:, t], device=dev)
    world = geo.unproject_depth_to_world(d, geo.invert_intrinsics(torch.as_tensor(dp.intrs[:, t], device=dev)),
                                         geo.invert_extrinsics(torch.as_tensor(dp.extrs[:, t], device=dev)), 1)
    valid = (d > 0).cpu().numpy()
    return (world.cpu().numpy()[valid], (dp.video[:, t][valid] / 255.0).astype(np.float32),
            (dp.segmentation[:, t][valid] > n_static).astype(np.float32))


def rel_gap(got, want) -> tuple[float, float]:
    """(max |gap| / max |want|, median |gap| / median |want|)."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    w = np.abs(np.asarray(want, np.float64))
    return float(d.max() / max(w.max(), 1e-30)), float(np.median(d) / max(np.median(w), 1e-30))


def knn_against_exact(torch, knn_ops, ref, query, k, self_query=False) -> dict:
    """K1 on (ref, query) against the exact plain kNN (ties to the lower
    index): distances within the kNN tolerance, each returned index at its
    distance, neighbour sets equal unless the k-th and (k+1)-th distances
    tie. Returns the max distance error and the ties met: tied neighbour
    pairs among the exact ranks, rows whose order differs from the exact
    one (a tie broken the other way), rows whose set differs at a tie; for
    a cloud queried with itself also the points with a twin at distance 0
    and the rows whose rank 0 is not the point itself."""
    ref, query = ref.float().contiguous(), query.float().contiguous()
    b, n = ref.shape[:2]
    kk = min(k, n)
    d_k, i_k = knn_ops.knn_cuda(ref, query, k)
    d_p, i_p = knn_ops.knn_exact_plain(ref, query, kk + 1 if kk < n else kk, max_elems=1 << 26)
    torch.cuda.synchronize()
    d_k, i_k = d_k[..., :kk], i_k[..., :kk]
    err = (d_k - d_p[..., :kk]).abs()
    if not bool((err <= KNN_ATOL + KNN_RTOL * d_p[..., :kk]).all()):
        raise AssertionError(f"K1 vs exact kNN: distances differ by {float(err.max()):.3e}")
    rows = torch.gather(ref, 1, i_k.reshape(b, -1, 1).expand(-1, -1, 3)).reshape(*i_k.shape, 3)
    true_d = (rows - query[:, :, None]).pow(2).sum(-1).clamp_min(1e-12).sqrt()
    if not bool(((true_d - d_k).abs() <= KNN_ATOL + KNN_RTOL * true_d).all()):
        raise AssertionError("K1 vs exact kNN: an index does not lie at its distance")
    same = (i_k.sort(-1).values == i_p[..., :kk].sort(-1).values).all(-1)
    if kk < n:
        d2 = d_p.pow(2)
        tie = (d2[..., kk] - d2[..., kk - 1]) <= 2 * (KNN_ATOL + KNN_RTOL * d2[..., kk])
        if not bool((same | tie).all()):
            raise AssertionError("K1 vs exact kNN: neighbour sets differ beyond ties")
    stats = {"max_err": float(err.max()), "tied_pairs": int((d_p[..., 1:kk] == d_p[..., :kk - 1]).sum()),
             "reordered_rows": int((i_k != i_p[..., :kk]).any(-1).sum()), "parted_rows": int((~same).sum())}
    if self_query:
        stats["twins"] = int((d_p[..., 1] == d_p[..., 0]).sum())  # rank 0 is at distance 0 (or a twin)
        stats["rank0_not_self"] = int((i_k[..., 0] != torch.arange(n, device=ref.device)).sum())
    return stats


def recorded_knn_against_exact(torch, knn_ops, calls, self_query=False) -> list:
    """`knn_against_exact` on every recorded call `(ref, query, k)` that
    `auto` sends to K1; one stats dict per call, with its shape."""
    out = []
    for ref, query, k in calls:
        if knn_ops.resolve_backend("auto", ref.shape[1]) != "fused":
            continue
        st = knn_against_exact(torch, knn_ops, ref, query, k, self_query=self_query)
        out.append({"B": ref.shape[0], "N": ref.shape[1], "M": query.shape[1], "k": k, **st})
    if not out:
        raise AssertionError(f"none of {len(calls)} recorded kNN calls goes to K1")
    return out


def knn_call(args, kw, out):
    """(ref, query, k) of a recorded `knn` call."""
    return args[0], args[1], kw["k"] if "k" in kw else args[2]


@contextlib.contextmanager
def recording(module, name: str, calls: list, keep=lambda args, kw, out: args):
    """Record what `keep` picks of each call of `module.name` into `calls`
    while the block runs; the calls themselves are unchanged."""
    original = getattr(module, name)

    def wrapper(*args, **kw):
        out = original(*args, **kw)
        calls.append(keep(args, kw, out))
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, original)


def on_cpu(tree):
    """A named tuple of tensors, or of dicts of tensors, moved to the CPU."""
    return tree.__class__(*({k: v.cpu() for k, v in x.items()} if isinstance(x, dict) else x.cpu() for x in tree))


def leaves_of(a, b):
    """(name, leaf of a, leaf of b) of two named tuples of the same kind,
    through dicts."""
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, dict):
            yield from ((f"{name}.{k}", x[k], y[k]) for k in x)
        else:
            yield name, x, y


def fit_render_inputs(fitted, video01, seg):
    """The t=0 render of a fitted Dynamic 3DGS state as `train_segment`
    renders it (every slot, the free ones at opacity logit -1e9) and view
    0's target (rgb and foreground mask), as numpy arrays."""
    opac = np.where(fitted["active"], fitted["logit_opacities"], np.float32(-1e9)).astype(np.float32)
    inputs = [fitted["means3d"][0], fitted["rotations"][0], fitted["log_scales"], opac,
              np.concatenate([fitted["rgb_colors"], fitted["seg_colors"]], -1)]
    return inputs, np.concatenate([video01[0, 0], seg[0, 0, ..., None]], -1)


def time_knn_shape(torch, knn_ops, pts, k, label, smi):
    """Log K1's device time on `pts` as its own queries, the plain
    version's, and the bound."""
    n = pts.shape[1]
    ms = device_ms(lambda: knn_ops.knn_cuda(pts, pts, k), reps=10)
    plain = device_ms(lambda: knn_ops.knn_plain(pts, pts, k), reps=2, replays=1)
    bnd, by = knn_bound(1, n, n, k)
    log(f"last models {label}: K1 at k={k}, M=N={n}: {ms:.5f} ms on the device, plain {plain:.5f} ms, bound "
        f"{bnd:.5f} ms ({by}), {ms / bnd:.1f} times the bound [{smi}]")


def phase_last_models(torch, smi, knn_ops, corr_ops):
    """Phase 13. Returns ({path: launches of its kernels}, {path: launch
    totals of a path with no kNN or correlation stage})."""
    import dataclasses

    from mvtracker_torch.convert import random_state_dict
    from mvtracker_torch.datasets import synthetic
    from mvtracker_torch.datasets.generic_scene import GenericSceneDataset, align_estimated_cameras_to_gt
    from mvtracker_torch.device import fp32_precision
    from mvtracker_torch.evaluation.cached import CachedPredictionPredictor
    from mvtracker_torch.evaluation.evaluator import Evaluator
    from mvtracker_torch.evaluation.query_sampling import SamplingSpec, sample_queries_from_depth
    from mvtracker_torch.models import dynamic3dgs as d3
    from mvtracker_torch.models import shape_of_motion as som
    from mvtracker_torch.models import vggt as vggt_lib
    from mvtracker_torch.models.mvtracker import MVTracker
    from mvtracker_torch.ops import gsplat

    dev = torch.device("cuda")
    counters = {"knn": knn_ops.knn_cuda, "knn_tiled": knn_ops.knn_tiled_cuda, "knn_exact": knn_ops.knn_exact_cuda,
                "corr": corr_ops.corr_select_cuda, "corr_bwd": corr_ops.corr_select_backward_cuda}

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def made(*keys):
        return {name: counters[name].launches for name in keys or counters}

    paths, free = {}, {}
    tmp = tempfile.TemporaryDirectory()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False  # PyTorch's defaults
    torch.cuda.empty_cache()
    t_phase = t0 = time.perf_counter()
    full = synthetic.render_scene(seed=GENERIC_SEED, n_views=V, n_frames=T, height=H, width=W, n_tracks=N_QUERIES)
    full = dataclasses.replace(full, seq_name="flagship_80")
    log(f"last models: rendered scene {GENERIC_SEED} ({V} x {T} x {H}x{W}) in {time.perf_counter() - t0:.1f} s [{smi}]")

    # (a) VGGT-1B at its defaults, seeded on the card, fp32.
    cfg = vggt_lib.VGGTConfig()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = vggt_lib.init_weights_(vggt_lib.VGGT(cfg, device=dev), seed=0).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    resident = torch.cuda.memory_allocated()
    log(f"last models (a) VGGT-1B ({cfg.depth} frame + {cfg.depth} global blocks, DINOv2 {cfg.vit_depth} blocks, width "
        f"{cfg.embed_dim}, {cfg.num_heads} heads, DPT {cfg.dpt_features}/{cfg.dpt_out_channels}): {n_params} "
        f"parameters, {(resident - base) / 2**20:.1f} MiB fp32, built and seeded on the card in "
        f"{time.perf_counter() - t0:.1f} s; attention F.scaled_dot_product_attention [{smi}]")

    def frames(ts, size):
        x = torch.as_tensor(full.video[:, ts].reshape(-1, H, W, 3), device=dev).permute(0, 3, 1, 2) / 255.0
        x = torch.nn.functional.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=True)
        return x.permute(0, 2, 3, 1)[None].contiguous()

    reset()
    times, peaks = [], {}
    with torch.no_grad():
        for ts, size, label in [([0], VGGT_SIZE, "S=4")] * VGGT_REQUESTS + [([0], VGGT_WIDE, "S=4 wide"),
                                                                            ([0, 1], VGGT_SIZE, "S=8")]:
            x = frames(ts, size)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            out = model(x)
            torch.cuda.synchronize()
            times.append(((time.perf_counter() - t1) * 1e3, label))
            peaks[label] = (torch.cuda.max_memory_allocated() - resident) / 2**20
            s, h, w = x.shape[1:4]
            if out["depth"].shape != (1, s, h, w, 1) or out["world_points"].shape != (1, s, h, w, 3):
                raise AssertionError(f"VGGT {label}: output shapes {tuple(out['depth'].shape)}")
            if not all(bool(torch.isfinite(out[k]).all()) for k in ("pose_enc", "depth", "depth_conf", "world_points")):
                raise AssertionError(f"VGGT {label}: non-finite outputs")
            if label == "S=4":
                est_extrs = out["extrinsics"][0].cpu().numpy()
    free["vggt"] = made()
    log(f"last models (a) VGGT-1B requests on the {V} views of scene {GENERIC_SEED} (first cold): "
        f"{[(round(ms, 2), label) for ms, label in times]} ms; max_memory_allocated above the weights "
        f"{ {k: round(v, 1) for k, v in peaks.items()} } MiB; launches {free['vggt']} [{smi}]")
    s_al, r_al, t_al = align_estimated_cameras_to_gt(est_extrs, full.extrs[:, 0])
    if not (np.isfinite(s_al) and np.isfinite(r_al).all() and np.isfinite(t_al).all()):
        raise AssertionError("align_estimated_cameras_to_gt: non-finite similarity")
    log(f"last models (a) VGGT cameras aligned to the scene's: scale {s_al:.4f}, |t| {np.linalg.norm(t_al):.4f} [{smi}]")
    del model, out
    torch.cuda.empty_cache()

    cut_cfg = dataclasses.replace(cfg, **VGGT_CUT)
    cut = vggt_lib.init_weights_(vggt_lib.VGGT(cut_cfg, device=dev), seed=1).eval()
    x = frames([0], VGGT_SIZE)[:, :2]
    with torch.no_grad(), fp32_precision(exact=True):
        got = cut(x)
        cpu = copy.deepcopy(cut).cpu()
        t1 = time.perf_counter()
        want = cpu(x.cpu())
        cpu_s = time.perf_counter() - t1
    failures = []
    for key in ("pose_enc", "extrinsics", "intrinsics", "depth", "depth_conf", "world_points", "world_points_conf"):
        mx, med = rel_gap(got[key].cpu(), want[key])
        log(f"last models (a) VGGT cut to {VGGT_CUT} at full width, S=2, 518^2, fp32 (TF32 off), card vs plain CPU "
            f"({cpu_s:.1f} s on the CPU): {key} relative gap max {mx:.3e} (limit {VGGT_PLAIN_MAX_REL}), median "
            f"{med:.3e} (limit {VGGT_PLAIN_MEDIAN_REL}) [{smi}]")
        if not (mx <= VGGT_PLAIN_MAX_REL and med <= VGGT_PLAIN_MEDIAN_REL):
            failures.append(key)
    if failures:
        raise AssertionError(f"VGGT card vs CPU: {failures}")
    del cut, cpu, got, want
    torch.cuda.empty_cache()

    # (b) The scene written in the generic layout, read back, queries
    # sampled from its depth, the flagship tracker served on it.
    root = Path(tmp.name) / "generic"
    t1 = time.perf_counter()
    write_generic_scene(full, root / full.seq_name)
    dp = GenericSceneDataset(str(root))[0]
    load_s = time.perf_counter() - t1
    if not (np.array_equal(dp.video, full.video.astype(np.uint8).astype(np.float32))
            and np.array_equal(dp.videodepth, full.videodepth) and np.array_equal(dp.extrs, full.extrs)):
        raise AssertionError("generic scene: read back other arrays than written")
    t1 = time.perf_counter()
    queries = sample_queries_from_depth(dp.videodepth, dp.intrs, dp.extrs,
                                        [SamplingSpec(frame=0, count=GENERIC_UNIFORM),
                                         SamplingSpec(frame=T // 2, count=GENERIC_KMEANS, method="kmeans")])
    sample_s = time.perf_counter() - t1
    if queries.shape != (GENERIC_UNIFORM + GENERIC_KMEANS, 4) or not np.isfinite(queries).all():
        raise AssertionError(f"query sampling: {queries.shape}")
    log(f"last models (b) generic layout written and read back in {load_s:.1f} s; {len(queries)} queries sampled "
        f"({GENERIC_UNIFORM} uniform at frame 0, {GENERIC_KMEANS} k-means at frame {T // 2}) in {sample_s:.2f} s [{smi}]")
    request = (dp.video, dp.videodepth, queries, dp.intrs, dp.extrs)
    model = MVTracker(compute_dtype="bfloat16", device=dev).eval()
    model.load_state_dict(random_state_dict(model, seed=0))
    reset()
    times, knn_calls = [], []
    for i in range(3):
        t1 = time.perf_counter()
        with recording(knn_ops, "knn", knn_calls, knn_call) if i == 0 else contextlib.nullcontext():
            out = model(*to_device(request, dev), iters=ITERS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        if out["traj"].shape != (T, len(queries), 3) or not bool(torch.isfinite(out["traj"]).all()):
            raise AssertionError("generic scene tracker: bad outputs")
    paths["generic_scene_serving"] = made("knn", "corr")
    log(f"last models (b) flagship MVTracker (bf16, seeded) on the generic scene: ms per request "
        f"{[round(x, 2) for x in times]} (first cold); launches {paths['generic_scene_serving']} [{smi}]")
    held = recorded_knn_against_exact(torch, knn_ops, knn_calls)
    log(f"last models (b) the first request's {len(held)} K1 calls (of {len(knn_calls)} kNN calls) against the exact "
        f"plain kNN: shapes {sorted({(h['B'], h['N'], h['M'], h['k']) for h in held})}; max distance error "
        f"{max(h['max_err'] for h in held):.3e}; ties met: {sum(h['tied_pairs'] for h in held)} tied neighbour pairs, "
        f"{sum(h['reordered_rows'] for h in held)} rows ordered otherwise at a tie, "
        f"{sum(h['parted_rows'] for h in held)} rows whose set differs at a tie [{smi}]")
    del knn_calls, held
    del model
    log(f"last models (a) and (b) took {time.perf_counter() - t_phase:.1f} s [{smi}]")

    # (c) Dynamic 3D Gaussians at capacity 32768 on the first frames.
    fit_dp = cut_datapoint(full, FIT_T)
    n_static = 1  # render_scene freezes int(5 * 0.25) objects, segment id 1
    xyz, rgb, is_fg = frame_cloud(torch, fit_dp, 0, n_static, dev)
    video01 = (fit_dp.video / 255.0).astype(np.float32)
    seg = (fit_dp.segmentation > n_static).astype(np.float32)
    d3cfg = d3.D3DGSConfig(iters_first=D3_ITERS_FIRST, iters_rest=D3_ITERS_REST, segment_iters=D3_SEGMENT,
                           densify_start=D3_DENSIFY_START)
    knn_calls, densified = [], []
    reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with recording(d3, "knn", knn_calls, knn_call), \
            recording(d3, "densify", densified, lambda a, kw, o: (a, kw, o)):
        fitted = d3.fit_scene(video01, seg, fit_dp.intrs[:, 0], fit_dp.extrs[:, 0], xyz, rgb, is_fg, d3cfg, seed=0,
                              device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    paths["dynamic3dgs_fit"] = made("knn")
    steps = D3_ITERS_FIRST + (FIT_T - 1) * D3_ITERS_REST
    log(f"last models (c) Dynamic 3DGS fit_scene, capacity {d3cfg.capacity}, {V} views x {H}x{W}, {FIT_T} frames, "
        f"{len(xyz)} cloud points: {steps} steps in {fit_s:.1f} s, {fit_s / steps * 1e3:.1f} ms a step with "
        f"{len(densified)} densification and the host's copies; active {int(fitted['active'].sum())}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; launches "
        f"{paths['dynamic3dgs_fit']} [{smi}]")
    if len(densified) != 1:
        raise AssertionError(f"the fit densified {len(densified)} times, not once")
    for i, h in enumerate(recorded_knn_against_exact(torch, knn_ops, knn_calls, self_query=True)):
        log(f"last models (c) fit kNN call {i} (k={h['k']}, M=N={h['N']}), K1 vs exact plain: max distance error "
            f"{h['max_err']:.3e}; ties met: {h['twins']} points with a twin at distance 0, {h['rank0_not_self']} rows "
            f"whose rank 0 is not the point itself, {h['tied_pairs']} tied neighbour pairs, {h['reordered_rows']} rows "
            f"ordered otherwise at a tie, {h['parted_rows']} rows whose set differs at a tie [{smi}]")
    rigidity_pts = knn_calls[-1][0]
    time_knn_shape(torch, knn_ops, rigidity_pts, d3cfg.knn_neighbors + 1, "(c) rigidity", smi)

    # The fit's densification: what it cloned and split.
    (state, opt, stats, radius, it, _), kw, (new_state, _, _) = densified[0]

    def requests(st, sts, thresh, r):
        grads = torch.where(sts.denom > 0, sts.grad_accum / sts.denom.clamp(min=1), torch.zeros_like(sts.denom))
        small = torch.exp(st.log_scales).max(-1).values <= 0.01 * r
        hot = (grads >= thresh) & st.active
        return grads, int((hot & small).sum()), int((hot & ~small).sum())

    grads, clones, splits = requests(state, stats, d3cfg.grad_thresh, radius)
    free_slots = int((~state.active).sum())
    log(f"last models (c) densification at step {it}: {clones} clones and {splits} splits requested (mean screen "
        f"gradient >= {d3cfg.grad_thresh}; the largest {float(grads.max()):.3e}), {free_slots} free slots; "
        f"{int((~state.active & new_state.active).sum())} free slots taken, "
        f"{int((state.active & ~new_state.active).sum())} gaussians pruned [{smi}]")
    # Densification card vs plain CPU on the same state and statistics, the
    # threshold lowered so that requests outnumber the free slots, the split
    # offsets drawn once on the card: as the fit has it, then with every
    # request a clone (the scene radius taken 100 times larger, which only
    # moves the clone/split line at this step) so that clones make twins at
    # distance 0; the rigidity kNN then runs on those twins.
    ranked = torch.sort(grads[state.active], descending=True).values
    forced_cfg = dataclasses.replace(d3cfg, grad_thresh=float(ranked[min(int(DENSIFY_OVERBOOK * free_slots),
                                                                         len(ranked) - 1)]))
    noise = torch.randn(2, d3cfg.capacity, 3, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    for label, r in (("as fitted", radius), ("every request a clone", 100 * radius)):
        _, clones, splits = requests(state, stats, forced_cfg.grad_thresh, r)
        got = d3.densify(state, opt, stats, r, it, forced_cfg, split_noise=noise)
        want = d3.densify(*(on_cpu(x) for x in (state, opt, stats)), r, it, forced_cfg, split_noise=noise.cpu())
        for part, g, w_ in zip(("state", "adam", "stats"), got, want):
            for key, x, y in leaves_of(g, w_):
                x = x.cpu()
                exact = x.dtype == torch.bool or part != "state"
                if not (torch.equal(x, y) if exact else bool(((x - y).abs() <= 1e-6 * (1 + y.abs())).all())):
                    raise AssertionError(f"densify ({label}) card vs CPU: {part} {key} differ")
        twin_calls = []
        with recording(d3, "knn", twin_calls, knn_call):
            d3.build_rigidity_refs(got[0], d3cfg)
        h = recorded_knn_against_exact(torch, knn_ops, twin_calls, self_query=True)[0]
        log(f"last models (c) densification {label}, the threshold lowered to {forced_cfg.grad_thresh:.3e}: {clones} "
            f"clones and {splits} splits requested for {free_slots} free slots, "
            f"{int((~state.active & got[0].active).sum())} taken; card vs plain CPU equal (masks, slots and moments "
            f"exactly, values within 1e-6); the rigidity kNN on the result (k={h['k']}, M=N={h['N']}), K1 vs exact "
            f"plain: max distance error {h['max_err']:.3e}; ties met: {h['twins']} points with a twin at distance 0, "
            f"{h['rank0_not_self']} rows whose rank 0 is not the point itself, {h['tied_pairs']} tied neighbour "
            f"pairs, {h['reordered_rows']} rows ordered otherwise at a tie, {h['parted_rows']} rows whose set differs "
            f"at a tie [{smi}]")
    if h["twins"] == 0:
        raise AssertionError("densification with every request a clone made no twin")
    del knn_calls, twin_calls, densified, state, opt, stats, new_state, got, want, rigidity_pts, noise

    tracks, vis = d3.extract_tracks(fitted, fit_dp.query_points_3d, fit_dp.videodepth, fit_dp.intrs[:, 0],
                                    fit_dp.extrs[:, 0], device=dev)
    cache = Path(tmp.name) / "cache"
    os.makedirs(cache)
    d3.export_cached_predictions(cache / f"{fit_dp.seq_name}_tracks.npz", tracks, vis)
    summary, _ = Evaluator().evaluate_sequence(CachedPredictionPredictor(str(cache)), [fit_dp])
    metrics = summary["all_any"]
    if not all(np.isfinite(metrics[k]) for k in ("average_jaccard", "ate_visible")):
        raise AssertionError(f"Dynamic 3DGS tracks through the evaluator: {metrics}")
    log(f"last models (c) {tracks.shape[1]} tracks extracted (z-test visible share {vis.mean():.3f}), through "
        f"CachedPredictionPredictor and Evaluator: AJ {metrics['average_jaccard']:.3f}, ATE "
        f"{metrics['ate_visible']:.4f} [{smi}]")
    # One render of the fitted state at t=0 and its gradients, card vs CPU,
    # with a squared loss (PERF.md, PR 8: the fit's L1 loss turns at pixels
    # the card and the CPU round to either side of the target).
    inputs, target = fit_render_inputs(fitted, video01, seg)

    def render_grads(device):
        leaves = [torch.as_tensor(a, device=device).requires_grad_(True) for a in inputs]
        out = gsplat.render_gaussians(*leaves, torch.as_tensor(fit_dp.intrs[0, 0], device=device),
                                      torch.as_tensor(fit_dp.extrs[0, 0], device=device), (W, H), chunk=1024)
        loss = ((out.rgb[..., :4] - torch.as_tensor(target, device=device)).square().mean() + out.depth.mean()
                + out.alpha.mean())
        return out, torch.autograd.grad(loss, leaves)

    with fp32_precision(exact=True):
        out_g, grads_g = render_grads(dev)
    # The plain CPU path takes minutes on the host's cores (PERF.md, §5):
    # it runs on a thread beside the script's later card work, and
    # `check_render` holds it against the card's render once it is done.
    cpu_ref = {}

    def cpu_render():
        t1 = time.perf_counter()
        try:
            cpu_ref["out"] = render_grads(torch.device("cpu"))
        except BaseException as e:  # raised again by check_render
            cpu_ref["error"] = e
        cpu_ref["s"] = time.perf_counter() - t1

    cpu_thread = threading.Thread(target=cpu_render, name="render-cpu-reference", daemon=True)
    cpu_thread.start()
    n_active = int(fitted["active"].sum())

    def check_render():
        t1 = time.perf_counter()
        cpu_thread.join()
        if "error" in cpu_ref:
            raise cpu_ref["error"]
        out_c, grads_c = cpu_ref["out"]
        for key in ("rgb", "alpha", "depth"):
            gap = float((getattr(out_g, key).detach().cpu() - getattr(out_c, key).detach()).abs().max())
            if not gap <= RENDER_ATOL:
                raise AssertionError(f"render {key}: card vs CPU gap {gap:.3e}")
        rel = [rel_gap(a.cpu(), b)[0] for a, b in zip(grads_g, grads_c)]
        log(f"last models (c) render of all {d3cfg.capacity} slots ({n_active} active) at {W}x{H} with "
            f"its gradients, fp32 (TF32 off), card vs plain CPU ({cpu_ref['s']:.1f} s on the CPU beside the later "
            f"phases, {time.perf_counter() - t1:.1f} s waited for): rgb/alpha/depth within "
            f"{RENDER_ATOL}; gradient relative gaps (means, quats, scales, opacities, colours) "
            f"{[f'{r:.2e}' for r in rel]} (limit {RENDER_GRAD_RTOL}) [{smi}]")
        if max(rel) > RENDER_GRAD_RTOL:
            raise AssertionError(f"render gradients: card vs CPU {rel}")

    # (d) Shape of Motion at the JAX widths on the same frames, with depth,
    # mask and track supervision.
    rng = np.random.default_rng(0)
    pick = rng.choice(len(xyz), size=min(SOM_POINTS, len(xyz)), replace=False)
    fg_sel, bg_sel = pick[is_fg[pick] > 0.5], pick[is_fg[pick] <= 0.5]
    somcfg = som.SOMConfig(iters=SOM_ITERS, segment_iters=SOM_SEGMENT)
    knn_calls = []
    reset()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    with recording(som, "knn", knn_calls, knn_call):
        params = som.fit_scene(video01, fit_dp.intrs[:, 0], fit_dp.extrs[:, 0], xyz[fg_sel], rgb[fg_sel], xyz[bg_sel],
                               rgb[bg_sel], depth=fit_dp.videodepth, mask=seg,
                               tracks3d=fit_dp.trajectory_3d.transpose(1, 0, 2),
                               tracks3d_valid=fit_dp.visibility.any(0).T, cfg=somcfg, seed=0, device=dev)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    paths["shape_of_motion_fit"] = made("knn")
    tracks, vis = som.extract_tracks(params, fit_dp.query_points_3d, FIT_T, fit_dp.videodepth, fit_dp.intrs[:, 0],
                                     fit_dp.extrs[:, 0])
    if not np.isfinite(tracks).all():
        raise AssertionError("Shape of Motion: non-finite tracks")
    log(f"last models (d) Shape of Motion ({somcfg.num_bases} bases, {len(fg_sel)} + {len(bg_sel)} gaussians, {FIT_T} "
        f"frames): {SOM_ITERS} steps in {fit_s:.1f} s, {fit_s / SOM_ITERS * 1e3:.1f} ms a step with the host's copies; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; {tracks.shape[1]} tracks "
        f"(visible share {vis.mean():.3f}); launches {paths['shape_of_motion_fit']} [{smi}]")
    for label, h, (pts, _, _) in zip(("(d) foreground", "(d) background"),
                                     recorded_knn_against_exact(torch, knn_ops, knn_calls, self_query=True), knn_calls):
        log(f"last models {label} kNN (k={h['k']}, M=N={h['N']}), K1 vs exact plain: max distance error "
            f"{h['max_err']:.3e}; ties met: {h['twins']} points with a twin at distance 0, {h['tied_pairs']} tied "
            f"neighbour pairs, {h['parted_rows']} rows whose set differs at a tie [{smi}]")
        time_knn_shape(torch, knn_ops, pts, h["k"], label, smi)
    del knn_calls
    del params
    torch.cuda.empty_cache()
    log(f"last models (c) and (d) took {time.perf_counter() - t_phase:.1f} s from the phase's start [{smi}]")

    # (b), last: the tracker's request on the generic scene in fp32 (TF32
    # off), card vs plain CPU, with the exact kNN on both sides: 41 percent
    # of the pixels have no depth and unproject to the camera centres, where
    # distances tie (K1 on this path's own calls is held above).
    model = seeded_weights(MVTracker(device=dev), seed=1).eval()
    model.knn_backend = "exact"
    with fp32_precision(exact=True):
        got = model(*to_device(request, dev), iters=ITERS)
        t1 = time.perf_counter()
        want = copy.deepcopy(model).cpu()(*to_device(request, torch.device("cpu")), iters=ITERS)
        cpu_s = time.perf_counter() - t1
    check_gaps({"generic": (got["traj"].cpu(), got["vis"].cpu())}, {"generic": (want["traj"], want["vis"])},
               GENERIC_PLAIN_LIMITS, f"last models (b) generic scene, fp32 (TF32 off, exact kNN), card vs plain CPU "
                                     f"({cpu_s:.1f} s on the CPU) [{smi}]")
    tmp.cleanup()
    return paths, free, check_render


# ---------------------------------------------------------------------------
# Phase 14: data parallelism, the sharded kNN, ICP and bundle adjustment
# ---------------------------------------------------------------------------

# The ranks are processes on this one card joined by gloo (NCCL admits one
# rank per device): the port's gloo collectives move CUDA tensors through
# host memory. Two processes on one card are no data-parallel speed-up: the
# times below say what the collectives and the sharing cost, not what a
# second card would gain.
PAR_RING_QUERIES = 2048  # (a): M * k = 32768 > 16384 / D points a shard: the ring
PAR_MESH_QUERIES = (256, 1024)  # (b): level 0 by the gather-merge, then by the ring
PAR_STEP_SCENE = (4, 18, 128, 128, 64)  # (c) fp32 parity batch: views, frames, H, W, tracks a scene
PAR_STEPS, PAR_BF16_STEPS, PAR_TOTAL_STEPS = 2, 3, 100
PAR_CHILD_TIMEOUT = 600  # the 4-rank parts, then the 2-rank parts, in one spawn
PAR_DEVICE = "cuda"  # phase 14's device (a rehearsal on the CPU sets "cpu")
# (c) the sharded fp32 step against one process (TF32 off, remat), 2 steps.
# Limits from `scripts/control_torch_parallel.py`, the same comparison at
# small width on gloo CPU processes; its readings, the worse of 2 x 1 and
# 2 x 2 with shard_views and shard_tracks, in the comments. The control's
# 2 x 1 reads 0.0 in all of them (the same sums in the same order on the
# CPU); on the card neither 2 x 1 nor one process against itself does:
# cuDNN's weight gradients of the encoder's convs differ from run to run
# (PERF.md, §6).
PAR_STEP_LIMITS = {
    "loss": 1e-5,  # relative, the worse step; control 8.0e-8
    # Adam's moments, each leaf's max |gap| / max |value|, the worst leaf.
    # After step 1, the first moment (0.1 x the clipped gradient) outside
    # the encoder's convs; control 6.8e-6:
    "mu": 1e-3,
    # The encoder's conv weights, phase 6's class and limit; control 8.1e-6:
    "mu_encoder": 2e-1,
    # After step 2, both moments over every leaf (but the dead conv biases):
    # AdamW moves every parameter whose first gradient is rounding noise by
    # a whole step of the learning rate, so the second gradient of every
    # leaf carries the encoder class's noise; phase 6's class limit. Control
    # 4.4e-2 (mu) and 4.1e-2 (nu), both at an encoder conv. A wrong second
    # gradient shows above it: a factor 2 reads about 0.5 (mu) and 1.5 (nu).
    "mu_last": 2e-1,
    "nu_last": 2e-1,
    # max |gap| over every parameter: two AdamW steps move a parameter by at
    # most lr_0 + lr_1 = 8.6e-5, so where a gradient is rounding noise two
    # runs part by up to 1.7e-4; control 1.03e-4. A check against blow-up;
    # the moments above hold the gradients.
    "params": 2e-4,
}
# (e) ICP card vs CPU after ICP_ITERS iterations; the recovery bounds of the
# JAX package's ICP test; bundle adjustment as `tests/test_torch_bundle_adjust.py`.
ICP_ITERS, ICP_STRIDE = 20, 4
ICP_POSE_ATOL, ICP_FIT_ATOL, ICP_Z_ATOL = 1e-4, 1e-3, 1e-4
BA_ATOL, BA_PIXEL_ATOL = 1e-4, 1e-3


def check_built() -> None:
    """A child process must find every kernel that phase 1 built."""
    from mvtracker_torch.ops import _cuda

    missing = [name for name in _cuda.SOURCES if not _cuda._library_path(name).exists()]
    if missing:
        raise RuntimeError(f"kernels {missing} are not built: a child would build them itself")


def counters():
    from mvtracker_torch.ops import corr as corr_ops
    from mvtracker_torch.ops import knn as knn_ops

    return {"knn": knn_ops.knn_cuda, "knn_tiled": knn_ops.knn_tiled_cuda, "knn_exact": knn_ops.knn_exact_cuda,
            "corr": corr_ops.corr_select_cuda, "corr_bwd": corr_ops.corr_select_backward_cuda}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items() if fn.launches}


def level0_cloud(torch, scene, frames, dev):
    """The level-0 xyz cloud [frames, P, 3] of a scene's first frames, as the
    tracker builds it (stride 4, every view)."""
    from mvtracker_torch.utils import geometry as geo

    _, depths, _, intrs, extrs = (torch.as_tensor(a, device=dev) for a in scene)
    f = slice(0, frames)
    xyz, _ = geo.init_pointcloud_from_rgbd(
        depths[None, :, f, ::4, ::4, None], depths[None, :, f, ::4, ::4], intrs[None, :, f], extrs[None, :, f],
        stride=4, level=0)
    return xyz.reshape(frames, -1, 3).contiguous()


def par_knn(torch, rank, world, spec):
    """(a) on this rank: each case's cloud split into `world` equal shards,
    searched by its schedule; the results and this rank's K1 and K4 launches."""
    from mvtracker_torch.ops import knn as knn_ops
    from mvtracker_torch.parallel.mesh import make_mesh

    group = make_mesh(1, world, backend="gloo").group("model")
    out = {}
    for name, (ref, query, k, schedule) in spec.items():
        ref, query = torch.as_tensor(ref, device=PAR_DEVICE), torch.as_tensor(query, device=PAR_DEVICE)
        n_local = ref.shape[1] // world
        shard = ref[:, rank * n_local : (rank + 1) * n_local].contiguous()
        fn = knn_ops.knn_sharded_ring if schedule == "ring" else knn_ops.knn_sharded
        fn(shard, query, k, group)  # warm-up, not counted
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        d, i = fn(shard, query, k, group)
        torch.cuda.synchronize()
        out[name] = {"d": d.cpu().numpy(), "i": i.cpu().numpy(), "ms": (time.perf_counter() - t0) * 1e3,
                     "launches": read_counts()}
    return out


def mesh_requests(n_queries):
    from mvtracker_torch.scene import make_scene

    return [make_scene(np.random.default_rng(0), V, T, H, W, n) for n in n_queries]


def flagship_bf16(torch, dev, **kw):
    from mvtracker_torch.convert import random_state_dict
    from mvtracker_torch.models.mvtracker import MVTracker

    model = MVTracker(compute_dtype="bfloat16", device=dev, **kw).eval()
    model.load_state_dict(random_state_dict(model, seed=0))
    return model


def par_knn_mesh(torch, rank, world, spec):
    """(b) on this rank: the flagship bf16 MVTracker with a 1 x world knn_mesh
    serves the requests; tracks, launches and ms per request."""
    from mvtracker_torch.ops import knn as knn_ops
    from mvtracker_torch.parallel.mesh import make_mesh

    model = flagship_bf16(torch, PAR_DEVICE, knn_mesh=make_mesh(1, world, backend="gloo"))
    schedules = {"gather": 0, "ring": 0}
    for name, attr in (("gather", "knn_sharded"), ("ring", "knn_sharded_ring")):
        def counted(*a, _fn=getattr(knn_ops, attr), _name=name, **kw):
            schedules[_name] += 1
            return _fn(*a, **kw)
        setattr(knn_ops, attr, counted)
    out = []
    for scene in mesh_requests(spec["queries"]):
        scene = to_device(scene, torch.device(PAR_DEVICE))
        torch.cuda.synchronize()
        reset_counts()
        schedules.update(gather=0, ring=0)
        t0 = time.perf_counter()
        res = model(*scene, iters=ITERS)
        torch.cuda.synchronize()
        out.append({"traj": res["traj"].float().cpu().numpy(), "vis": res["vis"].float().cpu().numpy(),
                    "ms": (time.perf_counter() - t0) * 1e3, "launches": read_counts(), "schedules": dict(schedules)})
    return out


def par_step_batch(views, frames, height, width, tracks, scenes=2, seed=3):
    """A batch of `scenes` seeded scenes with ground truth, as numpy arrays."""
    from mvtracker_torch.scene import make_scene

    rng = np.random.default_rng(seed)
    parts = [make_scene(rng, views, frames, height, width, tracks) for _ in range(scenes)]
    keys = ("rgbs", "depths", "query_points", "intrs", "extrs")
    batch = {k: np.stack([p[i] for p in parts]) for i, k in enumerate(keys)}
    batch["traj_gt"] = (batch["query_points"][:, None, :, 1:]
                        + rng.normal(size=(scenes, frames, tracks, 3)) * 0.1).astype(np.float32)
    batch["vis_gt"] = (rng.random((scenes, frames, tracks)) > 0.3).astype(np.float32)
    batch["valid"] = np.ones((scenes, frames, tracks), np.float32)
    return batch


def par_step_model(torch, device, width, dtype="float32"):
    """The model of part (c): remat, seeded weights with the flow-head gain."""
    from mvtracker_torch.convert import random_state_dict
    from mvtracker_torch.models.mvtracker import MVTracker

    model = MVTracker(**width, compute_dtype=dtype, remat=True, remat_encoder=False, device=device)
    sd = random_state_dict(model, seed=1)
    for name in sd:
        if name.startswith("updateformer.flow_head.") and name.endswith("weight"):
            sd[name] = sd[name] * FLOW_HEAD_GAIN
    model.load_state_dict(sd)
    return model


def par_run_steps(torch, model, batch, steps, mesh=None, shard_views=False, shard_tracks=False, exact=True):
    """`steps` train steps on `batch` (this rank's scenes when a mesh is
    given), TF32 off with `exact`; the metrics of every step, the host ms of
    each, the parameters after them, Adam's first moment after the first
    step (0.1 x its clipped gradient) and both moments after the last (they
    mix in gradients taken where the parameters already differ, AdamW
    having turned rounding noise into whole steps of the learning rate)."""
    from mvtracker_torch.device import fp32_precision
    from mvtracker_torch.training import step as step_lib

    optimizer = step_lib.make_optimizer(total_steps=PAR_TOTAL_STEPS)
    state = step_lib.init_state(model, optimizer)
    step = step_lib.make_train_step(model, optimizer, iters=ITERS, mesh=mesh, shard_views=shard_views,
                                    shard_tracks=shard_tracks)
    metrics, times, mu = [], [], None
    with fp32_precision(exact=exact):
        for _ in range(steps):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})  # synchronises
            times.append((time.perf_counter() - t0) * 1e3)
            if mu is None:  # a copy: on the CPU `.cpu()` is the tensor the next step updates in place
                mu = {k: v.cpu().numpy().copy() for k, v in state.opt_state["mu"].items()}
    return {"metrics": metrics, "ms": times, "mu": mu,
            "mu_last": {k: v.cpu().numpy() for k, v in state.opt_state["mu"].items()},
            "nu_last": {k: v.cpu().numpy() for k, v in state.opt_state["nu"].items()},
            "params": {k: p.detach().cpu().numpy() for k, p in model.named_parameters()}}


def par_step(torch, rank, world, spec):
    """(c) on this rank: the fp32 parity steps on its scenes, then timed bf16
    steps at the flagship shape. Rank 0 returns the parameters and moments;
    every rank a digest of its parameters."""
    from mvtracker_torch.parallel import mesh as mesh_lib

    device = spec["device"]
    mesh = mesh_lib.make_mesh(world // spec["n_model"], spec["n_model"], backend="gloo")
    flags = dict(shard_views=spec["shard_views"], shard_tracks=spec["shard_tracks"])
    model = par_step_model(torch, device, spec["width"])
    local = mesh_lib.shard_batch_pytree(par_step_batch(*spec["scene"]), mesh)
    reset_counts()
    got = par_run_steps(torch, model, local, PAR_STEPS, mesh=mesh, **flags)
    got["parity_launches"] = read_counts()
    got["digest"] = float(sum(float(np.abs(p).astype(np.float64).sum()) for p in got["params"].values()))
    if rank != 0:
        for key in ("params", "mu", "mu_last", "nu_last"):
            got.pop(key)
    del model
    if not spec.get("bf16_steps"):
        return got
    # Timed bf16 steps of the flagship on a 2-scene batch of the flagship shape.
    torch.cuda.empty_cache()
    model = par_step_model(torch, device, spec["width"], dtype="bfloat16")
    local = {k: torch.as_tensor(v, device=device)
             for k, v in mesh_lib.shard_batch_pytree(par_step_batch(V, T, H, W, N_QUERIES, seed=0), mesh).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    timed = par_run_steps(torch, model, local, spec["bf16_steps"], mesh=mesh, exact=False, **flags)
    got["bf16"] = {"ms": timed["ms"], "loss": [m["loss"] for m in timed["metrics"]], "launches": read_counts(),
                   "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
    return got


def par_probe(torch, rank, world, spec) -> list:
    """(c) on this rank, alone (no mesh): the ops of one fp32 train step of
    the parity batch that PyTorch warns have no deterministic implementation
    (`use_deterministic_algorithms(True, warn_only=True)`, a process-wide
    switch, so in a child: the main process's CPU render runs meanwhile)."""
    import warnings

    from mvtracker_torch.device import fp32_precision
    from mvtracker_torch.training import step as step_lib

    model = par_step_model(torch, PAR_DEVICE, {})
    batch = {k: torch.as_tensor(v, device=PAR_DEVICE) for k, v in par_step_batch(*spec["scene"]).items()}
    optimizer = step_lib.make_optimizer(total_steps=PAR_TOTAL_STEPS)
    step = step_lib.make_train_step(model, optimizer, iters=ITERS)
    with warnings.catch_warnings(record=True) as caught, fp32_precision(exact=True):
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            float(step(step_lib.init_state(model, optimizer), batch)[1]["loss"])
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(" does not have")[0].split(".")[0][:120] for w in caught
                   if "determinis" in str(w.message)})


def step_gaps(got, want) -> dict:
    """The sharded step against one process: the loss's worst relative gap
    over the steps; Adam's first moment after the first step per leaf class
    and both moments after the last over every leaf, each leaf's max |gap|
    over its largest |value|, the worst leaf; the largest parameter gap."""
    gaps = {"loss": max(abs(g["loss"] - w["loss"]) / abs(w["loss"]) for g, w in zip(got["metrics"],
                                                                                   want["metrics"]))}
    for moment in ("mu", "mu_last", "nu_last"):
        worst = {"plain": 0.0, "encoder": 0.0}
        for name, w in want[moment].items():
            kind = leaf_kind(name)
            if kind != "dead":
                gap = float(np.abs(got[moment][name] - w).max() / max(np.abs(w).max(), 1e-30))
                worst[kind] = max(worst[kind], gap)
        if moment == "mu":
            gaps["mu"], gaps["mu_encoder"] = worst["plain"], worst["encoder"]
        else:
            gaps[moment] = max(worst.values())
    gaps["params"] = max(float(np.abs(got["params"][k] - w).max()) for k, w in want["params"].items())
    return gaps


def par_bundle(torch, rank, world, spec):
    """(e) on this rank: `refine_cameras_sharded` over its equal slice of the
    points, on the card."""
    from mvtracker_torch.ops import bundle_adjust as ba

    import torch.distributed as dist

    intrs, extrs, points, obs, weights = (torch.as_tensor(a, device=PAR_DEVICE) for a in spec["problem"])
    per = points.shape[0] // world
    sl = slice(rank * per, (rank + 1) * per)
    e, p = ba.refine_cameras_sharded(intrs, extrs, points[sl], obs[:, sl], weights[:, sl], dist.group.WORLD,
                                     iterations=spec["iterations"])
    return {"extrs": e.cpu().numpy(), "points": p.cpu().numpy()}


SPILLED = ("params", "mu", "mu_last", "nu_last")  # a step part's per-leaf arrays, hundreds of MB on rank 0


def spill(out: dict, spill_dir: str, rank: int) -> None:
    """Move the per-leaf arrays of `out`'s step parts to .npy files in
    `spill_dir`: through the result queue they are pickled into a pipe the
    parent drains while it competes for the host (30 s alone, 108 s beside
    phase 13's render thread)."""
    for part, got in out.items():
        if isinstance(got, dict) and "params" in got:
            got["spilled"] = {}
            for moment in SPILLED:
                path = os.path.join(spill_dir, f"{part}_rank{rank}_{moment}.npz")
                np.savez(path, **got.pop(moment))
                got["spilled"][moment] = path


def unspill(got: dict) -> dict:
    """`spill`'s arrays back into a step part's result."""
    for moment, path in got.pop("spilled", {}).items():
        with np.load(path) as leaves:
            got[moment] = dict(leaves)
    return got


def par_child(rank, world, plan, device, spill_dir=None):
    """A phase-14 process: the parts of `plan`, in order, on `device` (the
    card; the CPU for `scripts/control_torch_parallel.py`). A part
    ("regroup", {"world": n, "init": url}) leaves the world; ranks below n
    join a new world of n (through the rendezvous `url`) for the parts that
    follow, the others return. With `spill_dir` the step parts' arrays come
    back as files there (`spill`)."""
    import torch
    import torch.distributed as dist

    global PAR_DEVICE
    PAR_DEVICE = device
    if PAR_DEVICE == "cuda":
        torch.cuda.set_device(0)
        check_built()
    fns = {"knn": par_knn, "knn4": par_knn, "knn_mesh": par_knn_mesh, "step": par_step, "step4": par_step,
           "bundle": par_bundle, "probe": par_probe}
    out = {"entered": time.time()}
    for part, spec in plan:
        if part == "regroup":
            out["left_" + str(world)] = time.time()
            dist.destroy_process_group()
            if rank >= spec["world"]:
                break
            world = spec["world"]
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
            dist.init_process_group("gloo", init_method=spec["init"], rank=rank, world_size=world)
            out["regrouped"] = time.time()
            continue
        t0 = time.perf_counter()
        out[part] = fns[part](torch, rank, world, spec)
        out[part + "_s"] = time.perf_counter() - t0
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20 if PAR_DEVICE == "cuda" else 0.0
    if spill_dir is not None:
        spill(out, spill_dir, rank)
    out["left"] = time.time()
    return out


def nccl_on_one_card(rank, world):
    """Two NCCL ranks on one device: what NCCL says."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    group = dist.new_group(backend="nccl", timeout=datetime.timedelta(seconds=30))
    x = torch.ones(4, device="cuda")
    dist.all_reduce(x, group=group)
    torch.cuda.synchronize()
    return float(x[0])


def ba_problem(rng, v=4, p=256):
    """Cameras on a circle looking at the origin, points near it, their
    exact pixels and unit weights where in front; the cameras but view 0
    perturbed by about 1 degree and 2 cm. 256 points, the size of the JAX
    package's sharded test: joint refinement leaves a similarity gauge that
    only the 1e-4 damping holds, and at 4096 points its first fp32 step is
    decided by rounding (max twist 0.16 in JAX, 0.63 or 8.7 in the port on
    1 or 4 CPU threads, the last diverging to NaN)."""
    intrs = np.zeros((v, 3, 3), np.float32)
    intrs[:, 0, 0] = intrs[:, 1, 1] = 300.0
    intrs[:, :2, 2] = (160.0, 120.0)
    intrs[:, 2, 2] = 1.0
    extrs = np.zeros((v, 3, 4), np.float32)
    for vi in range(v):
        c, s = np.cos(2 * np.pi * vi / v), np.sin(2 * np.pi * vi / v)
        extrs[vi, :, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        extrs[vi, :, 3] = [0.05 * vi, -0.02 * vi, 3.0]
    points = (rng.normal(size=(p, 3)) * 0.5).astype(np.float32)
    cam = np.einsum("vij,pj->vpi", extrs[:, :, :3], points) + extrs[:, None, :, 3]
    pix = np.einsum("vij,vpj->vpi", intrs, cam)
    obs = (pix[..., :2] / pix[..., 2:]).astype(np.float32)
    weights = (cam[..., 2] > 0.1).astype(np.float32)
    perturbed = extrs.copy()
    for vi in range(1, v):
        w = np.deg2rad(1.0) * rng.normal(size=3)
        theta = np.linalg.norm(w)
        kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / theta
        dr = np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx
        perturbed[vi, :, :3] = dr @ perturbed[vi, :, :3]
        perturbed[vi, :, 3] += 0.02 * rng.normal(size=3)
    return intrs, perturbed.astype(np.float32), points, obs, weights


def pixels(torch, intrs, extrs, points):
    from mvtracker_torch.ops import bundle_adjust as ba

    v, p = extrs.shape[0], points.shape[0]
    r, _, _ = ba._project_residuals(*(torch.as_tensor(np.asarray(a, np.float32)) for a in (
        intrs, extrs, points, np.zeros((v, p, 2)), np.ones((v, p)))))
    return r.numpy()


def rotation(axis, deg):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    a = np.deg2rad(deg)
    kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * kx + (1 - np.cos(a)) * kx @ kx


def phase_parallel(torch, smi, knn_ops, corr_ops):
    """Phase 14: (a) the two kNN schedules at full size on 2 and 4 ranks, (b)
    the flagship MVTracker with a knn_mesh over 2 ranks, (c) the sharded
    train step, (d) `cli.train` with MVTRACKER_DISTRIBUTED=1 (a world of 1,
    NCCL) and `eval_checkpoint --exp_dir`, (e) ICP, the z-offset search and
    bundle adjustment; the ranks are processes on this card. Returns
    {path: launch totals} (children's counts summed over their ranks)."""
    import socket

    import torch.distributed as dist

    from mvtracker_torch.cli import eval_checkpoint
    from mvtracker_torch.cli import train as cli_train
    from mvtracker_torch.datasets.synthetic import render_scene
    from mvtracker_torch.ops import bundle_adjust as ba
    from mvtracker_torch.ops import icp
    from mvtracker_torch.parallel.launch import run_local
    from mvtracker_torch.scene import make_scene
    from mvtracker_torch.utils import geometry as geo

    dev = torch.device(PAR_DEVICE)
    paths = {}
    tmp = tempfile.TemporaryDirectory()
    groups = "backend gloo, collectives through host memory"

    # The children's inputs, then the children (one spawn of 4 ranks, which
    # regroup to 2 for the 2-rank parts) in a thread beside this process's
    # parts: the references, (d), (e) and the NCCL probe.
    t0 = time.perf_counter()
    flag = make_scene(np.random.default_rng(0), V, T, H, W, PAR_RING_QUERIES)
    cloud = level0_cloud(torch, flag, WINDOW, dev)  # [12, 16384, 3]
    queries = torch.as_tensor(flag[2][:, 1:], device=dev)[None].expand(WINDOW, -1, -1).contiguous()
    large = make_scene(np.random.default_rng(10), LARGE_V, WINDOW, LARGE_H, LARGE_W, N_QUERIES)
    large_cloud = level0_cloud(torch, large, WINDOW, dev)  # [12, 281600, 3]
    large_q = torch.as_tensor(large[2][:, 1:], device=dev)[None].expand(WINDOW, -1, -1).contiguous()
    del large
    k = 16
    knn_cases = {
        "flagship_gather": (cloud, queries[:, :N_QUERIES].contiguous(), k, "gather"),
        "flagship_ring": (cloud, queries, k, "ring"),
        "large_gather": (large_cloud, large_q, k, "gather"),
    }
    problem = ba_problem(np.random.default_rng(0))
    step_scene = PAR_STEP_SCENE

    def numpy_cases(names):
        return {n: (knn_cases[n][0].cpu().numpy(), knn_cases[n][1].cpu().numpy(), knn_cases[n][2], knn_cases[n][3])
                for n in names}

    step_spec = dict(device=PAR_DEVICE, width={}, scene=step_scene, bf16_steps=PAR_BF16_STEPS)
    regroup = "file://" + str(Path(tmp.name) / "rendezvous_regroup")
    plan = [("knn4", numpy_cases(["flagship_gather", "flagship_ring"])),
            ("step4", dict(step_spec, n_model=2, shard_views=True, shard_tracks=True)),
            ("regroup", {"world": 2, "init": regroup}),
            ("knn", numpy_cases(["flagship_gather", "flagship_ring", "large_gather"])),
            ("knn_mesh", {"queries": PAR_MESH_QUERIES}),
            ("step", dict(step_spec, n_model=1, shard_views=False, shard_tracks=False)),
            ("bundle", {"problem": problem, "iterations": 10}),
            ("probe", {"scene": step_scene})]
    children = {}

    def run_children():
        children["start"] = time.time()
        try:
            children["ranks"] = run_local(par_child, 4, tmp.name, plan, PAR_DEVICE, tmp.name,
                                          timeout=PAR_CHILD_TIMEOUT, threads=max(1, (os.cpu_count() or 1) // 4))
        except BaseException as e:  # raised in this process once the thread is joined
            children["error"] = e
        children["done"] = time.time()

    torch.cuda.synchronize()
    thread = threading.Thread(target=run_children, name="phase14-ranks", daemon=True)
    thread.start()
    want = {}
    for name, (ref, q, kk, _) in knn_cases.items():
        want[name] = {"global": knn_ops.knn(ref, q, kk), "exact": knn_ops.knn_exact_cuda(ref, q, kk)}
    mesh_model = flagship_bf16(torch, dev)
    mesh_want = []
    for scene in mesh_requests(PAR_MESH_QUERIES):
        res = mesh_model(*to_device(scene, dev), iters=ITERS)
        mesh_want.append({key: res[key].float().cpu().numpy() for key in ("traj", "vis")})
    del mesh_model
    step_batch = {k: torch.as_tensor(v, device=dev) for k, v in par_step_batch(*step_scene).items()}
    step_want = par_run_steps(torch, par_step_model(torch, PAR_DEVICE, {}), step_batch, PAR_STEPS)
    # The same steps again in this process: the noise floor of the
    # comparisons of (c).
    step_again = step_gaps(par_run_steps(torch, par_step_model(torch, PAR_DEVICE, {}), step_batch, PAR_STEPS),
                           step_want)
    del step_batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"parallel: references in one process {time.perf_counter() - t0:.1f} s, beside the ranks [{smi}]")

    # (d) cli.train with MVTRACKER_DISTRIBUTED=1: a world of 1 over NCCL, the
    # environment as a launcher sets it; then eval_checkpoint --exp_dir.
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    exp = str(Path(tmp.name) / "distributed")
    env = {"MVTRACKER_DISTRIBUTED": "1", "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    saved_env = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    # With 8 heads and a window of 8 the config's model is `presets.py`'s
    # flagship, which eval_checkpoint builds (the same width otherwise).
    argv = ["--config", str(ROOT / "configs" / "mvtracker.yaml"), "--device", PAR_DEVICE, "trainer.total_steps=3",
            "trainer.save_ckpt_freq=3", f"trainer.exp_dir={exp}", "trainer.telemetry_freq=1", "model.num_heads=8",
            "model.sliding_window_len=8"]
    reset_counts()
    t0 = time.perf_counter()
    try:
        state = cli_train.main(argv)
        backend = dist.get_backend()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    train_s = time.perf_counter() - t0
    paths["parallel_cli_train"] = {key: read_counts().get(key, 0) for key in ("knn", "corr", "corr_bwd")}
    trained = {name: p.detach().clone() for name, p in state.model.named_parameters()}
    del state
    torch.cuda.empty_cache()
    if backend != ("nccl" if PAR_DEVICE == "cuda" else "gloo") or not all(paths["parallel_cli_train"].values()):
        raise AssertionError(f"cli.train distributed: backend {backend}, launches {paths['parallel_cli_train']}")
    eval_argv = ["--exp_dir", exp, "--model_size", "flagship", "--views", "4", "--res", "128", "--frames", "12",
                 "--n_tracks", "32", "--calib_scenes", "1", "--eval_scenes", "1", "--iters", "1", "--grid", "0",
                 "--thresholds", "0.5", "--device", PAR_DEVICE]
    t0 = time.perf_counter()
    rows = eval_checkpoint.main(eval_argv)
    eval_s = time.perf_counter() - t0
    model = eval_checkpoint.build(eval_checkpoint.build_parser().parse_args(eval_argv))
    eval_checkpoint.restore_checkpoint(model, exp, 3)
    same = all(torch.equal(p, trained[name]) for name, p in model.named_parameters())
    aj = rows["iters1_grid0"]["heldout_calibrated"]["average_jaccard"]
    log(f"parallel (d) cli.train configs/mvtracker.yaml model.num_heads=8 model.sliding_window_len=8 with "
        f"MVTRACKER_DISTRIBUTED=1 (world 1, backend {backend}): "
        f"3 steps in {train_s:.1f} s with the scenes' rendering, launches {paths['parallel_cli_train']}; "
        f"eval_checkpoint --exp_dir --model_size flagship: checkpoint step {rows['checkpoint_step']}, weights equal "
        f"to the trainer's {same}, AJ {aj} (untrained), {eval_s:.1f} s [{smi}]")
    if rows["checkpoint_step"] != 3 or not same or not np.isfinite(aj):
        raise AssertionError("eval_checkpoint --exp_dir did not evaluate the distributed trainer's checkpoint")
    del model

    # (e) ICP on two views of a rendered flagship frame, card vs CPU; the
    # z-offset search on that pair; bundle adjustment.
    dp = render_scene(seed=0, n_views=2, n_frames=1, height=H, width=W, n_tracks=4)
    depth = torch.as_tensor(np.asarray(dp.videodepth, np.float32))[:, 0].reshape(2, H, W)
    intrs = torch.as_tensor(np.asarray(dp.intrs, np.float32))[:, 0]
    extrs = torch.as_tensor(np.asarray(dp.extrs, np.float32))[:, 0]
    world = geo.unproject_depth_to_world(depth, geo.invert_intrinsics(intrs), geo.invert_extrinsics(extrs), stride=1)
    s = ICP_STRIDE
    views = [world[v, ::s, ::s].reshape(-1, 3)[depth[v, ::s, ::s].reshape(-1) > 0] for v in range(2)]
    target = torch.cat(views).contiguous()
    r_true, t_true = rotation([0.3, 1.0, 0.2], 2.0), np.array([0.01, -0.015, 0.008])
    source = torch.as_tensor(((target.numpy() - t_true) @ r_true).astype(np.float32))
    reset_counts()
    t0 = time.perf_counter()
    r_gpu, t_gpu, fit_gpu = icp.icp(source.to(dev), target.to(dev), iters=ICP_ITERS)
    torch.cuda.synchronize()
    icp_ms = (time.perf_counter() - t0) * 1e3
    icp_counts = read_counts()
    t0 = time.perf_counter()
    r_cpu, t_cpu, fit_cpu = icp.icp(source, target, iters=ICP_ITERS)
    icp_cpu_s = time.perf_counter() - t0
    ang = float(np.rad2deg(np.arccos(np.clip((np.trace(r_gpu.cpu().double().numpy() @ r_true.T) - 1) / 2, -1, 1))))
    t_err = float(np.linalg.norm(t_gpu.cpu().numpy() - t_true))
    pose_gap = max(float((r_gpu.cpu() - r_cpu).abs().max()), float((t_gpu.cpu() - t_cpu).abs().max()))
    fit_gap = abs(float(fit_gpu) - float(fit_cpu))
    log(f"parallel (e) ICP point-to-plane on views 0 and 1 of a rendered {H}x{W} frame ({target.shape[0]} points, "
        f"every {s}th pixel), a known 2 degree / {np.linalg.norm(t_true) * 1e3:.1f} mm pose, {ICP_ITERS} iterations: "
        f"card {icp_ms:.1f} ms, launches {icp_counts}; recovered to {ang:.4f} degree and {t_err * 1e3:.4f} mm, "
        f"fitness {float(fit_gpu):.4f}; card vs CPU ({icp_cpu_s:.1f} s) pose {pose_gap:.3e} (limit {ICP_POSE_ATOL}), "
        f"fitness {fit_gap:.3e} (limit {ICP_FIT_ATOL}) [{smi}]")
    if icp_counts != {"knn": 1 + ICP_ITERS}:
        raise AssertionError(f"ICP launches {icp_counts}, want {{'knn': {1 + ICP_ITERS}}}")
    if not (ang < 0.1 and t_err < 1e-3 and pose_gap <= ICP_POSE_ATOL and fit_gap <= ICP_FIT_ATOL):
        raise AssertionError("parallel (e): ICP did not recover the pose, or the card and the CPU disagree")
    paths["parallel_icp"] = icp_counts

    # The z-offset search: view 1 seen from its own camera with a z bias,
    # against view 0 in the world.
    z_true = 0.023
    c2w = geo.invert_extrinsics(extrs[1:2])[0]  # [4, 4]
    local = (views[1] - c2w[:3, 3]) @ c2w[:3, :3]
    local[:, 2] -= z_true
    frame = {"wrist_points_local": local.numpy(), "wrist_cam_to_world": c2w.numpy(),
             "external_points_world": views[0].numpy()}
    reset_counts()
    t0 = time.perf_counter()
    z_gpu, zfit_gpu = icp.optimize_wrist_z_offset(**frame, device=PAR_DEVICE)
    z_ms = (time.perf_counter() - t0) * 1e3
    z_counts = read_counts()
    z_cpu, zfit_cpu = icp.optimize_wrist_z_offset(**frame, device="cpu")
    log(f"parallel (e) wrist z offset {z_true} (view 1 from its camera against view 0, {local.shape[0]} and "
        f"{views[0].shape[0]} points): card {z_gpu:.6f} (fitness {zfit_gpu:.4f}, {z_ms:.1f} ms, "
        f"launches {z_counts}), CPU {z_cpu:.6f} (fitness {zfit_cpu:.4f}); gap {abs(z_gpu - z_cpu):.3e} "
        f"(limit {ICP_Z_ATOL}) [{smi}]")
    if not zfit_gpu > 0.05:  # (0, 0): the search found no usable frame or candidate
        raise AssertionError(f"parallel (e): the z-offset search found no alignment (fitness {zfit_gpu})")
    if not (abs(z_gpu - z_cpu) <= ICP_Z_ATOL and abs(zfit_gpu - zfit_cpu) <= ICP_FIT_ATOL):
        raise AssertionError("parallel (e): the z-offset search differs between the card and the CPU")
    paths["parallel_icp"] = {"knn": icp_counts["knn"] + z_counts["knn"]}

    intrs_b, extrs_b, points_b, obs_b, weights_b = problem
    cams = {}
    for device in (PAR_DEVICE, "cpu"):
        args = [torch.as_tensor(a, device=device) for a in problem]
        e_only, _, msr_only = ba.refine_cameras(*args, iterations=15, refine_points=False)
        e_joint, p_joint, msr_joint = ba.refine_cameras(*args, iterations=10)
        cams[device] = (e_only.cpu().numpy(), e_joint.cpu().numpy(), p_joint.cpu().numpy(), float(msr_only),
                        float(msr_joint))
    only_gap = float(np.abs(cams[PAR_DEVICE][0] - cams["cpu"][0]).max())
    joint_gap = float(np.abs(pixels(torch, intrs_b, *cams[PAR_DEVICE][1:3])
                             - pixels(torch, intrs_b, *cams["cpu"][1:3])).max())
    log(f"parallel (e) bundle adjustment, {extrs_b.shape[0]} cameras, {points_b.shape[0]} points: card vs CPU "
        f"cameras only {only_gap:.3e} (limit {BA_ATOL}), joint reprojection {joint_gap:.3e} px (limit "
        f"{BA_PIXEL_ATOL}); residuals {cams[PAR_DEVICE][3]:.3e} / {cams[PAR_DEVICE][4]:.3e} [{smi}]")
    if not (only_gap <= BA_ATOL and joint_gap <= BA_PIXEL_ATOL):
        raise AssertionError("parallel (e): bundle adjustment differs between the card and the CPU")

    # NCCL with two ranks on one device: once, to write down what it says.
    t0 = time.perf_counter()
    try:
        outcome = f"ran: {run_local(nccl_on_one_card, 2, tmp.name, timeout=90)}"
    except (RuntimeError, TimeoutError) as e:
        lines = [line for line in str(e).splitlines() if line.strip()]
        outcome = "failed: " + " | ".join(lines[-3:])[:600]
    log(f"parallel: NCCL, 2 ranks on one device ({time.perf_counter() - t0:.1f} s): {outcome}")

    # The ranks' results.
    t0 = time.perf_counter()
    thread.join()
    if "error" in children:
        raise children["error"]
    ranks_all = children["ranks"]
    for r in ranks_all:
        for part in ("step", "step4"):
            if part in r:
                unspill(r[part])
    results = {4: [{"knn": r["knn4"], "step4": r["step4"]} for r in ranks_all], 2: ranks_all[:2]}
    start, done = children["start"], children["done"]
    log(f"parallel: 4 ranks on one card ({groups}) then ranks 0 and 1 regrouped into a world of 2, in "
        f"{done - start:.1f} s ({time.perf_counter() - t0:.1f} s waited for after this process's parts); per rank "
        f"{[{p: round(r[p + '_s'], 1) for p, _ in plan if p + '_s' in r} for r in ranks_all]} s; from the start to "
        f"each rank's first part {[round(r['entered'] - start, 1) for r in ranks_all]} s, the regroup "
        f"{[round(r['regrouped'] - r['left_4'], 1) for r in ranks_all[:2]]} s, from each rank's return to the last "
        f"exit {[round(done - r['left'], 1) for r in ranks_all]} s; peak memory per rank "
        f"{[round(r['peak_mib'], 1) for r in ranks_all]} MiB [{smi}]")

    # (a) The schedules against the global search and the exact kNN.
    k1 = {}
    for world, ranks in results.items():
        for name, (ref, q, kk, schedule) in knn_cases.items():
            if name not in ranks[0]["knn"]:
                continue
            gd, gi = (a.cpu().numpy() for a in want[name]["global"])
            ed, ei = (a.cpu().numpy() for a in want[name]["exact"])
            ties = int((np.diff(ed, axis=-1) == 0).sum())
            for rank, r in enumerate(ranks):
                got = r["knn"][name]
                if not (np.array_equal(got["d"], gd) and np.array_equal(got["d"], ed)):
                    raise AssertionError(f"parallel (a) {name} on {world} ranks, rank {rank}: distances differ "
                                         f"from the global search ({float(np.abs(got['d'] - gd).max()):.3e})")
                if not np.array_equal(got["i"], ei):
                    raise AssertionError(f"parallel (a) {name} on {world} ranks, rank {rank}: "
                                         f"{int((got['i'] != ei).sum())} indices differ from the exact kNN's")
                if not np.array_equal(got["d"], ranks[0]["knn"][name]["d"]):
                    raise AssertionError(f"parallel (a) {name}: the ranks disagree")
                k1[(world, name, rank)] = got["launches"]
            off = int((gi != ei).sum())
            per_rank = [r["knn"][name]["launches"] for r in ranks]
            global_kernel = "K4" if ref.shape[1] > knn_ops.FUSED_MAX_POINTS else "K1"
            log(f"parallel (a) {name}: cloud [{ref.shape[0]}, {ref.shape[1]}, 3] over {world} ranks "
                f"({ref.shape[1] // world} points a shard), {q.shape[1]} queries, k={kk}, {schedule}: distances "
                f"bit-equal to the global {global_kernel} search and the exact kNN, indices equal to the exact kNN's; "
                f"{ties} tied neighbour pairs, {off} indices of the global {global_kernel} search ordered otherwise; "
                f"launches per rank {per_rank}; ms per rank {[round(r['knn'][name]['ms'], 2) for r in ranks]} "
                f"[{smi}]")
            if any(set(c) != {"knn"} or c["knn"] != (1 if schedule == "gather" else world) for c in per_rank):
                raise AssertionError(f"parallel (a) {name}: launches per rank {per_rank}")
    paths["parallel_knn"] = {"knn": sum(c["knn"] for c in k1.values())}

    # (b) The knn_mesh tracker against the same requests in one process.
    counts = {"knn": 0, "corr": 0}
    for qi, n in enumerate(PAR_MESH_QUERIES):
        rows = []
        for rank, r in enumerate(results[2]):
            got = r["knn_mesh"][qi]
            for key, (tmax, tmed) in (("traj", (E2E_TRAJ_MAX, E2E_TRAJ_MEDIAN)),
                                      ("vis", (E2E_VIS_MAX, E2E_VIS_MEDIAN))):
                gap = np.abs(got[key] - mesh_want[qi][key])
                rows.append(f"rank {rank} {key} max {gap.max():.3e} median {np.median(gap):.3e}")
                if not (gap.max() <= tmax and np.median(gap) <= tmed):
                    raise AssertionError(f"parallel (b) {n} queries, rank {rank}: {key} gap {gap.max():.3e} / "
                                         f"{np.median(gap):.3e} beyond phase 4's limits {tmax} / {tmed}")
            for key in counts:
                counts[key] += got["launches"].get(key, 0)
        per_rank = [r["knn_mesh"][qi]["launches"] for r in results[2]]
        log(f"parallel (b) flagship bf16 knn_mesh 1 x 2, request of {n} queries: schedules per rank "
            f"{[r['knn_mesh'][qi]['schedules'] for r in results[2]]}, launches per rank {per_rank}, ms per rank "
            f"{[round(r['knn_mesh'][qi]['ms'], 2) for r in results[2]]}; against one process (limits phase 4's, "
            f"traj {E2E_TRAJ_MAX} / {E2E_TRAJ_MEDIAN}, vis {E2E_VIS_MAX} / {E2E_VIS_MEDIAN}): {'; '.join(rows)} "
            f"[{smi}]")
        schedule = "gather" if n * 16 <= LEVEL_POINTS[0] // 2 else "ring"
        if any(not r["knn_mesh"][qi]["schedules"][schedule] for r in results[2]):
            raise AssertionError(f"parallel (b) {n} queries: level 0 did not take the {schedule} schedule")
    paths["parallel_knn_mesh"] = counts

    # (c) The sharded train step against one process.
    counts = {"knn": 0, "corr": 0, "corr_bwd": 0}
    for world, part in ((2, "step"), (4, "step4")):
        ranks = [r[part] for r in results[world]]
        if len({r["digest"] for r in ranks}) != 1:
            raise AssertionError(f"parallel (c) {part}: the ranks' parameters differ {[r['digest'] for r in ranks]}")
        gaps = step_gaps(ranks[0], step_want)
        label = "2 x 1" if world == 2 else "2 x 2 shard_views shard_tracks"
        log(f"parallel (c) flagship fp32 train step, TF32 off, remat, {label}, {PAR_STEPS} steps of a 2-scene batch "
            f"({step_scene[0]} views x {step_scene[1]} frames x {step_scene[2]}x{step_scene[3]}, {step_scene[4]} "
            f"tracks) against one process: loss {[round(m['loss'], 6) for m in ranks[0]['metrics']]} vs "
            f"{[round(m['loss'], 6) for m in step_want['metrics']]}; gaps {gaps}, limits {PAR_STEP_LIMITS}; "
            f"launches per rank {[r['parity_launches'] for r in ranks]} [{smi}]")
        if world == 2:
            log(f"parallel (c) one process against itself, the same fp32 steps: gaps {step_again}; ops without a "
                f"deterministic implementation in one such step (each rank of the 2-rank round, in its own "
                f"process): {[r['probe'] for r in results[2]]} [{smi}]")
        bad = {key: v for key, v in gaps.items() if not v <= PAR_STEP_LIMITS[key]}
        if bad:
            raise AssertionError(f"parallel (c) {label}: gaps {bad} beyond {PAR_STEP_LIMITS}")
        bf16 = [r["bf16"] for r in ranks]
        log(f"parallel (c) flagship bf16 (remat) {label}, {PAR_BF16_STEPS} steps of 2 scenes of {V} views x {T} "
            f"frames x {H}x{W}, {N_QUERIES} tracks ({world} processes sharing one card, no data-parallel speed-up): "
            f"ms per step per rank {[[round(x, 1) for x in b['ms']] for b in bf16]}, peak memory per rank "
            f"{[round(b['peak_mib'], 1) for b in bf16]} MiB, losses {bf16[0]['loss']}, launches per rank "
            f"{[b['launches'] for b in bf16]} [{smi}]")
        want_steps = {"knn": K1_PER_FWD * PAR_BF16_STEPS, "corr": K2_PER_FWD * PAR_BF16_STEPS,
                      "corr_bwd": K3_PER_STEP * PAR_BF16_STEPS}
        if any(b["launches"] != want_steps for b in bf16) or not all(np.isfinite(b["loss"]).all() for b in bf16):
            raise AssertionError(f"parallel (c) {label} bf16: launches {[b['launches'] for b in bf16]}, want "
                                 f"{want_steps}; losses {[b['loss'] for b in bf16]}")
        for b in bf16:
            for key in counts:
                counts[key] += b["launches"][key]
    paths["parallel_train"] = counts

    ranks = [r["bundle"] for r in results[2]]
    sharded_points = np.concatenate([r["points"] for r in ranks])
    sharded_gap = float(np.abs(pixels(torch, intrs_b, ranks[0]["extrs"], sharded_points)
                               - pixels(torch, intrs_b, *cams[PAR_DEVICE][1:3])).max())
    log(f"parallel (e) bundle adjustment: refine_cameras_sharded over 2 ranks vs refine_cameras on the card "
        f"{sharded_gap:.3e} px (limit {BA_PIXEL_ATOL}) [{smi}]")
    if not (sharded_gap <= BA_PIXEL_ATOL and np.array_equal(ranks[0]["extrs"], ranks[1]["extrs"])):
        raise AssertionError("parallel (e): the sharded bundle adjustment differs")
    tmp.cleanup()
    return paths


# ---------------------------------------------------------------------------
# Phase 15: the DROID data factory
# ---------------------------------------------------------------------------

# The synthetic episode every part of the phase runs on: 2 external cameras
# and the wrist camera at 256x192, 40 frames (three boundary-chained segments
# of `track --chunk_frames 16`), 24 contact points a finger. It is built in a
# process of its own from the top of the script (numpy ray tracing on the
# host, about a minute of one core), beside the card phases.
DROID_EPISODE = dict(seed=0, n_frames=40, n_external_cams=2, width=256, height=192, num_track_points=24)
DROID_DEVICE = "cuda"  # phase 15's device (a rehearsal on the CPU sets "cpu")
DROID_CHUNK = 16
DROID_QUERIES = 256  # depth queries of the mask-guided request
DROID_TIMED = 3  # warm gripper requests timed
DROID_PLAIN_FRAMES = 24  # the fp32 card-vs-CPU request: two chained segments
DROID_REPROJECT_FRAMES = 8
DROID_TRAIN_FRAMES, DROID_TRAIN_STEPS = 24, 3
DROID_Z_TRUE = 0.03  # the wrist bias injected for `refine` (3 cm, as tests/test_droid_refine.py)
DROID_Z_ATOL = 1e-3  # the JAX package's recovery criterion
# Card against CPU: the refined offset, and the fp32 track request (TF32
# off, exact kNN on both). Limits from `scripts/control_torch_droid.py`, the
# plain CPU path against itself with its inputs moved by up to 1e-6 (run on
# the card host's CPU), and the card's first reading: 3 times the larger, as
# phase 13's. The control's offset does not move (0.0; the card's gap read
# 0.0 too): the limit is the search's own tolerance, 1e-5 m. Track control
# traj median / p90 / max 4.88e-7 / 9.24e-7 / 4.89e-5, vis 6.56e-7 /
# 2.74e-6 / 0.601 (one visibility flips under the move, so the vis max
# holds nothing); the card read traj 0.0 / 7.45e-9 / 2.12e-6, vis 4.17e-7 /
# 7.15e-7 / 7.69e-5.
DROID_REFINE_CPU_ATOL = 1e-5
DROID_PLAIN_LIMITS = {"traj": {"median": 1.5e-6, "p90": 2.8e-6, "max": 1.5e-4},
                      "vis": {"median": 2.0e-6, "p90": 8.2e-6, "max": 1.0}}
# The codecs at DROID's own size: a ZED HD720 depth stream and a
# trajectory.h5 of 300 steps.
CODEC_FRAMES, CODEC_H, CODEC_W = 60, 720, 1280
H5_STEPS = 300


def build_droid_episode(root: str, spec: dict) -> None:
    """Phase 15 (b)'s episode, in its own process: raw h5 -> FK pipeline ->
    rendered rgb.npz and depth.mkv under `root/processed`."""
    from mvtracker_torch.droid.synth_episode import build_episode

    t0 = time.perf_counter()
    build_episode(root, **spec)
    with open(os.path.join(root, "build_seconds"), "w") as f:
        f.write(f"{time.perf_counter() - t0:.1f}")


def start_droid_episode(spec=None):
    """Start building phase 15's episode (or the one `spec` names) in a
    spawned process; returns (process, temporary directory, its start time)."""
    import multiprocessing

    tmp = tempfile.TemporaryDirectory()
    proc = multiprocessing.get_context("spawn").Process(
        target=build_droid_episode, args=(tmp.name, spec or DROID_EPISODE), daemon=True)
    proc.start()
    return proc, tmp, time.perf_counter()


def codec_depth(rng, t, h, w):
    """Depth frames [t, h, w] in meters as a ZED stream gives them: a slanted
    table with noise, a hole (no depth) and a far band near 65 m."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.4 + 0.9 * yy / h + 0.2 * np.sin(xx / 53.0)
    d = base[None] + rng.normal(0, 0.002, (t, h, w)).astype(np.float32)
    d[:, h // 3:h // 2, w // 5:w // 3] = 0.0
    d[:, :h // 10] = rng.uniform(63.0, 65.5, (t, h // 10, w)).astype(np.float32)
    return d


def phase_droid(torch, smi, job):
    """Phase 15: (a) the port's FFV1 and HDF5 codecs at DROID's size, (b) the
    synthetic episode and its loader, (c) `cli.droid refine`, (d) `cli.droid
    track`, (e) `cli.droid reproject`, (f) `cli.train` with dataset=droid.
    Returns {path: launch totals}."""
    import shutil

    from mvtracker_torch.cli import droid as droid_cli
    from mvtracker_torch.cli import train as cli_train
    from mvtracker_torch.datasets import droid as droid_data
    from mvtracker_torch.datasets import hdf5
    from mvtracker_torch.device import fp32_precision
    from mvtracker_torch.droid import depth_video, reproject
    from mvtracker_torch.droid.refine import refine_episode_wrist_z
    from mvtracker_torch.evaluation.evaluator import to_host

    paths = {}
    proc, episode_tmp, started = job
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    rng = np.random.default_rng(0)

    # (a) FFV1 at 1280x720: encode, decode, bit-equal millimetres.
    depth = codec_depth(rng, CODEC_FRAMES, CODEC_H, CODEC_W)
    mm = np.stack([depth_video.encode_depth_frame(f) for f in depth])
    mkv = str(root / "zed_hd720_depth.mkv")
    t0 = time.perf_counter()
    depth_video.write_depth_video(mkv, depth)
    enc_ms = (time.perf_counter() - t0) * 1e3 / CODEC_FRAMES
    t0 = time.perf_counter()
    back = depth_video.read_bgr_frames(mkv)
    dec_ms = (time.perf_counter() - t0) * 1e3 / CODEC_FRAMES
    equal = len(back) == CODEC_FRAMES and all(np.array_equal(a[..., :2], b[..., :2]) for a, b in zip(back, mm))
    size = os.path.getsize(mkv)
    log(f"droid (a) FFV1 depth video, {CODEC_FRAMES} frames of {CODEC_W}x{CODEC_H} (holes, far band near 65 m): "
        f"encode {enc_ms:.2f} ms a frame, decode {dec_ms:.2f} ms a frame (host, {os.cpu_count()} cores), "
        f"{size / 2**20:.1f} MiB ({size / (CODEC_FRAMES * CODEC_H * CODEC_W * 2):.3f} of the raw uint16), "
        f"millimetres bit-equal {equal} [{smi}]")
    if not equal:
        raise AssertionError("droid (a): the FFV1 round trip is not bit-equal")
    del depth, mm, back
    # HDF5: a DROID-shaped trajectory.h5, contiguous and chunked.
    h5_data = {"observation/robot_state/cartesian_position": rng.normal(size=(H5_STEPS, 6)),
               "observation/robot_state/gripper_position": rng.uniform(size=(H5_STEPS, 1))}
    for layout, kw in (("contiguous", {}), ("chunked, resizable, deflate",
                                            dict(chunks={k: (64,) + v.shape[1:] for k, v in h5_data.items()},
                                                 deflate=4))):
        path = str(root / "trajectory.h5")
        t0 = time.perf_counter()
        hdf5.write(path, h5_data, **kw)
        got = hdf5.read_all(path)
        ms = (time.perf_counter() - t0) * 1e3
        same = sorted(got) == sorted(h5_data) and all(
            got[k].dtype == v.dtype and np.array_equal(got[k], v) for k, v in h5_data.items())
        log(f"droid (a) HDF5 trajectory.h5 ({layout}): cartesian [{H5_STEPS}, 6] and gripper [{H5_STEPS}, 1] "
            f"float64 written and read back in {ms:.1f} ms, equal {same}")
        if not same:
            raise AssertionError(f"droid (a): the {layout} HDF5 round trip differs")

    # (b) The episode, built beside the earlier phases.
    t0 = time.perf_counter()
    proc.join(timeout=900)
    waited = time.perf_counter() - t0
    if proc.exitcode != 0:
        raise AssertionError(f"droid (b): the episode build ended with exit code {proc.exitcode}")
    build_s = float((Path(episode_tmp.name) / "build_seconds").read_text())
    ep = str(Path(episode_tmp.name) / "processed" / f"episode_{DROID_EPISODE['seed']:03d}")
    t0 = time.perf_counter()
    dp = droid_data.load_droid_episode(ep)
    load_ms = (time.perf_counter() - t0) * 1e3
    cams = droid_data.episode_camera_ids(ep)
    tracks = np.load(os.path.join(ep, "tracks.npz"))
    extr = np.load(os.path.join(ep, "extrinsics.npz"))
    meta = json.loads(Path(ep, "metadata.json").read_text())
    for vi, cid in enumerate(cams):
        rec = Path(ep, "recordings", cid)
        pose = extr["wrist"] if cid == meta["wrist_cam_serial"] else np.broadcast_to(
            extr[f"external_{cid}"], (dp.video.shape[1], 4, 4))
        same = (np.array_equal(dp.video[vi], np.load(rec / "rgb.npz")["rgb"].astype(np.float32))
                and np.array_equal(dp.videodepth[vi], depth_video.read_depth_video(str(rec / "depth.mkv")))
                and np.array_equal(dp.extrs[vi], np.linalg.inv(pose.astype(np.float64))[:, :3].astype(np.float32))
                and np.array_equal(dp.intrs[vi, 0], np.asarray(meta["camera_intrinsics"][cid]["K"], np.float32)))
        if not same:
            raise AssertionError(f"droid (b): load_droid_episode's camera {cid} differs from its files")
    if not np.array_equal(dp.trajectory_3d, tracks["tracks_3d"].astype(np.float32)):
        raise AssertionError("droid (b): load_droid_episode's tracks differ from tracks.npz")
    v, t, h, w = dp.videodepth.shape
    log(f"droid (b) synthetic episode ({v} cameras {cams} x {t} frames x {w}x{h}, {dp.trajectory_3d.shape[1]} "
        f"FK contact tracks; raw trajectory.h5 through the port's HDF5 writer and reader, depth.mkv through its FFV1 "
        f"writer): built in {build_s:.1f} s in its own process beside phases 2 to 14, waited {waited:.1f} s for it; "
        f"load_droid_episode {load_ms:.1f} ms, equal to the files it reads [{smi}]")
    del dp

    # (c) cli.droid refine on a copy with the wrist biased by DROID_Z_TRUE.
    biased = str(root / "biased")
    shutil.copytree(ep, biased)
    data = dict(np.load(os.path.join(biased, "extrinsics.npz")))
    data["wrist"] = data["wrist"].copy()
    data["wrist"][:, :3, 3] -= DROID_Z_TRUE * data["wrist"][:, :3, 2]
    np.savez_compressed(os.path.join(biased, "extrinsics.npz"), **data)
    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        droid_cli.main(["refine", "--episode", biased, "--device", DROID_DEVICE])
    refine_s = time.perf_counter() - t0
    paths["droid_refine"] = {"knn": read_counts().get("knn", 0)}
    card = json.loads(out.getvalue().strip().splitlines()[-1])
    t0 = time.perf_counter()
    cpu = refine_episode_wrist_z(biased, device="cpu")
    cpu_s = time.perf_counter() - t0
    z_err = abs(card["wrist_z_offset_m"] - DROID_Z_TRUE)
    z_gap = abs(card["wrist_z_offset_m"] - cpu["wrist_z_offset_m"])
    log(f"droid (c) cli.droid refine, wrist biased {DROID_Z_TRUE} m: card {card['wrist_z_offset_m']:.6f} m "
        f"(fitness {card['fitness']:.4f}, {card['frames_used']} frames, {refine_s:.1f} s, launches "
        f"{paths['droid_refine']}), {z_err * 1e3:.3f} mm from the bias (limit {DROID_Z_ATOL * 1e3:.0f} mm); CPU "
        f"{cpu['wrist_z_offset_m']:.6f} m ({cpu_s:.1f} s), gap {z_gap:.3e} (limit {DROID_REFINE_CPU_ATOL}) [{smi}]")
    if not (card["status"] == "ok" and z_err < DROID_Z_ATOL and z_gap <= DROID_REFINE_CPU_ATOL
            and paths["droid_refine"]["knn"] > 0):
        raise AssertionError("droid (c): the wrist offset was not recovered, or card and CPU differ")

    # (d) cli.droid track: the flagship bf16 with seeded weights.
    mask = np.zeros((h, w), np.float32)
    mask[:, : 3 * w // 4] = 1.0
    masked = str(root / "masked")
    shutil.copytree(ep, masked)
    np.savez_compressed(os.path.join(masked, "masks.npz"), **{f"cam{c}": mask for c in cams})
    track_counts = {}
    for name, episode, extra in (("gripper", ep, []),
                                 ("depth", masked, ["--queries", "depth", "--num_queries", str(DROID_QUERIES)])):
        reset_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = droid_cli.main(["track", "--episode", episode, "--out", str(root / f"{name}.npz"), "--chunk_frames",
                              str(DROID_CHUNK), "--overlay", str(root / f"{name}_overlay.mp4"), "--device",
                              DROID_DEVICE, *extra])
        first_s = time.perf_counter() - t0
        track_counts[name] = {k: read_counts().get(k, 0) for k in ("knn", "corr")}
        traj, vis = to_host(res["traj"]), to_host(res["vis"])
        written = sorted(p.name for p in root.iterdir() if p.name.startswith(f"{name}_overlay"))
        log(f"droid (d) cli.droid track --queries {name} (bf16, seeded weights, 6 iterations, grid 5, "
            f"--chunk_frames {DROID_CHUNK}): traj {tuple(traj.shape)}, finite {bool(np.isfinite(traj).all())}, "
            f"launches {track_counts[name]}, first request with the model's build {first_s:.1f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; overlay written as {written} [{smi}]")
        if not (traj.shape[0] == t and np.isfinite(traj).all() and np.isfinite(vis).all()
                and all(track_counts[name].values()) and written):
            raise AssertionError(f"droid (d) {name}: outputs, launches or overlay missing")
    paths["droid_track"] = {k: sum(c[k] for c in track_counts.values()) for k in ("knn", "corr")}
    args = droid_cli.build_parser().parse_args(
        ["track", "--episode", ep, "--out", str(root / "timed.npz"), "--chunk_frames", str(DROID_CHUNK), "--device",
         DROID_DEVICE])
    dp, queries, pred = droid_cli.prepare_track(args)
    request = (dp.video, dp.videodepth, queries, dp.intrs, dp.extrs)
    with torch.no_grad():
        pred(*request)
        torch.cuda.synchronize()
        times = []
        for _ in range(DROID_TIMED):
            t0 = time.perf_counter()
            to_host(pred(*request)["traj"])
            times.append((time.perf_counter() - t0) * 1e3)
    log(f"droid (d) track, warm gripper requests ({len(queries)} queries, {v} x {t} frames of {w}x{h}, 3 segments): "
        f"{[round(x, 2) for x in times]} ms [{smi}]")
    del pred, dp
    # One fp32 request (TF32 off, exact kNN) on the card against the plain CPU path.
    outs = {}
    for device in (DROID_DEVICE, "cpu"):
        args = droid_cli.build_parser().parse_args(
            ["track", "--episode", ep, "--out", str(root / "plain.npz"), "--chunk_frames", str(DROID_CHUNK),
             "--max_frames", str(DROID_PLAIN_FRAMES), "--dtype", "float32", "--device", device])
        dp, queries, pred = droid_cli.prepare_track(args)
        pred.model.knn_backend = "exact"
        t0 = time.perf_counter()
        with torch.no_grad(), fp32_precision(True):
            res = pred(dp.video, dp.videodepth, queries, dp.intrs, dp.extrs)
        outs[device] = (to_host(res["traj"]), to_host(res["vis"]))
        if device == "cpu":
            cpu_s = time.perf_counter() - t0
        del pred
    check_gaps({"droid": outs[DROID_DEVICE]}, {"droid": outs["cpu"]}, DROID_PLAIN_LIMITS,
               f"droid (d) track fp32 (TF32 off, exact kNN), {DROID_PLAIN_FRAMES} frames, card vs plain CPU "
               f"({cpu_s:.1f} s on the CPU) [{smi}]")
    torch.cuda.empty_cache()

    # (e) cli.droid reproject: depth videos through the FFV1 writer.
    out_dir = str(root / "reprojected")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        droid_cli.main(["reproject", "--episode", ep, "--out", out_dir, "--max_frames", str(DROID_REPROJECT_FRAMES),
                        "--overlay_tracks"])
    rp_s = time.perf_counter() - t0
    dp = droid_data.load_droid_episode(ep, max_frames=DROID_REPROJECT_FRAMES)
    clamps = reproject._camera_clamps(cams, meta["wrist_cam_serial"])
    direct_hits = 0
    for ti in range(DROID_REPROJECT_FRAMES):
        pts, cols = reproject.fuse_frame_cloud(dp.video[:, ti], dp.videodepth[:, ti], dp.intrs[:, ti],
                                               dp.extrs[:, ti], clamps, stride=2)
        for vi, cid in enumerate(cams):
            _, dep = reproject.render_pointcloud_to_view(pts, cols, dp.intrs[vi, ti], dp.extrs[vi, ti], h, w,
                                                         min_depth=clamps[vi][0], splat_size=3)
            got = depth_video.read_depth_video(os.path.join(out_dir, f"{cid}_depth_reprojected.mkv"))[ti]
            if not np.array_equal(got, depth_video.decode_depth_frame(depth_video.encode_depth_frame(dep))):
                raise AssertionError(f"droid (e): camera {cid} frame {ti}: the depth video is not the render")
            if ti == 0:
                # The z-buffer: every pixel a point lands on holds the closest.
                cam_pts = pts @ dp.extrs[vi, 0, :, :3].T + dp.extrs[vi, 0, :, 3]
                z = cam_pts[:, 2]
                keep = z > clamps[vi][0]
                k = dp.intrs[vi, 0]
                u = np.round(cam_pts[keep, 0] * k[0, 0] / z[keep] + k[0, 2]).astype(np.int64)
                vv = np.round(cam_pts[keep, 1] * k[1, 1] / z[keep] + k[1, 2]).astype(np.int64)
                inside = (u >= 0) & (u < w) & (vv >= 0) & (vv < h)
                closest = np.full(h * w, np.inf, np.float32)
                np.minimum.at(closest, vv[inside] * w + u[inside], z[keep][inside].astype(np.float32))
                hit = np.isfinite(closest)
                direct_hits += int(hit.sum())
                if not np.array_equal(dep.reshape(-1)[hit], closest[hit]):
                    raise AssertionError(f"droid (e): camera {cid}: the z-buffer does not keep the closest point")
    files = sorted(os.listdir(out_dir))
    log(f"droid (e) cli.droid reproject --max_frames {DROID_REPROJECT_FRAMES} --overlay_tracks: {rp_s:.1f} s; "
        f"{len(cams)} depth videos read back bit-equal to the renders' millimetres, the z-buffer holding the closest "
        f"point at all {direct_hits} directly hit pixels of frame 0; files {files} [{smi}]")
    del dp

    # (f) cli.train with dataset=droid: 3 bf16 steps of configs/mvtracker.yaml.
    windows = windows_of(np.zeros((1, 4)), DROID_TRAIN_FRAMES, WINDOW, WINDOW // 2)
    argv = ["--config", str(ROOT / "configs" / "mvtracker.yaml"), "--device", DROID_DEVICE, "data.dataset=droid",
            f"data.root={os.path.dirname(ep)}", f"data.n_frames={DROID_TRAIN_FRAMES}", "data.num_workers=1",
            "model.compute_dtype=bfloat16", f"trainer.total_steps={DROID_TRAIN_STEPS}",
            f"trainer.exp_dir={root / 'train'}", "trainer.telemetry_freq=1", "trainer.save_ckpt_freq=1000"]
    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    with LogRecords() as logs:
        state = cli_train.main(argv)
    train_s = time.perf_counter() - t0
    paths["droid_train"] = {k: read_counts().get(k, 0) for k in ("knn", "corr", "corr_bwd")}
    # adaptive_iters with 100 warm-up steps: one iteration a step.
    want = {"knn": DROID_TRAIN_STEPS * (1 + 3 * windows), "corr": DROID_TRAIN_STEPS * 4 * windows,
            "corr_bwd": DROID_TRAIN_STEPS * 4 * windows}
    losses = [m.split(" loss=")[1].split()[0] for m in logs.messages if " loss=" in m]
    telemetry = [m.split(" | ")[-1] for m in logs.messages if "mean/med/std" in m]
    log(f"droid (f) cli.train configs/mvtracker.yaml data.dataset=droid data.n_frames={DROID_TRAIN_FRAMES} bf16: "
        f"{state.step} steps in {train_s:.1f} s, losses {losses}, launches {paths['droid_train']} ({windows} windows "
        f"a step: K1 {1 + 3 * windows}, K2 {4 * windows}, K3 {4 * windows} a step); telemetry {telemetry} [{smi}]")
    if state.step != DROID_TRAIN_STEPS or paths["droid_train"] != want or len(losses) != DROID_TRAIN_STEPS or not all(
            np.isfinite(float(x)) for x in losses):
        raise AssertionError(f"droid (f): steps {state.step}, launches {paths['droid_train']} (want {want}), "
                             f"losses {losses}")
    del state
    torch.cuda.empty_cache()
    tmp.cleanup()
    episode_tmp.cleanup()
    return paths


# ---------------------------------------------------------------------------
# Phase 16: checkpoint conversion, the demo, the DROID north star and its
# fine-tuning, each through the entry point a user runs.
# ---------------------------------------------------------------------------

SLICE_DEVICE = "cuda"  # phase 16's device (a rehearsal on the CPU sets "cpu")
DEMO_CHUNK = 16  # the demo's --chunk_frames: phase 3's 24 frames in 2 chained segments
# (a)'s one-step checkpoint to export: the medium release model on a small
# synthetic scene.
EXPORT_SCENE = dict(n_views=2, n_frames=8, height=64, width=64, n_tracks=16)
# (c) The north star at `scripts/eval_droid_track_error.py`'s settings: its
# first episode (2 external cameras and the wrist at 256x192, 48 frames, 24
# contact points a finger), the medium model with vis-geom features and a
# 128-wide visibility MLP in fp32, 3 iterations, grid 0, world scale auto.
# One episode where the JAX run had 4 (cut for time). The episode is built
# in a process of its own from the top of the script, as phase 15's is.
NORTH_EPISODE = dict(seed=0, n_frames=48, n_external_cams=2, width=256, height=192, num_track_points=24)
NORTH_PLAIN_FRAMES = 16  # the card-vs-CPU request: the episode's first 16 frames
# Card against CPU on those frames (TF32 off, exact kNN on both): 3 times the
# larger of the CPU control (`scripts/control_torch_north_star.py`, the plain
# CPU path against itself with the queries moved by up to 1e-6, run on an
# 8-core host without the card) and the card's first reading, per weights.
# Seeded: control traj median / p90 / max 4.79e-7 / 8.94e-7 / 4.72e-6, vis
# 3.73e-7 / 1.23e-6 / 0.229 (one visibility flips, so the vis max holds
# nothing); card traj 0.0 / 0.0 / 3.73e-9, vis 2.09e-7 / 6.56e-7 / 1.52e-6.
# The release amplifies rounding, as in phase 9: control traj 3.73e-5 /
# 2.25e-3 / 7.18e-2, vis 1.01e-2 / 4.68e-2 / 0.440; card traj 1.25e-6 /
# 1.06e-4 / 9.69e-3, vis 8.89e-4 / 7.63e-3 / 2.54e-2.
NORTH_PLAIN_LIMITS = {
    "seeded": {"traj": {"median": 1.5e-6, "p90": 2.7e-6, "max": 1.5e-5},
               "vis": {"median": 1.2e-6, "p90": 3.7e-6, "max": 1.0}},
    "release": {"traj": {"median": 1.2e-4, "p90": 6.8e-3, "max": 0.22},
                "vis": {"median": 3.1e-2, "p90": 0.15, "max": 1.0}},
}
FT_STEPS = 3  # (d) `train_droid_ft_torch.py` steps from (c)'s weights


def counted(knn_ops, corr_ops):
    """A context that records every kNN search and every neighbour
    correlation the block asks for (the dispatchers' calls), beside the
    kernels' launch counters."""
    stack = contextlib.ExitStack()
    searches, correlations = [], []
    stack.enter_context(recording(knn_ops, "knn", searches, keep=lambda a, kw, out: 1))
    stack.enter_context(recording(corr_ops, "corr_select", correlations, keep=lambda a, kw, out: 1))
    return stack, searches, correlations


def every_search_launched(path, counts, searches, correlations) -> None:
    """Each kNN search went to K1 and each correlation to K2: as many
    launches as calls, none of them zero."""
    if not (counts["knn"] == len(searches) > 0 and counts["corr"] == len(correlations) > 0):
        raise AssertionError(f"{path}: launches {counts} for {len(searches)} kNN searches and {len(correlations)} "
                             "correlations")


def phase_slice(torch, smi, job, release):
    """Phase 16: (a) `cli.convert` and `export_params_msgpack_torch.py`
    round trips, (b) `cli.demo`, (c) the DROID north star
    (`eval_droid_track_error_torch.py`), (d) `train_droid_ft_torch.py`.
    Returns {path: launch totals}."""
    import shutil

    from mvtracker_torch import convert
    from mvtracker_torch.cli import demo as demo_cli
    from mvtracker_torch.datasets.loader import PrefetchLoader, SyntheticSceneDataset
    from mvtracker_torch.device import fp32_precision
    from mvtracker_torch.evaluation.evaluator import to_host
    from mvtracker_torch.evaluation.predictor import EvaluationPredictor
    from mvtracker_torch.models.mvtracker import MVTracker
    from mvtracker_torch.ops import corr as corr_ops
    from mvtracker_torch.ops import knn as knn_ops
    from mvtracker_torch.presets import build_model
    from mvtracker_torch.scene import make_scene
    from mvtracker_torch.training import step as step_lib
    from mvtracker_torch.training.train import TrainConfig, Trainer

    sys.path.insert(0, str(ROOT / "scripts"))
    import eval_droid_track_error_torch as north_star
    import export_params_msgpack_torch as export
    import train_droid_ft_torch as finetune

    dev = torch.device(SLICE_DEVICE)
    paths = {}
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)

    # (a) cli.convert: the seeded flagship's state dict under "model", as a
    # training checkpoint holds it, through the CLI's own process.
    model = MVTracker(device=dev)
    sd = convert.random_state_dict(model, seed=0)
    torch.save({"model": sd, "step": 0}, root / "flagship.pth")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "mvtracker_torch.cli.convert", str(root / "flagship.pth"),
                          str(root / "flagship.msgpack")], cwd=ROOT, capture_output=True, text=True, timeout=600)
    convert_s = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"slice (a): cli.convert exited with {run.returncode}: {run.stderr[-2000:]}")
    convert.load_release(str(root / "flagship.msgpack"), model)
    loaded = model.state_dict()
    differ = [k for k in sd if not torch.equal(loaded[k].cpu(), sd[k])]
    log(f"slice (a) python -m mvtracker_torch.cli.convert on the seeded flagship (a .pth under 'model'): "
        f"{run.stdout.strip()!r} in {convert_s:.1f} s (a process of its own), "
        f"{(root / 'flagship.msgpack').stat().st_size / 2**20:.1f} MiB; load_release strict into a fresh flagship: "
        f"{len(sd) - len(differ)} of {len(sd)} leaves bit-equal")
    if differ:
        raise AssertionError(f"slice (a): leaves differ after the convert round trip: {differ[:8]}")
    # export_params_msgpack_torch.py --dtype bfloat16 on a one-step checkpoint.
    medium = build_model("medium", vis_geom=True, vis_head_hidden=128, device=dev)
    medium.load_state_dict(convert.random_state_dict(medium, seed=1))
    cfg = TrainConfig(total_steps=1, warmup_steps=0, adaptive_iters=False, train_iters=1, save_ckpt_freq=1,
                      exp_dir=str(root / "one_step"), tensorboard=False, watchdog_timeout_s=0)
    ds = SyntheticSceneDataset(n_scenes=1, cache=True, **EXPORT_SCENE)
    state = Trainer(medium, cfg).fit(iter(PrefetchLoader(ds, batch_size=1, num_workers=1, shuffle=False)),
                                     max_steps=1)
    stepped = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        export.main(["--exp_dir", str(root / "one_step"), "--model_size", "medium", "--vis_geom",
                     "--vis_head_hidden", "128", "--out", str(root / "medium_bf16.msgpack"), "--dtype", "bfloat16",
                     "--device", SLICE_DEVICE])
    export_s = time.perf_counter() - t0
    back = convert.params_from_flax(convert.load_flax_msgpack(str(root / "medium_bf16.msgpack")))
    differ = [k for k in stepped if not torch.equal(back[k], stepped[k].to(torch.bfloat16).float())]
    fresh = build_model("medium", vis_geom=True, vis_head_hidden=128, device=dev)
    convert.load_release(str(root / "medium_bf16.msgpack"), fresh)
    log(f"slice (a) {out.getvalue().strip()!r} in {export_s:.1f} s: "
        f"{(root / 'medium_bf16.msgpack').stat().st_size / 2**20:.1f} MiB, {len(stepped) - len(differ)} of "
        f"{len(stepped)} leaves equal to the step-1 weights rounded to bf16 and widened; load_release strict")
    if sorted(back) != sorted(stepped) or differ:
        raise AssertionError(f"slice (a): the bf16 export differs from the checkpoint: {differ[:8]}")
    del medium, fresh, state, back, stepped

    # (b) cli.demo on phase 3's scene (seed 0) written as a sample NPZ, the
    # flagship's seeded weights from a --ckpt_dir.
    rgbs, depths, query, intrs, extrs = make_scene(np.random.default_rng(0), V, T, H, W, N_QUERIES)
    np.savez(root / "sample.npz", rgbs=rgbs, depths=depths, query_points=query, intrs=intrs, extrs=extrs)
    demo_trainer = Trainer(model, TrainConfig(exp_dir=str(root / "demo_exp"), tensorboard=False, watchdog_timeout_s=0))
    demo_trainer.save(step_lib.init_state(model, demo_trainer.optimizer), 1)
    reset_counts()
    stack, searches, correlations = counted(knn_ops, corr_ops)
    t0 = time.perf_counter()
    with stack, LogRecords() as logs:
        res = demo_cli.main(["--sample", str(root / "sample.npz"), "--out", str(root / "demo.npz"), "--ckpt_dir",
                             str(root / "demo_exp"), "--chunk_frames", str(DEMO_CHUNK), "--mp4",
                             str(root / "demo.mp4"), "--device", SLICE_DEVICE])
    demo_s = time.perf_counter() - t0
    paths["demo"] = {k: read_counts().get(k, 0) for k in ("knn", "corr")}
    every_search_launched("slice (b) demo", paths["demo"], searches, correlations)
    # `viz/mp4.save_video`: an mp4 or a GIF where imageio can write one, else an .npz frame stack.
    written = sorted(p.name for p in root.iterdir() if p.name in ("demo.mp4", "demo.gif", "demo.mp4.npz"))
    saved = np.load(root / "demo.npz")
    model.eval()
    direct = EvaluationPredictor(model, interp_shape=None, grid_size=0, n_iters=6, chunk_frames=DEMO_CHUNK)
    with torch.no_grad():
        want = direct(*demo_cli.load_sample(str(root / "sample.npz")))
    equal = (np.array_equal(saved["traj_e"], to_host(want["traj"])) and np.array_equal(saved["vis_e"],
                                                                                       to_host(want["vis"])))
    tracked = [m for m in logs.messages if m.startswith("tracked")]
    log(f"slice (b) python -m mvtracker_torch.cli.demo --chunk_frames {DEMO_CHUNK} --mp4 (flagship fp32, seeded "
        f"weights from --ckpt_dir, {V} views x {T} frames x {W}x{H}, {N_QUERIES} queries, 6 iterations): "
        f"{demo_s:.1f} s with the model's build ({tracked[-1] if tracked else 'no timing logged'}), launches "
        f"{paths['demo']} for {len(searches)} kNN searches and {len(correlations)} correlations; traj_e "
        f"{saved['traj_e'].shape} and vis_e bit-equal to the predictor called directly: {equal}; "
        f"mosaic written as {written} [{smi}]")
    if not (equal and written and np.isfinite(saved["traj_e"]).all() and saved["traj_e"].shape == (T, N_QUERIES, 3)):
        raise AssertionError("slice (b): the demo's outputs differ from the predictor's, or the mosaic is missing")
    del model, direct, res, want

    # (c) The north star: seeded medium weights written through the port's
    # encoder (the strict load then runs), or the release.
    proc, episode_tmp, _ = job
    t0 = time.perf_counter()
    proc.join(timeout=900)
    waited = time.perf_counter() - t0
    if proc.exitcode != 0:
        raise AssertionError(f"slice (c): the episode build ended with exit code {proc.exitcode}")
    build_s = float((Path(episode_tmp.name) / "build_seconds").read_text())
    ep_root = episode_tmp.name
    weights = release
    if weights is None:
        seeded = build_model("medium", vis_geom=True, vis_head_hidden=128, device="cpu")
        weights = str(root / "medium_seeded.msgpack")
        convert.save_flax_msgpack(convert.convert_reference_state_dict(convert.random_state_dict(seeded, seed=0)),
                                  weights)
    argv = ["--root", ep_root, "--episodes", "1", "--frames", str(NORTH_EPISODE["n_frames"]), "--width",
            str(NORTH_EPISODE["width"]), "--height", str(NORTH_EPISODE["height"]), "--external_cams",
            str(NORTH_EPISODE["n_external_cams"]), "--track_points", str(NORTH_EPISODE["num_track_points"]),
            "--params_msgpack", weights, "--out_json", str(root / "north_star.json"), "--device", SLICE_DEVICE]
    reset_counts()
    stack, searches, correlations = counted(knn_ops, corr_ops)
    out = io.StringIO()
    t0 = time.perf_counter()
    with stack, contextlib.redirect_stdout(out):
        results = north_star.main(argv)
    north_s = time.perf_counter() - t0
    paths["north_star"] = {k: read_counts().get(k, 0) for k in ("knn", "corr")}
    every_search_launched("slice (c) north star", paths["north_star"], searches, correlations)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    proto = results["protocol"]
    log(f"slice (c) scripts/eval_droid_track_error_torch.py ({'release' if release else 'seeded'} weights, strict "
        f"msgpack load; 1 episode of {proto['cams']} cameras x {proto['frames']} frames x "
        f"{proto['resolution'][1]}x{proto['resolution'][0]}, built in {build_s:.1f} s in its own process, waited "
        f"{waited:.1f} s; world scale {proto['world_scale']:.4f}; backend {proto['backend']}): median 3D track error "
        f"{line['median_3d_track_error_m']:.6f} m, CopyCat {line['copycat_median_m']:.6f} m, fps {line['fps']:.2f} "
        f"(the first timed call of the shape, as the JAX script times it); {north_s:.1f} s; launches "
        f"{paths['north_star']} for {len(searches)} kNN searches and {len(correlations)} correlations [{smi}]")
    if not all(np.isfinite(line[k]) for k in line):
        raise AssertionError(f"slice (c): non-finite results {line}")
    # The model's predictor on the card against the plain CPU path, on the
    # episode's first frames (TF32 off, exact kNN on both: ties alike).
    args = north_star.build_parser().parse_args(argv)
    scenes = north_star.build_scenes(args)
    scale = north_star.world_scale(args, scenes)
    dp = scenes[0]
    cut = NORTH_PLAIN_FRAMES
    request = (dp.video[:, :cut], dp.videodepth[:, :cut], dp.query_points_3d, dp.intrs[:, :cut], dp.extrs[:, :cut])
    outs, seconds = {}, {}
    for device in (SLICE_DEVICE, "cpu"):
        mdl = north_star.load_model(args, torch.device(device))
        mdl.knn_backend = "exact"
        pred = north_star.model_predictor(args, mdl, scale)
        t0 = time.perf_counter()
        with torch.no_grad(), fp32_precision(True):
            got = pred(*request)
        outs[device] = (to_host(got["traj"]), to_host(got["vis"]))
        seconds[device] = time.perf_counter() - t0
        del mdl, pred
    check_gaps({"north_star": outs[SLICE_DEVICE]}, {"north_star": outs["cpu"]},
               NORTH_PLAIN_LIMITS["release" if release else "seeded"],
               f"slice (c) north star fp32 (TF32 off, exact kNN), the first {cut} frames, card vs plain CPU "
               f"({seconds['cpu']:.1f} s on the CPU) [{smi}]")

    # (d) train_droid_ft_torch.py from those weights on (c)'s episode, which
    # is also its monitor episode (placed where the script looks for it).
    exp = root / "finetune"
    shutil.copytree(os.path.join(ep_root, "processed", f"episode_{NORTH_EPISODE['seed']:03d}"),
                    exp / "monitor_episodes" / "processed" / "episode_500")
    losses = []
    get_step = Trainer._get_step_fn

    def loss_recording(self, iters):
        fn = get_step(self, iters)

        def step(state, batch):
            state, metrics = fn(state, batch)
            losses.append(float(metrics["loss"]))
            return state, metrics

        return step

    reset_counts()
    stack, searches, correlations = counted(knn_ops, corr_ops)
    out = io.StringIO()
    Trainer._get_step_fn = loss_recording
    t0 = time.perf_counter()
    try:
        with stack, contextlib.redirect_stdout(out):
            report = finetune.main(["--episodes_root", os.path.join(ep_root, "processed"), "--eval_root", ep_root,
                                    "--eval_episodes", "1", "--steps", str(FT_STEPS), "--workers", "1",
                                    "--eval_every", "0", "--save_every", str(FT_STEPS), "--warm_start", weights,
                                    "--exp_dir", str(exp), "--device", SLICE_DEVICE])
    finally:
        Trainer._get_step_fn = get_step
    ft_s = time.perf_counter() - t0
    paths["droid_finetune"] = {k: read_counts().get(k, 0) for k in ("knn", "corr", "corr_bwd")}
    every_search_launched("slice (d) fine-tune", paths["droid_finetune"], searches, correlations)
    evals = (exp / "eval_log.jsonl").read_text().splitlines()
    ours = report["ours"]
    log(f"slice (d) scripts/train_droid_ft_torch.py --steps {FT_STEPS} (medium fp32, warm start from (c)'s "
        f"weights, (c)'s episode to train on and to monitor): losses {[round(x, 5) for x in losses]}, {ft_s:.1f} s "
        f"with the warm start and {len(evals)} evaluation (ATE {ours.get('ate_visible', float('nan')):.2f}, AJ "
        f"{ours.get('average_jaccard', float('nan')):.2f}; CopyCat ATE "
        f"{report['copycat'].get('ate_visible', float('nan')):.2f}); launches {paths['droid_finetune']} for "
        f"{len(searches)} kNN searches and {len(correlations)} correlations [{smi}]")
    if not (len(losses) == FT_STEPS and all(np.isfinite(losses)) and report["steps"] == FT_STEPS and len(evals) == 1
            and paths["droid_finetune"]["corr_bwd"] > 0 and (exp / "checkpoints" / f"step_{FT_STEPS}.pt").exists()):
        raise AssertionError(f"slice (d): losses {losses}, evaluations {len(evals)}, launches "
                             f"{paths['droid_finetune']}")
    torch.cuda.empty_cache()
    tmp.cleanup()
    episode_tmp.cleanup()
    return paths


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--release", default=None,
                        help="release checkpoint (flax msgpack) for phases 9 and 10, held against the golden outputs, "
                             "and the weights of phase 16's north star")
    parser.add_argument("--phases", default=None,
                        help="comma-separated phases to run (of 2 to 16; 8 runs with 7) for a quicker check of one "
                             "part; such a run prints no kernels line and no result line")
    cli = parser.parse_args()
    only = None if cli.phases is None else {int(x) for x in cli.phases.split(",")}

    def wanted(phase):
        return only is None or phase in only

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from mvtracker_torch.convert import random_state_dict
    from mvtracker_torch.droid import ffv1
    from mvtracker_torch.models.mvtracker import MVTracker
    from mvtracker_torch.ops import _cuda
    from mvtracker_torch.ops import corr as corr_ops
    from mvtracker_torch.ops import knn as knn_ops
    from mvtracker_torch.scene import make_scene

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _cuda.build_all()
    log(f"built kernels {list(_cuda.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ffv1.load()  # host code (g++): phase 15's depth-video codec
    log(f"built the FFV1 codec {ffv1.native.library_path(ffv1.SOURCE).relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")
    droid_job = start_droid_episode() if wanted(15) else None
    north_job = start_droid_episode(NORTH_EPISODE) if wanted(16) else None
    script_t0 = time.perf_counter()

    def took(phase, t_start, what):
        log(f"phase {phase} ({what}) took {time.perf_counter() - t_start:.1f} s [{smi}]")

    gen = torch.Generator(device="cuda").manual_seed(0)
    if wanted(2):
        t0 = time.perf_counter()
        stats = phase_kernels(torch, knn_ops, corr_ops, gen)
        phase_kernels_evaluation(torch, knn_ops, corr_ops, gen, stats)
        phase_kernels_options(torch, knn_ops, corr_ops, gen, stats)
        took(2, t0, "kernels against their plain versions")
    if wanted(3):
        t0 = time.perf_counter()
        serving = phase_main_path(torch, MVTracker, random_state_dict, make_scene, knn_ops, corr_ops)
        took(3, t0, "serving")
    if wanted(4):
        t0 = time.perf_counter()
        phase_end_to_end(torch, MVTracker, random_state_dict, make_scene, knn_ops)
        took(4, t0, "fp32 forward against the plain CPU path")
    if wanted(5):
        t0 = time.perf_counter()
        training = phase_train_path(torch, smi, MVTracker, random_state_dict, make_scene, knn_ops, corr_ops)
        took(5, t0, "training")
    if wanted(6):
        t0 = time.perf_counter()
        phase_train_end_to_end(torch, MVTracker, random_state_dict, make_scene, corr_ops)
        took(6, t0, "fp32 train step against the plain CPU path")
    if wanted(7) or wanted(8):
        t0 = time.perf_counter()
        large, cloud = phase_large_cloud(torch, smi, MVTracker, random_state_dict, make_scene, knn_ops, corr_ops)
        direct = phase_direct_knn(torch, smi, knn_ops, cloud)
        took("7 and 8", t0, "large cloud, direct kNN")
    if wanted(9):
        t0 = time.perf_counter()
        evaluation = phase_evaluation(torch, smi, knn_ops, corr_ops, cli.release)
        took(9, t0, "evaluation")
    if wanted(10):
        t0 = time.perf_counter()
        options = phase_options(torch, smi, knn_ops, corr_ops, cli.release)
        log(f"phase 10 (options, warm start, config CLIs) took {time.perf_counter() - t0:.1f} s [{smi}]")
    if wanted(11):
        t0 = time.perf_counter()
        data_path = phase_data_path(torch, smi, knn_ops, corr_ops)
        log(f"phase 11 (native data path, augmented training, crash replay, real dataset formats) took "
            f"{time.perf_counter() - t0:.1f} s [{smi}]")
    if wanted(12):
        t0 = time.perf_counter()
        families = phase_other_families(torch, smi, knn_ops, corr_ops)
        log(f"phase 12 (triplane SpaTracker, learned 2D tracker, monocular zoo) took {time.perf_counter() - t0:.1f} s "
            f"[{smi}]")
        # These paths have no kNN and no neighbour correlation.
        for path, counts in families.items():
            if any(counts.values()):
                raise AssertionError(f"the {path} path launched {counts}; it has no kNN or correlation stage")
    if wanted(13):
        t0 = time.perf_counter()
        last, last_free, check_render = phase_last_models(torch, smi, knn_ops, corr_ops)
        log(f"phase 13 (VGGT-1B, generic scene to tracker, Dynamic 3DGS, Shape of Motion) took "
            f"{time.perf_counter() - t0:.1f} s [{smi}]")
        for path, counts in last_free.items():
            if any(counts.values()):
                raise AssertionError(f"the {path} path launched {counts}; it has no kNN or correlation stage")
        for path, counts in last.items():
            idle = [key for key, count in counts.items() if count == 0]
            if idle:
                raise AssertionError(f"the {path} path launched no {idle} kernel")
    if wanted(14):
        t0 = time.perf_counter()
        parallel = phase_parallel(torch, smi, knn_ops, corr_ops)
        log(f"phase 14 (data parallelism, the sharded kNN, ICP and bundle adjustment) took "
            f"{time.perf_counter() - t0:.1f} s [{smi}]")
        for path, counts in parallel.items():
            idle = [key for key, count in counts.items() if count == 0]
            if idle:
                raise AssertionError(f"the {path} path launched no {idle} kernel")
    if wanted(15):
        t0 = time.perf_counter()
        droid = phase_droid(torch, smi, droid_job)
        took(15, t0, "the DROID factory: codecs, episode, refine, track, reproject, cli.train")
    if wanted(16):
        t0 = time.perf_counter()
        slice_paths = phase_slice(torch, smi, north_job, cli.release)
        took(16, t0, "convert and export round trips, the demo, the DROID north star and its fine-tuning")
    if wanted(13):
        check_render()  # phase 13's render against its CPU reference, computed beside phases 14 to 16
    log(f"phases 2 to 16 took {time.perf_counter() - script_t0:.1f} s [{smi}]")
    if only is not None:
        log(f"partial run of phases {sorted(only)} passed; no kernels line and no result line")
        return 0

    # Each path was driven with the counts at 0 just before it; every kernel
    # of a path must have been launched in that path's run.
    paths = {"serving": serving, "training": training, "large_cloud": large, "direct_knn": direct,
             "evaluation": evaluation, **options, **data_path, **last, **parallel, **droid, **slice_paths}
    for path, counts in paths.items():
        idle = [key for key, count in counts.items() if count == 0]
        if idle:
            raise AssertionError(f"the {path} path launched no {idle} kernel")
    for key in ("knn", "corr", "corr_bwd", "knn_tiled", "knn_exact"):
        if not any(counts.get(key, 0) for counts in paths.values()):
            raise AssertionError(f"no path launched the {key} kernel")

    meta = {
        "knn": ("knn", "mvtracker_torch/csrc/knn.cu", "mvtracker_tpu/ops/knn.py:483"),
        "corr": ("corr_select", "mvtracker_torch/csrc/corr.cu", "mvtracker_tpu/ops/corr_pallas.py:66"),
        "corr_bwd": ("corr_select_backward", "mvtracker_torch/csrc/corr_bwd.cu", "mvtracker_tpu/ops/corr_pallas.py:133"),
        "knn_tiled": ("knn_tiled", "mvtracker_torch/csrc/knn_tiled.cu", "mvtracker_tpu/ops/knn.py:345"),
        "knn_exact": ("knn_exact", "mvtracker_torch/csrc/knn_exact.cu", "mvtracker_tpu/ops/knn.py:207"),
    }
    kernels = []
    for key, (name, source, replaces) in meta.items():
        st = stats[key]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(counts.get(key, 0) for counts in paths.values()),
            "launches_by_path": {**{path: counts[key] for path, counts in paths.items() if key in counts},
                                 **{path: counts[key] for path, counts in {**families, **last_free}.items()}},
            "max_abs_err": st["err"],
            "ms": st["ms"],
            "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"],
            "bound_by": max(st["by"], key=st["by"].get),
            "library_ms": None,
        })
    log("ms, plain_ms, bound_ms: sums over the path shapes of one flagship forward (knn, corr_select), of one "
        "train step's backward (corr_select_backward), of one large-cloud request (knn_tiled) or of one direct call "
        f"(knn_exact); launches: the 3 requests of the serving path, the {TRAIN_STEPS} steps of the training path, "
        f"the {LARGE_REQUESTS} requests of the large-cloud path, the 3 calls of the direct path, the 16 requests "
        "of the release protocol (evaluation), the paths of phase 10 (options_*, config_*, serving_cli), of phase "
        "11 (augmented_train, crash_replay, kubric_cli_train, realworld_cli_eval), of phase 12 (spatracker_*, "
        "cotracker2d_*, zoo_cli_eval_*, ncc_direct: no kNN or correlation stage, 0 by construction and checked) and "
        "of phase 13 (generic_scene_serving: 3 requests; dynamic3dgs_fit, shape_of_motion_fit: one fit each; vggt: "
        "5 requests, no kNN or correlation stage, 0 and checked) and of phase 14, summed over the ranks "
        "(parallel_knn: the schedules' timed calls; parallel_knn_mesh: 2 requests on 2 ranks; parallel_train: the "
        "bf16 steps on 2 and 4 ranks; parallel_cli_train: 3 steps in a world of 1; parallel_icp: one ICP call and "
        "one z-offset search) and of phase 15 (droid_refine: one cli.droid refine; droid_track: the gripper and "
        "the mask-guided depth requests of cli.droid track; droid_train: 3 cli.train steps on the episode) and of "
        "phase 16 (demo: one cli.demo request in 2 chained segments; north_star: the 2 model requests of "
        "eval_droid_track_error_torch.py on one episode; droid_finetune: 3 train_droid_ft_torch.py steps and its "
        "one evaluation)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
