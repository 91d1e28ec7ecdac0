"""GPU smoke run of the PyTorch port (macarons_tpu_torch) on one NVIDIA card.

Usage: python3 chip_smoke.py
       python3 chip_smoke.py --depth-holds N   (only the depth hold, N times)
       python3 chip_smoke.py --demos           (only phase_demos)
       python3 chip_smoke.py --group-times     (only scene groups 1, 2, 4
                                                with the disk memory and 1,
                                                2 with the device memory
                                                timed, phase_group_times)

Phases, each of which fails the run (non-zero exit) if it fails:
  1. build the CUDA kernels from macarons_tpu_torch/csrc (one nvcc per
     source, all started together) and the replay memory's file loader
     (g++);
  2. hold each kernel against its plain PyTorch twin on the card, at edge
     cases (B3's forward also at shapes that stress its launch plan:
     (3, 52, 2048), (1, 53, 1001), (24, 1, 2048), and (2, 5, 333) with
     poles and pads); B3's backward kernel (the SCONE step's gradient of the SH
     coefficients) against its plain version at the SCONE step's shapes, at
     odd sizes, 5 cameras, the poles and the pads, and its basis against
     the forward kernel's, bit for bit;
  2b. demos: the port's last modules through their entry points on
     synth_00 subdivided to 59,392 faces at the default test config's
     widths (phase_demos): the macarons demo's run part (3 NBV steps,
     ManyDepth), its PLY and camera curves read back; the tester with
     export_results; a DemoSession stepped, reset and stepped under
     profile_trace (the trace names sh_visibility_kernel); the scone
     demo's run part on a suite mesh in ShapeNet's layout; the
     shared-sample agreement tool with --trials 5 --bench; each part's
     launches counted;
  3. drive the nbv scene-exploration trajectory at the default test config's
     widths on the generated synthetic scene synth_00 (232 faces: scan
     capture), with random SCONE weights from a seed, and check its outputs;
  4. score the trajectory's last candidates again on the card and on the CPU
     (the plain twins) with the same Monte-Carlo sample: the gains agree;
  5. suite_eval: the synthetic-suite evaluation as users run it
     (run_suite_eval under eval_params: perfect depth, the carving field)
     on 2 scenes x 2 starts x 10 poses for nbv (the committed SconeVis
     weights), random and carving; B3 launched, the summaries finite, the
     random walk's first trajectory on RESULTS_synthetic.json's poses; the
     reduced rows and the time per pose printed;
  6. scene-scale capture: the same trajectory on synth_00 subdivided 4 times
     (59,392 faces: tiled capture, one fused launch of the tile raster
     kernel per capture for TPU kernels B1 and B2), run twice from one
     generator state: the same poses, coverages and gains, bit for bit, and
     the sampling CDF's scan repeats; then one move's frames rasterized on
     the card and on the CPU (the plain versions): the same face ids; the
     tiled path's time, first call and warm;
  7. depth: the default test config as users run it, on the 59,392-face
     scene: ManyDepth depth at 256x456 with 96 planes and the predicted
     SconeOcc field, random weights for the three networks from a seed, 5
     nbv poses; every disparity in (0, 1), every depth finite and in
     [znear, zfar]; then ManyDepth on the card and on the CPU, same weights,
     on the last decision batch (B 1) and the last supervision batch (B 4):
     the disparities and the depth step's masks agree; ManyDepth's forward
     time at B 1 and B 4;
  8. train: run_training with the default training config on the
     59,392-face scene and its default replay memory, the DeviceMemory
     (frames, depths, snapshots and the episode on the card; the decision
     scores all 30 neighbour moves), epoch 0 (4 poses, a remap at pose 2),
     then a resumed run through epoch 1, its memory hydrated from the
     files epoch 0 flushed, with depth and SCONE replay, validating on the
     scene after each epoch (2 poses, the coverage_validated_ checkpoint);
     per-pose phase times, the checks of phase_train (the flushed files
     equal to the stores; each flush's host peak; depth replay's reads
     through the native loader and through np.load); one depth step (B 1:
     the card's float64 gradient against the CPU's, its float32 one against
     the step's float32 noise from one-ulp replicas, TF32 off) and one
     SCONE step on the card against the CPU's float64 and float32 runs,
     both taking the card's kNN and max-pool picks, every pick where the
     card differs from float64 a near-tie (TIE_REL; the flips excused and
     their gaps printed), the SCONE step's inputs saved under
     chiprun_out/; the depth step at B 4 and the SCONE step
     timed alone; then depth_pretrain: the depth pretrainer over the train
     phase's frames at 256x456 with 96 planes, batch 4 (an epoch, a resumed
     second, an epoch with learn_pose), each checkpoint reloaded two ways,
     the learn_pose step held like the depth step, bfloat16 convolutions
     and the batched stem against float32, step times; then syncs: one
     device-memory pose's episode, ring, store and depth-store calls under
     torch.cuda's sync debug mode "error", one pose's online step with
     each memory under "warn" (the synchronising calls and their sites),
     the DeviceMemory's bytes at the default config; then train group:
     run_training at n_parallel_scenes 2 with the disk memory (the native
     loader, queued writes) on synth_00 and synth_01, each
     subdivided to 59,392 faces, as the train phase (4 group poses, a
     resumed epoch with depth replay at twice the samples and SCONE
     replay scene by scene): one depth step over both scenes' windows and
     one SCONE step on the mean of their losses per group pose, the checks
     of phase_train_group, one group SCONE step held card against CPU (as
     the train phase's),
     times per scene-pose, the replay split and the peak memory;
  9. time each kernel at the shapes of the scene-scale path (B3 at the
     scorer's first pose, at the suite scorer's most frequent
     (C_pad, 1, 512), at the device decision's (30, 1, 2048) and at the
     SCONE step's (4, 1, 2048), its backward
     at the SCONE step's two shapes beside the launch floor), and hold it
     against its twin there; time the two-pass composition (B1, B2, merge) against
     the fused launch, in turns;
 10. scene_data: the scene-data CLI on the 59,392-face scene and the
     occupied poses of a 12,288-face cube, held against the CPU's tiled
     plain path (poses and flags), rasterize_tiled with a face mask twice
     per position and no culled face winning a pixel; time per position,
     device and host;
 11. scone_pretrain: a ShapeNet-format root of 8 synthetic meshes (two
     above 4096 faces) and its GT at ShapeNetGTConfig's widths (52 FoV and
     6 orthographic cameras at 512x512: the tiled path), the occupancy and
     coverage-gain pretrainers at their configs' widths (2 epochs of 2
     batches, then a resumed third), the ShapeNet tester on the test split,
     the MACARONS checkpoint assembled from the two and loaded by the
     trainer; the GT held card against CPU at 128x128, one occ and one vis
     step held card against CPU; B1 + B2 at the GT captures' shapes, B3
     and its backward at (3, 52, 2048) and B3 at the ShapeNet tester's
     (1, 52, 2048), held against their plain versions and timed;
 12. print the kernel table (JSON), the card's name and power limit, and the
     result line {"ok": true, "device": {...}}.
Each trajectory prints its pose sequence and coverages. A saved SCONE step
replays on the card and the CPU with
    python3 -c "import chip_smoke as cs; cs.replay_scone_step(
        cs.load_scone_step('chiprun_out/scone_step.pt.gz'))"
Each trajectory (the train phase: both runs together; scone_pretrain: GT,
both pretrainers and the tester together; scene_data: the CLI's run, then
the cube's) runs with every kernel's launch count set to 0 just before it
and read just after; B3's forward also counts its launches by shape, and
each of its rows gives the launches at its own shape. Needs CUDA; never falls
back to the CPU.
"""

import contextlib
import copy
import dataclasses
import functools
import gc
import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from macarons_tpu_torch.config import (
    Params,
    load_params,
    normalize_test_config,
)
from macarons_tpu_torch.data import datasets, generate_scene_data, \
    generate_shapenet_data, shapenet
from macarons_tpu_torch.data.mesh_io import Mesh, load_obj, save_obj
from macarons_tpu_torch.data.scenes import SceneDataset, SceneSettings, \
    compute_occupied_poses, compute_scene_settings, pose_camera
from macarons_tpu_torch.data.synthetic_suite import SUITE_VIS_INIT, \
    build_scene_mesh, generate_suite, run_suite_eval, suite_training_params
from macarons_tpu_torch.models import scone as scone_model
from macarons_tpu_torch.models.attention import PCTransformer, init_weights
from macarons_tpu_torch.models.macarons import (
    MacaronsModel,
    create_macarons_model,
    create_many_depth,
    create_optimizers,
    init_macarons_weights,
    load_macarons,
)
from macarons_tpu_torch.ops import rasterizer as rast
from macarons_tpu_torch.ops.cuda import sh_visibility as shv
from macarons_tpu_torch.ops.cuda import tile_raster as tr
from macarons_tpu_torch.ops.cuda.build import BUILD_DIR
from macarons_tpu_torch.ops.geometry import FoVCamera, look_at_view_transform
from macarons_tpu_torch.ops.knn import knn_gather
from macarons_tpu_torch.ops.projection import disparity_to_depth
from macarons_tpu_torch.ops.sampling import compute_mesh_face_area, cumsum_rows
from macarons_tpu_torch.scene.camera import (
    PoseSpace,
    episode_commit,
    episode_interpolations,
    episode_neighbors,
    episode_pose_from_idx,
    get_camera_RT,
)
from macarons_tpu_torch.scene.depth_runtime import (
    depth_loss,
    depth_masks,
    error_table,
    many_depth_inputs,
    ring_frames,
    ring_push,
    sample_augmentation,
    store_append,
)
from macarons_tpu_torch.scene import runtime as scene_runtime
from macarons_tpu_torch.scene.memory import DeviceMemory, Memory
from macarons_tpu_torch.testers import shapenet as shapenet_tester
from macarons_tpu_torch.testers.scene import compute_trajectory
from macarons_tpu_torch.trainers import pretrain_depth, pretrain_occ, \
    pretrain_vis
from macarons_tpu_torch.trainers import train_macarons as TM
from macarons_tpu_torch.trainers.train_macarons import (
    MacaronsRuntime,
    run_training,
    seeded_generator,
    setup_scene,
)
from macarons_tpu_torch.utils import generate_macarons_model, native_loader
from macarons_tpu_torch.utils.checkpoint import load_checkpoint
from macarons_tpu_torch.utils.device import make_generator, resolve_device

REPO_DIR = os.path.dirname(os.path.abspath(__file__))
# What the run keeps for later: the held SCONE step's inputs.
HELD_DIR = os.path.join(REPO_DIR, "chiprun_out")
SEED = 0
N_POSES = 5
SCENE_LEVELS = 4  # 232 * 4**4 = 59,392 faces
ATOL = 1e-4
RASTER_ATOL = 1e-5  # zbuf and barycentrics; face ids and slots identical
# The error mask thresholds a regularity table at its mean + std: a pixel
# within this relative distance of the threshold may fall on either side
# when the card's and the CPU's disparities differ in their last bits.
ERR_REL = 1e-5
TILE = 16
KERNELS = {"rasterize_pairs": tr.rasterize_pairs,
           "rasterize_tiles": tr.rasterize_tiles,
           "rasterize_tiled": tr.rasterize_tiled,
           "sh_visibility": shv.sh_visibility,
           "sh_visibility_backward": shv.sh_visibility_backward}
# The tile raster wrappers the scene-scale capture path launches: the fused
# one only (B1 and B2 alone serve binning="topk" and the per-kernel checks).
SCENE_KERNELS = ["rasterize_tiled", "sh_visibility"]
# The train phase's kernels: capture, scoring, and B3's backward in every
# SCONE step.
TRAIN_KERNELS = ["rasterize_tiled", "sh_visibility", "sh_visibility_backward"]
TRAIN_POSES = 4
TRAIN_REMAP = 2
VAL_POSES = 2
# Card against CPU for the optimizer steps: the least gradient error,
# relative to the network's largest gradient, that fails a step (see
# FP32_SLACK): where the CPU's float32 gradient is within a few ulps of the
# float64 one, the card's is held to this float32 floor instead.
STEP_REL = 1e-4
# The B3 backward kernel against its plain version, relative to max |grad|.
BACKWARD_REL = 1e-5
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def subdivide(mesh: Mesh, levels: int) -> Mesh:
    """Midpoint subdivision: each level splits every face into four at its
    edge midpoints (shared between the two faces of an edge), keeping the
    winding; vertex colours are interpolated. Face i's children are faces
    4i .. 4i + 3."""
    verts, faces, colors = mesh.verts, mesh.faces, mesh.vert_colors
    for _ in range(levels):
        F = len(faces)
        edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                                faces[:, [2, 0]]])
        uniq, inv = np.unique(np.sort(edges, axis=1), axis=0,
                              return_inverse=True)
        ab, bc, ca = len(verts) + inv.reshape(3, F)
        verts = np.concatenate([verts, (verts[uniq[:, 0]]
                                        + verts[uniq[:, 1]]) / 2])
        if colors is not None:
            colors = np.concatenate([colors, (colors[uniq[:, 0]]
                                              + colors[uniq[:, 1]]) / 2])
        a, b, c = faces.T
        faces = np.stack([np.stack(f, axis=1) for f in
                          ((a, ab, ca), (ab, b, bc), (ca, bc, c),
                           (ab, bc, ca))], axis=1).reshape(-1, 3)
    return Mesh(verts.astype(np.float32), faces.astype(np.int32),
                None if colors is None else colors.astype(np.float32))


def scene_scale_suite(root, levels):
    """The synthetic suite's synth_00 under ``root`` with its mesh
    subdivided ``levels`` times (232 faces times 4 ** levels)."""
    root = generate_suite(root, n_scenes=1)
    path = os.path.join(root, "synth_00", "mesh.obj")
    save_obj(path, subdivide(load_obj(path), levels))
    return root


def fail(msg):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def time_ms(fn, iters=50):
    """Mean device time of one call over ``iters`` calls (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_device_ms(fn, kernel_name, iters=20):
    """Device time per call of ``fn`` from torch.profiler's CUDA trace:
    the mean time of every kernel it launches (``kernel_name``, its
    epilogue, the item table's kernels), each launched once per call,
    summed. Each mean is over the launches the trace holds, which may be
    fewer than ``iters``: a trace can lose some of its device events,
    more the more the process has traced before (on the H100, 1 of 20
    launches after 100,000 traced ones, 3 of 20 after 200,000; late in a
    smoke all of a 20-launch trace, PERF.md §7). So a trace that holds no
    device time for ``kernel_name`` is taken again with 5 and then 50
    times the calls, and a third such trace fails the run. Returns (ms
    per call, {kernel: ms per call})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for n in (iters, 5 * iters, 50 * iters):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us and e.count:
                per[e.key] = us / 1e3 / e.count
        if any(kernel_name in k for k in per):
            return sum(per.values()), per
        print(f"[profiler] a trace of {n} calls holds no device time for "
              f"{kernel_name} (its device events: {sorted(per)})",
              flush=True)
    fail(f"the profiler trace holds no device time for {kernel_name}")


def device_breakdown(fn, iters=5):
    """Device time per call of ``fn``, every kernel it launches summed, from
    torch.profiler's CUDA trace over ``iters`` calls. Returns (ms per call,
    {kernel: ms per call})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us:
            per[e.key] = us / 1e3 / iters
    if not per:
        fail("the profiler trace holds no device time")
    return sum(per.values()), per


def sh_inputs(gen, B, C, L, P=4):
    dev = "cuda"
    pts = torch.randn(B, L, P, device=dev, generator=gen) * 0.5
    harm = torch.randn(B, L, 64, device=dev, generator=gen) * 0.3
    X_cam = torch.randn(B, C, 3, device=dev, generator=gen) * 2.0
    return pts, harm, X_cam


def reset_counts():
    for fn in KERNELS.values():
        fn.launches = 0
    shv.sh_visibility.launches_at.clear()


def read_counts():
    """Each kernel's launches, and B3's forward's by (B, C, L) under
    "sh_visibility_at"."""
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    counts["sh_visibility_at"] = dict(shv.sh_visibility.launches_at)
    return counts


def phase_build():
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        jobs = [pool.submit(m.build, verbose=True) for m in (shv, tr)]
        jobs.append(pool.submit(native_loader.build))
        for job in jobs:
            job.result()
    print(f"[build] sh_visibility, tile_raster and the memory's file loader "
          f"built in {time.perf_counter() - t0:.2f} s", flush=True)


def phase_kernels(gen):
    """Kernel vs plain twin at the scorer's shapes and at edge cases; then
    at the shapes that stress the forward's launch plan (cameras dealt to
    slices, point and camera counts that are multiples of no slice or block
    size), from their own generator: the trajectories after it draw as
    before."""
    cases = []
    for B, C, L in ((8, 1, 2048), (1, 52, 2048), (1, 8, 16411)):
        for sig in (True, False):
            cases.append((f"random ({B},{C},{L}) "
                          f"{'sigmoid' if sig else 'relu'}",
                          sh_inputs(gen, B, C, L), sig))
    # Points on the +-y pole of their camera (sin(theta) clamp) and
    # 1e6 pad points (the JAX kernel's padding value).
    pts, harm, X_cam = sh_inputs(gen, 2, 4, 300)
    pts[:, :100, 0] = X_cam[:, :1, 0]
    pts[:, :100, 2] = X_cam[:, :1, 2]
    pts[:, 100:150, :3] = 1e6
    for sig in (True, False):
        cases.append((f"poles and pads {'sigmoid' if sig else 'relu'}",
                      (pts, harm, X_cam), sig))
    plan_gen = make_generator(torch.device("cuda"), SEED + 6)
    for B, C, L in ((3, 52, 2048), (1, 53, 1001), (24, 1, 2048),
                    (2, 5, 333)):
        make = pole_and_pad_inputs if (B, C, L) == (2, 5, 333) else sh_inputs
        args = make(plan_gen, B, C, L)
        plan = shv.forward_plan(B, C, L)
        for sig in (True, False):
            cases.append((f"{'poles and pads ' if make is not sh_inputs else ''}"
                          f"({B},{C},{L}), {plan.slices} slices x "
                          f"{plan.points} points a block "
                          f"{'sigmoid' if sig else 'relu'}", args, sig))
    worst = 0.0
    for name, (p, h, x), sig in cases:
        out = shv.sh_visibility(p, h, x, use_sigmoid=sig)
        torch.cuda.synchronize()
        ref = shv.compute_visibilities_plain(p, h, x, use_sigmoid=sig)
        err = float((out - ref).abs().max())
        worst = max(worst, err)
        us = 1e3 * time_ms(lambda: shv.sh_visibility(p, h, x, sig), 20)
        plain_us = 1e3 * time_ms(
            lambda: shv.compute_visibilities_plain(p, h, x, sig), 5)
        print(f"[kernel] sh_visibility {name}: max |kernel - plain| "
              f"{err:.3e}; per call (CUDA events, host launch included): "
              f"kernel {us:.1f} us, plain {plain_us:.1f} us",
              flush=True)
        if not np.isfinite(err) or err > ATOL:
            fail(f"sh_visibility {name} differs from its plain twin by {err}")
    return worst


def smoke_params(root, fixture=True):
    """The default test config with its training config, on the synthetic
    scene; with ``fixture``, perfect depth and the carving occupancy field
    in place of ManyDepth and the predicted field."""
    params = normalize_test_config(load_params(os.path.join(
        REPO_DIR, "configs/test/test_in_default_scenes_config.json")),
        REPO_DIR)
    train = load_params(os.path.join(REPO_DIR, params.training_config))
    train.update(params.to_dict())
    train.update(dict(
        dataset_path=root, test_scenes=["synth_00"],
        # The synthetic suite is built at unit scale: its settings' boxes and
        # pose lattices are not multiplied by the landmark scenes' 10x.
        scene_scale_factor=1.0))
    if fixture:
        train.update(dict(use_perfect_depth=True, use_supervision_occ=True))
    return train


def phase_trajectory(gen, label, levels, needs, fixture=True):
    """Drive N_POSES nbv poses on synth_00 subdivided ``levels`` times (with
    the fixtures of ``smoke_params``, or as users run the config), with
    every launch count set to 0 just before and read just after; fail unless
    each kernel in ``needs`` launched. Returns what later phases use,
    among them the last depth batch of each size and, with ManyDepth, every
    depth step's depth and disparities."""
    dev = resolve_device("cuda")
    tag = f"[{label}]"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                     dir=_work_dir()) as tmp:
        root = scene_scale_suite(os.path.join(tmp, "scenes"), levels)
        params = smoke_params(root, fixture)
        print(f"{tag} widths: image {params.image_height}x"
              f"{params.image_width}, proxies {params.n_proxy_points}, "
              f"seq_len {params.seq_len}, k_for_knn {params.k_for_knn}, "
              f"harmonics {params.n_harmonics}, GT points "
              f"{params.n_gt_surface_points}, interpolation steps "
              f"{params.n_interpolation_steps}", flush=True)
        item = SceneDataset(root)[0]
        t0 = time.perf_counter()
        model = init_macarons_weights(create_macarons_model(params, dev), gen)
        scene = setup_scene(params, item, gen, dev)
        rt = MacaronsRuntime(params, model, scene.cfg, scene.cell_table, dev)
        torch.cuda.synchronize()
        print(f"{tag} scene setup {time.perf_counter() - t0:.2f} s, "
              f"{scene.mesh.faces.shape[0]} faces, cell table "
              f"{scene.cell_table.proxy_slots.shape}", flush=True)

        gains_log, cand_shapes, calls = [], [], []
        score = rt.coverage_gains

        def recording_gains(*args, **kw):
            cand_shapes.append(tuple(args[5].shape))
            calls.append(args)
            g = score(*args, **kw)
            gains_log.append(g.detach().cpu())
            return g

        rt.coverage_gains = recording_gains
        # With ManyDepth: the last depth batch of each size, and the range
        # of every depth and disparity, kept on the card (no sync).
        depth_log, depths, disps, hooks = {}, [], [], []
        if model.depth is not None:
            apply_depth = rt.apply_depth_inference

            def recording_depth(batch, alpha):
                out = apply_depth(batch, alpha)
                depth_log[batch["images"].shape[0]] = (batch, alpha)
                depths.append(value_range(out[0]))
                return out

            rt.apply_depth_inference = recording_depth
            hooks.append(model.depth.register_forward_hook(
                lambda module, args, out: disps.extend(
                    value_range(d) for d in out[1:])))
        events = {}

        def on_pose(i, phase):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[(i, phase)] = ev

        memory_path = os.path.join(tmp, "memory")
        memory = Memory([memory_path])
        rs = np.random.default_rng(params.get("random_seed", 42))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        traj = compute_trajectory(
            rt, scene, memory, memory_path, gen, rs, n_poses=N_POSES,
            surface_epsilon=2.0 * params.test_resolution,
            start_idx=np.asarray(item["settings"].start_positions[0]),
            policy="nbv", on_pose=on_pose)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        for hook in hooks:
            hook.remove()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

    def span(i, a, b):
        return events[(i, a)].elapsed_time(events[(i, b)])

    print(f"{tag} start: pose {traj['cam_idx'][0]}, coverage "
          f"{traj['coverage'][0]!r}", flush=True)
    for i in range(N_POSES):
        print(f"{tag} pose {i}: decision "
              f"{span(i, 'decision', 'capture'):.2f} ms (depth + mapping "
              f"{span(i, 'decision', 'field'):.2f}, occupancy field "
              f"{span(i, 'field', 'score'):.2f}, scoring "
              f"{span(i, 'score', 'capture'):.2f}), capture "
              f"{span(i, 'capture', 'done'):.2f} ms, candidates "
              f"{cand_shapes[i][0]}, next pose {traj['cam_idx'][i + 1]}, "
              f"coverage {traj['coverage'][i + 1]!r}", flush=True)
    print(f"{tag} {N_POSES} poses in {wall:.2f} s, peak device memory "
          f"{peak_gib:.2f} GiB, launches {counts}", flush=True)

    cov = np.asarray(traj["coverage"])
    if len(gains_log) != N_POSES:
        fail(f"{len(gains_log)} scorer calls for {N_POSES} poses")
    if not all(bool(torch.isfinite(g).all()) for g in gains_log):
        fail("non-finite coverage gains")
    if not (np.all(np.isfinite(cov)) and np.all(np.diff(cov) >= -1e-6)):
        fail(f"coverage not finite and non-decreasing: {cov.tolist()}")
    if len({tuple(c) for c in traj["cam_idx"]}) < 2:
        fail("the camera never moved")
    for name in needs:
        if counts[name] <= 0:
            fail(f"the {label} trajectory never launched the {name} kernel")
    return dict(counts=counts, c_pad=cand_shapes[0][0], seq_len=params.seq_len,
                rt=rt, model=model, call=calls[-1], traj=traj, scene=scene,
                params=params, depth_log=depth_log, depths=depths,
                disps=disps, peak_gib=peak_gib, gains=gains_log)


SUITE_SCENES, SUITE_STARTS, SUITE_POSES = 2, 2, 10
SUITE_POLICIES = ("nbv", "random", "carving")


def phase_suite_eval():
    """The synthetic-suite evaluation as users run it
    (``run_suite_eval`` under ``eval_params``), cut to SUITE_SCENES scenes
    x SUITE_STARTS starts x SUITE_POSES poses for each policy, nbv on the
    committed SconeVis weights, with every launch count set to 0 just
    before and read just after. Fails unless B3 launched, the summaries
    are finite and the random walk's first trajectory takes the committed
    RESULTS_synthetic.json's poses (one numpy generator serves a whole
    run, so at this depth only its first trajectory's draws line up with
    the committed 100-pose run's). Returns the launch counts."""
    tag = "[suite_eval]"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_suite_",
                                     dir=_work_dir()) as tmp:
        root = generate_suite(os.path.join(tmp, "scenes"),
                              n_scenes=SUITE_SCENES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        data = run_suite_eval(
            root, os.path.join(tmp, "results.json"), n_poses=SUITE_POSES,
            n_start_poses=SUITE_STARTS, policies=SUITE_POLICIES,
            device="cuda", vis_weights_path=SUITE_VIS_INIT, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    per_pose = data["_protocol"]["seconds_per_pose"]
    print(f"{tag} {SUITE_SCENES} scenes x {SUITE_STARTS} starts x "
          f"{SUITE_POSES} poses per policy in {wall:.2f} s, peak device "
          f"memory {peak_gib:.2f} GiB, launches {counts}", flush=True)
    for policy in SUITE_POLICIES:
        print(f"{tag} {policy}: {json.dumps(data['_all_summaries'][policy])}"
              f", {per_pose[policy] * 1e3:.2f} ms per pose", flush=True)
    print(f"{tag} lift: {json.dumps(data['_lift'])}", flush=True)
    rows = [v for row in data["_all_summaries"].values()
            for k, v in row.items() if k != "n_traj"]
    if not np.all(np.isfinite(rows)):
        fail(f"non-finite suite summaries: {data['_all_summaries']}")
    if counts["sh_visibility"] <= 0:
        fail("the suite's nbv policy never launched the sh_visibility kernel")
    with open(os.path.join(REPO_DIR, "RESULTS_synthetic.json")) as f:
        committed = json.load(f)["_baselines"]["random"]["synth_00"]["0"]
    ours = data["_baselines"]["random"]["synth_00"]["0"]["cam_idx"]
    if ours != committed["cam_idx"][:SUITE_POSES + 1]:
        fail(f"the random walk left the committed poses: {ours} against "
             f"{committed['cam_idx'][:SUITE_POSES + 1]}")
    print(f"{tag} random walk synth_00 start 0: {SUITE_POSES + 1} poses as "
          "committed", flush=True)
    return counts


def hold_raster(name, kernel, plain, args):
    """Launch a tile raster kernel and its plain twin on the same inputs:
    identical face ids or slots, zbuf and barycentrics within RASTER_ATOL.
    Returns the largest difference of the float outputs."""
    out = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    if not torch.equal(out[1], ref[1]):
        bad = int((out[1] != ref[1]).sum())
        fail(f"{name}: {bad} face ids or slots differ from the plain twin")
    err = max((float((a - b).abs().max()) if a.numel() else 0.0)
              for a, b in zip((out[0], out[2], out[3]),
                              (ref[0], ref[2], ref[3])))
    if not err <= RASTER_ATOL:
        fail(f"{name}: zbuf or barycentrics differ from the plain twin by "
             f"{err}")
    return err, float((out[1] >= 0).float().mean()) if out[1].numel() else 0


def raster_args(f9, size, K_cap, pc, face_mask=None):
    """The arguments of B1 (rasterize_pairs), B2 (rasterize_tiles) and of
    the fused rasterize_tiled for the tiled path of faces f9 (N, 9, F)
    (and a face mask, if given), as ops.rasterizer._rasterize_tiled builds
    them."""
    H, W = size
    TH, TW = rast._tiles(H, W, TILE)
    pface, starts, counts, big = rast._pairlist_pairs(f9, size, TILE,
                                                      face_mask=face_mask)
    valid, faces = rast._big_face_lists(f9, big, H, W, TILE)
    N, T = f9.shape[0], TH * TW
    # B1 and B2 alone read face rows gathered by id, camera-major.
    cam = torch.arange(pface.shape[0], device=f9.device) // (pface.shape[0]
                                                             // N)
    pfv = f9[cam, :, pface.long()].contiguous()
    fv = f9[(torch.arange(N * T, device=f9.device) // T)[:, None], :,
            faces].permute(0, 2, 1).contiguous()
    n = valid.sum(-1).int()
    b1 = (pfv, pface, starts, counts, TILE, TW, H, W, T, K_cap, pc)
    b2 = (fv, valid.float(), n, TILE, TW, H, W, T, 256, pc)
    fused = (f9, pface, starts, counts, faces.int(), valid, n, TILE, TW, H, W,
             T, K_cap, 256, pc)
    return b1, b2, fused


def item_boundary_args(f9, size, K_cap, item, pc, gen):
    """Synthetic lists around the kernel's item boundaries, over the faces
    f9 (N, 9, F) of the edge-case mesh. Row r's segment holds 0, item - 1,
    item, item + 1, 2 item + 1 or K_cap + 5 random face ids (ascending),
    except the last row, whose 3 pairs are counted 13, past the end of the
    pair array. Its 128 lanes hold as many valid ones (at most 128): first
    and all counted in every other group of six rows, else at random places
    with half of them counted, so that valid lanes past the count rounded up
    to whole 32-lane chunks (k_chunk 32) are skipped. Returns the arguments
    of rasterize_pairs, rasterize_tiles and rasterize_tiled, as raster_args
    does."""
    H, W = size
    N, _, F = f9.shape
    dev = f9.device
    TH, TW = rast._tiles(H, W, TILE)
    T, R, K = TH * TW, N * TH * TW, 128
    cycle = torch.tensor([0, item - 1, item, item + 1, 2 * item + 1,
                          K_cap + 5], device=dev)
    lens = cycle[torch.arange(R, device=dev) % len(cycle)]
    lens[-1] = 3
    order = torch.rand(R, F, device=dev, generator=gen).argsort(dim=1)
    pick = torch.arange(F, device=dev) < lens[:, None]
    ids = torch.sort(torch.where(pick, order, F), dim=1).values
    pface = ids[ids < F].int()
    starts = (torch.cumsum(lens, 0) - lens).int()
    counts = lens.int()
    counts[-1] += 10  # past the end of the pair array
    cam = (torch.arange(R, device=dev) // T).repeat_interleave(lens)
    pfv = f9[cam, :, pface.long()].contiguous()
    n_valid = lens.clamp(max=K)
    first = (torch.arange(R, device=dev) // len(cycle)) % 2 == 0
    lane = torch.arange(K, device=dev)
    place = torch.where(first[:, None], lane, torch.rand(
        R, K, device=dev, generator=gen).argsort(dim=1))
    valid = torch.zeros(R, K, dtype=torch.bool, device=dev)
    valid.scatter_(1, place, lane < n_valid[:, None])
    lane_faces = torch.sort(torch.rand(R, F, device=dev, generator=gen)
                            .argsort(dim=1)[:, :K], dim=1).values
    fv = f9[(torch.arange(R, device=dev) // T)[:, None], :,
            lane_faces].permute(0, 2, 1).contiguous()
    lane_counts = torch.where(first, n_valid, n_valid // 2).int()
    b1 = (pfv, pface, starts, counts, TILE, TW, H, W, T, K_cap, pc)
    b2 = (fv, valid.float(), lane_counts, TILE, TW, H, W, T, 32, pc)
    fused = (f9, pface, starts, counts, lane_faces.int(), valid, lane_counts,
             TILE, TW, H, W, T, K_cap, 32, pc)
    return b1, b2, fused


def edge_case_mesh(gen):
    """2400 small faces and 200 random big ones around the origin, two ground
    planes, a degenerate face, a face crossing the camera plane and coplanar
    copies of 40 faces and of a plane; two cameras, the second looking past
    most of it. On the device of the generator ``gen``."""
    dev = gen.device
    n = 2600
    centres = torch.rand(n, 1, 3, device=dev, generator=gen) * 3 - 1.5
    offsets = torch.randn(n, 3, 3, device=dev, generator=gen) * 0.08
    offsets[2400:] = torch.rand(200, 3, 3, device=dev, generator=gen) * 3
    extra = torch.tensor([[-3, -3, 0.2], [3, -3, 0.2], [0, 3, 0.2],
                          [-3, 3, -0.2], [3, 3, -0.2], [0, -3, -0.2],
                          [0, 0, 0], [1, 1, 1], [2, 2, 2],
                          [0, 0, 4.0], [1, 0, 6.0], [0, 1, 6.0]], device=dev)
    verts = torch.cat([(centres + offsets).reshape(-1, 3), extra])
    faces = torch.arange(3 * n + 12, device=dev).reshape(-1, 3)
    faces = torch.cat([faces, faces[100:140], faces[n:n + 1]])
    eye = torch.tensor([[0.5, 1.0, 5.0], [4.0, 0.5, 2.0]], device=dev)
    at = torch.tensor([[0.0, 0.0, 0.0], [6.0, 0.0, -2.0]], device=dev)
    R, T = look_at_view_transform(eye, at)
    return verts, faces, FoVCamera.create(R, T, zfar=40.0)


def phase_raster_kernels(gen):
    """The tile raster wrappers against their plain versions on the
    edge-case mesh: a padded tile column (456 and 53 are not multiples of
    16), empty tiles, K_cap overflow, more big faces per tile than lanes,
    perspective correction on and off; B1, B2 and the fused launch on the
    capture path's lists, and the tiled path with binning="topk" (B2 over
    dense lists of every face) on the card and on the CPU. Then the lists
    around the kernel's item boundaries, for several item sizes; and two
    fused launches bit for bit alike."""
    verts, faces, cam = edge_case_mesh(gen)
    f9 = rast.project_fv_batch(verts, faces, cam)
    worst = {"rasterize_pairs": 0.0, "rasterize_tiles": 0.0,
             "rasterize_tiled": 0.0}
    wrappers = (("rasterize_pairs", tr.rasterize_pairs,
                 tr.rasterize_pairs_plain),
                ("rasterize_tiles", tr.rasterize_tiles,
                 tr.rasterize_tiles_plain),
                ("rasterize_tiled", tr.rasterize_tiled,
                 tr.rasterize_tiled_plain))
    for size, K_cap, pc in (((37, 53), 1024, True), ((37, 53), 128, True),
                            ((37, 53), 128, False), ((256, 456), 1024, True),
                            ((256, 456), 128, False)):
        cases = raster_args(f9, size, K_cap, pc)
        over = int((cases[0][3] > K_cap).sum())
        for (name, kernel, plain), args in zip(wrappers, cases):
            err, cover = hold_raster(name, kernel, plain, args)
            worst[name] = max(worst[name], err)
            print(f"[kernel] {name} {size[0]}x{size[1]} K_cap {K_cap} "
                  f"perspective {pc}: ids identical, max |kernel - plain| "
                  f"{err:.3e}, covered {cover:.3f}, tiles over K_cap {over}",
                  flush=True)
        card = rast._rasterize_tiled(f9, size, TILE, K_cap, pc,
                                     binning="topk")
        cpu = rast._rasterize_tiled(f9.cpu(), size, TILE, K_cap, pc,
                                    binning="topk")
        err = max(float((a.cpu() - b).abs().max()) for a, b in
                  zip(card[1:], cpu[1:]))
        if not (torch.equal(card.pix_to_face.cpu(), cpu.pix_to_face)
                and err <= RASTER_ATOL):
            fail(f"binning topk {size} K_cap {K_cap}: the card and the CPU "
                 f"differ (max |zbuf, bary difference| {err})")
        worst["rasterize_tiles"] = max(worst["rasterize_tiles"], err)
        print(f"[kernel] tiled path binning topk {size[0]}x{size[1]} K_cap "
              f"{K_cap}: ids identical on the card and the CPU, max "
              f"|difference| {err:.3e}", flush=True)
    # The trajectories after this phase draw their weights and samples from
    # ``gen``: the synthetic lists take their own generator, so that each
    # run drives the same trajectories whatever this phase checks.
    lists_gen = make_generator(torch.device("cuda"), SEED + 1)
    for item in (1, 7, 64, 128):
        cases = item_boundary_args(f9, (37, 53), 128, item, True, lists_gen)
        for (name, kernel, plain), args in zip(wrappers, cases):
            if name == "rasterize_tiled":
                kernel = functools.partial(kernel, item=item)
            err, _ = hold_raster(name, kernel, plain, args)
            worst[name] = max(worst[name], err)
        print(f"[kernel] item boundaries, item {item}: rows of 0, {item - 1}, "
              f"{item}, {item + 1}, {2 * item + 1} and 133 pairs (K_cap 128), "
              f"stray lanes: B1, B2 and the fused launch hold", flush=True)
    args = raster_args(f9, (256, 456), 1024, True)[2]
    first, again = tr.rasterize_tiled(*args), tr.rasterize_tiled(*args)
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        fail("two launches of rasterize_tiled differ")
    print("[kernel] rasterize_tiled: two launches bit for bit alike",
          flush=True)
    return worst


def first_move(traj, scene, params):
    """The first move of trajectory ``traj`` (its n_interpolation_steps
    frames after the start) on ``scene``'s mesh, projected on the card.
    Returns (the projected faces, the image size, the cameras)."""
    steps = params.n_interpolation_steps
    X = torch.tensor(traj["X_cam"][1:1 + steps], device="cuda")
    V = torch.tensor(traj["V_cam"][1:1 + steps], device="cuda")
    cam = FoVCamera.create(*get_camera_RT(X, V), zfar=params.zfar)
    size = (params.image_height, params.image_width)
    return (rast.project_fv_batch(scene.verts_dev, scene.faces_dev, cam),
            size, cam)


def phase_scene_render(run):
    """One move of the scene-scale trajectory rasterized on the card and on
    the CPU through the tiled path (kernels vs plain twins). From the same
    projected faces the face ids must be identical. From each device's own
    projection (the matmuls round differently) a pixel may change face where
    two faces tie within ulps: on the edges shared by the subdivided mesh's
    coplanar neighbours. That share is printed and must stay below 1e-3."""
    scene, steps = run["scene"], run["params"].n_interpolation_steps
    f9, size, cam = first_move(run["traj"], scene, run["params"])
    t0 = time.perf_counter()
    card = rast._rasterize_tiled(f9, size, TILE, 1024, True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu = rast._rasterize_tiled(f9.cpu(), size, TILE, 1024, True)
    t2 = time.perf_counter()
    warm = []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rast._rasterize_tiled(f9, size, TILE, 1024, True)
        end.record()
        torch.cuda.synchronize()
        warm.append(start.elapsed_time(end))
    if not torch.equal(card.pix_to_face.cpu(), cpu.pix_to_face):
        fail("the move's face ids differ between the card and the CPU")
    err = max(float((a.cpu() - b).abs().max())
              for a, b in zip(card[1:], cpu[1:]))
    if not err <= RASTER_ATOL:
        fail(f"the move's zbuf or barycentrics differ by {err}")
    cpu_cam = FoVCamera(*(getattr(cam, f.name).cpu()
                          for f in dataclasses.fields(cam)))
    own = rast.rasterize(scene.verts_dev.cpu(), scene.faces_dev.cpu(),
                         cpu_cam, size, method="tiled")
    flipped = own.pix_to_face != cpu.pix_to_face
    flips = float(flipped.float().mean())
    both = flipped & (own.zbuf > 0) & (cpu.zbuf > 0)
    dz = float((own.zbuf - cpu.zbuf)[both].abs().max()) if both.any() else 0.0
    print(f"[scene render] move of {steps} frames at {size[0]}x{size[1]}, "
          f"{scene.faces_dev.shape[0]} faces: ids identical on card and CPU, "
          f"max |zbuf, bary difference| {err:.3e}, covered "
          f"{float((card.pix_to_face >= 0).float().mean()):.3f}; tiled path "
          f"{1e3 * (t1 - t0):.1f} ms on the card (first call, host clock), "
          f"{float(np.median(warm)):.3f} ms warm (median of 20 calls between "
          f"CUDA events, {min(warm):.3f}-{max(warm):.3f}), "
          f"{1e3 * (t2 - t1):.1f} ms on the CPU; with the CPU's own "
          f"projection {flips:.2e} of the pixels change face, their depth "
          f"by at most {dz:.2e}", flush=True)
    if flips > 1e-3:
        fail(f"{flips} of the pixels change face with the CPU's projection")
    return f9, size


def phase_determinism(run, state):
    """The scene-scale trajectory once more in this process, from the
    generator state ``state`` that ``run`` started from: the same pose
    sequence, coverages and coverage gains, bit for bit. Then the sampling
    CDF of the scene's face areas (one row of 59,392 floats) taken 200 times
    by torch.cumsum and by cumsum_rows, which the port uses: the distinct
    results of each are printed (torch.cumsum scans a single CUDA row with
    an order of additions that changes between runs, PERF.md §6), and
    cumsum_rows must give one."""
    gen = make_generator(torch.device("cuda"), SEED)
    gen.set_state(state)
    again = phase_trajectory(gen, "scene scale again", SCENE_LEVELS,
                             SCENE_KERNELS)
    a, b = run["traj"], again["traj"]
    same = {"poses": a["cam_idx"] == b["cam_idx"],
            "coverage": a["coverage"] == b["coverage"],
            "gains": len(run["gains"]) == len(again["gains"]) and all(
                torch.equal(x, y) for x, y in zip(run["gains"],
                                                  again["gains"]))}
    print(f"[determinism] two scene-scale runs bit for bit alike: {same}; "
          f"pose sequence {a['cam_idx']}; coverage {a['coverage']}",
          flush=True)
    if not all(same.values()):
        fail(f"two scene-scale runs differ: {same}; second run's poses "
             f"{b['cam_idx']}, coverage {b['coverage']}")
    scene = run["scene"]
    areas = compute_mesh_face_area(scene.verts_dev, scene.faces_dev)
    distinct = {name: len({fn(areas).cpu().numpy().tobytes()
                           for _ in range(200)})
                for name, fn in (("torch.cumsum",
                                  lambda x: torch.cumsum(x, 0)),
                                 ("cumsum_rows", cumsum_rows))}
    print(f"[determinism] the CDF of {areas.shape[0]} face areas, 200 times "
          f"on the card: distinct results {distinct}", flush=True)
    if distinct["cumsum_rows"] != 1:
        fail(f"cumsum_rows gave {distinct['cumsum_rows']} results")


def value_range(x):
    """(min, max, all finite) of ``x`` as one tensor on its device."""
    return torch.stack((x.min(), x.max(), torch.isfinite(x).all().to(x.dtype)))


def phase_depth():
    """The default test config as users run it (ManyDepth, the predicted
    occupancy field) on the scene-scale suite, with its own generator so
    that the phases after it draw what they drew before it. Every disparity
    must lie in (0, 1) and every depth be finite and in [znear, zfar]. Then
    ManyDepth runs on the card and on the CPU, same weights and inputs, on
    the last decision batch (B 1) and the last supervision batch (B 4):
    disp1..disp4 within ATOL; the depth step's depth within rtol 1e-4, the
    mask identical and the error mask identical off the pixels within
    ERR_REL of its threshold. ManyDepth's forward is timed at both sizes
    (median of 20 calls between CUDA events)."""
    gen = make_generator(torch.device("cuda"), SEED + 2)
    run = phase_trajectory(gen, "depth", SCENE_LEVELS, SCENE_KERNELS,
                           fixture=False)
    params, model, cfg = run["params"], run["model"], run["rt"].dcfg
    if model.depth is None or not run["disps"]:
        fail("the default test config did not run ManyDepth")
    print(f"[depth] ManyDepth {params.image_height}x{params.image_width}, "
          f"{params.n_depth} planes, float32; depth batches "
          f"{sorted(run['depth_log'])}, {len(run['depths'])} depth steps",
          flush=True)
    disps, depths = torch.stack(run["disps"]), torch.stack(run["depths"])
    lo, hi = float(disps[:, 0].min()), float(disps[:, 1].max())
    if not (bool(disps[:, 2].all()) and 0.0 < lo <= hi < 1.0):
        fail(f"disparities outside (0, 1): {lo} .. {hi}")
    finite = bool(depths[:, 2].all())
    zlo, zhi = float(depths[:, 0].min()), float(depths[:, 1].max())
    if not (finite and cfg.znear <= zlo <= zhi <= cfg.zfar):
        fail(f"depths not finite in [{cfg.znear}, {cfg.zfar}]: {zlo} .. {zhi}")
    print(f"[depth] disparities {lo:.4f} .. {hi:.4f}, depths {zlo:.4f} .. "
          f"{zhi:.4f}, all finite", flush=True)

    net = model.depth
    cpu_net = copy.deepcopy(net).cpu()
    for B, (batch, alpha) in sorted(run["depth_log"].items()):
        args = many_depth_inputs(cfg, batch, alpha)
        cpu_args = [a.cpu() for a in args]
        with torch.no_grad():
            card = net(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cpu = cpu_net(*cpu_args)
            cpu_s = time.perf_counter() - t0
        err = max(float((a.cpu() - b).abs().max())
                  for a, b in zip(card[1:], cpu[1:]))
        if not err <= ATOL:
            fail(f"ManyDepth at B {B}: the card and the CPU differ by {err}")
        images, mask = cpu_args[0], batch["mask"].cpu()
        mask_card, err_card = depth_masks(cfg, card[1], args[0],
                                          batch["mask"])
        mask_cpu, err_cpu = depth_masks(cfg, cpu[1], images, mask)
        table, thr = error_table(cfg, cpu[1], images, mask)
        near = torch.abs(table - thr) <= ERR_REL * torch.abs(thr)
        differ = err_card.cpu() != err_cpu
        if not torch.equal(mask_card.cpu(), mask_cpu):
            fail(f"ManyDepth at B {B}: the depth masks differ")
        if bool((differ & ~near).any()):
            fail(f"ManyDepth at B {B}: {int((differ & ~near).sum())} error "
                 "mask pixels differ away from the threshold")
        if not torch.allclose(
                disparity_to_depth(card[1], cfg.znear, cfg.zfar).cpu(),
                disparity_to_depth(cpu[1], cfg.znear, cfg.zfar), rtol=1e-4,
                atol=0):
            fail(f"ManyDepth at B {B}: depths differ beyond rtol 1e-4")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        with torch.no_grad():
            for _ in range(23):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                net(*args)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
        times = times[3:]
        peak = torch.cuda.max_memory_allocated() / 2**30
        with torch.no_grad():
            busy, per = device_breakdown(lambda: net(*args))
        top = ", ".join(f"{short(k)} {v:.3f}" for k, v in sorted(
            per.items(), key=lambda kv: -kv[1])[:6])
        print(f"[depth] ManyDepth B {B}: max |card - CPU| disparity "
              f"{err:.3e}; error mask pixels that differ {int(differ.sum())} "
              f"(within {ERR_REL} of the threshold {int(near.sum())}) of "
              f"{differ.numel()}; forward {float(np.median(times)):.3f} ms "
              f"on the card (median of 20 calls between CUDA events, "
              f"{min(times):.3f}-{max(times):.3f}), {cpu_s:.2f} s on the CPU; "
              f"peak device memory of the forward {peak:.2f} GiB; device "
              f"time {busy:.3f} ms per forward over {len(per)} kernels "
              f"(torch.profiler; ms: {top})", flush=True)
    print(f"[depth] phase peak device memory {run['peak_gib']:.2f} GiB "
          "(the trajectory)", flush=True)
    return run


class StepRecorder:
    """Counts the runtime's optimizer steps per (epoch, phase) while it is
    entered, keeps the arguments of every online depth and SCONE step (of
    a scene group's SCONE step, the last), the batch size of every depth
    step, the host seconds spent in the replay memory's reads per (epoch,
    pose, phase) (the disk Memory's file reads; the DeviceMemory's slices
    of its stores), and the DeviceMemory of the run (the last one
    flushed) with every flush's seconds and the most host bytes its queued
    writes held at once (``flushes``). ``on_phase`` is the trainer's phase hook: it also records a
    CUDA event at every phase boundary."""

    # The memories' read methods; time spent in one called from another
    # counts once.
    READS = {Memory: ("load_frame", "load_frame_sequence", "load_depth",
                      "depth_stack", "load_surface_scene",
                      "load_occupancy_field", "get_random_scene_for_scone"),
             DeviceMemory: ("load_frame_sequence", "load_depth",
                            "depth_stack", "load_surface_scene",
                            "load_occupancy_field",
                            "get_random_scene_for_scone")}

    def __init__(self):
        self.epoch, self.pose, self.phase = None, None, None
        self.steps = {}
        self.events = {}
        self.depth_calls = []
        self.depth_batches = {}
        self.scone_calls = []
        self.group_call = None
        self.reads = {}
        self.device_memory = None
        self.flushes = []

    def on_phase(self, epoch, pose_i, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events[(epoch, pose_i, name)] = ev
        self.epoch, self.pose, self.phase = epoch, pose_i, name

    def __enter__(self):
        self.saved = (MacaronsRuntime.depth_train_step,
                      MacaronsRuntime.scone_train_step,
                      MacaronsRuntime.parallel_scone_train_step,
                      {(cls, n): getattr(cls, n) for cls, names in
                       self.READS.items() for n in names},
                      DeviceMemory.flush_to_disk)
        depth_step, scone_step, group_step, reads, flush = self.saved
        depth_in_read = [0]

        def count(kind):
            key = (self.epoch, self.phase, kind)
            self.steps[key] = self.steps.get(key, 0) + 1

        def depth(rt, opt, batch, alpha, **kw):
            count("depth")
            self.depth_batches.setdefault((self.epoch, self.phase), []).append(
                int(batch["images"].shape[0]))
            if self.phase == "depth_step":
                self.depth_calls.append((rt, batch, alpha))
            return depth_step(rt, opt, batch, alpha, **kw)

        def scone(rt, *args, **kw):
            count("scone")
            if self.phase == "scone_step":
                self.scone_calls.append((rt, args, kw))
            return scone_step(rt, *args, **kw)

        def group(rt, opt, members, **kw):
            count("scone_group")
            self.group_call = (rt, members, kw)
            if len(members) == 1 and self.phase == "scone_step":
                self.scone_calls.append(lone_scone_call(rt, opt, members[0],
                                                        kw))
            return group_step(rt, opt, members, **kw)

        def timed(fn):
            @functools.wraps(fn)
            def read(*args, **kw):
                if depth_in_read[0]:
                    return fn(*args, **kw)
                depth_in_read[0] += 1
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    depth_in_read[0] -= 1
                    key = (self.epoch, self.pose, self.phase)
                    self.reads[key] = (self.reads.get(key, 0.0)
                                       + time.perf_counter() - t0)
            return read

        def flushed(dmem, *args, **kw):
            self.device_memory = dmem
            Memory.reset_queued_peak()
            t0 = time.perf_counter()
            out = flush(dmem, *args, **kw)
            self.flushes.append((time.perf_counter() - t0,
                                 Memory.queued_peak()))
            return out

        MacaronsRuntime.depth_train_step = depth
        MacaronsRuntime.scone_train_step = scone
        MacaronsRuntime.parallel_scone_train_step = group
        for (cls, name), fn in reads.items():
            setattr(cls, name, timed(fn))
        DeviceMemory.flush_to_disk = flushed
        return self

    def __exit__(self, *exc):
        (MacaronsRuntime.depth_train_step, MacaronsRuntime.scone_train_step,
         MacaronsRuntime.parallel_scone_train_step) = self.saved[:3]
        for (cls, name), fn in self.saved[3].items():
            setattr(cls, name, fn)
        DeviceMemory.flush_to_disk = self.saved[4]

    def count(self, epoch, phase, kind):
        return self.steps.get((epoch, phase, kind), 0)

    def span(self, epoch, pose_i, a, b):
        return self.events[(epoch, pose_i, a)].elapsed_time(
            self.events[(epoch, pose_i, b)])

    def read_ms(self, epoch, pose_i, phase):
        return 1e3 * self.reads.get((epoch, pose_i, phase), 0.0)

    def replay_split(self, epoch, pose_i):
        """A replaying pose's split (ms): depth replay, SCONE replay and the
        remap between CUDA events, each with the host time of its memory
        reads."""
        return {phase: (round(self.span(epoch, pose_i, phase, nxt), 2),
                        round(self.read_ms(epoch, pose_i, phase), 2))
                for phase, nxt in (("depth_replay", "scone_replay"),
                                   ("scone_replay", "remap"),
                                   ("remap", "done"))}


def lone_scone_call(rt, opt, x, kw):
    """A group of one's SCONE step (a parallel_scone_train_step call on one
    scene's SceneSupervision ``x``) as the (rt, args, kw) of the
    scone_train_step call that computes it, for hold_scone_step."""
    box_diag = float(np.linalg.norm(np.asarray(x.cfg.x_max)
                                    - np.asarray(x.cfg.x_min)))
    args = (opt, x.proxy, x.surface, x.prediction_camera, x.close_mask,
            x.visited_cams, x.visited_X, x.supervision_gains, x.field)
    return rt, args, dict(
        n_supervision=rt.params.get(
            "n_proxy_point_for_occupancy_supervision", 6000),
        box_diag=box_diag, cell_resolution=x.cfg.resolution,
        n_cells_active=kw.get("n_cells_active"), sup_occ=x.sup_occ)


def train_params(root, epochs):
    """The default training config on the scene-scale suite: full widths,
    4 poses per trajectory with a remap at pose 2, 2 rotating memory
    trajectories, no validation, random weights from its torch_seed. The
    remap saves every frame's depth: the config's every fourth would leave
    4 of the 13 frames it maps, fewer than the 7 depths that 2 SCONE replay
    loops of 4 need."""
    params = load_params(os.path.join(
        REPO_DIR, "configs/macarons/macarons_default_training_config.json"))
    params.update(dict(
        data_path=root, epochs=epochs, start_from_scratch=epochs == 1,
        n_poses_in_trajectory=TRAIN_POSES, remap_every_n_poses=TRAIN_REMAP,
        n_memory_trajectories=2, save_depth_every_n_frame=1,
        validate_every_n_epochs=0, pretrained=False,
        macarons_model_name="smoke",
        # The synthetic suite is built at unit scale (see smoke_params).
        scene_scale_factor=1.0))
    return params


def grads_of(module):
    return {n: p.grad.detach().cpu().double()
            for n, p in module.named_parameters() if p.grad is not None}


def grad_error(grads, ref):
    """max |grads - ref| over a network's gradients, relative to the
    largest reference gradient."""
    if set(grads) != set(ref) or not ref:
        fail("gradients of different parameters: "
             f"{sorted(set(grads) ^ set(ref))}")
    scale = max(float(g.abs().max()) for g in ref.values())
    if not scale > 0:
        fail("the step gave a network no gradient")
    return max(float((grads[k] - ref[k]).abs().max()) for k in ref) / scale


# The SCONE and pretraining steps are run three times from one state: on
# the card and on the CPU in float32, and on the CPU in float64 as the
# reference; the card is held to be no further from the float64 gradient
# than FP32_SLACK times the CPU's float32 is (or STEP_REL, whichever is
# larger).
FP32_SLACK = 3.0
RUNS = (("cuda", torch.float32), ("cpu", torch.float32),
        ("cpu", torch.float64))
# The depth step (B 1) is ill-conditioned in float32: BatchNorm in train
# mode over one frame (E[x^2] - E[x]^2, as Flax computes it) sends either
# device's float32 gradient 1e-4 to 0.2 of max |g| from the float64 one,
# with the state and the augmentation, so a bound on the ratio of two such
# errors fails now and then. Its hold measures instead. The card runs the
# step in float64 too, held to the CPU's float64 within DEPTH_F64_REL of
# max |g| (the largest measured on the H100 was 4.0e-10, PERF.md §6): the
# card computes the same step. DEPTH_REPLICAS CPU float32 runs, each with
# DEPTH_ULP_SHARE of the input frames' entries moved by one ulp (seeded
# positions and signs), measure the step's float32 noise: the largest
# replica error from float64. The card's float32 error is held within
# DEPTH_NOISE_MULTIPLE of it. 50, from measurement on the H100 (PERF.md
# §6): over 28 holds the card's error was 0.014 to 37 times the noise (its
# convolutions and reductions round in another order than the CPU's,
# which one-ulp nudges reach only in part); with TF32 switched on, 94 to
# 2324 times.
DEPTH_RUNS = RUNS + (("cuda", torch.float64),)
DEPTH_F64_REL = 1e-9
DEPTH_REPLICAS = 6
DEPTH_ULP_SHARE = 0.01
DEPTH_NOISE_MULTIPLE = 50.0


def in_dtype(dtype, fn):
    """fn() with ``dtype`` as the default floating type (the tensors the
    port creates inside a step take it)."""
    saved = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        return fn()
    finally:
        torch.set_default_dtype(saved)


def net_copy(net, dev, dtype):
    return None if net is None else copy.deepcopy(net).to(dev, dtype)


def fp32_faults(out, nets):
    """Per network: the card's and the CPU's float32 gradient error against
    the float64 one. Returns (the errors, the faults: one line per network
    whose card error is beyond the slack)."""
    ref, card, cpu = out[RUNS[2]], out[RUNS[0]], out[RUNS[1]]
    errs, faults = {}, []
    for name in nets:
        e_card = grad_error(card[name], ref[name])
        e_cpu = grad_error(cpu[name], ref[name])
        errs[f"{name}_grad_card"], errs[f"{name}_grad_cpu"] = e_card, e_cpu
        if not e_card <= max(STEP_REL, FP32_SLACK * e_cpu):
            faults.append(f"the {name} gradient on the card is further "
                          "from the float64 one than the CPU's float32")
    return errs, faults


def fp32_errors(out, nets):
    """``fp32_faults``' errors; fails unless the card's are within the
    slack."""
    errs, faults = fp32_faults(out, nets)
    if faults:
        fail(f"{faults[0]}: {errs}")
    return errs


def nudge_frames(frames, seed):
    """A copy of the float tensor ``frames`` with DEPTH_ULP_SHARE of its
    entries moved by one ulp up or down, positions and signs from numpy's
    default_rng(seed)."""
    rs = np.random.default_rng(seed)
    flat = frames.detach().cpu().reshape(-1).clone()
    pos = torch.as_tensor(rs.choice(flat.numel(), max(1, int(
        DEPTH_ULP_SHARE * flat.numel())), replace=False))
    sign = torch.as_tensor(rs.choice([-np.inf, np.inf], len(pos)),
                           dtype=flat.dtype)
    flat[pos] = torch.nextafter(flat[pos], sign)
    return flat.reshape(frames.shape).to(frames.device)


def hold_depth_step(params, model, batch, alpha, seed=0, draws=None):
    """One depth optimizer step from one state (the networks of ``model``,
    fresh AdamW, augmentation with fixed draws) in each of DEPTH_RUNS and
    in DEPTH_REPLICAS CPU float32 replicas on frames nudged by one ulp
    (seeds from ``seed``): in float64 the card's loss, the running
    statistics BatchNorm leaves and the gradient within DEPTH_F64_REL of
    the CPU's; in float32 its gradient's error from float64 within
    DEPTH_NOISE_MULTIPLE of the largest replica's, its loss's and
    statistics' errors within 1e-4 and 1e-5 or that multiple of the
    replicas' noise; TF32 off in every card run. ``draws`` are the
    augmentation's (default: jitter and flip at fixed factors). Returns
    the errors."""
    draws = draws or {"jitter": True, "symmetry": True,
                      "factors": (1.1, 0.9, 1.05, 0.03)}

    def step(dev, dt, b, a):
        m = MacaronsModel(*(net_copy(n, dev, dt) for n in
                            (model.occ, model.vis, model.depth)))
        opts = create_optimizers(params, m)
        rt = MacaronsRuntime(params, m, device=dev)
        loss = rt.depth_train_step(opts["depth"], _to(b, dev, dt),
                                   _to(a, dev, dt), draws=draws)[0]
        if dev == "cuda" and (torch.backends.cuda.matmul.allow_tf32
                              or torch.backends.cudnn.allow_tf32):
            fail("TF32 is on for the depth step on the card")
        return {"loss": float(loss), "depth": grads_of(m.depth),
                "stats": {k: v.cpu().double() for k, v in
                          m.depth.named_buffers() if v.is_floating_point()}}

    out = {(dev, dt): in_dtype(dt, lambda: step(dev, dt, batch, alpha))
           for dev, dt in DEPTH_RUNS}
    replicas = []
    for r in range(DEPTH_REPLICAS):
        rseed = seed * DEPTH_REPLICAS + r
        b = dict(batch, images=nudge_frames(batch["images"], 2 * rseed))
        a = dict(alpha, images=nudge_frames(alpha["images"], 2 * rseed + 1))
        replicas.append(in_dtype(torch.float32,
                                 lambda: step("cpu", torch.float32, b, a)))
    card, cpu, ref, card64 = (out[r] for r in DEPTH_RUNS)

    def rel(a, b):
        return abs(a - b) / abs(b)

    def stats_rel(run, base):
        return max(float((run["stats"][k] - v).abs().max())
                   / max(float(v.abs().max()), 1e-30)
                   for k, v in base["stats"].items())

    errs = {"loss_rel": rel(card["loss"], cpu["loss"]),
            "stats_rel": stats_rel(card, cpu),
            "loss_rel_card64": rel(card64["loss"], ref["loss"]),
            "stats_rel_card64": stats_rel(card64, ref),
            "depth_grad_card64": grad_error(card64["depth"], ref["depth"])}
    # The step's float32 noise in each measure: the replicas' largest
    # distance from float64.
    noise = {"loss": max(rel(r["loss"], ref["loss"]) for r in replicas),
             "stats": max(stats_rel(r, ref) for r in replicas),
             "grad": [grad_error(r["depth"], ref["depth"]) for r in replicas]}
    errs.update(depth_grad_card=grad_error(card["depth"], ref["depth"]),
                depth_grad_cpu=grad_error(cpu["depth"], ref["depth"]),
                depth_grad_replicas=noise["grad"],
                loss_noise=noise["loss"], stats_noise=noise["stats"])
    errs["card_over_noise"] = errs["depth_grad_card"] / max(noise["grad"])
    if not np.isfinite(card["loss"]):
        fail(f"the depth step's loss on the card is not finite: {errs}")
    if not max(errs["loss_rel_card64"], errs["stats_rel_card64"],
               errs["depth_grad_card64"]) <= DEPTH_F64_REL:
        fail(f"the depth step in float64 on the card is further than "
             f"{DEPTH_F64_REL} from the CPU's: {errs}")
    # The float32 loss and statistics: within the earlier fixed bounds
    # (1e-4, 1e-5) or, where the step's own float32 noise is larger,
    # within DEPTH_NOISE_MULTIPLE of it, as the gradient.
    if not (rel(card["loss"], ref["loss"])
            <= max(1e-4, DEPTH_NOISE_MULTIPLE * noise["loss"])
            and stats_rel(card, ref)
            <= max(1e-5, DEPTH_NOISE_MULTIPLE * noise["stats"])):
        fail(f"the depth step's float32 loss or BatchNorm statistics on the "
             f"card are further from float64 than the step's float32 noise "
             f"allows: {errs}")
    if not errs["card_over_noise"] <= DEPTH_NOISE_MULTIPLE:
        fail(f"the depth gradient on the card is further from the float64 "
             f"one than {DEPTH_NOISE_MULTIPLE} times the step's float32 "
             f"noise: {errs}")
    return errs


def phase_depth_holds(n):
    """The depth hold alone, ``n`` times from fresh draws: one training
    epoch as the train phase's first (4 poses on the 59,392-face scene)
    gives the trained networks and the online depth steps' batches; hold i
    takes batch i mod 4, its target (i // 4) mod 4, the augmentation drawn
    from seed SEED + 100 + i and nudge seeds from i. Every hold's errors
    are printed; any failure fails the run."""
    dev = resolve_device("cuda")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_holds_",
                                     dir=_work_dir()) as tmp:
        root = scene_scale_suite(os.path.join(tmp, "scenes"), SCENE_LEVELS)
        params = train_params(root, 1)
        with StepRecorder() as rec:
            model, _ = run_training(params, weights_dir=os.path.join(
                tmp, "weights"), memory_root=os.path.join(tmp, "mem"),
                device=dev, verbose=False, on_phase=rec.on_phase)
    calls = rec.depth_calls
    ratios = []
    for i in range(n):
        rt, batch, alpha = calls[i % len(calls)]
        j = (i // len(calls)) % batch["images"].shape[0]
        draws = sample_augmentation(rt.dcfg, torch.Generator().manual_seed(
            SEED + 100 + i))
        t0 = time.perf_counter()
        errs = hold_depth_step(
            params, model, {k: v[j:j + 1] for k, v in batch.items()},
            {k: v[j:j + 1] for k, v in alpha.items()}, seed=i, draws=draws)
        ratios.append(errs["card_over_noise"])
        print(f"[depth holds] hold {i + 1}/{n} (batch {i % len(calls)}, "
              f"target {j}, augmentation {draws}): {errs} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"[depth holds] {n} holds passed; card error over the float32 "
          f"noise: {ratios}", flush=True)


# The SCONE hold, conditioned on the card's discrete picks. SconeOcc takes
# discrete decisions in float arithmetic: each query's k nearest cloud
# points (kNN) and the max-pool of each point transformer's Dense
# outputs. Where two candidates lie within float32 rounding of each other,
# the card (another summation order) can pick the other one: the gradient
# then follows another point, and the card's float32 gradient strays from
# the float64 one far more than the CPU's float32 does (once one max-pool
# flip at 3.3e-8 of its column's maximum sent it to 2.2e-4 of max |g|,
# PERF.md §6).
# So the CPU runs that the card is held to take the card's own picks (kNN
# neighbours and max-pool points, forced; knn_picks, pool_picks), and each
# pick where the card differs from what the float64 run would pick itself
# must be a near-tie: its gap, read from the float64 run's values, at most
# TIE_REL. A flip beyond it is a fault, never excused.
#
# TIE_REL, from float32 rounding of the sums in front of the picks. A
# max-pool compares outputs y = sum_i w_i z_i + b of a Dense of input width
# n = 128 (SconeOcc's pts_embedding_dim, every point transformer's).
# Summed in float32 in any order, y is off by at most about n float32
# rounding units of S = sum_i |w_i z_i| + |b|, the magnitude of its terms
# (not of y: the terms cancel), so two outputs closer than n ulps (2**-23
# relative) of S can be ordered either way; with a margin of 4 for the
# rounding of the inputs z themselves, TIE_REL = 4 x 128 x 2**-23 = 6.1e-5
# of S, the larger S of the two points. A kNN pick compares squared
# distances |q|^2 + |p|^2 - 2 q.p (ops/knn.py) over 3 coordinates, whose
# float32 rounding is relative to |q|^2 + |p|^2, for the same reason; the
# same TIE_REL bounds it, looser than its 3 terms need. (Gaps relative to
# |column maximum| or to the k-th distance ignore the cancellation: at
# |column maximum| the first check on the card found sound flips at
# 7.1e-4, PERF.md §6.) Checked on the card by `python3 scone_holds.py N`:
# the gaps of the card's flips over sound states, and two planted faults
# (a pick moved to its column's smallest value, B3's backward scaled by
# 1 + 1e-3), both of which must fail the hold.
TIE_REL = 4 * 128 * 2.0 ** -23


def near_ties(gaps, tie_rel=TIE_REL):
    """``gaps``: per kind of pick ("knn", "pool"), the relative gaps of the
    card's flips (a tensor or sequence). Returns, per kind, the sorted gaps
    above ``tie_rel``: empty lists when every flip is a near-tie."""
    return {kind: sorted(float(v) for v in torch.as_tensor(g).reshape(-1)
                         if not v <= tie_rel)
            for kind, g in gaps.items()}


def gap_summary(gaps):
    """Per kind of pick: the number of flips and the largest gap."""
    return {kind: (int(torch.as_tensor(g).numel()),
                   float(torch.as_tensor(g).max()) if len(g) else 0.0)
            for kind, g in gaps.items()}


def print_excused(tag, errs):
    """The line that shows every excuse: how many flips the hold excused,
    by kind, and the largest gap of each."""
    flips = errs["flips"]
    print(f"[{tag}] SCONE hold: {sum(n for n, _ in flips.values())} card "
          "picks differ from float64's, excused as near-ties (TIE_REL "
          f"{TIE_REL:.3e}): " + ", ".join(
              f"{k} {n} (largest gap {g:.3e})" for k, (n, g) in flips.items()),
          flush=True)


def scone_state(params, model, rt, args, kw, gen, n_cells_active=5):
    """A recorded scone_train_step call (``args``/``kw``) as a state that
    scone_stepper runs: the cell-ranking noise and the Monte-Carlo sample
    (points drawn among the occupied ones) drawn once from ``gen``, on the
    CPU with the config, the cell tables and both networks' weights."""
    args = args[1:]  # the recorded optimizer is the trainer's
    # The ranking's first n_cells_active cells are the first ones of any
    # longer ranking by the same noise: rank only those.
    params = Params(dict(params.to_dict(), occ_curriculum_max_cells=min(
        n_cells_active, rt.occ_curriculum_max_cells)))
    field = args[7]
    X_world, _, occ, valid = field
    pool = torch.nonzero((occ[:, 0] > rt.coverage_gain.min_occ) & valid)[:, 0]
    n_cams = args[4].R.shape[0]
    kw = dict(kw, n_cells_active=n_cells_active, gen=None,
              cell_noise=torch.rand(rt._tables.slots.shape[0],
                                    device=gen.device, generator=gen),
              sample_idx=pool[torch.randint(
                  len(pool), (n_cams, rt.coverage_gain.seq_len),
                  device=gen.device, generator=gen)])
    return {"params": params.to_dict(), "args": _to(args, "cpu"),
            "kw": _to(kw, "cpu"), "tables": _to(rt._tables, "cpu"),
            "occ": _to(model.occ.state_dict(), "cpu"),
            "vis": _to(model.vis.state_dict(), "cpu")}


def hold_scone_step(params, model, rt, args, kw, gen, n_cells_active=5):
    """One SCONE optimizer step from one state (``scone_state``: the
    recorded call, its draws drawn once) on the card, then on the CPU in
    float64 and float32, both taking the card's kNN and max-pool picks
    (``hold_scone_runs``). The state is saved (save_scone_step). The
    card's losses within rtol 1e-3 of the CPU's (SconeOcc's kNN and both
    networks' attention reduce in another order), every flip a near-tie,
    its gradients of SconeOcc and SconeVis as close to the float64 ones as
    fp32_errors asks (``scone_verdict``), and one launch of the B3 backward
    kernel. Returns the errors."""
    state = scone_state(params, model, rt, args, kw, gen, n_cells_active)
    card, cpu, ref = hold_scone_runs(scone_stepper(state))
    save_scone_step(os.path.join(HELD_DIR, "scone_step.pt.gz"), state, card)
    errs, faults = scone_verdict(card, cpu, ref)
    if faults:
        fail(f"the SCONE step on the card: {'; '.join(faults)}: {errs}")
    print_excused("train", errs)
    return errs


def scone_verdict(card, cpu, ref):
    """The SCONE hold's verdict on three runs of one step: ``card``
    (float32 on the card), ``cpu`` and ``ref`` (float32 and float64 on the
    CPU, both forced to the card's picks; ``ref["gaps"]`` the gaps of the
    card's flips, as knn_picks and pool_picks record them). The card's
    losses within rtol 1e-3 of the CPU's, finite, and positive on the CPU;
    every flip a near-tie; its gradients held to ``ref`` by fp32_faults'
    rule against ``cpu``. Returns (errors, faults)."""
    c, p = card["losses"], cpu["losses"]
    errs = {"occ_loss": p[0], "cov_loss": p[1],
            "loss_rel": max(abs(a - b) / max(abs(b), 1e-30)
                            for a, b in zip(c, p))}
    faults = []
    if not (all(np.isfinite(c)) and p[0] > 0 and p[1] > 0
            and errs["loss_rel"] <= 1e-3):
        faults.append("its losses differ from the CPU's")
    over = near_ties(ref["gaps"])
    if any(over.values()):
        faults.append("card picks that are not near-ties (gap above "
                      f"TIE_REL {TIE_REL:.2e}): " + ", ".join(
                          f"{k} {len(v)} up to {v[-1]:.3e}"
                          for k, v in over.items() if v))
    grad_errs, grad_faults = fp32_faults(
        {RUNS[0]: card, RUNS[1]: cpu, RUNS[2]: ref}, ("occ", "vis"))
    errs.update(grad_errs, flips=gap_summary(ref["gaps"]))
    return errs, faults + grad_faults


def hold_scone_runs(step, tag="train"):
    """The hold's runs of ``step`` (scone_stepper's): the card in float32,
    the CPU in float64 and float32 forced to the card's picks, and the card
    again; prints what sets the card's error (the rerun tells rounding
    that changes from run to run from arithmetic the card repeats; the
    parameters the largest errors sit in name their layers). Returns
    (card, cpu, ref)."""
    card = in_dtype(torch.float32, lambda: step(*RUNS[0]))
    ref = in_dtype(torch.float64, lambda: step(*RUNS[2], card["picks"],
                                                card["maxima"]))
    cpu = in_dtype(torch.float32, lambda: step(*RUNS[1], card["picks"],
                                                card["maxima"]))
    again = in_dtype(torch.float32, lambda: step(*RUNS[0]))
    diag = {"occ_card_rerun": grad_error(again["occ"], card["occ"]),
            "vis_card_rerun": grad_error(again["vis"], card["vis"]),
            "occ_worst_params_card": worst_params(card, ref),
            "occ_worst_params_cpu": worst_params(cpu, ref),
            "knn_rows": sum(p.shape[0] for p in card["picks"]),
            "maxima": sum(p.numel() for p in card["maxima"]),
            "flips_card": gap_summary(ref["gaps"]),
            "flips_cpu_from_card": gap_summary(cpu["gaps"])}
    print(f"[{tag}] SCONE step, the card's gradient error: {diag}",
          flush=True)
    return card, cpu, ref


def worst_params(run, ref):
    """The three SconeOcc parameters where ``run``'s gradient is furthest
    from ``ref``'s, relative to the largest reference gradient."""
    scale = max(float(g.abs().max()) for g in ref["occ"].values())
    err = {k: float((run["occ"][k] - g).abs().max()) / scale
           for k, g in ref["occ"].items()}
    return [(k, f"{err[k]:.2e}") for k in sorted(err, key=err.get)[-3:]]


def scone_stepper(state):
    """``step(dev, dtype, neighbours=None, pools=None, plant=None)``: the
    SCONE step of ``state`` (scone_state's, or one that load_scone_step
    read from a file) on ``dev`` in ``dtype``, taking the given kNN
    neighbours and max-pool points (such lists from another run) instead
    of its own; ``plant``, if given, is called with SconeOcc and entered
    as a context around the step before the picks are recorded (a planted
    fault: scone_holds.planted_pick).
    Returns its losses, its gradients of SconeOcc and SconeVis, its own kNN
    and max-pool picks, and the relative gaps of the picks it was forced
    to take where they differ from its own (``gaps``: "knn", "pool")."""
    params = Params(state["params"])
    nets = create_macarons_model(Params(dict(state["params"],
                                             use_perfect_depth=True)), "cpu")
    nets.occ.load_state_dict(state["occ"])
    nets.vis.load_state_dict(state["vis"])

    def step(dev, dt, neighbours=None, pools=None, plant=None):
        m = MacaronsModel(net_copy(nets.occ, dev, dt),
                          net_copy(nets.vis, dev, dt), None)
        r = MacaronsRuntime(params, m, device=dev)
        r._tables = _to(state["tables"], dev, dt)
        opts = create_optimizers(params, m)
        before = shv.sh_visibility_backward.launches
        with contextlib.ExitStack() as stack:
            if plant is not None:
                stack.enter_context(plant(m.occ))
            kp = stack.enter_context(knn_picks(neighbours))
            pp = stack.enter_context(pool_picks(m.occ, pools))
            losses = r.scone_train_step(opts["scone"],
                                        *_to(state["args"], dev, dt),
                                        **_to(state["kw"], dev, dt))
        if (dev == "cuda"
                and shv.sh_visibility_backward.launches != before + 1):
            fail("the SCONE step on the card did not launch the "
                 "sh_visibility backward kernel once")
        return {"losses": [float(v) for v in losses[1:]],
                "occ": grads_of(m.occ), "vis": grads_of(m.vis),
                **picks_of(kp, pp)}

    return step


def replay_scone_step(state):
    """The SCONE step of ``state`` (hold_scone_step's, or one that
    load_scone_step read from a file) in each of RUNS, each with its own
    picks, then held as the smoke holds it (``hold_scone_runs``,
    ``scone_verdict``). Prints what sets the card's gradient error: the
    kNN query rows and the max-pool maxima whose picks differ from the
    float64 run's, on the card and on the CPU, the card's error when it
    takes the float64 run's picks, and the hold's verdict with its faults.
    Returns the runs with their own picks."""
    step = scone_stepper(state)
    out = {(dev, dt): in_dtype(dt, lambda: step(dev, dt))
           for dev, dt in RUNS}
    card, cpu, ref = (out[r] for r in RUNS)
    moved = in_dtype(torch.float32, lambda: step(*RUNS[0], ref["picks"]))
    pooled = in_dtype(torch.float32, lambda: step(*RUNS[0], None,
                                                  ref["maxima"]))
    diag = {"occ_grad_card": grad_error(card["occ"], ref["occ"]),
            "occ_grad_cpu": grad_error(cpu["occ"], ref["occ"]),
            "knn_rows": sum(p.shape[0] for p in ref["picks"]),
            "knn_rows_differ_card": rows_differ(card["picks"], ref["picks"]),
            "knn_rows_differ_cpu": rows_differ(cpu["picks"], ref["picks"]),
            "occ_grad_card_float64_neighbours": grad_error(moved["occ"],
                                                           ref["occ"]),
            "maxima": sum(p.numel() for p in ref["maxima"]),
            "maxima_differ_card": picks_differ(card["maxima"],
                                               ref["maxima"]),
            "maxima_differ_cpu": picks_differ(cpu["maxima"], ref["maxima"]),
            "occ_grad_card_float64_maxima": grad_error(pooled["occ"],
                                                       ref["occ"])}
    print(f"[replay] SCONE step, each run with its own picks: {diag}",
          flush=True)
    errs, faults = scone_verdict(*hold_scone_runs(step, "replay"))
    print(f"[replay] the hold's verdict: {'; '.join(faults) or 'passes'}: "
          f"{errs}", flush=True)
    return out


class knn_picks:
    """SconeOcc's kNN picks while the block runs: ``picks``, a list of each
    call's neighbour indices (on the CPU), one (queries, k) array per
    scale; given ``neighbours`` (such a list from another run), each call
    takes those instead of its own, and ``gaps`` gets, for each forced
    neighbour that differs from its own at that rank, the gap between the
    two squared distances (from this run's values) relative to |q|^2 +
    |p|^2, the magnitude float32 rounds them at (TIE_REL)."""

    def __init__(self, neighbours=None):
        self.neighbours = None if neighbours is None else iter(neighbours)

    def __enter__(self):
        self.own, self.picks, self.gaps = scone_model.knn_points_many, [], []

        def knn(queries, k, big=1e10):
            out = self.own(queries, k, big)
            if self.neighbours is not None:
                forced = []
                for (x, pc, _), (near, d, idx) in zip(queries, out):
                    want = next(self.neighbours).to(pc.device).reshape(
                        idx.shape)
                    at = knn_gather(pc, want)
                    q = x[..., None, :]
                    norm = (q * q).sum(-1)
                    gap = (((at - q) ** 2).sum(-1)
                           - ((near - q) ** 2).sum(-1)).abs()
                    scale = norm + torch.maximum((at * at).sum(-1),
                                                 (near * near).sum(-1))
                    differ = want != idx
                    self.gaps.append((gap[differ] / scale[differ]).cpu())
                    forced.append((at, d, idx))
                out = forced
            self.picks += [idx.reshape(-1, k).cpu() for _, _, idx in out]
            return out

        scone_model.knn_points_many = knn
        return self

    def __exit__(self, *exc):
        scone_model.knn_points_many = self.own


class pool_picks:
    """The max-pool picks of the point transformers of ``net`` (SconeOcc)
    while the block runs: ``picks``, per call, the point each (cloud,
    feature) maximum comes from, on the CPU; given ``forced`` (such a list
    from another run), each maximum whose pick differs is moved to the
    forced point, by raising that point's feature to just above the
    maximum (a near-tie's gap), so that the gradient takes the forced
    point, and ``gaps`` gets the gap between the maximum and the forced
    point's value (this run's values) relative to the magnitude float32
    rounds the pooled Dense's outputs at there: sum_i |w_i z_i| + |b| over
    its inputs z, at either point, the larger (TIE_REL)."""

    def __init__(self, net, forced=None):
        self.mods = [m for m in net.modules()
                     if isinstance(m, PCTransformer)]
        self.forced = None if forced is None else iter(forced)

    def __enter__(self):
        self.picks, self.gaps, self.mask = [], [], None
        self.hooks = [h for m in self.mods for h in (
            m.register_forward_pre_hook(self.pre, with_kwargs=True),
            m.Dense_0.register_forward_hook(self.post))]
        return self

    def pre(self, module, args, kwargs):
        self.mask = kwargs.get("pts_mask")

    def post(self, module, args, out):
        x = out.detach()
        if self.mask is not None:
            x = x.masked_fill(~self.mask[..., None], -np.inf)
        pick = x.argmax(dim=-2, keepdim=True)
        if self.forced is not None:
            want = next(self.forced).to(x.device).reshape(pick.shape)
            peak = x.amax(dim=-2, keepdim=True)
            at = torch.gather(x, -2, want)
            differ = want != pick
            # Each differing maximum's rounding scale: sum_i |w_i z_i| +
            # |b| of the Dense's output at either point, the larger.
            b, _, f = differ.nonzero(as_tuple=True)
            z, w = args[0].detach(), module.weight.detach().abs()[f]
            scale = torch.maximum(*(
                (w * z[b, p].abs()).sum(-1) + module.bias.detach().abs()[f]
                for p in (pick[b, 0, f], want[b, 0, f])))
            self.gaps.append(((peak - at)[differ] / torch.clamp(
                scale, min=torch.finfo(x.dtype).tiny)).cpu())
            top = torch.nextafter(peak, torch.tensor(
                np.inf, dtype=x.dtype, device=x.device))
            lift = torch.where(differ, top - at, 0.0)
            out = out + torch.zeros_like(x).scatter(-2, want, lift)
            pick = want
        self.picks.append(pick.cpu())
        return out

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()


def picks_of(kp, pp):
    """A run's kNN and max-pool picks and the gaps of those it was forced
    to take (knn_picks ``kp``, pool_picks ``pp``)."""
    def cat(gaps):
        return torch.cat(gaps) if gaps else torch.zeros(0)

    return {"picks": kp.picks, "maxima": pp.picks,
            "gaps": {"knn": cat(kp.gaps), "pool": cat(pp.gaps)}}


def rows_differ(picks, ref):
    """Query rows whose neighbours differ from ``ref``'s."""
    if [p.shape for p in picks] != [p.shape for p in ref]:
        fail("two runs of one SCONE step made different kNN calls")
    return sum(int((p != q).any(1).sum()) for p, q in zip(picks, ref))


def picks_differ(picks, ref):
    """Max-pool maxima whose pick differs from ``ref``'s."""
    if [p.shape for p in picks] != [p.shape for p in ref]:
        fail("two runs of one SCONE step made different max-pools")
    return sum(int((p != q).sum()) for p, q in zip(picks, ref))


def save_scone_step(path, state, card):
    """Everything a SCONE step held by hold_scone_step starts from, on the
    CPU, gzipped: the recorded call's arguments without its optimizer
    (``args``, ``kw``: the states, the field, the cameras, the cell noise
    and the Monte-Carlo sample), the cell tables, the config, both
    networks' weights, and the card's losses and gradients, so that the
    step can be replayed (``load_scone_step``, ``replay_scone_step``) and
    held against the card's result on another machine."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = dict(state, card={
        k: v if k == "losses" else {n: g.float() for n, g in v.items()}
        for k, v in card.items() if k not in ("picks", "maxima")})
    with gzip.open(path, "wb", compresslevel=6) as f:
        torch.save(state, f)
    print(f"[train] the held SCONE step's inputs saved to "
          f"{os.path.relpath(path, REPO_DIR)} "
          f"({os.path.getsize(path) / 2**20:.1f} MiB)", flush=True)


def load_scone_step(path):
    """The state save_scone_step wrote, its tensors on the CPU."""
    with gzip.open(path, "rb") as f:
        return torch.load(f, weights_only=False)


def median_ms(fn, reps=5):
    """Median time of ``fn`` between CUDA events over ``reps`` calls after
    one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), min(times), max(times)


TRAIN_PHASES = ("decision", "capture", "depth_step", "scone_step",
                "depth_replay", "scone_replay", "remap", "done")


def phase_train(frames_to):
    """The online trainer as users run it: run_training with the default
    training config at full widths on the 59,392-face scene (random weights
    from its torch_seed), its replay memory the default DeviceMemory.
    Epoch 0: TRAIN_POSES poses, a remap at pose TRAIN_REMAP, memory
    trajectory slot 0, the memory flushed to disk at its end. Then a second
    run resumes from epoch 0's checkpoint, hydrates the memory from disk
    and trains epoch 1 in slot 1, with depth replay (n_memory_loops steps
    of n_memory_samples frames) and SCONE replay (n_memory_scene_loops
    steps) from slot 0 after every pose. Every epoch validates on the
    scene (VAL_POSES poses, frozen weights, a disk Memory). Launch counts
    are set to 0 before the first run and read after the second. Fails
    unless the losses are finite with a positive depth loss, the three
    networks moved, both B3 kernels and rasterize_tiled launched (B3 at
    the device decision's (30, 1, seq_len) once per pose), the B3 backward
    once per SCONE step, each trajectory holds 1 + n_alpha + poses x
    interpolation steps frames in the DeviceMemory and on disk, the
    remap's depths too, the flushed files equal the stores, the checkpoint
    reloads, and the coverage_validated_ checkpoint holds a validation
    coverage in [0, 1]. Then one depth step (B 1) and one SCONE step on
    the card against the CPU. The memory's two frames/ directories are
    copied under ``frames_to`` for the depth pretrainer."""
    dev = resolve_device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_",
                                     dir=_work_dir()) as tmp:
        root = scene_scale_suite(os.path.join(tmp, "scenes"), SCENE_LEVELS)
        wdir, mroot = os.path.join(tmp, "weights"), os.path.join(tmp, "mem")
        p0, p1 = train_params(root, 1), train_params(root, 2)
        for p in (p0, p1):
            p.update(dict(val_scenes=["synth_00"], validate_every_n_epochs=1,
                          n_val_poses=VAL_POSES))
        print(f"[train] default training config: image {p0.image_height}x"
              f"{p0.image_width}, ManyDepth {p0.n_depth} planes, proxies "
              f"{p0.n_proxy_points}, seq_len {p0.seq_len}, interpolation "
              f"steps {p0.n_interpolation_steps}, alphas {p0.alphas}, depth "
              f"replay {p0.n_memory_loops} x {p0.n_memory_samples}, SCONE "
              f"replay {p0.n_memory_scene_loops}, curriculum cells "
              f"{p0.occ_curriculum_min_cells}..{p0.occ_curriculum_max_cells}",
              flush=True)
        init = create_macarons_model(p0, dev)
        init_macarons_weights(init, seeded_generator(dev, p0.torch_seed))
        init = {name: {k: v.detach().cpu().clone() for k, v in
                       getattr(init, name).state_dict().items()}
                for name in ("occ", "vis", "depth")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with StepRecorder() as rec:
            _, losses0 = run_training(p0, weights_dir=wdir, memory_root=mroot,
                                      device=dev, verbose=False,
                                      on_phase=rec.on_phase)
            t1 = time.perf_counter()
            model, losses = run_training(p1, weights_dir=wdir,
                                         memory_root=mroot, device=dev,
                                         verbose=False, on_phase=rec.on_phase)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = read_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        mem = os.path.join(mroot, "synth_00", p0.memory_dir_name, "training")
        n_frames = [len(os.listdir(os.path.join(mem, str(t), "frames")))
                    for t in (0, 1)]
        n_depths = len(os.listdir(os.path.join(mem, "0", "depths")))
        dmem = rec.device_memory
        if dmem is None:
            fail("the train phase did not run the device memory")
        stores = hold_flushed(dmem, os.path.dirname(mem))
        reads = loader_times(os.path.dirname(mem), p1)
        reloaded = create_macarons_model(p1, dev)
        meta = load_macarons(os.path.join(wdir, "unvalidated_smoke"),
                             reloaded, create_optimizers(p1, reloaded))
        # A loss peak in epoch 1 rolls the returned depth network back to
        # epoch 0's checkpoint, after the resume point was saved.
        peak = losses[1]["depth"] > (losses[0]["depth"]
                                     + p1.get("loss_peak_threshold", 0.015))
        depth_ref = create_macarons_model(p1, dev)
        load_macarons(os.path.join(wdir, "epoch_0_smoke" if peak
                                   else "unvalidated_smoke"), depth_ref)
        val_path = os.path.join(wdir, "coverage_validated_smoke")
        val_meta = (load_macarons(val_path, create_macarons_model(p1, dev))
                    if os.path.exists(val_path + ".pt") else {})
        val_frames = os.path.join(mroot, "synth_00", "macarons_memory_val",
                                  "training", "0", "frames")
        n_val_frames = (len(os.listdir(val_frames))
                        if os.path.isdir(val_frames) else 0)
        frames_dirs = []
        for t in (0, 1):
            frames_dirs.append(os.path.join(frames_to, f"frames_{t}"))
            shutil.copytree(os.path.join(mem, str(t), "frames"),
                            frames_dirs[-1])

    for e in (0, 1):
        for i in range(TRAIN_POSES):
            spans = ", ".join(
                f"{a} {rec.span(e, i, a, b):.2f}" for a, b in
                zip(TRAIN_PHASES, TRAIN_PHASES[1:]))
            print(f"[train] epoch {e} pose {i} (ms): {spans}", flush=True)
    for i in range(TRAIN_POSES):
        print(f"[train] epoch 1 pose {i} replay split (ms: phase between "
              f"CUDA events, of it memory reads on the host): "
              f"{rec.replay_split(1, i)}", flush=True)
    steps = {k: v for k, v in sorted(rec.steps.items(),
                                     key=lambda kv: str(kv[0]))}
    print(f"[train] epoch 0 {t1 - t0:.2f} s, epoch 1 (resumed) {t2 - t1:.2f} "
          f"s; peak device memory {peak_gib:.2f} GiB; losses {losses}; "
          f"optimizer steps (epoch, phase, network): {steps}; frames per "
          f"trajectory {n_frames}, remap depths {n_depths}; launches "
          f"{counts}", flush=True)
    print(f"[train] DeviceMemory: {stores}; the flushed files equal the "
          f"stores; flush_to_disk per epoch (s, most host bytes its queued "
          f"writes held at once): {rec.flushes}", flush=True)
    print(f"[train] depth replay's reads of the flushed files, ms per "
          f"replay batch (median, min-max of {LOADER_REPS}, warm page "
          f"cache): {reads}", flush=True)
    if stores["frames"] != [want_frames(p0)] * 2 or stores["depths"][0] \
            != n_depths:
        fail(f"the DeviceMemory holds {stores}, not {want_frames(p0)} frames "
             f"a slot and the remap's {n_depths} depths")

    if losses[0] != losses0[0]:
        fail("the resumed run lost epoch 0's losses")
    for row in losses:
        if not (all(np.isfinite(v) for v in row.values())
                and row["depth"] > 0):
            fail(f"losses not finite with a positive depth loss: {losses}")
    for name, state in init.items():
        now = getattr(model, name).state_dict()
        if all(torch.equal(v, now[k].cpu()) for k, v in state.items()
               if v.is_floating_point()):
            fail(f"training left the {name} network as it was initialised")
    for name in TRAIN_KERNELS:
        if counts[name] <= 0:
            fail(f"the train phase never launched the {name} kernel")
    # A lone scene's online step is a group step of one scene.
    n_scone = sum(v for (_, _, kind), v in rec.steps.items()
                  if kind in ("scone", "scone_group"))
    if counts["sh_visibility_backward"] != n_scone:
        fail(f"{counts['sh_visibility_backward']} launches of the B3 "
             f"backward kernel for {n_scone} SCONE steps")
    want = want_frames(p0)
    if n_frames != [want, want]:
        fail(f"frames per trajectory {n_frames}, not {want}")
    launches_at(counts, (DECISION_CANDIDATES, 1, p0.seq_len),
                2 * TRAIN_POSES)
    if (rec.count(1, "depth_replay", "depth")
            != TRAIN_POSES * p1.n_memory_loops
            or rec.count(1, "scone_replay", "scone")
            != TRAIN_POSES * p1.n_memory_scene_loops):
        fail(f"replay did not run as configured: {steps}")
    same = [all(torch.equal(v, b.state_dict()[k])
                for k, v in a.state_dict().items())
            for a, b in ((model.occ, reloaded.occ), (model.vis, reloaded.vis),
                         (model.depth, depth_ref.depth))]
    if meta.get("epoch") != 2 or not all(same):
        fail(f"the checkpoints do not reload the trained networks (occ, vis, "
             f"depth{' rolled back at the loss peak' if peak else ''}: "
             f"{same})")
    print(f"[train] the resume point reloads (epoch {meta['epoch']}); loss "
          f"peak rollback of the depth network: {peak}", flush=True)
    val_cov = val_meta.get("val_coverage")
    if val_cov is None or not 0.0 <= val_cov <= 1.0:
        fail(f"no coverage_validated_ checkpoint with a validation coverage "
             f"in [0, 1]: {val_meta}")
    want_val = 1 + p0.n_alpha + VAL_POSES * p0.n_interpolation_steps
    if n_val_frames != want_val:
        fail(f"the validation trajectory saved {n_val_frames} frames, not "
             f"{want_val}")
    print(f"[train] validation ({VAL_POSES} poses on synth_00 each epoch, "
          f"{n_val_frames} frames in its memory): coverage_validated_smoke "
          f"written at epoch {val_meta['epoch']}, val_coverage "
          f"{val_cov:.6f}", flush=True)

    gen = make_generator(torch.device("cuda"), SEED + 3)
    # The last online depth step's own supervision batch, its first target.
    _, batch, alpha = rec.depth_calls[-1]
    t0 = time.perf_counter()
    derr = hold_depth_step(p1, model, {k: v[:1] for k, v in batch.items()},
                           {k: v[:1] for k, v in alpha.items()})
    t1 = time.perf_counter()
    # The online SCONE step with the most proxies close to the surface.
    srt, sargs, skw = max(rec.scone_calls, key=lambda c: int(c[1][4].sum()))
    serr = hold_scone_step(p1, model, srt, sargs, skw, gen)
    t2 = time.perf_counter()
    print(f"[train] depth step B 1, card against CPU: {derr} "
          f"({t1 - t0:.1f} s); SCONE step (n_cells_active 5), card against "
          f"CPU: {serr} ({t2 - t1:.1f} s)", flush=True)

    # The steps timed alone, on copies: the online depth step at B 4
    # (forward, backward, AdamW) and the online SCONE step.
    m = MacaronsModel(*(copy.deepcopy(n) for n in (model.occ, model.vis,
                                                   model.depth)))
    trt = MacaronsRuntime(p1, m, device=dev)
    trt._tables = srt._tables
    opts = create_optimizers(p1, m)
    torch.cuda.reset_peak_memory_stats()
    d_ms = median_ms(lambda: trt.depth_train_step(opts["depth"], batch,
                                                  alpha, gen=gen))
    d_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    s_ms = median_ms(lambda: trt.scone_train_step(opts["scone"], *sargs[1:],
                                                  **dict(skw, gen=gen)))
    s_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train] depth step B {batch['images'].shape[0]} (forward, "
          f"backward, AdamW) {d_ms[0]:.2f} ms ({d_ms[1]:.2f}-{d_ms[2]:.2f}, "
          f"median of 5 between CUDA events), peak {d_peak:.2f} GiB; SCONE "
          f"step {s_ms[0]:.2f} ms ({s_ms[1]:.2f}-{s_ms[2]:.2f}), peak "
          f"{s_peak:.2f} GiB", flush=True)
    return dict(counts=counts, n_cams=int(sargs[5].R.shape[0]),
                seq_len=p1.seq_len, frames_dirs=frames_dirs, model=model,
                store_bytes=stores["bytes"])


# The device decision scores every neighbour move of the lattice: one
# translation unit, at most one rotation unit.
DECISION_CANDIDATES = 30


def want_frames(params):
    """Frames a trajectory of the smoke's training runs captures."""
    return 1 + params.n_alpha + TRAIN_POSES * params.n_interpolation_steps


def hold_flushed(dmem, scene_dir):
    """The DeviceMemory's stores against the files its flush wrote under
    ``scene_dir`` (read by a disk Memory): every slot's frames, depths and
    snapshots, bit for bit. Returns the frame and depth counts per slot and
    the stores' bytes."""
    disk = Memory([scene_dir], n_trajectories=dmem.n_trajectories)
    out = {"frames": [], "depths": [], "bytes": dmem.nbytes()}
    for t in range(dmem.n_trajectories):
        n, n_d = dmem.n_frames(scene_dir, t), dmem.n_depths(scene_dir, t)
        out["frames"].append(n)
        out["depths"].append(n_d)
        if (disk.n_frames(scene_dir, t), disk.n_depths(scene_dir, t)) \
                != (n, n_d):
            fail(f"slot {t}: {n} frames and {n_d} depths in the DeviceMemory, "
                 f"{disk.n_frames(scene_dir, t)} and "
                 f"{disk.n_depths(scene_dir, t)} on disk")
        pairs = []
        if n:
            files = disk.load_frame_sequence(scene_dir, n - 1, n, t)
            store = dmem.load_frame_sequence(scene_dir, n - 1, n, t)
            pairs += [(k, store[k], files[k]) for k in store]
        for i in range(n_d):
            files = disk.load_depth(scene_dir, i, t)
            pairs += [(f"depth {i} {k}", v, files[k]) for k, v in
                      dmem.load_depth(scene_dir, i, t).items()]
        for name in ("load_surface_scene", "load_occupancy_field"):
            state = getattr(dmem, name)(scene_dir, t)[0]
            files = getattr(disk, name)(scene_dir, t)[0]
            pairs += [(f"{name} {k}", getattr(state, k), getattr(files, k))
                      for k in state._fields]
        for k, a, b in pairs:
            if not torch.equal(a.cpu(), torch.as_tensor(b)):
                fail(f"slot {t}: the flushed {k} differs from the store's")
    return out


LOADER_REPS = 7


def loader_times(scene_dir, params):
    """Depth replay's reads on the files under ``scene_dir``: the batches
    of ``sample_depth_replay`` (n_memory_samples windows of the depth
    step's context) read by the disk Memory through the native loader and
    by np.load file by file (as the memory read before the loader), in
    turns, LOADER_REPS times each. Fails unless both give the same arrays.
    Returns ms per batch, median and range, per reader."""
    disk = Memory([scene_dir], n_trajectories=2)
    dcfg = TM.depth_cfg_from_params(params)
    n_context = dcfg.n_alpha + 1 + (
        1 if dcfg.use_future_frame_for_supervision else 0)
    draws = disk.sample_depth_replay(np.random.default_rng(0),
                                     params.get("n_memory_samples", 4),
                                     n_context)

    def native():
        return [disk.load_frame_sequence(p, last, n_context, t)
                for p, t, last in draws]

    def plain():
        out = []
        for p, t, last in draws:
            files = []
            for i in range(last - n_context + 1, last + 1):
                with np.load(os.path.join(disk.frames_dir(p, t),
                                          f"{i}.npz")) as z:
                    files.append({k: z[k] for k in z.files})
            out.append({("images" if k == "rgb" else k): np.concatenate(
                [f[k] for f in files]) for k in ("rgb", "zbuf", "mask", "R",
                                                   "T")})
        return out

    for a, b in zip(native(), plain()):
        if any(not np.array_equal(a[k], b[k]) for k in b):
            fail("the native loader's frames differ from np.load's")
    ms = {"native_loader": [], "np_load": []}
    for _ in range(LOADER_REPS):
        for name, fn in (("native_loader", native), ("np_load", plain)):
            t0 = time.perf_counter()
            fn()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    return {name: (float(np.median(v)), min(v), max(v))
            for name, v in ms.items()}


class sync_mode:
    """torch.cuda's sync debug mode ("warn" or "error") inside the block.
    Under "warn", ``sites`` counts the synchronising calls by the innermost
    frame of the port's package (else the warning's own site)."""

    def __init__(self, mode):
        self.mode = mode
        self.sites = {}

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        if "synchroniz" not in str(message):
            return
        import traceback

        pkg = os.path.join(REPO_DIR, "macarons_tpu_torch")
        mine = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(pkg)]
        site = (f"{os.path.relpath(mine[-1].filename, REPO_DIR)}:"
                f"{mine[-1].lineno} ({mine[-1].name})" if mine
                else f"{filename}:{lineno}")
        self.sites[site] = self.sites.get(site, 0) + 1

    def __enter__(self):
        import warnings

        self.caught = warnings.catch_warnings()
        self.caught.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._show
        torch.cuda.set_sync_debug_mode(self.mode)
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self.caught.__exit__(*exc)

    def total(self):
        return sum(self.sites.values())


def episode_calls(rt, scene, memory, mp, gen):
    """One device-memory pose's episode, ring, store and depth-store calls
    (the capture replaced by the ring's newest frames): the candidates,
    the selection on drawn gains, the interpolated move, the ring push, the
    store's append and window, the commit, a depth appended, gathered and
    read back, the counts."""
    tables, dims, n_elev, n_azim = TM._lattice(scene)
    K = rt.n_interpolation_steps
    ep = scene.episode
    cand, new_ok, visited_ok = episode_neighbors(ep, tables, dims)
    episode_pose_from_idx(cand, tables, n_elev, n_azim)
    gains = torch.rand(cand.shape[0], device=cand.device, generator=gen)
    nxt = TM.select_move(cand, gains, new_ok, visited_ok)
    X, V = episode_interpolations(ep, nxt, tables, n_elev, n_azim, K)
    R, T = get_camera_RT(X, V)
    fr = ring_frames(scene.ring, K)
    ring_push(scene.ring, fr["images"], fr["zbuf"], fr["mask"], R, T,
              rt.dcfg.zfar)
    memory.update_store(mp, store_append(memory.store(mp), fr["images"],
                                         fr["zbuf"], fr["mask"], R, T))
    n = memory.n_frames(mp)
    win = memory.load_frame_sequence(mp, n - 1, 1 + rt.dcfg.n_alpha)
    episode_commit(ep, nxt, X, V, R, T, dims)
    memory.save_depth(mp, 0, win["zbuf"][:1], win["mask"][:1],
                      win["mask"][:1], win["R"][:1], win["T"][:1])
    memory.depth_stack(mp, None, [0, 0])
    memory.load_depth(mp, memory.n_depths(mp) - 1)
    memory.sample_depth_replay(np.random.default_rng(0), 4, 3)


SYNC_POSES = 2  # the replayed trajectory's poses, the remap at its last


def phase_syncs():
    """What synchronises the host with the card in a training pose, on the
    59,392-face scene at the default training config's widths, with the
    device memory and with the disk memory: a trajectory of SYNC_POSES
    poses in slot 0 (a remap at its last) that the next one replays, then
    a replaying pose in slot 1 (online step, depth replay, SCONE replay)
    under torch.cuda's sync debug mode "warn": the synchronising calls of
    the pose by phase (between the trainer's phase hooks) and by site,
    and of its trajectory's start. Then, on the device memory, one pose's episode,
    ring, store and depth-store calls under "error" (they must not
    raise). Also the DeviceMemory's bytes for one (scene, slot) at the
    default config's trajectory (100 poses). Returns what PERF.md
    reports."""
    dev = resolve_device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_syncs_",
                                     dir=_work_dir()) as tmp:
        root = scene_scale_suite(os.path.join(tmp, "scenes"), SCENE_LEVELS)
        params = train_params(root, 1)
        model = create_macarons_model(params, dev)
        init_macarons_weights(model, seeded_generator(dev, params.torch_seed))
        opts = create_optimizers(params, model)
        rt = MacaronsRuntime(params, model, device=dev)
        item = SceneDataset(root)[0]
        gen = seeded_generator(dev, params.torch_seed, 0)
        rs = np.random.default_rng(0)
        for mode in ("device", "disk"):
            mp = os.path.join(tmp, mode, "synth_00", "macarons_memory")
            memory = (DeviceMemory(
                [mp], n_trajectories=2, max_frames=want_frames(params),
                max_depths=want_frames(params), height=rt.H, width=rt.W,
                zfar=params.zfar, device=dev) if mode == "device"
                else Memory([mp], n_trajectories=2))
            episodes = (TM.DEVICE_EPISODES if mode == "device"
                        else TM.HOST_EPISODES)
            marks = []

            def trajectory(scene, epoch, n_poses, **kw):
                memory.current_epoch = epoch
                TM.run_trajectory(rt, scene, memory, mp, opts, gen, rs,
                                  n_poses,
                                  n_memory_loops=params.n_memory_loops,
                                  episodes=episodes, **kw)

            scenes = [setup_scene(params, item, seeded_generator(
                dev, params.torch_seed, 9), dev) for _ in range(2)]
            trajectory(scenes[0], 0, SYNC_POSES, remap_at=SYNC_POSES - 1)
            scene = scenes[1]
            torch.cuda.synchronize()
            with sync_mode("warn") as syncs:
                trajectory(scene, 1, 1, on_phase=lambda i, name: marks.append(
                    (name, syncs.total())))
                torch.cuda.synchronize()
                marks.append(("end", syncs.total()))
            phases = {a: b - n for (a, n), (_, b) in zip(marks, marks[1:])}
            pose = marks[-1][1] - marks[0][1]
            out[mode] = {"pose": pose, "start": marks[0][1],
                         "phases": phases}
            sites = dict(sorted(syncs.sites.items(), key=lambda kv: -kv[1]))
            print(f"[syncs] {mode} memory, a replaying pose's synchronising "
                  f"calls under sync debug mode warn: {pose} (by phase "
                  f"{phases}); its trajectory's start {marks[0][1]}; all "
                  f"{syncs.total()} by site {sites}", flush=True)
            if mode == "device":
                try:
                    with sync_mode("error"):
                        episode_calls(rt, scene, memory, mp, gen)
                except RuntimeError as err:
                    fail(f"the device memory's episode, ring and store calls "
                         f"synchronise with the card: {err}")
                print("[syncs] the device memory's episode, ring, store and "
                      "depth-store calls of a pose ran under sync debug mode "
                      "error", flush=True)
            else:
                memory.flush()
        traj = 1 + params.n_alpha + 100 * params.n_interpolation_steps
        full = DeviceMemory([tmp], max_frames=traj, max_depths=traj,
                            height=rt.H, width=rt.W, zfar=params.zfar,
                            device=dev)
        full.begin_trajectory(tmp)
        out["slot_bytes"] = full.nbytes()
        del full
        gc.collect()
        torch.cuda.empty_cache()
    default = load_params(os.path.join(
        REPO_DIR, "configs/macarons/macarons_default_training_config.json"))
    slots = default.n_memory_trajectories
    scenes = len(default.train_scenes)
    out["config_bytes"] = scenes * slots * out["slot_bytes"]
    print(f"[syncs] DeviceMemory at the default training config ({traj} "
          f"frames of {rt.H}x{rt.W}): {out['slot_bytes'] / 1e9:.3f} GB "
          f"allocated for one (scene, slot); its {scenes} training scenes x "
          f"{slots} slots: {out['config_bytes'] / 1e9:.2f} GB; the phase "
          f"took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


GROUP = 2
GROUP_PHASES = tuple(f"{p}/{i}" for i in range(GROUP)
                     for p in ("decision", "capture")) + (
    "depth_step", "supervision", "scone_step", "depth_replay",
    "scone_replay", "remap", "done")


def group_suite(root, levels, n_scenes=GROUP):
    """The synthetic suite's first ``n_scenes`` scenes under ``root``, each
    mesh subdivided ``levels`` times (synth_00 and synth_01: 59,392 faces
    each at 4 levels, in boxes of different heights)."""
    root = generate_suite(root, n_scenes=n_scenes)
    for i in range(n_scenes):
        path = os.path.join(root, f"synth_{i:02d}", "mesh.obj")
        save_obj(path, subdivide(load_obj(path), levels))
    return root


def phase_train_group():
    """Scene-group training as users run it: run_training with the default
    training config at full widths, n_parallel_scenes GROUP and the disk
    memory (device_memory false) on synth_00 and synth_01 subdivided
    SCENE_LEVELS times. Epoch 0:
    TRAIN_POSES group poses (decisions, moves and captures scene by scene,
    one depth step over both scenes' windows, one SCONE step on the mean
    of their losses), a remap at pose TRAIN_REMAP; then a resumed epoch 1
    with depth replay at GROUP times n_memory_samples frames and SCONE
    replay scene by scene. Launch counts are set to 0 before the first run
    and read after the second. Fails unless the losses are finite with a
    positive depth loss, the three networks moved, each scene saved 1 +
    n_alpha + poses x interpolation steps frames per trajectory, one group
    SCONE step ran per group pose, the depth replay took GROUP times the
    samples, rasterize_tiled and both B3 kernels launched, the B3 backward
    GROUP times per group SCONE step and once per replay step; then one
    group SCONE step on the card against the CPU (hold_group_scone_step).
    Prints each group pose's phase times per scene-pose, the replay split
    and the peak device memory. Returns the launch counts."""
    dev = resolve_device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_group_",
                                     dir=_work_dir()) as tmp:
        root = group_suite(os.path.join(tmp, "scenes"), SCENE_LEVELS)
        wdir, mroot = os.path.join(tmp, "weights"), os.path.join(tmp, "mem")
        p0, p1 = train_params(root, 1), train_params(root, 2)
        for p in (p0, p1):
            # The disk memory (the native loader, queued writes); the train
            # phase runs the default DeviceMemory.
            p.update(dict(n_parallel_scenes=GROUP, device_memory=False))
        init = create_macarons_model(p0, dev)
        init_macarons_weights(init, seeded_generator(dev, p0.torch_seed))
        init = {name: {k: v.detach().cpu().clone() for k, v in
                       getattr(init, name).state_dict().items()}
                for name in ("occ", "vis", "depth")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with StepRecorder() as rec:
            run_training(p0, weights_dir=wdir, memory_root=mroot, device=dev,
                         verbose=False, on_phase=rec.on_phase)
            t1 = time.perf_counter()
            model, losses = run_training(p1, weights_dir=wdir,
                                         memory_root=mroot, device=dev,
                                         verbose=False, on_phase=rec.on_phase)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = read_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        names = SceneDataset(root).scene_names
        n_frames = {n: [len(os.listdir(os.path.join(
            mroot, n, p0.memory_dir_name, "training", str(t), "frames")))
            for t in (0, 1)] for n in names}

    for e in (0, 1):
        for i in range(TRAIN_POSES):
            spans = ", ".join(
                f"{a} {rec.span(e, i, a, b) / GROUP:.2f}" for a, b in
                zip(GROUP_PHASES, GROUP_PHASES[1:]))
            total = rec.span(e, i, GROUP_PHASES[0], "done") / GROUP
            print(f"[train group] epoch {e} pose {i}, ms per scene-pose "
                  f"(group {GROUP}): {total:.2f}: {spans}", flush=True)
    for i in range(TRAIN_POSES):
        print(f"[train group] epoch 1 pose {i} replay split for the group "
              f"(ms: phase between CUDA events, of it memory reads on the "
              f"host): {rec.replay_split(1, i)}", flush=True)
    steps = {k: v for k, v in sorted(rec.steps.items(),
                                     key=lambda kv: str(kv[0]))}
    print(f"[train group] epoch 0 {t1 - t0:.2f} s, epoch 1 (resumed) "
          f"{t2 - t1:.2f} s for {GROUP} scenes x {TRAIN_POSES} poses; "
          f"losses {losses}; optimizer steps (epoch, phase, kind): {steps}; "
          f"depth batch sizes {rec.depth_batches}; frames per trajectory "
          f"{n_frames}; launches {counts}", flush=True)
    print(f"[train group] peak device memory {peak_gib:.2f} GiB", flush=True)

    for row in losses:
        if not (all(np.isfinite(v) for v in row.values())
                and row["depth"] > 0):
            fail(f"group losses not finite with a positive depth loss: "
                 f"{losses}")
    for name, state in init.items():
        now = getattr(model, name).state_dict()
        if all(torch.equal(v, now[k].cpu()) for k, v in state.items()
               if v.is_floating_point()):
            fail(f"group training left the {name} network as it was "
                 f"initialised")
    want = 1 + p0.n_alpha + TRAIN_POSES * p0.n_interpolation_steps
    if len(n_frames) != GROUP or any(v != [want, want]
                                     for v in n_frames.values()):
        fail(f"frames per scene and trajectory {n_frames}, not {want}")
    n_group = sum(v for (_, _, kind), v in rec.steps.items()
                  if kind == "scone_group")
    n_replay = sum(v for (_, phase, kind), v in rec.steps.items()
                   if kind == "scone" and phase == "scone_replay")
    if (n_group != 2 * TRAIN_POSES
            or rec.count(0, "depth_step", "depth") != TRAIN_POSES
            or n_replay != TRAIN_POSES * GROUP * p1.n_memory_scene_loops):
        fail(f"not one depth and one SCONE step per group pose, or SCONE "
             f"replay not per scene: {steps}")
    replay = rec.depth_batches.get((1, "depth_replay"), [])
    if (len(replay) != TRAIN_POSES * p1.n_memory_loops
            or any(b != GROUP * p1.n_memory_samples for b in replay)):
        fail(f"depth replay batches {replay}, not {p1.n_memory_loops} a "
             f"pose of {GROUP} x {p1.n_memory_samples}")
    for name in TRAIN_KERNELS:
        if counts[name] <= 0:
            fail(f"group training never launched the {name} kernel")
    if counts["sh_visibility_backward"] != GROUP * n_group + n_replay:
        fail(f"{counts['sh_visibility_backward']} launches of the B3 "
             f"backward kernel for {n_group} group SCONE steps of {GROUP} "
             f"scenes and {n_replay} replay steps")

    gen = make_generator(torch.device("cuda"), SEED + 4)
    t0 = time.perf_counter()
    errs = hold_group_scone_step(p1, model, *rec.group_call, gen)
    print(f"[train group] group SCONE step (n_cells_active 5), card against "
          f"CPU: {errs} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return counts


class PhaseTimes(StepRecorder):
    """A StepRecorder that also keeps every phase boundary's CUDA event in
    order, across trajectories and scenes."""

    def __init__(self):
        super().__init__()
        self.order = []

    def on_phase(self, epoch, pose_i, name):
        super().on_phase(epoch, pose_i, name)
        self.order.append((epoch, name, self.events[(epoch, pose_i, name)]))

    def totals(self):
        """{(epoch, phase): ms} summed over poses and scenes (a group's
        per-scene phases under their common name), and {(epoch, phase):
        ms of memory reads}."""
        torch.cuda.synchronize()
        ms, reads = {}, {}
        for (e, a, ev0), (_, _, ev1) in zip(self.order, self.order[1:]):
            if a != "done":
                key = (e, a.split("/")[0])
                ms[key] = ms.get(key, 0.0) + ev0.elapsed_time(ev1)
        for (e, _, phase), sec in self.reads.items():
            key = (e, phase.split("/")[0])
            reads[key] = reads.get(key, 0.0) + 1e3 * sec
        return ms, reads


GROUP_TIME_SCENES = 4
GROUP_TIME_SUITE_POSES = 10


def phase_group_times():
    """Scene-group training's cost on the card at groups 1, 2 and 4,
    without holds: the suite's training config (synthetic_suite
    train-config: eval_params widths, perfect depth, the carving field)
    on the suite's first GROUP_TIME_SCENES scenes, GROUP_TIME_SUITE_POSES
    poses each, the remap at the last saving every depth; and the default
    training config (train_params) on synth_00..synth_03 subdivided
    SCENE_LEVELS times, TRAIN_POSES poses, a remap at TRAIN_REMAP. Each
    configuration runs with the disk memory at groups 1, 2 and 4, and
    with the DeviceMemory at groups 1 and 2. Each run: an epoch, then a
    resumed one with replay. Prints, per configuration, memory, group and
    epoch, the ms per scene-pose of each phase (between CUDA events), of it
    the memory reads (host time: file reads, or the device memory's
    slices), the seconds per scene-pose and the peak device memory; group
    4, if its run runs out of device memory, is reported as not fitting (an
    OOM at groups 1 and 2 fails the run)."""
    dev = resolve_device("cuda")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gtimes_",
                                     dir=_work_dir()) as tmp:
        suite = generate_suite(os.path.join(tmp, "suite"))
        scenes = group_suite(os.path.join(tmp, "scenes"), SCENE_LEVELS,
                             GROUP_TIME_SCENES)
        configs = []
        runs = [("disk", g) for g in (1, 2, 4)] + [("device", 1),
                                                   ("device", 2)]
        for memory, g in runs:
            p = suite_training_params(suite)
            # The remap (the config's at pose 95 of 100) at the cut
            # trajectory's last pose, saving every frame's depth (the
            # config's every fourth leaves 5, fewer than the 7 that 2 SCONE
            # replay loops of 4 need), so that epoch 1 replays as the
            # config's epochs do.
            p.update(dict(n_poses_in_trajectory=GROUP_TIME_SUITE_POSES,
                          remap_every_n_poses=GROUP_TIME_SUITE_POSES - 1,
                          save_depth_every_n_frame=1,
                          device_memory=memory == "device"))
            configs.append((f"suite train-config, {memory} memory", g, p))
        for memory, g in runs:
            p = train_params(scenes, 1)
            p.update(dict(device_memory=memory == "device"))
            configs.append((f"default training config, {memory} memory", g,
                            p))
        for label, g, p in configs:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            run = os.path.join(tmp, f"run_{len(os.listdir(tmp))}")
            rec = PhaseTimes()
            poses = p.n_poses_in_trajectory
            try:
                with rec:
                    for epoch in (0, 1):
                        p.update(dict(n_parallel_scenes=g, epochs=epoch + 1,
                                      start_from_scratch=epoch == 0))
                        run_training(
                            p, weights_dir=os.path.join(run, "w"),
                            memory_root=os.path.join(run, "mem"),
                            max_scenes_per_epoch=GROUP_TIME_SCENES,
                            device=dev, verbose=False,
                            on_phase=rec.on_phase)
            except torch.cuda.OutOfMemoryError as err:
                # Only group 4 may not fit; groups 1 and 2 must.
                if g < 4:
                    raise
                print(f"[group times] {label}, group {g}: does not fit on "
                      f"the card ({str(err).splitlines()[0]})", flush=True)
                continue
            peak = torch.cuda.max_memory_allocated() / 2**30
            ms, reads = rec.totals()
            n = GROUP_TIME_SCENES * poses
            for epoch in (0, 1):
                phases = {a: round(v / n, 2) for (e, a), v in ms.items()
                          if e == epoch}
                read = {a: round(v / n, 2) for (e, a), v in reads.items()
                        if e == epoch}
                print(f"[group times] {label}, group {g}, epoch {epoch} "
                      f"({'with' if epoch else 'no'} replay): "
                      f"{sum(phases.values()) / 1e3:.4f} s per scene-pose "
                      f"({GROUP_TIME_SCENES} scenes x {poses} poses); ms per "
                      f"scene-pose by phase {phases}; of it memory reads "
                      f"{read}; peak {peak:.2f} GiB", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])


def hold_group_scone_step(params, model, rt, members, kw, gen,
                          n_cells_active=5):
    """One group SCONE step from one state, held as hold_scone_step holds
    one scene's (the CPU runs taking the card's picks, ``scone_verdict``):
    ``members`` are a recorded parallel_scone_train_step's scenes; each
    scene's cell noise and Monte-Carlo sample (points drawn among its
    occupied ones) are drawn once and given to every run; one launch of
    the B3 backward kernel per scene. Returns the errors."""
    params = Params(dict(params.to_dict(), occ_curriculum_max_cells=min(
        n_cells_active, rt.occ_curriculum_max_cells)))
    noise, sample = [], []
    for x in members:
        _, _, occ, valid = x.field
        pool = torch.nonzero((occ[:, 0] > rt.coverage_gain.min_occ)
                             & valid)[:, 0]
        noise.append(torch.rand(x.cfg.n_cells, device=gen.device,
                                generator=gen))
        sample.append(pool[torch.randint(
            len(pool), (x.visited_cams.R.shape[0], rt.coverage_gain.seq_len),
            device=gen.device, generator=gen)])
    pns = params.get("prediction_neighborhood_size", 3.0)

    def step(dev, dt, neighbours=None, pools=None):
        m = MacaronsModel(net_copy(model.occ, dev, dt),
                          net_copy(model.vis, dev, dt), None)
        r = MacaronsRuntime(params, m, device=dev)
        # Each scene's cell tables in the run's type.
        r.bind_scene = lambda cfg, table: setattr(r, "_tables", _to(
            scene_runtime.device_cell_tables(cfg, table, pns, dev), dev, dt))
        opts = create_optimizers(params, m)
        before = shv.sh_visibility_backward.launches
        with knn_picks(neighbours) as kp, pool_picks(m.occ, pools) as pp:
            losses = r.parallel_scone_train_step(
                opts["scone"], [_to(x, dev, dt) for x in members],
                n_cells_active=n_cells_active,
                cell_noise=[n.to(dev) for n in noise],
                sample_idx=[i.to(dev) for i in sample])
        if (dev == "cuda" and shv.sh_visibility_backward.launches
                != before + len(members)):
            fail("the group SCONE step on the card did not launch the B3 "
                 "backward kernel once per scene")
        return {"losses": [float(v) for v in losses[1:]],
                "occ": grads_of(m.occ), "vis": grads_of(m.vis),
                **picks_of(kp, pp)}

    card, cpu, ref = hold_scone_runs(step, "train group")
    errs, faults = scone_verdict(card, cpu, ref)
    if faults:
        fail(f"the group SCONE step on the card: {'; '.join(faults)}: "
             f"{errs}")
    print_excused("train group", errs)
    return errs


def _to(x, dev, dtype=None):
    """``x`` (a tensor, a camera dataclass, a NamedTuple, tuple or dict of
    tensors, or anything else) with its tensors on ``dev`` and, given a
    ``dtype``, its floating tensors in it."""
    if isinstance(x, torch.Tensor):
        x = x.to(dev)
        return x.to(dtype) if dtype and x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: _to(v, dev, dtype) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _to(getattr(x, f.name), dev,
                                                     dtype)
                                         for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        items = [_to(v, dev, dtype) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def phase_reference(gen, rt, model, args):
    """The last pose's candidates scored again, on the card (SconeVis and the
    kernel) and on the CPU (SconeVis and the plain twin), with one injected
    Monte-Carlo sample of occupied field points: gains agree to rtol 1e-3
    and pick the same candidate."""
    _, _, occ, valid = args[:4]
    scorer = rt.coverage_gain
    pool = torch.nonzero((occ[:, 0] > scorer.min_occ) & valid)[:, 0]
    if len(pool) == 0:
        fail("the field has no occupied point to sample")
    C = args[5].shape[0]
    idx = pool[torch.randint(len(pool), (C, scorer.seq_len), device=pool.device,
                             generator=gen)]
    before = shv.sh_visibility.launches
    on_card = scorer(model.vis, *args, sample_idx=idx).cpu()
    if shv.sh_visibility.launches != before + 1:
        fail("the scorer on the card did not launch the sh_visibility kernel")
    vis_cpu = copy.deepcopy(model.vis).cpu()
    on_cpu = scorer(vis_cpu, *_to(args, "cpu"), sample_idx=idx.cpu())
    scale = float(on_cpu.abs().max())
    err = float((on_card - on_cpu).abs().max())
    print(f"[reference] {C} candidates scored on the card and on the CPU: max "
          f"|gain difference| {err:.3e} (largest gain {scale:.4g}), argmax "
          f"{int(on_card.argmax())} / {int(on_cpu.argmax())}", flush=True)
    if not (np.isfinite(err) and scale > 0):
        fail("reference gains are not finite and positive")
    if not torch.allclose(on_card, on_cpu, rtol=1e-3, atol=1e-6 * scale):
        fail("gains on the card differ from the CPU reference")
    if int(on_card.argmax()) != int(on_cpu.argmax()):
        fail("the card and the CPU reference pick different candidates")


def _work_dir():
    """Temporary files stay inside the checkout, beside the kernel builds."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    return BUILD_DIR


def kernel_row(gen, launches, worst_err, shape, path=None):
    """B3's forward held and timed at a path's shape (B, C, L): the scene
    path's per-candidate scorer (C_pad, 1, seq_len), the SCONE step's
    (4, 1, 2048), the pretraining lane's (3, 52, 2048) and the ShapeNet
    tester's (1, 52, 2048); ``path`` names the row's path beside the
    scorer's."""
    B, C, L = shape
    p, h, x = sh_inputs(gen, B, C, L)
    err = float((shv.sh_visibility(p, h, x)
                 - shv.compute_visibilities_plain(p, h, x)).abs().max())
    if not np.isfinite(err) or err > ATOL:
        fail(f"sh_visibility ({B},{C},{L}) differs from its plain twin by "
             f"{err}")
    host_ms = time_ms(lambda: shv.sh_visibility(p, h, x))
    plain_ms = time_ms(lambda: shv.compute_visibilities_plain(p, h, x), 10)
    t_ops = shv.flops(B, C, L) / PEAK_FP32_FLOPS * 1e3
    t_bytes = shv.bytes_moved(B, C, L) / PEAK_BYTES_PER_S * 1e3
    dev_ms, _ = profiled_device_ms(lambda: shv.sh_visibility(p, h, x),
                                   "sh_visibility_kernel")
    plan = shv.forward_plan(B, C, L)
    print(f"[kernel] sh_visibility ({B},{C},{L}) ({plan.slices} slices x "
          f"{plan.points} points a block, {plan.blocks} blocks): max |kernel "
          f"- plain| {err:.3e}, kernel {dev_ms * 1e3:.2f} us (torch.profiler), "
          f"{host_ms * 1e3:.2f} us per call (CUDA events, back-to-back calls, "
          f"host launch included), bound {max(t_ops, t_bytes) * 1e3:.2f} us, "
          f"{launches} launches on its path", flush=True)
    # "ms" is the kernel's device time from the profiler; "host_ms" the
    # per-call time between CUDA events, host launch included.
    return {
        "name": "sh_visibility" + (f" ({path}, {B}x{C}x{L})" if path else ""),
        "route": "cuda",
        "source": "macarons_tpu_torch/csrc/sh_visibility.cu",
        "replaces": "macarons_tpu/ops/pallas/sh_visibility.py:133",
        "launches": launches, "max_abs_err": max(worst_err, err),
        "ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None, "shape": [B, C, L], "host_ms": host_ms,
    }


def launches_at(counts, shape, want=None):
    """B3's forward launches at ``shape`` from a phase's counts; fails if
    there are none, or not ``want``."""
    n = counts["sh_visibility_at"].get(tuple(shape), 0)
    if n <= 0 or (want is not None and n != want):
        fail(f"B3's forward launched {n} times at {tuple(shape)}, not "
             f"{want if want is not None else 'at least once'}: "
             f"{counts['sh_visibility_at']}")
    return n


def hold_backward(p, h, x, sig, g):
    """B3's backward through autograd on the card (the kernel) against the
    plain backward on the same inputs, relative to the largest gradient.
    Fails unless the kernel launched once and the output carries a grad_fn."""
    h = h.detach().requires_grad_()
    out = shv.sh_visibility(p, h, x, use_sigmoid=sig)
    if out.grad_fn is None:
        fail("sh_visibility on CUDA tensors carries no grad_fn")
    before = shv.sh_visibility_backward.launches
    grad, = torch.autograd.grad(out, h, g)
    torch.cuda.synchronize()
    if shv.sh_visibility_backward.launches != before + 1:
        fail("the B3 backward kernel did not launch once per backward")
    ref = shv.sh_visibility_backward_plain(p, x, out.detach(), g, sig)
    return float((grad - ref).abs().max() / ref.abs().max())


def hold_basis(p, x):
    """The backward kernel's basis against the forward kernel's, bit for
    bit, at points p (B, L, P) seen from one camera x (B, 1, 3): with the
    output and its gradient at 1 and relu, grad_harmonics[..., k] is Y_k
    itself; the forward with relu and the coefficients +-e_k gives
    max(+-Y_k, 0). Returns the number of (point, term) entries that
    differ."""
    B, L = p.shape[:2]
    ones = torch.ones(B, 1, L, device="cuda")
    basis = shv.sh_visibility_backward(p, x, ones, ones, use_sigmoid=False)
    fwd = torch.empty_like(basis)
    with torch.no_grad():
        for k in range(shv.N_HARMONICS):
            e = torch.zeros_like(basis)
            e[..., k] = 1.0
            fwd[..., k] = (shv.sh_visibility(p, e, x, False)
                           - shv.sh_visibility(p, -e, x, False))[:, 0]
    return int((fwd != basis).sum())


def pole_and_pad_inputs(gen, B, C, L):
    """sh_inputs with points on the +-y axis of camera 0 (the sin(theta)
    clamp) and 1e6 pads (the JAX kernel's padding value)."""
    pts, harm, X_cam = sh_inputs(gen, B, C, L)
    pts[:, :L // 3, 0] = X_cam[:, :1, 0]
    pts[:, :L // 3, 2] = X_cam[:, :1, 2]
    pts[:, L // 3:L // 2, :3] = 1e6
    return pts, harm, X_cam


def phase_backward_kernel():
    """B3's backward kernel against its plain version at the SCONE step's
    shapes (4 visited cameras, one per candidate batch: (4, 1, 2048); one
    shared sample: (1, 4, 2048)), at 1001 points (a multiple of no block or
    lane-group size), at 5 cameras, and at the poles and the 1e6 pads, both
    activations; its basis against the forward kernel's, bit for bit; and
    the wrapper refusing points that require grad. Own generator: the
    trajectories after it draw as before."""
    gen = make_generator(torch.device("cuda"), SEED + 4)
    cases = []
    for B, C, L in ((4, 1, 2048), (1, 4, 2048), (3, 1, 1001), (2, 5, 333)):
        for sig in (True, False):
            cases.append((f"({B},{C},{L}) {'sigmoid' if sig else 'relu'}",
                          sh_inputs(gen, B, C, L), sig))
    pts, harm, X_cam = pole_and_pad_inputs(gen, 2, 3, 300)
    for sig in (True, False):
        cases.append((f"poles and pads {'sigmoid' if sig else 'relu'}",
                      (pts, harm, X_cam), sig))
    worst = 0.0
    for name, (p, h, x), sig in cases:
        g = torch.randn(p.shape[0], x.shape[1], p.shape[1], device="cuda",
                        generator=gen)
        err = hold_backward(p, h, x, sig, g)
        worst = max(worst, err)
        print(f"[kernel] sh_visibility_backward {name}: max |kernel - plain| "
              f"{err:.3e} of max |grad|", flush=True)
        if not np.isfinite(err) or err > BACKWARD_REL:
            fail(f"sh_visibility_backward {name} differs from its plain "
                 f"version by {err} of max |grad|")
    p, _, x = pole_and_pad_inputs(gen, 2, 1, 300)
    differ = hold_basis(p, x)
    print(f"[kernel] sh_visibility_backward: basis against the forward "
          f"kernel's at the poles and pads, {differ} of "
          f"{p.shape[0] * p.shape[1] * shv.N_HARMONICS} terms differ",
          flush=True)
    if differ:
        fail(f"the backward kernel's basis differs from the forward's in "
             f"{differ} terms")
    try:
        shv.sh_visibility(pts.detach().requires_grad_(), harm, X_cam)
    except ValueError:
        pass
    else:
        fail("sh_visibility accepted points that require grad")
    return worst


def launch_floor_ms():
    """torch.profiler's device time of a one-element elementwise kernel:
    what no single launch beats."""
    x = torch.zeros(1, device="cuda")
    return profiled_device_ms(lambda: x.add_(1.0), "elementwise")[0]


def backward_times(gen, B, C, L):
    """B3's backward at (B, C, L): held to its plain version, then its
    device time (torch.profiler), its time per call between CUDA events, the
    plain version's and the bound."""
    backward = shv.sh_visibility_backward
    p, h, x = sh_inputs(gen, B, C, L)
    with torch.no_grad():
        out = shv.sh_visibility(p, h, x)
    g = torch.randn(B, C, L, device="cuda", generator=gen)
    ref = shv.sh_visibility_backward_plain(p, x, out, g)
    err = float((backward(p, x, out, g) - ref).abs().max() / ref.abs().max())
    t_ops = shv.backward_flops(B, C, L) / PEAK_FP32_FLOPS * 1e3
    t_bytes = shv.backward_bytes_moved(B, C, L) / PEAK_BYTES_PER_S * 1e3
    return {"shape": [B, C, L], "max_abs_err": err,
            "ms": profiled_device_ms(lambda: backward(p, x, out, g),
                                     "sh_visibility_backward_kernel")[0],
            "plain_ms": time_ms(lambda: shv.sh_visibility_backward_plain(
                p, x, out, g), 10),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "host_ms": time_ms(lambda: backward(p, x, out, g))}


def backward_row(worst, scone_shape, shared_shape):
    """B3's backward at the SCONE step's per-candidate shape and, under
    "shared_sample", at its shared-sample shape, with the launch floor;
    its launches are the train phase's, filled in by the caller."""
    gen = make_generator(torch.device("cuda"), SEED + 5)
    main, shared = (backward_times(gen, *shape)
                    for shape in (scone_shape, shared_shape))
    floor = launch_floor_ms()
    for t in (main, shared):
        if not t["max_abs_err"] <= BACKWARD_REL:
            fail(f"sh_visibility_backward {t['shape']} differs from its plain "
                 f"version by {t['max_abs_err']} of max |grad|")
        print(f"[kernel] sh_visibility_backward {tuple(t['shape'])}: max "
              f"|kernel - plain| {t['max_abs_err']:.3e} of max |grad|, kernel "
              f"{t['ms'] * 1e3:.2f} us (torch.profiler), "
              f"{t['host_ms'] * 1e3:.2f} us per call (CUDA events, host "
              f"launch included), plain "
              f"{t['plain_ms'] * 1e3:.2f} us, bound {t['bound_ms'] * 1e3:.2f} "
              f"us ({t['bound_by']}), launch floor {floor * 1e3:.2f} us",
              flush=True)
    return dict(main, name="sh_visibility_backward", route="cuda",
                source="macarons_tpu_torch/csrc/sh_visibility.cu",
                replaces="macarons_tpu/ops/pallas/sh_visibility.py:133",
                launches=None, max_abs_err=max(worst, main["max_abs_err"]),
                library_ms=None, launch_floor_ms=floor,
                shared_sample=shared)


def short(kernel):
    """A kernel's name from the profiler, without its return type,
    namespace and arguments."""
    name = kernel.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:48]


def two_pass(b1, b2, lane_faces):
    """The tiled path's composition before the fused launch: B1 over the
    pairs, B2 over the big-face lanes, slots to face ids, the merge."""
    z, slot, b0, b1_ = tr.rasterize_tiles(*b2)
    fid = torch.where(slot >= 0,
                      lane_faces.gather(1, slot.clamp(min=0).long()), -1)
    return tr.merge_passes(tr.rasterize_pairs(*b1), (z, fid, b0, b1_))


def raster_rows(launches, worst, f9, size):
    """B1 alone, B2 alone and the fused launch at the scene-scale move's
    shape (its cameras' tiles stacked on the grid): held against their
    plain versions there, then timed; and the two-pass composition against
    the fused launch, in turns."""
    K_cap = rast.k_cap(1024, f9.shape[2])
    b1, b2, fused = raster_args(f9, size, K_cap, True)
    R, P = b1[2].shape[0], TILE * TILE
    n_p, _, n_l, cum = tr.item_table(b1[2], b1[3], b1[0].shape[0], K_cap,
                                     fused[5], fused[6])
    n_pairs, n_lanes, n_items = int(n_p.sum()), int(n_l.sum()), int(cum[-1])
    print(f"[kernel] move shape: {R} (camera, tile) rows, {n_pairs} pairs "
          f"tested (largest tile {int(b1[3].max())}, "
          f"{int((b1[3] > K_cap).sum())} tiles over K_cap {K_cap}), "
          f"{n_lanes} big-face lanes; {n_items} items of at most {tr.ITEM} "
          f"faces", flush=True)
    rows = []
    for name, kernel, plain, args, line, n, t_ops, t_bytes in (
            ("rasterize_pairs", tr.rasterize_pairs, tr.rasterize_pairs_plain,
             b1, 264, n_pairs, tr.flops(n_pairs, R, P),
             tr.bytes_moved(n_pairs, R, P)),
            ("rasterize_tiles", tr.rasterize_tiles, tr.rasterize_tiles_plain,
             b2, 320, n_lanes, tr.flops(n_lanes, R, P),
             tr.bytes_moved(n_lanes, R, P)),
            ("rasterize_tiled", tr.rasterize_tiled, tr.rasterize_tiled_plain,
             fused, 264, n_pairs + n_lanes,
             tr.tiled_flops(n_pairs, n_lanes, R, P),
             tr.tiled_bytes(n_pairs, n_lanes, R, P))):
        err, _ = hold_raster(name, kernel, plain, args)
        host_ms = time_ms(lambda: kernel(*args), 20)
        plain_ms = time_ms(lambda: plain(*args), 3)
        dev_ms, per = profiled_device_ms(lambda: kernel(*args),
                                         "raster_tiled_kernel")
        t_ops = t_ops / PEAK_FP32_FLOPS * 1e3
        t_bytes = t_bytes / PEAK_BYTES_PER_S * 1e3
        parts = ", ".join(f"{short(k)} {v * 1e3:.2f}" for k, v in
                          sorted(per.items(), key=lambda kv: -kv[1]))
        print(f"[kernel] {name} rows {R} faces tested {n}: max |kernel - "
              f"plain| {err:.3e}, {dev_ms * 1e3:.2f} us of device time per "
              f"call (torch.profiler; us: {parts}), {host_ms * 1e3:.2f} us "
              f"per call (CUDA events, host launch included), plain "
              f"{plain_ms:.3f} ms, bound {max(t_ops, t_bytes) * 1e3:.2f} us",
              flush=True)
        row = {
            "name": name, "route": "cuda",
            "source": "macarons_tpu_torch/csrc/tile_raster.cu",
            "replaces": f"macarons_tpu/ops/pallas/tile_raster.py:{line}",
            "launches": launches[name], "max_abs_err": max(worst[name], err),
            "ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "shape": [R, P, n], "host_ms": host_ms,
            "kernel_ms": sum(v for k, v in per.items()
                             if "raster_tiled_kernel" in k),
        }
        if name == "rasterize_tiled":
            row["replaces_also"] = "macarons_tpu/ops/pallas/tile_raster.py:320"
        rows.append(row)

    sweep = []
    for item in (16, 32, 64, 128):
        _, per = profiled_device_ms(
            lambda: tr.rasterize_tiled(*fused, item=item),
            "raster_tiled_kernel")
        us = 1e3 * sum(v for k, v in per.items()
                       if "raster_tiled_kernel" in k)
        sweep.append(f"{item} faces {us:.2f} us")
    print("[kernel] rasterize_tiled at the move shape, raster_tiled_kernel's "
          "device time by item size: " + ", ".join(sweep), flush=True)
    lane_faces = fused[4]
    if not torch.equal(two_pass(b1, b2, lane_faces)[1],
                       tr.rasterize_tiled(*fused)[1]):
        fail("the two-pass composition and the fused launch differ")
    turns = []
    for label, fn in (("two-pass", lambda: two_pass(b1, b2, lane_faces)),
                      ("fused", lambda: tr.rasterize_tiled(*fused)),
                      ("fused", lambda: tr.rasterize_tiled(*fused)),
                      ("two-pass", lambda: two_pass(b1, b2, lane_faces))):
        turns.append((label, time_ms(fn, 20),
                      profiled_device_ms(fn, "raster_tiled_kernel")[0]))
    print("[kernel] two-pass composition (B1, B2, merge) vs fused launch at "
          "the move shape, in turns: " + "; ".join(
              f"{label} {host * 1e3:.2f} us per call (CUDA events), "
              f"{dev * 1e3:.2f} us device" for label, host, dev in turns),
          flush=True)
    return rows


# ---------------------------------------------------------------------------
# The SCONE pretraining lane (GT generation, the two pretrainers, the
# ShapeNet tester, the assembled checkpoint)
# ---------------------------------------------------------------------------

PRETRAIN_KERNELS = ["rasterize_tiled", "sh_visibility",
                    "sh_visibility_backward"]
# The lane's cuts: 8 meshes (synth_00 subdivided 4 times, synth_01 3 times,
# synth_02 .. 07 as they are), 2 epochs x 2 batches and a resumed third, 2
# test meshes. Widths are the configs'.
PRETRAIN_EPOCHS = 2
PRETRAIN_BATCHES = 2
GT_HOLD_SIZE = 128  # the card-against-CPU GT hold's image side
# The GT hold on one mesh, card against CPU from the same draws: shares of
# agreement the run must reach (face choices and pixel edges round
# differently on the two devices, PERF.md §6: 5e-4 of a move's pixels).
GT_AGREE = 0.99
CARVE_AGREE = 0.999


def shapenet_suite(root):
    """A ShapeNet-format root of 8 meshes of the synthetic suite
    (``shapenet_mesh``) with train (synth_00 .. 05), val (05 .. 07) and
    test (synth_00, 07) split files. Returns the model paths."""
    models = [shapenet_mesh(root, i) for i in range(8)]
    for split, names in (("train_list.json", models[:6]),
                         ("val_list.json", models[5:]),
                         ("all_test_list.json", [models[0], models[7]])):
        with open(os.path.join(root, split), "w") as f:
            json.dump({"models": names}, f)
    return models


def shapenet_mesh(root, i):
    """Mesh i of the synthetic suite in ShapeNet's layout,
    ``02000000/synth_<i>/model.obj``, normalised to a box diagonal of 1;
    meshes 0 and 1 subdivided to 59,392 and 14,848 faces. Returns its path
    under ``root``."""
    mesh = build_scene_mesh(1000 + i)
    if i < 2:
        mesh = subdivide(mesh, SCENE_LEVELS - i)
    v = mesh.verts - (mesh.verts.max(0) + mesh.verts.min(0)) / 2
    v = v / np.linalg.norm(mesh.verts.max(0) - mesh.verts.min(0))
    name = f"02000000/synth_{i:02d}/model.obj"
    os.makedirs(os.path.dirname(os.path.join(root, name)))
    save_obj(os.path.join(root, name),
             Mesh(v.astype(np.float32), mesh.faces, mesh.vert_colors))
    return name


def pretrain_params(path, root, epochs, **extra):
    params = load_params(os.path.join(REPO_DIR, path))
    params.update(dict(data_path=root, epochs=epochs,
                       start_from_scratch=epochs == PRETRAIN_EPOCHS, **extra))
    return params


def load_mesh(root, name, dev):
    mesh = load_obj(os.path.join(root, name))
    return (shapenet.adjust_mesh_diagonally(
        torch.as_tensor(mesh.verts, device=dev), 1.0),
        torch.as_tensor(mesh.faces, device=dev).long())


def hold_gt(root, name):
    """GT of one mesh at GT_HOLD_SIZE on the card and on the CPU (the tiled
    path, kernels against their plain versions) from one CPU generator's
    draws. The surface sample's face picks differ where a uniform draw lies
    within the two devices' CDF difference of a face boundary (their
    cumsums of the face areas round differently): elsewhere the points
    agree within 1e-5, and every differing pick must be so explained. The
    clouds' points lie within 1e-4 of the same camera's CPU cloud, the
    coverage entries agree, in shares of at least GT_AGREE; the carving of
    the CPU's samples agrees in a share of at least CARVE_AGREE. Returns
    the shares."""
    cfg = shapenet.ShapeNetGTConfig(image_size=GT_HOLD_SIZE)
    gts, cdfs = {}, {}
    for dev in ("cuda", "cpu"):
        verts, faces = load_mesh(root, name, dev)
        gts[dev] = shapenet.generate_mesh_gt(
            torch.Generator().manual_seed(SEED), verts, faces, cfg,
            method="tiled")
        cdf = cumsum_rows(compute_mesh_face_area(verts, faces))
        cdfs[dev] = (cdf / cdf[-1]).cpu()
    card, cpu = ({k: torch.as_tensor(v) for k, v in g.items()}
                 for g in (gts["cuda"], gts["cpu"]))
    # The surface sample's first draws (ops.sampling.sample_mesh_triangle).
    u = torch.rand(cfg.n_points_surface,
                   generator=torch.Generator().manual_seed(SEED))
    picks = [torch.searchsorted(cdfs[d], u) for d in ("cuda", "cpu")]
    same = picks[0] == picks[1]
    delta = float((cdfs["cuda"] - cdfs["cpu"]).abs().max())
    edge = cdfs["cpu"][torch.minimum(*picks).clamp(
        max=cdfs["cpu"].numel() - 1)]
    explained = bool(((u - edge).abs()[~same] <= 2 * delta).all())
    close = (card["surface_points"] - cpu["surface_points"]).abs().amax(1) \
        <= 1e-5
    share = {"surface_picks_differ": float((~same).float().mean()),
             "cdf_max_difference": delta,
             "surface_same_pick_close": float(close[same].float().mean())}
    near, n_valid = [], []
    for c in range(card["partial_point_cloud"].shape[0]):
        a = card["partial_point_cloud"][c][card["partial_point_cloud_mask"][c]]
        b = cpu["partial_point_cloud"][c][cpu["partial_point_cloud_mask"][c]]
        n_valid.append((len(a), len(b)))
        if len(a) and len(b):
            d = torch.cdist(a.cuda(), b.cuda(),
                            compute_mode="donot_use_mm_for_euclid_dist")
            near.append(d.amin(1).cpu() <= 1e-4)
    share["clouds"] = float(torch.cat(near).float().mean())
    share["valid_counts_equal"] = float(np.mean([a == b for a, b in n_valid]))
    share["coverage"] = float((card["coverage"] == cpu["coverage"])
                              .float().mean())
    X = cpu["occupancy_field"][:, :3]
    occ = [shapenet.carve_occupancy(*load_mesh(root, name, dev), X.to(dev),
                                    cfg, method="tiled").cpu()
           for dev in ("cuda", "cpu")]
    share["carving"] = float((occ[0] == occ[1]).float().mean())
    share["occupied"] = (float(card["occupancy_field"][:, 3].mean()),
                         float(cpu["occupancy_field"][:, 3].mean()))
    print(f"[scone_pretrain] GT of {name} at {GT_HOLD_SIZE}x{GT_HOLD_SIZE}, "
          f"card against CPU (tiled path, same draws): {share}", flush=True)
    if not (share["surface_same_pick_close"] == 1.0 and explained):
        fail("the GT surface points on the card and on the CPU differ "
             f"beyond their area CDFs' rounding: {share}")
    for key in ("clouds", "coverage"):
        if not share[key] >= GT_AGREE:
            fail(f"the GT {key} on the card and on the CPU agree in a share "
                 f"of {share[key]}, under {GT_AGREE}")
    if not share["carving"] >= CARVE_AGREE:
        fail(f"the carving on the card and on the CPU agree in a share of "
             f"{share['carving']}, under {CARVE_AGREE}")
    return share


def gt_raster_row(root, name, cams, label, launches, image_size=None):
    """B1 + B2 (the fused rasterize_tiled) at a GT capture's shape: the
    mesh at surface_resolution scale under ``cams`` at ``image_size``
    squared (the GT config's 512 by default), as ``tiled_row``."""
    cfg = shapenet.ShapeNetGTConfig()
    verts, faces = load_mesh(root, name, "cuda")
    verts = shapenet.adjust_mesh_diagonally(verts, cfg.surface_resolution)
    side = image_size or cfg.image_size
    return tiled_row(rast.project_fv_batch(verts, faces, cams),
                     (side, side), label, launches)


def tiled_row(f9, size, label, launches):
    """The fused rasterize_tiled row at the shape of the projected faces
    ``f9`` at image ``size``: held against its plain version, then timed;
    the pairs K_cap truncation drops are counted, and the whole tiled path
    (feeder and launch) is timed."""
    K_cap = rast.k_cap(1024, f9.shape[2])
    args = raster_args(f9, size, K_cap, True)[2]
    err, cover = hold_raster("rasterize_tiled", tr.rasterize_tiled,
                             tr.rasterize_tiled_plain, args)
    n_p, _, n_l, _ = tr.item_table(args[2], args[3], args[1].shape[0],
                                   K_cap, args[5], args[6])
    n_pairs, n_lanes = int(n_p.sum()), int(n_l.sum())
    counts = args[3].long()
    dropped = int((counts - K_cap).clamp(min=0).sum())
    R, P = counts.shape[0], TILE * TILE
    plain_ms = median_ms(lambda: tr.rasterize_tiled_plain(*args), reps=2)[0]
    dev_ms, per = profiled_device_ms(lambda: tr.rasterize_tiled(*args),
                                     "raster_tiled_kernel")
    path_ms = median_ms(lambda: rast._rasterize_tiled(f9, size, TILE, 1024,
                                                      True))
    t_ops = tr.tiled_flops(n_pairs, n_lanes, R, P) / PEAK_FP32_FLOPS * 1e3
    t_bytes = tr.tiled_bytes(n_pairs, n_lanes, R, P) / PEAK_BYTES_PER_S * 1e3
    print(f"[kernel] rasterize_tiled, {label}: {R} (camera, tile) rows, "
          f"{n_pairs} pairs and {n_lanes} big-face lanes tested, "
          f"{int((counts > K_cap).sum())} tiles over K_cap {K_cap} dropping "
          f"{dropped} of {int(counts.sum())} pairs; ids identical to the "
          f"plain version, max |kernel - plain| {err:.3e}, covered "
          f"{cover:.3f}; {dev_ms * 1e3:.2f} us of device time per call "
          f"(torch.profiler), plain {plain_ms:.3f} ms, bound "
          f"{max(t_ops, t_bytes) * 1e3:.2f} us; the whole tiled path "
          f"(feeder and launch) {path_ms[0]:.3f} ms (median of 5 between "
          f"CUDA events, {path_ms[1]:.3f}-{path_ms[2]:.3f})", flush=True)
    return {"name": f"rasterize_tiled ({label})", "route": "cuda",
            "source": "macarons_tpu_torch/csrc/tile_raster.cu",
            "replaces": "macarons_tpu/ops/pallas/tile_raster.py:264",
            "replaces_also": "macarons_tpu/ops/pallas/tile_raster.py:320",
            "launches": launches, "max_abs_err": err, "ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "shape": [R, P, n_pairs + n_lanes],
            "kernel_ms": sum(v for k, v in per.items()
                             if "raster_tiled_kernel" in k),
            "pairs_dropped_by_K_cap": dropped, "path_ms": path_ms[0]}


def hold_pretrain_step(kind, params, net, occ_net, batch, draws=None):
    """One pretraining step (``kind`` "occ": SconeOcc's MSE; "vis":
    SconeVis's coverage loss on a frozen SconeOcc, with ``draws``
    injected) from one state in each of RUNS, SconeOcc's down-samples
    deterministic: the losses within rtol 1e-3 of the CPU's float32, the
    gradients as fp32_errors asks; on the card B3 forward and backward each
    launched once (vis). Returns the errors."""
    out = {}
    for dev, dt in RUNS:
        def step():
            m = net_copy(net, dev, dt)
            consts = _to(pretrain_occ.step_constants(params, dev), dev, dt)
            b = _to(pretrain_occ.batch_to_device(batch, dev), dev, dt)
            before = read_counts()
            pred = None
            if kind == "occ":
                loss = pretrain_occ.occ_loss(params, m, consts, b)
            else:
                loss, pred, _ = pretrain_vis.vis_loss(
                    params, net_copy(occ_net, dev, dt), m, consts, b,
                    draws=_to(draws, dev, dt))
                pred = pred.detach().cpu().double()
            loss.backward()
            after = read_counts()
            if kind == "vis" and dev == "cuda" and (
                    after["sh_visibility"] != before["sh_visibility"] + 1
                    or after["sh_visibility_backward"]
                    != before["sh_visibility_backward"] + 1):
                fail("the vis step on the card did not launch B3 and its "
                     "backward once each")
            return {"loss": loss.item(), kind: grads_of(m), "pred": pred}
        out[(dev, dt)] = in_dtype(dt, step)
    card, cpu = out[RUNS[0]]["loss"], out[RUNS[1]]["loss"]
    errs = {"loss": cpu, "loss_rel": abs(card - cpu) / max(abs(cpu), 1e-30)}
    if kind == "vis":
        a, c = out[RUNS[0]]["pred"], out[RUNS[1]]["pred"]
        errs["gains_rel"] = float((a - c).abs().max() / c.abs().max())
    if not (np.isfinite(card) and cpu > 0 and errs["loss_rel"] <= 1e-3):
        fail(f"the {kind} step on the card and on the CPU differ: {errs}")
    errs.update(fp32_errors(out, [kind]))
    return errs


def phase_scone_pretrain():
    """The SCONE pretraining lane at the configs' widths: a ShapeNet-format
    root of 8 synthetic meshes and its GT (ShapeNetGTConfig: 52 FoV and 6
    orthographic cameras at 512x512, 16,384 surface points, 600,000
    carving samples) written by the port's generate_shapenet_data; the
    occupancy pretrainer (seq_len 2048, n_sample 6000, n_view_max 5, batch
    3) for PRETRAIN_EPOCHS epochs of PRETRAIN_BATCHES batches and a resumed
    one more; the coverage-gain pretrainer (100,000 proxies, n_view_max 9)
    the same way on the occupancy checkpoint; the ShapeNet tester
    (n_view_max 10, pc_size 1024) on the test split with both; launch
    counts set to 0 before and read after all of it. Then the GT hold on
    synth_00, one occ and one vis step held card against CPU, and the
    MACARONS checkpoint assembled from the two and loaded by the online
    trainer's set-up. Returns the rows' inputs."""
    dev = resolve_device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    timer = {}

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        timer[name] = ev

    with tempfile.TemporaryDirectory(prefix="chip_smoke_shapenet_",
                                     dir=_work_dir()) as tmp:
        root = os.path.join(tmp, "ShapeNetCore.v1")
        models = shapenet_suite(root)
        w_occ, w_vis = (os.path.join(tmp, "weights", k)
                        for k in ("occ", "vis"))
        occ_path = "configs/scone/occupancy/occupancy_pretraining_config.json"
        vis_path = ("configs/scone/coverage_gain/"
                    "coverage_gain_pretraining_config.json")
        p_occ = [pretrain_params(occ_path, root, e)
                 for e in (PRETRAIN_EPOCHS, PRETRAIN_EPOCHS + 1)]
        p_vis = [pretrain_params(vis_path, root, e)
                 for e in (PRETRAIN_EPOCHS, PRETRAIN_EPOCHS + 1)]
        occ_ckpt = os.path.join(w_occ, p_vis[0].scone_occ_model_name)
        vis_ckpt = os.path.join(w_vis, "best_unval_"
                                + p_vis[0].scone_vis_model_name)
        test = normalize_test_config(load_params(os.path.join(
            REPO_DIR, "configs/test/test_on_shapenet_seen_categories_config"
            ".json")), REPO_DIR)
        p_test = load_params(os.path.join(REPO_DIR, test.training_config))
        p_test.update(test.to_dict())
        faces = {m: load_obj(os.path.join(root, m)).faces.shape[0]
                 for m in models}
        print(f"[scone_pretrain] meshes (faces): {faces}; occ: seq_len "
              f"{p_occ[0].seq_len}, n_sample {p_occ[0].n_sample}, n_view_max "
              f"{p_occ[0].n_view_max}, batch {p_occ[0].batch_size}; vis: "
              f"proxies {p_vis[0].n_proxy_points}, n_view_max "
              f"{p_vis[0].n_view_max}, occ pass "
              f"{p_vis[0].max_points_per_scone_occ_pass}; test: n_view_max "
              f"{p_test.n_view_max}, pc_size {p_test.pc_size}", flush=True)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        steps = {"occ": 0, "vis": 0}
        mark("gt")
        generate_shapenet_data.generate(root, shapenet.ShapeNetGTConfig(),
                                        device=dev, verbose=False)
        mark("occ")
        losses = {}
        for i, p in enumerate(p_occ):
            _, tl, vl = pretrain_occ.run_training(
                p, weights_dir=w_occ, max_batches_per_epoch=PRETRAIN_BATCHES,
                device=dev, verbose=False)
            losses[f"occ_{i}"] = (tl, vl)
        mark("vis")
        with counting(pretrain_vis, "vis_loss", steps, "vis"):
            for i, p in enumerate(p_vis):
                _, tl, vl, nbv = pretrain_vis.run_training(
                    p, weights_dir=w_vis, occ_weights_path=occ_ckpt,
                    max_batches_per_epoch=PRETRAIN_BATCHES, device=dev,
                    verbose=False)
                losses[f"vis_{i}"] = (tl, vl, nbv)
        mark("test")
        results = shapenet_tester.run_test(
            p_test, data_path=root, occ_weights_path=occ_ckpt,
            vis_weights_path=vis_ckpt, results_dir=os.path.join(tmp, "res"),
            device=dev, verbose=False)
        mark("done")
        torch.cuda.synchronize()
        counts = read_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        spans = {a: timer[a].elapsed_time(timer[b]) / 1e3 for a, b in
                 (("gt", "occ"), ("occ", "vis"), ("vis", "test"),
                  ("test", "done"))}
        print(f"[scone_pretrain] phase times (s, CUDA events): GT "
              f"{spans['gt']:.2f}, occ pretraining {spans['occ']:.2f}, vis "
              f"pretraining {spans['vis']:.2f}, ShapeNet test "
              f"{spans['test']:.2f}; peak device memory {peak_gib:.2f} GiB",
              flush=True)
        print(f"[scone_pretrain] launches {counts}; vis losses computed "
              f"{steps['vis']}", flush=True)
        print(f"[scone_pretrain] losses {losses}; test mean coverages "
              f"{results['mean_coverages']}", flush=True)

        for name in PRETRAIN_KERNELS:
            if counts[name] <= 0:
                fail(f"the scone_pretrain phase never launched {name}")
        n_big = sum(f > 4 * 1024 for f in faces.values())
        n_vis_train = (PRETRAIN_EPOCHS + 1) * PRETRAIN_BATCHES
        n_test = len(results["coverages"]) * (p_test.n_view_max - 1)
        want = {"rasterize_tiled": 2 * n_big,
                "sh_visibility": steps["vis"] + n_test,
                "sh_visibility_backward": n_vis_train}
        if any(counts[k] != v for k, v in want.items()):
            fail(f"launches {counts}, not {want}: GT for {n_big} meshes "
                 f"above 4096 faces (FoV and orthographic), {steps['vis']} "
                 f"vis losses ({n_vis_train} trained), {n_test} tester "
                 f"steps")
        for k, v in losses.items():
            if not all(np.isfinite(x).all() for x in v):
                fail(f"{k} losses not finite: {v}")
        for k in ("occ", "vis"):
            if losses[f"{k}_1"][0][:PRETRAIN_EPOCHS] != losses[f"{k}_0"][0]:
                fail(f"the resumed {k} run lost the first epochs' losses")
        for m, cov in results["coverages"].items():
            if not (np.all(np.isfinite(cov)) and np.all(np.diff(cov) >= 0)):
                fail(f"the ShapeNet test's coverage of {m} decreases: {cov}")

        # The assembled MACARONS checkpoint, loaded by the online trainer's
        # set-up (no epoch run) weight for weight.
        mark("assemble")
        scenes = generate_suite(os.path.join(tmp, "scenes"), n_scenes=1)
        t_params = train_params(scenes, 0)
        out = os.path.join(tmp, "weights", "initialized_macarons")
        assembled = generate_macarons_model.assemble(
            t_params, occ_ckpt, vis_ckpt, out=out, device=dev)
        loaded, _ = run_training(Params(dict(
            t_params.to_dict(), pretrained=True, pretrained_model_path=out,
            start_from_scratch=True)), weights_dir=os.path.join(tmp, "mw"),
            device=dev, verbose=False)
        occ_net = pretrain_occ.build_model(p_vis[0]).to(dev)
        vis_net = pretrain_vis.build_vis_model(p_vis[0]).to(dev)
        load_checkpoint(occ_ckpt, occ_net)
        load_checkpoint(vis_ckpt, vis_net)
        for got, want in ((loaded.occ, occ_net), (loaded.vis, vis_net),
                          (assembled.occ, occ_net)):
            sd = got.state_dict()
            if not all(torch.equal(sd[k], v)
                       for k, v in want.state_dict().items()):
                fail("the assembled MACARONS checkpoint does not load the "
                     "pretrained networks weight for weight")
        mark("hold")
        print("[scone_pretrain] the assembled MACARONS checkpoint loads in "
              "run_training (pretrained: true) weight for weight", flush=True)

        share = hold_gt(root, models[0])
        rs = np.random.default_rng(SEED)
        train_paths = [os.path.join(root, m) for m in models[:3]]
        X_cam = pretrain_occ.step_constants(p_occ[0], "cpu").X_cam.numpy()
        # The occ step on 1,000 of the config's 6,000 queries (the CPU's
        # float64 run).
        occ_batch = datasets.assemble_occ_batch(
            rs, train_paths, X_cam, p_occ[0].n_view_min,
            p_occ[0].n_view_max, p_occ[0].seq_len,
            min(1000, p_occ[0].n_sample))
        occ_errs = hold_pretrain_step("occ", p_occ[0], occ_net, None,
                                      occ_batch)
        print(f"[scone_pretrain] occ step (B 3, 1,000 queries), card against "
              f"CPU: {occ_errs}", flush=True)
        # The vis step with fewer proxies on all three runs (the CPU's
        # float64 SconeOcc would take minutes over 100,000 of them): 5,000,
        # the Monte-Carlo sample drawn uniformly among them. The briefly
        # trained SconeOcc predicts no occupancy above 0.1 (its vis losses
        # above stay at 1: no proxy to sample, no gain, no gradient); the
        # hold's SconeOcc is drawn from a seed, its last bias raised by 1,
        # so that every item samples hundreds of proxies.
        p_hold = Params(dict(p_vis[0].to_dict(), n_proxy_points=5000))
        hold_occ = init_weights(pretrain_occ.build_model(p_hold).to(dev),
                                make_generator(dev, SEED))
        with torch.no_grad():
            hold_occ.Dense_2.bias += 1.0
        # Every item sees all n_view_max views, none at a pole: a padded
        # view is candidate 0, at a pole, and its look-at in the prediction
        # box is ill-conditioned, so that the card and the CPU filter other
        # proxies with it (one item's gains 10 % apart on the H100).
        n_cam, n_view = X_cam.shape[0], p_hold.n_view_max
        vis_batch = pretrain_vis.assemble_vis_batch(
            rs, train_paths, X_cam, p_hold, n_views=[n_view] * 3,
            view_sequences=[rs.permutation(np.arange(1, n_cam - 1))[:n_view]
                            for _ in train_paths])
        g = torch.Generator().manual_seed(SEED)
        draws = {"X": torch.rand(3, p_hold.n_proxy_points, 3, generator=g)
                 - 0.5,
                 "sample_idx": torch.randint(p_hold.n_proxy_points,
                                             (3, p_hold.seq_len),
                                             generator=g)}
        vis_errs = hold_pretrain_step("vis", p_hold, vis_net, hold_occ,
                                      vis_batch, draws)
        mark("end")
        torch.cuda.synchronize()
        assembly = timer["assemble"].elapsed_time(timer["hold"]) / 1e3
        holds = timer["hold"].elapsed_time(timer["end"]) / 1e3
        print(f"[scone_pretrain] vis step (B 3, B3 at (3, 52, 2048)), card "
              f"against CPU: {vis_errs} (assembly {assembly:.2f} s, GT hold "
              f"and steps {holds:.2f} s)", flush=True)
        cfg = shapenet.ShapeNetGTConfig()
        fov = shapenet.candidate_cameras(cfg, "cuda")[1]
        ortho = shapenet.ortho_cameras(cfg, "cuda")
        # Each mesh above 4096 faces launched the kernel once per camera
        # kind.
        rows = [gt_raster_row(root, models[0], fov,
                              "GT, 52 FoV cameras, 512x512", n_big),
                gt_raster_row(root, models[0], ortho,
                              "GT, 6 orthographic cameras, 512x512", n_big)]
    return dict(counts=counts, rows=rows, gt_share=share)


class counting:
    """Counts the calls of ``module.name`` into ``steps[key]`` while the
    block runs."""

    def __init__(self, module, name, steps, key):
        self.module, self.name, self.steps, self.key = (module, name, steps,
                                                        key)

    def __enter__(self):
        self.own = getattr(self.module, self.name)

        def call(*args, **kw):
            self.steps[self.key] += 1
            return self.own(*args, **kw)

        setattr(self.module, self.name, call)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.own)


def pretrain_sh_rows(gen, counts, worst, worst_backward):
    """B3 and its backward at the coverage-gain pretrainer's shape
    (3, 52, 2048) and B3 at the ShapeNet tester's (1, 52, 2048): held
    against their plain versions and timed, with the launch floor; their
    launches are the scone_pretrain phase's at each shape."""
    shape = (3, 52, 2048)
    fwd = kernel_row(gen, launches_at(counts, shape), worst, shape,
                     "pretraining")
    tester = kernel_row(gen, launches_at(counts, (1, 52, 2048)), worst,
                        (1, 52, 2048), "ShapeNet tester")
    t = backward_times(gen, *shape)
    if not t["max_abs_err"] <= BACKWARD_REL:
        fail(f"sh_visibility_backward {shape} differs from its plain "
             f"version by {t['max_abs_err']} of max |grad|")
    floor = launch_floor_ms()
    print(f"[kernel] sh_visibility_backward {shape}: max |kernel - plain| "
          f"{t['max_abs_err']:.3e} of max |grad|, kernel "
          f"{t['ms'] * 1e3:.2f} us (torch.profiler), {t['host_ms'] * 1e3:.2f} "
          f"us per call (CUDA events), plain {t['plain_ms'] * 1e3:.2f} us, "
          f"bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}), launch "
          f"floor {floor * 1e3:.2f} us", flush=True)
    bwd = dict(t, name="sh_visibility_backward (pretraining, 3x52x2048)",
               route="cuda",
               source="macarons_tpu_torch/csrc/sh_visibility.cu",
               replaces="macarons_tpu/ops/pallas/sh_visibility.py:133",
               launches=counts["sh_visibility_backward"],
               max_abs_err=max(worst_backward, t["max_abs_err"]),
               library_ms=None, launch_floor_ms=floor)
    return [fwd, tester, bwd]


# ---------------------------------------------------------------------------
# Scene data (settings.json, occupied poses) and depth pretraining
# ---------------------------------------------------------------------------

# compute_occupied_poses' threshold and the CLI's image size.
OCC_THRESHOLD = 1e-3
OCC_SIZE = (64, 64)
# The closed cube (12 faces) subdivided 5 times: 12,288 faces, above the
# 4096 at which capture takes the tiled path.
CUBE_LEVELS = 5
# The JAX package's occupied-pose test lattice (tests/test_scene_data_gen.py).
CUBE_LATTICE = (np.array([-3.0, -3, -3]), np.array([3.0, 3, 3]), 3, 3, 3, 3,
                8)
CUBE_CORNERS = [(i, j, k) for i in (0, 2) for j in (0, 2) for k in (0, 2)]


def closed_cube(half=1.0) -> Mesh:
    """A cube of 8 vertices and 12 outward faces (tests/test_rasterizer.py's
    cube)."""
    v = np.array([[x, y, z] for x in (-half, half) for y in (-half, half)
                  for z in (-half, half)], np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    f = [t for a, b, c, d in quads for t in ((a, b, c), (a, c, d))]
    return Mesh(v, np.array(f, np.int32))


class tiled_on_cpu:
    """While the block runs, ops.rasterizer.rasterize (and so render_mesh)
    takes the tiled path on any device: on CPU tensors its plain version,
    which the card's kernel matches bit for bit, where "auto" would take the
    binned path (which truncates other faces of an overflowing tile)."""

    def __enter__(self):
        self.own = rast.rasterize
        rast.rasterize = functools.partial(self.own, method="tiled")

    def __exit__(self, *exc):
        rast.rasterize = self.own


def pairs_over_cap(verts, faces, pose, face_mask=None):
    """The (tile, face) pairs K_cap truncation drops from a pose's render at
    OCC_SIZE (the tiled path keeps each tile's K_cap smallest face ids)."""
    f9 = rast.project_fv_batch(verts, faces,
                               pose_camera(pose, device=verts.device))
    counts = rast._pairlist_pairs(f9, OCC_SIZE, TILE, face_mask=face_mask)[2]
    return int((counts.long() - rast.k_cap(1024, f9.shape[2]))
               .clamp(min=0).sum())


def masked_faces_win(verts, faces, poses):
    """Pixels that a face culled by front_face_mask wins in the culled
    render of each pose, on the card (the 64-bit atomicMin merge must never
    let one through): their total."""
    bad = 0
    for pose in poses:
        cam = pose_camera(pose, device=verts.device)
        mask = rast.front_face_mask(verts, faces, cam)
        fid = rast.rasterize(verts, faces, cam, OCC_SIZE,
                             perspective_correct=False,
                             face_mask=mask).pix_to_face
        bad += int((~mask[fid.clamp(min=0)] & (fid >= 0)).sum())
    return bad


def hold_occupied(label, card, cpu):
    """The card's occupied poses against the CPU's tiled plain path: the
    same positions, resampled poses and flags. Prints the smallest margin
    |diff - threshold| and the largest card-vs-CPU |diff|."""
    if not (np.array_equal(card["X_idx"], cpu["X_idx"])
            and np.array_equal(card["poses"], cpu["poses"])):
        fail(f"[scene_data] {label}: the card and the CPU took other poses")
    margin = float(np.abs(card["diff"] - OCC_THRESHOLD).min())
    gap = float(np.abs(card["diff"] - cpu["diff"]).max())
    differ = np.flatnonzero(card["occupied"] != cpu["occupied"])
    print(f"[scene_data] {label}: {len(card['X_idx'])} positions, "
          f"{int(card['occupied'].sum())} occupied; card against CPU (tiled "
          f"plain path): flags {'identical' if not len(differ) else differ}, "
          f"poses identical, max |diff card - diff CPU| {gap:.3e}, smallest "
          f"margin |diff - {OCC_THRESHOLD}| {margin:.3e}", flush=True)
    if len(differ):
        fail(f"[scene_data] {label}: the card's occupied flags differ from "
             f"the CPU's at {card['X_idx'][differ].tolist()}")
    return margin, gap


def occupied_raster_row(verts, faces, pose, launches):
    """B1 + B2 (the fused rasterize_tiled) at the occupied-pose shape: one
    camera at OCC_SIZE with its front-face mask, held against its plain
    version, then timed."""
    cam = pose_camera(pose, device=verts.device)
    f9 = rast.project_fv_batch(verts, faces, cam)
    mask = rast.front_face_mask(verts, faces, cam)
    K_cap = rast.k_cap(1024, f9.shape[2])
    args = raster_args(f9, OCC_SIZE, K_cap, False, face_mask=mask)[2]
    err, cover = hold_raster("rasterize_tiled", tr.rasterize_tiled,
                             tr.rasterize_tiled_plain, args)
    n_p, _, n_l, _ = tr.item_table(args[2], args[3], args[1].shape[0],
                                   K_cap, args[5], args[6])
    n_pairs, n_lanes = int(n_p.sum()), int(n_l.sum())
    counts = args[3].long()
    R, P = counts.shape[0], TILE * TILE
    plain_ms = median_ms(lambda: tr.rasterize_tiled_plain(*args), reps=3)[0]
    dev_ms, per = profiled_device_ms(lambda: tr.rasterize_tiled(*args),
                                     "raster_tiled_kernel")
    path_ms = median_ms(lambda: rast._rasterize_tiled(
        f9, OCC_SIZE, TILE, 1024, False, face_mask=mask))
    t_ops = tr.tiled_flops(n_pairs, n_lanes, R, P) / PEAK_FP32_FLOPS * 1e3
    t_bytes = tr.tiled_bytes(n_pairs, n_lanes, R, P) / PEAK_BYTES_PER_S * 1e3
    kernel_ms = sum(v for k, v in per.items() if "raster_tiled_kernel" in k)
    print(f"[kernel] rasterize_tiled, occupied poses (pose {np.round(pose, 3)}"
          f", 1 camera x {OCC_SIZE[0]}x{OCC_SIZE[1]}, {int(mask.sum())} of "
          f"{f9.shape[2]} faces kept by the face mask): {R} tiles, "
          f"{n_pairs} pairs and {n_lanes} big-face lanes tested, "
          f"{int((counts > K_cap).sum())} tiles over K_cap {K_cap}; ids "
          f"identical to the plain version, max |kernel - plain| {err:.3e}, "
          f"covered {cover:.3f}; {dev_ms * 1e3:.2f} us of device time per "
          f"call [kernel {kernel_ms * 1e3:.2f}] (torch.profiler), plain "
          f"{plain_ms:.3f} ms, bound {max(t_ops, t_bytes) * 1e3:.2f} us; the "
          f"whole tiled path (feeder and launch) {path_ms[0]:.3f} ms",
          flush=True)
    return {"name": f"rasterize_tiled (occupied poses, 1 camera x 64x64, "
                    f"face mask, {f9.shape[2]:,} faces)",
            "route": "cuda",
            "source": "macarons_tpu_torch/csrc/tile_raster.cu",
            "replaces": "macarons_tpu/ops/pallas/tile_raster.py:264",
            "replaces_also": "macarons_tpu/ops/pallas/tile_raster.py:320",
            "launches": launches, "max_abs_err": err, "ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "shape": [R, P, n_pairs + n_lanes],
            "kernel_ms": kernel_ms, "path_ms": path_ms[0]}


def phase_scene_data():
    """Scene data as users generate it: the port's generate_scene_data CLI
    (main) on the card over a copy of synth_00 subdivided 4 times (59,392
    faces; its settings.json's pose lattice, which the CLI keeps), then
    compute_occupied_poses on the closed cube subdivided to 12,288 faces
    over the JAX package's 3x3x3 test lattice. Launch counts are set to 0
    before each run and read after it: rasterize_tiled twice per
    position, the two-pass composition never. Each run is held against the
    CPU's tiled plain path (the same poses and flags), no culled face wins
    a pixel of a culled render, the cube's centre is occupied and every
    corner whose render loses no pair to K_cap truncation is free. Returns
    the kernel row of rasterize_tiled at the occupied-pose shape."""
    dev = resolve_device("cuda")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scene_data_",
                                     dir=_work_dir()) as tmp:
        root = scene_scale_suite(os.path.join(tmp, "scenes"), SCENE_LEVELS)
        scene = os.path.join(root, "synth_00")
        mesh = load_obj(os.path.join(scene, "mesh.obj"))
        st = SceneSettings.from_json(os.path.join(scene, "settings.json"))
        ps = PoseSpace(st.pose_x_min, st.pose_x_max, st.pose_l, st.pose_w,
                       st.pose_h, st.pose_n_elev, st.pose_n_azim)
        own = compute_scene_settings(mesh.verts)["camera"]
        print(f"[scene_data] synth_00 subdivided {SCENE_LEVELS} times: "
              f"{len(mesh.faces)} faces; its settings.json lattice "
              f"{st.pose_l}x{st.pose_w}x{st.pose_h} = {ps.dims[:3].prod()} "
              f"positions (compute_scene_settings at pose_step 1 would give "
              f"{own['pose_l']}x{own['pose_w']}x{own['pose_h']})", flush=True)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = generate_scene_data.main(["--data_path", root,
                                        "--device", "cuda"])["synth_00"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        with np.load(os.path.join(scene, "occupied_pose.npz")) as f:
            written = dict(f)
    n = len(out["X_idx"])
    if not (set(written) == {"X_idx", "occupied"}
            and np.array_equal(written["X_idx"], out["X_idx"])
            and np.array_equal(written["occupied"], out["occupied"])):
        fail("[scene_data] occupied_pose.npz does not hold the run's result")
    if counts["rasterize_tiled"] != 2 * n or counts["rasterize_pairs"] \
            or counts["rasterize_tiles"]:
        fail(f"[scene_data] {n} positions launched {counts}: not 2 "
             f"rasterize_tiled per position and no B1 or B2 alone")
    verts = torch.as_tensor(mesh.verts, device=dev)
    faces = torch.as_tensor(mesh.faces, device=dev).long()
    # Device time from a short trace: the 2x2x2 lattice over the same box.
    few = PoseSpace(st.pose_x_min, st.pose_x_max, 2, 2, 2, st.pose_n_elev,
                    st.pose_n_azim)
    dev_ms, per = device_breakdown(
        lambda: compute_occupied_poses(mesh, few, device=dev), iters=1)
    dev_ms, tiled_dev = dev_ms / 8, sum(v for k, v in per.items()
                                        if "raster" in k) / 8
    print(f"[scene_data] generate_scene_data (card): {wall:.2f} s for {n} "
          f"positions, {wall / n * 1e3:.2f} ms per position; device time "
          f"per position {dev_ms:.3f} ms (torch.profiler over 8 positions "
          f"of a 2x2x2 lattice; the tile raster kernels {tiled_dev:.3f} "
          f"ms), so the host holds ~{max(0.0, wall / n * 1e3 - dev_ms):.2f} "
          f"ms of it; launches {counts}", flush=True)
    t1 = time.perf_counter()
    with tiled_on_cpu():
        cpu = compute_occupied_poses(mesh, ps, device="cpu")
    print(f"[scene_data] the CPU's run: {time.perf_counter() - t1:.1f} s",
          flush=True)
    margins = [hold_occupied("synth_00", out, cpu)]

    cube = subdivide(closed_cube(), CUBE_LEVELS)
    cps = PoseSpace(*CUBE_LATTICE)
    torch.cuda.synchronize()
    reset_counts()
    card = compute_occupied_poses(cube, cps, device=dev)
    ccounts = read_counts()
    if ccounts["rasterize_tiled"] != 2 * 27 or ccounts["rasterize_pairs"] \
            or ccounts["rasterize_tiles"]:
        fail(f"[scene_data] the cube's 27 positions launched {ccounts}")
    with tiled_on_cpu():
        cpu = compute_occupied_poses(cube, cps, device="cpu")
    margins.append(hold_occupied(f"cube ({len(cube.faces)} faces)", card,
                                 cpu))
    cverts = torch.as_tensor(cube.verts, device=dev)
    cfaces = torch.as_tensor(cube.faces, device=dev).long()
    flags = {tuple(x): (bool(o), float(d), p) for x, o, d, p in
             zip(card["X_idx"], card["occupied"], card["diff"],
                 card["poses"])}
    corners = {c: (flags[c][0], flags[c][1],
                   pairs_over_cap(cverts, cfaces, flags[c][2]))
               for c in CUBE_CORNERS}
    print(f"[scene_data] cube: centre occupied {flags[(1, 1, 1)][0]}; "
          f"corners (occupied, diff, pairs dropped by K_cap in the plain "
          f"render): {corners}", flush=True)
    if not flags[(1, 1, 1)][0]:
        fail("[scene_data] the cube's centre is not occupied")
    wrong = [c for c, (occ, _, over) in corners.items() if occ and not over]
    if wrong:
        fail(f"[scene_data] cube corners {wrong} are occupied with no pair "
             f"lost to K_cap truncation")
    bad = (masked_faces_win(verts, faces, out["poses"])
           + masked_faces_win(cverts, cfaces, card["poses"]))
    if bad:
        fail(f"[scene_data] {bad} pixels won by faces the mask culls")
    row = occupied_raster_row(verts, faces,
                              out["poses"][int(np.argmax(out["diff"]))],
                              counts["rasterize_tiled"])
    print(f"[scene_data] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return row


def pretrain_depth_params(**extra):
    """The depth pretrainer on the default training config's depth widths
    (256x456, 96 planes, augmentation on), alphas [-2, -1], batch 4, one
    epoch."""
    params = load_params(os.path.join(
        REPO_DIR, "configs/macarons/macarons_default_training_config.json"))
    params.update(dict(dict(alphas=[-2, -1], n_alpha=2, batch_size=4,
                            epochs=1, start_from_scratch=True,
                            depth_model_name="smoke_depth"), **extra))
    return params


def disparities(model, inputs):
    with torch.no_grad():
        return model.eval()(*inputs)[1:]


def depth_step_ms(model, params, batch, alpha):
    """One pretrainer step (depth_loss in train mode, backward, AdamW) on
    a copy of ``model``: (median ms of 5 between CUDA events, peak GiB)."""
    m = copy.deepcopy(model).train()
    opt = torch.optim.AdamW(m.parameters(), lr=1e-4, weight_decay=0.01)
    cfg = pretrain_depth.depth_cfg(params)
    gen = make_generator(torch.device("cuda"), SEED)

    def step():
        loss = depth_loss(m, cfg, batch, alpha, gen=gen)[0]
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = median_ms(step)
    return ms, torch.cuda.max_memory_allocated() / 2**30


def phase_depth_pretrain(frames_dirs, scone):
    """The depth pretrainer as users run it, on the card, over the frames
    the train phase's memory holds: one epoch (learn_pose false), a
    resumed second, and one epoch with learn_pose. Fails unless every loss
    is finite and each checkpoint is written and gives the trained
    network's disparities reloaded both through
    utils.generate_macarons_model (-d) and create_macarons_model. Then:
    one learn_pose step (B 1) held against the CPU by hold_depth_step;
    bfloat16 convolutions at B 1 and B 4 against float32 (the largest
    disparity gap and both times); the batched stem against the split
    calls in eval mode, within 1e-6; the step times at B 4 with and
    without learn_pose and their peak memory."""
    dev = resolve_device("cuda")
    t_phase = time.perf_counter()
    p1 = pretrain_depth_params()
    p2 = pretrain_depth_params(epochs=2, start_from_scratch=False)
    plp = pretrain_depth_params(learn_pose=True,
                                depth_model_name="smoke_depth_pose")
    ds = datasets.RGBDataset(frames_dirs, p1.alphas)
    print(f"[depth_pretrain] {len(ds)} items in {len(frames_dirs)} "
          f"trajectories; {p1.image_height}x{p1.image_width}, {p1.n_depth} "
          f"planes, alphas {p1.alphas}, batch {p1.batch_size}, augmentation "
          f"{p1.data_augmentation}", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_depth_",
                                     dir=_work_dir()) as tmp:
        wdir = os.path.join(tmp, "weights")
        runs = {}
        for label, params in (("epoch 0", p1), ("resumed epoch 1", p2),
                              ("learn_pose epoch 0", plp)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model, losses = pretrain_depth.run_training(
                params, frames_dirs, wdir, device=dev, verbose=False)
            torch.cuda.synchronize()
            runs[label] = (model, losses)
            print(f"[depth_pretrain] {label}: losses {losses}, "
                  f"{time.perf_counter() - t0:.2f} s, peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
                  flush=True)
            if not all(np.isfinite(v) and v > 0 for v in losses):
                fail(f"[depth_pretrain] {label}: losses {losses}")
        if (len(runs["epoch 0"][1]) != 1 or len(runs["resumed epoch 1"][1])
                != 2 or runs["resumed epoch 1"][1][0]
                != runs["epoch 0"][1][0]):
            fail("[depth_pretrain] the resumed run lost epoch 0's loss")
        items = [ds[i] for i in range(4)]
        batch, alpha = pretrain_depth.load_frame_batch(items, 2, dev)
        inputs = many_depth_inputs(pretrain_depth.depth_cfg(p1), batch, alpha)
        for params, label in ((p2, "resumed epoch 1"),
                              (plp, "learn_pose epoch 0")):
            name = params.depth_model_name
            want = disparities(runs[label][0], inputs)
            for flavour in ("unvalidated", "best_unval"):
                path = os.path.join(wdir, f"{flavour}_{name}")
                if not all(os.path.exists(path + e) for e in (".pt", ".json")):
                    fail(f"[depth_pretrain] {path}.pt/.json not written")
                a = generate_macarons_model.assemble(params, depth_ckpt=path,
                                                     device=dev).depth
                b = create_macarons_model(params, dev).depth
                load_checkpoint(path, b)
                da, db = disparities(a, inputs), disparities(b, inputs)
                if not all(torch.equal(x, y) for x, y in zip(da, db)):
                    fail(f"[depth_pretrain] {path} reloads to other "
                         f"disparities through its two routes")
                if flavour == "unvalidated" and not all(
                        torch.equal(x, y) for x, y in zip(da, want)):
                    fail(f"[depth_pretrain] {path} does not hold the trained "
                         f"network")
        print("[depth_pretrain] the checkpoints (unvalidated_, best_unval_; "
              "without and with learn_pose) reload through "
              "generate_macarons_model -d and create_macarons_model to the "
              "trained disparities", flush=True)

    lp_model = runs["learn_pose epoch 0"][0]
    t0 = time.perf_counter()
    herr = hold_depth_step(plp, MacaronsModel(scone.occ, scone.vis, lp_model),
                           {k: v[:1] for k, v in batch.items()},
                           {k: v[:1] for k, v in alpha.items()})
    print(f"[depth_pretrain] learn_pose step B 1, card against CPU: {herr} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    f32 = runs["resumed epoch 1"][0].eval()
    bf16 = create_many_depth(pretrain_depth_params(
        depth_compute_dtype="bfloat16"), dev)
    bf16.load_state_dict(f32.state_dict())
    for B in (1, 4):
        sub = tuple(t[:B] for t in inputs)
        gap = max(float((x - y).abs().max()) for x, y in
                  zip(disparities(bf16, sub), disparities(f32, sub)))
        t32 = median_ms(lambda: disparities(f32, sub))
        t16 = median_ms(lambda: disparities(bf16, sub))
        print(f"[depth_pretrain] bfloat16 forward B {B}: max |disp bf16 - "
              f"disp f32| {gap:.3e}; {t16[0]:.2f} ms against float32's "
              f"{t32[0]:.2f} ms (median of 5 between CUDA events)",
              flush=True)
        if not np.isfinite(gap):
            fail("[depth_pretrain] the bfloat16 disparities are not finite")
    batched = copy.deepcopy(f32)
    batched.depth_decoder.batched_stem = True
    gap = max(float((x - y).abs().max()) for x, y in
              zip(disparities(batched, inputs), disparities(f32, inputs)))
    print(f"[depth_pretrain] batched stem at B 4 against the split calls: "
          f"max |disp| gap {gap:.3e}", flush=True)
    if not gap <= 1e-6:
        fail(f"[depth_pretrain] the batched stem differs by {gap}")
    for label, model, params in (("without learn_pose", f32, p1),
                                 ("with learn_pose", lp_model, plp)):
        ms, peak = depth_step_ms(model, params, batch, alpha)
        print(f"[depth_pretrain] step at B 4 {label}: {ms[0]:.2f} ms "
              f"({ms[1]:.2f}-{ms[2]:.2f}, median of 5 between CUDA events), "
              f"peak {peak:.2f} GiB", flush=True)
    print(f"[depth_pretrain] phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# The demos, the tester's exports and the shared-sample agreement tool
# ---------------------------------------------------------------------------

DEMO_STEPS = 3
AGREEMENT_TRIALS = 5
SCONE_DEMO_GT_SIZE = 128
# The parts whose captures are moves of the default test config.
DEMO_MOVES = ("macarons demo", "tester exports", "DemoSession")
# Each part of phase_demos and the kernels it must launch.
DEMO_KERNELS = {"macarons demo": ("rasterize_tiled", "sh_visibility"),
                "tester exports": ("rasterize_tiled", "sh_visibility"),
                "DemoSession": ("sh_visibility",),
                "scone demo": ("rasterize_tiled", "sh_visibility"),
                "agreement tool": ("sh_visibility",)}


def read_ply_vertices(path):
    """The vertex count an ASCII PLY declares, held against its lines."""
    with open(path) as f:
        lines = f.read().splitlines()
    n = int(lines[2].split()[-1])
    body = lines[lines.index("end_header") + 1:]
    if len(body) != n or any(len(row.split()) != 3 for row in body):
        fail(f"{path}: {len(body)} rows for {n} declared vertices")
    return n


def check_coverages(label, cov):
    cov = np.asarray(cov, np.float64)
    if not (np.all(np.isfinite(cov)) and cov.min() >= 0.0 and cov.max() <= 1.0
            and np.all(np.diff(cov) >= -1e-6)):
        fail(f"the {label}'s coverages are not in [0, 1] and "
             f"non-decreasing: {cov.tolist()}")


def phase_demos():
    """The port's last modules, through their entry points, on the card:
    the macarons demo's run part (demos/macarons_demo.run) with the
    default test config (smoke_params: ManyDepth and the predicted field,
    random weights from its torch_seed) for DEMO_STEPS NBV steps on the
    59,392-face synth_00, its PLY read back (one vertex per valid surface
    point) and its camera curves (one entry per pose it moved to); the
    tester's run_test with export_results (2 poses, 1 start), its files
    read back; a DemoSession (demos/interactive_demo): step, step, reset,
    then one step under utils/profiling.profile_trace, whose trace must
    name sh_visibility_kernel; the scone demo's run part on suite mesh 0
    in ShapeNet's layout (GT at 128x128); the shared-sample agreement tool
    (data/shared_sample_agreement) with --trials 5 --bench. Each part runs
    with the launch counts set to 0 just before it and read just after,
    and fails unless it launched the kernels DEMO_KERNELS names. Then the
    fused raster's rows at the demos' shapes. Returns the counts and times
    per part and the rows."""
    from macarons_tpu_torch.data import shared_sample_agreement
    from macarons_tpu_torch.demos import interactive_demo, macarons_demo, \
        scone_demo
    from macarons_tpu_torch.testers import scene as scene_tester
    from macarons_tpu_torch.utils.profiling import profile_trace

    dev = resolve_device("cuda")
    counts, seconds = {}, {}

    @contextlib.contextmanager
    def part(name):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        counts[name] = read_counts()
        for kernel in DEMO_KERNELS[name]:
            if counts[name][kernel] <= 0:
                fail(f"the {name} never launched the {kernel} kernel: "
                     f"{counts[name]}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_demos_",
                                     dir=_work_dir()) as tmp:
        root = scene_scale_suite(os.path.join(tmp, "scenes"), SCENE_LEVELS)
        params = smoke_params(root, fixture=False)
        out = os.path.join(tmp, "demo")
        with part("macarons demo"):
            traj, scene = macarons_demo.run(params, root, "synth_00",
                                            n_steps=DEMO_STEPS, out=out,
                                            device=dev, verbose=False)
        check_coverages("macarons demo", traj["coverage"])
        with open(os.path.join(out, "trajectory.json")) as f:
            if json.load(f) != json.loads(json.dumps(traj)):
                fail("the demo's trajectory.json is not its trajectory")
        valid = int(scene.surface_scene.valid.sum())
        n_ply = read_ply_vertices(os.path.join(out, "exports",
                                               "surface.ply"))
        with open(os.path.join(out, "exports", "cameras.json")) as f:
            curves = json.load(f)
        if n_ply != valid or n_ply == 0:
            fail(f"the demo's PLY holds {n_ply} vertices, the surface "
                 f"{valid} valid points")
        if not len(curves["camera_X"]) == len(curves["camera_look"]) \
                == DEMO_STEPS:
            fail(f"the demo's camera curves hold {len(curves['camera_X'])} "
                 f"entries for {DEMO_STEPS} poses")

        results_dir = os.path.join(tmp, "results")
        with part("tester exports"):
            results = scene_tester.run_test(
                Params(dict(params.to_dict(), export_results=True)),
                data_path=root, results_dir=results_dir, n_start_poses=1,
                n_poses=2, device=dev, verbose=False)
        check_coverages("tester", results["synth_00"]["0"]["coverage"])
        edir = os.path.join(results_dir, "exports", "synth_00")
        with open(os.path.join(edir, "start_0_cameras.json")) as f:
            tester_curves = json.load(f)
        n_tester_ply = read_ply_vertices(os.path.join(
            edir, "start_0_surface.ply"))
        if not (tester_curves["camera_X"] and n_tester_ply > 0):
            fail(f"the tester's exports are empty: {n_tester_ply} vertices")

        item = SceneDataset(root)[0]
        model = macarons_demo.load_model(params, None, dev,
                                         make_generator(dev, 0), False)
        with part("DemoSession"):
            session = interactive_demo.DemoSession(
                params, item, os.path.join(tmp, "session"), model, dev)
            session.step()
            session.step()
            stepped = (session.pose, list(session.coverages))
            session.reset()
        if stepped[0] != 2 or session.pose != 0 or session.coverages:
            fail(f"DemoSession's pose counters: {stepped[0]} after two "
                 f"steps, {session.pose} after reset")
        check_coverages("DemoSession", stepped[1])
        trace_dir = os.path.join(tmp, "trace")
        t0 = time.perf_counter()
        with profile_trace(trace_dir):
            session.step()
            torch.cuda.synchronize()
        seconds["profiled step"] = time.perf_counter() - t0
        traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
        named = sum(open(t).read().count("sh_visibility_kernel")
                    for t in traces)
        print(f"[demos] a DemoSession step under profile_trace: "
              f"{len(traces)} trace, sh_visibility_kernel named {named} "
              f"times", flush=True)
        if not named:
            fail("profile_trace's trace of a demo step does not name "
                 "sh_visibility_kernel")

        suite = os.path.join(tmp, "shapenet")
        mesh_name = shapenet_mesh(suite, 0)
        mesh = os.path.join(suite, mesh_name)
        with part("scone demo"):
            cov, views, _, _ = scone_demo.run(
                mesh, out=os.path.join(tmp, "scone_demo"),
                gt_image_size=SCONE_DEMO_GT_SIZE,
                device=dev, verbose=False)
        check_coverages("scone demo", cov)

        with part("agreement tool"):
            agreement = shared_sample_agreement.main(
                ["--trials", str(AGREEMENT_TRIALS), "--bench"])

        # The fused raster at the demos' own shapes, timed after the parts:
        # the moves of the macarons demo, the tester and the DemoSession
        # (n_interpolation_steps frames of the default test config on the
        # 59,392-face scene), timed at the macarons demo's first move; the
        # scone demo's GT at 128x128, one capture per camera kind.
        moves = sum(counts[p]["rasterize_tiled"] for p in DEMO_MOVES)
        f9, size, _ = first_move(traj, scene, params)
        rows = [tiled_row(f9, size, "demos' moves, the macarons demo's "
                          "first", moves)]
        if counts["scone demo"]["rasterize_tiled"] != 2:
            fail("the scone demo's GT did not capture once per camera "
                 f"kind: {counts['scone demo']}")
        cfg = shapenet.ShapeNetGTConfig()
        rows += [gt_raster_row(suite, mesh_name, cams, label, 1,
                               SCONE_DEMO_GT_SIZE)
                 for cams, label in (
                     (shapenet.candidate_cameras(cfg, "cuda")[1],
                      "scone demo GT, 52 FoV cameras, 128x128"),
                     (shapenet.ortho_cameras(cfg, "cuda"),
                      "scone demo GT, 6 orthographic cameras, 128x128"))]
    print(f"[demos] seconds per part: "
          f"{ {k: round(v, 2) for k, v in seconds.items()} }; macarons "
          f"demo coverages {traj['coverage']}, PLY {n_ply} vertices; tester "
          f"PLY {n_tester_ply} vertices, {len(tester_curves['camera_X'])} "
          f"camera entries; DemoSession coverages {stepped[1]}; scone demo "
          f"views {views.tolist()}, coverages {cov.tolist()}; agreement "
          f"{agreement}; launches {counts}", flush=True)
    return {"counts": counts, "seconds": seconds, "agreement": agreement,
            "rows": rows}


def demo_rows(gen, demos, worst):
    """B3's forward at every shape phase_demos launched it (its launches
    there, by part), and phase_demos' fused raster rows."""
    at = {}
    for name, c in demos["counts"].items():
        for shape, n in c["sh_visibility_at"].items():
            at.setdefault(shape, {})[name] = n
    rows = [kernel_row(gen, sum(parts.values()), worst, shape,
                       "demos: " + ", ".join(parts))
            for shape, parts in sorted(at.items())]
    return rows + demos["rows"]


def main():
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    gen = make_generator(torch.device("cuda"), SEED)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    phase_build()
    worst = phase_kernels(gen)
    worst_backward = phase_backward_kernel()
    worst_raster = phase_raster_kernels(gen)
    demos = phase_demos()
    small = phase_trajectory(gen, "trajectory", 0, ["sh_visibility"])
    phase_reference(gen, small["rt"], small["model"], small["call"])
    suite = phase_suite_eval()
    state = gen.get_state()
    big = phase_trajectory(gen, "scene scale", SCENE_LEVELS, SCENE_KERNELS)
    if big["counts"]["rasterize_pairs"] or big["counts"]["rasterize_tiles"]:
        fail("the scene-scale capture ran the two-pass composition: "
             f"{big['counts']}")
    phase_determinism(big, state)
    f9, size = phase_scene_render(big)
    phase_depth()
    rows = raster_rows(big["counts"], worst_raster, f9, size)
    # The scorer's first pose: its candidate count varies from pose to pose
    # (the row counts the launches at this one).
    scorer = (big["c_pad"], 1, big["seq_len"])
    rows.append(kernel_row(gen, launches_at(big["counts"], scorer), worst,
                           scorer))
    # The suite's scorer (eval_params: seq_len 512) at its most frequent
    # candidate bucket.
    at = suite["sh_visibility_at"]
    shape = max(at, key=at.get)
    rows.append(kernel_row(gen, at[shape], worst, shape, "suite scorer"))
    # B3's backward at the SCONE step's shapes: the supervision window's
    # cameras, one per candidate batch, or all of them on one shared sample
    # of seq_len points.
    shape = train_params(None, 1)
    n_cams, seq_len = shape.n_interpolation_steps, shape.seq_len
    backward = backward_row(worst_backward, (n_cams, 1, seq_len),
                            (1, n_cams, seq_len))
    keep = tempfile.mkdtemp(prefix="chip_smoke_frames_", dir=_work_dir())
    try:
        train = phase_train(keep)
        if [train["n_cams"], 1, train["seq_len"]] != backward["shape"]:
            fail(f"the SCONE step ran B3 at {train}, not "
                 f"{backward['shape']}")
        backward["launches"] = train["counts"]["sh_visibility_backward"]
        # The SCONE step's forward, one launch per step as its backward.
        step = (train["n_cams"], 1, train["seq_len"])
        scone_row = kernel_row(gen, launches_at(train["counts"], step,
                                                backward["launches"]),
                               worst, step, "SCONE step")
        # The device memory's decision scores every neighbour move.
        decision = (DECISION_CANDIDATES, 1, train["seq_len"])
        rows += [scone_row, backward,
                 kernel_row(gen, launches_at(train["counts"], decision),
                            worst, decision, "device decision"),
                 dict(next(r for r in rows if r["name"] == "rasterize_tiled"),
                      name="rasterize_tiled (train, device memory)",
                      launches=train["counts"]["rasterize_tiled"])]
        phase_depth_pretrain(train["frames_dirs"], train.pop("model"))
    finally:
        shutil.rmtree(keep)
    phase_syncs()
    # The group phase's launches of the train path's kernels, beside the
    # rows measured above at the same shapes.
    group = phase_train_group()
    fused = next(r for r in rows if r["name"] == "rasterize_tiled")
    rows += [
        dict(fused, name=f"rasterize_tiled (train group {GROUP})",
             launches=group["rasterize_tiled"]),
        dict(scone_row, name=f"sh_visibility (SCONE step, group {GROUP}, "
             f"{'x'.join(map(str, step))})",
             launches=launches_at(group, step)),
        dict(backward, name=f"sh_visibility_backward (train group {GROUP})",
             launches=group["sh_visibility_backward"])]
    rows.append(phase_scene_data())
    lane = phase_scone_pretrain()
    rows += lane["rows"]
    rows += pretrain_sh_rows(gen, lane["counts"], worst, worst_backward)
    rows += demo_rows(gen, demos, worst)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(json.dumps({"kernels": rows}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--depth-holds", type=int, default=0, metavar="N",
                        help="run only the depth hold, N times from fresh "
                        "draws (phase_depth_holds)")
    parser.add_argument("--group-times", action="store_true",
                        help="run only the timing of scene groups 1, 2 and "
                        "4 (phase_group_times)")
    parser.add_argument("--demos", action="store_true",
                        help="run only the demos, the tester's exports and "
                        "the agreement tool (phase_demos)")
    args = parser.parse_args()
    if args.depth_holds or args.group_times or args.demos:
        if not torch.cuda.is_available():
            fail("CUDA is not available")
        phase_build()
        if args.depth_holds:
            phase_depth_holds(args.depth_holds)
        elif args.demos:
            phase_demos()
        else:
            phase_group_times()
    else:
        main()
