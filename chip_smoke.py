"""GPU smoke run of the PyTorch port (macarons_tpu_torch) on one NVIDIA card.

Usage: python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:
  1. build the CUDA kernels from macarons_tpu_torch/csrc (one nvcc per
     source, all started together);
  2. hold each kernel against its plain PyTorch twin on the card, at edge
     cases; B3's backward kernel (the SCONE step's gradient of the SH
     coefficients) against its plain version at the SCONE step's shapes;
  3. drive the nbv scene-exploration trajectory at the default test config's
     widths on the generated synthetic scene synth_00 (232 faces: scan
     capture), with random SCONE weights from a seed, and check its outputs;
  4. score the trajectory's last candidates again on the card and on the CPU
     (the plain twins) with the same Monte-Carlo sample: the gains agree;
  5. scene-scale capture: the same trajectory on synth_00 subdivided 4 times
     (59,392 faces: tiled capture, one fused launch of the tile raster
     kernel per capture for TPU kernels B1 and B2), then one move's frames
     rasterized on the card and on the CPU (the plain versions): the same
     face ids; the tiled path's time, first call and warm;
  6. depth: the default test config as users run it, on the 59,392-face
     scene: ManyDepth depth at 256x456 with 96 planes and the predicted
     SconeOcc field, random weights for the three networks from a seed, 5
     nbv poses; every disparity in (0, 1), every depth finite and in
     [znear, zfar]; then ManyDepth on the card and on the CPU, same weights,
     on the last decision batch (B 1) and the last supervision batch (B 4):
     the disparities and the depth step's masks agree; ManyDepth's forward
     time at B 1 and B 4;
  7. train: run_training with the default training config on the
     59,392-face scene, epoch 0 (4 poses, a remap at pose 2), then a resumed
     run through epoch 1 with depth and SCONE replay; per-pose phase times,
     the checks of phase_train; one depth step (B 1) and one SCONE step on
     the card against the CPU; the depth step at B 4 and the SCONE step
     timed alone;
  8. time each kernel at the shapes of the scene-scale path (B3's backward
     at the SCONE step's), and hold it against its twin there; time the
     two-pass composition (B1, B2, merge) against the fused launch, in
     turns;
  9. print the kernel table (JSON), the card's name and power limit, and the
     result line {"ok": true, "device": {...}}.
Each trajectory (the train phase: both runs together) runs with every
kernel's launch count set to 0 just before it and read just after. Needs CUDA; never falls back to the CPU.
"""

import copy
import dataclasses
import functools
import gc
import json
import os
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
from macarons_tpu_torch.data.mesh_io import Mesh, load_obj, save_obj
from macarons_tpu_torch.data.scenes import SceneDataset
from macarons_tpu_torch.data.synthetic_suite import generate_suite
from macarons_tpu_torch.models.macarons import (
    MacaronsModel,
    create_macarons_model,
    create_optimizers,
    init_macarons_weights,
    load_macarons,
)
from macarons_tpu_torch.ops import rasterizer as rast
from macarons_tpu_torch.ops.cuda import sh_visibility as shv
from macarons_tpu_torch.ops.cuda import tile_raster as tr
from macarons_tpu_torch.ops.cuda.build import BUILD_DIR
from macarons_tpu_torch.ops.geometry import FoVCamera, look_at_view_transform
from macarons_tpu_torch.ops.projection import disparity_to_depth
from macarons_tpu_torch.scene.camera import get_camera_RT
from macarons_tpu_torch.scene.depth_runtime import (
    depth_masks,
    error_table,
    many_depth_inputs,
)
from macarons_tpu_torch.scene.memory import Memory
from macarons_tpu_torch.testers.scene import compute_trajectory
from macarons_tpu_torch.trainers.train_macarons import (
    MacaronsRuntime,
    run_training,
    seeded_generator,
    setup_scene,
)
from macarons_tpu_torch.utils.device import make_generator, resolve_device

REPO_DIR = os.path.dirname(os.path.abspath(__file__))
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
    fewer than ``iters``. Returns (ms per call, {kernel: ms per call});
    a trace that holds no device time for ``kernel_name`` is taken once
    more (one did, after the train phase: PERF.md §6), and a second
    such trace fails the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
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
            if us and e.count:
                per[e.key] = us / 1e3 / e.count
        if any(kernel_name in k for k in per):
            return sum(per.values()), per
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


def read_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def phase_build():
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        for job in [pool.submit(m.build, verbose=True) for m in (shv, tr)]:
            job.result()
    print(f"[build] sh_visibility and tile_raster built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def phase_kernels(gen):
    """Kernel vs plain twin at the scorer's shapes and at edge cases."""
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

    for i in range(N_POSES):
        print(f"{tag} pose {i}: decision "
              f"{span(i, 'decision', 'capture'):.2f} ms (depth + mapping "
              f"{span(i, 'decision', 'field'):.2f}, occupancy field "
              f"{span(i, 'field', 'score'):.2f}, scoring "
              f"{span(i, 'score', 'capture'):.2f}), capture "
              f"{span(i, 'capture', 'done'):.2f} ms, coverage "
              f"{traj['coverage'][i + 1]:.4f}, candidates "
              f"{cand_shapes[i][0]}", flush=True)
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
                disps=disps, peak_gib=peak_gib)


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


def raster_args(f9, size, K_cap, pc):
    """The arguments of B1 (rasterize_pairs), B2 (rasterize_tiles) and of
    the fused rasterize_tiled for the tiled path of faces f9 (N, 9, F), as
    ops.rasterizer._rasterize_tiled builds them."""
    H, W = size
    TH, TW = rast._tiles(H, W, TILE)
    pface, starts, counts, big = rast._pairlist_pairs(f9, size, TILE)
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


def phase_scene_render(run):
    """One move of the scene-scale trajectory rasterized on the card and on
    the CPU through the tiled path (kernels vs plain twins). From the same
    projected faces the face ids must be identical. From each device's own
    projection (the matmuls round differently) a pixel may change face where
    two faces tie within ulps: on the edges shared by the subdivided mesh's
    coplanar neighbours. That share is printed and must stay below 1e-3."""
    traj, scene, params = run["traj"], run["scene"], run["params"]
    steps = params.n_interpolation_steps
    X = torch.tensor(traj["X_cam"][1:1 + steps], device="cuda")
    V = torch.tensor(traj["V_cam"][1:1 + steps], device="cuda")
    R, T = get_camera_RT(X, V)
    cam = FoVCamera.create(R, T, zfar=params.zfar)
    size = (params.image_height, params.image_width)
    f9 = rast.project_fv_batch(scene.verts_dev, scene.faces_dev, cam)
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
    entered, and keeps the arguments of the last online depth step and of
    every online SCONE step. ``on_phase`` is the trainer's phase hook: it
    also records a CUDA event at every phase boundary."""

    def __init__(self):
        self.epoch, self.phase = None, None
        self.steps = {}
        self.events = {}
        self.depth_call = None
        self.scone_calls = []

    def on_phase(self, epoch, pose_i, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events[(epoch, pose_i, name)] = ev
        self.epoch, self.phase = epoch, name

    def __enter__(self):
        self.saved = (MacaronsRuntime.depth_train_step,
                      MacaronsRuntime.scone_train_step)
        depth_step, scone_step = self.saved

        def count(kind):
            key = (self.epoch, self.phase, kind)
            self.steps[key] = self.steps.get(key, 0) + 1

        def depth(rt, opt, batch, alpha, **kw):
            count("depth")
            if self.phase == "depth_step":
                self.depth_call = (rt, batch, alpha)
            return depth_step(rt, opt, batch, alpha, **kw)

        def scone(rt, *args, **kw):
            count("scone")
            if self.phase == "scone_step":
                self.scone_calls.append((rt, args, kw))
            return scone_step(rt, *args, **kw)

        MacaronsRuntime.depth_train_step = depth
        MacaronsRuntime.scone_train_step = scone
        return self

    def __exit__(self, *exc):
        (MacaronsRuntime.depth_train_step,
         MacaronsRuntime.scone_train_step) = self.saved

    def count(self, epoch, phase, kind):
        return self.steps.get((epoch, phase, kind), 0)

    def span(self, epoch, pose_i, a, b):
        return self.events[(epoch, pose_i, a)].elapsed_time(
            self.events[(epoch, pose_i, b)])


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


# The optimizer steps are run three times from one state: on the card and
# on the CPU in float32, and on the CPU in float64 as the reference. The
# depth step's float32 gradients are ill-conditioned (BatchNorm in train
# mode over one frame: the card's and the CPU's differed by 0.6-1.5 % of
# max |g| with their losses within 2e-5, PERF.md §6), so the card is held
# to be no further from the float64 gradient than FP32_SLACK times the
# CPU's float32 is (or STEP_REL, whichever is larger).
FP32_SLACK = 3.0
RUNS = (("cuda", torch.float32), ("cpu", torch.float32),
        ("cpu", torch.float64))


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


def fp32_errors(out, nets):
    """Per network: the card's and the CPU's float32 gradient error against
    the float64 one; fails unless the card's is within the slack."""
    ref, card, cpu = out[RUNS[2]], out[RUNS[0]], out[RUNS[1]]
    errs = {}
    for name in nets:
        e_card = grad_error(card[name], ref[name])
        e_cpu = grad_error(cpu[name], ref[name])
        errs[f"{name}_grad_card"], errs[f"{name}_grad_cpu"] = e_card, e_cpu
        if not e_card <= max(STEP_REL, FP32_SLACK * e_cpu):
            fail(f"the {name} gradient on the card is further from the "
                 f"float64 one than the CPU's float32: {errs}")
    return errs


def hold_depth_step(params, model, batch, alpha):
    """One depth optimizer step from one state (the networks of ``model``,
    fresh AdamW, augmentation with fixed draws) in each of RUNS: the card's
    loss within rtol 1e-4 of the CPU's and the running statistics BatchNorm
    leaves within 1e-5, and its gradient as close to the float64 one as
    fp32_errors asks. Returns the errors."""
    draws = {"jitter": True, "symmetry": True,
             "factors": (1.1, 0.9, 1.05, 0.03)}
    out = {}
    for dev, dt in RUNS:
        def step():
            m = MacaronsModel(*(net_copy(n, dev, dt) for n in
                                (model.occ, model.vis, model.depth)))
            opts = create_optimizers(params, m)
            loss = MacaronsRuntime(params, m, device=dev).depth_train_step(
                opts["depth"], _to(batch, dev, dt), _to(alpha, dev, dt),
                draws=draws)[0]
            return {"loss": float(loss), "depth": grads_of(m.depth),
                    "stats": {k: v.cpu().double() for k, v in
                              m.depth.named_buffers()
                              if v.is_floating_point()}}
        out[(dev, dt)] = in_dtype(dt, step)
    card, cpu = out[RUNS[0]], out[RUNS[1]]
    errs = {"loss_rel": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
            "stats_rel": max(float((card["stats"][k] - v).abs().max())
                             / max(float(v.abs().max()), 1e-30)
                             for k, v in cpu["stats"].items())}
    if not (np.isfinite(card["loss"]) and errs["loss_rel"] <= 1e-4
            and errs["stats_rel"] <= 1e-5):
        fail(f"the depth step on the card and on the CPU differ: {errs}")
    errs.update(fp32_errors(out, ["depth"]))
    return errs


def hold_scone_step(params, model, rt, args, kw, gen, n_cells_active=5):
    """One SCONE optimizer step from one state in each of RUNS: ``args``/
    ``kw`` are a recorded scone_train_step call; the cell-ranking noise and
    the Monte-Carlo sample (points drawn among the occupied ones) are drawn
    once and given to every run. The card's losses within rtol 1e-3 of the
    CPU's (SconeOcc's kNN and both networks' attention reduce in another
    order), its gradients of SconeOcc and SconeVis as close to the float64
    ones as fp32_errors asks, and one launch of the B3 backward kernel.
    Returns the errors."""
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
              cell_noise=torch.rand(rt._tables.slots.shape[0], device="cuda",
                                    generator=gen),
              sample_idx=pool[torch.randint(
                  len(pool), (n_cams, rt.coverage_gain.seq_len),
                  device="cuda", generator=gen)])
    def step(dev, dt):
        m = MacaronsModel(net_copy(model.occ, dev, dt),
                          net_copy(model.vis, dev, dt), None)
        r = MacaronsRuntime(params, m, device=dev)
        r._tables = _to(rt._tables, dev, dt)
        opts = create_optimizers(params, m)
        before = shv.sh_visibility_backward.launches
        losses = r.scone_train_step(opts["scone"], *_to(args, dev, dt),
                                    **_to(kw, dev, dt))
        if (dev == "cuda"
                and shv.sh_visibility_backward.launches != before + 1):
            fail("the SCONE step on the card did not launch the "
                 "sh_visibility backward kernel once")
        return {"losses": [float(v) for v in losses[1:]],
                "occ": grads_of(m.occ), "vis": grads_of(m.vis)}

    out = {(dev, dt): in_dtype(dt, lambda: step(dev, dt))
           for dev, dt in RUNS}
    # What sets the card's gradient error: a second card run tells
    # rounding that changes from run to run (atomic accumulation) from
    # arithmetic the card repeats, and the parameter the largest error
    # sits in says which layer it comes from.
    again = in_dtype(torch.float32, lambda: step(*RUNS[0]))
    ref_occ, card_occ = out[RUNS[2]]["occ"], out[RUNS[0]]["occ"]
    diag = {"occ_card_rerun": grad_error(again["occ"], card_occ),
            "vis_card_rerun": grad_error(again["vis"], out[RUNS[0]]["vis"]),
            "occ_worst_param": max(
                ref_occ, key=lambda k: float((card_occ[k]
                                              - ref_occ[k]).abs().max()))}
    print(f"[train] SCONE step, the card's gradient error: {diag}",
          flush=True)
    card, cpu = out[RUNS[0]]["losses"], out[RUNS[1]]["losses"]
    errs = {"occ_loss": cpu[0], "cov_loss": cpu[1],
            "loss_rel": max(abs(a - b) / max(abs(b), 1e-30)
                            for a, b in zip(card, cpu))}
    if not (all(np.isfinite(card)) and cpu[0] > 0 and cpu[1] > 0
            and errs["loss_rel"] <= 1e-3):
        fail(f"the SCONE step on the card and on the CPU differ: {errs}")
    errs.update(fp32_errors(out, ["occ", "vis"]))
    return errs


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


def phase_train():
    """The online trainer as users run it: run_training with the default
    training config at full widths on the 59,392-face scene (random weights
    from its torch_seed). Epoch 0: TRAIN_POSES poses, a remap at pose
    TRAIN_REMAP, memory trajectory slot 0. Then a second run resumes from
    epoch 0's checkpoint and trains epoch 1 in slot 1, with depth replay
    (n_memory_loops steps of n_memory_samples frames) and SCONE replay
    (n_memory_scene_loops steps) from slot 0 after every pose. Launch
    counts are set to 0 before the first run and read after the second.
    Fails unless the losses are finite with a positive depth loss, the
    three networks moved, both B3 kernels and rasterize_tiled launched,
    the B3 backward once per SCONE step, each trajectory saved 1 + n_alpha
    + poses x interpolation steps frames, and the checkpoint reloads. Then
    one depth step (B 1) and one SCONE step on the card against the CPU."""
    dev = resolve_device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_",
                                     dir=_work_dir()) as tmp:
        root = scene_scale_suite(os.path.join(tmp, "scenes"), SCENE_LEVELS)
        wdir, mroot = os.path.join(tmp, "weights"), os.path.join(tmp, "mem")
        p0, p1 = train_params(root, 1), train_params(root, 2)
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

    for e in (0, 1):
        for i in range(TRAIN_POSES):
            spans = ", ".join(
                f"{a} {rec.span(e, i, a, b):.2f}" for a, b in
                zip(TRAIN_PHASES, TRAIN_PHASES[1:]))
            print(f"[train] epoch {e} pose {i} (ms): {spans}", flush=True)
    steps = {k: v for k, v in sorted(rec.steps.items(),
                                     key=lambda kv: str(kv[0]))}
    print(f"[train] epoch 0 {t1 - t0:.2f} s, epoch 1 (resumed) {t2 - t1:.2f} "
          f"s; peak device memory {peak_gib:.2f} GiB; losses {losses}; "
          f"optimizer steps (epoch, phase, network): {steps}; frames per "
          f"trajectory {n_frames}, remap depths {n_depths}; launches "
          f"{counts}", flush=True)

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
    n_scone = sum(v for (_, _, kind), v in rec.steps.items()
                  if kind == "scone")
    if counts["sh_visibility_backward"] != n_scone:
        fail(f"{counts['sh_visibility_backward']} launches of the B3 "
             f"backward kernel for {n_scone} SCONE steps")
    want = 1 + p0.n_alpha + TRAIN_POSES * p0.n_interpolation_steps
    if n_frames != [want, want]:
        fail(f"frames per trajectory {n_frames}, not {want}")
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

    gen = make_generator(torch.device("cuda"), SEED + 3)
    # The last online depth step's own supervision batch, its first target.
    _, batch, alpha = rec.depth_call
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
                seq_len=p1.seq_len)


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


def kernel_row(gen, launches, worst_err, c_pad, seq_len):
    """Times at the main path's per-candidate shape (C_pad, 1, seq_len)."""
    B, C, L = c_pad, 1, seq_len
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
    print(f"[kernel] sh_visibility ({B},{C},{L}): max |kernel - plain| "
          f"{err:.3e}, kernel {dev_ms * 1e3:.2f} us (torch.profiler), "
          f"{host_ms * 1e3:.2f} us per call (CUDA events, back-to-back calls, "
          f"host launch included)", flush=True)
    # "ms" is the kernel's device time from the profiler; "host_ms" the
    # per-call time between CUDA events, host launch included.
    return {
        "name": "sh_visibility", "route": "cuda",
        "source": "macarons_tpu_torch/csrc/sh_visibility.cu",
        "replaces": "macarons_tpu/ops/pallas/sh_visibility.py:133",
        "launches": launches, "max_abs_err": max(worst_err, err),
        "ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None, "shape": [B, C, L], "host_ms": host_ms,
    }


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


def phase_backward_kernel():
    """B3's backward kernel against its plain version at the SCONE step's
    shapes (4 visited cameras, one per candidate batch: (4, 1, 2048); one
    shared sample: (1, 4, 2048)) and at the poles and the 1e6 pads, both
    activations; and the wrapper refusing points that require grad. Own
    generator: the trajectories after it draw as before."""
    gen = make_generator(torch.device("cuda"), SEED + 4)
    cases = []
    for B, C, L in ((4, 1, 2048), (1, 4, 2048)):
        for sig in (True, False):
            cases.append((f"({B},{C},{L}) {'sigmoid' if sig else 'relu'}",
                          sh_inputs(gen, B, C, L), sig))
    pts, harm, X_cam = sh_inputs(gen, 2, 3, 300)
    pts[:, :100, 0] = X_cam[:, :1, 0]
    pts[:, :100, 2] = X_cam[:, :1, 2]
    pts[:, 100:150, :3] = 1e6
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
    try:
        shv.sh_visibility(pts.detach().requires_grad_(), harm, X_cam)
    except ValueError:
        pass
    else:
        fail("sh_visibility accepted points that require grad")
    return worst


def backward_row(worst, B, C, L):
    """B3's backward at the SCONE step's per-candidate shape (B, C, L);
    its launches are the train phase's, filled in by the caller."""
    gen = make_generator(torch.device("cuda"), SEED + 5)
    p, h, x = sh_inputs(gen, B, C, L)
    out = shv.sh_visibility(p, h, x)
    g = torch.randn(B, C, L, device="cuda", generator=gen)
    err = hold_backward(p, h, x, True, g)
    host_ms = time_ms(lambda: shv.sh_visibility_backward(p, x, out, g))
    plain_ms = time_ms(
        lambda: shv.sh_visibility_backward_plain(p, x, out, g), 10)
    t_ops = shv.backward_flops(B, C, L) / PEAK_FP32_FLOPS * 1e3
    t_bytes = shv.backward_bytes_moved(B, C, L) / PEAK_BYTES_PER_S * 1e3
    dev_ms, _ = profiled_device_ms(
        lambda: shv.sh_visibility_backward(p, x, out, g),
        "sh_visibility_backward_kernel")
    print(f"[kernel] sh_visibility_backward ({B},{C},{L}): max |kernel - "
          f"plain| {err:.3e} of max |grad|, kernel {dev_ms * 1e3:.2f} us "
          f"(torch.profiler), {host_ms * 1e3:.2f} us per call (CUDA events, "
          f"host launch included), plain {plain_ms * 1e3:.2f} us, bound "
          f"{max(t_ops, t_bytes) * 1e3:.2f} us", flush=True)
    return {
        "name": "sh_visibility_backward", "route": "cuda",
        "source": "macarons_tpu_torch/csrc/sh_visibility.cu",
        "replaces": "macarons_tpu/ops/pallas/sh_visibility.py:133",
        "launches": None, "max_abs_err": max(worst, err),
        "ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None, "shape": [B, C, L], "host_ms": host_ms,
    }


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
    small = phase_trajectory(gen, "trajectory", 0, ["sh_visibility"])
    phase_reference(gen, small["rt"], small["model"], small["call"])
    big = phase_trajectory(gen, "scene scale", SCENE_LEVELS, SCENE_KERNELS)
    if big["counts"]["rasterize_pairs"] or big["counts"]["rasterize_tiles"]:
        fail("the scene-scale capture ran the two-pass composition: "
             f"{big['counts']}")
    f9, size = phase_scene_render(big)
    phase_depth()
    rows = raster_rows(big["counts"], worst_raster, f9, size)
    rows.append(kernel_row(gen, big["counts"]["sh_visibility"], worst,
                           big["c_pad"], big["seq_len"]))
    # B3's backward at the SCONE step's shape: the supervision window's
    # cameras, one per candidate batch, and seq_len sampled points.
    shape = train_params(None, 1)
    backward = backward_row(worst_backward, shape.n_interpolation_steps, 1,
                            shape.seq_len)
    train = phase_train()
    if [train["n_cams"], 1, train["seq_len"]] != backward["shape"]:
        fail(f"the SCONE step ran B3 at {train}, not {backward['shape']}")
    backward["launches"] = train["counts"]["sh_visibility_backward"]
    rows.append(backward)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(json.dumps({"kernels": rows}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
