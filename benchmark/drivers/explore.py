"""NBV exploration with frozen weights (traffic mixes whose ``driver`` is
``explore``): the tester's ``testers/scene.compute_trajectory``, policy
nbv, ManyDepth's depth and the predicted SconeOcc field, trajectories run
back to back from the scene's start positions. It is a closed loop: one
agent, each pose decided after the last was captured.

A unit of work is a pose, decision through capture and the supervision
frames' depth. The window's rate is its completed poses over its length,
and its tail that of every pose in it. At a few poses drawn from the seed
the driver records what the program's layers took and gave (ManyDepth's
depth, the occupancy field, the candidates' gains, the pose chosen, the
captured frames); after the window the plain reference recomputes them
(``benchmark/reference/explore.py``)."""

from __future__ import annotations

import gc
import inspect
import itertools
import json
import os
import shutil
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import flops as F
from ..harness import scenes
from ..harness.common import (
    CHECK_STREAM,
    PROGRAM_STREAM,
    Clock,
    Patches,
    StopWindow,
    Tracer,
    generator,
    network_weights,
    quantile,
    stream_seed,
)

# The span that each phase boundary closes, named after its layer.
SPAN_OF = {"field": "depth_mapping", "score": "field", "capture": "score",
           "done": "capture"}
# The span that each phase boundary opens; between poses, the trajectory's
# own set-up and start.
NEXT_SPAN = {"decision": "depth_mapping", "field": "field", "score": "score",
             "capture": "capture", "done": "between_poses"}


def clone(x):
    """A deep copy of the tensors in ``x`` (tuples, lists, dicts, objects
    with tensor attributes)."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(clone(v) for v in x)
    if hasattr(x, "_fields"):
        return {k: clone(getattr(x, k)) for k in x._fields}
    if hasattr(x, "__dataclass_fields__"):
        return {k: clone(getattr(x, k)) for k in x.__dataclass_fields__}
    if isinstance(x, np.ndarray):
        return x.copy()
    return x


class PoseSample:
    """The poses that the check records: ``n`` drawn from the seed,
    uniformly among all the window's poses from ordinal ``first`` on,
    however many the window holds (reservoir sampling). ``slot(k)`` says,
    at pose k's decision, which record pose k would replace, or None."""

    def __init__(self, seed: int, n: int, first: int):
        self.rs = np.random.default_rng(stream_seed(seed, CHECK_STREAM))
        self.n, self.first = n, first

    def slot(self, k: int):
        m = k - self.first
        if m < 0:
            return None
        if m < self.n:
            return m
        j = int(self.rs.integers(0, m + 1))
        return j if j < self.n else None


def setup(ctx):
    from macarons_tpu_torch.config import Params
    from macarons_tpu_torch.data.scenes import SceneDataset
    from macarons_tpu_torch.models import scone as scone_module
    from macarons_tpu_torch.models.macarons import create_macarons_model
    from macarons_tpu_torch.ops import rasterizer as raster_module
    from macarons_tpu_torch.scene import camera as camera_module
    from macarons_tpu_torch.testers import scene as tester
    from macarons_tpu_torch.trainers.train_macarons import MacaronsRuntime
    from macarons_tpu_torch.utils.device import resolve_device

    tr = ctx.traffic
    dev = resolve_device(ctx.device)
    root = scenes.scene_scale_suite(os.path.join(ctx.work_dir, "scenes"),
                                    tr["scene_levels"])
    params = Params({k: v for k, v in ctx.config.items()
                     if not k.startswith("_")})
    params.update(dict(dataset_path=root, data_path=root))
    item = SceneDataset(root)[0]
    model = create_macarons_model(params, dev)
    # The weights and the program's draws come from the configuration's
    # torch_seed, as the tester's own entry point seeds them: in a closed
    # loop they set the path a trajectory takes, and with it the work, so
    # every run does the same work; the run's seed draws what is checked.
    network_weights(params.torch_seed, dev, model.occ, model.vis,
                    model.depth)
    st = SimpleNamespace(
        params=params, model=model, item=item, dev=dev, root=root,
        gen=generator(dev, params.torch_seed, PROGRAM_STREAM),
        rs=np.random.default_rng(stream_seed(params.torch_seed,
                                             PROGRAM_STREAM)),
        tester=tester, rt=None, n_traj=0, counting=False, shapes=[],
        armed=None, slot=None, records=[], trace_shapes=None, tracer=None,
        launches=[], patches=Patches())
    sp = item["settings"].start_positions
    st.starts = [np.asarray(sp[i], np.int64) for i in tr["starts"]]
    st.rt = MacaronsRuntime(params, model, device=dev)
    st.n_poses = params.get("n_poses_in_trajectory", 100)
    st.surface_epsilon = (2.0 * params.get("test_resolution", 0.05)
                          * params.get("scene_scale_factor", 1.0))
    with open(os.path.join(root, "synth_00", "settings.json")) as f:
        st.settings = json.load(f)
    st.mesh_path = os.path.join(root, "synth_00", "mesh.obj")
    _instrument(ctx, st, scone_module, camera_module, tester, raster_module)
    # Warm-up: the first poses of a trajectory from the last start, every
    # shape of a pose (the buckets of candidates come and go) through once,
    # and the profiler's first start.
    trajectory(ctx, st, st.starts[-1], tr["warmup_poses"], None)
    Tracer(ctx.trace).warm()
    return st


def _instrument(ctx, st, scone_module, camera_module, tester,
                raster_module):
    """The benchmark's own wrappers at the layers' boundaries: the shapes
    of the networks' calls (for the model FLOPs), the fused rasterizer's
    launches in the traced stretch (for its roofline) and, at the sampled
    poses, the layers' inputs and outputs. Faults, when planted, alter an
    answer where it is produced."""
    model, rt = st.model, st.rt
    faults = set(ctx.faults)

    def shapes(kind):
        def hook(module, args, kwargs=None):
            if st.counting:
                st.shapes.append((kind, tuple(tuple(a.shape) for a in args
                                              if isinstance(a,
                                                            torch.Tensor))))
        return hook

    model.occ.register_forward_pre_hook(shapes("occ"))
    model.vis.register_forward_pre_hook(shapes("vis"))
    model.depth.register_forward_pre_hook(shapes("depth"))

    def record(key, value):
        if st.armed is not None and key not in st.armed:
            st.armed[key] = value

    depth_fn = rt.apply_depth_inference

    def apply_depth(batch, alpha):
        out = depth_fn(batch, alpha)
        if "depth" in faults:
            out = (out[0] * 1.01,) + tuple(out[1:])
        record("depth", {"batch": clone(batch), "alpha": clone(alpha),
                         "out": clone(out[0])})
        return out

    rt.apply_depth_inference = apply_depth

    field_fn = rt.occupancy_field

    def occupancy_field(proxy, surface, prediction_camera, **kw):
        inputs = None
        if st.armed is not None and "field" not in st.armed:
            inputs = {"proxy": clone(proxy), "surface": clone(surface),
                      "camera": clone(prediction_camera), "kw": dict(kw)}
        out = field_fn(proxy, surface, prediction_camera, **kw)
        if inputs is not None:
            record("field", dict(inputs, out=clone(out)))
        return out

    rt.occupancy_field = occupancy_field

    gains_fn = rt.coverage_gains

    def coverage_gains(*args, **kw):
        inputs = None
        if st.armed is not None and "gains" not in st.armed:
            inputs = {"args": clone(args),
                      "gen_state": kw["generator"].get_state()}
        out = gains_fn(*args, **kw)
        if inputs is not None:
            record("gains", dict(inputs, out=clone(out)))
        return out

    rt.coverage_gains = coverage_gains

    choice_fn = tester.nbv_choice

    def nbv_choice(rt_, scene, fld, valid_nbrs, gen):
        out = choice_fn(rt_, scene, fld, valid_nbrs, gen)
        if "choice" in faults:
            j = int(np.flatnonzero((valid_nbrs == out).all(axis=1))[0])
            out = valid_nbrs[(j + 1) % len(valid_nbrs)]
        record("choice", {"valid_nbrs": np.array(valid_nbrs),
                          "next_idx": np.array(out)})
        return out

    st.patches.set(tester, "nbv_choice", nbv_choice)

    sh_fn = scone_module.sh_visibility

    def sh_visibility(pts, harmonics, X_cam, use_sigmoid=True):
        out = sh_fn(pts, harmonics, X_cam, use_sigmoid=use_sigmoid)
        if st.counting:
            st.shapes.append(("sh", (pts.shape[0], X_cam.shape[1],
                                     pts.shape[1])))
        if "answer" in faults:
            out = out * 1.05
        return out

    st.patches.set(scone_module, "sh_visibility", sh_visibility)

    capture_fn = camera_module.capture

    def capture(verts, faces, vert_colors, R, T, height, width, zfar, *a,
                **kw):
        images, depth, mask = capture_fn(verts, faces, vert_colors, R, T,
                                         height, width, zfar, *a, **kw)
        if "frame" in faults:
            depth = torch.where(mask, depth * 1.01, depth)
        if st.armed is not None and st.armed.get("phase") == "capture":
            record("capture", {"R": clone(R), "T": clone(T), "zfar": zfar,
                               "size": (height, width),
                               "depth": clone(depth)})
        return images, depth, mask

    st.patches.set(camera_module, "capture", capture)

    tiled_fn = raster_module.rasterize_tiled
    signature = inspect.signature(tiled_fn)

    def rasterize_tiled(*args, **kw):
        if st.tracer is not None and st.tracer.active:
            a = signature.bind(*args, **kw)
            a.apply_defaults()
            a = a.arguments
            # The launch's lists, kept as they are; counted after the
            # traced stretch, so that counting adds no work to it.
            st.launches.append((a["pface"].shape[0], a["starts"],
                                a["counts"], int(a["K_cap"]),
                                a["lane_valid"], a["lane_counts"],
                                int(a["k_chunk"]), int(a["tile"]) ** 2))
        return tiled_fn(*args, **kw)

    st.patches.set(raster_module, "rasterize_tiled", rasterize_tiled)


def trajectory(ctx, st, start, n_poses, on_pose):
    """One trajectory of the tester from ``start`` on a fresh scene state,
    its frames on disk under the run's work directory, removed after."""
    from macarons_tpu_torch.scene.memory import Memory
    from macarons_tpu_torch.trainers.train_macarons import setup_scene

    scene = setup_scene(st.params, st.item, st.gen, st.dev)
    st.rt.bind_scene(scene.cfg, scene.cell_table)
    path = os.path.join(ctx.work_dir, "memory", f"traj_{st.n_traj}")
    st.n_traj += 1
    try:
        st.tester.compute_trajectory(
            st.rt, scene, Memory([path]), path, st.gen, st.rs,
            n_poses=n_poses, surface_epsilon=st.surface_epsilon,
            use_collision=st.params.get("use_collision", False),
            start_idx=start, policy="nbv", on_pose=on_pose)
    finally:
        shutil.rmtree(path, ignore_errors=True)


def window(ctx, st):
    tr = ctx.traffic
    clock = Clock(sync=ctx.trace)
    tracer = st.tracer = Tracer(ctx.trace)
    sample = PoseSample(ctx.seed, tr["check_poses"], tr["check_from"])
    latencies = []
    n = {"done": 0, "last": None, "t0": None}
    trace_from, trace_to = tr["trace_from"], tr["trace_from"] + tr[
        "trace_poses"]

    def on_pose(i, phase):
        t = clock.now()
        k = n["done"]
        if phase == "decision":
            if k == trace_from:
                tracer.start()
                st.shapes_at_trace = len(st.shapes)
                t = clock.now()
            st.slot = sample.slot(k)
            if st.slot is not None:
                st.armed = {}
            n["t0"] = t
        else:
            clock.span(SPAN_OF[phase], t - n["last"])
        if st.armed is not None:
            st.armed["phase"] = phase
        tracer.mark("bench." + NEXT_SPAN[phase])
        n["last"] = t
        if phase == "done":
            latencies.append(t - n["t0"])
            n["done"] = k + 1
            if st.armed is not None:
                if st.slot < len(st.records):
                    st.records[st.slot] = st.armed
                else:
                    st.records.append(st.armed)
                st.armed = None
            if k + 1 == trace_to and tracer.active:
                tracer.mark(None)
                tracer.stop()
                st.trace_shapes = st.shapes[st.shapes_at_trace:]
            if t >= t_end:
                raise StopWindow

    st.counting = True
    t_start = time.perf_counter()
    t_end = t_start + ctx.seconds
    try:
        for k in itertools.count():
            trajectory(ctx, st, st.starts[k % len(st.starts)], st.n_poses,
                       on_pose)
    except StopWindow:
        pass
    # A profiler stopped inside the window paused the program meanwhile.
    window_s = n["last"] - t_start - tracer.stop_s
    if tracer.active:
        tracer.mark(None)
        tracer.stop()
        st.trace_shapes = st.shapes[st.shapes_at_trace:]
    st.counting = False
    poses = n["done"]
    shapes = st.shapes
    reading = tracer.reading() if tracer.done else None
    if reading is not None:
        reading["model_flops"] = model_flops(st, st.trace_shapes)
        reading["raster_bound_s"] = sum(raster_bound_s(*launch)
                                        for launch in st.launches)
        reading["sh_bound_s"] = sum(
            F.bound_seconds(F.sh_visibility_flops(*s),
                            F.sh_visibility_bytes(*s))
            for kind, s in st.trace_shapes if kind == "sh")
    st.launches = []
    return {
        "attempted": poses, "failed": 0,
        "metrics": {"explore_poses_per_s": poses / window_s,
                    "explore_pose_p90_ms": 1e3 * quantile(latencies, 0.9)},
        "run": {"spans": clock.spans, "units": poses, "window_s": window_s,
                "trace": reading,
                "model_flops": model_flops(st, shapes)},
    }


def raster_bound_s(nfe, starts, counts, K_cap, lane_valid, lane_counts,
                   k_chunk, P) -> float:
    """The least time of one fused rasterizer launch at the card's peaks:
    B1's operations and bytes over the pairs it tests, B2's over the
    big-face lanes, one set of outputs."""
    pairs, lanes = (int(n) for n in F.tiled_work(
        nfe, starts, counts, K_cap, lane_valid, lane_counts, k_chunk))
    rows = counts.shape[0]
    return F.bound_seconds(F.tiled_flops(pairs, lanes, rows, P),
                           F.tiled_bytes(pairs, lanes, rows, P))


def model_flops(st, shapes) -> int:
    """Model FLOPs of the recorded calls: ManyDepth, SconeOcc, SconeVis
    (forwards only: the weights are frozen) and B3."""
    p = st.params
    total = 0
    for kind, s in shapes:
        if kind == "depth":
            (B, H, W, _), alpha = s[0], s[1]
            total += F.many_depth_flops(B, H, W, alpha[1],
                                        p.get("n_depth", 96),
                                        p.get("learn_pose", False))
        elif kind == "occ":
            (B, L, _), (_, S, _) = s[0], s[1]
            total += F.scone_occ_flops(B, S, L, p.get("seq_len", 2048),
                                       p.get("k_for_knn", 16))
        elif kind == "vis":
            total += F.scone_vis_flops(s[0][0], s[0][1])
        elif kind == "sh":
            total += F.sh_visibility_flops(*s)
    return total


def check(ctx, st, out, control: bool = False):
    """The compared numbers of the recorded poses (with ``control``, of
    the reference in TF32 in the program's place)."""
    from ..reference import explore as reference

    st.patches.restore()
    records = st.records
    meta = {"params": dict(st.params.to_dict()), "settings": st.settings,
            "mesh_path": st.mesh_path}
    # The program's state goes before the reference runs, so that the
    # reference neither sets the peak nor runs out of room.
    st.model = st.rt = None
    gc.collect()
    torch.cuda.empty_cache()
    return reference.compare(ctx, meta, records, control)
