"""The plain reference of the exploration cell and its comparison.

For each pose the driver recorded, the reference recomputes from that
pose's inputs, with the frozen networks (``frozen/``) rebuilt and filled
from the run's seed, in float32 with TF32 off:

- ManyDepth's depth of the decision's frames (``depth_rel``: the largest
  relative gap of a pixel's depth);
- the occupancy field over the proxies, its cell tables rebuilt from the
  proxies and the scene's settings (``field_gap``: the largest gap of a
  predicted occupancy, 1 where the two prediction masks differ);
- every candidate's coverage gain, SconeVis and the plain SH integral in
  place of B3, from the same Monte-Carlo draws (``gains_rel``: the largest
  gap over the largest gain);
- the pose chosen (``choice_gap``: how far the chosen candidate's
  reference gain lies below the reference's best, over the best);
- the move's captured depth at pixels drawn from the seed, by an exact
  scan of every face (``capture_miss``: the share of sampled pixels whose
  depth differs by more than RASTER_REL, or that one side leaves empty).

The reference follows the program from the state its layers were handed
(the proxies' view states and the surface grid that mapping built, the
scene field the scorer was given): each layer is judged on its own
inputs. It imports nothing of the program.

``compare(..., control=True)`` puts the reference computed with TF32 in
the program's place: the nearest precision below the float32 that the
configuration states."""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import numpy as np
import torch

from ..harness.common import CHECK_STREAM, generator, network_weights
from .frozen import depth_runtime as drt
from .frozen import grid as G
from .frozen import runtime as R
from .frozen.geometry import FoVCamera, ndc_pixel_grid
from .frozen.many_depth import ManyDepth
from .frozen.scone import SconeOcc, SconeVis

# A sampled pixel's depth may differ by this share before it counts as a
# miss: rounding of the projection and the interpolation, not a face.
RASTER_REL = 1e-3
PIXELS_PER_FRAME = 4096


@contextlib.contextmanager
def precision(tf32: bool):
    """Matmuls and convolutions in float32 (TF32 off), or in TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def networks(params: dict, seed: int, device):
    """The frozen SconeOcc, SconeVis and ManyDepth at the configuration's
    widths, their weights from ``seed`` as the driver made them."""
    occ = SconeOcc(seq_len=params.get("seq_len", 2048),
                   n_scale=0 if params.get("no_local_features", False) else 3,
                   k_for_knn=params.get("k_for_knn", 16)).to(device).eval()
    vis = SconeVis().to(device).eval()
    depth = ManyDepth(
        input_height=params.get("image_height", 256),
        input_width=params.get("image_width", 456),
        d_min=params.get("znear", 0.5), d_max=params.get("zfar", 750.0),
        n_depth=params.get("n_depth", 96),
        pose_factor=params.get("pose_factor", 100.0),
        learn_pose=params.get("learn_pose", False)).to(device).eval()
    network_weights(seed, device, occ, vis, depth)
    return SimpleNamespace(occ=occ, vis=vis, depth=depth)


def depth_config(p: dict) -> drt.DepthBatchConfig:
    return drt.DepthBatchConfig(
        n_alpha=p.get("n_alpha", 2),
        n_alpha_for_supervision=p.get("n_alpha_for_supervision", 2),
        alphas=tuple(p.get("alphas", [-2, -1])),
        use_future_frame_for_supervision=p.get(
            "use_future_frame_for_supervision", False),
        znear=p.get("znear", 0.5), zfar=p.get("zfar", 750.0),
        pose_factor=p.get("pose_factor", 100.0),
        rotation_mode=p.get("rotation_mode", "angle"),
        ssim_factor=p.get("ssim_factor", 0.85),
        regularity_factor=p.get("regularity_factor", 0.01),
        regularity_loss=p.get("regularity_loss", True),
        use_depth_mask=p.get("use_depth_mask", True),
        padding_mode=p.get("padding_mode", "border"),
        data_augmentation=p.get("data_augmentation", True),
        jitter_probability=p.get("jitter_probability", 0.5),
        symmetry_probability=p.get("symmetry_probability", 0.5))


def camera(d: dict) -> FoVCamera:
    return FoVCamera(d["R"], d["T"], d["fov"], d["znear"], d["zfar"],
                     d["aspect_ratio"])


def grid_config(p: dict, settings: dict):
    s = settings["scene"]
    scale = p.get("scene_scale_factor", 1.0)
    return G.make_grid_config(
        tuple(np.asarray(s["x_min"], np.float32)),
        tuple(np.asarray(s["x_max"], np.float32)),
        s["grid_l"], s["grid_w"], s["grid_h"],
        resolution=p.get("surface_cell_resolution",
                         p.get("test_resolution", 0.05) * scale),
        capacity=p.get("surface_cell_capacity"), feature_dim=1)


def read_obj(path: str, device):
    """Vertices and triangles of an OBJ file (``v`` and ``f`` lines)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                faces.append([int(x.split("/")[0]) - 1 for x in parts[1:4]])
    return (torch.tensor(verts, dtype=torch.float32, device=device),
            torch.tensor(faces, dtype=torch.int64, device=device))


def nearest_depth(verts, faces, cam: FoVCamera, px, py, eps: float = 1e-8,
                  chunk: int = 4096):
    """View depth of the nearest face at NDC pixel centres (px, py) (P,)
    of one camera, by testing every face: -1 where none covers a pixel."""
    view = cam.world_to_view(verts[None])[0]
    ndc = cam.project_view(view[None])[0]
    fv = torch.cat((ndc[:, :2], view[:, 2:]), dim=-1)[faces]  # (F, 3, 3)
    best = torch.full(px.shape, float("inf"), device=px.device)
    px, py = px[:, None], py[:, None]
    for a in range(0, fv.shape[0], chunk):
        f = fv[a:a + chunk]
        x0, y0, z0 = f[:, 0, 0], f[:, 0, 1], f[:, 0, 2]
        x1, y1, z1 = f[:, 1, 0], f[:, 1, 1], f[:, 1, 2]
        x2, y2, z2 = f[:, 2, 0], f[:, 2, 1], f[:, 2, 2]
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        ok = (area.abs() > eps) & (z0 > eps) & (z1 > eps) & (z2 > eps)
        inv = torch.where(ok, 1.0 / torch.where(ok, area, 1.0), 0.0)
        w0 = ((x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)) * inv
        w1 = ((x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)) * inv
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & ok
        iw = w0 / z0 + w1 / z1 + w2 / z2
        z = 1.0 / torch.where(iw.abs() > eps, iw, eps)
        z = torch.where(inside & (z > eps), z, float("inf"))
        best = torch.minimum(best, z.amin(dim=-1))
    return torch.where(torch.isfinite(best), best, -1.0)


def _depth(nets, cfg, rec, tf32):
    with precision(tf32), torch.no_grad():
        return drt.many_depth_inference(nets.depth, cfg, rec["batch"],
                                        rec["alpha"])[0]


def _field(nets, p, settings, rec, tf32):
    proxy = SimpleNamespace(**rec["proxy"])
    cfg = grid_config(p, settings)
    table = R.build_cell_index_table(cfg, proxy.points.cpu().numpy())
    tables = R.device_cell_tables(
        cfg, table, p.get("prediction_neighborhood_size", 3.0),
        proxy.points.device)
    ff_chunk = p.get("occ_full_field_chunk", None)
    field = R.OccupancyField(
        nets.occ, n_elev=p.get("view_state_n_elev", 7),
        n_azim=p.get("view_state_n_azim", 14),
        degree=p.get("harmonic_degree", 8), k_for_knn=p.get("k_for_knn", 16),
        max_cells=p.get("n_cell_per_occ_forward_pass", 12),
        cell_batch=p.get("occ_cell_batch",
                         max(p.get("n_cell_per_occ_forward_pass", 12),
                             ff_chunk or 0)),
        full_field_chunk=ff_chunk)
    kw = dict(rec["kw"])
    kw.setdefault("full_field", p.get("full_occupancy_field", True))
    with precision(tf32):
        return field(proxy, SimpleNamespace(**rec["surface"]), tables,
                     camera(rec["camera"]), **kw)


def _gains(nets, p, rec, tf32):
    (X_world, harmonics, occ, valid, cand, X_cand, pred_cam, box_diag,
     resolution, sensor_range) = rec["args"]
    scorer = R.CoverageGain(
        seq_len=p.get("seq_len", 2048), image_height=p.get("image_height",
                                                           256),
        image_width=p.get("image_width", 456),
        min_occ=p.get("min_occ_for_proxy_points", 0.1),
        use_occ_to_sample=p.get("use_occ_to_sample_proxy_points", True),
        use_sigmoid=p.get("use_sigmoid", True),
        dist_factor_mode=p.get("distance_factor_th"),
        shared_sample=p.get("shared_sample_scoring", False))
    gen = torch.Generator(device=X_world.device)
    gen.set_state(rec["gen_state"])
    with precision(tf32):
        return scorer(nets.vis, X_world, harmonics, occ, valid, camera(cand),
                      X_cand, camera(pred_cam), box_diag, resolution,
                      sensor_range, generator=gen)


def _pixels(gen, H, W, n, device):
    idx = torch.randint(0, H * W, (n,), generator=gen, device=device)
    ndc_x, ndc_y = ndc_pixel_grid(H, W, device=device)
    return idx, ndc_x.reshape(-1)[idx], ndc_y.reshape(-1)[idx]


def compare(ctx, meta: dict, records: list, control: bool = False) -> list:
    """The cell's compared numbers, each the worst over the recorded
    poses, beside its limit from the traffic mix. With ``control`` the
    program's outputs are replaced by the reference's in TF32."""
    p, dev = meta["params"], ctx.device
    limits = ctx.traffic["limits"]
    nets = networks(p, p["torch_seed"], dev)
    cfg = depth_config(p)
    verts, faces = read_obj(meta["mesh_path"], dev)
    verts = verts * p.get("scene_scale_factor", 1.0)
    pix_gen = generator(dev, ctx.seed, CHECK_STREAM)
    worst = {k: 0.0 for k in limits}
    seen = {k: 0 for k in limits}
    for rec in records:
        if "depth" in rec:
            r = rec["depth"]
            ref = _depth(nets, cfg, r, False)
            got = _depth(nets, cfg, r, True) if control else r["out"]
            rel = ((got - ref).abs() / ref.abs().clamp(min=1e-6)).max()
            worst["depth_rel"] = max(worst["depth_rel"], float(rel))
            seen["depth_rel"] += 1
        if "field" in rec:
            r = rec["field"]
            ref_p, ref_m, _ = _field(nets, p, meta["settings"], r, False)
            got_p, got_m, _ = (_field(nets, p, meta["settings"], r, True)
                               if control else r["out"])
            gap = torch.where(ref_m & got_m, (got_p - ref_p).abs()[:, 0],
                              0.0).max()
            if not torch.equal(ref_m, got_m):
                gap = torch.ones_like(gap)
            worst["field_gap"] = max(worst["field_gap"], float(gap))
            seen["field_gap"] += 1
        if "gains" in rec and "choice" in rec:
            r, c = rec["gains"], rec["choice"]
            n = len(c["valid_nbrs"])
            ref = _gains(nets, p, r, False)[:n]
            got = (_gains(nets, p, r, True) if control else r["out"])[:n]
            scale = ref.abs().max().clamp(min=1e-12)
            worst["gains_rel"] = max(worst["gains_rel"],
                                     float((got - ref).abs().max() / scale))
            seen["gains_rel"] += 1
            if control:
                j = int(torch.argmax(got))
            else:
                j = int(np.flatnonzero((c["valid_nbrs"]
                                        == c["next_idx"]).all(axis=1))[0])
            worst["choice_gap"] = max(worst["choice_gap"],
                                      float((ref.max() - ref[j]) / scale))
            seen["choice_gap"] += 1
        if "capture" in rec:
            r = rec["capture"]
            H, W = r["size"]
            cams = FoVCamera.create(r["R"], r["T"], zfar=r["zfar"])
            misses, total = 0, 0
            for i in range(r["R"].shape[0]):
                idx, px, py = _pixels(pix_gen, H, W, PIXELS_PER_FRAME, dev)
                with precision(False):
                    ref = nearest_depth(verts, faces, cams[i], px, py)
                if control:
                    with precision(True):
                        got = nearest_depth(verts, faces, cams[i], px, py)
                else:
                    got = r["depth"][i].reshape(-1)[idx]
                miss = ((ref < 0) != (got < 0)) | (
                    (got - ref).abs() > RASTER_REL * ref.abs().clamp(min=1.0))
                misses += int(miss.sum())
                total += idx.numel()
            worst["capture_miss"] = max(worst["capture_miss"],
                                        misses / max(total, 1))
            seen["capture_miss"] += 1
    checks = [{"name": k, "value": worst[k], "limit": limits[k]}
              for k in limits]
    # A layer the window never reached at a sampled pose is not correct.
    checks.append({"name": "records_missing",
                   "value": sum(1 for k in limits if seen[k] == 0),
                   "limit": 0})
    return checks
