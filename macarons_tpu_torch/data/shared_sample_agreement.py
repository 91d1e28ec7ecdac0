"""Shared-sample against per-candidate NBV scoring: how often they agree
(port of data_tools/shared_sample_agreement.py).

The per-candidate scorer (the default, the reference's scene loop) draws
a fresh occupancy-weighted Monte-Carlo sample and runs SconeVis once per
candidate; the shared-sample one (``shared_sample_scoring``) draws one
sample from the union of the candidates' fields of view and runs SconeVis
once. Over random decision states this measures the argmax agreement, the
share of per-candidate argmaxes in the shared top 3, and the mean Spearman
rank correlation; ``--bench`` also times both scorers between CUDA events.

Usage:
  python -m macarons_tpu_torch.data.shared_sample_agreement [--trials N]
      [--seq-len L] [--n-pts N] [--n-cand C] [--weights CKPT] [--bench]
      [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models.attention import init_weights
from ..models.scone import SconeVis
from ..ops.geometry import FoVCamera, get_cartesian_coords, \
    look_at_view_transform
from ..scene.runtime import CoverageGain
from ..utils.convert import flax_to_torch, read_msgpack
from ..utils.device import make_generator, resolve_device

# The scorers' scalar arguments: box diagonal, cell resolution, sensor
# range.
BOX_DIAG, CELL_RESOLUTION, SENSOR_RANGE = 24.0, 0.2, 60.0


def make_state(seed: int, n_pts: int, n_cand: int, device):
    """A structured random decision state, its draws from numpy's
    ``default_rng(seed)``: gaussian point clusters with occupancy decaying
    with the distance to their centre, view harmonics, partial validity,
    and candidate cameras looking at the origin. Returns the scorers'
    arguments on ``device``: (X (N, 3), harmonics (N, 64), occ (N, 1),
    valid (N,), candidate cameras, their centres (C, 3), the prediction
    camera)."""
    N, C = n_pts, n_cand
    rs = np.random.default_rng(seed)
    n_clusters = rs.integers(3, 8)
    centers = rs.uniform(-8, 8, (n_clusters, 3))
    assign = rs.integers(0, n_clusters, N)
    pts = (centers[assign] + rs.normal(0, 1.2, (N, 3))).astype(np.float32)
    d = np.linalg.norm(pts - centers[assign], axis=-1)
    occ = np.clip(np.exp(-d) + rs.uniform(0, 0.3, N), 0, 1)
    occ = occ.astype(np.float32)[:, None]
    vh = (rs.normal(0, 0.15, (N, 64))).astype(np.float32)
    valid = rs.uniform(0, 1, N) > 0.2
    elev = rs.uniform(-50, 50, C).astype(np.float32)
    azim = rs.uniform(0, 360, C).astype(np.float32)
    dist = rs.uniform(10, 18, C).astype(np.float32)

    def t(a):
        return torch.as_tensor(a, device=device)

    def looking_at_origin(dist, elev, azim):
        eye = get_cartesian_coords(dist, elev, azim, in_degrees=True)
        return FoVCamera.create(*look_at_view_transform(
            eye, torch.zeros_like(eye)), zfar=60.0)

    cams = looking_at_origin(t(dist), t(elev), t(azim))
    pcam = looking_at_origin(t([15.0]), t([25.0]), t([60.0]))
    return (t(pts), t(vh), t(occ), t(valid), cams, cams.camera_center(), pcam)


def spearman(a, b) -> float:
    """Spearman rank correlation of two score vectors (1 if either is
    constant)."""
    ra = np.argsort(np.argsort(a))
    rb = np.argsort(np.argsort(b))
    denom = np.std(ra) * np.std(rb)
    return (float(np.mean((ra - ra.mean()) * (rb - rb.mean())) / denom)
            if denom > 0 else 1.0)


def bench_ms(fn, n: int = 20) -> float:
    """ms per call of ``fn`` over ``n`` calls after one warm-up call,
    between CUDA events."""
    fn(0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--n-pts", type=int, default=20000)
    ap.add_argument("--n-cand", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bench", action="store_true",
                    help="also time both scorers between CUDA events")
    ap.add_argument("--weights", default=None,
                    help="a MACARONS checkpoint of the JAX package (path "
                    "without .msgpack): its SconeVis weights replace the "
                    "random ones")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.bench and dev.type != "cuda":
        raise SystemExit("--bench times the scorers on the card: it needs "
                         "--device cuda")

    N, C, L = args.n_pts, args.n_cand, args.seq_len
    vis = init_weights(SconeVis().to(dev), make_generator(dev, 0)).eval()
    weights_kind = "random_init"
    if args.weights:
        state = flax_to_torch(read_msgpack(args.weights + ".msgpack")["vis"])
        vis.load_state_dict({k: v.to(dev) for k, v in state.items()})
        weights_kind = args.weights

    per = CoverageGain(seq_len=L)
    shared = CoverageGain(seq_len=L, shared_sample=True)

    def gains(scorer, state, seed):
        return scorer(vis, *state, BOX_DIAG, CELL_RESOLUTION, SENSOR_RANGE,
                      generator=make_generator(dev, seed))

    agree = top3 = 0
    rank_corrs = []
    for t in range(args.trials):
        state = make_state(1000 + t, N, C, dev)
        g_per = gains(per, state, t).cpu().numpy()
        g_sh = gains(shared, state, t).cpu().numpy()
        a_per, a_sh = int(np.argmax(g_per)), int(np.argmax(g_sh))
        agree += a_per == a_sh
        top3 += a_per in np.argsort(-g_sh)[:3]
        rank_corrs.append(spearman(g_per, g_sh))
        if (t + 1) % 20 == 0:
            print(f"  {t + 1}/{args.trials}: argmax agreement "
                  f"{agree / (t + 1):.3f}", flush=True)

    out = {
        "trials": args.trials, "seq_len": L, "n_pts": N, "n_cand": C,
        "weights": weights_kind,
        "argmax_agreement": agree / args.trials,
        "top3_agreement": top3 / args.trials,
        "mean_rank_corr": float(np.mean(rank_corrs)),
    }
    if args.bench:
        state = make_state(7, N, C, dev)
        out["per_candidate_ms"] = bench_ms(lambda i: gains(per, state, i))
        out["shared_ms"] = bench_ms(lambda i: gains(shared, state, i))
        out["speedup"] = out["per_candidate_ms"] / out["shared_ms"]
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
