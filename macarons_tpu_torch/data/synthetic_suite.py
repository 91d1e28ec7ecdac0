"""The synthetic evaluation suite (port of data_tools/synthetic_suite.py):
deterministic scenes, their evaluation and the suite's training config.

Each scene is a 'town block': a ground slab and 6-10 houses, towers and
arches with per-vertex colours, a few hundred faces, written as
``<root>/synth_XX/mesh.obj`` + ``settings.json`` with five fixed start poses.
The same seed gives the same files as the JAX package's generator.

The evaluation runs the scene tester under ``eval_params`` (perfect depth
and the carving occupancy field) for one or more policies on the same
scenes and start poses, and writes one results file in the layout of the
repo's ``RESULTS_synthetic.json``.

Usage:
  python -m macarons_tpu_torch.data.synthetic_suite generate [root]
  python -m macarons_tpu_torch.data.synthetic_suite eval|eval-all [root]
      [--poses N] [--starts N] [--scenes K] [--test-scenes a,b]
      [--policies a,b] [--out F] [--weights F] [--vis-weights F]
      [--torch-seed S] [--device cuda|cpu]
  python -m macarons_tpu_torch.data.synthetic_suite train-config [root]
      --out F   (the suite's training config, for macarons_tpu_torch.train)
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np

from .mesh_io import Mesh, save_obj

N_SCENES = 10
REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# SconeVis's weights under the JAX tester's fixed-seed init (torch_seed 5)
# at eval_params' widths: the weights of the committed `nbv` row.
SUITE_VIS_INIT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "weights", "suite_vis_init")
# Start 4 of every scene is an isolated lattice pose: zero coverage under
# every policy, so the "valid starts" rows and the lifts leave it out.
INVALID_STARTS = ("4",)


def _box(center, size, color):
    c = np.asarray(center, np.float32)
    s = np.asarray(size, np.float32) / 2
    corners = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        np.float32)
    faces = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
    ], np.int32)
    colors = np.broadcast_to(np.asarray(color, np.float32), (8, 3)).copy()
    return c + corners * s, faces, colors


def _cylinder(center, radius, height, color, n=14):
    c = np.asarray(center, np.float32)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = np.stack([radius * np.cos(ang), np.zeros(n), radius * np.sin(ang)],
                    -1).astype(np.float32)
    bot = c + ring + [0, -height / 2, 0]
    top = c + ring + [0, height / 2, 0]
    verts = np.concatenate([bot, top,
                            [c + [0, -height / 2, 0], c + [0, height / 2, 0]]])
    faces = []
    for i in range(n):
        j = (i + 1) % n
        faces += [[i, n + i, n + j], [i, n + j, j],
                  [2 * n, j, i], [2 * n + 1, n + i, n + j]]
    colors = np.broadcast_to(np.asarray(color, np.float32),
                             (len(verts), 3)).copy()
    return verts, np.asarray(faces, np.int32), colors


def _pyramid(center, size, height, color):
    c = np.asarray(center, np.float32)
    s = size / 2
    verts = np.array([c + [-s, 0, -s], c + [s, 0, -s], c + [s, 0, s],
                      c + [-s, 0, s], c + [0, height, 0]], np.float32)
    faces = np.array([[0, 2, 1], [0, 3, 2], [0, 1, 4], [1, 2, 4],
                      [2, 3, 4], [3, 0, 4]], np.int32)
    colors = np.broadcast_to(np.asarray(color, np.float32), (5, 3)).copy()
    return verts, faces, colors


def build_scene_mesh(seed: int) -> Mesh:
    """Ground slab + 6-10 structures drawn from ``default_rng(seed)``."""
    rs = np.random.default_rng(seed)
    parts = [_box([0, -0.15, 0], [10.0, 0.3, 10.0], [0.45, 0.5, 0.4])]
    for _ in range(6 + int(rs.integers(0, 5))):
        kind = rs.integers(0, 3)
        x, z = rs.uniform(-3.6, 3.6, 2)
        col = rs.uniform(0.2, 0.95, 3)
        if kind == 0:  # house: box + pyramid roof
            w, d = rs.uniform(0.8, 1.8, 2)
            h = rs.uniform(0.8, 2.6)
            parts.append(_box([x, h / 2, z], [w, h, d], col))
            parts.append(_pyramid([x, h, z], max(w, d) * 1.1,
                                  rs.uniform(0.4, 1.0), col * 0.7))
        elif kind == 1:  # tower
            r = rs.uniform(0.3, 0.7)
            h = rs.uniform(1.5, 3.5)
            parts.append(_cylinder([x, h / 2, z], r, h, col))
        else:  # arch: two pillars + lintel
            w = rs.uniform(0.8, 1.6)
            h = rs.uniform(1.0, 2.2)
            t = rs.uniform(0.25, 0.45)
            parts.append(_box([x - w / 2, h / 2, z], [t, h, t], col))
            parts.append(_box([x + w / 2, h / 2, z], [t, h, t], col))
            parts.append(_box([x, h + t / 2, z], [w + t, t, t], col * 0.8))
    verts, faces, colors, off = [], [], [], 0
    for v, f, c in parts:
        verts.append(v)
        faces.append(f + off)
        colors.append(c)
        off += len(v)
    return Mesh(np.concatenate(verts), np.concatenate(faces),
                np.concatenate(colors))


def generate_suite(root: str, n_scenes: int = N_SCENES):
    """Write scenes synth_00 .. synth_{n-1} under ``root``."""
    os.makedirs(root, exist_ok=True)
    for i in range(n_scenes):
        d = os.path.join(root, f"synth_{i:02d}")
        os.makedirs(d, exist_ok=True)
        mesh = build_scene_mesh(1000 + i)
        save_obj(os.path.join(d, "mesh.obj"), mesh)
        mn = mesh.verts.min(0)
        mx = mesh.verts.max(0)
        settings = {
            "scene": {"x_min": (mn - 0.3).tolist(),
                      "x_max": (mx + 0.3).tolist(),
                      "grid_l": 4, "grid_w": 3, "grid_h": 4},
            "camera": {"x_min": [-6.5, 0.5, -6.5], "x_max": [6.5, 6.5, 6.5],
                       "pose_l": 5, "pose_w": 4, "pose_h": 5,
                       "pose_n_elev": 5, "pose_n_azim": 8,
                       "start_positions": [[0, 2, 0, 1, 0], [4, 1, 4, 1, 4],
                                           [2, 3, 2, 1, 2], [0, 1, 4, 1, 6],
                                           [4, 2, 0, 2, 3]]},
            "contrast_factor": 1.0,
        }
        with open(os.path.join(d, "settings.json"), "w") as f:
            json.dump(settings, f)
    return root


def eval_params(root: str, n_proxy: int = 20000) -> dict:
    """Tester params for the suite: perfect depth + carving field (the
    decoupling fixtures) so quality reflects the system (mapping, carving,
    camera logic, NBV scoring) with fixed-seed weights."""
    return dict(
        data_path=root, image_height=64, image_width=96, znear=0.5, zfar=40.0,
        n_depth=8, n_alpha=2, n_alpha_for_supervision=2, alphas=[-2, -1],
        n_interpolation_steps=2, n_proxy_points=n_proxy, seq_len=512,
        n_gt_surface_points=8192, surface_cell_resolution=0.15,
        test_resolution=0.075, view_state_n_elev=7, view_state_n_azim=14,
        harmonic_degree=8, k_for_knn=8, n_cell_per_occ_forward_pass=8,
        occ_cell_batch=2, min_occ_for_proxy_points=0.1,
        use_occ_to_sample_proxy_points=True, use_sigmoid=True,
        sensor_range=48.0, gathering_factor=0.1, learning_rate=1e-4,
        scene_scale_factor=1.0, random_seed=42, torch_seed=5,
        use_perfect_depth=True, use_supervision_occ=True,
        data_augmentation=False, load_obj_textures=False,
    )


def _traj_summary(results: dict, n_poses: int) -> dict:
    """Mean final coverage + AUC over every trajectory of ``results``."""
    finals, aucs = [], []
    for scene, starts in results.items():
        for s, traj in starts.items():
            cov = traj["coverage"]
            finals.append(cov[-1])
            aucs.append(float(np.mean(cov)))
    return {"mean_final_coverage": float(np.mean(finals)),
            "mean_auc": float(np.mean(aucs)),
            "n_scenes": len(results), "n_poses": n_poses}


def _metrics(coverage) -> tuple:
    """(final, auc, auc@30) of one trajectory: its last coverage, the mean
    of all its coverages, the mean of its first 30."""
    return (coverage[-1], float(np.mean(coverage)),
            float(np.mean(coverage[:30])))


def _row(covs) -> dict:
    """A summary row over a list of coverage curves, to 4 digits."""
    m = np.mean([_metrics(c) for c in covs], axis=0)
    return {"mean_final_coverage": round(float(m[0]), 4),
            "mean_auc": round(float(m[1]), 4),
            "mean_auc_30": round(float(m[2]), 4), "n_traj": len(covs)}


def summarize(per_policy: dict) -> tuple:
    """``(_all_summaries, _lift)`` of ``{policy: {scene: {start: traj}}}``.

    ``_all_summaries`` has ``<policy>`` (every trajectory) and
    ``<policy>_valid_starts`` (start 4 left out). ``_lift["<a>_vs_<b>"]``
    compares each learned policy (its name starts with "nbv") with each
    baseline and a trained row with the fixed-seed ``nbv`` one, on the valid
    starts that both ran: each mean rounded to 4 digits, then
    ``100 (a / b - 1)`` to 2, with ``n_common_traj``."""
    summaries = {}
    for p, res in per_policy.items():
        summaries[p] = _row([t["coverage"] for st in res.values()
                             for t in st.values()])
        summaries[f"{p}_valid_starts"] = _row(
            [t["coverage"] for st in res.values()
             for s, t in st.items() if s not in INVALID_STARTS])
    lift = {}
    for a, ra in per_policy.items():
        if not a.startswith("nbv"):
            continue
        for b, rb in per_policy.items():
            if b == a or (b.startswith("nbv") and (b != "nbv" or a == "nbv")):
                continue
            pairs = [(ra[sc][s]["coverage"], rb[sc][s]["coverage"])
                     for sc in ra for s in ra[sc]
                     if s not in INVALID_STARTS and s in rb.get(sc, {})]
            if not pairs:
                continue
            ma, mb = (np.round(np.mean([_metrics(c[i]) for c in pairs],
                                       axis=0), 4) for i in (0, 1))
            pct = np.round(100.0 * (ma / mb - 1.0), 2)
            lift[f"{a}_vs_{b}"] = {
                "n_common_traj": len(pairs), "final_pct": float(pct[0]),
                "auc_pct": float(pct[1]), "auc30_pct": float(pct[2])}
    return summaries, lift


def _checkpoint_path(path):
    """A checkpoint path without its extension (the loaders add it)."""
    if path and os.path.splitext(path)[1] in (".msgpack", ".pt"):
        return os.path.splitext(path)[0]
    return path


def run_suite_eval(root: str, out_json: str, n_poses: int = 30,
                   n_start_poses: int = 2, max_scenes=None,
                   policies=("nbv",), device="cuda", weights_path=None,
                   vis_weights_path=None, torch_seed: int = 5,
                   test_scenes=None, verbose: bool = True) -> dict:
    """Evaluate ``policies`` on the same scenes, start poses and seeds and
    write one results file: the primary policy's trajectories (``nbv`` if
    it ran) at the top level, the others under ``_baselines``,
    ``_summary`` (the primary's valid starts), ``_all_summaries``, ``_lift``
    and ``_protocol`` (with each policy's seconds per pose). Runs on
    ``device`` ("cuda" unless the caller asks for the CPU). The networks
    come from ``weights_path`` (a MACARONS checkpoint, the port's ``.pt``
    or a JAX ``.msgpack``), else from the init seeded by ``torch_seed``,
    with SconeVis then read from ``vis_weights_path`` (a SconeVis
    variables msgpack, e.g. ``SUITE_VIS_INIT``). ``test_scenes`` names
    the scenes to run (default all, or the first ``max_scenes``); the
    random walk's numpy generator starts afresh in every run. Returns the
    file's contents; an unknown policy raises a ValueError before any
    runs."""
    from ..config import Params
    from ..testers.scene import check_policy, run_test
    from ..utils.device import resolve_device

    for policy in policies:
        check_policy(policy)
    resolve_device(device)
    out_dir = os.path.dirname(out_json) or "."
    stem = os.path.splitext(os.path.basename(out_json))[0]
    per_policy, seconds = {}, {}
    for policy in policies:
        params = Params(dict(eval_params(root), torch_seed=torch_seed))
        mem = os.path.join(out_dir, f"_eval_memory_{policy}_{stem}")
        tmp = f"_tmp_{policy}_{stem}.json"
        t0 = time.perf_counter()
        results = run_test(
            params, data_path=root, results_dir=out_dir, results_name=tmp,
            n_start_poses=n_start_poses, n_poses=n_poses,
            max_scenes=max_scenes, test_scenes=test_scenes, policy=policy,
            device=device,
            weights_path=_checkpoint_path(weights_path),
            vis_weights_path=_checkpoint_path(vis_weights_path),
            memory_root=mem, verbose=verbose)
        n_traj = sum(len(st) for st in results.values())
        seconds[policy] = (time.perf_counter() - t0) / (n_traj * n_poses)
        per_policy[policy] = results
        os.remove(os.path.join(out_dir, tmp))
        shutil.rmtree(mem, ignore_errors=True)
        if verbose:
            print(f"policy {policy}: "
                  f"{json.dumps(_traj_summary(results, n_poses))}, "
                  f"{seconds[policy]:.4f} s per pose", flush=True)

    summaries, lift = summarize(per_policy)
    primary = "nbv" if "nbv" in per_policy else list(per_policy)[0]
    data = dict(per_policy[primary])
    data["_summary"] = summaries[f"{primary}_valid_starts"]
    data["_all_summaries"] = summaries
    data["_baselines"] = {p: r for p, r in per_policy.items() if p != primary}
    data["_lift"] = lift
    data["_protocol"] = {
        "n_poses": n_poses, "n_start_poses": n_start_poses,
        "policies": list(per_policy), "torch_seed": torch_seed,
        "device": str(device), "seconds_per_pose": seconds}
    os.makedirs(out_dir, exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(data, f, indent=1)
    if verbose:
        print("synthetic suite summaries:", json.dumps(summaries))
        print("lift:", json.dumps(lift))
    return data


def suite_training_params(root: str):
    """The default training config with the suite's evaluation widths and
    fixtures (``eval_params`` but its seeds and learning rate), 100-pose
    trajectories, 3 epochs, and SconeVis starting from ``SUITE_VIS_INIT``
    (``vis_init_path``, relative to the repo's root, so that the config
    serves any checkout)."""
    from ..config import load_params

    params = load_params(os.path.join(
        REPO_DIR, "configs/macarons/macarons_default_training_config.json"))
    overlay = {k: v for k, v in eval_params(root).items()
               if k not in ("random_seed", "torch_seed", "learning_rate")}
    params.update(dict(overlay, n_poses_in_trajectory=100, epochs=3,
                       pretrained=False,
                       vis_init_path=os.path.relpath(SUITE_VIS_INIT,
                                                     REPO_DIR),
                       macarons_model_name="synth"))
    return params


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="Generate or evaluate the synthetic suite.")
    parser.add_argument("cmd", choices=("generate", "eval", "eval-all",
                                        "train-config"))
    parser.add_argument("root", nargs="?", default="data/synthetic_scenes")
    parser.add_argument("--poses", type=int, default=30)
    parser.add_argument("--starts", type=int, default=2)
    parser.add_argument("--scenes", type=int, default=None)
    parser.add_argument("--test-scenes", default=None,
                        help="comma-separated scene names (default all)")
    parser.add_argument("--policies", default=None,
                        help="comma-separated (eval: nbv; eval-all: "
                        "nbv,random,carving)")
    parser.add_argument("--out", default=None,
                        help="results file (default results/"
                        "RESULTS_synthetic_torch.json); train-config: the "
                        "config file to write")
    parser.add_argument("--weights", default=None,
                        help="a MACARONS checkpoint (.pt or JAX .msgpack)")
    parser.add_argument("--vis-weights", default=None,
                        help="a SconeVis variables msgpack, e.g. "
                        + os.path.relpath(SUITE_VIS_INIT, REPO_DIR)
                        + ".msgpack")
    parser.add_argument("--torch-seed", type=int, default=5)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.cmd == "generate":
        generate_suite(args.root)
        print(f"wrote {N_SCENES} scenes under {args.root}")
        return None
    if args.cmd == "train-config":
        if not args.out:
            parser.error("train-config needs --out")
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(suite_training_params(args.root).to_dict(), f, indent=1)
        print(f"wrote {args.out}")
        return None
    policies = (args.policies.split(",") if args.policies
                else ["nbv"] if args.cmd == "eval"
                else ["nbv", "random", "carving"])
    from ..testers.scene import check_policy

    for policy in policies:
        check_policy(policy)
    if not os.path.isdir(args.root) or not os.listdir(args.root):
        generate_suite(args.root)
    return run_suite_eval(
        args.root, args.out or "results/RESULTS_synthetic_torch.json",
        n_poses=args.poses, n_start_poses=args.starts, max_scenes=args.scenes,
        policies=tuple(policies), device=args.device,
        weights_path=args.weights, vis_weights_path=args.vis_weights,
        torch_seed=args.torch_seed, test_scenes=(
            args.test_scenes.split(",") if args.test_scenes else None))


if __name__ == "__main__":
    main()
