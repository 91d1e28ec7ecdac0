"""MACARONS exploration demo: NBV steps on one scene, with figures (port
of demos/macarons_demo.py).

A headless CLI: it loads a scene and the model, runs ``n_steps`` NBV steps
of the tester's trajectory and writes ``trajectory.json``, the camera
curves and the reconstructed surface (``exports/``), then one figure per
step: the surface map, the camera trajectory and the coverage curve.
``run`` does the device work and ``draw`` the figures (matplotlib).

Usage:
  python -m macarons_tpu_torch.demos.macarons_demo --scene_dir <scenes>
      [--scene NAME] [--config cfg.json] [--weights ckpt] [--n_steps 10]
      [--out demo_out] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np

from ..config import Params, load_params
from ..data.scenes import SceneDataset
from ..models.macarons import create_macarons_model, init_macarons_weights, \
    load_macarons
from ..scene import grid as G
from ..scene.memory import Memory
from ..testers.scene import compute_trajectory, export_trajectory
from ..trainers.train_macarons import MacaronsRuntime, SceneState, \
    setup_scene
from ..utils.checkpoint import checkpoint_exists
from ..utils.device import make_generator, resolve_device

DEFAULTS = dict(
    image_height=128, image_width=168, znear=0.5, zfar=30.0, n_depth=16,
    n_alpha=2, n_alpha_for_supervision=2, alphas=[-2, -1],
    n_interpolation_steps=2, n_proxy_points=20000, seq_len=512,
    n_gt_surface_points=8192, surface_cell_resolution=0.05,
    view_state_n_elev=7, view_state_n_azim=14, harmonic_degree=8,
    k_for_knn=16, n_cell_per_occ_forward_pass=8, occ_cell_batch=2,
    min_occ_for_proxy_points=0.1, use_occ_to_sample_proxy_points=True,
    use_sigmoid=True, sensor_range=40.0, gathering_factor=0.1,
    data_augmentation=False, random_seed=42, torch_seed=5,
    scene_scale_factor=1.0, test_resolution=0.05,
)


def demo_params(config: Optional[str] = None) -> Params:
    """``DEFAULTS``, updated by the JSON config at ``config`` if given."""
    params = Params(DEFAULTS)
    if config:
        params.update(load_params(config).to_dict())
    return params


def load_model(params: Params, weights: Optional[str], dev, gen,
               verbose: bool = True):
    """The MACARONS networks: random weights drawn from ``gen``, replaced
    by the checkpoint at ``weights`` (the port's ``.pt`` or a JAX
    ``.msgpack``) if it exists."""
    model = init_macarons_weights(create_macarons_model(params, dev), gen)
    if weights and checkpoint_exists(weights):
        load_macarons(weights, model)
        if verbose:
            print("loaded weights from", weights)
    return model


def run(params: Params, scene_dir: str, scene: Optional[str] = None,
        weights: Optional[str] = None, n_steps: int = 10,
        out: str = "demo_out", device="cuda", verbose: bool = True):
    """The demo's device work: ``n_steps`` NBV steps of the tester's
    trajectory on ``scene`` (default the first under ``scene_dir``), with
    its generators seeded from the config (``torch_seed`` draws the
    networks' weights, then the scene and the trajectory; ``random_seed``
    the start pose). Writes ``out/trajectory.json``, and under
    ``out/exports/`` the camera curves (``cameras.json``, one entry per
    pose the NBV moved to) and the surface (``surface.ply``).
    Returns (the trajectory's results dict, the scene state)."""
    dev = resolve_device(device)
    params = Params(dict(params.to_dict(), data_path=scene_dir))
    dataset = SceneDataset(scene_dir)
    name = scene or dataset.scene_names[0]
    item = dataset[dataset.scene_names.index(name)]
    gen = make_generator(dev, params.get("torch_seed", 5))
    rs = np.random.default_rng(params.get("random_seed", 42))
    model = load_model(params, weights, dev, gen, verbose)
    state = setup_scene(params, item, gen, dev)
    rt = MacaronsRuntime(params, model, state.cfg, state.cell_table, dev)
    memory_path = os.path.join(out, "memory")
    traj = compute_trajectory(
        rt, state, Memory([memory_path]), memory_path, gen, rs,
        n_poses=n_steps,
        surface_epsilon=2 * params.get("test_resolution", 0.05)
        * params.get("scene_scale_factor", 1.0),
        verbose=verbose)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "trajectory.json"), "w") as f:
        json.dump(traj, f)
    export_trajectory(state, params, os.path.join(out, "exports"),
                      jump_poses=state.camera.n_interpolation_steps)
    return traj, state


def plot_step(out_dir: str, step: int, scene: SceneState, coverages):
    """``out_dir/step_<step>.png``: the surface map, the camera trajectory
    and the coverage curve up to ``step``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts, valid = G.all_points(scene.surface_scene)
    p = pts[valid].cpu().numpy()
    fig = plt.figure(figsize=(12, 4))
    ax = fig.add_subplot(131, projection="3d")
    if len(p):
        ax.scatter(p[:, 0], p[:, 2], p[:, 1], s=0.5, c=p[:, 1], cmap="viridis")
    ax.set_title(f"surface map ({len(p)} pts)")
    ax2 = fig.add_subplot(132, projection="3d")
    X = np.concatenate(scene.camera.X_cam_history, 0)
    ax2.plot(X[:, 0], X[:, 2], X[:, 1], "o-", ms=3)
    ax2.set_title("camera trajectory")
    ax3 = fig.add_subplot(133)
    ax3.plot(coverages, "o-")
    ax3.set_xlabel("pose")
    ax3.set_ylabel("true coverage")
    ax3.set_ylim(0, 1)
    ax3.set_title("coverage evolution")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, f"step_{step:03d}.png"), dpi=110)
    plt.close(fig)


def draw(out: str, traj, scene: SceneState):
    """One figure per pose of ``traj`` (``run``'s results) into ``out``."""
    for step in range(len(traj["coverage"])):
        plot_step(out, step, scene, traj["coverage"][: step + 1])


def require(*modules: str):
    """Import each module, or stop with an error naming the missing one
    (before any device work)."""
    import importlib

    for m in modules:
        try:
            importlib.import_module(m)
        except ImportError as e:
            raise SystemExit(f"this demo draws its figures with {m}, which "
                             f"cannot be imported here ({e}); install it or "
                             "call the demo's run() without figures")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--scene_dir", required=True,
                        help="Directory containing the scene folders.")
    parser.add_argument("--scene", default=None)
    parser.add_argument("--config", default=None)
    parser.add_argument("--weights", default=None)
    parser.add_argument("--n_steps", type=int, default=10)
    parser.add_argument("--out", default="demo_out")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    require("matplotlib")
    traj, scene = run(demo_params(args.config), args.scene_dir, args.scene,
                      args.weights, args.n_steps, args.out, args.device)
    draw(args.out, traj, scene)
    print(f"demo complete: final coverage {traj['coverage'][-1]:.4f}; "
          f"figures in {args.out}/")


if __name__ == "__main__":
    main()
