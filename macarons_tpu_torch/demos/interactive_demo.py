"""Interactive MACARONS exploration demo: a browser UI over the real
pipeline (port of demos/interactive_demo.py).

Served with the standard library's http.server: load a scene and the
model, then click "NBV step" to run one decision (depth inference ->
mapping -> carving -> occupancy field -> candidate scoring) and the camera
move; the page shows the captured RGB, the predicted depth, the growing
surface cloud and the coverage curve. ``DemoSession.step`` and ``reset``
do the device work; ``render`` draws (PIL and matplotlib).

Usage:
  python -m macarons_tpu_torch.demos.interactive_demo --scene_dir <scene>
      [--config cfg.json] [--weights ckpt] [--out demo_out] [--port 7860]
      [--device cuda]
then open http://localhost:7860
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..config import Params
from ..data.scenes import SceneDataset
from ..scene import grid as G
from ..scene.depth_runtime import create_batch_for_depth_model
from ..scene.memory import Memory
from ..trainers.train_macarons import HOST_EPISODES, MacaronsRuntime, \
    setup_scene, start_trajectory, window_frames
from ..utils.device import make_generator, resolve_device
from .macarons_demo import demo_params, load_model, require

PAGE = """<!doctype html>
<html><head><title>MACARONS explorer</title>
<style>
 body { font-family: sans-serif; margin: 2em; background: #161616; color: #eee; }
 img { image-rendering: pixelated; border: 1px solid #444; }
 button { font-size: 1.1em; padding: 0.5em 1.2em; margin-right: 1em; }
 .row { display: flex; gap: 1.5em; margin-top: 1em; flex-wrap: wrap; }
 .card { background: #222; padding: 1em; border-radius: 8px; }
 h3 { margin: 0 0 .5em 0; font-weight: normal; color: #9cf; }
</style></head>
<body>
<h2>MACARONS — interactive NBV exploration</h2>
<div>
 <button onclick="step()">NBV step</button>
 <button onclick="reset()">Reset</button>
 <span id="status"></span>
</div>
<div class="row">
 <div class="card"><h3>Captured RGB</h3><img id="rgb" width="336"></div>
 <div class="card"><h3>Predicted depth</h3><img id="depth" width="336"></div>
 <div class="card"><h3>Surface cloud (top view)</h3><img id="cloud" width="336"></div>
 <div class="card"><h3>Coverage</h3><img id="cov" width="336"></div>
</div>
<script>
async function call(p) {
  document.getElementById('status').textContent = ' running...';
  const r = await fetch(p, {method: 'POST'});
  const d = await r.json();
  for (const k of ['rgb', 'depth', 'cloud', 'cov'])
    if (d[k]) document.getElementById(k).src = 'data:image/png;base64,' + d[k];
  document.getElementById('status').textContent =
    ` pose ${d.pose}: coverage ${d.coverage.toFixed(4)}`;
}
function step() { call('/step'); }
function reset() { call('/reset'); }
</script>
</body></html>
"""


def array_png(a):
    """A uint8-able (H, W[, 3]) array -> base64 PNG."""
    from PIL import Image

    a = np.asarray(a)
    if a.dtype != np.uint8:
        a = np.clip(a, 0.0, 1.0)
        a = (a * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def plot_png(draw_fn):
    """A matplotlib figure drawn by ``draw_fn(ax)`` -> base64 PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(4, 3), dpi=90)
    draw_fn(ax)
    buf = io.BytesIO()
    fig.tight_layout()
    fig.savefig(buf, format="png")
    plt.close(fig)
    return base64.b64encode(buf.getvalue()).decode()


class DemoSession:
    """The server's exploration state; every ``step`` runs one real
    decision and move, as the trainer's ``nbv_parallel_step`` does for a
    lone scene (the host camera's ``decide``, then ``move_and_capture``),
    followed by depth inference on the newest frames."""

    def __init__(self, params: Params, scene_item, memory_root: str, model,
                 device="cuda"):
        self.params = params
        self.item = scene_item
        self.memory_root = memory_root
        self.model = model
        self.device = resolve_device(device)
        self.lock = threading.Lock()
        self.reset()

    def reset(self):
        """A fresh scene state and trajectory: the generators seeded from
        the config, a random valid start pose and its captures."""
        params = self.params
        self.gen = make_generator(self.device, params.get("torch_seed", 5))
        rs = np.random.default_rng(params.get("random_seed", 42))
        self.scene = setup_scene(params, self.item, self.gen, self.device)
        self.rt = MacaronsRuntime(params, self.model, self.scene.cfg,
                                  self.scene.cell_table, self.device)
        self.memory_path = os.path.join(self.memory_root, "demo_memory")
        self.memory = Memory([self.memory_path])
        start_trajectory(self.rt, self.scene, self.memory, self.memory_path,
                         rs)
        self.coverages = []
        self.pose = 0
        self.last_rgb = None
        self.last_depth = None

    def step(self):
        """One NBV step: the decision and move, then depth inference on the
        supervision window (its newest frame is shown) and the surface's
        coverage of the GT surface."""
        rt, scene = self.rt, self.scene
        next_idx, _, _ = HOST_EPISODES.decide(rt, scene, self.gen, False)
        HOST_EPISODES.move(rt, scene, self.memory, self.memory_path,
                           next_idx)
        batch, alpha = create_batch_for_depth_model(
            rt.dcfg, window_frames(rt, scene, rt.n_interpolation_steps
                                   + rt.dcfg.n_alpha_for_supervision),
            "supervision", device=rt.device)
        depth, _, _ = rt.apply_depth_inference(batch, alpha)
        self.last_rgb = batch["images"][-1].cpu().numpy()
        self.last_depth = depth[-1, ..., 0].cpu().numpy()
        cov, _ = G.scene_coverage(scene.cfg, scene.gt_scene,
                                  scene.surface_scene)
        self.coverages.append(float(cov))
        self.pose += 1

    def render(self):
        """The page's JSON: the pose, the coverage and base64 PNGs of the
        newest RGB frame, its depth, the surface cloud and the coverage
        curve."""
        out = {"pose": self.pose,
               "coverage": self.coverages[-1] if self.coverages else 0.0}
        if self.last_rgb is not None:
            out["rgb"] = array_png(self.last_rgb)
            d = self.last_depth
            lo, hi = float(d.min()), float(max(d.max(), d.min() + 1e-6))
            out["depth"] = array_png((d - lo) / (hi - lo))
        pts, valid = G.all_points(self.scene.surface_scene)
        pts = pts[valid].cpu().numpy()

        def draw_cloud(ax):
            if len(pts):
                ax.scatter(pts[:, 0], pts[:, 2], s=0.5, c=pts[:, 1],
                           cmap="viridis")
            ax.set_aspect("equal")
            ax.set_title(f"{len(pts)} surface points", fontsize=9)

        def draw_cov(ax):
            ax.plot(self.coverages, marker="o", ms=3)
            ax.set_xlabel("pose")
            ax.set_ylabel("coverage")
            ax.set_ylim(0, 1)

        out["cloud"] = plot_png(draw_cloud)
        out["cov"] = plot_png(draw_cov)
        return out


def make_handler(session: DemoSession):
    """The request handler: ``GET`` serves the page, ``POST /step`` and
    ``POST /reset`` run the session and answer ``render()``'s JSON."""

    class Handler(BaseHTTPRequestHandler):
        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            body = PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            with session.lock:
                if self.path == "/reset":
                    session.reset()
                elif self.path == "/step":
                    session.step()
                self._json(session.render())

        def log_message(self, *a):
            pass

    return Handler


def build_session(args) -> DemoSession:
    """The session of the CLI's arguments: the demo's parameters (and
    ``--config``), the scene folder ``--scene_dir``, random weights from
    seed 0 replaced by ``--weights`` if it exists."""
    params = demo_params(args.config)
    dev = resolve_device(args.device)
    data_path = os.path.dirname(os.path.abspath(args.scene_dir))
    name = os.path.basename(os.path.abspath(args.scene_dir))
    item = SceneDataset(data_path, scene_names=[name])[0]
    model = load_model(params, args.weights, dev, make_generator(dev, 0))
    return DemoSession(params, item, args.out, model, dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene_dir", required=True)
    ap.add_argument("--config", default=None)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--out", default="demo_out")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require("matplotlib", "PIL")
    os.makedirs(args.out, exist_ok=True)
    session = build_session(args)
    server = ThreadingHTTPServer(("0.0.0.0", args.port),
                                 make_handler(session))
    print(f"serving on http://localhost:{args.port}")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
