"""The port's demos (macarons_tpu_torch/demos) and the shared-sample
agreement tool (macarons_tpu_torch/data/shared_sample_agreement.py) on the
CPU at tiny sizes: each demo's run part and its draw part, DemoSession
over one HTTP round trip, the agreement tool's states against the JAX
tool's (data_tools/shared_sample_agreement.py) for the same seeds."""

import json
import os
import runpy
import sys
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from macarons_tpu_torch.data import shared_sample_agreement as SSA
from macarons_tpu_torch.data.mesh_io import Mesh, save_obj
from macarons_tpu_torch.data.scenes import SceneDataset
from macarons_tpu_torch.demos import interactive_demo as I
from macarons_tpu_torch.demos import macarons_demo as M
from macarons_tpu_torch.demos import scone_demo as S
from macarons_tpu_torch.scene.memory import Memory
from macarons_tpu_torch.testers.scene import compute_trajectory
from macarons_tpu_torch.trainers.train_macarons import MacaronsRuntime, \
    setup_scene
from torch_port_helpers import TINY, make_scene_root, \
    torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_scene_root(tmp_path_factory)


def tiny_params():
    params = M.demo_params()
    params.update(TINY)
    return params


def read_ply(path):
    lines = open(path).read().splitlines()
    n = int(lines[2].split()[-1])
    rows = lines[lines.index("end_header") + 1:]
    assert len(rows) == n
    return np.array([[float(v) for v in r.split()] for r in rows])


def test_macarons_demo_run_and_draw(root, tmp_path):
    """The run part's trajectory is compute_trajectory's from the same
    generator state (the weights drawn first, then the scene); its files
    hold that trajectory, one camera-curve entry per pose it moved to, and
    the surface's valid points; the draw part writes one figure per
    pose."""
    params = tiny_params()
    out = str(tmp_path / "demo")
    traj, scene = M.run(params, root, n_steps=3, out=out, device="cpu",
                        verbose=False)

    gen = torch.Generator().manual_seed(params.torch_seed)
    model = M.load_model(params, None, CPU, gen, verbose=False)
    item = SceneDataset(root)[0]
    ref_scene = setup_scene(params, item, gen, CPU)
    rt = MacaronsRuntime(params, model, ref_scene.cfg, ref_scene.cell_table,
                         "cpu")
    mem = str(tmp_path / "memory")
    ref = compute_trajectory(rt, ref_scene, Memory([mem]), mem, gen,
                             np.random.default_rng(params.random_seed),
                             n_poses=3, surface_epsilon=2 * 0.075)
    assert traj == ref
    assert len(traj["coverage"]) == 4
    assert np.all(np.diff(traj["coverage"]) >= 0)

    with open(os.path.join(out, "trajectory.json")) as f:
        assert json.load(f) == traj
    with open(os.path.join(out, "exports", "cameras.json")) as f:
        curves = json.load(f)
    assert len(curves["camera_X"]) == len(curves["camera_look"]) == 3
    pts = read_ply(os.path.join(out, "exports", "surface.ply"))
    valid = scene.surface_scene.valid.reshape(-1)
    np.testing.assert_allclose(
        pts, scene.surface_scene.points.reshape(-1, 3)[valid].numpy(),
        rtol=1e-6)

    M.draw(out, traj, scene)
    assert sorted(f for f in os.listdir(out) if f.endswith(".png")) == [
        f"step_{i:03d}.png" for i in range(4)]


def test_cli_stops_before_device_work_without_matplotlib(root, tmp_path,
                                                         monkeypatch):
    """Without matplotlib the demo CLIs stop at start, naming it, before
    any device work."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)

    def no_run(*args, **kw):
        raise AssertionError("the demo ran without its figures")

    monkeypatch.setattr(M, "run", no_run)
    monkeypatch.setattr(S, "run", no_run)
    monkeypatch.setattr(I, "build_session", no_run)
    for main, argv in ((M.main, ["--scene_dir", root]),
                       (S.main, ["--mesh", str(tmp_path / "m.obj")]),
                       (I.main, ["--scene_dir", root])):
        with pytest.raises(SystemExit, match="matplotlib"):
            main(argv + ["--device", "cpu"])


def test_demo_session_and_http(root, tmp_path):
    """DemoSession: two real steps, render's PNGs, reset; then one HTTP
    round trip (GET /, POST /step) through make_handler on port 0."""
    params = tiny_params()
    item = SceneDataset(root)[0]
    model = M.load_model(params, None, CPU, torch.Generator().manual_seed(0),
                         verbose=False)
    s = I.DemoSession(params, item, str(tmp_path), model, "cpu")
    s.step()
    s.step()
    out = s.render()
    assert out["pose"] == 2
    assert 0.0 <= out["coverage"] <= 1.0
    for k in ("rgb", "depth", "cloud", "cov"):
        assert isinstance(out[k], str) and len(out[k]) > 100  # base64 PNGs
    s.reset()
    assert s.pose == 0 and s.coverages == []

    server = ThreadingHTTPServer(("127.0.0.1", 0), I.make_handler(s))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(url + "/", timeout=60) as r:
            assert b"NBV step" in r.read()
        req = urllib.request.Request(url + "/step", method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        assert body["pose"] == 1 and "rgb" in body
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_scone_demo_run_and_draw(tmp_path):
    """The scone demo on a box mesh (the ShapeNet fixture's box, written as
    an OBJ; make_shapenet_root's GT clouds hold 128 points a view, fewer
    than the demo's n_views x pc_size, so the demo generates its own):
    GT written, coverages non-decreasing in [0, 1], distinct views, the
    JSON and the figure."""
    corners = np.array([[x, y, z] for x in (-1.0, 1.0) for y in (-1.0, 1.0)
                        for z in (-1.0, 1.0)], np.float32) * np.array(
        [1.0, 0.6, 0.8], np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = np.array([f for a, b, c, d in quads
                      for f in ((a, b, c), (a, c, d))], np.int64)
    mesh = str(tmp_path / "box" / "model.obj")
    os.makedirs(os.path.dirname(mesh))
    save_obj(mesh, Mesh(corners, faces, None))
    out = str(tmp_path / "out")
    cov, views, part_pc, part_mask = S.run(mesh, n_views=3, out=out,
                                           gt_image_size=48, device="cpu",
                                           verbose=False)
    assert os.path.exists(tmp_path / "box" / "tensors" /
                          "partial_point_clouds.npz")
    assert cov.shape == views.shape == (3,) and views[0] == 0
    assert len(set(views.tolist())) == 3
    assert np.all(np.diff(cov) >= 0) and 0 < cov[-1] <= 1
    with open(os.path.join(out, "trajectory.json")) as f:
        assert json.load(f) == {"coverage": cov.tolist(),
                                "view_idx": views.tolist()}
    assert os.path.exists(S.draw(out, cov, views, part_pc, part_mask))


@pytest.fixture
def jax_tool(monkeypatch, capsys):
    """The JAX tool's main at --trials 2 --n-pts 2000, its scorers replaced
    by recorders of their arguments (no SconeVis, no compile). Returns
    (the recorded decision states, its output JSON)."""
    import macarons_tpu.models.scone as jscone
    import macarons_tpu.scene.runtime as jR
    import macarons_tpu.utils.platform as jplatform

    states = []

    class NoVis:
        def init(self, *args):
            return {}

    def scorer(vis_model, seq_len, shared_sample=False):
        def fn(vis_vars, *args):
            if not shared_sample:
                states.append(args[:7])
            return np.zeros(args[4].R.shape[0], np.float32)
        return fn

    monkeypatch.setattr(jplatform, "configure_platform", lambda: None)
    monkeypatch.setattr(jscone, "SconeVis", NoVis)
    monkeypatch.setattr(jR, "make_coverage_gain_fn", scorer)
    monkeypatch.setattr(sys, "argv", ["shared_sample_agreement.py",
                                      "--trials", "2", "--n-pts", "2000"])
    capsys.readouterr()
    runpy.run_path(os.path.join(REPO, "data_tools",
                                "shared_sample_agreement.py"),
                   run_name="__main__")
    return states, json.loads(capsys.readouterr().out.splitlines()[-1])


def test_agreement_tool_against_jax(jax_tool):
    """The port's decision states equal the JAX tool's for the same seeds
    (numpy draws exactly, the cameras to float32 rounding), and its output
    has the JAX tool's keys."""
    states, jax_out = jax_tool
    assert len(states) == 2
    for t, jstate in enumerate(states):
        state = SSA.make_state(1000 + t, 2000, 30, CPU)
        for a, b in zip(state[:4], jstate[:4]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        cams, X, pcam = state[4:]
        jcams, jX, jpcam = jstate[4:]
        for mine, theirs in ((cams.R, jcams.R), (cams.T, jcams.T),
                             (X, jX), (pcam.R, jpcam.R), (pcam.T, jpcam.T)):
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                       rtol=1e-5, atol=1e-5)
    out = SSA.main(["--trials", "2", "--n-pts", "2000", "--device", "cpu"])
    assert set(out) == set(jax_out)
    for k in ("trials", "seq_len", "n_pts", "n_cand", "weights"):
        assert out[k] == jax_out[k]
    for k in ("argmax_agreement", "top3_agreement"):
        assert 0.0 <= out[k] <= 1.0
    assert -1.0 <= out["mean_rank_corr"] <= 1.0
