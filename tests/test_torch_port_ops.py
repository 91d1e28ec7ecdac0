"""PyTorch port vs JAX package: geometry, harmonics, projection, grid_sample,
kNN, view-state bins, the scan rasterizer and the scene grid, on the same
seeded numpy inputs (CPU). Tolerances are PARITY.md's float32 levels."""

import os
import re

import jax.numpy as jnp
import numpy as np
import torch

from macarons_tpu.ops import geometry as jgeo
from macarons_tpu.ops import grid_sample as jgs
from macarons_tpu.ops import harmonics as jharm
from macarons_tpu.ops import knn as jknn
from macarons_tpu.ops import projection as jproj
from macarons_tpu.ops import rasterizer as jrast
from macarons_tpu.ops import view_state as jvs
from macarons_tpu.scene import camera as jcam
from macarons_tpu.scene import grid as jgrid
from macarons_tpu.scene import runtime as jrt
from macarons_tpu_torch.ops import geometry as geo
from macarons_tpu_torch.ops import grid_sample as gs
from macarons_tpu_torch.ops import harmonics as harm
from macarons_tpu_torch.ops import knn
from macarons_tpu_torch.ops import projection as proj
from macarons_tpu_torch.ops import rasterizer as rast
from macarons_tpu_torch.ops import view_state as vs
from macarons_tpu_torch.scene import camera as cam
from macarons_tpu_torch.scene import grid as grid
from macarons_tpu_torch.scene import runtime as rt
from torch_port_helpers import camera_to_torch, grid_to_torch, \
    torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|macarons_tpu(?!_torch)|data_tools"
    r"|torch_oracles)\b",
    re.M)


def t(x):
    return torch.as_tensor(np.array(x))


def cameras(rng, n):
    """Random look-at cameras around the origin, from the JAX package and as
    port FoVCameras (same R, T)."""
    X = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    X[:, 1] = np.abs(X[:, 1]) + 1.0
    V = np.stack([rng.uniform(-60, 0, n), rng.uniform(0, 360, n)],
                 -1).astype(np.float32)
    R, T = jcam.get_camera_RT(jnp.asarray(X), jnp.asarray(V))
    jc = jgeo.FoVCamera.create(R, T, zfar=40.0)
    return X, V, jc, camera_to_torch(jc)


def test_port_imports_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(os.path.join(REPO, "macarons_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]  # kernel builds, scratch
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = [f for f in files if FORBIDDEN.search(open(f).read())]
    assert len(files) > 20 and not bad, bad


def test_camera_rt_and_projection(rng):
    X, V, jc, tc = cameras(rng, 6)
    R, T = cam.get_camera_RT(t(X), t(V))
    np.testing.assert_allclose(R.numpy(), np.asarray(jc.R), atol=1e-6)
    np.testing.assert_allclose(T.numpy(), np.asarray(jc.T), atol=1e-5)
    pts = rng.normal(size=(6, 50, 3)).astype(np.float32) * 3
    np.testing.assert_allclose(tc.transform_points(t(pts)).numpy(),
                               np.asarray(jc.transform_points(pts)),
                               rtol=1e-5, atol=1e-5)
    ndc = rng.uniform(-1, 1, (6, 50, 3)).astype(np.float32)
    ndc[..., 2] = rng.uniform(1, 20, (6, 50))
    np.testing.assert_allclose(tc.unproject_ndc_depth(t(ndc)).numpy(),
                               np.asarray(jc.unproject_ndc_depth(ndc)),
                               atol=2e-5)
    for a, b in zip(geo.ndc_pixel_grid(7, 11), jgeo.ndc_pixel_grid(7, 11)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)
    assert geo.ndc_bounds(32, 48) == jgeo.ndc_bounds(32, 48)


def test_spherical_harmonics(rng):
    rays = rng.normal(size=(500, 3)).astype(np.float32)
    # azim = acos(.) is ill-conditioned near 0 and pi (PARITY.md: 1.3e-3
    # against float64), hence its looser bound.
    for a, b, tol in zip(geo.get_spherical_coords(t(rays)),
                         jgeo.get_spherical_coords(rays), (1e-5, 1e-5, 1e-4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol)
    # The materialised basis goes through azim = acos(.) (see above).
    np.testing.assert_allclose(
        harm.harmonics_from_directions(t(rays)).numpy(),
        np.asarray(jharm.harmonics_from_directions(rays)), atol=1e-4)
    coeffs = rng.normal(size=(500, 64)).astype(np.float32)
    np.testing.assert_allclose(
        harm.sh_weighted_sum(t(rays), t(coeffs)).numpy(),
        np.asarray(jharm.sh_weighted_sum(rays, coeffs)), atol=2e-5)
    theta = rng.uniform(0, np.pi, 64)
    phi = rng.uniform(-np.pi, np.pi, 64)
    np.testing.assert_allclose(harm.real_spherical_harmonics_np(theta, phi),
                               jharm.real_spherical_harmonics_np(theta, phi),
                               atol=1e-6)


def test_projection_and_grid_sample(rng):
    _, _, jc, tc = cameras(rng, 2)
    H, W = 12, 18
    depth = rng.uniform(2, 15, (2, H, W, 1)).astype(np.float32)
    depth[:, :3] = -1.0
    for a, b in zip(proj.project_depth_back_to_3D(t(depth), tc),
                    jproj.project_depth_back_to_3D(depth, jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)
    pts = rng.normal(size=(2, 400, 3)).astype(np.float32) * 4
    np.testing.assert_array_equal(
        proj.points_in_fov_mask(t(pts), tc, H, W, fov_range=12.0).numpy(),
        np.asarray(jproj.points_in_fov_mask(pts, jc, H, W, fov_range=12.0)))
    mask = depth > 0
    np.testing.assert_allclose(
        proj.signed_distance_to_depth_maps(t(pts), t(depth), t(mask), tc,
                                           40.0).numpy(),
        np.asarray(jproj.signed_distance_to_depth_maps(pts, depth, mask, jc,
                                                       40.0)),
        rtol=1e-5, atol=2e-5)
    img = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    grid_xy = rng.uniform(-1.2, 1.2, (2, 5, 7, 2)).astype(np.float32)
    for pad in ("border", "zeros"):
        np.testing.assert_allclose(
            gs.grid_sample(t(img), t(grid_xy), padding_mode=pad).numpy(),
            np.asarray(jgs.grid_sample(img, grid_xy, padding_mode=pad)),
            atol=1e-5)


def test_knn_exact(rng):
    x = rng.normal(size=(2, 40, 3)).astype(np.float32)
    pc = rng.normal(size=(2, 300, 3)).astype(np.float32)
    g, d, i = knn.knn_points(t(x), t(pc), 8)
    jg, jd, ji = jknn.knn_points(x, pc, 8)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=0)
    np.testing.assert_allclose(
        knn.pairwise_sqdist(t(x), t(pc)).numpy(),
        np.asarray(jknn.pairwise_sqdist(x, pc)), atol=1e-5)


def test_view_state_bins_exact(rng):
    # Bins of identical angles are bit-exact, both clamp variants, on a dense
    # grid through every bin edge and the poles.
    elev = np.linspace(-np.pi / 2, np.pi / 2, 181).astype(np.float32)
    azim = np.linspace(-np.pi, np.pi, 181).astype(np.float32)
    ee, aa = (a.reshape(-1) for a in np.meshgrid(elev, azim, indexing="ij"))
    ee = np.concatenate([ee, rng.uniform(-np.pi / 2, np.pi / 2, 150000)
                         .astype(np.float32)])
    aa = np.concatenate([aa, rng.uniform(-np.pi, np.pi, 150000)
                         .astype(np.float32)])
    for clamp in (6, 3):
        np.testing.assert_array_equal(
            vs._bin_directions(t(ee), t(aa), 7, 14, clamp).numpy(),
            np.asarray(jvs._bin_directions(jnp.asarray(ee), jnp.asarray(aa),
                                           7, 14, elev_upper_clamp=clamp)))
    # From rays, the angles themselves differ by float32 ulps (acos), which
    # can move a ray that sits on a bin edge: at most 1e-4 of the bins.
    pts = rng.normal(size=(1, 3000, 3)).astype(np.float32) * 3
    X_view = rng.normal(size=(6, 3)).astype(np.float32) * 5
    X_view[0] = [0.0, 20.0, 0.0]  # straight overhead: pole bins
    X_view[1] = [0.0, -20.0, 0.0]
    ours = vs.compute_view_state(t(pts), t(X_view), 7, 14).numpy()
    ref = np.asarray(jvs.compute_view_state(pts, X_view, 7, 14))
    assert np.mean(ours != ref) < 1e-4
    for i in range(3):
        _, _, jc, tc = cameras(rng, 1)
        np.testing.assert_array_equal(
            vs.view_space_permutation(tc, 7, 14).numpy(),
            np.asarray(jvs.view_space_permutation(jc, 7, 14)))
    hist = (rng.uniform(size=(2, 50, 98)) > 0.7).astype(np.float32)
    base, h_polar, _ = jvs.get_all_harmonics_under_degree(8, 7, 14)
    np.testing.assert_allclose(
        vs.compute_view_harmonics(t(hist), vs.view_harmonics_weights(
            8, 7, 14, "cpu")).numpy(),
        np.asarray(jvs.compute_view_harmonics(hist, base, h_polar, 7, 14)),
        atol=1e-5)


def test_scan_rasterizer_pix_to_face(rng, monkeypatch):
    from macarons_tpu_torch.data.synthetic_suite import build_scene_mesh

    mesh = build_scene_mesh(1000)
    verts = mesh.verts.astype(np.float32)
    X = np.array([[6.0, 4.0, 6.0], [-5.0, 2.5, 3.0]], np.float32)
    V = np.array([[-25.0, 225.0], [-15.0, 120.0]], np.float32)
    R, T = jcam.get_camera_RT(jnp.asarray(X), jnp.asarray(V))
    jc = jgeo.FoVCamera.create(R, T, zfar=40.0)
    jf = jrast.rasterize(jnp.asarray(verts), jnp.asarray(mesh.faces), jc,
                         (32, 48), chunk=64, method="scan")
    tf = rast.rasterize(t(verts), t(mesh.faces).long(),
                        camera_to_torch(jc), (32, 48), chunk=64)
    np.testing.assert_array_equal(tf.pix_to_face.numpy(),
                                  np.asarray(jf.pix_to_face))
    np.testing.assert_allclose(tf.zbuf.numpy(), np.asarray(jf.zbuf),
                               atol=1e-4)
    np.testing.assert_allclose(tf.bary.numpy(), np.asarray(jf.bary),
                               atol=1e-4)
    assert (tf.pix_to_face >= 0).float().mean() > 0.2
    # Above 4 * max_faces_per_tile faces, "auto" takes the binned path on the
    # CPU (the JAX package's choice off the TPU).
    binned = rast._rasterize_single_binned
    calls = []
    monkeypatch.setattr(rast, "_rasterize_single_binned",
                        lambda *a, **k: calls.append(a[1].shape) or binned(
                            *a, **k))
    big = torch.as_tensor(np.resize(mesh.faces, (4097, 3))).long()
    frags = rast.rasterize(t(verts), big, camera_to_torch(jc), (32, 48))
    assert calls == [(4097, 3)] * 2
    np.testing.assert_array_equal(frags.pix_to_face.numpy() % 232,
                                  tf.pix_to_face.numpy() % 232)


def test_grid_fill_and_coverage(rng):
    cfg = jgrid.make_grid_config((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), 3, 2, 2,
                                 capacity=300, resolution=0.05, feature_dim=1)
    tcfg = grid.make_grid_config((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), 3, 2, 2,
                                 capacity=300, resolution=0.05, feature_dim=1)
    assert tcfg == cfg
    pts = rng.uniform(-1.1, 1.1, (900, 3)).astype(np.float32)
    np.testing.assert_array_equal(grid.cell_index(tcfg, t(pts)).numpy(),
                                  np.asarray(jgrid.cell_index(cfg, pts)))
    import jax

    # Below capacity, the kept set does not depend on the random draws.
    js = jgrid.fill_cells(cfg, jgrid.empty_grid(cfg), jax.random.PRNGKey(0),
                          jnp.asarray(pts[:450]))
    js = jgrid.fill_cells(cfg, js, jax.random.PRNGKey(1),
                          jnp.asarray(pts[300:]))
    gen = torch.Generator().manual_seed(0)
    ts = grid.fill_cells(tcfg, grid.empty_grid(tcfg), gen, t(pts[:450]))
    ts = grid.fill_cells(tcfg, ts, gen, t(pts[300:]))

    def kept(points, valid):
        p = np.asarray(points).reshape(-1, 3)[np.asarray(valid).reshape(-1)]
        return p[np.lexsort(p.T)]

    np.testing.assert_array_equal(kept(ts.points, ts.valid),
                                  kept(js.points, js.valid))
    gt = jgrid.fill_cells(cfg, jgrid.empty_grid(cfg), jax.random.PRNGKey(2),
                          jnp.asarray(rng.uniform(-1, 1, (600, 3)),
                                      jnp.float32))
    cov, n = grid.scene_coverage(tcfg, grid_to_torch(gt), ts,
                                 surface_epsilon=0.1)
    jcov, jn = jgrid.scene_coverage(cfg, gt, js, surface_epsilon=0.1)
    assert int(n) == int(jn) and abs(float(cov) - float(jcov)) < 1e-6


def test_cell_index_table(rng):
    cfg = jgrid.make_grid_config((-2.0, 0.0, -2.0), (2.0, 1.5, 2.0), 4, 3, 4,
                                 capacity=100, resolution=0.1)
    pts = rng.uniform([-2, 0, -2], [2, 1.5, 2], (3000, 3)).astype(np.float32)
    a = rt.build_cell_index_table(grid.GridConfig(*cfg), pts)
    b = jrt.build_cell_index_table(cfg, pts)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
