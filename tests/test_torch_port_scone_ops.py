"""PyTorch port vs JAX package: the ops the SCONE pretraining lane adds
(CPU, seeded numpy inputs): the orthographic camera, the sphere camera
lattices, view states with view masks and per-cloud cameras, the view-space
move, the proxy filter, the rasterizer under an orthographic camera (scan
and binned), the samplers with their draws injected (and their
distributions), cdist and ray kNN. Functions agree to float32 1e-5; face
ids, bins and masks exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macarons_tpu.ops import geometry as jgeo
from macarons_tpu.ops import knn as jknn
from macarons_tpu.ops import rasterizer as jrast
from macarons_tpu.ops import sampling as jsamp
from macarons_tpu.ops import view_state as jvs
from macarons_tpu_torch.data.synthetic_suite import build_scene_mesh
from macarons_tpu_torch.ops import geometry as geo
from macarons_tpu_torch.ops import knn
from macarons_tpu_torch.ops import rasterizer as rast
from macarons_tpu_torch.ops import sampling as samp
from macarons_tpu_torch.ops import view_state as vs
from test_rasterizer import cube_mesh
from torch_port_helpers import camera_to_torch, torch_one_thread  # noqa: F401

RTOL = 1e-5


def t(x):
    return torch.as_tensor(np.array(x))


def close(a, b, tol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * max(
        1.0, float(np.abs(b).max())))


def ortho_pair(rng, n):
    X = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    X[:, 1] = np.abs(X[:, 1]) + 0.5
    R, T = jgeo.look_at_view_transform(eye=jnp.asarray(X))
    jc = jgeo.OrthoCamera.create(R, T, znear=0.01, zfar=10.0)
    return jc, geo.OrthoCamera(*(t(a) for a in jc))


def test_ortho_camera(rng):
    jc, tc = ortho_pair(rng, 4)
    pts = rng.normal(size=(4, 50, 3)).astype(np.float32)
    close(tc.world_to_view(t(pts)), jc.world_to_view(jnp.asarray(pts)))
    close(tc.view_to_world(t(pts)), jc.view_to_world(jnp.asarray(pts)))
    close(tc.project_view(t(pts)), jc.project_view(jnp.asarray(pts)))
    close(tc.transform_points(t(pts)), jc.transform_points(jnp.asarray(pts)))
    close(tc.unproject_ndc_depth(t(pts)),
          jc.unproject_ndc_depth(jnp.asarray(pts)))
    close(tc.camera_center(), jc.camera_center())
    c2 = geo.OrthoCamera.create(tc.R, tc.T, znear=0.01, zfar=10.0)
    close(c2.project_view(t(pts)), jc.project_view(jnp.asarray(pts)))


def test_sphere_lattices():
    close(geo.sample_cameras_on_sphere(49, 1.5),
          jgeo.sample_cameras_on_sphere(49, 1.5))
    for poles in (False, True):
        ours = vs.get_cameras_on_sphere(5, 10, 1.5, pole_cameras=poles)
        ref = jvs.get_cameras_on_sphere(5, 10, 1.5, pole_cameras=poles)
        for a, b in zip(ours, ref):
            close(a, b)
    for a, b in zip(vs.sphere_grid_angles(7, 14),
                    jvs.sphere_grid_angles(7, 14)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    a, b = np.float32([[1, 2, 3]]), np.float32([[0.5, -1, 2]])
    close(geo.dot_prod(t(a), t(b), keepdim=True),
          jgeo.dot_prod(jnp.asarray(a), jnp.asarray(b), keepdims=True))


@pytest.mark.parametrize("mask_rank", [0, 1, 2])
def test_view_state_masks_and_cloud_cameras(rng, mask_rank):
    """Shared cameras with no mask or a (V,) mask; per-cloud cameras with
    a (B, V) mask: the bins equal the JAX package's."""
    B, L, V = 3, 200, 5
    pts = rng.normal(size=(B, L, 3)).astype(np.float32) * 0.4
    X_view = (rng.normal(size=(V, 3)) * 1.5).astype(np.float32)
    mask = None
    if mask_rank == 1:
        mask = np.array([True, False, True, True, False])
    if mask_rank == 2:
        X_view = (rng.normal(size=(B, V, 3)) * 1.5).astype(np.float32)
        mask = rng.uniform(size=(B, V)) < 0.6
    ref = jvs.compute_view_state(jnp.asarray(pts), jnp.asarray(X_view), 7, 14,
                                 view_mask=None if mask is None
                                 else jnp.asarray(mask))
    ours = vs.compute_view_state(t(pts), t(X_view), 7, 14,
                                 view_mask=None if mask is None else t(mask))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    old = np.asarray(ref)[..., ::-1].copy()
    pm = rng.uniform(size=(B, L)) < 0.5
    np.testing.assert_array_equal(
        vs.update_view_state(t(old), t(pts), t(X_view[..., -2:, :]
                                               if mask_rank == 2 else X_view),
                             7, 14, pts_mask=t(pm).float()).numpy(),
        np.asarray(jvs.update_view_state(
            jnp.asarray(old), jnp.asarray(pts),
            jnp.asarray(X_view[..., -2:, :] if mask_rank == 2 else X_view),
            7, 14, pts_mask=jnp.asarray(pm, jnp.float32))))


def test_move_view_state_and_filter(rng):
    X_view = (rng.normal(size=(4, 3)) * 1.5).astype(np.float32)
    R, T = jgeo.look_at_view_transform(eye=jnp.asarray(X_view),
                                       at=jnp.zeros((4, 3)))
    jc = jgeo.FoVCamera.create(R, T, zfar=1000.0)
    tc = camera_to_torch(jc)
    state = (rng.uniform(size=(2, 30, 98)) < 0.3).astype(np.float32)
    np.testing.assert_array_equal(
        vs.move_view_state_to_view_space(t(state), tc[1:2], 7, 14).numpy(),
        np.asarray(jvs.move_view_state_to_view_space(
            jnp.asarray(state), jgeo.FoVCamera(*(a[1:2] for a in jc)), 7,
            14)))
    Xp = rng.uniform(-0.6, 0.6, (500, 3)).astype(np.float32)
    pc = rng.uniform(-0.3, 0.3, (80, 3)).astype(np.float32)
    pc_mask = rng.uniform(size=80) < 0.8
    view_mask = np.array([True, True, False, True])
    for kw in ({}, {"pc_mask": pc_mask}, {"pc_mask": pc_mask,
                                          "view_mask": view_mask}):
        ref = jvs.filter_proxy_points_mask(
            jc, jnp.asarray(Xp), jnp.asarray(pc), filter_tol=0.01,
            **{k: jnp.asarray(v) for k, v in kw.items()})
        ours = vs.filter_proxy_points_mask(
            tc, t(Xp), t(pc), filter_tol=0.01,
            **{k: t(v) for k, v in kw.items()})
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        assert 0 < int(ours.sum()) < 500


def meshes():
    v, f = cube_mesh(0.5)
    synth = build_scene_mesh(1000)
    sv = synth.verts - (synth.verts.max(0) + synth.verts.min(0)) / 2
    sv = sv / np.linalg.norm(synth.verts.max(0) - synth.verts.min(0))
    return {"cube": (np.asarray(v), np.asarray(f)),
            "synth_00": (sv.astype(np.float32), synth.faces)}


@pytest.mark.parametrize("name", ["cube", "synth_00"])
@pytest.mark.parametrize("method", ["scan", "binned"])
def test_rasterize_ortho(name, method):
    """The 6 GT carving cameras and 2 oblique ones at 1.5 x scale, on an
    image whose pixel centres meet no cube edge or face diagonal: face ids
    exact; zbuf within 1e-6 under the carving cameras (faces parallel to
    the image: constant z), and within 1e-5 relative under the oblique ones
    (the JAX package's CPU program fuses the edge functions' products into
    FMAs; over the cube's large faces that moves z by up to 2.98e-06, as
    test_torch_port_raster.py's ATOL allows)."""
    verts, faces = meshes()[name]
    verts = verts * 1.5
    elev = jnp.array([0.0, 0.0, 0.0, 0.0, 90.0, -90.0, 30.0, -20.0])
    azim = jnp.array([0.0, 90.0, 180.0, 270.0, 0.0, 0.0, 45.0, 200.0])
    R, T = jgeo.look_at_view_transform(dist=jnp.full_like(elev, 1.5),
                                       elev=elev, azim=azim)
    jc = jgeo.OrthoCamera.create(R, T, znear=0.01, zfar=10.0)
    ref = jrast.rasterize(jnp.asarray(verts), jnp.asarray(faces), jc,
                          (37, 41), method=method, max_faces_per_tile=64)
    ours = rast.rasterize(t(verts), t(faces).long(),
                          geo.OrthoCamera(*(t(a) for a in jc)), (37, 41),
                          method=method, max_faces_per_tile=64)
    np.testing.assert_array_equal(ours.pix_to_face.numpy(),
                                  np.asarray(ref.pix_to_face))
    np.testing.assert_allclose(ours.zbuf[:6].numpy(),
                               np.asarray(ref.zbuf)[:6], atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours.zbuf[6:].numpy(),
                               np.asarray(ref.zbuf)[6:], atol=0, rtol=1e-5)
    assert (ours.pix_to_face >= 0).float().mean() > 0.05
    with pytest.raises(TypeError):
        rast.rasterize(t(verts), t(faces).long(), object(), (8, 8))


def test_samplers_with_draws(rng):
    verts, faces = meshes()["synth_00"]
    F = faces.shape[0]
    n = 500
    u = rng.uniform(size=n).astype(np.float32)
    alpha, beta = (rng.uniform(size=(n, 1)).astype(np.float32)
                   for _ in range(2))
    # sample_mesh_triangle's inverse CDF with the same draws u.
    areas = np.asarray(jsamp.compute_mesh_face_area(jnp.asarray(verts),
                                                    jnp.asarray(faces)))
    cdf = np.asarray(jnp.cumsum(jnp.asarray(areas)))
    cdf = cdf / cdf[-1]
    jidx = np.clip(np.searchsorted(cdf, u), 0, F - 1)
    idx = samp.sample_mesh_triangle(None, t(verts), t(faces).long(), n,
                                    u=t(u))
    np.testing.assert_array_equal(idx.numpy(), jidx)
    mask = rng.uniform(size=F) < 0.5
    idx_m = samp.sample_mesh_triangle(None, t(verts), t(faces).long(), n,
                                      face_mask=t(mask), u=t(u))
    assert mask[idx_m.numpy()].all()

    # The barycentric points, with the JAX sampler's own uniform draws.
    import jax

    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    ja = np.asarray(jax.random.uniform(k1, (n, 1)))
    jb = np.asarray(jax.random.uniform(k2, (n, 1)))
    feats = rng.normal(size=(verts.shape[0], 2)).astype(np.float32)
    jpts, jf = jsamp.sample_points_on_mesh_faces(
        key, jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(jidx),
        vert_features=jnp.asarray(feats))
    pts, f = samp.sample_points_on_mesh_faces(
        None, t(verts), t(faces).long(), idx, vert_features=t(feats),
        alpha=t(ja), beta=t(jb))
    close(pts, jpts)
    close(f, jf)

    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    jball = jsamp.sample_X_in_ball(jax.random.PRNGKey(4), 0.7, n)
    ball = samp.sample_X_in_ball(None, 0.7, n, normal=t(
        jax.random.normal(k1, (n, 3))), u=t(jax.random.uniform(k2, (n, 1))))
    close(ball, jball)
    jbox = jsamp.sample_X_in_box(jax.random.PRNGKey(5), 0.8, n)
    box = samp.sample_X_in_box(None, 0.8, n, u=t(
        jax.random.uniform(jax.random.PRNGKey(5), (n, 3))))
    close(box, jbox)
    x = rng.normal(size=(40, 3)).astype(np.float32)
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(6), 40))
    np.testing.assert_array_equal(
        samp.random_permutation_take(None, t(x), 7, perm=t(perm)).numpy(),
        np.asarray(jsamp.random_permutation_take(jax.random.PRNGKey(6),
                                                 jnp.asarray(x), 7)))


def test_sampler_distributions():
    """Drawn from a generator: box and ball bounds, the ball's radius law,
    and the area-weighted face choice (chi-square-like check of the
    empirical face frequencies against the areas)."""
    gen = torch.Generator().manual_seed(0)
    box = samp.sample_X_in_box(gen, 0.8, 20000)
    assert box.abs().max() <= 0.4 and box.abs().max() > 0.39
    assert abs(float(box.mean())) < 0.01
    ball = samp.sample_X_in_ball(gen, 0.7, 20000)
    r = torch.linalg.norm(ball, dim=1)
    assert float(r.max()) <= 0.7 + 1e-6
    # r = R sqrt(U): P(r < R/2) = 1/4.
    assert abs(float((r < 0.35).float().mean()) - 0.25) < 0.02
    verts, faces = meshes()["cube"]
    verts = verts * np.float32([1, 2, 3])
    v, f = t(verts), t(faces).long()
    idx = samp.sample_mesh_triangle(gen, v, f, 60000)
    areas = samp.compute_mesh_face_area(v, f)
    freq = torch.bincount(idx, minlength=12).float() / 60000
    np.testing.assert_allclose(freq.numpy(), (areas / areas.sum()).numpy(),
                               atol=0.01)
    pts = samp.sample_points_on_mesh_surface(gen, v, f, 2000)
    half = torch.tensor([0.5, 1.0, 1.5])
    assert torch.all((pts.abs() - half).abs().min(dim=1).values < 1e-5)
    p = samp.random_permutation_take(gen, torch.arange(50), 50)
    assert sorted(p.tolist()) == list(range(50))


def test_cdist_and_ray_knn(rng):
    x = rng.normal(size=(2, 30, 3)).astype(np.float32)
    y = rng.normal(size=(2, 40, 3)).astype(np.float32)
    close(knn.cdist(t(x), t(y)), jknn.cdist(jnp.asarray(x), jnp.asarray(y)))
    X_cam = rng.normal(size=(2, 3)).astype(np.float32) * 3
    pc = rng.normal(size=(2, 40, 3)).astype(np.float32)
    pc[:, 20:30] = pc[:, 0:10]  # equal rays: lower index first
    ref = jknn.get_k_nearest_ray_points(jnp.asarray(X_cam), jnp.asarray(x),
                                        jnp.asarray(pc), 6)
    ours = knn.get_k_nearest_ray_points(t(X_cam), t(x), t(pc), 6)
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))
    close(ours[0], ref[0])
    close(ours[1], ref[1])
