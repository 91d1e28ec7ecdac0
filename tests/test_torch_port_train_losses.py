"""The online trainer's losses and scene-state pieces: the port against the
JAX package on the CPU, values and gradients, from numpy inputs made from a
seed.

Depth: the pose, L1, regularity and photometric reconstruction losses, the
warp, SSIM, the colour jitter and the flip with its pose. SCONE: the
coverage-distribution losses and the occupancy MSE, and the SH-visibility
backward (the plain twin of the CUDA backward kernel) against ``jax.grad``
of ``compute_visibilities``, with the pole and padding cases. Scene state:
the window coverage gains, the other grid distance queries, the curricula
and the mirrored mesh with its atlas remap.

Values are held at rtol 1e-4; gradients within 1e-3 of their largest
magnitude (the B3 backward within 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macarons_tpu.data import mesh_io as jmesh
from macarons_tpu.models import depth_losses as jdl
from macarons_tpu.models import losses as jL
from macarons_tpu.models import many_depth as jmd
from macarons_tpu.models.scone import compute_visibilities as jvis
from macarons_tpu.ops.geometry import FoVCamera as JFoVCamera
from macarons_tpu.scene import depth_runtime as jdr
from macarons_tpu.scene import grid as jG
from macarons_tpu.scene import runtime as jR
from macarons_tpu_torch.data import mesh_io
from macarons_tpu_torch.models import depth_losses as dl
from macarons_tpu_torch.models import losses as L
from macarons_tpu_torch.models import many_depth as md
from macarons_tpu_torch.ops.cuda.sh_visibility import (
    sh_visibility, sh_visibility_backward, sh_visibility_backward_plain)
from macarons_tpu_torch.ops.geometry import FoVCamera
from macarons_tpu_torch.scene import depth_runtime as dr
from macarons_tpu_torch.scene import grid as G
from macarons_tpu_torch.scene import runtime as R
from torch_port_helpers import to_torch, torch_one_thread  # noqa: F401

B, A, H, W = 2, 2, 16, 24
RTOL = 1e-4
GRAD_REL = 1e-3


def leaves(x):
    return x if isinstance(x, (tuple, list)) else (x,)


def check(jfn, fn, args, grad_args=(), rtol=RTOL, grad_rel=GRAD_REL,
          atol=1e-7):
    """fn(*torch args) against jfn(*args): the value, and the gradient of
    sum(value * w) for a fixed random w in the arguments ``grad_args``."""
    ref = jax.jit(jfn)(*args)
    targs = [to_torch(a) for a in args]
    for i in grad_args:
        targs[i] = targs[i].clone().requires_grad_()
    ours = fn(*targs)
    for a, b in zip(leaves(ref), leaves(ours)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=rtol, atol=atol)
    if not grad_args:
        return
    rs = np.random.default_rng(0)
    w = rs.normal(size=np.shape(leaves(ref)[0])).astype(np.float32)

    def scalar(*g):
        full = list(args)
        for i, v in zip(grad_args, g):
            full[i] = v
        return jnp.sum(leaves(jfn(*full))[0] * w)

    jg = jax.jit(jax.grad(scalar, argnums=tuple(range(len(grad_args)))))(
        *[args[i] for i in grad_args])
    tg = torch.autograd.grad((leaves(ours)[0] * to_torch(w)).sum(),
                             [targs[i] for i in grad_args])
    for a, b in zip(jg, tg):
        a = np.asarray(a)
        assert np.abs(a).max() > 0
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=grad_rel * np.abs(a).max())


def images(rs, *shape):
    return rs.uniform(size=(*shape, 3)).astype(np.float32)


def cameras(rs, n, spread=0.05):
    """World-to-view poses near the identity, camera in front of z > 1."""
    from macarons_tpu_torch.ops.geometry import matrix_from_axis_angle

    aa = (rs.normal(size=(n, 3)) * spread).astype(np.float32)
    Rm = matrix_from_axis_angle(torch.as_tensor(aa)).numpy()
    T = (rs.normal(size=(n, 3)) * 0.1).astype(np.float32)
    return Rm, T


def test_ssim_and_l1_losses():
    rs = np.random.default_rng(1)
    x, y = images(rs, B, H, W), images(rs, B, H, W)
    check(jmd.ssim, md.ssim, (x, y), grad_args=(0, 1))
    d1 = rs.uniform(1, 5, size=(B, H, W, 1)).astype(np.float32)
    d2 = rs.uniform(1, 5, size=(B, H, W, 1)).astype(np.float32)
    m = (rs.uniform(size=(B, H, W, 1)) > 0.3).astype(np.float32)
    check(lambda a, b, c: jdl.depth_l1_loss(a, b, c, 10.0),
          lambda a, b, c: dl.depth_l1_loss(a, b, c, 10.0), (d1, d2, m),
          grad_args=(0,))
    disp = rs.uniform(0.1, 1, size=(B, H, W, 1)).astype(np.float32)
    check(jdl.regularity_loss, dl.regularity_loss, (disp, x),
          grad_args=(0, 1))


@pytest.mark.parametrize("mode", ["angle", "matrix"])
def test_pose_loss(mode):
    rs = np.random.default_rng(2)
    p, q = (rs.normal(size=(2, B, A, 6)) * 0.01).astype(np.float32)
    check(lambda a, b: jdl.pose_loss(a, b, 100.0, mode),
          lambda a, b: dl.pose_loss(a, b, 100.0, mode), (p, q),
          grad_args=(0,))


@pytest.mark.parametrize("use_mask,padding", [(True, "border"),
                                              (False, "zeros")])
def test_reconstruction_loss(use_mask, padding):
    rs = np.random.default_rng(3)
    img, alpha_img = images(rs, B, H, W), images(rs, B, A, H, W)
    mask = rs.uniform(size=(B, H, W, 1)) > 0.2
    depth = rs.uniform(2.0, 6.0, size=(B, H, W, 1)).astype(np.float32)
    R, T = cameras(rs, B)
    aR, aT = cameras(rs, B * A)

    def jfn(depth, alpha_img, img, mask, R, T, aR, aT):
        return jdl.reconstruction_loss(
            img, alpha_img, mask, JFoVCamera.create(R, T, zfar=40.0),
            JFoVCamera.create(aR, aT, zfar=40.0), depth, use_mask=use_mask,
            zfar=40.0, padding_mode=padding)

    def fn(depth, alpha_img, img, mask, R, T, aR, aT):
        return dl.reconstruction_loss(
            img, alpha_img, mask, FoVCamera.create(R, T, zfar=40.0),
            FoVCamera.create(aR, aT, zfar=40.0), depth, use_mask=use_mask,
            zfar=40.0, padding_mode=padding)

    check(jfn, fn, (depth, alpha_img, img, mask, R, T, aR, aT),
          grad_args=(0, 1))

    def jwarp(depth, alpha_img, R, T, aR, aT):
        return jdl.warp_images_to_target(
            depth, JFoVCamera.create(R, T, zfar=40.0), alpha_img,
            JFoVCamera.create(aR, aT, zfar=40.0), padding_mode=padding)

    def warp(depth, alpha_img, R, T, aR, aT):
        return dl.warp_images_to_target(
            depth, FoVCamera.create(R, T, zfar=40.0), alpha_img,
            FoVCamera.create(aR, aT, zfar=40.0), padding_mode=padding)

    check(jwarp, warp, (depth, alpha_img, R, T, aR, aT), grad_args=(0, 1),
          atol=1e-5)


def test_augmentation():
    rs = np.random.default_rng(4)
    x = images(rs, B, A, H, W)
    factors = (1.15, 0.85, 1.1, -0.04)
    check(lambda v: jdr.adjust_image(v, *factors),
          lambda v: dr.adjust_image(v, *factors), (x,), grad_args=(0,),
          atol=1e-6)
    # The factors from the JAX package's uniforms (its key split) are its.
    key = jax.random.PRNGKey(3)
    u = [float(jax.random.uniform(k, ())) for k in jax.random.split(key, 4)]
    ref = jdr.sample_jitter_factors(key, jdr.DepthBatchConfig())
    np.testing.assert_allclose(dr.jitter_factors(dr.DepthBatchConfig(), u),
                               [float(f) for f in ref], rtol=1e-6)
    R, T = cameras(rs, B * A, spread=0.3)
    R, T = R.reshape(B, A, 3, 3), T.reshape(B, A, 3)
    m = rs.uniform(size=(B, A, H, W, 1)) > 0.5
    check(lambda *a: jdr.apply_symmetry(*a), lambda *a: dr.apply_symmetry(*a),
          (x, R, T, m))


def test_scone_losses():
    rs = np.random.default_rng(5)
    x, y = rs.uniform(0.1, 2.0, size=(2, 3, 6, 1)).astype(np.float32)
    for jfn, fn in ((jL.kl_div_ce, L.kl_div_ce),
                    (jL.l1_normalized, L.l1_normalized),
                    (jL.uncentered_l1, L.uncentered_l1)):
        check(jfn, fn, (x, y), grad_args=(0,))
    p, t = rs.uniform(size=(2, 4, 50, 1)).astype(np.float32)
    mask = rs.uniform(size=(4, 50)) > 0.4
    check(jL.occupancy_mse, L.occupancy_mse, (p, t, mask), grad_args=(0,))
    check(jL.occupancy_mse, L.occupancy_mse, (p, t), grad_args=(0,))


def sh_inputs(rs, Bb, C, Lp):
    pts = rs.normal(size=(Bb, Lp, 4)).astype(np.float32)
    h = rs.normal(size=(Bb, Lp, 64)).astype(np.float32)
    X = (rs.normal(size=(Bb, C, 3)) * 3).astype(np.float32)
    # Poles (the ray along +-y), a camera on a point, and padding at 1e6.
    pts[:, 0, :3] = X[:, 0] - np.array([0.0, 2.0, 0.0], np.float32)
    pts[:, 1, :3] = X[:, 0] + np.array([0.0, 1e-4, 0.0], np.float32)
    pts[:, 2, :3] = X[:, 0]
    pts[:, -2:, :3] = 1e6
    return pts, h, X


@pytest.mark.parametrize("use_sigmoid", [True, False])
@pytest.mark.parametrize("shape", [(4, 1, 64), (1, 4, 64)])
def test_sh_visibility_backward(use_sigmoid, shape):
    """The plain backward of B3 against jax.grad of the JAX package's
    compute_visibilities, within 1e-4 of the largest gradient; autograd of
    the plain forward agrees with it too."""
    rs = np.random.default_rng(6)
    pts, h, X = sh_inputs(rs, *shape)
    g = rs.normal(size=(shape[0], shape[1], shape[2])).astype(np.float32)

    def jloss(h):
        return jnp.sum(jvis(pts, h, X, use_sigmoid=use_sigmoid) * g)

    ref = np.asarray(jax.jit(jax.grad(jloss))(h))
    out = sh_visibility(to_torch(pts), to_torch(h), to_torch(X),
                        use_sigmoid=use_sigmoid)
    plain = sh_visibility_backward_plain(to_torch(pts), to_torch(X), out,
                                         to_torch(g), use_sigmoid)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(plain.numpy(), ref, rtol=0, atol=1e-4 * scale)
    th = to_torch(h).requires_grad_()
    auto, = torch.autograd.grad(
        (sh_visibility(to_torch(pts), th, to_torch(X), use_sigmoid)
         * to_torch(g)).sum(), th)
    np.testing.assert_allclose(auto.numpy(), ref, rtol=0, atol=1e-4 * scale)
    np.testing.assert_array_equal(
        sh_visibility_backward(to_torch(pts), to_torch(X), out, to_torch(g),
                               use_sigmoid).numpy(), plain.numpy())


def test_sh_visibility_grad_only_in_coefficients():
    rs = np.random.default_rng(7)
    pts, h, X = (to_torch(a) for a in sh_inputs(rs, 1, 2, 8))
    with pytest.raises(ValueError, match="coefficients"):
        sh_visibility(pts.requires_grad_(), h, X)
    with pytest.raises(ValueError, match="coefficients"):
        sh_visibility(pts.detach(), h, X.requires_grad_())
    with torch.no_grad():  # without grad nothing is differentiated
        sh_visibility(pts, h, X)


def small_grid(rs, cfg, fill=0.6):
    C, K = cfg.n_cells, cfg.capacity
    pts = rs.uniform(-1.0, 1.0, size=(C, K, 3)).astype(np.float32)
    feat = (rs.uniform(size=(C, K, 1)) > 0.5).astype(np.float32)
    valid = rs.uniform(size=(C, K)) < fill
    return pts, feat, valid


def test_window_coverage_gains():
    rs = np.random.default_rng(8)
    jcfg = jG.make_grid_config((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), 2, 2, 2,
                               capacity=96, feature_dim=1)
    cfg = G.GridConfig(*jcfg)
    state = small_grid(rs, jcfg)
    pcs = rs.uniform(-1.2, 1.2, size=(4, 300, 3)).astype(np.float32)
    masks = rs.uniform(size=(4, 300)) > 0.2
    eps = 0.1
    jg, jstate = jG.window_coverage_gains(jcfg, jG.GridState(*state), pcs,
                                          masks, surface_epsilon=eps)
    g, st = G.window_coverage_gains(
        cfg, G.GridState(*(to_torch(a) for a in state)), to_torch(pcs),
        to_torch(masks), surface_epsilon=eps)
    assert np.asarray(jg).min() > 0
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(st.features.numpy(),
                                  np.asarray(jstate.features))
    jgain, jst2 = jG.camera_coverage_gain(jcfg, jG.GridState(*state), pcs[0],
                                          masks[0], surface_epsilon=eps)
    gain, st2 = G.camera_coverage_gain(
        cfg, G.GridState(*(to_torch(a) for a in state)), to_torch(pcs[0]),
        to_torch(masks[0]), surface_epsilon=eps)
    assert float(gain) == float(jgain) > 0
    np.testing.assert_array_equal(st2.features.numpy(),
                                  np.asarray(jst2.features))
    q = rs.uniform(-1.0, 1.0, size=(500, 3)).astype(np.float32)
    np.testing.assert_allclose(
        G.min_dist_to_stored(cfg, G.GridState(*(to_torch(a) for a in state)),
                             to_torch(q), chunk=128).numpy(),
        np.asarray(jG.min_dist_to_stored(jcfg, jG.GridState(*state), q)),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_poses", [2, 7, 100])
def test_curricula(n_poses):
    np.testing.assert_array_equal(
        R.curriculum_sampling_distances(n_poses, 0.05, (0.4, 0.5, 0.3)),
        jR.curriculum_sampling_distances(n_poses, 0.05, (0.4, 0.5, 0.3)))
    np.testing.assert_array_equal(
        R.curriculum_sampling_cell_number(n_poses, 5, 20),
        jR.curriculum_sampling_cell_number(n_poses, 5, 20))


@pytest.mark.parametrize("spread", [0.0, 1e-6, 1e-2])
def test_relative_pose_round_trip_conditioning(spread):
    """The depth step's pose vector (the relative rotation's axis-angle,
    through 2 arccos(w)) and the alpha rotation ManyDepth rebuilds from it,
    for alpha cameras within ``spread`` rad of the target's orientation
    (0: the same orientation, as an interpolated move's frames can share).
    Near the identity the angle and the axis's 1 / sin(angle / 2) move
    together, so an ulp of rounding in the cameras, as another device's,
    moves both by ulps and not by sqrt(ulp); float32 within 1e-6 of
    float64 and of the JAX package."""
    from macarons_tpu_torch.ops.geometry import matrix_from_axis_angle

    rs = np.random.default_rng(11)
    n = 256
    aa = rs.normal(size=(n, 3))
    T = rs.normal(size=(n, 3))
    aa_alpha = aa + spread * rs.normal(size=(n, 3))
    T_alpha = T + 0.1 * rs.normal(size=(n, 1, 3))[:, 0]
    as64 = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    R64, Ra64 = matrix_from_axis_angle(as64(aa)), matrix_from_axis_angle(
        as64(aa_alpha))[:, None]
    pose64 = dl.convert_matrix_to_pose(R64, as64(T), Ra64,
                                       as64(T_alpha)[:, None], 1.0)
    R32, Ra32 = R64.float(), Ra64.float()
    ulps = torch.as_tensor(rs.integers(-1, 2, size=(n, 3, 3)),
                           dtype=torch.float32)
    R32p = R32 * (1.0 + ulps * float(np.finfo(np.float32).eps))
    T32, Ta32 = as64(T).float(), as64(T_alpha)[:, None].float()
    pose32 = dl.convert_matrix_to_pose(R32, T32, Ra32, Ta32, 1.0)
    pose32p = dl.convert_matrix_to_pose(R32p, T32, Ra32, Ta32, 1.0)
    jpose = jdl.convert_matrix_to_pose(*(jnp.asarray(t.numpy()) for t in
                                         (R32, T32, Ra32, Ta32)), 1.0)
    for p in (pose32, pose32p, torch.as_tensor(np.array(jpose))):
        assert float((p.double() - pose64)[..., 3:].abs().max()) < 1e-6
        rebuilt = matrix_from_axis_angle(p[..., 3:].float()).double()
        assert float((rebuilt - matrix_from_axis_angle(
            pose64[..., 3:])).abs().max()) < 1e-6


@pytest.mark.parametrize("axes", [[0], [0, 1], [2]])
def test_mirror_mesh(axes):
    rs = np.random.default_rng(9)
    verts = rs.normal(size=(30, 3)).astype(np.float32)
    faces = rs.integers(0, 30, size=(40, 3))
    colors = rs.uniform(size=(30, 3)).astype(np.float32)
    atlas = rs.uniform(size=(40, 5, 5, 3)).astype(np.float32)
    ref = jmesh.mirror_mesh(jmesh.Mesh(verts, faces, colors, atlas), axes)
    ours = mesh_io.mirror_mesh(mesh_io.Mesh(verts, faces, colors, atlas), axes)
    for a, b in zip(ref, ours):
        np.testing.assert_array_equal(b, a)
    if len(axes) % 2:
        assert not np.array_equal(ours.texture_atlas, atlas)


def test_warmup_rate():
    """The trainer's per-step learning rate (steps from 1) against the JAX
    trainer's, through the warm-up and past it."""
    from macarons_tpu.trainers.train_macarons import MacaronsRuntime as JRT
    from macarons_tpu_torch.utils import schedule as S

    for warmup in (1, 4, 200):
        for step in range(1, 300, 7):
            assert S.warmup_rate(1e-3, step, warmup) == JRT._warmup_rate(
                1e-3, step, warmup)
    assert [S.warmup_rate(1e-3, s, 4) for s in (1, 4, 9)] == [2.5e-4, 1e-3,
                                                             1e-3]
