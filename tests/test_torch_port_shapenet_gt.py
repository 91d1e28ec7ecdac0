"""PyTorch port vs JAX package: ShapeNet GT generation and the dataset layer
(CPU, small sizes). The draws of the two packages cannot be matched, so the
deterministic parts are held: every pixel's back-projected depth before the
subsample (mask exact, points within 1e-5), the coverage matrix of the
same clouds (exact), the carving occupancy of the same samples (exact);
and the files each package writes load in the other's loaders. The
occupancy batch assembled from one numpy seed equals the JAX package's bit
for bit (on a root of the conftest ``shapenet_root``'s layout and sizes,
whose GT the port writes: that fixture's JAX GT takes ~100 s here). The
port's own GT on the cube is checked as the JAX package's
tests check its own (tests/test_shapenet_gen.py)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macarons_tpu.data import datasets as jD
from macarons_tpu.data import shapenet as jsng
from macarons_tpu.ops.grid_sample import sample_points_bilinear as jbilinear
from macarons_tpu.ops.projection import project_depth_back_to_3D as jback
from macarons_tpu.ops.rasterizer import rasterize as jrasterize
from macarons_tpu_torch.data import datasets as D
from macarons_tpu_torch.data import generate_shapenet_data as gen_cli
from macarons_tpu_torch.data import shapenet as sng
from macarons_tpu_torch.data.mesh_io import Mesh, save_obj
from macarons_tpu_torch.ops import rasterizer as rast
from macarons_tpu_torch.ops.view_state import get_cameras_on_sphere
from test_rasterizer import cube_mesh
from torch_port_helpers import make_shapenet_root, \
    torch_one_thread  # noqa: F401

CFG = dict(n_points_surface=512, part_pc_length=256,
           n_samples_for_occupancy=1000, n_max_samples=2000, image_size=37,
           surface_epsilon_is_constant=True, surface_epsilon=0.08)


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def cube():
    """A box (not a cube: no view sees two faces at one depth), diag-1."""
    v, f = cube_mesh(1.0)
    v = jsng.adjust_mesh_diagonally(v * jnp.array([1.0, 0.7, 0.85]), 1.0)
    return np.asarray(v), np.asarray(f)


@pytest.fixture(scope="module")
def jax_backprojection(cube):
    """The JAX package's zbuf back-projection of the 52 candidates, and its
    face ids, before the subsample."""
    verts, faces = cube
    cfg = jsng.ShapeNetGTConfig(**CFG)
    _, jcams = jsng.candidate_cameras(cfg)
    surf = jsng.adjust_mesh_diagonally(jnp.asarray(verts),
                                       cfg.surface_resolution)
    frags = jrasterize(surf, jnp.asarray(faces), jcams, (37, 37))
    jpts, jmask = jback(frags.zbuf[..., None], jcams)
    return (np.asarray(jpts / cfg.surface_resolution), np.asarray(jmask),
            np.asarray(frags.pix_to_face).reshape(52, -1))


def test_backprojection_matches(cube, jax_backprojection):
    """Mask exact; points within 1e-5 wherever the two rasterizers pick the
    same face. At a box edge through a pixel centre the float32 rounding of
    the edge functions decides the face (the JAX package's CPU program
    fuses them into FMAs): that may happen at a few pixels of the 29,780."""
    verts, faces = cube
    jpts, jmask, jfaces = jax_backprojection
    cfg = sng.ShapeNetGTConfig(**CFG)
    _, cams = sng.candidate_cameras(cfg)
    pts, mask = sng.backproject_partial_clouds(t(verts), t(faces).long(),
                                               cams, cfg)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    assert mask.any(dim=1).all()
    surf = sng.adjust_mesh_diagonally(t(verts), cfg.surface_resolution)
    fids = rast.rasterize(surf, t(faces).long(), cams, (37, 37)
                          ).pix_to_face.reshape(52, -1).numpy()
    same = fids == jfaces
    assert (~same).sum() <= 5, (~same).sum()
    m = mask.numpy() & same
    np.testing.assert_allclose(pts.numpy()[m], jpts[m], atol=1e-5, rtol=0)


def test_coverage_and_carving_match(cube, jax_backprojection):
    """The coverage matrix of the same clouds (the JAX back-projection
    subsampled in numpy) and surface points, and the carving occupancy of
    the same
    samples (the JAX package's compute_occupancy_field rebuilt from its
    public functions), through both packages: equal."""
    verts, faces = cube
    jcfg = jsng.ShapeNetGTConfig(**CFG)
    cfg = sng.ShapeNetGTConfig(**CFG)
    jpts, jmask, _ = jax_backprojection
    rs = np.random.default_rng(1)
    part = np.zeros((52, 256, 3), np.float32)
    pmask = np.zeros((52, 256), bool)
    for c in range(52):
        valid = np.flatnonzero(jmask[c])
        pick = rs.permutation(valid)[:256]
        part[c, :len(pick)] = jpts[c, pick]
        pmask[c, :len(pick)] = True
    # 8 cameras' clouds (the JAX function traces its chunk scan once per
    # camera, 0.2 s each), and a surface of 512 back-projected points.
    flat = jpts[jmask]
    surface = flat[rs.permutation(len(flat))[:512]]
    ref = np.asarray(jsng.compute_coverage_matrix(
        jnp.asarray(surface), jnp.asarray(part[::7]),
        jnp.asarray(pmask[::7]), None, jcfg))
    ours = sng.compute_coverage_matrix(t(surface), t(part[::7]),
                                       t(pmask[::7]), cfg)
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert 0 < ref.mean() < 1

    X = np.concatenate([rs.uniform(-0.5, 0.5, (1500, 3)),
                        surface[:500] + rs.normal(0, 0.03, (500, 3))]
                       ).astype(np.float32)
    cams = jsng.ortho_cameras(jcfg)
    res = jcfg.surface_resolution
    frags = jrasterize(jsng.adjust_mesh_diagonally(jnp.asarray(verts), res),
                       jnp.asarray(faces), cams, (37, 37))
    depth = frags.zbuf[..., None]
    depth = jnp.where(depth > -1, depth, 100 * res)
    Xs = jnp.broadcast_to(jnp.asarray(X)[None] * res, (6, *X.shape))
    ortho_z = jbilinear(depth, -cams.transform_points(Xs)[..., :2],
                        padding_mode="border")[..., 0]
    jocc = np.asarray(jnp.prod((cams.world_to_view(Xs)[..., 2] - ortho_z > 0)
                               .astype(jnp.float32), axis=0))
    occ = sng.carve_occupancy(t(verts), t(faces).long(), t(X), cfg)
    np.testing.assert_array_equal(occ.numpy(), jocc)
    assert 0.1 < jocc.mean() < 0.9


def test_surface_epsilon_and_distances(cube):
    """On points of a 1/16 lattice, where every squared distance (a point's
    own 0 included) is exact in float32 in both packages: the epsilon
    quantile skips the point itself, so a residual of its own distance
    would enter it."""
    X = (np.random.default_rng(2).integers(0, 48, (700, 3)) / 16
         ).astype(np.float32)
    mask = np.random.default_rng(0).uniform(size=300) < 0.7
    np.testing.assert_allclose(
        float(sng.compute_surface_epsilon(t(X), 0.9, chunk=256)),
        float(jsng.compute_surface_epsilon(jnp.asarray(X), 0.9, chunk=256)),
        rtol=1e-5)
    np.testing.assert_allclose(
        sng.min_dist_to_cloud(t(X), t(X[:300]), t(mask), chunk=256).numpy(),
        np.asarray(jsng.min_dist_to_cloud(jnp.asarray(X),
                                          jnp.asarray(X[:300]),
                                          jnp.asarray(mask), chunk=256)),
        rtol=1e-5, atol=1e-6)


def test_port_gt_on_cube_and_files_interchange(cube, tmp_path):
    """The port's GT: the surface on the box, clouds on the surface, the
    carving exact inside and out, occupied points first then the surface at
    occ 1; its files load in the JAX package's loaders, and the JAX
    package's in the port's."""
    verts, faces = cube
    cfg = sng.ShapeNetGTConfig(**dict(CFG, image_size=64))
    gt = sng.generate_mesh_gt(torch.Generator().manual_seed(0), t(verts),
                              t(faces).long(), cfg)
    half = np.abs(verts).max(axis=0)
    sp = gt["surface_points"]
    assert sp.shape == (512, 3)
    assert np.all(np.abs(np.abs(sp) - half).min(axis=1) < 1e-5)
    pc, m = gt["partial_point_cloud"], gt["partial_point_cloud_mask"]
    assert pc.shape == (52, 256, 3) and m.any(axis=1).all()
    assert np.all(np.abs(np.abs(pc[m]) - half).min(axis=1) < 2e-2)
    occ_field = gt["occupancy_field"]
    assert occ_field.shape == (1000 + 512, 4)
    pts, occ = occ_field[:1000, :3], occ_field[:1000, 3]
    assert occ[np.all(np.abs(pts) < half * 0.92, axis=-1)].mean() > 0.98
    assert occ[np.any(np.abs(pts) > half * 1.08, axis=-1)].mean() < 0.02
    np.testing.assert_array_equal(occ_field[1000:, 3], 1.0)
    assert gt["coverage"].shape == (52, 512)

    for name, writer, reader, source in (
            ("port", sng.save_mesh_gt, jD, gt),
            ("jax", jsng.save_mesh_gt, D,
             {k: v[::-1].copy() if np.ndim(v) else v
              for k, v in gt.items()})):
        model = tmp_path / name / "model.obj"
        writer(source, str(model.parent / "tensors"))
        p, mk, cov = reader.get_gt_partial_point_clouds(str(model))
        np.testing.assert_array_equal(p, source["partial_point_cloud"])
        np.testing.assert_array_equal(mk, source["partial_point_cloud_mask"])
        np.testing.assert_array_equal(cov, source["coverage"])
        X, o = reader.get_gt_occupancy_field(str(model))
        np.testing.assert_array_equal(
            np.concatenate([X, o], -1), source["occupancy_field"])
        s, eps = reader.get_gt_surface(str(model))
        np.testing.assert_array_equal(s, source["surface_points"])
        assert eps == float(source["epsilon"])


def test_generate_cli_on_cpu(cube, tmp_path, monkeypatch):
    """``python -m macarons_tpu_torch.data.generate_shapenet_data`` over a
    two-mesh root at a small image, then skipped on a second run; without a
    card its default device raises."""
    verts, faces = cube
    models = []
    for i in range(2):
        d = tmp_path / "02000000" / f"m{i}"
        d.mkdir(parents=True)
        save_obj(str(d / "model.obj"),
                 Mesh(verts * (1 + i), faces.astype(np.int32), None))
        models.append(f"02000000/m{i}/model.obj")
    (tmp_path / "train_list.json").write_text(json.dumps({"models": models}))
    (tmp_path / "val_list.json").write_text(json.dumps({"models": models[1:]}))
    conf = tmp_path / "gt.json"
    conf.write_text(json.dumps(dict(CFG, image_size=24)))
    gen_cli.main(["-c", str(conf), "--data-path", str(tmp_path),
                  "--device", "cpu"])
    for m in models:
        pc, mask, cov = D.get_gt_partial_point_clouds(str(tmp_path / m))
        assert pc.shape == (52, 256, 3) and cov.shape == (52, 512)
    assert gen_cli.generate(str(tmp_path), sng.ShapeNetGTConfig(**CFG),
                            device="cpu", verbose=False) == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        gen_cli.main(["--data-path", str(tmp_path)])


@pytest.fixture(scope="module")
def shapenet_root(tmp_path_factory):
    return make_shapenet_root(tmp_path_factory)


def test_assemble_occ_batch_matches(shapenet_root):
    """Same numpy seed, same paths: the same batch, bit for bit; and the
    validation view counts and the shuffled batches too."""
    X_cam = get_cameras_on_sphere(5, 10, 1.5, pole_cameras=True)[0].numpy()
    train = D.get_shapenet_datasets(shapenet_root)[0]
    jtrain = jD.get_shapenet_datasets(shapenet_root)[0]
    assert train.paths == jtrain.paths
    for n_views in (None, [1, 2, 2]):
        a = D.assemble_occ_batch(np.random.default_rng(3), train.paths[:3],
                                 X_cam, 1, 2, 32, 24, n_views=n_views)
        b = jD.assemble_occ_batch(np.random.default_rng(3), jtrain.paths[:3],
                                  X_cam, 1, 2, 32, 24, n_views=n_views)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(D.get_validation_n_views_list(8, 1, 5),
                                  jD.get_validation_n_views_list(8, 1, 5))
    assert (list(D.iterate_batches(train.paths, 3, shuffle=True, seed=4,
                                   epoch=2))
            == list(jD.iterate_batches(train.paths, 3, shuffle=True, seed=4,
                                       epoch=2)))
    assert len(D.CustomDataset(os.path.dirname(train.paths[0]))) == 1
