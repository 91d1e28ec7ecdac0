"""PyTorch port vs JAX package: the tile rasterizer kernels' plain twins
against the Pallas kernels (interpret mode), the tiled and binned
rasterization paths, and OBJ + MTL texture atlases (CPU, small sizes,
numpy-seeded inputs).

Face ids and slots must be identical; zbuf, barycentrics and atlases agree
within 1e-5 (the JAX package's CPU programs contract and reassociate float32
steps, the port rounds each step, so values differ by a few ulps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macarons_tpu.data import mesh_io as jmesh
from macarons_tpu.ops import geometry as jgeo
from macarons_tpu.ops import rasterizer as jrast
from macarons_tpu.ops.pallas.tile_raster import pallas_rasterize_pairs, \
    pallas_rasterize_tiles
from macarons_tpu_torch.data import mesh_io
from macarons_tpu_torch.ops import rasterizer as rast
from macarons_tpu_torch.ops.cuda import tile_raster as tr
from torch_port_helpers import camera_to_torch, torch_one_thread  # noqa: F401

ATOL = 1e-5
TILE = 16


def t(x):
    return torch.as_tensor(np.array(x))


def random_faces(rng, n, H, W):
    """(n, 9) NDC triangles over an H x W image with view z in [0.5, 6.3],
    a few degenerate, and the last 20 exact copies of earlier faces
    (coplanar duplicates). Faces with a vertex behind the camera never reach
    the kernels: the feeder's z test drops them (covered by the path tests
    below)."""
    s = min(H, W)
    c = np.stack([rng.uniform(-W / s - 0.1, W / s + 0.1, n),
                  rng.uniform(-H / s - 0.1, H / s + 0.1, n)], -1)
    fv = np.zeros((n, 3, 3), np.float32)
    fv[:, :, :2] = c[:, None] + rng.normal(0, 0.15, (n, 3, 2))
    fv[:, :, 2] = rng.uniform(0.5, 6.0, (n, 1)) + rng.uniform(0, 0.3, (n, 3))
    fv[60:65, 2, :2] = fv[60:65, 0, :2]
    fv[-20:] = fv[100:120]
    return fv.reshape(n, 9)


def tile_lists(fv9, H, W):
    """Per tile, the ascending ids of the faces whose box overlaps it."""
    TH, TW = -(-H // TILE), -(-W // TILE)
    bounds = [b.numpy() for b in rast._tile_bounds(H, W, TILE, "cpu")]
    x, y = fv9[:, [0, 3, 6]], fv9[:, [1, 4, 7]]
    slack = 2.0 / (min(H, W) - 1)
    ov = ((x.min(1)[None] <= bounds[0][:, None] + slack)
          & (x.max(1)[None] >= bounds[1][:, None] - slack)
          & (y.min(1)[None] <= bounds[2][:, None] + slack)
          & (y.max(1)[None] >= bounds[3][:, None] - slack))
    return [np.flatnonzero(row) for row in ov], TH, TW


def compare(ref, ours, ids_ref, ids_ours):
    zj, bj0, bj1 = (np.asarray(a)[:, 0] for a in ref)
    z, b0, b1 = (a.numpy() for a in ours)
    np.testing.assert_array_equal(ids_ours.numpy(),
                                  np.asarray(ids_ref)[:, 0].astype(np.int64))
    for a, b in ((z, zj), (b0, bj0), (b1, bj1)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize("pc,K_cap", [(True, 1024), (True, 64),
                                      (False, 64)])
def test_pair_kernel_twin_matches_pallas(rng, pc, K_cap):
    """B1: two cameras' segments (camera 1 with every other tile empty),
    K_cap below the largest count in two cases."""
    H, W = 37, 53
    fv9 = random_faces(rng, 600, H, W)
    lists, TH, TW = tile_lists(fv9, H, W)
    T = TH * TW
    segs = lists + [ids if t % 2 else ids[:0] for t, ids in enumerate(lists)]
    counts = np.array([len(s) for s in segs], np.int32)
    assert counts.max() > 64 and (counts == 0).any()
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    ids = np.concatenate(segs).astype(np.int32)
    # Pad to whole 128-lane chunks with a far, finite face: the Pallas kernel
    # reads whole chunks around each segment.
    pad = -len(ids) % 128 + 128
    pfv = np.concatenate([fv9[ids], np.tile(
        np.array([50, 50, 1, 51, 50, 1, 50, 51, 1], np.float32), (pad, 1))])
    pface = np.concatenate([ids, np.zeros(pad, np.int32)])
    pfv10 = np.concatenate([pfv.T, pface[None].astype(np.float32)])
    ref = pallas_rasterize_pairs(
        jnp.asarray(pfv10), jnp.asarray(starts), jnp.asarray(counts), TILE,
        TW, H, W, n_tiles=T, k_chunk=128, K_cap=K_cap, perspective_correct=pc,
        interpret=True)
    z, fid, b0, b1 = tr.rasterize_pairs(t(pfv), t(pface), t(starts),
                                        t(counts), TILE, TW, H, W, T,
                                        K_cap=K_cap, perspective_correct=pc)
    compare((ref[0], ref[2], ref[3]), (z, b0, b1), ref[1], fid)
    hit = fid.numpy() >= 0
    assert 0.2 < hit.mean() < 1.0
    # The coplanar copies (ids 580-599) never win over their originals.
    assert not np.isin(fid.numpy(), np.arange(580, 600)).any()


@pytest.mark.parametrize("pc", [True, False])
def test_tile_kernel_twin_matches_pallas(rng, pc):
    """B2: dense lists of 256 lanes in 64-lane chunks, invalid lanes holding
    real faces, empty tiles, and a stray valid lane past the counted chunks
    (which both skip)."""
    H, W = 37, 53
    fv9 = random_faces(rng, 500, H, W)
    lists, TH, TW = tile_lists(fv9, H, W)
    T, K = TH * TW, 256
    R = 2 * T
    tile_fv = np.zeros((R, 9, K), np.float32)
    valid = np.zeros((R, K), np.float32)
    for r in range(R):
        ids = lists[r % T][: K - 40] if r % 5 else lists[r % T][:0]
        lanes = rng.choice(500, K)
        lanes[: len(ids)] = ids
        tile_fv[r] = fv9[lanes].T
        valid[r, : len(ids)] = 1.0
    valid[5, 200] = 1.0  # an empty list's stray lane, past its counted chunk
    counts = (valid > 0).sum(1).astype(np.int32)
    assert counts[5] == 1 and counts.max() > 64
    ref = pallas_rasterize_tiles(
        jnp.asarray(tile_fv), jnp.asarray(valid)[:, None], TILE, TW, H, W,
        n_tiles=T, k_chunk=64, perspective_correct=pc, interpret=True)
    z, slot, b0, b1 = tr.rasterize_tiles(t(tile_fv), t(valid), t(counts),
                                         TILE, TW, H, W, T, k_chunk=64,
                                         perspective_correct=pc)
    compare((ref[0], ref[2], ref[3]), (z, b0, b1), ref[1], slot)
    assert (slot.numpy() >= 0).mean() > 0.2


def scene(rng):
    """1500 small faces, 150 random big ones and two ground planes (faces
    1650 and 1651), a degenerate face, a face crossing the camera plane and
    duplicated coplanar faces, with two cameras (the second looks past most
    of it). Tiles overflow both K_cap = 128 and the 128 big-face lanes."""
    n = 1650
    verts = rng.uniform(-1.5, 1.5, (n, 1, 3)) + np.where(
        np.arange(n)[:, None, None] < 1500, rng.normal(0, 0.08, (n, 3, 3)),
        rng.uniform(-1.5, 1.5, (n, 3, 3)))
    big = np.array([[-3, -3, 0.2], [3, -3, 0.2], [0, 3, 0.2],
                    [-3, 3, -0.2], [3, 3, -0.2], [0, -3, -0.2],
                    [0, 0, 0], [1, 1, 1], [2, 2, 2],
                    [0, 0, 4.0], [1, 0, 6.0], [0, 1, 6.0]], np.float32)
    verts = np.concatenate([verts.reshape(-1, 3), big]).astype(np.float32)
    faces = np.arange(n * 3 + 12, dtype=np.int32).reshape(-1, 3)
    faces = np.concatenate([faces, faces[40:60], faces[1600:1610],
                            faces[n:n + 1]])
    X = np.array([[0.5, 1.0, 5.0], [4.0, 0.5, 2.0]], np.float32)
    at = np.array([[0, 0, 0], [6.0, 0, -2.0]], np.float32)
    R, T = jgeo.look_at_view_transform(eye=jnp.asarray(X), at=jnp.asarray(at))
    jc = jgeo.FoVCamera.create(R, T, zfar=40.0)
    return verts, faces, jc, camera_to_torch(jc)


def assert_same_fragments(ours, ref, bary_atol=ATOL):
    np.testing.assert_array_equal(ours.pix_to_face.numpy(),
                                  np.asarray(ref.pix_to_face))
    np.testing.assert_allclose(ours.zbuf.numpy(), np.asarray(ref.zbuf),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(ours.bary.numpy(), np.asarray(ref.bary),
                               atol=bary_atol, rtol=0)


@pytest.mark.parametrize("binning,pc", [("pairlist", True),
                                        ("pairlist", False),
                                        ("topk", True)])
def test_tiled_path_matches_jax_pallas(rng, binning, pc):
    verts, faces, jc, tc = scene(rng)
    kw = dict(max_faces_per_tile=128, perspective_correct=pc)
    # Binning and kernels from the same projected faces.
    f9 = np.asarray(jrast.project_fv_batch(jnp.asarray(verts),
                                           jnp.asarray(faces), jc))
    ref = jrast._rasterize_batch_binned_pallas(
        jnp.asarray(f9), (37, 53), 16, 128, pc, binning=binning)
    ours = rast._rasterize_tiled(t(f9), (37, 53), 16, 128, pc,
                                 binning=binning)
    assert_same_fragments(ours, ref)
    hit = ours.pix_to_face.numpy()
    assert (hit[0] >= 0).mean() > 0.2 and (hit[1] < 0).mean() > 0.3
    assert np.isin([1650, 1651], hit).all()  # the ground planes are drawn
    # End to end, the two packages' projections differ by float32 ulps (NDC
    # x/y grow as 1/z near the camera plane), which the barycentrics of the
    # smallest faces (area ~1e-3 in NDC) amplify ~100x.
    np.testing.assert_allclose(
        rast.project_fv_batch(t(verts), t(faces).long(), tc).numpy(), f9,
        rtol=1e-4, atol=1e-6)
    ref = jrast.rasterize(jnp.asarray(verts), jnp.asarray(faces), jc,
                          (37, 53), method="pallas", binning=binning, **kw)
    ours = rast.rasterize(t(verts), t(faces).long(), tc, (37, 53),
                          method="tiled", binning=binning, **kw)
    assert_same_fragments(ours, ref, bary_atol=1e-4)


@pytest.mark.parametrize("pc", [True, False])
def test_binned_path_matches_jax(rng, pc):
    verts, faces, jc, tc = scene(rng)
    kw = dict(max_faces_per_tile=64, perspective_correct=pc)
    ref = jrast.rasterize(jnp.asarray(verts), jnp.asarray(faces), jc,
                          (37, 53), method="binned", **kw)
    ours = rast.rasterize(t(verts), t(faces).long(), tc, (37, 53),
                          method="binned", **kw)
    assert_same_fragments(ours, ref)


def write_textured_mesh(tmp_path):
    """A quad textured left red / right blue through uvs, a Kd-coloured
    triangle, and a textured triangle without uvs."""
    from PIL import Image

    tex = np.zeros((8, 8, 3), np.uint8)
    tex[:, :4] = [255, 0, 0]
    tex[:, 4:] = [0, 0, 255]
    tex[2, 5] = [10, 200, 30]
    Image.fromarray(tex).save(tmp_path / "tex.png")
    (tmp_path / "mesh.mtl").write_text(
        "newmtl tex\nKd 0.2 0.3 0.4\nmap_Kd tex.png\n"
        "newmtl red\nKd 0.9 0.1 0.1\n")
    (tmp_path / "mesh.obj").write_text(
        "mtllib mesh.mtl\n"
        "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\nv 0 0 -0.5\n"
        "vt 0.0 0.0\nvt 1.0 0.0\nvt 0.9 1.0\nvt 0.0 1.0\n"
        "usemtl tex\nf 1/1 2/2 3/3 4/4\nf 1 5 2\n"
        "usemtl red\nf 4 3 5\n")
    return str(tmp_path / "mesh.obj")


def test_texture_atlas_load_bake_and_sample(tmp_path, rng):
    path = write_textured_mesh(tmp_path)
    for size in (4, 7):
        ours = mesh_io.load_obj(path, create_texture_atlas=True,
                                texture_atlas_size=size)
        ref = jmesh.load_obj(path, create_texture_atlas=True,
                             texture_atlas_size=size)
        np.testing.assert_array_equal(ours.verts, ref.verts)
        np.testing.assert_array_equal(ours.faces, ref.faces)
        np.testing.assert_allclose(ours.texture_atlas, ref.texture_atlas,
                                   atol=ATOL, rtol=0)
        assert ours.vert_colors is None and ref.vert_colors is None
        assert ours.texture_atlas.shape == (4, size, size, 3)
    assert mesh_io.load_obj(path).texture_atlas is None
    np.testing.assert_allclose(mesh_io.adjust_mesh(ours.verts, 2.0),
                               jmesh.adjust_mesh(ref.verts, 2.0), atol=1e-6)
    uv = rng.uniform(-0.1, 1.1, (5, 6, 2)).astype(np.float32)
    img = rng.uniform(size=(9, 11, 3)).astype(np.float32)
    np.testing.assert_allclose(mesh_io._sample_texture_bilinear(img, uv),
                               jmesh._sample_texture_bilinear(img, uv),
                               atol=ATOL)

    pix = rng.integers(-1, 4, (2, 6, 7))
    bary = rng.uniform(-0.2, 1.2, (2, 6, 7, 3)).astype(np.float32)
    for mode in ("nearest", "bilinear"):
        got = rast.sample_texture_atlas(
            rast.Fragments(t(pix), t(bary[..., 0]), t(bary)),
            t(ours.texture_atlas), mode)
        want = jrast.sample_texture_atlas(
            jrast.Fragments(jnp.asarray(pix), jnp.asarray(bary[..., 0]),
                            jnp.asarray(bary)),
            jnp.asarray(ref.texture_atlas), mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_textured_render_matches_jax(tmp_path):
    mesh = mesh_io.load_obj(write_textured_mesh(tmp_path),
                            create_texture_atlas=True, texture_atlas_size=8)
    R, T = jgeo.look_at_view_transform(
        eye=jnp.asarray([[0.3, 0.4, 2.5]]), at=jnp.zeros((1, 3)))
    jc = jgeo.FoVCamera.create(R, T, zfar=10.0)
    jl = jrast.PointLights.create(jnp.zeros((1, 3)), ambient=1.0,
                                  diffuse=0.0, specular=0.0)
    ref, rf = jrast.render_mesh(
        jnp.asarray(mesh.verts), jnp.asarray(mesh.faces), jc, (32, 40), jl,
        texture_atlas=jnp.asarray(mesh.texture_atlas), background=0.0,
        perspective_correct=True)
    tl = rast.PointLights.create(torch.zeros((1, 3)), ambient=1.0,
                                 diffuse=0.0, specular=0.0)
    img, frags = rast.render_mesh(
        t(mesh.verts), t(mesh.faces).long(), camera_to_torch(jc), (32, 40),
        tl, texture_atlas=t(mesh.texture_atlas), background=0.0,
        perspective_correct=True)
    np.testing.assert_array_equal(frags.pix_to_face.numpy(),
                                  np.asarray(rf.pix_to_face))
    np.testing.assert_allclose(img.numpy(), np.asarray(ref), atol=ATOL)
    assert (frags.pix_to_face.numpy() >= 0).mean() > 0.3
