"""The port's CUDA kernels on the card, against their plain PyTorch twins.

Needs an NVIDIA card (marker ``gpu``; skipped without CUDA). Imports no JAX,
so it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_port_cuda.py
"""

import pytest
import torch

from chip_smoke import edge_case_mesh, item_boundary_args, raster_args
from macarons_tpu_torch.models.macarons import init_depth_weights
from macarons_tpu_torch.models.many_depth import ManyDepth
from macarons_tpu_torch.models.scone import compute_visibilities
from macarons_tpu_torch.ops import rasterizer as rast
from macarons_tpu_torch.ops.cuda import sh_visibility as shv
from macarons_tpu_torch.ops.cuda import tile_raster as tr
from macarons_tpu_torch.utils.device import resolve_device

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("B,C,L,sig", [(8, 1, 2048, True), (1, 52, 2048, True),
                                       (1, 8, 16411, False), (3, 2, 5, True)])
def test_sh_visibility_kernel(gen, B, C, L, sig):
    pts = torch.randn(B, L, 4, device="cuda", generator=gen)
    pts[:, : L // 4, 0] = 0.0  # on the vertical axis of cameras at x = z = 0
    pts[:, : L // 4, 2] = 0.0
    pts[:, L // 4: L // 2, :3] = 1e6
    harm = torch.randn(B, L, 64, device="cuda", generator=gen) * 0.3
    X_cam = torch.randn(B, C, 3, device="cuda", generator=gen) * 2.0
    X_cam[:, 0, 0] = 0.0
    X_cam[:, 0, 2] = 0.0
    before = shv.sh_visibility.launches
    out = compute_visibilities(pts, harm, X_cam, use_sigmoid=sig)
    torch.cuda.synchronize()
    assert shv.sh_visibility.launches == before + 1
    ref = shv.compute_visibilities_plain(pts, harm, X_cam, use_sigmoid=sig)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


def test_sh_visibility_rejects_bad_inputs(gen):
    pts = torch.randn(2, 10, 3, device="cuda", generator=gen)
    harm = torch.randn(2, 10, 64, device="cuda", generator=gen)
    X_cam = torch.randn(2, 3, 3, device="cuda", generator=gen)
    with pytest.raises(ValueError):
        shv.sh_visibility(pts.double(), harm, X_cam)
    with pytest.raises(ValueError):
        shv.sh_visibility(pts, harm[:, :, :32], X_cam)


def raster_inputs(gen, size=(37, 53), K_cap=1024, pc=True):
    """chip_smoke's edge-case mesh (small and big faces, coplanar copies, a
    degenerate face, a face crossing the camera plane, two cameras): its
    projected faces and the arguments of B1, B2 and the fused launch."""
    verts, faces, cam = edge_case_mesh(gen)
    f9 = rast.project_fv_batch(verts, faces, cam)
    return f9, raster_args(f9, size, K_cap, pc)


def assert_same(out, ref):
    torch.testing.assert_close(out[1], ref[1], rtol=0, atol=0)
    for a, b in zip(out[::2] + out[3:], ref[::2] + ref[3:]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("pc,K_cap", [(True, 1024), (True, 128),
                                      (False, 128)])
def test_pair_kernel_matches_twin(gen, pc, K_cap):
    args = raster_inputs(gen, K_cap=K_cap, pc=pc)[1][0]
    assert int(args[3].max()) > 128
    before = tr.rasterize_pairs.launches
    out = tr.rasterize_pairs(*args)
    torch.cuda.synchronize()
    assert tr.rasterize_pairs.launches == before + 1
    assert_same(out, tr.rasterize_pairs_plain(*args))
    assert 0.02 < float((out[1] >= 0).float().mean()) < 1.0


@pytest.mark.parametrize("pc", [True, False])
def test_tile_kernel_matches_twin(gen, pc):
    args = raster_inputs(gen, pc=pc)[1][1]
    before = tr.rasterize_tiles.launches
    out = tr.rasterize_tiles(*args)
    torch.cuda.synchronize()
    assert tr.rasterize_tiles.launches == before + 1
    assert_same(out, tr.rasterize_tiles_plain(*args))
    assert float((out[1] >= 0).float().mean()) > 0.05


def test_tiled_path_on_card_matches_cpu(gen):
    f9 = raster_inputs(gen)[0]
    for binning in ("pairlist", "topk"):
        card = rast._rasterize_tiled(f9, (37, 53), 16, 128, True,
                                     binning=binning)
        cpu = rast._rasterize_tiled(f9.cpu(), (37, 53), 16, 128, True,
                                    binning=binning)
        torch.testing.assert_close(card.pix_to_face.cpu(), cpu.pix_to_face,
                                   rtol=0, atol=0)
        torch.testing.assert_close(card.zbuf.cpu(), cpu.zbuf, rtol=0,
                                   atol=1e-5)


def test_tile_raster_rejects_bad_inputs(gen):
    (pfv, pface, starts, counts, *rest), (fv, valid, n, *more), fused = \
        raster_inputs(gen)[1]
    with pytest.raises(ValueError):
        tr.rasterize_pairs(pfv, pface.long(), starts, counts, *rest)
    with pytest.raises(ValueError):
        tr.rasterize_pairs(pfv[:, :8], pface, starts, counts, *rest)
    with pytest.raises(ValueError):
        tr.rasterize_tiles(fv, valid, n, 64, *more[1:])
    f9, pface, *lists = fused[:7]
    with pytest.raises(ValueError):
        tr.rasterize_tiled(f9, pface.long(), *lists, *fused[7:])
    with pytest.raises(ValueError):  # 2 cameras but 3 tiles per camera
        tr.rasterize_tiled(*fused[:11], 3, *fused[12:])
    with pytest.raises(ValueError):
        tr.rasterize_tiled(*fused, item=129)


@pytest.mark.parametrize("size,K_cap,pc", [((37, 53), 1024, True),
                                           ((37, 53), 128, True),
                                           ((37, 53), 128, False),
                                           ((256, 456), 1024, True)])
def test_fused_kernel_matches_plain(gen, size, K_cap, pc):
    """rasterize_tiled against its plain version (the B1 and B2 twins and
    their merge) on the card: identical ids, and two launches bit for bit
    alike."""
    args = raster_inputs(gen, size, K_cap, pc)[1][2]
    before = tr.rasterize_tiled.launches
    out = tr.rasterize_tiled(*args)
    again = tr.rasterize_tiled(*args)
    torch.cuda.synchronize()
    assert tr.rasterize_tiled.launches == before + 2
    assert_same(out, tr.rasterize_tiled_plain(*args))
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    assert 0.02 < float((out[1] >= 0).float().mean()) < 1.0


@pytest.mark.parametrize("item", [1, 7, 64, 128])
def test_kernel_at_item_boundaries(gen, item):
    """Rows of 0, item - 1, item, item + 1 and more than K_cap pairs, a
    segment running past the pair array, valid lanes past the counted
    chunks: the fused launch and B1 and B2 alone against their plain
    versions."""
    f9 = raster_inputs(gen)[0]
    b1, b2, fused = item_boundary_args(f9, (37, 53), 128, item, True, gen)
    assert_same(tr.rasterize_tiled(*fused, item=item),
                tr.rasterize_tiled_plain(*fused))
    assert_same(tr.rasterize_pairs(*b1), tr.rasterize_pairs_plain(*b1))
    assert_same(tr.rasterize_tiles(*b2), tr.rasterize_tiles_plain(*b2))


@pytest.mark.parametrize("item", [1, 64])
def test_item_table_kernel_matches_plain(gen, item):
    """raster_items_kernel against the table's tensor ops on the CPU."""
    f9 = raster_inputs(gen)[0]
    for args in (raster_args(f9, (37, 53), 128, True)[2],
                 item_boundary_args(f9, (37, 53), 128, item, True, gen)[2]):
        _, pface, starts, counts, _, valid, lane_counts = args[:7]
        lists = (starts, counts, pface.shape[0], 128, valid, lane_counts,
                 args[13], item)
        scratch = torch.zeros((starts.shape[0], 256), dtype=torch.int64,
                              device="cuda")
        card = tr.item_table(*lists, scratch=scratch)
        cpu = tr.item_table(*(a.cpu() if torch.is_tensor(a) else a
                              for a in lists))
        for i in (0, 2, 3):
            assert torch.equal(card[i].cpu(), cpu[i])
        tested = torch.arange(valid.shape[1]) < cpu[2][:, None]
        assert torch.equal(card[1].cpu()[tested], cpu[1][tested])
        assert bool((scratch == -1).all())


def test_pairlist_path_is_one_fused_launch(gen):
    f9 = raster_inputs(gen)[0]
    counts = [f.launches for f in (tr.rasterize_tiled, tr.rasterize_pairs,
                                   tr.rasterize_tiles)]
    rast._rasterize_tiled(f9, (37, 53), 16, 128, True)
    after = [f.launches for f in (tr.rasterize_tiled, tr.rasterize_pairs,
                                  tr.rasterize_tiles)]
    assert after == [counts[0] + 1, counts[1], counts[2]]


def test_tile_raster_wrappers_never_sync(gen):
    b1, b2, fused = raster_inputs(gen)[1]
    calls = ((tr.rasterize_pairs, b1), (tr.rasterize_tiles, b2),
             (tr.rasterize_tiled, fused))
    for fn, args in calls:  # builds the kernel
        fn(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn, args in calls:
            fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def many_depth_inputs(B, A=2, H=256, W=456):
    """Images and known relative poses at the default test config's widths,
    on the CPU: the target at R = I, T = 0, the alphas a small rotation and
    shift away (the pose vector is [T, axis-angle] / pose_factor)."""
    g = torch.Generator().manual_seed(B)
    x = torch.rand(B, H, W, 3, generator=g)
    x_alpha = torch.rand(B, A, H, W, 3, generator=g)
    R = torch.eye(3).expand(B, 3, 3)
    T = torch.zeros(B, 3)
    pose = torch.randn(B, A, 6, generator=g) * 2e-3
    return x, x_alpha, R, T, pose


@pytest.fixture
def many_depth(gen):
    """ManyDepth at the default test config's widths (96 planes), random
    weights, in eval mode on the CPU and (a copy) on the card."""
    resolve_device("cuda")  # TF32 off for the convolutions
    cpu = ManyDepth().eval()
    init_depth_weights(cpu, torch.Generator().manual_seed(0))
    card = ManyDepth().eval()
    card.load_state_dict(cpu.state_dict())
    return cpu, card.cuda()


@pytest.mark.parametrize("B", [1, 4])
def test_many_depth_on_card_matches_cpu(many_depth, B):
    cpu, card = many_depth
    args = many_depth_inputs(B)
    with torch.no_grad():
        ref = cpu(*args)
        out = card(*(a.cuda() for a in args))
    torch.cuda.synchronize()
    for a, b in zip(out[1:], ref[1:]):
        assert float(b.min()) > 0.0 and float(b.max()) < 1.0
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)


def test_many_depth_never_syncs(many_depth):
    _, card = many_depth
    args = [a.cuda() for a in many_depth_inputs(1)]
    with torch.no_grad():
        card(*args)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            card(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
