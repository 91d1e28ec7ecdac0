"""The port's CUDA kernels on the card, against their plain PyTorch twins.

Needs an NVIDIA card (marker ``gpu``; skipped without CUDA). Imports no JAX,
so it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    BACKWARD_REL,
    DEPTH_F64_REL,
    DEPTH_NOISE_MULTIPLE,
    FP32_SLACK,
    SCENE_LEVELS,
    STEP_REL,
    edge_case_mesh,
    hold_backward,
    hold_basis,
    hold_depth_step,
    hold_scone_step,
    item_boundary_args,
    pole_and_pad_inputs,
    raster_args,
    scene_scale_suite,
    sh_inputs,
    smoke_params,
)
from macarons_tpu_torch.config import Params, load_params
from macarons_tpu_torch.data.scenes import SceneDataset
from macarons_tpu_torch.data.synthetic_suite import generate_suite
from macarons_tpu_torch.models.macarons import (
    MacaronsModel,
    create_macarons_model,
    init_depth_weights,
    init_macarons_weights,
)
from macarons_tpu_torch.models.many_depth import ManyDepth
from macarons_tpu_torch.models.scone import (
    SconeOcc,
    SconeVis,
    compute_visibilities,
)
from macarons_tpu_torch.ops import rasterizer as rast
from macarons_tpu_torch.ops.cuda import sh_visibility as shv
from macarons_tpu_torch.ops.cuda import tile_raster as tr
from macarons_tpu_torch.ops.geometry import FoVCamera, look_at_view_transform
from macarons_tpu_torch.ops.sampling import cumsum_rows
from macarons_tpu_torch.scene.camera import get_camera_RT
from macarons_tpu_torch.scene.depth_runtime import create_batch_for_depth_model
from macarons_tpu_torch.scene.grid import empty_grid
from macarons_tpu_torch.scene.memory import Memory
from macarons_tpu_torch.scene.runtime import assemble_scene_field
from macarons_tpu_torch.testers.scene import (
    compute_trajectory,
    true_coverage_update,
)
from macarons_tpu_torch.trainers.train_macarons import (
    MacaronsRuntime,
    depth_cfg_from_params,
    setup_scene,
)
from macarons_tpu_torch.utils.device import resolve_device

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("B,C,L,sig", [(8, 1, 2048, True), (1, 52, 2048, True),
                                       (1, 8, 16411, False), (3, 2, 5, True),
                                       (3, 52, 2048, True),
                                       (3, 52, 2048, False),
                                       (1, 53, 1001, True),
                                       (1, 53, 1001, False),
                                       (24, 1, 2048, True),
                                       (24, 1, 2048, False),
                                       (4, 1, 2048, True),
                                       (2, 5, 333, True), (2, 5, 333, False)])
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


@pytest.mark.parametrize("size", [(128, 128), (512, 512)])
def test_fused_kernel_matches_plain_ortho(gen, size, tmp_path):
    """rasterize_tiled against its plain version under the 6 orthographic
    carving cameras of the ShapeNet GT, on synth_00 subdivided 4 times
    (59,392 faces) at the GT's surface scale: identical ids."""
    from chip_smoke import shapenet_suite, load_mesh
    from macarons_tpu_torch.data import shapenet

    root = str(tmp_path)
    name = shapenet_suite(root)[0]
    verts, faces = load_mesh(root, name, "cuda")
    cfg = shapenet.ShapeNetGTConfig()
    f9 = rast.project_fv_batch(
        shapenet.adjust_mesh_diagonally(verts, cfg.surface_resolution),
        faces, shapenet.ortho_cameras(cfg, "cuda"))
    args = raster_args(f9, size, rast.k_cap(1024, f9.shape[2]), True)[2]
    out = tr.rasterize_tiled(*args)
    torch.cuda.synchronize()
    assert_same(out, tr.rasterize_tiled_plain(*args))
    assert 0.05 < float((out[1] >= 0).float().mean()) < 1.0


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


def backward_inputs(gen, B, C, L, poles=False):
    pts, harm, X_cam = (pole_and_pad_inputs if poles else sh_inputs)(
        gen, B, C, L)
    g = torch.randn(B, C, L, device="cuda", generator=gen)
    return pts, harm, X_cam, g


@pytest.mark.parametrize("sig", [True, False])
@pytest.mark.parametrize("B,C,L,poles", [(4, 1, 2048, False),
                                         (1, 4, 2048, False),
                                         (3, 52, 2048, False),
                                         (3, 1, 1001, False),
                                         (2, 5, 333, False),
                                         (2, 3, 300, True)])
def test_sh_visibility_backward_kernel(gen, B, C, L, poles, sig):
    """B3's backward kernel, reached through autograd, against its plain
    version: within 1e-5 of the largest gradient. The SCONE step's shapes,
    the coverage-gain pretrainer's (3, 52, 2048: 8 camera slices), 1001
    points (a multiple of no block or lane-group size), 5 cameras
    (slices of unequal length), the poles and the 1e6 pads."""
    pts, harm, X_cam, g = backward_inputs(gen, B, C, L, poles)
    assert hold_backward(pts, harm, X_cam, sig, g) <= BACKWARD_REL


@pytest.mark.parametrize("poles", [False, True])
def test_sh_visibility_backward_basis_is_the_forwards(gen, poles):
    """The backward kernel's 64 basis terms are the forward kernel's, bit
    for bit (chip_smoke.hold_basis)."""
    pts, _, X_cam, _ = backward_inputs(gen, 2, 1, 300, poles)
    assert hold_basis(pts, X_cam) == 0


def test_cumsum_rows_repeats_on_card(gen):
    """The sampling CDF of one row of 59,392 floats: one result in 200
    runs (torch.cumsum's single-row scan on CUDA varies between runs). A
    row of the 232-face scene's length, one tile of that scan, keeps
    torch.cumsum's own bits."""
    x = torch.rand(59392, device="cuda", generator=gen)
    assert len({cumsum_rows(x).cpu().numpy().tobytes()
                for _ in range(200)}) == 1
    np.testing.assert_array_equal(cumsum_rows(x).cpu().numpy(),
                                  torch.cumsum(x[None].expand(2, -1), 1)[0]
                                  .cpu().numpy())
    short = torch.rand(232, device="cuda", generator=gen)
    assert len({cumsum_rows(short).cpu().numpy().tobytes()
                for _ in range(200)}) == 1
    np.testing.assert_array_equal(cumsum_rows(short).cpu().numpy(),
                                  torch.cumsum(short, 0).cpu().numpy())


def scene_scale_capture(root, seed):
    """The scene-scale scene set up from ``seed`` (its GT surface sample),
    one capture at start 0 and its true coverage."""
    params = smoke_params(root)
    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    item = SceneDataset(root)[0]
    scene = setup_scene(params, item, gen, dev)
    cam = scene.camera
    cam.initialize(np.asarray(item["settings"].start_positions[0]))
    images, depth, mask = cam.capture_image(
        scene.verts_dev, scene.faces_dev, vert_colors=scene.colors_dev,
        texture_atlas=scene.atlas_dev)
    cov, covered = true_coverage_update(
        scene, empty_grid(scene.cfg, dev), depth, cam.fov_camera.R,
        cam.fov_camera.T, gen, params.zfar, 2.0 * params.test_resolution)
    return [images, depth, mask, *scene.gt_scene, *covered], cov


def test_scene_scale_capture_and_coverage_repeat(gen, tmp_path):
    """Two set-ups of the 59,392-face scene from one seed, each with a
    capture and its true coverage: the same GT sample, frames, covered grid
    and coverage, bit for bit."""
    root = scene_scale_suite(str(tmp_path / "scenes"), SCENE_LEVELS)
    first, cov = scene_scale_capture(root, 0)
    again, cov_again = scene_scale_capture(root, 0)
    assert cov == cov_again
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_compute_visibilities_carries_grad_fn(gen):
    pts, harm, X_cam, _ = backward_inputs(gen, 4, 1, 256)
    out = compute_visibilities(pts, harm.requires_grad_(), X_cam)
    assert out.requires_grad and out.grad_fn is not None


def test_sh_visibility_refuses_grad_in_points(gen):
    pts, harm, X_cam, _ = backward_inputs(gen, 1, 2, 64)
    with pytest.raises(ValueError, match="coefficients"):
        shv.sh_visibility(pts.requires_grad_(), harm, X_cam)
    with pytest.raises(ValueError, match="coefficients"):
        shv.sh_visibility(pts.detach(), harm, X_cam.requires_grad_())


def depth_frames(n, H=256, W=456, zfar=750.0):
    """A frame sequence on a short camera arc, random images and depths, on
    the CPU (as Memory.load_frame_sequence gives it)."""
    g = torch.Generator().manual_seed(n)
    t = torch.linspace(0.0, 0.3, n)
    eye = torch.stack((3 * torch.sin(t), 0.2 + 0.1 * t, 3 * torch.cos(t)), -1)
    R, T = look_at_view_transform(eye, torch.zeros(n, 3))
    return {"images": torch.rand(n, H, W, 3, generator=g),
            "zbuf": 1.0 + 4.0 * torch.rand(n, H, W, 1, generator=g),
            "mask": torch.rand(n, H, W, 1, generator=g) > 0.1,
            "R": R, "T": T, "zfar": torch.full((n,), zfar)}


def test_depth_step_on_card_matches_cpu(gen):
    """One depth optimizer step at the default training config's widths
    (ManyDepth at 256x456, 96 planes, B 1, augmentation with fixed draws)
    on the card and on the CPU from one state (chip_smoke.hold_depth_step:
    the loss within rtol 1e-4, BatchNorm's running statistics, the card's
    float64 gradient within chip_smoke.DEPTH_F64_REL of the CPU's, and its
    float32 gradient's error from float64 within
    chip_smoke.DEPTH_NOISE_MULTIPLE of the step's float32 noise, measured
    on one-ulp replicas)."""
    params = load_params(
        "configs/macarons/macarons_default_training_config.json")
    model = create_macarons_model(params, "cpu")
    init_macarons_weights(model, torch.Generator().manual_seed(1))
    cfg = depth_cfg_from_params(params)
    batch, alpha = create_batch_for_depth_model(
        cfg, depth_frames(cfg.n_alpha + 2), "supervision")
    assert batch["images"].shape[0] == 1
    errs = hold_depth_step(params, model, batch, alpha)
    assert errs["depth_grad_card64"] <= DEPTH_F64_REL
    assert errs["card_over_noise"] <= DEPTH_NOISE_MULTIPLE


def test_scone_step_on_card_matches_cpu(gen, tmp_path, monkeypatch):
    """One SCONE optimizer step on a small scene state (synth_00 after two
    random poses with perfect depth, narrow networks) on the card and on
    the CPU from one state, the draws shared (chip_smoke.hold_scone_step:
    both losses and the gradients of SconeOcc and SconeVis). The step's
    saved state goes to ``tmp_path``, not over the smoke's."""
    import chip_smoke
    from torch_port_helpers import TINY

    monkeypatch.setattr(chip_smoke, "HELD_DIR", str(tmp_path))

    root = generate_suite(str(tmp_path / "scenes"), n_scenes=1)
    params = Params(dict(TINY, data_path=root, occ_curriculum_max_cells=8,
                         n_proxy_point_for_occupancy_supervision=200))
    dev = resolve_device("cuda")
    item = SceneDataset(root)[0]
    scene = setup_scene(params, item, gen, dev)
    model = init_macarons_weights(
        MacaronsModel(SconeOcc(seq_len=256, k_for_knn=8).to(dev),
                      SconeVis().to(dev), None), gen)
    rt = MacaronsRuntime(params, model, scene.cfg, scene.cell_table, dev)
    mem = str(tmp_path / "memory")
    compute_trajectory(rt, scene, Memory([mem]), mem, gen,
                       np.random.default_rng(42), n_poses=2,
                       surface_epsilon=0.15,
                       start_idx=np.asarray(
                           item["settings"].start_positions[0]),
                       policy="random")
    proxy, cam = scene.proxy, scene.camera
    in_field = proxy.out_of_field[:, 0] < 1.0
    nbrs = cam.get_valid_neighbors(cam.get_neighboring_poses(),
                                   scene.verts_dev)[:4]
    poses = torch.as_tensor(cam.pose_space.pose_from_idx(nbrs), device=dev)
    visited = FoVCamera.create(*get_camera_RT(poses[:, :3], poses[:, 3:]),
                               zfar=params.zfar)
    N = proxy.points.shape[0]
    harm = 0.3 * torch.randn(N, 64, device=dev, generator=gen)
    args = (None, proxy, scene.surface_scene, cam.fov_camera,
            in_field & (torch.rand(N, device=dev, generator=gen) < 0.7),
            visited, poses[:, :3],
            1.0 + 9.0 * torch.rand(len(nbrs), device=dev, generator=gen),
            assemble_scene_field(proxy, proxy.supervision_occ, in_field, harm))
    kw = dict(n_supervision=200,
              box_diag=float(np.linalg.norm(np.asarray(scene.cfg.x_max)
                                            - np.asarray(scene.cfg.x_min))),
              cell_resolution=scene.cfg.resolution,
              sup_occ=(torch.rand(N, 1, device=dev, generator=gen)
                       < 0.5).float())
    errs = hold_scone_step(params, model, rt, args, kw, gen)
    for net in ("occ", "vis"):
        assert errs[f"{net}_grad_card"] <= max(
            STEP_REL, FP32_SLACK * errs[f"{net}_grad_cpu"])
