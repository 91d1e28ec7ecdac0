"""The plain reference against the program at a tiny size on the CPU: the
frozen networks get the program's weights from a seed and give its
outputs, the plain SH integral is B3's CPU twin, and the reference's
exact scan of every face gives the program's captured depth."""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

from benchmark.harness.common import network_weights  # noqa: E402
from benchmark.reference import explore as ref  # noqa: E402
from benchmark.reference.frozen import scone as fscone  # noqa: E402
from benchmark.reference.frozen import sh_visibility as fsh  # noqa: E402
from benchmark.reference.frozen.many_depth import ManyDepth  # noqa: E402

SEED = 2 ** 31 + 17


def nets(module_scone, depth_cls, H=64, W=96):
    occ = module_scone.SconeOcc(seq_len=64, k_for_knn=16).eval()
    vis = module_scone.SconeVis().eval()
    depth = depth_cls(input_height=H, input_width=W, n_depth=8).eval()
    network_weights(SEED, torch.device("cpu"), occ, vis, depth)
    return occ, vis, depth


def test_networks_agree_with_the_program():
    from macarons_tpu_torch.models import scone
    from macarons_tpu_torch.models.many_depth import ManyDepth as Program

    ours = nets(fscone, ManyDepth)
    theirs = nets(scone, Program)
    for a, b in zip(ours, theirs):
        pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
        assert pa.keys() == pb.keys()
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k
    g = torch.Generator().manual_seed(0)
    pc = torch.rand(2, 400, 3, generator=g) - 0.5
    x = torch.rand(2, 30, 3, generator=g) - 0.5
    vh = torch.rand(2, 30, 64, generator=g)
    mask = torch.rand(2, 400, generator=g) > 0.1
    with torch.no_grad():
        assert torch.equal(ours[0](pc, x, vh, pc_mask=mask),
                           theirs[0](pc, x, vh, pc_mask=mask))
        pts = torch.rand(3, 64, 4, generator=g)
        smask = torch.rand(3, 64, generator=g) > 0.2
        h = torch.rand(3, 64, 64, generator=g)
        assert torch.equal(ours[1](pts, h, pts_mask=smask),
                           theirs[1](pts, h, pts_mask=smask))
        img = torch.rand(1, 64, 96, 3, generator=g)
        alpha = torch.rand(1, 2, 64, 96, 3, generator=g)
        R = torch.eye(3).expand(1, 3, 3)
        T = torch.zeros(1, 3)
        pose = torch.rand(1, 2, 6, generator=g) * 0.01
        for a, b in zip(ours[2](img, alpha, R, T, pose),
                        theirs[2](img, alpha, R, T, pose)):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b)
    # The occupancy head is centred: the random field reads above the
    # samplers' 0.1.
    with torch.no_grad():
        assert float(ours[0](pc, x, vh, pc_mask=mask).min()) > 0.1


def test_plain_sh_integral_is_b3s_twin():
    from macarons_tpu_torch.ops.cuda import sh_visibility as shv

    g = torch.Generator().manual_seed(1)
    pts = torch.randn(2, 50, 4, generator=g) * 0.5
    harm = torch.randn(2, 50, 64, generator=g) * 0.3
    cams = torch.randn(2, 7, 3, generator=g) * 2
    assert torch.equal(fsh.sh_visibility(pts, harm, cams),
                       shv.sh_visibility(pts, harm, cams))


def test_exact_scan_gives_the_programs_depth(tmp_path):
    from macarons_tpu_torch.data.synthetic_suite import generate_suite
    from macarons_tpu_torch.ops.geometry import FoVCamera as ProgramCamera
    from macarons_tpu_torch.ops.geometry import look_at_view_transform
    from macarons_tpu_torch.scene.camera import capture

    root = generate_suite(str(tmp_path), n_scenes=1)
    path = os.path.join(root, "synth_00", "mesh.obj")
    verts, faces = ref.read_obj(path, "cpu")
    eye = torch.tensor([[4.0, 3.0, -5.0], [-3.0, 2.0, 4.0]])
    R, T = look_at_view_transform(eye, torch.zeros_like(eye))
    H, W = 48, 80
    _, depth, _ = capture(verts, faces, None, R, T, H, W, 100.0, 1.0, 1.0)
    cams = ref.FoVCamera.create(R, T, zfar=100.0)
    assert isinstance(ProgramCamera.create(R, T), ProgramCamera)
    gen = torch.Generator().manual_seed(3)
    for i in range(2):
        idx, px, py = ref._pixels(gen, H, W, 1000, "cpu")
        ours = ref.nearest_depth(verts, faces, cams[i], px, py)
        theirs = depth[i].reshape(-1)[idx]
        assert bool(((ours < 0) == (theirs < 0)).all())
        assert torch.allclose(ours, theirs, rtol=1e-5, atol=1e-6)
    assert bool((depth > 0).any())
    assert np.isfinite(depth.numpy()).all()
