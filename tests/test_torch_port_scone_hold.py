"""The smoke's SCONE hold (chip_smoke.py), conditioned on the card's
discrete picks, on the CPU.

SconeOcc picks kNN neighbours and max-pool points in float arithmetic; a
pick where two candidates lie within float32 rounding of each other can go
either way on another device. The hold runs the float64 and float32
references with the card's picks forced and accepts a flip only as a
near-tie: its gap, from the float64 values, at most TIE_REL. TIE_REL comes
from the float32 rounding of the sums in front of the picks: a max-pool
compares outputs y = sum_i w_i z_i + b of a Dense of input width 128
(SconeOcc's pts_embedding_dim), which float32 may round by up to about one
ulp (2**-23 relative) of S = sum_i |w_i z_i| + |b| per term, so TIE_REL = 4
x 128 x 2**-23 of S (4 for the rounding of the inputs z); a kNN gap is the
squared distances' difference relative to |q|^2 + |p|^2, the magnitude
their float32 expansion rounds at.

Here the "card" run is the CPU's float32 one: the rule's pure parts
(near_ties, scone_verdict) on planted numbers, then the whole hold on a small
scene state, sound and with a planted wrong pick and a planted wrong
gradient.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
import scone_holds as sh
from macarons_tpu_torch.config import Params
from macarons_tpu_torch.data.scenes import SceneDataset
from macarons_tpu_torch.models.macarons import MacaronsModel, \
    init_macarons_weights
from macarons_tpu_torch.models.scone import SconeOcc, SconeVis
from macarons_tpu_torch.ops.geometry import FoVCamera
from macarons_tpu_torch.scene.camera import get_camera_RT
from macarons_tpu_torch.scene.memory import Memory
from macarons_tpu_torch.scene.runtime import assemble_scene_field
from macarons_tpu_torch.testers.scene import compute_trajectory
from macarons_tpu_torch.trainers.train_macarons import MacaronsRuntime, \
    setup_scene
from torch_port_helpers import TINY, make_scene_root, \
    torch_one_thread  # noqa: F401

# A flip 0.3 float32 ulp (2**-23 relative) of S apart, the scale the hold
# takes a max-pool gap at (S = sum_i |w_i z_i| + |b| of the pooled Dense's
# output). The flip that once failed the hold's float32 rule sat 0.3 ulp of
# its column's maximum apart, which is at most as far on the S scale.
SUB_ULP_GAP = 0.3 * 2.0 ** -23
# The largest gap of a sound state's flip measured on the card, of S
# (PERF.md §6): a near-tie too.
LARGEST_SOUND_GAP = 6.67e-7


def test_tie_rel_derivation():
    """TIE_REL is 4 float32 ulps times the pooled Dense's input width."""
    assert cs.TIE_REL == 4 * 128 * 2.0 ** -23
    occ = SconeOcc()
    assert {m.Dense_0.weight.shape[1] for m in (
        occ.global_transformer, occ.local_transformers_0)} == {128}


def test_near_ties():
    """A sub-ulp flip and the card's largest sound one are near-ties; a
    pick PLANT_TIE_RELS x TIE_REL away is not, whichever kind of pick it
    is."""
    assert cs.near_ties({"knn": [LARGEST_SOUND_GAP],
                         "pool": [SUB_ULP_GAP, LARGEST_SOUND_GAP, 0.0]}) == {
        "knn": [], "pool": []}
    wrong = sh.PLANT_TIE_RELS * cs.TIE_REL
    for kind in ("knn", "pool"):
        over = cs.near_ties({"knn": [SUB_ULP_GAP], "pool": [SUB_ULP_GAP],
                             kind: [SUB_ULP_GAP, wrong]})
        assert over[kind] == [wrong]
    assert cs.near_ties({"pool": [float("nan")]})["pool"]


def fake_runs(seed, card_scale=1.0, gaps=(SUB_ULP_GAP,)):
    """card, cpu and ref runs of the hold's shape: float64 gradients and
    float32 roundings of them; the card's gradients of SconeVis scaled by
    ``card_scale``; ``gaps`` the card's flips."""
    rs = np.random.default_rng(seed)
    ref = {net: {f"{net}.w{i}": torch.tensor(rs.normal(size=(7, 5)))
                 for i in range(3)} for net in ("occ", "vis")}
    f32 = {net: {k: v.float().double() for k, v in g.items()}
           for net, g in ref.items()}
    card = dict(f32, vis={k: v * card_scale for k, v in f32["vis"].items()},
                losses=[0.5, 0.25])
    cpu = dict(f32, losses=[0.5, 0.25])
    ref = dict(ref, losses=[0.5, 0.25],
               gaps={"knn": torch.zeros(0),
                     "pool": torch.tensor(gaps, dtype=torch.float64)})
    return card, cpu, ref


def test_scone_hold_verdict():
    """A sub-ulp flip is excused and counted; a planted wrong pick and a
    planted wrong gradient each fail the hold."""
    errs, faults = cs.scone_verdict(*fake_runs(0))
    assert not faults
    assert errs["flips"] == {"knn": (0, 0.0), "pool": (1, SUB_ULP_GAP)}
    _, faults = cs.scone_verdict(*fake_runs(
        0, gaps=(SUB_ULP_GAP, sh.PLANT_TIE_RELS * cs.TIE_REL)))
    assert faults and "not near-ties" in faults[0]
    errs, faults = cs.scone_verdict(*fake_runs(
        0, card_scale=1.0 + sh.WRONG_GRADIENT_REL))
    assert faults == ["the vis gradient on the card is further from the "
                      "float64 one than the CPU's float32"]
    assert errs["vis_grad_card"] > cs.STEP_REL


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    """scone_stepper's step of a small SCONE state on the CPU: synth_00
    after two random poses with perfect depth, SconeOcc at its widths but
    seq_len 256 and k 8, its draws from a seeded generator."""
    root = make_scene_root(tmp_path_factory)
    params = Params(dict(TINY, data_path=root, occ_curriculum_max_cells=8,
                         n_proxy_point_for_occupancy_supervision=200))
    gen = torch.Generator().manual_seed(0)
    item = SceneDataset(root)[0]
    scene = setup_scene(params, item, gen, "cpu")
    model = init_macarons_weights(MacaronsModel(
        SconeOcc(seq_len=256, k_for_knn=8), SconeVis(), None), gen)
    rt = MacaronsRuntime(params, model, scene.cfg, scene.cell_table, "cpu")
    mem = str(tmp_path_factory.mktemp("memory"))
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
    poses = torch.as_tensor(cam.pose_space.pose_from_idx(nbrs))
    visited = FoVCamera.create(*get_camera_RT(poses[:, :3], poses[:, 3:]),
                               zfar=params.zfar)
    N = proxy.points.shape[0]
    harm = 0.3 * torch.randn(N, 64, generator=gen)
    args = (None, proxy, scene.surface_scene, cam.fov_camera,
            in_field & (torch.rand(N, generator=gen) < 0.7), visited,
            poses[:, :3], 1.0 + 9.0 * torch.rand(len(nbrs), generator=gen),
            assemble_scene_field(proxy, proxy.supervision_occ, in_field, harm))
    kw = dict(n_supervision=200,
              box_diag=float(np.linalg.norm(np.asarray(scene.cfg.x_max)
                                            - np.asarray(scene.cfg.x_min))),
              cell_resolution=scene.cfg.resolution,
              sup_occ=(torch.rand(N, 1, generator=gen) < 0.5).float())
    return cs.scone_stepper(cs.scone_state(params, model, rt, args, kw, gen))


def conditioned(step, card):
    """The hold's float64 and float32 references, forced to ``card``'s
    picks."""
    ref = cs.in_dtype(torch.float64, lambda: step(
        "cpu", torch.float64, card["picks"], card["maxima"]))
    cpu = cs.in_dtype(torch.float32, lambda: step(
        "cpu", torch.float32, card["picks"], card["maxima"]))
    return ref, cpu


def test_hold_on_a_sound_state(step):
    """The float32 run held against the references that take its picks:
    every flip a near-tie, the gradients as close as the rule asks; forcing
    a run's own picks changes nothing."""
    card = cs.in_dtype(torch.float32, lambda: step("cpu", torch.float32))
    ref, cpu = conditioned(step, card)
    errs, faults = cs.scone_verdict(card, cpu, ref)
    assert not faults, (faults, errs)
    assert not any(cs.near_ties(ref["gaps"]).values())
    assert cpu["gaps"]["knn"].numel() == cpu["gaps"]["pool"].numel() == 0
    for net in ("occ", "vis"):
        assert all(torch.equal(cpu[net][k], card[net][k]) for k in card[net])
    assert sum(p.numel() for p in card["maxima"]) > 0
    assert sum(p.shape[0] for p in card["picks"]) > 0


def test_hold_refuses_a_planted_wrong_pick(step):
    """A max-pool pick moved to its column's smallest value (planted_pick)
    is recorded as the run's own, forced on the references, and refused at
    a gap of at least PLANT_TIE_RELS x TIE_REL."""
    card = cs.in_dtype(torch.float32, lambda: step("cpu", torch.float32,
                                                    plant=sh.planted_pick))
    ref, cpu = conditioned(step, card)
    errs, faults = cs.scone_verdict(card, cpu, ref)
    assert faults and "not near-ties" in faults[0]
    assert float(ref["gaps"]["pool"].max()) >= sh.PLANT_TIE_RELS * cs.TIE_REL


def test_hold_refuses_a_planted_wrong_gradient(step):
    """SconeVis's gradients of the run held scaled by 1 +
    WRONG_GRADIENT_REL, as B3's backward scaled so would give them."""
    card = cs.in_dtype(torch.float32, lambda: step("cpu", torch.float32))
    ref, cpu = conditioned(step, card)
    card = dict(card, vis={k: g * (1.0 + sh.WRONG_GRADIENT_REL)
                           for k, g in card["vis"].items()})
    _, faults = cs.scone_verdict(card, cpu, ref)
    assert "the vis gradient on the card" in faults[0]


def test_view_picks():
    """view_picks: a run's own view-space permutation recorded, a forced
    one taken in its place, and each differing bin's gap the differing
    angle's distance from the rounding boundary between the two bins,
    relative to pi. A camera turned half an azimuth bin about the vertical
    puts every direction on an azimuth boundary (a flip there is a
    near-tie) and keeps the elevations at their bins' centres: a flip at a
    positive elevation is half a bin from a jump (refused), one at a
    negative elevation sits on a jump (the truncated and floored quotients
    part at each multiple of the step there: a near-tie)."""
    from macarons_tpu_torch.scene import runtime as scene_runtime

    n_elev, n_azim = 7, 14
    th = np.pi / n_azim
    R = torch.tensor([[[np.cos(th), 0.0, -np.sin(th)], [0.0, 1.0, 0.0],
                       [np.sin(th), 0.0, np.cos(th)]]], dtype=torch.float64)
    cam = FoVCamera.create(R, torch.zeros((1, 3), dtype=torch.float64))
    with cs.view_picks() as own:
        perm = scene_runtime.view_space_permutation(cam, n_elev, n_azim)
    assert len(own.picks) == 1 and torch.equal(own.picks[0], perm)
    assert not own.gaps
    # On the boundaries within the float32 rounding of the bins' own
    # directions (the grid is float32 in either type).
    elev, azim = cs.view_space_angles(cam, n_elev, n_azim)
    step = 2 * np.pi / n_azim
    assert float(((torch.remainder(azim, step) - step / 2).abs()).max()) \
        < 1e-6
    forced = perm.clone()
    i0, i1, i2 = 3, 4 * n_azim + 5, 2 * n_azim + 6
    assert float(elev[i1]) > 0 > float(elev[i2])
    a = forced[i0] % n_azim
    forced[i0] += (a + 1) % n_azim - a
    for i in (i1, i2):
        forced[i] = (forced[i] + n_azim) % (n_elev * n_azim)
    with cs.view_picks([forced]) as vp:
        got = scene_runtime.view_space_permutation(cam, n_elev, n_azim)
    assert torch.equal(got, forced) and torch.equal(vp.picks[0], forced)
    gaps = vp.gaps[0]
    assert gaps.shape == (3,)
    assert float(gaps[0]) < 1e-6 / np.pi and float(gaps[1]) < 1e-6 / np.pi
    assert float(gaps[2]) == pytest.approx(1 / (2 * (n_elev + 1)), rel=1e-5)
    over = cs.near_ties({"view": gaps})["view"]
    assert over == [pytest.approx(1 / (2 * (n_elev + 1)), rel=1e-5)]
