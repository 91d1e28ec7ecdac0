"""The benchmark's yardstick of work: the networks' model FLOPs against
``torch.utils.flop_counter`` on the frozen reference at small sizes, and
the kernels' frozen bound arithmetic against the figures PERF.md's kernel
table states at its shapes."""

import os
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

from benchmark import flops as F  # noqa: E402
from benchmark.reference.frozen.many_depth import ManyDepth  # noqa: E402
from benchmark.reference.frozen.scone import SconeOcc, SconeVis  # noqa: E402


def counted(fn):
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("B,S,L", [(1, 20, 300), (2, 7, 1000), (3, 5, 90)])
def test_scone_occ_flops(B, S, L):
    net = SconeOcc(seq_len=128, k_for_knn=16).eval()
    pc = torch.rand(B, L, 3)
    x = torch.rand(B, S, 3)
    vh = torch.rand(B, S, 64)
    assert F.scone_occ_flops(B, S, L, seq_len=128, k=16) == counted(
        lambda: net(pc, x, vh))


@pytest.mark.parametrize("B,L", [(1, 64), (3, 100)])
def test_scone_vis_flops(B, L):
    net = SconeVis().eval()
    pts = torch.rand(B, L, 4)
    h = torch.rand(B, L, 64)
    assert F.scone_vis_flops(B, L) == counted(lambda: net(pts, h))


def test_many_depth_flops_on_meta_match_a_real_forward():
    B, H, W, n_alpha, n_depth = 2, 64, 96, 2, 8
    net = ManyDepth(input_height=H, input_width=W, n_depth=n_depth).eval()
    real = counted(lambda: net(
        torch.rand(B, H, W, 3), torch.rand(B, n_alpha, H, W, 3),
        torch.eye(3).expand(B, 3, 3), torch.zeros(B, 3),
        torch.zeros(B, n_alpha, 6)))
    assert F.many_depth_flops(B, H, W, n_alpha, n_depth) == real


def test_kernel_bounds_give_the_kernel_tables_figures():
    # B3 at the scorer's (24, 1, 2048): 3.99 us, bound by bytes.
    b3 = F.bound_seconds(F.sh_visibility_flops(24, 1, 2048),
                         F.sh_visibility_bytes(24, 1, 2048))
    assert round(b3 * 1e6, 2) == 3.99
    # B3' at the SCONE step's (4, 1, 2048): 0.67 us, by bytes.
    b3b = F.bound_seconds(F.sh_visibility_backward_flops(4, 1, 2048),
                          F.sh_visibility_backward_bytes(4, 1, 2048))
    assert round(b3b * 1e6, 2) == 0.67
    # B1 + B2 fused at a scene-scale move of 4 frames: 1,856 rows, 193,981
    # pairs, 4,153 big-face lanes: 16.01 us, by operations; B1's pairs
    # alone 15.64 us, B2's lanes alone 2.32 us, by bytes.
    fused = F.bound_seconds(F.tiled_flops(193981, 4153, 1856),
                            F.tiled_bytes(193981, 4153, 1856))
    assert round(fused * 1e6, 2) == 16.01
    b1 = F.bound_seconds(F.raster_flops(193981, 1856),
                         F.raster_bytes(193981, 1856))
    assert round(b1 * 1e6, 2) == 15.64
    b2 = F.bound_seconds(F.raster_flops(4153, 1856),
                         F.raster_bytes(4153, 1856))
    assert round(b2 * 1e6, 2) == 2.32
    # B1 + B2 at the demos' move: 1,856 rows, 9,843 pairs, 12,762 big-face
    # lanes: 2.54 us, by bytes.
    move = F.bound_seconds(F.tiled_flops(9843, 12762, 1856),
                           F.tiled_bytes(9843, 12762, 1856))
    assert round(move * 1e6, 2) == 2.54


@pytest.mark.parametrize("k_chunk", [4, 256])
def test_tiled_work_counts_what_the_item_table_counts(k_chunk):
    # The pairs and lanes the benchmark counts for a fused rasterizer
    # launch are those the program's item table gives the kernel, on lists
    # with rows past K_cap, segments running off the pair array, empty
    # rows and lanes invalid within a row's count.
    from macarons_tpu_torch.ops.cuda import tile_raster as tr

    g = torch.Generator().manual_seed(7)
    R, K, nfe, K_cap = 37, 12, 400, 9
    counts = torch.randint(0, 20, (R,), generator=g, dtype=torch.int32)
    starts = torch.randint(0, nfe + 5, (R,), generator=g, dtype=torch.int32)
    lane_counts = torch.randint(0, K + 1, (R,), generator=g,
                                dtype=torch.int32)
    lane_valid = torch.rand(R, K, generator=g) < 0.6
    pairs, lanes = F.tiled_work(nfe, starts, counts, K_cap, lane_valid,
                                lane_counts, k_chunk)
    n_pairs, _, n_lanes, _ = tr.item_table(starts, counts, nfe, K_cap,
                                           lane_valid, lane_counts, k_chunk)
    assert int(pairs) == int(n_pairs.sum()) > 0
    assert int(lanes) == int(n_lanes.sum()) > 0


def test_the_explore_driver_reads_the_rasterizers_arguments_by_name():
    import inspect

    from macarons_tpu_torch.ops import rasterizer

    names = inspect.signature(rasterizer.rasterize_tiled).parameters
    for name in ("pface", "starts", "counts", "K_cap", "lane_valid",
                 "lane_counts", "k_chunk", "tile"):
        assert name in names
