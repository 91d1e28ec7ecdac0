"""The control comes out not correct: the plain reference computed in TF32,
the nearest precision below the float32 that the configurations state, put
in the program's place, fails one of each cell's compared numbers at the
committed limits. TF32 exists only on the card, so this test runs there
alone (``python -m pytest benchmark/tests -m gpu``); on the CPU it skips.
The readings at the cells' own sizes come from ``benchmark/controls.py``
(PERF.md)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

from benchmark.harness import core  # noqa: E402
from test_bench_faults import SIZES  # noqa: E402

CARD_SIZES = {
    "explore.macarons-default": {
        "config": dict(SIZES["explore.macarons-default"]["config"],
                       image_height=128, image_width=224,
                       n_proxy_points=20000, seq_len=512, n_depth=32),
        "traffic": dict(SIZES["explore.macarons-default"]["traffic"],
                        scene_levels=2)},
    "pretrain-vis.scone": {
        "config": {"n_proxy_points": 20000, "seq_len": 512},
        "traffic": {"mesh_levels": [2, 0, 0],
                    "gt_config": {"image_size": 128}}},
}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CARD_SIZES))
def test_the_control_is_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    bench = core.load_benchmark()
    entry = core.cell_entry(bench, cell)
    for seed in (101, 202, 303):
        with core.drive(bench, entry, seed, 1.0, False, torch.device("cuda"),
                        sizes=CARD_SIZES[cell]) as (ctx, driver, state, out):
            checks = driver.check(ctx, state, out, control=True)
        assert any(c["value"] > c["limit"] for c in checks), checks
