"""A run of each cell on the CPU at a small size, past the look for a
card: sound, it comes out correct; with its timed path broken underneath
it comes out not correct, once for each fault the cell can have:

- explore: an answer altered where it is produced (B3's visibilities, the
  captured depth, ManyDepth's depth, the pose chosen);
- pretrain-vis: a step that returns its state unchanged, half of the batch
  left out with the mean over the rest, an answer altered (B3).

The limits are the committed ones (benchmark/traffic/*.json)."""

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

from benchmark.harness import core  # noqa: E402

SEED = 3_000_000_019
SIZES = {
    "explore.macarons-default": {
        "config": {"image_height": 64, "image_width": 96,
                   "n_proxy_points": 3000, "n_gt_surface_points": 3000,
                   "seq_len": 128, "n_depth": 8, "n_poses_in_trajectory": 3},
        "traffic": {"scene_levels": 0, "warmup_poses": 1, "check_poses": 1,
                    "check_from": 0}},
    "pretrain-vis.scone": {
        "config": {"n_proxy_points": 3000, "seq_len": 128},
        "traffic": {"mesh_levels": [0, 0, 0],
                    "gt_config": {"image_size": 64,
                                  "n_points_surface": 2048}}},
}
FAULTS = [("explore.macarons-default", ()),
          ("explore.macarons-default", ("answer",)),
          ("explore.macarons-default", ("frame",)),
          ("explore.macarons-default", ("depth",)),
          ("explore.macarons-default", ("choice",)),
          ("pretrain-vis.scone", ()),
          ("pretrain-vis.scone", ("unchanged",)),
          ("pretrain-vis.scone", ("half",)),
          ("pretrain-vis.scone", ("answer",))]


@pytest.mark.parametrize("cell,faults", FAULTS)
def test_a_run_is_correct_only_without_faults(cell, faults):
    torch.manual_seed(0)
    bench = core.load_benchmark()
    result = core.execute(bench, core.cell_entry(bench, cell), SEED, 0.5,
                          False, torch.device("cpu"), time.perf_counter(),
                          faults=faults, sizes=SIZES[cell])
    failing = {k: v for k, v in result["checks"].items()
               if v["value"] > v["limit"]}
    assert result["attempted"] > 0
    assert result["correct"] == (not faults), failing
    assert list(result)[-1] == "checks"


def test_the_checked_poses_are_drawn_over_the_whole_window():
    # Reservoir sampling: n poses from ordinal `first` on, each pose of a
    # window of any length equally likely, the same for the same seed.
    from benchmark.drivers.explore import PoseSample

    def drawn(seed, poses, n=3, first=1):
        sample, slots = PoseSample(seed, n, first), [None] * n
        for k in range(poses):
            j = sample.slot(k)
            if j is not None:
                slots[j] = k
        return slots

    assert drawn(5, 95) == drawn(5, 95)
    assert drawn(5, 3) == [1, 2, None]
    hits = [0] * 95
    for seed in range(3000):
        for k in drawn(seed, 95):
            hits[k] += 1
    assert hits[0] == 0
    expected = 3000 * 3 / 94
    assert all(abs(h - expected) < 0.35 * expected for h in hits[1:])
    assert sum(hits[60:]) > 0.3 * 3000 * 3
