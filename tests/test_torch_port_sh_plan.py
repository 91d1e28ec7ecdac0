"""The launch plan of B3's forward kernel (csrc/sh_visibility.cu,
sh_visibility_kernel), checked on the CPU: the plan's (block, thread, camera
step) index map, enumerated in plain Python as the kernel computes it, writes
every output (b, c, l) exactly once, stays inside its arrays, and fits
CUDA's launch limits."""

import numpy as np
import pytest

from macarons_tpu_torch.ops.cuda import sh_visibility as shv

SHAPES = [(24, 1, 2048), (4, 1, 2048), (1, 52, 2048), (3, 52, 2048),
          (1, 53, 1001), (2, 5, 333), (1, 1, 1), (1, 70001, 3)]


def kernel_writes(plan, B, C, L):
    """Each thread's writes, as sh_visibility_kernel computes them: (block,
    thread) -> [output index b * C * L + c * L + l, ...] in camera-step
    order. Also checks the staging reads: the block's coefficient rows and
    each chunk of camera centres lie inside the batch's."""
    writes = {}
    for block in range(plan.blocks):
        b = block // plan.tiles
        l0 = (block - b * plan.tiles) * plan.points
        n = min(plan.points, L - l0)
        assert 1 <= n and l0 + n <= L  # the staged rows
        for t in range(plan.threads):
            slice_ = t // plan.points
            j = t - slice_ * plan.points
            if j >= n:
                continue
            out = []
            c0 = 0
            while True:
                m = min(plan.chunk, C - c0)
                assert 0 < m and c0 + m <= C  # the staged camera centres
                out += [b * C * L + (c0 + c) * L + l0 + j
                        for c in range(slice_, m, plan.slices)]
                c0 += plan.chunk
                if c0 >= C:
                    break
            writes[block, t] = out
    return writes


@pytest.mark.parametrize("B,C,L", SHAPES)
def test_forward_plan_writes_each_output_once(B, C, L):
    plan = shv.forward_plan(B, C, L)
    # CUDA's limits and the kernel's: grid, block, shared memory, chunking.
    assert 1 <= plan.blocks <= shv.MAX_GRID
    assert plan.blocks == B * plan.tiles
    assert 1 <= plan.threads <= shv.MAX_FORWARD_THREADS
    assert plan.smem_bytes <= shv.MAX_SMEM_BYTES
    assert plan.chunk % plan.slices == 0 and plan.slices <= C

    writes = kernel_writes(plan, B, C, L)
    counts = np.zeros(B * C * L, dtype=np.int64)
    for out in writes.values():
        idx = np.asarray(out, dtype=np.int64)
        assert idx.size == 0 or (idx.min() >= 0 and idx.max() < B * C * L)
        np.add.at(counts, idx, 1)
    assert (counts == 1).all()

    # Each slice gets ceil(C / slices) cameras or one fewer; at C = 1 one
    # thread computes one output.
    steps = [len(out) for out in writes.values()]
    assert max(steps) == -(-C // plan.slices)
    assert min(steps) >= max(steps) - 1
    if C == 1:
        assert plan.slices == 1 and max(steps) == 1

    # A warp's lanes of one slice write runs of consecutive l.
    for (block, t), out in writes.items():
        nxt = writes.get((block, t + 1))
        if (t + 1) % 32 and nxt is not None and \
                (t + 1) // plan.points == t // plan.points:
            assert [i + 1 for i in out] == nxt


def test_forward_plan_fills_the_card_where_cameras_share_points():
    """With ~50 cameras per point set the plan deals each point's cameras to
    slices of at least MIN_CAMERAS_PER_SLICE cameras, with no more threads
    than fill the card about once."""
    for B, C, L in ((1, 52, 2048), (3, 52, 2048)):
        plan = shv.forward_plan(B, C, L)
        assert plan.slices > 1
        assert -(-C // plan.slices) >= shv.MIN_CAMERAS_PER_SLICE
        assert B * L * plan.slices <= shv.FILL_THREADS


def test_forward_plan_refuses_an_oversized_grid():
    with pytest.raises(ValueError):
        shv.forward_plan(2**31, 1, 1)
    with pytest.raises(ValueError):
        shv.forward_plan(1, 0, 5)
