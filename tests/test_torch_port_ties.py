"""The port's tie rule against the JAX package (CPU).

``jax.lax.top_k`` returns the largest values with the lower index first
among equal ones; ``torch.topk`` leaves that order unspecified. Every top-k
or sort of the port whose ties reach a result follows the JAX rule: the
capped occupancy field's cell choice (``torch.argsort(-counts,
stable=True)``) and every smallest-k (``ops.knn.smallest_k``: kNN, SconeOcc's
down-samples, the grid's eviction, the depth points' subsample). The inputs
hold exact ties: integer counts, duplicated points, lattice points at equal
distances, masked pads and equal scores. The sampling CDFs' scan, which
made scene-scale runs differ on the card, is held here too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macarons_tpu.ops import knn as jknn
from macarons_tpu_torch.ops import knn
from macarons_tpu_torch.ops.geometry import FoVCamera, look_at_view_transform
from macarons_tpu_torch.ops.sampling import cumsum_rows
from macarons_tpu_torch.scene import runtime as R
from torch_port_helpers import torch_one_thread  # noqa: F401

# The ROADMAP's example of counts tied at the cut (k = 4): JAX scores cells
# [1, 4, 0, 2]; torch.topk on the CPU gave [1, 4, 27, 25].
C1_COUNTS = [3, 5, 3, 3, 5, 1] + [3] * 30


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("counts, k", [
    (C1_COUNTS, 4),
    ([2] * 40 + [7, 0, 2, 7], 8),
    ([0] * 20, 5),
])
def test_capped_field_scores_the_jax_cells(counts, k, monkeypatch):
    """The capped field (full_field=False) hands SconeOcc the cells that
    jax.lax.top_k ranks first, with the same cell_ok flags."""
    C = len(counts)
    counts = torch.tensor(counts)
    seen = []

    def eligible(self, proxy, tables, use_mask, eligible_override=None):
        return torch.ones((C, 1), dtype=torch.bool), counts

    def cells_of(self, proxy, surface, tables, cam, elig, perm, cells, ok):
        seen.append((cells.tolist(), ok.tolist()))
        n = cells.shape[0]
        return (torch.zeros(n, dtype=torch.int64), torch.zeros(n),
                torch.zeros(n, 64), torch.zeros(n, dtype=torch.bool))

    monkeypatch.setattr(R.OccupancyField, "_eligible", eligible)
    monkeypatch.setattr(R.OccupancyField, "_cells", cells_of)
    field = R.OccupancyField(None, max_cells=k)
    proxy = type("Proxy", (), {"points": torch.zeros((10, 3))})()
    tables = type("Tables", (),
                  {"slots": torch.zeros((C, 1), dtype=torch.int64)})()
    Rm, T = look_at_view_transform(torch.tensor([[0.0, 1.0, 5.0]]),
                                   torch.zeros((1, 3)))
    field(proxy, None, tables, FoVCamera.create(Rm, T), full_field=False)
    _, jcells = jax.lax.top_k(jnp.asarray(counts.numpy(), jnp.float32), k)
    jcells = np.asarray(jcells).tolist()
    assert seen == [(jcells, [int(counts[c]) > 0 for c in jcells])]
    if counts.tolist() == C1_COUNTS:
        assert jcells == [1, 4, 0, 2]


def tie_cases(rng):
    """(x, pc, pc_mask, k) with exact ties."""
    # Duplicated points: three copies of each, scattered.
    p = rng.normal(size=(2, 50, 3)).astype(np.float32)
    dup = np.concatenate([p, p, p], axis=1)[:, rng.permutation(150)]
    # Lattice points and queries at lattice points and cell centres: many
    # points at equal (exact) distances.
    g = np.arange(-2, 3, dtype=np.float32)
    lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(1, -1, 3)
    q = np.concatenate([lat[:, ::7], lat[:, 3:40:9] + 0.5], axis=1)
    # Masked pads: some queries see fewer valid points than k, so pads tied
    # at the mask distance reach the result.
    pads = rng.normal(size=(2, 30, 3)).astype(np.float32)
    pads = np.concatenate([pads, pads[:, :6]], axis=1)
    mask = np.zeros((2, 36), bool)
    mask[0, :20] = True
    mask[1, ::9] = True
    return {
        "duplicates": (rng.normal(size=(2, 40, 3)).astype(np.float32), dup,
                       None, 8),
        "lattice": (q, lat, None, 10),
        "masked pads": (rng.normal(size=(2, 12, 3)).astype(np.float32), pads,
                        mask, 8),
    }


@pytest.mark.parametrize("case", ["duplicates", "lattice", "masked pads"])
def test_knn_points_ties(case):
    """The JAX package's indices at exact ties: the duplicates and the
    pads are ordered among knn_points' candidates; the lattice's
    cell-centre queries (a tie wider than the candidate margin) take whole
    rows."""
    x, pc, mask, k = tie_cases(np.random.default_rng(3))[case]
    if mask is None:
        jg, jd, ji = jknn.knn_points(x, pc, k)
    else:
        jg, jd, ji, _ = jknn.knn_points_masked(x, pc, k, pc_mask=mask,
                                               approx=False)
    g, d, i = knn.knn_points(t(x), t(pc), k,
                             pc_mask=None if mask is None else t(mask))
    d2 = knn.pairwise_sqdist(t(x), t(pc))
    ranked = torch.sort(d2, dim=-1).values[..., :k + 1]
    assert bool((ranked[..., 1:] == ranked[..., :-1]).any())  # ties reach k
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    if case == "lattice":  # exact distances: the float64 path agrees
        _, _, i64 = knn.knn_points(t(x).double(), t(pc).double(), k)
        np.testing.assert_array_equal(i64.numpy(), i.numpy())


def test_knn_points_many_is_knn_points():
    """SconeOcc's scales in one call (one host sync): each query's result
    is knn_points' alone, the lattice's wide ties taken whole beside the
    duplicates' and the pads' candidates."""
    cases = tie_cases(np.random.default_rng(3))
    queries = [(t(x), t(pc), None if m is None else t(m))
               for x, pc, m, _ in cases.values()]
    for k in (8, 10):
        many = knn.knn_points_many(queries, k)
        for (x, pc, m), got in zip(queries, many):
            for a, b in zip(got, knn.knn_points(x, pc, k, pc_mask=m)):
                np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("values", [
    [1e9, 0.5, 1e9, 0.25, 0.5, 1e9, 0.0, -0.0, 0.25, 1e9],
    [2.0] * 7 + [0.5] * 7,
    [float(v % 3) for v in range(40)],
])
def test_smallest_k_ties(values):
    """Equal scores (the 1e9 of invalid slots, repeated draws, zeros of
    both signs) come out lower index first, in float32 and float64."""
    v = np.asarray(values, np.float32)
    k = len(values) // 2 + 1
    jv, ji = jax.lax.top_k(-jnp.asarray(v) + 0.0, k)
    for dtype in (torch.float32, torch.float64):
        vals, idx = knn.smallest_k(t(v).to(dtype), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), -np.asarray(jv))


@pytest.mark.parametrize("shape", [(232,), (59392,), (1, 4097), (3, 1000)])
def test_cumsum_rows(shape):
    """The sampling CDFs' scan (C.2: torch.cumsum's single-row CUDA scan
    changes its order of additions between runs): one row is scanned as
    one of a batch of rows, which on the CPU gives torch.cumsum's bits, and
    agrees with the JAX package's jnp.cumsum to float32 rounding."""
    x = np.random.default_rng(len(shape)).random(shape).astype(np.float32)
    ours = cumsum_rows(t(x)).numpy()
    np.testing.assert_array_equal(ours, torch.cumsum(t(x), -1).numpy())
    np.testing.assert_allclose(ours, np.asarray(jnp.cumsum(x, axis=-1)),
                               rtol=2e-6)
