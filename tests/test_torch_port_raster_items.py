"""The work items of the fused tile raster kernel (raster_tiled_kernel) on
the CPU, in pure PyTorch.

- The item table covers, for every row, exactly the first min(count, K_cap)
  pairs of its segment and its tested valid lanes, each once.
- Evaluating item by item (decoded as the kernel decodes them) with the
  twins' per-tile test ``nearest_face`` and merging by (z, face id) gives
  what the plain version of rasterize_tiled
  gives (the B1 and B2 twins and their merge): identical face ids, zbuf and
  barycentrics within 1e-5.
- The plain version equals the two-pass composition it replaces.

Inputs: chip_smoke's edge-case mesh (small and big faces, coplanar copies, a
degenerate face, a face crossing the camera plane, two cameras) through the
capture path's feeders, with K_cap below the largest tile's count, and
synthetic lists of 0, item - 1, item, item + 1 and more than K_cap pairs.
"""

import pytest
import torch

from chip_smoke import edge_case_mesh, item_boundary_args, raster_args
from macarons_tpu_torch.ops import rasterizer as rast
from macarons_tpu_torch.ops.cuda import tile_raster as tr
from torch_port_helpers import torch_one_thread  # noqa: F401

ATOL = 1e-5
ITEMS = (1, 7, 64, 128)


@pytest.fixture(scope="module")
def f9():
    verts, faces, cam = edge_case_mesh(torch.Generator().manual_seed(0))
    return rast.project_fv_batch(verts, faces, cam)


def fused_args(f9, kind, size, K_cap, item, pc=True):
    if kind == "feeder":
        return raster_args(f9, size, K_cap, pc)[2]
    return item_boundary_args(f9, size, K_cap, item, pc,
                              torch.Generator().manual_seed(item))[2]


def items(cum, n_pairs, n_lanes, item):
    """Every item of the table as raster_tiled_kernel decodes it (its
    row_search, row_from and make_item): (row, lanes (bool: lanes or
    pairs), begin (first position in the row's pair segment or compacted
    lane list), m (faces)), each (n_items,)."""
    i = torch.arange(int(cum[-1]))
    row = torch.searchsorted(cum, i, right=True) - 1
    n_p = n_pairs[row].long()
    j = i - cum[row]
    ip = -(-n_p // item)
    lanes = j >= ip
    begin = torch.where(lanes, j - ip, j) * item
    m = torch.clamp(torch.where(lanes, n_lanes[row].long(), n_p) - begin,
                    max=item)
    return row, lanes, begin, m


def table(args, item):
    (_, pface, starts, counts, _, lane_valid, lane_counts, *_, K_cap,
     k_chunk, _) = args
    return tr.item_table(starts, counts, pface.shape[0], K_cap, lane_valid,
                         lane_counts, k_chunk, item)


@pytest.mark.parametrize("item", ITEMS)
def test_item_table_covers_each_face_once(f9, item):
    args = fused_args(f9, "boundary", (37, 53), 256, item)
    _, _, starts, counts, _, lane_valid, lane_counts, *_ = args
    n_pairs, lane_idx, n_lanes, cum = table(args, item)
    nfe = args[1].shape[0]
    lens = counts.clamp(min=0).tolist()
    assert {0, item + 1, 256 + 5}.issubset(lens)
    assert set(n_pairs.tolist()) >= {item - 1, item, item + 1}
    assert int(n_pairs[-1]) == nfe - int(starts[-1]) == 3 < int(counts[-1])
    row, lanes, begin, m = items(cum, n_pairs, n_lanes, item)
    assert len(row) == int(cum[-1])
    assert bool((m >= 1).all() and (m <= item).all())
    assert bool((row[1:] >= row[:-1]).all())  # rows in order
    K = lane_valid.shape[1]
    tested = (lane_valid & (torch.arange(K) < tr._tile_lengths(
        lane_counts, K, 32)[:, None]))
    assert bool((tested.sum(1) < lane_valid.sum(1)).any())  # skipped lanes
    for r in range(len(n_pairs)):
        mine = row == r
        kinds = lanes[mine].tolist()
        assert kinds == sorted(kinds)  # the pairs, then the lanes
        for is_lane, n in ((False, int(n_pairs[r])), (True, int(n_lanes[r]))):
            sel = mine & (lanes == is_lane)
            pos = torch.cat([torch.arange(b, b + k) for b, k in
                             zip(begin[sel].tolist(), m[sel].tolist())]
                            + [torch.zeros(0, dtype=torch.long)])
            assert pos.tolist() == list(range(n))
        n = min(max(lens[r], 0), 256, nfe - int(starts[r]))
        assert int(n_pairs[r]) == max(n, 0)
        assert (lane_idx[r, :int(n_lanes[r])].tolist()
                == torch.nonzero(tested[r])[:, 0].tolist())


def evaluate_items(args, item):
    """rasterize_tiled computed item by item: each item's faces through
    nearest_face, then per pixel the lexicographic minimum of (z, face id)
    over the items of its row."""
    (f9, pface, starts, _, lane_faces, _, _, tile, TW, H, W, n_tiles, _, _,
     pc) = args
    n_pairs, lane_idx, n_lanes, cum = table(args, item)
    row, lanes, begin, m = items(cum, n_pairs, n_lanes, item)
    R, P, K = starts.shape[0], tile * tile, lane_faces.shape[1]
    k = torch.arange(item)
    pos = begin[:, None] + k
    e = (starts.long()[row, None] + pos).clamp(0, pface.shape[0] - 1)
    lane = lane_idx[row[:, None], pos.clamp(max=K - 1)].long()
    ids = torch.where(lanes[:, None], lane_faces[row[:, None], lane],
                      pface[e]).long()
    z, key, b0, b1 = (torch.empty(len(row), P, dtype=d) for d in
                      (torch.float32, torch.long, torch.float32,
                       torch.float32))
    step = max(1, tr.BLOCK_ELEMS // (P * item))
    for a in range(0, len(row), step):
        s = slice(a, a + step)
        fv = f9[(row[s] // n_tiles)[:, None], :, ids[s]].permute(0, 2, 1)
        px, py, ok = tr.pixel_ndc(row[s] % n_tiles, tile, TW, H, W)
        z[s], lane_s, b0[s], b1[s], _ = tr.nearest_face(
            fv, k < m[s, None], px, py, ok, pc)
        key[s] = ids[s].gather(1, lane_s)
    at = row[:, None].expand(-1, P)
    inf = float("inf")
    zmin = torch.full((R, P), inf).scatter_reduce(0, at, z, "amin")
    tie = z == zmin[row]
    big = torch.iinfo(torch.long).max
    kmin = torch.full((R, P), big).scatter_reduce(
        0, at, torch.where(tie, key, big), "amin")
    win = tie & (key == kmin[row])

    def pick(x):
        return torch.full((R, P), -inf).scatter_reduce(
            0, at, torch.where(win, x, -inf), "amax")

    hit = zmin < inf
    return (torch.where(hit, zmin, -1.0), torch.where(hit, kmin, -1),
            torch.where(hit, pick(b0), 0.0), torch.where(hit, pick(b1), 0.0))


@pytest.mark.parametrize("kind,size,K_cap,item,pc", [
    ("feeder", (37, 53), 1024, 64, True),
    ("feeder", (37, 53), 128, 7, True),
    ("feeder", (37, 53), 128, 128, False),
    ("feeder", (256, 456), 64, 64, True),
    ("boundary", (37, 53), 128, 1, True),
    ("boundary", (37, 53), 128, 7, False),
    ("boundary", (37, 53), 128, 64, True),
    ("boundary", (37, 53), 1024, 128, True)])
def test_items_merged_by_depth_and_id_equal_plain(f9, kind, size, K_cap, item,
                                                  pc):
    args = fused_args(f9, kind, size, K_cap, item, pc)
    ours = evaluate_items(args, item)
    ref = tr.rasterize_tiled(*args)
    assert torch.equal(ours[1], ref[1].long())
    for a, b in zip(ours[::2] + ours[3:], ref[::2] + ref[3:]):
        torch.testing.assert_close(a, b, rtol=0, atol=ATOL)
    hit = ref[1] >= 0
    assert 0.02 < float(hit.float().mean()) < 1.0
    if kind == "feeder":
        assert int(args[3].max()) > K_cap or K_cap == 1024


@pytest.mark.parametrize("size,K_cap,pc", [((37, 53), 128, True),
                                           ((256, 456), 1024, False)])
def test_plain_equals_two_pass_composition(f9, size, K_cap, pc):
    """The plain version against what the tiled path computed before: B1's
    twin over the gathered pair rows, B2's over the gathered lanes, their
    slots mapped to face ids, and the merge."""
    b1, b2, fused = raster_args(f9, size, K_cap, pc)
    faces = fused[4].long()
    z, slot, b0, bb1 = tr.rasterize_tiles_plain(*b2)
    fid = torch.where(slot >= 0, faces.gather(1, slot.clamp(min=0).long()),
                      -1)
    want = tr.merge_passes(tr.rasterize_pairs_plain(*b1), (z, fid, b0, bb1))
    got = tr.rasterize_tiled(*fused)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[1].dtype == torch.int32
    assert bool((got[1] >= 0).any())


def test_tiled_path_routes_pairlist_through_fused_wrapper(f9, monkeypatch):
    calls = []
    fused = tr.rasterize_tiled

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return fused(*args, **kw)

    monkeypatch.setattr(rast, "rasterize_tiled", counting)
    frags = rast._rasterize_tiled(f9, (37, 53), 16, 128, True)
    assert calls == [f9.shape]
    assert frags.pix_to_face.dtype == torch.int64
    assert frags.pix_to_face.shape == (2, 37, 53)
