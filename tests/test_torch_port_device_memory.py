"""The trainer's device memory on the CPU, held to the JAX package's.

- ``FrameRing``, ``FrameStore`` and ``DepthStore`` sequences, past their
  capacity and with windows at frame 0 and at the end (JAX clamps the
  slices' starts), against JAX's functions on the same arrays: exact.
- ``DeviceMemory``'s three samplers over the same counts from one
  ``default_rng`` seed, against JAX ``DeviceMemory``: the same draws, the
  same outputs.
- ``flush_to_disk`` read by JAX ``Memory``, and JAX
  ``DeviceMemory.flush_to_disk`` hydrated by the port: array for array.
- Two ranks' memories of disjoint scenes, each writing its keys
  (``flush_to_disk(keys)``, stale files of a longer trajectory removed)
  and loading the other's (``load_from_disk``): both equal one memory of
  every scene key for key, and their samplers and windows equal JAX
  ``DeviceMemory``'s over the same arrays.
- The episode functions on a 4x4x4x3x8 lattice with an occupied cell, the
  azimuth's wrap and clamped duplicates at an edge, against JAX's and the
  host ``Camera``; ``episode_random_start`` on injected index batches in its
  four cases (JAX's function run with ``jax.disable_jit`` and its draws
  replaced by the batches); the selection rule on injected gains.
- Two device-memory trajectories at tiny widths (a remap at pose 2, the
  second trajectory replaying the first), as the JAX package's
  ``test_zero_sync_trajectory`` runs them, with its invariants.
- ``run_training``'s choice of memory (``device_memory`` absent: the device
  memory, hydrated on resume and flushed once per epoch; false: a disk
  ``Memory`` per epoch), the trajectories scripted, against JAX's, each
  handed the episodes of its memory.
- The port's own: ``flush_to_disk`` holding one slot's host copies at a
  time, the disk ``Memory``'s ``depth_stack`` against the device one's,
  and the device memory's placement on the card
  (``check_device_memory_fits`` on a scripted ``mem_get_info``: all on
  the card, a host tier, or a raise; one rank or two sharing the card;
  ``run_training`` stopping on it).
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macarons_tpu.config import Params as JParams
from macarons_tpu.scene import camera as JC
from macarons_tpu.scene import depth_runtime as jdr
from macarons_tpu.scene import memory as jmem
from macarons_tpu.scene.grid import GridState as JGridState
from macarons_tpu.scene.proxy import ProxyState as JProxyState
from macarons_tpu.trainers import train_macarons as JTM
from macarons_tpu_torch.config import Params
from macarons_tpu_torch.data.scenes import SceneDataset
from macarons_tpu_torch.models.macarons import create_macarons_model, \
    create_optimizers, init_macarons_weights
from macarons_tpu_torch.scene import camera as C
from macarons_tpu_torch.scene import depth_runtime as dr
from macarons_tpu_torch.scene import memory as mem
from macarons_tpu_torch.scene.grid import GridState
from macarons_tpu_torch.scene.proxy import ProxyState
from macarons_tpu_torch.trainers import train_macarons as TM
from test_torch_port_train_epochs import random_variables
from test_torch_port_train_loop import TRAIN
from torch_port_helpers import make_scene_root, torch_one_thread  # noqa: F401

H, W = 4, 6


def frames(rs, K):
    return (rs.uniform(size=(K, H, W, 3)).astype(np.float32),
            rs.uniform(-1, 5, size=(K, H, W, 1)).astype(np.float32),
            rs.uniform(size=(K, H, W, 1)) > 0.5,
            rs.normal(size=(K, 3, 3)).astype(np.float32),
            rs.normal(size=(K, 3)).astype(np.float32))


def depths(rs, k):
    return (rs.uniform(1, 5, size=(k, H, W, 1)).astype(np.float32),
            rs.uniform(size=(k, H, W, 1)) > 0.5,
            rs.uniform(size=(k, H, W, 1)) > 0.5,
            rs.normal(size=(k, 3, 3)).astype(np.float32),
            rs.normal(size=(k, 3)).astype(np.float32))


def t(arrays):
    return tuple(torch.tensor(np.asarray(a)) for a in arrays)


def same(ours, ref):
    """Exact equality, tensors or arrays or trees of them."""
    if isinstance(ref, dict):
        assert set(ours) == set(ref)
        for k in ref:
            same(ours[k], ref[k])
    elif isinstance(ref, (tuple, list)) and not hasattr(ref, "shape"):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            same(a, b)
    else:
        a = ours.cpu().numpy() if isinstance(ours, torch.Tensor) else \
            np.asarray(ours)
        b = np.asarray(ref)
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                           a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Rings and stores
# ---------------------------------------------------------------------------


def test_ring_and_frame_store():
    rs = np.random.default_rng(0)
    ring = dr.init_frame_ring(4, H, W, 40.0)
    jring = jdr.init_frame_ring(4, H, W, 40.0)
    same(tuple(ring), tuple(jring))
    for K in (3, 2, 5, 1):
        f = frames(rs, K)
        ring = dr.ring_push(ring, *t(f), 40.0)
        jring = jdr.ring_push(jring, *f, 40.0)
        same(tuple(ring), tuple(jring))
        for n in (1, 3, 4):
            same(dr.ring_frames(ring, n), jdr.ring_frames(jring, n))

    store = dr.init_frame_store(6, H, W)
    jstore = jdr.init_frame_store(6, H, W)
    same(tuple(store[:5]), tuple(jstore[:5]))
    for K in (3, 2, 3, 2):  # the third and fourth pass the capacity
        f = frames(rs, K)
        store = dr.store_append(store, *t(f))
        jstore = jdr.store_append(jstore, *(jnp.asarray(a) for a in f))
        same(tuple(store[:5]), tuple(jstore[:5]))
        assert store.n == int(jstore.n)
        for last, n in ((0, 3), (2, 3), (store.n - 1, 3), (4, 6), (1, 1)):
            same(dr.store_window(store, last, n, 40.0),
                 jdr.store_window(jstore, last, n, 40.0))


def test_depth_store():
    rs = np.random.default_rng(1)
    ds, jds = mem.DepthStore(4, H, W), jmem.DepthStore(4, H, W)
    for k in (1, 2, 2, 1):  # 5 and 6 entries pass the capacity of 4
        d = depths(rs, k)
        ds.append(*t(d))
        jds.append(*(jnp.asarray(a) for a in d))
        assert ds.n == jds.n
        for name in mem.DepthStore.FIELDS:
            same(getattr(ds, name), getattr(jds, name))
    for idx in ([0, 1, 2, 3], [3, 1], [2], [1, 1, 0]):
        same(ds.gather(idx), jds.gather(idx))


COUNTS = {(0, 0): (7, 3), (0, 1): (2, 0), (0, 2): (11, 5), (1, 0): (5, 2),
          (1, 2): (3, 1)}  # (scene, slot): (frames, depths)


def fill(dm, paths, rs, lib, scenes=(0, 1)):
    """The same trajectories in either package's DeviceMemory: frames,
    depths, snapshots and poses in 3 slots of two scenes; only those of
    ``scenes`` are kept (the others go to a memory that is dropped, so the
    draws are the same)."""
    arr = (lambda a: jnp.asarray(a)) if lib == "jax" else \
        (lambda a: torch.tensor(np.asarray(a)))
    mine = dm
    dropped = type(dm)(paths, n_trajectories=dm.n_trajectories,
                       max_frames=dm.max_frames, max_depths=dm.max_depths,
                       height=dm.height, width=dm.width, zfar=dm.zfar)
    for (p, slot), (n, n_d) in COUNTS.items():
        dm = mine if p in scenes else dropped
        dm.current_epoch = slot
        path = paths[p]
        store = dm.begin_trajectory(path)
        for K in (1, n - 1) if n > 1 else (1,):
            f = frames(rs, K)
            mod = jdr if lib == "jax" else dr
            store = mod.store_append(store, *(arr(a) for a in f))
            if lib == "jax":
                dm.update_store(path, store, K)
            else:
                dm.update_store(path, store)
        for i in range(n_d):
            dm.save_depth(path, i, *(arr(a) for a in depths(rs, 1)))
        N = 20
        grid = (rs.normal(size=(8, 4, 3)).astype(np.float32),
                rs.uniform(size=(8, 4, 1)).astype(np.float32),
                rs.uniform(size=(8, 4)) > 0.5)
        proxy = [rs.uniform(size=(N,) + shape).astype(np.float32)
                 for shape in ((3,), (1,), (1,), (98,), (1,), (1,), (1,))]
        proxy[2] = (proxy[2] > 0.5).astype(np.float32)
        G = JGridState if lib == "jax" else GridState
        P = JProxyState if lib == "jax" else ProxyState
        dm.save_surface_scene(path, G(*(arr(a) for a in grid)))
        dm.save_occupancy_field(path, P(*(arr(a) for a in proxy)))
        dm.save_poses(path, 0, arr(rs.normal(size=(12, 3)).astype(np.float32)),
                      arr(rs.normal(size=(12, 2)).astype(np.float32)),
                      arr(rs.integers(0, 5, size=(6, 5))), n_moves=4,
                      n_frames=9)
    mine.current_epoch = 0


def device_memories(tmp_path):
    paths = [str(tmp_path / f"s{i}" / "macarons_memory") for i in (0, 1)]
    kw = dict(n_trajectories=3, max_frames=12, max_depths=6, height=H,
              width=W, zfar=40.0)
    ours, ref = mem.DeviceMemory(paths, **kw), jmem.DeviceMemory(paths, **kw)
    fill(ours, paths, np.random.default_rng(2), "torch")
    fill(ref, paths, np.random.default_rng(2), "jax")
    return paths, ours, ref


def test_samplers(tmp_path):
    paths, ours, ref = device_memories(tmp_path)
    check_samplers(paths, ours, ref)


def check_samplers(paths, ours, ref):
    """The port's and JAX's DeviceMemory over the same trajectories: the
    counts, the three samplers from one default_rng seed (each exclusion),
    the windows and the depth stacks."""
    for p in paths:
        for slot in range(3):
            assert ours.n_frames(p, slot) == ref.n_frames(p, slot)
            assert ours.n_depths(p, slot) == ref.n_depths(p, slot)
    hits = 0
    for seed in range(12):
        for exclude in (None, 0, 2):
            out = []
            for dm in (ours, ref):
                rs = np.random.default_rng(seed)
                out.append((
                    dm.get_random_frames_for_depth(rs, paths[seed % 2], 3,
                                                   exclude),
                    dm.sample_depth_replay(rs, 5, 3, exclude),
                    dm.get_random_scene_for_scone(
                        rs, paths[seed % 2], 2, n_loops=1, max_build=4,
                        exclude_traj=exclude, n_proxy_points=20),
                    rs.bit_generator.state))
            same(out[0][:2], out[1][:2])
            assert out[0][3] == out[1][3]
            a, b = out[0][2], out[1][2]
            assert (a is None) == (b is None)
            if a is not None:
                hits += 1
                assert a[:2] == b[:2]
                same(a[2], b[2])
    assert hits > 10
    # Windows and depth stacks.
    for p, slot, last, n in ((paths[0], 0, 6, 3), (paths[0], 2, 0, 3),
                             (paths[1], 0, 4, 5)):
        same(ours.load_frame_sequence(p, last, n, slot),
             ref.load_frame_sequence(p, last, n, slot))
    same(ours.depth_stack(paths[0], 2, [1, 2, 3]),
         ref.depth_stack(paths[0], 2, [1, 2, 3]))
    same(ours.load_depth(paths[0], 4, traj=2), ref.load_depth(paths[0], 4,
                                                              traj=2))


def test_exchange_over_ranks(tmp_path):
    """Two ranks' memories, each holding one scene's trajectories: each
    writes its keys (one rank's slot dirs also hold a longer trajectory's
    files, which its flush removes) and loads the other's. Then both hold
    what one memory of both scenes holds, key for key, and replay from
    either draws and reads what JAX DeviceMemory does over the same
    arrays."""
    paths, ours, ref = device_memories(tmp_path)
    kw = dict(n_trajectories=3, max_frames=12, max_depths=6, height=H,
              width=W, zfar=40.0)
    ranks = [mem.DeviceMemory(paths, **kw) for _ in (0, 1)]
    keys = []
    for r, dm in enumerate(ranks):
        fill(dm, paths, np.random.default_rng(2), "torch", scenes=(r,))
        keys.append([(paths[p], t) for p, t in COUNTS if p == r])
        assert dm.keys() == sorted(keys[r])
    # A longer trajectory's files in scene 0's slot 0.
    disk = mem.Memory(paths, n_trajectories=3)
    stale = dict(zip(("rgb", "zbuf", "mask", "R", "T"), frames(
        np.random.default_rng(3), 1)))
    for i in range(7, 10):
        disk.save_frame(paths[0], i, **stale, zfar=40.0, traj=0)
        disk.save_depth(paths[0], 3 + i, *depths(np.random.default_rng(i),
                                                 1), traj=0)
    disk.flush()
    written = [dm.flush_to_disk(k) for dm, k in zip(ranks, keys)]
    assert disk.n_frames(paths[0], 0) == 7 and disk.n_depths(paths[0], 0) == 3
    read = [ranks[0].load_from_disk(keys[1]),
            ranks[1].load_from_disk(keys[0])]
    # The bytes read are the keys' stores and snapshots; those written
    # also hold the poses.
    for r in (0, 1):
        held = sum(v.nbytes for key in keys[1 - r]
                   for v in ours.key_state(key).values())
        assert 0 < read[r] == held < written[1 - r]
    for dm in ranks:
        assert dm.keys() == ours.keys()
        for key in ours.keys():
            same(dm.key_state(key), ours.key_state(key))
        check_samplers(paths, dm, ref)
    # A key without files is left empty; loading a key again replaces it.
    ranks[0].load_from_disk([(paths[1], 1), (paths[0], 0)])
    assert ranks[0].n_frames(paths[1], 1) == 0
    same(ranks[0].key_state((paths[0], 0)), ours.key_state((paths[0], 0)))


def test_flush_and_hydrate(tmp_path):
    """The port's flush read by JAX Memory, and JAX's flush hydrated by
    the port: every slot's frames, depths, snapshots and poses."""
    paths, ours, ref = device_memories(tmp_path)
    ours.flush_to_disk()
    disk = jmem.Memory(paths, n_trajectories=3)
    for p in paths:
        for slot in range(3):
            n, n_d = ours.n_frames(p, slot), ours.n_depths(p, slot)
            assert disk.n_frames(p, slot) == n
            assert disk.n_depths(p, slot) == n_d
            if n:
                fr = disk.load_frame_sequence(p, n - 1, n, slot)
                same(ours.load_frame_sequence(p, n - 1, n, slot),
                     {k: fr[k] for k in ("images", "zbuf", "mask", "R", "T",
                                         "zfar")})
            for i in range(n_d):
                same(ours.load_depth(p, i, slot), disk.load_depth(p, i, slot))
            if (p, slot) in ours._surface:
                same(tuple(ours.load_surface_scene(p, slot)[0]),
                     tuple(disk.load_surface_scene(p, slot)[0]))
                same(tuple(ours.load_occupancy_field(p, slot)[0]),
                     tuple(disk.load_occupancy_field(p, slot)[0]))
                X, V, idx, n_m, n_f = ours._poses[(p, slot)][0]
                with np.load(os.path.join(p, "training", str(slot), "poses",
                                          "epoch_0.npz")) as f:
                    same(X[:n_f], f["X_cam"])
                    same(V[:n_f], f["V_cam"])
                    same(idx[:n_m], f["cam_idx"])

    jpaths = [str(tmp_path / "j" / f"s{i}") for i in (0, 1)]
    ref.scene_memory_paths = jpaths
    ref._frames = {(jpaths[paths.index(p)], s): v
                   for (p, s), v in ref._frames.items()}
    for name in ("_n_frames", "_depths", "_surface", "_occupancy", "_poses"):
        setattr(ref, name, {(jpaths[paths.index(p)], s): v for (p, s), v in
                            getattr(ref, name).items()})
    ref.flush_to_disk()
    back = mem.DeviceMemory(jpaths, n_trajectories=3, max_frames=12,
                            max_depths=6, height=H, width=W, zfar=40.0)
    back.hydrate_from_disk()
    for p in jpaths:
        for slot in range(3):
            n = ref.n_frames(p, slot)
            assert back.n_frames(p, slot) == n
            assert back.n_depths(p, slot) == ref.n_depths(p, slot)
            if n:
                same(tuple(back.store(p, slot)[:5]),
                     tuple(ref.store(p, slot)[:5]))
            if ref.n_depths(p, slot):
                for name in mem.DepthStore.FIELDS:
                    same(getattr(back._depths[(p, slot)], name),
                         getattr(ref._depths[(p, slot)], name))
            if (p, slot) in ref._surface:
                same(tuple(back.load_surface_scene(p, slot)[0]),
                     tuple(ref.load_surface_scene(p, slot)[0]))
                same(tuple(back.load_occupancy_field(p, slot)[0]),
                     tuple(ref.load_occupancy_field(p, slot)[0]))


def slot_bytes(dm, p, slot):
    """Host bytes of one (scene, slot)'s files' arrays."""
    n = dm.n_frames(p, slot)
    out = sum(x[:n].nbytes for x in dm.store(p, slot)[:5]) if n else 0
    ds = dm._depths.get((p, slot))
    if ds is not None:
        out += sum(getattr(ds, k)[:ds.n].nbytes for k in ds.FIELDS)
    for snap in (dm._surface, dm._occupancy):
        if (p, slot) in snap:
            out += sum(a.nbytes for a in snap[(p, slot)][0])
    for X, V, idx, n_m, n_f in dm._poses.get((p, slot), {}).values():
        out += X[:n_f].nbytes + V[:n_f].nbytes + idx[:n_m].nbytes
    return out


def test_flush_one_slot_at_a_time(tmp_path):
    """flush_to_disk waits for each (scene, slot)'s writes before it queues
    the next one's: the host copies its queued writes hold at once never
    pass the largest slot's bytes, and every write has landed when it
    returns."""
    paths, ours, _ = device_memories(tmp_path)
    sizes = [slot_bytes(ours, p, slot) for p in paths for slot in range(3)]
    mem.Memory([]).flush()
    mem.Memory.reset_queued_peak()
    ours.flush_to_disk()
    assert 0 < mem.Memory.queued_peak() <= max(sizes) < sum(sizes)
    assert not mem.Memory._inflight
    assert mem.Memory._held["now"] == 0


def test_disk_depth_stack(tmp_path):
    """The disk Memory's depth_stack, which SCONE replay reads on either
    memory: the files of the flushed depths stacked as the DeviceMemory
    stacks them, with repeats and out of order."""
    paths, ours, _ = device_memories(tmp_path)
    ours.flush_to_disk()
    disk = mem.Memory(paths, n_trajectories=3)
    for p, slot, idx in ((paths[0], 0, [0, 1, 2]), (paths[0], 2, [4, 1, 1]),
                         (paths[1], 0, [1]), (paths[1], 2, [0, 0])):
        same(ours.depth_stack(p, slot, idx), disk.depth_stack(p, slot, idx))


GIB = 2 ** 30


@pytest.mark.parametrize("free_gib", [41.0, 40.0])
def test_device_memory_fit_check(monkeypatch, free_gib):
    """check_device_memory_fits on a scripted card and host: the stores of
    every (scene, slot) at the default config's widths (8 scenes x 5
    slots of 403 frames, 43.28 GB = 40.31 GiB) plus the headroom against
    the free bytes and the allocator's cached ones: all on the card where
    they fit; else one slot a scene on the card (8.06 GiB) and the rest
    in host memory (32.25 GiB) where that fits; a run where even the one
    slot a scene does not fit raises naming device_memory false; off the
    card nothing is asked. Two ranks sharing the card each need their
    stores and headroom: the free bytes that hold one rank's tier do not
    hold two, and twice those bytes (and 1 GiB) hold two ranks' stores
    where they held one rank's."""
    calls = []
    free = [free_gib]

    def mem_get_info(device=None):
        calls.append(device)
        return int(free[0] * GIB), 80 * GIB

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: 3 * GIB)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: 1 * GIB)
    monkeypatch.setattr(TM.mesh, "ranks_on_host", lambda: 1)
    monkeypatch.setattr(TM, "host_memory_available", lambda: 64 * GIB)
    kw = dict(n_trajectories=5, max_frames=403, max_depths=403, height=256,
              width=456, zfar=750.0)
    paths = [f"s{i}" for i in range(8)]
    dm = mem.DeviceMemory(paths, device="cuda", **kw)
    assert dm.full_nbytes() == 40 * 1_082_064_672
    assert dm.nbytes() == 0
    # 40.31 GiB of stores and 2 GiB of headroom: 41 GiB free and 2 cached
    # hold them all, 40 and 2 hold one slot a scene (and the host the
    # rest).
    want = "card" if free_gib == 41.0 else "host tier"
    assert TM.check_device_memory_fits(dm, 2.0) == want
    # With 36 GiB of headroom not even one slot a scene fits.
    with pytest.raises(RuntimeError, match='"device_memory": false'):
        TM.check_device_memory_fits(dm, TM.DEVICE_MEMORY_HEADROOM_GIB)
    assert len(calls) == 2
    assert TM.check_device_memory_fits(mem.DeviceMemory(
        paths, device="cpu", **kw), TM.DEVICE_MEMORY_HEADROOM_GIB) == "card"
    assert len(calls) == 2
    monkeypatch.setattr(TM.mesh, "ranks_on_device", lambda: 2)
    # 2 x (8.06 + 16) GiB do not fit 43 or 42 GiB.
    with pytest.raises(RuntimeError, match="each of the 2 ranks on the card"):
        TM.check_device_memory_fits(dm, 16.0)
    free[0] = 2 * free_gib + 1
    assert TM.check_device_memory_fits(dm, 2.0) == want
    assert len(calls) == 4


def test_run_training_checks_fit(root, tmp_path, monkeypatch):
    """run_training plans the device memory's placement, with the default
    headroom, before it runs a trajectory; a run where even one slot a
    scene does not fit stops there."""
    seen = []

    class DoesNotFit(Exception):
        pass

    def check(memory, *args, **kw):
        seen.append((type(memory).__name__, memory.n_trajectories,
                     memory.max_frames, args, kw))
        raise DoesNotFit

    def never(*a, **kw):
        raise AssertionError("a trajectory ran")

    monkeypatch.setattr(TM, "check_device_memory_fits", check)
    monkeypatch.setattr(TM, "run_trajectory", never)
    cfg = dict(DEVICE_TRAIN, data_path=root)
    with pytest.raises(DoesNotFit):
        TM.run_training(Params(cfg), weights_dir=str(tmp_path / "w"),
                        memory_root=str(tmp_path / "mem"), device="cpu",
                        verbose=False)
    assert seen == [("DeviceMemory", DEVICE_TRAIN["n_memory_trajectories"],
                     N_FRAMES, (), {})]


# ---------------------------------------------------------------------------
# Episode functions
# ---------------------------------------------------------------------------


DIMS = (4, 4, 4, 3, 8)


def lattice():
    ps = C.PoseSpace(np.array([-4.0, -4, -4]), np.array([4.0, 4, 4]), *DIMS)
    jps = JC.PoseSpace(np.array([-4.0, -4, -4]), np.array([4.0, 4, 4]), *DIMS)
    occupied = np.zeros(DIMS[:3], bool)
    occupied[1, 3, 2] = True
    return (ps, C.pose_space_tables(ps, occupied),
            JC.pose_space_tables(jps, occupied), occupied)


def same_episode(ep, jep):
    for name in JC.DeviceEpisode._fields:
        a, b = getattr(ep, name), getattr(jep, name)
        if name in ("n_moves", "n_frames"):
            assert a == int(b)
        elif name in ("X", "V", "R", "T", "X_history", "V_history"):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)


def test_episode_functions():
    """A start on the lattice's edge (x 0 and y 3 clamp, elev 2 of 3
    duplicates its unturned move), an occupied neighbour, a move across the
    azimuth's wrap (7 -> 0), then a move back: neighbours and masks, the
    interpolated poses, the commit, against JAX and the host Camera."""
    ps, tables, jtables, occupied = lattice()
    cam = C.Camera(ps, zfar=20.0, image_height=32, image_width=48,
                   device=torch.device("cpu"), n_interpolation_steps=3,
                   occupied_poses=occupied)
    start = np.array([0, 3, 2, 2, 7])
    cam.initialize(start)
    ep = C.init_device_episode(torch.tensor(start), tables, DIMS, 3, 8,
                               max_moves=6, max_frames=12)
    jep = JC.init_device_episode(start, jtables, DIMS, 3, 8, max_moves=6,
                                 max_frames=12)
    same_episode(ep, jep)
    np.testing.assert_allclose(
        C.episode_pose_from_idx(torch.tensor(start), tables, 3, 8).numpy(),
        ps.pose_from_idx(start), rtol=1e-6, atol=1e-6)
    targets = ([1, 3, 2, 2, 0], [0, 3, 2, 2, 7])
    for step, target in enumerate(targets):
        cand, new_ok, vis_ok = C.episode_neighbors(ep, tables, DIMS)
        jcand, jnew, jvis = JC.episode_neighbors(jep, jtables, DIMS)
        for a, b in ((cand, jcand), (new_ok, jnew), (vis_ok, jvis)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        nbrs = ps.neighbors(cam.cam_idx)
        visited = cam.pose_history[ps.flat_index(nbrs)]
        occ = occupied[nbrs[:, 0], nbrs[:, 1], nbrs[:, 2]]
        assert ({tuple(c) for c, ok in zip(cand.tolist(), new_ok) if ok}
                == {tuple(n) for n in nbrs[~visited & ~occ].tolist()})
        assert ({tuple(c) for c, ok in zip(cand.tolist(), vis_ok) if ok}
                == {tuple(n) for n in nbrs[visited].tolist()})
        if step == 0:
            assert int(new_ok.sum()) < 30  # clamps, duplicates, the occupied
            assert not vis_ok.any()
        else:
            assert vis_ok.any()
        nxt = torch.tensor(target)
        X, V = C.episode_interpolations(ep, nxt, tables, 3, 8, 3)
        jX, jV = JC.episode_interpolations(jep, jnp.asarray(target), jtables,
                                           3, 8, 3)
        np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(V.numpy(), np.asarray(jV), rtol=1e-6,
                                   atol=1e-6)
        for i in range(1, 4):
            cam.update_camera(np.asarray(target), interpolation_step=i)
            np.testing.assert_allclose(X[i - 1].numpy(), cam.X_cam[0],
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(V[i - 1].numpy(), cam.V_cam[0],
                                       rtol=1e-6, atol=1e-6)
        R, T = C.get_camera_RT(X, V)
        jR, jT = JC.get_camera_RT(jX, jV)
        ep = C.episode_commit(ep, nxt, X, V, R, T, DIMS)
        jep = JC.episode_commit(jep, jnp.asarray(target), jX, jV, jR, jT,
                                DIMS)
        same_episode(ep, jep)
        assert bool(ep.visited[ps.flat_index(target)])
    for _ in range(4):  # past the histories' capacity: the last rows
        ep = C.episode_commit(ep, nxt, X, V, R, T, DIMS)
        jep = JC.episode_commit(jep, jnp.asarray(targets[-1]), jX, jV, jR,
                                jT, DIMS)
        same_episode(ep, jep)


def test_select_move():
    """torch.where/argmax against JAX's where/argmax: the largest gain of
    the new valid moves, the visited ones when no new one is valid, slot 0
    when nothing is selectable (an argmax over -inf)."""
    rs = np.random.default_rng(3)
    cand = rs.integers(0, 8, size=(30, 5))
    for case in range(6):
        gains = rs.uniform(size=30).astype(np.float32)
        gains[rs.integers(0, 30, 3)] = gains.max()  # ties
        new_ok = rs.uniform(size=30) < (0.3, 0.0, 0.0, 0.05, 0.5, 0.0)[case]
        vis_ok = rs.uniform(size=30) < (0.3, 0.4, 0.0, 0.2, 0.0, 1.0)[case]
        sel = jnp.where(jnp.any(new_ok), new_ok, vis_ok)
        ref = cand[int(jnp.argmax(jnp.where(sel, gains, -jnp.inf)))]
        got = TM.select_move(torch.tensor(cand), torch.tensor(gains),
                             torch.tensor(new_ok), torch.tensor(vis_ok))
        np.testing.assert_array_equal(got.numpy(), ref)
        if case == 2:
            np.testing.assert_array_equal(ref, cand[0])


def cube_points():
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], np.float32)
    rs = np.random.default_rng(4)
    return corners, rs.uniform(-1.2, 1.2, size=(50, 3)).astype(np.float32)


@pytest.mark.parametrize("case", ["first", "later", "unoccupied", "none"])
def test_random_start(case, monkeypatch):
    """Index batches injected into both: a valid pose in batch 0; valid
    ones only in batch 2; none valid (the first unoccupied pose of the
    first batch holding one); none unoccupied (the first index drawn)."""
    ps, tables, jtables, _ = lattice()
    verts, proxies = cube_points()
    all_idx = np.stack(np.meshgrid(*[np.arange(d) for d in DIMS],
                                   indexing="ij"), -1).reshape(-1, 5)
    poses = C.episode_pose_from_idx(torch.tensor(all_idx), tables, 3, 8)
    fov = (C.fov_holds_points(poses, torch.tensor(verts), 32, 48, 20.0)
           & C.fov_holds_points(poses, torch.tensor(proxies), 32, 48,
                                20.0)).numpy()
    occ = tables.occupied.numpy()[(all_idx[:, 0] * 4 + all_idx[:, 1]) * 4
                                  + all_idx[:, 2]]
    rs = np.random.default_rng(5)
    valid = all_idx[fov & ~occ]
    invalid_free = all_idx[~fov & ~occ]
    occupied = all_idx[occ]
    assert len(valid) and len(invalid_free) and len(occupied)

    def pick(pool, n):
        return pool[rs.integers(0, len(pool), n)]

    B = 6
    if case == "first":
        batches = [np.concatenate([pick(invalid_free, 2), pick(valid, 4)])]
    elif case == "later":
        batches = [pick(invalid_free, B), pick(occupied, B),
                   np.concatenate([pick(occupied, 3), pick(valid, 3)])]
    elif case == "unoccupied":
        batches = [pick(occupied, B), np.concatenate(
            [pick(occupied, 2), pick(invalid_free, 4)]), pick(occupied, B),
            pick(invalid_free, B)]
    else:
        batches = [pick(occupied, B) for _ in range(4)]
    queue = [b[:, i] for b in batches for i in range(5)]

    def randint(key, shape, lo, hi):
        v = queue.pop(0)
        assert v.shape == shape and v.min() >= lo and v.max() < hi
        return jnp.asarray(v, jnp.int32)

    monkeypatch.setattr(jax.random, "randint", randint)
    with jax.disable_jit():
        jidx, jfound = JC.episode_random_start(
            jax.random.PRNGKey(0), jtables, DIMS, 3, 8, jnp.asarray(verts),
            jnp.asarray(proxies), 32, 48, 20.0, batch=B,
            max_attempts=len(batches))
    idx, found = C.episode_random_start(
        None, tables, DIMS, 3, 8, torch.tensor(verts), torch.tensor(proxies),
        32, 48, 20.0, batch=B, max_attempts=len(batches),
        index_batches=batches)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert found == bool(jfound) == (case in ("first", "later"))
    b, row = {"first": (0, 2), "later": (2, 3), "unoccupied": (1, 2),
              "none": (0, 0)}[case]
    want = batches[b][row]
    np.testing.assert_array_equal(idx.numpy(), want)


# ---------------------------------------------------------------------------
# Trajectories and the epoch loop
# ---------------------------------------------------------------------------


DEVICE_TRAIN = {k: v for k, v in TRAIN.items() if k != "device_memory"}
N_POSES = DEVICE_TRAIN["n_poses_in_trajectory"]
N_FRAMES = (1 + DEVICE_TRAIN["n_alpha"]
            + N_POSES * DEVICE_TRAIN["n_interpolation_steps"])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_scene_root(tmp_path_factory)


def test_two_trajectories(root, tmp_path):
    """Slot 0, then slot 1 replaying slot 0 (depth replay reading its
    frames, SCONE replay its depths and snapshots): the frame counts, the
    remap's depths, finite losses and coverages on the card's side, and
    the flush in JAX Memory's layout."""
    dev = torch.device("cpu")
    params = Params(dict(DEVICE_TRAIN, data_path=root))
    model = create_macarons_model(params, dev)
    init_macarons_weights(model, TM.seeded_generator(dev, 5))
    opts = create_optimizers(params, model)
    rt = TM.MacaronsRuntime(params, model, device=dev)
    item = SceneDataset(root)[0]
    mp = str(tmp_path / "synth_00" / "macarons_memory")
    dmem = mem.DeviceMemory([mp], n_trajectories=2, max_frames=N_FRAMES,
                            max_depths=N_FRAMES, height=rt.H, width=rt.W,
                            zfar=params.zfar, device=dev)
    reads = []
    for name in ("load_frame_sequence", "depth_stack",
                 "get_random_scene_for_scone"):
        fn = getattr(dmem, name)

        def logged(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            reads.append((_name, dmem.current_epoch, a, out))
            return out
        setattr(dmem, name, logged)
    gen = TM.seeded_generator(dev, 5, 0)
    rs = np.random.default_rng(0)
    common = dict(n_memory_loops=1, remap_at=2, verbose=True,
                  episodes=TM.DEVICE_EPISODES)
    for epoch in (0, 1):
        dmem.current_epoch = epoch
        scene = TM.setup_scene(params, item, TM.seeded_generator(dev, 5, 9),
                               dev)
        losses = TM.run_trajectory(rt, scene, dmem, mp, opts, gen, rs,
                                   N_POSES, **common)
        assert dmem.n_frames(mp, epoch) == N_FRAMES
        assert dmem.n_depths(mp, epoch) == N_FRAMES - params.n_alpha
        assert all(isinstance(v, torch.Tensor) for vs in losses.values()
                   for v in vs)
        assert all(isinstance(c, torch.Tensor) for c in scene.coverages)
        assert all(np.isfinite(float(v)) for vs in losses.values()
                   for v in vs)
        assert 0.0 <= float(scene.coverages[-1]) <= 1.0
        ep = scene.episode
        assert (ep.n_moves, ep.n_frames) == (N_POSES + 1, N_FRAMES - 2)
        # The episode's frames are the store's: its last pose is the last
        # frame's camera.
        same(ep.R[0], dmem.store(mp, epoch).R[N_FRAMES - 1])
    replayed = [(name, a) for name, e, a, out in reads if e == 1
                and out is not None]
    assert any(n == "load_frame_sequence" and len(a) == 4 and a[3] == 0
               for n, a in replayed)
    assert any(n == "depth_stack" and a[1] == 0 for n, a in replayed)
    assert any(n == "get_random_scene_for_scone" for n, a in replayed)
    assert not any(n == "depth_stack" and a[1] == 1 for n, a in replayed)

    dmem.flush_to_disk()
    disk = jmem.Memory([mp], n_trajectories=2)
    for slot in (0, 1):
        assert disk.n_frames(mp, slot) == N_FRAMES
        assert disk.n_depths(mp, slot) == N_FRAMES - params.n_alpha
        fr = disk.load_frame_sequence(mp, N_FRAMES - 1, N_FRAMES, slot)
        ours = dmem.load_frame_sequence(mp, N_FRAMES - 1, N_FRAMES, slot)
        for k in ("images", "zbuf", "mask", "R", "T"):
            same(ours[k], fr[k])
        with np.load(os.path.join(mp, "training", str(slot), "poses",
                                  f"epoch_{slot}.npz")) as f:
            assert f["X_cam"].shape == (N_FRAMES - 2, 3)
            assert f["cam_idx"].shape == (N_POSES + 1, 5)


def scripted(log, jax_side):
    """run_trajectory, scripted on either side: records the memory it is
    handed and the random state, draws from rs, returns losses."""
    def record(scene, memory, rs, n_poses):
        log.append(("trajectory", type(memory).__name__,
                    memory.current_epoch, memory.current_trajectory(),
                    rs.bit_generator.state["state"]["state"], n_poses))
        rs.integers(0, 100)
        scene.coverages = [0.3]
        e = memory.current_epoch
        return {"depth": [0.5 - 0.1 * e] * n_poses, "occ": [0.1] * n_poses,
                "cov": [0.2] * n_poses}

    if jax_side:
        def run(rt, scene, memory, memory_path, variables, opt_states, key,
                rs, n_poses, **kw):
            return variables, opt_states, record(scene, memory, rs,
                                                 n_poses), key
    else:
        def run(rt, scene, memory, memory_path, opts, gen, rs, n_poses,
                **kw):
            # The episodes run_training picked go with the memory.
            assert kw["episodes"] is (
                TM.DEVICE_EPISODES if isinstance(memory, mem.DeviceMemory)
                else TM.HOST_EPISODES)
            return record(scene, memory, rs, n_poses)
    return run


def stub_scene(params, item, *args, mirrored_axes=None):
    return types.SimpleNamespace(name=item["scene_name"], cfg=None,
                                 cell_table=None, coverages=[])


def logged_method(log, cls, name, mp):
    orig = getattr(cls, name)

    def fn(self, *a, **kw):
        log.append((name, self.current_epoch, self.n_trajectories,
                    self.max_frames, self.max_depths, self.height,
                    self.width))
        return orig(self, *a, **kw)
    mp.setattr(cls, name, fn)


@pytest.fixture(scope="module")
def jax_weights():
    """The JAX trainer's weights (seeded, from eval_shape: no Flax init)."""
    return random_variables(JParams(DEVICE_TRAIN), 2)


@pytest.mark.parametrize("device_memory", [None, False])
def test_run_training_memory(root, tmp_path, device_memory, jax_weights):
    """Two epochs, the second resumed in a new run: with device_memory
    absent, every trajectory gets the one DeviceMemory (hydrated once on
    resume, flushed once per epoch); with false, a disk Memory. The same
    calls, in the same order, with the same random state, as JAX's."""
    cfg = dict(DEVICE_TRAIN, data_path=root, n_poses_in_trajectory=2,
               random_mirror_scenes=False)
    if device_memory is not None:
        cfg["device_memory"] = device_memory
    logs = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(JTM, "init_macarons_variables",
                   lambda params, model, key: jax_weights)
        for module in (JTM, TM):
            mp.setattr(module, "setup_scene", stub_scene)
            mp.setattr(module.MacaronsRuntime, "bind_scene", lambda *a: None)
        for name, module, memory_mod, jax_side in (
                ("jax", JTM, jmem, True), ("port", TM, mem, False)):
            log = logs[name] = []
            mp.setattr(module, "run_trajectory", scripted(log, jax_side))
            for meth in ("hydrate_from_disk", "flush_to_disk"):
                logged_method(log, memory_mod.DeviceMemory, meth, mp)
            for epochs in (1, 2):
                kw = dict(weights_dir=str(tmp_path / name / "w"),
                          memory_root=str(tmp_path / name / "mem"),
                          verbose=False)
                p = dict(cfg, epochs=epochs, start_from_scratch=epochs == 1)
                if jax_side:
                    module.run_training(JParams(p), **kw)
                else:
                    module.run_training(Params(p), device="cpu", **kw)
    finally:
        mp.undo()
    assert logs["port"] == logs["jax"]
    kinds = [r[0] for r in logs["port"]]
    if device_memory is None:
        assert kinds == ["trajectory", "flush_to_disk", "hydrate_from_disk",
                         "trajectory", "flush_to_disk"]
        assert logs["port"][0][1] == "DeviceMemory"
        assert logs["port"][2][3:] == (N_FRAMES - 2, N_FRAMES - 2, 32, 48)
    else:
        assert kinds == ["trajectory", "trajectory"]
        assert logs["port"][0][1] == "Memory"


def test_tester_export_results_raises(root, tmp_path):
    """run_test with export_results raises no NotImplementedError: after
    the trajectory it writes the Blender camera curves (every frame's pose
    from the n_interpolation_steps-th on, as the JAX tester) and the
    surface PLY under results_dir/exports/<scene>/. (The name dates from
    when the branch raised; it is kept so that the test's record follows
    it.)"""
    from macarons_tpu_torch.testers import scene as tester

    params = Params(dict(DEVICE_TRAIN, data_path=root, export_results=True))
    results = tester.run_test(params, results_dir=str(tmp_path / "results"),
                              n_start_poses=1, n_poses=1, device="cpu",
                              verbose=False)
    name = next(iter(results))
    edir = tmp_path / "results" / "exports" / name
    with open(edir / "start_0_cameras.json") as f:
        curves = json.load(f)
    assert len(curves["camera_X"]) == len(curves["camera_look"]) == 1
    lines = (edir / "start_0_surface.ply").read_text().splitlines()
    n = int(lines[2].split()[-1])
    assert n > 0 and len(lines) == lines.index("end_header") + 1 + n
