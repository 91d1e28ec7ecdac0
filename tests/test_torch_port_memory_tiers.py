"""The device memory's host tier on the CPU, held to the memory without it
and to the JAX package's ``DeviceMemory``.

- The placement plan (``device_memory_plan``, ``check_device_memory_fits``)
  at the default training config's memory (8 scenes x 5 slots of 403
  frames of 256x456) on a scripted card and host: every slot on the card,
  one slot a scene on the card and the rest in host memory, or a raise
  naming ``"device_memory": false`` and both figures; ranks sharing the
  card or the host, the CPU, one slot.
- Memories with a host tier across five epochs while keys move (at an
  epoch's end while the scene has a free host slot, else when it begins
  its next trajectory): the three samplers from one ``default_rng`` seed,
  windows at frame 0 and at the end, depth stacks, against the memory
  without a tier key for key and against JAX ``DeviceMemory``; its
  ``flush_to_disk`` read by JAX ``Memory``; ``hydrate_from_disk``; two
  ranks exchanging every epoch's keys as ``exchange_device_memory`` does.
- The host tier's reads: runs of rows copied to a device, windows.
- Two device-memory trajectories, the second replaying the first from the
  host tier, and a three-epoch ``run_training`` whose plan is the host
  tier: equal bit for bit to the same runs with every slot on the card.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from macarons_tpu.scene import depth_runtime as jdr
from macarons_tpu.scene import memory as jmem
from macarons_tpu.scene.grid import GridState as JGridState
from macarons_tpu.scene.proxy import ProxyState as JProxyState
from macarons_tpu_torch.config import Params
from macarons_tpu_torch.data.scenes import SceneDataset
from macarons_tpu_torch.models.macarons import create_macarons_model, \
    create_optimizers, init_macarons_weights
from macarons_tpu_torch.scene import depth_runtime as dr
from macarons_tpu_torch.scene import memory as mem
from macarons_tpu_torch.scene.grid import GridState
from macarons_tpu_torch.scene.proxy import ProxyState
from macarons_tpu_torch.trainers import train_macarons as TM
from test_torch_port_device_memory import DEVICE_TRAIN, H, N_FRAMES, \
    N_POSES, W, depths, frames, same
from torch_port_helpers import make_scene_root, torch_one_thread  # noqa: F401

GIB = 2 ** 30
SLOT = 1_082_064_672  # one (scene, slot) at the default training config
DEFAULT = dict(n_trajectories=5, max_frames=403, max_depths=403, height=256,
               width=456, zfar=750.0)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


# (case, card GiB free, cached GiB, headroom GiB, ranks on the card, ranks
# on the host, host GiB available, the placement or the words of the
# raise). The stores: 40.31 GiB in all, 8.06 on the card and 32.25 on the
# host with the tier.
PLANS = [
    ("all on the card", 77.0, 2.0, 36.0, 1, 1, 64.0, "card"),
    ("host tier", 70.0, 2.0, 36.0, 1, 1, 64.0, "host tier"),
    ("not even one slot a scene", 40.0, 2.0, 36.0, 1, 1, 64.0,
     "the card has 42.00 GiB free; with one slot a scene on the card it "
     "needs 8.06 GiB there and 32.25 GiB of host memory"),
    ("too little host memory", 70.0, 2.0, 36.0, 1, 1, 30.0,
     "the host has 30.00 GiB available"),
    ("two ranks on the card", 70.0, 2.0, 30.0, 2, 1, 64.0,
     "each of the 2 ranks on the card"),
    ("two ranks on the card, host tier", 77.0, 2.0, 20.0, 2, 1, 80.0,
     "host tier"),
    ("two ranks on the host", 70.0, 2.0, 20.0, 2, 2, 60.0,
     "32.25 GiB of host memory for each of the 2 ranks on this host"),
    ("headroom past the card", 77.0, 2.0, 72.0, 1, 1, 64.0,
     "training about 72.0 GiB more"),
]


@pytest.mark.parametrize("case", PLANS, ids=[c[0] for c in PLANS])
def test_plan(monkeypatch, case):
    """The placement on a scripted card and host at the default config's
    memory: its figures, and a raise that names device_memory false and
    the card's and the host's figures."""
    _, free, cached, headroom, on_card, on_host, host, want = case
    asked = []

    def mem_get_info(device=None):
        asked.append(device)
        return int(free * GIB), 80 * GIB

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: int((cached + 1) * GIB))
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: 1 * GIB)
    monkeypatch.setattr(TM.mesh, "ranks_on_device", lambda: on_card)
    monkeypatch.setattr(TM.mesh, "ranks_on_host", lambda: on_host)
    monkeypatch.setattr(TM, "host_memory_available", lambda: int(host * GIB))
    paths = [f"s{i}" for i in range(8)]
    dm = mem.DeviceMemory(paths, device="cuda", **DEFAULT)
    assert dm.slot_nbytes() == SLOT and dm.full_nbytes() == 40 * SLOT
    assert dm.nbytes() == 0
    plan = TM.device_memory_plan(dm, headroom)
    assert plan["stores"] == 40 * SLOT
    assert plan["card_stores"] == 8 * SLOT
    assert plan["host_stores"] == 32 * SLOT
    assert plan["all_card"] == on_card * (40 * SLOT + int(headroom * GIB))
    assert plan["tiered_card"] == on_card * (8 * SLOT + int(headroom * GIB))
    assert plan["tiered_host"] == on_host * 32 * SLOT
    assert plan["card_free"] == int((free + cached) * GIB)
    if want in ("card", "host tier"):
        assert plan["placement"] == want
        assert TM.check_device_memory_fits(dm, headroom) == want
    else:
        assert plan["placement"] is None
        with pytest.raises(RuntimeError) as err:
            TM.check_device_memory_fits(dm, headroom)
        msg = str(err.value)
        assert '"device_memory": false' in msg and want in msg
        assert "GiB of host memory" in msg and "GiB available" in msg
    assert len(asked) == 2
    # Off the card nothing is asked; one slot has no tier to move to.
    cpu = mem.DeviceMemory(paths, device="cpu", **DEFAULT)
    assert TM.device_memory_plan(cpu, headroom) == {
        "placement": "card"}
    assert len(asked) == 2
    # One slot a scene is every slot of a one-slot memory.
    one = mem.DeviceMemory(paths, device="cuda",
                           **dict(DEFAULT, n_trajectories=1))
    if want == "host tier":
        assert TM.check_device_memory_fits(one, headroom) == "card"


def test_host_memory_available():
    """MemAvailable of /proc/meminfo, in bytes."""
    with open("/proc/meminfo") as f:
        kib = next(int(line.split()[1]) for line in f
                   if line.startswith("MemAvailable:"))
    got = TM.host_memory_available()
    assert 0 < got and abs(got - kib * 1024) < 2 * GIB


# ---------------------------------------------------------------------------
# Memories across epochs
# ---------------------------------------------------------------------------


KW = dict(n_trajectories=3, max_frames=12, max_depths=6, height=H, width=W,
          zfar=40.0)
# Each epoch's trajectories: (scene, frames, depths). Slot e % 3.
SCHEDULE = [
    [(0, 7, 3), (1, 5, 2)],
    [(0, 2, 0)],
    [(0, 11, 5), (1, 3, 1)],
    [(1, 12, 6)],
    [(0, 4, 2), (1, 9, 6)],
]
# Where each key lives after each epoch's end, in the tiered memory: the
# epoch's keys move to the host while their scene has a free host slot
# (two a scene); a scene's key left on the card moves when the scene
# begins its next trajectory.
ON_CARD = [set(), set(), {(0, 2)}, {(0, 2)}, {(0, 1), (1, 1)}]


def trajectory(dm, lib, path, n, n_d, rs):
    """One trajectory in the current slot of either package's memory:
    frames in two batches, depths, snapshots and poses."""
    arr = jnp.asarray if lib == "jax" else \
        (lambda a: torch.tensor(np.asarray(a)))
    store = dm.begin_trajectory(path)
    mod = jdr if lib == "jax" else dr
    for K in (1, n - 1) if n > 1 else (1,):
        store = mod.store_append(store, *(arr(a) for a in frames(rs, K)))
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
    dm.save_poses(path, dm.current_epoch,
                  arr(rs.normal(size=(12, 3)).astype(np.float32)),
                  arr(rs.normal(size=(12, 2)).astype(np.float32)),
                  arr(rs.integers(0, 5, size=(6, 5))), n_moves=4, n_frames=9)


def run_epoch(e, memories, paths, scenes_of=None):
    """Epoch ``e``'s trajectories in each (memory, lib); ``scenes_of[i]``
    keeps memory i to those scenes (the others go to a memory that is
    dropped, so that every memory draws the same)."""
    rs = np.random.default_rng([2, e])
    draws = [np.random.default_rng([2, e]) for _ in memories]
    for scene, n, n_d in SCHEDULE[e]:
        state = rs.bit_generator.state
        for i, (dm, lib) in enumerate(memories):
            mine = scenes_of is None or scene in scenes_of[i]
            target = dm if mine else type(dm)(paths, **KW)
            target.current_epoch = e
            draws[i].bit_generator.state = state
            trajectory(target, lib, paths[scene], n, n_d, draws[i])
        rs.bit_generator.state = draws[0].bit_generator.state
    for dm, _ in memories:
        dm.current_epoch = e


def check_reads(paths, ours, ref):
    """A memory against another over the same trajectories (the port's
    without a tier, or JAX's): the counts, the three samplers from one
    default_rng seed (each exclusion), windows at frame 0, inside and at
    the end, and depth stacks."""
    keys = [(p, t) for p in paths for t in range(3)]
    for key in keys:
        assert ours.n_frames(*key) == ref.n_frames(*key)
        assert ours.n_depths(*key) == ref.n_depths(*key)
    for seed in range(8):
        for exclude in (None, 0, 1, 2):
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
                assert a[:2] == b[:2]
                same(a[2], b[2])
    for p, t in keys:
        n = ours.n_frames(p, t)
        if n:
            for last, k in ((0, 3), (n - 1, 3), (KW["max_frames"] - 1, 3),
                            (min(n, 6) - 1, min(n, 6)), (1, 1)):
                same(ours.load_frame_sequence(p, last, k, t),
                     ref.load_frame_sequence(p, last, k, t))
        if ours.n_depths(p, t):
            for idx in ([0], [0, 1, 2], [3, 1], [2, 2, 0], [5, 4, 1, 2]):
                same(ours.depth_stack(p, t, idx), ref.depth_stack(p, t, idx))
            same(ours.load_depth(p, 0, traj=t), ref.load_depth(p, 0, traj=t))


def same_memory(ours, flat):
    """Key for key what replay can read, and the snapshots' parameters."""
    assert ours.keys() == flat.keys()
    for key in flat.keys():
        same(ours.key_state(key), flat.key_state(key))
        assert ours.n_frames(*key) == flat.n_frames(*key)
        assert ours.n_depths(*key) == flat.n_depths(*key)


def placement(dm):
    """The keys on the card; every scene at most one there, at most slots
    - 1 in host slots, the pool never exceeded."""
    card = {k for k in dm.keys() if not dm.on_host(k)}
    for p in dm.scene_memory_paths:
        assert sum(k[0] == p for k in card) <= 1
        assert sum(k[0] == p and dm.on_host(k) for k in dm.keys()) \
            <= dm.n_trajectories - 1
    assert len(dm._host) + len(dm._host_free) == dm._host_slots
    return card


def scene_keys(paths, keys):
    return {(paths.index(p), t) for p, t in keys}


@pytest.fixture(scope="module")
def epochs(tmp_path_factory):
    """The schedule in a tiered memory, one without a tier and JAX's, each
    epoch's keys moved to the host at its end as the trainer does; after
    every epoch the tiered memory is held to the one without a tier, and
    after the last (and the first that leaves a key on the card) to JAX's
    too. Returns the paths and the memories."""
    tmp = tmp_path_factory.mktemp("tiers")
    paths = [str(tmp / f"s{i}" / "macarons_memory") for i in (0, 1)]
    tiered, flat = mem.DeviceMemory(paths, **KW), mem.DeviceMemory(paths, **KW)
    tiered.enable_host_tier()
    assert tiered.nbytes("host") == 4 * tiered.slot_nbytes()
    assert tiered.nbytes("card") == 0
    ref = jmem.DeviceMemory(paths, **KW)
    for e in range(len(SCHEDULE)):
        run_epoch(e, [(tiered, "torch"), (flat, "torch"), (ref, "jax")],
                  paths)
        slot = e % 3
        moved = tiered.move_to_host([(paths[s], slot) for s, _, _
                                     in SCHEDULE[e]])
        assert flat.move_to_host([(paths[s], slot) for s, _, _
                                  in SCHEDULE[e]]) == 0
        assert (moved > 0) == (e < 4)
        assert scene_keys(paths, placement(tiered)) == ON_CARD[e]
        assert tiered.nbytes("card") == len(ON_CARD[e]) * \
            tiered.slot_nbytes()
        same_memory(tiered, flat)
        check_reads(paths, tiered, flat)
        if e in (2, len(SCHEDULE) - 1):
            check_reads(paths, tiered, ref)
    # Replay read the host tier's rows.
    assert tiered.host_read_bytes > 0 and flat.host_read_bytes == 0
    return paths, tiered, flat, ref


def test_samplers_across_epochs(epochs):
    """Five epochs of the schedule: after each, the tiered memory holds
    what the untiered one holds, draws and reads what JAX DeviceMemory
    does, and keeps each scene's slots but one in the host tier."""
    paths, tiered, flat, ref = epochs
    assert len(tiered._host) == 4 and not tiered._host_free


def test_flush_and_hydrate(epochs):
    """The tiered memory's flush read by JAX Memory, slot for slot, and a
    tiered memory hydrated from those files: what the memory without a
    tier holds, its current slot on the card."""
    paths, tiered, flat, ref = epochs
    tiered.flush_to_disk()
    disk = jmem.Memory(paths, n_trajectories=3)
    for p in paths:
        for slot in range(3):
            n, n_d = tiered.n_frames(p, slot), tiered.n_depths(p, slot)
            assert disk.n_frames(p, slot) == n
            assert disk.n_depths(p, slot) == n_d
            fr = disk.load_frame_sequence(p, n - 1, n, slot)
            same(ref.load_frame_sequence(p, n - 1, n, slot),
                 {k: fr[k] for k in ("images", "zbuf", "mask", "R", "T",
                                     "zfar")})
            for i in range(disk.n_depths(p, slot)):
                same(ref.load_depth(p, i, slot), disk.load_depth(p, i, slot))
            same(tuple(ref.load_surface_scene(p, slot)[0]),
                 tuple(disk.load_surface_scene(p, slot)[0]))
            same(tuple(ref.load_occupancy_field(p, slot)[0]),
                 tuple(disk.load_occupancy_field(p, slot)[0]))
    back = mem.DeviceMemory(paths, current_epoch=4, **KW)
    back.enable_host_tier()
    back.hydrate_from_disk()
    assert scene_keys(paths, placement(back)) == {(0, 1), (1, 1)}
    same_memory(back, flat)


def test_exchange_two_ranks(tmp_path):
    """Two ranks, each a tiered memory training scene r: at each epoch's
    end each moves and writes the keys it captured, and after both have
    written, loads the other's (exchange_device_memory's steps). After
    every epoch both hold what one memory without a tier holds, key for
    key, and draw and read what JAX DeviceMemory does."""
    paths = [str(tmp_path / f"s{i}" / "macarons_memory") for i in (0, 1)]
    ranks = [mem.DeviceMemory(paths, **KW) for _ in (0, 1)]
    for dm in ranks:
        dm.enable_host_tier()
    flat, ref = mem.DeviceMemory(paths, **KW), jmem.DeviceMemory(paths, **KW)
    for e in range(len(SCHEDULE)):
        run_epoch(e, [(ranks[0], "torch"), (ranks[1], "torch"),
                      (flat, "torch"), (ref, "jax")], paths,
                  scenes_of=[(0,), (1,), (0, 1), (0, 1)])
        slot = e % 3
        owners = {paths[s]: s for s, _, _ in SCHEDULE[e]}
        for r, dm in enumerate(ranks):
            mine = [(p, slot) for p, o in owners.items() if o == r]
            dm.move_to_host(mine)
            dm.flush_to_disk(mine)
        for r, dm in enumerate(ranks):
            dm.load_from_disk([(p, slot) for p, o in owners.items()
                               if o != r])
        for dm in ranks:
            placement(dm)
            assert dm.keys() == flat.keys()
            same_memory(dm, flat)
            check_reads(paths, dm, flat)
    for dm in ranks:
        check_reads(paths, dm, ref)


def test_host_reads():
    """Rows of a host tensor copied to a device: one copy a run of
    consecutive rows, the same rows as a gather; a window of a host store
    with its zfar on the device."""
    x = torch.arange(7 * 2 * 3, dtype=torch.float32).reshape(7, 2, 3)
    cpu = torch.device("cpu")
    for idx in ([0], [2, 3, 4], [3, 1], [6, 6, 0, 1, 2], [5, 4, 3]):
        got = mem._rows_to(x, idx, cpu)
        same(got, x.index_select(0, torch.tensor(idx)))
    assert mem._runs([6, 6, 0, 1, 2, 4]) == [[6, 1], [6, 1], [0, 3], [4, 1]]
    # A host slot written as the memory writes one (reset to the rows it
    # will write, then written) and reused: beyond the rows kept it holds
    # a fresh store's values again.
    slot = mem.HostSlot(6, 4, H, W).reset(4, 3)
    store = dr.store_append(slot.frames, *(torch.tensor(a) for a in frames(
        np.random.default_rng(0), 4)))
    slot.depths.append(*(torch.tensor(a) for a in depths(
        np.random.default_rng(1), 3)))
    same(dr.store_window(store, 3, 3, 40.0, cpu),
         dr.store_window(store, 3, 3, 40.0))
    slot.reset(2, 1)
    fresh = dr.init_frame_store(6, H, W)
    for a, b in zip(slot.frames[:5], fresh[:5]):
        same(a[2:], b[2:])
    assert not torch.equal(slot.frames.images[:2], fresh.images[:2])
    fresh_d = mem.DepthStore(4, H, W)
    for k in mem.DepthStore.FIELDS:
        same(getattr(slot.depths, k)[1:], getattr(fresh_d, k)[1:])
    assert slot.depths.n == 0


# ---------------------------------------------------------------------------
# Trajectories
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_scene_root(tmp_path_factory)


def weights(model):
    return {f"{name}.{k}": v.clone() for name in ("depth", "occ", "vis")
            if getattr(model, name) is not None
            for k, v in getattr(model, name).state_dict().items()}


def two_trajectories(root, tmp_path, tiered):
    """Slot 0, the epoch's end (its key to the host with a tier), then
    slot 1 replaying slot 0: the losses, coverages, weights and memory."""
    dev = torch.device("cpu")
    params = Params(dict(DEVICE_TRAIN, data_path=root))
    model = create_macarons_model(params, dev)
    init_macarons_weights(model, TM.seeded_generator(dev, 5))
    opts = create_optimizers(params, model)
    rt = TM.MacaronsRuntime(params, model, device=dev)
    item = SceneDataset(root)[0]
    mp = str(tmp_path / ("tiered" if tiered else "flat") / "synth_00"
             / "macarons_memory")
    dmem = mem.DeviceMemory([mp], n_trajectories=2, max_frames=N_FRAMES,
                            max_depths=N_FRAMES, height=rt.H, width=rt.W,
                            zfar=params.zfar, device=dev)
    if tiered:
        dmem.enable_host_tier()
    gen = TM.seeded_generator(dev, 5, 0)
    rs = np.random.default_rng(0)
    out = {"losses": [], "coverages": []}
    for epoch in (0, 1):
        dmem.current_epoch = epoch
        scene = TM.setup_scene(params, item, TM.seeded_generator(dev, 5, 9),
                               dev)
        out["losses"].append(TM.run_trajectory(
            rt, scene, dmem, mp, opts, gen, rs, N_POSES, n_memory_loops=1,
            remap_at=2, episodes=TM.DEVICE_EPISODES))
        out["coverages"].append(scene.coverages)
        moved = dmem.move_to_host([(mp, epoch)])
        assert (moved > 0) == (tiered and epoch == 0)
        assert dmem.on_host((mp, 0)) == tiered
        assert not dmem.on_host((mp, 1))
    out["model"] = weights(model)
    out["memory"] = {t: dmem.key_state((p, t)) for p, t in dmem.keys()}
    out["host_reads"] = dmem.host_read_bytes
    return out


def test_two_trajectories_from_the_host_tier(root, tmp_path):
    """The second trajectory's depth and SCONE replay read slot 0 from the
    host tier; losses, coverages, weights and memory are those of the run
    with both slots on the card, bit for bit."""
    tiered = two_trajectories(root, tmp_path, True)
    flat = two_trajectories(root, tmp_path, False)
    assert tiered["host_reads"] > 0 and flat["host_reads"] == 0
    for a, b in zip(tiered["losses"], flat["losses"]):
        same({k: [v.detach() for v in vs] for k, vs in a.items()},
             {k: [v.detach() for v in vs] for k, vs in b.items()})
    same([torch.stack(c) for c in tiered["coverages"]],
         [torch.stack(c) for c in flat["coverages"]])
    same(tiered["model"], flat["model"])
    same(tiered["memory"], flat["memory"])


def test_run_training_host_tier(root, tmp_path, monkeypatch):
    """Three epochs of run_training (2 slots: the first epoch's key moves
    to the host at its end, the second's stays on the card, the third's
    begin moves it) with the plan scripted to the host tier and to the
    card: the same losses, weights and memory after every epoch, bit for
    bit, the tier's keys where the plan puts them."""
    cfg = dict(DEVICE_TRAIN, data_path=root, epochs=3,
               random_mirror_scenes=False, n_poses_in_trajectory=2,
               remap_at_pose=1)
    orig = TM.exchange_device_memory
    runs = {}
    for placement_ in ("host tier", "card"):
        seen = runs[placement_] = []

        def exchange(memory, owners, verbose=False):
            out = orig(memory, owners, verbose)
            # Copies: the tier's host slots are written again later.
            seen.append(({t: {k: v.clone() for k, v in
                              memory.key_state((p, t)).items()}
                          for p, t in memory.keys()},
                         sorted(k[1] for k in memory.keys()
                                if memory.on_host(k)), out["moved"] > 0))
            return out

        monkeypatch.setattr(TM, "exchange_device_memory", exchange)
        monkeypatch.setattr(TM, "check_device_memory_fits",
                            lambda memory, *a, p=placement_, **kw: p)
        model, losses = TM.run_training(
            Params(cfg), weights_dir=str(tmp_path / placement_ / "w"),
            memory_root=str(tmp_path / placement_ / "mem"), device="cpu",
            verbose=False)
        seen.append((losses, weights(model)))
    tier, card = runs["host tier"], runs["card"]
    assert [s[1:] for s in tier[:3]] == [([0], True), ([0], False),
                                        ([1], False)]
    assert [s[1:] for s in card[:3]] == [([], False)] * 3
    for a, b in zip(tier[:3], card[:3]):
        same(a[0], b[0])
    assert tier[3][0] == card[3][0]
    same(tier[3][1], card[3][1])
