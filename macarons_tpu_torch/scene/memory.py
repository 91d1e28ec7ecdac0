"""The replay memory (port of macarons_tpu/scene/memory.py): the disk
``Memory`` and the device-resident ``DeviceMemory``.

Per scene directory, ``<scene>/training/<traj>/`` holds the captured frames
(``frames/<n>.npz``: rgb, zbuf, mask, R, T, zfar), the predicted depths of a
remap (``depths/<n>.npz``: depth, mask, error_mask, R, T), the
end-of-trajectory snapshots (``surface/scene.npz``, ``occupancy/field.npz``)
and the poses (``poses/epoch_<e>.npz``), with the JAX package's keys, so
the two packages read each other's memories.

``Memory`` queues its writes: a CUDA tensor is copied into pinned host
memory without blocking, and a writer thread saves the file once the copy's
event has completed; a read or rewrite of a file waits for its queued write,
and a directory listing for all of them. Frame sequences are read through
the native loader (``utils/native_loader.py``), all files at once.

Across the processes of a data-parallel run (``parallel.distributed``)
each rank holds its own ``Memory`` of every scene directory: only a
scene's owner (the rank training it) writes that scene's files, and the
registry of queued writes is each process's own, so a rank drains its
writes (``flush``) and the ranks meet at a barrier before any replay that
can read another rank's scene (``trainers.train_macarons`` does so before
each scene group's trajectories and at every epoch's end).

``DeviceMemory`` keeps a training run's memory on the card: each (scene,
trajectory slot) has a ``FrameStore`` of its frames and a ``DepthStore`` of
its remap's depths, the snapshots and poses are kept as tensors, and the
counts are host integers, so no read or write of it synchronises with the
card. ``flush_to_disk`` writes (scene, slot) keys in the disk layout (the
trainer: at each epoch's end the slots captured in it) and
``hydrate_from_disk`` loads a run's files back (on resume). Over
data-parallel ranks every rank keeps a whole ``DeviceMemory``: at an
epoch's end each writes the keys it captured and, after a barrier, loads
the ones the other ranks captured (``load_from_disk(keys)``;
``trainers.train_macarons.exchange_device_memory``).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from .depth_runtime import (
    FrameStore,
    _clamped_start,
    init_frame_store,
    store_append,
    store_window,
)
from .grid import GridState
from .proxy import ProxyState


def _snapshot(v):
    """A value to save later: a CUDA tensor as a pinned host copy started
    now (its event marks the end of the copy), a CPU tensor cloned, else a
    numpy array. Returns (value, whether it waits on an event, its host
    bytes)."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.is_cuda:
            host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host.copy_(v, non_blocking=True)
            return host, True, host.nbytes
        return v.clone(), False, v.nbytes
    v = np.asarray(v)
    return v, False, v.nbytes


def _numpy(v):
    return v.numpy() if isinstance(v, torch.Tensor) else v


class Memory:
    """Replay store over one or more scene directories; trajectory slots
    rotate with the epoch (``current_epoch % n_trajectories``)."""

    # Queued writes (file path -> Future), shared by every Memory of the
    # process, so that any Memory's read of a file waits for its write.
    _inflight: Dict[str, object] = {}
    _writer_pool: Optional[ThreadPoolExecutor] = None
    _loader = None
    # Host bytes held by queued writes' copies, now and at most since the
    # last reset_queued_peak().
    _held = {"now": 0, "peak": 0}
    _held_lock = threading.Lock()

    def __init__(self, scene_memory_paths: List[str], current_epoch: int = 0,
                 n_trajectories: int = 1):
        self.scene_memory_paths = list(scene_memory_paths)
        self.n_trajectories = n_trajectories
        self.current_epoch = current_epoch
        for path in self.scene_memory_paths:
            for traj in range(n_trajectories):
                for sub in ("frames", "depths", "surface", "occupancy", "poses"):
                    os.makedirs(os.path.join(path, "training", str(traj), sub),
                                exist_ok=True)

    def current_trajectory(self) -> int:
        return self.current_epoch % self.n_trajectories

    def _dir(self, scene_path: str, sub: str, traj: Optional[int]) -> str:
        t = self.current_trajectory() if traj is None else traj
        return os.path.join(scene_path, "training", str(t), sub)

    # -- queued writes --------------------------------------------------------
    @classmethod
    def _writer(cls) -> ThreadPoolExecutor:
        if cls._writer_pool is None:
            cls._writer_pool = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="memory-writer")
        return cls._writer_pool

    def _queue(self, fpaths: List[str], arrays: Dict, write):
        """Start the arrays' copies to the host, then queue ``write(host
        arrays)`` on a writer thread, after any queued write of the same
        files and after the copies' event."""
        host, on_card, held = {}, False, 0
        for k, v in arrays.items():
            host[k], waits, nbytes = _snapshot(v)
            on_card |= waits
            held += nbytes
        self._hold(held)
        event = None
        if on_card:
            event = torch.cuda.Event()
            event.record()
        for f in fpaths:
            self._wait_for(f)

        def run():
            try:
                if event is not None:
                    event.synchronize()
                write({k: _numpy(v) for k, v in host.items()})
            finally:
                host.clear()
                self._hold(-held)

        fut = self._writer().submit(run)
        for f in fpaths:
            self._inflight[f] = fut

    def _save(self, fpath: str, **arrays):
        self._queue([fpath], arrays, lambda host: np.savez(fpath, **host))

    def _wait_for(self, fpath: str):
        fut = self._inflight.pop(fpath, None)
        if fut is not None:
            fut.result()

    def flush(self):
        """Wait for every queued write (before a directory listing)."""
        for fpath in list(self._inflight):
            self._wait_for(fpath)

    @classmethod
    def _hold(cls, nbytes: int):
        with cls._held_lock:
            cls._held["now"] += nbytes
            cls._held["peak"] = max(cls._held["peak"], cls._held["now"])

    @classmethod
    def queued_peak(cls) -> int:
        """The most host bytes that queued writes' copies held at once
        since the last ``reset_queued_peak``."""
        return cls._held["peak"]

    @classmethod
    def reset_queued_peak(cls):
        with cls._held_lock:
            cls._held["peak"] = cls._held["now"]

    def _load(self, fpath: str) -> Dict[str, np.ndarray]:
        self._wait_for(fpath)
        with np.load(fpath) as f:
            return dict(f)

    # -- frames -------------------------------------------------------------
    def frames_dir(self, scene_path: str, traj: Optional[int] = None) -> str:
        return self._dir(scene_path, "frames", traj)

    def save_frame(self, scene_path: str, frame_nb: int, rgb, zbuf, mask, R,
                   T, zfar, traj: Optional[int] = None):
        self._save(os.path.join(self.frames_dir(scene_path, traj),
                                f"{frame_nb}.npz"),
                   rgb=rgb, zbuf=zbuf, mask=mask, R=R, T=T,
                   zfar=np.float32(zfar))

    def save_frame_batch(self, scene_path: str, first_frame_nb: int, rgb,
                         zbuf, mask, R, T, zfar, traj: Optional[int] = None):
        """A capture batch of K frames as K per-frame files: one copy to the
        host per array, the slicing on the writer thread."""
        d = self.frames_dir(scene_path, traj)
        fpaths = [os.path.join(d, f"{first_frame_nb + i}.npz")
                  for i in range(rgb.shape[0])]

        def write(host):
            for i, f in enumerate(fpaths):
                np.savez(f, **{k: v[i:i + 1] for k, v in host.items()},
                         zfar=np.float32(zfar))

        self._queue(fpaths, dict(rgb=rgb, zbuf=zbuf, mask=mask, R=R, T=T),
                    write)

    def load_frame(self, scene_path: str, frame_nb: int,
                   traj: Optional[int] = None) -> Dict[str, np.ndarray]:
        return self._load(os.path.join(self.frames_dir(scene_path, traj),
                                       f"{frame_nb}.npz"))

    def n_frames(self, scene_path: str, traj: Optional[int] = None) -> int:
        self.flush()
        d = self.frames_dir(scene_path, traj)
        return len([f for f in os.listdir(d) if f.endswith(".npz")])

    @classmethod
    def _async_loader(cls):
        if cls._loader is None:
            from ..utils.native_loader import AsyncLoader

            cls._loader = AsyncLoader(n_threads=4)
        return cls._loader

    def load_frame_sequence(self, scene_path: str, last_frame_nb: int, n: int,
                            traj: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Frames [last - n + 1 .. last], stacked; the n files are read at
        once through the native loader."""
        from ..utils.native_loader import prefetch_npz, take_npz

        loader = self._async_loader()
        d = self.frames_dir(scene_path, traj)
        paths = [os.path.join(d, f"{last_frame_nb - n + 1 + i}.npz")
                 for i in range(n)]
        for p in paths:
            self._wait_for(p)
        frames = [take_npz(loader, j) for j in prefetch_npz(loader, paths)]
        out = {k: np.concatenate([f[k] for f in frames], axis=0)
               for k in ("rgb", "zbuf", "mask", "R", "T")}
        out["images"] = out.pop("rgb")
        out["zfar"] = np.full((n,), float(frames[0]["zfar"]), np.float32)
        return out

    # -- depths (predicted, for SCONE replay) --------------------------------
    def save_depth(self, scene_path: str, frame_nb: int, depth, mask,
                   error_mask, R, T, traj: Optional[int] = None):
        self._save(os.path.join(self._dir(scene_path, "depths", traj),
                                f"{frame_nb}.npz"),
                   depth=depth, mask=mask, error_mask=error_mask, R=R, T=T)

    def load_depth(self, scene_path: str, frame_nb: int,
                   traj: Optional[int] = None):
        return self._load(os.path.join(self._dir(scene_path, "depths", traj),
                                       f"{frame_nb}.npz"))

    def depth_stack(self, scene_path: str, traj: Optional[int], indices):
        """Depths ``indices`` stacked, as ``DeviceMemory.depth_stack``
        gives them (numpy arrays here)."""
        got = [self.load_depth(scene_path, int(i), traj) for i in indices]
        return {k: np.concatenate([d[k] for d in got])
                for k in DepthStore.FIELDS}

    def n_depths(self, scene_path: str, traj: Optional[int] = None) -> int:
        self.flush()
        d = self._dir(scene_path, "depths", traj)
        return len([f for f in os.listdir(d) if f.endswith(".npz")])

    # -- scene snapshots ------------------------------------------------------
    def save_surface_scene(self, scene_path: str, state: GridState,
                           traj: Optional[int] = None, **scene_params):
        self._save(os.path.join(self._dir(scene_path, "surface", traj),
                                "scene.npz"),
                   points=state.points, features=state.features,
                   valid=state.valid, **scene_params)

    def load_surface_scene(self, scene_path: str, traj: Optional[int] = None):
        """(GridState of numpy arrays, the other saved arrays)."""
        d = self._load(os.path.join(self._dir(scene_path, "surface", traj),
                                    "scene.npz"))
        return GridState(d.pop("points"), d.pop("features"), d.pop("valid")), d

    def save_occupancy_field(self, scene_path: str, state: ProxyState,
                             traj: Optional[int] = None, **scene_params):
        self._save(os.path.join(self._dir(scene_path, "occupancy", traj),
                                "field.npz"),
                   **state._asdict(), **scene_params)

    def load_occupancy_field(self, scene_path: str,
                             traj: Optional[int] = None):
        """(ProxyState of numpy arrays, the other saved arrays)."""
        d = self._load(os.path.join(self._dir(scene_path, "occupancy", traj),
                                    "field.npz"))
        fields = {k: d.pop(k) for k in ProxyState._fields}
        return ProxyState(**fields), d

    def save_poses(self, scene_path: str, epoch: int, X_history, V_history,
                   idx_history, traj: Optional[int] = None):
        self._save(os.path.join(self._dir(scene_path, "poses", traj),
                                f"epoch_{epoch}.npz"),
                   X_cam=X_history, V_cam=V_history, cam_idx=idx_history)

    # -- replay sampling ------------------------------------------------------
    def get_random_frames_for_depth(self, rs: np.random.Generator,
                                    scene_path: str, n_needed: int,
                                    exclude_traj: Optional[int] = None):
        """A random past frame burst of any trajectory but ``exclude_traj``:
        (traj, last_frame_nb), or None if nothing is replayable."""
        return _random_frames(self, rs, scene_path, n_needed, exclude_traj)

    def sample_depth_replay(self, rs: np.random.Generator, n_samples: int,
                            n_context: int,
                            exclude_traj: Optional[int] = None):
        """n_samples independent (scene_path, traj, last_frame) draws over
        every scene memory and every trajectory but ``exclude_traj``, each a
        supervision frame with its n_context - 1 frames of context; None if
        no trajectory is replayable."""
        return _depth_replay(self, rs, n_samples, n_context, exclude_traj)

    def _has_snapshots(self, scene_path: str, t: int) -> bool:
        return (os.path.exists(os.path.join(
            self._dir(scene_path, "surface", t), "scene.npz"))
            and os.path.exists(os.path.join(
                self._dir(scene_path, "occupancy", t), "field.npz")))

    def get_random_scene_for_scone(self, rs: np.random.Generator,
                                   scene_path: str, n_supervise: int,
                                   n_loops: int = 1, max_build: int = 30,
                                   exclude_traj: Optional[int] = None,
                                   n_proxy_points: Optional[int] = None):
        """A replay trajectory with its saved snapshots: a random consecutive
        BUILD run of 1 .. max_build - 1 depths rebuilds the partial world,
        then ``n_loops`` windows of ``n_supervise`` depths follow it (each
        window starting at the previous one's last depth).

        The occupancy snapshot gives the occupancy pseudo-GT
        ``(supervision_occ > 0) & (out_of_field < 1)`` of the whole
        trajectory and the carving counters the replay continues from; a
        snapshot of another proxy count is skipped.
        Returns (traj, build depth numbers, info) or None; info holds
        'pseudo_gt', 'n_inside_fov', 'n_behind_depth' ((N, 1) float32) and
        'n_depths'."""
        self.flush()
        return _scone_replay(self, rs, scene_path, n_supervise, n_loops,
                             max_build, exclude_traj, n_proxy_points)


# ---------------------------------------------------------------------------
# The samplers both memories share: host logic over host counts
# ---------------------------------------------------------------------------


def _random_frames(mem, rs, scene_path, n_needed, exclude_traj):
    candidates = []
    for t in range(mem.n_trajectories):
        if exclude_traj is not None and t == exclude_traj:
            continue
        n = mem.n_frames(scene_path, t)
        if n >= n_needed:
            candidates.append((t, n))
    if not candidates:
        return None
    t, n = candidates[rs.integers(0, len(candidates))]
    return t, int(rs.integers(n_needed - 1, n))


def _depth_replay(mem, rs, n_samples, n_context, exclude_traj):
    pools = []
    for path in mem.scene_memory_paths:
        for t in range(mem.n_trajectories):
            if exclude_traj is not None and t == exclude_traj:
                continue
            n = mem.n_frames(path, t)
            if n >= n_context:
                pools.append((path, t, n))
    if not pools:
        return None
    out = []
    for _ in range(n_samples):
        path, t, n = pools[rs.integers(0, len(pools))]
        out.append((path, t, int(rs.integers(n_context - 1, n))))
    return out


def _scone_replay(mem, rs, scene_path, n_supervise, n_loops, max_build,
                  exclude_traj, n_proxy_points):
    need_extra = n_loops * max(n_supervise - 1, 0)
    candidates = []
    for t in range(mem.n_trajectories):
        if exclude_traj is not None and t == exclude_traj:
            continue
        n_d = mem.n_depths(scene_path, t)
        if mem._has_snapshots(scene_path, t) and n_d >= 1 + need_extra:
            candidates.append((t, n_d))
    if not candidates:
        return None
    t, n_d = candidates[rs.integers(0, len(candidates))]
    state, _ = mem.load_occupancy_field(scene_path, t)
    if n_proxy_points is not None and state.points.shape[0] != n_proxy_points:
        return None
    pseudo_gt = (state.supervision_occ > 0.0) & (state.out_of_field < 1.0)
    if isinstance(state.points, torch.Tensor):
        info = {"pseudo_gt": pseudo_gt.float(),
                "n_inside_fov": state.n_inside_fov.float(),
                "n_behind_depth": state.n_behind_depth.float()}
    else:
        info = {"pseudo_gt": pseudo_gt.astype(np.float32),
                "n_inside_fov": np.asarray(state.n_inside_fov, np.float32),
                "n_behind_depth": np.asarray(state.n_behind_depth,
                                             np.float32)}
    info["n_depths"] = n_d
    hi_build = max(min(max_build - 1, n_d - need_extra), 1)
    n_build = int(rs.integers(1, hi_build + 1))
    start = int(rs.integers(0, n_d - n_build - need_extra + 1))
    return t, list(range(start, start + n_build)), info


# ---------------------------------------------------------------------------
# Device-resident memory
# ---------------------------------------------------------------------------


def _rows(x, indices: List[int]):
    """Rows ``indices`` of x: a view for consecutive ones, else a gather
    whose index tensor reaches the card from pinned memory, without
    waiting for it."""
    if all(b == a + 1 for a, b in zip(indices, indices[1:])):
        return x[indices[0]:indices[0] + len(indices)]
    idx = torch.as_tensor(indices, dtype=torch.int64)
    if x.is_cuda:
        idx = idx.pin_memory().to(x.device, non_blocking=True)
    return x.index_select(0, idx)


class DepthStore:
    """A trajectory's predicted depths on the card (for SCONE replay),
    allocated at capacity, appended in order at a host count."""

    FIELDS = ("depth", "mask", "error_mask", "R", "T")

    def __init__(self, max_depths: int, height: int, width: int,
                 device=None):
        shape = (max_depths, height, width, 1)
        self.depth = torch.zeros(shape, device=device)
        self.mask = torch.zeros(shape, dtype=torch.bool, device=device)
        self.error_mask = torch.zeros(shape, dtype=torch.bool, device=device)
        self.R = torch.eye(3, device=device).expand(max_depths, 3,
                                                    3).clone()
        self.T = torch.zeros((max_depths, 3), device=device)
        self.n = 0

    def append(self, depth, mask, error_mask, R, T):
        """Entries [n, n + k) in place; past the capacity the batch lands
        on the last k rows, as JAX writes it. The frame number a caller
        saves under is not used: entries are in append order."""
        k = depth.shape[0]
        at = _clamped_start(self.n, k, self.depth.shape[0])
        for name, v in zip(self.FIELDS, (depth, mask, error_mask, R, T)):
            getattr(self, name)[at:at + k] = v
        self.n += k

    def gather(self, indices) -> Dict[str, torch.Tensor]:
        """Entries ``indices``, stacked."""
        indices = [int(i) for i in indices]
        return {k: _rows(getattr(self, k), indices) for k in self.FIELDS}

    def nbytes(self) -> int:
        return sum(getattr(self, k).nbytes for k in self.FIELDS)


class DeviceMemory:
    """``Memory``'s interface over the card: frames in a ``FrameStore`` and
    remap depths in a ``DepthStore`` per (scene, trajectory slot), both
    allocated when a trajectory begins in that slot; snapshots and poses
    kept as tensors; host counts. Slots rotate with the epoch, as the disk
    memory's directories do."""

    def __init__(self, scene_memory_paths: List[str], current_epoch: int = 0,
                 n_trajectories: int = 1, max_frames: int = 512,
                 max_depths: int = 128, height: int = 256, width: int = 456,
                 zfar: float = 750.0, device=None):
        self.scene_memory_paths = list(scene_memory_paths)
        self.n_trajectories = n_trajectories
        self.current_epoch = current_epoch
        self.max_frames = max_frames
        self.max_depths = max_depths
        self.height, self.width = height, width
        self.zfar = float(zfar)
        self.device = torch.device("cpu" if device is None else device)
        self._frames: Dict = {}  # (path, traj) -> FrameStore
        self._depths: Dict = {}  # (path, traj) -> DepthStore
        self._surface: Dict = {}  # (path, traj) -> (GridState, params)
        self._occupancy: Dict = {}  # (path, traj) -> (ProxyState, params)
        self._poses: Dict = {}  # (path, traj) -> {epoch: (X, V, idx, n_m, n_f)}

    def current_trajectory(self) -> int:
        return self.current_epoch % self.n_trajectories

    def _key(self, scene_path: str, traj: Optional[int]):
        return (scene_path,
                self.current_trajectory() if traj is None else traj)

    # -- frames ---------------------------------------------------------------
    def _new_stores(self, key):
        """Empty frame and depth stores for ``key`` (the old ones are
        released first, so the allocator can reuse their memory)."""
        self._frames.pop(key, None)
        self._depths.pop(key, None)
        self._frames[key] = init_frame_store(self.max_frames, self.height,
                                             self.width, self.device)
        self._depths[key] = DepthStore(self.max_depths, self.height,
                                       self.width, self.device)

    def begin_trajectory(self, scene_path: str) -> FrameStore:
        """Fresh stores for the current slot (its earlier trajectory and
        snapshots are dropped, as its directory is overwritten on disk)."""
        key = self._key(scene_path, None)
        self._new_stores(key)
        self._surface.pop(key, None)
        self._occupancy.pop(key, None)
        return self._frames[key]

    def store(self, scene_path: str, traj: Optional[int] = None) -> FrameStore:
        return self._frames[self._key(scene_path, traj)]

    def update_store(self, scene_path: str, store: FrameStore):
        """Adopt ``store`` (as ``store_append`` returned it, its count
        advanced) for the current slot."""
        self._frames[self._key(scene_path, None)] = store

    def n_frames(self, scene_path: str, traj: Optional[int] = None) -> int:
        st = self._frames.get(self._key(scene_path, traj))
        return 0 if st is None else st.n

    def load_frame_sequence(self, scene_path: str, last_frame_nb: int, n: int,
                            traj: Optional[int] = None) -> Dict:
        """``Memory.load_frame_sequence`` as views of the store (keys
        images, zbuf, mask, R, T, zfar)."""
        return store_window(self.store(scene_path, traj), last_frame_nb, n,
                            self.zfar)

    # -- depths (predicted, for SCONE replay) ---------------------------------
    def save_depth(self, scene_path: str, frame_nb: int, depth, mask,
                   error_mask, R, T, traj: Optional[int] = None):
        self._depths[self._key(scene_path, traj)].append(depth, mask,
                                                         error_mask, R, T)

    def n_depths(self, scene_path: str, traj: Optional[int] = None) -> int:
        ds = self._depths.get(self._key(scene_path, traj))
        return 0 if ds is None else ds.n

    def load_depth(self, scene_path: str, frame_nb: int,
                   traj: Optional[int] = None) -> Dict:
        """Entry ``frame_nb`` as (1, ...) views."""
        return self.depth_stack(scene_path, traj, [frame_nb])

    def depth_stack(self, scene_path: str, traj: Optional[int], indices):
        return self._depths[self._key(scene_path, traj)].gather(indices)

    # -- scene snapshots -------------------------------------------------------
    def save_surface_scene(self, scene_path: str, state: GridState,
                           traj: Optional[int] = None, **scene_params):
        self._surface[self._key(scene_path, traj)] = (state,
                                                      dict(scene_params))

    def load_surface_scene(self, scene_path: str, traj: Optional[int] = None):
        return self._surface[self._key(scene_path, traj)]

    def save_occupancy_field(self, scene_path: str, state: ProxyState,
                             traj: Optional[int] = None, **scene_params):
        self._occupancy[self._key(scene_path, traj)] = (state,
                                                        dict(scene_params))

    def load_occupancy_field(self, scene_path: str,
                             traj: Optional[int] = None):
        return self._occupancy[self._key(scene_path, traj)]

    def save_poses(self, scene_path: str, epoch: int, X_history, V_history,
                   idx_history, n_moves: Optional[int] = None,
                   n_frames: Optional[int] = None,
                   traj: Optional[int] = None):
        """Pose histories as tensors; ``n_moves`` and ``n_frames`` are the
        filled rows of the capacity-sized histories."""
        self._poses.setdefault(self._key(scene_path, traj), {})[epoch] = (
            X_history, V_history, idx_history, n_moves, n_frames)

    # -- replay sampling (host logic over host counts) -------------------------
    def get_random_frames_for_depth(self, rs: np.random.Generator,
                                    scene_path: str, n_needed: int,
                                    exclude_traj: Optional[int] = None):
        return _random_frames(self, rs, scene_path, n_needed, exclude_traj)

    def sample_depth_replay(self, rs: np.random.Generator, n_samples: int,
                            n_context: int,
                            exclude_traj: Optional[int] = None):
        return _depth_replay(self, rs, n_samples, n_context, exclude_traj)

    def _has_snapshots(self, scene_path: str, t: int) -> bool:
        return ((scene_path, t) in self._surface
                and (scene_path, t) in self._occupancy)

    def get_random_scene_for_scone(self, rs: np.random.Generator,
                                   scene_path: str, n_supervise: int,
                                   n_loops: int = 1, max_build: int = 30,
                                   exclude_traj: Optional[int] = None,
                                   n_proxy_points: Optional[int] = None):
        """``Memory.get_random_scene_for_scone`` with the pseudo-GT and the
        carving counters as tensors on the card."""
        return _scone_replay(self, rs, scene_path, n_supervise, n_loops,
                             max_build, exclude_traj, n_proxy_points)

    # -- persistence -----------------------------------------------------------
    def nbytes(self) -> int:
        """Bytes of the frame and depth stores allocated now."""
        return (sum(sum(t.nbytes for t in st[:5])
                    for st in self._frames.values())
                + sum(ds.nbytes() for ds in self._depths.values()))

    def full_nbytes(self) -> int:
        """Bytes of the frame and depth stores once every (scene, slot) has
        begun a trajectory (built on the meta device: nothing allocated)."""
        meta = torch.device("meta")
        frames = init_frame_store(self.max_frames, self.height, self.width,
                                  meta)
        depths = DepthStore(self.max_depths, self.height, self.width, meta)
        slot = sum(t.nbytes for t in frames[:5]) + depths.nbytes()
        return len(self.scene_memory_paths) * self.n_trajectories * slot

    def hydrate_from_disk(self):
        """Load a run's memory files into the stores (resume): every
        (scene, slot) key, as ``load_from_disk`` loads it."""
        self.load_from_disk([(path, t) for path in self.scene_memory_paths
                             for t in range(self.n_trajectories)])

    def load_from_disk(self, keys) -> int:
        """Load each (scene path, slot) key of ``keys`` from its files (those
        that ``flush_to_disk`` writes): its frames and depths up to the
        capacities, and its snapshots. A key's stores and snapshots are
        replaced, never appended to; a key without files is left empty.
        Returns the bytes of the arrays read."""
        mem = Memory(self.scene_memory_paths, self.current_epoch,
                     self.n_trajectories)
        return sum(self._load_key(mem, path, t) for path, t in keys)

    def _load_key(self, mem: Memory, path: str, t: int) -> int:
        key, dev, nbytes = (path, t), self.device, 0

        def tensors(arrays):
            nonlocal nbytes
            nbytes += sum(np.asarray(a).nbytes for a in arrays)
            return (torch.as_tensor(a, device=dev) for a in arrays)

        for held in (self._frames, self._depths, self._surface,
                     self._occupancy):
            held.pop(key, None)
        n = min(mem.n_frames(path, t), self.max_frames)
        n_d = min(mem.n_depths(path, t), self.max_depths)
        if n or n_d:
            self._new_stores(key)
        if n:
            fr = mem.load_frame_sequence(path, n - 1, n, t)
            self._frames[key] = store_append(self._frames[key], *tensors(
                [fr[k] for k in ("images", "zbuf", "mask", "R", "T")]))
        for i in range(n_d):
            d = mem.load_depth(path, i, t)
            self._depths[key].append(*tensors(
                [d[k] for k in DepthStore.FIELDS]))
        if mem._has_snapshots(path, t):
            state, extra = mem.load_surface_scene(path, t)
            self._surface[key] = (GridState(*tensors(state)), extra)
            state, extra = mem.load_occupancy_field(path, t)
            self._occupancy[key] = (ProxyState(*tensors(state)), extra)
        return nbytes

    def keys(self) -> List:
        """The (scene path, slot) keys that hold frames or depths."""
        return sorted(set(self._frames) | set(self._depths))

    def key_state(self, key) -> Dict[str, torch.Tensor]:
        """What replay can read of ``key``: its filled frame and depth rows
        and its snapshots' states, by name (the counts are the rows)."""
        out = {}
        n = self.n_frames(*key)
        if n:
            st = self._frames[key]
            out.update({f"frames.{k}": getattr(st, k)[:n]
                        for k in ("images", "zbuf", "mask", "R", "T")})
        ds = self._depths.get(key)
        if ds is not None and ds.n:
            out.update({f"depths.{k}": getattr(ds, k)[:ds.n]
                        for k in DepthStore.FIELDS})
        for kind, held in (("surface", self._surface),
                           ("occupancy", self._occupancy)):
            if key in held:
                state, _ = held[key]
                out.update({f"{kind}.{k}": v for k, v in
                            state._asdict().items()})
        return out

    def flush_to_disk(self, keys=None) -> int:
        """Write the (scene path, slot) keys ``keys`` (default every scene's
        every slot) through a disk ``Memory`` in its layout:
        frames/<n>.npz, depths/<n>.npz, surface/scene.npz,
        occupancy/field.npz, poses/epoch_<e>.npz; returns once the files
        are written, with the bytes of the arrays written. A key's frame
        and depth files past its counts, and snapshot files it does not
        hold, are removed, so that its files hold what the memory holds
        (``load_from_disk`` gives it back). Each key's writes are waited
        for before the next one's are queued, so the host holds at most
        one slot's copies at a time."""
        mem = Memory(self.scene_memory_paths, self.current_epoch,
                     self.n_trajectories)
        if keys is None:
            keys = [(path, t) for path in self.scene_memory_paths
                    for t in range(self.n_trajectories)]
        nbytes = 0
        for path, t in keys:
            key = (path, t)
            held = key in self._frames or key in self._depths
            n = self.n_frames(path, t)
            if n:
                st = self._frames[key]
                frames = [x[:n] for x in st[:5]]
                nbytes += sum(x.nbytes for x in frames)
                mem.save_frame_batch(path, 0, *frames, self.zfar, traj=t)
            ds = self._depths.get(key)
            n_d = 0 if ds is None else ds.n
            for i in range(n_d):
                depth = [getattr(ds, k)[i:i + 1] for k in DepthStore.FIELDS]
                nbytes += sum(x.nbytes for x in depth)
                mem.save_depth(path, i, *depth, traj=t)
            if key in self._surface:
                state, params = self._surface[key]
                nbytes += sum(x.nbytes for x in state)
                mem.save_surface_scene(path, state, traj=t, **params)
            if key in self._occupancy:
                state, params = self._occupancy[key]
                nbytes += sum(x.nbytes for x in state)
                mem.save_occupancy_field(path, state, traj=t, **params)
            for epoch, (X, V, idx, n_m, n_f) in self._poses.get(
                    key, {}).items():
                poses = (X[:n_f] if n_f else X, V[:n_f] if n_f else V,
                         idx[:n_m] if n_m else idx)
                nbytes += sum(x.nbytes for x in poses)
                mem.save_poses(path, epoch, *poses, traj=t)
            mem.flush()
            if held:
                _remove_past(mem.frames_dir(path, t), n)
                _remove_past(mem._dir(path, "depths", t), n_d)
                for kind, name, snaps in (
                        ("surface", "scene.npz", self._surface),
                        ("occupancy", "field.npz", self._occupancy)):
                    f = os.path.join(mem._dir(path, kind, t), name)
                    if key not in snaps and os.path.exists(f):
                        os.remove(f)
        return nbytes


def _remove_past(directory: str, n: int):
    """Remove ``directory``'s numbered files <i>.npz from i = n on (those
    of a longer trajectory that an earlier epoch left in the slot)."""
    for f in os.listdir(directory):
        stem, ext = os.path.splitext(f)
        if ext == ".npz" and stem.isdigit() and int(stem) >= n:
            os.remove(os.path.join(directory, f))
