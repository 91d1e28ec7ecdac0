"""On-disk replay memory (port of the ``Memory`` of
macarons_tpu/scene/memory.py).

Per scene directory, ``<scene>/training/<traj>/`` holds the captured frames
(``frames/<n>.npz``: rgb, zbuf, mask, R, T, zfar), the predicted depths of a
remap (``depths/<n>.npz``: depth, mask, error_mask, R, T), the
end-of-trajectory snapshots (``surface/scene.npz``, ``occupancy/field.npz``)
and the poses (``poses/epoch_<e>.npz``), with the JAX package's keys, so
the two packages read each other's memories. Writes are synchronous.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .grid import GridState
from .proxy import ProxyState


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


class Memory:
    """Replay store over one or more scene directories; trajectory slots
    rotate with the epoch (``current_epoch % n_trajectories``)."""

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

    @staticmethod
    def _save(fpath: str, **arrays):
        np.savez(fpath, **{k: _np(v) for k, v in arrays.items()})

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
        """A capture batch of K frames as K per-frame files, with one copy to
        the host per array."""
        host = {k: _np(v) for k, v in
                dict(rgb=rgb, zbuf=zbuf, mask=mask, R=R, T=T).items()}
        for i in range(host["rgb"].shape[0]):
            self._save(os.path.join(self.frames_dir(scene_path, traj),
                                    f"{first_frame_nb + i}.npz"),
                       **{k: v[i:i + 1] for k, v in host.items()},
                       zfar=np.float32(zfar))

    def load_frame(self, scene_path: str, frame_nb: int,
                   traj: Optional[int] = None) -> Dict[str, np.ndarray]:
        with np.load(os.path.join(self.frames_dir(scene_path, traj),
                                  f"{frame_nb}.npz")) as f:
            return dict(f)

    def n_frames(self, scene_path: str, traj: Optional[int] = None) -> int:
        d = self.frames_dir(scene_path, traj)
        return len([f for f in os.listdir(d) if f.endswith(".npz")])

    def load_frame_sequence(self, scene_path: str, last_frame_nb: int, n: int,
                            traj: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Frames [last - n + 1 .. last], stacked."""
        frames = [self.load_frame(scene_path, last_frame_nb - n + 1 + i, traj)
                  for i in range(n)]
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
        with np.load(os.path.join(self._dir(scene_path, "depths", traj),
                                  f"{frame_nb}.npz")) as f:
            return dict(f)

    def n_depths(self, scene_path: str, traj: Optional[int] = None) -> int:
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
        with np.load(os.path.join(self._dir(scene_path, "surface", traj),
                                  "scene.npz")) as f:
            d = dict(f)
        return GridState(d.pop("points"), d.pop("features"), d.pop("valid")), d

    def save_occupancy_field(self, scene_path: str, state: ProxyState,
                             traj: Optional[int] = None, **scene_params):
        self._save(os.path.join(self._dir(scene_path, "occupancy", traj),
                                "field.npz"),
                   **state._asdict(), **scene_params)

    def load_occupancy_field(self, scene_path: str,
                             traj: Optional[int] = None):
        """(ProxyState of numpy arrays, the other saved arrays)."""
        with np.load(os.path.join(self._dir(scene_path, "occupancy", traj),
                                  "field.npz")) as f:
            d = dict(f)
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
        candidates = []
        for t in range(self.n_trajectories):
            if exclude_traj is not None and t == exclude_traj:
                continue
            n = self.n_frames(scene_path, t)
            if n >= n_needed:
                candidates.append((t, n))
        if not candidates:
            return None
        t, n = candidates[rs.integers(0, len(candidates))]
        return t, int(rs.integers(n_needed - 1, n))

    def sample_depth_replay(self, rs: np.random.Generator, n_samples: int,
                            n_context: int,
                            exclude_traj: Optional[int] = None):
        """n_samples independent (scene_path, traj, last_frame) draws over
        every scene memory and every trajectory but ``exclude_traj``, each a
        supervision frame with its n_context - 1 frames of context; None if
        no trajectory is replayable."""
        pools = []
        for path in self.scene_memory_paths:
            for t in range(self.n_trajectories):
                if exclude_traj is not None and t == exclude_traj:
                    continue
                n = self.n_frames(path, t)
                if n >= n_context:
                    pools.append((path, t, n))
        if not pools:
            return None
        out = []
        for _ in range(n_samples):
            path, t, n = pools[rs.integers(0, len(pools))]
            out.append((path, t, int(rs.integers(n_context - 1, n))))
        return out

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
        need_extra = n_loops * max(n_supervise - 1, 0)
        candidates = []
        for t in range(self.n_trajectories):
            if exclude_traj is not None and t == exclude_traj:
                continue
            surf = os.path.join(self._dir(scene_path, "surface", t),
                                "scene.npz")
            occf = os.path.join(self._dir(scene_path, "occupancy", t),
                                "field.npz")
            n_d = self.n_depths(scene_path, t)
            if os.path.exists(surf) and os.path.exists(occf) \
                    and n_d >= 1 + need_extra:
                candidates.append((t, n_d))
        if not candidates:
            return None
        t, n_d = candidates[rs.integers(0, len(candidates))]
        state, _ = self.load_occupancy_field(scene_path, t)
        if n_proxy_points is not None \
                and state.points.shape[0] != n_proxy_points:
            return None
        info = {
            "pseudo_gt": ((state.supervision_occ > 0.0)
                          & (state.out_of_field < 1.0)).astype(np.float32),
            "n_inside_fov": np.asarray(state.n_inside_fov, np.float32),
            "n_behind_depth": np.asarray(state.n_behind_depth, np.float32),
            "n_depths": n_d,
        }
        hi_build = max(min(max_build - 1, n_d - need_extra), 1)
        n_build = int(rs.integers(1, hi_build + 1))
        start = int(rs.integers(0, n_d - n_build - need_extra + 1))
        return t, list(range(start, start + n_build)), info
