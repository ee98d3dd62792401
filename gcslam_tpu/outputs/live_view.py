"""Live visualization during a streaming run — the reference's live Rerun
mode (backend/rerun_visualizer.py:34 spawns a viewer at node start and logs
lidar points / trajectory / map as the run progresses), rebuilt for the
offline device runtime.

Two backends, picked at construction:

  rerun  — when the `rerun` SDK is importable: init a recording (optionally
           `spawn=True` to pop the viewer), log `world/trajectory`,
           `world/lidar`, `world/map/points` live. Matches the entity layout
           of outputs/rerun_export.py so post-run and live views agree.
  file   — SDK-less fallback (this image ships no rerun): an append-only
           `live/` directory — `live.jsonl` (one line per logged scan: pose,
           stamp, map size, snapshot file) plus periodic map-snapshot NPZs —
           i.e. a tail-able stream any external viewer can poll. This is the
           same contract as the /gc/map + /gc/state topics the reference
           publishes live (map_publisher.py:90, backend_node.py:2212-2293).

The logger is intentionally host-side and pull-cheap: per-scan it logs only
the 6D pose (one tiny d2h, which streaming mode already pays); points and
map snapshots are logged every `points_every` / `map_every` scans.
"""

from __future__ import annotations

import json
import os

import numpy as np


class LiveViewer:
    def __init__(
        self,
        out_dir: str,
        spawn: bool = False,
        points_every: int = 10,
        map_every: int = 20,
        max_points: int = 2048,
    ):
        self.points_every = max(1, points_every)
        self.map_every = max(1, map_every)
        self.max_points = max_points
        self.out_dir = out_dir
        self._traj: list = []
        self._n_logged = 0
        try:
            import rerun as rr  # type: ignore

            self.rr = rr
            self.backend = "rerun"
            rr.init("gcslam_tpu", spawn=spawn)
            if not spawn:
                os.makedirs(out_dir, exist_ok=True)
                rr.save(os.path.join(out_dir, "live.rrd"))
        except ImportError:
            self.rr = None
            self.backend = "file"
            os.makedirs(out_dir, exist_ok=True)
            self._jsonl = open(os.path.join(out_dir, "live.jsonl"), "w")

    # -- per-scan ------------------------------------------------------------
    def log_scan(self, i: int, stamp: float, pose6: np.ndarray,
                 points: np.ndarray | None = None,
                 weights: np.ndarray | None = None,
                 map_valid_total: float = 0.0) -> None:
        pose6 = np.asarray(pose6, dtype=np.float64)
        self._traj.append(pose6[:3].copy())
        self._n_logged += 1
        log_pts = points is not None and (i % self.points_every == 0)
        pts = None
        if log_pts:
            pts = np.asarray(points, dtype=np.float32)
            if weights is not None:
                pts = pts[np.asarray(weights) > 0]
            if len(pts) > self.max_points:
                pts = pts[:: max(1, len(pts) // self.max_points)]
        if self.backend == "rerun":
            rr = self.rr
            rr.set_time_seconds("scan_time", float(stamp))
            rr.log("world/trajectory",
                   rr.LineStrips3D([np.asarray(self._traj, dtype=np.float32)]))
            if pts is not None:
                rr.log("world/lidar", rr.Points3D(pts))
        else:
            rec = {
                "scan": int(i), "stamp": float(stamp),
                "pose": [round(float(v), 6) for v in pose6],
                "map_valid_total": float(map_valid_total),
            }
            if pts is not None:
                f = os.path.join(self.out_dir, f"points_{i:06d}.npz")
                np.savez_compressed(f, points=pts)
                rec["points_file"] = os.path.basename(f)
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    # -- periodic map --------------------------------------------------------
    def maybe_log_map(self, i: int, atlas) -> None:
        if i % self.map_every != 0:
            return
        from gcslam_tpu.outputs.splat_export import save_splat_export

        f = os.path.join(self.out_dir, f"live_map_{i:06d}.npz")
        n = save_splat_export(f, atlas)
        if self.backend == "rerun":
            d = np.load(f)
            self.rr.log("world/map/points",
                        self.rr.Points3D(d["mu_world"],
                                         colors=(d["colors"] * 255).astype(np.uint8)))
        else:
            self._jsonl.write(json.dumps(
                {"scan": int(i), "map_file": os.path.basename(f), "n_splats": int(n)}
            ) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self.backend == "file":
            self._jsonl.close()
