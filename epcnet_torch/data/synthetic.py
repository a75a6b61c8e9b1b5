"""Synthetic dataset generator (twin of ``epcnet_tpu/data/synthetic.py``).

Writes a dataset in the Oxford on-disk layout (runs with a locations csv
and float64 ``.bin`` submaps), byte for byte the files the JAX package
writes for the same arguments, and with no pandas: the csv is written by
hand in the format ``DataFrame.to_csv(index=False)`` gives (shortest
round-trip floats).

Geometry: every trajectory waypoint hashes to a base cloud of gaussian
blobs, so revisits of one place (any run) share structure while waypoints
``spacing_m`` apart (beyond the positive radius) do not. ``difficulty`` in
[0, 1] adds per-visit heading change (up to ±difficulty·π), occlusion (each
visit hides ~35%·difficulty of the blobs), resampling and extra noise; the
labels stay exact.
"""

from __future__ import annotations

import os

import numpy as np


def _cell_cloud(
    place: tuple[int, int], num_points: int, world_seed: int,
    sample_rng: np.random.Generator | None = None,
    n_blobs: int = 8,
    keep_mask: np.ndarray | None = None,
) -> np.ndarray:
    """A point cloud of ``place``: ``n_blobs`` gaussian blobs from the
    place's own seed. With ``sample_rng=None`` the points come from that
    seed too (every visit identical); a per-visit ``sample_rng`` draws
    fresh points from the same blobs. ``keep_mask`` hides some blobs."""
    seed = (world_seed * 1_000_003 + place[0] * 7919 + place[1] * 104729) % (2**31 - 1)
    rng = np.random.default_rng(seed)
    k = n_blobs
    centers = rng.uniform(-0.8, 0.8, (k, 3))
    scales = rng.uniform(0.02, 0.2, (k, 1))
    srng = sample_rng if sample_rng is not None else rng
    if keep_mask is not None:
        kept = np.flatnonzero(keep_mask)
        assign = kept[srng.integers(0, len(kept), num_points)]
    else:
        assign = srng.integers(0, k, num_points)
    pts = centers[assign] + scales[assign] * srng.standard_normal((num_points, 3))
    return np.clip(pts, -1.0, 1.0)


def _write_csv(path: str, rows: list[tuple[str, float, float]]) -> None:
    with open(path, "w", newline="") as f:
        f.write("timestamp,northing,easting\n")
        for ts, n, e in rows:
            f.write(f"{ts},{float(n)!r},{float(e)!r}\n")


def generate_synthetic_dataset(
    root: str,
    num_runs: int = 3,
    submaps_per_run: int = 40,
    num_points: int = 4096,
    runs_subdir: str = "oxford",
    pointcloud_dir: str = "pointcloud_20m_10overlap",
    csv_name: str = "pointcloud_locations_20m_10overlap.csv",
    spacing_m: float = 20.0,
    world_seed: int = 7,
    noise: float = 0.01,
    origin: tuple[float, float] = (5_800_000.0, 600_000.0),
    resample_per_visit: bool = False,
    difficulty: float = 0.0,
) -> str:
    """Writes the dataset under ``root`` and returns ``root``.

    Every run follows the same closed loop in UTM space with jitter, so run
    i's submap near (n, e) is a true positive for run j's submap there.
    ``origin`` defaults to a spot far from the Oxford test rectangles;
    distinct origins give non-overlapping regions.
    ``resample_per_visit`` draws fresh points on every visit; ``difficulty``
    > 0 implies it."""
    base = os.path.join(root, runs_subdir)
    os.makedirs(base, exist_ok=True)
    if not 0.0 <= difficulty <= 1.0:
        raise ValueError(f"difficulty must be in [0, 1], got {difficulty}")
    resample = resample_per_visit or difficulty > 0
    n_blobs = 8 if difficulty == 0 else 12
    rot_max = 0.2 + difficulty * (np.pi - 0.2)
    blob_dropout = 0.35 * difficulty
    noise = noise + 0.02 * difficulty
    t = np.linspace(0, 2 * np.pi, submaps_per_run, endpoint=False)
    radius = spacing_m * submaps_per_run / (2 * np.pi)
    origin_n, origin_e = origin

    for r in range(num_runs):
        rng = np.random.default_rng(1000 + r)
        run = f"run_{r:02d}"
        pc_dir = os.path.join(base, run, pointcloud_dir)
        os.makedirs(pc_dir, exist_ok=True)
        rows = []
        for s in range(submaps_per_run):
            n = origin_n + radius * np.cos(t[s]) + rng.normal(0, 2.0)
            e = origin_e + radius * np.sin(t[s]) + rng.normal(0, 2.0)
            # the place is the waypoint, told apart by origin so that
            # separate regions never share base clouds
            place = (s, int(origin_n + origin_e) % 1_000_003)
            keep = None
            if blob_dropout > 0:
                keep = rng.random(n_blobs) >= blob_dropout
                if not keep.any():
                    keep[rng.integers(n_blobs)] = True
            pts = _cell_cloud(
                place, num_points, world_seed,
                sample_rng=rng if resample else None,
                n_blobs=n_blobs, keep_mask=keep,
            )
            # per visit: a rotation about z and noise
            ang = rng.uniform(-rot_max, rot_max)
            c, sn = np.cos(ang), np.sin(ang)
            rot = np.array([[c, -sn, 0], [sn, c, 0], [0, 0, 1]])
            pts = pts @ rot.T + noise * rng.standard_normal(pts.shape)
            pts = np.clip(pts, -1.0, 1.0)
            ts = f"{r:02d}{s:06d}"
            pts.astype(np.float64).tofile(os.path.join(pc_dir, f"{ts}.bin"))
            rows.append((ts, n, e))
        _write_csv(os.path.join(base, run, csv_name), rows)
    return root
