"""Point-cloud file IO and augmentation (twin of
``epcnet_tpu/data/pointclouds.py``).

Submaps are raw ``.bin`` files of float64 xyz (4096 x 3 in the standard
layout), already normalised to [-1, 1]; they are read as float32, the
models' input dtype. Augmentation is a random rotation about the up axis
plus clipped Gaussian jitter, from an explicit ``np.random.Generator``.
Everything here is host numpy.
"""

from __future__ import annotations

import os

import numpy as np


def load_pc_file(
    filename: str, dataset_root: str = "", num_points: int | None = 4096
) -> np.ndarray:
    """One submap: .bin float64 xyz -> [num_points, 3] float32.

    ``num_points=None`` infers N from the file size (``cli/embed.py`` reads
    clouds of any size)."""
    path = os.path.join(dataset_root, filename) if dataset_root else filename
    pc = np.fromfile(path, dtype=np.float64)
    if num_points is None:
        if pc.size == 0 or pc.size % 3 != 0:
            raise ValueError(
                f"{path}: expected float64 xyz triples, got {pc.size} values"
            )
        return pc.reshape(-1, 3).astype(np.float32)
    if pc.size != num_points * 3:
        raise ValueError(
            f"{path}: expected {num_points * 3} float64 values, got {pc.size}"
        )
    return pc.reshape(num_points, 3).astype(np.float32)


def load_pc_files(filenames, dataset_root: str = "", num_points: int = 4096) -> np.ndarray:
    """[len(filenames), num_points, 3] float32."""
    return np.stack(
        [load_pc_file(f, dataset_root, num_points) for f in filenames], axis=0
    )


def rotate_point_cloud(batch: np.ndarray, rng: np.random.Generator | None = None) -> np.ndarray:
    """Random rotation about the up axis (z), one angle per cloud."""
    rng = rng or np.random.default_rng()
    out = np.empty_like(batch)
    for i in range(batch.shape[0]):
        angle = rng.uniform() * 2.0 * np.pi
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=batch.dtype)
        out[i] = batch[i] @ rot.T
    return out


def jitter_point_cloud(
    batch: np.ndarray,
    sigma: float = 0.005,
    clip: float = 0.05,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Gaussian jitter of std ``sigma``, clipped to ±``clip``."""
    rng = rng or np.random.default_rng()
    noise = np.clip(sigma * rng.standard_normal(batch.shape), -clip, clip)
    return (batch + noise).astype(batch.dtype)
