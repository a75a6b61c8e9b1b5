"""Seeded inputs: sub-seeds, blob submaps, unit descriptor rows, tuple
batches and the open-loop arrival schedule.

``blob_submaps`` and ``tuple_batch`` are copies of
``epcnet_torch/scripts/train_bench.py``'s, and ``unit_rows`` of
``epcnet_torch/scripts/serve_scale.py``'s (here it returns the rows on the
generator's device), so that the yardstick does not move when the program's
scripts do.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

# one stream of random numbers a purpose, each from the run's seed
_TAGS = {"weights": 1, "pool": 2, "schedule": 3, "db": 4, "batches": 6, "plant": 7}


def _words(seed: int) -> list[int]:
    s = int(seed) % (1 << 64)
    return [s & 0xFFFFFFFF, s >> 32]


def rng(seed: int, tag: str) -> np.random.Generator:
    """A numpy generator for one purpose (``_TAGS``) of the run's seed. Any
    whole number is a seed, 64 bits and more included."""
    return np.random.default_rng(_words(seed) + [_TAGS[tag]])


def torch_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for a ``torch.Generator``, for one purpose of the run's
    seed."""
    state = np.random.SeedSequence(_words(seed) + [_TAGS[tag]]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def blob_submaps(rng_: np.random.Generator, count: int, n: int) -> np.ndarray:
    """Seeded place-like submaps: each a few gaussian blobs, 3-12 of them
    with random sizes and shares, clipped to [-1, 1] (the geometry of the
    synthetic dataset)."""
    out = np.empty((count, n, 3), np.float32)
    for i in range(count):
        nb = int(rng_.integers(3, 13))
        centers = rng_.uniform(-0.8, 0.8, (nb, 3))
        scales = rng_.uniform(0.02, 0.2, (nb, 1))
        pick = rng_.choice(nb, n, p=rng_.dirichlet(np.ones(nb)))
        out[i] = np.clip(centers[pick] + scales[pick] * rng_.standard_normal((n, 3)), -1, 1)
    return out


def tuple_batch(rng_: np.random.Generator, b: int, p: int, ng: int, n: int) -> dict:
    """B tuples of 1 query, P positives, Ng negatives and the other
    negative, as the program's loader emits them (numpy)."""
    clouds = blob_submaps(rng_, b * (p + ng + 2), n).reshape(b, p + ng + 2, n, 3)
    return {"query": clouds[:, 0], "positives": clouds[:, 1:1 + p],
            "negatives": clouds[:, 1 + p:1 + p + ng], "other_neg": clouds[:, -1]}


def unit_rows(gen: torch.Generator, n: int, dim: int) -> torch.Tensor:
    """n random unit-norm fp32 rows, drawn on the generator's device."""
    d = torch.randn((n, dim), generator=gen, device=gen.device)
    return d / torch.linalg.vector_norm(d, dim=1, keepdim=True)


def open_loop_schedule(seed: int, rate: float, seconds: float, pool: int):
    """Due times (s from the window's start) and pool submaps of an open
    loop of Poisson arrivals at ``rate`` a second over ``seconds``.

    Every seed gets the same set of gaps and the same multiset of submaps,
    in another order: the gaps are the exponential distribution's quantiles
    at (i + 0.5) / M for M = round(rate x seconds), scaled so that the last
    request is due at ``seconds`` x (M - 0.5) / M, and submap j is asked
    for M / pool times (one more for the first M % pool). So a seed changes
    which request waits behind which, not how much work the window holds."""
    m = max(1, int(round(rate * seconds)))
    q = (np.arange(m) + 0.5) / m
    gaps = -np.log1p(-q)
    gaps *= seconds * (m - 0.5) / m / gaps.sum()
    r = rng(seed, "schedule")
    due = np.cumsum(r.permutation(gaps))
    which = r.permutation(np.arange(m) % pool)
    return due, which


class Laps:
    """Seconds between calls: ``lap(name)`` records the time since the
    last call (or since it was made) under ``name``."""

    def __init__(self):
        self.laps: dict[str, float] = {}
        self._t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.laps[name] = now - self._t
        self._t = now


class GcPauses:
    """The interpreter's garbage-collection pauses (every thread waits in
    them) from its creation to ``close()``."""

    def __init__(self):
        self.pauses: list[tuple[int, float]] = []
        self._start = 0.0
        gc.callbacks.append(self._cb)

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start = time.perf_counter()
        else:
            self.pauses.append((info["generation"], time.perf_counter() - self._start))

    def close(self) -> None:
        if self._cb in gc.callbacks:
            gc.callbacks.remove(self._cb)

    def summary(self) -> dict:
        full = [p for g, p in self.pauses if g == 2]
        return {"count": len(self.pauses), "full": len(full),
                "max_ms": max((p for _, p in self.pauses), default=0.0) * 1e3,
                "total_ms": sum(p for _, p in self.pauses) * 1e3}
