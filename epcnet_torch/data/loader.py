"""Training-tuple assembly and async prefetching loader (twin of
``epcnet_tpu/data/loader.py``; numpy only).

The reference loads every tuple on the main Python thread between steps.
Here ``DataConfig.loader_threads`` pool workers
assemble tuples in parallel (each tuple's clouds load through the GIL-free
native batch loader), a bounded in-flight window keeps order deterministic,
and a bounded queue keeps ``prefetch_depth`` batches ready, so host IO
overlaps device compute.

Determinism: tuple composition is keyed (seed, epoch, tuple-idx) and batch
augmentation (seed, epoch, batch-seq), so the emitted stream is identical
for ANY pool size — restart idempotence does not depend on
thread scheduling. The stream equals the JAX loader's for the same seed,
epoch and ``skip_batches`` (``tests/test_torch_loader.py``): a run resumed
by either package sees the same batches.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np

from epcnet_torch.configs import DataConfig
from epcnet_torch.data.native_loader import load_pc_files_native
from epcnet_torch.data.pointclouds import (
    jitter_point_cloud,
    rotate_point_cloud,
)
from epcnet_torch.data.tuples import TrainingTuples


def get_query_tuple(
    tuples: TrainingTuples,
    idx: int,
    cfg: DataConfig,
    rng: np.random.Generator,
    hard_negatives: Sequence[int] | None = None,
) -> dict | None:
    """One training tuple as numpy arrays (query/positives/negatives/other_neg).

    Matches reference semantics: positives sampled from the <10 m set, negatives random
    (or provided hard negatives first), other_neg = a submap that is a
    negative of the query AND of every sampled positive/negative's
    neighbourhood (approximated, as in the reference, by a random negative of
    the union). Returns None if the tuple is unusable (too few positives).
    """
    entry = tuples.queries[idx]
    if len(entry["positives"]) < cfg.num_positives:
        return None

    pos_ids = rng.choice(entry["positives"], cfg.num_positives, replace=False)
    negs = [int(n) for n in (hard_negatives or [])][: cfg.num_negatives]
    pool = entry["negatives"]
    if len(pool) == 0:
        return None
    need = cfg.num_negatives - len(negs)
    if need > 0:
        taken = set(negs)
        fresh = [int(p) for p in pool if int(p) not in taken]
        if len(fresh) >= need:
            negs.extend(int(x) for x in rng.choice(fresh, need, replace=False))
        else:
            # tiny/synthetic regions: fall back to replacement rather than
            # rejection-sample forever (the reference's random.sample would
            # raise here; we keep the tuple usable)
            negs.extend(fresh)
            while len(negs) < cfg.num_negatives:
                negs.append(int(pool[rng.integers(len(pool))]))

    other = None
    if cfg.use_other_neg:
        # neighbours of everything sampled -> other_neg must avoid them all
        banned = set(entry["positives"]) | {idx}
        for i in negs:
            banned |= set(tuples.queries[int(i)]["positives"])
        choices = [i for i in pool if i not in banned]
        other = int(choices[rng.integers(len(choices))]) if choices else int(
            pool[rng.integers(len(pool))]
        )

    # ONE native batch load for the whole tuple (GIL-free parallel reads)
    load_ids = [idx, *[int(i) for i in pos_ids], *negs] + ([other] if other is not None else [])
    files = [tuples.queries[i]["query"] for i in load_ids]
    # one consistent pool size across ALL native-loader callers: the C++
    # pool is global and rebuilt whenever the requested size changes, so
    # mismatched sizes would thrash it between tuple loads and mining sweeps
    pts = load_pc_files_native(
        files, cfg.dataset_root, cfg.num_points, n_threads=cfg.loader_threads
    )

    p, ng = cfg.num_positives, cfg.num_negatives
    out = {
        "query": pts[0],
        "positives": pts[1 : 1 + p],
        "negatives": pts[1 + p : 1 + p + ng],
        "ids": {"query": idx, "positives": [int(i) for i in pos_ids],
                "negatives": list(negs)},
    }
    if other is not None:
        out["other_neg"] = pts[-1]
        out["ids"]["other_neg"] = other
    return out


def _augment(batch: np.ndarray, cfg: DataConfig, rng: np.random.Generator) -> np.ndarray:
    flat = batch.reshape(-1, *batch.shape[-2:])
    if cfg.rotate:
        flat = rotate_point_cloud(flat, rng)
    if cfg.jitter_sigma > 0:
        flat = jitter_point_cloud(flat, cfg.jitter_sigma, cfg.jitter_clip, rng)
    return flat.reshape(batch.shape)


class TupleLoader:
    """Bounded-queue prefetching loader over training tuples.

    Yields batches (dict of stacked numpy arrays):
      query [B, N, 3], positives [B, P, N, 3], negatives [B, Ng, N, 3],
      other_neg [B, N, 3], ids (list of id-dicts).
    ``set_hard_negatives(fn)`` installs a callback idx -> list of hard
    negative ids (the mining hook, ``train/mining.py``).
    """

    def __init__(
        self,
        tuples: TrainingTuples,
        cfg: DataConfig,
        batch_size: int,
        seed: int = 0,
        augment: bool = True,
    ):
        self.tuples = tuples
        self.cfg = cfg
        self.batch_size = batch_size
        self.seed = seed
        self.augment = augment
        self._hard_neg_fn = None
        self._stop = threading.Event()

    def set_hard_negatives(self, fn) -> None:
        self._hard_neg_fn = fn

    def stop(self) -> None:
        self._stop.set()

    def epoch(self, epoch_idx: int = 0, skip_batches: int = 0) -> Iterator[dict]:
        """One pass over shuffled tuple indices, pool-assembled + prefetched.

        ``skip_batches`` fast-forwards past the first N emitted batches
        WITHOUT file IO (mid-epoch resume): batch composition depends only
        on tuple METADATA (the get_query_tuple usability predicate) and the
        augmentation rng consumes draws whose count depends only on shapes,
        so replaying zero-filled batches through the real ``_augment`` keeps
        the resumed stream bit-identical to a full replay, without
        re-loading every already-consumed cloud. The number actually
        skipped is left in ``self.skipped_batches``.
        """
        # stop() only cancels the CURRENT epoch: a fresh epoch (e.g. train()
        # called again after a preemption checkpoint) starts unpoisoned
        self._stop = threading.Event()
        rng = np.random.default_rng((self.seed, epoch_idx))
        order = rng.permutation(len(self.tuples.queries))
        crng = np.random.default_rng((self.seed, epoch_idx, 2))
        self.skipped_batches = 0
        if skip_batches > 0:
            order = self._fast_forward(order, skip_batches, crng)
        q: queue.Queue = queue.Queue(maxsize=self.cfg.prefetch_depth)
        stop = self._stop
        n_workers = max(1, self.cfg.loader_threads)

        def assemble(idx: int):
            # per-tuple RNG stream -> result independent of pool scheduling
            trng = np.random.default_rng((self.seed, epoch_idx, 1, idx))
            hard = self._hard_neg_fn(idx) if self._hard_neg_fn else None
            return get_query_tuple(self.tuples, idx, self.cfg, trng, hard)

        def put_checked(item) -> bool:
            # bounded put that honours stop() even when the queue is full
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=n_workers) as ex:
                    inflight = collections.deque()
                    batch = []
                    it = iter(order)
                    exhausted = False
                    while not stop.is_set():
                        while not exhausted and len(inflight) < 2 * n_workers:
                            try:
                                inflight.append(ex.submit(assemble, int(next(it))))
                            except StopIteration:
                                exhausted = True
                        if not inflight:
                            break
                        t = inflight.popleft().result()
                        if t is None:
                            continue
                        batch.append(t)
                        if len(batch) == self.batch_size:
                            if not put_checked(self._collate(batch, crng)):
                                return
                            batch = []
            except BaseException as e:  # surface worker errors to the consumer
                put_checked(e)
            finally:
                if stop.is_set():
                    try:
                        q.put_nowait(None)
                    except queue.Full:
                        pass  # consumer already gone
                else:
                    q.put(None)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # Any abnormal consumer exit (a dispatch raising mid-epoch, the
            # generator being dropped) lands here via GeneratorExit: without
            # it the producer spins in put_checked (stop never set) or
            # blocks forever in the final q.put(None) on a full queue —
            # leaking a thread + prefetch_depth batches per failed epoch.
            stop.set()
            while True:  # unblock a producer stuck in a full-queue put
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            th.join(timeout=10)

    def _fast_forward(self, order, skip_batches: int, crng) -> "np.ndarray":
        """Advance ``order``/``crng`` past ``skip_batches`` emitted batches
        using metadata only (see epoch()). Usability mirrors
        get_query_tuple's early-return predicate exactly: enough positives
        and a nonempty negative pool."""
        cfg = self.cfg
        dummies = None
        usable = 0
        consumed = len(order)
        for pos, idx in enumerate(order):
            e = self.tuples.queries[int(idx)]
            if len(e["positives"]) < cfg.num_positives or len(e["negatives"]) == 0:
                continue
            usable += 1
            if usable < self.batch_size:
                continue
            usable = 0
            self.skipped_batches += 1
            if self.augment:
                # consume crng EXACTLY as _collate would: run the real
                # _augment on zero batches of the real shapes (draw counts
                # depend only on shapes, so this cannot drift from the
                # augmentation implementation)
                if dummies is None:
                    n, b = cfg.num_points, self.batch_size
                    dummies = [
                        np.zeros((b, n, 3), np.float32),
                        np.zeros((b, cfg.num_positives, n, 3), np.float32),
                        np.zeros((b, cfg.num_negatives, n, 3), np.float32),
                    ] + ([np.zeros((b, n, 3), np.float32)]
                         if cfg.use_other_neg else [])
                for d in dummies:
                    _augment(d, cfg, crng)
            if self.skipped_batches == skip_batches:
                consumed = pos + 1
                break
        return order[consumed:]

    def _collate(self, batch: list, rng: np.random.Generator) -> dict:
        out = {
            "query": np.stack([b["query"] for b in batch]),
            "positives": np.stack([b["positives"] for b in batch]),
            "negatives": np.stack([b["negatives"] for b in batch]),
            "ids": [b["ids"] for b in batch],
        }
        if "other_neg" in batch[0]:
            out["other_neg"] = np.stack([b["other_neg"] for b in batch])
        if self.augment:
            for k in ("query", "positives", "negatives", "other_neg"):
                if k in out:
                    out[k] = _augment(out[k], self.cfg, rng)
        return out
