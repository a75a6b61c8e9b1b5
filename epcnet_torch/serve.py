"""Descriptor serving: an online place-recognition index (twin of
``epcnet_tpu/serve.py``, single device).

  service = PlaceIndex.from_export("log/export")       # weights + config
  service.add(points_batch, metadata...)               # extend the DB
  ids, dists = service.query(points_batch, k=25)       # embed + retrieve
  service.save(path) / service.load_db(path)           # persistence

  sched = QueryScheduler(service, k=25)                # concurrent serving
  ids, dists = sched.submit(points_one_submap).result()

Embedding runs the model at a fixed batch (``embed_batch``, padded tail);
retrieval is the exact fp32 top-k of ``ops/retrieval.py``. The device DB is
append-only and grows by doubling, its filler rows far away (1e6 in fp32;
int8 127 with scale 1e6), so ids stay valid and the tail never wins.
``quantize="int8"`` stores the device DB int8 + per-row scale; the host DB
stays the fp32 master, so save/load are lossless.

Not ported yet: ``sync_mode="background"`` (ROADMAP item 5) and a ``mesh``
for sharded retrieval (ROADMAP item 6). ``warm_on_grow`` has no counterpart:
eager PyTorch compiles nothing per DB capacity, so a capacity growth costs
no compile to hide.

Concurrency: a lock guards the host bookkeeping; device work runs outside
it on immutable snapshots (the device append is functional: a grown or
appended buffer is a new tensor, never written in place under a reader).
"""

from __future__ import annotations

import collections
import os
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Sequence

import numpy as np
import torch

from epcnet_torch.device import resolve_device
from epcnet_torch.ops.retrieval import (
    quantize_descriptors,
    topk_neighbors,
    topk_neighbors_quantized,
)
from epcnet_torch.train.step import build_embed_fn
from epcnet_torch.weights import load_export


def _pad_rows(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Zero-pad the leading axis up to the next ``multiple`` (the fixed
    batch shapes every query/embed path shares)."""
    pad = (-arr.shape[0]) % multiple
    if not pad:
        return arr
    return np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])


class PlaceIndex:
    def __init__(
        self,
        embed_fn: Callable[[torch.Tensor], torch.Tensor] | None,
        descriptor_dim: int = 256,
        embed_batch: int = 32,
        block_rows: int = 4096,
        mesh=None,
        quantize: str = "none",
        max_k: int = 25,
        num_points: int | None = None,
        sync_mode: str = "blocking",
        sync_chunk_rows: int | None = None,
        device: str | torch.device | None = None,
    ):
        """``embed_fn`` maps a [B, N, 3] tensor on ``device`` to [B, dim]
        descriptors there (``train.step.build_embed_fn``), or is None for a
        descriptor-only index. ``device`` is the card unless ``"cpu"``."""
        if quantize not in ("none", "int8"):
            raise ValueError(f"quantize={quantize!r} not in {{'none', 'int8'}}")
        if sync_mode not in ("blocking", "background"):
            raise ValueError(
                f"sync_mode={sync_mode!r} not in {{'blocking', 'background'}}"
            )
        if sync_mode == "background":
            raise NotImplementedError(
                "sync_mode='background' is not ported yet (ROADMAP item 5, Serving)"
            )
        if mesh is not None:
            raise NotImplementedError(
                "a mesh (sharded retrieval) is not ported yet (ROADMAP item 6, "
                "Multi-device)"
            )
        self.device = resolve_device(device)
        self.sync_mode = sync_mode
        self.num_points = num_points
        # max_k bounds the fused path's top-k: it always retrieves
        # min(max_k, capacity) rows and the request's k trims on host, the
        # same policy as the JAX index (there it bounds compiled programs)
        self.max_k = max_k
        self._embed = embed_fn
        self.dim = descriptor_dim
        self.embed_batch = embed_batch
        self.block_rows = block_rows
        # one sync step moves at most this many rows, a block multiple
        chunk = sync_chunk_rows or 8 * block_rows
        self.sync_chunk_rows = max(block_rows, -(-chunk // block_rows) * block_rows)
        self.quantize = quantize
        self._db = np.zeros((0, descriptor_dim), np.float32)
        self._meta: list = []
        self._dev_db = None  # [capacity, dim] device tensor, far-padded tail
        self._dev_scale = None  # [capacity, 1] fp32 row scales (int8 mode)
        self._dev_rows = 0  # rows of _db already resident on device
        self._lock = threading.RLock()  # guards _db/_meta/_dev_* bookkeeping
        # serializes device-sync work, which runs outside _lock; lock order
        # is always _sync_lock -> _lock
        self._sync_lock = threading.Lock()
        self._counters = {"adds": 0, "rows_added": 0, "queries": 0,
                          "query_rows": 0, "dev_syncs": 0}

    # ------------------------------------------------------------------
    @classmethod
    def from_export(
        cls, basename: str, embed_batch: int = 32, quantize: str = "none",
        max_k: int = 25, sync_mode: str = "blocking",
        sync_chunk_rows: int | None = None,
        device: str | torch.device | None = None,
    ) -> "PlaceIndex":
        """An index over the model in ``<basename>.npz/.json`` as written by
        ``epcnet_tpu/cli/export.py`` (the counterpart of the JAX
        ``from_checkpoint``: Orbax checkpoints are not readable without
        JAX)."""
        cfg, flat = load_export(basename)
        embed = build_embed_fn(cfg.model, device, variables=flat)
        return cls(embed, cfg.model.output_dim, embed_batch, quantize=quantize,
                   max_k=max_k, num_points=cfg.data.num_points,
                   sync_mode=sync_mode, sync_chunk_rows=sync_chunk_rows,
                   device=device)

    # ------------------------------------------------------------------
    def _embed_padded(self, points: np.ndarray) -> torch.Tensor:
        """Descriptors of up to ``embed_batch`` submaps, on the device, for
        the batch padded to ``embed_batch``."""
        pts = torch.from_numpy(_pad_rows(np.asarray(points, np.float32),
                                         self.embed_batch))
        return self._embed(pts.to(self.device))

    def embed(self, points: np.ndarray) -> np.ndarray:
        """[B, N, 3] -> [B, dim] descriptors, in fixed ``embed_batch`` chunks
        (padded tail)."""
        n = points.shape[0]
        out = np.zeros((n, self.dim), np.float32)
        bs = self.embed_batch
        for s in range(0, n, bs):
            chunk = points[s: s + bs]
            out[s: s + len(chunk)] = self._embed_padded(chunk).cpu().numpy()[: len(chunk)]
        return out

    def add(self, points: np.ndarray, metadata: Sequence | None = None) -> None:
        self.add_descriptors(self.embed(points), metadata)

    def add_descriptors(self, desc: np.ndarray, metadata: Sequence | None = None) -> None:
        if metadata is not None and len(metadata) != len(desc):
            # a silent mismatch would skew id->metadata for every later query
            raise ValueError(
                f"metadata length {len(metadata)} != batch size {len(desc)}"
            )
        with self._lock:
            self._db = np.concatenate([self._db, np.asarray(desc, np.float32)], axis=0)
            self._meta.extend(metadata if metadata is not None else [None] * len(desc))
            self._counters["adds"] += 1
            self._counters["rows_added"] += len(desc)
        # the device sync is lazy (next query): adds stay cheap, bursts coalesce

    def __len__(self) -> int:
        with self._lock:
            return len(self._db)

    # ------------------------------------------------------------------
    def query(self, points: np.ndarray, k: int = 25):
        """Embed + retrieve. Returns (ids [B, k] int32, sqdists [B, k]).

        Batches up to ``embed_batch`` with k <= max_k take the fused path:
        the descriptors go straight from the model into the top-k on the
        device, with no host round trip. Larger batches go
        embed-then-retrieve."""
        n = points.shape[0]
        if self._embed is not None and 0 < n <= self.embed_batch and k <= self.max_k:
            dbj, scj, kk = self._snapshot_db(n, k)
            # top-k = min(max_k, capacity): the capacity tail is far-padded,
            # so the first len(db) results are real and the host trim to
            # kk <= len(db) is exact
            k_fused = min(self.max_k, int(dbj.shape[0]))
            with torch.inference_mode():
                desc = self._embed_padded(points)
                idx, dist = self._retrieve(desc, dbj, scj, k_fused)
            return idx.cpu().numpy()[:n, :kk], dist.cpu().numpy()[:n, :kk]
        return self.query_descriptors(self.embed(points), k)

    def _snapshot_db(self, n_query_rows: int, k: int):
        """Consistent (dev_db, scale, clamped-k) snapshot after a full sync
        (read-your-writes). The one place for the empty check, the k clamp
        and the query counters."""
        with self._lock:
            if len(self._db) == 0:
                raise ValueError("empty index")
            if k < 1:
                raise ValueError(f"k={k} must be >= 1")
        self._ensure_synced()
        with self._lock:
            kk = min(k, self._dev_rows)
            self._counters["queries"] += 1
            self._counters["query_rows"] += n_query_rows
            return self._dev_db, self._dev_scale, kk

    def query_descriptors(self, desc: np.ndarray, k: int = 25):
        dbj, scj, kk = self._snapshot_db(desc.shape[0], k)
        n = desc.shape[0]
        # the query batch is padded to an embed_batch multiple (fixed shapes)
        q = torch.from_numpy(_pad_rows(np.asarray(desc, np.float32),
                                       self.embed_batch)).to(self.device)
        # capacity-keyed top-k for k <= max_k, as on the fused path
        k_prog = min(self.max_k, int(dbj.shape[0])) if k <= self.max_k else kk
        with torch.inference_mode():
            idx, dist = self._retrieve(q, dbj, scj, k_prog)
        return idx.cpu().numpy()[:n, :kk], dist.cpu().numpy()[:n, :kk]

    def _retrieve(self, q: torch.Tensor, dbj, scj, k_prog: int):
        """The one dispatch point for descriptor retrieval (int8 vs fp32),
        shared by both query paths and warmup."""
        if self.quantize == "int8":
            return topk_neighbors_quantized(q, dbj, scj, k_prog)
        return topk_neighbors(q, dbj, k_prog)

    def _ensure_synced(self) -> None:
        """Bring the device DB up to date, one sync_chunk_rows chunk at a
        time; only the querying caller waits."""
        while True:
            with self._sync_lock:
                backlog = self._sync_chunk()
            if backlog <= 0:
                return

    def _sync_chunk(self) -> int:
        """Advance the device DB by at most sync_chunk_rows rows; returns the
        remaining backlog. Caller holds _sync_lock. The host DB is
        append-only and the device buffers are replaced, never written in
        place, so a query running on an older snapshot stays consistent."""
        with self._lock:
            db_ref = self._db  # append-only: this array object never mutates
            n = len(db_ref)
            dev_db, dev_scale, dev_rows = self._dev_db, self._dev_scale, self._dev_rows
        if n == 0 or (dev_rows == n and dev_db is not None):
            return 0
        cap = 0 if dev_db is None else dev_db.shape[0]
        # this chunk's rows, rounded up to a block multiple (1e6 filler rows
        # in the rounding tail are overwritten by a later sync)
        start = (dev_rows // self.block_rows) * self.block_rows
        end = min(n, start + self.sync_chunk_rows)
        rows = -(-end // self.block_rows) * self.block_rows
        upd = np.full((rows - start, self.dim), 1e6, np.float32)
        upd[: end - start] = db_ref[start:end]
        upd = torch.from_numpy(upd).to(self.device)
        quant = self.quantize == "int8"
        new_cap = max(self.block_rows, cap)
        while new_cap < rows:
            new_cap *= 2
        # a new buffer every sync (functional append); growth doubles
        db = torch.full((new_cap, self.dim), 127 if quant else 1e6,
                        dtype=torch.int8 if quant else torch.float32,
                        device=self.device)
        if dev_db is not None:
            db[:cap] = dev_db
        if quant:
            scale = torch.full((new_cap, 1), 1e6, dtype=torch.float32,
                               device=self.device)
            if dev_scale is not None:
                scale[:cap] = dev_scale
            db[start:rows], scale[start:rows] = quantize_descriptors(upd)
        else:
            scale = None
            db[start:rows] = upd
        with self._lock:
            self._dev_db, self._dev_scale = db, scale
            self._dev_rows = end
            self._counters["dev_syncs"] += 1
            return len(self._db) - end

    def warmup(self, num_points: int | None = None) -> None:
        """Build the kernels and run one padded query before traffic: the
        embed at ``embed_batch`` x ``num_points`` and the query path against
        the synced DB (or a far-padded dummy block when the index is empty,
        without touching index state or metrics)."""
        num_points = num_points or self.num_points
        if num_points is None and self._embed is not None:
            raise ValueError(
                "warmup needs num_points (pass it, or construct the index "
                "with num_points=...)"
            )
        if len(self) > 0:
            self._ensure_synced()
            with self._lock:
                dbj, scj = self._dev_db, self._dev_scale
        else:
            quant = self.quantize == "int8"
            dbj = torch.full((self.block_rows, self.dim), 127 if quant else 1e6,
                             dtype=torch.int8 if quant else torch.float32,
                             device=self.device)
            scj = (torch.full((self.block_rows, 1), 1e6, device=self.device)
                   if quant else None)
        k = min(self.max_k, int(dbj.shape[0]))
        with torch.inference_mode():
            if self._embed is not None:
                q = self._embed_padded(np.zeros((1, num_points, 3), np.float32))
            else:
                q = torch.zeros((self.embed_batch, self.dim), device=self.device)
            idx, _ = self._retrieve(q, dbj, scj, k)
        idx.cpu()  # waits for the device

    def metrics(self) -> dict:
        """Operational gauges + counters for monitoring."""
        with self._lock:
            cap = 0 if self._dev_db is None else int(self._dev_db.shape[0])
            dev_bytes = 0
            if self._dev_db is not None:
                dev_bytes = self._dev_db.numel() * self._dev_db.element_size()
                if self._dev_scale is not None:
                    dev_bytes += self._dev_scale.numel() * 4
            return {
                "size": len(self._db),
                "dim": self.dim,
                "quantize": self.quantize,
                "sharded": False,
                "sync_mode": self.sync_mode,
                "device_rows_capacity": cap,
                "device_bytes": int(dev_bytes),
                "device_synced_rows": self._dev_rows,
                "sync_backlog_rows": len(self._db) - self._dev_rows,
                **self._counters,
            }

    def metadata(self, ids) -> list:
        # append-only DB: ids from any earlier query remain valid
        with self._lock:
            return [self._meta[int(i)] for i in np.asarray(ids).ravel()]

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        """The JAX index's format: one .npz with ``db`` (fp32) and ``meta``
        (1-D object array)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with self._lock:
            db, meta = self._db, list(self._meta)
        meta_arr = np.empty(len(meta), dtype=object)
        meta_arr[:] = meta
        # a file object, so that savez does not append ".npz" to the path
        with open(path, "wb") as f:
            np.savez_compressed(f, db=db, meta=meta_arr)

    def load_db(self, path: str) -> None:
        if not os.path.isfile(path) and os.path.isfile(path + ".npz"):
            path += ".npz"
        with np.load(path, allow_pickle=True) as data:
            db, meta = data["db"], data["meta"]
        if db.ndim != 2 or db.shape[1] != self.dim:
            raise ValueError(
                f"{path}: db shape {db.shape} does not match this index's "
                f"descriptor_dim={self.dim} (saved from a different model?)"
            )
        if meta.ndim > 1:  # legacy 2-D object saves: restore row entries
            meta = [list(row) for row in meta]
        with self._sync_lock:
            with self._lock:
                self._db = db.astype(np.float32)
                self._meta = list(meta)
                self._dev_db = None  # full reload: the next query re-syncs
                self._dev_scale = None
                self._dev_rows = 0


def _resolve_future(setter, value) -> None:
    """Resolve a caller's Future without killing the worker: a cancelled
    future raises InvalidStateError, and the other callers of the
    micro-batch must still get their answers."""
    try:
        setter(value)
    except InvalidStateError:
        pass


class QueryScheduler:
    """Dynamic micro-batching front-end for concurrent queries.

    Callers submit ONE submap each and get a Future; a single worker thread
    aggregates up to ``max_batch`` pending requests within ``max_wait_ms``
    and serves them as one padded device batch.
    """

    def __init__(self, index: PlaceIndex, k: int = 25,
                 max_batch: int | None = None, max_wait_ms: float = 2.0):
        self.index = index
        self.k = k
        self.max_batch = max_batch or index.embed_batch
        self._max_wait = max_wait_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        # written by the worker only; _lat_lock guards the deque, which
        # metrics() iterates
        self._counters = {"requests": 0, "dispatches": 0, "errors": 0}
        self._recent_lat = collections.deque(maxlen=1024)
        self._lat_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, points: np.ndarray) -> Future:
        """points: [N, 3] one submap -> Future of (ids [k], sqdists [k])."""
        if self._stop.is_set():
            raise RuntimeError("scheduler stopped")
        fut: Future = Future()
        self._q.put((np.asarray(points), fut, time.perf_counter()))
        return fut

    def _run(self):
        while not self._stop.is_set():
            try:
                batch = [self._q.get(timeout=0.1)]
            except queue.Empty:
                continue
            deadline = time.perf_counter() + self._max_wait
            while len(batch) < self.max_batch:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            # group by shape: one odd-sized request must not poison the
            # other callers' micro-batch
            groups: dict = {}
            for pts, fut, t0 in batch:
                groups.setdefault(getattr(pts, "shape", None), []).append((pts, fut, t0))
            for group in groups.values():
                self._counters["dispatches"] += 1
                self._counters["requests"] += len(group)
                try:
                    pts = np.stack([g[0] for g in group])
                    ids, dists = self.index.query(pts, self.k)
                    done = time.perf_counter()
                    for i, (_, fut, t0) in enumerate(group):
                        with self._lat_lock:
                            self._recent_lat.append(done - t0)
                        _resolve_future(fut.set_result, (ids[i], dists[i]))
                except Exception as e:  # propagate to this group's callers only
                    self._counters["errors"] += len(group)
                    for _, fut, _t0 in group:
                        _resolve_future(fut.set_exception, e)

    def metrics(self) -> dict:
        """Counters + recent-window latency percentiles."""
        c = dict(self._counters)
        with self._lat_lock:
            lat = sorted(self._recent_lat)
        if lat:
            c["latency_recent_n"] = len(lat)
            c["latency_p50_ms"] = lat[len(lat) // 2] * 1e3
            c["latency_p99_ms"] = lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3
        c["avg_batch"] = c["requests"] / c["dispatches"] if c["dispatches"] else 0.0
        c["queue_depth"] = self._q.qsize()
        return c

    def stop(self) -> None:
        self._stop.set()
        self._worker.join(timeout=5)
        # drain: queued requests would otherwise hold futures that never
        # resolve
        while True:
            try:
                _, fut, _t0 = self._q.get_nowait()
            except queue.Empty:
                break
            _resolve_future(fut.set_exception, RuntimeError("scheduler stopped"))
