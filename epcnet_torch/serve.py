"""Descriptor serving: an online place-recognition index (twin of
``epcnet_tpu/serve.py``).

  service = PlaceIndex.from_checkpoint(log_dir)        # a port training run
  service = PlaceIndex.from_export("log/export")       # or an export pair
  service.add(points_batch, metadata...)               # extend the DB
  ids, dists = service.query(points_batch, k=25)       # embed + retrieve
  service.save(path) / service.load_db(path)           # persistence

  sched = QueryScheduler(service, k=25)                # concurrent serving
  ids, dists = sched.submit(points_one_submap).result()

Embedding runs the model at a fixed batch (``embed_batch``, padded tail);
retrieval is the exact fp32 top-k of ``ops/retrieval.py``, a block of rows
at a time, over the synced prefix of the device DB (``n_valid``). The
device DB is append-only and grows by doubling (filler rows 1e6 in fp32;
int8 127 with scale 1e6), so ids stay valid. ``quantize="int8"`` stores
the device DB int8 + per-row scale; the host DB stays the fp32 master, so
save/load are lossless.

``sync_mode`` says when added rows become query-visible. ``"blocking"``:
read-your-writes, a query first syncs every row added before it.
``"background"``: adds kick a daemon thread that syncs in
``sync_chunk_rows`` chunks, and a query runs at once against the resident
consistent prefix (the first query waits for the first chunk); ``flush()``
gives read-your-writes on demand, and a sync failure surfaces on the next
query or ``flush()``.

On the card every sync runs on a CUDA stream of its own, one for each
device that holds a shard: the chunk goes from a pinned staging buffer
(``non_blocking``) into the device buffers, and an event recorded on each
side stream after it is installed with the buffers. A query makes its
stream on each device wait on that device's event before it reads the
buffers, and marks each buffer as used on its stream (``record_stream``),
so the caching allocator does not hand the memory out while the query
still reads it (a buffer replaced at a capacity growth). A large chunk
thus never stalls the default streams that queries run on.

With a ``mesh`` (a ``parallel.Mesh``) whose "db" axis is above 1 the
device DB is sharded over that axis's devices: global row r lives on shard
r % ndev at local row r // ndev, so the capacity (in rows) is a multiple of
the shard count and each shard grows in place, by doubling, on its own
device; a chunk of rows goes to the shards that own them; a query retrieves
on every shard and merges the candidates on the first device
(``ops/retrieval.py::topk_over_shards``); ``warmup`` runs the sharded
retrieval. The staged chunk is laid out shard by shard, so each shard's
rows go to its device in one contiguous copy. ``warm_on_grow`` has no counterpart: eager PyTorch
compiles nothing per DB capacity, so a capacity growth costs no compile to
hide.

Concurrency: a lock guards the host bookkeeping; device work runs outside
it on snapshots (buffer, synced rows P, event). A chunk is written in place
past the synced prefix, rows no snapshot reads: a query's retrieval takes
only rows below its P as candidates, so rows being written past it are
never seen, and rows below P are never written again. Only a capacity
growth copies the prefix into a new buffer. (The JAX index appends
functionally, a new buffer a chunk: at 2^21 fp32 rows a 32,768-row chunk
(32 MB) would fill, read and write 6 GB of device memory, and allocate
2 GB.) The host master is a list of fixed-size segments
(``HOST_SEGMENT_ROWS``), which adds write outside that lock (one add at a
time): an add costs its own rows, and no add copies the whole DB, as the
add that grows a buffer grown by doubling would (at 10^6 fp32 rows a 1 GB
copy into 2 GB of fresh pages, which held queries running beside it for
tens of milliseconds on an H100 host).
"""

from __future__ import annotations

import collections
import contextlib
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
    topk_over_shards,
)
from epcnet_torch.train.checkpoint import read_run_config, restore_model
from epcnet_torch.train.step import build_embed_fn
from epcnet_torch.weights import flat_variables, load_export

# rows of one host segment (64 MB at dim 256); a full segment is never
# copied again
HOST_SEGMENT_ROWS = 1 << 16

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
        descriptor-only index. ``device`` is the card unless ``"cpu"``.
        ``mesh``: a ``parallel.Mesh``; with a "db" axis above 1 the device
        DB is sharded over its devices, and queries run on the first."""
        if quantize not in ("none", "int8"):
            raise ValueError(f"quantize={quantize!r} not in {{'none', 'int8'}}")
        if sync_mode not in ("blocking", "background"):
            raise ValueError(
                f"sync_mode={sync_mode!r} not in {{'blocking', 'background'}}"
            )
        sharded = mesh is not None and mesh.shape.get("db", 1) > 1
        self.device = resolve_device(mesh.devices("db")[0] if sharded else device)
        # the devices of the DB's shards (one: unsharded)
        self._shards = mesh.devices("db") if sharded else [self.device]
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
        # host fp32 master: rows [:_n] of segments of HOST_SEGMENT_ROWS rows,
        # the last partly filled; an add replaces the list, never mutates it
        self._segs: list[np.ndarray] = []
        self._n = 0
        self._meta: list = []
        # a [capacity / ndev, dim] tensor a shard, far-padded tails
        self._dev_db: list | None = None
        self._dev_scale: list | None = None  # [capacity / ndev, 1] fp32 row scales (int8)
        self._dev_rows = 0  # host rows already resident on the device
        self._dev_ready = None  # CUDA events (one a side stream) after which _dev_* are written
        # the sync's side stream of each device that holds a shard (card)
        self._streams = ({dev: torch.cuda.Stream(dev) for dev in self._shards}
                         if self.device.type == "cuda" else {})
        self._staging = None  # pinned host rows of one chunk (card)
        self._add_lock = threading.Lock()  # one add at a time writes the host master
        self._lock = threading.RLock()  # guards _segs/_n/_meta/_dev_* bookkeeping
        # serializes device-sync work, which runs outside _lock; lock order
        # is always _add_lock -> _sync_lock -> _lock
        self._sync_lock = threading.Lock()
        self._sync_cv = threading.Condition(self._lock)  # _dev_rows progress
        self._sync_thread = None  # background worker (sync_mode="background")
        self._sync_error: BaseException | None = None
        self._counters = {"adds": 0, "rows_added": 0, "queries": 0,
                          "query_rows": 0, "dev_syncs": 0}

    # ------------------------------------------------------------------
    @classmethod
    def from_export(
        cls, basename: str, embed_batch: int = 32, quantize: str = "none",
        max_k: int = 25, sync_mode: str = "blocking",
        sync_chunk_rows: int | None = None,
        device: str | torch.device | None = None, mesh=None,
    ) -> "PlaceIndex":
        """An index over the model in ``<basename>.npz/.json`` as written by
        ``epcnet_tpu/cli/export.py`` or ``weights.save_export``: how weights
        the JAX package trained reach the port; ``mesh`` shards the device
        DB."""
        cfg, flat = load_export(basename)
        dev = resolve_device(mesh.devices("db")[0] if mesh is not None else device)
        embed = build_embed_fn(cfg.model, dev, variables=flat)
        return cls(embed, cfg.model.output_dim, embed_batch, mesh=mesh, quantize=quantize,
                   max_k=max_k, num_points=cfg.data.num_points,
                   sync_mode=sync_mode, sync_chunk_rows=sync_chunk_rows,
                   device=dev)

    @classmethod
    def from_checkpoint(
        cls, log_dir: str, mesh=None, embed_batch: int = 32,
        quantize: str = "none", max_k: int = 25, sync_mode: str = "blocking",
        sync_chunk_rows: int | None = None,
        device: str | torch.device | None = None,
    ) -> "PlaceIndex":
        """An index over the latest port checkpoint of a run
        (``<log_dir>/ckpt``, ``train/checkpoint.py``; ``FileNotFoundError``
        where there is none), with ``<log_dir>/config.json`` (the defaults
        where it is absent); ``mesh`` shards the device DB."""
        dev = resolve_device(mesh.devices("db")[0] if mesh is not None else device)
        cfg = read_run_config(log_dir)
        model, _ = restore_model(log_dir, cfg)
        embed = build_embed_fn(cfg.model, dev, variables=flat_variables(model))
        return cls(embed, cfg.model.output_dim, embed_batch, mesh=mesh, quantize=quantize,
                   max_k=max_k, num_points=cfg.data.num_points,
                   sync_mode=sync_mode, sync_chunk_rows=sync_chunk_rows,
                   device=dev)

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
        desc = np.asarray(desc, np.float32)
        if desc.ndim != 2 or desc.shape[1] != self.dim:
            raise ValueError(f"descriptors of shape {desc.shape}; this index takes "
                             f"[n, {self.dim}]")
        if metadata is not None and len(metadata) != len(desc):
            # a silent mismatch would skew id->metadata for every later query
            raise ValueError(
                f"metadata length {len(metadata)} != batch size {len(desc)}"
            )
        with self._add_lock:
            with self._lock:
                n, segs = self._n, list(self._segs)
            m = len(desc)
            # outside _lock: readers take only rows [:n], which the new rows
            # do not touch
            _write_rows(segs, n, desc)
            with self._lock:
                self._segs, self._n = segs, n + m
                self._meta.extend(metadata if metadata is not None else [None] * m)
                self._counters["adds"] += 1
                self._counters["rows_added"] += m
        # "blocking": the device sync is lazy (next query), so adds stay cheap
        # and bursts coalesce; "background": start syncing now
        if self.sync_mode == "background":
            self._kick_background_sync()

    def __len__(self) -> int:
        with self._lock:
            return self._n

    @property
    def _db(self) -> np.ndarray:
        """The host master as one [n, dim] fp32 array (a copy where it spans
        segments): what ``save`` writes."""
        with self._lock:
            segs, n = self._segs, self._n
        return _rows(segs, 0, n, self.dim)

    # ------------------------------------------------------------------
    def query(self, points: np.ndarray, k: int = 25):
        """Embed + retrieve. Returns (ids [B, k] int32, sqdists [B, k]).

        Batches up to ``embed_batch`` with k <= max_k take the fused path:
        the descriptors go straight from the model into the top-k on the
        device, with no host round trip. Larger batches go
        embed-then-retrieve."""
        n = points.shape[0]
        if self._embed is not None and 0 < n <= self.embed_batch and k <= self.max_k:
            dbj, scj, kk, rows = self._snapshot_db(n, k)
            # top-k = min(max_k, capacity) over the synced prefix: its first
            # kk <= rows results are real, so the host trim is exact
            k_fused = min(self.max_k, _capacity(dbj))
            with torch.inference_mode():
                desc = self._embed_padded(points)
                idx, dist = self._retrieve(desc, dbj, scj, k_fused, rows)
            return idx.cpu().numpy()[:n, :kk], dist.cpu().numpy()[:n, :kk]
        return self.query_descriptors(self.embed(points), k)

    def _snapshot_db(self, n_query_rows: int, k: int):
        """Consistent (dev_db, scale, clamped-k, synced rows) snapshot, ready
        to read on the caller's stream. The one place for the empty check, the k
        clamp, the sync policy and the query counters.

        "blocking": after a full sync (read-your-writes). "background": at
        once, against the resident prefix (the first query ever waits for
        chunk one)."""
        with self._lock:
            if self._n == 0:
                raise ValueError("empty index")
            if k < 1:
                raise ValueError(f"k={k} must be >= 1")
        if self.sync_mode == "blocking":
            self._ensure_synced()
        else:
            self._kick_background_sync()
        with self._lock:
            while self._dev_rows == 0 or self._dev_db is None:
                # nothing resident yet: the first chunk is the least a query
                # can run against (one sync_chunk_rows transfer, not the backlog)
                self._raise_sync_error()
                self._sync_cv.wait(timeout=1.0)
            self._raise_sync_error()
            # clamp to the visible prefix: the far-padded tail keeps the
            # top-kk of the prefix exact
            kk = min(k, self._dev_rows)
            self._counters["queries"] += 1
            self._counters["query_rows"] += n_query_rows
            dbj, scj, ready, rows = (self._dev_db, self._dev_scale, self._dev_ready,
                                     self._dev_rows)
        self._await(ready, dbj, scj)
        return dbj, scj, kk, rows

    def _await(self, ready, *tensors) -> None:
        """Order the caller's stream on each shard device after the sync
        that wrote ``tensors`` and keep their memory from reuse until that
        stream is done."""
        if ready is None:
            return
        for dev, event in ready.items():
            torch.cuda.current_stream(dev).wait_event(event)
        for shards in tensors:
            for t in shards or ():
                t.record_stream(torch.cuda.current_stream(t.device))

    def _raise_sync_error(self) -> None:
        """Surface a background-sync failure on the caller's thread (call
        under the lock) instead of losing it in a daemon thread."""
        if self._sync_error is not None:
            err, self._sync_error = self._sync_error, None
            raise RuntimeError("background device sync failed") from err

    def query_descriptors(self, desc: np.ndarray, k: int = 25):
        dbj, scj, kk, rows = self._snapshot_db(desc.shape[0], k)
        n = desc.shape[0]
        # the query batch is padded to an embed_batch multiple (fixed shapes)
        q = torch.from_numpy(_pad_rows(np.asarray(desc, np.float32),
                                       self.embed_batch)).to(self.device)
        # capacity-keyed top-k for k <= max_k, as on the fused path
        k_prog = min(self.max_k, _capacity(dbj)) if k <= self.max_k else kk
        with torch.inference_mode():
            idx, dist = self._retrieve(q, dbj, scj, k_prog, rows)
        return idx.cpu().numpy()[:n, :kk], dist.cpu().numpy()[:n, :kk]

    def _retrieve(self, q: torch.Tensor, dbj, scj, k_prog: int, rows: int):
        """The one dispatch point for descriptor retrieval (sharded vs int8
        vs fp32) over the first ``rows`` rows, shared by both query paths
        and warmup."""
        if len(dbj) > 1:
            nd = len(dbj)
            # shard s holds global rows s, s + nd, ...: ceil((rows - s) / nd) of them
            valid = [max(0, -(-(rows - s) // nd)) for s in range(nd)]
            return topk_over_shards(q, dbj, k_prog, scj, n_valid=valid)
        if self.quantize == "int8":
            return topk_neighbors_quantized(q, dbj[0], scj[0], k_prog, n_valid=rows)
        return topk_neighbors(q, dbj[0], k_prog, n_valid=rows)

    # ------------------------------------------------------------------
    def flush(self) -> None:
        """Block until every row added so far is device-resident: the
        read-your-writes barrier of ``sync_mode="background"`` (a no-op
        after any query in "blocking" mode). Raises a pending sync failure."""
        self._ensure_synced()

    def _ensure_synced(self) -> None:
        """Bring the device DB up to date, one sync_chunk_rows chunk at a
        time; only the calling thread waits."""
        while True:
            with self._sync_lock:
                with self._lock:
                    self._raise_sync_error()
                backlog = self._sync_chunk()
            if backlog <= 0:
                return

    def _kick_background_sync(self) -> None:
        """Start (or reuse) the daemon sync worker. The worker clears
        _sync_thread under the lock only after it sees no backlog, so an add
        racing its exit either finds it alive or starts a fresh one."""
        with self._lock:
            if self._sync_thread is not None:
                return
            if self._dev_rows == self._n and self._dev_db is not None:
                return
            t = threading.Thread(target=self._background_sync_loop,
                                 daemon=True, name="placeindex-sync")
            self._sync_thread = t
        t.start()

    def _background_sync_loop(self) -> None:
        while True:
            try:
                with self._sync_lock:
                    backlog = self._sync_chunk()
            except BaseException as e:  # surfaces on the next query/flush
                with self._lock:
                    self._sync_error = e
                    self._sync_thread = None
                    self._sync_cv.notify_all()
                return
            if backlog <= 0:
                with self._lock:
                    if self._dev_rows == self._n:
                        self._sync_thread = None
                        return
                    # rows landed between the chunk and this check: loop

    def _sync_chunk(self) -> int:
        """Advance the device DB by at most sync_chunk_rows rows; returns the
        remaining backlog. Caller holds _sync_lock. The rows go past the
        synced prefix (no snapshot takes them as candidates), or, at a
        capacity growth, into a new buffer; the install then publishes them."""
        with self._lock:
            segs, n = self._segs, self._n  # rows [:n] never change
            dev_db, dev_scale, start = self._dev_db, self._dev_scale, self._dev_rows
        if n == 0 or (start == n and dev_db is not None):
            return 0
        end = min(n, start + self.sync_chunk_rows)
        capacity = max(self.block_rows * len(self._shards),
                       0 if dev_db is None else _capacity(dev_db))
        while capacity < end:
            capacity *= 2
        upd = self._stage(segs, start, end)
        with contextlib.ExitStack() as on_side:
            for stream in self._streams.values():
                on_side.enter_context(torch.cuda.stream(stream))
            dev_db, dev_scale = self._append_fn(dev_db, dev_scale, upd, start, capacity)
            ready = None
            if self._streams:
                ready = {dev: torch.cuda.Event() for dev in self._streams}
                for dev, event in ready.items():
                    event.record(self._streams[dev])
        with self._lock:
            self._dev_db, self._dev_scale, self._dev_ready = dev_db, dev_scale, ready
            self._dev_rows = end
            self._counters["dev_syncs"] += 1
            self._sync_cv.notify_all()
            backlog = self._n - end
        for event in (ready or {}).values():
            event.synchronize()  # the next chunk reuses the staging buffer
        return backlog

    def _stage(self, segs: list, start: int, end: int) -> torch.Tensor:
        """Host rows [start, end) as one tensor, shard by shard: the rows of
        shard 0 (global row r % ndev == 0) in order, then shard 1's, ...
        (unsharded: the rows as they are). On the card a view of the pinned
        staging buffer, filled piece by piece (a pageable source would make
        the copy synchronous)."""
        nd = len(self._shards)
        if nd == 1:
            parts = _pieces(segs, start, end)
        else:
            rows = _rows(segs, start, end, self.dim)
            parts = [rows[(s - start) % nd::nd] for s in range(nd)]
        if not self._streams:
            return torch.from_numpy(parts[0] if len(parts) == 1 else np.concatenate(parts))
        if self._staging is None:
            self._staging = torch.empty((self.sync_chunk_rows, self.dim),
                                        dtype=torch.float32, pin_memory=True)
        out = self._staging[:end - start]
        at = 0
        for part in parts:
            out[at:at + len(part)].copy_(torch.from_numpy(part))
            at += len(part)
        return out

    def _append(self, db, scale, upd: torch.Tensor, start: int, capacity: int):
        """(db, scale), per shard, with the host rows ``upd`` (``_stage``'s
        shard-by-shard layout) written from global row ``start`` (int8 mode:
        quantized on the device, with their scales): in place when the
        shards hold ``capacity`` rows together, else in new [capacity / ndev,
        dim] buffers, filler past the copied prefix. Global row r is shard r
        % ndev's local row r // ndev."""
        quant = self.quantize == "int8"
        nd, end = len(self._shards), start + upd.shape[0]
        out_db, out_scale, at = [], [], 0
        for s, dev in enumerate(self._shards):
            d = None if db is None else db[s]
            sc = None if scale is None else scale[s]
            lo, hi = -(-(start - s) // nd), -(-(end - s) // nd)  # this shard's local rows
            if d is None or d.shape[0] < capacity // nd:
                grown = torch.full((capacity // nd, self.dim), 127 if quant else 1e6,
                                   dtype=torch.int8 if quant else torch.float32, device=dev)
                grown_sc = (torch.full((capacity // nd, 1), 1e6, dtype=torch.float32,
                                       device=dev) if quant else None)
                if d is not None:
                    grown[:lo] = d[:lo]
                    if quant:
                        grown_sc[:lo] = sc[:lo]
                d, sc = grown, grown_sc
            rows = upd[at:at + hi - lo].to(dev, non_blocking=True)
            at += hi - lo
            if quant:
                d[lo:hi], sc[lo:hi] = quantize_descriptors(rows)
            else:
                d[lo:hi] = rows
            out_db.append(d)
            out_scale.append(sc)
        return out_db, (out_scale if quant else None)

    # the device append: the one seam tests slow down or break (an instance
    # attribute overrides it). A class attribute, not self._append stored on
    # the instance: that bound method would make a reference cycle, so that a
    # dropped index kept its device and host buffers until a collection,
    # which then freed gigabytes inside some unrelated query
    _append_fn = _append

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
            self._ensure_synced()  # full residency before traffic, any mode
            with self._lock:
                dbj, scj, ready, rows = (self._dev_db, self._dev_scale, self._dev_ready,
                                         self._dev_rows)
            self._await(ready, dbj, scj)
        else:
            quant = self.quantize == "int8"
            dbj = [torch.full((self.block_rows, self.dim), 127 if quant else 1e6,
                              dtype=torch.int8 if quant else torch.float32, device=dev)
                   for dev in self._shards]
            scj = ([torch.full((self.block_rows, 1), 1e6, device=dev) for dev in self._shards]
                   if quant else None)
            rows = _capacity(dbj)
        k = min(self.max_k, _capacity(dbj))
        with torch.inference_mode():
            if self._embed is not None:
                q = self._embed_padded(np.zeros((1, num_points, 3), np.float32))
            else:
                q = torch.zeros((self.embed_batch, self.dim), device=self.device)
            idx, _ = self._retrieve(q, dbj, scj, k, rows)
        idx.cpu()  # waits for the device

    def metrics(self) -> dict:
        """Operational gauges + counters for monitoring."""
        with self._lock:
            cap = 0 if self._dev_db is None else _capacity(self._dev_db)
            dev_bytes = sum(t.numel() * t.element_size()
                            for t in (self._dev_db or []) + (self._dev_scale or []))
            return {
                "size": self._n,
                "dim": self.dim,
                "quantize": self.quantize,
                "sharded": len(self._shards) > 1,
                "sync_mode": self.sync_mode,
                "device_rows_capacity": cap,
                "device_bytes": int(dev_bytes),
                "device_synced_rows": self._dev_rows,
                "sync_backlog_rows": self._n - self._dev_rows,
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
        segs: list[np.ndarray] = []
        _write_rows(segs, 0, db)
        # _sync_lock first: a background chunk computed from the old rows
        # must not install after the swap
        with self._add_lock, self._sync_lock, self._lock:
            self._segs, self._n = segs, len(db)
            self._meta = list(meta)
            self._dev_db = None  # full reload: the next query re-syncs
            self._dev_scale = self._dev_ready = None
            self._dev_rows = 0


def _capacity(shards: list) -> int:
    """Rows of a device DB held as per-shard buffers."""
    return sum(int(t.shape[0]) for t in shards)


def _write_rows(segs: list, n: int, rows: np.ndarray) -> None:
    """Write ``rows`` (cast to fp32) as rows [n, n + len(rows)) of a
    segmented host master, appending segments to ``segs`` as needed."""
    i = 0
    while i < len(rows):
        s, off = divmod(n + i, HOST_SEGMENT_ROWS)
        if s == len(segs):
            segs.append(np.empty((HOST_SEGMENT_ROWS, rows.shape[1]), np.float32))
        take = min(HOST_SEGMENT_ROWS - off, len(rows) - i)
        segs[s][off:off + take] = rows[i:i + take]
        i += take


def _pieces(segs: list, start: int, end: int) -> list[np.ndarray]:
    """Rows [start, end) of a segmented host master, as views, one a segment."""
    r = HOST_SEGMENT_ROWS
    return [segs[s][max(start - s * r, 0):min(end - s * r, r)]
            for s in range(start // r, -(-end // r))]


def _rows(segs: list, start: int, end: int, dim: int) -> np.ndarray:
    """Rows [start, end) of a segmented host master: a view within one
    segment, else a copy."""
    pieces = _pieces(segs, start, end)
    if len(pieces) == 1:
        return pieces[0]
    return np.concatenate(pieces) if pieces else np.zeros((0, dim), np.float32)


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
