"""Blocked retrieval (``epcnet_torch/ops/retrieval.py``) against the JAX
package's ``topk_neighbors`` / ``topk_neighbors_quantized`` and against the
port's full-sort plain versions, and the index's chunked and background
device sync (``PlaceIndex``, counterparts of ``tests/test_serve.py``'s
sync tests), on the CPU.

Tolerances: ids exactly; distances within rtol 1e-5 / atol 1e-6 of JAX's in
fp32 and atol 1e-5 in int8 (those of ``tests/test_torch_ops.py``); the
blocked path's distances equal the plain version's bit for bit.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epcnet_tpu.ops import retrieval as jret

from epcnet_torch.ops import retrieval as tret
from epcnet_torch.serve import PlaceIndex


def _unit_rows(rng, n, d=32):
    v = rng.normal(size=(n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _db(seed, n=300, d=32):
    """Unit rows with exact duplicates of row 3 across block boundaries and
    a far-padded tail (the index's filler rows)."""
    rng = np.random.RandomState(seed)
    db = _unit_rows(rng, n, d)
    db[[60, 63, 64, 65, 130, 200]] = db[3]
    db[n - 40:] = 1e6
    q = np.concatenate([db[:5], db[[64]], _unit_rows(rng, 10, d)])
    return db, q


@pytest.mark.parametrize("block", [32, 64, 100, 299, 65536])
@pytest.mark.parametrize("k", [1, 12, 300])
def test_blocked_fp32_matches_jax(block, k):
    db, q = _db(1)
    ids, d = tret.topk_neighbors(torch.tensor(q), torch.tensor(db), k, block_rows=block)
    jids, jd = jret.topk_neighbors(jnp.asarray(q), jnp.asarray(db), k)
    assert ids.dtype == torch.int32 and d.dtype == torch.float32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    pids, pd = tret.topk_neighbors_plain(torch.tensor(q), torch.tensor(db), k)
    np.testing.assert_array_equal(ids.numpy(), pids.numpy())
    np.testing.assert_array_equal(d.numpy(), pd.numpy())
    if k >= 7:  # the duplicates of row 3, lowest index first
        np.testing.assert_array_equal(ids[3, :7].numpy(), [3, 60, 63, 64, 65, 130, 200])
        np.testing.assert_array_equal(ids[5, :7].numpy(), [3, 60, 63, 64, 65, 130, 200])


@pytest.mark.parametrize("block", [32, 100, 65536])
@pytest.mark.parametrize("k", [5, 300])
def test_blocked_int8_matches_jax(block, k):
    db, q = _db(2)
    qi, sc = tret.quantize_descriptors(torch.tensor(db))
    jqi, jsc = jret.quantize_descriptors(jnp.asarray(db))
    ids, d = tret.topk_neighbors_quantized(torch.tensor(q), qi, sc, k, block_rows=block)
    jids, jd = jret.topk_neighbors_quantized(jnp.asarray(q), jqi, jsc, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    pids, pd = tret.topk_neighbors_quantized_plain(torch.tensor(q), qi, sc, k)
    np.testing.assert_array_equal(ids.numpy(), pids.numpy())
    np.testing.assert_array_equal(d.numpy(), pd.numpy())


def test_blocked_selection_ties_and_negative_zero():
    """The selection alone, on a hand-made distance matrix. A -0.0 can
    reach it where torch's ``clamp_min(x, 0.0)`` keeps the sign that JAX's
    ``jnp.maximum(x, 0.0)`` drops, so it must tie with +0.0 (lowest index
    first) as JAX's +0.0 does; equal values across blocks resolve by index."""
    d = np.array([[0.5, 0.0, 0.25, -0.0, 0.5, 0.0, 0.25, 1.0, 0.5, -0.0],
                  [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]], np.float32)
    assert torch.signbit(torch.tensor(d).clamp_min(0.0)).any()
    jd = jnp.maximum(jnp.asarray(d), 0.0)  # JAX's clamp of the distances
    jids = np.asarray(jax.lax.top_k(-jd, 10)[1])
    for block in (1, 3, 4, 10):
        ids, vals = tret.blocked_smallest_k(lambda s, e: torch.tensor(d[:, s:e]), 10, 10, block)
        np.testing.assert_array_equal(ids.numpy(), jids)
        np.testing.assert_array_equal(vals.numpy(), np.take_along_axis(np.asarray(jd), jids, 1))
        assert not torch.signbit(vals).any()
    with pytest.raises(ValueError, match="outside"):
        tret.blocked_smallest_k(lambda s, e: torch.tensor(d[:, s:e]), 10, 11)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_rows_past_n_valid_are_never_candidates(quantize):
    """Rows past ``n_valid`` (an index's unsynced tail, which may be being
    written) are not computed or are masked: the result equals JAX's on
    the first n_valid rows alone, and with fewer candidates than k the
    slots past them hold -1."""
    db, q = _db(4, n=600)
    db[450:] = np.repeat(q[:1], 150, axis=0)  # exact copies of query 0 past n_valid
    db[460] = np.nan
    tdb = torch.tensor(db)
    for n_valid, block in ((450, 64), (450, 65536), (129, 64)):
        if quantize == "int8":
            qi, sc = tret.quantize_descriptors(tdb)
            ids, d = tret.topk_neighbors_quantized(torch.tensor(q), qi, sc, 25, block, n_valid)
            jids, jd = jret.topk_neighbors_quantized(
                jnp.asarray(q), *jret.quantize_descriptors(jnp.asarray(db[:n_valid])), 25)
        else:
            ids, d = tret.topk_neighbors(torch.tensor(q), tdb, 25, block, n_valid)
            jids, jd = jret.topk_neighbors(jnp.asarray(q), jnp.asarray(db[:n_valid]), 25)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    ids, d = tret.topk_neighbors(torch.tensor(q), tdb, 25, 64, n_valid=10)
    assert (ids[:, :10] >= 0).all() and (ids[:, 10:] == -1).all()
    assert torch.isnan(d[:, 10:]).all() and not torch.isnan(d[:, :10]).any()


def test_int8_path_widens_one_block_at_a_time(monkeypatch):
    """The quantized path never widens more than one block of the int8
    DB to fp32 (the capacity contract of the JAX docstring)."""
    db, q = _db(3, n=1024)
    qi, sc = tret.quantize_descriptors(torch.tensor(db))
    widened = []
    to_float = torch.Tensor.float

    def spy(self, *a, **kw):
        if self.dtype == torch.int8:
            widened.append(tuple(self.shape))
        return to_float(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "float", spy)
    tret.topk_neighbors_quantized(torch.tensor(q), qi, sc, 25, block_rows=256)
    assert widened == [(256, 32)] * 4
    widened.clear()
    tret.topk_neighbors_quantized_plain(torch.tensor(q), qi, sc, 25)
    assert widened == [(1024, 32)]  # the plain version widens the whole DB


# ---------------------------------------------------------------------------
# The index's chunked and background device sync


def _desc_index(dim=16, block_rows=32, **kw):
    """Descriptor-only index (no model): sync behaviour does not depend on
    the embed path."""
    return PlaceIndex(None, descriptor_dim=dim, embed_batch=4, block_rows=block_rows,
                      device="cpu", **kw)


@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("sync_mode", ["blocking", "background"])
def test_chunked_sync_matches_oracle(quantize, sync_mode):
    """Many small chunks crossing several capacity doublings agree with a
    float64 top-k over the host master."""
    rng = np.random.RandomState(5)
    idx = _desc_index(sync_chunk_rows=32, quantize=quantize, sync_mode=sync_mode)
    for n in (100, 150, 50):  # 300 rows, 10 chunks, capacities 32 -> 512
        idx.add_descriptors(_unit_rows(rng, n, idx.dim))
        idx.flush()
        q = _unit_rows(rng, 3, idx.dim)
        ids, dists = idx.query_descriptors(q, k=5)
        db = idx._db.astype(np.float64)
        if quantize == "int8":  # the same dequantised rows the device ranks
            scale = np.maximum(np.abs(db).max(1, keepdims=True) / 127.0, 1e-12)
            db = np.clip(np.round(db / scale), -127, 127) * scale
        d2 = ((q.astype(np.float64)[:, None, :] - db[None]) ** 2).sum(-1)
        oracle = np.argsort(d2, axis=1, kind="stable")[:, :5]
        np.testing.assert_array_equal(ids, oracle)
        np.testing.assert_allclose(dists, np.take_along_axis(d2, oracle, axis=1), atol=1e-5)
    assert idx.metrics()["sync_backlog_rows"] == 0
    assert idx._dev_db[0].shape[0] == 512


def test_background_sync_prefix_then_flush():
    """Background mode: a query is answered at once against a consistent
    prefix of at least one chunk; flush() restores read-your-writes."""
    rng = np.random.RandomState(6)
    idx = _desc_index(sync_chunk_rows=32, sync_mode="background")
    d = _unit_rows(rng, 200, idx.dim)
    idx.add_descriptors(d)
    ids, _ = idx.query_descriptors(d[:2], k=1)
    assert ids.shape == (2, 1)
    assert idx.metrics()["device_synced_rows"] >= 32
    idx.flush()
    m = idx.metrics()
    assert m["sync_backlog_rows"] == 0 and m["device_synced_rows"] == 200
    assert m["sync_mode"] == "background"
    ids, dists = idx.query_descriptors(d[-3:], k=1)
    np.testing.assert_array_equal(ids[:, 0], [197, 198, 199])
    assert dists.max() < 1e-6


def test_queries_available_during_slow_sync():
    """With a big backlog mid-transfer, a query completes in about one
    chunk's time, not behind the whole sync."""
    rng = np.random.RandomState(7)
    idx = _desc_index(sync_chunk_rows=32, sync_mode="background")
    delay = 0.15
    append = idx._append_fn

    def slow_append(db, scale, upd, start, capacity):
        time.sleep(delay)  # a slow host->device link, per chunk
        return append(db, scale, upd, start, capacity)

    idx._append_fn = slow_append
    d = _unit_rows(rng, 640, idx.dim)  # 20 chunks: ~3 s of sync
    idx.add_descriptors(d)
    t0 = time.perf_counter()
    ids, _ = idx.query_descriptors(d[:1], k=1)
    dt = time.perf_counter() - t0
    backlog = idx.metrics()["sync_backlog_rows"]
    idx.flush()
    assert backlog > 0, "sync finished too fast to exercise the stall path"
    assert dt < 1.5, f"query stalled {dt:.2f}s behind the bulk sync"
    assert idx.metrics()["sync_backlog_rows"] == 0
    ids, _ = idx.query_descriptors(d[:4], k=1)
    np.testing.assert_array_equal(ids[:, 0], [0, 1, 2, 3])


def test_background_sync_error_surfaces():
    """A failure in the daemon sync thread surfaces on the next query, and
    on flush(), with the cause chained."""
    rng = np.random.RandomState(8)
    for call in ("query", "flush"):
        idx = _desc_index(sync_mode="background")

        def boom(db, scale, upd, start, capacity):
            raise OSError("injected transfer failure")

        idx._append_fn = boom
        idx.add_descriptors(_unit_rows(rng, 10, idx.dim))
        with pytest.raises(RuntimeError, match="background device sync failed") as e:
            if call == "query":
                idx.query_descriptors(_unit_rows(rng, 1, idx.dim), k=1)
            else:
                while idx._sync_thread is not None:  # let the worker fail first
                    time.sleep(0.01)
                idx.flush()
        assert isinstance(e.value.__cause__, OSError)


def test_sync_appends_in_place_past_the_prefix():
    """A chunk that fits the capacity is written into the same buffer past
    the synced prefix; a capacity growth copies the prefix into a new
    buffer. A snapshot never takes rows past its prefix as candidates,
    whatever they hold."""
    rng = np.random.RandomState(10)
    idx = _desc_index(sync_chunk_rows=32)
    d = _unit_rows(rng, 100, idx.dim)
    idx.add_descriptors(d[:40])
    idx.flush()
    buf = idx._dev_db[0]  # the one shard of an unsharded index
    assert buf.shape[0] == 64 and idx._dev_rows == 40
    buf[40:] = torch.tensor(d[:1])  # rows past the prefix: copies of row 0
    ids, _ = idx.query_descriptors(d[:1], k=3)
    assert ids[0, 0] == 0 and (ids[0] < 40).all()
    idx.add_descriptors(d[40:60])
    idx.flush()
    assert idx._dev_db[0] is buf  # written in place
    idx.add_descriptors(d[60:])
    idx.flush()
    assert idx._dev_db[0] is not buf and idx._dev_db[0].shape[0] == 128  # grown, prefix copied
    np.testing.assert_array_equal(idx._dev_db[0][:100].numpy(), d)
    assert (idx._dev_db[0][100:] == 1e6).all()
    ids, _ = idx.query_descriptors(d[[0, 55, 99]], k=1)
    np.testing.assert_array_equal(ids[:, 0], [0, 55, 99])


def test_sync_mode_validation():
    with pytest.raises(ValueError, match="sync_mode"):
        _desc_index(sync_mode="lazy")


def test_concurrent_adds_and_background_queries():
    """Adds from one thread while four threads query: every answer is the
    exact top-1 of a prefix no shorter than the one visible when it was sent."""
    rng = np.random.RandomState(9)
    idx = _desc_index(sync_chunk_rows=64, sync_mode="background")
    d = _unit_rows(rng, 1200, idx.dim)
    idx.add_descriptors(d[:64])
    idx.flush()
    errors = []

    def worker(seed):
        r = np.random.RandomState(seed)
        for _ in range(30):
            j = int(r.randint(1200))
            lo = idx.metrics()["device_synced_rows"]
            ids, _ = idx.query_descriptors(d[j:j + 1], k=1)
            hi = idx.metrics()["device_synced_rows"]
            if j < lo and ids[0, 0] != j:  # visible when sent: must be found
                errors.append((j, lo, int(ids[0, 0])))
            if ids[0, 0] >= hi:
                errors.append(("beyond prefix", j, hi, int(ids[0, 0])))

    import threading

    pool = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in pool:
        t.start()
    for s in range(64, 1200, 100):
        idx.add_descriptors(d[s:s + 100])
    for t in pool:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in pool)
    assert not errors, errors[:3]
    idx.flush()
    ids, _ = idx.query_descriptors(d[-4:], k=1)
    np.testing.assert_array_equal(ids[:, 0], np.arange(1196, 1200))


@pytest.mark.parametrize("sync_mode", ["blocking", "background"])
def test_host_master_segments(monkeypatch, tmp_path, sync_mode):
    """The host master in segments of HOST_SEGMENT_ROWS rows: adds of
    irregular sizes across segment boundaries leave every earlier segment in
    place (no add copies the DB), chunks that span segments sync the right
    rows, and save / load_db keep every row."""
    from epcnet_torch import serve

    monkeypatch.setattr(serve, "HOST_SEGMENT_ROWS", 16)
    rng = np.random.RandomState(11)
    idx = _desc_index(sync_chunk_rows=24, sync_mode=sync_mode)
    d = _unit_rows(rng, 150, idx.dim)
    at = 0
    for m in (5, 11, 16, 1, 40, 7, 70):  # 150 rows, 10 segments
        before = list(idx._segs)
        idx.add_descriptors(d[at:at + m])
        at += m
        assert all(a is b for a, b in zip(before, idx._segs))
    assert len(idx._segs) == 10 and len(idx) == 150
    np.testing.assert_array_equal(idx._db, d)
    idx.flush()
    np.testing.assert_array_equal(idx._dev_db[0][:150].numpy(), d)
    ids, dists = idx.query_descriptors(d[[0, 15, 16, 31, 149]], k=1)
    np.testing.assert_array_equal(ids[:, 0], [0, 15, 16, 31, 149])
    assert dists.max() < 1e-6
    path = str(tmp_path / "db.npz")
    idx.save(path)
    fresh = _desc_index(sync_chunk_rows=24)
    fresh.load_db(path)
    assert len(fresh._segs) == 10
    np.testing.assert_array_equal(fresh._db, d)


def test_dropped_index_is_freed_without_a_collection():
    """No reference cycle keeps a dropped index (and its buffers) alive
    until the cyclic collector runs, also after a background sync and a
    test seam's round trip."""
    import gc
    import weakref

    rng = np.random.RandomState(12)
    gc.disable()
    try:
        idx = _desc_index(sync_chunk_rows=32, sync_mode="background")
        append = idx._append_fn
        idx._append_fn = lambda *a: append(*a)
        idx.add_descriptors(_unit_rows(rng, 100, idx.dim))
        idx.flush()
        idx.query_descriptors(_unit_rows(rng, 2, idx.dim), k=3)
        del idx._append_fn, append
        ref = weakref.ref(idx)
        del idx
        deadline = time.time() + 5  # the sync thread drops its reference on exit
        while ref() is not None and time.time() < deadline:
            time.sleep(0.01)
        assert ref() is None
    finally:
        gc.enable()
