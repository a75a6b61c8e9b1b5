"""The port's PlaceIndex / QueryScheduler on the CPU, mirroring
tests/test_serve.py (self-query, growth, empty, save/load, int8, fused vs
two-step, scheduler), plus the ids of the JAX PlaceIndex on the same weights
and clouds; and the serving path's spans, its queue-wait counter and the
benchmark's readers of those spans."""

import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from bench_h100 import harness
from bench_h100.trace import Stretch
from epcnet_tpu.cli.export import flatten_variables
from epcnet_tpu.configs import ModelConfig as JModelConfig
from epcnet_tpu.configs import TrainConfig
from epcnet_tpu.serve import PlaceIndex as JPlaceIndex
from epcnet_tpu.train.state import create_train_state
from epcnet_tpu.train.step import build_embed_fn as j_build_embed_fn

from epcnet_torch.configs import ModelConfig
from epcnet_torch.serve import PlaceIndex, QueryScheduler
from epcnet_torch.train.step import build_embed_fn

TINY = dict(num_points=128, knn_k=8, use_pallas=False, proxyconv_channels=(16, 16),
            lift_channels=(32, 64), feature_dim=64, vlad_clusters=8,
            vlad_groups=4, vlad_group_dim=16)


@pytest.fixture(scope="module")
def jax_state():
    return create_train_state(JModelConfig(**TINY), TrainConfig(), num_points=128)


@pytest.fixture(scope="module")
def embed(jax_state):
    flat = flatten_variables(jax_state.params, jax_state.batch_stats)
    return build_embed_fn(ModelConfig(**TINY), device="cpu", variables=flat)


@pytest.fixture(scope="module")
def index(embed):
    return PlaceIndex(embed, descriptor_dim=256, embed_batch=4, block_rows=64,
                      device="cpu")


def _clouds(seed, n):
    return np.random.RandomState(seed).uniform(-1, 1, (n, 128, 3)).astype(np.float32)


def test_add_and_query_self(index):
    pts = _clouds(31, 10)
    index.add(pts, metadata=[f"submap_{i}" for i in range(10)])
    assert len(index) == 10
    ids, dists = index.query(pts[:3], k=1)
    np.testing.assert_array_equal(ids[:, 0], [0, 1, 2])
    assert dists.max() < 1e-4
    assert index.metadata(ids[:, 0]) == ["submap_0", "submap_1", "submap_2"]
    with pytest.raises(ValueError, match="metadata length"):
        index.add_descriptors(np.zeros((2, 256), np.float32), metadata=["a"])


def test_incremental_growth(index):
    before = len(index)
    more = _clouds(32, 7)
    index.add(more)
    assert len(index) == before + 7
    ids, _ = index.query(more[:2], k=1)
    np.testing.assert_array_equal(ids[:, 0], [before, before + 1])
    m = index.metrics()
    assert m["size"] == before + 7 and m["sync_backlog_rows"] == 0
    assert m["device_rows_capacity"] == 64


def test_query_empty_raises(embed):
    empty = PlaceIndex(embed, descriptor_dim=256, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        empty.query_descriptors(np.zeros((1, 256), np.float32))


def test_save_load(index, tmp_path):
    p = str(tmp_path / "index.npz")
    index.save(p)
    fresh = PlaceIndex(index._embed, descriptor_dim=index.dim, device="cpu")
    fresh.load_db(p)
    assert len(fresh) == len(index)
    q = index._db[:2]
    i1, _ = index.query_descriptors(q, k=3)
    i2, _ = fresh.query_descriptors(q, k=3)
    np.testing.assert_array_equal(i1, i2)
    assert fresh.metadata([0]) == index.metadata([0])


def _unit_rows(rng, n, d=32):
    v = rng.normal(size=(n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_int8_matches_fp32():
    """tests/test_serve.py:486 on the port: top-1 survives quantization,
    deeper ranks mostly agree, incremental appends keep working."""
    desc = _unit_rows(np.random.RandomState(33), 200)
    out = {}
    for quant in ("none", "int8"):
        ix = PlaceIndex(None, descriptor_dim=32, embed_batch=4, block_rows=64,
                        quantize=quant, device="cpu")
        ix.add_descriptors(desc[:150])
        ids, dists = ix.query_descriptors(desc[:20], k=5)
        ix.add_descriptors(desc[150:])
        ids2, _ = ix.query_descriptors(desc[180:], k=1)
        out[quant] = (ids, dists, ids2, ix)
    np.testing.assert_array_equal(out["int8"][0][:, 0], out["none"][0][:, 0])
    overlap = np.mean([len(set(a) & set(b)) / 5.0
                       for a, b in zip(out["int8"][0], out["none"][0])])
    assert overlap >= 0.9, overlap
    np.testing.assert_array_equal(out["int8"][2].ravel(), np.arange(180, 200))
    np.testing.assert_array_equal(out["int8"][2], out["none"][2])
    np.testing.assert_allclose(out["int8"][1][:, 0], out["none"][1][:, 0], atol=5e-3)
    assert str(out["int8"][3]._dev_db[0].dtype) == "torch.int8"
    assert out["int8"][3].metrics()["device_bytes"] == 256 * 32 + 256 * 4


def test_fused_query_matches_two_step(embed):
    pts = _clouds(34, 10)
    for quant in ("none", "int8"):
        ix = PlaceIndex(embed, descriptor_dim=256, embed_batch=4, block_rows=64,
                        quantize=quant, device="cpu")
        ix.add(pts)
        ids_ref, d_ref = ix.query_descriptors(ix.embed(pts[:3]), k=4)
        orig_embed = ix.embed
        ix.embed = None  # the fused path must not need it
        ids, d = ix.query(pts[:3], k=4)
        ix.embed = orig_embed
        np.testing.assert_array_equal(ids, ids_ref)
        np.testing.assert_allclose(d, d_ref, atol=1e-5)
        np.testing.assert_array_equal(ids[:, 0], np.arange(3))
        ids_big, _ = ix.query(pts, k=1)  # > embed_batch: embed-then-retrieve
        np.testing.assert_array_equal(ids_big.ravel(), np.arange(10))


def test_query_scheduler_batches_and_matches(embed):
    idx = PlaceIndex(embed, descriptor_dim=256, embed_batch=8, block_rows=32,
                     device="cpu")
    db_pts = _clouds(35, 12)
    idx.add(db_pts)
    calls = []
    real_query = idx.query

    def counting_query(pts, k=25):
        calls.append(pts.shape[0])
        return real_query(pts, k)

    idx.query = counting_query
    sched = QueryScheduler(idx, k=2, max_batch=8, max_wait_ms=50.0)
    try:
        futs = [None] * 10

        def submit(i):
            futs[i] = sched.submit(db_pts[i])

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        results = [f.result(timeout=120) for f in futs]
    finally:
        sched.stop()
    idx.query = real_query
    direct, _ = idx.query(db_pts[:10], k=2)
    for i, (ids, _) in enumerate(results):
        np.testing.assert_array_equal(ids, direct[i])
        assert ids[0] == i
    assert len(calls) < 10 and sum(calls) == 10
    m = sched.metrics()
    assert m["requests"] == 10 and m["errors"] == 0
    with pytest.raises(RuntimeError, match="stopped"):
        sched.submit(db_pts[0])


def test_ids_match_jax_place_index(jax_state, embed):
    """Same weights, same clouds: the port's index answers with the JAX
    index's ids (fp32 and int8)."""
    pts = _clouds(36, 12)
    j_embed = j_build_embed_fn(JModelConfig(**TINY))
    for quant in ("none", "int8"):
        jx = JPlaceIndex(j_embed, jax_state.params, jax_state.batch_stats,
                         descriptor_dim=256, embed_batch=4, block_rows=64,
                         quantize=quant)
        tx = PlaceIndex(embed, descriptor_dim=256, embed_batch=4, block_rows=64,
                        quantize=quant, device="cpu")
        jx.add(pts)
        tx.add(pts)
        np.testing.assert_allclose(tx._db, jx._db, atol=2e-4)
        j_ids, _ = jx.query(pts[:4], k=1)
        t_ids, _ = tx.query(pts[:4], k=1)
        np.testing.assert_array_equal(t_ids, j_ids)
        np.testing.assert_array_equal(t_ids[:, 0], np.arange(4))
        j_ids, _ = jx.query_descriptors(jx._db[4:9], k=3)
        t_ids, _ = tx.query_descriptors(jx._db[4:9], k=3)
        np.testing.assert_array_equal(t_ids, j_ids)


def test_unported_modes_raise(embed):
    # background sync and the mesh are ported (tests/test_torch_retrieval.py
    # and tests/test_torch_sharded_retrieval.py hold them); a bad mode raises
    assert PlaceIndex(embed, sync_mode="background", device="cpu").sync_mode == "background"
    from epcnet_torch.configs import MeshConfig
    from epcnet_torch.parallel import make_mesh

    mesh = make_mesh(MeshConfig(data_axis=1, db_axis=2), ["cpu", "cpu"])
    assert PlaceIndex(embed, mesh=mesh, device="cpu").metrics()["sharded"]
    with pytest.raises(ValueError, match="sync_mode"):
        PlaceIndex(embed, sync_mode="eventual", device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        PlaceIndex(embed, quantize="int4", device="cpu")


def test_warmup_leaves_state_alone(embed):
    ix = PlaceIndex(embed, descriptor_dim=256, embed_batch=4, block_rows=64,
                    num_points=128, device="cpu")
    ix.warmup()
    m = ix.metrics()
    assert len(ix) == 0 and m["queries"] == 0 and m["device_rows_capacity"] == 0


@pytest.mark.parametrize("fmt", ["packed", "gather"])
def test_capacity_routes_serve_like_jax(jax_state, fmt):
    """An index over a model on the packed or the gather route (the routes
    ``auto`` takes past N=16384 and N=32768) answers with the JAX index's
    ids, every added submap at rank 0 of its own query."""
    pts = _clouds(37, 8)
    flat = flatten_variables(jax_state.params, jax_state.batch_stats)
    j_embed = j_build_embed_fn(JModelConfig(**TINY, adjacency_format=fmt))
    t_embed = build_embed_fn(ModelConfig(**TINY, adjacency_format=fmt), device="cpu",
                             variables=flat)
    jx = JPlaceIndex(j_embed, jax_state.params, jax_state.batch_stats,
                     descriptor_dim=256, embed_batch=4, block_rows=64)
    tx = PlaceIndex(t_embed, descriptor_dim=256, embed_batch=4, block_rows=64,
                    num_points=128, device="cpu")
    tx.warmup()
    jx.add(pts)
    tx.add(pts)
    np.testing.assert_allclose(tx._db, jx._db, atol=2e-4)
    t_ids, _ = tx.query(pts, k=3)
    j_ids, _ = jx.query(pts, k=3)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_array_equal(t_ids[:, 0], np.arange(8))


DISPATCH = ["serve/wait", "serve/collect", "serve/stack", "serve/snapshot", "serve/upload",
            "serve/retrieve", "serve/copy_back", "serve/resolve"]


@pytest.fixture(scope="module")
def traced(embed):
    """Three one-request dispatches through a scheduler, the second traced
    whole: the profiler starts in the worker thread inside the first
    dispatch's ``PlaceIndex.query`` and stops inside the third's, as the
    benchmark's serve stretch does. The stretch's ``Trace``."""
    idx = PlaceIndex(embed, descriptor_dim=256, embed_batch=4, block_rows=32, device="cpu")
    pts = _clouds(38, 3)
    idx.add(pts)
    stretch, calls, real = Stretch("cpu", 0, 0), [], idx.query

    def query(points, k=25):
        calls.append(len(points))
        if len(calls) == 1:
            stretch.start()
        elif len(calls) == 3:
            stretch.stop(2)
        return real(points, k)

    idx.query = query
    sched = QueryScheduler(idx, k=2, max_wait_ms=1.0)
    try:
        for i in range(3):
            assert sched.submit(pts[i]).result(timeout=120)[0][0] == i
    finally:
        sched.stop()
    return stretch.trace


def test_dispatch_records_each_span_once_in_order(traced):
    serve = [(s, t, name) for s, t, name in sorted(traced.spans) if name.startswith("serve/")]
    names = [name for _, _, name in serve]
    first = names.index("serve/resolve")  # the first dispatch's, after the profiler started
    assert names[:first + 1] == DISPATCH[3:]
    assert names[first + 1:first + 1 + len(DISPATCH)] == DISPATCH
    assert names[first + 1 + len(DISPATCH):] == DISPATCH[:3]  # stopped inside the third
    for (_, end, _), (start, _, _) in zip(serve, serve[1:]):
        assert end <= start  # one after another, none inside another
    upload, retrieve = (next(s for s, _, n in serve[first + 1:] if n == name)
                        for name in ("serve/upload", "serve/retrieve"))
    model = [s for s, _, n in traced.spans if n.startswith("epcnet/") and upload < s < retrieve]
    assert model  # the model's own spans, between the upload and the retrieval


def test_serve_span_readers(traced):
    """The benchmark's readers of the serve spans on a CPU profile: host
    times read, device time (none on the CPU) does not."""
    obs = types.SimpleNamespace(trace=traced, counters={}, model=None, params=None)
    read = {name: harness.load_module("metrics", name).read(obs)
            for name in ("serve.collect_ms", "serve.upload_ms", "serve.retrieve_ms")}
    assert read["serve.collect_ms"] >= 0.9  # one request: the batch closes at max_wait_ms
    assert read["serve.upload_ms"] > 0
    assert read["serve.retrieve_ms"] is None
    empty = types.SimpleNamespace(trace=None, counters={}, model=None, params=None)
    for name in read:
        assert harness.load_module("metrics", name).read(empty) is None


def test_spans_cost_nothing_without_a_profiler(embed, monkeypatch):
    called = []

    def refuse(name):
        called.append(name)
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    idx = PlaceIndex(embed, descriptor_dim=256, embed_batch=4, block_rows=32, device="cpu")
    pts = _clouds(39, 6)
    idx.add(pts)  # embed
    assert idx.query(pts[:2], k=1)[0][:, 0].tolist() == [0, 1]
    assert idx.query(pts, k=1)[0][:, 0].tolist() == list(range(6))  # embed, then retrieve
    sched = QueryScheduler(idx, k=1, max_wait_ms=1.0)
    try:
        assert sched.submit(pts[3]).result(timeout=60)[0][0] == 3
    finally:
        sched.stop()
    assert not called


def test_queue_wait_counts_the_time_held_in_the_queue(embed):
    idx = PlaceIndex(embed, descriptor_dim=256, embed_batch=4, block_rows=32, device="cpu")
    pts = _clouds(40, 2)
    idx.add(pts)
    entered, gate, real = threading.Event(), threading.Event(), idx.query

    def held(points, k=25):
        entered.set()
        assert gate.wait(60)
        return real(points, k)

    idx.query = held
    sched = QueryScheduler(idx, k=1, max_wait_ms=1.0)
    try:
        first = sched.submit(pts[0])
        assert entered.wait(60)  # the worker is inside the first dispatch
        second = sched.submit(pts[1])
        queued = time.perf_counter()
        time.sleep(0.2)
        released = time.perf_counter()
        gate.set()
        assert [f.result(timeout=60)[0][0] for f in (first, second)] == [0, 1]
        m = sched.metrics()
    finally:
        sched.stop()
    assert m["requests"] == 2 and m["dispatches"] == 2
    assert m["queue_wait_s"] >= released - queued
