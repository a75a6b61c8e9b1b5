"""Sharded and ring retrieval of the port, one process over a device-list
mesh (here 8 and 4 shards on the CPU), against the unsharded port and the
JAX package's ``sharded_topk_neighbors`` / ``ring_topk_neighbors`` on its
8-device CPU mesh (``tests/test_multidevice.py``'s retrieval tests,
ported), and the sharded ``PlaceIndex`` against the unsharded one.

Ids are held exactly (tie-free data), distances within 1e-5 of JAX's
(``sharded_topk_neighbors``'s own test bound); on ties the port gives the
lowest global row, as its unsharded retrieval does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epcnet_tpu.ops.retrieval import quantize_descriptors as j_quantize
from epcnet_tpu.ops.retrieval import ring_topk_neighbors as j_ring_topk
from epcnet_tpu.ops.retrieval import sharded_topk_neighbors as j_sharded_topk

from epcnet_torch.configs import MeshConfig
from epcnet_torch.ops.retrieval import (
    quantize_descriptors,
    ring_topk_neighbors,
    sharded_topk_neighbors,
    topk_neighbors,
    topk_neighbors_quantized,
    topk_over_shards,
)
from epcnet_torch.parallel import make_mesh
from epcnet_torch.serve import PlaceIndex, QueryScheduler


def _mesh(n):
    return make_mesh(MeshConfig(data_axis=1, db_axis=n), ["cpu"] * n)


@pytest.fixture(scope="module")
def jmesh8():
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()).reshape(8), ("db",))


def _case(seed, q, n, d=16):
    rng = np.random.RandomState(seed)
    return rng.randn(q, d).astype(np.float32), rng.randn(n, d).astype(np.float32)


@pytest.mark.parametrize("n,k", [(101, 9), (20, 20), (173, 8), (4096, 25)])
def test_sharded_fp32_matches_unsharded_and_jax(jmesh8, n, k):
    q, db = _case(n, 5, n)
    want_i, want_d = topk_neighbors(torch.tensor(q), torch.tensor(db), k)
    ji, jd = j_sharded_topk(jnp.asarray(q), jnp.asarray(db), k, jmesh8)
    for fn in (sharded_topk_neighbors, ring_topk_neighbors):
        i, d = fn(torch.tensor(q), torch.tensor(db), k, _mesh(8))
        np.testing.assert_array_equal(i.numpy(), want_i.numpy())
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)


def test_ring_matches_jax_ring(jmesh8):
    q, db = _case(3, 6, 173, 32)
    ji, jd = j_ring_topk(jnp.asarray(q), jnp.asarray(db), 8, jmesh8)
    i, d = ring_topk_neighbors(torch.tensor(q), torch.tensor(db), 8, _mesh(8))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5)


@pytest.mark.parametrize("n,k", [(101, 9), (20, 20)])
def test_sharded_int8_matches_unsharded_and_jax(jmesh8, n, k):
    q, db = _case(n + 1, 5, n)
    qi, sc = quantize_descriptors(torch.tensor(db))
    want_i, _ = topk_neighbors_quantized(torch.tensor(q), qi, sc, k)
    i, d = sharded_topk_neighbors(torch.tensor(q), qi, k, _mesh(8), db_scale=sc)
    np.testing.assert_array_equal(i.numpy(), want_i.numpy())
    jq, js = j_quantize(jnp.asarray(db))
    ji, jd = j_sharded_topk(jnp.asarray(q), jq, k, jmesh8, db_scale=js)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)


def test_ties_go_to_the_lowest_global_row():
    """Copies of one row in every shard (and twice in one): the answer
    lists them in global row order, as the unsharded retrieval does."""
    q, db = _case(9, 3, 64)
    db[[5, 6, 21, 40, 63]] = q[0]
    want_i, _ = topk_neighbors(torch.tensor(q), torch.tensor(db), 7)
    for fn in (sharded_topk_neighbors, ring_topk_neighbors):
        i, _ = fn(torch.tensor(q), torch.tensor(db), 7, _mesh(4))
        np.testing.assert_array_equal(i.numpy(), want_i.numpy())
        np.testing.assert_array_equal(i.numpy()[0, :5], [5, 6, 21, 40, 63])


def test_fewer_rows_than_shards_and_k_past_the_rows():
    """5 rows over 8 shards leave three empty: the answer is the unsharded
    one; k above the rows raises."""
    q, db = _case(12, 3, 5)
    want_i, _ = topk_neighbors(torch.tensor(q), torch.tensor(db), 4)
    qi, sc = quantize_descriptors(torch.tensor(db))
    want_q, _ = topk_neighbors_quantized(torch.tensor(q), qi, sc, 4)
    for fn in (sharded_topk_neighbors, ring_topk_neighbors):
        i, _ = fn(torch.tensor(q), torch.tensor(db), 4, _mesh(8))
        np.testing.assert_array_equal(i.numpy(), want_i.numpy())
        with pytest.raises(ValueError, match="outside"):
            fn(torch.tensor(q), torch.tensor(db), 6, _mesh(8))
    i, _ = sharded_topk_neighbors(torch.tensor(q), qi, 4, _mesh(8), db_scale=sc)
    np.testing.assert_array_equal(i.numpy(), want_q.numpy())


def test_over_shards_cyclic_and_valid_rows():
    """The index's layout (global row r on shard r % 4) with rows past a
    prefix excluded: the unsharded answer over that prefix; slots past the
    candidates hold -1."""
    q, db = _case(11, 4, 64)
    shards = [torch.tensor(db[s::4]) for s in range(4)]
    for rows in (64, 30, 3):
        valid = [max(0, -(-(rows - s) // 4)) for s in range(4)]
        i, d = topk_over_shards(torch.tensor(q), shards, 5, n_valid=valid)
        want, _ = topk_neighbors(torch.tensor(q), torch.tensor(db[:rows]), min(5, rows))
        np.testing.assert_array_equal(i.numpy()[:, :min(5, rows)], want.numpy())
        assert (i.numpy()[:, rows:] == -1).all() and np.isnan(d.numpy()[:, rows:]).all()


def _unit(rng, n, dim=32):
    x = rng.standard_normal((n, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("sync_mode", ["blocking", "background"])
@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_sharded_place_index_matches_unsharded(quantize, sync_mode):
    """Adds across several capacity doublings (3 shards: capacities are
    multiples of 3); every answer equals the unsharded index's."""
    rng = np.random.RandomState(4)
    desc = _unit(rng, 700)
    mesh = make_mesh(MeshConfig(data_axis=1, db_axis=3), ["cpu"] * 3)
    kw = dict(descriptor_dim=32, embed_batch=4, block_rows=16, quantize=quantize,
              sync_mode=sync_mode, sync_chunk_rows=64, device="cpu")
    one, sh = PlaceIndex(None, **kw), PlaceIndex(None, mesh=mesh, **kw)
    for a, b in ((0, 10), (10, 11), (11, 200), (200, 700)):
        for ix in (one, sh):
            ix.add_descriptors(desc[a:b], metadata=list(range(a, b)))
            ix.flush()
        for k in (1, 5, 25, 40):
            i1, d1 = one.query_descriptors(desc[:b:7], k=k)
            i2, d2 = sh.query_descriptors(desc[:b:7], k=k)
            np.testing.assert_array_equal(i2, i1)
            np.testing.assert_allclose(d2, d1, atol=1e-6)
    m = sh.metrics()
    assert m["sharded"] and m["device_rows_capacity"] % 3 == 0
    assert m["device_rows_capacity"] >= 700 and len(sh._dev_db) == 3
    assert sh.metadata([699]) == [699]


def test_sharded_index_fused_query_and_warmup():
    """The fused embed + retrieve path and warmup run the sharded
    retrieval (an embed that returns the submap's first row as its
    descriptor, unit-normalised)."""
    def embed(pts):
        x = pts[:, 0, :].repeat(1, 11)[:, :32]
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    rng = np.random.RandomState(8)
    pts = rng.uniform(-1, 1, (40, 5, 3)).astype(np.float32)
    mesh = make_mesh(MeshConfig(data_axis=1, db_axis=4), ["cpu"] * 4)
    sh = PlaceIndex(embed, descriptor_dim=32, embed_batch=4, block_rows=8, mesh=mesh,
                    num_points=5, device="cpu")
    sh.warmup()
    assert len(sh) == 0 and sh.metrics()["queries"] == 0
    sh.add(pts)
    for s in range(0, 40, 4):
        ids, _ = sh.query(pts[s:s + 4], k=3)
        np.testing.assert_array_equal(ids[:, 0], np.arange(s, s + 4))
    sched = QueryScheduler(sh, k=3)
    try:
        futs = [sched.submit(pts[i]) for i in range(0, 40, 3)]
        assert [int(f.result(timeout=30)[0][0]) for f in futs] == list(range(0, 40, 3))
    finally:
        sched.stop()
