"""The port's training loader and mining against the JAX package's on the
CPU: ``TupleLoader`` emits the same batches (arrays bit for bit, ids equal)
for the same (seed, epoch, skip_batches), with hard negatives attached and
without, and with any pool size; ``MiningCache._precompute_hard_negatives``
picks the same hard negatives from the same latents, ties (duplicated rows)
included, with the pools subsampled under the same RNG keying."""

import numpy as np
import pytest
import torch

from epcnet_tpu import configs as jcfg
from epcnet_tpu.data import TupleLoader as JTupleLoader
from epcnet_tpu.data import construct_query_dict as j_construct_query_dict
from epcnet_tpu.data.tuples import TrainingTuples as JTrainingTuples
from epcnet_tpu.data.tuples import scan_runs as j_scan_runs
from epcnet_tpu.train.mining import MiningCache as JMiningCache

from epcnet_torch import configs as tcfg
from epcnet_torch.data import TupleLoader, get_query_tuple
from epcnet_torch.data.tuples import TrainingTuples
from epcnet_torch.models import get_model
from epcnet_torch.train.mining import MiningCache
from epcnet_torch.train.step import model_embed_fn
from epcnet_torch.weights import init_flat_variables, load_flat_variables
from test_torch_models import _cfgs
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def tuples(synthetic_root):
    tt = j_construct_query_dict(j_scan_runs(synthetic_root), exclude_test_regions=False)
    return tt.queries


def _data_kw(root, **kw):
    return dict(dataset_root=root, num_points=128, num_negatives=4, num_positives=2, **kw)


def _hard(idx):  # a deterministic mining callback, as MiningCache.hard_negatives
    return [(idx * 7 + j) % 90 for j in range(3)] if idx % 3 else None


def _batches(loader, epoch, skip):
    return list(loader.epoch(epoch, skip_batches=skip))


@pytest.mark.parametrize("epoch,skip,hard,threads,other", [
    (0, 0, False, 4, True),
    (1, 3, False, 2, True),
    (2, 0, True, 4, True),
    (0, 5, True, 1, True),
    (1, 0, False, 3, False),
])
def test_loader_stream_equals_jax(tuples, synthetic_root, epoch, skip, hard, threads, other):
    kw = _data_kw(synthetic_root, loader_threads=threads, use_other_neg=other)
    jl = JTupleLoader(JTrainingTuples(tuples), jcfg.DataConfig(**kw), 3, seed=11)
    tl = TupleLoader(TrainingTuples(tuples), tcfg.DataConfig(**kw), 3, seed=11)
    if hard:
        jl.set_hard_negatives(_hard)
        tl.set_hard_negatives(_hard)
    want, got = _batches(jl, epoch, skip), _batches(tl, epoch, skip)
    assert len(got) == len(want) > 0 and tl.skipped_batches == jl.skipped_batches == skip
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["ids"] == w["ids"]
        for k in w:
            if k != "ids":
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_fast_forward_equals_full_replay(tuples, synthetic_root):
    """skip_batches=s resumes the stream at the batch a full pass emits
    s-th (the mid-epoch resume contract)."""
    tl = TupleLoader(TrainingTuples(tuples), tcfg.DataConfig(**_data_kw(synthetic_root)), 2,
                     seed=3)
    full = _batches(tl, 1, 0)
    rest = _batches(tl, 1, 4)
    assert len(rest) == len(full) - 4
    for a, b in zip(full[4:], rest):
        np.testing.assert_array_equal(a["query"], b["query"])
        assert a["ids"] == b["ids"]


def test_get_query_tuple_short_pools(tuples, synthetic_root):
    """More negatives than the pool holds: replacement sampling, no hang."""
    cfg = tcfg.DataConfig(**{**_data_kw(synthetic_root), "num_negatives": 200})
    t = get_query_tuple(TrainingTuples(tuples), 0, cfg, np.random.default_rng(0))
    assert t["negatives"].shape == (200, 128, 3) and len(t["ids"]["negatives"]) == 200


@pytest.mark.parametrize("pool,k", [(20, 4), (4000, 10), (3, 5)])
def test_precompute_hard_negatives_equals_jax(tuples, synthetic_root, pool, k):
    """Duplicated latent rows: equal distances, which JAX's top_k orders by
    position in the pool and the port's stable sort orders the same."""
    rng = np.random.default_rng(pool)
    n = len(tuples)
    lat = rng.standard_normal((n, 16)).astype(np.float32)
    lat[1::4] = lat[0::4][: len(lat[1::4])]  # every other pair of rows identical
    lat[2::9] = lat[5]
    kw = dict(sampled_neg_pool=pool, hard_neg_per_tuple=k, seed=5)
    dk = _data_kw(synthetic_root)
    jm = JMiningCache(JTrainingTuples(tuples), jcfg.DataConfig(**dk), jcfg.TrainConfig(**kw),
                      embed_fn=None)
    tm = MiningCache(TrainingTuples(tuples), tcfg.DataConfig(**dk), tcfg.TrainConfig(**kw))
    for gen in (0, 3):
        want = jm._precompute_hard_negatives(lat, gen)
        got = tm._precompute_hard_negatives(lat, gen)
        np.testing.assert_array_equal(got, want)


def test_mining_refresh_embeds_with_the_model(tuples, synthetic_root):
    _, tc = _cfgs("epcnet", compute_dtype="float32")
    model = get_model(tc, "cpu")
    load_flat_variables(model, init_flat_variables(tc, 4))
    dcfg = tcfg.DataConfig(**_data_kw(synthetic_root))
    cache = MiningCache(TrainingTuples(tuples), dcfg, tcfg.TrainConfig(hard_neg_per_tuple=3),
                        batch_size=16)
    assert cache.hard_negatives(0) is None  # before a refresh
    cache.refresh(model)
    lat = cache.latents
    assert lat.shape == (len(tuples), 256)
    from epcnet_torch.data.native_loader import load_pc_files_native

    pts = load_pc_files_native([tuples[i]["query"] for i in range(5)], synthetic_root, 128)
    np.testing.assert_allclose(lat[:5], model_embed_fn(model)(pts).numpy(), atol=1e-6, rtol=0)
    hard = cache.hard_negatives(0)
    pool = tuples[0]["negatives"]
    d = ((lat[pool] - lat[0]) ** 2).sum(-1)
    assert len(hard) == 3 and all(h in set(pool) for h in hard)
    np.testing.assert_allclose(((lat[hard[0]] - lat[0]) ** 2).sum(), d.min(), rtol=1e-6)
    cache.refresh(model)
    assert cache._cache[1] == 1  # the generation keys the next subsampling
    assert not torch.is_inference_mode_enabled()
