"""Weights across the packages: the flat naming of ``cli/export.py``, the
export file pair, and the numpy-seeded init the card's machine uses."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from epcnet_tpu import configs as jcfg
from epcnet_tpu.cli.export import flatten_variables
from epcnet_tpu.models import get_model as j_get_model
from epcnet_tpu.train.state import create_train_state

from epcnet_torch import configs as tcfg
from epcnet_torch.models import get_model
from epcnet_torch.serve import PlaceIndex
from epcnet_torch.weights import (
    init_flat_variables,
    init_train_variables,
    load_export,
    load_flat_variables,
    save_export,
)


def _jax_flat_shapes(cfg, n):
    m = j_get_model(cfg)
    v = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), jnp.zeros((1, n, 3)),
                                      train=False))
    flat = flatten_variables(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), v["params"]),
                             jax.tree_util.tree_map(lambda s: np.zeros(s.shape),
                                                    v["batch_stats"]))
    return {k: a.shape for k, a in flat.items()}


_CONFIGS = {"epcnet": "ModelConfig", "epcnet_l": "epcnet_l_config",
            "pointnetvlad": "pointnetvlad_config"}


@pytest.mark.parametrize("name", ["epcnet", "epcnet_l", "pointnetvlad"])
def test_init_flat_variables_naming(name):
    """Same names and shapes as a JAX init at the full published widths."""
    jc, tc = getattr(jcfg, _CONFIGS[name])(), getattr(tcfg, _CONFIGS[name])()
    flat = init_flat_variables(tc, seed=3)
    assert {k: v.shape for k, v in flat.items()} == _jax_flat_shapes(jc, 256)
    assert all(v.dtype == np.float32 for v in flat.values())
    again = init_flat_variables(tc, seed=3)
    other = init_flat_variables(tc, seed=4)
    assert all(np.array_equal(flat[k], again[k]) for k in flat)
    gate = f"params/{'netvlad' if name == 'pointnetvlad' else 'gvlad'}/gate/kernel"
    assert not np.array_equal(flat[gate], other[gate])
    assert all(flat[k].min() > 0 for k in flat if k.endswith("/var"))
    assert any(np.abs(flat[k]).max() > 0 for k in flat if k.endswith("/mean"))
    for tnet in ("input_tnet", "feature_tnet") if name == "pointnetvlad" else ():
        w, b = flat[f"params/{tnet}/transform_w"], flat[f"params/{tnet}/transform_b"]
        dim = int(np.sqrt(b.size))
        assert 0 < np.abs(w).max() < 0.05 and w.shape == (256, dim * dim)
        assert 0 < np.abs(b - np.eye(dim).ravel()).max() < 0.3  # near the identity


@pytest.mark.parametrize("name", ["epcnet", "epcnet_l", "pointnetvlad"])
def test_init_train_variables_follow_jax_init(name):
    """Training's init is JAX's ``model.init`` in distribution, leaf by leaf,
    at the published widths: the constants (zero biases and running means,
    unit BN scales and variances, the T-Nets' identity) equal, and every
    random leaf of at least 512 entries with JAX's std to 10% and, where
    JAX's is a LeCun normal truncated at 2 std, no entry beyond it."""
    jc, tc = getattr(jcfg, _CONFIGS[name])(num_points=64), getattr(tcfg, _CONFIGS[name])(
        num_points=64)
    m = j_get_model(jc)
    v = jax.jit(lambda: m.init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 3)), train=False))()
    want = flatten_variables(v["params"], v["batch_stats"])
    got = init_train_variables(tc, seed=3)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == np.float32, k
        if w.std() == 0:
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif w.size >= 512:
            assert abs(g.std() / w.std() - 1) < 0.1, (k, g.std(), w.std())
            if k.endswith("kernel") or k.endswith("group_w"):  # fan_in: all but the last axis
                bound = 2 * np.sqrt(1.0 / np.prod(w.shape[:-1])) / 0.87962566103423978
                assert np.abs(w).max() <= bound * (1 + 1e-6), k  # JAX's truncation
                assert np.abs(g).max() <= bound * (1 + 1e-6), k
    again, other = init_train_variables(tc, seed=3), init_train_variables(tc, seed=4)
    assert all(np.array_equal(got[k], again[k]) for k in got)
    assert any(not np.array_equal(got[k], other[k]) for k in got)


def test_save_export_roundtrip(tmp_path):
    """save_export writes export.py's pair: load_export reads back the
    config and the arrays, and the manifest has export.py's keys."""
    mc = tcfg.pointnetvlad_config(num_points=128, vlad_clusters=8, feature_dim=64,
                                  pointnet_channels=(16, 16, 16, 32, 64))
    cfg = tcfg.ExperimentConfig(model=mc, data=tcfg.DataConfig(num_points=128))
    flat = init_flat_variables(mc, seed=1)
    base = str(tmp_path / "run" / "export")
    save_export(base, cfg, flat, step=7)
    got_cfg, got = load_export(base)
    assert got_cfg == cfg and list(got) == list(flat)
    assert all(np.array_equal(got[k], flat[k]) for k in flat)
    with open(base + ".json") as f:
        manifest = json.load(f)
    assert set(manifest) == {"framework", "step", "config", "leaves"}
    assert manifest["step"] == 7 and manifest["leaves"][0] == {
        "name": next(iter(flat)), "shape": list(next(iter(flat.values())).shape),
        "dtype": "float32"}
    assert jcfg.ExperimentConfig.from_json(json.dumps(manifest["config"])).model.name \
        == "pointnetvlad"
    m = get_model(mc, device="cpu")
    load_flat_variables(m, got)


def test_load_flat_variables_rejects_bad_input():
    cfg = tcfg.ModelConfig(proxyconv_channels=(8, 8), lift_channels=(16, 32),
                           feature_dim=32, vlad_clusters=4, vlad_groups=2,
                           vlad_group_dim=8)
    model = get_model(cfg, device="cpu")
    flat = init_flat_variables(cfg, seed=0)
    load_flat_variables(model, flat)
    np.testing.assert_array_equal(model.proxyconv_0.dense.weight.detach().numpy(),
                                  flat["params/proxyconv_0/dense/kernel"].T)
    np.testing.assert_array_equal(model.lift.bn_1.var.numpy(),
                                  flat["batch_stats/lift/bn_1/var"])
    missing = dict(flat)
    del missing["batch_stats/lift/bn_0/mean"]
    with pytest.raises(KeyError, match="no value"):
        load_flat_variables(model, missing)
    with pytest.raises(KeyError, match="no counterpart"):
        load_flat_variables(model, {**flat, "params/gvlad/extra": np.zeros(3)})
    with pytest.raises(KeyError, match="no counterpart"):  # a param named as a stat
        load_flat_variables(model, {**flat, "batch_stats/gvlad/centroids":
                                    flat["params/gvlad/centroids"]})
    bad = dict(flat)
    bad["params/gvlad/assign/kernel"] = flat["params/gvlad/assign/kernel"].T
    with pytest.raises(ValueError, match="shape"):
        load_flat_variables(model, bad)


def test_from_export_serves_the_jax_weights(tmp_path):
    """An export pair written as cli/export.py writes it, read by
    PlaceIndex.from_export: the descriptors are the JAX model's."""
    mc = jcfg.ModelConfig(num_points=128, knn_k=8, proxyconv_channels=(16, 16),
                          lift_channels=(32, 64), feature_dim=64, vlad_clusters=8,
                          vlad_groups=4, vlad_group_dim=16, compute_dtype="float32")
    cfg = jcfg.ExperimentConfig(model=mc, data=jcfg.DataConfig(num_points=128))
    state = create_train_state(mc, cfg.train, num_points=128)
    flat = flatten_variables(state.params, state.batch_stats)
    base = str(tmp_path / "export")
    np.savez(base + ".npz", **flat)
    with open(base + ".json", "w") as f:
        json.dump({"framework": "epcnet_tpu", "step": 0,
                   "config": json.loads(cfg.to_json()),
                   "leaves": [{"name": k, "shape": list(v.shape), "dtype": str(v.dtype)}
                              for k, v in flat.items()]}, f)
    tcfg_, tflat = load_export(base)
    assert tcfg_.model.knn_k == 8 and set(tflat) == set(flat)

    ix = PlaceIndex.from_export(base, embed_batch=4, device="cpu")
    assert ix.num_points == 128 and ix.dim == 256
    pts = np.random.RandomState(41).uniform(-1, 1, (5, 128, 3)).astype(np.float32)
    want = np.asarray(j_get_model(mc).apply(
        {"params": state.params, "batch_stats": state.batch_stats},
        jnp.asarray(pts), train=False))
    np.testing.assert_allclose(ix.embed(pts), want, atol=1e-5)
    ix.add(pts)
    ids, _ = ix.query(pts, k=1)
    np.testing.assert_array_equal(ids.ravel(), np.arange(5))

    with open(base + ".json") as f:
        manifest = json.load(f)
    manifest["leaves"] = manifest["leaves"][1:]
    with open(base + ".json", "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="manifest"):
        load_export(base)
