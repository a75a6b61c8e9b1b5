"""The port's importer (``epcnet_torch/utils/importer.py``) and convert CLI
(``epcnet_torch/cli/convert.py``) against the JAX package's, on the JAX
package's test cases (``tests/test_importer.py``, ``tests/test_cli.py``):
the imported weights are compared as flat dicts (``params/...``,
``batch_stats/...``) and must be equal; descriptors of converted runs are
held to JAX's within 1e-5 (fp32, CPU) and, where the weights are the
port's own, equal to the bridge's (``load_flat_variables``) exactly."""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epcnet_tpu import configs as jcfg
from epcnet_tpu.cli.export import flatten_variables
from epcnet_tpu.models import get_model as j_get_model
from epcnet_tpu.utils import importer as jimp

from epcnet_torch import configs as tcfg
from epcnet_torch.cli import convert
from epcnet_torch.cli import embed as tembed
from epcnet_torch.models import get_model
from epcnet_torch.utils import importer as timp
from epcnet_torch.weights import flat_variables, init_flat_variables, load_flat_variables

EPC_SMALL = dict(num_points=64, knn_k=4, use_pallas=False, proxyconv_channels=(8, 8, 8, 16),
                 lift_channels=(16, 32), feature_dim=32, vlad_clusters=4, vlad_groups=2,
                 vlad_group_dim=8, output_dim=16, compute_dtype="float32")


def _flat(params, stats) -> dict:
    return {k: np.asarray(v) for k, v in flatten_variables(params, stats or {}).items()}


def _assert_flat_equal(got: dict, want: dict):
    assert list(sorted(got)) == list(sorted(want))
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k], np.float32),
                                      np.asarray(want[k], np.float32), err_msg=k)


def _jax_init(cfg, seed=0, n=64):
    model = j_get_model(cfg)
    return model, model.init(jax.random.PRNGKey(seed), jnp.zeros((1, n, 3)), train=False)


def test_convert_dense_and_name_maps_match():
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    for arr, src in ((w, "torch"), (w.reshape(4, 3, 1, 1), "torch"),
                     (w.reshape(1, 1, 4, 3), "tf"), (w, "tf")):
        np.testing.assert_array_equal(timp.convert_dense(arr, src),
                                      jimp.convert_dense(arr, src))
    assert timp.NAME_MAPS == jimp.NAME_MAPS


def test_import_state_dict_matches_jax():
    """JAX's torch-layout case: one ProxyConv's dense and BN by regex, one
    unrelated key skipped with a warning."""
    rng = np.random.RandomState(0)
    sd = {
        "backbone.convs.0.weight": rng.randn(8, 6).astype(np.float32),
        "backbone.convs.0.bias": rng.randn(8).astype(np.float32),
        "backbone.bns.0.weight": rng.rand(8).astype(np.float32),
        "backbone.bns.0.bias": rng.randn(8).astype(np.float32),
        "backbone.bns.0.running_mean": rng.randn(8).astype(np.float32),
        "backbone.bns.0.running_var": rng.rand(8).astype(np.float32) + 0.5,
        "unrelated.key": np.zeros(3),
    }
    name_map = {
        r"backbone\.convs\.(\d+)\.weight": r"proxyconv_\1/dense/kernel",
        r"backbone\.convs\.(\d+)\.bias": r"proxyconv_\1/dense/bias",
        r"backbone\.bns\.(\d+)\.weight": r"proxyconv_\1/bn/scale",
        r"backbone\.bns\.(\d+)\.bias": r"proxyconv_\1/bn/bias",
        r"backbone\.bns\.(\d+)\.running_mean": r"proxyconv_\1/bn/mean",
        r"backbone\.bns\.(\d+)\.running_var": r"proxyconv_\1/bn/var",
    }
    with pytest.warns(UserWarning, match="skipped 1 keys"):
        got = timp.import_state_dict(sd, name_map, source="torch")
    with pytest.warns(UserWarning, match="skipped 1 keys"):
        want = _flat(*jimp.import_state_dict(sd, name_map, source="torch"))
    _assert_flat_equal(got, want)
    base = init_flat_variables(tcfg.ModelConfig(**EPC_SMALL), 0)
    merged = timp.merge_into_variables(base, got)
    np.testing.assert_array_equal(merged["params/proxyconv_0/dense/kernel"],
                                  sd["backbone.convs.0.weight"].T)
    assert merged["params/lift/dense_0/kernel"] is base["params/lift/dense_0/kernel"]


def test_merge_into_variables_rejects():
    base = init_flat_variables(tcfg.ModelConfig(**EPC_SMALL), 0)
    with pytest.raises(ValueError, match="shape mismatch"):
        timp.merge_into_variables(base, {"params/proxyconv_0/dense/kernel": np.zeros((7, 7))})
    with pytest.raises(KeyError, match="absent"):
        timp.merge_into_variables(base, {"params/nope/kernel": np.zeros(3)})


def _tf_sd(rng, cfg, pnv: bool):
    """A complete TF1 variable dict in the NAME_MAPS' naming (the JAX
    tests' fabrications)."""
    def r(*shape):
        return rng.randn(*shape).astype(np.float32)

    def bn(prefix, w):
        return {f"{prefix}/bn/{nm}": a for nm, a in
                (("gamma", r(w)), ("beta", r(w)), ("moving_mean", r(w)),
                 ("moving_variance", np.abs(r(w))))}

    sd = {}
    if pnv:
        for scope, cin, tvar, tdim in (("transform_net1", 3, "transform_XYZ", 9),
                                       ("transform_net2", 8, "transform_feat", 64)):
            prev = cin
            for i, w in enumerate([64, 128, 1024], start=1):
                sd[f"{scope}/tconv{i}/weights"] = r(1, 1, prev, w)
                sd[f"{scope}/tconv{i}/biases"] = r(w)
                sd.update(bn(f"{scope}/tconv{i}", w))
                prev = w
            for i, w in enumerate([512, 256], start=1):
                sd[f"{scope}/tfc{i}/weights"] = r(prev, w)
                sd[f"{scope}/tfc{i}/biases"] = r(w)
                sd.update(bn(f"{scope}/tfc{i}", w))
                prev = w
            sd[f"{scope}/{tvar}/weights"] = r(256, tdim)
            sd[f"{scope}/{tvar}/biases"] = r(tdim)
        prev = 3
        for i, w in enumerate([8, 8, 16], start=1):
            sd[f"conv{i}/weights"] = r(1, 1, prev, w)
            sd[f"conv{i}/biases"] = r(w)
            sd.update(bn(f"conv{i}", w))
            prev = w
        sd.update({"cluster_weights": r(16, 4), "cluster_biases": r(4),
                   "cluster_weights2": r(1, 16, 4), "hidden1_weights": r(64, 32),
                   "hidden1_biases": r(32), "gating_weights": r(32, 32),
                   "gating_biases": r(32)})
        return sd
    prev = 3
    for i, w in enumerate(cfg.proxyconv_channels, start=1):
        sd[f"pconv{i}/weights"] = r(1, 1, 2 * prev, w)
        sd[f"pconv{i}/biases"] = r(w)
        sd.update(bn(f"pconv{i}", w))
        prev = w
    prev = sum(cfg.proxyconv_channels)
    for i, w in enumerate(cfg.lift_channels, start=5):
        sd[f"conv{i}/weights"] = r(1, 1, prev, w)
        sd[f"conv{i}/biases"] = r(w)
        sd.update(bn(f"conv{i}", w))
        prev = w
    d, k, g, gd = cfg.feature_dim, cfg.vlad_clusters, cfg.vlad_groups, cfg.vlad_group_dim
    sd.update({"vlad/cluster_weights": r(d, k), "vlad/cluster_biases": r(k),
               "vlad/cluster_weights2": r(1, d, k), "vlad/hidden1_weights": r(g, k * d // g, gd),
               "vlad/hidden1_biases": r(g, gd), "vlad/hidden2_weights": r(g * gd, cfg.output_dim),
               "vlad/hidden2_biases": r(cfg.output_dim),
               "vlad/gating_weights": r(cfg.output_dim, cfg.output_dim),
               "vlad/gating_biases": r(cfg.output_dim)})
    return sd


@pytest.mark.parametrize("name", ["tf1_epcnet", "tf1_pointnetvlad"])
def test_tf1_name_maps_match_jax(name):
    """A complete TF1 dict through each NAME_MAP: no key skipped, the flat
    result equal to JAX's, every leaf of the port's model covered, and the
    port's descriptors with it within 1e-5 of JAX's."""
    rng = np.random.RandomState(1)
    if name == "tf1_epcnet":
        jc, tc = jcfg.ModelConfig(**EPC_SMALL), tcfg.ModelConfig(**EPC_SMALL)
    else:
        small = dict(pointnet_channels=(8, 8, 16), feature_dim=16, vlad_clusters=4,
                     vlad_groups=1, vlad_group_dim=32, output_dim=32, use_pallas=False,
                     compute_dtype="float32")
        jc = jcfg.pointnetvlad_config(num_points=64).variant(**small)
        tc = tcfg.pointnetvlad_config(num_points=64).variant(**small)
    sd = _tf_sd(rng, jc, name == "tf1_pointnetvlad")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a skipped key is a map gap
        got = timp.import_state_dict(sd, timp.NAME_MAPS[name], source="tf")
        want = _flat(*jimp.import_state_dict(sd, jimp.NAME_MAPS[name], source="tf"))
    _assert_flat_equal(got, want)
    base = init_flat_variables(tc, 0)
    assert set(got) == set(base)  # every leaf of the model, nothing else
    merged = timp.merge_into_variables(base, got)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 64, 3)).astype(np.float32)
    model, variables = _jax_init(jc)
    jmerged = jimp.merge_into_variables(variables, *jimp.import_state_dict(
        sd, jimp.NAME_MAPS[name], source="tf"))
    want_d = np.asarray(model.apply(jmerged, jnp.asarray(x), train=False))
    tm = load_flat_variables(get_model(tc, "cpu"), merged).eval()
    with torch.no_grad():
        got_d = tm(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=1e-5)


def test_model_leaf_order_and_automatch_match_jax():
    """JAX's unlabelled round trip: the donor's leaves renamed var_000...
    in JAX's leaf order with TF layouts auto-match onto the target; the
    port's matcher (on JAX's flat order) gives the same weights."""
    cfg = jcfg.ModelConfig(**{**EPC_SMALL, "proxyconv_channels": (8, 8),
                              "compute_dtype": "bfloat16"})
    _, donor = _jax_init(cfg, 1)
    _, target = _jax_init(cfg, 2)
    jflat_target = _flat(target["params"], target["batch_stats"])
    order = jimp.model_leaf_order(target)
    assert timp.model_leaf_order(jflat_target) == order
    dflat = _flat(donor["params"], donor["batch_stats"])
    sd = {}
    for i, (tree, path, _) in enumerate(order):
        arr = dflat[("params/" if tree == "params" else "batch_stats/") + path]
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "kernel":
            arr = arr[None, None]
        elif leaf == "centroids":
            arr = arr.T[None]
        sd[f"var_{i:03d}"] = arr
    got = timp.automatch_state_dict(sd, jflat_target, source="tf")
    want = _flat(*jimp.automatch_state_dict(sd, target, source="tf"))
    _assert_flat_equal(got, want)
    _assert_flat_equal(got, dflat)


def test_automatch_rejects_and_transposes_square_torch():
    base = init_flat_variables(tcfg.ModelConfig(**{**EPC_SMALL, "proxyconv_channels": (8,),
                                                   "lift_channels": (16,)}), 0)
    with pytest.raises(ValueError, match="matched no model leaf"):
        timp.automatch_state_dict({"w": np.zeros((3, 8), np.float32)}, base)
    with pytest.raises(ValueError, match="model leaves unmatched"):
        timp.automatch_state_dict({"w": np.zeros((6, 8), np.float32)}, base)
    w = np.random.default_rng(3).uniform(-1, 1, (8, 8)).astype(np.float32)
    variables = {"params/gate/kernel": np.zeros((8, 8), np.float32),
                 "params/gate/bias": np.zeros((8,), np.float32)}
    got = timp.automatch_state_dict({"fc.weight": w, "fc.bias": w[0]}, variables,
                                    source="torch")
    want = jimp.automatch_state_dict(
        {"fc.weight": w, "fc.bias": w[0]},
        {"params": {"gate": {"kernel": np.zeros((8, 8)), "bias": np.zeros(8)}}}, source="torch")
    np.testing.assert_array_equal(got["params/gate/kernel"], w.T)
    np.testing.assert_array_equal(got["params/gate/kernel"], want[0]["gate"]["kernel"])


def test_automatch_port_state_dict_order():
    """The port's own torch ``state_dict()`` (torch layouts, the head's
    centroids [K, D] listed before its assign Linear [K, D]), names
    scrambled, auto-matches onto the port's flat variables exactly."""
    cfg = tcfg.ModelConfig(**EPC_SMALL)
    donor = load_flat_variables(get_model(cfg, "cpu"), init_flat_variables(cfg, 5))
    keys = list(donor.state_dict())
    assert keys.index("gvlad.centroids") < keys.index("gvlad.assign.weight")
    sd = {f"var_{i:03d}": v for i, v in enumerate(donor.state_dict().values())}
    got = timp.automatch_state_dict(sd, init_flat_variables(cfg, 0), source="torch")
    _assert_flat_equal(got, flat_variables(donor))


# ---------------------------------------------------------------------------
# The convert CLI


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory):
    """A JAX run directory and its ``cli/export`` pair: seeded JAX weights
    through the JAX convert (a checkpoint at step 0), then the JAX export."""
    from epcnet_tpu.cli.convert import main as j_convert
    from epcnet_tpu.cli.export import main as j_export

    d = tmp_path_factory.mktemp("jax_run")
    cfg = jcfg.ExperimentConfig(model=jcfg.ModelConfig(**EPC_SMALL),
                                data=jcfg.DataConfig(num_points=64))
    _, variables = _jax_init(cfg.model, 3)
    np.savez(d / "seed.npz", **_flat(variables["params"], variables["batch_stats"]))
    with open(d / "cfg.json", "w") as f:
        f.write(cfg.to_json())
    log = str(d / "log")
    j_convert(["--source", str(d / "seed.npz"), "--log_dir", log, "--config",
               str(d / "cfg.json")])
    j_export(["--log_dir", log])
    return log


def _embed(log_dir, cloud, out, device="cpu"):
    return tembed.main(["--log_dir", log_dir, "--output", out, cloud, "--device", device])


def test_convert_self_from_jax_export(jax_export, tmp_path):
    """The JAX export pair through the port's convert (self layout): the
    port's checkpoint and pair hold JAX's weights, and the port's embed CLI
    gives JAX's descriptors within 1e-5 (fp32)."""
    from epcnet_tpu.cli.embed import main as j_embed

    cloud = str(tmp_path / "c.npy")
    np.save(cloud, np.random.default_rng(4).uniform(-1, 1, (64, 3)).astype(np.float32))
    log = convert.main(["--device", "cpu", "--source", os.path.join(jax_export, "export.npz"),
                        "--log_dir", str(tmp_path / "port"),
                        "--config", os.path.join(jax_export, "config.json")])
    assert sorted(os.listdir(log)) == ["ckpt", "config.json", "export.json", "export.npz"]
    assert os.listdir(os.path.join(log, "ckpt")) == ["step_0.pt"]
    with np.load(os.path.join(jax_export, "export.npz")) as z, \
            np.load(os.path.join(log, "export.npz")) as p:
        _assert_flat_equal(dict(p), dict(z))
    got = _embed(log, cloud, str(tmp_path / "t.npy"))
    j_embed(["--log_dir", jax_export, "--output", str(tmp_path / "j.npy"), cloud])
    np.testing.assert_allclose(got, np.load(tmp_path / "j.npy"), rtol=0, atol=1e-5)


def test_convert_name_maps_and_torch_source(jax_export, tmp_path):
    """The same weights renamed to the tf1_epcnet layout (NAME_MAPS
    inverted), as an unlabelled torch dict (.pt, auto) and as a pickle
    (self): each converts to JAX's weights exactly."""
    with np.load(os.path.join(jax_export, "export.npz")) as z:
        flat = {k: z[k] for k in z.files}
    cfg_json = os.path.join(jax_export, "config.json")

    def converted(src, *extra):
        out = str(tmp_path / ("log_" + os.path.basename(src)))
        log = convert.main(["--device", "cpu", "--source", src, "--log_dir", out,
                            "--config", cfg_json, *extra])
        with np.load(os.path.join(log, "export.npz")) as p:
            return {k: p[k] for k in p.files}

    tf = {}
    for pat, tmpl in timp.NAME_MAPS["tf1_epcnet"].items():
        name = timp._flat_name(tmpl)
        src = pat.replace("(?:g?vlad/)?", "vlad/").replace("(?:hidden1|group)", "hidden1") \
            .replace("(?:hidden2|out)", "hidden2")
        src = src.replace("(?:pconv|proxyconv|proxy_conv|epc_conv)", "pconv")
        src = src.replace("(?:conv5|agg1|lift1)", "conv5").replace("(?:conv6|agg2|lift2)", "conv6")
        v = flat[name]
        leaf = name.rsplit("/", 1)[-1]
        tf[src] = v[None, None] if leaf == "kernel" else v.T[None] if leaf == "centroids" else v
    np.savez(tmp_path / "tf.npz", **tf)
    _assert_flat_equal(converted(str(tmp_path / "tf.npz"), "--name_map", "tf1_epcnet"), flat)

    model = load_flat_variables(get_model(tcfg.ModelConfig(**EPC_SMALL), "cpu"), flat)
    torch.save({"state_dict": {f"v{i}": t for i, t in enumerate(model.state_dict().values())}},
               tmp_path / "anon.pt")
    _assert_flat_equal(converted(str(tmp_path / "anon.pt")), flat)  # auto, torch layouts

    import pickle

    with open(tmp_path / "w.pkl", "wb") as f:
        pickle.dump(flat, f)
    _assert_flat_equal(converted(str(tmp_path / "w.pkl")), flat)  # self, auto-detected


def test_convert_rejects_truncated_archive(jax_export, tmp_path):
    with np.load(os.path.join(jax_export, "export.npz")) as z:
        part = {k: z[k] for k in z.files[:-3]}
    np.savez(tmp_path / "part.npz", **part)
    with pytest.raises(ValueError, match="truncated archive"):
        convert.main(["--device", "cpu", "--source", str(tmp_path / "part.npz"), "--log_dir",
                      str(tmp_path / "out"), "--config",
                      os.path.join(jax_export, "config.json")])
    np.savez(tmp_path / "empty.npz")
    with pytest.raises(ValueError, match="truncated archive"):
        convert.main(["--device", "cpu", "--source", str(tmp_path / "empty.npz"), "--log_dir",
                      str(tmp_path / "out2"), "--name_map", "self"])
    with pytest.raises(ValueError, match="extension"):
        convert.main(["--device", "cpu", "--source", str(tmp_path / "x.weird"), "--log_dir",
                      str(tmp_path / "out3")])
    manifest = json.load(open(os.path.join(jax_export, "export.json")))
    assert len(manifest["leaves"]) == len(part) + 3
