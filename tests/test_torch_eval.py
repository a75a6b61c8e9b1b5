"""The port's evaluation against the JAX package's, on the CPU: ``get_recall``
(exactly equal), ``evaluate_dataset`` and ``embed_entries`` with the same
weights on both sides, and the ``evaluate`` and ``embed`` CLIs — the JAX
CLIs on an Orbax checkpoint, the port's on the export pair of the same
weights. Descriptors in fp32 agree to 1e-5 max abs; recall arrays, results
files and pickles are equal."""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from epcnet_tpu import configs as jcfg
from epcnet_tpu.cli import embed as j_embed_cli
from epcnet_tpu.cli import evaluate as j_eval_cli
from epcnet_tpu.cli.export import flatten_variables
from epcnet_tpu.evals import recall as j_recall
from epcnet_tpu.ops.retrieval import topk_neighbors as j_topk
from epcnet_tpu.train import build_embed_fn as j_build_embed_fn
from epcnet_tpu.train.checkpoint import CheckpointManager
from epcnet_tpu.train.state import create_train_state

from epcnet_torch import configs as tcfg
from epcnet_torch.cli import embed as t_embed_cli
from epcnet_torch.cli import evaluate as t_eval_cli
from epcnet_torch.cli import generate_tuples as t_gen
from epcnet_torch.data import synthetic as t_syn
from epcnet_torch.data import tuples as t_tup
from epcnet_torch.evals import recall as t_recall
from epcnet_torch.train.step import build_embed_fn
from epcnet_torch.weights import save_export
from test_torch_models import FP32_TOL, GOLDEN_KW, _seeded_stats

N = 128


def _recall_both(db, q, gt, **kw):
    want = j_recall.get_recall(db, q, gt, **kw)
    got = t_recall.get_recall(db, q, gt, device="cpu", **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    return got


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_get_recall_seeded(quantize):
    rng = np.random.default_rng(0)
    db = _unit(rng.standard_normal((300, 32)))
    pick = rng.integers(0, 300, 40)
    q = _unit(db[pick] + 0.4 * rng.standard_normal((40, 32)))
    gt = [[int(p)] + [int(j) for j in rng.integers(0, 300, int(rng.integers(0, 3)))]
          for p in pick]
    r, p1, n = _recall_both(db, q, gt, top_k=25, quantize=quantize)
    assert n == 40 and 0 < r[0] < r[-1] <= 1 and (np.diff(r) >= 0).all()
    _recall_both(db, q, gt, top_k=5, quantize=quantize)


def test_get_recall_duplicates_break_to_lowest_index():
    """Rows 10-19 repeat rows 0-9 on a grid of quarters, so distances are
    exact and tie: the lower index wins, in both packages."""
    rng = np.random.default_rng(1)
    db = (rng.integers(-4, 5, (40, 8)) / 4).astype(np.float32)
    db[10:20] = db[0:10]
    q = db[0:10].copy()
    r, p1, n = _recall_both(db, q, [[i + 10] for i in range(10)], top_k=3)
    assert r[0] == 0.0 and r[1] == 1.0 and p1 == 0.0 and n == 10
    r, _, _ = _recall_both(db, q, [[i] for i in range(10)], top_k=3)
    assert r[0] == 1.0
    _recall_both(db, q, [[i + 10] for i in range(10)], top_k=3, quantize="int8")


def test_get_recall_empty_ground_truth():
    rng = np.random.default_rng(2)
    db, q = _unit(rng.standard_normal((30, 16))), _unit(rng.standard_normal((6, 16)))
    r, _, n = _recall_both(db, q, [[0], [], [3, 4], [], [], [29]], top_k=4)
    assert n == 3
    r, p1, n = _recall_both(db, q, [[]] * 6, top_k=4)
    assert n == 0 and p1 == 0.0 and not r.any() and r.shape == (4,)
    _recall_both(db[:3], q, [[0], [1], [2], [], [0, 2], [1]], top_k=25)  # k > |DB|


def test_get_recall_one_percent_past_top_k():
    """|DB| = 2600: top-1% takes k = 26 > top_k = 25. Queries whose
    ground truth sits at rank 25 count for top-1% and not for recall@25."""
    rng = np.random.default_rng(3)
    db = _unit(rng.standard_normal((2600, 32)))
    q = _unit(rng.standard_normal((30, 32)))
    idx = np.asarray(j_topk(jnp.asarray(q), jnp.asarray(db), 26)[0])
    gt = [[int(idx[i, 25])] if i % 3 == 0 else [int(idx[i, i % 20])] for i in range(30)]
    r, p1, n = _recall_both(db, q, gt, top_k=25)
    assert p1 == 1.0 and r[-1] == pytest.approx(2 / 3)
    _recall_both(db, q, gt, top_k=25, quantize="int8")


def test_get_recall_rejects():
    db = np.eye(4, dtype=np.float32)
    with pytest.raises(ValueError, match="quantize"):
        t_recall.get_recall(db, db, [[0]] * 4, quantize="int4", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
        t_recall.get_recall(db, db, [[0]] * 4, mesh=object(), device="cpu")


def test_latency_probe_keys():
    db = _unit(np.random.default_rng(4).standard_normal((80, 32)))
    out = t_recall.retrieval_latency_probe(db, num_queries=12, top_k=25, device="cpu")
    assert set(out) == {"p50_ms", "p99_ms", "device_ms"}
    assert all(np.isfinite(v) and v >= 0 for v in out.values())
    assert out["p99_ms"] >= out["p50_ms"] > 0
    with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
        t_recall.retrieval_latency_probe(db, 4, mesh=object(), device="cpu")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 3-run dataset and a 2-run second region (N=128, difficulty 0.5),
    the test pickles, and one fp32 tiny EPC-Net with seeded BN statistics:
    a JAX log dir (config.json + Orbax checkpoint) and the port's export
    pair of the same weights."""
    base = tmp_path_factory.mktemp("eval")
    root = str(base / "data")
    t_gen.main(["--dataset_root", root, "--synthetic", "--synthetic_runs", "3",
                "--synthetic_submaps", "6", "--num_points", str(N),
                "--synthetic_difficulty", "0.5"])
    t_gen.main(["--dataset_root", root, "--mode", "test"])
    t_syn.generate_synthetic_dataset(root, num_runs=2, submaps_per_run=5, num_points=N,
                                     runs_subdir="university", difficulty=0.5,
                                     origin=(5810000.0, 610000.0))
    kw = {**GOLDEN_KW["epcnet"], "compute_dtype": "float32"}
    jc = jcfg.ExperimentConfig(model=jcfg.ModelConfig(**kw),
                               data=jcfg.DataConfig(num_points=N, dataset_root=root),
                               eval=jcfg.EvalConfig(batch_size=4))
    state = create_train_state(jc.model, jc.train, num_points=N)
    state = state.replace(batch_stats=_seeded_stats(state.batch_stats,
                                                    np.random.RandomState(5)))
    log_dir = str(base / "log")
    os.makedirs(log_dir)
    with open(os.path.join(log_dir, "config.json"), "w") as f:
        f.write(jc.to_json())
    mgr = CheckpointManager(f"{log_dir}/ckpt")
    mgr.save(state)
    mgr._mgr.wait_until_finished()
    flat = flatten_variables(state.params, state.batch_stats)
    tc = tcfg.ExperimentConfig.from_json(jc.to_json())
    save_export(os.path.join(log_dir, "export"), tc, flat)
    return {"root": root, "log_dir": log_dir, "state": state, "jc": jc, "tc": tc,
            "flat": flat}


def _regions(root):
    """Two regions; oxford's second query run is emptied."""
    db, q = t_tup.load_pickle(os.path.join(root, "oxford_evaluation_database.pickle")), \
        t_tup.load_pickle(os.path.join(root, "oxford_evaluation_query.pickle"))
    q[1] = {}
    uni = t_tup.construct_query_and_database_sets(t_tup.scan_runs(root, "university"))
    return {"oxford": (db, q), "university": uni}


def test_evaluate_dataset_matches(world):
    jc, tc, state = world["jc"], world["tc"], world["state"]
    regions = _regions(world["root"])
    want = j_recall.evaluate_dataset(j_build_embed_fn(jc.model), state.params,
                                     state.batch_stats, regions, jc.data, jc.eval)
    embed = build_embed_fn(tc.model, "cpu", variables=world["flat"])
    got = t_recall.evaluate_dataset(embed, regions, tc.data, tc.eval)
    assert list(got) == list(want) == ["oxford", "university", "average"]
    for name in want:
        np.testing.assert_array_equal(got[name]["recall_at"], want[name]["recall_at"])
        assert got[name]["recall_at_1pct"] == want[name]["recall_at_1pct"]
        assert got[name].get("evaluated_pairs") == want[name].get("evaluated_pairs")
    assert got["oxford"]["evaluated_pairs"] == 4  # 3 x 2 pairs, 2 with the empty run
    assert 0 < got["average"]["recall_at"][-1] <= 1
    with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
        t_recall.evaluate_dataset(embed, regions, tc.data, tc.eval, mesh=object())


def test_embed_entries_match_and_padding(world):
    """fp32 descriptors within 1e-5 of JAX's; a batch of 4 over 6 entries
    (a padded last batch) gives batch size 1's descriptors."""
    jc, tc, state = world["jc"], world["tc"], world["state"]
    entries = _regions(world["root"])["oxford"][0][0]
    assert len(entries) == 6
    want = j_recall.embed_entries(j_build_embed_fn(jc.model), state.params,
                                  state.batch_stats, entries, jc.data, 4)
    embed = build_embed_fn(tc.model, "cpu", variables=world["flat"])
    got = t_recall.embed_entries(embed, entries, tc.data, 4)
    assert got.shape == (6, 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=0)
    one = t_recall.embed_entries(embed, entries, tc.data, 1)
    np.testing.assert_allclose(got, one, atol=1e-6, rtol=0)


def test_evaluate_cli_matches_jax(world, tmp_path):
    """Both CLIs, scan form: the same results.txt (the reference's format)
    and results.json; the port's json is evaluate_dataset's numbers; the
    pickle form gives the same averages."""
    root, log_dir = world["root"], world["log_dir"]
    outs = {}
    for name, main, extra in (("jax", j_eval_cli.main, []),
                              ("torch", t_eval_cli.main, ["--device", "cpu"])):
        outs[name] = str(tmp_path / f"{name}.txt")
        main(["--dataset_root", root, "--log_dir", log_dir, "--output", outs[name]] + extra)
    text = open(outs["torch"]).read()
    assert text == open(outs["jax"]).read()
    assert text.startswith("== oxford ==\nAverage Recall @N:\n[") and "== average ==" in text
    assert re.search(r"Average Top 1% Recall: \d+\.\d\d\n", text)
    got = json.load(open(str(tmp_path / "torch.json")))
    assert got == json.load(open(str(tmp_path / "jax.json")))

    tc = world["tc"]
    embed = build_embed_fn(tc.model, "cpu", variables=world["flat"])
    sets = t_tup.construct_query_and_database_sets(t_tup.scan_runs(root))
    direct = t_recall.evaluate_dataset(embed, {"oxford": sets}, tc.data, tc.eval)
    for name in ("oxford", "average"):
        assert got[name]["recall_at"] == [float(x) for x in direct[name]["recall_at"]]
        assert got[name]["recall_at_1pct"] == direct[name]["recall_at_1pct"]

    out = t_eval_cli.main([
        "--log_dir", log_dir, "--device", "cpu", "--output", str(tmp_path / "p.txt"),
        "--database_pickle", os.path.join(root, "oxford_evaluation_database.pickle"),
        "--query_pickle", os.path.join(root, "oxford_evaluation_query.pickle")])
    assert list(out["results"]) == ["pickled", "average"] and out["latency"] is None
    assert json.load(open(str(tmp_path / "p.json")))["average"] == got["average"]


def test_evaluate_cli_flags(world, tmp_path, capsys):
    root, log_dir = world["root"], world["log_dir"]
    base = ["--dataset_root", root, "--log_dir", log_dir, "--device", "cpu",
            "--output", str(tmp_path / "r.txt")]
    with pytest.raises(SystemExit):
        t_eval_cli.main(base + ["--database_pickle", "db.pickle"])
    assert "must be given together" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
        t_eval_cli.main(base + ["--mesh"])
    out = t_eval_cli.main(base + ["--latency_probe", "--quantize", "int8",
                                  "--set", "eval.latency_probe_queries=16"])
    lat = out["latency"]
    assert set(lat) == {"p50_ms", "p99_ms", "device_ms"}
    assert all(np.isfinite(v) for v in lat.values())
    line = [s for s in capsys.readouterr().out.splitlines() if "retrieval latency" in s][0]
    assert re.search(r"p50=[\d.]+ms p99=[\d.]+ms device=[\d.]+ms", line)
    assert 0 <= out["results"]["average"]["recall_at"][0] <= 1


def _clouds(tmp_path, sizes):
    """[.npy, .bin, .bin, ...] files of seeded clouds, and the clouds."""
    rng = np.random.default_rng(7)
    clouds, paths = [], []
    for i, n in enumerate(sizes):
        c = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        p = str(tmp_path / (f"c{i}.npy" if i == 0 else f"c{i}.bin"))
        np.save(p, c) if i == 0 else c.astype(np.float64).tofile(p)
        clouds.append(c)
        paths.append(p)
    return clouds, paths


def test_embed_cli(world, tmp_path):
    """.bin and .npy inputs: the port's embed rows in input order, within
    1e-5 of the JAX CLI's; the manifest; JAX's error on a wrong N; and
    --points_sharded refused."""
    log_dir = world["log_dir"]
    clouds, paths = _clouds(tmp_path, [N] * 5)
    out = str(tmp_path / "descs.npy")
    got = t_embed_cli.main(["--log_dir", log_dir, "--output", out, "--batch_size", "2",
                            "--device", "cpu", *paths])
    np.testing.assert_array_equal(np.load(out), got)
    embed = build_embed_fn(world["tc"].model, "cpu", variables=world["flat"])
    np.testing.assert_allclose(got, embed(np.stack(clouds)).numpy(), atol=1e-6, rtol=0)
    assert json.load(open(str(tmp_path / "descs.json"))) == {"files": paths,
                                                            "shape": [5, 256]}
    j_embed_cli.main(["--log_dir", log_dir, "--output", str(tmp_path / "j.npy"),
                      "--batch_size", "2", *paths])
    np.testing.assert_allclose(got, np.load(str(tmp_path / "j.npy")), atol=FP32_TOL, rtol=0)

    (tmp_path / "bad").mkdir()
    _, bad_paths = _clouds(tmp_path / "bad", [N, N + 3])
    errs = []
    for main, extra in ((j_embed_cli.main, []), (t_embed_cli.main, ["--device", "cpu"])):
        with pytest.raises(ValueError) as e:
            main(["--log_dir", log_dir, "--output", str(tmp_path / "x.npy"), *extra,
                  *bad_paths])
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "has 131 points but model.num_points=128" in errs[1]
    with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
        t_embed_cli.main(["--log_dir", log_dir, "--points_sharded", "--device", "cpu",
                          *paths])


@pytest.mark.parametrize("cli", ["generate_tuples", "evaluate", "embed"])
def test_cli_runs_as_module(cli):
    """``python -m epcnet_torch.cli.<name>`` reaches the CLI's parser."""
    out = subprocess.run([sys.executable, "-m", f"epcnet_torch.cli.{cli}", "--help"],
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.startswith("usage:"), out.stderr
