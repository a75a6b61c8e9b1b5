"""``PlaceIndex.from_checkpoint`` and the HTTP server
(``epcnet_torch/cli/serve.py``) on the CPU: from a port training run; side
by side with the JAX package's ``make_server`` on the same weights (through
the weight bridge) and the same submaps; and the CLI in a subprocess
(warmup before bind, SIGTERM drain, ``--save_on_exit``), each wait bounded
by a deadline; and ``scripts/serve_scale.py`` at a tiny size.

Tolerances: ids and status codes equal; sqdists within 1e-5 and
descriptors within 1e-5 of JAX's (fp32); the CLI's saved DB within 1e-6 of
the same weights' descriptors in this process.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from epcnet_tpu.cli.export import flatten_variables
from epcnet_tpu.cli.serve import make_server as j_make_server
from epcnet_tpu.configs import ModelConfig as JModelConfig
from epcnet_tpu.configs import TrainConfig as JTrainConfig
from epcnet_tpu.serve import PlaceIndex as JPlaceIndex
from epcnet_tpu.train.state import create_train_state as j_create_train_state
from epcnet_tpu.train.step import build_embed_fn as j_build_embed_fn

from epcnet_torch.cli import serve as serve_cli
from epcnet_torch.cli import train as train_cli
from epcnet_torch.configs import DataConfig, ExperimentConfig, ModelConfig
from epcnet_torch.serve import PlaceIndex
from epcnet_torch.train.step import build_embed_fn
from epcnet_torch.weights import init_flat_variables, save_export

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(num_points=128, knn_k=8, use_pallas=False, proxyconv_channels=(16, 16),
            lift_channels=(32, 64), feature_dim=64, vlad_clusters=8, vlad_groups=4,
            vlad_group_dim=16, compute_dtype="float32")
TRAIN_SETS = ["model.num_points=128", "model.knn_k=6", "model.proxyconv_channels=8,8",
              "model.lift_channels=16,32", "model.feature_dim=32", "model.vlad_clusters=4",
              "model.vlad_groups=2", "model.vlad_group_dim=8", "data.num_points=128",
              "data.num_negatives=3", "data.num_positives=1", "train.max_epoch=1",
              "train.mining_start_epoch=99", "train.checkpoint_every_steps=1000000"]


def _clouds(seed, n, npts=128):
    return np.random.default_rng(seed).uniform(-1, 1, (n, npts, 3)).astype(np.float32)


def test_from_checkpoint_after_cli_train(tmp_path):
    """A port training run serves through ``from_checkpoint``: every added
    submap retrieves itself, with the trainer's model's descriptors."""
    log = str(tmp_path / "log")
    args = ["--dataset_root", str(tmp_path / "ds"), "--log_dir", log, "--synthetic",
            "--device", "cpu"]
    tr = train_cli.main(args + [a for s in TRAIN_SETS for a in ("--set", s)])
    idx = PlaceIndex.from_checkpoint(log, embed_batch=4, device="cpu")
    assert idx.num_points == 128 and idx.dim == 256
    pts = _clouds(0, 6)
    idx.add(pts)
    ids, dists = idx.query(pts[:2], k=1)
    np.testing.assert_array_equal(ids[:, 0], [0, 1])
    assert dists.max() < 1e-4
    with torch.inference_mode():
        want = tr.state.model.eval()(torch.tensor(pts[:4])).numpy()
    np.testing.assert_array_equal(idx.embed(pts[:4]), want)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        PlaceIndex.from_checkpoint(str(tmp_path / "nothing"), device="cpu")
    from epcnet_torch.configs import MeshConfig
    from epcnet_torch.parallel import make_mesh

    sharded = PlaceIndex.from_checkpoint(
        log, mesh=make_mesh(MeshConfig(data_axis=1, db_axis=2), ["cpu", "cpu"]))
    sharded.add(pts)
    np.testing.assert_array_equal(sharded.query(pts[:2], k=3)[0], idx.query(pts[:2], k=3)[0])
    assert sharded.metrics()["sharded"]


def _call(base, path, payload=None, raw=None):
    """(status, JSON body) of one request."""
    data = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(base + path, data, {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def servers():
    """The JAX and the port server over the same weights, each on port 0."""
    jcfg = JModelConfig(**TINY)
    state = j_create_train_state(jcfg, JTrainConfig(), num_points=128)
    flat = flatten_variables(state.params, state.batch_stats)
    jidx = JPlaceIndex(j_build_embed_fn(jcfg), state.params, state.batch_stats,
                       descriptor_dim=256, embed_batch=4, block_rows=64)
    tidx = PlaceIndex(build_embed_fn(ModelConfig(**TINY), "cpu", variables=flat),
                      descriptor_dim=256, embed_batch=4, block_rows=64, device="cpu")
    out = []
    for make, idx in ((j_make_server, jidx), (serve_cli.make_server, tidx)):
        srv, sched = make(idx, port=0, k=3, max_wait_ms=20.0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        out.append((f"http://127.0.0.1:{srv.server_address[1]}", srv, sched))
    yield [o[0] for o in out]
    for _, srv, sched in out:
        srv.shutdown()
        srv.server_close()
        sched.stop()


def test_http_server_matches_jax(servers):
    jbase, tbase = servers
    pts = _clouds(1, 6)
    for base in servers:
        assert _call(base, "/healthz") == (200, {"ok": True, "size": 0, "dim": 256})
        assert _call(base, "/add", {"points": pts.tolist(),
                                    "metadata": [f"s{i}" for i in range(6)]}) == (200, {"size": 6})
    (js, jd), (ts, td) = (_call(b, "/embed", {"points": pts[:2].tolist()}) for b in servers)
    assert js == ts == 200
    np.testing.assert_allclose(td["descriptors"], jd["descriptors"], rtol=0, atol=1e-5)

    def queries(base):  # concurrent single-submap queries share micro-batches
        with ThreadPoolExecutor(4) as ex:
            return list(ex.map(lambda i: _call(base, "/query", {"points": pts[i].tolist(),
                                                               "k": 3}), range(6)))

    for (jc, jr), (tc, tr) in zip(queries(jbase), queries(tbase)):
        assert jc == tc == 200
        assert tr["ids"] == jr["ids"] and tr["metadata"] == jr["metadata"]
        np.testing.assert_allclose(tr["sqdists"], jr["sqdists"], rtol=0, atol=1e-5)
    (jc, jr), (tc, tr) = (_call(b, "/query_batch", {"points": pts[:3].tolist(), "k": 2})
                          for b in servers)
    assert jc == tc == 200 and tr["ids"] == jr["ids"]
    assert [row[0] for row in tr["ids"]] == [0, 1, 2]
    np.testing.assert_allclose(tr["sqdists"], jr["sqdists"], rtol=0, atol=1e-5)

    bad = [("/query", {"k": 1}), ("/query", {"points": pts[0].tolist(), "k": 0}),
           ("/query", {"points": pts[0].tolist(), "k": 4}),
           ("/query_batch", {"points": pts[0].tolist(), "k": 1}),
           ("/query_batch", {"points": pts[:1].tolist(), "k": 9}),
           ("/add", {"points": pts[:2].tolist(), "metadata": ["one"]}),
           ("/embed", {"points": "xyz"}), ("/nowhere", {"k": 1})]
    for path, body in bad:
        codes = [_call(b, path, body)[0] for b in servers]
        assert codes[0] == codes[1] and codes[0] in (400, 404), (path, codes)
    codes = [_call(b, "/query", raw=b"{not json")[0] for b in servers]
    assert codes == [400, 400]
    got = [_call(b, "/nowhere") for b in servers]
    assert got[0][0] == got[1][0] == 404 and "error" in got[1][1]
    (_, jm), (_, tm) = (_call(b, "/metrics") for b in servers)
    assert set(tm) == set(jm) == {"index", "scheduler"}
    assert set(tm["scheduler"]) == set(jm["scheduler"]) | {"queue_wait_s"}
    assert set(tm["index"]) <= set(jm["index"]) | {"dev_syncs"}
    assert tm["index"]["size"] == jm["index"]["size"] == 6


def test_serve_cli_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="no port checkpoint"):
        serve_cli.main(["--log_dir", str(tmp_path), "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="no port checkpoint"):  # --mesh gets as far
        serve_cli.main(["--log_dir", str(tmp_path), "--mesh", "--device", "cpu"])


def test_serve_cli_subprocess_warmup_and_drain(tmp_path):
    """``python -m epcnet_torch.cli.serve --device cpu`` over an export
    pair: it warms up before it binds, answers, and on SIGTERM drains and
    persists the DB (``--save_on_exit``); every wait has a deadline."""
    cfg = ExperimentConfig(model=ModelConfig(**TINY), data=DataConfig(num_points=128))
    flat = init_flat_variables(cfg.model, 4)
    save_export(str(tmp_path / "log" / "export"), cfg, flat)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    saved, logf = str(tmp_path / "saved.npz"), str(tmp_path / "serve.log")
    env = {**os.environ, "PYTHONPATH": ROOT}
    with open(logf, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "epcnet_torch.cli.serve", "--log_dir",
             str(tmp_path / "log"), "--port", str(port), "--embed_batch", "4", "--k", "3",
             "--save_on_exit", saved, "--device", "cpu"],
            stdout=out, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
    base = f"http://127.0.0.1:{port}"
    pts = _clouds(2, 3)
    try:
        deadline = time.time() + 120
        health = None
        while time.time() < deadline and health is None:
            assert proc.poll() is None, open(logf).read()[-2000:]
            try:
                health = _call(base, "/healthz")
            except OSError:
                time.sleep(0.25)
        assert health == (200, {"ok": True, "size": 0, "dim": 256}), open(logf).read()
        assert _call(base, "/add", {"points": pts.tolist(), "metadata": ["a", "b", "c"]}) == \
            (200, {"size": 3})
        code, q = _call(base, "/query", {"points": pts[1].tolist(), "k": 1})
        assert code == 200 and q["ids"] == [1] and q["metadata"] == ["b"]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()  # never leak a live server into the rest of the run
            proc.wait(timeout=30)
            raise
    text = open(logf).read()
    assert rc == 0, text[-2000:]
    assert text.index("warmup: embed+query ran") < text.index("serving on"), text
    assert "server stopped" in text
    with np.load(saved, allow_pickle=True) as data:
        db, meta = data["db"], list(data["meta"])
    ix = PlaceIndex(build_embed_fn(cfg.model, "cpu", variables=flat), 256, embed_batch=4,
                    device="cpu")
    np.testing.assert_allclose(db, ix.embed(pts), rtol=0, atol=1e-6)
    assert meta == ["a", "b", "c"]
    ix.load_db(saved)
    ids, _ = ix.query(pts, k=1)
    np.testing.assert_array_equal(ids[:, 0], [0, 1, 2])


def test_serve_scale_script_on_cpu(tmp_path):
    """``scripts/serve_scale.py`` at a tiny size on the CPU: the ladder's
    planted submaps at rank 0 and its blocked retrieval equal to the full
    sort, the load test self-retrieving, and every answer of the
    background ingest the exact top-5 of a prefix, all rows visible after
    ``flush()``, in the window at one capacity and in the one that crosses
    a capacity doubling (host clocks: no time is checked)."""
    from epcnet_torch.scripts import serve_scale

    out = str(tmp_path / "serve_scale.json")
    res = serve_scale.main(["--device", "cpu", "--rungs", "1000,5000", "--iters", "3",
                            "--load", "--ingest", "--ingest_rows", "6000", "--out", out])
    assert json.load(open(out)) == json.loads(json.dumps(res))
    for rows in res["ladder"].values():
        assert [r["rows"] for r in rows] == [1000, 5000]
        assert all(r["planted_rank0"] == "4/4" for r in rows)
        assert rows[1]["plain_vs_blocked"]["ids_equal"]
        assert rows[1]["retrieval_transient_bytes"] is None  # not measured on the CPU
    assert res["load"]["queries"] == 96 and not res["load"]["self_retrieval_fails"]
    for name, capacity in (("ingest", "capacity_fixed"), ("ingest_growth", "capacity_doubled")):
        ing = res[name]
        assert ing["n_bad_answers"] == 0 and not ing["errors"] and ing["threads_alive"] == 0
        assert ing["all_visible_after_flush"] and ing[capacity], (name, ing)
        assert ing["answers_checked"] > 0 and ing["chunks_synced"] >= 1
    assert not res["ingest"]["growth_chunk_ms"]
    assert len(res["ingest_growth"]["growth_chunk_ms"]) == 1
