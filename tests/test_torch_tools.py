"""The port's last modules against the JAX package's on the CPU: the
compile-cache flag (``utils/compile_cache.py``), the benchmark CLI
(``cli/benchmark.py``) and the multi-seed protocol runner
(``scripts/multiseed.py``) at a tiny size."""

import json
import os
import re

import pytest
import torch

from epcnet_torch.ops import _build
from epcnet_torch.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN_TREE = _build.CSRC / "build"


@pytest.fixture
def build_dir(monkeypatch):
    """The build directory restored after the test; no cache variable set."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)


@pytest.mark.parametrize("flag,env,want", [
    (None, None, "in-tree"),
    (None, "env", "env"),
    ("flag", None, "flag"),
    ("flag", "env", "flag"),
])
def test_cache_dir_resolution(build_dir, monkeypatch, tmp_path, flag, env, want):
    if env:
        monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / env))
    got = compile_cache.enable_compilation_cache(str(tmp_path / flag) if flag else None)
    expect = IN_TREE if want == "in-tree" else tmp_path / want
    assert got == str(expect) and _build.BUILD_DIR == expect
    for name in _build.SOURCES:  # every kernel is built and looked up there
        src, lib = _build._target(name)
        assert lib.parent == expect and lib.name.startswith(f"lib{name}-")
        assert src == _build.CSRC / f"{name}.cu"


def test_cache_dir_names_stay_content_addressed(build_dir, tmp_path):
    before = _build._target("knn_adj")[1].name
    compile_cache.enable_compilation_cache(str(tmp_path))
    assert _build._target("knn_adj")[1] == tmp_path / before
    # a later call with nothing set keeps the directory, as JAX's keeps its cache
    assert compile_cache.enable_compilation_cache() == str(tmp_path)


def _jax_cli_flags(name):
    src = open(os.path.join(ROOT, "epcnet_tpu", "cli", f"{name}.py")).read()
    return "add_cli_arg(ap)" in src


@pytest.mark.parametrize("name", ["benchmark", "distill", "embed", "evaluate", "serve",
                                  "train"])
def test_every_wired_cli_takes_the_flag(build_dir, monkeypatch, tmp_path, name):
    import importlib

    assert _jax_cli_flags(name)  # JAX wires it here too
    cli = importlib.import_module(f"epcnet_torch.cli.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"benchmark": [], "distill": ["--dataset_root", str(tmp_path),
                                         "--teacher_log_dir", str(tmp_path)],
            "embed": ["--log_dir", str(tmp_path), "cloud.bin"],
            "evaluate": ["--log_dir", str(tmp_path)], "serve": ["--log_dir", str(tmp_path)],
            "train": ["--dataset_root", str(tmp_path), "--log_dir", str(tmp_path)]}[name]
    cache = tmp_path / "kernels"
    # parsed and applied before the device check, which then refuses
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv + ["--compilation_cache_dir", str(cache)])
    assert _build.BUILD_DIR == cache


def test_benchmark_keys_cover_jax(build_dir, capsys):
    from epcnet_torch.cli import benchmark

    src = open(os.path.join(ROOT, "epcnet_tpu", "cli", "benchmark.py")).read()
    jax_keys = set(re.findall(r'out\["(\w+)"\]', src)) | {"backend", "batch", "num_points"}
    assert jax_keys == set(benchmark.KEY_MAP)
    out = benchmark.main(["--device", "cpu", "--json", "--batch", "2", "--num_points", "64",
                          "--iters", "1", "--db_size", "64"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    # every JAX key has its port key, but the card-only kNN kernel's
    assert set(out) == set(benchmark.KEY_MAP.values()) - {"knn_cuda_ms"}
    assert out["backend"] == "cpu" and (out["batch"], out["num_points"]) == (2, 64)
    assert out["embed_device_ms"] is None and out["submaps_per_sec_device"] is None
    assert all(out[k] > 0 for k in ("knn_plain_ms", "vlad_highest_ms", "vlad_default_ms",
                                    "embed_wall_ms", "retrieval_1q_ms"))


TINY_SETS = ("model.num_points=128", "model.knn_k=6", "model.proxyconv_channels=8,8",
             "model.lift_channels=16,32", "model.feature_dim=32", "model.vlad_clusters=4",
             "model.vlad_groups=2", "model.vlad_group_dim=8", "data.num_points=128",
             "data.num_negatives=3", "data.num_positives=1",
             "train.checkpoint_every_steps=1000000")


def test_multiseed_runs_small_and_resumes(tmp_path):
    from epcnet_torch.scripts import multiseed

    root = str(tmp_path / "ms")
    kw = dict(seeds=(1234,), epochs=1, device="cpu", teacher_only=True, pointnetvlad=False,
              sets=TINY_SETS, data_shape=(2, 20, 128))
    out = multiseed.run(root, **kw)
    assert json.load(open(os.path.join(root, "multiseed.json"))) == json.loads(json.dumps(out))
    for key in ("metric", "protocol", "seeds", "teacher", "student", "gap", "untrained",
                "pointnetvlad", "band", "device", "tensorboard_mirrors"):
        assert key in out, key
    (row,) = out["seeds"]
    assert row["seed"] == 1234 and not row["reused"] and row["student_recall1"] is None
    assert 0.0 <= row["teacher_recall1"] <= 1.0 and row["seconds"]["teacher"] > 0
    assert out["teacher"]["n"] == 1 and out["student"]["n"] == 0
    assert 0.0 <= out["untrained"]["recall1"] <= 1.0 and out["device"] is None
    assert "teacher_ok" in out["band"]
    # a run off the protocol says so
    assert out["protocol"].startswith("2x20x128 ") and "model.num_points=128" in out["protocol"]
    assert out["sets"] == list(TINY_SETS) and out["data_shape"] == [2, 20, 128]
    assert out["epochs"] == 1
    for f in ("teacher.log", "export_teacher.log", "eval_teacher.log"):
        assert os.path.isfile(os.path.join(root, "s1234", f)), f
    again = multiseed.run(root, **kw)  # the seed's results.json: reused, nothing retrained
    assert again["seeds"][0]["reused"] and again["seeds"][0]["seconds"] == {}
    assert again["teacher"] == out["teacher"] and again["seconds"] == {}
    # PointNetVLAD's reference recipe on top (its published widths), the seed
    # and the floor reused
    sets = [kv for kv in TINY_SETS if not kv.startswith("model.")] + ["model.num_points=128"]
    pnv = multiseed.run(root, **{**kw, "pointnetvlad": True, "sets": sets})
    assert pnv["seeds"][0]["reused"] and 0.0 <= pnv["pointnetvlad"]["recall1"] <= 1.0
    assert pnv["seconds"]["pnv_pointnetvlad"] > 0 and "pnv_ok" in pnv["band"]
    with open(os.path.join(root, "pnv", "log", "config.json")) as f:
        assert json.load(f)["model"]["name"] == "pointnetvlad"
