"""The port stands alone: it loads no JAX and nothing of ``epcnet_tpu``, it
keeps its own copy of the configs in step with the JAX package's, and its
entry points refuse to carry on on the CPU when the card is missing."""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from epcnet_tpu import configs as jcfg

from epcnet_torch import configs as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "epcnet_tpu")
# Libraries the JAX package's data tools use that the card's machine may not
# have: the port reads csv files with the csv module and builds KD-trees
# with scipy instead
HOST_ONLY = ("pandas", "sklearn")


def test_import_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import epcnet_torch\n"
        "for m in pkgutil.walk_packages(epcnet_torch.__path__, 'epcnet_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + HOST_ONLY!r})\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('epcnet_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 62  # every submodule was imported


def _imports(path):
    """Every module name a file imports, including importlib/__import__
    calls with a literal name."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


def test_source_scan():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "epcnet_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) >= 63  # chip_smoke.py and the package's 62 modules
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in FORBIDDEN + HOST_ONLY, (f, mod)


def test_configs_copy_in_step():
    for name in ("ModelConfig", "DataConfig", "TrainConfig", "MeshConfig",
                 "EvalConfig", "ExperimentConfig"):
        jf = [(f.name, f.default) for f in dataclasses.fields(getattr(jcfg, name))]
        tf = [(f.name, f.default) for f in dataclasses.fields(getattr(tcfg, name))]
        assert jf == tf, name
    j = jcfg.apply_overrides(jcfg.ExperimentConfig(), ["model.knn_k=12",
                                                       "model.lift_channels=8,16"])
    t = tcfg.ExperimentConfig.from_json(j.to_json())
    assert json.loads(t.to_json()) == json.loads(j.to_json())
    assert tcfg.epcnet_l_config() == tcfg.ModelConfig(
        **dataclasses.asdict(jcfg.epcnet_l_config()))
    with pytest.raises(ValueError, match="vlad_precision"):
        tcfg.ModelConfig(vlad_precision="fast")
    with pytest.raises(KeyError, match="unknown config key"):
        tcfg.apply_overrides(tcfg.ExperimentConfig(), ["model.knn_kk=3"])


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    import numpy as np

    from epcnet_torch.cli import benchmark, convert, distill, embed, evaluate, serve, train
    from epcnet_torch.evals import get_recall, retrieval_latency_probe
    from epcnet_torch.models import get_model
    from epcnet_torch.scripts import batch_sweep, capacity, multiseed
    from epcnet_torch.serve import PlaceIndex
    from epcnet_torch.train import Trainer, create_train_state
    from epcnet_torch.train.step import build_embed_fn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.ModelConfig()
    db = np.eye(4, dtype=np.float32)
    log = ["--log_dir", str(tmp_path)]  # no export there: the device check comes first
    for call in (lambda: get_model(cfg), lambda: get_model(cfg, "cuda"),
                 lambda: get_model(tcfg.pointnetvlad_config()),
                 lambda: build_embed_fn(cfg), lambda: PlaceIndex(None),
                 lambda: PlaceIndex.from_checkpoint(str(tmp_path)),
                 lambda: serve.main(log),
                 lambda: convert.main(["--source", str(tmp_path / "w.npz")] + log),
                 lambda: get_recall(db, db, [[0]] * 4),
                 lambda: retrieval_latency_probe(db, 4),
                 lambda: evaluate.main(["--dataset_root", str(tmp_path)] + log),
                 lambda: embed.main(log + ["cloud.bin"]),
                 lambda: create_train_state(cfg, tcfg.TrainConfig()),
                 lambda: Trainer(tcfg.ExperimentConfig(), None),
                 lambda: train.main(["--dataset_root", str(tmp_path)] + log),
                 lambda: distill.main(["--dataset_root", str(tmp_path),
                                       "--teacher_log_dir", str(tmp_path)]),
                 lambda: benchmark.main(["--json"]),
                 lambda: multiseed.run(str(tmp_path / "ms")),
                 lambda: capacity.train_ladder(cfg),
                 lambda: capacity.main(["--out", str(tmp_path / "cap.json")]),
                 lambda: batch_sweep.main(["--out", str(tmp_path / "bs.json")])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert next(get_model(cfg, "cpu").parameters()).device.type == "cpu"
    for written in ("ms", "cap.json", "bs.json"):  # refused before it wrote anything
        assert not (tmp_path / written).exists(), written


def test_multi_device_modules_stand_alone():
    """The multi-device layer and the gloo test worker import no JAX, no
    ``epcnet_tpu`` and no ``conftest`` (the worker runs in processes of its
    own, which must not touch the JAX platform)."""
    files = [os.path.join(ROOT, "epcnet_torch", p) for p in
             ("parallel/mesh.py", "parallel/multislice.py", "parallel/collectives.py",
              "models/points_sharded.py", "ops/retrieval.py")]
    files.append(os.path.join(ROOT, "tests", "torch_dist_worker.py"))
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in FORBIDDEN + HOST_ONLY + ("conftest",), (f, mod)


def test_multi_device_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    import numpy as np

    from epcnet_torch.cli import distill, embed, evaluate, serve, train
    from epcnet_torch.models.points_sharded import (
        embed_points_sharded,
        points_sharded_train_state,
        shard_model,
    )
    from epcnet_torch.parallel import (
        ProcessMesh,
        make_mesh,
        make_multislice_mesh,
        maybe_initialize_distributed,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("EPCNET_COORDINATOR_ADDRESS", "localhost:1")  # never reached
    cfg = tcfg.ModelConfig()
    log = ["--log_dir", str(tmp_path)]
    flat = {}
    for call in (lambda: make_mesh(), lambda: make_mesh(devices=["cuda:0", "cuda:0"]),
                 lambda: make_multislice_mesh(),
                 lambda: maybe_initialize_distributed(),
                 lambda: embed_points_sharded(flat, np.zeros((64, 3), np.float32), cfg,
                                              ProcessMesh()),
                 lambda: shard_model(cfg, flat),
                 lambda: points_sharded_train_state(cfg, tcfg.TrainConfig(), ProcessMesh()),
                 lambda: serve.main(log + ["--mesh"]),
                 lambda: evaluate.main(["--dataset_root", str(tmp_path), "--mesh"] + log),
                 lambda: embed.main(log + ["--points_sharded", "cloud.bin"]),
                 lambda: train.main(["--dataset_root", str(tmp_path), "--mesh"] + log),
                 lambda: distill.main(["--dataset_root", str(tmp_path), "--mesh",
                                       "--teacher_log_dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not torch.distributed.is_initialized()
