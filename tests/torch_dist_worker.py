"""Ranks of a gloo process group on the CPU, for the port's multi-device
tests (``tests/test_torch_dist_*.py``). Not a test file (no ``test_``
prefix): pytest never collects it.

It imports only torch, numpy and ``epcnet_torch`` (never JAX, never
``conftest``): the JAX side of each comparison runs in the pytest process,
which writes the inputs to ``<workdir>/inputs.npz`` and reads each rank's
results from ``<workdir>/out_<rank>.npz``.

  python tests/torch_dist_worker.py <scenario> --rank R --world W --workdir D

Every rank joins the group through ``parallel.maybe_initialize_distributed``
(a ``file://`` store in the workdir) and runs one scenario:

- ``model``: the ring kNN, BatchNorm over the ranks, the points-sharded
  embed (fp32, with pad rows, bf16, and the ``k > nl`` error), the
  points-sharded distillation gradient (with and without remat) and the
  points-sharded tuple train step;
- ``dp``: one data-parallel train step (SGD with momentum), also with
  ``grad_accum_steps=2``, the multi-step dispatch and a distillation step;
- ``trainer``: a ``Trainer`` with ``mesh=`` for 1 epoch (mining sweep,
  checkpoint), its resume to 2 epochs, and 2 epochs straight;
- ``preempt``: a ``Trainer`` under a ``PreemptionGuard`` that the parent
  signals on rank 0 only; ``--restore`` resumes;
- ``cuda_collectives`` (needs the card): every collective of
  ``parallel/collectives.py`` on CUDA tensors over gloo, against the values
  they must give.

``spawn`` (used by the tests) starts the ranks and waits for them, with a
time limit of its own.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the golden small EPC-Net (tests/test_torch_models.py GOLDEN_KW)
SMALL = dict(num_points=128, knn_k=8, use_pallas=False, proxyconv_channels=(16, 16),
             lift_channels=(32, 64), feature_dim=64, vlad_clusters=8, vlad_groups=4,
             vlad_group_dim=16)
LR = 1e-3


def spawn(scenario: str, world: int, workdir: str, timeout: float = 120.0, extra=(),
          signal_rank0_when: str | None = None) -> list[dict]:
    """Run ``scenario`` on ``world`` ranks; returns each rank's results. A
    rank that fails, or a group that outlives ``timeout`` seconds, fails
    the call (every rank is killed). ``signal_rank0_when``: a path; rank 0
    alone gets SIGTERM once it exists."""
    store = os.path.join(workdir, f"store_{scenario}_{time.monotonic_ns()}")
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = []
    for r in range(world):
        log = open(os.path.join(workdir, f"log_{scenario}_{r}.txt"), "w")
        cmd = [sys.executable, "-u", os.path.abspath(__file__), scenario, "--rank", str(r),
               "--world", str(world), "--workdir", workdir, "--store", store, *extra]
        procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env),
                      log))
    deadline = time.monotonic() + timeout
    try:
        if signal_rank0_when is not None:
            while not os.path.exists(signal_rank0_when):
                if time.monotonic() > deadline or procs[0][0].poll() is not None:
                    break
                time.sleep(0.05)
            procs[0][0].terminate()
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{scenario} on {world} ranks outlived {timeout} s")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, (p, _) in enumerate(procs):
        text = open(os.path.join(workdir, f"log_{scenario}_{r}.txt")).read()
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{text[-3000:]}"
    return [dict(np.load(os.path.join(workdir, f"out_{scenario}_{r}.npz"), allow_pickle=False))
            for r in range(world)]


# -- scenarios -----------------------------------------------------------------


def _flat(path: str) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def scenario_model(args, inp: dict, out: dict) -> None:
    import torch

    from epcnet_torch.configs import ModelConfig, TrainConfig
    from epcnet_torch.models.layers import DynamicBatchNorm
    from epcnet_torch.models.points_sharded import (
        build_points_sharded_distill_fn,
        build_points_sharded_train_step,
        embed_points_sharded,
        points_sharded_train_state,
        shard_model,
    )
    from epcnet_torch.ops.retrieval import ring_knn_points
    from epcnet_torch.parallel import ProcessMesh
    from epcnet_torch.configs import MeshConfig
    from epcnet_torch.weights import flat_grads, flat_variables

    mesh = ProcessMesh(MeshConfig(data_axis=1, db_axis=args.world))
    group = mesh.group("db")
    for name in ("ring_x517", "ring_grid", "ring_x512"):
        k = int(inp[f"{name}_k"])
        idx, dist = ring_knn_points(torch.from_numpy(inp[name]), k, group)
        out[f"{name}_idx"], out[f"{name}_dist"] = idx.numpy(), dist.numpy()

    # BatchNorm over the ranks: forward and gradients of sum(y * w)
    x, w = torch.from_numpy(inp["bn_x"]), torch.from_numpy(inp["bn_w"])
    bn = DynamicBatchNorm(x.shape[-1], group=group)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(inp["bn_scale"]))
        bn.bias.copy_(torch.from_numpy(inp["bn_bias"]))
    r, nb = mesh.rank("db"), x.shape[0] // args.world
    xl = x[r * nb:(r + 1) * nb].clone().requires_grad_(True)
    y = bn(xl, train=True, momentum=0.9)
    (y * w[r * nb:(r + 1) * nb]).sum().backward()
    out["bn_y"], out["bn_dx"] = y.detach().numpy(), xl.grad.numpy()
    out["bn_dscale"], out["bn_dbias"] = bn.scale.grad.numpy(), bn.bias.grad.numpy()
    out["bn_mean"], out["bn_var"] = (t.numpy() for t in bn.pending[:2])

    f32 = ModelConfig(**{**SMALL, "compute_dtype": "float32"})
    flat = _flat(os.path.join(args.workdir, "flat_f32.npz"))
    for n in (128, 91):
        out[f"embed_f32_n{n}"] = embed_points_sharded(flat, inp[f"pts{n}"], f32, mesh,
                                                      device="cpu").numpy()
    out["embed_bf16_n120"] = embed_points_sharded(
        _flat(os.path.join(args.workdir, "flat_bf16.npz")), inp["pts120"], ModelConfig(**SMALL),
        mesh, device="cpu").numpy()
    try:
        embed_points_sharded(flat, inp["pts128"][:32], f32.variant(knn_k=20), mesh,
                             device="cpu")
        out["k_exceeds_raised"] = np.array(False)
    except ValueError as e:
        out["k_exceeds_raised"] = np.array("exceeds points-per-shard" in str(e))

    # points-sharded distillation: gradients, BN statistics, remat
    for remat in (False, True):
        model = shard_model(f32, flat, group, "cpu")
        step = build_points_sharded_distill_fn(f32, mesh, remat=remat)
        loss = step(model, inp["distill_pts"], inp["distill_target"], momentum=0.9)
        tag = "remat" if remat else "plain"
        out[f"distill_{tag}_loss"] = loss.numpy()
        for key, v in flat_grads(model).items():
            out[f"distill_{tag}_grad/{key}"] = v
        for key, v in flat_variables(model).items():
            if key.startswith("batch_stats/"):
                out[f"distill_{tag}_var/{key}"] = v

    # the points-sharded tuple step (lazy quadruplet, SGD with momentum)
    for remat in (False, True):
        tcfg = TrainConfig(loss="lazy_quadruplet", optimizer="momentum", remat=remat)
        state = points_sharded_train_state(f32, tcfg, mesh, device="cpu", variables=flat)
        state, m = build_points_sharded_train_step(f32, tcfg, mesh)(state, {
            key: inp[f"tuple_{key}"] for key in ("query", "positives", "negatives",
                                                 "other_neg")})
        tag = "remat" if remat else "plain"
        out[f"tuple_{tag}_loss"] = m["loss"].numpy()
        out[f"tuple_{tag}_best_pos"] = m["best_pos_dist"].numpy()
        for key, v in flat_variables(state.model).items():
            out[f"tuple_{tag}_var/{key}"] = v
    try:
        build_points_sharded_train_step(f32, TrainConfig(grad_accum_steps=2), mesh)
        out["accum_raised"] = np.array(False)
    except ValueError:
        out["accum_raised"] = np.array(True)


def scenario_dp(args, inp: dict, out: dict) -> None:
    from epcnet_torch.configs import MeshConfig, ModelConfig, TrainConfig, epcnet_l_config
    from epcnet_torch.models import get_model
    from epcnet_torch.parallel import ProcessMesh
    from epcnet_torch.train.state import create_train_state
    from epcnet_torch.train.step import (
        build_distill_step,
        build_multi_train_step,
        build_train_step,
    )
    from epcnet_torch.weights import flat_variables, load_flat_variables

    mesh = ProcessMesh(MeshConfig(data_axis=args.world, db_axis=1))
    group = mesh.group("data")
    f32 = ModelConfig(**{**SMALL, "compute_dtype": "float32"})
    flat = _flat(os.path.join(args.workdir, "flat_f32.npz"))
    batch = {key: inp[f"dp_{key}"] for key in ("query", "positives", "negatives", "other_neg")}
    for accum in (1, 2):
        tcfg = TrainConfig(learning_rate=LR, optimizer="momentum", grad_accum_steps=accum)
        state = create_train_state(f32, tcfg, "cpu", variables=flat)
        state, m = build_train_step(f32, tcfg, group)(state, batch)
        out[f"dp_accum{accum}_loss"] = m["loss"].numpy()
        for key, v in flat_variables(state.model).items():
            out[f"dp_accum{accum}_var/{key}"] = v
    # two steps in one dispatch
    tcfg = TrainConfig(learning_rate=LR, optimizer="momentum")
    state = create_train_state(f32, tcfg, "cpu", variables=flat)
    stacked = {key: np.stack([v, v[::-1].copy()]) for key, v in batch.items()}
    state, m = build_multi_train_step(f32, tcfg, group)(state, stacked)
    out["multi_loss"] = m["loss"].numpy()
    for key, v in flat_variables(state.model).items():
        out[f"multi_var/{key}"] = v
    # distillation: EPC-Net teacher, EPC-Net-L student
    student = epcnet_l_config(**{k: v for k, v in SMALL.items()
                                 if k in ("num_points", "knn_k", "use_pallas")},
                              compute_dtype="float32")
    teacher = get_model(f32, "cpu")
    load_flat_variables(teacher, flat)
    state = create_train_state(student, tcfg, "cpu",
                               variables=_flat(os.path.join(args.workdir, "flat_student.npz")))
    state, m = build_distill_step(student, f32, tcfg, alpha=2.0, group=group)(
        state, teacher, batch)
    out["distill_loss"] = m["loss"].numpy()
    for key, v in flat_variables(state.model).items():
        out[f"distill_var/{key}"] = v


def _trainer_cfg(args, log: str, max_epoch: int, mining_start_epoch: int = 0):
    from epcnet_torch.configs import DataConfig, ExperimentConfig, ModelConfig, TrainConfig

    return ExperimentConfig(
        model=ModelConfig(**SMALL),
        data=DataConfig(dataset_root=os.path.join(args.workdir, "data"), num_points=128,
                        num_negatives=4, num_positives=2),
        train=TrainConfig(batch_num_queries=4, max_epoch=max_epoch, learning_rate=LR,
                          mining_start_epoch=mining_start_epoch, mining_refresh_steps=10**6,
                          log_every_steps=5, checkpoint_every_steps=10**6, seed=1234),
        log_dir=os.path.join(args.workdir, log))


def _tuples(args):
    from epcnet_torch.data.tuples import construct_query_dict, scan_runs

    return construct_query_dict(scan_runs(os.path.join(args.workdir, "data")),
                                exclude_test_regions=False)


def scenario_trainer(args, inp: dict, out: dict) -> None:
    import torch.distributed as dist

    from epcnet_torch.configs import MeshConfig
    from epcnet_torch.parallel import ProcessMesh
    from epcnet_torch.train.trainer import Trainer
    from epcnet_torch.weights import flat_variables

    mesh = ProcessMesh(MeshConfig())
    tuples = _tuples(args)
    # 1 epoch with checkpoints, then a fresh trainer restores and trains a 2nd
    tr = Trainer(_trainer_cfg(args, "run", 1), tuples, mesh=mesh, device="cpu")
    tr.train()
    out["latents"] = tr.mining.latents
    out["ckpt_files_after_1"] = np.array(len(os.listdir(os.path.join(args.workdir, "run",
                                                                     "ckpt"))))
    dist.barrier()
    tr = Trainer(_trainer_cfg(args, "run", 2), tuples, mesh=mesh, device="cpu")
    out["restored_step"] = np.array(tr.maybe_restore())
    tr.train()
    for key, v in flat_variables(tr.state.model).items():
        out[f"resumed/{key}"] = v
    # 2 epochs straight, no checkpoints
    tr = Trainer(_trainer_cfg(args, "straight", 2), tuples, mesh=mesh, checkpoints=False,
                 device="cpu")
    tr.train()
    for key, v in flat_variables(tr.state.model).items():
        out[f"straight/{key}"] = v
    out["step"] = np.array(tr.state.step)


def scenario_preempt(args, inp: dict, out: dict) -> None:
    from epcnet_torch.configs import MeshConfig
    from epcnet_torch.parallel import PreemptionGuard, ProcessMesh
    from epcnet_torch.train.trainer import Trainer
    from epcnet_torch.weights import flat_variables

    mesh = ProcessMesh(MeshConfig())
    # no mining: a resume in the middle of an epoch rebuilds the mining cache
    # from the weights of the moment, so only a run without it ends bit-equal
    tr = Trainer(_trainer_cfg(args, args.log, args.max_epoch, mining_start_epoch=99),
                 _tuples(args), mesh=mesh, device="cpu")
    if args.restore:
        tr.maybe_restore()
    with PreemptionGuard() as guard:
        tr.train(should_stop=guard)
    out["step"] = np.array(tr.state.step)
    for key, v in flat_variables(tr.state.model).items():
        out[f"var/{key}"] = v


def scenario_cuda_collectives(args, inp: dict, out: dict) -> None:
    import torch

    from epcnet_torch.parallel import collectives

    group = torch.distributed.group.WORLD
    r, w = args.rank, args.world
    x = torch.arange(12, dtype=torch.float32, device="cuda").reshape(3, 4) + 100 * r
    want = torch.stack([torch.arange(12.0).reshape(3, 4) + 100 * i for i in range(w)])
    out["all_gather"] = np.array(torch.equal(collectives.all_gather(x, group).cpu(), want))
    out["all_gather_on_card"] = np.array(collectives.all_gather(x, group).is_cuda)
    out["ring_shift"] = np.array(torch.equal(collectives.ring_shift(x, group).cpu(),
                                             want[(r - 1) % w]))
    out["all_reduce_sum"] = np.array(torch.equal(collectives.all_reduce_sum(x, group).cpu(),
                                                 want.sum(0)))
    y = x.clone()
    out["broadcast"] = np.array(torch.equal(collectives.broadcast_(y, group).cpu(), want[0]))


SCENARIOS = {"model": scenario_model, "dp": scenario_dp, "trainer": scenario_trainer,
             "preempt": scenario_preempt, "cuda_collectives": scenario_cuda_collectives}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("scenario", choices=sorted(SCENARIOS))
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--log", default="run")
    ap.add_argument("--max_epoch", type=int, default=2)
    ap.add_argument("--restore", action="store_true")
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    from epcnet_torch.parallel import maybe_initialize_distributed

    torch.set_num_threads(1)
    assert maybe_initialize_distributed(f"file://{args.store}", args.world, args.rank,
                                        device="cpu")
    path = os.path.join(args.workdir, "inputs.npz")
    inp = _flat(path) if os.path.isfile(path) else {}
    out: dict = {}
    SCENARIOS[args.scenario](args, inp, out)
    np.savez(os.path.join(args.workdir, f"out_{args.scenario}_{args.rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
