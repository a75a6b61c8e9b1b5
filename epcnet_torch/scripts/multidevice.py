"""The multi-device paths of the port on one card, checked and timed.

  python -m epcnet_torch.scripts.multidevice               # the card: one JSON line
  python -m epcnet_torch.scripts.multidevice --device cpu --small   # a rehearsal

``chip_smoke.py``'s "multi-device" phase calls the three parts:

- ``retrieval``: one process over ``make_mesh(devices=[dev, dev])``. A
  database of 10^6 unit rows (fp32 and int8) with the embedded submaps
  planted in it: ``sharded_topk_neighbors`` and ``ring_topk_neighbors``
  return the unsharded blocked retrieval's ids exactly, every planted
  submap at rank 0; then a sharded ``PlaceIndex`` and an unsharded one over
  the same rows answer the submaps through a ``QueryScheduler`` from 8
  threads (p50 / p99 of the scheduler's request latency, host clock).
- ``gloo_world``: two ranks sharing the card over gloo
  (``torch.multiprocessing`` spawn, a ``FileStore``), each counting its
  kernel launches: a data-parallel train step of the default 44-cloud
  batch (1 tuple a rank; bf16 and fp32; SGD with momentum), the ring kNN
  and the points-sharded embed of one cloud, and the points-sharded tuple
  step of a cut tuple (1 query, 1 positive, 2 negatives, the other
  negative). Each is held against the single-device path on the same card
  and inputs, computed here first (``TOL``). The tuple step is also run
  with a planted fault, which its bound must catch, and both tuple steps
  are measured against the single-device step in fp64.
- ``nccl_world``: one rank over NCCL through
  ``maybe_initialize_distributed``: the data-parallel step timed against
  the plain step in the same process (the difference is the collectives'
  cost), and ``cli/train.py --mesh`` for two steps.

``gloo_cuda_ops`` probes which raw ``torch.distributed`` collectives gloo
runs on CUDA tensors, each in a pair of processes of its own (a refusal
may abort the process).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from epcnet_torch.configs import MeshConfig, ModelConfig, TrainConfig
from epcnet_torch.models.points_sharded import (
    build_points_sharded_train_step,
    embed_points_sharded,
    points_sharded_train_state,
)
from epcnet_torch.ops import knn
from epcnet_torch.ops.retrieval import (
    quantize_descriptors,
    ring_knn_points,
    ring_topk_neighbors,
    sharded_topk_neighbors,
    topk_neighbors,
    topk_neighbors_quantized,
)
from epcnet_torch.parallel import ProcessMesh, make_mesh, maybe_initialize_distributed
from epcnet_torch.scripts.train_bench import blob_submaps, tuple_batch
from epcnet_torch.serve import PlaceIndex, QueryScheduler
from epcnet_torch.train.state import create_train_state
from epcnet_torch.train.step import build_embed_fn, build_train_step
from epcnet_torch.utils.timing import cuda_ms
from epcnet_torch.weights import flat_grads, flat_variables, init_flat_variables

LR = 1e-3
K = 25
# each against the single-device path on the same card and inputs:
# - bf16: K1/K2 exact, but a GEMM of 22 clouds (a rank's) against one of 44
#   may round differently; chip_smoke.py's TRAIN_TOL (loss 1e-3 relative,
#   each gradient within 5e-2 of max(its largest, a tenth of the model's))
# - fp32: summation order only (the CPU tests' bounds against JAX: loss
#   1e-4 relative, gradients 1e-3 of the scale above)
# - the points-sharded tuple step (5 x 32768 rows): loss and each gradient
#   against the single-device step in the same dtype, the gradient bound
#   between what the sound steps read and what a planted fault (one BN on a
#   rank's rows only) reads, with both steps' gaps from the fp64 step
#   reported. On an H100: fp32 5.46e-3 (the single step's own rounding: it
#   is 5.49e-3 from fp64, the sharded step 5.3e-4, and permuting the points
#   leaves it in place), planted 6.3e-2 -> 1e-2; bf16 1.39e-2 (the permuted
#   single step reads the same), planted 0.157 -> 5e-2
# - parameters after one SGD step: tests/test_multidevice.py's 1e-4
# - embeds: tests/test_points_sharded.py's (cosine > 0.999 in bf16, 2e-4 fp32)
TOL = {"bf16": dict(loss=1e-3, grad=5e-2, params=1e-4, grad_l2=2e-2),
       "fp32": dict(loss=1e-4, grad=1e-3, params=1e-4, grad_l2=1e-3),
       "tuple_bf16": dict(loss=1e-3, grad=5e-2),
       "tuple_fp32": dict(loss=1e-4, grad=1e-2),
       "embed_cos_bf16": 0.999, "embed_f32": 2e-4}


def _pre_bn_bias(name: str, names) -> bool:
    """A Dense bias that BN follows: its gradient is zero in exact
    arithmetic, so what a step computes for it is rounding noise."""
    m = re.match(r"params/(.*)/dense(_\d+)?/bias$", name)
    return bool(m) and f"params/{m.group(1)}/bn{m.group(2) or ''}/scale" in names


def grad_gaps(got: dict, want: dict) -> dict:
    """Each gradient's gap over max(its largest entry, a tenth of the
    largest of all), worst first; the biases ahead of a BN are left out."""
    gmax = max(float(np.abs(v).max()) for v in want.values())
    gaps = {k: float(np.abs(got[k] - w).max()) / max(float(np.abs(w).max()), 0.1 * gmax)
            for k, w in want.items() if not _pre_bn_bias(k, want)}
    return dict(sorted(gaps.items(), key=lambda kv: -kv[1]))


def _gaps(g: dict, w: dict) -> dict:
    """Loss (relative), worst gradient gap, the three worst tensors and the
    relative L2 error of the gradient as one vector (the biases ahead of a
    BN left out)."""
    gg = grad_gaps(g["grads"], w["grads"])
    diff = sum(float(((g["grads"][k].astype(np.float64) - w["grads"][k]) ** 2).sum()) for k in gg)
    norm = sum(float((w["grads"][k].astype(np.float64) ** 2).sum()) for k in gg)
    return {"loss": abs(g["loss"] - w["loss"]) / abs(w["loss"]), "grad": next(iter(gg.values())),
            "grad_l2": (diff / norm) ** 0.5, "worst_grads": dict(list(gg.items())[:3])}


def _params_gap(got: dict, want: dict) -> float:
    return max(float(np.abs(got[k] - w).max()) for k, w in want.items()
               if k.startswith("params/"))


def _counts() -> dict:
    return {"K1": knn.knn_adjacency_cuda.launches, "K2": knn.knn_cuda.launches}


def _zero() -> None:
    knn.knn_adjacency_cuda.launches = knn.knn_cuda.launches = 0


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ms(fn, dev):
    """(result, host ms) of one call that ends in a synchronise."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def _run(fn, dev, keep=lambda r: r):
    """(keep(first result), launch counts of the first call, the least
    host ms of three more calls): the first call is the checked, counted
    one; the warm ones are timed (a step's later calls update the state
    again)."""
    _zero()
    r = fn()
    _sync(dev)
    counts = _counts()
    kept = keep(r)
    return kept, counts, min(_ms(fn, dev)[1] for _ in range(3))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sizes(small: bool) -> dict:
    """The phase's shapes: full width at the sizes above, or a tiny model
    for a CPU rehearsal."""
    if small:
        cfg = ModelConfig(num_points=128, knn_k=8, proxyconv_channels=(16, 16),
                          lift_channels=(32, 64), feature_dim=64, vlad_clusters=8,
                          vlad_groups=4, vlad_group_dim=16)
        return dict(cfg=cfg, db_rows=4096, ring_n=1024, embed32_n=512, tuple_n=256,
                    submaps=16, negatives=2)
    return dict(cfg=ModelConfig(), db_rows=10**6, ring_n=131072, embed32_n=65536,
                tuple_n=32768, submaps=64, negatives=18)


# -- (a) sharded retrieval in one process ------------------------------------


def retrieval(dev: torch.device, embed, sub: np.ndarray, db_rows: int) -> dict:
    """Sharded and ring top-k over [dev, dev] against the unsharded
    blocked retrieval, and the sharded PlaceIndex through QueryScheduler
    beside the unsharded one (see the module docstring)."""
    mesh = make_mesh(MeshConfig(data_axis=1, db_axis=2), [dev, dev])
    gen = torch.Generator(device=dev).manual_seed(10)
    db = torch.nn.functional.normalize(torch.randn(db_rows, embed.model.cfg.output_dim,
                                                   device=dev, generator=gen), dim=-1)
    with torch.inference_mode():
        q = torch.cat([embed(torch.as_tensor(sub[s:s + 32], device=dev))
                       for s in range(0, len(sub), 32)])
    at = torch.randperm(db_rows, generator=torch.Generator().manual_seed(11))[:len(sub)]
    db[at.to(dev)] = q
    out = {"db_rows": db_rows, "queries": len(sub), "shards": 2}
    with torch.inference_mode():
        want, _ = topk_neighbors(q, db, K)
        assert torch.equal(want[:, 0].cpu(), at.to(torch.int32)), "a planted submap not at rank 0"
        qi, sc = quantize_descriptors(db)
        want_q, _ = topk_neighbors_quantized(q, qi, sc, K)
        assert torch.equal(want_q[:, 0].cpu(), at.to(torch.int32))
        calls = {"fp32_unsharded": lambda: topk_neighbors(q, db, K),
                 "fp32_sharded": lambda: sharded_topk_neighbors(q, db, K, mesh),
                 "fp32_ring": lambda: ring_topk_neighbors(q, db, K, mesh),
                 "int8_unsharded": lambda: topk_neighbors_quantized(q, qi, sc, K),
                 "int8_sharded": lambda: sharded_topk_neighbors(q, qi, K, mesh, db_scale=sc)}
        for name, fn in calls.items():
            ids = fn()[0]
            assert torch.equal(ids, want_q if name.startswith("int8") else want), name
        if dev.type == "cuda":
            out["ms"] = {name: cuda_ms(fn, 5) for name, fn in calls.items()}
    host = db.cpu().numpy()
    del db, qi, sc
    lat = {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        ix = PlaceIndex(embed, embed.model.cfg.output_dim, embed_batch=32, mesh=m,
                        num_points=sub.shape[1], device=dev)
        ix.add_descriptors(host)
        ix.warmup()
        sched = QueryScheduler(ix, k=5, max_wait_ms=5.0)
        try:
            with ThreadPoolExecutor(8) as pool:
                got = list(pool.map(lambda i: sched.submit(sub[i]).result(timeout=300)[0][0],
                                    range(len(sub))))
            assert got == at.tolist(), (name, got)
            m_ = sched.metrics()
        finally:
            sched.stop()
        lat[name] = {"p50_ms": m_["latency_p50_ms"], "p99_ms": m_["latency_p99_ms"],
                     "avg_batch": m_["avg_batch"], "sharded": ix.metrics()["sharded"]}
        del ix
    out["scheduler_8_threads"] = lat
    return out


# -- (b) two ranks sharing the card over gloo ---------------------------------


def _gloo_rank(rank: int, world: int, store: str, tmp: str, dev_type: str) -> None:
    torch.set_num_threads(2)
    dev = torch.device(dev_type)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        out = _gloo_work(rank, world, torch.load(os.path.join(tmp, "gloo_in.pt"),
                                                 weights_only=False), dev)
        torch.save(out, os.path.join(tmp, f"gloo_out_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _gloo_work(rank: int, world: int, inp: dict, dev: torch.device) -> dict:
    cfg, flat = inp["cfg"], inp["flat"]
    dp_mesh = ProcessMesh(MeshConfig(data_axis=world, db_axis=1))
    pts_mesh = ProcessMesh(MeshConfig(data_axis=1, db_axis=world))
    first = rank == 0
    out, counts, ms = {}, {}, {}

    def step_result(r, state):
        res = {"loss": float(r[1]["loss"])}
        if first:
            res["grads"] = flat_grads(state.model)
            res["vars"] = flat_variables(state.model)
        return res

    for dtype, mc in (("bf16", cfg), ("fp32", cfg.variant(compute_dtype="float32"))):
        tc = TrainConfig(learning_rate=LR, optimizer="momentum")
        st = create_train_state(mc, tc, dev, variables=flat)
        step = build_train_step(mc, tc, dp_mesh.group("data"))
        out[f"dp_{dtype}"], counts[f"dp_step_{dtype}"], ms[f"dp_step_{dtype}"] = _run(
            lambda: step(st, inp["batch"]), dev, lambda r: step_result(r, st))
        del st
    group = pts_mesh.group("db")
    x = torch.as_tensor(inp["ring_cloud"], device=dev)
    out["ring_ids"], counts["ring_knn"], ms["ring_knn"] = _run(
        lambda: ring_knn_points(x, cfg.knn_k, group), dev, lambda r: r[0].cpu())
    for name, mc, cloud in (("embed_bf16", cfg, inp["ring_cloud"]),
                            ("embed_fp32", cfg.variant(compute_dtype="float32"),
                             inp["embed32_cloud"])):
        out[name], counts[name], ms[name] = _run(
            lambda: embed_points_sharded(flat, cloud, mc, pts_mesh, device=dev), dev,
            lambda r: r.cpu())
    for dtype in ("bf16", "fp32"):
        mc = cfg.variant(num_points=inp["tuple_n"],
                         compute_dtype="bfloat16" if dtype == "bf16" else "float32")
        tc = TrainConfig(learning_rate=LR, optimizer="momentum", batch_num_queries=1)
        st = points_sharded_train_state(mc, tc, pts_mesh, device=dev, variables=flat)
        step = build_points_sharded_train_step(mc, tc, pts_mesh)
        out[f"tuple_{dtype}"], counts[f"tuple_step_{dtype}"], ms[f"tuple_step_{dtype}"] = _run(
            lambda: step(st, inp["tuple"]), dev, lambda r: step_result(r, st))
        # a planted fault the check must catch: one BN on the rank's rows only
        st = points_sharded_train_state(mc, tc, pts_mesh, device=dev, variables=flat)
        st.model.lift.bn_0.group = None
        out[f"tuple_{dtype}_planted"] = step_result(step(st, inp["tuple"]), st)
        del st
    if not first:
        out.pop("ring_ids")
    out["counts"], out["ms"] = counts, ms
    return out


def gloo_world(dev: torch.device, cfg: ModelConfig, flat: dict, small: bool = False,
               world: int = 2) -> dict:
    """The gloo world's checks (see the module docstring); returns errors,
    times and each rank's launch counts."""
    sz = sizes(small)
    n, k = cfg.num_points, cfg.knn_k
    rng = np.random.default_rng(131)
    b = tuple_batch(3, 2, 2, sz["negatives"], n)
    tup = {key: v[0] for key, v in tuple_batch(4, 1, 1, 2, sz["tuple_n"]).items()}
    inp = {"cfg": cfg, "flat": flat, "batch": b, "tuple": tup, "tuple_n": sz["tuple_n"],
           "ring_cloud": blob_submaps(rng, 1, sz["ring_n"])[0],
           "embed32_cloud": blob_submaps(rng, 1, sz["embed32_n"])[0]}
    ref, ref_ms = {}, {}
    # the single-device paths, on the same card and inputs
    def step_result(r, state):
        return {"loss": float(r[1]["loss"]), "grads": flat_grads(state.model),
                "vars": flat_variables(state.model)}

    for dtype, mc in (("bf16", cfg), ("fp32", cfg.variant(compute_dtype="float32"))):
        tc = TrainConfig(learning_rate=LR, optimizer="momentum")
        st = create_train_state(mc, tc, dev, variables=flat)
        step = build_train_step(mc, tc)
        ref[f"dp_{dtype}"], _, ref_ms[f"dp_step_{dtype}"] = _run(
            lambda: step(st, b), dev, lambda r: step_result(r, st))
        del st
    x = torch.as_tensor(inp["ring_cloud"], device=dev)
    ref["ring_ids"], _, ref_ms["ring_knn"] = _run(lambda: knn.knn(x[None], k)[0], dev,
                                                  lambda r: r.cpu())
    for name, mc, cloud in (("embed_bf16", cfg, inp["ring_cloud"]),
                            ("embed_fp32", cfg.variant(compute_dtype="float32"),
                             inp["embed32_cloud"])):
        embed = build_embed_fn(mc, dev, variables=flat)
        ref[name], _, ref_ms[name] = _run(lambda: embed(cloud[None])[0], dev, lambda r: r.cpu())
        del embed
    for dtype in ("bf16", "fp32"):
        mc = cfg.variant(num_points=sz["tuple_n"],
                         compute_dtype="bfloat16" if dtype == "bf16" else "float32")
        tc = TrainConfig(learning_rate=LR, optimizer="momentum", batch_num_queries=1)
        step = build_train_step(mc, tc)
        # and with each cloud's points permuted: the same loss and gradient
        # in exact arithmetic, the sums over the tuple's rows in another
        # order (reported beside the sharded step's gap, not held)
        perm = np.random.default_rng(5).permutation(sz["tuple_n"])
        for tag, one in (("", {key: v[None] for key, v in tup.items()}),
                         ("_permuted", {key: v[..., perm, :][None] for key, v in tup.items()})):
            st = create_train_state(mc, tc, dev, variables=flat)
            ref[f"tuple_{dtype}{tag}"], _, ref_ms[f"tuple_step_{dtype}{tag}"] = _run(
                lambda: step(st, one), dev, lambda r: step_result(r, st))
            del st
    # the tuple in fp64 on the same card (K2's ids as in fp32): the reference
    # that both steps' rounding is measured from
    mc = cfg.variant(num_points=sz["tuple_n"], compute_dtype="float64")
    st = create_train_state(mc, tc, dev, variables=flat)
    st.model.double()
    ref["tuple_fp64"] = step_result(build_train_step(mc, tc)(st, {key: v[None] for key, v
                                                                  in tup.items()}), st)
    del st
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="epcnet_gloo_") as tmp:
        torch.save(inp, os.path.join(tmp, "gloo_in.pt"))
        t0 = time.perf_counter()
        mp.start_processes(_gloo_rank, args=(world, os.path.join(tmp, "store"), tmp, dev.type),
                           nprocs=world, start_method="spawn")
        wall = time.perf_counter() - t0
        outs = [torch.load(os.path.join(tmp, f"gloo_out_{r}.pt"), weights_only=False)
                for r in range(world)]

    got = outs[0]
    res = {"world": world, "backend": "gloo", "wall_s": wall, "tolerance": TOL,
           "ms": {r: o["ms"] for r, o in enumerate(outs)}, "single_device_ms": ref_ms,
           "counts": {r: o["counts"] for r, o in enumerate(outs)}}
    for dtype in ("bf16", "fp32"):
        tol, g, w = TOL[dtype], got[f"dp_{dtype}"], ref[f"dp_{dtype}"]
        gap = dict(_gaps(g, w), params=_params_gap(g["vars"], w["vars"]))
        assert all(gap[key] <= tol[key] for key in tol), (f"dp_{dtype}", gap)
        assert all(o[f"dp_{dtype}"]["loss"] == g["loss"] for o in outs)
        res[f"dp_step_{dtype}"] = dict(gap, loss=g["loss"], loss_single=w["loss"])
        # the tuple step against the single-device step, per tensor, beside
        # a planted fault and the permuted single step; and each against
        # the fp64 step (where the rounding gap comes from)
        g, w = got[f"tuple_{dtype}"], ref[f"tuple_{dtype}"]
        gap = _gaps(g, w)
        pick = lambda v: {key: v[key] for key in ("grad", "grad_l2", "worst_grads")}
        res[f"tuple_step_{dtype}"] = dict(
            gap, loss_gap=gap["loss"], loss=g["loss"], loss_single=w["loss"], clouds=5,
            n=sz["tuple_n"], planted=pick(_gaps(got[f"tuple_{dtype}_planted"], w)),
            single_permuted=pick(_gaps(ref[f"tuple_{dtype}_permuted"], w)),
            fp64={name: pick(_gaps(x, ref["tuple_fp64"])) for name, x in (
                ("sharded", g), ("single", w), ("single_permuted", ref[f"tuple_{dtype}_permuted"]))})
    for dtype in ("bf16", "fp32"):
        r, tol = res[f"tuple_step_{dtype}"], TOL[f"tuple_{dtype}"]
        assert r["loss_gap"] <= tol["loss"] and r["grad"] <= tol["grad"] < r["planted"]["grad"], \
            (f"tuple_{dtype}", {d: res[f"tuple_step_{d}"] for d in ("bf16", "fp32")})
    assert torch.equal(got["ring_ids"], ref["ring_ids"]), "ring kNN ids differ from K2's"
    res["ring_knn"] = {"n": sz["ring_n"], "k": k, "ids_equal_k2": True}
    a, b_ = got["embed_bf16"].double(), ref["embed_bf16"].double()
    cos = float(a @ b_ / (a.norm() * b_.norm()))
    assert cos > TOL["embed_cos_bf16"], cos
    err32 = float((got["embed_fp32"] - ref["embed_fp32"]).abs().max())
    assert err32 <= TOL["embed_f32"], err32
    for o in outs[1:]:  # the embed is the same on every rank
        assert torch.equal(o["embed_bf16"], got["embed_bf16"])
    res["embed"] = {"bf16": {"n": sz["ring_n"], "cosine": cos},
                    "fp32": {"n": sz["embed32_n"], "max_abs_err": err32}}
    if dev.type == "cuda":  # every path through its kernel, on every rank
        for r, o in enumerate(outs):
            c = o["counts"]
            assert all(c[f"dp_step_{d}"]["K1"] == 1 for d in ("bf16", "fp32")), (r, c)
            assert all(c[p]["K2"] >= 1 for p in ("ring_knn", "embed_bf16", "embed_fp32",
                                                 "tuple_step_bf16", "tuple_step_fp32")), (r, c)
    return res


# -- (c) a world of one over NCCL -------------------------------------------


def _nccl_rank(rank: int, port: int, tmp: str) -> None:
    os.environ.update(EPCNET_COORDINATOR_ADDRESS=f"localhost:{port}", EPCNET_NUM_PROCESSES="1",
                      EPCNET_PROCESS_ID="0")
    assert maybe_initialize_distributed()  # NCCL: the card
    try:
        out = _nccl_work(torch.load(os.path.join(tmp, "nccl_in.pt"), weights_only=False), tmp)
        torch.save(out, os.path.join(tmp, "nccl_out.pt"))
    finally:
        dist.destroy_process_group()


def _nccl_work(inp: dict, tmp: str) -> dict:
    dev = torch.device("cuda")
    cfg, flat, batch = inp["cfg"], inp["flat"], inp["batch"]
    mesh = ProcessMesh()
    out = {"backend": dist.get_backend(), "mesh": mesh.shape}
    tc = TrainConfig(learning_rate=LR, optimizer="momentum")
    steps = {}
    for name, group in (("plain", None), ("mesh", mesh.group("data"))):
        st = create_train_state(cfg, tc, dev, variables=flat)
        steps[name] = (st, build_train_step(cfg, tc, group))
    ms = {"plain": [], "mesh": []}
    for name in ("plain", "mesh", "mesh", "plain"):  # in turns
        st, step = steps[name]
        ms[name].append(cuda_ms(lambda: step(st, batch), 10))
    out["step_ms"] = {name: float(np.mean(v)) for name, v in ms.items()}
    out["step_ms_runs"] = ms
    out["collective_ms"] = out["step_ms"]["mesh"] - out["step_ms"]["plain"]
    st, step = steps["mesh"]
    _zero()
    step(st, batch)
    torch.cuda.synchronize()
    out["step_counts"] = _counts()
    del steps, st
    out["cli_train"] = cli_train_two_steps(cfg, tmp, "cuda")
    return out


def cli_train_two_steps(cfg: ModelConfig, tmp: str, device: str) -> dict:
    """``cli/train.py --mesh`` for one epoch of two steps of the default
    tuple batch (1 positive a tuple): the synthetic set of 2 runs x 20
    submaps, the tuples pickle cut to 4 usable tuples (the rest keep no
    positive, which the loader skips)."""
    from epcnet_torch.cli import generate_tuples, train
    from epcnet_torch.configs import DataConfig, ExperimentConfig
    from epcnet_torch.data.tuples import load_pickle, save_pickle

    root, log_dir = os.path.join(tmp, "data"), os.path.join(tmp, "log")
    generate_tuples.main(["--dataset_root", root, "--synthetic", "--synthetic_runs", "2",
                          "--synthetic_submaps", "20", "--num_points", str(cfg.num_points)])
    tuples = load_pickle(os.path.join(root, "training_queries_baseline.pickle"))
    keep = [i for i in sorted(tuples) if tuples[i]["negatives"]][:4]
    for i in tuples:
        if i not in keep:
            tuples[i]["positives"] = []
    cut = os.path.join(tmp, "four_tuples.pickle")
    save_pickle(tuples, cut)
    cfg_path = os.path.join(tmp, "config.json")
    with open(cfg_path, "w") as f:
        f.write(ExperimentConfig(model=cfg, data=DataConfig(num_points=cfg.num_points)).to_json())
    _zero()
    tr = train.main(["--config", cfg_path, "--dataset_root", root, "--log_dir", log_dir,
                     "--tuples_pickle", cut, "--mesh", "--device", device,
                     "--set", "train.max_epoch=1", "--set", "data.num_positives=1",
                     "--set", "train.log_every_steps=1"])
    _sync(torch.device(device))
    recs = [json.loads(line) for line in open(os.path.join(log_dir, "train.jsonl"))]
    return {"steps": tr.state.step, "mesh": tr.mesh.shape, "counts": _counts(),
            "losses": [r["loss"] for r in recs],
            "checkpoints": sorted(os.listdir(os.path.join(log_dir, "ckpt")))}


def nccl_world(dev: torch.device, cfg: ModelConfig, flat: dict, small: bool = False) -> dict:
    b = tuple_batch(3, 2, 2, sizes(small)["negatives"], cfg.num_points)
    with tempfile.TemporaryDirectory(prefix="epcnet_nccl_") as tmp:
        torch.save({"cfg": cfg, "flat": flat, "batch": b}, os.path.join(tmp, "nccl_in.pt"))
        t0 = time.perf_counter()
        mp.start_processes(_nccl_rank, args=(_free_port(), tmp), nprocs=1, start_method="spawn")
        out = torch.load(os.path.join(tmp, "nccl_out.pt"), weights_only=False)
    out["wall_s"] = time.perf_counter() - t0
    assert out["backend"] == "nccl" and out["mesh"] == {"data": 1, "db": 1}, out
    assert out["step_counts"]["K1"] == 1, out["step_counts"]
    c = out["cli_train"]
    assert c["steps"] == 2 and c["counts"]["K1"] == 2, c
    assert len(c["losses"]) == 2 and all(np.isfinite(c["losses"])), c
    assert c["checkpoints"] == ["step_2.pt"], c
    return out


# -- which collectives gloo runs on CUDA tensors ------------------------------

GLOO_OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
            "reduce_scatter_tensor", "send_recv", "barrier")


def _probe_rank(rank: int, store: str, op: str) -> None:
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    x = torch.ones(8, device="cuda") * (rank + 1)
    if op == "all_reduce":
        got, want = x.clone(), torch.full((8,), 3.0)
        dist.all_reduce(got)
    elif op == "broadcast":
        got, want = x.clone(), torch.ones(8)
        dist.broadcast(got, 0)
    elif op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        got, want = torch.cat(parts), torch.cat([torch.ones(8), torch.full((8,), 2.0)])
    elif op == "all_gather_into_tensor":
        got, want = torch.empty(16, device="cuda"), torch.cat([torch.ones(8), torch.full((8,), 2.0)])
        dist.all_gather_into_tensor(got, x)
    elif op == "reduce_scatter_tensor":
        got, want = torch.empty(4, device="cuda"), torch.full((4,), 3.0)
        dist.reduce_scatter_tensor(got, x)
    elif op == "send_recv":
        got, want = torch.empty_like(x), torch.full((8,), 2.0 - rank)
        ops = [dist.P2POp(dist.isend, x, 1 - rank), dist.P2POp(dist.irecv, got, 1 - rank)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    else:
        dist.barrier()
        got = want = torch.zeros(1)
    torch.cuda.synchronize()
    if not torch.equal(got.cpu(), want):
        raise ValueError(f"{op} gave {got.cpu().tolist()}, not {want.tolist()}")
    dist.destroy_process_group()


def gloo_cuda_ops(ops=GLOO_OPS) -> dict:
    """Each op in a pair of processes of its own: "accepted" (it ran and
    gave the plain values), or how the pair ended (a refusal may raise or
    abort the process; wrong values raise ``ValueError``)."""
    out = {}
    with tempfile.TemporaryDirectory(prefix="epcnet_probe_") as tmp:
        # every pair at once; each joined with a time limit, killed after it
        ctxs = {op: mp.start_processes(_probe_rank, args=(os.path.join(tmp, op), op), nprocs=2,
                                       start_method="spawn", join=False) for op in ops}
        deadline = time.monotonic() + 180
        for op, ctx in ctxs.items():
            try:
                while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                    if time.monotonic() > deadline:
                        raise TimeoutError("no answer in 180 s")
                out[op] = "accepted"
            except (mp.ProcessRaisedException, mp.ProcessExitedException, TimeoutError) as e:
                out[op] = str(e).strip().splitlines()[-1][:200]  # the error's own line
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="a tiny model and sizes")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    sz = sizes(args.small)
    cfg = sz["cfg"]
    flat = init_flat_variables(cfg, 0)
    embed = build_embed_fn(cfg, dev, variables=flat)
    sub = blob_submaps(np.random.default_rng(1), sz["submaps"], cfg.num_points)
    res = {"retrieval": retrieval(dev, embed, sub, sz["db_rows"]),
           "gloo_world": gloo_world(dev, cfg, flat, args.small)}
    if dev.type == "cuda":
        res["nccl_world"] = nccl_world(dev, cfg, flat, args.small)
        res["gloo_cuda_ops"] = gloo_cuda_ops()
    print(json.dumps(res, default=str))
    return res


if __name__ == "__main__":
    main()
