"""Recall@N evaluation harness (twin of ``epcnet_tpu/evals/recall.py``).

For every (database run, query run) pair of each region: embed all
submaps, find each query's nearest database descriptors, and score

  - recall@k, k = 1..top_k: the share of queries whose ground-truth set
    meets the top k;
  - recall@top-1%: k = max(ceil(|DB| / 100), 1);

averaged over the pairs, then over the regions. Retrieval is the exact
top-k of ``ops/retrieval.py`` (ties to the lowest index), in fp32 or
against the int8 database that serving keeps. Descriptors come from the
port's ``embed`` (``train.step.build_embed_fn``, which carries its weights
and device); retrieval runs on that device, or, with a ``mesh`` (a
``parallel.Mesh``) whose "db" axis is above 1, sharded over its devices
(``sharded_topk_neighbors``), as evaluation and serving run it in JAX.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from epcnet_torch.configs import DataConfig, EvalConfig
from epcnet_torch.data.native_loader import load_pc_files_native
from epcnet_torch.device import resolve_device
from epcnet_torch.ops.retrieval import (
    quantize_descriptors,
    sharded_topk_neighbors,
    topk_neighbors,
    topk_neighbors_quantized,
)
from epcnet_torch.utils.timing import cuda_ms


def _sharded(mesh) -> bool:
    """A mesh whose "db" axis shards the database."""
    return mesh is not None and mesh.shape.get("db", 1) > 1


def embed_entries(embed, entries: dict, data_cfg: DataConfig,
                  batch_size: int = 64) -> np.ndarray:
    """Embed every submap of a database/query set dict -> [n, D] fp32, in
    batches of ``batch_size`` read by the native loader; the last batch is
    zero-padded (BN uses its running statistics, so the padding cannot
    change the real rows)."""
    n = len(entries)
    descs = []
    buf = np.zeros((batch_size, data_cfg.num_points, 3), np.float32)
    for s in range(0, n, batch_size):
        cnt = min(s + batch_size, n) - s
        files = [entries[s + j]["query"] for j in range(cnt)]
        load_pc_files_native(files, data_cfg.dataset_root, data_cfg.num_points,
                             out=buf[:cnt], n_threads=data_cfg.loader_threads)
        if cnt < batch_size:
            buf[cnt:] = 0.0
        descs.append(embed(buf)[:cnt].cpu().numpy())
    return np.concatenate(descs, axis=0)


def get_recall(
    db_desc: np.ndarray,
    q_desc: np.ndarray,
    gt: list[list[int]],
    top_k: int = 25,
    mesh=None,
    quantize: str = "none",
    device: str | torch.device | None = None,
):
    """recall@1..top_k, recall@top-1% and the number of queries scored, for
    one (database, query run) pair, retrieving on ``device`` (the card
    unless ``"cpu"``).

    gt[i] = the ground-truth database indices of query i; a query with none
    is skipped. ``quantize="int8"`` retrieves against the int8 database as
    serving does; ``mesh`` with a "db" axis above 1 shards it."""
    if quantize not in ("none", "int8"):
        raise ValueError(f"quantize={quantize!r} not in {{'none', 'int8'}}")
    dev = resolve_device(device)
    one_percent_k = max(int(np.ceil(len(db_desc) / 100.0)), 1)
    k = min(max(top_k, one_percent_k), len(db_desc))
    q = torch.as_tensor(np.asarray(q_desc, np.float32), device=dev)
    db = torch.as_tensor(np.asarray(db_desc, np.float32), device=dev)
    with torch.inference_mode():
        if quantize == "int8":
            db_q, db_scale = quantize_descriptors(db)
            idx, _ = (sharded_topk_neighbors(q, db_q, k, mesh, db_scale=db_scale)
                      if _sharded(mesh) else topk_neighbors_quantized(q, db_q, db_scale, k))
        elif _sharded(mesh):
            idx, _ = sharded_topk_neighbors(q, db, k, mesh)
        else:
            idx, _ = topk_neighbors(q, db, k)
    idx = idx.cpu().numpy()

    recall = np.zeros(top_k)
    one_percent_hits = 0
    evaluated = 0
    for i, gti in enumerate(gt):
        if not gti:
            continue
        evaluated += 1
        gts = set(gti)
        hits = [j for j, n in enumerate(idx[i]) if int(n) in gts]
        if hits:
            first = hits[0]
            if first < top_k:
                recall[first:] += 1
            if first < one_percent_k:
                one_percent_hits += 1
    if evaluated == 0:
        return np.zeros(top_k), 0.0, 0
    return recall / evaluated, one_percent_hits / evaluated, evaluated


def evaluate_region(
    embed,
    database_sets: list[dict],
    query_sets: list[dict],
    data_cfg: DataConfig,
    eval_cfg: EvalConfig | None = None,
    mesh=None,
    quantize: str = "none",
):
    """All (database run i, query run j != i) pairs of one region. Returns
    the averaged metrics; ``evaluated_pairs=0`` where no pair had a query
    to score."""
    eval_cfg = eval_cfg or EvalConfig()
    # an empty run is skipped on both sides: a pair with nothing in it must
    # not score as zero recall
    db_descs = [embed_entries(embed, s, data_cfg, eval_cfg.batch_size) if len(s) else None
                for s in database_sets]
    q_descs = [embed_entries(embed, s, data_cfg, eval_cfg.batch_size) if len(s) else None
               for s in query_sets]
    recalls, one_percents = [], []
    for di in range(len(database_sets)):
        if db_descs[di] is None:
            continue
        for qi in range(len(query_sets)):
            if di == qi:
                continue
            qset = query_sets[qi]
            if not qset:
                continue
            gt = [qset[i].get(di, []) for i in range(len(qset))]
            r, p1, n_eval = get_recall(db_descs[di], q_descs[qi], gt, eval_cfg.top_k,
                                       mesh=mesh, quantize=quantize, device=embed.device)
            if n_eval:
                recalls.append(r)
                one_percents.append(p1)
    if not recalls:
        return {"recall_at": np.zeros(eval_cfg.top_k), "recall_at_1pct": 0.0,
                "evaluated_pairs": 0}
    return {
        "recall_at": np.mean(recalls, axis=0),
        "recall_at_1pct": float(np.mean(one_percents)),
        "evaluated_pairs": len(recalls),
    }


def evaluate_dataset(embed, regions: dict, data_cfg: DataConfig,
                     eval_cfg: EvalConfig | None = None, mesh=None,
                     quantize: str = "none"):
    """regions: {name: (database_sets, query_sets)}. Each region's metrics,
    and under ``"average"`` their mean over the regions that scored a pair
    (the reference's results.txt table)."""
    out = {}
    per_region = []
    for name, (db_sets, q_sets) in regions.items():
        m = evaluate_region(embed, db_sets, q_sets, data_cfg, eval_cfg, mesh=mesh,
                            quantize=quantize)
        out[name] = m
        # a region that scored no pair must not average in as zeros
        if m.get("evaluated_pairs", 1) > 0:
            per_region.append(m)
    if not per_region:
        per_region = list(out.values()) or [
            {"recall_at": np.zeros((eval_cfg or EvalConfig()).top_k),
             "recall_at_1pct": 0.0}
        ]
    out["average"] = {
        "recall_at": np.mean([m["recall_at"] for m in per_region], axis=0),
        "recall_at_1pct": float(np.mean([m["recall_at_1pct"] for m in per_region])),
    }
    return out


def retrieval_latency_probe(
    db_desc: np.ndarray, num_queries: int = 256, top_k: int = 25, mesh=None,
    seed: int = 0, device: str | torch.device | None = None,
):
    """Retrieval latency against ``db_desc`` on ``device`` (the card unless
    ``"cpu"``), two views:

    - ``p50_ms`` / ``p99_ms``: the host-clock time of one single-query call,
      the copy of its result to the host included; the query is put on the
      device before the clock starts, as the JAX twin does;
    - ``device_ms``: the device time of one query with no dispatch in it.
      The queries are chained by data dependence (each query moves by
      1e-9 x its nearest distance) and the chains of 36 and 4 queries are
      taken apart; on the card each chain is one CUDA graph, replayed and
      timed by CUDA events, so no host launch sits between its kernels. On
      the CPU the chains run eagerly on the host clock (no device number).

    With ``mesh`` ("db" above 1) every query takes the sharded retrieval.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    top_k = min(top_k, len(db_desc))  # a tiny DB: k cannot exceed the rows
    qs = db_desc[rng.integers(0, len(db_desc), num_queries)] + 1e-3 * rng.standard_normal(
        (num_queries, db_desc.shape[1])
    ).astype(np.float32)
    db = torch.as_tensor(np.asarray(db_desc, np.float32), device=dev)

    def retrieve(q):
        if _sharded(mesh):
            return sharded_topk_neighbors(q, db, top_k, mesh)
        return topk_neighbors(q, db, top_k)

    lat = []
    with torch.inference_mode():
        retrieve(torch.as_tensor(qs[:1], device=dev))[0].cpu()  # warm-up
        for i in range(num_queries):
            q = torch.as_tensor(qs[i:i + 1], device=dev)
            t0 = time.perf_counter()
            idx, _ = retrieve(q)
            idx.cpu()
            lat.append(time.perf_counter() - t0)
    lat = np.sort(np.array(lat))

    def chain(q, n):
        for _ in range(n):
            idx, dist = retrieve(q)
            q = q + 1e-9 * dist[:, :1]
        return idx

    lo, hi = 4, 36
    q0 = torch.as_tensor(qs[:1], device=dev)
    with torch.inference_mode():
        t_lo, t_hi = (_chain_ms(lambda n=n: chain(q0, n), dev) for n in (lo, hi))
    device_ms = max(0.0, (t_hi - t_lo) / (hi - lo))
    return {
        "p50_ms": float(lat[int(0.50 * len(lat))] * 1e3),
        "p99_ms": float(lat[min(int(0.99 * len(lat)), len(lat) - 1)] * 1e3),
        "device_ms": float(device_ms),
    }


def _chain_ms(fn, dev: torch.device) -> float:
    """The least of 3 times of ``fn()`` in ms: one CUDA graph replay timed
    by CUDA events on the card, the host clock on the CPU."""
    if dev.type != "cuda":
        fn()
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return min(ts) * 1e3
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()  # the allocator and cuBLAS warm up before the capture
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return min(cuda_ms(graph.replay, 1) for _ in range(3))
