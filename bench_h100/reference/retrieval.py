"""Exact retrieval in fp64: each query's k nearest database rows by squared
L2 distance, nearest first, ties to the lower row (the order of
``jax.lax.top_k(-d)``), a block of rows at a time."""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 1 << 18  # database rows moved to the device at a time


@torch.no_grad()
def topk(queries, db: np.ndarray, k: int, device):
    """(ids int64 [Q, k], fp64 distances [Q, k]) of ``queries`` [Q, D] over
    ``db`` [N, D] (host rows, moved to ``device`` a block at a time)."""
    q = torch.as_tensor(np.asarray(queries), device=device).double()
    qq = (q * q).sum(1, keepdim=True)
    best_d = best_i = None
    for s in range(0, len(db), BLOCK):
        x = torch.as_tensor(db[s:s + BLOCK], device=device).double()
        d = (qq + (x * x).sum(1)[None] - 2.0 * (q @ x.t())).clamp_min(0.0)
        dv, di = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False, sorted=True)
        di = di + s
        if best_d is not None:
            dv, di = torch.cat([best_d, dv], 1), torch.cat([best_i, di], 1)
        # order by (distance, row): sort by row first, then stably by distance
        o = torch.argsort(di, dim=1)
        dv, di = dv.gather(1, o), di.gather(1, o)
        o = torch.sort(dv, dim=1, stable=True).indices[:, :k]
        best_d, best_i = dv.gather(1, o), di.gather(1, o)
    return best_i.cpu().numpy(), best_d.cpu().numpy()

