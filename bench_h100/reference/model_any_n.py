"""EPC-Net and EPC-Net-L plainly, as ``model.py`` computes them, at any
number of points: the same forward (``model.py``'s functions), whose kNN
keeps each block of rows' k winners alone.

``model.knn_ids`` keeps a view of each block's whole sort until its
blocks are joined, B·N²·8 bytes in all: 34 GB a cloud at N=65536, more than
the card holds beside anything. ``knn_ids`` here copies the k winners out
of each block's sort, so a block's sort is freed before the next; the ids
are the same (the same distances, the same stable sort).
"""

from __future__ import annotations

import torch

from bench_h100.reference import model
from bench_h100.reference.precision import FULL, Precision


def knn_ids(x: torch.Tensor, k: int) -> torch.Tensor:
    """``model.knn_ids``: [B, N, 3] -> [B, N, k] int64, nearest first, ties
    to the lower index."""
    out = []
    for r0 in range(0, x.shape[1], model.ROWS):
        d = model.sqdist(x[:, r0:r0 + model.ROWS], x)
        out.append(torch.sort(d, dim=-1, stable=True).indices[..., :k].clone())
        del d
    return torch.cat(out, dim=1)


def forward(w: dict, m: dict, x: torch.Tensor, train: bool = False,
            stats: dict | None = None, p: Precision = FULL) -> torch.Tensor:
    """``model.forward``: descriptors [B, output_dim] of submaps ``x``
    [B, N, 3]."""
    x, eps = x.float(), m["bn_epsilon"]
    with torch.no_grad():
        ids = knn_ids(x, m["knn_k"])
    f, scales = x, []
    for i in range(len(m["proxyconv_channels"])):
        fl = p.low(f)
        h = torch.cat([model.neighbour_mean(fl, ids) - fl, fl], dim=-1)
        key = f"proxyconv_{i}"
        f = torch.relu(model.batch_norm(model.dense(h, w, key + ".dense", p), w, key + ".bn",
                                        train, stats, eps))
        scales.append(f)
    f = torch.cat(scales, dim=-1)
    for j in range(len(m["lift_channels"])):
        f = torch.relu(model.batch_norm(model.dense(f, w, f"lift.dense_{j}", p), w,
                                        f"lift.bn_{j}", train, stats, eps))
    return model.gvlad(f, w, m, p)


@torch.no_grad()
def embed(w: dict, m: dict, points, device, p: Precision = FULL) -> torch.Tensor:
    """Eval-mode descriptors of ``points`` [B, N, 3] (numpy or tensor), a
    block of ``model.CLOUDS`` at a time; fp32 on ``device``."""
    x = torch.as_tensor(points, dtype=torch.float32, device=device)
    return torch.cat([forward(w, m, x[s:s + model.CLOUDS], p=p)
                      for s in range(0, x.shape[0], model.CLOUDS)])
