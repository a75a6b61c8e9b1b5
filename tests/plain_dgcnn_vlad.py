"""DGCNN-VLAD, plainly, in fp32: the reference the CPU tests hold the port's
``epcnet_torch/models/dgcnn.py`` to. It imports torch only.

The backbone is DGCNN's [Wang et al., ACM TOG 2019, arXiv:1801.07829; the
authors' ``pytorch/model.py``, class ``DGCNN``, k = 20]:

- each of four EdgeConv layers builds its own kNN graph over its input
  (xyz, then the previous layer's output), the point itself included;
- e_ij = [x_j - x_i, x_i], h_ij = LeakyReLU_0.2(BN(W_i e_ij)) with no
  bias, x'_i = max over j of h_ij; widths 64, 64, 128, 256; BN over every
  edge, eps 1e-5;
- conv5: the concat of the four outputs (512) -> 1024, no bias, BN,
  LeakyReLU 0.2.

The head is PointNetVLAD's NetVLAD [Uy & Lee, CVPR 2018, arXiv:1804.03492]
on conv5's per-point features: 64 clusters, the residual sums, intra-norm
and L2 norm, one 65,536 -> 256 FC, context gating, the L2 norm.

Departures from the authors' code, each the port's too:

- Layer 0's graph is by the squared distance summed coordinate by
  coordinate (each product and sum rounded on its own); layers 1-3 rank by
  ``||x_j||^2 - 2 <x_i, x_j>``. The authors rank every layer by
  ``-||x_i||^2 + 2 <x_i, x_j> - ||x_j||^2``, which orders the same in
  exact arithmetic.
- Ties go to the lower index (a stable sort); the authors' ``topk``
  promises no order.
- BN in training normalises with the batch's mean and biased variance and
  records them (``stats``); the running update is the caller's
  (TF-style momentum), not ``nn.BatchNorm2d``'s. Eval uses the running
  statistics.
- DGCNN's classification head (max and mean pooling, three FCs, dropout)
  is replaced by NetVLAD on conv5's per-point features, and that NetVLAD is
  the port's: the assignment is a Dense with a bias and no BN, the FC has
  a bias and no BN, the gate is a Dense with a bias (PointNetVLAD's code
  has BN after each of the three instead).

``w`` holds fp32 tensors keyed by the port's ``state_dict`` keys (a Dense
weight [out, in]); ``channels`` the EdgeConv widths. TF32 stays off. Given
fp64 weights and points, every stage runs in fp64.
"""

from __future__ import annotations

import torch

EPS = 1e-5
SLOPE = 0.2


def sqdist_xyz(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, R, 3] x [B, N, 3] -> [B, R, N], coordinate by coordinate."""
    d = torch.zeros(a.shape[:-1] + (b.shape[-2],), dtype=a.dtype, device=a.device)
    for c in range(a.shape[-1]):
        diff = a[..., :, c, None] - b[..., None, :, c]
        d = d + diff * diff
    return d


def knn_ids(x: torch.Tensor, k: int, xyz: bool) -> torch.Tensor:
    """[B, N, D] -> [B, N, k] int64, nearest first, ties to the lower index."""
    if xyz:
        s = sqdist_xyz(x, x)
    else:
        s = (x * x).sum(-1)[:, None, :] - 2 * (x @ x.transpose(1, 2))
    return torch.sort(s, dim=-1, stable=True).indices[..., :k]


def batch_norm(x, w, key, train: bool, stats: dict | None):
    if train:
        red = tuple(range(x.dim() - 1))
        mean = x.mean(dim=red)
        var = ((x - mean) ** 2).mean(dim=red)
        if stats is not None:
            stats[key] = (mean.detach(), var.detach())
    else:
        mean, var = w[key + ".mean"], w[key + ".var"]
    return (x - mean) / torch.sqrt(var + EPS) * w[key + ".scale"] + w[key + ".bias"]


def leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, SLOPE * x)


def edge_conv(f: torch.Tensor, ids: torch.Tensor, w: dict, key: str, train: bool,
              stats: dict | None) -> torch.Tensor:
    b, n, c = f.shape
    k = ids.shape[-1]
    nbr = torch.stack([f[i][ids[i]] for i in range(b)])  # [B, N, k, C]
    ctr = f[:, :, None, :].expand(b, n, k, c)
    e = torch.cat([nbr - ctr, ctr], dim=-1)
    h = leaky(batch_norm(e @ w[key + ".dense.weight"].t(), w, key + ".bn", train, stats))
    return h.max(dim=2).values


def netvlad(f: torch.Tensor, w: dict) -> torch.Tensor:
    """[B, N, D] -> [B, 256] L2-normalised."""
    b = f.shape[0]
    a = torch.softmax(f @ w["netvlad.assign.weight"].t() + w["netvlad.assign.bias"], dim=-1)
    v = a.transpose(1, 2) @ f - a.sum(1)[..., None] * w["netvlad.centroids"]
    v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)
    flat = v.reshape(b, -1)
    flat = flat / (torch.linalg.vector_norm(flat, dim=-1, keepdim=True) + 1e-12)
    out = flat @ w["netvlad.group_w"][0] + w["netvlad.group_b"][0]
    out = out * torch.sigmoid(out @ w["netvlad.gate.weight"].t() + w["netvlad.gate.bias"])
    return out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True) + 1e-12)


def forward(w: dict, x: torch.Tensor, k: int, channels, train: bool = False,
            stats: dict | None = None, graphs_in=None):
    """(descriptors [B, 256], the four graphs [B, N, k]) of submaps x [B, N, 3];
    ``graphs_in``, where given, replaces each layer's own graph."""
    f, graphs, outs = x.to(torch.promote_types(x.dtype, torch.float32)), [], []
    for i in range(len(channels)):
        with torch.no_grad():
            ids = knn_ids(f, k, xyz=i == 0) if graphs_in is None else graphs_in[i].long()
        graphs.append(ids)
        f = edge_conv(f, ids, w, f"edgeconv_{i}", train, stats)
        outs.append(f)
    h = torch.cat(outs, dim=-1) @ w["lift.dense_0.weight"].t()
    h = leaky(batch_norm(h, w, "lift.bn_0", train, stats))
    return netvlad(h, w), graphs
