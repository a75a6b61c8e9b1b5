"""EPC-Net and EPC-Net-L, plainly, in fp32 [arXiv:2101.02374 §III; the
port's ``models/epcnet.py`` is the system under test, not a source here].

[B, N, 3] submap -> kNN graph on xyz (k nearest, self included, ordered by
squared distance and then index) -> ProxyConv layers (proxy = the mean of
the k neighbours' features; ReLU(BN(W [proxy - f, f] + b))) -> the concat
of every layer's output -> the lift (Dense, BN, ReLU per width) -> G-VLAD
(softmax assignment, residual sums, intra-norm and L2 norm, grouped FC,
output FC, context gating, L2 norm) -> [B, output_dim].

The squared distance is summed coordinate by coordinate, each product and
sum rounded on its own, as the configuration's kNN defines it; the sort is
stable, so ties go to the lower index. BN normalises with the
configuration's ``bn_epsilon``: with the running statistics in eval, with
the batch's (mean and biased variance over every point of every cloud) in
training.

``weights`` is a dict of fp32 tensors keyed as ``bench_h100/weights.py``
makes them. ``precision`` rounds the operands of each product
(``precision.py``): the control runs this same code below the
configuration's precision.
"""

from __future__ import annotations

import torch

from bench_h100.reference.precision import FULL, Precision

# rows of the kNN's distance matrix sorted at a time, and clouds embedded at
# a time, so that the reference fits beside anything on the card
ROWS = 512
CLOUDS = 8


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, R, 3] x [B, N, 3] -> [B, R, N] squared distances, coordinate
    by coordinate."""
    d = torch.zeros(a.shape[:-1] + (b.shape[-2],), dtype=torch.float32, device=a.device)
    for c in range(a.shape[-1]):
        diff = a[..., :, c, None] - b[..., None, :, c]
        d = d + diff * diff
    return d


def knn_ids(x: torch.Tensor, k: int) -> torch.Tensor:
    """[B, N, 3] -> [B, N, k] int64: each point's k nearest, nearest first,
    ties to the lower index (a stable full sort of each row)."""
    out = []
    for r0 in range(0, x.shape[1], ROWS):
        d = sqdist(x[:, r0:r0 + ROWS], x)
        out.append(torch.sort(d, dim=-1, stable=True).indices[..., :k])
        del d
    return torch.cat(out, dim=1)


def neighbour_mean(f: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """[B, N, C] features, [B, N, k] ids -> [B, N, C]: the mean of each
    point's k neighbours' features."""
    b, n, c = f.shape
    k = ids.shape[-1]
    g = torch.gather(f, 1, ids.reshape(b, n * k, 1).expand(-1, -1, c))
    return g.reshape(b, n, k, c).sum(2) / k


def dense(x, w, key, p: Precision, wide: bool = False):
    rnd = p.wide if wide else p.low
    return rnd(x) @ rnd(w[key + ".weight"]).t() + w[key + ".bias"]


def batch_norm(x, w, key, train: bool, stats: dict | None, eps: float):
    """BN over every leading axis. In training the batch's statistics are
    used and recorded in ``stats[key] = (mean, biased var)``."""
    if train:
        red = tuple(range(x.dim() - 1))
        mean = x.mean(dim=red)
        var = ((x - mean) ** 2).mean(dim=red)
        if stats is not None:
            stats[key] = (mean.detach(), var.detach())
    else:
        mean, var = w[key + ".mean"], w[key + ".var"]
    return (x - mean) * torch.rsqrt(var + eps) * w[key + ".scale"] + w[key + ".bias"]


def gvlad(f: torch.Tensor, w: dict, model: dict, p: Precision) -> torch.Tensor:
    """[B, N, D] -> [B, output_dim] L2-normalised."""
    b = f.shape[0]
    g, gd, out_dim = model["vlad_groups"], model["vlad_group_dim"], model["output_dim"]
    a = torch.softmax(dense(f, w, "gvlad.assign", p), dim=-1)  # [B, N, C]
    s = p.wide(a).transpose(1, 2) @ p.wide(f)  # [B, C, D]
    v = s - a.sum(1)[..., None] * w["gvlad.centroids"]
    v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)
    flat = v.reshape(b, -1)
    flat = flat / (torch.linalg.vector_norm(flat, dim=-1, keepdim=True) + 1e-12)
    h = torch.einsum("bgi,gio->bgo", p.wide(flat.reshape(b, g, -1)),
                     p.wide(w["gvlad.group_w"])) + w["gvlad.group_b"]
    out = h.reshape(b, g * gd)
    if not (g == 1 and gd == out_dim):
        out = dense(out, w, "gvlad.out_fc", p, wide=True)
    if model["gating"]:
        out = out * torch.sigmoid(dense(out, w, "gvlad.gate", p, wide=True))
    return out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True) + 1e-12)


def forward(w: dict, model: dict, x: torch.Tensor, train: bool = False,
            stats: dict | None = None, p: Precision = FULL) -> torch.Tensor:
    """Descriptors [B, output_dim] of submaps ``x`` [B, N, 3]."""
    x, eps = x.float(), model["bn_epsilon"]
    with torch.no_grad():
        ids = knn_ids(x, model["knn_k"])
    f, scales = x, []
    for i in range(len(model["proxyconv_channels"])):
        fl = p.low(f)
        h = torch.cat([neighbour_mean(fl, ids) - fl, fl], dim=-1)
        key = f"proxyconv_{i}"
        f = torch.relu(batch_norm(dense(h, w, key + ".dense", p), w, key + ".bn", train,
                                  stats, eps))
        scales.append(f)
    f = torch.cat(scales, dim=-1)
    for j in range(len(model["lift_channels"])):
        f = torch.relu(batch_norm(dense(f, w, f"lift.dense_{j}", p), w, f"lift.bn_{j}",
                                  train, stats, eps))
    return gvlad(f, w, model, p)


@torch.no_grad()
def embed(w: dict, model: dict, points, device, p: Precision = FULL) -> torch.Tensor:
    """Eval-mode descriptors of ``points`` [B, N, 3] (numpy or tensor), a
    block of ``CLOUDS`` at a time; fp32 on ``device``."""
    x = torch.as_tensor(points, dtype=torch.float32, device=device)
    return torch.cat([forward(w, model, x[s:s + CLOUDS], p=p)
                      for s in range(0, x.shape[0], CLOUDS)])
