"""MinkLoc3Dv2, plainly, in fp32: the reference the CPU tests hold the port's
``epcnet_torch/models/minkloc.py`` to. It imports torch only, keeps TF32 off
and builds its own voxels and kernel maps (a dense lookup grid, not sorted
keys), from the equations below, with nothing cached across calls.

MinkLoc3Dv2 [Komorowski, ICPR 2022, arXiv:2203.00972; github.com/jac99/
MinkLoc3Dv2, its MinkLoc3Dv2 model config]: MinkFPN with planes 64, 128,
64, 32, one ECABasicBlock a level, two top-down steps, conv0's kernel 5,
feature size 256, GeM pooling, cartesian voxels of 0.01, embeddings not
normalised.

- Voxels: ``c = floor(p / 0.01)`` in fp32 (a true division), one voxel for
  each distinct (cloud, c), feature 1. At tensor stride 2s the voxels are
  ``floor(c / 2s) · 2s`` of those at s.
- A convolution ``out[u] = Σ_o W_o · in[u + o·s]`` over the offsets whose
  input voxel exists, no bias; offsets ordered x slowest, z fastest. Odd
  kernels (5³, 3³) are centred and keep the input's voxels; the stride-2
  kernel 2³ takes offsets {0, 1}³ · s to the voxels at 2s; its transpose
  gives each voxel at s its parent's row times W at its own offset.
- MinkFPN: conv0 (5³, 1 -> 64) + BN + ReLU; four levels of a stride-2 conv
  (2³, width kept) + BN + ReLU and an ECABasicBlock; laterals 1x1 of level
  3 (32 -> 256), then transposed conv to stride 8 + lateral of level 2 (64
  -> 256), transposed conv to stride 4 + lateral of level 1 (128 -> 256).
- ECABasicBlock: conv 3³ + BN + ReLU + conv 3³ + BN, ECA, + residual (1x1
  conv + BN where the width changes, as MinkowskiEngine's ResNet blocks
  are built), ReLU. ECA: each cloud's channel means, a bias-free conv1d
  over the channels (kernel 3 at 32 and 64 channels, 5 at 128, zero
  padding), sigmoid, scale.
- GeM: ``(mean over the cloud's voxels of clamp(x, 1e-6)^p)^(1/p)``.
- BN eps 1e-5; in training the batch's mean and biased variance over all
  voxels of the batch (recorded in ``stats``), in eval the running ones.

``w`` holds tensors keyed by the port's ``state_dict`` keys (a sparse
convolution's ``offset_weight`` [K, Cin, Cout], a 1x1 conv's ``weight``
[out, in]). Given fp64 weights and points, every stage after the voxels
runs in fp64.
"""

from __future__ import annotations

import itertools

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

STEP = 0.01
PLANES = (64, 128, 64, 32)
TOP_DOWN = 2
EPS = 1e-5
GEM_EPS = 1e-6


def voxelize(points: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] -> the distinct (cloud, x, y, z) rows [M, 4] int64, sorted."""
    b, n, _ = points.shape
    step = torch.tensor(STEP, dtype=torch.float32, device=points.device)
    c = torch.floor(points.float() / step).long()
    cloud = torch.arange(b, device=points.device)[:, None, None].expand(b, n, 1)
    return torch.unique(torch.cat([cloud, c], -1).reshape(-1, 4), dim=0)


def coarsen(v: torch.Tensor, s: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Voxels at stride s -> (voxels at 2s, each voxel's parent row)."""
    up = v.clone()
    up[:, 1:] = torch.div(v[:, 1:], 2 * s, rounding_mode="floor") * (2 * s)
    return torch.unique(up, dim=0, return_inverse=True)


class Grid:
    """A dense table of a voxel set at stride s: (cloud, c) -> row, -1 for
    none (and outside the table)."""

    def __init__(self, v: torch.Tensor, s: int, pad: int):
        self.s = s
        self.lo = v[:, 1:].amin(0) - pad * s
        dims = (v[:, 1:].amax(0) + pad * s - self.lo) // s + 1
        self.dims = [int(v[:, 0].max()) + 1, *[int(d) for d in dims]]
        self.table = torch.full(self.dims, -1, dtype=torch.int32, device=v.device)
        self.table[self._index(v)] = torch.arange(v.shape[0], dtype=torch.int32,
                                                  device=v.device)

    def _index(self, v):
        g = (v[:, 1:] - self.lo) // self.s
        return (v[:, 0], g[:, 0], g[:, 1], g[:, 2])

    def find(self, v: torch.Tensor) -> torch.Tensor:
        g = (v[:, 1:] - self.lo) // self.s
        inside = ((g >= 0) & (g < torch.tensor(self.dims[1:], device=v.device))).all(1)
        idx = torch.full((v.shape[0],), -1, dtype=torch.long, device=v.device)
        gi = g[inside]
        idx[inside] = self.table[v[inside, 0], gi[:, 0], gi[:, 1], gi[:, 2]].long()
        return idx


def offsets(size: int) -> list[tuple[int, int, int]]:
    r = range(2) if size == 2 else range(-(size // 2), size // 2 + 1)
    return list(itertools.product(r, r, r))


def odd_table(v: torch.Tensor, s: int, size: int) -> torch.Tensor:
    """[M, size³]: the row of voxel u + o·s, or -1."""
    grid = Grid(v, s, size // 2)
    cols = []
    for o in offsets(size):
        q = v.clone()
        q[:, 1:] += torch.tensor(o, device=v.device) * s
        cols.append(grid.find(q))
    return torch.stack(cols, 1)


def slots(v: torch.Tensor, parents: torch.Tensor, coarse: torch.Tensor, s: int) -> torch.Tensor:
    """Each voxel's offset index in {0, 1}³ (x slowest) under its parent."""
    o = (v[:, 1:] - coarse[parents, 1:]) // s
    return o[:, 0] * 4 + o[:, 1] * 2 + o[:, 2]


class Voxels:
    """Every stride's voxels and the maps of a forward."""

    def __init__(self, points: torch.Tensor):
        self.b = points.shape[0]
        self.v = {1: voxelize(points)}
        self.parent, self.slot = {}, {}
        s = 1
        while s < 2 ** len(PLANES):
            self.v[2 * s], self.parent[s] = coarsen(self.v[s], s)
            self.slot[s] = slots(self.v[s], self.parent[s], self.v[2 * s], s)
            s *= 2

    def cloud_counts(self, s):
        return self.v[s][:, 0], torch.bincount(self.v[s][:, 0], minlength=self.b)


def conv_odd(x, table, w):
    """x [M, Cin], table [M, K], w [K, Cin, Cout] -> [M, Cout]."""
    xp = torch.cat([x, torch.zeros_like(x[:1])])  # row -1: zeros
    out = 0
    for o in range(table.shape[1]):
        out = out + xp[table[:, o]] @ w[o]
    return out


def conv_down(x, parent, slot, rows, w):
    """From stride s (x [M_s, Cin]) to the ``rows`` voxels at 2s."""
    out = torch.zeros((rows, w.shape[2]), dtype=x.dtype, device=x.device)
    for o in range(8):
        sel = slot == o
        out = out.index_add(0, parent[sel], x[sel] @ w[o])
    return out


def conv_up(x, parent, slot, w):
    """From stride 2s (x) back to the voxels at s."""
    out = torch.zeros((parent.shape[0], w.shape[2]), dtype=x.dtype, device=x.device)
    for o in range(8):
        sel = (slot == o).nonzero().squeeze(1)
        out = out.index_copy(0, sel, x[parent[sel]] @ w[o])
    return out


def batch_norm(x, w, key, train, stats):
    if train:
        mean = x.mean(0)
        var = ((x - mean) ** 2).mean(0)
        if stats is not None:
            stats[key] = (mean.detach(), var.detach())
    else:
        mean, var = w[key + ".mean"], w[key + ".var"]
    return (x - mean) / torch.sqrt(var + EPS) * w[key + ".scale"] + w[key + ".bias"]


def cloud_mean(x, cloud, counts):
    z = torch.zeros((counts.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)
    return z.index_add(0, cloud, x) / counts[:, None]


def eca(x, w, key, cloud, counts):
    m = cloud_mean(x, cloud, counts)
    k = w[key + ".weight"]
    y = torch.nn.functional.conv1d(m[:, None, :], k.reshape(1, 1, -1),
                                   padding=(k.shape[0] - 1) // 2)[:, 0]
    return x * torch.sigmoid(y)[cloud]


def block(x, w, key, table, cloud, counts, train, stats):
    out = torch.relu(batch_norm(conv_odd(x, table, w[key + ".conv1.offset_weight"]), w,
                                key + ".norm1", train, stats))
    out = batch_norm(conv_odd(out, table, w[key + ".conv2.offset_weight"]), w,
                     key + ".norm2", train, stats)
    out = eca(out, w, key + ".eca", cloud, counts)
    if key + ".downsample.weight" in w:
        x = batch_norm(x @ w[key + ".downsample.weight"].t(), w, key + ".downsample_bn",
                       train, stats)
    return torch.relu(out + x)


def forward(w: dict, points: torch.Tensor, train: bool = False,
            stats: dict | None = None) -> torch.Tensor:
    """Descriptors [B, 256] of submaps [B, N, 3]."""
    vox = Voxels(points)
    dt = w["conv0.offset_weight"].dtype
    f = torch.ones((vox.v[1].shape[0], 1), dtype=dt, device=points.device)
    f = torch.relu(batch_norm(conv_odd(f, odd_table(vox.v[1], 1, 5), w["conv0.offset_weight"]),
                              w, "bn0", train, stats))
    lateral = []
    for i in range(len(PLANES)):
        s = 2 ** i
        f = conv_down(f, vox.parent[s], vox.slot[s], vox.v[2 * s].shape[0],
                      w[f"down_{i}.offset_weight"])
        f = torch.relu(batch_norm(f, w, f"down_bn_{i}", train, stats))
        cloud, counts = vox.cloud_counts(2 * s)
        f = block(f, w, f"block_{i}", odd_table(vox.v[2 * s], 2 * s, 3), cloud, counts,
                  train, stats)
        if len(PLANES) - 1 - TOP_DOWN <= i < len(PLANES) - 1:
            lateral.append(f)
    f = f @ w["conv1x1_0.weight"].t()
    s = 2 ** len(PLANES)
    for j in range(TOP_DOWN):
        s //= 2
        f = (conv_up(f, vox.parent[s], vox.slot[s], w[f"tconv_{j}.offset_weight"])
             + lateral[-1 - j] @ w[f"conv1x1_{j + 1}.weight"].t())
    cloud, counts = vox.cloud_counts(s)
    p = w["gem.p"]
    return cloud_mean(f.clamp(min=GEM_EPS).pow(p), cloud, counts).pow(1.0 / p)


def counts(points: torch.Tensor) -> dict:
    """Voxels at each stride and pairs of each kernel map, by the port's
    map names."""
    vox = Voxels(points)
    out = {"voxels": {s: int(v.shape[0]) for s, v in vox.v.items()}, "pairs": {}}
    out["pairs"]["conv0"] = int((odd_table(vox.v[1], 1, 5) >= 0).sum())
    for i in range(len(PLANES)):
        out["pairs"][f"down_{i}"] = int(vox.v[2 ** i].shape[0])
        out["pairs"][f"block_{i}"] = int((odd_table(vox.v[2 ** (i + 1)], 2 ** (i + 1), 3)
                                          >= 0).sum())
    for j in range(TOP_DOWN):
        out["pairs"][f"up_{j}"] = int(vox.v[2 ** (len(PLANES) - 1 - j)].shape[0])
    return out
