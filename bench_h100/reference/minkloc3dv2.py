"""MinkLoc3Dv2, plainly, in fp32 [Komorowski, ICPR 2022, arXiv:2203.00972;
github.com/jac99/MinkLoc3Dv2, its MinkLoc3Dv2 model config; the port's
``models/minkloc.py`` is the system under test, not a source here]: a copy
of ``tests/plain_minkloc3dv2.py`` (its docstring states the equations), with
the control's rounding of each product's operands and ``embed``, which
takes the pool a block of ``CLOUDS`` submaps at a time. It builds its own
voxels and kernel maps (a dense lookup grid) from the equations, with
nothing cached across calls, and imports nothing of the port.

Voxels ``floor(p / 0.01)`` (fp32, a true division; floor below 0); strides
1-16, each ``floor(c / 2s) · 2s``; conv0 5³, four levels of a stride-2 conv
2³ + BN + ReLU and an ECABasicBlock (planes 64, 128, 64, 32; a 1x1 conv +
BN residual where the width changes), two top-down steps (transposed 2³
conv to the voxels at s / 2 + a 1x1 lateral), GeM (p from the weights, eps
1e-6) over each cloud's voxels at stride 4; BN eps 1e-5; not normalised.

``precision`` rounds the operands of every convolution and 1x1 product
with ``low`` (bf16 in the program); the control runs this same code below
the configuration's precision.
"""

from __future__ import annotations

import itertools

import torch

from bench_h100.reference.precision import FULL, Precision

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

STEP = 0.01
PLANES = (64, 128, 64, 32)
TOP_DOWN = 2
EPS = 1e-5
GEM_EPS = 1e-6
CLOUDS = 8  # submaps a block of ``embed``


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


def conv_odd(x, table, w, p: Precision = FULL):
    """x [M, Cin], table [M, K], w [K, Cin, Cout] -> [M, Cout]."""
    xp = torch.cat([p.low(x), torch.zeros_like(x[:1])])  # row -1: zeros
    w = p.low(w)
    out = 0
    for o in range(table.shape[1]):
        out = out + xp[table[:, o]] @ w[o]
    return out


def conv_down(x, parent, slot, rows, w, p: Precision = FULL):
    """From stride s (x [M_s, Cin]) to the ``rows`` voxels at 2s."""
    x, w = p.low(x), p.low(w)
    out = torch.zeros((rows, w.shape[2]), dtype=x.dtype, device=x.device)
    for o in range(8):
        sel = slot == o
        out = out.index_add(0, parent[sel], x[sel] @ w[o])
    return out


def conv_up(x, parent, slot, w, p: Precision = FULL):
    """From stride 2s (x) back to the voxels at s."""
    x, w = p.low(x), p.low(w)
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


def dense(x, weight, p: Precision = FULL):
    """A 1x1 conv: x [M, Cin], weight [Cout, Cin]."""
    return p.low(x) @ p.low(weight).t()


def block(x, w, key, table, cloud, counts, train, stats, p: Precision = FULL):
    out = torch.relu(batch_norm(conv_odd(x, table, w[key + ".conv1.offset_weight"], p), w,
                                key + ".norm1", train, stats))
    out = batch_norm(conv_odd(out, table, w[key + ".conv2.offset_weight"], p), w,
                     key + ".norm2", train, stats)
    out = eca(out, w, key + ".eca", cloud, counts)
    if key + ".downsample.weight" in w:
        x = batch_norm(dense(x, w[key + ".downsample.weight"], p), w, key + ".downsample_bn",
                       train, stats)
    return torch.relu(out + x)


def forward(w: dict, points: torch.Tensor, train: bool = False,
            stats: dict | None = None, p: Precision = FULL) -> torch.Tensor:
    """Descriptors [B, 256] of submaps [B, N, 3]."""
    vox = Voxels(points)
    dt = w["conv0.offset_weight"].dtype
    f = torch.ones((vox.v[1].shape[0], 1), dtype=dt, device=points.device)
    f = torch.relu(batch_norm(conv_odd(f, odd_table(vox.v[1], 1, 5), w["conv0.offset_weight"], p),
                              w, "bn0", train, stats))
    lateral = []
    for i in range(len(PLANES)):
        s = 2 ** i
        f = conv_down(f, vox.parent[s], vox.slot[s], vox.v[2 * s].shape[0],
                      w[f"down_{i}.offset_weight"], p)
        f = torch.relu(batch_norm(f, w, f"down_bn_{i}", train, stats))
        cloud, counts = vox.cloud_counts(2 * s)
        f = block(f, w, f"block_{i}", odd_table(vox.v[2 * s], 2 * s, 3), cloud, counts,
                  train, stats, p)
        if len(PLANES) - 1 - TOP_DOWN <= i < len(PLANES) - 1:
            lateral.append(f)
    f = dense(f, w["conv1x1_0.weight"], p)
    s = 2 ** len(PLANES)
    for j in range(TOP_DOWN):
        s //= 2
        f = (conv_up(f, vox.parent[s], vox.slot[s], w[f"tconv_{j}.offset_weight"], p)
             + dense(lateral[-1 - j], w[f"conv1x1_{j + 1}.weight"], p))
    cloud, counts = vox.cloud_counts(s)
    gem_p = w["gem.p"]
    return cloud_mean(f.clamp(min=GEM_EPS).pow(gem_p), cloud, counts).pow(1.0 / gem_p)


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


@torch.no_grad()
def embed(w: dict, model: dict, points, device, p: Precision = FULL) -> torch.Tensor:
    """Eval-mode descriptors of ``points`` [B, N, 3] (numpy or tensor), a
    block of ``CLOUDS`` at a time; fp32 on ``device``."""
    x = torch.as_tensor(points, dtype=torch.float32, device=device)
    return torch.cat([forward(w, x[s:s + CLOUDS], p=p) for s in range(0, x.shape[0], CLOUDS)])
