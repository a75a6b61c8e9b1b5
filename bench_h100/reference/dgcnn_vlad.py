"""DGCNN-VLAD, plainly, in fp32 [DGCNN: Wang et al., ACM TOG 2019,
arXiv:1801.07829, the authors' ``pytorch/model.py`` class ``DGCNN``, k = 20;
the head: PointNetVLAD's NetVLAD, Uy & Lee, CVPR 2018, arXiv:1804.03492;
the port's ``models/dgcnn.py`` is the system under test, not a source here].

[B, N, 3] submap -> four EdgeConv layers, each on a kNN graph built again
over its own input (layer 0 on xyz, layers 1-3 on the previous layer's
output; the point itself included) -> the concat of the four outputs (512)
-> conv5 (512 -> 1024 without bias, BN, LeakyReLU) -> NetVLAD (softmax
assignment, residual sums, intra-norm and L2 norm, one 65,536 -> 256 FC,
context gating, L2 norm) -> [B, 256].

EdgeConv i: e_ij = [x_j - x_i, x_i]; h_ij = LeakyReLU(BN(W_i e_ij)), no
bias; x'_i = the max over j of h_ij. BN over every edge (B·N·k rows) with
the configuration's ``bn_epsilon`` (1e-5), the slope its ``leaky_slope``
(0.2). The edges are materialised and reduced with a max, as published.

Departures from the authors' code (the port's too):

- layer 0's graph ranks by the squared distance summed coordinate by
  coordinate (``model_any_n.knn_ids``); layers 1-3 by ``||x_j||^2 - 2 <x_i,
  x_j>``; the authors rank every layer by ``-||x_i||^2 + 2 <x_i, x_j> -
  ||x_j||^2``, the same order in exact arithmetic;
- ties go to the lower index (a stable full sort); ``topk`` promises none;
- BN in training records the batch's mean and biased variance; eval uses
  the running statistics;
- DGCNN's classification head is replaced by NetVLAD on conv5's per-point
  features, as the port's ``GVLADHead`` with one group has it (the
  assignment, the FC and the gate each a Dense with a bias and no BN;
  PointNetVLAD's code puts BN after each): ``model.gvlad`` on the
  ``netvlad.*`` leaves.

``weights`` is a dict of fp32 tensors keyed as
``bench_h100/weights_dgcnn_vlad.py`` makes them. ``precision`` rounds the
operands of each product (``precision.py``): the features the kNN of
layers 1-3 ranks by and the edges and weights of every Dense with ``low``,
the head's with ``wide``; the control runs this same code below the
configuration's precision.
"""

from __future__ import annotations

import torch

from bench_h100.reference.model import batch_norm, gvlad
from bench_h100.reference.model_any_n import knn_ids
from bench_h100.reference.precision import FULL, Precision

# rows of a score matrix sorted at a time, and clouds embedded at a time,
# so that the reference fits beside anything on the card
ROWS = 512
CLOUDS = 8


def feature_knn_ids(f: torch.Tensor, k: int) -> torch.Tensor:
    """[B, N, D] -> [B, N, k] int64: each point's k nearest by
    ``||f_j||^2 - 2 <f_i, f_j>``, nearest first, ties to the lower index."""
    nrm = (f * f).sum(-1)[:, None, :]
    out = []
    for r0 in range(0, f.shape[1], ROWS):
        s = nrm - 2 * (f[:, r0:r0 + ROWS] @ f.transpose(1, 2))
        out.append(torch.sort(s, dim=-1, stable=True).indices[..., :k].clone())
        del s
    return torch.cat(out, dim=1)


def leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def edge_conv(fl: torch.Tensor, ids: torch.Tensor, w: dict, key: str, model: dict,
              train: bool, stats: dict | None, p: Precision) -> torch.Tensor:
    """Features [B, N, C] (rounded as the product takes them), ids
    [B, N, k] -> [B, N, C_out]."""
    b, n, c = fl.shape
    k = ids.shape[-1]
    nbr = torch.gather(fl, 1, ids.reshape(b, n * k, 1).expand(-1, -1, c)).reshape(b, n, k, c)
    ctr = fl[:, :, None, :].expand(b, n, k, c)
    e = torch.cat([nbr - ctr, ctr], dim=-1)
    h = p.low(e) @ p.low(w[key + ".dense.weight"]).t()
    h = batch_norm(h, w, key + ".bn", train, stats, model["bn_epsilon"])
    return leaky(h, model["leaky_slope"]).amax(dim=2)


def forward_with_graphs(w: dict, model: dict, x: torch.Tensor, train: bool = False,
                        stats: dict | None = None, p: Precision = FULL):
    """(descriptors [B, output_dim], each layer's graph [B, N, k]) of
    submaps ``x`` [B, N, 3]."""
    x, k = x.float(), model["knn_k"]
    f, graphs, outs = x, [], []
    for i in range(len(model["proxyconv_channels"])):
        fl = p.low(f)
        with torch.no_grad():
            ids = knn_ids(x, k) if i == 0 else feature_knn_ids(fl, k)
        graphs.append(ids)
        f = edge_conv(fl, ids, w, f"edgeconv_{i}", model, train, stats, p)
        outs.append(f)
    f = torch.cat(outs, dim=-1)
    for j in range(len(model["lift_channels"])):
        f = p.low(f) @ p.low(w[f"lift.dense_{j}.weight"]).t()
        f = leaky(batch_norm(f, w, f"lift.bn_{j}", train, stats, model["bn_epsilon"]),
                  model["leaky_slope"])
    head = {"gvlad." + key[len("netvlad."):]: v for key, v in w.items()
            if key.startswith("netvlad.")}
    return gvlad(f, head, model, p), graphs


def forward(w: dict, model: dict, x: torch.Tensor, train: bool = False,
            stats: dict | None = None, p: Precision = FULL) -> torch.Tensor:
    """Descriptors [B, output_dim] of submaps ``x`` [B, N, 3]."""
    return forward_with_graphs(w, model, x, train, stats, p)[0]


@torch.no_grad()
def embed(w: dict, model: dict, points, device, p: Precision = FULL) -> torch.Tensor:
    """Eval-mode descriptors of ``points`` [B, N, 3] (numpy or tensor), a
    block of ``CLOUDS`` at a time; fp32 on ``device``."""
    x = torch.as_tensor(points, dtype=torch.float32, device=device)
    return torch.cat([forward(w, model, x[s:s + CLOUDS], p=p)
                      for s in range(0, x.shape[0], CLOUDS)])
