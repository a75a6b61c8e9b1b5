"""Eval-mode BN and its activation in one pass (``ops/bn_act.py``, K9's
plain version and the models' use of it) on the CPU.

Every comparison is ``torch.equal``: the one-pass path must give the bits of
the chain it replaces, ``activation(DynamicBatchNorm(x))`` in eval, so that
no descriptor moves. K9 itself is held to ``bn_act_plain`` on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from epcnet_torch.configs import (
    ModelConfig,
    dgcnn_vlad_config,
    epcnet_l_config,
    pointnetvlad_config,
)
from epcnet_torch.models import layers
from epcnet_torch.models.dgcnn import EdgeConv
from epcnet_torch.models.layers import DynamicBatchNorm
from epcnet_torch.ops.bn_act import activation, bn_act, bn_act_plain
from epcnet_torch.train.step import build_embed_fn
from epcnet_torch.weights import init_flat_variables


def _seed_bn(bn: DynamicBatchNorm, gen: torch.Generator) -> None:
    """Running statistics and affine parameters away from their identity
    start, so that each operation of the chain rounds."""
    c, dev = bn.mean.shape[0], bn.mean.device
    with torch.no_grad():
        bn.mean.copy_(torch.randn(c, device=dev, generator=gen) * 0.5)
        bn.var.copy_(torch.rand(c, device=dev, generator=gen) * 2 + 0.05)
        bn.scale.copy_(torch.randn(c, device=dev, generator=gen) * 0.4 + 1)
        bn.bias.copy_(torch.randn(c, device=dev, generator=gen) * 0.3)


def _chain(self, x, train=False, momentum=0.9, negative_slope=0.0):
    """``DynamicBatchNorm.forward_act`` as it was before the one pass."""
    return activation(self(x, train, momentum), negative_slope)


def _bn(c, eps, seed=0):
    bn = DynamicBatchNorm(c, eps)
    _seed_bn(bn, torch.Generator().manual_seed(seed))
    return bn


def _x(shape, dtype=torch.bfloat16, seed=1):
    return (torch.randn(shape, generator=torch.Generator().manual_seed(seed)) * 2).to(dtype)


def _spy(monkeypatch):
    """Counts the models' calls of the one-pass ``bn_act``."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return bn_act(*args, **kwargs)

    monkeypatch.setattr(layers, "bn_act", counted)
    return calls


@pytest.mark.parametrize("shape", [(300,), (2, 7, 5)], ids=["2d", "4d"])
@pytest.mark.parametrize("c", [16, 64, 1024])
@pytest.mark.parametrize("slope,eps", [(0.0, 1e-3), (0.2, 1e-5)], ids=["relu", "leaky"])
def test_bn_act_plain_is_the_eval_chain(slope, eps, c, shape):
    """``bn_act_plain``, ``bn_act`` on a CPU tensor and ``forward_act`` in
    eval give the bits of ``activation(bn(x))``; signed zeros, ties and
    negative values included."""
    bn = _bn(c, eps, seed=c)
    x = _x((*shape, c), seed=len(shape))
    x[..., 0] = bn.mean[0].to(torch.bfloat16)  # x - mean may be 0 in channel 0
    x[..., 1] = -0.0
    want = activation(bn(x, False), slope)
    assert want.dtype == torch.bfloat16 and bool((want < 0).any()) == bool(slope)
    args = (bn.mean, bn.var, bn.scale, bn.bias, eps, slope)
    assert torch.equal(bn_act_plain(x, *args), want)
    assert torch.equal(bn_act(x, *args), want)
    with torch.no_grad():
        assert torch.equal(bn.forward_act(x, False, 0.9, slope), want)


@pytest.mark.parametrize("case", ["eval", "train", "grad", "float32", "float64", "c12",
                                  "strided", "bf16_stats"])
def test_forward_act_takes_the_chain_otherwise(case, monkeypatch):
    """``forward_act`` takes the chain in train mode (which records its
    batch statistics), where a gradient flows, and on fp32 and fp64; in eval
    on bf16 it takes the one pass, which on the CPU is the chain's own
    arithmetic whatever C, the strides or the statistics' dtype (K9 raises
    on the card on what it does not take: ``tests/test_torch_cuda.py``)."""
    calls = _spy(monkeypatch)
    c = 12 if case == "c12" else 16
    bn = _bn(c, 1e-3, seed=3)
    dtype = {"float32": torch.float32, "float64": torch.float64}.get(case, torch.bfloat16)
    if case == "float64":
        bn.double()
    if case == "bf16_stats":
        bn.to(torch.bfloat16)
    x = _x((40, 2 * c) if case == "strided" else (40, c), dtype)
    if case == "strided":
        x = x[:, ::2]
    train, grad = case == "train", case in ("train", "grad")
    x.requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        got = bn.forward_act(x, train, 0.9, 0.2)
        want = activation(DynamicBatchNorm.forward(bn, x, train, 0.9), 0.2)
    assert torch.equal(got, want)
    assert len(calls) == (case in ("eval", "c12", "strided", "bf16_stats"))
    assert (bn.pending is not None) == train
    if grad:
        got.float().sum().backward()
        assert x.grad is not None and bn.scale.grad is not None


@pytest.mark.parametrize("name,bns", [("epcnet", 6), ("epcnet_l", 6), ("dgcnn_vlad", 5),
                                      ("pointnetvlad", 15)])
def test_eval_descriptors_bitwise_the_chains(name, bns, monkeypatch):
    """Each model's eval forward (``build_embed_fn``, inference mode) takes
    the one pass at every BN of its ``bns`` but those inside DGCNN-VLAD's
    EdgeConvs (which K10's eval path applies itself, ``ops/edge_max.py``),
    and its descriptors equal those of the same weights through the chain,
    bit for bit. For DGCNN-VLAD that holds conv5's BN alone: both runs take
    the EdgeConvs' eval path, which ``tests/test_torch_dgcnn.py::
    test_eval_algebra_is_the_published_edgeconv`` holds against the
    published edges and ``tests/test_torch_cuda.py::test_k10_matches_plain``
    holds K10 against on the card."""
    cfg = {"epcnet": ModelConfig, "epcnet_l": epcnet_l_config,
           "dgcnn_vlad": dgcnn_vlad_config, "pointnetvlad": pointnetvlad_config}[name](
        num_points=256)
    embed = build_embed_fn(cfg, device="cpu", variables=init_flat_variables(cfg, seed=2))
    gen = torch.Generator().manual_seed(7)
    for mod in embed.model.modules():
        if isinstance(mod, DynamicBatchNorm):
            _seed_bn(mod, gen)
    x = np.random.default_rng(3).uniform(-1, 1, (2, 256, 3)).astype(np.float32)
    calls = _spy(monkeypatch)
    got = embed(x)
    assert bns == sum(isinstance(m, DynamicBatchNorm) for m in embed.model.modules())
    assert len(calls) == bns - sum(isinstance(m, EdgeConv) for m in embed.model.modules())
    monkeypatch.setattr(DynamicBatchNorm, "forward_act", _chain)
    want = embed(x)
    assert got.shape == (2, cfg.output_dim) and bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
