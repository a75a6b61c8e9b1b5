"""The port's multi-device layer. Only ``PreemptionGuard`` so far; the
meshes and data-parallel training are ROADMAP item 6, Multi-device."""

from epcnet_torch.parallel.multislice import PreemptionGuard

__all__ = ["PreemptionGuard"]
