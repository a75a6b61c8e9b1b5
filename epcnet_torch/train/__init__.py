"""Train-side entry points of the port; only the embed step so far."""

from epcnet_torch.train.step import build_embed_fn

__all__ = ["build_embed_fn"]
