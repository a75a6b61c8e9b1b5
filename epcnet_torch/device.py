"""The port's device rule, in one place.

Entry points (``get_model``, ``build_embed_fn``, ``PlaceIndex``) run on the
card unless the caller asks for the CPU. Without a card they raise: a
program meant for the H100 must never quietly carry on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raises ``RuntimeError`` without a card); an
    explicit ``"cpu"`` or ``"cuda[:i]"`` is honoured, and ``cuda`` without a
    card raises too."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: epcnet_torch runs on the card by default; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
