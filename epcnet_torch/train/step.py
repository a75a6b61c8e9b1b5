"""The embed step (twin of ``build_embed_fn`` in ``epcnet_tpu/train/step.py``).

Training steps are not ported yet (ROADMAP item 4).
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch

from epcnet_torch.configs import ModelConfig
from epcnet_torch.device import resolve_device
from epcnet_torch.models import get_model
from epcnet_torch.weights import init_flat_variables, load_flat_variables


def build_embed_fn(
    model_cfg: ModelConfig,
    device: str | torch.device | None = None,
    variables: Mapping[str, np.ndarray] | None = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Returns ``embed(points[B, N, 3]) -> [B, output_dim]`` in inference mode
    (running BN stats), on ``device`` (the card unless ``"cpu"``).

    Weights come from ``variables`` (a ``flatten_variables`` dict, e.g. from
    ``weights.load_export``) or, when it is None, from
    ``init_flat_variables(model_cfg, seed=0)``. ``points`` may be a numpy array
    or a tensor; it is moved to the model's device. The returned function
    carries the model as ``embed.model`` and its device as ``embed.device``.
    """
    dev = resolve_device(device)
    model = get_model(model_cfg, dev)
    load_flat_variables(
        model, variables if variables is not None else init_flat_variables(model_cfg, seed=0)
    )

    def embed(points) -> torch.Tensor:
        with torch.inference_mode():
            return model(torch.as_tensor(points, dtype=torch.float32, device=dev))

    embed.model = model
    embed.device = dev
    return embed
