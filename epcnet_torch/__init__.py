"""epcnet_torch — the PyTorch / CUDA port of ``epcnet_tpu`` for NVIDIA Hopper.

Same contract as the JAX package: a [B, N, 3] submap in, a 256-D
L2-normalised descriptor out (kNN on xyz once -> ProxyConv stack ->
multi-scale concat -> lift -> G-VLAD), plus the serving index around it.

Layout mirrors ``epcnet_tpu/`` module for module. Every kernel the JAX
package wrote in Pallas is a hand-written CUDA kernel here (``csrc/``), with
a plain PyTorch twin in the same module: a CPU tensor takes the twin, a CUDA
tensor takes the kernel. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; without a card they raise instead of carrying on on
the CPU.

This package imports ``torch`` and numpy only — never ``jax`` or any module
of ``epcnet_tpu``.
"""

from epcnet_torch.configs import (
    DataConfig,
    EvalConfig,
    ExperimentConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
)

__version__ = "0.1.0"

__all__ = [
    "ModelConfig",
    "TrainConfig",
    "DataConfig",
    "MeshConfig",
    "EvalConfig",
    "ExperimentConfig",
    "__version__",
]
