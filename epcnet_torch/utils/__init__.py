"""Timing, profiling and logging helpers (counterpart of ``epcnet_tpu/utils``)."""

from epcnet_torch.utils.logging import log_string
from epcnet_torch.utils.profiling import (
    profile_region,
    region_ms,
    start_trace,
    top_device_ops,
)
from epcnet_torch.utils.timing import cuda_ms, device_sync, timeit, timeit_pipelined

__all__ = [
    "device_sync",
    "timeit",
    "timeit_pipelined",
    "cuda_ms",
    "profile_region",
    "start_trace",
    "top_device_ops",
    "region_ms",
    "log_string",
]
