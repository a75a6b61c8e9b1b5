"""Evaluation of the port: batch embedding, retrieval, recall@N, the
retrieval latency probe (twin of ``epcnet_tpu/evals``)."""

from epcnet_torch.evals.recall import (
    embed_entries,
    evaluate_dataset,
    evaluate_region,
    get_recall,
    retrieval_latency_probe,
)

__all__ = [
    "embed_entries",
    "get_recall",
    "evaluate_region",
    "evaluate_dataset",
    "retrieval_latency_probe",
]
