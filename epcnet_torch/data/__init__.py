"""The data plane of the port (twin of ``epcnet_tpu/data``): ``.bin``
submap IO and augmentation, the native batch loader, training-tuple and
test-set generation, the synthetic dataset, and the training tuple loader
(``TupleLoader``, ``get_query_tuple``)."""

from epcnet_torch.data.loader import TupleLoader, get_query_tuple
from epcnet_torch.data.native_loader import load_pc_files_native, native_available
from epcnet_torch.data.pointclouds import (
    jitter_point_cloud,
    load_pc_file,
    load_pc_files,
    rotate_point_cloud,
)
from epcnet_torch.data.synthetic import generate_synthetic_dataset
from epcnet_torch.data.tuples import (
    OXFORD_TEST_REGIONS,
    TrainingTuples,
    any_in_test_regions,
    construct_query_and_database_sets,
    construct_query_dict,
    in_test_region,
    load_pickle,
    save_pickle,
    scan_runs,
)

__all__ = [
    "load_pc_file",
    "load_pc_files",
    "rotate_point_cloud",
    "jitter_point_cloud",
    "load_pc_files_native",
    "native_available",
    "OXFORD_TEST_REGIONS",
    "TrainingTuples",
    "in_test_region",
    "any_in_test_regions",
    "scan_runs",
    "construct_query_dict",
    "construct_query_and_database_sets",
    "save_pickle",
    "load_pickle",
    "generate_synthetic_dataset",
    "TupleLoader",
    "get_query_tuple",
]
