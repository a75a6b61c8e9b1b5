"""The port's meshes and process-group bootstrap against the JAX package's
(``tests/test_multidevice.py::test_make_mesh_shapes`` and
``tests/test_multislice.py``, ported).

Devices are compared by position: the port's mesh holds ``torch.device``s
(here ``cpu:i``, one per JAX CPU device ``i`` of the 8-device platform),
and each must sit where JAX's mesh puts device ``i``.
"""

import jax
import numpy as np
import pytest
import torch

from epcnet_tpu.configs import MeshConfig as JMeshConfig
from epcnet_tpu.parallel import make_mesh as j_make_mesh
from epcnet_tpu.parallel import make_multislice_mesh as j_make_multislice_mesh
from epcnet_tpu.parallel import retrieval_db_axis as j_retrieval_db_axis

from epcnet_torch.configs import MeshConfig
from epcnet_torch.parallel import (
    Mesh,
    ProcessMesh,
    data_block,
    make_mesh,
    make_multislice_mesh,
    maybe_initialize_distributed,
    retrieval_db_axis,
    slice_groups,
)
from epcnet_torch.parallel import collectives

DEVICES = [torch.device("cpu", i) for i in range(8)]
ENV = ("EPCNET_COORDINATOR_ADDRESS", "EPCNET_NUM_PROCESSES", "EPCNET_PROCESS_ID",
       "EPCNET_DISTRIBUTED")


def _layout(mesh) -> list:
    """Device positions of a mesh: JAX ids, or the port's cpu indices."""
    if isinstance(mesh, Mesh):
        return [[d.index for d in row] for row in mesh.grid]
    return [[d.id for d in row] for row in mesh.devices]


@pytest.mark.parametrize("data,db", [(-1, 2), (-1, 1), (2, 4), (8, 1), (-1, 8)])
def test_make_mesh_layout_matches_jax(data, db):
    got = make_mesh(MeshConfig(data_axis=data, db_axis=db), DEVICES)
    want = j_make_mesh(JMeshConfig(data_axis=data, db_axis=db))
    assert got.shape == dict(want.shape)
    assert _layout(got) == _layout(want)
    assert got.devices("db") == list(got.grid[0]) and got.devices("data") == list(got.grid[:, 0])


def test_make_mesh_errors_and_repeated_devices():
    with pytest.raises(ValueError, match="mesh 3x3 != 8"):
        make_mesh(MeshConfig(data_axis=3, db_axis=3), DEVICES)
    with pytest.raises(ValueError):
        j_make_mesh(JMeshConfig(data_axis=3, db_axis=3))
    m = make_mesh(MeshConfig(data_axis=1, db_axis=2), ["cpu", "cpu"])  # one device twice
    assert m.shape == {"data": 1, "db": 2} and m.devices("db") == [torch.device("cpu")] * 2
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(devices=["cuda:0"])


@pytest.mark.parametrize("db", [1, 2, 4])
@pytest.mark.parametrize("slices", ["parity", "halves"])
def test_multislice_mesh_matches_jax(slices, db):
    fn = {"parity": lambda i: i % 2, "halves": lambda i: i // 4}[slices]
    got = make_multislice_mesh(MeshConfig(data_axis=-1, db_axis=db), DEVICES,
                               slice_index_fn=lambda d: fn(d.index))
    want = j_make_multislice_mesh(JMeshConfig(data_axis=-1, db_axis=db),
                                  slice_index_fn=lambda d: fn(d.id))
    assert _layout(got) == _layout(want)
    for row in got.grid:  # the db axis stays inside a slice
        assert len({fn(d.index) for d in row}) == 1


def test_multislice_errors_and_single_slice():
    with pytest.raises(ValueError, match="unequal"):
        make_multislice_mesh(MeshConfig(), DEVICES,
                             slice_index_fn=lambda d: 0 if d.index < 3 else 1)
    with pytest.raises(ValueError, match="does not divide"):
        make_multislice_mesh(MeshConfig(db_axis=3), DEVICES, slice_index_fn=lambda d: d.index % 2)
    one = make_multislice_mesh(MeshConfig(), DEVICES)  # one host: make_mesh's mesh
    assert _layout(one) == _layout(make_mesh(MeshConfig(), DEVICES))
    assert [len(g) for g in slice_groups(DEVICES, lambda d: d.index % 2)] == [4, 4]


def test_retrieval_db_axis_matches_jax():
    fn = lambda i: i // 4  # noqa: E731
    assert retrieval_db_axis(DEVICES, lambda d: fn(d.index)) == \
        j_retrieval_db_axis(slice_index_fn=lambda d: fn(d.id)) == 4
    assert retrieval_db_axis(DEVICES) == j_retrieval_db_axis() == 8
    mesh = make_multislice_mesh(MeshConfig(data_axis=-1, db_axis=4), DEVICES,
                                slice_index_fn=lambda d: fn(d.index))
    assert mesh.shape == {"data": 2, "db": 4}


def test_maybe_initialize_distributed_is_noop(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    assert maybe_initialize_distributed(device="cpu") is False
    monkeypatch.setenv("EPCNET_NUM_PROCESSES", "1")
    assert maybe_initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_maybe_initialize_distributed_dispatch(monkeypatch):
    """The EPCNET_* variables route into ``init_process_group``: gloo on the
    CPU, an address without a scheme as tcp://, EPCNET_DISTRIBUTED=1 alone
    as torch's env:// defaults."""
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("EPCNET_DISTRIBUTED", "1")
    assert maybe_initialize_distributed(device="cpu") is True
    assert calls[-1][0] == ("gloo",) and set(calls[-1][1]) == {"timeout"}
    monkeypatch.setenv("EPCNET_COORDINATOR_ADDRESS", "10.0.0.1:8476")
    monkeypatch.setenv("EPCNET_NUM_PROCESSES", "4")
    monkeypatch.setenv("EPCNET_PROCESS_ID", "2")
    assert maybe_initialize_distributed(device="cpu") is True
    kw = calls[-1][1]
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == ("tcp://10.0.0.1:8476", 4, 2)
    assert maybe_initialize_distributed("file:///tmp/store", 2, 1, device="cpu") is True
    assert calls[-1][1]["init_method"] == "file:///tmp/store"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        maybe_initialize_distributed()  # the card by default: none here


def test_world_of_one():
    """No process group: a 1 x 1 process mesh, and every collective the
    identity."""
    pm = ProcessMesh()
    assert pm.shape == {"data": 1, "db": 1} and pm.group("data") is None and pm.primary
    with pytest.raises(ValueError, match="mesh 1x2 != 1"):
        ProcessMesh(MeshConfig(data_axis=1, db_axis=2))
    x = torch.arange(6.0).reshape(3, 2)
    assert collectives.all_reduce_sum(x, None) is x
    assert collectives.all_gather(x, None).shape == (1, 3, 2)
    assert collectives.ring_shift(x, None) is x
    assert collectives.group_size(None) == 1 and collectives.group_rank(None) == 0


def test_data_block_is_jax_block_split():
    x = np.arange(24).reshape(8, 3)
    mesh = j_make_mesh(JMeshConfig(data_axis=4, db_axis=2))
    from jax.sharding import NamedSharding, PartitionSpec as P

    arr = jax.device_put(x, NamedSharding(mesh, P("data", None)))
    shards = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
    for r in range(4):  # data row r of the mesh holds block r
        np.testing.assert_array_equal(data_block(x, r, 4), shards[mesh.devices[r, 0].id])
    with pytest.raises(ValueError, match="does not split"):
        data_block(x, 0, 3)
