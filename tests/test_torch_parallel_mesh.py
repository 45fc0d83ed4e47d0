"""``arflow_tpu_torch.parallel`` on the CPU: ``initialize_multihost`` at
world size 1 (a no-op, as the JAX function is) and at 2 (two processes
over gloo), ``make_mesh``, ``make_hybrid_mesh`` (2 hosts x 1 card),
``shard_batch``, ``replicate`` and the autograd ``all_sum``; and the
rank-partitioned loader: over 2 epochs the union of the two ranks' rows
is the JAX loader's global batches, in order, without a duplicate."""

import numpy as np
import pytest
import torch

from arflow_tpu.data.loader import DataLoader as JaxDataLoader
from arflow_tpu.data.loader import InMemoryDataset as JaxInMemoryDataset
from arflow_tpu_torch.data.loader import DataLoader, InMemoryDataset
from arflow_tpu_torch.parallel import (
    batch_mean,
    data_parallel,
    initialize_multihost,
    local_device,
    make_hybrid_mesh,
    make_mesh,
    shard_batch,
)
from torch_ddp_util import loader_case, run_ranks
from torch_data_util import few_torch_threads  # noqa: F401  (fixture)


def test_one_process_is_a_no_op():
    assert not initialize_multihost()
    assert not initialize_multihost(None, 1, 0)
    assert not torch.distributed.is_initialized()
    mesh = make_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.group, mesh.shape) == (1, 0, None, (1,))
    hybrid = make_hybrid_mesh("cpu")
    assert hybrid.shape == (1, 1) and hybrid.axis_names == ("dcn", "data")
    batch = {"a": np.arange(6), "t": {"f": np.ones((6, 2))}}
    rows = shard_batch(mesh, batch)
    assert rows["a"].tolist() == list(range(6)) and rows["t"]["f"].shape == (6, 2)
    x = torch.rand(3, 4, dtype=torch.float64)
    with data_parallel(None):  # no group: exactly the local mean
        assert batch_mean(x).item() == x.mean().item()
    assert local_device(3, "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="coordinator"):
        initialize_multihost(None, 2, 0)


def test_two_ranks_mesh_shard_replicate_all_sum(tmp_path):
    out = run_ranks({}, tmp_path, world=2, entry="mesh_case")
    for r, o in enumerate(out):
        assert (o["rank"], o["size"]) == (r, 2)
        assert o["shape"] == (2, 1) and o["axes"] == ("dcn", "data")
        assert o["sub"] == {"data": 1, "dcn": 2}  # a host's card; the hosts
        np.testing.assert_array_equal(
            o["rows"]["x"], np.arange(24).reshape(8, 3)[4 * r:4 * r + 4])
        assert o["rows"]["s"] == 2.0
        # rank 0's weights everywhere
        torch.testing.assert_close(o["weight"], out[0]["weight"], rtol=0, atol=0)
        # sum over the ranks of x = (1 + r, 2): (3, 4); the gradient of
        # sum(y^2) summed over the ranks: 2 * 2 * y
        assert o["sum"].tolist() == [3.0, 4.0]
        assert o["grad"].tolist() == [12.0, 16.0]
        assert o["gathered"].flatten().tolist() == [0.0, 0.0, 1.0, 1.0]


@pytest.mark.parametrize("n,batch_size", [(26, 4), (23, 6)])
def test_rank_partitioned_loader_against_the_jax_batches(n, batch_size,
                                                         tmp_path):
    case = {"n": n, "batch_size": batch_size, "seed": 3, "epochs": 2}
    out = run_ranks(case, tmp_path, world=2, entry="loader_case")
    data = JaxInMemoryDataset([{"i": np.int64(i)} for i in range(n)])
    jax_loader = JaxDataLoader(data, batch_size=batch_size, shuffle=True,
                               drop_last=True, seed=3, num_workers=1)
    for e in range(2):
        jax_loader.set_epoch(e)
        jax_batches = [b["i"].tolist() for b in jax_loader]
        ours = [a + b for a, b in zip(out[0]["epochs"][e], out[1]["epochs"][e])]
        assert ours == jax_batches  # each rank its half, in order
        seen = [i for b in ours for i in b]
        assert len(seen) == len(set(seen)) == len(jax_batches) * batch_size
        assert [len(b) for b in out[0]["epochs"][e]] == [batch_size // 2] * len(ours)
    assert out[0]["len"] == out[1]["len"] == len(jax_loader)
    # one process: the JAX loader's batches themselves
    one = loader_case(case)
    jax_loader.set_epoch(1)
    assert one["epochs"][1] == [b["i"].tolist() for b in jax_loader]
    # validation: whole batches, round robin over the ranks
    valid = sorted(out[0]["valid"] + out[1]["valid"])
    assert [i for i, _ in out[1]["valid"]] == list(range(1, len(valid), 2))
    assert valid == list(enumerate(
        b["i"].tolist() for b in JaxDataLoader(data, batch_size=batch_size)))


def test_trimmed_and_dropped_batches():
    """An odd global batch is trimmed to a multiple of the ranks, as the
    JAX trainer's ``_trim_batch`` trims it; a shorter one is dropped."""
    data = InMemoryDataset([{"i": np.int64(i)} for i in range(7)])
    rows = [[b["i"].tolist() for b in DataLoader(data, batch_size=3,
                                                 num_replicas=2, rank=r)]
            for r in (0, 1)]
    assert rows == [[[0], [3]], [[1], [4]]]  # [6] alone trims to none
    with pytest.raises(ValueError, match="partition"):
        DataLoader(data, partition="samples")
