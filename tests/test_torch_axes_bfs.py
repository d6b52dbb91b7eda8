"""The port's BFS over a hierarchical mesh against the JAX package's: on
``SimMesh((2, 4), ("pod", "data"))`` with ``axes=("pod", "data")`` the
port equals the reference on ``mesh24`` bit for bit (distances, levels,
edges examined and the flight recorder's rows) under all six syncs at
fanouts 2 and 4, on Kronecker scale 10 (direction-optimizing) and a 20 x
20 torus (top-down), and every rank's bytes equal the byte model over the
axes' sizes.  The answers equal the one-axis run's; only all-to-all's
bytes differ from it (``sum(a - 1)`` buffers, not ``P - 1``)."""

import numpy as np
import pytest
import torch

from repro.core import bfs as ref_bfs
from repro.core import flightrec as ref_fl
from repro.graph import generators as ref_gen
from repro.graph import partition as ref_part
from repro_torch.core import bfs, butterfly, collectives, flightrec
from repro_torch.dist.sharding import SimMesh
from repro_torch.graph import partition

MESH24 = SimMesh((2, 4), ("pod", "data"))
AXES = ("pod", "data")
GRAPHS = {
    "kron10": (lambda gen: gen.kronecker(10, 8, seed=1), "direction_optimizing"),
    "torus": (lambda gen: gen.torus_2d(20), "top_down"),
}
ROOT = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def partitions():
    out = {}
    for name, (make, _) in GRAPHS.items():
        rpg = ref_part.partition_1d(make(ref_gen), 8)
        out[name] = (rpg, partition.from_reference(
            {k: getattr(rpg, k) for k in partition.SCALARS}, rpg.arrays()))
    return out


@pytest.mark.parametrize("fanout", [2, 4])
@pytest.mark.parametrize("sync", bfs.SYNCS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bfs_over_pod_data_matches_reference(mesh24, partitions, name, sync, fanout):
    rpg, tpg = partitions[name]
    mode = GRAPHS[name][1]
    want = ref_fl.traced_bfs(rpg, mesh24, ROOT, ref_bfs.BFSConfig(
        axes=AXES, sync=sync, fanout=fanout, mode=mode))
    cfg = bfs.BFSConfig(axes=AXES, sync=sync, fanout=fanout, mode=mode)
    comm = collectives.Communicator(MESH24, "cpu")
    dist, levels, scanned, trace = flightrec.traced_bfs(
        tpg, ROOT, cfg, comm=comm, device="cpu", mesh=MESH24)
    np.testing.assert_array_equal(dist, want[0])
    assert (levels, scanned) == (want[1], want[2])
    np.testing.assert_array_equal(trace.data, want[3].data)
    # bytes: the model over the axes' sizes, on every rank
    rec = flightrec.reconcile_bytes(trace, comm.bytes_sent)
    assert rec["matches"], rec
    # the one-axis run gives the same answers
    one = bfs.distributed_bfs(tpg, ROOT, bfs.BFSConfig(sync=sync, fanout=fanout, mode=mode),
                              device="cpu")
    np.testing.assert_array_equal(dist, one[0])
    assert (levels, scanned) == one[1:]
    if sync == "all_to_all":
        nb = tpg.n_words * 4
        assert trace._dense_bytes_per_node() == 4 * nb  # (2 - 1) + (4 - 1), not 7
        assert comm.bytes_sent[0] == levels * 4 * nb


@pytest.mark.parametrize("sync", ["butterfly", "adaptive", "xla"])
def test_bfs_kernel_path_over_axes(partitions, sync):
    """``use_kernels=True`` (the kernels' plain versions on CPU tensors)
    over the axes equals the plain path, bytes and all."""
    _, tpg = partitions["kron10"]
    out = []
    for use_kernels in (False, True):
        cfg = bfs.BFSConfig(axes=AXES, sync=sync, fanout=4, mode="direction_optimizing",
                            use_kernels=use_kernels)
        comm = collectives.Communicator(MESH24, "cpu")
        out.append(flightrec.traced_bfs(tpg, ROOT, cfg, comm=comm, device="cpu",
                                        mesh=MESH24) + (comm.bytes_sent.tolist(),))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1:3] == out[1][1:3] and out[0][4] == out[1][4]
    np.testing.assert_array_equal(out[0][3].data, out[1][3].data)


def test_bfs_data_first_axes_order(partitions):
    """``axes=("data", "pod")`` runs the data rounds first: the answers
    are the same; the butterfly's bytes add up the same digits."""
    _, tpg = partitions["torus"]
    a = bfs.BFSConfig(axes=("data", "pod"), sync="sparse", fanout=2)
    comm = collectives.Communicator(MESH24, "cpu")
    dist, levels, scanned, trace = flightrec.traced_bfs(tpg, ROOT, a, comm=comm,
                                                        device="cpu", mesh=MESH24)
    one = bfs.distributed_bfs(tpg, ROOT, bfs.BFSConfig(sync="sparse", fanout=2), device="cpu")
    np.testing.assert_array_equal(dist, one[0])
    assert (levels, scanned) == one[1:]
    assert trace.axis_sizes == (4, 2)
    assert flightrec.reconcile_bytes(trace, comm.bytes_sent)["matches"]
    assert butterfly.axes_digit_plan((4, 2), 2) == [2, 2, 2]


@pytest.mark.parametrize("bad", [
    dict(axes=("pod", "data"), mesh=None),  # no pod axis on the default mesh
    dict(axes=("model",), mesh=MESH24),  # an axis the mesh lacks
    dict(axes=("data",), mesh=MESH24),  # 4 ranks for 8 partitions
    dict(axes=("pod", "pod"), mesh=MESH24),  # an axis twice
    dict(axes=("pod", "data"), mesh=SimMesh((4, 4), ("pod", "data"))),  # 16 != 8
])
def test_config_guard(partitions, bad):
    """The build refuses axes the mesh lacks and axes whose sizes do not
    multiply to P, as the reference's ``P(axes)`` cannot place them."""
    _, tpg = partitions["torus"]
    with pytest.raises(ValueError):
        bfs.build_bfs_fn(tpg, bfs.BFSConfig(axes=bad["axes"]), device="cpu", mesh=bad["mesh"])
    with pytest.raises(ValueError):
        bfs.resolve_mesh(tpg.p, bad["axes"], bad["mesh"])


def test_comm_on_another_mesh_refused(partitions):
    _, tpg = partitions["torus"]
    fn = bfs.build_bfs_fn(tpg, bfs.BFSConfig(axes=AXES), device="cpu", mesh=MESH24)
    arrays = bfs.place_arrays(tpg, device="cpu")
    with pytest.raises(ValueError):
        fn(arrays, ROOT, collectives.Communicator(8, "cpu"))
    fn(arrays, ROOT, collectives.Communicator(MESH24, "cpu"))
