"""The multi-slice mesh (singa_tpu_torch.distributed.global_mesh(
dcn_mesh_shape=), counterpart of singa_tpu/distributed.py:100-157) over
4 gloo ranks standing for 2 hosts: torchrun's GROUP_RANK 0, 0, 1, 1
(each host's ranks contiguous) and 1, 0, 1, 0 (interleaved), one spawn
each (`helper_torch_parity._rank_multislice`).

- The hybrid layout of `global_mesh(axis_names=("data",),
  dcn_mesh_shape=(2,))` and of `global_mesh((1, 2), ("data", "model"),
  dcn_mesh_shape=(2, 1))` equals the reference's
  `create_hybrid_device_mesh` over stand-in devices, one a rank, whose
  `slice_index` is the rank's host (hosts numbered in the port's order:
  by their lowest rank; the stand-ins pass through jax's code, which
  lays out non-TPU devices by reshape). The mesh's axis groups are that
  layout's lines; a group orders its members by rank, so where the
  layout orders a line otherwise (the interleaved hosts' data axis,
  [0, 2, 1, 3]) the mesh keeps its members in rank order.
- The reference's ValueErrors are raised with its wording, and more
  slices than hosts raises.
- One DistOpt step over the data axis of the hybrid (data, model) mesh,
  each rank on rows of its own, equals the step over the data axis of
  the flat 2 x 2 mesh (`get_mesh`) whose data groups are the same, and
  a plain SGD step on the rows of the data group's ranks; the two data
  groups' parameters differ, so a mesh whose data groups were another
  layout's lines would not pass.
"""

import numpy as np
import pytest

from helper_torch_parity import (MULTISLICE_MESHES, MULTISLICE_REFUSALS,
                                 _rank_multislice, run_ranks)

jax = pytest.importorskip("jax")
from jax.experimental import mesh_utils  # noqa: E402

WORLD = 4
HOSTS = {"contiguous": (0, 0, 1, 1), "interleaved": (1, 0, 1, 0)}
#: the flat 2 x 2 mesh's axis names whose data groups are those of the
#: hybrid (data, model) mesh: the hosts are the model groups
#: ({0, 1}, {2, 3} contiguous; {0, 2}, {1, 3} interleaved)
FLAT_NAMES = {"contiguous": ("data", "model"),
              "interleaved": ("model", "data")}


class StandIn:
    """A device for `create_hybrid_device_mesh`: a rank and its slice."""

    platform = device_kind = "cpu"

    def __init__(self, rank, slice_index):
        self.id, self.slice_index = rank, slice_index


def reference_layout(group_ranks, shape, dcn):
    order = list(dict.fromkeys(group_ranks))  # hosts by their lowest rank
    devs = [StandIn(r, order.index(g)) for r, g in enumerate(group_ranks)]
    arr = mesh_utils.create_hybrid_device_mesh(tuple(shape), tuple(dcn),
                                               devices=devs)
    return np.vectorize(lambda d: d.id)(arr)


def data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((8, 12)).astype(np.float32),
            rng.integers(0, 3, 8).astype(np.int32))


@pytest.fixture(scope="module", params=list(HOSTS))
def spawn(request, tmp_path_factory):
    hosts = HOSTS[request.param]
    X, y = data()
    return hosts, run_ranks(_rank_multislice, WORLD,
                            tmp_path_factory.mktemp(request.param),
                            group_ranks=hosts,
                            flat_names=FLAT_NAMES[request.param], X=X, y=y,
                            lr=0.1)


@pytest.mark.parametrize("key", list(MULTISLICE_MESHES))
def test_layout_equals_the_reference_hybrid_mesh(spawn, key):
    hosts, ranks = spawn
    shape, names, dcn = MULTISLICE_MESHES[key]
    want = reference_layout(hosts, shape or (WORLD // 2,), dcn)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[key]["layout"], want)
        assert got["slices"] == ranks[0]["slices"]
        mesh = got[key]
        assert mesh["dims"] == want.shape
        lines = {a: sorted(sorted(v.tolist()) for v in
                           np.moveaxis(want, a, -1).reshape(-1,
                                                            want.shape[a]))
                 for a in range(want.ndim)}
        for a, name in enumerate(names):
            # this rank's group along the axis is its line of the layout,
            # in rank order, and its index there is its place in it
            members = mesh["members"][name]
            assert members in lines[a] and r in members
            assert mesh["index"][name] == members.index(r)
        laid = np.asarray(mesh["ranks"]).reshape(mesh["dims"])
        if all((np.diff(want, axis=a) >= 0).all() for a in range(want.ndim)):
            np.testing.assert_array_equal(laid, want)


def test_interleaved_hosts_keep_their_lines():
    """The interleaved hosts' hybrid layouts, as the reference lays them
    out: the 1-D data axis [0, 2, 1, 3] (one line, all four ranks), the
    (data, model) mesh [[0, 2], [1, 3]] (model groups are the hosts)."""
    hosts = HOSTS["interleaved"]
    np.testing.assert_array_equal(reference_layout(hosts, (2,), (2,)),
                                  [0, 2, 1, 3])
    np.testing.assert_array_equal(reference_layout(hosts, (1, 2), (2, 1)),
                                  [[0, 2], [1, 3]])


def test_refusals_raise_the_reference_errors(spawn):
    _, ranks = spawn
    errors = ranks[0]["errors"]
    assert set(errors) == set(MULTISLICE_REFUSALS)
    assert "must have one entry per mesh axis" in errors["axes"]
    assert "4 devices do not split into prod(dcn_mesh_shape)=3 slices" in \
        errors["split"]
    assert "per-slice shape (2,) does not match axis names" in \
        errors["shape"]
    assert "the slices hold [2, 2]" in errors["hosts"]
    assert all(r["errors"] == errors for r in ranks)


def test_distopt_step_over_the_hybrid_data_axis_equals_the_flat_mesh(spawn):
    hosts, ranks = spawn
    want = reference_layout(hosts, (1, 2), (2, 1))
    groups = [sorted(want[:, c].tolist()) for c in range(want.shape[1])]
    for r, got in enumerate(ranks):
        assert got["data_group"] in groups and r in got["data_group"]
        for k, v in got["hybrid"].items():
            assert np.isfinite(v).all(), k
            np.testing.assert_allclose(v, got["flat"][k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)
            np.testing.assert_allclose(v, got["group"][k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    # the data groups stepped on different rows, so their steps differ
    a, b = (ranks[g[0]]["hybrid"] for g in groups)
    assert any(not np.allclose(a[k], b[k], rtol=1e-4) for k in a)


def test_one_slice_at_world_one_is_the_global_mesh():
    from singa_tpu_torch import distributed

    distributed.init(device="cpu")
    try:
        one = distributed.global_mesh(dcn_mesh_shape=(1,))
        flat = distributed.global_mesh()
        assert (one.ranks, one.dims, one.axis_names) == (
            flat.ranks, flat.dims, flat.axis_names) == ((0,), (1,),
                                                         ("data",))
        assert distributed.host_slices() == [[0]]
    finally:
        distributed.shutdown()
