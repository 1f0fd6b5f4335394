"""The 3-D mesh and the pspec helpers of the port (`parallel.mesh`'s
`get_mesh_3d`, `get_mesh(devices=)` and discovery context;
`distributed`'s `active_pspec`, `block_of`, `place_model_states`,
`place_opt_states`, `infer_state_mesh`, `gather_full`), in one process.

`active_pspec` and `get_mesh_3d`'s axis order are held against
singa_tpu's on its virtual mesh. Placement is held on a stand-in mesh
of two ranks seen from rank 1 (sizes and indices, no process group:
slicing needs no collective): a tensor-parallel model's blocks, its
full-array state loads, the optimizer's slots and a checkpoint's full
slots. The multi-rank gathers run in tests/test_torch_tp_model.py and
tests/test_torch_scan_tp.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from helper_torch_parity import port_tp_mlp  # noqa: E402
from singa_tpu_torch import distributed, opt  # noqa: E402
from singa_tpu_torch.parallel import mesh as mesh_module  # noqa: E402


class TwoRanks:
    """A (data 1, model 2) mesh seen from model rank 1, with no group."""

    axis_names = ("data", "model")
    size = 2
    group = None

    def axis_size(self, name):
        return {"data": 1, "model": 2}[name]

    def axis_index(self, name):
        return {"data": 0, "model": 1}[name]

    def axis_group(self, name):
        return None


SPECS = [(None, "model"), ("model", None), ("model",), (None, None, "sp"),
         (("model", "data"),), (("sp", "expert"), None), ()]


def test_active_pspec_matches_the_reference():
    from singa_tpu import distributed as rdist
    from singa_tpu.parallel import mesh as rmesh

    ref = rmesh.get_mesh((1, 2), ("data", "model"),
                         devices=jax.devices()[:2])
    port = mesh_module.get_mesh((1, 1), ("data", "model"))
    for spec in SPECS:
        assert distributed.active_pspec(spec, port) == tuple(
            rdist.active_pspec(spec, ref)), spec


def test_get_mesh_3d_keeps_the_reference_axis_order():
    from singa_tpu.parallel import mesh as rmesh

    ref = rmesh.get_mesh_3d(1, 1, 1, devices=jax.devices()[:1])
    m = mesh_module.get_mesh_3d(1, 1, 1)
    assert m.axis_names == tuple(ref.axis_names) == ("data", "model", "sp")
    assert m.shape == {"data": 1, "model": 1, "sp": 1}
    assert mesh_module.get_mesh_3d(axis_names=("d", "m", "s")).axis_names \
        == ("d", "m", "s")
    with pytest.raises(ValueError, match="does not match the 1 processes"):
        mesh_module.get_mesh_3d(1, 2, 1)


def test_get_mesh_devices_names_ranks():
    m = mesh_module.get_mesh((1,), ("model",), devices=[0])
    assert m.shape == {"model": 1}
    assert mesh_module.get_mesh(devices=[torch.device("cuda", 0)]).shape \
        == {"data": 1}
    for bad in ([0, 0], [1], ["x"]):
        with pytest.raises(ValueError):
            mesh_module.get_mesh(devices=bad)


def test_discovery_context_nests():
    assert not mesh_module.in_discovery()
    with mesh_module.discovery_context():
        with mesh_module.discovery_context():
            assert mesh_module.in_discovery()
        assert mesh_module.in_discovery()
    assert not mesh_module.in_discovery()


def test_block_of_splits_jointly_first_axis_major():
    full = torch.arange(24.0).reshape(2, 12)
    mesh = TwoRanks()
    np.testing.assert_array_equal(
        distributed.block_of(full, (None, "model"), mesh), full[:, 6:])
    np.testing.assert_array_equal(
        distributed.block_of(full, ("model", None), mesh), full[1:])
    # joint (model, data): 2 x 1 parts, model major
    np.testing.assert_array_equal(
        distributed.block_of(full, (None, ("model", "data")), mesh),
        full[:, 6:])
    with pytest.raises(ValueError, match="not divisible"):
        distributed.block_of(torch.zeros(3), ("model",), mesh)


def test_placement_slices_blocks_and_loads_full_states():
    """Rank 1's blocks of a tp MLP; full arrays (a checkpoint's states,
    an optimizer's slots) load as that rank's blocks."""
    m = port_tp_mlp(tp_axis="model")
    m.compile([torch.zeros(2, 12)], is_train=False, use_graph=False)
    full = {k: v.detach().clone() for k, v in m.get_states().items()}
    mesh = TwoRanks()
    assert distributed.place_model_states(mesh, m) == 3
    assert distributed.place_model_states(mesh, m) == 0  # idempotent
    assert tuple(m.fc1.W.shape) == (12, 8) and tuple(m.fc2.W.shape) == (8, 4)
    np.testing.assert_array_equal(m.fc1.W.detach(), full["fc1.W"][:, 8:])
    np.testing.assert_array_equal(m.fc2.W.detach(), full["fc2.W"][8:])
    assert m.fc1.W.placed == ((12, 16), (None, "model"), mesh)
    assert distributed.infer_state_mesh(m) is mesh
    with pytest.raises(ValueError, match="placed on"):
        distributed.place_model_states(TwoRanks(), m)
    doubled = {k: 2 * v for k, v in full.items()}
    m.set_states(doubled)
    np.testing.assert_array_equal(m.fc1.b.detach(), doubled["fc1.b"][8:])
    np.testing.assert_array_equal(m.fc0.W.detach(), doubled["fc0.W"])
    sgd = opt.SGD(lr=0.1, momentum=0.9)
    sgd.prepare(dict(m.named_parameters()))
    slots = {f"{k}//momentum": torch.full(v.shape, float(i))
             for i, (k, v) in enumerate(full.items())}
    sgd.load_states(slots)
    got = sgd.dump_states()
    assert tuple(got["fc1.W//momentum"].shape) == (12, 8)
    assert distributed.place_opt_states(mesh, m, sgd) == 0
    with pytest.raises(ValueError, match="placed on"):
        distributed.place_opt_states(TwoRanks(), m, sgd)
    assert distributed.infer_state_mesh(port_tp_mlp(), sgd) is None
