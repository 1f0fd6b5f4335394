"""The port's sharded checkpoint (`singa_tpu_torch.resilience.checkpoint`)
against the reference's: the oracles of tests/test_resilience_checkpoint.py
and tests/test_storage_driver.py on the port, and checkpoints crossed
between the two packages.

- A round trip is bitwise (parameters, slots, the step counter, the step
  and the data cursor) on the posix and the ``mem://`` drivers; a torn
  step (shard bytes, no manifest) is unreachable and a same-step re-save
  lands in a fresh ``.r1`` dir, leaving the committed one untouched.
- A flipped bit is refused naming the file and the chunk's byte offset
  (a shard of more than one 1 MiB chunk, the flip in its second).
- A process killed (`faults.kill_at_phase`, `os._exit`) at each of the
  four commit phases, sync and async, leaves `LATEST` naming the previous
  step, which restores. The "receipts" phase is the two-phase commit's,
  driven by two thread-hosted ranks in the doomed process.
- `prune` keeps the newest and `LATEST`; `allow_partial` is the only way
  to drop the optimizer's states, and the structural refusals hold.
- A checkpoint the reference writes restores into the port and the
  reverse, with ``set_rng=False``: parameters and slots bitwise. The
  reference's side runs in a process of its own (`run_reference`).
- `distributed.owner_table` equals the reference's `shard_owner_map` on
  the same (shape, pspec, mesh) for tp, zero3, joint tp x zero3 and
  replicated leaves, the reference's device index playing the rank.
"""

import os
import subprocess
import sys
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from helper_torch_parity import ckpt_net, ckpt_state, run_reference  # noqa: E402
from singa_tpu_torch import distributed, resilience, storage  # noqa: E402
from singa_tpu_torch.models import MLP  # noqa: E402
from singa_tpu_torch.resilience import checkpoint as ckpt  # noqa: E402
from singa_tpu_torch.resilience import faults  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("snapshot", "shard_writes", "receipts", "manifest")
KILLS = [(p, False) for p in PHASES] + [("shard_writes", True),
                                        ("manifest", True)]


@pytest.fixture(params=["posix", "mem"])
def ckdir(request, tmp_path):
    if request.param == "posix":
        yield str(tmp_path / "ck")
        return
    d = f"mem://t-{uuid.uuid4().hex[:12]}/ck"
    yield d
    storage.get_driver(d).delete_prefix(d)


def assert_same(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}: {k}")


def test_round_trip_is_bitwise(ckdir):
    m, o, x, y = ckpt_net()
    for _ in range(2):
        m.train_one_batch(x, y)
    want = ckpt_state(m, o)
    step_dir = resilience.save(ckdir, m, o, step=2, data_cursor={"i": 2})
    assert resilience.latest_step_dir(ckdir) == step_dir
    m2, o2, _, _ = ckpt_net(seed=1)
    meta = resilience.restore(ckdir, m2, o2)
    assert meta["step"] == 2 and meta["data_cursor"] == {"i": 2}
    assert meta["dir"] == step_dir
    assert_same(ckpt_state(m2, o2), want, "round trip")
    assert o2.step_counter == 2
    manifest, _ = resilience.read_manifest(ckdir)
    assert manifest["format"] == ckpt.FORMAT and manifest["processes"] == 1
    names = [leaf["name"] for leaf in manifest["leaves"]]
    assert names[:4] == ["param/fc1.W", "param/fc1.b", "param/fc2.W",
                         "param/fc2.b"]
    assert "opt/__step__" in names and "opt/fc1.W//m" in names
    assert set(manifest["rng"]) == {"cpu", "cuda"}


def test_torn_step_unreachable_and_same_step_resave(ckdir):
    drv = storage.get_driver(ckdir)
    m, o, x, y = ckpt_net()
    m.train_one_batch(x, y)
    first = resilience.save(ckdir, m, o, step=1)
    drv.put_atomic(storage.join(ckdir, "step-00000002", "00000-000.bin"),
                   b"\x00" * 64)
    m2, o2, _, _ = ckpt_net(seed=1)
    meta = resilience.restore(ckdir, m2, o2)
    assert meta["dir"] == first and meta["step"] == 1
    stamp = {n: drv.version(storage.join(first, n)) for n in drv.list(first)}
    second = resilience.save(ckdir, m, o, step=1)
    assert second != first and second.endswith(".r1")
    assert stamp == {n: drv.version(storage.join(first, n))
                     for n in drv.list(first)}
    assert resilience.restore(ckdir, m2, o2, step=1)["dir"] == second


def test_a_flipped_bit_is_refused_naming_file_and_offset(tmp_path):
    # fc1.W is 12 x 24000 fp32: two crc chunks; the flip lands in the second
    m, o, x, y = ckpt_net(hidden=24000)
    resilience.save(str(tmp_path), m, o, step=1)
    off = ckpt.CHUNK_BYTES + 12
    path, got_off = faults.flip_checkpoint_byte(str(tmp_path),
                                                leaf="param/fc1.W",
                                                byte_offset=off)
    assert got_off == off and path.endswith("00000-000.bin")
    m2, o2, _, _ = ckpt_net(seed=1, hidden=24000)
    before = ckpt_state(m2, o2)
    with pytest.raises(resilience.CorruptCheckpointError) as ei:
        resilience.restore(str(tmp_path), m2, o2)
    msg = str(ei.value)
    assert path in msg and f"byte offset {ckpt.CHUNK_BYTES}" in msg
    assert "crc32" in msg and "param/fc1.W" in msg
    # refused before anything loaded
    assert_same(ckpt_state(m2, o2), before, "after the refusal")
    with open(path, "r+b") as f:  # a truncated shard is refused too
        f.truncate(100)
    with pytest.raises(resilience.CorruptCheckpointError, match="truncated"):
        resilience.restore(str(tmp_path), m2, o2)


@pytest.fixture(scope="module")
def killed(tmp_path_factory):
    """One doomed child a (phase, async) case, all started at once:
    {case: (exit code, its stderr, its directory)}."""
    base = tmp_path_factory.mktemp("kills")
    procs = {}
    for phase, async_ in KILLS:
        d = str(base / f"{phase}_{async_}")
        code = ("from helper_torch_parity import _ckpt_kill_child; "
                f"_ckpt_kill_child({d!r}, {phase!r}, {async_!r})")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT), str(ROOT / "tests"),
             os.environ.get("PYTHONPATH", "")]))
        procs[(phase, async_)] = (subprocess.Popen(
            [sys.executable, "-c", code], cwd=str(ROOT), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), d)
    out = {}
    for case, (p, d) in procs.items():
        _, err = p.communicate(timeout=110)
        out[case] = (p.returncode, err, d)
    return out


@pytest.mark.parametrize("phase,async_", KILLS)
def test_a_kill_at_each_phase_leaves_the_previous_step_committed(
        killed, phase, async_):
    code, err, d = killed[(phase, async_)]
    assert code == 42, f"the kill at {phase} did not fire: {err[-2000:]}"
    assert resilience.latest_step_dir(d).endswith("step-00000001")
    m, o, x, y = ckpt_net()
    m.train_one_batch(x, y)
    want = ckpt_state(m, o)
    m2, o2, _, _ = ckpt_net(seed=1)
    assert resilience.restore(d, m2, o2)["step"] == 1
    assert_same(ckpt_state(m2, o2), want, f"killed at {phase}")
    # a torn step 2 is pruned as an older leftover once a newer step
    # commits
    resilience.save(d, m2, o2, step=3)
    resilience.prune(d, keep=1)
    assert storage.get_driver(d).list(d) == ["LATEST", "step-00000003"]


def test_prune_keeps_the_newest_and_latest(ckdir):
    m, o, x, y = ckpt_net()
    m.train_one_batch(x, y)
    for s in (1, 2, 3):
        resilience.save(ckdir, m, o, step=s)
    assert resilience.prune(ckdir, keep=2) == ["step-00000001"]
    drv = storage.get_driver(ckdir)
    assert [n for n in drv.list(ckdir) if n.startswith("step-")] == [
        "step-00000002", "step-00000003"]
    # a torn dir newer than LATEST may be a writer in flight: kept
    drv.put_atomic(storage.join(ckdir, "step-00000009", "x.bin"), b"x")
    assert resilience.prune(ckdir, keep=1) == ["step-00000002"]
    assert drv.isdir(storage.join(ckdir, "step-00000009"))
    assert resilience.restore(ckdir, m, o)["step"] == 3


def test_allow_partial_and_the_structural_refusals(tmp_path):
    m, o, x, y = ckpt_net()
    m.train_one_batch(x, y)
    d = str(tmp_path / "ck")
    resilience.save(d, m, o, step=1)
    m2, o2, _, _ = ckpt_net(seed=1)
    fresh_slots = {k: v.clone() for k, v in o2.dump_states().items()}
    with pytest.raises(resilience.CheckpointError, match="optimizer=None"):
        resilience.restore(d, m2, None)
    with pytest.warns(UserWarning, match="params-only warm start"):
        resilience.restore(d, m2, None, allow_partial=True)
    for k, v in m.get_states().items():
        assert torch.equal(m2.get_states()[k], v)
    for k, v in o2.dump_states().items():
        assert torch.equal(v, fresh_slots[k])
    # a model-only checkpoint refuses a passed optimizer
    d2 = str(tmp_path / "model_only")
    resilience.save(d2, m, None, step=1)
    with pytest.raises(resilience.CheckpointError, match="no optimizer"):
        resilience.restore(d2, m2, o2)
    # the wrong model: a shape and a missing state
    wide, wide_o, _, _ = ckpt_net(hidden=8)
    with pytest.raises(resilience.CheckpointError, match="wrong model"):
        resilience.restore(d, wide, wide_o)
    with pytest.raises(resilience.CheckpointError, match="no committed"):
        resilience.restore(str(tmp_path / "nothing"), m2, o2)


# -- checkpoints crossed between the packages ---------------------------------

MLP_KW = dict(perceptron_size=9, num_classes=3)


def _batch():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((8, 6)).astype(np.float32),
            (np.arange(8) % 3).astype(np.int32))


def reference_side(port_dir, ref_dir):
    """The reference's MLP with Adam, 2 steps, saved under `ref_dir`
    (its states returned); and a fresh reference MLP restored from the
    port's `port_dir` (its states returned)."""
    from singa_tpu import opt, resilience as ref_resilience
    from singa_tpu import tensor as tensor_module
    from singa_tpu.models import MLP as RefMLP
    from singa_tpu.tensor import from_numpy

    x, y = (from_numpy(a) for a in _batch())

    def build():
        tensor_module.set_seed(3)
        m = RefMLP(**MLP_KW)
        o = opt.Adam(lr=0.01)
        m.set_optimizer(o)
        m.compile([x], is_train=True, use_graph=True)
        return m, o

    def state(m, o):
        out = {f"param/{k}": np.asarray(v.data)
               for k, v in m.get_states().items()}
        out.update({f"opt/{k}": np.asarray(v)
                    for k, v in o.dump_states().items()})
        return out

    m, o = build()
    for _ in range(2):
        m.train_one_batch(x, y)
    ref_resilience.save(ref_dir, m, o, step=2, data_cursor=2)
    wrote = state(m, o)
    m2, o2 = build()
    meta = ref_resilience.restore(port_dir, m2, o2, set_rng=False)
    return dict(wrote=wrote, read=state(m2, o2), step=meta["step"],
                cursor=meta["data_cursor"])


def port_mlp():
    torch.manual_seed(4)
    m = MLP(**MLP_KW, in_features=6, device="cpu")
    from singa_tpu_torch import opt

    o = opt.Adam(lr=0.01)
    m.set_optimizer(o)
    x, y = (torch.from_numpy(a) for a in _batch())
    m.compile([x], is_train=True, use_graph=True)
    return m, o, x, y.long()


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    base = tmp_path_factory.mktemp("crossed")
    port_dir, ref_dir = str(base / "port"), str(base / "ref")
    m, o, x, y = port_mlp()
    for _ in range(3):
        m.train_one_batch(x, y)
    resilience.save(port_dir, m, o, step=3, data_cursor=3)
    ref = run_reference("test_torch_checkpoint", "reference_side",
                        base, port_dir=port_dir, ref_dir=ref_dir)
    return dict(port=ckpt_state(m, o), ref=ref, ref_dir=ref_dir)


def test_a_reference_checkpoint_restores_into_the_port(crossed):
    m, o, _, _ = port_mlp()
    meta = resilience.restore(crossed["ref_dir"], m, o, set_rng=False)
    assert meta["step"] == 2 and meta["data_cursor"] == 2
    assert_same(ckpt_state(m, o), crossed["ref"]["wrote"],
                "reference -> port")


def test_a_port_checkpoint_restores_into_the_reference(crossed):
    ref = crossed["ref"]
    assert ref["step"] == 3 and ref["cursor"] == 3
    assert_same(ref["read"], crossed["port"], "port -> reference")


# -- shard_owner_map ------------------------------------------------------------

OWNER_CASES = {
    "tp": ((8, 12), (None, "model"), (2, 4), ("data", "model")),
    "tp_rows": ((16, 6), ("model", None), (1, 8), ("data", "model")),
    "zero3": ((2, 8, 6), (None, "data", None), (4,), ("data",)),
    "zero3_on_2d": ((2, 8, 6), (None, "data", None), (2, 4),
                    ("data", "model")),
    "tp_x_zero3": ((2, 16, 6), (None, ("model", "data"), None), (2, 2, 2),
                   ("data", "model", "sp")),
    "replicated": ((5, 3), (), (2, 4), ("data", "model")),
}


class _Dev:
    """A reference device whose process index is its id: one rank a
    device, as the port runs one process a device."""

    def __init__(self, dev):
        self.process_index = int(dev.id)


class _AsRanks:
    def __init__(self, shape, sharding):
        self.shape, self._sharding = shape, sharding

    @property
    def sharding(self):
        outer = self._sharding

        class S:
            @staticmethod
            def devices_indices_map(shape):
                return {_Dev(d): idx for d, idx in
                        outer.devices_indices_map(shape).items()}

        return S()


@pytest.mark.parametrize("case", sorted(OWNER_CASES))
def test_owner_table_matches_the_reference(case):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from singa_tpu import distributed as ref_distributed

    shape, spec, dims, names = OWNER_CASES[case]
    n = int(np.prod(dims))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(dims), names)
    want = ref_distributed.shard_owner_map(
        _AsRanks(shape, NamedSharding(mesh, PartitionSpec(*spec))))
    got = distributed.owner_table(shape, spec, names, dims)
    assert got == want
    # ranks laid out otherwise: the lowest of each shard's holders owns it
    ranks = tuple(reversed(range(n)))
    moved = distributed.owner_table(shape, spec, names, dims, ranks)
    assert sorted(moved) == sorted(got)
    assert all(moved[b] == min(ranks[p] for p in range(n)
                               if _holds(b, p, shape, spec, dims, names))
               for b in moved)


def _holds(bounds, pos, shape, spec, dims, names):
    one = distributed.owner_table(shape, spec, names, dims,
                                  [0 if i == pos else 1 for i in
                                   range(int(np.prod(dims)))])
    return one[bounds] == 0


def test_shard_owner_map_of_an_unplaced_tensor_is_one_shard():
    t = torch.zeros(3, 4)
    t.pspec = (None, "model")  # declared, not placed: replicated
    assert distributed.shard_owner_map(t) == {((0, 3), (0, 4)): 0}
    assert distributed.shard_owner_map(torch.zeros(())) == {(): 0}
    # an axis the mesh lacks is replicated
    assert distributed.owner_table((4, 2), ("expert", None), ("data",),
                                   (2,)) == {((0, 4), (0, 2)): 0}
