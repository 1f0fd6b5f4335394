"""The storage drivers of the port (`singa_tpu_torch.storage`, its own
copy of singa_tpu/storage) against the reference's conformance suite
(tests/test_storage_driver.py), parametrized over both drivers.

Each conformance case runs one script of driver calls on the reference's
driver and on the port's, each under a fresh base of its own (a
temporary directory, or a fresh ``mem://`` bucket), and the transcripts
must be equal: the bytes read back, the listings, every boolean a put,
`exists` or `isdir` returns, and whether each version token moved. The
races (eight threads claiming one key with `put_if_absent`) run on the
port's drivers and must admit exactly one winner. The checkpoint
protocol over both drivers is tests/test_torch_checkpoint.py's.
"""

import os
import threading
import time
import uuid

import pytest

from singa_tpu import storage as ref_storage
from singa_tpu_torch import storage


def _mem_base() -> str:
    return f"mem://t-{uuid.uuid4().hex[:12]}"


@pytest.fixture(params=["posix", "mem"])
def bases(request, tmp_path):
    """(the reference's base, the port's base) on one driver kind."""
    if request.param == "posix":
        yield str(tmp_path / "ref"), str(tmp_path / "port")
        return
    pair = (_mem_base(), _mem_base())
    yield pair
    ref_storage.get_driver(pair[0]).delete_prefix(pair[0])
    storage.get_driver(pair[1]).delete_prefix(pair[1])


def both(bases, script):
    """`script(pkg, base)`'s transcript on the reference and on the
    port, which must be equal; returns the port's."""
    ref_base, port_base = bases
    for b in bases:
        if "://" not in b:
            os.makedirs(b, exist_ok=True)
    want = script(ref_storage, ref_base)
    got = script(storage, port_base)
    assert got == want
    return got


def test_scheme_resolution_and_join(tmp_path):
    assert storage.get_driver(str(tmp_path)).name == "posix"
    assert storage.get_driver("mem://x/y").name == "object-store"
    assert storage.get_driver("mem://x/y").atomic_cas
    assert not storage.get_driver(str(tmp_path)).atomic_cas
    # every mem:// path shares ONE store, as processes share a bucket
    assert storage.get_driver("mem://a") is storage.get_driver("mem://b")
    for parts in (("mem://b/", "c", "d"), ("/tmp/x", "y"), ("rel", "a")):
        assert storage.join(*parts) == ref_storage.join(*parts)
    with pytest.raises(ValueError, match="must look like"):
        storage.register_scheme("s3", storage.ObjectStoreDriver())


def test_register_scheme_routes_by_longest_prefix():
    fresh = storage.ObjectStoreDriver()
    storage.register_scheme("mem://special/", fresh)
    try:
        assert storage.get_driver("mem://special/k") is fresh
        assert storage.get_driver("mem://other/k") is not fresh
    finally:
        del storage._SCHEMES["mem://special/"]


def _put_read_version(pkg, base):
    drv = pkg.get_driver(base)
    key = pkg.join(base, "obj")
    out = [drv.read(key), drv.version(key), drv.exists(key)]
    drv.put_atomic(key, b"one")
    v1 = drv.version(key)
    out += [drv.read(key), drv.exists(key), v1 is not None,
            drv.read(key), drv.version(key) == v1]
    time.sleep(0.01)  # posix mtime_ns granularity
    drv.put_atomic(key, b"two")
    out += [drv.read(key), drv.version(key) != v1]
    return out


def test_put_atomic_read_version(bases):
    got = both(bases, _put_read_version)
    assert got == [None, None, False, b"one", True, True, b"one", True,
                   b"two", True]


def test_put_if_absent_single_winner(bases):
    _, base = bases
    if "://" not in base:
        os.makedirs(base, exist_ok=True)
    drv = storage.get_driver(base)
    key = storage.join(base, "excl")
    wins = []
    barrier = threading.Barrier(8)

    def claim(i):
        barrier.wait()
        if drv.put_if_absent(key, f"claimant-{i}".encode()):
            wins.append(i)

    threads = [threading.Thread(target=claim, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert all(not t.is_alive() for t in threads)
    assert len(wins) == 1, wins
    assert drv.read(key) == f"claimant-{wins[0]}".encode()
    assert not drv.put_if_absent(key, b"late")


def _if_match(pkg, base):
    drv = pkg.get_driver(base)
    key = pkg.join(base, "cas")
    out = [drv.put_if_match(key, b"v1", None),
           drv.put_if_match(key, b"clobber", None)]
    token = drv.version(key)
    time.sleep(0.01)
    out += [drv.put_if_match(key, b"v2", token), drv.read(key),
            drv.put_if_match(key, b"v3", token), drv.read(key)]
    return out


def test_put_if_match_semantics(bases):
    got = both(bases, _if_match)
    assert got == [True, False, True, b"v2", False, b"v2"]


def _containers(pkg, base):
    drv = pkg.get_driver(base)
    drv.makedirs(pkg.join(base, "d"))
    drv.put_atomic(pkg.join(base, "d", "a"), b"1")
    drv.put_atomic(pkg.join(base, "d", "sub", "b"), b"2")
    return [drv.list(pkg.join(base, "d")),
            drv.isdir(pkg.join(base, "d")),
            drv.isdir(pkg.join(base, "d", "sub")),
            drv.isdir(pkg.join(base, "d", "a")),
            drv.list(pkg.join(base, "missing")),
            drv.read(pkg.join(base, "d", "sub", "b"))]


def test_list_after_put_and_containers(bases):
    got = both(bases, _containers)
    assert got == [["a", "sub"], True, True, False, [], b"2"]


def _deletes(pkg, base):
    drv = pkg.get_driver(base)
    drv.makedirs(pkg.join(base, "p"))
    drv.put_atomic(pkg.join(base, "p", "x"), b"1")
    drv.put_atomic(pkg.join(base, "p", "q", "y"), b"2")
    drv.delete(pkg.join(base, "p", "x"))
    drv.delete(pkg.join(base, "p", "x"))  # missing: no-op
    out = [drv.exists(pkg.join(base, "p", "x")),
           drv.list(pkg.join(base, "p"))]
    drv.delete_prefix(pkg.join(base, "p"))
    return out + [drv.list(pkg.join(base, "p")),
                  drv.isdir(pkg.join(base, "p"))]


def test_delete_and_delete_prefix(bases):
    got = both(bases, _deletes)
    assert got == [False, ["q"], [], False]


def test_object_store_put_delay_slows_only_puts():
    drv = storage.ObjectStoreDriver()
    drv.put_delay_s = 0.05
    t = time.perf_counter()
    drv.put_atomic("mem://d/k", b"x")
    assert time.perf_counter() - t >= 0.05
    t = time.perf_counter()
    assert drv.read("mem://d/k") == b"x"
    assert time.perf_counter() - t < 0.05
