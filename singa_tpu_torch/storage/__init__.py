"""Pluggable storage drivers for state I/O (counterpart of
singa_tpu/storage/, pure Python, the port's own copy).

The checkpoint commit protocol speaks a small primitive vocabulary
(`storage.driver.StorageDriver`); this package resolves WHICH
implementation carries it from the path alone:

- a plain filesystem path -> `PosixDriver` (write-temp+fsync+rename,
  hard-link no-clobber — bitwise the pre-driver behavior);
- ``mem://bucket/...``    -> the in-process `ObjectStoreDriver` fake
  (flat keys, generation-checked conditional puts, S3/GCS semantics);
- any scheme registered via `register_scheme` (a real S3/GCS driver
  plugs in here without touching the protocols).

`get_driver(path)` is called at every I/O site instead of threading a
driver object through the call stacks — resolution is one prefix scan
over a tiny registry, and every existing caller keeps passing plain
path strings (`resilience.save("mem://t/ckpt", ...)` just works,
which is what lets the kill-anywhere oracles run parametrized over
both drivers).
"""

from __future__ import annotations

from typing import Dict

from singa_tpu_torch.storage.driver import StorageDriver  # noqa: F401
from singa_tpu_torch.storage.object_store import (  # noqa: F401
    ObjectStoreDriver,
)
from singa_tpu_torch.storage.posix import PosixDriver  # noqa: F401

__all__ = ["StorageDriver", "PosixDriver", "ObjectStoreDriver",
           "get_driver", "register_scheme", "join"]

#: the process-wide driver singletons: scheme prefix -> driver. The
#: posix driver is the schemeless fallback; the object-store fake is
#: one shared instance so every mem:// path in the process (threads,
#: background commits) sees the same store, like processes sharing a
#: bucket.
_SCHEMES: Dict[str, StorageDriver] = {
    "mem://": ObjectStoreDriver(),
}
_POSIX = PosixDriver()


def register_scheme(prefix: str, driver: StorageDriver) -> None:
    """Install `driver` for paths starting with `prefix` (e.g. a real
    ``s3://`` driver, or a test double that throttles/fails writes).
    Re-registering a prefix replaces the driver."""
    if "://" not in prefix:
        raise ValueError(
            f"storage scheme prefix {prefix!r} must look like "
            f"'name://' — a schemeless prefix would shadow every "
            f"filesystem path")
    _SCHEMES[prefix] = driver


def get_driver(path: str) -> StorageDriver:
    """The driver owning `path`: longest registered scheme prefix
    wins; schemeless paths are the posix filesystem."""
    best = None
    for prefix in _SCHEMES:
        if path.startswith(prefix) and (
                best is None or len(prefix) > len(best)):
            best = prefix
    return _POSIX if best is None else _SCHEMES[best]


def join(base: str, *parts: str) -> str:
    """Path join that works for both addressings ("/" separators on
    schemed keys; os.path.join on filesystem paths — identical on this
    POSIX container, kept explicit for readability at call sites)."""
    import os

    if "://" in base:
        return "/".join([base.rstrip("/"), *parts])
    return os.path.join(base, *parts)
