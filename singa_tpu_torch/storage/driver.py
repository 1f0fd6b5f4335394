"""The storage driver interface (counterpart of
singa_tpu/storage/driver.py): the primitives every state-I/O protocol
is built from.

The two-phase checkpoint commit (resilience/checkpoint.py) was written
against a shared POSIX filesystem where `rename` is atomic and `link`
refuses an existing target. A shared medium may as well be an object
store (S3/GCS), where there is no rename and no O_EXCL, but there ARE
conditional puts. This interface names the exact operations the
protocol performs, so it is driver-generic:

| primitive                    | protocol step it carries              |
|------------------------------|---------------------------------------|
| ``put_atomic``               | shard files, manifest, the LATEST     |
|                              | swing, receipts/ACKs                  |
| ``put_if_absent``            | an exclusive first publish            |
| ``put_if_match``             | a compare-and-swap (CAS drivers)      |
| ``read`` / ``version``       | manifest/marker reads; a change token |
| ``list`` / ``exists``        | step-dir discovery, receipt barriers, |
|                              | prune listings                        |
| ``delete`` / ``delete_prefix``| nonce retirement, checkpoint         |
|                              | retention                             |

Drivers are addressed by the PATH itself (`storage.get_driver(path)`):
a plain filesystem path resolves to the `PosixDriver` (bitwise the
pre-driver behavior), a ``mem://bucket/...`` path to the in-process
`ObjectStoreDriver` fake whose conditional puts model S3/GCS
semantics. Every caller keeps passing plain strings
(`resilience.save("mem://t/ckpt", ...)` just works), which is what lets
the kill-anywhere oracles run parametrized over BOTH drivers.

Semantics every driver must honor (tests/test_torch_storage.py runs
the reference's conformance suite on these drivers):

- **put_atomic**: readers see the old bytes or the complete new bytes,
  never a torn object; durable before return (fsync on posix).
- **put_if_absent**: publish only if nothing is at `path`; returns
  whether THIS caller won. Two concurrent winners are impossible.
- **put_if_match(path, data, expected)**: swap only if the current
  version token equals `expected` (`None` = must-not-exist, i.e.
  put_if_absent). Returns whether the swap landed. Only drivers with
  ``atomic_cas = True`` guarantee the compare and the swap are one
  atomic step; the posix driver approximates it read-compare-replace
  and says so (``atomic_cas = False``).
- **version**: an opaque change token (posix: (mtime_ns, size); object
  store: a generation counter). It MUST change on every successful
  put and never change on reads: it is the CAS token.
- **list(prefix)**: names of the IMMEDIATE children under `prefix`,
  directories synthesized from deeper keys on stores that have none;
  a put is visible to list before the put returns (no eventual
  consistency in the fake — modern S3/GCS are read-after-write
  consistent too).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

__all__ = ["StorageDriver", "VersionToken"]

#: an opaque change token: compare for equality only
VersionToken = Tuple


class StorageDriver:
    """Abstract driver (module docstring). Paths are the caller's
    strings verbatim — each driver owns its own addressing (filesystem
    paths / ``scheme://bucket/key``)."""

    #: short name stamped into logs/tests ("posix", "object-store")
    name: str = "abstract"
    #: whether put_if_match is a true atomic compare-and-swap (object
    #: stores) or a read-compare-replace approximation (posix)
    atomic_cas: bool = False

    # -- writes ---------------------------------------------------------------
    def put_atomic(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def put_if_absent(self, path: str, data: bytes) -> bool:
        raise NotImplementedError

    def put_if_match(self, path: str, data: bytes,
                     expected: Optional[VersionToken]) -> bool:
        raise NotImplementedError

    # -- reads ----------------------------------------------------------------
    def read(self, path: str) -> Optional[bytes]:
        """The object's bytes, or None when absent (a torn object is
        unobservable by the put_atomic contract)."""
        raise NotImplementedError

    def version(self, path: str) -> Optional[VersionToken]:
        """Change token for `path`, None when absent."""
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        """Whether an OBJECT sits exactly at `path` (a posix file; not
        a directory/prefix — see `isdir`)."""
        raise NotImplementedError

    def isdir(self, path: str) -> bool:
        """Whether `path` is a container: a posix directory, or (on an
        object store) a prefix with at least one object beneath it."""
        raise NotImplementedError

    def list(self, path: str) -> List[str]:
        """Names of the immediate children under `path` ([] when none
        or absent) — both objects and synthesized sub-containers."""
        raise NotImplementedError

    # -- deletes / containers -------------------------------------------------
    def delete(self, path: str) -> None:
        """Remove the object at `path`; a missing object is a no-op."""
        raise NotImplementedError

    def delete_prefix(self, path: str) -> None:
        """Remove everything under `path` (the rmtree of a step dir);
        missing is a no-op."""
        raise NotImplementedError

    def makedirs(self, path: str) -> None:
        """Ensure the container exists (posix mkdir -p; a no-op on
        stores without directories)."""
        raise NotImplementedError
