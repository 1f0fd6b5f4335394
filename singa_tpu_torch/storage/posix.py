"""PosixDriver: the shared-filesystem storage driver (counterpart of
singa_tpu/storage/posix.py).

- ``put_atomic`` is the commit protocol's write-to-temp + fsync +
  rename (+ a directory fsync so the rename itself is durable).
- ``put_if_absent`` is a write-temp + hard-link no-clobber publish
  (`os.link` refuses an existing target: the classic shared-fs O_EXCL
  primitive).
- ``put_if_match`` is a read-compare-replace APPROXIMATION
  (``atomic_cas = False``): POSIX has no native compare-and-swap on
  file content, so a writer stalled between the compare and the
  replace can still lose a race the object store's generation check
  would catch.
- ``version`` is the (mtime_ns, size) fingerprint.
"""

from __future__ import annotations

import os
import uuid
from typing import List, Optional

from singa_tpu_torch.storage.driver import StorageDriver, VersionToken

__all__ = ["PosixDriver"]


def _fsync_dir(path: str) -> None:
    if os.name != "posix":  # pragma: no cover — POSIX container
        return
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class PosixDriver(StorageDriver):
    name = "posix"
    atomic_cas = False

    def _tmp(self, path: str) -> str:
        # unique per WRITE, not per process: two writers of one
        # process (a background commit thread) must not share a name.
        # Parents are created on demand — the object store has no
        # directories at all, so a driver-generic caller cannot be
        # required to mkdir before every put.
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        return f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"

    def put_atomic(self, path: str, data: bytes) -> None:
        tmp = self._tmp(path)
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(path) or ".")

    def put_if_absent(self, path: str, data: bytes) -> bool:
        tmp = self._tmp(path)
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, path)
            _fsync_dir(os.path.dirname(path) or ".")
            return True
        except FileExistsError:
            return False
        finally:
            os.remove(tmp)

    def put_if_match(self, path: str, data: bytes,
                     expected: Optional[VersionToken]) -> bool:
        if expected is None:
            return self.put_if_absent(path, data)
        if self.version(path) != tuple(expected):
            return False
        # read-compare-replace: not atomic (module docstring)
        self.put_atomic(path, data)
        return True

    def read(self, path: str) -> Optional[bytes]:
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError:
            return None

    def version(self, path: str) -> Optional[VersionToken]:
        try:
            st = os.stat(path)
            return (st.st_mtime_ns, st.st_size)
        except OSError:
            return None

    def exists(self, path: str) -> bool:
        return os.path.isfile(path)

    def isdir(self, path: str) -> bool:
        return os.path.isdir(path)

    def list(self, path: str) -> List[str]:
        try:
            return sorted(os.listdir(path))
        except OSError:
            return []

    def delete(self, path: str) -> None:
        try:
            os.remove(path)
        except OSError:
            pass

    def delete_prefix(self, path: str) -> None:
        import shutil

        shutil.rmtree(path, ignore_errors=True)

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
