"""ObjectStoreDriver: an in-process object-store fake (``mem://``)
whose conditional puts model S3/GCS semantics (counterpart of
singa_tpu/storage/object_store.py).

What it models, and the posix driver CANNOT:

- **No rename, no directories.** Objects live in a flat key space;
  "directories" are synthesized from key prefixes at `list`/`isdir`
  time. `put_atomic` is a plain whole-object PUT: atomicity is the
  store's native property, not a rename trick.
- **Generation-checked conditional puts.** Every object carries a
  monotonically increasing GENERATION (the etag/x-goog-generation
  analogue) which `version()` returns as the change token.
  ``put_if_absent`` is an `If-None-Match: *` PUT; ``put_if_match``
  is an `If-Match: <generation>` PUT, both decided atomically under
  the store's lock, so ``atomic_cas = True``.
- **Read-after-write consistency**: a completed put is immediately
  visible to `read`/`list`/`version`.

State lives on the DRIVER INSTANCE (`self._objects`), and sharing
comes from `singa_tpu_torch.storage` registering ONE instance for the
``mem://`` scheme, so every mem:// path in the process (threads,
background commit threads) sees the same store, the way processes
share a bucket; re-registering the scheme with a fresh instance starts
from an empty store. It cannot cross process boundaries: the
real-process oracles stay on the posix driver.

Test seam: ``put_delay_s`` sleeps inside every `put_atomic`, which
slows the commit path down to a measurable size without a clock in
the protocol itself.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from singa_tpu_torch.storage.driver import StorageDriver, VersionToken

__all__ = ["ObjectStoreDriver", "SCHEME"]

SCHEME = "mem://"


class _Obj:
    __slots__ = ("data", "generation")

    def __init__(self, data: bytes, generation: int):
        self.data = data
        self.generation = generation


class ObjectStoreDriver(StorageDriver):
    name = "object-store"
    atomic_cas = True

    def __init__(self):
        self._lock = threading.RLock()
        self._objects: Dict[str, _Obj] = {}
        self._gen = 0
        #: test seam — per-put sleep, applied OUTSIDE the lock so a
        #: slowed writer does not serialize unrelated readers
        self.put_delay_s = 0.0

    @staticmethod
    def _key(path: str) -> str:
        return path.rstrip("/")

    def _next_gen(self) -> int:
        self._gen += 1
        return self._gen

    # -- writes ---------------------------------------------------------------
    def put_atomic(self, path: str, data: bytes) -> None:
        if self.put_delay_s:
            time.sleep(self.put_delay_s)
        key = self._key(path)
        with self._lock:
            self._objects[key] = _Obj(bytes(data), self._next_gen())

    def put_if_absent(self, path: str, data: bytes) -> bool:
        key = self._key(path)
        with self._lock:  # If-None-Match: * — decided atomically
            if key in self._objects:
                return False
            self._objects[key] = _Obj(bytes(data), self._next_gen())
            return True

    def put_if_match(self, path: str, data: bytes,
                     expected: Optional[VersionToken]) -> bool:
        key = self._key(path)
        with self._lock:  # If-Match: <generation> — atomically
            cur = self._objects.get(key)
            if expected is None:
                if cur is not None:
                    return False
            elif cur is None or (cur.generation,) != tuple(expected):
                return False
            self._objects[key] = _Obj(bytes(data), self._next_gen())
            return True

    # -- reads ----------------------------------------------------------------
    def read(self, path: str) -> Optional[bytes]:
        with self._lock:
            obj = self._objects.get(self._key(path))
            return None if obj is None else obj.data

    def version(self, path: str) -> Optional[VersionToken]:
        with self._lock:
            obj = self._objects.get(self._key(path))
            return None if obj is None else (obj.generation,)

    def exists(self, path: str) -> bool:
        with self._lock:
            return self._key(path) in self._objects

    def isdir(self, path: str) -> bool:
        prefix = self._key(path) + "/"
        with self._lock:
            return any(k.startswith(prefix) for k in self._objects)

    def list(self, path: str) -> List[str]:
        prefix = self._key(path) + "/"
        names = set()
        with self._lock:
            for k in self._objects:
                if k.startswith(prefix):
                    names.add(k[len(prefix):].split("/", 1)[0])
        return sorted(names)

    # -- deletes --------------------------------------------------------------
    def delete(self, path: str) -> None:
        with self._lock:
            self._objects.pop(self._key(path), None)

    def delete_prefix(self, path: str) -> None:
        prefix = self._key(path) + "/"
        with self._lock:
            for k in [k for k in self._objects
                      if k.startswith(prefix) or k == self._key(path)]:
                del self._objects[k]

    def makedirs(self, path: str) -> None:
        pass  # no directories to make: containers are key prefixes
