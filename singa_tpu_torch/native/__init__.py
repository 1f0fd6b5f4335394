"""The native planners (counterpart of singa_tpu/native/__init__.py's
`GraphPlanner`, :261-381, and its communicator planners, :383-430).

g++ compiles the repository's `native/graph_core.cc` and
`native/comm_core.cc`, unedited, with `-O2 -shared -fPIC` into
`build/torch_native/` at the repository root, at first use, one library
each; a library is named by a hash of its source and the flags, so an
edited source is rebuilt on its next use. Both are bound with `ctypes`
(the sources' C interfaces: `graph_new`, `graph_add_node`,
`graph_add_edge`, `graph_toposort`, `graph_plan_memory`,
`graph_naive_bytes`, `graph_free`; `comm_plan_buckets`,
`comm_plan_buckets_balanced`, `comm_ring_schedule`).

`GraphPlanner` keeps the reference's methods: nodes are ops, edges carry
(buffer id, bytes), `toposort()` is Kahn's algorithm with the lowest id
first among the ready nodes and raises on a cycle, and
`plan_memory(order)` places every buffer in one arena by greedy best fit
over its lifetime and returns (offsets, peak, naive). `toposort_plain`
and `plan_memory_plain` are the same two algorithms in Python: the plain
versions the tests hold the library against, and what a planner made
with `require_native=False` uses when the build fails. Graph mode asks
for the library (`require_native=True`): if g++ is missing or refuses
the source, it raises `NativeBuildError` with the compiler's output.

The communicator planners keep the reference's return shapes:
`plan_buckets_native(sizes, bucket_elems)` packs consecutive gradients
into buckets of at most `bucket_elems` elements (an oversized one alone)
and returns the buckets' index lists; `plan_buckets_balanced(sizes,
n_buckets)` assigns them first-fit-decreasing to the least loaded of
`n_buckets` buckets and returns the non-empty buckets; `ring_schedule(n,
world)` returns the (world - 1, world, 2) array of (start, len) of rank
r's chunk at reduce-scatter step s. They always call the library:
`communicator.plan_buckets` plans every fused all-reduce and ZeRO-1's
overlapped buckets through it, and a missing or refusing g++ raises
`NativeBuildError`; `communicator.plan_buckets_plain` is the plain
version they are held to.

`native_call_count()` counts the calls into the libraries (a planner's
graph, each `plan_memory`, each communicator planner), so a caller can
tell that the C++ ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import heapq
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["GraphPlanner", "NativeBuildError", "build",
           "native_call_count", "plan_buckets_balanced",
           "plan_buckets_native", "plan_memory_plain", "ring_schedule",
           "toposort_plain"]

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "graph_core.cc"
COMM_SOURCE = _ROOT / "native" / "comm_core.cc"
BUILD_DIR = _ROOT / "build" / "torch_native"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
#: the arena's allocation granularity, as graph_core.cc's kAlign
ALIGN = 256

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_comm_lib: Optional[ctypes.CDLL] = None
_calls = [0]


class NativeBuildError(RuntimeError):
    """g++ is missing, or it refused a source under `native/`."""


def native_call_count() -> int:
    """Calls made into the library so far in this process."""
    return _calls[0]


def _target(source: Path) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile `source` (`native/graph_core.cc` by default) unless it is
    built; the library's path."""
    if not source.is_file():
        raise NativeBuildError(f"{source} is missing")
    out = _target(source)
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeBuildError(
            "g++ not found on PATH: the native planners are built from "
            f"{source} on first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [gxx, *GXX_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64, p64 = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
            lib.graph_new.restype, lib.graph_new.argtypes = i64, []
            lib.graph_free.restype, lib.graph_free.argtypes = None, [i64]
            lib.graph_add_node.restype = i64
            lib.graph_add_node.argtypes = [i64]
            lib.graph_add_edge.restype = ctypes.c_int
            lib.graph_add_edge.argtypes = [i64] * 5
            lib.graph_toposort.restype = i64
            lib.graph_toposort.argtypes = [i64, p64]
            lib.graph_plan_memory.restype = i64
            lib.graph_plan_memory.argtypes = [i64, p64, i64, p64, i64]
            lib.graph_naive_bytes.restype = i64
            lib.graph_naive_bytes.argtypes = [i64]
            _lib = lib
        return _lib


def _load_comm() -> ctypes.CDLL:
    global _comm_lib
    with _lock:
        if _comm_lib is None:
            lib = ctypes.CDLL(str(build(COMM_SOURCE)))
            i64, p64 = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
            lib.comm_plan_buckets.restype = i64
            lib.comm_plan_buckets.argtypes = [p64, i64, i64, p64]
            lib.comm_plan_buckets_balanced.restype = i64
            lib.comm_plan_buckets_balanced.argtypes = [p64, i64, i64, p64]
            lib.comm_ring_schedule.restype = None
            lib.comm_ring_schedule.argtypes = [i64, i64, p64]
            _comm_lib = lib
        return _comm_lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


# -- the communicator planners -----------------------------------------------


def _sizes(sizes: Sequence[int]) -> np.ndarray:
    s = np.ascontiguousarray(list(sizes), np.int64)
    if s.ndim != 1:
        raise ValueError(f"sizes must be a flat sequence, got shape {s.shape}")
    return s


def plan_buckets_native(sizes: Sequence[int], bucket_elems: int
                        ) -> List[List[int]]:
    """Consecutive bucketing in C++ (module docstring): each bucket's
    gradient indices."""
    lib = _load_comm()
    s = _sizes(sizes)
    out = np.empty(len(s), np.int64)
    nb = lib.comm_plan_buckets(_ptr(s), len(s), int(bucket_elems), _ptr(out))
    _calls[0] += 1
    buckets: List[List[int]] = [[] for _ in range(int(nb))]
    for i, b in enumerate(out.tolist()):
        buckets[b].append(i)
    return buckets


def plan_buckets_balanced(sizes: Sequence[int], n_buckets: int
                          ) -> List[List[int]]:
    """First-fit-decreasing bucketing over `n_buckets` in C++ (module
    docstring): the non-empty buckets' gradient indices."""
    if int(n_buckets) < 1:
        raise ValueError(f"n_buckets={n_buckets!r} must be >= 1")
    lib = _load_comm()
    s = _sizes(sizes)
    out = np.empty(len(s), np.int64)
    lib.comm_plan_buckets_balanced(_ptr(s), len(s), int(n_buckets),
                                   _ptr(out))
    _calls[0] += 1
    buckets: List[List[int]] = [[] for _ in range(int(n_buckets))]
    for i, b in enumerate(out.tolist()):
        buckets[b].append(i)
    return [b for b in buckets if b]


def ring_schedule(n: int, world: int) -> np.ndarray:
    """The (world - 1, world, 2) array of (start, len) reduce-scatter
    chunks, in C++ (module docstring)."""
    if int(world) < 1 or int(n) < 0:
        raise ValueError(f"ring_schedule needs n >= 0 and world >= 1, got "
                         f"n={n!r}, world={world!r}")
    lib = _load_comm()
    out = np.empty((int(world) - 1) * int(world) * 2, np.int64)
    lib.comm_ring_schedule(int(n), int(world), _ptr(out))
    _calls[0] += 1
    return out.reshape(int(world) - 1, int(world), 2)


# -- the plain versions ------------------------------------------------------


def toposort_plain(n_nodes: int, edges: Sequence[Tuple[int, int, int, int]]
                   ) -> List[int]:
    """Kahn's algorithm, the lowest ready id first; raises ValueError on
    a cycle."""
    adj: List[List[int]] = [[] for _ in range(n_nodes)]
    indeg = [0] * n_nodes
    for s, d, _, _ in edges:
        if s >= 0 and d >= 0:
            adj[s].append(d)
            indeg[d] += 1
    heap = [i for i in range(n_nodes) if indeg[i] == 0]
    heapq.heapify(heap)
    order = []
    while heap:
        u = heapq.heappop(heap)
        order.append(u)
        for v in adj[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                heapq.heappush(heap, v)
    if len(order) < n_nodes:
        raise ValueError("graph has a cycle")
    return order


def plan_memory_plain(edges: Sequence[Tuple[int, int, int, int]],
                      order: Sequence[int], n_buffers: int
                      ) -> Tuple[List[int], int, int]:
    """The arena plan over `order`: a buffer lives from its producer's
    step (0 for a graph input) to its last consumer's (the end for a
    graph output); buffers are placed by start, larger first, each at
    the best-fitting gap among the buffers still live (one whose last
    read is at its first step still counts as live). Returns (offsets by
    buffer id, peak bytes, naive bytes: the sum of all buffers)."""
    step_of = {n: i for i, n in enumerate(order)}
    lives: dict = {}
    for s, d, b, nb in edges:
        st = step_of[s] if s >= 0 else 0
        en = step_of[d] if d >= 0 else len(order)
        life = lives.setdefault(b, [float("inf"), -1, 0])
        life[0], life[1] = min(life[0], st), max(life[1], en)
        life[2] = max(life[2], nb)
    offsets = [-1] * n_buffers
    placed: List[Tuple[int, int, int]] = []
    peak = naive = 0
    for bid, (st, en, nb) in sorted(lives.items(),
                                    key=lambda kv: (kv[1][0], -kv[1][2])):
        need = (nb + ALIGN - 1) // ALIGN * ALIGN
        naive += need
        best, best_waste, cur = -1, float("inf"), 0
        for off, size, _ in sorted((p for p in placed if p[2] >= st),
                                   key=lambda p: p[0]):
            if off - cur >= need and off - cur - need < best_waste:
                best, best_waste = cur, off - cur - need
            cur = max(cur, off + size)
        if best < 0:
            best = cur
        if 0 <= bid < n_buffers:
            offsets[bid] = best
        placed.append((best, need, en))
        peak = max(peak, best + need)
    return offsets, peak, naive


# -- the planner -------------------------------------------------------------


class GraphPlanner:
    """An op graph for ordering and arena accounting: nodes are ops,
    edges (src, dst, buffer, bytes) with -1 for the graph's boundary.
    `require_native=True` raises `NativeBuildError` when the library
    cannot be built; otherwise a failed build leaves the plain
    versions."""

    def __init__(self, require_native: bool = False):
        try:
            self._lib = _load()
        except (NativeBuildError, OSError):
            if require_native:
                raise
            self._lib = None
        self._h = self._lib.graph_new() if self._lib is not None else None
        if self._h is not None:
            _calls[0] += 1
        self._n_nodes = 0
        self._edges: List[Tuple[int, int, int, int]] = []

    @property
    def native(self) -> bool:
        return self._h is not None

    def add_node(self) -> int:
        nid = (self._lib.graph_add_node(self._h) if self._h is not None
               else self._n_nodes)
        self._n_nodes += 1
        return nid

    def add_edge(self, src: int, dst: int, buffer: int, nbytes: int) -> None:
        for v, what in ((src, "src"), (dst, "dst")):
            if not -1 <= v < self._n_nodes:
                raise ValueError(f"{what} {v} is not a node of this graph")
        if buffer < 0 or nbytes < 0:
            raise ValueError("buffer ids and byte counts are >= 0")
        self._edges.append((src, dst, buffer, nbytes))
        if self._h is not None:
            self._lib.graph_add_edge(self._h, src, dst, buffer, nbytes)

    def toposort(self) -> List[int]:
        if self._h is None:
            return toposort_plain(self._n_nodes, self._edges)
        out = np.empty(self._n_nodes, np.int64)
        k = self._lib.graph_toposort(self._h, _ptr(out))
        if k < self._n_nodes:
            raise ValueError("graph has a cycle")
        return out.tolist()

    def plan_memory(self, order: Optional[Sequence[int]] = None
                    ) -> Tuple[List[int], int, int]:
        order = list(self.toposort() if order is None else order)
        if sorted(order) != list(range(self._n_nodes)):
            raise ValueError("order must list every node once")
        n_buffers = 1 + max((e[2] for e in self._edges), default=-1)
        if self._h is None:
            return plan_memory_plain(self._edges, order, n_buffers)
        oarr = np.asarray(order, np.int64)
        offsets = np.full(max(n_buffers, 1), -1, np.int64)
        peak = self._lib.graph_plan_memory(self._h, _ptr(oarr), len(order),
                                           _ptr(offsets), n_buffers)
        naive = self._lib.graph_naive_bytes(self._h)
        _calls[0] += 1
        return offsets[:n_buffers].tolist(), int(peak), int(naive)

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.graph_free(self._h)
