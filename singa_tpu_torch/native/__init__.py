"""The native planners, the prefetch loader and the StableHLO graph
buffer (counterpart of singa_tpu/native/__init__.py's `GraphPlanner`,
:261-381, its communicator planners, :383-430, `NativeLoader`,
:432-540, and `HloGraphBuilder`, :826-955).

g++ compiles the repository's `native/graph_core.cc`,
`native/comm_core.cc`, `native/dataloader_core.cc` and
`native/hlo_core.cc`, unedited, with `-O2 -shared -fPIC` (the loader
also `-lpthread`) into `build/torch_native/` at the repository root, at
first use, one library each; a library is named by a hash of its source
and the flags, so an edited source is rebuilt on its next use. All are
bound with `ctypes` (the sources' C interfaces: `graph_new`,
`graph_add_node`, `graph_add_edge`, `graph_toposort`,
`graph_plan_memory`, `graph_naive_bytes`, `graph_free`;
`comm_plan_buckets`, `comm_plan_buckets_balanced`,
`comm_ring_schedule`; `loader_new`, `loader_next`, `loader_next_view`,
`loader_release`, `loader_free`; the 28 `hlo_*` functions).

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

`NativeLoader(x, y, batch, seed=, shuffle=, prefetch=, copy=)` keeps
the reference's loader: a background thread gathers shuffled batches of
(float32 x, int32 y) into a ring of `prefetch` host buffers, each epoch
shuffled by `std::shuffle` under `mt19937_64(seed + epoch)`, the last
short batch dropped, forever; a batch larger than the data ends the
iteration at once. `copy=True` yields owned arrays; `copy=False` yields
views into the ring, valid until the next `__next__` or `close` (see the
class). It always calls the library: a missing or refusing g++ raises
`NativeBuildError` (the reference's Python fallback is not kept).
`plain_loader` is the same contract in Python, the plain version the
tests hold the library's coverage and shapes to (it cannot reproduce
libstdc++'s shuffle order).

`HloGraphBuilder()` keeps the reference's methods and return values:
each call records one op node in the C++ buffer and returns its value
id, and `emit(out)` / `emit_multi(outs, n_replicas=)` return the
StableHLO module text the C++ writes (`hlo_bridge` lowers a tape
through it, `hlo_runtime` runs the text). An operand error raises
ValueError with `hlo_last_error`'s message, as the reference's `_chk`
does; a missing or refusing g++ raises `NativeBuildError` (there is no
Python emitter).

`native_call_count()` counts the calls into the libraries (a planner's
graph, each `plan_memory`, each communicator planner, each loader and
each graph buffer made), so a caller can tell that the C++ ran.
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
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["GraphPlanner", "HloGraphBuilder", "NativeBuildError",
           "NativeLoader", "build",
           "native_call_count", "plain_loader", "plan_buckets_balanced",
           "plan_buckets_native", "plan_memory_plain", "ring_schedule",
           "toposort_plain"]

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "graph_core.cc"
COMM_SOURCE = _ROOT / "native" / "comm_core.cc"
LOADER_SOURCE = _ROOT / "native" / "dataloader_core.cc"
HLO_SOURCE = _ROOT / "native" / "hlo_core.cc"
BUILD_DIR = _ROOT / "build" / "torch_native"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
#: what a source links beyond GXX_FLAGS (the loader's worker thread)
LINK_FLAGS = {LOADER_SOURCE.name: ("-lpthread",)}
#: the arena's allocation granularity, as graph_core.cc's kAlign
ALIGN = 256

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_comm_lib: Optional[ctypes.CDLL] = None
_loader_lib: Optional[ctypes.CDLL] = None
_hlo_lib: Optional[ctypes.CDLL] = None
_calls = [0]


class NativeBuildError(RuntimeError):
    """g++ is missing, or it refused a source under `native/`."""


def native_call_count() -> int:
    """Calls made into the library so far in this process."""
    return _calls[0]


def _flags(source: Path) -> Tuple[str, ...]:
    return GXX_FLAGS + LINK_FLAGS.get(source.name, ())


def _target(source: Path) -> Path:
    h = hashlib.sha256(" ".join(_flags(source)).encode())
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
    cmd = [gxx, *GXX_FLAGS, "-o", str(tmp), str(source),
           *LINK_FLAGS.get(source.name, ())]
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


def _load_loader() -> ctypes.CDLL:
    global _loader_lib
    with _lock:
        if _loader_lib is None:
            lib = ctypes.CDLL(str(build(LOADER_SOURCE)))
            i64, p64 = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
            pf, pi = (ctypes.POINTER(ctypes.c_float),
                      ctypes.POINTER(ctypes.c_int32))
            lib.loader_new.restype = i64
            lib.loader_new.argtypes = [pf, pi, i64, i64, i64,
                                       ctypes.c_uint64, ctypes.c_int,
                                       ctypes.c_int, i64]
            lib.loader_next.restype = i64
            lib.loader_next.argtypes = [i64, pf, pi]
            lib.loader_next_view.restype = i64
            lib.loader_next_view.argtypes = [i64, p64,
                                             ctypes.POINTER(pf),
                                             ctypes.POINTER(pi)]
            lib.loader_release.restype = None
            lib.loader_release.argtypes = [i64, i64]
            lib.loader_free.restype = None
            lib.loader_free.argtypes = [i64]
            _loader_lib = lib
        return _loader_lib


def _load_hlo() -> ctypes.CDLL:
    global _hlo_lib
    with _lock:
        if _hlo_lib is None:
            lib = ctypes.CDLL(str(build(HLO_SOURCE)))
            i64, p64 = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
            for fn, nargs in (
                    ("hlo_new", 0), ("hlo_free", 1), ("hlo_dot", 3),
                    ("hlo_add_bias", 3), ("hlo_add", 3), ("hlo_mul", 3),
                    ("hlo_sub", 3), ("hlo_div", 3), ("hlo_relu", 2),
                    ("hlo_tanh", 2), ("hlo_logistic", 2), ("hlo_exp", 2),
                    ("hlo_log", 2), ("hlo_neg", 2), ("hlo_transpose", 2),
                    ("hlo_all_reduce_sum", 3), ("hlo_reduce_scatter_sum", 3),
                    ("hlo_all_gather", 3), ("hlo_select_gt0", 3),
                    ("hlo_reduce", 4), ("hlo_bcast_axis", 4),
                    ("hlo_convert", 3)):
                f = getattr(lib, fn)
                f.restype, f.argtypes = i64, [i64] * nargs
            lib.hlo_param.restype = i64
            lib.hlo_param.argtypes = [i64, p64, i64]
            lib.hlo_param_t.restype = i64
            lib.hlo_param_t.argtypes = [i64, p64, i64, i64]
            lib.hlo_scale.restype = i64
            lib.hlo_scale.argtypes = [i64, i64, ctypes.c_double]
            lib.hlo_emit.restype = i64
            lib.hlo_emit.argtypes = [i64, i64, ctypes.c_char_p, i64]
            lib.hlo_emit_multi.restype = i64
            lib.hlo_emit_multi.argtypes = [i64, p64, i64, i64,
                                           ctypes.c_char_p, i64]
            lib.hlo_last_error.restype = i64
            lib.hlo_last_error.argtypes = [i64, ctypes.c_char_p, i64]
            _hlo_lib = lib
        return _hlo_lib


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


# -- the prefetch loader -----------------------------------------------------


class NativeLoader:
    """Threaded prefetching batcher over (x float32, y int32) arrays in
    C++ (`native/dataloader_core.cc`): iterates forever, each epoch
    reshuffled, e.g. ``itertools.islice(NativeLoader(x, y, 64), steps)``.

    `copy=True` (the default) yields owned arrays, copied out of the
    ring on the consumer's thread. `copy=False` yields zero-copy views
    into the ring, valid until the next `__next__` or `close`; the
    library cannot enforce the contract that comes with them: the
    consumer must be done reading batch k (its host-to-device copy
    finished) before it asks for batch k + 1, or the producer may refill
    the slot under it. A blocking `.to(device)` or a `copy_` into a
    captured step's static input finishes before it returns, as does
    any read of the step's loss. The ring is `std::vector` memory,
    pageable, not pinned (despite the source's header), and this class
    does not register it: a `non_blocking=True` copy from a view is
    staged through CUDA's own pinned buffer before the call returns, and
    is only safe because the memory is pageable.
    """

    def __init__(self, x: np.ndarray, y: np.ndarray, batch: int,
                 seed: int = 0, shuffle: bool = True, prefetch: int = 4,
                 copy: bool = True):
        self._h = None
        self._held = None
        self.copy = bool(copy)
        self.x = np.ascontiguousarray(x, np.float32)
        self.y = np.ascontiguousarray(y, np.int32)
        if self.y.shape != (len(self.x),):
            raise ValueError(f"y of shape {self.y.shape} does not label "
                             f"the {len(self.x)} rows of x")
        self.batch = int(batch)
        if self.batch < 1:
            raise ValueError(f"batch={batch!r} must be >= 1")
        self.item_shape = self.x.shape[1:]
        self.item = int(np.prod(self.item_shape))
        self.seed, self.shuffle = int(seed), bool(shuffle)
        self._lib = _load_loader()
        self._h = self._lib.loader_new(
            self.x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.y.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(self.x), self.item, self.batch, self.seed,
            int(self.shuffle), 1, int(prefetch))
        _calls[0] += 1

    def __iter__(self):
        return self

    def _release_held(self):
        if self._held is not None:
            self._lib.loader_release(self._h, self._held)
            self._held = None

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._h is None:
            raise StopIteration
        if self.copy:
            bx = np.empty((self.batch, self.item), np.float32)
            by = np.empty(self.batch, np.int32)
            n = self._lib.loader_next(
                self._h, bx.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                by.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if n <= 0:
                raise StopIteration
            return bx.reshape((self.batch,) + self.item_shape), by
        self._release_held()
        slot = ctypes.c_int64()
        px = ctypes.POINTER(ctypes.c_float)()
        py = ctypes.POINTER(ctypes.c_int32)()
        n = self._lib.loader_next_view(self._h, ctypes.byref(slot),
                                       ctypes.byref(px), ctypes.byref(py))
        if n <= 0:
            raise StopIteration
        self._held = slot.value
        bx = np.ctypeslib.as_array(px, shape=(int(n), self.item))
        by = np.ctypeslib.as_array(py, shape=(int(n),))
        return bx.reshape((int(n),) + self.item_shape), by

    def close(self) -> None:
        """Stop the worker and free the ring (views die with it)."""
        if self._h is not None:
            self._release_held()
            self._lib.loader_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


def plain_loader(x: np.ndarray, y: np.ndarray, batch: int, seed: int = 0,
                 shuffle: bool = True
                 ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """`NativeLoader`'s contract in Python: endless epochs, epoch e in
    the order `default_rng(seed + e).permutation(n)` (or as stored), the
    last short batch dropped, nothing at all when `batch` exceeds the
    rows; owned (float32, int32) arrays."""
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.int32)
    n, batch = len(x), int(batch)
    epoch = 0
    while batch <= n:
        order = (np.random.default_rng(seed + epoch).permutation(n)
                 if shuffle else np.arange(n))
        for i in range(0, n - n % batch, batch):
            idx = order[i:i + batch]
            yield x[idx], y[idx]
        epoch += 1


# -- the StableHLO graph buffer ------------------------------------------------

#: hlo_core.cc's element-type codes
_DTYPES = {"f32": 0, "bf16": 1}


class HloGraphBuilder:
    """The C++ graph buffer that emits StableHLO (`native/hlo_core.cc`;
    module docstring): op nodes are recorded in C++ through the C
    interface and the module text is written by C++; this side only
    forwards value ids."""

    def __init__(self):
        self._h = -1
        self._lib = _load_hlo()
        self._h = self._lib.hlo_new()
        _calls[0] += 1

    def _chk(self, v: int) -> int:
        if v < 0:
            buf = ctypes.create_string_buffer(512)
            self._lib.hlo_last_error(self._h, buf, 512)
            raise ValueError(
                f"hlo_core: {buf.value.decode() or 'invalid operands'}")
        return int(v)

    def param(self, shape) -> int:
        d = np.asarray(shape, np.int64)
        return self._chk(self._lib.hlo_param(self._h, _ptr(d), len(d)))

    def param_t(self, shape, dtype: str = "f32") -> int:
        d = np.asarray(shape, np.int64)
        return self._chk(self._lib.hlo_param_t(self._h, _ptr(d), len(d),
                                               _DTYPES[dtype]))

    def dot(self, a: int, b: int) -> int:
        return self._chk(self._lib.hlo_dot(self._h, a, b))

    def add_bias(self, a: int, b: int) -> int:
        return self._chk(self._lib.hlo_add_bias(self._h, a, b))

    def add(self, a: int, b: int) -> int:
        return self._chk(self._lib.hlo_add(self._h, a, b))

    def mul(self, a: int, b: int) -> int:
        return self._chk(self._lib.hlo_mul(self._h, a, b))

    def sub(self, a: int, b: int) -> int:
        return self._chk(self._lib.hlo_sub(self._h, a, b))

    def div(self, a: int, b: int) -> int:
        return self._chk(self._lib.hlo_div(self._h, a, b))

    def relu(self, a: int) -> int:
        return self._chk(self._lib.hlo_relu(self._h, a))

    def tanh(self, a: int) -> int:
        return self._chk(self._lib.hlo_tanh(self._h, a))

    def logistic(self, a: int) -> int:
        return self._chk(self._lib.hlo_logistic(self._h, a))

    def exp(self, a: int) -> int:
        return self._chk(self._lib.hlo_exp(self._h, a))

    def log(self, a: int) -> int:
        return self._chk(self._lib.hlo_log(self._h, a))

    def neg(self, a: int) -> int:
        return self._chk(self._lib.hlo_neg(self._h, a))

    def scale(self, a: int, c: float) -> int:
        return self._chk(self._lib.hlo_scale(self._h, a, float(c)))

    def select_gt0(self, x: int, dy: int) -> int:
        return self._chk(self._lib.hlo_select_gt0(self._h, x, dy))

    def reduce_sum(self, a: int, axis: int) -> int:
        return self._chk(self._lib.hlo_reduce(self._h, a, axis, 0))

    def reduce_max(self, a: int, axis: int) -> int:
        return self._chk(self._lib.hlo_reduce(self._h, a, axis, 1))

    def bcast_axis(self, vec: int, like: int, axis: int) -> int:
        return self._chk(self._lib.hlo_bcast_axis(self._h, vec, like, axis))

    def convert(self, a: int, dtype: str) -> int:
        return self._chk(self._lib.hlo_convert(self._h, a, _DTYPES[dtype]))

    def transpose(self, a: int) -> int:
        return self._chk(self._lib.hlo_transpose(self._h, a))

    def all_reduce_sum(self, a: int, n_replicas: int) -> int:
        return self._chk(self._lib.hlo_all_reduce_sum(self._h, a,
                                                      n_replicas))

    def reduce_scatter_sum(self, a: int, n_replicas: int) -> int:
        return self._chk(self._lib.hlo_reduce_scatter_sum(self._h, a,
                                                          n_replicas))

    def all_gather(self, a: int, n_replicas: int) -> int:
        return self._chk(self._lib.hlo_all_gather(self._h, a, n_replicas))

    def emit(self, out: int) -> str:
        n = self._chk(self._lib.hlo_emit(self._h, out, None, 0))
        buf = ctypes.create_string_buffer(n + 1)
        self._chk(self._lib.hlo_emit(self._h, out, buf, n + 1))
        return buf.value.decode()

    def emit_multi(self, outs, n_replicas: int = 1) -> str:
        o = np.asarray(outs, np.int64)
        n = self._chk(self._lib.hlo_emit_multi(self._h, _ptr(o), len(o),
                                               n_replicas, None, 0))
        buf = ctypes.create_string_buffer(n + 1)
        self._chk(self._lib.hlo_emit_multi(self._h, _ptr(o), len(o),
                                           n_replicas, buf, n + 1))
        return buf.value.decode()

    def close(self) -> None:
        if self._h >= 0:
            self._lib.hlo_free(self._h)
            self._h = -1

    def __del__(self):
        if getattr(self, "_h", -1) >= 0:
            self.close()
