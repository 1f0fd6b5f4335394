"""Atomic sharded checkpoints with a manifest commit protocol
(counterpart of singa_tpu/resilience/checkpoint.py).

What a resilient trainer needs that `Model.save_states` (one zip of
gathered arrays) cannot give:

- **Per-shard files.** Every state leaf (parameter, buffer, optimizer
  slot) is written as its set of DISTINCT shards: a rank holding a tp or
  ZeRO-3 block (`distributed.place_model_states`) writes that block, and
  never the full array. A replicated leaf is written once. The manifest
  holds each leaf's logical shape, dtype and pspec and each shard's
  index, so the full array can be rebuilt anywhere.
- **Commit protocol.** Every object is written atomically through the
  storage driver (`singa_tpu_torch.storage`: write to a temp file,
  fsync, rename on a filesystem; a whole-object put on the ``mem://``
  store); the manifest is written LAST, and the `LATEST` marker, the
  only thing `restore` trusts, swings after it. A kill at any byte
  leaves the previous committed checkpoint or a complete new one.
- **Integrity.** Each shard file carries a crc32 per 1 MiB chunk in the
  manifest; a flipped bit or a truncated file is refused at restore
  (`CorruptCheckpointError`) naming the file and the chunk's offset.
- **Bitwise resume.** The manifest records the step, the generators'
  states (`tensor.get_rng_state`: the host's and each card's, whose
  philox seed and offset a captured step draws from, and under
  ``ranks`` the dropout generator of each rank r > 0 of a distributed
  step, which every rank puts in its shard index and rank 0 merges;
  `autograd.set_rank_generator_states` says what a restore into
  another world does with them) and an opaque
  `data_cursor`; the optimizer's states include the `GradSentinel`'s
  loss-scale scalars. That is what train-k, kill, restore, train-(n-k)
  needs to equal an unbroken n-step run bitwise.
- **Elastic restore.** `restore` reads each leaf into the CURRENT
  model's layout, which may be another mesh than the saving one: a rank
  holding a block reads only the shard files that overlap it and copies
  only the overlapping elements (`_assemble_slice`); a rank holding the
  whole array assembles it from every file. Restore writes into the
  existing parameter, buffer and slot tensors in place (`copy_`), so a
  captured `GraphStep` keeps reading them.

- **Ranks: a two-phase commit.** A process is a rank. With a group of
  more than one, `save` is called by every rank (it is collective
  without running a collective): phase 1, each rank writes only the
  shards it owns (`distributed.shard_owner_map`: the lowest rank holding
  a shard writes it, from the pspec and the mesh alone), its shard
  index `SHARDS-p{i}.json` and its receipt `COMMIT-p{i}`; phase 2, rank
  0 waits for every receipt (a bounded wait, then `TornSaveError`
  naming the missing ranks), merges the indexes into the one manifest
  and swings `LATEST`. The barrier is the storage itself; receipts and
  indexes carry a per-save nonce (`SAVE-NONCE`, chosen by rank 0) so a
  straggler from an earlier torn attempt cannot join; after the swing
  every peer drops `ACK-p{i}` and rank 0 waits for them (bounded,
  non-fatal) before it returns or prunes.

- **Async saves.** ``save(async_=True)`` takes the snapshot, a host copy
  of every owned shard into memory this module owns, synchronised on an
  event before the call returns (a captured step updates the parameters
  and slots in place, and the next replay must not reach the bytes
  being written), under a ``checkpoint.snapshot`` span; the commit
  protocol, verbatim the synchronous one, runs on a background thread
  under ``checkpoint.commit_async`` and the call returns an
  `AsyncSaveHandle`. A failed background commit bumps
  ``ckpt_async_failures`` and re-raises from ``handle.result()``; the
  commit point never moved. Commits under one directory are ordered,
  and at most ONE is in flight: an async save drains its predecessor
  before its snapshot; a synchronous save or `wait_pending(directory)`
  drains the queue; `prune` skips a step dir a commit is still writing.

Counted: ``saves``, ``restores``, ``ckpt_async_saves``,
``ckpt_async_failures``; spans ``checkpoint.write``, ``checkpoint.read``,
``checkpoint.snapshot``, ``checkpoint.commit_async``.

The manifest is the reference's format (`FORMAT`) with its field and
leaf names (``param/<name>``, ``buffer/<name>``, ``opt/<key>``); a
ZeRO-1 or residual state of a group of more than one rank is one
``(world, ...)`` leaf whose row r is rank r's, as the reference stacks
it. Only the ``rng`` entry differs: it holds the port's generator
states, ``{"cpu": [...], "cuda": [[...], ...]}``. A checkpoint either
package wrote restores into the other with ``set_rng=False``.

Layout::

    dir/
      LATEST                  -> "step-00000008" (atomic swing, commit point)
      step-00000008/
        MANIFEST.json         (written last; leaf table + rng + cursor)
        00000-000.bin ...     (one file per distinct shard, crc-chunked)
        SAVE-NONCE            (groups of ranks: the attempt id)
        SHARDS-p1.json ...    (groups of ranks: per-rank shard indexes)
        COMMIT-p1 ...         (groups of ranks: phase-1 receipts)
        ACK-p1 ...            (groups of ranks: commit-observed barrier)
"""

from __future__ import annotations

import copy as _copy
import json
import os
import signal as _signal
import threading
import time
import uuid
import warnings
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from singa_tpu_torch import storage
from singa_tpu_torch.observability import trace
from singa_tpu_torch.resilience import counters

__all__ = ["save", "restore", "latest_step_dir", "read_manifest",
           "prune", "CheckpointError", "CorruptCheckpointError",
           "TornSaveError", "PreemptionGuard", "AsyncSaveHandle",
           "wait_pending", "pspec_to_json", "pspec_from_json"]

FORMAT = "singa-tpu-ckpt-v1"
MANIFEST = "MANIFEST.json"
LATEST = "LATEST"
SAVE_NONCE = "SAVE-NONCE"

#: crc granularity: a flipped bit is localized to a <=1 MiB offset range
CHUNK_BYTES = 1 << 20

#: how long the two-phase commit waits for its peers (rank 0 for the
#: phase-1 receipts, the others for the committed manifest) before
#: declaring the save torn; `save(receipt_timeout_s=)` overrides
RECEIPT_TIMEOUT_S = 600.0
_POLL_S = 0.05

#: test seam (faults.kill_at_phase): called with "snapshot" after the
#: device->host snapshot but before ANY storage write, "shard_writes"
#: after a rank wrote its shard files but BEFORE its receipt,
#: "receipts" after rank 0 observed every receipt but before the
#: manifest, and "manifest" after the manifest but before the LATEST
#: swing (for an async save every phase after "snapshot" fires on the
#: background commit thread)
_phase_hook: Optional[Callable[[str], None]] = None


def _phase(name: str) -> None:
    if _phase_hook is not None:
        _phase_hook(name)


class CheckpointError(RuntimeError):
    """No committed checkpoint / structural mismatch with this run."""


class CorruptCheckpointError(CheckpointError):
    """A shard file failed its integrity check: refused, never loaded."""


class TornSaveError(CheckpointError):
    """A two-phase save over ranks could not commit (a peer never wrote
    its receipt, or the committing rank died before the manifest or the
    LATEST swing). The previous committed checkpoint is untouched."""


# -- pspec (de)serialization -------------------------------------------------


def pspec_to_json(spec) -> List:
    """Tensor pspec -> JSON: None -> null, axis -> str, joint tuple ->
    list."""
    out = []
    for entry in (spec or ()):
        if isinstance(entry, (tuple, list)):
            out.append(list(entry))
        else:
            out.append(entry)
    return out


def pspec_from_json(ent) -> Tuple:
    return tuple(
        tuple(e) if isinstance(e, list) else e for e in (ent or ()))


# -- dtypes and bytes ----------------------------------------------------------

#: the manifest's dtype names (numpy's, as the reference writes them)
_DTYPES = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
    torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
}
_BY_NAME = {v: k for k, v in _DTYPES.items()}


def _dtype_name(dt: torch.dtype) -> str:
    try:
        return _DTYPES[dt]
    except KeyError:
        raise CheckpointError(f"no checkpoint dtype for {dt}") from None


def _torch_dtype(name: str) -> torch.dtype:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise CheckpointError(
            f"checkpoint dtype {name!r} has no torch counterpart") from None


def _as_bytes(host: torch.Tensor) -> memoryview:
    """A contiguous host tensor's bytes, without a copy."""
    return memoryview(host.reshape(-1).view(torch.uint8).numpy())


def _from_bytes(data: bytes, name: str, shape) -> torch.Tensor:
    """A read-only view of `data` as a tensor (it is copied into its
    target, never written)."""
    dt = _torch_dtype(name)
    if not data:
        return torch.empty(tuple(shape), dtype=dt)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # not writable
        flat = torch.frombuffer(data, dtype=torch.uint8)
    return flat.view(dt).reshape(tuple(shape))


# -- low-level atomic IO (driver-routed) --------------------------------------


def _write_atomic(path: str, data) -> None:
    """Atomic whole-object write through the owning storage driver:
    readers see the old bytes or the complete new bytes."""
    storage.get_driver(path).put_atomic(path, data)


def _dir_key(directory: str) -> str:
    """The per-directory identity the async-ordering and in-flight
    registries key on (absolute for filesystem paths, verbatim for
    schemed keys)."""
    return directory if "://" in directory else os.path.abspath(directory)


#: step dirs a commit (sync or background) is writing into, per
#: directory: `prune` never deletes one (a background commit's dir looks
#: torn until its manifest lands)
_inflight_lock = threading.Lock()
_inflight: Dict[str, set] = {}


def _inflight_add(directory: str, step_name: str) -> None:
    with _inflight_lock:
        _inflight.setdefault(_dir_key(directory), set()).add(step_name)


def _inflight_remove(directory: str, step_name: str) -> None:
    with _inflight_lock:
        _inflight.get(_dir_key(directory), set()).discard(step_name)


def _inflight_names(directory: str) -> set:
    with _inflight_lock:
        return set(_inflight.get(_dir_key(directory), ()))


# -- how each leaf lies over the ranks --------------------------------------------


class _Layout:
    """A leaf's logical `shape`, its `table` {bounds: owner rank} of
    distinct shards, and `mine`, the bounds of the shard this rank
    holds (its local tensor, reshaped)."""

    __slots__ = ("shape", "table", "mine")

    def __init__(self, shape, table=None, mine=None):
        self.shape = tuple(int(d) for d in shape)
        full = tuple((0, d) for d in self.shape)
        self.table = table if table is not None else {full: 0}
        self.mine = mine if mine is not None else full


def _placed_layout(placed) -> _Layout:
    from singa_tpu_torch import distributed

    full, spec, mesh = placed
    return _Layout(full, distributed.owner_table(
        full, spec, mesh.axis_names, mesh.dims, mesh.ranks),
        distributed.mesh_block_bounds(full, spec, mesh))


def _comm_of(optimizer):
    """(mesh, axis, world) of a DistOpt's group when it has more than
    one rank, else None."""
    comm = getattr(optimizer, "comm", None)
    if comm is None or not comm._active() or comm.world_size <= 1:
        return None
    return comm.mesh, comm.axis_name, comm.world_size


def _opt_layout(key: str, local: torch.Tensor, by_name, group,
                raw: bool) -> _Layout:
    """The layout of the optimizer state `key` whose local tensor is
    `local`: a per-rank state (raw ZeRO-1 row, residual) of a group of
    more than one rank is a `(world, ...)` leaf split over the comm
    axis; a slot of a placed parameter has the parameter's layout; the
    rest (scalars, slots of whole parameters, canonical forms) is one
    replicated leaf."""
    from singa_tpu_torch import distributed
    from singa_tpu_torch.communicator import is_per_chip_state_key

    if raw and group is not None and is_per_chip_state_key(key):
        mesh, axis, world = group
        rest = tuple(local.shape[1:]) if "//__zshard__" in key \
            else tuple(local.shape)
        full = (world,) + rest
        spec = (axis,) + (None,) * len(rest)
        return _Layout(full, distributed.owner_table(
            full, spec, mesh.axis_names, mesh.dims, mesh.ranks),
            distributed.mesh_block_bounds(full, spec, mesh))
    p = by_name.get(key.rpartition("//")[0])
    placed = getattr(p, "placed", None)
    if placed is not None and tuple(local.shape) == tuple(p.shape) \
            and local.dim() >= len(placed[1]):
        return _placed_layout(placed)
    return _Layout(local.shape)


def _collect_leaves(model, optimizer, opt_states=None
                    ) -> List[Tuple[str, torch.Tensor, Tuple, _Layout]]:
    """(name, local tensor, pspec, layout) for every state leaf, named
    param/ buffer/ opt/ so restore routes them without guessing. The
    optimizer states' pspecs are `communicator.opt_state_pspec`'s. An
    explicit `opt_states` (`utils.checkpoint`'s canonical,
    world-independent form) replaces `optimizer.dump_states()`."""
    from singa_tpu_torch.communicator import opt_state_pspec

    leaves = []
    params = model.get_params()
    for n, t in params.items():
        placed = getattr(t, "placed", None)
        lay = _placed_layout(placed) if placed else _Layout(t.shape)
        leaves.append((f"param/{n}", t.detach(), tuple(
            getattr(t, "pspec", None) or ()), lay))
    for n, t in model.get_buffers().items():
        placed = getattr(t, "placed", None)
        lay = _placed_layout(placed) if placed else _Layout(t.shape)
        leaves.append((f"buffer/{n}", t.detach(), tuple(
            getattr(t, "pspec", None) or ()), lay))
    if opt_states is None and optimizer is None:
        return leaves
    raw = opt_states is None
    states = optimizer.dump_states() if raw else opt_states
    group = _comm_of(optimizer)
    params_pspec = {n: tuple(getattr(t, "pspec", None) or ())
                    for n, t in params.items()}
    axis = getattr(getattr(optimizer, "comm", None), "axis_name", None)
    for k, v in states.items():
        v = torch.as_tensor(v).detach()
        spec = opt_state_pspec(k, params_pspec, axis, v.dim()) if raw \
            else ()
        leaves.append((f"opt/{k}", v, spec,
                       _opt_layout(k, v, params, group, raw)))
    return leaves


# -- save --------------------------------------------------------------------


def _host(t: torch.Tensor, shape, copy: bool) -> torch.Tensor:
    """`t` as a contiguous host tensor of `shape`: on the card a copy
    into fresh host memory (enqueued; the caller synchronises before it
    reads it), on the CPU a view, or a copy with `copy`."""
    if t.device.type == "cpu":
        out = t.clone() if copy else t.contiguous()
        return out.reshape(shape)
    out = torch.empty(tuple(t.shape), dtype=t.dtype, device="cpu")
    out.copy_(t, non_blocking=True)
    return out.reshape(shape)


def _snapshot_owned(model, optimizer, opt_states, pidx: int, *,
                    copy: bool = False):
    """The device->host SNAPSHOT: host copies of every shard THIS rank
    owns, with the global leaf metadata, yielded ONE LEAF AT A TIME so
    the synchronous path streams (each leaf's shards are written and
    dropped before the next is copied). The async path materializes it
    (`list`) with ``copy=True``: every shard goes to fresh host memory,
    and `_snapshot_list` waits for the copies before it returns."""
    for i, (name, t, pspec, lay) in enumerate(
            _collect_leaves(model, optimizer, opt_states=opt_states)):
        owned = []
        for j, bounds in enumerate(sorted(lay.table)):
            if lay.table[bounds] != pidx:
                continue
            if bounds != lay.mine:
                raise CheckpointError(
                    f"save: leaf {name!r} shard {bounds} is owned by "
                    f"rank {pidx}, which holds {lay.mine}: inconsistent "
                    f"placement metadata")
            shape = tuple(b - a for a, b in bounds)
            owned.append((j, [list(b) for b in bounds],
                          _host(t, shape, copy)))
        yield {
            "name": name,
            "shape": list(lay.shape),
            "dtype": _dtype_name(t.dtype),
            "pspec": pspec_to_json(pspec),
            "ordinal": i,
            "owned": owned,
        }


def _snapshot_list(model, optimizer, opt_states, pidx: int) -> List[Dict]:
    """The whole snapshot in host memory this module owns, complete when
    it returns: the copies are enqueued on the current stream, which a
    captured step's next replay waits for, and an event on that stream
    is waited on here, so no later step can reach these bytes."""
    snap = list(_snapshot_owned(model, optimizer, opt_states, pidx,
                                copy=True))
    for dev in {p.device for p in model.parameters() if p.is_cuda}:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()
    return snap


#: shard files written at once by a commit (crc32 and the file writes
#: release the interpreter lock); also the most leaves of host copies a
#: streaming sync save holds
WRITERS = 4


def _write_shard(step_dir: str, fname: str, idx, host: torch.Tensor
                 ) -> Dict:
    """One shard file, written atomically, and its manifest entry."""
    buf = _as_bytes(host)
    crcs = [zlib.crc32(buf[o:o + CHUNK_BYTES])
            for o in range(0, len(buf), CHUNK_BYTES)] or [zlib.crc32(b"")]
    _write_atomic(storage.join(step_dir, fname), buf)
    return {
        "file": fname,
        "index": idx,
        "shard_shape": list(host.shape),
        "nbytes": len(buf),
        "chunk_bytes": CHUNK_BYTES,
        "crc32": crcs,
    }


def _write_snapshot_shards(step_dir: str, snapshot) -> List[Dict]:
    """Phase 1 of the commit: write (atomically, durably) every shard
    file in `snapshot`, `WRITERS` at once, returning the leaf table whose
    shard lists hold only the owned entries (the whole table on one
    rank; each rank's share over a group, which rank 0 merges). A leaf
    is taken from `snapshot` only while fewer than `WRITERS` leaves are
    being written, so a streaming snapshot holds that many at most."""
    from concurrent.futures import ThreadPoolExecutor

    leaves, pending = [], []
    with ThreadPoolExecutor(WRITERS) as pool:
        for leaf in snapshot:
            if len(pending) >= WRITERS:
                for f in pending.pop(0):
                    f.result()
            futs = [pool.submit(_write_shard, step_dir,
                                f"{leaf['ordinal']:05d}-{j:03d}.bin", idx,
                                host)
                    for j, idx, host in leaf["owned"]]
            pending.append(futs)
            leaves.append(({k: leaf[k] for k in ("name", "shape", "dtype",
                                                  "pspec")}, futs))
        return [dict(meta, shape=list(meta["shape"]),
                     shards=[f.result() for f in futs])
                for meta, futs in leaves]


def _rng_json(state):
    """The generators' state as JSON (lists of ints)."""
    if isinstance(state, dict):
        return {k: _rng_json(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [_rng_json(v) for v in state]
    return np.asarray(state).tolist()


def _commit_manifest(directory: str, step_dir: str, step_name: str,
                     leaves_meta: List[Dict], *, step: int, data_cursor,
                     rng_state, meta, processes: int) -> None:
    """Phase 2: the manifest (written after every shard is durable),
    then the `LATEST` swing: the commit point."""
    manifest = {
        "format": FORMAT,
        "step": step,
        "data_cursor": data_cursor,
        "rng": _rng_json(rng_state),
        "meta": meta,
        "processes": processes,
        "leaves": leaves_meta,
    }
    _write_atomic(storage.join(step_dir, MANIFEST),
                  json.dumps(manifest, indent=1).encode())
    _phase("manifest")
    _write_atomic(storage.join(directory, LATEST), step_name.encode())


def _wait_for(predicate, timeout_s: float, poll_s: float = _POLL_S):
    """Poll `predicate` until it returns non-None or `timeout_s` passed;
    None means timed out. The two-phase commit's only wait: storage
    state, bounded, no collective."""
    t0 = time.monotonic()
    while True:
        got = predicate()
        if got is not None:
            return got
        if time.monotonic() - t0 > timeout_s:
            return None
        time.sleep(poll_s)


def _read_text(path: str) -> Optional[str]:
    data = storage.get_driver(path).read(path)
    return None if data is None else data.decode().strip()


def _merge_leaf_tables(step_dir: str, nonce: str, own: List[Dict],
                       pcount: int) -> List[Dict]:
    """Merge every rank's `SHARDS-p{j}.json` into the one manifest leaf
    table: leaf metadata from rank 0's own, shard lists concatenated
    (ownership partitions them) and sorted by file name. Each index must
    carry THIS save's nonce and the merged shards must tile every leaf;
    either violation is a `TornSaveError` raised BEFORE the manifest
    exists."""
    merged = [dict(leaf, shards=list(leaf["shards"])) for leaf in own]
    for j in range(1, pcount):
        body = json.loads(_read_text(
            storage.join(step_dir, f"SHARDS-p{j}.json")) or "{}")
        if body.get("nonce") != nonce:
            raise TornSaveError(
                f"two-phase save {step_dir!r}: rank {j}'s shard "
                f"index carries nonce {body.get('nonce')!r}, this "
                f"attempt is {nonce!r}: a stale straggler; not "
                f"committing")
        for leaf, other in zip(merged, body.get("leaves", ())):
            if other["name"] != leaf["name"]:
                raise TornSaveError(
                    f"two-phase save {step_dir!r}: rank {j} saved "
                    f"leaf {other['name']!r} where rank 0 has "
                    f"{leaf['name']!r}: divergent models across "
                    f"ranks; not committing")
            leaf["shards"].extend(other["shards"])
    for leaf in merged:
        leaf["shards"].sort(key=lambda sh: sh["file"])
        size = int(np.prod([int(d) for d in leaf["shape"]]))
        covered = sum(int(np.prod([int(b) - int(a)
                                   for a, b in sh["index"]]))
                      for sh in leaf["shards"])
        if covered != max(1, size):
            raise TornSaveError(
                f"two-phase save {step_dir!r}: merged shard files "
                f"cover {covered} of leaf {leaf['name']!r}'s "
                f"{size} elements: the per-rank indexes do not "
                f"tile the leaf; not committing")
    return merged


def _rank_rng(rng_state) -> List:
    return (rng_state.get("ranks", []) if isinstance(rng_state, dict)
            else [])


def _merge_rank_rng(step_dir: str, rng_state, pcount: int):
    """Rank 0's `rng` with every rank's rank generators
    (`SHARDS-p{j}.json`'s "rng_ranks"): one entry per rank and device
    type, the first writer's where two ranks draw one stream
    (tensor-parallel peers, each on a card of its own)."""
    if not isinstance(rng_state, dict):
        return rng_state
    entries = {}
    bodies = [{"rng_ranks": _rng_json(_rank_rng(rng_state))}] + [
        json.loads(_read_text(storage.join(
            step_dir, f"SHARDS-p{j}.json")) or "{}")
        for j in range(1, pcount)]
    for body in bodies:
        for e in body.get("rng_ranks", ()):
            entries.setdefault(
                (int(e["rank"]), torch.device(e["device"]).type), e)
    merged = dict(rng_state)
    merged.pop("ranks", None)
    if entries:
        merged["ranks"] = [entries[k] for k in sorted(entries)]
    return merged


class AsyncSaveHandle:
    """The in-flight half of a ``save(async_=True)``: the snapshot is
    taken (the step path is free), the commit runs on a background
    thread. ``result()`` blocks for the committed step dir and re-raises
    anything the background commit raised; a failed commit never moved
    the commit point."""

    def __init__(self, directory: str, step: int):
        self.directory = str(directory)
        self.step = int(step)
        self._done = threading.Event()
        self._step_dir: Optional[str] = None
        self._exc: Optional[BaseException] = None

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the background commit finished (either way);
        returns whether it did within `timeout`."""
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> str:
        if not self._done.wait(timeout):
            raise TornSaveError(
                f"async save of step {self.step} under "
                f"{self.directory!r} did not finish within "
                f"{timeout}s: still committing in the background")
        if self._exc is not None:
            raise self._exc
        return self._step_dir  # type: ignore[return-value]

    def _finish(self, step_dir: Optional[str],
                exc: Optional[BaseException]) -> None:
        self._step_dir = step_dir
        self._exc = exc
        self._done.set()


#: the newest pending async save per directory: the ordering chain and
#: the drain point of `wait_pending` and a synchronous save
_pending_lock = threading.Lock()
_pending: Dict[str, AsyncSaveHandle] = {}


def wait_pending(directory: str,
                 timeout: Optional[float] = None) -> bool:
    """Drain any in-flight async save under `directory` (its outcome
    ignored: a failed commit left the previous checkpoint committed).
    Returns whether the directory is drained: False means the timeout
    elapsed with the commit still running."""
    with _pending_lock:
        handle = _pending.get(_dir_key(directory))
    if handle is None:
        return True
    return handle.wait(timeout)


def _group() -> Tuple[int, int]:
    """(ranks in the process group, this rank): (1, 0) without one."""
    from singa_tpu_torch import distributed

    pcount = int(distributed.process_count())
    return pcount, int(distributed.process_index()) if pcount > 1 else 0


def save(directory: str, model, optimizer=None, *, step: int = 0,
         data_cursor=None, rng_state=None, opt_states=None,
         meta=None, receipt_timeout_s: Optional[float] = None,
         async_: bool = False):
    """Write a committed checkpoint of (model, optimizer, step, rng,
    data_cursor) under `directory`; returns the committed step dir.

    Atomic end to end (module docstring): shard files first, the
    manifest next, the `LATEST` marker last. `rng_state` defaults to
    `tensor.get_rng_state()`. `opt_states` replaces
    `optimizer.dump_states()` with an explicit state dict (the
    `utils.checkpoint` canonical form); `meta` is a JSON-able dict kept
    in the manifest and handed back by `read_manifest` / `restore`.

    With ``async_=True`` only the device->host snapshot runs here; the
    call returns an `AsyncSaveHandle` and the same commit runs on a
    background thread (``handle.result()`` for the step dir,
    `wait_pending(directory)` to drain). `directory` is any
    `singa_tpu_torch.storage` path.

    In a process group of more than one rank every rank calls it with
    the same arguments: each writes the shards it owns and a receipt,
    and rank 0 commits the merged manifest; `receipt_timeout_s`
    (default `RECEIPT_TIMEOUT_S`) bounds each rank's wait for its peers
    before `TornSaveError`."""
    if async_:
        return _save_impl(directory, model, optimizer, step=step,
                          data_cursor=data_cursor, rng_state=rng_state,
                          opt_states=opt_states, meta=meta,
                          receipt_timeout_s=receipt_timeout_s,
                          async_=True)
    with trace.span("checkpoint.write", step=int(step)):
        return _save_impl(directory, model, optimizer, step=step,
                          data_cursor=data_cursor, rng_state=rng_state,
                          opt_states=opt_states, meta=meta,
                          receipt_timeout_s=receipt_timeout_s)


def _save_impl(directory: str, model, optimizer=None, *, step: int = 0,
               data_cursor=None, rng_state=None, opt_states=None,
               meta=None, receipt_timeout_s: Optional[float] = None,
               async_: bool = False):
    pcount, pidx = _group()
    if rng_state is None:
        from singa_tpu_torch import tensor as tensor_module

        rng_state = tensor_module.get_rng_state()
    if opt_states is None and optimizer is not None:
        # raw ZeRO-1 slots load only under the SAME shard layout: stamp
        # the saving run's so restore refuses a mismatch
        layout_fn = getattr(optimizer, "zero1_layout", None)
        layout = layout_fn() if layout_fn is not None else None
        if layout is not None:
            meta = dict(meta or {})
            meta.setdefault("zero1_layout", layout)
    step = int(step)
    timeout_s = (RECEIPT_TIMEOUT_S if receipt_timeout_s is None
                 else float(receipt_timeout_s))
    if not async_:
        # an earlier async commit lands first (commits are ordered);
        # the sync path streams: one leaf's host copies alive at a time
        wait_pending(directory)
        _phase("snapshot")  # nothing written yet
        step_dir, step_name = _probe_step_dir(directory, step)
        try:
            return _commit_snapshot(
                directory,
                lambda: _snapshot_owned(model, optimizer, opt_states,
                                        pidx),
                step_dir=step_dir, step_name=step_name,
                pidx=pidx, pcount=pcount, step=step,
                data_cursor=data_cursor, rng_state=rng_state,
                meta=meta, timeout_s=timeout_s)
        finally:
            _inflight_remove(directory, step_name)

    # backpressure: at most one in-flight commit per directory (each
    # snapshot is a full host image of the states)
    wait_pending(directory)
    rng_state = _copy.deepcopy(_rng_json(rng_state))
    data_cursor = _copy.deepcopy(data_cursor)
    meta = _copy.deepcopy(meta)
    with trace.span("checkpoint.snapshot", step=step, background=True):
        snapshot = _snapshot_list(model, optimizer, opt_states, pidx)
    _phase("snapshot")
    # probed and registered in flight on the caller's thread, so a prune
    # issued the instant save() returns already sees it
    bg_step_dir, bg_step_name = _probe_step_dir(directory, step)
    handle = AsyncSaveHandle(directory, step)
    with _pending_lock:
        prev = _pending.get(_dir_key(directory))
        _pending[_dir_key(directory)] = handle

    def _commit_in_background() -> None:
        step_dir, exc = None, None
        try:
            if prev is not None:
                prev.wait()  # the predecessor's commit point moves first
            with trace.span("checkpoint.commit_async", step=step):
                step_dir = _commit_snapshot(
                    directory, lambda: snapshot,
                    step_dir=bg_step_dir, step_name=bg_step_name,
                    pidx=pidx, pcount=pcount, step=step,
                    data_cursor=data_cursor,
                    rng_state=rng_state, meta=meta,
                    timeout_s=timeout_s)
            counters.bump("ckpt_async_saves")
        except BaseException as e:  # surfaced via handle.result()
            exc = e
            counters.bump("ckpt_async_failures")
        finally:
            _inflight_remove(directory, bg_step_name)
            with _pending_lock:
                if _pending.get(_dir_key(directory)) is handle:
                    del _pending[_dir_key(directory)]
            handle._finish(step_dir, exc)

    try:
        threading.Thread(target=_commit_in_background,
                         name=f"ckpt-commit-{step}",
                         daemon=True).start()
    except BaseException as e:
        # the handle is registered: leaving it unfinished would hang
        # every later wait_pending
        _inflight_remove(directory, bg_step_name)
        with _pending_lock:
            if _pending.get(_dir_key(directory)) is handle:
                del _pending[_dir_key(directory)]
        handle._finish(None, e)
        raise
    return handle


def _probe_step_dir(directory: str, step: int):
    """Pick (and create) the step dir for a save and register it in
    flight for `prune`. Never reuses a COMMITTED step dir: a same-step
    re-save gets a fresh ".rK" dir (rewriting shard files under the old
    manifest's crcs would tear the only committed checkpoint on a kill);
    a manifest-less leftover is reused. Every rank of a group sees the
    same committed set (a manifest commits only at the end of a joined
    save), so they pick the same dir."""
    drv = storage.get_driver(directory)
    step_name = f"step-{step:08d}"
    k = 0
    while drv.exists(storage.join(directory, step_name, MANIFEST)):
        k += 1
        step_name = f"step-{step:08d}.r{k}"
    step_dir = storage.join(directory, step_name)
    drv.makedirs(step_dir)
    _inflight_add(directory, step_name)
    return step_dir, step_name


def _commit_snapshot(directory: str, snapshot_fn, *, step_dir: str,
                     step_name: str, pidx: int, pcount: int,
                     step: int, data_cursor, rng_state, meta,
                     timeout_s: float) -> str:
    """The storage half of a save, after the snapshot and the
    `_probe_step_dir` prologue: write the shard files, run the commit
    (two-phase over a group). `snapshot_fn` yields a fresh iterable of
    snapshot leaves per call."""
    if pcount == 1:
        leaves_meta = _write_snapshot_shards(step_dir, snapshot_fn())
        _phase("shard_writes")
        _commit_manifest(directory, step_dir, step_name,
                         leaves_meta, step=step,
                         data_cursor=data_cursor,
                         rng_state=rng_state, meta=meta,
                         processes=1)
        counters.bump("saves")
        return step_dir
    _save_two_phase(directory, step_dir, step_name, snapshot_fn,
                    pidx=pidx, pcount=pcount, step=step,
                    data_cursor=data_cursor, rng_state=rng_state,
                    meta=meta, timeout_s=timeout_s)
    counters.bump("saves")
    return step_dir


def _save_two_phase(directory: str, step_dir: str, step_name: str,
                    snapshot_fn, *, pidx: int,
                    pcount: int, step: int, data_cursor, rng_state,
                    meta, timeout_s: float) -> None:
    """The commit over ranks (module docstring). Rank 0 picks the
    attempt nonce; every rank runs phase 1 (owned shards, shard index,
    receipt, all stamped with the nonce); rank 0 waits for the receipts,
    merges and commits; the others wait for the commit. A rank that
    finds the nonce MOVED while waiting redoes phase 1 (it had joined a
    superseded attempt); shard file names are deterministic and writes
    atomic, so the redo converges."""
    nonce_path = storage.join(step_dir, SAVE_NONCE)
    if pidx == 0:
        nonce = uuid.uuid4().hex
        _write_atomic(nonce_path, nonce.encode())
    else:
        nonce = _wait_for(lambda: _read_text(nonce_path), timeout_s)
        if nonce is None:
            raise TornSaveError(
                f"two-phase save {step_dir!r}: rank 0 never "
                f"published {SAVE_NONCE} within {timeout_s:.0f}s: "
                f"missing ranks: [0]; the previous committed "
                f"checkpoint is untouched")

    while True:
        # a committed manifest here means this rank joined a stale
        # attempt: writing would replace shard files under its crcs
        if storage.get_driver(step_dir).exists(
                storage.join(step_dir, MANIFEST)):
            raise TornSaveError(
                f"two-phase save: {step_dir!r} already holds a "
                f"committed manifest: this rank joined a stale "
                f"attempt; nothing was written, retry the save")
        leaves_meta = _write_snapshot_shards(step_dir, snapshot_fn())
        _phase("shard_writes")
        _write_atomic(
            storage.join(step_dir, f"SHARDS-p{pidx}.json"),
            json.dumps({"process": pidx, "nonce": nonce,
                        "leaves": leaves_meta,
                        "rng_ranks": _rng_json(_rank_rng(rng_state))},
                       indent=1).encode())
        _write_atomic(storage.join(step_dir, f"COMMIT-p{pidx}"),
                      nonce.encode())

        if pidx == 0:
            def missing():
                return [j for j in range(1, pcount)
                        if _read_text(storage.join(
                            step_dir, f"COMMIT-p{j}")) != nonce]

            if _wait_for(lambda: True if not missing() else None,
                         timeout_s) is None:
                raise TornSaveError(
                    f"two-phase save {step_dir!r}: no phase-1 receipt "
                    f"from rank(s) {missing()} within "
                    f"{timeout_s:.0f}s: not committing; the previous "
                    f"committed checkpoint is untouched")
            _phase("receipts")
            merged = _merge_leaf_tables(step_dir, nonce, leaves_meta,
                                        pcount)
            _commit_manifest(directory, step_dir, step_name, merged,
                             step=step, data_cursor=data_cursor,
                             rng_state=_merge_rank_rng(
                                 step_dir, rng_state, pcount),
                             meta=meta, processes=pcount)
            # committed: retire the attempt gate
            storage.get_driver(nonce_path).delete(nonce_path)

            # exit barrier (bounded, non-fatal): rank 0 does not return,
            # exit or prune while a peer still reads the new LATEST
            def acks():
                return True if all(
                    _read_text(storage.join(
                        step_dir, f"ACK-p{j}")) == nonce
                    for j in range(1, pcount)) else None

            _wait_for(acks, timeout_s)
            return

        def committed_or_moved():
            if _read_text(storage.join(directory, LATEST)) == step_name:
                return ("committed", nonce)
            cur = _read_text(nonce_path)
            if cur is not None and cur != nonce:
                return ("moved", cur)
            return None

        got = _wait_for(committed_or_moved, timeout_s)
        if got is None:
            raise TornSaveError(
                f"two-phase save {step_dir!r}: rank 0 never "
                f"committed the merged manifest within "
                f"{timeout_s:.0f}s (receipt from rank {pidx} was "
                f"written): the previous committed checkpoint is "
                f"untouched")
        state, cur = got
        if state == "committed":
            _write_atomic(storage.join(step_dir, f"ACK-p{pidx}"),
                          nonce.encode())
            return
        nonce = cur  # a superseded attempt: redo phase 1


# -- restore -----------------------------------------------------------------


def latest_step_dir(directory: str) -> str:
    """The committed step dir `restore` would use; CheckpointError when
    the directory holds no committed checkpoint."""
    drv = storage.get_driver(directory)
    step_name = _read_text(storage.join(directory, LATEST))
    if step_name is None:
        raise CheckpointError(
            f"no committed checkpoint under {directory!r} (no {LATEST} "
            f"marker: a torn save never swings it)")
    step_dir = storage.join(directory, step_name)
    if not drv.exists(storage.join(step_dir, MANIFEST)):
        raise CheckpointError(
            f"checkpoint {step_dir!r} has no {MANIFEST}: the commit "
            f"marker points at an incomplete save")
    return step_dir


def _committed_step_dir(directory: str, step: int) -> str:
    """The committed dir for an explicit step: `step-XXXXXXXX` or a
    same-step re-save `step-XXXXXXXX.rK` (the LATEST-named one when it
    matches, else the highest K)."""
    drv = storage.get_driver(directory)
    base = f"step-{step:08d}"
    latest = _read_text(storage.join(directory, LATEST))

    def committed(name: str) -> bool:
        return drv.exists(storage.join(directory, name, MANIFEST))

    if latest is not None and (
            latest == base or latest.startswith(base + ".r")) \
            and committed(latest):
        return storage.join(directory, latest)
    cands = []
    for name in drv.list(directory):
        if name == base and committed(name):
            cands.append((0, name))
        elif name.startswith(base + ".r") and committed(name):
            try:
                cands.append((int(name[len(base) + 2:]), name))
            except ValueError:
                continue
    if not cands:
        raise CheckpointError(
            f"no committed checkpoint for step {step} under "
            f"{directory!r}")
    return storage.join(directory, max(cands)[1])


def _read_shard(step_dir: str, leaf: Dict, sh: Dict,
                cache: Dict) -> torch.Tensor:
    """The crc-verified host tensor of ONE shard file; corruption is
    refused naming the file and the chunk's byte offset. `cache` (per
    leaf, per restore) reads a file once when several target slices
    overlap it."""
    got = cache.get(sh["file"])
    if got is not None:
        return got
    path = storage.join(step_dir, sh["file"])
    data = storage.get_driver(path).read(path)
    if data is None:
        raise CorruptCheckpointError(
            f"checkpoint shard missing: {path} (leaf "
            f"{leaf['name']!r})")
    if len(data) != sh["nbytes"]:
        raise CorruptCheckpointError(
            f"checkpoint refused: {path} is {len(data)} bytes, "
            f"manifest says {sh['nbytes']} (truncated/torn write): "
            f"leaf {leaf['name']!r}")
    chunk = int(sh["chunk_bytes"])
    view = memoryview(data)
    for ci, crc in enumerate(sh["crc32"]):
        seg = view[ci * chunk:(ci + 1) * chunk]
        if zlib.crc32(seg) != crc:
            raise CorruptCheckpointError(
                f"checkpoint refused: {path} fails its crc32 at "
                f"byte offset {ci * chunk} (chunk of {len(seg)} "
                f"bytes): leaf {leaf['name']!r} is corrupt, not "
                f"loading it")
    arr = _from_bytes(data, leaf["dtype"], sh["shard_shape"])
    cache[sh["file"]] = arr
    return arr


def _assemble_slice(step_dir: str, leaf: Dict, bounds,
                    cache: Dict) -> torch.Tensor:
    """The [start, stop) hyper-rectangle `bounds` of a leaf's logical
    array, from ONLY the shard files that overlap it (the elastic
    restore's core: a rank holding a block never assembles the whole
    leaf)."""
    bounds = tuple((int(a), int(b)) for a, b in bounds)
    exact = [sh for sh in leaf["shards"]
             if tuple((int(a), int(b)) for a, b in sh["index"]) == bounds]
    if exact:  # one file is the whole slice: no assembly
        return _read_shard(step_dir, leaf, exact[0], cache).reshape(
            tuple(b - a for a, b in bounds))
    out = torch.zeros(tuple(b - a for a, b in bounds),
                      dtype=_torch_dtype(leaf["dtype"]))
    covered = 0
    for sh in leaf["shards"]:
        sb = [(int(a), int(b)) for a, b in sh["index"]]
        inter = [(max(a, c), min(b, d))
                 for (a, b), (c, d) in zip(bounds, sb)]
        if any(a >= b for a, b in inter):
            continue  # disjoint from the wanted slice: file not read
        arr = _read_shard(step_dir, leaf, sh, cache)
        if out.dim() == 0:
            out.copy_(arr.reshape(()))
            covered += 1
            continue
        src = tuple(slice(a - c, b - c)
                    for (a, b), (c, _) in zip(inter, sb))
        dst = tuple(slice(a - c, b - c)
                    for (a, b), (c, _) in zip(inter, bounds))
        out[dst] = arr[src]
        covered += int(np.prod([b - a for a, b in inter]))
    if covered != max(1, out.numel()):
        raise CorruptCheckpointError(
            f"checkpoint leaf {leaf['name']!r}: its shard files cover "
            f"{covered} of the {out.numel()} elements in slice "
            f"{tuple(bounds)}: the manifest's shard index set does not "
            f"tile the leaf")
    return out


def _read_leaf(step_dir: str, leaf: Dict,
               cache: Optional[Dict] = None) -> torch.Tensor:
    """One leaf's FULL logical array on the host."""
    bounds = tuple((0, int(d)) for d in leaf["shape"])
    return _assemble_slice(step_dir, leaf, bounds,
                           {} if cache is None else cache)


def read_manifest(directory: str, step=None) -> Tuple[Dict, str]:
    """(manifest, step_dir) of the committed checkpoint `restore` would
    use: a metadata-only read (no shard file is touched)."""
    if step is not None:
        step_dir = _committed_step_dir(directory, int(step))
    else:
        step_dir = latest_step_dir(directory)
    body = storage.get_driver(step_dir).read(
        storage.join(step_dir, MANIFEST))
    if body is None:
        raise CheckpointError(
            f"checkpoint {step_dir!r} lost its {MANIFEST} between the "
            f"commit probe and the read: pruned underneath us?")
    manifest = json.loads(body.decode())
    if manifest.get("format") != FORMAT:
        raise CheckpointError(
            f"{step_dir}/{MANIFEST}: unknown format "
            f"{manifest.get('format')!r} (this build reads {FORMAT})")
    return manifest, step_dir


def restore(directory: str, model, optimizer=None, *, step=None,
            set_rng: bool = True, allow_partial: bool = False,
            opt_transform=None) -> Dict[str, Any]:
    """Load the committed checkpoint under `directory` into (model,
    optimizer), in place: every shard read is crc-verified, and every
    leaf is read into the CURRENT layout (a placed block takes only the
    saved files overlapping it), whatever mesh saved it. The
    generators' states are restored with `set_rng` (a port checkpoint's;
    the reference's JAX key has no torch counterpart and is skipped).

    A checkpoint with `opt/` leaves and ``optimizer=None`` is REFUSED
    naming the dropped leaves; ``allow_partial=True`` makes it a
    params-only warm start (warned; those files are never read).
    ``opt_transform`` (`utils.checkpoint`'s canonical hook) receives the
    assembled host optimizer-state dict and returns the dict to load.

    Returns {"step", "data_cursor", "dir", "meta"}."""
    with trace.span("checkpoint.read",
                    step="latest" if step is None else int(step)):
        return _restore_impl(directory, model, optimizer, step=step,
                             set_rng=set_rng,
                             allow_partial=allow_partial,
                             opt_transform=opt_transform)


def _expected_shape(t: torch.Tensor) -> Tuple[int, ...]:
    placed = getattr(t, "placed", None)
    return tuple(placed[0]) if placed is not None else tuple(t.shape)


def _set_rng(state) -> None:
    """Restore the generators from a manifest's `rng` (the port's dict;
    each card's state only where that card exists; the rank generators
    by `autograd.set_rank_generator_states`)."""
    from singa_tpu_torch import autograd

    torch.set_rng_state(torch.tensor(state["cpu"], dtype=torch.uint8))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for i, s in enumerate(state.get("cuda", ())):
        if i < cards:
            torch.cuda.set_rng_state(torch.tensor(s, dtype=torch.uint8), i)
    autograd.set_rank_generator_states(state.get("ranks", ()))


def _restore_impl(directory: str, model, optimizer=None, *, step=None,
                  set_rng: bool = True, allow_partial: bool = False,
                  opt_transform=None) -> Dict[str, Any]:
    manifest, step_dir = read_manifest(directory, step=step)
    params = model.get_params()
    buffers = model.get_buffers()
    if optimizer is not None:
        # slots exist under their parameters' names before load_states
        optimizer.prepare(params)

    # -- structural checks FIRST, from the manifest alone ----------------------
    model_leaves, opt_leaves = [], []
    covered: set = set()
    for leaf in manifest["leaves"]:
        name = leaf["name"]
        kind, _, key = name.partition("/")
        if kind in ("param", "buffer"):
            tgt = (params if kind == "param" else buffers).get(key)
            if tgt is None:
                raise CheckpointError(
                    f"checkpoint leaf {name!r} has no matching state in "
                    f"this model: wrong model for this checkpoint")
            if _expected_shape(tgt) != tuple(leaf["shape"]):
                raise CheckpointError(
                    f"checkpoint leaf {name!r} has shape "
                    f"{tuple(leaf['shape'])}, this model wants "
                    f"{_expected_shape(tgt)}: wrong model/config")
            model_leaves.append((leaf, tgt))
            covered.add(name)
        elif kind == "opt":
            opt_leaves.append((key, leaf))
        else:
            raise CheckpointError(
                f"checkpoint leaf {name!r}: unknown namespace {kind!r}")

    want = {f"param/{n}" for n in params} | {
        f"buffer/{n}" for n in buffers}
    missing = sorted(want - covered)
    if missing:
        raise CheckpointError(
            f"checkpoint {step_dir!r} does not cover {len(missing)} "
            f"state(s) of this model (e.g. {missing[:3]}): wrong "
            f"model/config for this checkpoint; refusing a partial "
            f"restore")

    if optimizer is None and opt_leaves:
        dropped = sorted(f"opt/{k}" for k, _ in opt_leaves)
        if not allow_partial:
            raise CheckpointError(
                f"checkpoint {step_dir!r} holds {len(dropped)} optimizer "
                f"state(s) (e.g. {dropped[:3]}) but optimizer=None: "
                f"they would be silently dropped and the resumed run "
                f"would train on fresh slots. Pass the optimizer to "
                f"resume, or allow_partial=True for an explicit "
                f"params-only warm start.")
        warnings.warn(
            f"restore(allow_partial=True): dropping {len(dropped)} "
            f"optimizer state(s) from {step_dir!r} (e.g. {dropped[:3]}) "
            f"- params-only warm start, slots stay fresh",
            stacklevel=2)

    cur: Dict[str, torch.Tensor] = {}
    if optimizer is not None:
        if not opt_leaves:
            raise CheckpointError(
                f"checkpoint {step_dir!r} holds no optimizer state but "
                f"an optimizer was passed: resuming would silently "
                f"train on fresh slots. Pass optimizer=None to "
                f"warm-start the model only.")
        from singa_tpu_torch.communicator import is_per_chip_state_key
        from singa_tpu_torch.resilience.sentinel import STATE_KEYS

        have_opt = {k for k, _ in opt_leaves}
        cur = optimizer.dump_states()
        missing_opt = sorted(set(cur) - set(STATE_KEYS) - have_opt)
        if missing_opt:
            raise CheckpointError(
                f"checkpoint {step_dir!r} does not cover "
                f"{len(missing_opt)} optimizer state(s) (e.g. "
                f"{missing_opt[:3]}): a partial slot restore would "
                f"silently mix fresh and loaded moments")
        if opt_transform is None:
            saved_layout = (manifest.get("meta") or {}).get(
                "zero1_layout")
            layout_fn = getattr(optimizer, "zero1_layout", None)
            cur_layout = layout_fn() if layout_fn is not None else None
            if saved_layout is not None and cur_layout is not None \
                    and any("//__zshard__" in k for k, _ in opt_leaves) \
                    and saved_layout != cur_layout:
                raise CheckpointError(
                    f"checkpoint {step_dir!r} holds RAW ZeRO-1 slots "
                    f"with shard layout {saved_layout} but this run's "
                    f"DistOpt uses {cur_layout} (overlap/buffSize "
                    f"changed between save and load): the raw proxy "
                    f"layout is bucket-dependent, loading it would "
                    f"silently scramble the slots. Resume with the "
                    f"saving run's overlap/buffSize config, or re-save "
                    f"through the CANONICAL layout-blind form "
                    f"(utils.checkpoint.save_checkpoint / "
                    f"DistOpt.canonicalize_states + "
                    f"restore(opt_transform=optimizer.reshard_states))")
            # per-rank state is world-SHAPED: a shape mismatch there is
            # another world, which reshard_raw_states resolves; any other
            # mismatch is a wrong model
            group = _comm_of(optimizer)
            mismatched = [
                k for k, leaf in opt_leaves if k in cur
                and _opt_layout(k, cur[k], params, group, True).shape
                != tuple(leaf["shape"])]
            if mismatched:
                raw_reshard = getattr(optimizer, "reshard_raw_states",
                                      None)
                if raw_reshard is not None and all(
                        is_per_chip_state_key(k) for k in mismatched):
                    def opt_transform(states, _f=raw_reshard,
                                      _l=saved_layout):
                        return _f(states, layout=_l)
                else:
                    k = next((k for k in mismatched
                              if not is_per_chip_state_key(k)),
                             mismatched[0])
                    leaf = dict(opt_leaves)[k]
                    raise CheckpointError(
                        f"optimizer state {k!r} has shape "
                        f"{tuple(leaf['shape'])} in the checkpoint, "
                        f"this run wants "
                        f"{_opt_layout(k, cur[k], params, group, True).shape}"
                        f": a different world size? cross-world resumes "
                        f"reshape per-rank (ZeRO-1/residual) state only, "
                        f"and need an optimizer exposing "
                        f"reshard_raw_states (DistOpt) or "
                        f"utils.checkpoint's canonical form")

    # -- reads happen only now, already knowing the restore will land --------
    with torch.no_grad():
        for leaf, tgt in model_leaves:
            placed = getattr(tgt, "placed", None)
            bounds = (_placed_layout(placed).mine if placed is not None
                      else tuple((0, int(d)) for d in tgt.shape))
            got = _assemble_slice(step_dir, leaf, bounds, {})
            tgt.copy_(got.reshape(tgt.shape))

    if optimizer is not None:
        if opt_transform is not None:
            # host-logical: full assembly, then the caller's reshaping
            opt_states = opt_transform(
                {k: _read_leaf(step_dir, leaf) for k, leaf in opt_leaves})
            optimizer.load_states(dict(opt_states), strict=True)
        else:
            group = _comm_of(optimizer)
            loaded = {}
            for k, leaf in opt_leaves:
                local = cur.get(k)
                if local is None:
                    loaded[k] = _read_leaf(step_dir, leaf)
                    continue
                lay = _opt_layout(k, local, params, group, True)
                loaded[k] = _assemble_slice(
                    step_dir, leaf, lay.mine, {}).reshape(local.shape)
            optimizer.load_states(loaded, strict=True)
    rng = manifest.get("rng")
    if set_rng and isinstance(rng, dict) and "cpu" in rng:
        _set_rng(rng)
    counters.bump("restores")
    return {"step": int(manifest["step"]),
            "data_cursor": manifest.get("data_cursor"),
            "dir": step_dir,
            "meta": manifest.get("meta")}


def _step_sort_key(name: str):
    """(step, resave_k) for a step dir name, None for foreign names."""
    if not name.startswith("step-"):
        return None
    body = name[len("step-"):]
    base, _, rk = body.partition(".r")
    try:
        return int(base), int(rk) if rk else 0
    except ValueError:
        return None


def prune(directory: str, keep: int = 2) -> List[str]:
    """Delete committed step dirs beyond the newest `keep`, returning
    the removed names. The LATEST target is always kept; torn
    (manifest-less) leftovers OLDER than the newest committed dir are
    removed too (a newer one may be a writer in flight), and a step dir
    an in-flight commit of this process is writing is never touched.
    The registry is per process: over a group of ranks prune on rank 0
    only, after `save` returned (its ACK barrier orders that; this is
    what `utils.checkpoint.save_checkpoint` does)."""
    drv = storage.get_driver(directory)
    keep = max(1, int(keep))
    names = drv.list(directory)
    if not names:
        return []
    try:
        latest = os.path.basename(latest_step_dir(directory))
    except CheckpointError:
        latest = None
    steps = sorted(
        (k, n) for n in names
        if (k := _step_sort_key(n)) is not None)
    committed = [n for _, n in steps
                 if drv.exists(storage.join(directory, n, MANIFEST))]
    keep_set = set(committed[-keep:])
    if latest is not None:
        keep_set.add(latest)
    keep_set |= _inflight_names(directory)
    newest_key = _step_sort_key(committed[-1]) if committed else None
    committed_set = set(committed)
    removed = []
    for key, name in steps:
        if name in keep_set:
            continue
        if name not in committed_set and (
                newest_key is None or key >= newest_key):
            continue  # a torn dir NEWER than LATEST may be mid-write
        drv.delete_prefix(storage.join(directory, name))
        removed.append(name)
    return removed


# -- preemption --------------------------------------------------------------


class PreemptionGuard:
    """SIGTERM-safe loops: the handler only sets a flag (Python signal
    handlers run between bytecodes, so the step in flight always
    completes), and the loop reads `triggered` between steps,
    checkpoints, and exits 0::

        with resilience.PreemptionGuard() as guard:
            for step in range(start, n):
                model.train_one_batch(x, y)
                if guard.triggered:
                    resilience.save(dir, model, opt_, step=step + 1)
                    guard.exit_zero()

    `exit_zero` raises SystemExit(0): the scheduler sees a clean exit
    and the next incarnation resumes from the committed checkpoint.
    Previous handlers are restored on context exit."""

    def __init__(self, signals=(_signal.SIGTERM,)):
        self.signals = tuple(signals)
        self.triggered = False
        self._prev: Dict[int, Any] = {}

    def _on_signal(self, signum, frame):
        self.triggered = True

    def __enter__(self) -> "PreemptionGuard":
        for s in self.signals:
            self._prev[s] = _signal.signal(s, self._on_signal)
        return self

    def __exit__(self, *exc) -> bool:
        for s, prev in self._prev.items():
            _signal.signal(s, prev)
        self._prev.clear()
        return False

    def exit_zero(self, save_fn=None):
        """Optionally run `save_fn` (the checkpoint), then exit 0:
        preemption handled, not failed."""
        if save_fn is not None:
            save_fn()
        raise SystemExit(0)
