"""Shardlint's step trace: the `torch.distributed` calls of one step
(counterpart of singa_tpu/analysis/trace.py).

The reference traces a step to a closed jaxpr and reads its collective
equations. PyTorch makes no such object, so here the collectives are
recorded as they are issued: each choke function of the port calls
`record(...)` at its entry, before it looks at the axis's size, and a
`CollectiveRecorder` active around one step keeps a `Record` of each
call. There is no monkeypatching of `torch.distributed`: the hooks are
explicit, and `tests/test_torch_analysis_audit.py` holds every
`dist.<collective>(` of the package to a hook beside it (or to a short
list of exempt sites: group setup, the serving CLI).

A record holds the op in the reference's primitive vocabulary where it
has one (`all_reduce` -> "psum", `all_gather_into_tensor` ->
"all_gather", `reduce_scatter_tensor` -> "reduce_scatter",
`all_to_all_single` -> "all_to_all", each tensor of one ring rotation's
send/receive pair -> "ppermute"); `broadcast` keeps its own name, as do
"send" and "recv" (the disaggregated prefill's hand-off, a transfer
between meshes rather than a rotation). Beside the op: the mesh axis the
call serves (named by the caller: at world 1 every axis of a mesh has
the same process group, so the group cannot name it), the group's
global ranks, the tensor's shape and dtype, for a ppermute the (source,
destination) positions in the group, the phase ("backward" where an
autograd node is running, `torch._C._current_autograd_node()`, else
"forward"), the block scope (`block(i, owner)`) and the recording rank.

Some records stand for a collective that did not run, because the
reference's program carries it where the port takes a short cut
(`Record.ran` False):

- a functional collective (`communicator.psum_over`, `pmean_over`,
  `broadcast_from`) over an axis of one rank, which
  `communicator._live_axes` skips;
- ZeRO-3's gather (`communicator.all_gather_tiled`) and tp's "g" on a
  live axis with no process group under it;
- Ulysses' and the MoE FFN's all-to-all at an axis of one rank;
- the ring's last rotation, which brings each block home and whose
  result is never read (`ring.py`: the reference's last ppermute), and
  at one rank every rotation; the GPipe rotation at one rank.

Nothing is recorded while a CUDA Graph is being captured: the artifacts
come from an uncaptured step. The recorder is process-global under a
lock, so the calls the autograd engine's thread issues (tp's "f", the
ZeRO-3 reduce-scatters, the ring's cotangent rotations) are kept too.
A block scope is thread-local: `ScanTransformerStack`'s block loop and
the serving engines' enter `block(i, owner)`, which costs one global
read when no recorder is active, so R2 counts each block exactly while
the ZeRO-3 prologue gather and the logits gather stay outside.

After the step, `CollectiveRecorder.merged(group)` gathers every rank's
records (`all_gather_object`, outside the recorded window): each rank
sees only its own sends, and R4 needs the whole cycle; R2 needs every
rank's counts.

`trace_step` drives `graph.GraphStep.lint_artifacts` (or an engine's
own `lint_artifacts`) and packs the result with the model's declared
metadata (axis roles, stacks with a `declared_schedule`) into a
`StepTrace`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import Counter
from typing import Dict, List, Optional, Set, Tuple

import torch
import torch.distributed as dist

__all__ = ["Record", "CollectiveRecorder", "record", "block", "recording",
           "StepTrace", "trace_step", "declared_axis_roles", "scan_stacks",
           "census", "AXIS_ATTR_ROLES"]

#: layer or model attribute -> parallelism role (R1's axis-role audit;
#: the reference's list)
AXIS_ATTR_ROLES = (
    ("tp_axis", "tp"),
    ("zero3_axis", "zero3"),
    ("seq_axis", "seq"),
    ("moe_axis", "expert"),
    ("pipe_axis", "pipe"),
)


@dataclasses.dataclass(frozen=True)
class Record:
    """One recorded collective (see the module docstring)."""

    op: str
    axis: Optional[str]
    ranks: Tuple[int, ...]
    shape: Tuple[int, ...]
    dtype: str
    #: a ppermute's (source, destination) positions in `ranks`
    peer: Optional[Tuple[int, int]] = None
    phase: str = "forward"
    #: (scope label, block index) inside a block scope, else None
    block: Optional[Tuple[str, int]] = None
    #: False: the reference's program carries it, the port skipped it
    ran: bool = True
    #: the recording process's global rank
    rank: int = 0

    def key(self) -> str:
        return f"{self.op}@{self.axis or ''}"

    def line(self) -> str:
        """One line of `graph.hlo_text`."""
        extra = f" peer={self.peer[0]}->{self.peer[1]}" if self.peer else ""
        blk = f" block={self.block[0]}:{self.block[1]}" if self.block else ""
        skip = "" if self.ran else " (not run)"
        return (f"rank {self.rank} {self.phase} {self.key()} "
                f"ranks={list(self.ranks)} {self.dtype}"
                f"{list(self.shape)}{extra}{blk}{skip}")


_LOCK = threading.Lock()
#: the active recorder (one per process at a time)
_ACTIVE: Optional["CollectiveRecorder"] = None
_scope = threading.local()


def recording() -> bool:
    """True while a recorder is active."""
    return _ACTIVE is not None


def _group_ranks(group) -> Tuple[int, ...]:
    live = dist.is_available() and dist.is_initialized()
    if group is None or not live:
        return (dist.get_rank() if live else 0,)
    return tuple(dist.get_process_group_ranks(group))


def record(op: str, tensor: torch.Tensor, axis: Optional[str] = None,
           group=None, peer: Optional[Tuple[int, int]] = None,
           ran: bool = True) -> None:
    """Keep one record of a collective about to be issued (or, with
    `ran=False`, skipped where the reference's program has it) when a
    recorder is active; nothing otherwise."""
    rec = _ACTIVE
    if rec is None:
        return
    if tensor.is_cuda and torch.cuda.is_current_stream_capturing():
        return
    live = dist.is_available() and dist.is_initialized()
    node = torch._C._current_autograd_node()
    r = Record(op=op, axis=axis, ranks=_group_ranks(group),
               shape=tuple(int(s) for s in tensor.shape),
               dtype=str(tensor.dtype).replace("torch.", ""),
               peer=None if peer is None else (int(peer[0]), int(peer[1])),
               phase="forward" if node is None else "backward",
               block=getattr(_scope, "block", None), ran=bool(ran),
               rank=dist.get_rank() if live else 0)
    with _LOCK:
        rec.records.append(r)


class _Block:
    __slots__ = ("label", "index", "prev")

    def __init__(self, label, index):
        self.label, self.index = label, index

    def __enter__(self):
        self.prev = getattr(_scope, "block", None)
        _scope.block = (self.label, self.index)

    def __exit__(self, *exc):
        _scope.block = self.prev


_NO_BLOCK = contextlib.nullcontext()


def block(index: int, owner):
    """The scope of block `index` of `owner` (a stack, an engine): the
    records made inside carry it. A no-op without an active recorder."""
    rec = _ACTIVE
    if rec is None:
        return _NO_BLOCK
    return _Block(rec.label(owner), int(index))


class CollectiveRecorder:
    """`with CollectiveRecorder() as rec:` keeps a `Record` of every
    collective the port issues in the block, on every thread. Block
    scopes are labelled "scope0", "scope1", ... by each owner's first
    appearance, which is the same on every rank of one program
    (`scopes` maps id(owner) to its label)."""

    def __init__(self):
        self.records: List[Record] = []
        self.scopes: Dict[int, str] = {}
        self._owners: List[object] = []  # kept alive: ids stay unique

    def label(self, owner) -> str:
        with _LOCK:
            lab = self.scopes.get(id(owner))
            if lab is None:
                lab = self.scopes[id(owner)] = f"scope{len(self.scopes)}"
                self._owners.append(owner)
            return lab

    def __enter__(self) -> "CollectiveRecorder":
        global _ACTIVE
        with _LOCK:
            if _ACTIVE is not None:
                raise RuntimeError("a CollectiveRecorder is already active "
                                   "in this process")
            _ACTIVE = self
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        with _LOCK:
            _ACTIVE = None

    def merged(self, group=None) -> List[List[Record]]:
        """Every rank's records, by rank of `group` (the step's mesh
        group; None: the world), gathered after the step. A world of one
        gives this rank's own."""
        live = dist.is_available() and dist.is_initialized()
        if not live or dist.get_world_size(group) == 1:
            return [list(self.records)]
        out: List = [None] * dist.get_world_size(group)
        dist.all_gather_object(out, list(self.records), group=group)
        return [list(r) for r in out]


def census(records: List[Record]) -> Dict[str, int]:
    """Observed calls: "op@axis" -> count over one rank's records."""
    return dict(sorted(Counter(r.key() for r in records).items()))


# -- the model's declared metadata -------------------------------------------


def _walk_layers(root):
    # an engine exposes axis attributes and a declared_schedule but is
    # no module tree
    mods = getattr(root, "modules", None)
    if callable(mods) and isinstance(root, torch.nn.Module):
        yield from mods()
    else:
        yield root


def declared_axis_roles(model, comm_axis: Optional[str]
                        ) -> Dict[str, Set[str]]:
    """axis name -> the parallelism roles the model declares on it (the
    model's and every layer's axis attributes, and DistOpt's data
    axis)."""
    roles: Dict[str, Set[str]] = {}

    def add(ax, role):
        if ax is not None:
            roles.setdefault(ax, set()).add(role)

    add(comm_axis, "data")
    for lyr in _walk_layers(model):
        for attr, role in AXIS_ATTR_ROLES:
            add(getattr(lyr, attr, None), role)
    return roles


def scan_stacks(model) -> List:
    """Every R2 subject: whatever declares a per-block schedule
    (`layer.ScanTransformerStack`, the sharded serving engines)."""
    return [lyr for lyr in _walk_layers(model)
            if callable(getattr(lyr, "declared_schedule", None))]


# -- the traced step -------------------------------------------------------------


@dataclasses.dataclass
class StepTrace:
    target: str
    model: object = None
    mesh: object = None
    comm_axis: Optional[str] = None
    #: every rank's records of the one recorded step, by rank
    records: List[List[Record]] = dataclasses.field(default_factory=list)
    #: id(owner) -> block scope label (this process's owners)
    scopes: Dict[int, str] = dataclasses.field(default_factory=dict)
    #: R5's evidence: {"across": what separates the snapshots,
    #: "snapshots": [{name: (data_ptr, dtype, shape)}, ...]}
    state: Optional[Dict] = None
    #: kernel launches of the recorded step and of the capture
    launches: Optional[Dict] = None
    axis_roles: Dict[str, Set[str]] = dataclasses.field(default_factory=dict)
    stacks: List = dataclasses.field(default_factory=list)
    #: set when the step failed on an axis that is not live (R1)
    trace_error: Optional[str] = None
    #: StableHLO module text, where the subject has one (the native
    #: training step, `hlo.trace_native_module`); R7 reads it
    lowered_text: Optional[str] = None
    #: the collective census the text's emitter declares (R7)
    hlo_declared: Optional[Dict[str, int]] = None

    def local_records(self) -> List[Record]:
        return self.records[0] if self.records else []


#: the message of a collective over an axis the step does not carry
#: (`parallel.mesh._axis_mesh`): the reference's "unbound axis name"
_UNBOUND = "is not live"


def trace_step(model, *args, train: bool = True,
               target: Optional[str] = None) -> StepTrace:
    """Record `model`'s training (or eval) step on these inputs. The
    model must be compiled with its optimizer set, as for training; a
    sharded serving engine records its own step (its `lint_artifacts`).
    A step that fails on an axis that is not live is R1's evidence
    (`trace_error`), not an exception."""
    from singa_tpu_torch import graph

    name = target or type(model).__name__
    opt = getattr(model, "_optimizer", None) if train else None
    comm = getattr(opt, "comm", None)
    comm_axis = getattr(comm, "axis_name", None)
    trace = StepTrace(target=name, model=model, comm_axis=comm_axis,
                      mesh=getattr(comm, "mesh", None),
                      axis_roles=declared_axis_roles(model, comm_axis),
                      stacks=scan_stacks(model))
    try:
        own = getattr(model, "lint_artifacts", None)
        if own is not None and not hasattr(model, "train_one_batch"):
            art = own(*args)
        else:
            art = graph._step_for(model, train).lint_artifacts(*args)
    except (ValueError, RuntimeError) as e:
        msg = f"{type(e).__name__}: {e}"
        if _UNBOUND in msg:
            trace.trace_error = msg
            return trace
        raise
    trace.records = art["records"]
    trace.scopes = art["scopes"]
    trace.mesh = art["mesh"]
    trace.comm_axis = art["comm_axis"]
    trace.state = art["state"]
    trace.launches = art.get("launches")
    return trace
