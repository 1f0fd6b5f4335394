"""The captured step and its memory accounting (counterpart of
singa_tpu/graph.py's `GraphStep`, :146-199 and :717-975,
`tape_memory_plan` and `plan_from_ops`, :51-122, and
`step_memory_analysis`, :1181-1207).

`GraphStep(model, method, train_step)` wraps a model's bound
`train_one_batch` (a training step) or `forward` (an eval step, run
without a tape: no backward, optimizer or step counter) and keeps one
entry per key: the tensor operands' shapes and dtypes, the static arguments,
`training`, the dispatch switches a step reads while it runs (the
autocast policy, `flash_attention.flash_enabled()`,
`max_pool.pool_kernel_enabled()`, the dropout rank
`autograd.draw_rank()`), and `layer.mutation_stamp()`. A graph reads
and writes the storage it was captured on, so a parameter object
replaced since (`m.fc.W = nn.Parameter(...)`) would be left training
the old tensor; the stamp moves on such an assignment (reference
`graph.py:228-249`), the next step takes a new key, and the entries of
older stamps are dropped with their graphs.

On the card a key's

- first call is the real first step, run uncaptured on the step's own
  stream: it is the warm-up (cuBLAS handles, the kernels' libraries, the
  autograd threads) and changes the state exactly as a step does;
- second call captures the whole step (forward, backward, clipping and
  the optimizer update; an eval step's forward) as one
  `torch.cuda.CUDAGraph` over static copies of the tensor operands, then
  replays it once, which is that call's step;
- later calls copy their operands into the static buffers and replay.

Every call returns its outputs detached, as the reference returns new
arrays without a tape; a replay returns fresh clones of the graph's
outputs (the next replay rewrites the graph's own). The optimizer's device step counter advances in
the graph; `step_counter`, its host mirror, advances by the capture's
steps after each replay. Capture needs every tensor the step reads to
exist at capture and every update to write in place (`opt.py` keeps to
both), and nothing in the step may wait for the host: no `.item()`, no
Python branch on a device value; and no tape of the model's parameters
may still be alive from an uncaptured forward on another stream (it
pins their gradient accumulators to that stream). A capture that fails
raises; there is no eager fallback. Dropout draws from PyTorch's default
generator, which the capture registers itself, or, in a distributed step
of rank r > 0, from that rank's generator (`autograd.rank_draws`), which
`_capture` registers with the graph; a step that draws from another
`torch.Generator` would repeat its draws on every replay.

A DistOpt step's collectives are captured with it: they enqueue on the
step's stream, and the key's first, uncaptured call has made NCCL's
communicator (made lazily at the first collective) before the capture.

Each `GraphStep` captures and replays on a stream that no other live
step or serving engine holds (`private_stream`): a graph keeps the
cuBLAS workspace of the stream it was captured on, and graphs that share
one corrupt each other when they run at once. One capture runs at a time
in the process (`CAPTURE_LOCK`), in thread-local mode.

On the CPU the same function runs uncaptured: a new key counts one
build, and every call is a plain call.

Counted (the reference's names): `graph_compiles` per capture (per new
key on the CPU) with the `graph.compile` span around it; `train_steps`
and `train_step_ms` (host wall of a training step's call) while the
hot-path metrics are on. `captures` and `replays` count the same on the
instance. With a trace file configured a training step whose
optimizer's `GradSentinel` skipped emits a `sentinel.skip` event
(reading the sentinel's scalars waits for the step, which is why only
tracing does it; reference :772, :788-805), and `fault_counters()` reads
the sentinel's scalars after the step, merged with the supervisor
counters (reference :807-830).

The memory plan. A key's first call also hands the step's op graph to
the native planner (`native.GraphPlanner`, g++'s build of
`native/graph_core.cc`; graph mode raises if it cannot be built), once
per step, and keeps its verdict as `memory_plan = {"ops", "peak_bytes",
"naive_bytes"}` (`Model.memory_estimate`). The op graph is PyTorch's
tape (`tape_memory_plan`): an op is an autograd node, so `ops` counts
PyTorch's nodes, not the reference's ops; a buffer is a node's output
(its bytes `numel * element_size` from the node's output metadata), a
parameter, or one of the step's tensor operands (live for the whole
step). A training step is planned when its backward starts
(`autograd._tape_observers`), before the backward frees the tape, as the
reference plans inside its backward walk. An eval step records no tape,
so its first call of a key records one for the plan, with grad on and a
saved-tensor hook that keeps nothing (memory as without a tape); no plan
is made under `torch.inference_mode`, where no tape can be recorded.

`step_memory_analysis(model, *args, train=True)` runs the step once on
the given inputs and puts the model and optimizer state back; see
`GraphStep.memory_analysis` for its keys.

Shardlint's artifacts (reference :873-905, :1095-1201).
`GraphStep.lint_artifacts(*args)` (and `step_lint_artifacts(model,
*args)`) runs the step under an `analysis.trace.CollectiveRecorder`,
then again, and snapshots every state tensor's address, dtype and shape
after each run: on the card the first call runs uncaptured (recorded)
and the second captures and replays the step, so the snapshots frame
the capture and a replay; on the CPU they frame two plain calls. Then
it puts every state back in place (parameters, buffers, the optimizer's
slots and step counter, the sentinel's scalars, the CPU, CUDA and rank
generators), so training goes on bitwise where it was, and drops the
graph it made. `collect_lint_artifacts(run, state, ...)` is the same
over any step function (the serving engines'). `hlo_text(model,
*args)` keeps the reference's name for a text dump of the recorded
collectives, one line a call: a PyTorch step has no HLO.
"""

from __future__ import annotations

import gc
import logging
import math
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from singa_tpu_torch import autograd
from singa_tpu_torch import layer as layer_module
from singa_tpu_torch import native
from singa_tpu_torch.observability import metrics as obs_metrics
from singa_tpu_torch.observability import trace as obs_trace
from singa_tpu_torch.ops import flash_attention as fa
from singa_tpu_torch.ops import max_pool

__all__ = ["GraphStep", "CAPTURE_LOCK", "private_stream", "plan_from_ops",
           "fault_counters", "step_memory_analysis", "tape_memory_plan",
           "check_param_shard_divisibility", "check_sharded_layers",
           "check_pipelined_stacks", "collect_lint_artifacts",
           "step_lint_artifacts", "hlo_text"]

_log = logging.getLogger("singa_tpu_torch.graph")

#: one CUDA Graph capture at a time in the process (training steps and
#: the serving engines, which may be pumped from several threads)
CAPTURE_LOCK = threading.Lock()
#: the streams held by live graph owners (`cuda_stream` handles): cuBLAS
#: keys its workspace by (handle, stream), and a graph keeps the
#: workspace of the stream it was captured on, so owners that run at
#: once must capture, and run, on streams no other owner uses
_HELD_STREAMS: set = set()
#: streams whose owner was collected, handed out again before a fresh
#: pool stream: cuBLAS keeps each stream's workspace for the life of the
#: process, so a fresh stream for every new owner (a model rebuilt after
#: a crash) would grow the memory in use by a workspace each time
_FREE_STREAMS: list = []


def _release_stream(st) -> None:
    _HELD_STREAMS.discard(st.cuda_stream)
    _FREE_STREAMS.append(st)


def _hold_stream(owner, st):
    _HELD_STREAMS.add(st.cuda_stream)
    _FREE_STREAMS[:] = [f for f in _FREE_STREAMS
                        if f.cuda_stream != st.cuda_stream]
    weakref.finalize(owner, _release_stream, st)
    return st


def private_stream(owner, device) -> torch.cuda.Stream:
    """A CUDA stream that no other live owner holds, released when
    `owner` is collected: a released one on `device` if there is one,
    else a fresh one from PyTorch's pool."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    for st in _FREE_STREAMS:
        if st.device == dev and st.cuda_stream not in _HELD_STREAMS:
            return _hold_stream(owner, st)
    for _retry in range(2):
        for _ in range(64):
            st = torch.cuda.Stream(dev)
            if st.cuda_stream not in _HELD_STREAMS:
                return _hold_stream(owner, st)
        gc.collect()  # owners dropped in reference cycles free theirs
    raise RuntimeError(
        f"every pooled CUDA stream is held by one of {len(_HELD_STREAMS)} "
        f"live graph owners (serving engines, captured training steps)")


def _map(obj, fn):
    """fn over every tensor of a (nested) tuple/list/dict."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(o, fn) for o in obj)
    if isinstance(obj, dict):
        return {k: _map(v, fn) for k, v in obj.items()}
    return obj


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# -- the memory plan over PyTorch's tape ---------------------------------------


def _tape_nodes(roots) -> List[Any]:
    """The autograd nodes that `roots` (tensors) were computed through,
    in an order where every node follows the nodes of its inputs
    (depth first, inputs in order, as the reference's walk); parameters'
    `AccumulateGrad` nodes are left out (they are graph inputs)."""
    order, seen = [], set()
    stack = [(t.grad_fn, False) for t in reversed(roots)]
    while stack:
        fn, done = stack.pop()
        if done:
            order.append(fn)
        elif fn is not None and fn not in seen:
            seen.add(fn)
            stack.append((fn, True))
            stack.extend((nxt, False) for nxt, _ in reversed(
                fn.next_functions))
    return [fn for fn in order if not hasattr(fn, "variable")]


def plan_from_ops(ops, inputs=(), require_native: bool = True):
    """Arena-plan a list of autograd nodes in forward order (see
    `_tape_nodes`) with the native planner: (order, peak bytes, naive
    bytes). A buffer is a node's output or a parameter (an
    `AccumulateGrad` input, live from the start); a node's output that
    no node of the list reads is a graph output (live to the end).
    `inputs`, the step's tensor operands, are live for the whole step
    (the caller holds them). Saved tensors are not read: reading one
    that a remat checkpoint holds would run its block again."""
    if not ops:
        return [], 0, 0
    planner = native.GraphPlanner(require_native=require_native)
    node_of = {op: planner.add_node() for op in ops}
    buf_ids: Dict[Any, int] = {}
    consumed = set()

    def edge(src, dst, key, nbytes):
        if key not in buf_ids:
            buf_ids[key] = len(buf_ids)
        planner.add_edge(src, dst, buf_ids[key], int(nbytes))
        consumed.add(key)

    def out_bytes(op, i):
        md = op._input_metadata[i]
        return math.prod(md.shape) * md.dtype.itemsize

    for t in inputs:
        edge(-1, -1, ("leaf", id(t)), _nbytes(t))
    for op in ops:
        dst = node_of[op]
        for nxt, i in op.next_functions:
            var = getattr(nxt, "variable", None)
            if var is not None:
                edge(-1, dst, ("leaf", id(var)), _nbytes(var))
            elif nxt in node_of:
                edge(node_of[nxt], dst, ("out", nxt, i), out_bytes(nxt, i))
    for op in ops:
        for i in range(len(op._input_metadata)):
            if ("out", op, i) not in consumed:
                edge(node_of[op], -1, ("out", op, i), out_bytes(op, i))
    order = planner.toposort()
    _, peak, naive = planner.plan_memory(order)
    return order, peak, naive


def tape_memory_plan(y, inputs=(), require_native: bool = True):
    """The native planner over the tape reaching `y` (a tensor, or a
    (nested) tuple/list/dict of them), with `inputs` live for the whole
    step: (order, peak bytes, naive bytes), the arena size with
    buffer-lifetime reuse and without. ([], 0, 0) when `y` has no
    tape."""
    roots = []
    _map(y, lambda t: roots.append(t) if t.grad_fn is not None else None)
    return plan_from_ops(_tape_nodes(roots), inputs,
                         require_native=require_native)


def _drop(t: torch.Tensor):
    """The eval plan's pack hook: the tape keeps nothing."""
    return None


def _no_unpack(_):
    raise RuntimeError("the eval step's planning tape keeps no tensor")


def fault_counters(optimizer) -> Optional[Dict[str, float]]:
    """The optimizer's sentinel's {"nonfinite_skips", "loss_scale",
    "good_steps", "steps_seen"}, read after the step, merged with the
    process-wide supervisor counters {"restarts", "rollbacks", "hangs",
    ...}; None without a sentinel when no supervisor event has fired."""
    from singa_tpu_torch.resilience import counters as _counters

    sent = getattr(optimizer, "sentinel", None)
    sup = _counters.supervisor_snapshot()
    if sent is None:
        return dict(sup) if any(sup.values()) else None
    return {**sent.counters(), **sup}


class _Captured:
    __slots__ = ("graph", "static", "out", "opt_steps")

    def __init__(self, graph, static, out, opt_steps):
        self.graph, self.static, self.out = graph, static, out
        self.opt_steps = opt_steps


#: a key whose first (uncaptured) call has run on the card
_WARM = object()


class GraphStep:
    """A model's training step or eval forward `method(*args, **kwargs)`,
    captured per key on the card and plain on the CPU (see the module
    docstring)."""

    def __init__(self, model, method: Callable, train_step: bool = True):
        self.model = model
        self.method = method
        self.train_step = bool(train_step)
        self._cache: Dict[Any, Any] = {}
        self._stamp = layer_module.mutation_stamp()
        self._stream = None
        self._step_metrics = None
        #: the native planner's {"ops", "peak_bytes", "naive_bytes"},
        #: from the first call that could record a tape
        self.memory_plan: Optional[Dict[str, int]] = None
        #: captures made (builds, on the CPU) and replays run
        self.captures = 0
        self.replays = 0
        self._last_skips = 0

    # ------------------------------------------------------------------
    @staticmethod
    def _split_args(args, kwargs):
        """The arguments with numpy arrays as tensors (as the reference
        takes them as arrays), the positions of the tensor operands, the
        operands, and the key of the static arguments. Tensor operands
        must be positional, as in the reference."""
        args = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                for a in args]
        dyn_idx, tensors, static = [], [], []
        for i, a in enumerate(args):
            if isinstance(a, torch.Tensor):
                dyn_idx.append(i)
                tensors.append(a)
            else:
                static.append((i, a))
        for k, v in kwargs.items():
            if isinstance(v, (torch.Tensor, np.ndarray)):
                raise NotImplementedError(
                    "graph()-mode: tensor operands must be positional; "
                    f"got tensor keyword argument {k!r}")
        return args, dyn_idx, tensors, (tuple(static), tuple(sorted(
            kwargs.items())))

    def _key(self, tensors, static_key, stamp):
        return (tuple((tuple(t.shape), t.dtype) for t in tensors),
                static_key, bool(self.model.training),
                tuple(sorted(autograd._autocast.items(), key=str)),
                fa.flash_enabled(), max_pool.pool_kernel_enabled(),
                autograd.draw_rank(), stamp)

    def _device(self, tensors) -> torch.device:
        for p in self.model.parameters():
            return p.device
        return tensors[0].device if tensors else torch.device("cpu")

    # ------------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        args, dyn_idx, tensors, static_key = self._split_args(args, kwargs)
        stamp = layer_module.mutation_stamp()
        if stamp != self._stamp:  # captured against replaced objects
            self._cache.clear()
            self._stamp = stamp
        key = self._key(tensors, static_key, stamp)
        dev = self._device(tensors)
        t0 = time.perf_counter() if obs_metrics.enabled() else None
        entry = self._cache.get(key)
        if dev.type != "cuda":
            if entry is None:
                obs_metrics.counter("graph_compiles").inc()
                self.captures += 1
                self._cache[key] = _WARM
                with obs_trace.span("graph.compile", train=self.train_step):
                    out = self._first(args, kwargs)
            else:
                out = self._run(args, kwargs)
        elif entry is None:
            self._cache[key] = _WARM
            out = self._on_stream(dev, lambda: self._first(args, kwargs))
        else:
            if entry is _WARM:
                obs_metrics.counter("graph_compiles").inc()
                with obs_trace.span("graph.compile", train=self.train_step):
                    entry = self._capture(dev, args, kwargs, dyn_idx,
                                          tensors)
                self._cache[key] = entry
            out = self._replay(dev, entry, tensors)
        if t0 is not None and self.train_step:
            self._record_step(time.perf_counter() - t0)
        if self.train_step and obs_trace.enabled():
            self._emit_sentinel_events(self.model.optimizer)
        return _map(out, torch.Tensor.detach)

    def _run(self, args, kwargs):
        """One plain call of the method (an eval step without a tape)."""
        if self.train_step:
            return self.method(*args, **kwargs)
        with torch.no_grad():
            return self.method(*args, **kwargs)

    def _first(self, args, kwargs):
        """A key's first call: the plain call, which also makes the
        memory plan while the step has none."""
        if self.memory_plan is not None or torch.is_inference_mode_enabled():
            return self._run(args, kwargs)
        operands = [a for a in args if isinstance(a, torch.Tensor)]
        if not self.train_step:
            with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                    _drop, _no_unpack):
                out = self.method(*args, **kwargs)
            self._set_plan(tape_memory_plan(out, operands))
            return out
        seen = []

        def observe(y):
            if not seen:
                seen.append(tape_memory_plan(y, operands))

        autograd._tape_observers.append(observe)
        try:
            out = self.method(*args, **kwargs)
        finally:
            autograd._tape_observers.remove(observe)
        self._set_plan(seen[0] if seen else tape_memory_plan(out, operands))
        return out

    def _set_plan(self, plan) -> None:
        order, peak, naive = plan
        if not order:
            return
        self.memory_plan = {"ops": len(order), "peak_bytes": int(peak),
                            "naive_bytes": int(naive)}
        _log.info("graph step: %d autograd nodes, arena %.2f MB (naive "
                  "%.2f MB)", len(order), peak / 1e6, naive / 1e6)

    # ------------------------------------------------------------------
    def _side(self, dev) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = private_stream(self, dev)
        return self._stream

    def _on_stream(self, dev, fn):
        """fn() on the step's stream, ordered after the caller's work,
        and the caller's stream after it."""
        side, cur = self._side(dev), torch.cuda.current_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn()
        cur.wait_stream(side)
        return out

    def _capture(self, dev, args, kwargs, dyn_idx, tensors) -> _Captured:
        """Capture the step over static copies of the tensor operands
        (on the model's device); the step does not run here."""
        static = [torch.empty_like(t, device=dev) for t in tensors]
        call_args = args[:]
        for i, buf in zip(dyn_idx, static):
            call_args[i] = buf
        opt = self.model.optimizer if self.train_step else None
        before = opt.step_counter if opt is not None else 0
        graph = torch.cuda.CUDAGraph()
        for gen in autograd.rank_generators(dev):
            graph.register_generator_state(gen)
        side, cur = self._side(dev), torch.cuda.current_stream(dev)
        with CAPTURE_LOCK:
            side.wait_stream(cur)
            try:
                with torch.cuda.graph(graph, stream=side,
                                      capture_error_mode="thread_local"):
                    out = self._run(call_args, kwargs)
            except RuntimeError as e:
                raise RuntimeError(
                    f"capturing the {'training' if self.train_step else 'eval'}"
                    f" step failed: {e}. A tape "
                    f"still alive from an uncaptured forward on another "
                    f"stream (a loss or output of the model kept by the "
                    f"caller) pins the parameters' gradient accumulators "
                    f"to that stream: drop it before the step") from e
            cur.wait_stream(side)
        self.captures += 1
        steps = opt.step_counter - before if opt is not None else 0
        return _Captured(graph, static, out, steps)

    def _replay(self, dev, entry: _Captured, tensors):
        for dst, src in zip(entry.static, tensors):
            dst.copy_(src)
        self._on_stream(dev, entry.graph.replay)
        self.replays += 1
        if entry.opt_steps:
            self.model.optimizer.step_counter += entry.opt_steps
        return _map(entry.out, torch.Tensor.clone)

    # ------------------------------------------------------------------
    def _record_step(self, dt_s: float) -> None:
        """Hot-path telemetry against handles cached at first use."""
        h = self._step_metrics
        if h is None:
            h = self._step_metrics = (
                obs_metrics.histogram("train_step_ms"),
                obs_metrics.counter("train_steps"))
        h[0].observe(dt_s * 1000.0)
        h[1].inc()

    def _emit_sentinel_events(self, opt) -> None:
        """A `sentinel.skip` event with the loss scale when the skip count
        advanced since the last step (tracing only: the read waits for
        the step)."""
        sent = getattr(opt, "sentinel", None)
        if sent is None:
            return
        c = sent.counters()
        skips = int(c.get("nonfinite_skips", 0))
        if skips > self._last_skips:
            obs_trace.event(
                "sentinel.skip", skips=skips - self._last_skips,
                nonfinite_skips=skips,
                loss_scale=float(c.get("loss_scale", 0.0)))
        self._last_skips = skips

    def fault_counters(self) -> Optional[Dict[str, float]]:
        """`fault_counters(optimizer)` of a training step; an eval step
        has no optimizer."""
        return fault_counters(self.model.optimizer if self.train_step
                              else None)

    # ------------------------------------------------------------------
    def memory_analysis(self, *args, **kwargs) -> Dict[str, int]:
        """Run the step once, uncaptured, on these inputs, put its state
        back (`_TrainingState`), and return the reference's keys
        (singa_tpu/graph.py:910-975):

        - `temp_bytes`: the bytes the step saves for its backward (each
          storage once; parameters and buffers are state, not counted),
          counted by a saved-tensor hook; on the card, the allocator's
          high-water mark above the step's start when that is larger (it
          holds the saved tensors and the step's transient buffers).
          Under a `per_block` remat stack a block saves only its input
          (the checkpoint's); under `none`, every residual;
        - `argument_bytes`: the state the step threads (parameters and
          buffers, and a training step's optimizer slots) and its tensor
          operands;
        - `alias_bytes`: the state a training step updates in place
          (parameters, buffers, slots; 0 for an eval step);
        - `output_bytes`: the step's outputs and the state it writes;
        - `peak_bytes`: argument + output - alias + temp, the reference's
          formula;
        - `parameter_bytes`: the parameters this rank holds (a placed
          tensor's block: the sharded resting footprint);
        - `attention_bytes`: the reference's analytic term at world 1
          (fp32 scores (B, heads, T, T) per live block of each
          `ScanTransformerStack`, one block under `per_block`);
        - `gathered_block_bytes`: the analytic ZeRO-3 working set on top
          of `parameter_bytes` (reference `_per_shard_gathered_bytes`,
          :970-1010): one block of per-tp-shard weights of each stack
          whose zero3 axis is on the training step's mesh, two under
          `overlap` (the double buffer); 0 without one."""
        args, _, tensors, _ = self._split_args(args, kwargs)
        model = self.model
        opt = model.optimizer if self.train_step else None
        params = list(model.parameters())
        bufs = list(model.buffers())
        slots = ([t for t in opt.dump_states().values()
                  if isinstance(t, torch.Tensor)] if opt is not None else [])
        state_ptrs = {t.untyped_storage().data_ptr()
                      for t in params + bufs + slots}
        dev = self._device(tensors)
        saved: Dict[int, int] = {}

        def pack(t):
            ptr = t.untyped_storage().data_ptr()
            if ptr not in state_ptrs:
                saved[ptr] = t.untyped_storage().nbytes()
            return t

        keep = _TrainingState(model, opt)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                out = self._run(args, kwargs)
            outs = []
            _map(out, outs.append)
            out_bytes = sum(_nbytes(t) for t in outs)
            temp = sum(saved.values())
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                temp = max(temp, torch.cuda.max_memory_allocated(dev) - base)
            del out, outs
        finally:
            keep.restore()
        state = sum(_nbytes(t) for t in params + bufs + slots)
        alias = state if self.train_step else 0
        res = {"temp_bytes": int(temp),
               "argument_bytes": state + sum(_nbytes(t) for t in tensors),
               "output_bytes": out_bytes + alias,
               "alias_bytes": alias}
        res["peak_bytes"] = (res["argument_bytes"] + res["output_bytes"]
                             - res["alias_bytes"] + res["temp_bytes"])
        res["parameter_bytes"] = sum(_nbytes(p) for p in params)
        res["attention_bytes"] = self._attention_bytes(tensors)
        res["gathered_block_bytes"] = self._gathered_block_bytes()
        return res

    # ------------------------------------------------------------------
    def _state_tensors(self) -> Dict[str, torch.Tensor]:
        """Every tensor the step keeps as state, by name: parameters,
        buffers and, for a training step, the optimizer's slots and
        scalars and its device step counter."""
        model = self.model
        out = {f"param:{n}": t for n, t in model.named_parameters()}
        out.update((f"buffer:{n}", t) for n, t in model.named_buffers())
        opt = model.optimizer if self.train_step else None
        if opt is not None:
            for k, v in opt.dump_states().items():
                if isinstance(v, torch.Tensor) and k != "__step__":
                    out[f"opt:{k}"] = v
            out["opt:__step__"] = getattr(opt, "opt", opt)._step
        return out

    def lint_artifacts(self, *args, **kwargs) -> Dict[str, Any]:
        """Shardlint's artifacts of this step on these inputs (module
        docstring): {"records", "scopes", "mesh", "comm_axis", "state",
        "launches"}. The step's state is put back and the graph this
        made is dropped."""
        opt = self.model.optimizer if self.train_step else None
        comm = getattr(opt, "comm", None)
        keep = _TrainingState(self.model, opt)
        cuda = any(p.is_cuda for p in self.model.parameters())
        try:
            return collect_lint_artifacts(
                lambda: self(*args, **kwargs), self._state_tensors,
                mesh=getattr(comm, "mesh", None),
                comm_axis=getattr(comm, "axis_name", None),
                across=("the capture and a replay of the step" if cuda
                        else "two calls of the step"))
        finally:
            self._cache.clear()
            keep.restore()

    def _gathered_block_bytes(self) -> int:
        from singa_tpu_torch.communicator import pspec_axis_names

        opt = self.model.optimizer if self.train_step else None
        mesh = getattr(getattr(opt, "comm", None), "mesh", None)
        if mesh is None:
            return 0
        total = 0
        for st in self.model.modules():
            if not isinstance(st, layer_module.ScanTransformerStack) or (
                    st.zero3_axis not in mesh.axis_names):
                continue
            tp_world = (mesh.axis_size(st.tp_axis)
                        if st.tp_axis in mesh.axis_names else 1)
            block = 0
            for name in st.STACKED:
                t = getattr(st, name)
                full = getattr(t, "placed", None)
                full = full[0] if full else tuple(t.shape)
                per_block = math.prod(full[1:]) * t.element_size()
                if st.tp_axis is not None and (
                        st.tp_axis in pspec_axis_names(t)):
                    per_block //= tp_world  # this rank's tp block
                block += per_block
            total += (2 if st.overlap else 1) * block
        return total

    def _attention_bytes(self, tensors) -> int:
        """The reference's analytic dense-equivalent attention scores at
        world 1 (singa_tpu/graph.py:1023-1064): per live block of each
        scan stack, B x heads x T x T fp32 scores of the first operand
        with two dims (the tokens)."""
        tok = next((t for t in tensors if t.dim() >= 2), None)
        if tok is None:
            return 0
        b, t = int(tok.shape[0]), int(tok.shape[1])
        total = 0
        for mod in self.model.modules():
            if isinstance(mod, layer_module.ScanTransformerStack):
                live = 1 if mod.remat == "per_block" else mod.n_blocks
                total += live * b * mod.num_heads * t * t * 4
        return total


def check_param_shard_divisibility(named_params, mesh) -> None:
    """Every pspec'd dim of a parameter must divide evenly over the
    product of its entry's axes on `mesh` (reference :314-340): raises
    naming the parameter, before it is placed."""
    for n, t in named_params.items():
        full = getattr(t, "placed", None)
        full = full[0] if full else tuple(t.shape)
        for i, entry in enumerate(getattr(t, "pspec", None) or ()):
            axes = entry if isinstance(entry, (tuple, list)) else (entry,)
            named = [ax for ax in axes if ax and ax in mesh.axis_names]
            world = math.prod(mesh.axis_size(ax) for ax in named)
            if world > 1 and full[i] % world:
                desc = "x".join(f"'{ax}'" for ax in named)
                raise ValueError(
                    f"parameter {n!r}: dim {i} (size {full[i]}) does not "
                    f"divide evenly over the {desc} mesh ax"
                    f"{'es' if len(named) > 1 else 'is'} (size {world}); "
                    f"pick the model dims as multiples of the axis size")


def check_pipelined_stacks(model, mesh) -> None:
    """A pipelined stack's blocks must divide over its pipe axis
    (reference :400-411); checked before the stack is placed, where the
    generic check of its stacked dims would raise first."""
    for lyr in model.modules():
        if isinstance(lyr, (layer_module.PipelineStack,
                            layer_module.PipelineTransformerStack)):
            pax = lyr.pipe_axis
            if pax in mesh.axis_names and (
                    lyr.n_blocks % mesh.axis_size(pax)):
                raise ValueError(
                    f"{type(lyr).__name__}(n_blocks={lyr.n_blocks}) does "
                    f"not divide evenly over the '{pax}' mesh axis (size "
                    f"{mesh.axis_size(pax)}); pick n_blocks as a multiple "
                    f"of the axis size")


def check_sharded_layers(model, mesh, model_moe_axis, ep_world: int
                         ) -> None:
    """The layer <-> model couplings of a distributed step (reference
    `_check_moe_layers`, :342-430), checked before it runs: a scanned
    stack's heads must divide over its tp axis (tp splits whole heads);
    a stack's `seq_axis` must be the model's (else the ring would run
    over replicated tokens); a `MoEFFN(moe_axis=)` needs the model to
    declare the same `moe_axis` (else the batch is replicated over the
    axis and expert gradients come out ep-fold), and its experts must
    divide over the axis; a pipelined stack's blocks must divide over its
    pipe axis (`check_pipelined_stacks`)."""
    check_pipelined_stacks(model, mesh)
    for lyr in model.modules():
        if isinstance(lyr, layer_module.ScanTransformerStack):
            tp_ax = lyr.tp_axis
            if tp_ax in mesh.axis_names and (
                    lyr.num_heads % mesh.axis_size(tp_ax)):
                raise ValueError(
                    f"ScanTransformerStack(num_heads={lyr.num_heads}) does "
                    f"not divide evenly over the '{tp_ax}' mesh axis (size "
                    f"{mesh.axis_size(tp_ax)}); head-parallel TP shards "
                    f"whole heads")
            sq_ax = lyr.seq_axis
            model_sq = getattr(model, "seq_axis", None)
            if sq_ax in mesh.axis_names and sq_ax != model_sq:
                raise ValueError(
                    f"ScanTransformerStack(seq_axis={sq_ax!r}) inside a "
                    f"model whose seq_axis is {model_sq!r}: ring attention "
                    f"needs the MODEL to declare the axis (self.seq_axis = "
                    f"{sq_ax!r}) so the token arguments shard over it")
        elif isinstance(lyr, layer_module.MoEFFN):
            ax = lyr.moe_axis
            if ax is None or ax not in mesh.axis_names:
                continue
            if ax != model_moe_axis:
                raise ValueError(
                    f"layer.MoEFFN(moe_axis={ax!r}) inside a model whose "
                    f"moe_axis is {model_moe_axis!r}: expert parallelism "
                    f"needs the MODEL to declare the axis (self.moe_axis = "
                    f"{ax!r}) so the batch shards over (data, {ax}) and "
                    f"expert grads skip the {ax}-axis reduction; without it "
                    f"expert gradients come out {mesh.axis_size(ax)}x too "
                    f"large")
            if lyr.n_experts % ep_world:
                raise ValueError(
                    f"layer.MoEFFN(n_experts={lyr.n_experts}) does not "
                    f"divide evenly over the '{ax}' mesh axis (size "
                    f"{ep_world}); pick n_experts as a multiple of the axis "
                    f"size")


class _TrainingState:
    """A copy of what a step changes, put back in place by `restore`:
    parameters, buffers, the optimizer's `dump_states` (slots, the step
    counter, the sentinel's scalars, DistOpt's residuals and master
    shard) and its master-shard flag, the CPU and CUDA generators and
    the rank generators (`autograd.rank_draws`; one the step made is
    forgotten, so the next step makes it again)."""

    def __init__(self, model, opt):
        self.model, self.opt = model, opt
        self.tensors = list(model.parameters()) + list(model.buffers())
        with torch.no_grad():
            self.values = [t.detach().clone() for t in self.tensors]
            self.opt_states = None if opt is None else {
                k: v.detach().clone() if isinstance(v, torch.Tensor) else v
                for k, v in opt.dump_states().items()}
        self.master_set = getattr(opt, "_z_master_set", None)
        self.rng = torch.get_rng_state()
        self.cuda_rng = (torch.cuda.get_rng_state_all()
                         if torch.cuda.is_initialized() else None)
        self.rank_gens = {k: (v[0].get_state(), v[1])
                          for k, v in autograd._RANK_GENERATORS.items()}
        self.rank_restored = dict(autograd._RANK_RESTORED)

    def restore(self) -> None:
        with torch.no_grad():
            for t, v in zip(self.tensors, self.values):
                t.copy_(v)
        if self.opt is not None:
            self.opt.load_states(self.opt_states)
            if self.master_set is not None:
                self.opt._z_master_set = self.master_set
        torch.set_rng_state(self.rng)
        if self.cuda_rng is not None:
            torch.cuda.set_rng_state_all(self.cuda_rng)
        gens = autograd._RANK_GENERATORS
        for k in list(gens):
            if k not in self.rank_gens:
                del gens[k]
            else:
                state, seed = self.rank_gens[k]
                gens[k][0].set_state(state)
                gens[k][1] = seed
        autograd._RANK_RESTORED.clear()
        autograd._RANK_RESTORED.update(self.rank_restored)


def _kernel_launches() -> Dict[str, int]:
    return {"flash_fwd": fa.FLASH_FWD_LAUNCHES,
            "flash_bwd_dq": fa.FLASH_BWD_DQ_LAUNCHES,
            "flash_bwd_dkv": fa.FLASH_BWD_DKV_LAUNCHES,
            "max_pool_bwd": max_pool.MAX_POOL_BWD_LAUNCHES}


def _snapshot(state: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    return {n: (t.data_ptr(), str(t.dtype).replace("torch.", ""),
                tuple(int(s) for s in t.shape)) for n, t in state.items()}


def collect_lint_artifacts(run: Callable, state: Callable, mesh=None,
                           comm_axis: Optional[str] = None,
                           again: Optional[Callable] = None,
                           across: str = "two calls of the step"
                           ) -> Dict[str, Any]:
    """`run()` once under a collective recorder, then `again()` (default:
    `run` again) unrecorded; `state()` ({name: tensor}) is snapshotted
    after each. Returns {"records" (every rank of `mesh`'s group,
    merged after both runs), "scopes", "mesh", "comm_axis", "state":
    {"across", "snapshots"}, "launches": the kernels each run launched
    ({"recorded", "again"})}. The caller puts the state back."""
    from singa_tpu_torch.analysis.trace import CollectiveRecorder

    start = _kernel_launches()
    with CollectiveRecorder() as rec:
        run()
    first = _kernel_launches()
    snaps = [_snapshot(state())]
    (again or run)()
    second = _kernel_launches()
    snaps.append(_snapshot(state()))
    group = getattr(mesh, "group", None)
    return {"records": rec.merged(group), "scopes": dict(rec.scopes),
            "mesh": mesh, "comm_axis": comm_axis,
            "state": {"across": across, "snapshots": snaps},
            "launches": {
                "recorded": {k: first[k] - start[k] for k in first},
                "again": {k: second[k] - first[k] for k in first}}}


def _step_for(model, train: bool) -> GraphStep:
    """A fresh GraphStep over the model's training step (or forward)."""
    method = model.forward
    if train:
        if getattr(model, "_user_train_one_batch", None) is None:
            method = type(model).train_one_batch.__get__(model)
        else:
            def method(*args, **kwargs):
                # a DistOpt model's distributed step on this rank's share
                step, args = model._train_route(args)
                return step(*args, **kwargs)
    return GraphStep(model, method, train_step=train)


def step_memory_analysis(model, *args, train: bool = True) -> Dict[str, int]:
    """`GraphStep.memory_analysis` of a model's training step (or eval
    forward) on these inputs; the remat policies' memory floors are
    measured with it."""
    return _step_for(model, train).memory_analysis(*args)


def step_lint_artifacts(model, *args, train: bool = True) -> Dict[str, Any]:
    """`GraphStep.lint_artifacts` of a model's training step (or eval
    forward) on these inputs: what shardlint's rules read."""
    return _step_for(model, train).lint_artifacts(*args)


def hlo_text(model, *args, train: bool = True) -> str:
    """The recorded collectives of one step on these inputs, one line a
    call, every rank's (the reference returns the lowered StableHLO; a
    PyTorch step has none, and this dump is what shardlint reads)."""
    art = step_lint_artifacts(model, *args, train=train)
    return "\n".join(r.line() for recs in art["records"] for r in recs)
