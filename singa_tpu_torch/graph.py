"""The captured training step (counterpart of singa_tpu/graph.py's
`GraphStep`, :146-172 and :717-786).

`GraphStep` wraps a model's bound `train_one_batch` and keeps one entry
per key: the tensor operands' shapes and dtypes, the static arguments,
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
  the optimizer update) as one `torch.cuda.CUDAGraph` over static copies
  of the tensor operands, then replays it once, which is that call's
  step;
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
and `train_step_ms` (host wall of a call) while the hot-path metrics are
on. `captures` and `replays` count the same on the instance.
"""

from __future__ import annotations

import gc
import threading
import time
import weakref
from typing import Any, Callable, Dict

import numpy as np
import torch

from singa_tpu_torch import autograd
from singa_tpu_torch import layer as layer_module
from singa_tpu_torch.observability import metrics as obs_metrics
from singa_tpu_torch.observability import trace as obs_trace
from singa_tpu_torch.ops import flash_attention as fa
from singa_tpu_torch.ops import max_pool

__all__ = ["GraphStep", "CAPTURE_LOCK", "private_stream"]

#: one CUDA Graph capture at a time in the process (training steps and
#: the serving engines, which may be pumped from several threads)
CAPTURE_LOCK = threading.Lock()
#: the streams held by live graph owners (`cuda_stream` handles): cuBLAS
#: keys its workspace by (handle, stream), and a graph keeps the
#: workspace of the stream it was captured on, so owners that run at
#: once must capture, and run, on streams no other owner uses
_HELD_STREAMS: set = set()


def private_stream(owner, device) -> torch.cuda.Stream:
    """A CUDA stream from PyTorch's pool that no other live owner holds,
    released when `owner` is collected."""
    for _retry in range(2):
        for _ in range(64):
            st = torch.cuda.Stream(device)
            if st.cuda_stream not in _HELD_STREAMS:
                _HELD_STREAMS.add(st.cuda_stream)
                weakref.finalize(owner, _HELD_STREAMS.discard,
                                 st.cuda_stream)
                return st
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


class _Captured:
    __slots__ = ("graph", "static", "out", "opt_steps")

    def __init__(self, graph, static, out, opt_steps):
        self.graph, self.static, self.out = graph, static, out
        self.opt_steps = opt_steps


#: a key whose first (uncaptured) call has run on the card
_WARM = object()


class GraphStep:
    """A model's training step `method(*args, **kwargs)`, captured per
    key on the card and plain on the CPU (see the module docstring)."""

    def __init__(self, model, method: Callable):
        self.model = model
        self.method = method
        self._cache: Dict[Any, Any] = {}
        self._stamp = layer_module.mutation_stamp()
        self._stream = None
        self._step_metrics = None
        #: captures made (builds, on the CPU) and replays run
        self.captures = 0
        self.replays = 0

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
                with obs_trace.span("graph.compile", train=True):
                    out = self.method(*args, **kwargs)
            else:
                out = self.method(*args, **kwargs)
        elif entry is None:
            self._cache[key] = _WARM
            out = self._on_stream(dev, lambda: self.method(*args, **kwargs))
        else:
            if entry is _WARM:
                obs_metrics.counter("graph_compiles").inc()
                with obs_trace.span("graph.compile", train=True):
                    entry = self._capture(dev, args, kwargs, dyn_idx,
                                          tensors)
                self._cache[key] = entry
            out = self._replay(dev, entry, tensors)
        if t0 is not None:
            self._record_step(time.perf_counter() - t0)
        return _map(out, torch.Tensor.detach)

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
        opt = self.model.optimizer
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
                    out = self.method(*call_args, **kwargs)
            except RuntimeError as e:
                raise RuntimeError(
                    f"capturing the training step failed: {e}. A tape "
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
