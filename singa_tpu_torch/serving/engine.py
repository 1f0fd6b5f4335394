"""Continuous-batching decode engine over a paged KV cache (counterpart
of singa_tpu/serving/engine.py, the single-device engine).

One decode step serves N concurrent request streams, and requests are
admitted and evicted BETWEEN steps without rebuilding anything:

- **Continuous batching**: the decode step has a fixed `slots`-wide
  batch; every slot carries its own cursor (`lengths`), sampling seed,
  generated-token count and temperature. Inactive slots compute values
  that masking and the host bookkeeping never surface. Admit and evict
  only change small host arrays (page table, cursors).
- **Paged KV cache**: K/V live in fixed-size blocks of one pool per
  layer, allocated once, (NB, bs, H, hd) rows first; a slot -> block
  page table (`layer.paged_kv_gather` / `paged_kv_token_write`)
  reassembles each slot's logical cache bitwise. Blocks are allocated
  at admission for the request's worst case and freed at eviction; an
  unservable request is refused with the capacity math
  (`serving/blocks.py`).
- **Prefill/decode disaggregation**: prefill is the model's own
  full-window prefill (`GPT._decode_fns(window)[0]`) with its own batch
  (`prefill_batch`); it writes whole pages through the page table and
  the decode step reads them.

On the card the decode step is captured ONCE as a `torch.cuda.CUDAGraph`
at construction. Everything it touches is allocated before capture: the
pools (written in place, scales included under int8), the parameters
and static device buffers for the page table, last tokens, positions,
seeds, generated-token counts, sample flags and temperatures. Before
each replay the host copies its arrays into those buffers; the step
never syncs the host inside. `decode_compiles` counts captures and stays
1 across any admit/evict pattern (the reference's compile-count probe).
On the CPU the same function runs uncaptured, and the count counts
builds. A capture that fails raises: there is no eager fallback on the
card. The suffix prefill (prefix cache, chunked admission), one
block_size-wide chunk of fixed shape, is captured the same way, once per
batch width at its first use: uncaptured, its ~400 launches from Python
made a warm admission slower than a cold one.

Correctness oracle: TOKEN IDENTITY. Every float op of the decode step
mirrors the model's dense `decode_step`, with the dense per-slot cache
replaced by the paged gather (pure data movement for fp32 pools), and
tokens are picked by the model's `pick_rows`, whose sample depends only
on (seed, generated-token index, logits). So every stream equals the
solo `GPT.generate(use_cache=True)` of the same prompt, seed and
temperature (exactly on the CPU; on the card up to the rounding of
products of another batch width). bf16 and int8 pools dequantize at the
gather and diverge only by the storage rounding.

Requests must fit one window (prompt + max_new <= window): refused at
admission, by name, as in the reference.

Not ported here: the tensor-parallel decode and the prefill mesh
(`mesh=`, `tp_axis=`, `prefill_mesh=`, `prefill_axis=` raise, naming
ROADMAP queue 1 items 10 and 13-15) and the shardlint surface.
"""

from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from singa_tpu_torch import layer
from singa_tpu_torch.models.gpt import GPT, pick_rows
from singa_tpu_torch.observability import metrics as obs_metrics
from singa_tpu_torch.observability import trace as obs_trace
from singa_tpu_torch.serving.blocks import (
    KV_DTYPES, BlockAllocator, OutOfBlocksError, PrefixIndex,
    blocks_needed, kv_block_bytes)
from singa_tpu_torch.tensor import paged_gather, quantize_int8_rows

__all__ = ["Request", "ServingEngine", "OutOfSlotsError",
           "OutOfBlocksError", "PrefillTicket", "emitted_token_count"]

#: one CUDA Graph capture at a time in the process: engines pumped from
#: several threads (the replica router) capture their suffix widths
#: lazily
_CAPTURE_LOCK = threading.Lock()
#: the streams of live engines on the card (`cuda_stream` handles):
#: cuBLAS keys its workspace by (handle, stream), and a graph keeps the
#: workspace of the stream it was captured on, so engines stepped at
#: once must capture, and run, on streams no other engine uses
_ENGINE_STREAMS: set = set()


def _private_stream(owner, device):
    """A CUDA stream from PyTorch's pool that no other live engine
    holds, released when `owner` is collected."""
    for _ in range(64):
        st = torch.cuda.Stream(device)
        if st.cuda_stream not in _ENGINE_STREAMS:
            _ENGINE_STREAMS.add(st.cuda_stream)
            weakref.finalize(owner, _ENGINE_STREAMS.discard, st.cuda_stream)
            return st
    raise RuntimeError(
        f"every pooled CUDA stream is held by one of "
        f"{len(_ENGINE_STREAMS)} live serving engines")


def emitted_token_count(emitted) -> int:
    """Tokens in one `step()`'s emitted dict: {rid: token}, or
    {rid: [tokens]} from an engine that emits several per stream."""
    return sum(len(t) if isinstance(t, list) else 1
               for t in emitted.values())


# -- KV pool storage formats --------------------------------------------------
#
# A pool is a ``(data, scales)`` pair: ``data (NB, bs, H, hd)`` in the
# storage dtype and ``scales`` None (fp32/bf16) or ``(NB, bs)`` float32
# per-row quantization scales riding the same page table (int8). Each
# layer's pair is a view into one (L, ...) allocation per K and V.


class _KVOps:
    """Format-dispatched paged read/write ops over (data, scales)
    pools. Writes are in place."""

    def __init__(self, kv_dtype: str):
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype {kv_dtype!r} is not a pool storage format "
                f"(choose from {KV_DTYPES})")
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype == "int8"
        self.store_dtype = {"fp32": torch.float32, "bf16": torch.bfloat16,
                            "int8": torch.int8}[kv_dtype]

    def make_pools(self, n_layers: int, num_blocks: int, block_size: int,
                   heads: int, hd: int, device):
        """(stacked data, stacked scales or None, per-layer pairs)."""
        data = torch.zeros((n_layers, num_blocks, block_size, heads, hd),
                           dtype=self.store_dtype, device=device)
        scales = (torch.zeros((n_layers, num_blocks, block_size),
                              dtype=torch.float32, device=device)
                  if self.quantized else None)
        pairs = tuple((data[i], None if scales is None else scales[i])
                      for i in range(n_layers))
        return data, scales, pairs

    def token_write(self, pool, page_table, pos, kv) -> None:
        """One new row per slot: kv (S, H, hd) at position pos (S,)."""
        data, sc = pool
        if not self.quantized:
            layer.paged_kv_token_write(data, page_table, pos,
                                       kv.to(self.store_dtype))
            return
        q, s = quantize_int8_rows(kv)
        layer.paged_kv_token_write(data, page_table, pos, q)
        layer.paged_kv_token_write(sc, page_table, pos, s)

    def window_write(self, pool, page_table, pos, kv) -> None:
        """T new rows per slot: kv (S, T, H, hd) at pos[s] + j."""
        data, sc = pool
        if not self.quantized:
            layer.paged_kv_window_write(data, page_table, pos,
                                        kv.to(self.store_dtype))
            return
        q, s = quantize_int8_rows(kv)
        layer.paged_kv_window_write(data, page_table, pos, q)
        layer.paged_kv_window_write(sc, page_table, pos, s)

    def pages_write(self, pool, pages, kv_pages) -> None:
        """Whole pages (the prefill path): kv_pages (B, P, bs, H, hd) at
        blocks pages (B, P)."""
        data, sc = pool
        if not self.quantized:
            layer.paged_kv_pages_write(data, pages,
                                       kv_pages.to(self.store_dtype))
            return
        q, s = quantize_int8_rows(kv_pages)
        layer.paged_kv_pages_write(data, pages, q)
        layer.paged_kv_pages_write(sc, pages, s)

    def gather(self, pool, page_table):
        """Every slot's dense (S, H, W, hd) cache view; int8 dequantized
        to float32, fp32 and bf16 as stored (the step casts to fp32)."""
        data, sc = pool
        got = layer.paged_kv_gather(data, page_table)
        if not self.quantized:
            return got
        s = paged_gather(sc, page_table)              # (S, W)
        return got.float() * s[:, None, :, None]


class _ChunkWork:
    """Staged, resumable suffix-prefill state for one admission group:
    `advance_prefill` runs one block_size-wide causal pass per call. `c`
    is the next chunk index; the group is exhausted at c == n_chunks."""

    __slots__ = ("items", "starts", "seeds", "temps", "sample",
                 "rows_d", "t0m1_d", "last", "c", "n_chunks")


class PrefillTicket:
    """A dispatched-but-unfinished batch of admissions: each chunk's
    device results and its reserved (slot, request, page-row) triples.
    Created by `ServingEngine.begin_prefill_async`, consumed by
    `finish_prefill` at a step boundary (or `abort_prefill`, which hands
    the requests back unstarted). A CHUNKED ticket also carries staged
    `_ChunkWork` groups that `advance_prefill` drains one pass at a
    time; it is not `ready()` until every group has run."""

    __slots__ = ("chunks", "work", "t0")

    def __init__(self, chunks, work=None):
        self.chunks = chunks
        self.work: List[_ChunkWork] = work if work is not None else []
        self.t0 = time.perf_counter()

    @property
    def requests(self) -> List["Request"]:
        got = [req for _, items in self.chunks for _, req, _ in items]
        got.extend(req for w in self.work for _, req, _ in w.items)
        return got

    def ready(self) -> bool:
        """Whether `finish_prefill` would complete without waiting on
        the device: no staged chunk work remains and every dispatched
        chunk's work has finished on its stream."""
        if self.work:
            return False
        return all(chunk[-1] is None or chunk[-1].query()
                   for chunk, _ in self.chunks)


class OutOfSlotsError(RuntimeError):
    """Admission refused: every decode slot is occupied. A
    queue-and-retry condition, like OutOfBlocksError."""


@dataclass
class Request:
    """One decode stream. `on_token(token, done)` fires on the engine's
    host thread once per emitted token (the first comes from prefill,
    at admission); `tokens` accumulates them for callers that poll."""

    rid: object
    prompt: np.ndarray
    max_new: int
    temperature: float = 0.0
    seed: int = 0
    on_token: Optional[Callable[[int, bool], None]] = None
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    #: prompt tokens served from the prefix cache at admission (a
    #: multiple of block_size; 0 = cold). Set by the engine's reserve.
    cached_tokens: int = 0
    #: scheduler lane and fairness key, carried for the scheduler that
    #: comes with the frontend (ROADMAP queue 1 item 11)
    priority: str = "normal"
    tenant: Optional[str] = None

    def _emit(self, tok: int, done: bool) -> None:
        self.tokens.append(int(tok))
        self.done = done
        if self.on_token is not None:
            self.on_token(int(tok), done)


class ServingEngine:
    """Continuous-batching decode over a paged KV pool for one GPT.

    `model` is a port `GPT` (either decoder); the engine runs on its
    device. `slots` is the decode batch width, `window` the per-request
    logical cache length (= pages x block_size), `num_blocks` the pool
    size (default: every slot at full window, +1 trash). `kv_dtype`
    picks the pool storage format ("fp32", "bf16", "int8"), and
    `pool_bytes=` sizes the pool by a byte budget instead of a block
    count. `prefix_cache=True` shares full prompt blocks across
    requests by content (copy-on-write, suffix-only prefill).
    """

    def __init__(self, model, *, slots: int = 4, block_size: int = 16,
                 window: int = 64, num_blocks: Optional[int] = None,
                 prefill_batch: int = 1, kv_dtype: str = "fp32",
                 pool_bytes: Optional[int] = None, mesh=None,
                 tp_axis: Optional[str] = None, prefill_mesh=None,
                 prefill_axis: Optional[str] = None,
                 prefix_cache: bool = False):
        for name, val in (("mesh", mesh), ("tp_axis", tp_axis)):
            if val is not None:
                raise NotImplementedError(
                    f"ServingEngine({name}=) is the tensor-parallel decode "
                    f"(ROADMAP queue 1 item 10, tp decode, over the mesh of "
                    f"items 13-15)")
        for name, val in (("prefill_mesh", prefill_mesh),
                          ("prefill_axis", prefill_axis)):
            if val is not None:
                raise NotImplementedError(
                    f"ServingEngine({name}=) is the disaggregated prefill "
                    f"mesh (ROADMAP queue 1 items 10 and 13-15)")
        if window % block_size:
            raise ValueError(
                f"window {window} must be a multiple of block_size "
                f"{block_size} (the page table maps whole blocks)")
        if window > model.pos.table.shape[0]:
            raise ValueError(
                f"window {window} exceeds the model's max_len "
                f"{model.pos.table.shape[0]}")
        self.model = model
        self.device = model.device
        #: the stream this engine captures its graphs on (the card only);
        #: a caller stepping several engines at once (the router's
        #: parallel pump) steps each on its own
        self.stream = (_private_stream(self, self.device)
                       if self.device.type == "cuda" else None)
        self.slots = int(slots)
        self.block_size = int(block_size)
        self.window = int(window)
        self.pages = window // block_size
        self.prefill_batch = int(prefill_batch)

        model._ensure_initialized(window)
        #: the detached parameter dict the step closes over
        self.pv = model._functional_params()
        #: the model's own prefill, so the first token is generate's
        self._prefill = model._decode_fns(window)[0]
        self.heads = model.decoder.num_heads
        self.d_model = model.d_model
        self.hd = self.d_model // self.heads
        self._n_layers = len(self.pv["blocks"])

        self.kv_dtype = kv_dtype
        self._kv = _KVOps(kv_dtype)
        kv_bytes = kv_block_bytes(self._n_layers, self.heads, self.hd,
                                  self.block_size, kv_dtype)
        if pool_bytes is not None:
            if num_blocks is not None:
                raise ValueError(
                    "pass num_blocks= OR pool_bytes=, not both (they "
                    "both size the same pool)")
            # a block's full cost: subclasses with sibling pools on
            # the same page table (the speculative draft cache) add
            # their share, so the budget holds for the whole allocation
            num_blocks = max(
                2, pool_bytes // (kv_bytes + self._extra_kv_block_bytes()))
        elif num_blocks is None:
            num_blocks = self.slots * self.pages + 1
        self.allocator = BlockAllocator(num_blocks, block_size,
                                        bytes_per_block=kv_bytes)
        args = (self._n_layers, num_blocks, self.block_size, self.heads,
                self.hd, self.device)
        self._kdata, self._kscale, self.kpools = self._kv.make_pools(*args)
        self._vdata, self._vscale, self.vpools = self._kv.make_pools(*args)
        self._write_prefill = self._build_write_prefill(self.heads, self.hd)

        s = self.slots
        self.page_table = np.zeros((s, self.pages), np.int32)
        self.lengths = np.zeros(s, np.int32)
        self.active = np.zeros(s, bool)
        self.last_tok = np.zeros(s, np.int32)
        self.n_gen = np.zeros(s, np.int32)
        self.temps = np.ones(s, np.float32)
        self.sample = np.zeros(s, bool)
        self.seeds = np.zeros(s, np.int64)
        self._reqs: List[Optional[Request]] = [None] * s

        self.steps = 0
        self.tokens_emitted = 0
        # telemetry handles, cached at the first enabled use
        self._step_metrics = None
        self._prefill_metrics = None
        self._chunk_counter = None
        # overlapped prefill: slots reserved with a prefill in flight
        # keep trash page-table rows until finish_prefill installs them,
        # and evictions of them defer until then
        self._pending: set = set()
        self._evict_after_prefill: set = set()

        # -- prefix cache: content-addressed block sharing (opt-in) -----
        self.prefix_cache = bool(prefix_cache)
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.cow_copies = 0
        self._prefix_metrics = None
        self._cow_metric = None
        self._slot_cached = [0] * s
        self._slot_reg_pages = [0] * s
        self._slot_key: List[Optional[bytes]] = [None] * s
        if self.prefix_cache:
            self.prefix_index: Optional[PrefixIndex] = PrefixIndex(
                self._prefix_fingerprint(), self.block_size)
            # an LRU reclaim rewrites the block: its index entry dies first
            self.allocator.on_reclaim = self.prefix_index.purge_block
        else:
            self.prefix_index = None
        self._suffix = None
        self._suffix_builds = 0
        #: lazily captured graphs on the card (the suffix chunk per
        #: batch width): {key: (graph, static inputs, static output)}
        self._graphs: Dict[Tuple, Tuple] = {}

        # -- the decode step: static inputs, then one build/capture -----
        p = self.pages
        #: host staging of the step's integer inputs, one row per slot:
        #: page table | last token | position | seed | n_gen | sample
        self._h_ints = np.zeros((s, p + 5), np.int64)
        self._d_ints = torch.zeros((s, p + 5), dtype=torch.long,
                                   device=self.device)
        self._d_temps = torch.ones(s, dtype=torch.float32,
                                   device=self.device)
        self._forward = self._build_decode_forward()
        self._graph = None
        self._graph_out = None
        self._decode_builds = 0
        self._build_step()

    # -- the decode step -----------------------------------------------------

    def _extra_kv_block_bytes(self) -> int:
        """Per-block bytes of any sibling pools riding the same page
        table (0 here; the speculative engine reports its draft pools'
        share so `pool_bytes=` budgets the whole allocation)."""
        return 0

    def _prefix_fingerprint(self) -> str:
        """Every knob that shapes a KV block's content for a given token
        prefix: two engines with equal fingerprints make comparable
        blocks."""
        return (f"gpt:v{self.model.vocab_size}:d{self.d_model}"
                f":h{self.heads}:L{self._n_layers}"
                f":bs{self.block_size}:W{self.window}"
                f":{self.kv_dtype}:tp1" + self._fingerprint_extra())

    def _fingerprint_extra(self) -> str:
        """Extra fingerprint material from subclasses whose sibling
        pools ride the same blocks (the speculative engine adds its
        draft dims: a block's draft rows are part of its content)."""
        return ""

    def _step_inputs(self):
        """Views of the static device inputs: (page_table, tok, pos,
        seeds, n_gen, sample, temps)."""
        d, p = self._d_ints, self.pages
        return (d[:, :p], d[:, p], d[:, p + 1], d[:, p + 2], d[:, p + 3],
                d[:, p + 4] != 0, self._d_temps)

    def _upload(self) -> None:
        """Copy the host's slot state into the static device inputs."""
        h, p = self._h_ints, self.pages
        h[:, :p] = self.page_table
        h[:, p] = self.last_tok
        h[:, p + 1] = self.lengths
        h[:, p + 2] = self.seeds
        h[:, p + 3] = self.n_gen
        h[:, p + 4] = self.sample
        self._d_ints.copy_(torch.from_numpy(h))
        self._d_temps.copy_(torch.from_numpy(self.temps))

    def _step_fn(self) -> torch.Tensor:
        """The decode step over the static inputs: the shared decode
        forward, then the token pick. Returns the next tokens (S,)."""
        pt, tok, pos, seeds, n_gen, sample, temps = self._step_inputs()
        logits = self._forward(self.pv, self.kpools, self.vpools, pt,
                               tok, pos)
        return pick_rows(logits, seeds, n_gen, temps, sample)

    def _capture(self, fn):
        """Capture fn() once as a CUDA Graph: (graph, its output).
        Warm-ups and capture run on the engine's own stream (off the
        caller's, as PyTorch's CUDA Graph notes ask), so its graphs hold
        a cuBLAS workspace no other engine's work touches. One capture
        at a time in the process, in thread-local mode, so an engine
        pumped on another thread keeps launching meanwhile. A capture
        that fails raises: there is no eager fallback."""
        side = self.stream
        with _CAPTURE_LOCK, torch.inference_mode():
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(3):
                    fn()
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                out = fn()
            torch.cuda.current_stream(self.device).wait_stream(side)
        return graph, out

    def _replay(self, key, fn, args):
        """fn(*args): on the CPU a plain call; on the card fn captured
        once per `key` over static copies of `args` (first use), then
        replayed with `args` copied into them. The output tensors are
        the graph's own, rewritten by the next replay."""
        if self.device.type != "cuda":
            return fn(*args)
        if key not in self._graphs:
            static = tuple(torch.zeros_like(a) for a in args)
            graph, out = self._capture(lambda: fn(*static))
            self._graphs[key] = (graph, static, out)
        graph, static, out = self._graphs[key]
        for dst, src in zip(static, args):
            dst.copy_(src)
        graph.replay()
        return out

    def _build_step(self) -> None:
        """Capture the step once on the card; on the CPU the step runs
        uncaptured. The static page table is all trash here, so the
        warm-up writes land in block 0."""
        self._decode_builds += 1
        if self.device.type == "cuda":
            self._graph, self._graph_out = self._capture(self._step_fn)

    def _run_step(self) -> torch.Tensor:
        if self._graph is None:
            return self._step_fn()
        self._graph.replay()
        return self._graph_out

    def _build_decode_forward(self, heads=None, hd=None, d=None):
        """The decode forward shared by the step and `peek_logits`:
        every float op mirrors the model's dense `decode_step` (same
        einsums, masking and fp32 LayerNorm), with the dense per-slot
        cache replaced by the paged gather. Dims default to the target's
        (the speculative engine builds its draft micro-step at the
        draft's)."""
        heads = self.heads if heads is None else heads
        hd = self.hd if hd is None else hd
        d = self.d_model if d is None else d
        window = self.window
        scale = hd ** -0.5
        ln = GPT._ln
        kv = self._kv

        def ffn(h, bp):
            f = F.gelu(h @ bp["w1"] + bp["b1"], approximate="tanh")
            return f @ bp["w2"] + bp["b2"]

        def forward(pv, kpools, vpools, page_table, tok, pos):
            s = tok.shape[0]
            h = pv["tok"][tok] + pv["pos"][pos.clamp(max=window - 1)]
            live = (torch.arange(window, device=tok.device)[None, None, :]
                    <= pos[:, None, None])               # (S, 1, W)
            for i, bp in enumerate(pv["blocks"]):
                qkv = h @ bp["wqkv"] + bp["bqkv"]
                q, k, v = (a.reshape(s, heads, hd)
                           for a in qkv.chunk(3, dim=-1))
                kv.token_write(kpools[i], page_table, pos, k)
                kv.token_write(vpools[i], page_table, pos, v)
                kc = kv.gather(kpools[i], page_table)
                vc = kv.gather(vpools[i], page_table)
                sc = torch.einsum("bhd,bhwd->bhw", q.float(),
                                  kc.float()) * scale
                sc = sc.masked_fill(~live, -1e30)
                p = torch.softmax(sc, dim=-1)
                o = torch.einsum("bhw,bhwd->bhd", p, vc.float())
                a = o.reshape(s, d) @ bp["wo"] + bp["bo"]
                h = ln(h + a, bp["ln1_s"], bp["ln1_o"])
                h = ln(h + ffn(h, bp), bp["ln2_s"], bp["ln2_o"])
            hf = ln(h, pv["lnf_s"], pv["lnf_o"])
            return hf @ pv["head_w"] + pv["head_b"]  # (S, V)

        return forward

    def _build_window_forward(self, width: int, heads=None, hd=None,
                              d=None, with_logits: bool = True):
        """`width` new tokens per row at positions start + j, j < width:
        each block writes their K/V through the page table
        (`window_write`, never `pages_write`: a warm row maps SHARED
        pages a whole-row write would clobber; positions past the window
        go to trash), then gathers and attends causally, so the query at
        start + j sees every row up to its own. The suffix prefill's
        chunk and the speculative verify pass. Returns logits
        (B, width, V), or None with `with_logits=False` (the draft
        cache's writer, which needs only the writes)."""
        heads = self.heads if heads is None else heads
        hd = self.hd if hd is None else hd
        d = self.d_model if d is None else d
        window = self.window
        scale = hd ** -0.5
        ln = GPT._ln
        kv = self._kv

        def ffn(h, bp):
            f = F.gelu(h @ bp["w1"] + bp["b1"], approximate="tanh")
            return f @ bp["w2"] + bp["b2"]

        def forward(pv, kpools, vpools, page_table, toks, start):
            b = toks.shape[0]
            steps = torch.arange(width, device=toks.device)
            qpos = start[:, None] + steps[None, :]          # (B, width)
            h = pv["tok"][toks] + pv["pos"][qpos.clamp(max=window - 1)]
            live = (torch.arange(window, device=toks.device)
                    [None, None, None, :] <= qpos[:, None, :, None])
            for i, bp in enumerate(pv["blocks"]):
                qkv = h @ bp["wqkv"] + bp["bqkv"]
                q, k, v = qkv.chunk(3, dim=-1)
                q = q.reshape(b, width, heads, hd).transpose(1, 2)
                k = k.reshape(b, width, heads, hd)
                v = v.reshape(b, width, heads, hd)
                kv.window_write(kpools[i], page_table, start, k)
                kv.window_write(vpools[i], page_table, start, v)
                kc = kv.gather(kpools[i], page_table)   # (B, H, W, hd)
                vc = kv.gather(vpools[i], page_table)
                sc = torch.einsum("bhqd,bhwd->bhqw", q.float(),
                                  kc.float()) * scale
                sc = sc.masked_fill(~live, -1e30)
                p = torch.softmax(sc, dim=-1)
                o = torch.einsum("bhqw,bhwd->bhqd", p, vc.float())
                a = o.transpose(1, 2).reshape(b, width, d) @ bp["wo"] \
                    + bp["bo"]
                h = ln(h + a, bp["ln1_s"], bp["ln1_o"])
                h = ln(h + ffn(h, bp), bp["ln2_s"], bp["ln2_o"])
            if not with_logits:
                return None
            hf = ln(h, pv["lnf_s"], pv["lnf_o"])
            return hf @ pv["head_w"] + pv["head_b"]        # (B, width, V)

        return forward

    def _build_suffix_prefill(self, with_logits: bool = True, heads=None,
                              hd=None, d=None):
        """The suffix-only prefill: ONE block_size-wide causal chunk for
        up to `prefill_batch` admissions, with the query window anchored
        at each row's own `start` cursor (`_build_window_forward`), so
        chunk c+1's queries see chunk c's rows. Rows past a prompt write
        masked values at positions >= t0 that decode overwrites before
        any read. With `with_logits` a (B, V) last-logits accumulator
        takes row t0-1's logits in the chunk that holds it; without
        (the draft cache's writer, at the draft's dims) the chunk only
        writes."""
        C = self.block_size
        forward = self._build_window_forward(C, heads, hd, d, with_logits)
        if not with_logits:
            return forward

        def suffix(pv, kpools, vpools, page_table, toks, start, t0m1,
                   last):
            b = toks.shape[0]
            logits = forward(pv, kpools, vpools, page_table, toks, start)
            inside = (t0m1 >= start) & (t0m1 < start + C)
            lg = logits[torch.arange(b, device=toks.device),
                        (t0m1 - start).clamp(0, C - 1)]
            return torch.where(inside[:, None], lg, last)

        return suffix

    def _ensure_suffix(self) -> None:
        """Build the suffix prefill at first need (the first warm or
        chunked admission); on the CPU this is the build
        `prefix_prefill_compiles` counts."""
        if self._suffix is None:
            self._suffix = self._build_suffix_prefill()
            if self.device.type != "cuda":
                self._suffix_builds += 1

    def _run_suffix(self, rows, toks, start, t0m1, last) -> torch.Tensor:
        """One suffix chunk. On the card each batch width is captured
        once as a CUDA Graph at its first use (warm-ups with all-trash
        page rows, so their writes land in block 0), then replayed;
        uncaptured, a chunk costs some 400 launches from Python. Returns
        a fresh (B, V) accumulator."""
        key = ("suffix", toks.shape[0])
        if self.device.type == "cuda" and key not in self._graphs:
            self._suffix_builds += 1
        out = self._replay(key, lambda *a: self._suffix(
            self.pv, self.kpools, self.vpools, *a),
            (rows, toks, start, t0m1, last))
        return out.clone()

    def _build_write_prefill(self, heads: int, hd: int):
        """Prefill -> pool at the given head dims: chunk each admitted
        request's full-window K/V (L, B, H, W, hd) into pages and write
        them at the page table's blocks (slack pages land in trash
        block 0)."""
        kv, pages, bs = self._kv, self.pages, self.block_size

        def write(kpools, vpools, kc, vc, page_rows):
            b = kc.shape[1]

            def chunk(x):
                # (B, H, W, hd) -> (B, P, bs, H, hd): rows-leading pages
                return x.transpose(1, 2).reshape(b, pages, bs, heads, hd)

            for i in range(len(kpools)):
                kv.pages_write(kpools[i], page_rows, chunk(kc[i]))
                kv.pages_write(vpools[i], page_rows, chunk(vc[i]))

        return write

    def _prefill_extra(self, ctx: torch.Tensor, rows: torch.Tensor) -> None:
        """Called once per cold prefill chunk with the padded context
        batch (B, W) and its page-table rows (B, P), after the target
        pools are written and before any bookkeeping or eviction. The
        base engine needs nothing; the speculative engine prefills the
        draft cache here."""

    def _suffix_extra(self, toks: torch.Tensor, start: torch.Tensor,
                      rows: torch.Tensor) -> None:
        """Called once per suffix chunk with the chunk's tokens (B, bs),
        per-row start cursors (B,) and page-table rows (B, P), after the
        target pools are written. The base engine needs nothing; the
        speculative engine writes the draft cache's suffix here."""

    # -- observability -------------------------------------------------------

    @property
    def decode_compiles(self) -> int:
        """Decode-step captures on the card (builds on the CPU): stays 1
        across any admit/evict sequence."""
        return self._decode_builds

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    @property
    def free_slots(self) -> int:
        # occupancy counts from reservation, not from first decode
        return sum(1 for r in self._reqs if r is None)

    @property
    def slot_occupancy(self) -> float:
        """Active streams over decode slots, in [0, 1]."""
        return self.n_active / max(1, self.slots)

    @property
    def kv_utilization(self) -> float:
        """Pinned KV blocks over pool capacity, in [0, 1] (cached but
        unpinned blocks are reclaimable, so they count as free)."""
        return self.allocator.used_blocks / max(1, self.allocator.capacity)

    @property
    def pool_bytes(self) -> int:
        """Device bytes every pool on the page table holds (scales, and
        a speculative engine's draft pools, included)."""
        return sum(t.numel() * t.element_size() for t in self._cow_pools())

    def peek_logits(self) -> np.ndarray:
        """The decode-step logits (S, V) for the CURRENT slot state,
        leaving the pools as they were: the rows the forward writes are
        saved first and restored after. The bounded-divergence oracle's
        surface (fp32 against bf16/int8 engines on the same requests).
        Runs uncaptured and is not counted by `decode_compiles`."""
        with torch.inference_mode():
            self._upload()
            pt, tok, pos = self._step_inputs()[:3]
            blocks = pt.gather(1, (pos // self.block_size).clamp(
                max=self.pages - 1)[:, None])[:, 0]
            rows = pos % self.block_size
            pools = [t for t in (self._kdata, self._vdata, self._kscale,
                                 self._vscale) if t is not None]
            saved = [t[:, blocks, rows].clone() for t in pools]
            logits = self._forward(self.pv, self.kpools, self.vpools, pt,
                                   tok, pos)
            for t, old in zip(pools, saved):
                t[:, blocks, rows] = old
            return logits.float().cpu().numpy()

    # -- admission / eviction ------------------------------------------------

    def admit(self, req: Request) -> int:
        """Admit one request (slot + blocks + batched prefill + first
        token). Raises OutOfSlotsError / OutOfBlocksError (queue and
        retry), ValueError for requests no configuration could serve."""
        return self.admit_many([req])[0]

    def admit_many(self, reqs: Sequence[Request]) -> List[int]:
        """Admit several requests, prefilling them in chunks of
        `prefill_batch` (dummy-padded). On a mid-list refusal the
        already-admitted prefix stays admitted and the refusal
        propagates."""
        slots, err = self.admit_ready(reqs)
        if err is not None:
            raise err
        return slots

    def admit_ready(
            self, reqs: Sequence[Request],
    ) -> Tuple[List[int], Optional[Exception]]:
        """Reserve the longest prefix of `reqs` the current slots and
        blocks allow, prefill it in `prefill_batch` chunks, and return
        (admitted slot ids, first refusal or None): the refusal is
        returned, not raised."""
        pending: List[Tuple[int, Request]] = []
        err: Optional[Exception] = None
        for req in reqs:
            try:
                pending.append((self._reserve(req), req))
            except (OutOfSlotsError, OutOfBlocksError, ValueError) as e:
                err = e
                break
        for group in self._chunk_items(pending):
            self._prefill_chunk(group)
        return [s for s, _ in pending], err

    def _chunk_items(self, pending):
        """Split reserved items into prefill_batch-sized chunks; with the
        prefix cache on, warm and cold admissions chunk separately."""
        if not self.prefix_cache:
            groups = [pending]
        else:
            cold = [it for it in pending if it[1].cached_tokens == 0]
            warm = [it for it in pending if it[1].cached_tokens > 0]
            groups = [g for g in (cold, warm) if g]
        for g in groups:
            for i in range(0, len(g), self.prefill_batch):
                yield g[i:i + self.prefill_batch]

    def _reserve(self, req: Request) -> int:
        """Host-side half of admission: validate, claim a slot, allocate
        the request's worst-case blocks."""
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("prompt must contain at least one token")
        t0 = prompt.shape[0]
        if t0 + req.max_new > self.window:
            raise ValueError(
                f"request {req.rid!r} wants {t0} prompt + {req.max_new} "
                f"new = {t0 + req.max_new} tokens but the engine window "
                f"is {self.window}: the serving engine has no sliding "
                f"phase (a slide re-embeds every learned position — a "
                f"full-recompute workload, not a cached decode step); "
                f"raise window= or lower max_new")
        if req.max_new < 1:
            raise ValueError("max_new must be >= 1")
        free = [s for s in range(self.slots) if self._reqs[s] is None]
        if not free:
            raise OutOfSlotsError(
                f"all {self.slots} decode slots are busy — request "
                f"{req.rid!r} must wait for an eviction (or build the "
                f"engine with more slots)")
        slot = free[0]
        needed = blocks_needed(t0, req.max_new, self.block_size)
        shared: List[int] = []
        if self.prefix_cache:
            shared = self._prefix_lookup(req, prompt)
        # shared pages map into the row without costing fresh blocks; a
        # refusal raises before any incref (alloc is atomic)
        got = self.allocator.alloc(slot, needed - len(shared),
                                   shared=shared)
        row = np.zeros(self.pages, np.int32)
        row[:len(shared)] = shared
        row[len(shared):needed] = got
        self.page_table[slot] = row
        self._reqs[slot] = req
        req.prompt = prompt
        req.cached_tokens = len(shared) * self.block_size
        if self.prefix_cache:
            self._slot_cached[slot] = req.cached_tokens
            self._note_admission(bool(shared), req.cached_tokens)
        return slot

    def _prefix_lookup(self, req: Request, prompt) -> List[int]:
        """The longest resident full-block prefix of `prompt`, capped at
        (t0-1)//block_size blocks so the suffix always keeps at least
        one token (the first pick needs the logits at row t0-1)."""
        chain = self.prefix_index.chain_keys(prompt)
        req._prefix_keys = chain
        f_max = (prompt.shape[0] - 1) // self.block_size
        if f_max <= 0:
            return []
        return self.prefix_index.lookup(chain[:f_max])

    def prefix_match_tokens(self, req: Request) -> int:
        """How many prompt tokens a warm admission of `req` would serve
        from the cache right now (0 with the cache off)."""
        if not self.prefix_cache:
            return 0
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        chain = getattr(req, "_prefix_keys", None)
        if chain is None or len(chain) != prompt.size // self.block_size:
            chain = self.prefix_index.chain_keys(prompt)
            req._prefix_keys = chain
        f_max = max(0, (prompt.size - 1) // self.block_size)
        return (len(self.prefix_index.lookup(chain[:f_max]))
                * self.block_size)

    def _note_admission(self, hit: bool, cached: int) -> None:
        """Prefix-cache admission accounting: lifetime ints always, the
        metric handles only when telemetry is on."""
        if hit:
            self.prefix_hits += 1
        else:
            self.prefix_misses += 1
        if not obs_metrics.enabled():
            return
        mh = self._prefix_metrics
        if mh is None:
            mh = self._prefix_metrics = (
                obs_metrics.counter("serve_prefix_hits"),
                obs_metrics.counter("serve_prefix_misses"),
                obs_metrics.gauge("serve_shared_pages"),
                obs_metrics.gauge("serve_prefix_hit_rate"))
        ch, cm, gsh, ghr = mh
        (ch if hit else cm).inc()
        gsh.set(self.allocator.shared_pages)
        total = self.prefix_hits + self.prefix_misses
        ghr.set(self.prefix_hits / max(1, total))

    def _prefill_chunk(self, pending: List[Tuple[int, Request]]) -> None:
        """One batched prefill for up to `prefill_batch` reserved
        requests, dispatched and finished back to back."""
        items = [(slot, req, self.page_table[slot].copy())
                 for slot, req in pending]
        self._finish_chunk(self._dispatch_chunk(items), items)

    def _dispatch_chunk(self, items) -> Tuple:
        """Launch the prefill, the page writes and the first-token pick
        for up to `prefill_batch` reserved requests, without waiting on
        the device. Warm chunks route to the suffix prefill, the rest to
        the full-window prefill."""
        cached = sum(int(req.cached_tokens) for _, req, _ in items)
        with obs_trace.span("serve.prefill", batch=len(items),
                            cached_tokens=cached), torch.inference_mode():
            if cached:
                return self._dispatch_suffix_chunk(items)
            return self._dispatch_full_chunk(items)

    def _row_sampling(self, items, n: int):
        """Per-row (seeds, temps, sample) host arrays for `items`, padded
        to `n` rows."""
        seeds = np.zeros(n, np.int64)
        temps = np.ones(n, np.float32)
        sample = np.zeros(n, bool)
        for j, (_, req, _) in enumerate(items):
            seeds[j] = req.seed
            sample[j] = req.temperature > 0
            temps[j] = max(req.temperature, 1e-6)
        return seeds, temps, sample

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if t.dtype == torch.int32:
            t = t.long()
        return t.to(self.device)

    def _event(self):
        """A CUDA event marking the end of the work queued so far (None
        on the CPU, where that work is already done)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _dispatch_full_chunk(self, items) -> Tuple:
        """The cold prefill: one full-window batched forward, whole-page
        writes (safe because a cold row holds no shared pages), then the
        first-token pick from row t0-1 at generated-token index 0."""
        bp = self.prefill_batch
        ctx = np.zeros((bp, self.window), np.int64)
        rows = np.zeros((bp, self.pages), np.int64)
        t0m1 = np.zeros(bp, np.int64)
        for j, (slot, req, row) in enumerate(items):
            t0 = req.prompt.shape[0]
            ctx[j, :t0] = req.prompt
            rows[j] = row
            t0m1[j] = t0 - 1
        seeds, temps, sample = self._row_sampling(items, bp)
        ctx_d, rows_d = self._dev(ctx), self._dev(rows)
        logits, kc, vc = self._prefill(self.pv, ctx_d)
        self._write_prefill(self.kpools, self.vpools, kc, vc, rows_d)
        # before any of these slots can be evicted (a max_new=1 request
        # finishes at its prefill, and the next chunk may reuse its
        # blocks), the sibling cache fills for the same context and pages
        self._prefill_extra(ctx_d, rows_d)
        lg = logits[torch.arange(bp, device=self.device), self._dev(t0m1)]
        first = pick_rows(lg, self._dev(seeds),
                          torch.zeros(bp, dtype=torch.long,
                                      device=self.device),
                          self._dev(temps), self._dev(sample))
        return (first, seeds, temps, sample, self._event())

    def _dispatch_suffix_chunk(self, items) -> Tuple:
        """The warm prefill (prefix cache): the shared full-block prefix
        is resident, so ONLY the suffix runs, in block_size-wide causal
        chunks: stage, advance to exhaustion, pick. The same resumable
        `_ChunkWork` record the chunked admission drains one pass at a
        time, so the two can never diverge."""
        w = self._stage_suffix_work(items)
        while w.c < w.n_chunks:
            self._advance_work(w)
        return self._finish_suffix_work(w)

    def _stage_suffix_work(self, items) -> _ChunkWork:
        """Host-side setup of a suffix-prefill group without running any
        chunk: cold rows stage at start 0, warm rows at their
        cached_tokens cursor."""
        self._ensure_suffix()
        b = len(items)
        bs = self.block_size
        w = _ChunkWork()
        w.items = items
        w.starts = np.zeros(b, np.int64)
        t0m1 = np.zeros(b, np.int64)
        rows = np.zeros((b, self.pages), np.int64)
        w.c = 0
        w.n_chunks = 1
        for j, (slot, req, row) in enumerate(items):
            t0 = req.prompt.shape[0]
            w.starts[j] = req.cached_tokens
            t0m1[j] = t0 - 1
            rows[j] = row
            w.n_chunks = max(w.n_chunks,
                             -(-(t0 - req.cached_tokens) // bs))
        w.seeds, w.temps, w.sample = self._row_sampling(items, b)
        w.rows_d = self._dev(rows)
        w.t0m1_d = self._dev(t0m1)
        w.last = torch.zeros((b, self.model.vocab_size),
                             dtype=torch.float32, device=self.device)
        return w

    def _advance_work(self, w: _ChunkWork) -> None:
        """Run ONE block_size-wide causal chunk of a staged group."""
        b = len(w.items)
        bs = self.block_size
        toks = np.zeros((b, bs), np.int64)
        st = w.starts + w.c * bs
        for j, (_, req, _) in enumerate(w.items):
            t0 = req.prompt.shape[0]
            lo = int(st[j])
            if lo < t0:
                hi = min(lo + bs, t0)
                toks[j, :hi - lo] = req.prompt[lo:hi]
        with torch.inference_mode():
            toks_d, st_d = self._dev(toks), self._dev(st)
            w.last = self._run_suffix(w.rows_d, toks_d, st_d, w.t0m1_d,
                                      w.last)
            self._suffix_extra(toks_d, st_d, w.rows_d)
        w.c += 1

    def _finish_suffix_work(self, w: _ChunkWork) -> Tuple:
        """Pick first tokens for an exhausted group: the accumulated
        row is the model's own logits at t0-1."""
        b = len(w.items)
        with torch.inference_mode():
            first = pick_rows(w.last, self._dev(w.seeds),
                              torch.zeros(b, dtype=torch.long,
                                          device=self.device),
                              self._dev(w.temps), self._dev(w.sample))
        return (first, w.seeds, w.temps, w.sample, self._event())

    def _finish_chunk(self, chunk: Tuple, items) -> None:
        """Read the chunk's first tokens, install the page-table rows
        (until now the decode step saw trash for these slots), activate
        cursors, emit. A deferred eviction (a cancel that raced the
        prefill) lands here, after the page writes."""
        first, seeds, temps, sample, _ = chunk
        first = first.cpu().numpy()
        for j, (slot, req, row) in enumerate(items):
            self._pending.discard(slot)
            self.page_table[slot] = row
            if self.prefix_cache:
                self._register_prefix(slot, req)
            if slot in self._evict_after_prefill:
                self._evict_after_prefill.discard(slot)
                self.evict(slot)
                continue
            t0 = req.prompt.shape[0]
            self.lengths[slot] = t0
            self.n_gen[slot] = 1
            self.last_tok[slot] = first[j]
            self.seeds[slot] = seeds[j]
            self.temps[slot] = temps[j]
            self.sample[slot] = sample[j]
            self.active[slot] = True
            self.tokens_emitted += 1
            done = req.max_new == 1
            req._emit(int(first[j]), done)
            if done:
                self.evict(slot)

    # -- overlapped prefill --------------------------------------------------

    @property
    def prefill_pending(self) -> int:
        """Slots reserved with a prefill still in flight."""
        return len(self._pending)

    def begin_prefill_async(
            self, reqs: Sequence[Request], chunked: bool = False,
    ) -> Tuple[Optional[PrefillTicket], Optional[Exception]]:
        """Reserve the longest admissible prefix of `reqs` and DISPATCH
        its prefill without waiting, returning a `PrefillTicket` to
        finish at a later step boundary (plus the first refusal). The
        reserved slots' page-table rows stay at TRASH until
        `finish_prefill` installs them, so decode steps in between write
        their rows to block 0, never into the blocks the prefill fills.

        With ``chunked=True`` nothing is dispatched: the prefill is
        STAGED as resumable `_ChunkWork` groups on the ticket, and
        `advance_prefill` runs it one block_size-wide pass at a time."""
        pending: List[Tuple[int, Request, np.ndarray]] = []
        err: Optional[Exception] = None
        for req in reqs:
            try:
                slot = self._reserve(req)
            except (OutOfSlotsError, OutOfBlocksError, ValueError) as e:
                err = e
                break
            row = self.page_table[slot].copy()
            self.page_table[slot] = 0   # decode sees trash until finish
            self._pending.add(slot)
            pending.append((slot, req, row))
        if not pending:
            return None, err
        if chunked:
            work = [self._stage_suffix_work(items)
                    for items in self._chunk_items(pending)]
            return PrefillTicket([], work=work), err
        chunks = [(self._dispatch_chunk(items), items)
                  for items in self._chunk_items(pending)]
        return PrefillTicket(chunks), err

    def advance_prefill(self, ticket: PrefillTicket,
                        max_chunks: int = 1) -> int:
        """Run up to `max_chunks` block-wide passes of a CHUNKED ticket's
        staged work (front group first), turning each exhausted group
        into an ordinary finished chunk. Returns the passes run (0: the
        ticket is finishable)."""
        ran = 0
        while ticket.work and ran < max_chunks:
            w = ticket.work[0]
            self._advance_work(w)
            ran += 1
            if w.c >= w.n_chunks:
                ticket.chunks.append((self._finish_suffix_work(w), w.items))
                ticket.work.pop(0)
        if ran and obs_metrics.enabled():
            c = self._chunk_counter
            if c is None:
                c = self._chunk_counter = obs_metrics.counter(
                    "serve_prefill_chunks")
            c.inc(ran)
        return ran

    def finish_prefill(self, ticket: PrefillTicket) -> List[int]:
        """Admit a dispatched ticket's streams: read first tokens,
        install page-table rows, activate cursors. Returns the slots."""
        if ticket.work:   # drain any staged chunked work first
            self.advance_prefill(ticket, max_chunks=1 << 30)
        slots = []
        for chunk, items in ticket.chunks:
            self._finish_chunk(chunk, items)
            slots.extend(slot for slot, _, _ in items)
        ticket.chunks = []
        if obs_metrics.enabled():
            mh = self._prefill_metrics
            if mh is None:
                mh = self._prefill_metrics = obs_metrics.histogram(
                    "serve_prefill_wait_ms")
            mh.observe((time.perf_counter() - ticket.t0) * 1000.0)
        return slots

    def abort_prefill(self, ticket: PrefillTicket) -> List[Request]:
        """Hand a dispatched ticket's requests back UNSTARTED: free their
        slots and blocks without activating anything. Queued page writes
        land in blocks that stay free until a later admission, whose own
        prefill overwrites them first (stream order). Returns the
        requests."""
        back = []
        groups = [items for _, items in ticket.chunks]
        groups.extend(w.items for w in ticket.work)
        for items in groups:
            for slot, req, _ in items:
                self._pending.discard(slot)
                self._evict_after_prefill.discard(slot)
                self.allocator.free(slot)
                self.page_table[slot] = 0
                self._reqs[slot] = None
                self._slot_cached[slot] = 0
                self._slot_reg_pages[slot] = 0
                self._slot_key[slot] = None
                back.append(req)
        ticket.chunks = []
        ticket.work = []
        return back

    def evict(self, slot: int) -> None:
        """Free the slot's blocks and deactivate it; idempotent. The
        page-table row points back at trash, so the slot's step writes
        stop landing in allocatable blocks. Evicting a slot whose
        prefill is in flight defers to `finish_prefill`."""
        if slot in self._pending:
            self._evict_after_prefill.add(slot)
            return
        if self.prefix_cache:
            # generated content that completed a block becomes shareable
            # before the blocks decref
            self._register_decoded_slot(slot)
        self.allocator.free(slot)
        self.page_table[slot] = 0
        self.active[slot] = False
        self.lengths[slot] = 0
        self.n_gen[slot] = 0
        self.last_tok[slot] = 0
        self.temps[slot] = 1.0
        self.sample[slot] = False
        self.seeds[slot] = 0
        self._reqs[slot] = None
        self._slot_cached[slot] = 0
        self._slot_reg_pages[slot] = 0
        self._slot_key[slot] = None

    def cancel(self, rid) -> bool:
        """Evict the in-flight request with this rid (its stream ends
        without its remaining tokens). Returns whether one was found."""
        for slot, req in enumerate(self._reqs):
            if req is not None and req.rid == rid:
                req.done = True
                self.evict(slot)
                return True
        return False

    # -- prefix-cache registration / copy-on-write ---------------------------

    def _register_prefix(self, slot: int, req: Request) -> None:
        """Register the slot's FULL prompt blocks and arm its
        registration frontier for decode-time extension. First writer
        wins: a duplicate's private copy stays unregistered."""
        chain = getattr(req, "_prefix_keys", None)
        if chain is None:
            chain = self.prefix_index.chain_keys(req.prompt)
            req._prefix_keys = chain
        row = self.page_table[slot]
        for j, (key, tb) in enumerate(chain):
            b = int(row[j])
            if self.prefix_index.register(key, tb, b):
                self.allocator.mark_registered(b)
        self._slot_reg_pages[slot] = len(chain)
        self._slot_key[slot] = (chain[-1][0] if chain
                                else self.prefix_index.root)

    def _slot_tokens(self, req: Request, lo: int, hi: int) -> np.ndarray:
        """Token ids at positions [lo, hi) of a live slot: prompt tokens,
        then generated ones (row p of the cache holds token p's KV)."""
        t0 = req.prompt.shape[0]
        out = np.empty(hi - lo, np.int32)
        for i in range(lo, hi):
            out[i - lo] = (req.prompt[i] if i < t0
                           else req.tokens[i - t0])
        return out

    def _register_decoded_slot(self, slot: int) -> None:
        """Extend the slot's registration frontier over blocks the
        decode cursor has completed: generated content becomes
        shareable (a multi-turn follow-up hits it)."""
        req = self._reqs[slot]
        key = self._slot_key[slot]
        if req is None or key is None:
            return
        bs = self.block_size
        full = int(self.lengths[slot]) // bs
        j = self._slot_reg_pages[slot]
        while j < full:
            tb = self._slot_tokens(req, j * bs, (j + 1) * bs).tobytes()
            key = self.prefix_index.extend_key(key, tb)
            b = int(self.page_table[slot, j])
            if b and self.prefix_index.register(key, tb, b):
                self.allocator.mark_registered(b)
            j += 1
        self._slot_reg_pages[slot] = j
        self._slot_key[slot] = key

    def _register_decoded(self, idx) -> None:
        """Decode-time registration for the step's surviving slots,
        after the emit/eviction loop."""
        bs = self.block_size
        for slot in idx:
            slot = int(slot)
            if (self.active[slot]
                    and int(self.lengths[slot]) // bs
                    > self._slot_reg_pages[slot]):
                self._register_decoded_slot(slot)

    def _cow_pools(self) -> List[torch.Tensor]:
        """The stacked (L, NB, ...) pool tensors a copy-on-write block
        copy spans: K and V, scales included (the speculative engine
        adds its draft pools: a block's draft rows share with its target
        rows as one unit). Writes are in place, so there is no setter."""
        return [t for t in (self._kdata, self._vdata, self._kscale,
                            self._vscale) if t is not None]

    def _copy_block(self, src: int, dst: int) -> None:
        """Device copy of one block in every pool, every layer: the
        copy-on-write payload move."""
        with torch.inference_mode():
            for t in self._cow_pools():
                t[:, dst].copy_(t[:, src])

    def _cow_guard(self, span: int) -> None:
        """Copy-on-write sweep before a decode round that writes rows
        [lengths, lengths+span) per active slot: any page in that range
        still SHARED gets a private copy first, so a decode write is
        never seen by the sharing stream. Unreachable in the normal
        append-only flow (the tail block is always private); insurance
        for fork-shaped sharing."""
        if self.allocator.shared_pages == 0:
            return
        bs = self.block_size
        for slot in np.flatnonzero(self.active):
            slot = int(slot)
            pos = int(self.lengths[slot])
            lo = pos // bs
            hi = min((pos + span - 1) // bs, self.pages - 1)
            for j in range(lo, hi + 1):
                b = int(self.page_table[slot, j])
                if b and self.allocator.refcount(b) > 1:
                    nb = self.allocator.cow(slot, b)
                    self._copy_block(b, nb)
                    self.page_table[slot, j] = nb
                    self.cow_copies += 1
                    if obs_metrics.enabled():
                        if self._cow_metric is None:
                            self._cow_metric = obs_metrics.counter(
                                "serve_cow_copies")
                        self._cow_metric.inc()

    @property
    def prefix_prefill_compiles(self) -> int:
        """Suffix-prefill captures on the card, one per distinct chunk
        batch width (a single-width workload stays at 1); builds on the
        CPU (0 before the first warm or chunked admission, then 1). The
        decode probe is separate."""
        return self._suffix_builds

    @property
    def prefix_stats(self) -> Dict[str, int]:
        """The prefix cache's lifetime accounting."""
        return dict(
            hits=self.prefix_hits, misses=self.prefix_misses,
            shared_pages=self.allocator.shared_pages,
            cached_blocks=self.allocator.cached_blocks,
            cow_copies=self.cow_copies,
            index_entries=(0 if self.prefix_index is None
                           else len(self.prefix_index)))

    # -- the decode loop -----------------------------------------------------

    def _advance_slots(self, idx: np.ndarray, last: np.ndarray,
                       counts: np.ndarray) -> None:
        """Vectorized host-side cursor advance for the `idx` slots."""
        self.lengths[idx] += counts
        self.n_gen[idx] += counts
        self.last_tok[idx] = last
        self.tokens_emitted += int(counts.sum())

    def _record_step_metrics(self, wall_s: float, n_streams: int,
                             n_tokens: int) -> None:
        """Enabled-path serving telemetry for one step() call, after the
        emit/eviction loop: the per-token latency histogram (the step
        wall normalized by streams/tokens, the reference's bench p50/p95
        math) and the live gauges, read from post-eviction state."""
        mh = self._step_metrics
        if mh is None:
            mh = self._step_metrics = (
                obs_metrics.histogram("serve_token_ms"),
                obs_metrics.counter("serve_tokens"),
                obs_metrics.counter("serve_steps"),
                obs_metrics.gauge("serve_slots_active"),
                obs_metrics.gauge("serve_slot_occupancy"),
                obs_metrics.gauge("serve_kv_blocks_used"),
                obs_metrics.gauge("serve_kv_utilization"))
        hist, ctok, cstep, gact, gocc, gused, gutil = mh
        if n_tokens:
            hist.observe(wall_s * 1000.0 * n_streams / n_tokens)
        ctok.inc(n_tokens)
        cstep.inc()
        act = int(self.active.sum())
        gact.set(act)
        gocc.set(act / max(1, self.slots))
        used = self.allocator.used_blocks
        gused.set(used)
        gutil.set(used / max(1, self.allocator.capacity))

    def step(self) -> Dict[object, int]:
        """One decode step for the whole slot batch (a graph replay on
        the card); returns {rid: token} for every stream that advanced.
        Finished requests (n_gen == max_new) are evicted after their
        last token."""
        if not self.active.any():
            return {}
        rec = obs_metrics.enabled()  # one boolean read when disabled
        t0 = time.perf_counter() if rec else 0.0
        if self.prefix_cache:
            self._cow_guard(1)  # the step writes one row per slot
        with torch.inference_mode():
            self._upload()
            toks = self._run_step().cpu().numpy()
        self.steps += 1
        idx = np.flatnonzero(self.active)
        self._advance_slots(idx, toks[idx], np.ones(idx.size, np.int32))
        emitted: Dict[object, int] = {}
        # callbacks and eviction stay per slot: they run user code
        for slot in idx:
            slot = int(slot)
            req = self._reqs[slot]
            emitted[req.rid] = int(toks[slot])
            done = int(self.n_gen[slot]) >= req.max_new
            req._emit(int(toks[slot]), done)
            if done:
                self.evict(slot)
        if self.prefix_cache:
            # after the emit loop: req.tokens holds this step's tokens
            self._register_decoded(idx)
        if rec:
            self._record_step_metrics(time.perf_counter() - t0,
                                      int(idx.size), int(idx.size))
        return emitted
