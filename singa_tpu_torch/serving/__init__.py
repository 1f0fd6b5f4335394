"""Inference serving (counterpart of singa_tpu/serving).

- ``engine.ServingEngine``: continuous-batching decode over a paged KV
  pool; one decode step, captured once as a CUDA Graph on the card,
  serves N concurrent streams, and admits/evicts between steps never
  rebuild it. fp32, bf16 and int8 pools; the prefix cache
  (copy-on-write block sharing, suffix-only prefill); the asynchronous
  prefill split (`begin_prefill_async` / `advance_prefill` /
  `finish_prefill` / `abort_prefill`); the tensor-parallel decode
  (`mesh=`, `tp_axis=`) and the disaggregated prefill mesh
  (`prefill_mesh=`, `prefill_axis=`: prefill on other ranks, its K/V
  sent to the decode ranks).
- ``blocks.BlockAllocator`` / ``PrefixIndex``: the paged cache's host
  side (refcounts, LRU, copy-on-write; refusals name the capacity math).
- ``speculative.SpeculativeEngine``: draft-model speculative decoding
  through the same paged cache; propose and verify are each one
  captured graph, greedy streams stay token-identical, sampled streams
  are residual-rejection distribution-preserving; on a tp mesh the
  draft shards over the target's axis.
- ``frontend.Frontend``: the streaming front end (queue in, per-token
  callbacks out), overlapped or chunk-scheduled prefill, and a SIGTERM
  drain through `resilience.PreemptionGuard`.
- ``sched.ChunkedScheduler``: the chunked-prefill policy (chunk budget,
  priority lanes, per-tenant deficit round-robin, prefix affinity).
- ``router.ReplicaRouter``: N engines behind one queue (prefix
  affinity, load, health, failover with exactly-once delivery);
  ``ProcessReplica`` / ``run_spool_server`` are its process-backed
  replicas.

Correctness contract: token identity. Every greedy stream equals the
solo `GPT.generate(use_cache=True)` for the same prompt under any
admit/evict interleaving and block-table fragmentation, speculative or
not, routed or not, sharded or not; plain-engine sampled streams
equal it too.
"""

from singa_tpu_torch.serving.blocks import (          # noqa: F401
    KV_DTYPES, BlockAllocator, OutOfBlocksError, PrefixIndex,
    blocks_needed, kv_block_bytes)
from singa_tpu_torch.serving.engine import (          # noqa: F401
    OutOfSlotsError, PrefillTicket, Request, ServingEngine,
    emitted_token_count)
from singa_tpu_torch.serving.frontend import Frontend  # noqa: F401
from singa_tpu_torch.serving.router import (           # noqa: F401
    ProcessReplica, ReplicaRouter, RouterHandle, run_spool_server)
from singa_tpu_torch.serving.sched import ChunkedScheduler  # noqa: F401
from singa_tpu_torch.serving.speculative import (      # noqa: F401
    SpeculativeEngine)

__all__ = ["ServingEngine", "SpeculativeEngine", "Request",
           "BlockAllocator", "OutOfBlocksError", "OutOfSlotsError",
           "PrefillTicket", "blocks_needed", "kv_block_bytes",
           "KV_DTYPES", "Frontend", "ChunkedScheduler",
           "ReplicaRouter", "RouterHandle", "ProcessReplica",
           "run_spool_server", "PrefixIndex", "emitted_token_count"]
