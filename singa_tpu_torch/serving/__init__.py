"""Inference serving (counterpart of singa_tpu/serving), single device.

- ``engine.ServingEngine``: continuous-batching decode over a paged KV
  pool; one decode step, captured once as a CUDA Graph on the card,
  serves N concurrent streams, and admits/evicts between steps never
  rebuild it. fp32, bf16 and int8 pools; the prefix cache
  (copy-on-write block sharing, suffix-only prefill); the asynchronous
  prefill split (`begin_prefill_async` / `advance_prefill` /
  `finish_prefill` / `abort_prefill`).
- ``blocks.BlockAllocator`` / ``PrefixIndex``: the paged cache's host
  side (refcounts, LRU, copy-on-write; refusals name the capacity math).

Correctness contract: token identity. Every stream equals the solo
`GPT.generate(use_cache=True)` for the same prompt, seed and temperature
under any admit/evict interleaving and block-table fragmentation.

Not ported yet: the frontend, scheduler, router and speculative engine
(ROADMAP queue 1 item 11) and the tensor-parallel engine (item 10's tp
decode).
"""

from singa_tpu_torch.serving.blocks import (          # noqa: F401
    KV_DTYPES, BlockAllocator, OutOfBlocksError, PrefixIndex,
    blocks_needed, kv_block_bytes)
from singa_tpu_torch.serving.engine import (          # noqa: F401
    OutOfSlotsError, PrefillTicket, Request, ServingEngine,
    emitted_token_count)

__all__ = ["ServingEngine", "Request", "BlockAllocator", "PrefixIndex",
           "OutOfBlocksError", "OutOfSlotsError", "PrefillTicket",
           "blocks_needed", "kv_block_bytes", "KV_DTYPES",
           "emitted_token_count"]
