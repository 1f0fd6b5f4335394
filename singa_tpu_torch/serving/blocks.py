"""Paged KV-cache block allocator (counterpart of
singa_tpu/serving/blocks.py, copied whole: it is pure Python).

The vLLM PagedAttention idea, host side: the device pool is NB
fixed-size blocks of `block_size` token rows; a request is admitted by
handing it ceil((prompt + max_new) / block_size) blocks — every block
it can ever touch, so the captured decode step never allocates — and its page-table row maps logical page
j to whichever pool block it got. Long and short requests share the one
pool instead of every slot padding to max_len; freed blocks go back on
the free list and the next admit may get a FRAGMENTED (non-contiguous,
out-of-order) set, which the gather indirection makes invisible to the
math (layer.paged_kv_gather is bitwise the dense layout).

Block 0 is the TRASH block: never allocated, it absorbs the
shape-static scatter writes of inactive slots and the prefill window's
slack pages. Admission failure is a loud `OutOfBlocksError` naming the
capacity math — the caller (frontend) queues and retries after the
next eviction instead of silently degrading.

Round 20 adds PREFIX CACHING on top of the same pool: blocks are
REFCOUNTED (several page-table rows may map the same block), "free"
becomes a decref, and full blocks whose content was registered in the
`PrefixIndex` outlive their last owner on a cached-LRU list — still
holding valid KV rows — until a future admission either re-shares them
(cache hit: incref, zero prefill) or reclaims them for fresh
allocations (LRU eviction with an `on_reclaim` purge callback). With
no registrations the allocator is bitwise the round-15 free-list
machine: decref of an unregistered block appends to `_free` in the
same order `free` always did.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["BlockAllocator", "OutOfBlocksError", "PrefixIndex",
           "blocks_needed", "kv_block_bytes", "KV_DTYPES"]

#: the pool storage formats the engine accepts for `kv_dtype=` (round
#: 16). "fp32"/"bf16" store raw rows at 4/2 bytes per element; "int8"
#: stores 1-byte quanta plus one float32 scale PER TOKEN ROW per block
#: (shape (NB, block_size) riding the same page table — see
#: tensor.quantize_int8_rows for why row granularity, not whole-block),
#: so an int8 block costs H*hd + 4 bytes per row instead of 4*H*hd —
#: ~4x the admission capacity at equal pool bytes (~2x vs bf16), which
#: is the "double streams per chip" lever of ROADMAP item 1.
KV_DTYPES = ("fp32", "bf16", "int8")


class OutOfBlocksError(RuntimeError):
    """Admission refused: the pool cannot hold the request's worst-case
    cache. Carries the capacity math so operators can size the pool."""


def kv_block_bytes(n_layers: int, heads: int, head_dim: int,
                   block_size: int, kv_dtype: str = "fp32",
                   tp: int = 1) -> int:
    """Bytes ONE pool block costs across K+V and every layer, per
    `kv_dtype` — the admission capacity math's denominator (the
    OutOfBlocksError message and the `pool_bytes=` engine sizing both
    use it). int8 adds the per-row float32 scale the quantized format
    stores next to the payload.

    `tp` (round 18): the tensor-parallel extent the pool shards over.
    The sharded engine's pool splits each block's heads over the tp
    axis, so PER-CHIP a block costs the heads/tp share (int8's scales
    shard with their heads: one f32 scale per row per CHIP-local head
    group, see engine `_KVOps` under sharding) — `pool_bytes=` budgets
    and refusal messages state per-chip HBM, the number an operator
    sizes against."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"kv_dtype {kv_dtype!r} is not a pool storage format "
            f"(choose from {KV_DTYPES})")
    if tp < 1 or heads % tp:
        raise ValueError(
            f"kv_block_bytes: heads {heads} must divide over tp {tp} "
            f"(the pool shards whole heads per chip)")
    rows = block_size * (heads // tp) * head_dim
    if kv_dtype == "int8":
        per_pool = rows + block_size * 4  # int8 quanta + f32 row scales
    elif kv_dtype == "bf16":
        per_pool = rows * 2
    else:
        per_pool = rows * 4
    return 2 * n_layers * per_pool  # K and V, all layers


def blocks_needed(prompt_len: int, max_new: int, block_size: int) -> int:
    """ceil((prompt_len + max_new) / block_size): every cache row the
    request can ever write, reserved at admission (the decode step is
    compiled once and must never allocate)."""
    total = prompt_len + max_new
    return -(-total // block_size)


class BlockAllocator:
    """Free-list allocator over a pool of `num_blocks` blocks of
    `block_size` rows each (block 0 reserved as trash — `capacity`
    counts only allocatable blocks). `alloc` is all-or-nothing;
    `free` decrefs a request's blocks — a block returns for reuse only
    when its LAST sharer releases it, and registered (prefix-indexed)
    blocks park on a cached-LRU list instead, reclaimable but still
    holding valid rows for future cache hits."""

    def __init__(self, num_blocks: int, block_size: int,
                 bytes_per_block: int = 0):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks {num_blocks} < 2: block 0 is the reserved "
                "trash block, so an allocatable pool needs at least one "
                "more")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        #: informational, for the refusal message (K+V, all layers)
        self.bytes_per_block = int(bytes_per_block)
        # LIFO free list: re-admits preferentially reuse just-freed
        # blocks, which is exactly what makes page tables fragment —
        # the engine's equivalence oracle leans on this
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._owned: Dict[object, List[int]] = {}
        # prefix-cache state. _ref counts page-table rows mapping each
        # block; _registered marks blocks whose content is in a
        # PrefixIndex; _cached is the refcount-0-but-registered LRU
        # (oldest first — reclaim takes from the front). on_reclaim is
        # the engine's purge hook: a reclaimed block's index entry must
        # die before the block is rewritten.
        self._ref: Dict[int, int] = {}
        self._registered: set = set()
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        self.on_reclaim = None  # callable(block) | None

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Blocks held by in-flight requests (cached blocks are
        reclaimable, so they count as capacity, not usage)."""
        return self.capacity - len(self._free) - len(self._cached)

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 registered blocks parked for future prefix hits."""
        return len(self._cached)

    @property
    def available_blocks(self) -> int:
        """What a fresh (non-sharing) admission can actually get:
        free plus reclaimable-cached."""
        return len(self._free) + len(self._cached)

    @property
    def shared_pages(self) -> int:
        """Pages saved by sharing right now: sum of (refcount - 1)
        over live blocks — each extra sharer of a block is one
        page-table page that cost zero pool blocks."""
        return sum(r - 1 for r in self._ref.values() if r > 1)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def mark_registered(self, block: int) -> None:
        """The engine registered `block` in its PrefixIndex: from now
        on this block parks on the cached-LRU at refcount 0 instead of
        returning to the free list."""
        self._registered.add(block)

    def alloc(self, owner, n: int,
              shared: Sequence[int] = ()) -> List[int]:
        """Hand `owner` exactly `n` fresh blocks or raise
        OutOfBlocksError with the capacity math (all-or-nothing: a
        partial grant would deadlock two half-admitted requests).

        `shared` (prefix cache): resident blocks the owner maps in
        ADDITION to the fresh grant — increfed atomically with the
        grant, so a refused admission touches nothing. Shared blocks
        sitting on the cached-LRU are revived (removed from it) and so
        are excluded from the reclaimable supply the fresh grant may
        draw on."""
        if owner in self._owned:
            raise ValueError(f"owner {owner!r} already holds blocks")
        shared = list(shared)
        cached_avail = len(self._cached) - sum(
            1 for b in shared if b in self._cached)
        if n > len(self._free) + cached_avail:
            tokens = n * self.block_size
            msg = (
                f"out of KV-cache blocks: request {owner!r} needs {n} "
                f"blocks ({tokens} token rows at block_size="
                f"{self.block_size}) but only {len(self._free)} of "
                f"{self.capacity} allocatable blocks are free "
                f"({self.used_blocks} held by in-flight requests; "
                f"block 0 is reserved trash)")
            if cached_avail or self.shared_pages:
                msg += (f"; prefix cache: {cached_avail} reclaimable "
                        f"cached blocks, {self.shared_pages} shared "
                        f"pages")
            if self.bytes_per_block:
                msg += (f"; pool = {self.capacity * self.bytes_per_block} "
                        f"bytes at {self.bytes_per_block} bytes/block")
            msg += (" — evict/finish a request, raise num_blocks, or "
                    "lower max_new")
            raise OutOfBlocksError(msg)
        # revive the shared blocks first (they must not be reclaimed
        # while we evict cached blocks for the fresh grant below)
        for b in shared:
            self._ref[b] = self._ref.get(b, 0) + 1
            self._cached.pop(b, None)
        got = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:
                # reclaim the least-recently-parked cached block: purge
                # its index entry so no future lookup maps dead content
                b, _ = self._cached.popitem(last=False)
                self._registered.discard(b)
                if self.on_reclaim is not None:
                    self.on_reclaim(b)
            self._ref[b] = 1
            got.append(b)
        self._owned[owner] = shared + got
        return got

    def free(self, owner) -> int:
        """Decref `owner`'s blocks; returns how many blocks actually
        came back to the reusable supply (free list or cached-LRU).
        Unknown owners free nothing (idempotent eviction)."""
        got = self._owned.pop(owner, [])
        released = 0
        for b in got:
            if self._decref(b):
                released += 1
        return released

    def _decref(self, block: int) -> bool:
        """Drop one reference; on reaching zero, park registered blocks
        on the cached-LRU (MRU end) and return unregistered ones to the
        free list. Returns True when the block left active use."""
        r = self._ref.get(block, 1) - 1
        if r > 0:
            self._ref[block] = r
            return False
        self._ref.pop(block, None)
        if block in self._registered:
            self._cached[block] = None
            self._cached.move_to_end(block)
        else:
            self._free.append(block)
        return True

    def cow(self, owner, old: int) -> int:
        """Copy-on-write: give `owner` a private replacement for the
        shared block `old` — takes one fresh block (free list, else
        cached-LRU reclaim), swaps it into the owner's holding, and
        decrefs `old`. The caller copies the payload and patches its
        page-table row. Raises OutOfBlocksError when the pool has
        nothing left (pathological budgets; see docs)."""
        held = self._owned.get(owner)
        if held is None or old not in held:
            raise ValueError(
                f"cow: owner {owner!r} does not hold block {old}")
        if self._free:
            new = self._free.pop()
        elif self._cached:
            new, _ = self._cached.popitem(last=False)
            self._registered.discard(new)
            if self.on_reclaim is not None:
                self.on_reclaim(new)
        else:
            raise OutOfBlocksError(
                f"copy-on-write for request {owner!r} needs 1 block "
                f"but the pool is exhausted ({self.used_blocks} of "
                f"{self.capacity} held, 0 cached) — raise num_blocks "
                "or lower concurrency")
        self._ref[new] = 1
        held[held.index(old)] = new
        self._decref(old)
        return new


class PrefixIndex:
    """Content-addressed index of FULL KV blocks by rolling token-prefix
    hash, keyed under a model/config fingerprint.

    The key for prefix block j is a chained blake2b:

        key_0   = H(fingerprint)                      (the root)
        key_j+1 = H(key_j || tokens[j*bs:(j+1)*bs])   (int32 LE bytes)

    so a block's key commits to the ENTIRE token prefix up to and
    including it, plus every config knob that shapes KV content
    (dims, kv_dtype, tp, spec draft dims). Entries also store the raw
    block-token bytes and are verified on lookup, so even a hash
    collision cannot map wrong content. First writer wins on register:
    a duplicate prefill's private copy simply stays unregistered.
    """

    def __init__(self, fingerprint: str, block_size: int):
        self.fingerprint = str(fingerprint)
        self.block_size = int(block_size)
        self.root = hashlib.blake2b(
            self.fingerprint.encode(), digest_size=16).digest()
        # key -> (block, token_bytes); block -> key for purge
        self._by_key: Dict[bytes, Tuple[int, bytes]] = {}
        self._by_block: Dict[int, bytes] = {}

    def __len__(self) -> int:
        return len(self._by_key)

    @staticmethod
    def extend_key(key: bytes, token_bytes: bytes) -> bytes:
        return hashlib.blake2b(
            key + token_bytes, digest_size=16).digest()

    def chain_keys(self, tokens) -> List[Tuple[bytes, bytes]]:
        """(key, token_bytes) for every FULL block of `tokens` (an
        int-sequence/ndarray), chained from the fingerprint root."""
        import numpy as np

        toks = np.asarray(tokens, np.int32)
        bs = self.block_size
        out: List[Tuple[bytes, bytes]] = []
        key = self.root
        for j in range(len(toks) // bs):
            tb = toks[j * bs:(j + 1) * bs].tobytes()
            key = self.extend_key(key, tb)
            out.append((key, tb))
        return out

    def lookup(self, chain: Iterable[Tuple[bytes, bytes]]) -> List[int]:
        """Longest resident run of blocks matching the chain from its
        start — stops at the first miss (a later block's content is
        only valid on top of every earlier one). Token bytes are
        verified entry-by-entry (collision-proof)."""
        hit: List[int] = []
        for key, tb in chain:
            ent = self._by_key.get(key)
            if ent is None or ent[1] != tb:
                break
            hit.append(ent[0])
        return hit

    def register(self, key: bytes, token_bytes: bytes,
                 block: int) -> bool:
        """Map `key` -> `block` unless the key is already resident
        (first writer wins — the duplicate's private block stays
        unregistered) or the block already backs another key."""
        if key in self._by_key or block in self._by_block:
            return False
        self._by_key[key] = (block, token_bytes)
        self._by_block[block] = key
        return True

    def purge_block(self, block: int) -> None:
        """Drop the entry backed by `block` (LRU reclaim / CoW source
        retirement): the block is about to be rewritten, so no lookup
        may map it again."""
        key = self._by_block.pop(block, None)
        if key is not None:
            self._by_key.pop(key, None)

    def block_of(self, key: bytes) -> Optional[int]:
        ent = self._by_key.get(key)
        return None if ent is None else ent[0]
