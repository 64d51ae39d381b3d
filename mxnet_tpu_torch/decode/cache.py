"""Paged KV-cache: fixed-size device blocks + a host-side free list.

The device side is dumb on purpose: per layer, one K and one V array of
shape ``(num_blocks, block_size, num_heads, head_dim)`` bound into the
decode/prefill executors, addressed entirely through runtime block
tables (``ops.nn.paged_decode_attention``).  All *policy* — which
sequence owns which blocks, when to grow, when to evict — lives here on
the host, where it costs integer bookkeeping instead of device
launches.  This is the PagedAttention split (vLLM, SOSP '23): block
tables turn the cache into virtual memory, so ragged sequences share
one fixed-shape compiled step and fragmentation is impossible by
construction (any free block serves any sequence).

Copy-on-write prefix sharing (vLLM §4.4, docs/DECODE.md): every
allocated block carries a refcount, ``free()`` is a *decref* (the block
returns to the free list only at zero), and a block-granular prefix
trie keyed on token-block content lets identical prompt prefixes share
their already-prefilled blocks across sequences — ``acquire_prefix``
increfs the matched chain at admission, ``register_prefix`` publishes a
finished prefill's full blocks (the trie holds its own reference, so
the prefix outlives its first sequence), and allocation pressure
evicts trie-only blocks leaf-first before declaring OOM.  Shared
blocks are read-only by construction (only *full* blocks strictly
below the prompt tail are ever shared); ``fork_for_write`` is the
safety valve that gives a writer a private copy of a block whose
refcount is above one.

Accounting: the ``decode_cache_*`` gauges track the free list in real
time (a shared block counts as ONE used block no matter how many
sequences reference it) and ``decode_cache_bytes`` the device bytes of
the attached cache tensors.

Counterpart of ``mxnet_tpu/decode/cache.py``; plain Python, no device
code.
"""
from __future__ import annotations

import weakref

from ..base import MXNetError
from ..telemetry import REGISTRY

__all__ = ["CacheOOMError", "PagedKVCache"]

BLOCKS_USED = REGISTRY.gauge(
    "decode_cache_blocks_used", "KV-cache blocks currently allocated",
    unit="blocks")
BLOCKS_FREE = REGISTRY.gauge(
    "decode_cache_blocks_free", "KV-cache blocks on the free list",
    unit="blocks")
CACHE_OCCUPANCY = REGISTRY.gauge(
    "decode_cache_occupancy", "allocated fraction of the KV cache (0..1)",
    unit="ratio")
CACHE_BYTES = REGISTRY.gauge(
    "decode_cache_bytes", "device bytes reserved for the paged KV cache",
    unit="bytes")
PREFIX_HIT_BLOCKS = REGISTRY.gauge(
    "decode_prefix_hit_blocks", "cumulative KV-cache blocks served from "
    "the shared-prefix trie instead of being re-prefilled",
    unit="blocks")
PREFIX_EVICTIONS = REGISTRY.counter(
    "decode_prefix_evictions", "trie-only prefix blocks evicted "
    "leaf-first under allocation pressure (fleet routing replays make "
    "this routine — invisible eviction churn is a routing-policy bug)")

# every live allocator contributes to the ONE set of process-wide
# gauges — a second engine in the same process must add
# to the accounting, not clobber the first's
_LIVE = weakref.WeakSet()


def _refresh_bytes():
    CACHE_BYTES.set(sum(nd._data.nbytes for cache in list(_LIVE)
                        for nd in getattr(cache, "_arrays", ())))


class CacheOOMError(MXNetError):
    """The free list cannot satisfy an allocation (after any eviction
    the caller was willing to do)."""


class PagedKVCache:
    """Free-list allocator over ``num_blocks`` cache blocks.

    Pure host state; the engine owns the device arrays and registers
    them via :meth:`attach_arrays`.  Allocation is LIFO (hot blocks
    stay hot).  Every block carries a refcount: ``alloc`` hands it out
    at refcount 1, ``free()`` is a decref — the block returns to the
    free list only when the count reaches zero, so a preempted/expired
    sharer can never yank a block its co-sharers (or the prefix trie)
    still reference.  A ``free()`` of a block not currently allocated
    still raises — a true double free would let two sequences share a
    block and silently corrupt each other's context — and the decref
    path keeps an explicit below-zero guard.

    ``prefix_sharing=True`` arms the copy-on-write prefix trie
    (module docstring); off (the default) the allocator behaves exactly
    like the exclusive-ownership original.
    """

    def __init__(self, num_blocks, block_size, prefix_sharing=False):
        if num_blocks <= 0 or block_size <= 0:
            raise MXNetError("PagedKVCache needs positive num_blocks/"
                             "block_size (got %s, %s)"
                             % (num_blocks, block_size))
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.prefix_sharing = bool(prefix_sharing)
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._allocated = set()
        self._ref = {}                 # block id -> refcount (>= 1)
        # prefix trie: nested nodes keyed by the tuple of one block's
        # tokens — node = {"block": id, "children": {tokens: node}}.
        # The trie itself holds one reference on every published block.
        self._prefix_root = {}
        self._prefix_blocks = 0        # blocks currently held by the trie
        self._prefix_hits = 0          # cumulative blocks served shared
        _LIVE.add(self)
        self._update_gauges()

    # -- sizing --------------------------------------------------------
    def blocks_for(self, n_tokens):
        """Blocks needed to hold ``n_tokens`` cache rows."""
        return -(-max(int(n_tokens), 0) // self.block_size)

    def blocks_missing(self, have, n_tokens):
        """Blocks a sequence holding ``have`` blocks still needs to
        reach ``n_tokens`` cache rows — the incremental allocation unit
        of chunked prefill, where the table grows chunk by chunk
        instead of whole-prompt at admission."""
        return max(self.blocks_for(n_tokens) - int(have), 0)

    @property
    def free_count(self):
        return len(self._free)

    @property
    def used_count(self):
        return len(self._allocated)

    @property
    def occupancy(self):
        return len(self._allocated) / float(self.num_blocks)

    # -- alloc/free ----------------------------------------------------
    def alloc(self, n):
        """Take ``n`` blocks off the free list (all-or-nothing).  Under
        pressure, trie-only prefix blocks are evicted leaf-first before
        giving up — cached prefixes are an optimization, never a reason
        to fail an allocation."""
        n = int(n)
        if n < 0:
            raise MXNetError("alloc(%d): negative block count" % n)
        if n > len(self._free):
            self._evict_prefix_blocks(n - len(self._free))
        if n > len(self._free):
            raise CacheOOMError(
                "KV cache exhausted: need %d blocks, %d free of %d"
                % (n, len(self._free), self.num_blocks))
        out = [self._free.pop() for _ in range(n)]
        self._allocated.update(out)
        for b in out:
            self._ref[b] = 1
        self._update_gauges()
        return out

    def free(self, blocks):
        """Decref each block; a block returns to the free list only at
        refcount zero (shared blocks survive their first owner)."""
        for b in blocks:
            if b not in self._allocated:
                raise MXNetError(
                    "free(%r): block not allocated (double free would "
                    "alias two sequences onto one block)" % (b,))
            rc = self._ref.get(b, 0) - 1
            if rc < 0:
                raise MXNetError(
                    "free(%r): refcount went negative (double decref)"
                    % (b,))
            if rc == 0:
                self._allocated.discard(b)
                del self._ref[b]
                self._free.append(b)
            else:
                self._ref[b] = rc
        self._update_gauges()

    def incref(self, block):
        """Add one reference to an allocated block (a new sharer)."""
        if block not in self._allocated:
            raise MXNetError("incref(%r): block not allocated" % (block,))
        self._ref[block] += 1

    def ref(self, block):
        """Current refcount of a block (0 when not allocated)."""
        return self._ref.get(block, 0)

    def fork_for_write(self, block):
        """Copy-on-write fork: when ``block`` is shared (refcount > 1),
        allocate a private replacement, drop the caller's reference on
        the shared original, and return the new block id — the caller
        must copy the device rows and patch its table.  Returns ``None``
        when the block is exclusively owned (no fork needed).  With
        full-blocks-only sharing this never triggers on the engine's
        hot path (writes land at positions past every shared row); it
        exists as the safety valve the COW contract requires."""
        if self.ref(block) <= 1:
            return None
        new = self.alloc(1)[0]
        self.free([block])
        return new

    # -- prefix-sharing trie -------------------------------------------
    def _chain(self, tokens, n_blocks):
        """The trie keys for the first ``n_blocks`` full blocks of a
        token list: one tuple of ``block_size`` token ids per level."""
        bs = self.block_size
        return [tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
                for i in range(n_blocks)]

    def acquire_prefix(self, tokens):
        """Match the longest published block chain against ``tokens``
        and take one reference per matched block for the caller.
        Returns ``(blocks, n_rows)`` — the shared block ids (prefix of
        the caller's table) and the cache rows they cover.  At most
        ``(len(tokens) - 1) // block_size`` blocks are shared, so at
        least one prompt token always goes through chunked prefill and
        the chunk head still emits the sequence's first token."""
        if not self.prefix_sharing or not self._prefix_root:
            return [], 0
        max_share = (len(tokens) - 1) // self.block_size
        blocks = []
        node_children = self._prefix_root
        for key in self._chain(tokens, max_share):
            node = node_children.get(key)
            if node is None:
                break
            blocks.append(node["block"])
            node_children = node["children"]
        for b in blocks:
            self.incref(b)
        if blocks:
            self._prefix_hits += len(blocks)
            self._update_gauges()
        return blocks, len(blocks) * self.block_size

    def register_prefix(self, tokens, n_rows, blocks):
        """Publish a finished prefill's *full* blocks (rows
        ``[0, n_rows)``, table ``blocks``) into the trie.  Each newly
        published block gains one trie-held reference; chains already
        present keep their existing blocks (first writer wins — the
        content is identical by determinism of prefill)."""
        if not self.prefix_sharing:
            return 0
        full = int(n_rows) // self.block_size
        full = min(full, len(blocks))
        node_children = self._prefix_root
        published = 0
        for i, key in enumerate(self._chain(tokens, full)):
            node = node_children.get(key)
            if node is None:
                b = blocks[i]
                self.incref(b)
                node = {"block": b, "children": {}}
                node_children[key] = node
                self._prefix_blocks += 1
                published += 1
            node_children = node["children"]
        if published:
            self._update_gauges()
        return published

    def flush_prefixes(self):
        """Drop every trie reference (hot weight reload: cached rows
        were computed under the OLD weights, so serving them to new
        admissions would silently mix weight versions)."""
        dropped = []

        def _walk(children):
            for node in children.values():
                dropped.append(node["block"])
                _walk(node["children"])

        _walk(self._prefix_root)
        self._prefix_root = {}
        self._prefix_blocks = 0
        if dropped:
            self.free(dropped)
        return len(dropped)

    def _evict_prefix_blocks(self, need):
        """Free up to ``need`` blocks by evicting trie-ONLY blocks
        (refcount 1 — no live sequence references them) leaf-first, so
        every surviving chain stays a contiguous prefix."""
        freed = 0
        while freed < need:
            victim = None          # (children_dict, key) of a leaf

            def _find(children):
                nonlocal victim
                for key, node in children.items():
                    if victim is not None:
                        return
                    if not node["children"] and self.ref(
                            node["block"]) == 1:
                        victim = (children, key)
                    else:
                        _find(node["children"])

            _find(self._prefix_root)
            if victim is None:
                return freed
            children, key = victim
            block = children[key]["block"]
            del children[key]
            self._prefix_blocks -= 1
            self.free([block])
            PREFIX_EVICTIONS.inc()
            freed += 1
        return freed

    @property
    def prefix_stats(self):
        return {"trie_blocks": self._prefix_blocks,
                "hit_blocks": self._prefix_hits}

    def _update_gauges(self):
        used = free = total = hits = 0
        for cache in list(_LIVE):
            used += len(cache._allocated)
            free += len(cache._free)
            total += cache.num_blocks
            hits += cache._prefix_hits
        BLOCKS_USED.set(used)
        BLOCKS_FREE.set(free)
        CACHE_OCCUPANCY.set(used / float(total) if total else 0.0)
        PREFIX_HIT_BLOCKS.set(hits)

    # -- device bytes ----------------------------------------------------
    def attach_arrays(self, ndarrays):
        """Register the engine's cache NDArrays for the
        ``decode_cache_bytes`` gauge.  Bytes are per-ARRAY, so a block
        shared by many sequences is counted once by construction."""
        self._arrays = list(ndarrays)
        _refresh_bytes()
