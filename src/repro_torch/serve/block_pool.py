"""Refcounted prefix-sharing block pool — host-side slot accounting.

Real traffic at scale is dominated by requests sharing a handful of
system prompts, so the paged KV pool should store each shared prefix
once.  :class:`BlockPool` owns the free list the continuous scheduler
used to hold directly and adds three things on top:

* **Prefix lookup.**  A physical block whose span lies inside a prompt
  will hold a pure function of that prompt prefix (the per-token cache
  commit depends only on the tokens at and before it), so the pool keys
  blocks by the *exact token chain* they will contain: full spans by
  ``prompt[: (j + 1) * block_size]``, a prompt's ragged last span by
  ``(chain, tail)``.  :meth:`acquire` returns an existing block when a
  new request's span matches — the two slots then write the same bytes
  through the same physical block (duplicate scatters of identical
  values), and each slot's reads stay below its own position, so
  sharing is invisible to the served streams.
* **Refcounts.**  A block is live while any slot's block table points at
  it; :meth:`decref` returns it to the free list (and evicts its lookup
  keys) only at zero — freeing a shared block under a surviving slot is
  exactly the aliasing bug the property tests hammer.
* **Copy-on-write.**  The first *generated* token a slot writes into a
  block other slots still reference diverges the content, so the engine
  calls :meth:`cow` to take a private copy first.  Prompt rows never
  need this: an exact chain match means every sharer write-through
  produces bit-identical bytes.

A partial (ragged last span) entry with registered tail ``T`` may be
shared by a request whose own tail ``t`` satisfies ``t == T[: len(t)]``:
the joiner only ever *reads* rows below its own prompt length, which the
registrant wrote as prompt rows, and any write past a prompt is a
generated row and therefore COWs.  The reverse (``t`` longer than ``T``)
is rejected — the extra rows would collide with the registrant's
generated tokens.  Partial-tail sharing makes one more hook necessary:
once the registrant decrefs away, the shorter-tailed sharer owns the
block alone (refcount 1), so its generated rows land IN PLACE — rows the
registered key still claims as prompt content.  The engine therefore
calls :meth:`note_generated_write` on every in-place generated write,
which trims each registered tail back to the rows still holding the
claimed prompt bytes (evicting keys left claiming nothing), so no later
request can match a stale key and alias diverged content.

Dedup accounting: ``logical_blocks`` counts block-spans *served* (every
acquire, shared or not), ``physical_blocks`` counts blocks *stored*
(every fresh allocation, COW copies included); their ratio is the
block-dedup ratio :func:`repro.core.metrics.block_dedup_ratio` reports —
the memory-side analogue of the paper's Eq. 1 lane utilization.

The free list keeps the engine's original LIFO discipline (``popleft``
to allocate, ``appendleft`` to free) so a sharing-disabled pool is
bit-compatible with the pre-pool scheduler, block ids included.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Sequence, Tuple

#: reserved null block idle slots harmlessly write into; never allocated
NULL_BLOCK = 0

TokenChain = Tuple[int, ...]
#: reverse-map key descriptors: ("full", chain) or ("partial", chain, tail)
_KeyDesc = Tuple


class BlockPool:
    """Refcounted physical block allocator with optional prefix sharing."""

    def __init__(self, n_blocks: int, block_size: int, *,
                 share_prefixes: bool = False):
        if n_blocks < 2:
            raise ValueError(f"need >= 2 blocks (null + 1), got {n_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.share_prefixes = share_prefixes
        #: LIFO free list (popleft/appendleft), block 0 excluded forever
        self.free: Deque[int] = deque(range(1, n_blocks))
        self.refcount: List[int] = [0] * n_blocks
        # prefix lookup: exact token chain -> physical block
        self._full: Dict[TokenChain, int] = {}
        self._partial: Dict[TokenChain, List[Tuple[TokenChain, int]]] = {}
        self._keys: Dict[int, List[_KeyDesc]] = {}  # block -> registered keys
        # dedup accounting (see module docstring)
        self.logical_blocks = 0
        self.physical_blocks = 0
        self.shared_hits = 0
        self.cow_copies = 0

    # -- core refcounting ------------------------------------------------------

    def alloc(self) -> int:
        """Take a fresh block off the free list (refcount 1)."""
        if not self.free:
            raise RuntimeError(
                f"block pool exhausted: all {self.n_blocks - 1} usable "
                f"blocks are referenced"
            )
        blk = self.free.popleft()
        self.refcount[blk] = 1
        self.logical_blocks += 1
        self.physical_blocks += 1
        return blk

    def incref(self, blk: int) -> None:
        if self.refcount[blk] < 1:
            raise RuntimeError(f"incref on dead block {blk}")
        self.refcount[blk] += 1

    def decref(self, blk: int) -> None:
        """Drop one reference; at zero the block's lookup keys are evicted
        and it returns to the HEAD of the free list (LIFO reuse)."""
        if blk == NULL_BLOCK:
            raise RuntimeError("decref on the null block")
        if self.refcount[blk] < 1:
            raise RuntimeError(f"double free of block {blk}")
        self.refcount[blk] -= 1
        if self.refcount[blk] == 0:
            self._evict_keys(blk)
            self.free.appendleft(blk)

    def refcount_of(self, blk: int) -> int:
        return self.refcount[blk]

    # -- prefix sharing --------------------------------------------------------

    def acquire(self, prompt: Sequence[int], j: int) -> int:
        """Map logical block ``j`` of a slot serving ``prompt``.

        With sharing enabled and the span inside the prompt, an existing
        block holding the same exact chain is returned (refcount bumped)
        instead of a fresh allocation; a fresh allocation registers its
        future content so later identical prompts can share it — even
        slots admitted in the same step, since the joiner writes through
        the same bytes and never reads past its own position.
        """
        bs = self.block_size
        P = len(prompt)
        span_start = j * bs
        if not self.share_prefixes or span_start >= P:
            return self.alloc()  # generated-only span: never shared
        if (j + 1) * bs <= P:  # full prompt span
            chain = _chain(prompt, (j + 1) * bs)
            hit = self._full.get(chain)
            if hit is not None:
                return self._share(hit)
            blk = self.alloc()
            self._full[chain] = blk
            self._keys.setdefault(blk, []).append(("full", chain))
            return blk
        # ragged last prompt span: (chain of full spans, tail)
        chain = _chain(prompt, span_start)
        tail = _chain(prompt, P)[span_start:]
        for reg_tail, blk in self._partial.get(chain, ()):
            if len(tail) <= len(reg_tail) and reg_tail[: len(tail)] == tail:
                return self._share(blk)
        blk = self.alloc()
        self._partial.setdefault(chain, []).append((tail, blk))
        self._keys.setdefault(blk, []).append(("partial", chain, tail))
        return blk

    def cow(self, blk: int) -> int:
        """Copy-on-write: detach from shared ``blk``, return a private
        replacement (the caller copies the device bytes and repoints its
        block table).  No ``logical_blocks`` bump — the span was already
        counted when acquired."""
        if self.refcount[blk] < 2:
            raise RuntimeError(f"cow on unshared block {blk}")
        if not self.free:
            raise RuntimeError(
                f"block pool exhausted: no free block to copy-on-write "
                f"block {blk}"
            )
        new = self.free.popleft()
        self.refcount[new] = 1
        self.physical_blocks += 1
        self.cow_copies += 1
        self.decref(blk)
        return new

    def note_generated_write(self, blk: int, row: int) -> None:
        """A generated-token row just landed in ``blk`` IN PLACE at
        ``row`` (no COW — the writer owns the block alone).

        Rows at and past ``row`` no longer encode any registered prompt
        chain, so every lookup key claiming them is trimmed back to the
        rows still holding the claimed bytes (``tail[:row]``), or
        evicted when nothing valid remains.  Without this, a
        shorter-tailed sharer that outlives the registrant of a partial
        span diverges the block under the registrant's stale key, and a
        later request matching that key would alias — and write-through
        corrupt — the live owner's generated rows.  Idempotent and cheap
        (generated rows only ever extend forward), so the engine calls
        it on every in-place generated write.
        """
        descs = self._keys.get(blk)
        if not descs:
            return  # unregistered (generated-only span or COW copy)
        kept: List[_KeyDesc] = []
        for desc in descs:
            if desc[0] == "full":
                # a full key claims the whole span; by construction full
                # spans lie inside every sharer's prompt and never take
                # generated rows, but evicting is the safe default
                if self._full.get(desc[1]) == blk:
                    del self._full[desc[1]]
                continue
            _, chain, tail = desc
            if len(tail) <= row:  # key claims only rows below the write
                kept.append(desc)
                continue
            entries = self._partial.setdefault(chain, [])
            entries[:] = [e for e in entries
                          if not (e[1] == blk and e[0] == tail)]
            if row > 0:  # rows [0, row) still encode chain + tail[:row]
                entries.append((tail[:row], blk))
                kept.append(("partial", chain, tail[:row]))
            if not entries:
                del self._partial[chain]
        if kept:
            self._keys[blk] = kept
        else:
            self._keys.pop(blk, None)

    def registered_claims(self) -> List[Tuple[TokenChain, int]]:
        """Every ``(token chain, block)`` the prefix registry currently
        claims — a block appears with chain ``c`` iff a request whose
        prompt starts with ``c`` may be handed that block by
        :meth:`acquire`.  White-box oracle for the content-vs-key
        consistency property tests."""
        out: List[Tuple[TokenChain, int]] = list(self._full.items())
        for chain, entries in self._partial.items():
            for tail, blk in entries:
                out.append((chain + tail, blk))
        return out

    def _share(self, blk: int) -> int:
        self.incref(blk)
        self.logical_blocks += 1
        self.shared_hits += 1
        return blk

    def _evict_keys(self, blk: int) -> None:
        for desc in self._keys.pop(blk, ()):
            if desc[0] == "full":
                if self._full.get(desc[1]) == blk:
                    del self._full[desc[1]]
            else:
                entries = self._partial.get(desc[1], [])
                entries[:] = [e for e in entries if e[1] != blk]
                if not entries and desc[1] in self._partial:
                    del self._partial[desc[1]]

    # -- dedup accounting ------------------------------------------------------

    @property
    def dedup_ratio(self) -> float:
        """Bytes served / bytes stored (block-granular, so the byte scale
        cancels); 1.0 with sharing off, > 1.0 once any span is shared."""
        if self.physical_blocks == 0:
            return 1.0
        return self.logical_blocks / self.physical_blocks

    # -- invariants (the property tests' oracle) -------------------------------

    def check_invariants(self) -> None:
        """Raise AssertionError on any broken pool invariant."""
        live = [b for b in range(self.n_blocks) if self.refcount[b] > 0]
        assert NULL_BLOCK not in live, "null block acquired a refcount"
        assert all(c >= 0 for c in self.refcount), "negative refcount"
        free = list(self.free)
        assert len(free) == len(set(free)), f"duplicate free blocks: {free}"
        assert NULL_BLOCK not in free, "null block on the free list"
        assert not set(free) & set(live), (
            f"blocks both free and referenced: {set(free) & set(live)}"
        )
        # conservation: every non-null block is either free or referenced
        assert len(live) + len(free) == self.n_blocks - 1, (
            f"lost blocks: {len(live)} live + {len(free)} free "
            f"!= {self.n_blocks - 1}"
        )
        # the prefix registry never outlives its blocks
        for blk in self._full.values():
            assert self.refcount[blk] >= 1, f"registry holds dead block {blk}"
        for entries in self._partial.values():
            for _, blk in entries:
                assert self.refcount[blk] >= 1, (
                    f"registry holds dead block {blk}"
                )
        # the registry and its reverse map agree in both directions (a
        # one-sided trim/evict would leave a stale key matchable)
        for blk, descs in self._keys.items():
            for desc in descs:
                if desc[0] == "full":
                    assert self._full.get(desc[1]) == blk, (
                        f"reverse map holds full key for {blk} the "
                        f"registry dropped"
                    )
                else:
                    assert (desc[2], blk) in self._partial.get(desc[1], []), (
                        f"reverse map holds partial key for {blk} the "
                        f"registry dropped"
                    )
        for chain, blk in self._full.items():
            assert ("full", chain) in self._keys.get(blk, []), (
                f"full key for {blk} missing from its reverse map"
            )
        for chain, entries in self._partial.items():
            assert entries, f"empty partial entry list for chain {chain}"
            for tail, blk in entries:
                assert ("partial", chain, tail) in self._keys.get(blk, []), (
                    f"partial key for {blk} missing from its reverse map"
                )
        assert self.physical_blocks <= self.logical_blocks, (
            "stored more block-spans than were served"
        )


def _chain(prompt: Sequence[int], end: int) -> TokenChain:
    """Exact token chain key for ``prompt[:end]`` (hashable ints)."""
    return tuple(int(t) for t in prompt[:end])
