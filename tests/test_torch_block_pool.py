"""The port's copy of ``BlockPool`` gives the reference's allocation trace.

Both classes replay the same seed-pinned operation sequences (acquire with
and without prefix sharing, decref, copy-on-write, in-place generated
writes), and every return value, free list, refcount and registered claim
must agree after every operation.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serve.block_pool import BlockPool as RefPool  # noqa: E402
from repro_torch.serve.block_pool import BlockPool  # noqa: E402

_PREFIXES = ((1, 2, 3, 4, 5, 6, 1, 2), (2, 4, 6, 1, 3))


def _state(pool):
    return (list(pool.free), list(pool.refcount),
            sorted(pool.registered_claims()), pool.logical_blocks,
            pool.physical_blocks, pool.shared_hits, pool.cow_copies)


def _replay(pool, seed, n_ops=60, bs=4):
    """One seeded lifecycle; returns the trace of every result and state.
    Errors (exhaustion, cow on an unshared block) are part of the trace."""
    rng = np.random.default_rng(seed)
    held = []  # [prompt, [blocks]]
    trace = []
    for _ in range(n_ops):
        op = rng.choice(["acquire", "acquire", "decref", "cow", "write"])
        v = int(rng.integers(0, 2 ** 16))
        try:
            if op == "acquire":
                g = v % (len(_PREFIXES) + 1)
                prompt = (_PREFIXES[g] if g < len(_PREFIXES)
                          else tuple((v + i) % 7 for i in range(1 + v % 6)))
                blocks = [pool.acquire(prompt, j)
                          for j in range(-(-len(prompt) // bs))]
                held.append([prompt, blocks])
                result = blocks
            elif op == "decref" and held:
                _, blocks = held.pop(v % len(held))
                for blk in blocks:
                    pool.decref(blk)
                result = blocks
            elif op == "cow" and held:
                _, blocks = held[v % len(held)]
                j = v % len(blocks)
                blocks[j] = pool.cow(blocks[j])
                result = blocks[j]
            elif op == "write" and held:
                _, blocks = held[v % len(held)]
                blk = blocks[v % len(blocks)]
                pool.note_generated_write(blk, v % bs)
                result = blk
            else:
                result = None
        except RuntimeError as e:
            result = ("error", str(e))
        trace.append((op, result, _state(pool)))
    return trace


@pytest.mark.parametrize("share", [False, True])
def test_allocation_trace_equals_reference(share):
    for seed in range(40):
        port = _replay(BlockPool(24, 4, share_prefixes=share), seed)
        ref = _replay(RefPool(24, 4, share_prefixes=share), seed)
        assert port == ref, f"seed {seed}"


def test_unshared_pool_is_the_reference_lifo_allocator():
    pool, ref = BlockPool(10, 4), RefPool(10, 4)
    for _ in range(3):
        got = [pool.acquire((1, 2, 3), 0) for _ in range(5)]
        want = [ref.acquire((1, 2, 3), 0) for _ in range(5)]
        assert got == want
        for blk in got[::2]:
            pool.decref(blk)
            ref.decref(blk)
        assert list(pool.free) == list(ref.free)
    pool.check_invariants()
