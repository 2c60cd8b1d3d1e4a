"""Fixed-size KV block allocator: admission measured in blocks (the
port's own copy of ``nbdistributed_tpu/serving_fast/paging.py``; the
same free list makes the same decisions from the same event stream).

The dense serving cache reserves ``max_len`` tokens of KV per slot the
moment a request is admitted, so admission capacity is "sequences",
and a pool of short chats wastes almost all of it.  Paging carves the
cache into fixed-size blocks of ``block_tokens`` tokens; a request
holds exactly ``ceil((prompt + max_new) / block_tokens)`` blocks and
admission is bounded by *free blocks*.

Pure host-side bookkeeping on purpose: no torch import, O(1) alloc/free,
a deterministic free-list (lowest id first) so two allocators (an
accounting replica and the device pool's) make identical decisions
from identical event streams.  Exhaustion raises
:class:`BlocksExhausted` — an explicit verdict carrying need/free —
never a silent wedge.

``defrag()`` compacts live blocks toward low ids and returns the
``{old_id: new_id}`` move map; the device layer applies the same map
to the physical pool with one gather so host tables and device storage
move in lock-step.  ``check()`` asserts the conservation invariants
(used + free == total, no block owned twice, tables match ownership)
and is called by the unit tests after every mutation batch.

Thread discipline: the allocator is NOT internally locked — its owner
(the :class:`~..models.serving.DecodeServer`) serializes access.
"""

from __future__ import annotations


def blocks_needed(tokens: int, block_tokens: int) -> int:
    """Blocks required to hold ``tokens`` KV entries (ceil division).

    A request that may grow to ``prompt + max_new`` tokens allocates
    its worst case up front — continuous batching never stalls
    mid-decode on allocation, and admission verdicts are decidable at
    submit time.
    """
    if tokens <= 0:
        return 0
    return -(-int(tokens) // int(block_tokens))


class BlocksExhausted(RuntimeError):
    """Allocation refused: the pool has fewer free blocks than needed.

    The explicit-verdict exception (never a silent wedge): carries the
    shortfall so the caller's verdict can say exactly why admission
    failed (``need`` blocks requested, ``free`` available).
    """

    def __init__(self, need: int, free: int):
        super().__init__(
            f"KV blocks exhausted: need {need}, {free} free")
        self.need = need
        self.free = free


class BlockAllocator:
    """Fixed-size block pool with per-owner block tables.

    Owners are opaque strings (slot ids in the decode server).  The
    free list is kept sorted ascending so allocation order is a pure
    function of the alloc/free history — the property that lets a
    replica mirror the pool without any wire chatter.
    """

    def __init__(self, n_blocks: int, block_tokens: int):
        if n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
        if block_tokens < 1:
            raise ValueError(
                f"block_tokens must be >= 1, got {block_tokens}")
        self.n_blocks = int(n_blocks)
        self.block_tokens = int(block_tokens)
        self._free: list[int] = list(range(self.n_blocks))
        self._tables: dict[str, list[int]] = {}

    # -- capacity accounting ------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - len(self._free)

    def can_fit(self, tokens: int) -> bool:
        """Would a request needing ``tokens`` KV entries be admitted?"""
        return blocks_needed(tokens, self.block_tokens) <= len(self._free)

    def largest_free_run(self) -> int:
        """Longest contiguous run of free block ids — the
        fragmentation number beside the free count: the free list is
        kept sorted, so one linear scan answers it."""
        best = run = 0
        prev = None
        for b in self._free:
            run = run + 1 if prev is not None and b == prev + 1 else 1
            if run > best:
                best = run
            prev = b
        return best

    def owners(self) -> list[str]:
        return list(self._tables)

    def table(self, owner: str) -> list[int]:
        """The owner's block table (a copy), in logical order."""
        return list(self._tables[owner])

    def owner_blocks(self, owner: str) -> int:
        t = self._tables.get(owner)
        return 0 if t is None else len(t)

    # -- alloc / grow / free ------------------------------------------
    def alloc(self, owner: str, n: int) -> list[int]:
        """Allocate ``n`` blocks for a new owner; returns the table.

        Raises :class:`BlocksExhausted` (nothing is taken) when the
        pool cannot satisfy the request, and ``ValueError`` if the
        owner already holds blocks — double-admission is a caller bug,
        not a capacity condition.
        """
        if owner in self._tables:
            raise ValueError(f"owner {owner!r} already has blocks")
        n = int(n)
        if n < 0:
            raise ValueError(f"negative block count {n}")
        if n > len(self._free):
            raise BlocksExhausted(n, len(self._free))
        taken, self._free = self._free[:n], self._free[n:]
        self._tables[owner] = taken
        return list(taken)

    def extend(self, owner: str, n: int) -> list[int]:
        """Grow an existing owner's table by ``n`` blocks.

        Block-table growth for requests whose budget is raised after
        admission.  All-or-nothing like :meth:`alloc`.
        """
        if owner not in self._tables:
            raise KeyError(f"unknown owner {owner!r}")
        n = int(n)
        if n < 0:
            raise ValueError(f"negative block count {n}")
        if n > len(self._free):
            raise BlocksExhausted(n, len(self._free))
        taken, self._free = self._free[:n], self._free[n:]
        self._tables[owner].extend(taken)
        return list(taken)

    def free(self, owner: str) -> int:
        """Release every block the owner holds; returns how many.

        Freeing an unknown owner is a no-op returning 0 — release and
        failover paths may race a finish, and double-free must not
        corrupt the pool.
        """
        t = self._tables.pop(owner, None)
        if t is None:
            return 0
        self._free.extend(t)
        self._free.sort()
        return len(t)

    def reset(self) -> None:
        """Drop every table and return all blocks to the free list."""
        self._tables.clear()
        self._free = list(range(self.n_blocks))

    # -- defrag --------------------------------------------------------
    def defrag(self) -> dict[int, int]:
        """Compact live blocks toward low ids; returns ``{old: new}``.

        After churn the live blocks are scattered across the id space.
        Compaction renumbers them densely from 0 (stable owner order,
        logical order preserved within each table) so the device pool's
        hot region is contiguous.  Only genuinely moving blocks appear
        in the returned map; the device layer applies it with a single
        gather.  Conservation is untouched — ``check()`` holds before
        and after.
        """
        moves: dict[int, int] = {}
        nxt = 0
        for owner in self._tables:
            tbl = self._tables[owner]
            for i, old in enumerate(tbl):
                if old != nxt:
                    moves[old] = nxt
                    tbl[i] = nxt
                nxt += 1
        self._free = list(range(nxt, self.n_blocks))
        return moves

    # -- invariants ----------------------------------------------------
    def check(self) -> None:
        """Assert conservation: every block owned exactly once or free."""
        seen: set[int] = set()
        for owner, tbl in self._tables.items():
            for b in tbl:
                if not (0 <= b < self.n_blocks):
                    raise AssertionError(
                        f"owner {owner!r} holds out-of-range block {b}")
                if b in seen:
                    raise AssertionError(
                        f"block {b} owned twice (second: {owner!r})")
                seen.add(b)
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate ids on the free list")
        if free & seen:
            raise AssertionError(
                f"blocks both free and owned: {sorted(free & seen)}")
        if len(free) + len(seen) != self.n_blocks:
            raise AssertionError(
                f"conservation broken: {len(seen)} used + "
                f"{len(free)} free != {self.n_blocks} total")

    def snapshot(self) -> dict:
        """Occupancy summary for status surfaces and metrics gauges."""
        return {
            "blocks": self.n_blocks,
            "block_tokens": self.block_tokens,
            "used": self.used_blocks,
            "free": self.free_blocks,
            "largest_run": self.largest_free_run(),
            "owners": {o: len(t) for o, t in self._tables.items()},
        }
