"""Paged KV-cache accounting: fixed-size pages, per-request page tables.

A production serving engine never gives a request a dense
``(capacity,)`` KV slab up front -- it would strand memory on short
requests and crash on long ones (the old ``ServeEngine`` did exactly
that: ``padded[:plen]`` raised once ``plen`` outgrew ``capacity``).
Instead the physical KV store is a pool of fixed-size **pages**; each
request owns a **page table** that grows one page at a time as its
sequence extends, admission is gated on free pages, and retirement
returns every page to the pool (vLLM's PagedAttention memory model).

In this repo the *numerics* still live in the model's per-slot ring
caches (and, for the fabric leg, in the on-fabric KV reservations of
:class:`repro.pim.fabric.FabricSession`); :class:`PagedKV` is the
shared **capacity model** layered on top.  It is accounting, not
arithmetic -- but the policies it drives are real: a prompt that can
never fit is rejected instead of crashing, a decode step that needs a
page from an empty pool preempts a victim, and a leak (a retired
request whose pages were never freed) is a hard error that
:meth:`assert_empty` turns into a test failure.
"""

from __future__ import annotations

from typing import Dict, List


class PagedKV:
    """Fixed-size-page KV pool with per-request page tables.

    ``num_pages`` pages of ``page_size`` token slots each.  Pages are
    handed out LIFO (a freed page is reused first -- locality), and a
    request's table only ever grows until :meth:`free` returns it
    wholesale.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError(
                f"need positive pool: num_pages={num_pages} "
                f"page_size={page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self.tables: Dict[int, List[int]] = {}   # rid -> [page_id, ...]
        self.lens: Dict[int, int] = {}           # rid -> tokens held
        self.stats = {"allocs": 0, "frees": 0, "pages_alloc": 0,
                      "pages_freed": 0, "failed_appends": 0,
                      "high_water_pages": 0}

    # -- capacity queries ---------------------------------------------------
    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` (at least one)."""
        return max(1, -(-int(n_tokens) // self.page_size))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def capacity_tokens(self) -> int:
        """Total token slots the pool can ever hold."""
        return self.num_pages * self.page_size

    def can_admit(self, n_tokens: int) -> bool:
        """Enough *free* pages to hold ``n_tokens`` right now?"""
        return self.pages_for(n_tokens) <= self.free_pages

    def can_ever_fit(self, n_tokens: int) -> bool:
        """Could ``n_tokens`` fit in an *empty* pool?  (admission's
        reject-vs-wait distinction: False means reject forever)."""
        return self.pages_for(n_tokens) <= self.num_pages

    # -- lifecycle ----------------------------------------------------------
    def alloc(self, rid: int, n_tokens: int) -> bool:
        """Admit ``rid`` holding ``n_tokens``; False if pages run short
        (no partial allocation is left behind)."""
        if rid in self.tables:
            raise KeyError(f"rid {rid} already holds pages")
        need = self.pages_for(n_tokens)
        if need > self.free_pages:
            return False
        self.tables[rid] = [self._free.pop() for _ in range(need)]
        self.lens[rid] = int(n_tokens)
        self.stats["allocs"] += 1
        self.stats["pages_alloc"] += need
        self.stats["high_water_pages"] = max(
            self.stats["high_water_pages"], self.used_pages)
        return True

    def append(self, rid: int) -> bool:
        """Extend ``rid`` by one token; allocates a page on a boundary
        crossing.  False (state unchanged) when the pool is dry -- the
        caller's cue to preempt a victim and retry."""
        table = self.tables[rid]
        new_len = self.lens[rid] + 1
        if new_len > len(table) * self.page_size:
            if not self._free:
                self.stats["failed_appends"] += 1
                return False
            table.append(self._free.pop())
            self.stats["pages_alloc"] += 1
            self.stats["high_water_pages"] = max(
                self.stats["high_water_pages"], self.used_pages)
        self.lens[rid] = new_len
        return True

    def free(self, rid: int) -> int:
        """Return every page ``rid`` holds; returns the page count."""
        table = self.tables.pop(rid)
        del self.lens[rid]
        self._free.extend(reversed(table))
        self.stats["frees"] += 1
        self.stats["pages_freed"] += len(table)
        return len(table)

    def held(self, rid: int) -> bool:
        return rid in self.tables

    # -- audits -------------------------------------------------------------
    def assert_empty(self) -> None:
        """Raise if any request leaked pages (post-``run()`` audit)."""
        if self.tables:
            raise AssertionError(
                f"leaked KV pages: rids {sorted(self.tables)} still hold "
                f"{self.used_pages} pages")
        if self.free_pages != self.num_pages:
            raise AssertionError(
                f"pool accounting drift: {self.free_pages} free != "
                f"{self.num_pages} total")

    def report(self) -> dict:
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "used_pages": self.used_pages,
            "free_pages": self.free_pages,
            "active_requests": len(self.tables),
            **self.stats,
        }
