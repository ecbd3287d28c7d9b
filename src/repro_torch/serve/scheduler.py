"""Admission, ordering, and preemption policy for the serve engine.

The scheduler owns the *which-request-when* decisions and nothing
else -- it never touches model state, so policies are unit-testable
without a model:

* **admission order** -- ``fifo`` (arrival order) or ``deadline``
  (earliest-deadline-first among requests that carry a ``deadline_ms``
  SLO, FIFO among the rest; a deadline always outranks no deadline);
* **admission verdicts** -- a prompt that can *never* fit (longer than
  the per-slot capacity budget or the whole page pool) is rejected or
  truncated up front instead of crashing mid-prefill; a prompt that
  merely has to wait for pages stays queued;
* **chunked prefill** -- prompts longer than ``prefill_chunk`` enter in
  a bounded prefill call and stream their tail through the shared
  decode step, one token per engine step, so a long prompt never stalls
  the decode batch behind a monolithic prefill;
* **preemption victims** -- when a decode step needs a KV page and the
  pool is dry, the victim is the *least-committed* active request: the
  last one admitted under FIFO, the latest-deadline one under
  ``deadline`` (no deadline counts as infinitely late).  Victims are
  requeued with their generated tokens intact and resume by
  re-prefilling ``prompt + out`` (recompute-style preemption -- greedy
  decoding makes the resumed chain bit-identical).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from .kv import PagedKV

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    admission: str = "fifo"              # fifo | deadline
    prefill_chunk: Optional[int] = None  # max tokens per prefill call
    long_prompt: str = "reject"          # reject | truncate

    def __post_init__(self):
        if self.admission not in ("fifo", "deadline"):
            raise ValueError(f"admission={self.admission!r}")
        if self.long_prompt not in ("reject", "truncate"):
            raise ValueError(f"long_prompt={self.long_prompt!r}")
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")


class Scheduler:
    """Queue + policy.  Requests are the engine's ``Request`` objects;
    the scheduler reads their ``deadline_ms`` / sequencing fields and
    writes nothing but queue membership."""

    def __init__(self, cfg: SchedulerConfig, kv: PagedKV, capacity: int):
        self.cfg = cfg
        self.kv = kv
        self.capacity = int(capacity)
        self.queue: List = []
        self._arrivals = 0

    # -- queue --------------------------------------------------------------
    def add(self, req) -> None:
        if req._arrival_seq < 0:          # first arrival; resumes keep it
            req._arrival_seq = self._arrivals
            self._arrivals += 1
        self.queue.append(req)

    def _order_key(self, req):
        if self.cfg.admission == "deadline":
            d = req.deadline_ms if req.deadline_ms is not None else _INF
            return (d, req._arrival_seq)
        return (req._arrival_seq,)

    def peek(self):
        """The next request admission would consider (policy order)."""
        if not self.queue:
            return None
        return min(self.queue, key=self._order_key)

    def pop(self, req) -> None:
        self.queue.remove(req)

    # -- admission verdicts -------------------------------------------------
    def max_admissible_tokens(self, max_new: int) -> int:
        """Longest prompt admissible with a ``max_new`` decode budget:
        the whole sequence must fit BOTH the per-slot capacity and the
        page pool (strict -- no silent ring-buffer wraparound)."""
        return min(self.capacity, self.kv.capacity_tokens) - int(max_new)

    def verdict(self, req) -> str:
        """``admit`` | ``wait`` | ``too_long`` for the request's
        *current* sequence (prompt plus any tokens generated before a
        preemption)."""
        seq_len = len(req.prompt) + len(req.out)
        if len(req.prompt) > self.max_admissible_tokens(req.max_new):
            return "too_long"
        first = self.first_chunk(seq_len)
        return "admit" if self.kv.can_admit(first) else "wait"

    def first_chunk(self, seq_len: int) -> int:
        """Tokens covered by the initial prefill call; the rest streams
        through the decode step."""
        if self.cfg.prefill_chunk is None:
            return seq_len
        return min(seq_len, self.cfg.prefill_chunk)

    # -- preemption ---------------------------------------------------------
    def pick_victim(self, active: List, protect=None):
        """Least-committed active request to evict (None if no
        candidate).  ``protect`` is never chosen -- the request whose
        append triggered the preemption must make progress."""
        cands = [r for r in active if r is not protect]
        if not cands:
            return None
        if self.cfg.admission == "deadline":
            return max(cands, key=lambda r: (
                r.deadline_ms if r.deadline_ms is not None else _INF,
                r._admit_seq))
        return max(cands, key=lambda r: r._admit_seq)
