"""Continuous-batching serve engine: paged KV, scheduled admission,
chunked prefill, preemption, and per-request latency accounting.

The counterpart of ``repro.serve.engine``.  The engine decodes a fixed
batch of ``batch_slots`` lanes through ONE ``decode_step`` and keeps
those lanes full from a queue (continuous batching), on ``device``
(``None``: the GPU).  The reference's ``jax.jit`` of ``decode_step`` and
of the prefill are direct calls here; ``stats["prefill_compiles"]``
still counts the distinct prefill shapes (buckets).  The loop rests on
three serving subsystems:

* :class:`repro_torch.serve.kv.PagedKV` -- a fixed-size-page KV pool with
  per-request page tables.  Admission is capacity-aware (a prompt that
  can never fit is **rejected** with accounting instead of crashing),
  decode appends allocate pages on demand, and a dry pool **preempts**
  the least-committed request (requeued with its tokens; it resumes by
  re-prefilling ``prompt + out`` -- bit-identical under greedy
  decoding).
* :class:`repro_torch.serve.scheduler.Scheduler` -- admission order (FIFO or
  earliest-deadline-first), long-prompt policy (reject | truncate),
  chunked prefill, and victim selection.
* **chunked prefill** -- a prompt longer than ``prefill_chunk`` enters
  with one bounded prefill call and streams its tail through the shared
  decode step, one token per engine step, *interleaved* with the other
  lanes' decode -- a long prompt never stalls the batch.  The streamed
  cache writes are bit-identical to a whole prefill (same projections
  at the same positions), so the first generated token matches.

Scheduling invariants the tests pin:

* a slot freed by a finishing request is **re-admitted in the same
  step** (retire-then-backfill): with work queued, the active-lane
  count never dips between steps;
* every step that did any work (prefill, decode, or retirement) runs
  one accounting epilogue -- ``stats["steps"]``, the per-step deadline
  check, and the sampling-key counter advance together on every path;
* the fabric probe only ever observes **active** lanes' token
  embeddings -- finished slots' stale tokens are never fed to the grid.

An optional ``fabric_probe`` (:class:`repro_torch.pim.fabric.FabricLinearProbe`)
routes linear projections of the live decode step through the simulated
Compute RAM block grid -- the paper's fabric executing a slice of real
serving traffic, with per-step energy/time accounting.  A probe built
with several weights (the Q/K/V/... projections of one layer) runs the
whole decode step's projections as ONE fused
:class:`repro_torch.pim.fabric.FabricProgram`; with ``session=True`` the
probe's weights stay resident across steps even as slots recycle and
the active-lane count (the GEMM's M) changes step to step.

Graceful degradation (docs/faults.md): a probe whose fault model lets a
corruption escape raises
:class:`repro_torch.core.faults.FabricFaultError`; the engine retries the
launch with exponential backoff up to ``probe_retries`` times, then
permanently falls back to the probe's host ``ref`` path
(``observe_ref``) -- serving keeps producing tokens either way.
``step_deadline_ms`` tracks per-step wall-clock deadline misses, and
``fault_report()`` aggregates the health counters.

Temperature sampling draws from a ``torch.Generator`` seeded from
``(seed, step)``: seeded and deterministic, but not the reference's
``jax.random`` stream.  Greedy decoding is ``argmax`` in both."""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.core.faults import FabricFaultError

from .kv import PagedKV
from .scheduler import Scheduler, SchedulerConfig


# eq=False: identity semantics -- requests live in queues and slots, and
# field-wise dataclass equality would compare numpy prompts (ambiguous
# truth value) the moment list.remove() ran
@dataclasses.dataclass(eq=False)
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # SLO: relative per-request deadline (drives deadline-aware
    # admission ordering and the latency report; not a kill switch)
    deadline_ms: Optional[float] = None
    # lifecycle: queued -> prefill (streaming a long prompt) -> decode
    #            -> done | rejected; preemption goes back to queued
    status: str = "queued"
    preemptions: int = 0
    truncated: bool = False
    # latency timestamps (time.perf_counter seconds; None = not reached)
    t_enqueue: Optional[float] = None
    t_admit: Optional[float] = None   # first admission
    t_first: Optional[float] = None   # first generated token
    t_done: Optional[float] = None
    # scheduler bookkeeping (internal)
    _arrival_seq: int = -1
    _admit_seq: int = -1
    _ptr: int = 0                     # next seq index to stream-feed
    _seq: Optional[np.ndarray] = None  # prompt + out at last admission

    # -- latency metrics ----------------------------------------------------
    def queue_ms(self) -> Optional[float]:
        if self.t_enqueue is None or self.t_admit is None:
            return None
        return (self.t_admit - self.t_enqueue) * 1e3

    def ttft_ms(self) -> Optional[float]:
        """Time to first token (enqueue -> first generated token)."""
        if self.t_enqueue is None or self.t_first is None:
            return None
        return (self.t_first - self.t_enqueue) * 1e3

    def ms_per_token(self) -> Optional[float]:
        """Steady-state decode latency: first token -> done, per token.
        A one-token request reports its TTFT-after-admission instead."""
        if self.t_done is None or not self.out:
            return None
        if len(self.out) > 1:
            return (self.t_done - self.t_first) * 1e3 / (len(self.out) - 1)
        return (self.t_done - self.t_admit) * 1e3


def _bucket(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(0, int(n - 1).bit_length())


def _sample_seed(seed: int, step: int) -> int:
    """The sampling generator's seed of engine step ``step``: distinct
    for every (seed, step) pair, so no two steps share a stream."""
    return int(np.random.SeedSequence((seed, step)).generate_state(
        1, np.uint64)[0])


class ServeEngine:
    """Paged continuous-batching decode over fixed shapes.

    All slots share one decode_step; finished slots are refilled
    from the scheduler's queue in the same step they free up.

    New serving knobs (defaults reproduce the pre-paging engine on
    in-capacity workloads):

    * ``page_size`` / ``num_pages`` -- the :class:`PagedKV` pool.  The
      default pool exactly covers ``batch_slots`` dense slots; a
      smaller pool creates admission pressure and preemption.
    * ``prefill_chunk`` -- enable chunked prefill (tokens per prefill
      call; the tail streams through the decode step).
    * ``admission`` -- ``"fifo"`` | ``"deadline"`` ordering.
    * ``long_prompt`` -- ``"reject"`` | ``"truncate"`` for prompts that
      can never fit (longer than ``min(capacity, pool) - max_new``).

    ``device`` is where the engine hands the model its tokens and
    positions (``None``: the GPU; it raises when there is none).
    """

    def __init__(self, model, params, batch_slots: int = 4,
                 capacity: int = 256, temperature: float = 0.0,
                 fabric_probe=None, seed: int = 0,
                 step_deadline_ms: Optional[float] = None,
                 probe_retries: int = 2, probe_backoff_s: float = 0.0,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 admission: str = "fifo", long_prompt: str = "reject",
                 device=None):
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.B = batch_slots
        self.capacity = capacity
        self.temperature = temperature
        self.fabric_probe = fabric_probe
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.pos = np.zeros((batch_slots,), np.int32)
        self.tokens = np.zeros((batch_slots, 1), np.int32)
        self.caches = model.init_cache(batch_slots, capacity)
        self._decode = model.decode_step
        self._prefill_one = (
            lambda p, t: model.prefill(p, tokens=t, capacity=capacity))
        # paged KV pool: default exactly covers the dense per-slot
        # caches (batch_slots x capacity tokens), so in-capacity
        # workloads never feel it; shrink it to model real memory
        # pressure (admission waits, preemption).
        if num_pages is None:
            num_pages = batch_slots * max(1, -(-capacity // page_size))
        self.kv = PagedKV(num_pages, page_size)
        self.sched = Scheduler(
            SchedulerConfig(admission=admission,
                            prefill_chunk=prefill_chunk,
                            long_prompt=long_prompt),
            self.kv, capacity)
        self.rejected: List[Request] = []
        # sampling: each step seeds its generator from (seed, a
        # monotonic step counter), so no two steps share a stream
        self.seed = seed
        self._step_count = 0       # worked steps (sampling-key counter)
        self._decode_count = 0     # decode launches (cold/warm split)
        self._admit_count = 0
        # prompt-length bucketing: the reference compiles _prefill_one
        # once per padded shape, so the distinct buckets count its
        # compiles (and here the distinct prefill shapes).
        # Models with recurrent state (ssm/rec layers) fold pad tokens
        # into their cache, so they prefill at exact lengths instead.
        self._pad_safe = bool(getattr(model, "prefill_pad_safe", True))
        self._prefill_buckets: set = set()
        # graceful degradation knobs + health counters
        self.step_deadline_ms = step_deadline_ms
        self.probe_retries = probe_retries
        self.probe_backoff_s = probe_backoff_s
        self.probe_fallback = False
        self.stats = {"steps": 0, "deadline_misses": 0,
                      "probe_retries": 0, "probe_fallbacks": 0,
                      "prefill_compiles": 0,
                      # scheduler accounting
                      "admitted": 0, "rejected": 0, "truncated": 0,
                      "preemptions": 0, "resumes": 0,
                      "stream_prefill_tokens": 0,
                      # phase timing split (serve_bench artifact): total
                      # prefill wall-clock + prompt tokens pushed through
                      # it, and decode wall-clock split cold (first decode
                      # step: compiles + fabric-session warm-up) vs warm
                      # (steady state)
                      "prefill_s": 0.0, "prefill_tokens": 0,
                      "decode_s": 0.0, "decode_tokens": 0,
                      "decode_cold_s": 0.0, "decode_warm_s": 0.0,
                      "decode_warm_steps": 0}

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """A host int array as a tensor on the engine's device (a copy:
        the engine goes on writing its own arrays)."""
        return torch.tensor(a, device=self.device)

    # -- queue --------------------------------------------------------------
    @property
    def queue(self) -> List[Request]:
        return self.sched.queue

    def add(self, req: Request):
        if req.t_enqueue is None:
            req.t_enqueue = time.perf_counter()
        self.sched.add(req)

    # -- admission ----------------------------------------------------------
    def _next_admissible(self) -> Optional[Request]:
        """Pop the next admissible request per policy; handles
        reject/truncate verdicts inline.  None = nothing can start now
        (empty queue or the policy head is waiting for pages)."""
        while True:
            req = self.sched.peek()
            if req is None:
                return None
            v = self.sched.verdict(req)
            if v == "too_long":
                limit = self.sched.max_admissible_tokens(req.max_new)
                if self.sched.cfg.long_prompt == "truncate" and limit >= 1:
                    # clip in place and re-run the verdict: the
                    # truncated prompt may still have to WAIT for pages
                    req.prompt = np.asarray(req.prompt[:limit], np.int32)
                    if not req.truncated:
                        req.truncated = True
                        self.stats["truncated"] += 1
                    continue
                self.sched.pop(req)
                req.status = "rejected"
                req.t_done = time.perf_counter()
                self.stats["rejected"] += 1
                self.rejected.append(req)
                continue
            if v == "wait":
                # head-of-line: admission stalls until pages free up
                # (skipping past the policy head would starve it)
                return None
            self.sched.pop(req)
            return req

    def _admit(self) -> int:
        """Fill free slots from the queue; returns admissions made."""
        admitted = 0
        for i in range(self.B):
            if self.slots[i] is not None:
                continue
            req = self._next_admissible()
            if req is None:
                break
            self._prefill_into(i, req)
            admitted += 1
        return admitted

    def _prefill_into(self, i: int, req: Request):
        """Admit ``req`` into slot ``i``: bounded prefill call, paged KV
        allocation, and (for long prompts) arming the streamed tail."""
        tp0 = time.perf_counter()
        resume = bool(req.out)
        # a resumed request re-prefills prompt + generated tokens: the
        # recompute preemption policy (greedy chains continue bit-
        # identically; see docs/serve.md)
        seq = (np.concatenate([np.asarray(req.prompt, np.int32),
                               np.asarray(req.out, np.int32)])
               if resume else np.asarray(req.prompt, np.int32))
        seq_len = len(seq)
        chunk = self.sched.first_chunk(seq_len)
        if not self.kv.alloc(req.rid, chunk):
            raise RuntimeError("admission verdict said pages were free")
        # pad the prefill to a power-of-two bucket: ragged arrival
        # traffic hits a handful of compiled prefill shapes instead of
        # one per distinct length.  Pad tokens sit at positions >= the
        # real length, which decode either masks (cache position >
        # current pos) or overwrites before ever attending --
        # bit-identical logits at the real last token.
        bucket = (min(_bucket(chunk), self.capacity)
                  if self._pad_safe else chunk)
        padded = np.zeros((bucket,), np.int32)
        padded[:chunk] = seq[:chunk]
        if bucket not in self._prefill_buckets:
            self._prefill_buckets.add(bucket)
            self.stats["prefill_compiles"] += 1
        logits, cache = self._prefill_one(
            self.params, self._tensor(padded)[None, :])

        # merge this request's cache into slot i: the batch dim is
        # dim 1 for stacked-layer ("unit") caches, dim 0 for
        # unstacked ("rest") layer caches.  The engine owns
        # self.caches, so the merge writes into it in place.
        def merge(full, one, bdim):
            if isinstance(full, dict):
                for k in full:
                    merge(full[k], one[k], 1 if k == "unit" else bdim)
            elif isinstance(full, (list, tuple)):
                for f, o in zip(full, one):
                    merge(f, o, bdim)
            else:
                lead = (slice(None),) * bdim
                full[lead + (i,)] = one[lead + (0,)]

        merge(self.caches, cache, 0)

        now = time.perf_counter()
        if req.t_admit is None:
            req.t_admit = now
        req._admit_seq = self._admit_count
        self._admit_count += 1
        req._seq = seq
        self.slots[i] = req
        self.pos[i] = chunk
        self.stats["admitted"] += 1
        if resume:
            self.stats["resumes"] += 1
        if chunk < seq_len:
            # long prompt: the tail streams through the shared decode
            # step, one token per engine step, interleaved with the
            # other lanes' decode
            req.status = "prefill"
            req._ptr = chunk
            self.tokens[i, 0] = seq[chunk]
        else:
            req.status = "decode"
            nxt = int(torch.argmax(logits[0, chunk - 1]))
            req.out.append(nxt)
            if req.t_first is None:
                req.t_first = now
            self.tokens[i, 0] = nxt
        self.stats["prefill_s"] += time.perf_counter() - tp0
        self.stats["prefill_tokens"] += chunk

    # -- retirement / preemption --------------------------------------------
    def _finish(self, i: int, req: Request):
        req.done = True
        req.status = "done"
        req.t_done = time.perf_counter()
        self.slots[i] = None
        if self.kv.held(req.rid):
            self.kv.free(req.rid)

    def _retire_satisfied(self) -> List[Request]:
        """Finish slots whose budget the prefill token already covered
        (max_new=1 admits) -- decoding them would overshoot."""
        finished = []
        for i, req in enumerate(self.slots):
            if req is not None and len(req.out) >= req.max_new:
                self._finish(i, req)
                finished.append(req)
        return finished

    def _preempt(self, i: int, req: Request):
        """Evict ``req`` from slot ``i`` back to the queue, pages freed,
        generated tokens kept (resume re-prefills prompt + out)."""
        self.kv.free(req.rid)
        self.slots[i] = None
        req.status = "queued"
        req.preemptions += 1
        req._ptr = 0
        req._seq = None
        self.stats["preemptions"] += 1
        self.sched.add(req)

    def _append_kv(self, active: List[int]):
        """Charge one KV token per active lane for this decode step,
        preempting victims while the pool is dry."""
        for i in active:
            req = self.slots[i]
            if req is None:          # already preempted as a victim
                continue
            while not self.kv.append(req.rid):
                others = [r for r in self.slots
                          if r is not None and r is not req]
                victim = self.sched.pick_victim(others)
                if victim is None:
                    raise RuntimeError(
                        "KV pool dry with a single active request -- "
                        "admission should have rejected it")
                vslot = next(j for j, r in enumerate(self.slots)
                             if r is victim)
                self._preempt(vslot, victim)

    # -- probe --------------------------------------------------------------
    def _observe_guarded(self, x):
        """Probe observe with bounded retry-with-backoff, then fallback.

        A :class:`FabricFaultError` (escaped corruption, or a dead grid
        that can no longer be repaired) is retried up to
        ``probe_retries`` times with exponential backoff; if the fabric
        still faults, the engine falls back permanently to the probe's
        host ``ref`` path -- degraded accounting, correct tokens.
        """
        delay = self.probe_backoff_s
        for attempt in range(self.probe_retries + 1):
            try:
                return self.fabric_probe.observe(x)
            except FabricFaultError:
                if attempt < self.probe_retries:
                    self.stats["probe_retries"] += 1
                    if delay > 0:
                        time.sleep(delay)
                        delay *= 2
        self.probe_fallback = True
        self.stats["probe_fallbacks"] += 1
        return self.fabric_probe.observe_ref(x)

    # -- the step -----------------------------------------------------------
    def step(self) -> List[Request]:
        """One scheduling step: retire, admit, decode every active lane,
        retire again, and backfill freed slots -- so with work queued
        the batch never runs a lane short.  Returns finished requests."""
        t0 = time.perf_counter()
        finished = self._retire_satisfied()
        admitted = self._admit()
        # a fresh admit whose prefill token covered its whole budget
        # (max_new=1) finishes before it ever decodes
        finished += self._retire_satisfied()

        active = [i for i, r in enumerate(self.slots) if r is not None]
        decode_ran = False
        if active:
            td0 = time.perf_counter()
            # paged-KV accounting for the token each lane writes this
            # step; a dry pool preempts the least-committed lane(s)
            self._append_kv(active)
            active = [i for i, r in enumerate(self.slots) if r is not None]
            streaming = [i for i in active
                         if self.slots[i].status == "prefill"]
            if self.fabric_probe is not None and not self.fabric_probe.done \
                    and not self.probe_fallback:
                # this step's real activations -- the token embeddings
                # of the ACTIVE lanes only (a finished slot's stale
                # token never reaches the grid; the fused program's M
                # tracks the live batch)
                x = self.model._embed(
                    self.params, self._tensor(self.tokens[active]))
                self._observe_guarded(
                    x.to(torch.float32).cpu().numpy()[:, 0, :])
            logits, self.caches = self._decode(
                self.params, self.caches, self._tensor(self.tokens),
                self._tensor(self.pos))
            if self.temperature > 0:
                gen = torch.Generator(device=logits.device).manual_seed(
                    _sample_seed(self.seed, self._step_count))
                probs = torch.softmax(
                    logits[:, 0].to(torch.float32) / self.temperature, -1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                nxt = torch.argmax(logits[:, 0], dim=-1)
            nxt = nxt.cpu().numpy().astype(np.int32)

            now = time.perf_counter()
            produced = 0
            for i in active:
                req = self.slots[i]
                self.pos[i] += 1
                if req.status == "prefill":
                    # streamed a prompt token into the cache this step
                    req._ptr += 1
                    self.stats["stream_prefill_tokens"] += 1
                    if req._ptr < len(req._seq):
                        self.tokens[i, 0] = req._seq[req._ptr]
                        continue
                    # last prompt token consumed: this step's logits
                    # ARE the first-token logits
                    req.status = "decode"
                req.out.append(int(nxt[i]))
                if req.t_first is None:
                    req.t_first = now
                produced += 1
                self.tokens[i, 0] = nxt[i]
                if len(req.out) >= req.max_new:
                    self._finish(i, req)
                    finished.append(req)
            # decode phase split: the FIRST decode launch pays the
            # one-time costs (the kernels' first launches, fabric-session
            # weight warm-up); later launches are the steady state
            dt = time.perf_counter() - td0
            self.stats["decode_s"] += dt
            self.stats["decode_tokens"] += produced
            if self._decode_count == 0:
                self.stats["decode_cold_s"] += dt
            else:
                self.stats["decode_warm_s"] += dt
                self.stats["decode_warm_steps"] += 1
            self._decode_count += 1
            decode_ran = True

        # retire-then-backfill: a slot freed THIS step serves the queue
        # THIS step (its prefill runs now; it decodes next step)
        admitted += self._admit()

        # unified accounting epilogue: every path that did work -- a
        # prefill-only turn, a retire-only turn, or a full decode --
        # counts the step and checks the deadline (the old early return
        # skipped all of it)
        if decode_ran or admitted or finished:
            self._step_count += 1
            self.stats["steps"] += 1
            if self.step_deadline_ms is not None:
                if (time.perf_counter() - t0) * 1e3 > self.step_deadline_ms:
                    self.stats["deadline_misses"] += 1
        return finished

    def run(self) -> List[Request]:
        done = []
        while self.queue or any(s is not None for s in self.slots):
            done.extend(self.step())
        return done

    # -- reports ------------------------------------------------------------
    def fabric_report(self):
        """Combined cost report of the fabric probe (None if unused).

        Includes the probe's ``config_summary()`` -- the block geometry
        and storage/compute split actually served from, and whether the
        schedule autotuner picked it."""
        if self.fabric_probe is None:
            return None
        return self.fabric_probe.report()

    def kv_report(self) -> dict:
        """The paged pool's allocation accounting (docs/serve.md)."""
        return self.kv.report()

    def fault_report(self) -> dict:
        """Serving health: fault + degradation accounting (docs/faults.md).

        Always available (zeros on a fault-free engine): step and
        deadline counters, probe retries/fallbacks, the probe's
        escaped-output count, and -- when the probe carries a
        :class:`repro_torch.core.faults.FaultModel` -- its full
        injected/detected/repaired/escaped tally."""
        rep = dict(self.stats)
        rep["prefill_bucket_shapes"] = sorted(self._prefill_buckets)
        rep["probe_fallback_active"] = self.probe_fallback
        if self.fabric_probe is not None:
            rep["probe_escaped_outputs"] = getattr(
                self.fabric_probe, "escaped_outputs", 0)
            fm = getattr(self.fabric_probe, "faults", None)
            if fm is not None:
                rep["faults"] = fm.stats()
        return rep
