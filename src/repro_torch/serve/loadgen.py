"""Seeded load generation + latency rollups for the serve engine.

Arrival times are measured in **engine steps**, not wall-clock: the
engine is step-driven, so gating arrivals on the step index makes a
whole load sweep deterministic end-to-end -- same seed, same arrival
interleaving, same admissions, same token streams, on any machine.
Wall-clock enters only through the latency *measurements* (the
``Request`` timestamps the engine stamps as it serves).

Distributions:

* ``poisson`` -- exponential inter-arrival gaps at ``rate`` requests
  per step (the classic open-loop server model);
* ``bursty``  -- ``burst``-sized request clumps every ``burst_gap``
  steps (flash-crowd traffic; stresses admission + page pressure);
* ``all_at_once`` -- everything queued at step 0 (the closed-loop
  reference: maximum batching opportunity, zero arrival noise).

:func:`latency_report` rolls per-request timestamps into the serving
SLO quantities CI gates: p50/p99 decode ms-per-token, p50/p99 time to
first token, queue wait, and aggregate tokens/sec.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np

from .engine import Request, ServeEngine


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    n_requests: int = 100
    seed: int = 0
    arrival: str = "poisson"        # poisson | bursty | all_at_once
    rate: float = 2.0               # poisson: mean arrivals per step
    burst: int = 8                  # bursty: requests per burst
    burst_gap: int = 6              # bursty: steps between bursts
    prompt_len: Tuple[int, int] = (4, 16)   # uniform inclusive range
    max_new: Tuple[int, int] = (2, 8)
    vocab: int = 256
    # fraction of requests carrying a deadline_ms SLO (uniform range)
    deadline_frac: float = 0.0
    deadline_ms: Tuple[float, float] = (50.0, 500.0)
    # fraction of deliberately oversize prompts (admission-rejection
    # traffic); their length is set by the driver via `oversize_len`
    oversize_frac: float = 0.0
    oversize_len: int = 0

    def __post_init__(self):
        if self.arrival not in ("poisson", "bursty", "all_at_once"):
            raise ValueError(f"arrival={self.arrival!r}")


def generate(cfg: LoadConfig) -> List[Tuple[float, Request]]:
    """Seeded ``[(arrival_step, Request), ...]`` sorted by arrival."""
    rng = np.random.default_rng([cfg.seed, 0xC0DE])
    n = cfg.n_requests
    if cfg.arrival == "poisson":
        gaps = rng.exponential(scale=1.0 / max(cfg.rate, 1e-9), size=n)
        at = np.cumsum(gaps)
    elif cfg.arrival == "bursty":
        at = np.asarray([(i // cfg.burst) * cfg.burst_gap
                         for i in range(n)], np.float64)
    else:                            # all_at_once
        at = np.zeros((n,), np.float64)

    out = []
    for rid in range(n):
        oversize = (cfg.oversize_frac > 0
                    and rng.random() < cfg.oversize_frac)
        plen = (cfg.oversize_len if oversize else
                int(rng.integers(cfg.prompt_len[0], cfg.prompt_len[1] + 1)))
        req = Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab, plen).astype(np.int32),
            max_new=int(rng.integers(cfg.max_new[0], cfg.max_new[1] + 1)))
        if cfg.deadline_frac > 0 and rng.random() < cfg.deadline_frac:
            req.deadline_ms = float(rng.uniform(*cfg.deadline_ms))
        out.append((float(at[rid]), req))
    return out


def clone_requests(arrivals) -> List[Tuple[float, Request]]:
    """Fresh Request objects over the same rids/prompts/budgets --
    one load set can drive several engine legs independently."""
    return [(at, Request(rid=r.rid, prompt=np.asarray(r.prompt, np.int32),
                         max_new=r.max_new, deadline_ms=r.deadline_ms))
            for at, r in arrivals]


def drive(engine: ServeEngine, arrivals,
          max_steps: Optional[int] = None) -> dict:
    """Feed ``arrivals`` into the engine as its step index passes each
    arrival time; run to drain.  Returns the run record (done list,
    wall seconds, step count)."""
    pending = sorted(arrivals, key=lambda p: (p[0], p[1].rid))
    done: List[Request] = []
    i = 0
    step_idx = 0
    t0 = time.perf_counter()
    while (i < len(pending) or engine.queue
           or any(s is not None for s in engine.slots)):
        while i < len(pending) and pending[i][0] <= step_idx:
            engine.add(pending[i][1])
            i += 1
        done.extend(engine.step())
        step_idx += 1
        if max_steps is not None and step_idx >= max_steps:
            break
    wall_s = time.perf_counter() - t0
    return {"done": done, "wall_s": wall_s, "steps": step_idx}


def _pct(vals, q):
    return float(np.percentile(np.asarray(vals, np.float64), q))


def latency_report(done: List[Request], wall_s: float,
                   engine: ServeEngine) -> dict:
    """Per-request timestamps -> SLO quantities.

    ``p50_ms``/``p99_ms`` are the decode ms-per-token percentiles over
    completed requests (a request's own steady-state token cadence);
    ``tokens_per_s`` is aggregate generated-token throughput over the
    whole sweep wall-clock (queue time included -- the honest serving
    number)."""
    per_tok = [r.ms_per_token() for r in done
               if r.ms_per_token() is not None]
    ttft = [r.ttft_ms() for r in done if r.ttft_ms() is not None]
    queue = [r.queue_ms() for r in done if r.queue_ms() is not None]
    tokens = sum(len(r.out) for r in done)
    rep = {
        "requests_done": len(done),
        "tokens": tokens,
        "wall_s": round(wall_s, 3),
        "tokens_per_s": round(tokens / max(wall_s, 1e-9), 1),
        "rejected": engine.stats["rejected"],
        "truncated": engine.stats["truncated"],
        "preemptions": engine.stats["preemptions"],
        "resumes": engine.stats["resumes"],
        "steps": engine.stats["steps"],
    }
    for name, vals in (("ms_per_token", per_tok), ("ttft_ms", ttft),
                       ("queue_ms", queue)):
        if vals:
            rep[f"{name}_p50"] = round(_pct(vals, 50), 3)
            rep[f"{name}_p99"] = round(_pct(vals, 99), 3)
    # the gate-facing aliases (CI validates these exact keys)
    rep["p50_ms"] = rep.get("ms_per_token_p50", 0.0)
    rep["p99_ms"] = rep.get("ms_per_token_p99", 0.0)
    return rep
