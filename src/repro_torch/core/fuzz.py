"""Constrained-random microcode fuzzing with differential replay.

The compiler (:mod:`repro.core.compiler`) carries five generations of
semantic passes -- lane vectorization, complementary-predication
coverage, copyrun/fillrun batching, jaxpr CSE, packed bit-plane lowering
with None-elision, multi-loop segmentation, the log-depth ``lane_fold``
carry-save fold -- and two latent cross-lane/borrow-asymmetry bugs were
already found *by hand*.  This module industrializes that
hunt the way constrained-random verification does for RISC-V cores:

* **Sequences** (:data:`SEQUENCES`) are reusable generators of
  random-but-valid node runs, each aimed at one compiler surface:
  predicated trow/tnrow write pairs stress ``_coverage_kills``, FA/FS
  ripple and in-place reduction chains stress ``planes_add`` elision and
  the lane-fold carry-dead proof, copy/fill runs with uniform and
  non-uniform strides stress run batching, hazard loops read rows the
  previous iteration wrote, and multi-loop emissions exercise
  ``analyze_multi`` segmentation.
* A **funnel** (:func:`gen_program`) draws a weighted mix of sequences,
  assigns each a row window inside the block (windows may deliberately
  overlap, for cross-sequence hazards), and concatenates them into one
  :class:`~repro.core.isa.Program` that is well-formed **by
  construction** -- re-checked by :func:`isa.validate_program` before
  every replay.
* **Differential replay** (:func:`replay`) runs every generated program
  across the full executor x packing matrix -- ``unroll`` (oracle),
  ``scan``, ``compiled`` x ``packed in {False, True, None}`` -- plus
  ``execute_blocks`` at a ragged block count, a two-program
  ``run_chain``, and a **fault family** (``"faults"``): the same block
  batch replayed through the protected
  :func:`repro.core.engine.execute_blocks` path with a seeded
  :class:`repro.core.faults.FaultModel` flipping bits between load and
  launch.  With scrub on (the default) the parity scrub must repair
  every flip -- the variant asserts bit-identity with the clean oracle
  AND that the injected flips were actually *detected*; with
  ``FuzzConfig.fault_scrub=False`` the same flips escape into the
  outputs, which is the forced bug the shrinking pipeline reduces to
  the committed ``tests/corpus/fuzz_faults.txt`` repro.
* On mismatch, **delta-debugging shrinking** (:func:`shrink`) reduces
  the repro -- drop sequences, then drop/halve op runs, then narrow the
  column width -- and the minimal program is serialized to a corpus
  file (:func:`save_repro` / :func:`load_corpus`) replayable via
  ``benchmarks/fuzz_run.py --replay FILE``.

Seed discipline: everything derives from one integer seed.
``gen_program(seed, cfg)`` is a pure function, the initial state derives
from ``(seed, "state")``, so a corpus file's seed alone reproduces the
whole scenario; the shrunken node list is stored too, because shrinking
is what seeds cannot reproduce.

See ``docs/fuzzing.md`` for the workflow (CI budget, soak mode, corpus
promotion).

The counterpart of ``repro.core.fuzz``: generators, shrinking, the
corpus text format and ``run_budget`` are the reference's, pure
Python over :mod:`isa`; the initial state, the test mutations and the
state diff are torch, and :func:`replay` drives the port's executors on
the ``device`` it is given (``None``: the GPU).  The same seed gives the
same program and the same initial state in both packages, so a corpus
file replays identically in either.
"""

from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import engine, isa
from . import faults as faults_core
from .isa import (AddReg, Instr, Loop, MovReg, Program, R, SetReg,
                  OP_AND, OP_C0, OP_C1, OP_COPY, OP_CROW, OP_CSTORE,
                  OP_FA, OP_FS, OP_NOP, OP_NOR, OP_NOT, OP_OR, OP_T1,
                  OP_TAND, OP_TC, OP_TNC, OP_TNOT, OP_TNROW, OP_TOR,
                  OP_TROW, OP_TSTORE, OP_W0, OP_W1, OP_XOR)

__all__ = [
    "FuzzConfig", "FuzzProgram", "Mismatch", "ReplayReport", "SEQUENCES",
    "gen_program", "gen_state", "replay", "shrink", "save_repro",
    "load_corpus", "program_to_text", "program_from_text", "run_budget",
    "MUTATIONS",
]


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FuzzConfig:
    """Geometry + budget constraints every generated program honours.

    ``rows``/``cols`` are the single-block geometry; ``blocks`` is the
    (deliberately ragged -- not a canonical budget) block count of the
    ``execute_blocks`` leg; ``max_ops`` caps the expanded stream so a
    CI budget's wall-clock stays bounded; ``min_seqs``/``max_seqs``
    bound the funnel draw; ``weights`` overrides the per-sequence
    default weights (unknown names are an error, weight 0 disables).

    The fault-family knobs drive the ``"faults"`` replay variant:
    ``fault_rate`` is the per-bit flip probability at the pre-launch
    injection point (the default expects a couple of flips per replay
    on the default 3x48x8 batch -- enough that detection is exercised
    on nearly every program); the per-program fault seed is
    ``seed ^ fault_seed``; ``fault_scrub=False`` disables the parity
    scrub so the same flips escape into the outputs -- the forced-bug
    mode the shrinking pipeline and the committed fault corpus use.
    """
    rows: int = 48
    cols: int = 8
    blocks: int = 3
    max_ops: int = 320
    min_seqs: int = 2
    max_seqs: int = 5
    weights: Tuple[Tuple[str, float], ...] = ()
    fault_rate: float = 2e-3
    fault_seed: int = 0xFA17
    fault_scrub: bool = True

    def __post_init__(self):
        if self.rows < 24:
            raise ValueError("fuzz geometry needs >= 24 rows")
        if self.cols < 1 or self.blocks < 1:
            raise ValueError("cols and blocks must be >= 1")
        if not 0.0 <= self.fault_rate <= 1.0:
            raise ValueError(f"fault_rate must be in [0, 1]: "
                             f"{self.fault_rate}")
        for name, _w in self.weights:
            if name not in SEQUENCES:
                raise ValueError(f"unknown sequence {name!r}; "
                                 f"known: {sorted(SEQUENCES)}")


# ---------------------------------------------------------------------------
# Sequences: each returns a list of Nodes touching only rows inside its
# window [base, base + h).  Registers are always Set before use, so a
# sequence never depends on (or leaks) register state across groups.
# ---------------------------------------------------------------------------
_ROW_WRITE_OPS = sorted(isa._WRITES_ROW)
_LATCH_OPS = sorted(set(range(isa.N_ARRAY_OPS)) - isa._WRITES_ROW
                    - {OP_NOP})
_MIN_WINDOW = 12      # every sequence can work inside 12 rows


def _row(rng, base, h):
    return int(base + rng.integers(0, h))


def seq_ops(rng, base, h):
    """Random run of flat micro-ops over the whole opcode space.

    Latch ops are mixed in so carry/tag provenance threads through the
    row writes; ~1/3 of ops are predicated.
    """
    nodes = []
    for _ in range(int(rng.integers(3, 13))):
        if rng.random() < 0.35:
            op = int(rng.choice(_LATCH_OPS))
        else:
            op = int(rng.choice(_ROW_WRITE_OPS))
        nodes.append(Instr(op, dst=_row(rng, base, h),
                           a=_row(rng, base, h), b=_row(rng, base, h),
                           pred=bool(rng.random() < 0.3)))
    return nodes


def seq_predpair(rng, base, h):
    """Complementary trow/tnrow predicated write pairs.

    The canonical ``_coverage_kills`` stressor: tag <- row t, predicated
    write to dst, tag <- ~row t, predicated write to the SAME dst -- the
    pair fully covers dst, so the compiler may (and does) prove the
    pre-pair value dead.  Variants flip which half comes first, write
    different values per half, and sometimes only *almost* cover (a
    different dst in one half) so the kill must NOT fire.
    """
    nodes = []
    for _ in range(int(rng.integers(1, 4))):
        t = _row(rng, base, h)
        d = _row(rng, base, h)
        d2 = d if rng.random() < 0.7 else _row(rng, base, h)   # near-miss
        src1, src2 = _row(rng, base, h), _row(rng, base, h)
        op1 = int(rng.choice([OP_COPY, OP_NOT, OP_W0, OP_W1]))
        op2 = int(rng.choice([OP_COPY, OP_NOT, OP_W0, OP_W1]))
        first, second = ((OP_TROW, OP_TNROW) if rng.random() < 0.5
                         else (OP_TNROW, OP_TROW))
        nodes += [Instr(first, a=t),
                  Instr(op1, dst=d, a=src1, pred=True),
                  Instr(second, a=t),
                  Instr(op2, dst=d2, a=src2, pred=True)]
        if rng.random() < 0.3:           # carry-latch flavored coverage
            nodes += [Instr(OP_CROW, a=t, pred=bool(rng.random() < 0.5)),
                      Instr(OP_TC if rng.random() < 0.5 else OP_TNC),
                      Instr(OP_CSTORE, dst=_row(rng, base, h), pred=True)]
    return nodes


def seq_ripple(rng, base, h):
    """FA/FS ripple chains and in-place reduction chains.

    Three flavors, all register-walked hardware loops (the lane-plan
    idiom):

    * three-address ripple ``d <- a (+/-) b`` over ``n`` bit rows;
    * in-place ``d <- d (+/-) a`` accumulation over shared rows -- the
      ``planes_add`` / lane-fold carry-dead surface, including the
      a-0 / 0-b borrow-asymmetry class;
    * a bounded carry-ripple suffix against a constant row (the idot
      idiom): ``W0 z; loop(FA d, d, z)``.
    """
    n = int(rng.integers(2, max(3, h // 3)))
    d0, a0, b0 = (int(base + o) for o in
                  rng.choice(h - n + 1, size=3, replace=True))
    op = OP_FS if rng.random() < 0.5 else OP_FA
    carry = int(rng.choice([OP_C0, OP_C1]))
    nodes: List = [Instr(carry)]
    flavor = rng.random()
    if flavor < 0.4:                                  # three-address
        nodes += [SetReg(1, d0), SetReg(2, a0), SetReg(3, b0),
                  Loop(n, [Instr(op, R(1), R(2), R(3),
                                 inc=((1, 1), (2, 1), (3, 1)))])]
    elif flavor < 0.8:                                # in-place
        nodes += [SetReg(1, d0), SetReg(2, a0),
                  Loop(n, [Instr(op, R(1), R(1), R(2),
                                 inc=((1, 1), (2, 1)))])]
    else:                                             # a-0 / 0-b elision
        z = int(base + h - 1)
        nodes += [Instr(OP_W0, dst=z), SetReg(1, d0),
                  Loop(n, [Instr(op, R(1), R(1), z, inc=((1, 1),))])]
    if rng.random() < 0.5:
        nodes.append(Instr(OP_CSTORE, dst=_row(rng, base, h)))
    if rng.random() < 0.3:                            # bounded suffix
        z = int(base + h - 1)
        k = int(rng.integers(1, 4))
        top = min(d0 + n + k, base + h - 1)
        if top > d0 + n:
            nodes += [Instr(OP_W0, dst=z), SetReg(1, d0 + n),
                      Loop(top - (d0 + n),
                           [Instr(OP_FA, R(1), R(1), z, inc=((1, 1),))])]
    return nodes


def seq_copyfill(rng, base, h):
    """Copy/fill runs with uniform and non-uniform strides.

    The copyrun/fillrun batching surface: loop-compressed COPY/NOT/W0/W1
    walks where dst and src advance at the same rate (uniform -- the
    batchable case) or different rates (non-uniform -- must NOT batch),
    optionally predicated.
    """
    nodes = []
    for _ in range(int(rng.integers(1, 4))):
        op = int(rng.choice([OP_COPY, OP_NOT, OP_W0, OP_W1]))
        sd = int(rng.choice([1, 1, 2, 3]))
        sa = int(rng.choice([0, 1, 1, 2])) if op in (OP_COPY, OP_NOT) \
            else 0
        span = max(sd, sa, 1)
        n = int(rng.integers(2, max(3, (h - 1) // span + 1)))
        n = min(n, (h - 1) // span) or 1
        d0 = int(base + rng.integers(0, h - (n - 1) * sd))
        a0 = int(base + rng.integers(0, h - max(1, (n - 1) * sa)))
        pred = bool(rng.random() < 0.25)
        if pred:
            nodes.append(Instr(OP_TROW, a=_row(rng, base, h)))
        inc = ((1, sd),) + (((2, sa),) if sa else ())
        body = Instr(op, R(1), R(2) if sa else a0, pred=pred, inc=inc)
        nodes += [SetReg(1, d0)] + ([SetReg(2, a0)] if sa else []) \
            + [Loop(n, [body])]
    return nodes


def seq_hazard(rng, base, h):
    """Loops whose iterations read rows written in the same loop.

    Iteration ``i`` writes row ``w + i`` and reads row ``w + i - 1``
    (written by iteration ``i - 1``) plus a fixed shared row that the
    loop itself keeps overwriting -- the read-after-write-in-loop
    pattern that cross-lane provenance staleness gets wrong when lanes
    are vectorized.
    """
    n = int(rng.integers(2, max(3, h // 2)))
    w0 = int(base + rng.integers(1, h - n + 1))
    shared = int(base + rng.integers(0, h))
    op = int(rng.choice([OP_XOR, OP_AND, OP_OR, OP_FA, OP_FS]))
    nodes: List = []
    if op in (OP_FA, OP_FS):
        nodes.append(Instr(int(rng.choice([OP_C0, OP_C1]))))
    nodes += [SetReg(1, w0), SetReg(2, w0 - 1),
              Loop(n, [Instr(op, R(1), R(2), shared,
                             inc=((1, 1), (2, 1))),
                       Instr(OP_COPY, shared, R(2))])]
    return nodes


def seq_latch(rng, base, h):
    """Carry/tag latch torture: dense latch-op interleavings.

    Random walks over the full latch-op set (tc/tnc/tag algebra,
    predicated carry loads, cstore's carry clear) with just enough row
    writes in between that latch provenance must thread through the
    compiled executor's state tracking.
    """
    nodes = []
    for _ in range(int(rng.integers(4, 10))):
        r = rng.random()
        if r < 0.55:
            op = int(rng.choice(_LATCH_OPS))
            nodes.append(Instr(op, a=_row(rng, base, h),
                               pred=bool(rng.random() < 0.3)))
        elif r < 0.8:
            nodes.append(Instr(int(rng.choice([OP_CSTORE, OP_TSTORE])),
                               dst=_row(rng, base, h),
                               pred=bool(rng.random() < 0.4)))
        else:
            nodes.append(Instr(int(rng.choice([OP_FA, OP_FS, OP_XOR])),
                               dst=_row(rng, base, h),
                               a=_row(rng, base, h),
                               b=_row(rng, base, h),
                               pred=bool(rng.random() < 0.3)))
    return nodes


def seq_multiloop(rng, base, h):
    """TWO top-level hardware loops back to back.

    Guarantees the program has at least two dominant loops, so
    ``analyze_multi`` segmentation (and the chained lane plans over a
    shared row store) is exercised even when the funnel drew only this
    sequence.  The second loop reads rows the first loop wrote.
    """
    half = h // 2
    n1 = int(rng.integers(2, max(3, half)))
    n2 = int(rng.integers(2, max(3, half)))
    d1 = int(base + rng.integers(0, half - n1 + 1)) if half > n1 else base
    d2 = int(base + half)
    op1 = int(rng.choice([OP_COPY, OP_XOR, OP_FA]))
    op2 = int(rng.choice([OP_FA, OP_FS, OP_AND]))
    nodes: List = []
    if op1 == OP_FA:
        nodes.append(Instr(OP_C0))
    src = int(base + rng.integers(0, h))
    nodes += [SetReg(1, d1),
              Loop(n1, [Instr(op1, R(1), R(1), src, inc=((1, 1),))])]
    if op2 in (OP_FA, OP_FS):
        nodes.append(Instr(int(rng.choice([OP_C0, OP_C1]))))
    n2 = min(n2, base + h - d2)
    if n2 >= 1:
        nodes += [SetReg(1, d2), SetReg(2, d1),
                  Loop(n2, [Instr(op2, R(1), R(2), d1,
                                  inc=((1, 1), (2, 1)))])]
    return nodes


#: name -> (generator, default weight).  Weights shape the funnel draw;
#: override per run via FuzzConfig.weights.
SEQUENCES: Dict[str, Tuple[Callable, float]] = {
    "ops": (seq_ops, 1.0),
    "predpair": (seq_predpair, 1.2),
    "ripple": (seq_ripple, 1.4),
    "copyfill": (seq_copyfill, 1.0),
    "hazard": (seq_hazard, 1.2),
    "latch": (seq_latch, 1.0),
    "multiloop": (seq_multiloop, 0.8),
}


# ---------------------------------------------------------------------------
# The funnel: weighted sequence mix -> one valid Program
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FuzzProgram:
    """One generated scenario: seed, geometry, and the grouped nodes.

    ``groups`` keeps the sequence boundaries (name, nodes) -- the first
    shrinking level drops whole groups.  ``shrunk`` marks instances
    whose nodes no longer derive from the seed (corpus files store the
    node text for exactly this reason).
    """
    seed: int
    cfg: FuzzConfig
    groups: Tuple[Tuple[str, Tuple], ...]
    shrunk: bool = False

    @property
    def program(self) -> Program:
        p = self.__dict__.get("_program")
        if p is None:
            nodes = [nd for _name, nds in self.groups for nd in nds]
            tag = "min" if self.shrunk else "gen"
            p = Program(f"fuzz_s{self.seed}_{tag}", nodes)
            object.__setattr__(self, "_program", p)
        return p

    def with_groups(self, groups, cfg=None) -> "FuzzProgram":
        return FuzzProgram(self.seed, cfg or self.cfg,
                           tuple((n, tuple(g)) for n, g in groups),
                           shrunk=True)

    def describe(self) -> str:
        names = ",".join(n for n, _ in self.groups)
        return (f"seed={self.seed} [{names}] "
                + isa.describe_stream(self.program))


def _weights(cfg: FuzzConfig):
    w = {name: wt for name, (_fn, wt) in SEQUENCES.items()}
    w.update(dict(cfg.weights))
    names = [n for n, wt in w.items() if wt > 0]
    probs = np.array([w[n] for n in names], float)
    return names, probs / probs.sum()


def gen_program(seed: int, cfg: FuzzConfig = FuzzConfig()) -> FuzzProgram:
    """Generate one random-but-valid program (pure in ``seed``/``cfg``).

    Draws ``min_seqs..max_seqs`` sequences by weight, gives each a row
    window (>= 12 rows, sometimes overlapping a neighbour's window for
    cross-sequence hazards), and concatenates until :attr:`max_ops`
    would be exceeded.  The result always passes
    :func:`isa.validate_program`.
    """
    rng = np.random.default_rng([int(seed), 0xF0225])
    names, probs = _weights(cfg)
    k = int(rng.integers(cfg.min_seqs, cfg.max_seqs + 1))
    picks = [str(rng.choice(names, p=probs)) for _ in range(k)]
    groups: List[Tuple[str, Tuple]] = []
    total = 0
    for name in picks:
        fn, _w = SEQUENCES[name]
        h = int(rng.integers(_MIN_WINDOW, min(cfg.rows, 2 * _MIN_WINDOW) + 1))
        base = int(rng.integers(0, cfg.rows - h + 1))
        nodes = fn(rng, base, h)
        cost = Program("_", list(nodes)).cycles()
        if groups and total + cost > cfg.max_ops:
            break
        groups.append((name, tuple(nodes)))
        total += cost
    fp = FuzzProgram(int(seed), cfg, tuple(groups))
    bad = isa.validate_program(fp.program, cfg.rows)
    if bad:     # a sequence generator broke its window contract
        raise AssertionError(
            f"generator emitted an invalid program (seed {seed}): {bad}")
    return fp


def gen_state(seed: int, cfg: FuzzConfig, blocks: int = 0, device=None):
    """Random initial CRState for ``seed`` (array, carry AND tag random).

    ``blocks=0`` gives a single-block ``(rows, cols)`` state; otherwise
    a ``(blocks, rows, cols)`` batch.  Derived from the seed alone so a
    corpus file's seed reproduces the exact scenario; the draws are the
    reference's, placed on ``device`` (``None``: the GPU).
    """
    dev = engine.resolve_device(device)
    rng = np.random.default_rng([int(seed), 0x57A7E])
    shape = (cfg.rows, cfg.cols) if blocks == 0 \
        else (blocks, cfg.rows, cfg.cols)
    cshape = shape[:-2] + shape[-1:]

    def bits(shp):
        return torch.from_numpy(rng.integers(0, 2, shp).astype(bool)).to(dev)

    # array, carry, tag: the reference's draw order
    return engine.CRState(array=bits(shape), carry=bits(cshape),
                          tag=bits(cshape))


# ---------------------------------------------------------------------------
# Differential replay
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Mismatch:
    variant: str        # e.g. "compiled:packed=True", "blocks", "chain"
    field: str          # array | carry | tag | cycles | footprint
    detail: str


@dataclasses.dataclass
class ReplayReport:
    fp: FuzzProgram
    mismatches: List[Mismatch]
    variants: Tuple[str, ...]
    cycles: int = 0
    footprint: int = 0

    @property
    def ok(self) -> bool:
        return not self.mismatches


#: the full differential matrix.  unroll is the oracle, not a variant.
#: "faults" replays the block batch through the protected engine path
#: with seeded bit flips injected pre-launch (scrub-on => bit-exact).
VARIANTS = ("scan", "compiled:packed=False", "compiled:packed=True",
            "compiled:packed=None", "blocks", "chain", "faults")

#: known-bad mutations (test hooks for the shrinking pipeline): name ->
#: fn(variant, program, CRState) -> CRState applied to a variant's
#: output.  "fa-flip" corrupts the packed compiled path's first array
#: bit whenever the program contains an OP_FA -- a stand-in for a real
#: lowering bug, used by tests and `fuzz_run.py --force-bug`.
def _mut_fa_flip(variant: str, program: Program, state):
    if variant != "compiled:packed=True":
        return state
    if not any(i.op == OP_FA for i in program.expand()):
        return state
    arr = state.array.clone()
    arr[0, 0] = torch.logical_not(arr[0, 0])
    return state._replace(array=arr)


def _mut_pred_carry(variant: str, program: Program, state):
    if variant != "scan" or not program.meta().uses_pred:
        return state
    return state._replace(carry=torch.logical_not(state.carry))


MUTATIONS: Dict[str, Callable] = {
    "fa-flip": _mut_fa_flip,
    "pred-carry": _mut_pred_carry,
}


def _diff_state(variant: str, got, want, out: List[Mismatch]):
    for field in ("array", "carry", "tag"):
        g = getattr(got, field).cpu().numpy()
        w = getattr(want, field).cpu().numpy()
        if not np.array_equal(g, w):
            n = int((g != w).sum())
            idx = tuple(int(x[0]) for x in np.nonzero(g != w))
            out.append(Mismatch(variant, field,
                                f"{n} bit(s) differ, first at {idx}"))


def replay(fp: FuzzProgram, variants: Sequence[str] = VARIANTS,
           mutate: Optional[Callable] = None,
           device=None) -> ReplayReport:
    """Differentially replay ``fp`` across ``variants`` vs the unroll
    oracle; returns the mismatch report (empty = bit-identical).

    Also re-checks validity and, for unshrunk programs, regenerates from
    the seed and pins fingerprint/cycles/footprint -- the seed
    discipline that makes every corpus line reproducible.

    ``mutate`` is the test seam for the shrinking pipeline: it is
    applied to every variant's final state (see :data:`MUTATIONS`).
    Every executor runs on ``device`` (``None``: the GPU).
    """
    device = engine.resolve_device(device)
    prog, cfg = fp.program, fp.cfg
    mismatches: List[Mismatch] = []
    bad = isa.validate_program(prog, cfg.rows)
    if bad:
        return ReplayReport(fp, [Mismatch("validate", "program", "; ".join(bad))],
                            tuple(variants))

    cycles, footprint = prog.cycles(), prog.footprint()
    if not fp.shrunk:
        regen = gen_program(fp.seed, cfg)
        if regen.program.fingerprint() != prog.fingerprint():
            mismatches.append(Mismatch("regen", "fingerprint",
                                       "generator is not seed-deterministic"))
        if regen.program.cycles() != cycles:
            mismatches.append(Mismatch("regen", "cycles",
                                       f"{regen.program.cycles()} != {cycles}"))
        if regen.program.footprint() != footprint:
            mismatches.append(
                Mismatch("regen", "footprint",
                         f"{regen.program.footprint()} != {footprint}"))
    # the cycle accounting must agree with the stream metadata
    meta = prog.meta()
    if cycles != meta.n_cycles + prog._ctrl_cycles:
        mismatches.append(Mismatch("meta", "cycles",
                                   f"cycles()={cycles} != stream "
                                   f"{meta.n_cycles}+{prog._ctrl_cycles}"))

    state = gen_state(fp.seed, cfg, device=device)
    want = engine.execute(prog, state)                      # oracle
    if mutate is not None:
        want = mutate("unroll", prog, want)

    def check(variant, got):
        if mutate is not None:
            got = mutate(variant, prog, got)
        _diff_state(variant, got, want, mismatches)

    # "blocks" and "faults" share one block batch + unroll oracle, so
    # running both costs a single extra (compile-cached) executable run
    _blocks_oracle = {}

    def blocks_oracle():
        if not _blocks_oracle:
            bstates = gen_state(fp.seed, cfg, blocks=cfg.blocks,
                                device=device)
            _blocks_oracle["v"] = (
                bstates, engine.execute_blocks(prog, bstates, "unroll"))
        return _blocks_oracle["v"]

    for variant in variants:
        if variant == "scan":
            check(variant, engine.execute_scan(prog, state))
        elif variant.startswith("compiled:"):
            pk = {"False": False, "True": True,
                  "None": None}[variant.split("=", 1)[1]]
            check(variant, engine.execute_compiled(prog, state, packed=pk))
        elif variant == "blocks":
            bstates, bwant = blocks_oracle()
            bgot = engine.execute_blocks(prog, bstates, "compiled")
            if mutate is not None:
                bgot = mutate(variant, prog, bgot)
            _diff_state(variant, bgot, bwant, mismatches)
        elif variant == "faults":
            bstates, bwant = blocks_oracle()
            fm = faults_core.FaultModel(
                bit_rate=cfg.fault_rate, seed=fp.seed ^ cfg.fault_seed,
                scrub=cfg.fault_scrub)
            fgot = engine.execute_blocks(prog, bstates, "compiled",
                                         faults=fm)
            if mutate is not None:
                fgot = mutate(variant, prog, fgot)
            _diff_state(variant, fgot, bwant, mismatches)
            if cfg.fault_scrub and fm.injected_flips and not fm.detected:
                mismatches.append(Mismatch(
                    variant, "detection",
                    f"{fm.injected_flips} flip(s) injected but parity "
                    f"scrub detected none"))
        elif variant == "chain":
            cwant = engine.execute(prog, want)     # 2nd sequential run
            cgot = engine.run_chain([prog, prog], state)
            if mutate is not None:
                cgot = mutate(variant, prog, cgot)
            _diff_state(variant, cgot, cwant, mismatches)
        else:
            raise ValueError(f"unknown replay variant {variant!r}")
    return ReplayReport(fp, mismatches, tuple(variants),
                        cycles=cycles, footprint=footprint)


# ---------------------------------------------------------------------------
# Delta-debugging shrinking
# ---------------------------------------------------------------------------
def _map_loops(nodes, edit):
    """All single-loop edits of a node tuple (used by the loop pass)."""
    out = []
    for i, nd in enumerate(nodes):
        if isinstance(nd, Loop):
            for repl in edit(nd):
                cand = list(nodes)
                if repl is None:
                    cand[i:i + 1] = list(nd.body)      # unwrap
                else:
                    cand[i] = repl
                out.append(tuple(cand))
            for sub in _map_loops(tuple(nd.body), edit):
                cand = list(nodes)
                cand[i] = Loop(nd.count, list(sub))
                out.append(tuple(cand))
    return out


def shrink(fp: FuzzProgram, fails: Callable[[FuzzProgram], bool],
           max_evals: int = 250) -> FuzzProgram:
    """Reduce ``fp`` to a (locally) minimal program with ``fails`` true.

    Classic greedy delta debugging in three levels, in this order:
    (1) drop whole sequences (groups), (2) drop / halve op runs inside
    the survivors (top-level nodes, loop trip counts, loop bodies, loop
    unwrapping), (3) narrow the column width.
    ``fails`` is typically a one-variant :func:`replay` closure -- the
    caller restricts to the variant that originally mismatched, so each
    probe costs one compile, not six.  Bounded by ``max_evals`` probes.
    """
    evals = [0]

    def try_cand(cand: FuzzProgram):
        if not any(nds for _n, nds in cand.groups):
            return None
        if evals[0] >= max_evals:
            return None
        evals[0] += 1
        try:
            return cand if fails(cand) else None
        except Exception:
            return None       # a candidate that errors is not a repro

    cur = fp
    # -- level 1: drop whole groups ----------------------------------------
    changed = True
    while changed and len(cur.groups) > 1:
        changed = False
        for i in range(len(cur.groups) - 1, -1, -1):
            cand = cur.with_groups(
                [g for j, g in enumerate(cur.groups) if j != i])
            got = try_cand(cand)
            if got is not None:
                cur, changed = got, True
                break

    # -- level 2: drop / halve op runs inside groups -----------------------
    def node_edits(cur):
        """Candidate programs from one structural edit anywhere."""
        for gi, (name, nodes) in enumerate(cur.groups):
            # drop contiguous chunks (halves first, then singles)
            n = len(nodes)
            for size in (max(1, n // 2), 1):
                for s in range(0, n, size):
                    rest = nodes[:s] + nodes[s + size:]
                    if not rest and len(cur.groups) == 1:
                        continue
                    yield cur.with_groups(
                        [(nm, rest if j == gi else nds)
                         for j, (nm, nds) in enumerate(cur.groups)])
            # halve loop counts / unwrap loops / shrink loop bodies
            def loop_edit(lp):
                reps = []
                if lp.count > 1:
                    reps.append(Loop(max(1, lp.count // 2), lp.body))
                    reps.append(Loop(1, lp.body))
                reps.append(None)                      # unwrap once
                if len(lp.body) > 1:
                    for k in range(len(lp.body)):
                        reps.append(Loop(lp.count,
                                         lp.body[:k] + lp.body[k + 1:]))
                return reps
            for edited in _map_loops(nodes, loop_edit):
                yield cur.with_groups(
                    [(nm, edited if j == gi else nds)
                     for j, (nm, nds) in enumerate(cur.groups)])

    changed = True
    while changed and evals[0] < max_evals:
        changed = False
        for cand in node_edits(cur):
            got = try_cand(cand)
            if got is not None:
                cur, changed = got, True
                break

    # -- level 3: narrow the width -----------------------------------------
    cols = cur.cfg.cols
    while cols > 1 and evals[0] < max_evals:
        cols = max(1, cols // 2)
        cand = cur.with_groups(cur.groups,
                               cfg=dataclasses.replace(cur.cfg, cols=cols))
        got = try_cand(cand)
        if got is None:
            break
        cur = got
    return cur


# ---------------------------------------------------------------------------
# Corpus serialization: a small line-based text format, parseable back
# into a FuzzProgram (shrunken nodes cannot be re-derived from the seed)
# ---------------------------------------------------------------------------
def _ref_to_text(ref) -> str:
    if isinstance(ref, R):
        return f"R{ref.reg}{ref.offset:+d}" if ref.offset else f"R{ref.reg}"
    return str(int(ref))


def _ref_from_text(s: str):
    if s.startswith("R"):
        body = s[1:]
        for i, c in enumerate(body):
            if c in "+-":
                return R(int(body[:i]), int(body[i:]))
        return R(int(body))
    return int(s)


def _nodes_to_lines(nodes, indent: int, out: List[str]):
    pad = "  " * indent
    for nd in nodes:
        if isinstance(nd, Loop):
            out.append(f"{pad}loop {nd.count}")
            _nodes_to_lines(nd.body, indent + 1, out)
            out.append(f"{pad}endloop")
        elif isinstance(nd, SetReg):
            out.append(f"{pad}setreg {nd.reg} {nd.value}")
        elif isinstance(nd, AddReg):
            out.append(f"{pad}addreg {nd.reg} {nd.delta}")
        elif isinstance(nd, MovReg):
            out.append(f"{pad}movreg {nd.dst} {nd.src} {nd.offset}")
        else:
            # serialize every operand (even ones the op ignores) so a
            # parsed program's expanded stream is byte-identical
            parts = [f"instr {isa.ARRAY_OP_NAMES[nd.op]}"]
            for field in ("dst", "a", "b"):
                ref = getattr(nd, field)
                if ref != 0:
                    parts.append(f"{field}={_ref_to_text(ref)}")
            if nd.pred:
                parts.append("pred")
            if nd.inc:
                parts.append("inc=" + ",".join(f"{r}:{d}"
                                               for r, d in nd.inc))
            out.append(pad + " ".join(parts))


def program_to_text(fp: FuzzProgram, header: Dict[str, str] = ()) -> str:
    """Serialize ``fp`` (geometry, seed, grouped nodes) to corpus text."""
    lines = ["# repro fuzz corpus v1"]
    for k, v in dict(header).items():
        lines.append(f"# {k}: {v}")
    c = fp.cfg
    lines.append(f"seed {fp.seed}")
    lines.append(f"geometry rows={c.rows} cols={c.cols} blocks={c.blocks}")
    dflt = FuzzConfig()
    if (c.fault_rate, c.fault_seed, c.fault_scrub) != \
            (dflt.fault_rate, dflt.fault_seed, dflt.fault_scrub):
        lines.append(f"faults rate={c.fault_rate!r} seed={c.fault_seed} "
                     f"scrub={int(c.fault_scrub)}")
    lines.append(f"shrunk {int(fp.shrunk)}")
    lines.append(f"cycles {fp.program.cycles()}")
    lines.append(f"footprint {fp.program.footprint()}")
    for name, nodes in fp.groups:
        lines.append(f"group {name}")
        _nodes_to_lines(nodes, 1, lines)
    return "\n".join(lines) + "\n"


def program_from_text(text: str) -> Tuple[FuzzProgram, Dict[str, int]]:
    """Parse corpus text back into ``(FuzzProgram, pins)``.

    ``pins`` carries the recorded ``cycles``/``footprint`` so corpus
    regression tests can assert the ISA-level accounting has not
    drifted since the repro was captured.

    The node text is always the source of truth: the text format does
    not record the full generator config (sequence weights etc.), so
    parsed programs are marked ``shrunk=True`` -- replay checks the
    nodes as-is and skips seed regeneration.  The ``shrunk`` header
    line is informational only.
    """
    seed, cfg_kw = 0, {}
    fault_kw: Dict = {}
    pins: Dict[str, int] = {}
    groups: List[Tuple[str, List]] = []
    stack: List[List] = []       # innermost-last loop bodies

    def target() -> List:
        if stack:
            return stack[-1]
        if not groups:
            groups.append(("corpus", []))
        return groups[-1][1]

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        toks = line.split()
        kw = toks[0]
        if kw == "seed":
            seed = int(toks[1])
        elif kw == "geometry":
            cfg_kw = {k: int(v) for k, v in
                      (t.split("=") for t in toks[1:])}
        elif kw == "faults":
            kv = dict(t.split("=") for t in toks[1:])
            fault_kw = {"fault_rate": float(kv.get("rate", 0.0)),
                        "fault_seed": int(kv.get("seed", 0)),
                        "fault_scrub": bool(int(kv.get("scrub", 1)))}
        elif kw == "shrunk":
            pass                       # informational (see docstring)
        elif kw in ("cycles", "footprint"):
            pins[kw] = int(toks[1])
        elif kw == "group":
            if stack:
                raise ValueError("group inside a loop")
            groups.append((toks[1], []))
        elif kw == "loop":
            body: List = []
            target().append(Loop(int(toks[1]), body))
            stack.append(body)
        elif kw == "endloop":
            stack.pop()
        elif kw == "setreg":
            target().append(SetReg(int(toks[1]), int(toks[2])))
        elif kw == "addreg":
            target().append(AddReg(int(toks[1]), int(toks[2])))
        elif kw == "movreg":
            target().append(MovReg(int(toks[1]), int(toks[2]),
                                   int(toks[3])))
        elif kw == "instr":
            op = isa.OP_BY_NAME[toks[1]]
            kws: Dict = {"dst": 0, "a": 0, "b": 0, "pred": False,
                         "inc": ()}
            for t in toks[2:]:
                if t == "pred":
                    kws["pred"] = True
                elif t.startswith("inc="):
                    kws["inc"] = tuple(
                        (int(r), int(d)) for r, d in
                        (p.split(":") for p in t[4:].split(",")))
                else:
                    k, v = t.split("=", 1)
                    kws[k] = _ref_from_text(v)
            target().append(Instr(op, kws["dst"], kws["a"], kws["b"],
                                  kws["pred"], kws["inc"]))
        else:
            raise ValueError(f"unparseable corpus line: {raw!r}")
    if stack:
        raise ValueError("unterminated loop")
    cfg = FuzzConfig(rows=cfg_kw.get("rows", 48),
                     cols=cfg_kw.get("cols", 8),
                     blocks=cfg_kw.get("blocks", 3), **fault_kw)
    fp = FuzzProgram(seed, cfg,
                     tuple((n, tuple(nds)) for n, nds in groups),
                     shrunk=True)
    return fp, pins


def save_repro(fp: FuzzProgram, report: ReplayReport,
               corpus_dir) -> pathlib.Path:
    """Write a shrunken repro to ``corpus_dir`` (named by fingerprint)."""
    corpus_dir = pathlib.Path(corpus_dir)
    corpus_dir.mkdir(parents=True, exist_ok=True)
    path = corpus_dir / f"fuzz_{fp.program.fingerprint()}.txt"
    mm = "; ".join(f"{m.variant}/{m.field}: {m.detail}"
                   for m in report.mismatches) or "captured-without-mismatch"
    header = {
        "mismatch": mm,
        "replay": f"PYTHONPATH=src python benchmarks/fuzz_run.py "
                  f"--replay {path}",
        "reseed": f"PYTHONPATH=src python benchmarks/fuzz_run.py "
                  f"--seed {fp.seed} --budget 1",
    }
    path.write_text(program_to_text(fp, header))
    return path


def load_corpus(path) -> Tuple[FuzzProgram, Dict[str, int]]:
    """Load one corpus file back into a replayable FuzzProgram."""
    return program_from_text(pathlib.Path(path).read_text())


# ---------------------------------------------------------------------------
# Budgeted campaign (the CI entry point; CLI in benchmarks/)
# ---------------------------------------------------------------------------
def run_budget(budget: int, seed: int = 0,
               cfg: FuzzConfig = FuzzConfig(),
               variants: Sequence[str] = VARIANTS,
               mutate: Optional[Callable] = None,
               corpus_dir=None,
               do_shrink: bool = True,
               max_minutes: Optional[float] = None,
               clear_cache_every: int = 40,
               log: Optional[Callable[[str], None]] = None,
               device=None) -> dict:
    """Fuzz ``budget`` seeds (``seed..seed+budget-1``); stop on mismatch.

    On the first mismatch the repro is shrunk against the cheapest
    failing variant and written to ``corpus_dir`` (when given).  Returns
    a stats dict: ``{"programs", "ops", "mismatch": report|None,
    "repro_path", "shrunk_ops", "seq_histogram", "seconds"}``.
    ``max_minutes`` bounds soak-style runs by wall clock instead of
    budget.  The engine compile cache is cleared every
    ``clear_cache_every`` programs -- fuzzing sweeps distinct programs,
    so the cache only pins dead executables.  Every replay runs on
    ``device`` (``None``: the GPU).
    """
    device = engine.resolve_device(device)
    t0 = time.time()
    log = log or (lambda s: None)
    stats = {"programs": 0, "ops": 0, "mismatch": None, "repro_path": None,
             "shrunk_ops": None, "seq_histogram": {}, "seconds": 0.0,
             "last_seed": None}
    for i in range(budget):
        if max_minutes is not None and (time.time() - t0) / 60 > max_minutes:
            log(f"fuzz: wall-clock budget {max_minutes} min reached")
            break
        s = seed + i
        fp = gen_program(s, cfg)
        report = replay(fp, variants=variants, mutate=mutate, device=device)
        stats["programs"] += 1
        stats["ops"] += report.cycles
        stats["last_seed"] = s
        for name, _ in fp.groups:
            stats["seq_histogram"][name] = \
                stats["seq_histogram"].get(name, 0) + 1
        if stats["programs"] % 20 == 0:
            log(f"fuzz: {stats['programs']} programs clean "
                f"({stats['ops']} micro-ops replayed, "
                f"{time.time() - t0:.0f}s)")
        if clear_cache_every and stats["programs"] % clear_cache_every == 0:
            engine.clear_compile_cache()
        if not report.ok:
            log(f"fuzz: MISMATCH at seed {s}: " + "; ".join(
                f"{m.variant}/{m.field}" for m in report.mismatches))
            min_fp = fp
            if do_shrink:
                bad_variants = [m.variant for m in report.mismatches
                                if m.variant in VARIANTS]
                probe = tuple(bad_variants[:1]) or tuple(variants)

                def fails(cand):
                    return not replay(cand, variants=probe,
                                      mutate=mutate, device=device).ok

                min_fp = shrink(fp, fails)
                log(f"fuzz: shrunk {len(fp.program.expand())} -> "
                    f"{len(min_fp.program.expand())} micro-ops")
            final = replay(min_fp, variants=variants, mutate=mutate,
                           device=device)
            stats["mismatch"] = final if not final.ok else report
            stats["shrunk_ops"] = len(min_fp.program.expand())
            if corpus_dir is not None:
                stats["repro_path"] = str(save_repro(
                    min_fp, stats["mismatch"], corpus_dir))
            break
    stats["seconds"] = time.time() - t0
    return stats
