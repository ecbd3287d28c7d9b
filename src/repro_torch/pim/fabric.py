"""Fabric scheduler: tile GEMMs across a Compute RAM block grid.

The paper's fabric-level claim (§IV, §V): an FPGA carries hundreds of
Compute RAM sites, each *dynamically* allocated to storage mode (a plain
BRAM holding operands) or compute mode (executing an instruction
sequence), and a DL workload is tiled across the grid.  This module is
that layer for the simulator: it turns "one block runs one program"
(:mod:`repro.pim.cram`) into "a simulated FPGA runs a matmul" -- and,
since the :class:`FabricProgram` refactor, "a simulated FPGA runs a
*decode step*": several GEMMs sharing activations fused into one grid
allocation.

Pipeline
--------
1. :func:`schedule_program` builds an explicit :class:`FabricProgram`
   IR for one or more GEMMs that share their activation operand (the
   fused-QKV case; :func:`schedule_gemm` is the single-GEMM wrapper):

   * **mode map + placement** -- each of the grid's ``n_blocks`` blocks
     sits at a ``(row, col)`` site (:meth:`FabricConfig.site`) and is
     assigned ``storage`` (operand residency) or ``compute`` mode
     (paper §II dual-mode allocation).  ``FabricConfig.placement``
     decides *where* the storage blocks go: ``contiguous`` packs them
     at one grid corner, ``interleaved`` spreads them among the compute
     blocks (shorter operand hops).  Storage demand is sized from the
     operand footprint; whatever does not fit on-fabric is marked
     *spilled* (off-fabric memory, longer wires).
   * **tiling** -- K is tiled to the ``idot`` tuple capacity of the
     block geometry (:func:`repro.pim.cram.idot_geometry`, clamped so
     the int32 accumulator provably cannot overflow), each GEMM's N to
     the block's columns, and each output row ``m`` is one tile task.
     Ragged edge tiles are zero-padded to the fixed tile geometry so
     **every round replays one compiled program** across every fused
     GEMM.
   * **rounds** -- tile tasks are packed ``n_compute`` at a time into
     :class:`Round`\\ s; one round is one ``engine.execute_blocks``
     launch.  Blocks without a task in a partial round are *not
     started* (each block has its own start line from the host FSM, so
     idle blocks burn no compute energy); the simulator still steps
     them on zeros purely as a wide-batch convenience, and their
     results are discarded.
   * **residency-aware loads** -- each round carries an explicit
     operand-load stage (:class:`TileLoad`).  Loads are *cache fills*
     against a per-compute-block resident-tile map: a tile fetched for
     round *i* stays pinned in its block for later rounds that reuse
     it, so repeated weight tiles are fetched ONCE instead of once per
     round (LRU eviction when the block's bits run out).  Within one
     round, every block needing a tile that is not already resident
     joins one multi-destination broadcast fetch.  Tasks are assigned
     to blocks residency-first (a task prefers a block that already
     holds its weight tile, then its activation slice), which is what
     converts cross-round reuse in the IR into actual fetch savings.

2. :func:`execute_program` runs the rounds **exactly** on the block
   simulator and accumulates per-tile accumulators into each GEMM's
   output.  By default all rounds are *batched* into one compiled
   wide-block launch (rounds become extra block-columns) -- the
   simulator-side wall-clock fast path, bit-identical to the per-round
   loop.

3. :func:`schedule_cost` walks the same IR and prices it with
   :mod:`repro.core.costmodel`: compute-mode cycles, storage-mode row
   traffic, and **hop-priced** wire energy -- every load/broadcast/
   drain is billed by the Manhattan distance between the actual block
   sites involved (``costmodel.hop_net_length_mm``), not one average
   fabric net length, so the cost model finally *sees* both residency
   (fewer fetches) and placement (shorter fetches), the paper's
   headline data-movement savings.

4. :func:`search_program` / :func:`search_schedule` autotune: they
   enumerate ``FabricConfig`` geometries x storage/compute splits x
   placements, price every candidate through the same roll-up (no
   execution), deduplicate geometry-equivalent candidates, and return
   the argmin program -- wired into ``PimConfig(mode="fabric",
   fabric_autotune=True)`` and the serving fabric probe.

Signed operands use the same zero-point offset algebra as
:func:`repro.pim.cram.cram_matmul` (the blocks are unsigned-only
hardware); corrections are host-side sums.

The counterpart of ``repro.pim.fabric``.  Scheduling, residency,
repair, costing and search are numpy and the reference's own code.  Only
the execute side differs: each round launch builds its block states on
the ``device`` the caller names (``None``: the GPU) and runs the port's
``engine.execute_blocks`` there, so every packed int round folds through
the ``lane_fold`` kernel on the card.  An integer class's operands go to
the device once a call and each launch's block images are packed there
(:func:`pack_blocks_device`, the ``fabric_pack`` kernel), so only the
accumulator rows come back; float classes, whose K-stages chain a host
accumulator image, and launches under a fault model, whose seeded flips
hit the host image, pack on the host as the reference does
(:func:`pack_blocks`, uint64 numpy: torch has no uint64 arithmetic).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch import trace
from repro_torch.core import costmodel, engine, floatprog, programs, ref
from repro_torch.core import faults as faults_core
from repro_torch.kernels import fabric_pack as fpk
from repro_torch.pim import cram

FabricFaultError = faults_core.FabricFaultError

ACC_BITS = 32

#: Storage-block placement strategies (the autotuner sweeps these).
PLACEMENT_CHOICES: Tuple[str, ...] = ("contiguous", "interleaved")


def _dtype_info(name) -> cram.DType:
    """Resolve a dtype spec, synthesizing intN widths not in DTYPES."""
    if name is None:
        raise ValueError("dtype name must be resolved before lookup")
    if isinstance(name, cram.DType):
        return name
    if isinstance(name, str) and name.startswith("int") \
            and name not in cram.DTYPES:
        return cram.DType(name, "int", int(name[3:]))
    return cram.resolve_dtype(name)


def _wide_drain_bits(info: cram.DType) -> int:
    """Rows a float task drains: the wide accumulator image (chaining
    means the *wide* value leaves the block, not just the rounded fmt
    result)."""
    return floatprog.wide_format(info.fmt).width


# ---------------------------------------------------------------------------
# Config + IR
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """A grid of Compute RAM blocks (one simulated FPGA).

    Blocks are laid out row-major on a near-square ``grid_rows x
    grid_cols`` grid of sites; the host/IO interface sits just off site
    ``(0, 0)``, so :meth:`edge_hops` is the Manhattan distance a spill
    fetch or an accumulator drain crosses.  ``placement`` picks where
    storage-mode blocks sit (``contiguous`` corner vs ``interleaved``
    among the compute blocks); ``residency`` enables the cross-round
    resident-tile map (off = the reload-every-round load stage, kept
    for differential tests and as the pricing baseline).
    """
    n_blocks: int = 8
    rows: int = 512
    cols: int = 40
    executor: str = "compiled"
    min_compute_blocks: int = 1    # never storage-starve the grid
    placement: str = "contiguous"  # where storage blocks sit on the grid
    residency: bool = True         # cross-round resident-tile map
    # blocks held in reserve for fault repair: the LAST ``spare_blocks``
    # grid sites are never assigned storage or compute mode by the
    # scheduler; ``repair_program`` remaps a dead block onto the nearest
    # live spare (docs/faults.md).  0 = the pre-fault grid, bit-exact.
    spare_blocks: int = 0

    @property
    def block_bits(self) -> int:
        return self.rows * self.cols

    @property
    def grid_cols(self) -> int:
        return int(math.ceil(math.sqrt(self.n_blocks)))

    @property
    def grid_rows(self) -> int:
        return int(math.ceil(self.n_blocks / self.grid_cols))

    @property
    def grid_diameter(self) -> int:
        """Manhattan distance between the two farthest sites."""
        return (self.grid_rows - 1) + (self.grid_cols - 1)

    def site(self, block: int) -> Tuple[int, int]:
        """(row, col) site of one block on the grid."""
        return block // self.grid_cols, block % self.grid_cols

    def hops(self, a: int, b: int) -> int:
        """Manhattan hop distance between two blocks' sites."""
        (ra, ca), (rb, cb) = self.site(a), self.site(b)
        return abs(ra - rb) + abs(ca - cb)

    def edge_hops(self, block: int) -> int:
        """Hops from a block to the host/IO interface (just off (0,0))."""
        r, c = self.site(block)
        return r + c + 1

    @property
    def spare_ids(self) -> Tuple[int, ...]:
        """Grid sites reserved as repair spares (the last N blocks)."""
        return tuple(range(self.n_blocks - self.spare_blocks,
                           self.n_blocks))

    @property
    def usable_blocks(self) -> int:
        """Blocks the scheduler may assign (grid minus spares)."""
        return self.n_blocks - self.spare_blocks

    def __post_init__(self):
        if self.n_blocks < 1:
            raise ValueError("fabric needs at least one block")
        if self.spare_blocks < 0:
            raise ValueError("spare_blocks must be >= 0")
        if not 1 <= self.min_compute_blocks <= self.n_blocks - \
                self.spare_blocks:
            raise ValueError("min_compute_blocks out of range (grid minus "
                             "spares must still fit the compute floor)")
        if self.placement not in PLACEMENT_CHOICES:
            raise ValueError(f"placement {self.placement!r} not in "
                             f"{PLACEMENT_CHOICES}")


@dataclasses.dataclass(frozen=True)
class GemmSpec:
    """One GEMM of a fabric program: ``(M, K) @ (K, N)``.

    Fused GEMMs of one :class:`FabricProgram` share ``M``/``K`` (and the
    activation operand); ``N`` is per GEMM (the QKV projections).

    ``dtype`` picks the GEMM's element type (a ``repro.pim.cram.DTYPES``
    key, or anything :func:`repro.pim.cram.resolve_dtype` accepts, e.g.
    ``jnp.bfloat16``); ``None`` defaults to the program-level
    ``int{nbits}``.  Fused GEMMs may mix dtypes -- int4/int8/bf16
    coexisting in ONE program (asymmetric per-GEMM precision): each
    dtype class gets its own tile geometry, instruction sequence, and
    activation encoding, while sharing the grid allocation and the
    residency machinery.

    ``kv`` names a :class:`FabricSession` KV cache that backs this
    GEMM's weight operand -- the new ``kv`` tile class of the Schedule
    IR.  KV tiles are session-pinned (never LRU-evicted within the
    sequence window), live at the cache's reserved home block, and load
    *append-addressed*: a compute block that already holds an earlier
    prefix of a growing tile fetches only the delta bits
    (:meth:`FabricSession.kv_append` grows the cache between programs).
    ``kv_axis`` records which GEMM dimension the appended positions tile
    along -- ``"n"`` for the K^T scores operand (``(hd, t)``), ``"k"``
    for the V operand (``(t, hd)``); the scheduler's growing-tile delta
    machinery covers both, the axis is a declaration checked at
    schedule time.
    """
    name: str
    M: int
    K: int
    N: int
    dtype: Optional[str] = None
    kv: Optional[str] = None
    kv_axis: str = "n"


@dataclasses.dataclass(frozen=True)
class TileTask:
    """One (gemm, output-row, K-tile, N-tile) unit of work on one block."""
    block: int                 # compute block executing this tile
    m: int                     # output row
    k0: int
    k1: int
    n0: int
    n1: int
    x_src: int                 # storage block holding x[m, :] (-1 = spill)
    w_src: int                 # storage block holding w tile (-1 = spill)
    gemm: int = 0              # index into FabricProgram.gemms


@dataclasses.dataclass(frozen=True)
class TileLoad:
    """One operand *cache fill* that must retire before its round's compute.

    The load stage is explicit in the IR so the cost model can price
    round *i+1*'s loads as double-buffered against round *i*'s compute
    (``ScheduleCost.overlapped_cycles``).  ``dsts`` lists only the
    compute blocks where the tile is NOT already resident: blocks that
    fetched it in an earlier round (and have not evicted it) are served
    from their resident-tile map and appear in no load at all.  Several
    missing destinations coalesce into ONE multi-destination broadcast
    net, priced once in the wire-energy split by the Manhattan span of
    the sites it touches.
    """
    kind: str                  # "x" (activation slice) | "w" (weight tile)
    key: Tuple[int, ...]       # ("x": (m, k0)) | ("w": (gemm, k0, n0))
    src: int                   # storage block holding the payload (-1 = spill)
    dsts: Tuple[int, ...]      # destination compute blocks (broadcast if >1)
    bits: int                  # payload bits of ONE copy


@dataclasses.dataclass(frozen=True)
class Round:
    """One lockstep ``execute_blocks`` launch over the compute blocks.

    ``loads`` is the round's operand-load stage: every tile a task reads
    is either covered by a load of the same round or already resident in
    the task's block from an earlier fetch (the cache-fill semantics the
    overlap model pipelines and ``residency_stats`` audits).
    """
    tasks: Tuple[TileTask, ...]
    loads: Tuple[TileLoad, ...] = ()
    # element-type class of every task in this round (a round is ONE
    # lockstep program launch, so it can never mix dtypes); None means
    # the program's default int class (single-dtype legacy programs).
    dtype: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class FabricProgram:
    """Explicit fabric schedule for one or more fused quantized GEMMs.

    The multi-GEMM, residency-aware successor of the single-GEMM
    ``Schedule`` IR (which remains as an alias): every fused GEMM shares
    the activation operand and the grid allocation, and all rounds
    replay ONE compiled idot program.  Single-GEMM programs keep the
    legacy accessors (``M``/``K``/``N``).
    """
    cfg: FabricConfig
    nbits: int
    signed: bool
    gemms: Tuple[GemmSpec, ...]
    kt: int                              # K-tile of gemm 0 (legacy accessor)
    modes: Tuple[str, ...]               # per block: "compute" | "storage"
    x_home: Tuple[int, ...]              # per output row m -> block | -1
    #                                      (primary dtype class's copy)
    w_home: Dict[Tuple[int, int, int], int]  # (gemm, k-tile, n-tile) -> block
    rounds: Tuple[Round, ...]
    # per-GEMM resolved dtype names + K-tiles (empty tuples on programs
    # built before the dtype refactor -> int{nbits} / kt fallbacks)
    dtypes: Tuple[str, ...] = ()
    kts: Tuple[int, ...] = ()
    # non-primary dtype classes' activation homes: (dtype, m) -> block
    x_home_ext: Dict[Tuple[str, int], int] = \
        dataclasses.field(default_factory=dict)

    @property
    def M(self) -> int:
        return self.gemms[0].M           # shared across fused GEMMs

    @property
    def K(self) -> int:
        return self.gemms[0].K           # shared across fused GEMMs

    # -- dtype plumbing -----------------------------------------------------
    def dtype_of(self, g: int) -> str:
        return self.dtypes[g] if self.dtypes else f"int{self.nbits}"

    def kt_of(self, g: int) -> int:
        return self.kts[g] if self.kts else self.kt

    def infos(self) -> Tuple[cram.DType, ...]:
        """Resolved :class:`repro.pim.cram.DType` per fused GEMM."""
        return tuple(_dtype_info(self.dtype_of(g))
                     for g in range(len(self.gemms)))

    @property
    def classes(self) -> Tuple[str, ...]:
        """Distinct dtype classes, in first-appearance order."""
        return tuple(dict.fromkeys(self.dtype_of(g)
                                   for g in range(len(self.gemms))))

    @property
    def multi(self) -> bool:
        """Mixed-precision program (>= 2 dtype classes)?"""
        return len(self.classes) > 1

    def class_kt(self, name: str) -> int:
        for g in range(len(self.gemms)):
            if self.dtype_of(g) == name:
                return self.kt_of(g)
        raise KeyError(name)

    def class_program(self, name: str):
        """(program, layout) every round of dtype class ``name`` replays."""
        info = _dtype_info(name)
        if info.is_float:
            return floatprog.float_dot(info.fmt, rows=self.cfg.rows,
                                       tuples=self.class_kt(name))
        return programs.idot(info.bits, rows=self.cfg.rows,
                             tuples=self.class_kt(name))

    @property
    def N(self) -> int:
        if len(self.gemms) != 1:
            raise ValueError(
                f"N is ambiguous for a {len(self.gemms)}-GEMM program; "
                f"use .gemms")
        return self.gemms[0].N

    @property
    def n_compute(self) -> int:
        return self.modes.count("compute")

    @property
    def n_storage(self) -> int:
        return self.modes.count("storage")

    @property
    def compute_blocks(self) -> Tuple[int, ...]:
        return tuple(b for b, m in enumerate(self.modes) if m == "compute")

    @property
    def program(self):
        """The program the primary dtype class's rounds replay."""
        prog, _ = self.class_program(self.dtype_of(0))
        return prog

    @property
    def ops(self) -> int:
        """Useful MACs (zero-padding excluded), across all fused GEMMs."""
        return sum((t.k1 - t.k0) * (t.n1 - t.n0)
                   for r in self.rounds for t in r.tasks)

    def describe(self) -> str:
        cfg = self.cfg
        sig = "s" if self.signed else "u"
        shapes = " + ".join(
            f"{g.name}[{self.dtype_of(i)}]:{g.M}x{g.K}@{g.K}x{g.N}"
            for i, g in enumerate(self.gemms))
        prec = "+".join(self.classes) if self.dtypes \
            else f"int{self.nbits}"
        kts = ", ".join(f"{c}:{self.class_kt(c)}" for c in self.classes) \
            if self.multi else str(self.kt)
        lines = [
            f"FabricProgram [{shapes}] {prec}{sig} on "
            f"{cfg.n_blocks} blocks "
            f"({cfg.grid_rows}x{cfg.grid_cols} grid, "
            f"{self.n_compute} compute / {self.n_storage} storage, "
            f"{cfg.placement})",
            f"  K-tile={kts} tuples, N-tile={cfg.cols} cols, "
            f"{len(self.rounds)} round(s), "
            f"{sum(len(r.tasks) for r in self.rounds)} tile task(s)",
        ]
        if cfg.residency:
            st = residency_stats(self)
            lines.append(
                f"  residency: {st['fetches']} fetch(es) for "
                f"{st['reads']} tile read(s) "
                f"(hit rate {st['hit_rate']:.0%}, "
                f"{st['fetch_reduction']:.2f}x fewer than reload)")
        spares = self.modes.count("spare")
        dead = self.modes.count("dead")
        if spares or dead:
            lines.append(f"  {spares} spare block(s) in reserve"
                         + (f", {dead} dead block(s) remapped" if dead
                            else ""))
        spills = sum(1 for t_ in self.w_home.values() if t_ < 0) \
            + sum(1 for t_ in self.x_home if t_ < 0) \
            + sum(1 for t_ in self.x_home_ext.values() if t_ < 0)
        if spills:
            lines.append(f"  {spills} operand(s) spilled off-fabric")
        return "\n".join(lines)


#: Alias: the single-GEMM IR's earlier name ``Schedule``.
Schedule = FabricProgram


# ---------------------------------------------------------------------------
# Persistent sessions: residency across programs (weight-stationary decode)
# ---------------------------------------------------------------------------
class FabricSession:
    """Grid state that persists across sequential fabric programs.

    Every :func:`schedule_program` call normally starts from a cold
    resident-tile map, so a weight-stationary serve loop refetches every
    weight tile on every decode step.  A session owns the state that
    should outlive one program:

    * the **mode map** (storage/compute allocation), pinned by the
      session's first program so later programs schedule onto the same
      grid split;
    * the per-compute-block **resident-tile maps**, keyed *globally*
      (weight tiles by ``(gemm name, dtype, k0, n0)``), so a tile
      fetched in decode step 1 emits **no load** in steps 2..N -- the
      caller contract is that a stable GEMM name means a stationary
      weight (a renamed or mutated weight only mis-models cost, never
      correctness: execution always packs the actual operands passed);
    * the storage blocks' **free space + operand homes**, so a warm tile
      is also not re-placed (activations are per-program: their homes
      recycle and their resident entries drop at each program boundary
      -- a decode step's activations are new payloads every step);
    * **KV caches** (:meth:`reserve_kv` / :meth:`kv_append`): reserved
      storage-block regions that grow in place, the on-fabric KV cache
      (see :class:`GemmSpec.kv`);
    * a per-decode-step **cost/fetch trajectory**
      (:meth:`begin_step` / :meth:`trajectory`) -- the cold step-1 vs
      steady-state split in :class:`repro.core.costmodel.CostTrajectory`.

    Lifecycle: create -> warm (schedule/execute programs through it) ->
    invalidated on fault repair (:meth:`invalidate_blocks` /
    :meth:`apply_remap`, wired into ``execute_program`` scrubs and
    :func:`repair_program`) -> :meth:`reset` back to cold.

    Residency remains an IR/cost-model concept: :func:`execute_program`
    re-packs every operand host-side each launch, so outputs are
    bit-identical with or without a session -- the session changes what
    the schedule *charges for moving*, never what the blocks compute.
    Not thread-safe; one session serves one sequential serve loop.
    """

    def __init__(self, cfg: Optional[FabricConfig] = None):
        self._cfg0 = cfg
        self.reset()

    # NOTE: no __eq__/__hash__ overrides -- identity hashing keeps a
    # session embeddable in frozen configs (repro.pim.linear.PimConfig).

    def reset(self) -> None:
        """Back to cold: drop residency, homes, KV caches, trajectory."""
        self.cfg: Optional[FabricConfig] = self._cfg0
        self.modes: Optional[Tuple[str, ...]] = None
        self.storage_free: Dict[int, int] = {}
        self.resident: Dict[int, dict] = {}    # block -> {key: [bits, last]}
        self.w_homes: Dict[tuple, int] = {}    # global weight key -> block
        self.clock = 0                         # global LRU round counter
        self.epoch = 0                         # program counter (x scoping)
        self.programs = 0
        self.kv: Dict[str, dict] = {}
        self.steps: List[dict] = []
        self._x_alloc: List[Tuple[int, int]] = []

    # -- grid binding (internal: schedule_program) --------------------------
    def _bind(self, cfg: FabricConfig) -> None:
        if self.cfg is not None and self.cfg != cfg:
            if self.programs == 0 and self.modes is None:
                self.cfg = cfg        # cold: adopt (e.g. an autotuned split)
                return
            raise ValueError(
                f"session is bound to grid {self.cfg}; got {cfg} -- "
                f"reset() before switching grids")
        self.cfg = cfg

    def _begin_program(self) -> None:
        """Per-program state turnover: activations never warm across
        programs (a decode step's activations are new payloads), so
        their storage allocations recycle and their resident entries
        drop; weights and KV tiles persist."""
        self.epoch += 1
        self.programs += 1
        for b, bits in self._x_alloc:
            if b >= 0:
                self.storage_free[b] = self.storage_free.get(b, 0) + bits
        self._x_alloc = []
        for res in self.resident.values():
            for kk in [k for k in res if k[0] == "x"]:
                del res[kk]
        self._step()["programs"] += 1

    # -- decode-step trajectory ----------------------------------------------
    def begin_step(self) -> dict:
        """Open a new per-decode-step accounting bucket."""
        self.steps.append({"programs": 0, "fetches": 0, "fetch_bits": 0.0,
                           "w_fetches": 0, "kv_fetch_bits": 0.0,
                           "kv_appends": 0, "kv_append_bits": 0,
                           "costs": []})
        return self.steps[-1]

    def _step(self) -> dict:
        return self.steps[-1] if self.steps else self.begin_step()

    def record_cost(self, cost: costmodel.ScheduleCost) -> None:
        self._step()["costs"].append(cost)

    def trajectory(self) -> costmodel.CostTrajectory:
        """The session's per-step cost/fetch trajectory so far."""
        costs = tuple(combine_costs("fabric/session_step", s["costs"])
                      if s["costs"] else None for s in self.steps)
        return costmodel.CostTrajectory(
            name="fabric/session",
            costs=costs,
            fetches=tuple(s["fetches"] for s in self.steps),
            fetch_bits=tuple(s["fetch_bits"] for s in self.steps),
            w_fetches=tuple(s["w_fetches"] for s in self.steps),
            kv_fetch_bits=tuple(s["kv_fetch_bits"] for s in self.steps))

    def stats(self) -> dict:
        rep = {
            "programs": self.programs,
            "steps": len(self.steps),
            "resident_tiles": sum(len(r) for r in self.resident.values()),
            "resident_bits": sum(bits for r in self.resident.values()
                                 for bits, _ in r.values()),
            "kv": {k: {"len": m["len"], "window": m["window"],
                       "home": m["home"]} for k, m in self.kv.items()},
        }
        if self.steps:
            rep["trajectory"] = self.trajectory().report()
        return rep

    # -- on-fabric KV caches -------------------------------------------------
    def reserve_kv(self, kv_id: str, pos_bits: int, window: int) -> None:
        """Reserve a growing KV cache of up to ``window`` positions of
        ``pos_bits`` bits each.  Must happen before the session's first
        program: reservations join the storage-demand sizing and are
        placed FIRST (before any weight tile), so the cache lives
        on-fabric whenever it fits one storage block."""
        if self.modes is not None:
            raise ValueError(
                "reserve_kv after the session's first program: the mode "
                "map is pinned; reset() to re-plan")
        if kv_id in self.kv:
            raise ValueError(f"KV cache {kv_id!r} already reserved")
        if pos_bits < 1 or window < 1:
            raise ValueError(f"degenerate KV reservation {kv_id!r}: "
                             f"{window} x {pos_bits} bits")
        self.kv[kv_id] = {"pos_bits": int(pos_bits), "window": int(window),
                          "len": 0, "home": None}

    def kv_len(self, kv_id: str) -> int:
        return self.kv[kv_id]["len"]

    def kv_append(self, kv_id: str, n_new: int = 1) -> None:
        """Append ``n_new`` positions to a KV cache (the decode step's
        new K/V row): the cache grows *in place* at its home block --
        history already on the grid is never refetched.  Charges the
        append write to the current step's trajectory."""
        meta = self.kv[kv_id]
        if meta["home"] is None:
            raise ValueError(
                f"KV cache {kv_id!r} not placed yet: run the session's "
                f"first program before appending")
        if meta["len"] + n_new > meta["window"]:
            raise ValueError(
                f"KV cache {kv_id!r} overflows its window: "
                f"{meta['len']} + {n_new} > {meta['window']}")
        meta["len"] += n_new
        bits = n_new * meta["pos_bits"]
        step = self._step()
        step["kv_appends"] += n_new
        step["kv_append_bits"] += bits
        cfg = self.cfg
        if cfg is not None:
            home = meta["home"]
            step["costs"].append(costmodel.kv_append_cost(
                f"fabric/kv_append/{kv_id}", n_blocks=cfg.n_blocks,
                cols=cfg.cols, bits=bits,
                edge_hops=(cfg.edge_hops(home) if home >= 0
                           else cfg.grid_diameter),
                spilled=home < 0))

    # -- fault hooks -----------------------------------------------------------
    def invalidate_blocks(self, blocks) -> None:
        """Drop every resident-tile entry of the given grid blocks.

        Called when a scrub restores a block from its pristine image
        (:func:`execute_program`'s fault path): the pristine refetch
        restores only *that launch's* packed operands, so any other
        tile the block's resident map claims to hold can no longer be
        trusted -- a stale map after repair would be silent wrong
        reuse in the cost model.  The next program refetches."""
        for b in blocks:
            if b in self.resident:
                self.resident[b].clear()

    def apply_remap(self, mapping: Dict[int, int]) -> None:
        """Mirror a :func:`repair_program` spare remap into the session.

        A dead compute block's resident map is DROPPED (the spare
        starts cold -- it holds nothing yet, silent reuse would be
        wrong); a dead storage block's homes and free space move to its
        spare, and every home pointer is rewritten."""
        if self.modes is None or not mapping:
            return
        modes = list(self.modes)
        for b, s in mapping.items():
            modes[s] = modes[b]
            modes[b] = "dead"
            if b in self.resident:
                self.resident.pop(b)
                self.resident[s] = {}
            if b in self.storage_free:
                self.storage_free[s] = self.storage_free.pop(b)
        self.modes = tuple(modes)

        def remap(v: int) -> int:
            return mapping.get(v, v) if v >= 0 else v

        self.w_homes = {k: remap(v) for k, v in self.w_homes.items()}
        self._x_alloc = [(remap(b), bits) for b, bits in self._x_alloc]
        for meta in self.kv.values():
            if meta["home"] is not None:
                meta["home"] = remap(meta["home"])


# ---------------------------------------------------------------------------
# Scheduling
# ---------------------------------------------------------------------------
def _task_operands(t: TileTask, gemms: Sequence[GemmSpec],
                   infos: Sequence[cram.DType], multi: bool):
    """The (kind, key, src, bits) operand reads of one tile task.

    Activation slices are keyed ``(m, k0)`` -- shared across fused GEMMs
    (all of them read the same activations); weight tiles are keyed
    ``(gemm, k0, n0)``.  The K-slice matters: two tasks reading
    different K-ranges of one row fetch different payloads.  In a
    mixed-precision program every dtype class stores its *own encoding*
    of the activations (a quantized int8 row and a bf16 row are
    different payloads even for the same ``(m, k0)``), so activation
    keys grow a leading dtype component: ``(dtype, m, k0)``.

    A GEMM backed by a session KV cache (``GemmSpec.kv``) reads its
    weight-side operand as a ``kv`` tile instead, keyed
    ``(kv_id, k0, n0)`` -- the key is already program-independent, so a
    session can track the growing tile across decode steps.
    """
    info = infos[t.gemm]
    kw = t.k1 - t.k0
    xkey = (info.name, t.m, t.k0) if multi else (t.m, t.k0)
    yield "x", xkey, t.x_src, kw * info.bits
    wbits = kw * (t.n1 - t.n0) * info.bits
    kv = getattr(gemms[t.gemm], "kv", None)
    if kv:
        yield "kv", (kv, t.k0, t.n0), t.w_src, wbits
    else:
        yield "w", (t.gemm, t.k0, t.n0), t.w_src, wbits


def _storage_block_ids(n_blocks: int, n_storage: int,
                       placement: str) -> Tuple[int, ...]:
    """Which grid sites hold operands (the placement dimension)."""
    if placement == "interleaved" and n_storage > 0:
        return tuple(int(i * n_blocks / n_storage) for i in range(n_storage))
    return tuple(range(n_storage))


def _assign_slots(chunk, compute_blocks, resident, x_keys, w_keys):
    """Residency-affinity task placement within one round.

    Each unit prefers a free compute block that already holds its weight
    tile (the big payload), then one holding its activation slice;
    leftovers fill the remaining blocks in grid order.  Deterministic:
    units are visited in schedule order.
    """
    free = list(compute_blocks)
    assign = {}
    deferred = []
    for u in chunk:
        b = next((b for b in free if w_keys[u] in resident[b]), None)
        if b is None:
            b = next((b for b in free if x_keys[u] in resident[b]), None)
        if b is None:
            deferred.append(u)
        else:
            assign[u] = b
            free.remove(b)
    for u in deferred:
        assign[u] = free.pop(0)
    return assign


def _evict_lru(res: dict, capacity: int, pinned: set):
    """Evict least-recently-used resident tiles until under capacity.

    Tiles read by the current round (``pinned``) are never evicted, and
    neither are ``kv`` tiles -- the session's KV cache is pinned for the
    whole sequence window (evicting appended history would turn every
    later decode step's delta load back into a full refetch); the
    idot layout guarantees one x slice + one w tile always fit a block.
    """
    while sum(bits for bits, _ in res.values()) > capacity:
        victims = [(last, kk) for kk, (_, last) in res.items()
                   if kk not in pinned and kk[0] != "kv"]
        if not victims:
            break
        res.pop(min(victims)[1])


def schedule_program(specs: Sequence[GemmSpec], nbits: int,
                     cfg: FabricConfig = FabricConfig(),
                     signed: bool = False,
                     session: Optional[FabricSession] = None
                     ) -> FabricProgram:
    """Plan one or more activation-sharing GEMMs onto the block grid.

    All specs must share ``M`` and ``K`` (they read the same activation
    operand -- the fused-QKV contract); each spec brings its own ``N``
    and weight matrix.  No execution happens here; the returned
    :class:`FabricProgram` feeds :func:`execute_program`,
    :func:`schedule_cost`, and the search.

    With a :class:`FabricSession`, the plan is made against the
    session's *warm* state: the mode map is pinned by the session's
    first program, weight tiles already resident in a compute block emit
    no load (keyed globally by GEMM name + dtype + tile coordinates, so
    the reuse carries across programs), weight homes persist, and
    ``GemmSpec.kv`` GEMMs read their weight operand from the session's
    reserved KV cache with append-addressed delta loads.  A *cold*
    session (no KV reservations) plans the first program identically to
    the sessionless path.  Scheduling through a session mutates it (the
    plan IS the intent to run) -- never pass a live session to a search.
    """
    specs = tuple(specs)
    if not specs:
        raise ValueError("fabric program needs at least one GEMM")
    M, K = specs[0].M, specs[0].K
    for g in specs:
        if min(g.M, g.K, g.N) < 1:
            raise ValueError(f"degenerate GEMM {g.name}: {g.M}x{g.K}x{g.N}")
        if (g.M, g.K) != (M, K):
            raise ValueError(
                f"fused GEMMs must share activations: {g.name} is "
                f"{g.M}x{g.K}, expected {M}x{K}")
        if g.kv_axis not in ("n", "k"):
            raise ValueError(f"GEMM {g.name}: kv_axis {g.kv_axis!r} "
                             f"not in ('n', 'k')")
        if g.kv and session is not None and g.kv not in session.kv:
            raise ValueError(f"GEMM {g.name}: KV cache {g.kv!r} not "
                             f"reserved on the session (reserve_kv first)")
    if session is not None:
        session._bind(cfg)
        session._begin_program()

    # --- resolve per-GEMM dtypes + per-class K-tiles -----------------------
    infos = tuple(cram.resolve_dtype(g.dtype) or _dtype_info(f"int{nbits}")
                  for g in specs)
    class_kt: Dict[str, int] = {}
    for info in infos:
        if info.name in class_kt:
            continue
        # the dtype-aware infeasible-geometry guard: idot_tile /
        # float_dot would otherwise clamp or fail much later with an
        # opaque layout error -- fail at schedule time with the
        # geometry named, for ints and floats alike
        if info.is_float:
            kt_c = cram.fdot_geometry(info.fmt, cfg.rows)
            if kt_c < 1:
                raise ValueError(
                    f"geometry {cfg.rows}x{cfg.cols} cannot host a "
                    f"float_dot[{info.name}] program (too few rows)")
        else:
            if cram.idot_geometry(info.bits, cfg.rows, ACC_BITS) < 1:
                raise ValueError(
                    f"geometry {cfg.rows}x{cfg.cols} cannot host an "
                    f"idot{info.bits} program (too few rows)")
            kt_c = cram.idot_tile(info.bits, cfg.rows, ACC_BITS)
        class_kt[info.name] = kt_c
    kts = tuple(class_kt[i.name] for i in infos)
    classes = tuple(dict.fromkeys(i.name for i in infos))
    by_class = {c: [g for g in range(len(specs)) if infos[g].name == c]
                for c in classes}
    multi = len(classes) > 1
    k_tiles = [math.ceil(K / kts[g]) for g in range(len(specs))]
    n_tiles = [math.ceil(g.N / cfg.cols) for g in specs]

    # --- mode map + placement: size storage demand, place the blocks -------
    # session KV-backed GEMMs read the reserved cache instead of placed
    # weight tiles: they join neither the storage sizing nor first-fit
    w_tile_bits = {}
    for g, spec in enumerate(specs):
        if spec.kv and session is not None:
            continue
        for ki in range(k_tiles[g]):
            for ni in range(n_tiles[g]):
                kw = min(K, (ki + 1) * kts[g]) - ki * kts[g]
                nw = min(spec.N, (ni + 1) * cfg.cols) - ni * cfg.cols
                w_tile_bits[(g, ki, ni)] = kw * nw * infos[g].bits
    x_row_bits = {c: K * _dtype_info(c).bits for c in classes}
    pinned_modes = session is not None and session.modes is not None
    if pinned_modes:
        modes = session.modes
        storage_ids = tuple(b for b, m in enumerate(modes)
                            if m == "storage")
        free = session.storage_free
    else:
        total_bits = sum(w_tile_bits.values()) \
            + M * sum(x_row_bits[c] for c in classes)
        if session is not None:
            total_bits += sum(m_["window"] * m_["pos_bits"]
                              for m_ in session.kv.values())
        usable = cfg.usable_blocks      # spares are never scheduled onto
        n_storage = min(math.ceil(total_bits / cfg.block_bits),
                        usable - cfg.min_compute_blocks)
        n_storage = max(n_storage, 0)
        storage_ids = _storage_block_ids(usable, n_storage, cfg.placement)
        spare_ids = set(cfg.spare_ids)
        modes = tuple("spare" if b in spare_ids
                      else "storage" if b in set(storage_ids) else "compute"
                      for b in range(cfg.n_blocks))
        free = {b: cfg.block_bits for b in storage_ids}
    compute_blocks = tuple(b for b, m in enumerate(modes) if m == "compute")
    n_compute = len(compute_blocks)
    if n_compute < 1:
        raise ValueError("session mode map has no compute blocks left")

    # --- operand residency: first-fit into the storage blocks ---------------
    def place(bits: int) -> int:
        for b in storage_ids:
            if free[b] >= bits:
                free[b] -= bits
                return b
        return -1                                  # spill off-fabric

    if session is not None and not pinned_modes:
        # pin the mode map and place KV reservations FIRST, so the
        # cache lives on-fabric whenever it fits a storage block
        session.modes = modes
        session.storage_free = free
        for meta in session.kv.values():
            meta["home"] = place(meta["window"] * meta["pos_bits"])

    def w_gkey(g: int, ki: int, ni: int) -> tuple:
        return ("w", specs[g].name, infos[g].name,
                ki * kts[g], ni * cfg.cols)

    w_home = {}
    for key, bits in sorted(w_tile_bits.items()):
        if session is not None:
            gk = w_gkey(*key)
            if gk not in session.w_homes:
                session.w_homes[gk] = place(bits)
            w_home[key] = session.w_homes[gk]
        else:
            w_home[key] = place(bits)
    for g, spec in enumerate(specs):       # KV GEMMs: home = the cache
        if spec.kv and session is not None:
            home = session.kv[spec.kv]["home"]
            for ki in range(k_tiles[g]):
                for ni in range(n_tiles[g]):
                    w_home[(g, ki, ni)] = home
    x_homes = {(c, m): place(x_row_bits[c])
               for c in classes for m in range(M)}
    if session is not None:
        session._x_alloc = [(x_homes[(c, m)], x_row_bits[c])
                            for c in classes for m in range(M)]
    x_home = tuple(x_homes[(classes[0], m)] for m in range(M))

    # --- tile units -> lockstep rounds of n_compute ------------------------
    # (ki, g, ni, m) order: consecutive units share a weight tile (so a
    # round's sharers join one broadcast), and for fused GEMMs every
    # activation slice (m, k-slice) recurs across g/ni -- the reuse the
    # resident-tile map converts into skipped fetches.  Single-GEMM
    # programs reduce to the single-GEMM (ki, ni, m) order exactly.
    #
    # A round is ONE lockstep program launch, so tasks of different
    # dtype classes can never share one: units are built per class
    # *segment* (single-int-class programs get one segment -- the exact
    # legacy order).  Float classes additionally segment per k-tile:
    # a float output tile's k-tiles CHAIN through the wide accumulator
    # (float addition does not associate, unlike the host-summed int
    # partials), so two k-tiles of one output must sit in different,
    # ordered rounds.
    def class_units(c: str, ki_range) -> list:
        return [(g, m, ki, ni)
                for ki in ki_range
                for g in by_class[c]
                for ni in range(n_tiles[g])
                for m in range(M)]

    segments: List[Tuple[str, list]] = []
    for c in classes:
        g0 = by_class[c][0]
        if _dtype_info(c).is_float:
            for ki in range(k_tiles[g0]):
                segments.append((c, class_units(c, (ki,))))
        else:
            segments.append((c, class_units(c, range(k_tiles[g0]))))

    def unit_task(u, block: int) -> TileTask:
        g, m, ki, ni = u
        return TileTask(
            block=block, m=m, gemm=g,
            k0=ki * kts[g], k1=min(K, (ki + 1) * kts[g]),
            n0=ni * cfg.cols, n1=min(specs[g].N, (ni + 1) * cfg.cols),
            x_src=x_homes[(infos[g].name, m)], w_src=w_home[(g, ki, ni)])

    def canon(kind: str, key: tuple) -> tuple:
        """Bookkeeping key for the resident-tile maps: local (kind, key)
        without a session; program-independent *global* keys with one --
        weights by (name, dtype, tile), activations scoped to this
        program's epoch (never warm across programs), kv keys already
        global."""
        if session is None:
            return (kind, key)
        if kind == "w":
            g, k0, n0 = key
            return ("w", specs[g].name, infos[g].name, k0, n0)
        if kind == "kv":
            return ("kv",) + tuple(key)
        if multi:
            d, m, k0 = key
        else:
            m, k0 = key
            d = infos[0].name
        return ("x", session.epoch, d, m, k0)

    def unit_keys(u):
        g, m, ki, ni = u
        k0, n0 = ki * kts[g], ni * cfg.cols
        xkey = (infos[g].name, m, k0) if multi else (m, k0)
        if specs[g].kv:
            wkk = canon("kv", (specs[g].kv, k0, n0))
        else:
            wkk = canon("w", (g, k0, n0))
        return canon("x", xkey), wkk

    if session is not None:
        resident = session.resident
        for b in compute_blocks:
            resident.setdefault(b, {})
    else:
        resident = {b: {} for b in compute_blocks}
    rbase = session.clock if session is not None else 0
    rounds: List[Round] = []
    for c, units in segments:
        x_keys = {u: unit_keys(u)[0] for u in units}
        w_keys = {u: unit_keys(u)[1] for u in units}
        for r0 in range(0, len(units), n_compute):
            chunk = units[r0:r0 + n_compute]
            if cfg.residency:
                assign = _assign_slots(chunk, compute_blocks, resident,
                                       x_keys, w_keys)
            else:
                assign = {u: compute_blocks[i] for i, u in enumerate(chunk)}
            tasks = tuple(unit_task(u, assign[u]) for u in chunk)

            # load stage: group this round's tile reads by (kind, key);
            # each group is ONE fetch broadcast to the blocks that miss
            order: List[tuple] = []
            needs: Dict[tuple, list] = {}
            pinned: Dict[int, set] = {b: set() for b in compute_blocks}
            for t in tasks:
                for kind, key, src, bits in _task_operands(t, specs, infos,
                                                           multi):
                    kk = canon(kind, key)
                    if kk not in needs:
                        needs[kk] = [kind, key, src, bits, []]
                        order.append(kk)
                    if t.block not in needs[kk][4]:
                        needs[kk][4].append(t.block)
                    pinned[t.block].add(kk)

            rindex = rbase + len(rounds)
            loads = []
            for kk in order:
                kind, lkey, src, bits, dsts = needs[kk]
                if cfg.residency and kind == "kv" and session is not None:
                    # append-addressed growing tile: a holder of an
                    # earlier prefix fetches only the delta; holders of
                    # distinct prefixes split into separate delta nets
                    groups: Dict[int, list] = {}
                    for d in dsts:
                        seen = resident[d][kk][0] if kk in resident[d] else 0
                        if seen >= bits:
                            resident[d][kk][1] = rindex    # full hit
                        else:
                            groups.setdefault(seen, []).append(d)
                    for seen in sorted(groups):
                        loads.append(TileLoad(
                            kind="kv", key=lkey, src=src,
                            dsts=tuple(groups[seen]), bits=bits - seen))
                        for d in groups[seen]:
                            resident[d][kk] = [bits, rindex]
                            _evict_lru(resident[d], cfg.block_bits,
                                       pinned[d])
                    continue
                if cfg.residency:
                    missing = [d for d in dsts if kk not in resident[d]]
                    for d in dsts:
                        if kk in resident[d]:
                            resident[d][kk][1] = rindex    # LRU touch
                else:
                    missing = dsts
                if not missing:
                    continue                               # all-hit: no net
                loads.append(TileLoad(kind=kind, key=lkey, src=src,
                                      dsts=tuple(missing), bits=bits))
                if cfg.residency:
                    for d in missing:
                        resident[d][kk] = [bits, rindex]
                        _evict_lru(resident[d], cfg.block_bits, pinned[d])
            rounds.append(Round(tasks=tasks, loads=tuple(loads), dtype=c))

    if session is not None:
        session.clock = rbase + len(rounds)
        step = session._step()
        for rnd in rounds:
            for ld in rnd.loads:
                step["fetches"] += 1
                step["fetch_bits"] += ld.bits
                if ld.kind == "w":
                    step["w_fetches"] += 1
                elif ld.kind == "kv":
                    step["kv_fetch_bits"] += ld.bits

    return FabricProgram(cfg=cfg, nbits=nbits, signed=signed, gemms=specs,
                         kt=kts[0], modes=modes, x_home=x_home,
                         w_home=w_home, rounds=tuple(rounds),
                         dtypes=tuple(i.name for i in infos), kts=kts,
                         x_home_ext={k: v for k, v in x_homes.items()
                                     if k[0] != classes[0]})


def schedule_gemm(M: int, K: int, N: int, nbits: int,
                  cfg: FabricConfig = FabricConfig(),
                  signed: bool = False) -> FabricProgram:
    """Plan ``(M, K) @ (K, N)`` onto the block grid (no execution)."""
    return schedule_program((GemmSpec("gemm", M, K, N),), nbits,
                            cfg=cfg, signed=signed)


def residency_stats(sched: FabricProgram) -> dict:
    """Audit the load stage: fetches vs resident hits, from the IR alone.

    ``reads`` counts every (task, operand) pair; ``fetches`` counts
    :class:`TileLoad` nets (a broadcast is ONE fetch); a pair not
    covered by a same-round load destination was served by the block's
    resident-tile map (``hits``).  ``reload_fetches`` is what a
    reload-every-round load stage would have issued (one net per
    distinct tile per round) -- ``fetch_reduction`` is the headline
    residency win the fabric benchmark gates on.
    """
    reads = fetch_pairs = fetches = reload_fetches = 0
    fetch_bits = reload_bits = 0.0
    infos = sched.infos()
    multi = sched.multi
    for rnd in sched.rounds:
        loaded = {}
        for ld in rnd.loads:
            fetches += 1
            fetch_bits += ld.bits
            # kv delta loads of one growing tile may split into several
            # nets (per distinct resident prefix): union the coverage
            loaded.setdefault((ld.kind, tuple(ld.key)), set()).update(
                ld.dsts)
        round_keys = {}
        for t in rnd.tasks:
            for kind, key, _src, bits in _task_operands(t, sched.gemms,
                                                        infos, multi):
                kk = (kind, key)
                reads += 1
                round_keys[kk] = bits
                if t.block in loaded.get(kk, ()):
                    fetch_pairs += 1
        reload_fetches += len(round_keys)
        reload_bits += sum(round_keys.values())
    hits = reads - fetch_pairs
    return {
        "reads": reads,
        "fetches": fetches,
        "fetch_bits": fetch_bits,
        "hits": hits,
        "hit_rate": hits / max(reads, 1),
        "reload_fetches": reload_fetches,
        "reload_fetch_bits": reload_bits,
        "fetch_reduction": reload_fetches / max(fetches, 1),
    }


# ---------------------------------------------------------------------------
# Fault repair: remap dead blocks onto spares, or reschedule degraded
# ---------------------------------------------------------------------------
def repair_program(sched: FabricProgram, dead,
                   fm: Optional[faults_core.FaultModel] = None,
                   session: Optional[FabricSession] = None
                   ) -> FabricProgram:
    """Remap dead blocks out of a fabric program (docs/faults.md).

    ``dead`` is a collection of grid block ids diagnosed dead (a hard
    whole-block fault).  Repair is tiered:

    1. a dead block the schedule never used (an idle spare, or already
       marked dead) costs nothing -- the program is returned unchanged;
    2. each dead *used* block is remapped onto the nearest live spare by
       Manhattan hops (ties broken by lower id, deterministic): the
       spare inherits the dead block's mode and every task, operand
       home, and load net is rewritten to the new site.  Bit-exact --
       only the wire distances (and thus the cost roll-up) change;
    3. with too few spares, the program is **rescheduled on a degraded
       grid** of the surviving block count (sites renumbered densely) --
       still exact, but the schedule shape may change (fewer rounds'
       worth of parallelism);
    4. if even the degraded grid cannot host the program,
       :class:`repro.core.faults.FabricFaultError` is raised -- the
       serve layer's cue to retry elsewhere or fall back to the ref
       path.

    ``fm`` (optional :class:`repro.core.faults.FaultModel`) receives the
    remap count for the health report.

    ``session`` (optional :class:`FabricSession`) is kept consistent
    with the repair: a spare remap moves the dead block's storage homes
    onto the spare and DROPS a dead compute block's resident-tile map
    (the spare starts cold -- reusing the dead block's map on the spare
    would be silent wrong reuse); a degraded-grid reschedule resets the
    session entirely (the dense renumbering invalidates every home and
    resident entry), so the next program re-warms from cold.
    """
    cfg = sched.cfg
    dead = {int(b) for b in dead if 0 <= int(b) < cfg.n_blocks}
    used = {b for b, m in enumerate(sched.modes)
            if m in ("compute", "storage")}
    dead_used = sorted(dead & used)
    if not dead_used:
        return sched
    spares = [b for b, m in enumerate(sched.modes)
              if m == "spare" and b not in dead]
    if len(spares) >= len(dead_used):
        mapping = {}
        avail = list(spares)
        for b in dead_used:
            s = min(avail, key=lambda sp: (cfg.hops(b, sp), sp))
            avail.remove(s)
            mapping[b] = s
        if fm is not None:
            fm.remaps += len(mapping)
        if session is not None:
            session.apply_remap(mapping)

        def remap(b: int) -> int:
            return mapping.get(b, b) if b >= 0 else b

        modes = list(sched.modes)
        for b, s in mapping.items():
            modes[s] = modes[b]
            modes[b] = "dead"
        rounds = tuple(
            Round(tasks=tuple(
                      dataclasses.replace(t, block=remap(t.block),
                                          x_src=remap(t.x_src),
                                          w_src=remap(t.w_src))
                      for t in r.tasks),
                  loads=tuple(
                      dataclasses.replace(ld, src=remap(ld.src),
                                          dsts=tuple(remap(d)
                                                     for d in ld.dsts))
                      for ld in r.loads),
                  dtype=r.dtype)
            for r in sched.rounds)
        return dataclasses.replace(
            sched, modes=tuple(modes),
            x_home=tuple(remap(b) for b in sched.x_home),
            w_home={k: remap(v) for k, v in sched.w_home.items()},
            x_home_ext={k: remap(v) for k, v in sched.x_home_ext.items()},
            rounds=rounds)

    # not enough spares: degraded-grid reschedule on the survivors
    alive = cfg.n_blocks - len(dead)
    if alive < 1:
        raise FabricFaultError(
            f"all {cfg.n_blocks} blocks dead; nothing to reschedule onto")
    if fm is not None:
        fm.remaps += len(dead_used)
    if session is not None:
        session.reset()               # dense renumbering: nothing survives
    degraded = dataclasses.replace(
        cfg, n_blocks=alive, spare_blocks=0,
        min_compute_blocks=min(cfg.min_compute_blocks, alive))
    try:
        return schedule_program(sched.gemms, sched.nbits, cfg=degraded,
                                signed=sched.signed)
    except ValueError as e:
        raise FabricFaultError(
            f"degraded grid of {alive} block(s) cannot host the "
            f"program: {e}") from e


# ---------------------------------------------------------------------------
# Exact execution on the block simulator
# ---------------------------------------------------------------------------
# Cap on blocks per batched launch: bounds host memory for huge
# schedules (rounds are chunked; the final chunk is zero-padded so one
# compiled wide fn serves every chunk of a schedule).
MAX_BATCH_BLOCKS = 512

#: widest integer class whose images are packed on the device: the
#: ``fabric_pack`` kernel reads operands as bytes or 32-bit words
DEVICE_PACK_MAX_BITS = 32


def pack_blocks(lay, cols: int, tasks_slots, n_slots: int,
                x_enc: np.ndarray, w_us: Sequence[np.ndarray],
                fmt=None, accs=None) -> np.ndarray:
    """Host pack: the ``(n_slots, lay.rows, cols)`` bool block images of
    one launch, every ``(task, block-slot)`` pair of ``tasks_slots``.

    ``x_enc`` is the class's ``(M, K)`` activation encoding and
    ``w_us[g]`` GEMM *g*'s ``(K, N_g)`` weights (uint64).  Bit-plane
    transposition runs once per bit over every block at once (numpy
    broadcasting) instead of once per task -- identical images to
    ``harness.pack_state`` per block, but the host-side cost no longer
    scales with task count.  For a float class (``fmt``), a task past
    its first K-stage starts from the wide accumulator image its last
    stage left in ``accs[(gemm, m, n0)]``.
    """
    kt = lay.tuples
    a_vals = np.zeros((n_slots, kt, cols), np.uint64)
    b_vals = np.zeros((n_slots, kt, cols), np.uint64)
    for t, slot in tasks_slots:
        kw, nw = t.k1 - t.k0, t.n1 - t.n0
        a_vals[slot, :kw, :] = x_enc[t.m, t.k0:t.k1][:, None]     # -> cols
        b_vals[slot, :kw, :nw] = w_us[t.gemm][t.k0:t.k1, t.n0:t.n1]
    arrs = np.zeros((n_slots, lay.rows, cols), bool)
    bases = np.array([lay.base(i) for i in range(kt)])
    for name, vals in (("a", a_vals), ("b", b_vals)):
        off, width = lay.fields[name]
        for i in range(width):
            arrs[:, bases + off + i, :] = \
                ((vals >> np.uint64(i)) & np.uint64(1)).astype(bool)
    if fmt is not None:
        for t, slot in tasks_slots:
            if t.k0 == 0:
                continue          # fresh accumulator (+0 image)
            floatprog.fdot_set_acc(arrs[slot], fmt, accs[(t.gemm, t.m, t.n0)])
    return arrs


def pack_rowmap(lay) -> np.ndarray:
    """``(lay.rows,)`` int32: the ``fabric_pack`` row map of an ``idot``
    layout -- each operand row's tuple, field and bit
    (:func:`repro_torch.kernels.fabric_pack.row_code`), -1 elsewhere."""
    rowmap = np.full(lay.rows, -1, np.int32)
    for i in range(lay.tuples):
        for name in ("a", "b"):
            off, width = lay.fields[name]
            for j in range(width):
                rowmap[lay.base(i) + off + j] = fpk.row_code(i, name, j)
    return rowmap


def pack_descriptor(tasks_slots, n_slots: int, col_off: Dict[int, int],
                    kt: int, cols: int) -> np.ndarray:
    """``(n_slots, 6)`` int32: one launch's slot descriptors for
    ``fabric_pack`` -- ``m, k0, kw, col0, nw, used`` per slot, with
    ``col0`` the task's first column among the class's weights side by
    side (GEMM *g* starts at ``col_off[g]``); slots without a task stay
    zero (unused)."""
    desc = np.zeros((n_slots, fpk.DESC_FIELDS), np.int32)
    if not tasks_slots:
        return desc
    rows = np.array([(slot, t.m, t.k0, t.k1 - t.k0, col_off[t.gemm] + t.n0,
                      t.n1 - t.n0, 1) for t, slot in tasks_slots], np.int64)
    if rows[:, 3].max() > kt or rows[:, 5].max() > cols \
            or rows[:, 0].max() >= n_slots:
        raise ValueError(f"a task exceeds the launch's {n_slots} slots, its "
                         f"{kt} tuples or its {cols} columns")
    desc[rows[:, 0]] = rows[:, 1:]
    return desc


@dataclasses.dataclass(frozen=True)
class DeviceOperands:
    """One integer dtype class's operands on the device, for
    :func:`pack_blocks_device`: the ``(M, K)`` activation ``x`` and the
    class's GEMMs' weights side by side in ``w`` ``(K, sum N_g)`` (GEMM
    *g* from column ``col_off[g]``), uint8 up to 8 bits and 32-bit words
    (int32) above; the layout's ``rowmap``; its ``kt`` tuples."""
    x: torch.Tensor
    w: torch.Tensor
    col_off: Dict[int, int]
    rowmap: torch.Tensor
    kt: int


def device_operands(lay, bits: int, x_enc: np.ndarray,
                    w_us: Dict[int, np.ndarray], dev) -> DeviceOperands:
    """Upload one integer class's operands (``w_us``: GEMM -> its
    ``(K, N_g)`` weights, in GEMM order) and its layout's row map."""
    if bits > DEVICE_PACK_MAX_BITS:
        raise ValueError(f"int{bits} operands are wider than the device "
                         f"pack's {DEVICE_PACK_MAX_BITS} bits")

    dt = np.uint8 if bits <= 8 else np.uint32

    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a if dt == np.uint8
                                else a.view(np.int32)).to(dev)

    col_off, n = {}, 0
    for g, w in w_us.items():
        col_off[g], n = n, n + w.shape[1]
    return DeviceOperands(
        x=up(np.ascontiguousarray(x_enc, dt)),
        w=up(np.concatenate([w.astype(dt, order="C")
                             for w in w_us.values()], axis=1)),
        col_off=col_off, rowmap=torch.from_numpy(pack_rowmap(lay)).to(dev),
        kt=lay.tuples)


def pack_blocks_device(ops: DeviceOperands, desc: torch.Tensor,
                       cols: int) -> torch.Tensor:
    """Device pack: the ``(slots, rows, cols)`` bool block images of one
    launch from its uploaded descriptor (:func:`pack_descriptor`),
    written where the engine reads them -- bit for bit
    :func:`pack_blocks`'s integer images.  The ``fabric_pack`` kernel on
    CUDA, its plain torch version on the CPU."""
    return fpk.fabric_pack(ops.x, ops.w, desc, ops.rowmap, cols)


def execute_program(sched: FabricProgram, x_u: np.ndarray,
                    w_us: Sequence[np.ndarray],
                    executor: Optional[str] = None,
                    batch_rounds: Optional[bool] = None,
                    max_batch_blocks: int = MAX_BATCH_BLOCKS,
                    x_alt: Optional[Dict[str, np.ndarray]] = None,
                    packed: Optional[bool] = None,
                    faults: Optional[faults_core.FaultModel] = None,
                    dead_repaired: bool = False,
                    session: Optional[FabricSession] = None,
                    device=None) -> List[np.ndarray]:
    """Run the program's rounds exactly; operands already encoded.

    x_u ``(M, K)`` is the shared activation in the *primary* dtype
    class's encoding (unsigned ``< 2^bits`` for ints -- signed callers
    bias first -- and fmt bit patterns for floats); ``w_us[g]`` is GEMM
    *g*'s ``(K, N_g)`` weight in its own dtype's encoding.  For
    mixed-precision programs ``x_alt`` maps every non-primary dtype
    class name to its activation encoding.  Returns one raw ``(M, N_g)``
    uint64 image per fused GEMM: the accumulator for int GEMMs (callers
    apply the signed zero-point correction; see :func:`fabric_matmul`)
    and the rounded fmt bit pattern for float GEMMs.

    ``batch_rounds`` (default: on for the compiled executor) batches
    rounds into wide ``engine.execute_blocks`` launches (rounds = extra
    block-columns), chunked at ``max_batch_blocks``.  Rounds batch only
    with neighbours replaying the SAME program on independent data: a
    dtype-class boundary splits the batch, and float rounds batch
    per K-stage -- a float output tile's k-tiles chain through the wide
    accumulator image, which the host carries between stages, so the
    result is bit-identical to the per-round loop *and* independent of
    the K-tiling.

    ``packed`` selects the compiled interior representation and is
    forwarded to ``engine.execute_blocks``: the default ``None``
    resolves per program via ``engine.default_packed`` -- the int
    dot/mul round programs go through the uint32 bit-plane interior
    (where the wide-block scaling win lives) while the big float
    sequences keep the bool interior and its fast compiles.  Either
    setting is bit-identical.

    An active ``faults`` model (:class:`repro.core.faults.FaultModel`)
    injects seeded bit flips into every launch's packed block images
    and parity-scrubs on the model's cadence *before* the blocks
    execute: a dirty slot is restored from its pristine image (the
    re-pack from the backing operands -- the re-fetch the cost model
    prices).  Dead blocks must have been remapped away first
    (:func:`repair_program`); an unrepaired dead block that the
    schedule still uses raises
    :class:`repro.core.faults.FabricFaultError`.

    ``session`` (optional :class:`FabricSession`) is consulted only by
    the fault path: a parity scrub that restores a block from its
    pristine image re-packed *this launch's* operands only, so any
    session resident-tile entries for that physical block -- which may
    describe tiles of OTHER programs scheduled against warm state -- can
    no longer be trusted and are invalidated
    (:meth:`FabricSession.invalidate_blocks`); the next program through
    the session refetches them.  Residency itself was already consumed
    at schedule time, so execution is unaffected.

    ``device`` (``None``: the GPU) is where every launch's block states
    live and its engine call runs.  Each integer class without a fault
    model uploads its operands once (:func:`device_operands`) and packs
    every launch's images there (:func:`pack_blocks_device`); a float
    class, and every class under an active fault model, packs on the
    host (:func:`pack_blocks`) and uploads each image.  Counters
    ``fabric.packed_on_device`` and ``fabric.packed_on_host`` count the
    launches of each.  An integer launch brings back its accumulator
    rows alone, a float launch its whole image.
    """
    dev = engine.resolve_device(device)
    cfg = sched.cfg
    executor = executor or cfg.executor
    fm = faults if (faults is not None and faults.active) else None
    # ``dead_repaired`` (set by fabric_fused_matmul after repair_program)
    # suppresses this guard: a degraded-grid reschedule renumbers block
    # ids densely, so the model's physical dead ids may coincide with
    # live logical ids of the repaired schedule.
    if fm is not None and fm.dead_blocks and not fm.healed \
            and not dead_repaired:
        unrepaired = sorted(
            set(fm.dead_blocks)
            & {b for b, m in enumerate(sched.modes)
               if m in ("compute", "storage")})
        if unrepaired:
            raise FabricFaultError(
                f"dead block(s) {unrepaired} still mapped by the "
                f"schedule; run repair_program first")
    if batch_rounds is None:
        batch_rounds = executor == "compiled" and len(sched.rounds) > 1
    infos = sched.infos()
    classes = sched.classes
    primary = classes[0]
    x_encs = {primary: np.asarray(x_u, np.uint64)}
    for name, enc in (x_alt or {}).items():
        x_encs[name] = np.asarray(enc, np.uint64)
    missing = [c for c in classes if c not in x_encs]
    if missing:
        raise ValueError(
            f"missing activation encoding(s) for dtype class(es) "
            f"{missing} (pass x_alt)")
    w_us = [np.asarray(w, np.uint64) for w in w_us]
    if len(w_us) != len(sched.gemms):
        raise ValueError(f"{len(w_us)} weight operand(s) for a "
                         f"{len(sched.gemms)}-GEMM program")
    M, K = sched.M, sched.K
    for g, (spec, w_u) in enumerate(zip(sched.gemms, w_us)):
        info = infos[g]
        width = info.fmt.width if info.is_float else info.bits
        x_enc = x_encs[info.name]
        if x_enc.shape != (M, K) or w_u.shape != (K, spec.N):
            raise ValueError(
                f"operands {x_enc.shape} @ {w_u.shape} do not match "
                f"schedule {M}x{K}x{spec.N} (gemm {spec.name})")
        if np.any(w_u >= (1 << width)) or np.any(x_enc >= (1 << width)):
            raise ValueError(f"operands must be < 2^{width} "
                             f"({info.name} gemm {spec.name})")

    progs = {c: sched.class_program(c) for c in classes}
    class_info = {c: _dtype_info(c) for c in classes}
    compute_blocks = sched.compute_blocks
    slot_of = {b: i for i, b in enumerate(compute_blocks)}
    n_compute = len(compute_blocks)
    outs = [np.zeros((M, spec.N), np.uint64) for spec in sched.gemms]
    # float chaining state: (gemm, m, n0) -> (cols,) wide acc image
    accs: Dict[Tuple[int, int, int], np.ndarray] = {}

    def unpack_int(c: str, res: np.ndarray) -> np.ndarray:
        """(blocks, acc_bits, cols) accumulator rows -> (blocks, cols)."""
        _, lay = progs[c]
        acc = np.zeros((res.shape[0], res.shape[2]), np.uint64)
        for i in range(lay.acc_bits):
            acc |= res[:, i, :].astype(np.uint64) << np.uint64(i)
        return acc

    launch_idx = [0]                   # scrub cadence counts launches

    def faulted(arrs: np.ndarray) -> np.ndarray:
        """Inject + (on cadence) parity-scrub one launch's block images."""
        pristine = arrs
        blocks, rows_, cols_ = arrs.shape
        fm.parity_bits = max(fm.parity_bits,
                             blocks * faults_core.parity_bits(rows_, cols_))
        sig = faults_core.parity_signature(pristine)
        out = faults_core.inject(pristine.copy(), fm, dead_slots=())
        if fm.scrub and launch_idx[0] % fm.scrub_every == 0:
            if session is not None:
                # a scrubbed slot's restored image holds only THIS
                # launch's operands -- drop the physical block's warm
                # residency so later programs refetch instead of
                # silently reusing a state the scrub rewrote
                dirty = faults_core.dirty_blocks(out, sig)
                if dirty.any():
                    session.invalidate_blocks(
                        compute_blocks[s % n_compute]
                        for s in np.nonzero(dirty)[0])
            out = faults_core.scrub_states(out, pristine, sig, fm)
        launch_idx[0] += 1
        return out

    def launch(c: str, array: torch.Tensor) -> np.ndarray:
        blocks = array.shape[0]
        states = engine.CRState(
            array=array,
            carry=torch.zeros((blocks, cfg.cols), dtype=torch.bool,
                              device=dev),
            tag=torch.ones((blocks, cfg.cols), dtype=torch.bool, device=dev))
        out = engine.execute_blocks(progs[c][0], states, executor=executor,
                                    packed=packed)
        with trace.span("fabric.d2h"):
            if class_info[c].is_float:
                return out.array.cpu().numpy()
            # an int result is its accumulator rows alone
            return out.array[:, :progs[c][1].acc_bits].cpu().numpy()

    def consume(c: str, slots, res: np.ndarray) -> None:
        info = class_info[c]
        if not info.is_float:
            acc = unpack_int(c, res)
            for t, slot in slots:
                outs[t.gemm][t.m, t.n0:t.n1] += acc[slot, : t.n1 - t.n0]
            return
        fmt = info.fmt
        for t, slot in slots:
            nw = t.n1 - t.n0
            accs[(t.gemm, t.m, t.n0)] = \
                floatprog.fdot_acc(res[slot], fmt)
            if t.k1 == K:             # final K-stage: rounded result
                outs[t.gemm][t.m, t.n0:t.n1] = \
                    floatprog.fdot_result(res[slot], fmt)[:nw]

    def round_stage(rnd: Round):
        """Batch key: rounds batch only within (class, float K-stage)."""
        c = rnd.dtype or primary
        if class_info[c].is_float and rnd.tasks:
            return c, rnd.tasks[0].k0
        return c, None

    # integer classes pack on the device, from operands uploaded once;
    # the fault model's flips and the float chain need host images
    on_card: Dict[str, DeviceOperands] = {}
    if fm is None:
        with trace.span("fabric.h2d"):
            for c in classes:
                info = class_info[c]
                if not info.is_float and info.bits <= DEVICE_PACK_MAX_BITS:
                    on_card[c] = device_operands(
                        progs[c][1], info.bits, x_encs[c],
                        {g: w_us[g] for g in range(len(w_us))
                         if infos[g].name == c}, dev)

    # group consecutive batchable rounds, then chunk each group
    groups: List[Tuple[str, List[Round]]] = []
    for rnd in sched.rounds:
        key = round_stage(rnd)
        if batch_rounds and groups and groups[-1][0] == key:
            groups[-1][1].append(rnd)
        else:
            groups.append((key, [rnd]))

    for (c, _stage), rlist in groups:
        R = len(rlist)
        chunk_r = max(1, min(R, max(max_batch_blocks, n_compute)
                             // n_compute))
        for c0 in range(0, R, chunk_r):
            chunk = rlist[c0:c0 + chunk_r]
            slots = [(t, ri * n_compute + slot_of[t.block])
                     for ri, rnd in enumerate(chunk) for t in rnd.tasks]
            # the last chunk stays zero-padded to the chunk shape so ONE
            # compiled wide fn serves every chunk of the group
            n_slots = chunk_r * n_compute
            if c in on_card:
                ops = on_card[c]
                with trace.span("fabric.pack"):
                    desc = pack_descriptor(slots, n_slots, ops.col_off,
                                           ops.kt, cfg.cols)
                with trace.span("fabric.h2d"):
                    desc = torch.from_numpy(desc).to(dev)
                with trace.span("fabric.pack"):
                    array = pack_blocks_device(ops, desc, cfg.cols)
                trace.count("fabric.packed_on_device")
            else:
                info = class_info[c]
                with trace.span("fabric.pack"):
                    arrs = pack_blocks(progs[c][1], cfg.cols, slots, n_slots,
                                       x_encs[c], w_us,
                                       fmt=info.fmt if info.is_float
                                       else None, accs=accs)
                    if fm is not None:
                        arrs = faulted(arrs)
                with trace.span("fabric.h2d"):
                    array = torch.from_numpy(arrs).to(dev)
                trace.count("fabric.packed_on_host")
            res = launch(c, array)
            with trace.span("fabric.consume"):
                consume(c, slots, res)
            trace.count("fabric.slots_used", len(slots))
    return outs


def execute_schedule(sched: FabricProgram, x_u: np.ndarray, w_u: np.ndarray,
                     executor: Optional[str] = None,
                     batch_rounds: Optional[bool] = None,
                     max_batch_blocks: int = MAX_BATCH_BLOCKS,
                     packed: Optional[bool] = None,
                     device=None) -> np.ndarray:
    """Single-GEMM wrapper of :func:`execute_program` (legacy surface)."""
    if len(sched.gemms) != 1:
        raise ValueError("execute_schedule is single-GEMM; use "
                         "execute_program for fused programs")
    return execute_program(sched, x_u, (w_u,), executor=executor,
                           batch_rounds=batch_rounds,
                           max_batch_blocks=max_batch_blocks,
                           packed=packed, device=device)[0]


@dataclasses.dataclass(frozen=True)
class FabricResult:
    out: np.ndarray
    schedule: FabricProgram
    cost: costmodel.ScheduleCost
    #: float GEMMs also surface the raw fmt bit patterns (``out`` is
    #: their exact float32 value); None for integer GEMMs.
    out_bits: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class FusedResult:
    """Outputs of one fused multi-GEMM fabric program (one per GEMM)."""
    outs: Tuple[np.ndarray, ...]
    schedule: FabricProgram
    cost: costmodel.ScheduleCost
    #: per-GEMM raw fmt bit patterns for float GEMMs (None for ints)
    bits: Tuple[Optional[np.ndarray], ...] = ()


def _encode_float_operand(arr: np.ndarray, fmt) -> np.ndarray:
    """Float array -> fmt bit patterns; unsigned ints pass through as
    already-packed bit patterns."""
    if np.issubdtype(arr.dtype, np.unsignedinteger):
        return arr.astype(np.uint64)
    return ref.to_bits(np.asarray(arr, np.float32),
                       fmt.ebits, fmt.mbits).astype(np.uint64)


def fabric_matmul(x, w, nbits: int = 4,
                  cfg: FabricConfig = FabricConfig(),
                  signed: bool = False, *,
                  dtype=None,
                  schedule: Optional[FabricProgram] = None,
                  batch_rounds: Optional[bool] = None,
                  faults: Optional[faults_core.FaultModel] = None,
                  session: Optional[FabricSession] = None,
                  device=None) -> FabricResult:
    """Schedule, execute, and account ``(M, K) @ (K, N)`` on the fabric.

    Integer GEMMs (``dtype=None`` / ``"int4"`` / ...) are bit-exact vs
    ``x @ w`` in int64 for any operand in range.  Float GEMMs
    (``dtype=jnp.bfloat16`` / ``"bf16"`` / ``"fp16"`` / ``"fp8"``) take
    float arrays (converted by :func:`repro.core.ref.to_bits`, FTZ+RTZ)
    or pre-packed unsigned bit patterns, and are bit-exact vs the
    FTZ+RTZ fused-MAC reference :func:`repro.core.ref.float_matmul` --
    independent of grid size and K-tiling, because the wide accumulator
    image chains across K-tiles.  The cost report prices the *executed*
    schedule (same IR), so correctness and accounting never drift apart.

    ``schedule`` reuses a pre-built plan (e.g. the
    :func:`search_schedule` argmin) instead of re-planning; its shape /
    precision must match the operands.  ``batch_rounds`` is forwarded to
    :func:`execute_schedule`.  ``session`` threads a
    :class:`FabricSession` through scheduling so sequential calls reuse
    warm resident tiles (see :func:`fabric_fused_matmul`).  The blocks
    run on ``device`` (``None``: the GPU).
    """
    res = fabric_fused_matmul(x, (w,), nbits=nbits, cfg=cfg, signed=signed,
                              dtypes=(dtype,), program=schedule,
                              batch_rounds=batch_rounds, faults=faults,
                              session=session, device=device)
    return FabricResult(out=res.outs[0], schedule=res.schedule,
                        cost=res.cost,
                        out_bits=res.bits[0] if res.bits else None)


@trace.spanned("fabric.fused_matmul")
def fabric_fused_matmul(x, ws: Sequence, nbits: int = 4,
                        cfg: FabricConfig = FabricConfig(),
                        signed: bool = False, *,
                        names: Optional[Sequence[str]] = None,
                        dtypes: Optional[Sequence] = None,
                        program: Optional[FabricProgram] = None,
                        batch_rounds: Optional[bool] = None,
                        faults: Optional[faults_core.FaultModel] = None,
                        specs: Optional[Sequence[GemmSpec]] = None,
                        session: Optional[FabricSession] = None,
                        device=None) -> FusedResult:
    """Run several GEMMs sharing activations as ONE fabric program.

    ``x (M, K) @ ws[g] (K, N_g)`` for every g -- the fused-QKV case: one
    grid allocation, shared activation residency, one batched wide-block
    launch.  Bit-exact per GEMM vs ``x @ ws[g]`` in int64 (int GEMMs) /
    vs :func:`repro.core.ref.float_matmul` (float GEMMs).

    ``dtypes`` assigns a per-GEMM element type (None entries = the
    int{nbits} default), enabling **asymmetric precision**: int4, int8
    and bf16 GEMMs coexisting in one program (e.g. int8 QKV + a bf16
    output projection).  Every float GEMM reads the shared activation
    through its own encoding (``ref.to_bits`` of ``x`` as float32 --
    exact whenever x holds small integers); int GEMMs require an
    integer-valued ``x`` in range, exactly as before.

    ``program`` reuses a pre-built plan (e.g. the :func:`search_program`
    argmin); its shapes / precision / dtypes must match the operands.

    ``faults`` (:class:`repro.core.faults.FaultModel`, default None =
    pristine SRAM) enables the fault path: dead blocks are repaired out
    of the schedule first (:func:`repair_program` -- spare remap or
    degraded reschedule), bit flips are injected + parity-scrubbed per
    launch inside :func:`execute_program`, and the returned cost adds
    the honest fault overhead (parity storage, scrub reads, re-fetch
    traffic via :func:`repro.core.costmodel.fault_cost`).

    ``specs`` overrides the auto-built :class:`GemmSpec` tuple -- the
    way to declare ``kv=`` cache tiles or custom stable names while
    still letting this call schedule; shapes must match the operands.
    Ignored when ``program`` is given (the program carries its specs).

    ``session`` threads a :class:`FabricSession` through scheduling:
    sequential calls against the same session schedule WARM -- weight
    tiles resident from earlier programs emit no :class:`TileLoad`, and
    the session's trajectory records the per-call cost.  With both
    ``program`` and ``session``, the program acts as the plan template
    (its specs / cfg / precision) and is re-scheduled against the
    session's current residency -- a pre-tuned plan stays pre-tuned
    while later steps still get the warm-state savings.  Outputs are
    bit-identical with or without a session: execution always re-packs
    from the host-side operands; residency is a cost/IR concept.

    ``device`` (``None``: the GPU) is where the blocks run; operands and
    results are numpy arrays on the host.
    """
    x = np.asarray(x)
    ws = [np.asarray(w) for w in ws]
    if names is None:
        names = [f"gemm{g}" for g in range(len(ws))]
    if dtypes is None:
        dtypes = (None,) * len(ws)
    if len(dtypes) != len(ws):
        raise ValueError(f"{len(dtypes)} dtype(s) for {len(ws)} GEMM(s)")
    rinfos = tuple(cram.resolve_dtype(d) or _dtype_info(f"int{nbits}")
                   for d in dtypes)
    if program is None:
        if specs is None:
            specs = tuple(GemmSpec(str(names[g]), x.shape[0], x.shape[1],
                                   ws[g].shape[1],
                                   dtype=(rinfos[g].name
                                          if dtypes[g] is not None
                                          else None))
                          for g in range(len(ws)))
        else:
            specs = tuple(specs)
            if len(specs) != len(ws):
                raise ValueError(
                    f"{len(specs)} spec(s) for {len(ws)} GEMM(s)")
            rinfos = tuple(cram.resolve_dtype(s.dtype)
                           or _dtype_info(f"int{nbits}") for s in specs)
        with trace.span("fabric.schedule"):
            sched = schedule_program(specs, nbits, cfg=cfg, signed=signed,
                                     session=session)
    else:
        sched = program
        shapes = tuple((g.M, g.K, g.N) for g in sched.gemms)
        want = tuple((x.shape[0], x.shape[1], w.shape[1]) for w in ws)
        have_dt = tuple(sched.dtype_of(g) for g in range(len(sched.gemms)))
        want_dt = tuple(i.name for i in rinfos)
        if shapes != want or sched.nbits != nbits \
                or sched.signed != signed or have_dt != want_dt:
            raise ValueError(
                f"program {shapes}/int{sched.nbits}"
                f"{'s' if sched.signed else 'u'}/{have_dt} does not match "
                f"operands {want} int{nbits}{'s' if signed else 'u'}"
                f"/{want_dt}")
        if session is not None:
            # the program is the plan template; re-schedule its specs on
            # its cfg against the session's warm residency so a tuned
            # plan keeps its geometry AND gets the cross-call savings
            with trace.span("fabric.schedule"):
                sched = schedule_program(sched.gemms, sched.nbits,
                                         cfg=sched.cfg, signed=sched.signed,
                                         session=session)
    infos = sched.infos()

    # encode the shared activation once per dtype class, weights per GEMM
    with trace.span("fabric.encode"):
        int_off: Dict[str, np.int64] = {}
        x_encs: Dict[str, np.ndarray] = {}
        for info in infos:
            if info.name in x_encs:
                continue
            if info.is_float:
                x_encs[info.name] = _encode_float_operand(x, info.fmt)
            elif signed:
                cram._check_range([x], info.bits, signed=True)
                xu, off = cram._bias_signed(x, info.bits)
                x_encs[info.name] = xu
                int_off[info.name] = off
            else:
                cram._check_range([x], info.bits, signed=False)
                x_encs[info.name] = np.asarray(x, np.uint64)
        w_encs = []
        for info, w in zip(infos, ws):
            if info.is_float:
                w_encs.append(_encode_float_operand(w, info.fmt))
            elif signed:
                cram._check_range([w], info.bits, signed=True)
                w_encs.append(cram._bias_signed(w, info.bits)[0])
            else:
                cram._check_range([w], info.bits, signed=False)
                w_encs.append(np.asarray(w, np.uint64))

    fm = faults if (faults is not None and faults.active) else None
    repaired = False
    if fm is not None and fm.dead_blocks and not fm.healed:
        with trace.span("fabric.schedule"):
            sched = repair_program(sched, fm.dead_blocks, fm=fm,
                                   session=session)
        repaired = True

    primary = sched.classes[0]
    x_alt = {c: enc for c, enc in x_encs.items() if c != primary}
    scrub0, refetch0 = ((fm.scrub_rows, fm.refetch_bits) if fm is not None
                        else (0, 0))
    with trace.span("fabric.execute"):
        raws = execute_program(sched, x_encs[primary], w_encs,
                               batch_rounds=batch_rounds,
                               x_alt=x_alt or None, faults=fm,
                               dead_repaired=repaired, session=session,
                               device=device)

    with trace.span("fabric.unbias"):
        outs, bits = [], []
        for info, raw, wu in zip(infos, raws, w_encs):
            if info.is_float:
                bits.append(raw.astype(np.uint32))
                outs.append(ref.from_bits(raw, info.fmt.ebits,
                                          info.fmt.mbits))
            elif signed:
                off = int_off[info.name]
                a_sums = x_encs[info.name].sum(axis=1,
                                               dtype=np.int64)[:, None]
                outs.append(cram._unbias(
                    raw, off, a_sums,
                    wu.sum(axis=0, dtype=np.int64)[None, :], x.shape[1]))
                bits.append(None)
            else:
                outs.append(raw)
                bits.append(None)
    with trace.span("fabric.cost"):
        cost = schedule_cost(sched)
        if fm is not None:
            fcost = costmodel.fault_cost(
                "fabric/fault_overhead", n_blocks=sched.cfg.n_blocks,
                cols=sched.cfg.cols, parity_bits=fm.parity_bits,
                scrub_rows=fm.scrub_rows - scrub0,
                refetch_bits=fm.refetch_bits - refetch0,
                edge_hops=sched.cfg.grid_diameter)
            cost = combine_costs(cost.name + "+faults", [cost, fcost])
        if session is not None:
            session.record_cost(cost)
    return FusedResult(outs=tuple(outs), schedule=sched,
                       cost=cost, bits=tuple(bits))


# ---------------------------------------------------------------------------
# Cost accounting (walks the IR, prices with core.costmodel)
# ---------------------------------------------------------------------------
def _broadcast_net_mm(cfg: FabricConfig, src: int,
                      dsts: Tuple[int, ...]) -> float:
    """Wire length of one multi-destination fabric net, by placement.

    The net spans the bounding box of the source and destination sites
    (a Steiner-tree approximation): its length is the Manhattan span in
    hops times the per-hop wire length -- so a broadcast to neighbours
    is short and one across the grid diameter is long.
    """
    sites = [cfg.site(src)] + [cfg.site(d) for d in dsts]
    rows_ = [s[0] for s in sites]
    cols_ = [s[1] for s in sites]
    span = (max(rows_) - min(rows_)) + (max(cols_) - min(cols_))
    return costmodel.hop_net_length_mm(span)


def _spill_net_mm(cfg: FabricConfig, dsts: Tuple[int, ...]) -> float:
    """Off-fabric fetch: the long I/O column plus the on-fabric hops
    from the host edge to the farthest destination block."""
    edge = max(cfg.edge_hops(d) for d in dsts)
    return costmodel.NET_LENGTH_SPILL_MM + costmodel.hop_net_length_mm(edge)


def schedule_cost(sched: FabricProgram) -> costmodel.ScheduleCost:
    """Roll one fabric program up into energy (pJ) / time (us).

    Event counts per round (transposed bit-serial layout):

    * operand load: each :class:`TileLoad` moves its payload bits ONCE,
      regardless of how many destinations the broadcast fans out to --
      the fetch is a single multi-destination net priced by the
      Manhattan span of the sites it touches (:func:`_broadcast_net_mm`;
      the spill path adds the off-fabric I/O column), and one read
      stream at the source.  Tiles served from a block's resident-tile
      map appear in NO load: residency savings are wire and storage
      savings the cost model sees directly.
    * storage-mode traffic: source rows read (``ceil(bits / row width)``
      at the home block, once per load) plus destination rows written
      per *fetched* copy (the tile spans ``kt * nbits`` rows of the
      compute block while it is still in storage mode; resident hits
      write nothing), plus ``ACC_BITS`` accumulator rows read back per
      task (the drain stage).
    * compute: every *started* block burns ``program.cycles()``
      compute-mode cycles; idle blocks in a partial round are never
      started (per-block start lines) and burn nothing.  Rounds
      serialize (lockstep launches), so the critical path still spans
      every round regardless of occupancy.

    Latency (CR-cycle units, storage rows converted at the BRAM/CR
    frequency ratio): ``serial_cycles`` lays every round's load ->
    compute -> drain end to end.  ``overlapped_cycles`` double-buffers:
    round *i+1*'s loads and round *i*'s drain run during round *i*'s
    compute, so each pipeline stage costs ``max(compute, next_load +
    drain)`` -- strictly less than serial for any schedule with >= 2
    rounds (the hidden work is positive), identical for 1 round.
    Residency shrinks the load stage of later rounds, so the pipeline
    model credits reuse with real cycles, not just energy.
    """
    cfg = sched.cfg
    infos = sched.infos()
    primary = sched.classes[0]
    cycles_of = {c: sched.class_program(c)[0].cycles()
                 for c in sched.classes}
    # per-task drain width: int tasks read back the 32-bit accumulator;
    # float tasks drain the *wide* accumulator image (K-tile chaining
    # moves the wide value, not just the rounded fmt result)
    drain_of = {g: (_wide_drain_bits(infos[g]) if infos[g].is_float
                    else ACC_BITS) for g in range(len(infos))}
    by_name = {infos[g].name: g for g in range(len(infos))}
    row_bits = cfg.cols

    n_active_cycles = 0.0
    round_cycles = 0.0
    fabric_bits = 0.0
    spill_bits = 0.0
    fabric_bit_mm = 0.0
    spill_bit_mm = 0.0
    load_rows = []                 # per round: src reads + dst writes
    drain_rows = []                # per round: accumulator readback
    cycles_rows = []               # per round: compute cycles
    for rnd in sched.rounds:
        cyc = cycles_of[rnd.dtype or primary]
        n_active_cycles += len(rnd.tasks) * cyc
        round_cycles += cyc
        cycles_rows.append(float(cyc))
        lr = 0.0
        for ld in rnd.loads:
            if ld.src >= 0:
                fabric_bits += ld.bits
                fabric_bit_mm += ld.bits * _broadcast_net_mm(cfg, ld.src,
                                                             ld.dsts)
                lr += math.ceil(ld.bits / row_bits)        # src reads, once
            else:
                spill_bits += ld.bits
                spill_bit_mm += ld.bits * _spill_net_mm(cfg, ld.dsts)
            # dst writes while the compute block is still in storage
            # mode -- one copy per destination that actually fetched;
            # the tile spans the load's class K-tile x element width
            if ld.kind == "w":
                g = ld.key[0]
                lr += len(ld.dsts) * sched.kt_of(g) * infos[g].bits
            elif ld.kind == "kv":
                # append-addressed cache tile: only the DELTA bits since
                # the destination last saw this tile land in new rows --
                # history already sits in place and is never rewritten
                lr += len(ld.dsts) * math.ceil(ld.bits / row_bits)
            else:
                g = by_name[ld.key[0]] if sched.multi else by_name[primary]
                lr += len(ld.dsts) * sched.kt_of(g) * infos[g].bits
        dr = 0.0
        for t in rnd.tasks:
            # result readback crosses the fabric to the host edge: hops
            # from the task's site to the I/O interface
            bits = drain_of[t.gemm] * (t.n1 - t.n0)
            fabric_bits += bits
            fabric_bit_mm += bits * costmodel.hop_net_length_mm(
                cfg.edge_hops(t.block))
            dr += drain_of[t.gemm]
        load_rows.append(lr)
        drain_rows.append(dr)
    rows_touched = sum(load_rows) + sum(drain_rows)

    ratio = costmodel.STORAGE_ROW_CR_CYCLES
    R = len(sched.rounds)
    serial = sum(load_rows[r] * ratio + cycles_rows[r]
                 + drain_rows[r] * ratio for r in range(R))
    overlapped = load_rows[0] * ratio
    for r in range(R - 1):
        overlapped += max(cycles_rows[r],
                          (load_rows[r + 1] + drain_rows[r]) * ratio)
    overlapped += cycles_rows[R - 1] + drain_rows[R - 1] * ratio

    shapes = "+".join(f"{g.M}x{g.K}x{g.N}" for g in sched.gemms)
    prec = "+".join(sched.classes) if sched.dtypes else f"int{sched.nbits}"
    return costmodel.schedule_cost_rollup(
        f"fabric/gemm{shapes}/{prec}",
        n_blocks=cfg.n_blocks, n_compute=sched.n_compute,
        n_storage=sched.n_storage, rounds=R,
        compute_block_cycles=float(n_active_cycles),
        round_cycles=float(round_cycles),
        storage_rows_touched=rows_touched,
        fabric_bits_moved=fabric_bits, spill_bits_moved=spill_bits,
        ops=sched.ops, serial_cycles=serial, overlapped_cycles=overlapped,
        fabric_bit_mm=fabric_bit_mm, spill_bit_mm=spill_bit_mm)


# ---------------------------------------------------------------------------
# Schedule autotuner: enumerate FabricConfig geometries x storage/compute
# splits x placements, price each candidate with the (cheap, pure-Python)
# costmodel roll-up -- NO execution -- and return the argmin program.
# ---------------------------------------------------------------------------
#: Paper §V-D block geometries (same 20 Kb capacity, different aspect).
GEOMETRY_CHOICES: Tuple[Tuple[int, int], ...] = tuple(
    sorted(costmodel.GEOMETRIES))

#: Objectives the search can minimize -> ScheduleCost accessor.
OBJECTIVES = {
    "overlapped_cycles": "overlapped_cycles_",
    "serial_cycles": "serial_cycles_",
    "time_us": "time_us",
    "energy_pj": "energy_pj",
    "energy_per_op_pj": "energy_per_op_pj",
}

# bounded memo (shared LRU implementation with the compile cache)
_SEARCH_MEMO = engine._LRUCache(128)


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """Argmin of a schedule search plus the full priced candidate table.

    ``candidates`` holds one row per *distinct* schedule: geometry-
    equivalent configs (e.g. two ``min_compute_blocks`` values clamping
    to the same storage/compute split) are deduplicated before pricing,
    and every row carries the residency hit-rate/fetch columns so an
    autotune pick is explainable from the table alone.
    """
    schedule: FabricProgram
    cost: costmodel.ScheduleCost
    objective: str
    candidates: Tuple[dict, ...]     # one row per priced candidate

    @property
    def config(self) -> FabricConfig:
        return self.schedule.cfg

    def describe(self) -> str:
        c = self.schedule.cfg
        return (f"search[{self.objective}]: {len(self.candidates)} "
                f"candidate(s) -> {c.rows}x{c.cols} "
                f"min_compute={c.min_compute_blocks} {c.placement} "
                f"({getattr(self.cost, OBJECTIVES[self.objective]):.0f})")

    def candidate_table(self) -> str:
        """The priced candidate table, one aligned text row each."""
        cols = ("rows", "cols", "placement", "n_compute", "n_storage",
                "rounds", "hit_rate", "fetches", "objective",
                "energy_pj")
        head = " ".join(f"{c:>10}" for c in cols)
        body = [" ".join(f"{r[c]:>10}" for c in cols)
                for r in self.candidates]
        return "\n".join([head] + body)


def _split_choices(n_blocks: int) -> Tuple[int, ...]:
    """min_compute_blocks candidates: sweep the storage/compute split."""
    raw = {1, n_blocks // 4, n_blocks // 2, (3 * n_blocks) // 4, n_blocks}
    return tuple(sorted(x for x in raw if 1 <= x <= n_blocks))


def search_program(specs: Sequence[GemmSpec], nbits: int, *,
                   base: FabricConfig = FabricConfig(),
                   signed: bool = False,
                   geometries: Optional[Tuple[Tuple[int, int], ...]] = None,
                   splits: Optional[Tuple[int, ...]] = None,
                   placements: Optional[Tuple[str, ...]] = None,
                   objective: str = "overlapped_cycles") -> SearchResult:
    """Search geometries x splits x placements for one fabric program.

    Every candidate is planned with :func:`schedule_program` and priced
    with :func:`schedule_cost` -- pure Python on the IR, no simulator
    execution -- so the search is cheap enough to run per serving shape.
    The argmin program is returned ready for :func:`fabric_fused_matmul`
    (``program=``) / :func:`fabric_matmul` (``schedule=``).

    ``geometries`` defaults to the base grid's geometry plus the paper
    §V-D choices (:data:`GEOMETRY_CHOICES`).  Callers that will
    *execute* the winner on the simulator may want to pin ``geometries``
    to the base geometry only: each new (nbits, rows, kt) shape compiles
    a fresh program (seconds), whereas split/placement tuning reuses
    compiled programs.  ``splits`` defaults to a sweep of
    ``min_compute_blocks`` over the grid (:func:`_split_choices`);
    ``placements`` to :data:`PLACEMENT_CHOICES` (where the storage
    blocks sit -- the dimension the hop-priced wire model makes
    meaningful).

    Candidates that plan to an identical schedule (same geometry,
    placement, and resulting storage/compute split) are priced once.
    Results are memoized (bounded LRU) -- serving calls the search once
    per (shape, grid), not once per token.
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; "
                         f"expected one of {sorted(OBJECTIVES)}")
    specs = tuple(specs)
    geometries = tuple(geometries) if geometries is not None else \
        tuple(dict.fromkeys(((base.rows, base.cols),) + GEOMETRY_CHOICES))
    splits = tuple(splits) if splits is not None else \
        _split_choices(base.n_blocks)
    placements = tuple(placements) if placements is not None else \
        PLACEMENT_CHOICES

    key = (specs, nbits, signed, base.n_blocks, base.executor,
           base.residency, geometries, splits, placements, objective)
    hit = _SEARCH_MEMO.get(key)
    if hit is not None:
        return hit

    attr = OBJECTIVES[objective]
    best = None
    best_val = None
    rows_out = []
    seen = set()
    for rows, cols in geometries:
        for placement in placements:
            for mcb in splits:
                if mcb > base.n_blocks:
                    continue
                cfg = FabricConfig(n_blocks=base.n_blocks, rows=rows,
                                   cols=cols, executor=base.executor,
                                   min_compute_blocks=mcb,
                                   placement=placement,
                                   residency=base.residency)
                try:
                    sched = schedule_program(specs, nbits, cfg=cfg,
                                             signed=signed)
                except ValueError:
                    continue           # geometry can't host the program
                sig = (rows, cols, placement, sched.n_compute)
                if sig in seen:        # geometry-equivalent: price once
                    continue
                seen.add(sig)
                cost = schedule_cost(sched)
                stats = residency_stats(sched)
                val = float(getattr(cost, attr))
                rows_out.append({
                    "rows": rows, "cols": cols, "min_compute": mcb,
                    "placement": placement,
                    "n_compute": sched.n_compute,
                    "n_storage": sched.n_storage,
                    "rounds": len(sched.rounds), "kt": sched.kt,
                    "objective": round(val, 3),
                    "serial_cycles": round(cost.serial_cycles_, 1),
                    "overlapped_cycles": round(cost.overlapped_cycles_, 1),
                    "energy_pj": round(cost.energy_pj, 3),
                    "fetches": stats["fetches"],
                    "hits": stats["hits"],
                    "hit_rate": round(stats["hit_rate"], 3),
                    "fetch_reduction": round(stats["fetch_reduction"], 3),
                })
                if best_val is None or val < best_val:
                    best, best_val = (sched, cost), val
    if best is None:
        shapes = "+".join(f"{g.M}x{g.K}x{g.N}" for g in specs)
        raise ValueError(
            f"no candidate geometry can schedule {shapes} int{nbits}")
    return _SEARCH_MEMO.put(key, SearchResult(
        schedule=best[0], cost=best[1], objective=objective,
        candidates=tuple(rows_out)))


def search_schedule(M: int, K: int, N: int, nbits: int, *,
                    base: FabricConfig = FabricConfig(),
                    signed: bool = False,
                    geometries: Optional[Tuple[Tuple[int, int], ...]] = None,
                    splits: Optional[Tuple[int, ...]] = None,
                    placements: Optional[Tuple[str, ...]] = None,
                    objective: str = "overlapped_cycles") -> SearchResult:
    """Single-GEMM wrapper of :func:`search_program` (legacy surface)."""
    return search_program((GemmSpec("gemm", M, K, N),), nbits, base=base,
                          signed=signed, geometries=geometries,
                          splits=splits, placements=placements,
                          objective=objective)


# ---------------------------------------------------------------------------
# Attention on the fabric (the paper's DL workload, via models/attention
# shapes: q/k are (B, S, H, hd) exactly as produced by ``_qkv``)
# ---------------------------------------------------------------------------
def _quantize_sym(x: np.ndarray, bits: int):
    """Symmetric per-tensor quantization to signed ``bits`` ints."""
    qmax = (1 << (bits - 1)) - 1
    amax = max(float(np.abs(x).max()), 1e-8)
    scale = amax / qmax
    q = np.clip(np.round(x / scale), -qmax - 1, qmax).astype(np.int64)
    return q, scale


def fabric_attention_scores(q: np.ndarray, k: np.ndarray,
                            cfg: FabricConfig = FabricConfig(),
                            bits: int = 8, device=None):
    """Attention score matmul ``q @ k^T`` per (batch, head) on the fabric.

    q: ``(B, Sq, H, hd)``, k: ``(B, Sk, H, hd)`` floats (the
    ``models.attention._qkv`` layout).  Each (batch, head) score tile is
    one fabric GEMM of the *quantized* operands; scores come back
    dequantized and pre-scaled by ``hd ** -0.5`` -- ready for the
    softmax of :func:`repro.models.attention.chunked_attention`.

    Returns ``(scores (B, Sq, H, Sk) float32, int_scores int64,
    costs list[ScheduleCost])``.  The blocks run on ``device``
    (``None``: the GPU).
    """
    dev = engine.resolve_device(device)
    q = np.asarray(q, np.float32)
    k = np.asarray(k, np.float32)
    B, Sq, H, hd = q.shape
    Bk, Sk, Hk, hdk = k.shape
    if (B, H, hd) != (Bk, Hk, hdk):
        raise ValueError(f"q {q.shape} vs k {k.shape}")

    qq, sq = _quantize_sym(q, bits)
    qk, sk = _quantize_sym(k, bits)
    scores = np.zeros((B, Sq, H, Sk), np.float32)
    int_scores = np.zeros((B, Sq, H, Sk), np.int64)
    costs = []
    for b in range(B):
        for h in range(H):
            res = fabric_matmul(qq[b, :, h, :], qk[b, :, h, :].T,
                                nbits=bits, cfg=cfg, signed=True,
                                device=dev)
            int_scores[b, :, h, :] = res.out
            scores[b, :, h, :] = res.out * (sq * sk * hd ** -0.5)
            costs.append(res.cost)
    return scores, int_scores, costs


class FabricAttentionBlock:
    """A full single-head attention block decoding on ONE fabric session.

    Per decode step, four chained programs run on one grid allocation
    (the session pins the mode map at step 1):

    1. fused **QKV** projection -- ``x (1, d) @ wq/wk/wv (d, hd)``;
       weight tiles go resident at step 1 and emit NO loads afterwards;
    2. **scores** ``q (1, hd) @ K^T (hd, t)`` -- K^T is a session KV
       cache (``GemmSpec(kv="k", kv_axis="n")``): this step's column
       was *appended* in place, so the schedule charges only the delta;
    3. host softmax + **AV** ``p (1, t) @ V (t, hd)`` -- V is the
       second KV cache, growing along the K axis (``kv_axis="k"``);
    4. **output projection** ``a (1, hd) @ wo (hd, d)``.

    Quantization scales are FIXED after step-1 calibration (``sp`` is
    analytic: softmax outputs live in [0, 1]): an append-only cache
    cannot rescale history, so every step quantizes onto the same grid
    and the whole trajectory is replayable bit-exactly by a host int
    oracle applying the same scales (see tests).  Execution re-packs the
    host-side mirrors every launch, so outputs are bit-identical with or
    without the session -- the session changes the *accounting*
    (steady-state steps fetch ~nothing).  Every program runs on
    ``device`` (``None``: the GPU).
    """

    def __init__(self, wq, wk, wv, wo, cfg: FabricConfig = FabricConfig(),
                 bits: int = 8, window: int = 64,
                 session: Optional[FabricSession] = None, device=None):
        self.device = engine.resolve_device(device)
        self.wq, self.wk, self.wv, self.wo = (
            np.asarray(w, np.float32) for w in (wq, wk, wv, wo))
        d, hd = self.wq.shape
        for name, w, shape in (("wk", self.wk, (d, hd)),
                               ("wv", self.wv, (d, hd)),
                               ("wo", self.wo, (hd, d))):
            if w.shape != shape:
                raise ValueError(f"{name} {w.shape}, expected {shape} "
                                 f"(wq is {self.wq.shape})")
        self.d, self.hd = d, hd
        self.cfg = cfg
        self.bits = bits
        self.window = window
        self.qmax = (1 << (bits - 1)) - 1
        # stationary weights: quantize ONCE (the session contract -- a
        # stable name must mean a stable weight)
        (self._qwq, self.swq), (self._qwk, self.swk), \
            (self._qwv, self.swv), (self._qwo, self.swo) = (
                _quantize_sym(w, bits)
                for w in (self.wq, self.wk, self.wv, self.wo))
        self.session = session if session is not None else FabricSession(cfg)
        self.session.reserve_kv("k", pos_bits=hd * bits, window=window)
        self.session.reserve_kv("v", pos_bits=hd * bits, window=window)
        # activation scales: calibrated at step 1, then FIXED
        self.sx = self.sq = self.sk = self.sv = self.so = None
        self.sp = 1.0 / self.qmax          # softmax probs: analytic scale
        # host-side mirrors of the on-fabric caches (execution packs
        # operands from the host; residency/kv is the cost-model view)
        self.k_cache = np.zeros((hd, 0), np.int64)     # K^T: (hd, t)
        self.v_cache = np.zeros((0, hd), np.int64)     # V:   (t, hd)

    @property
    def t(self) -> int:
        """Positions decoded so far (== both KV cache lengths)."""
        return self.v_cache.shape[0]

    def _qfix(self, x: np.ndarray, scale: float) -> np.ndarray:
        q = np.round(np.asarray(x, np.float32) / scale)
        return np.clip(q, -self.qmax - 1, self.qmax).astype(np.int64)

    def _cal(self, attr: str, x: np.ndarray) -> float:
        """First step: calibrate the scale; later steps: reuse it."""
        if getattr(self, attr) is None:
            amax = max(float(np.abs(x).max()), 1e-8)
            setattr(self, attr, amax / self.qmax)
        return getattr(self, attr)

    def decode_step(self, x_t):
        """One decode position: x_t ``(d,)`` or ``(1, d)`` float.

        Returns ``(y (1, d) float32, step stats dict)`` -- the stats
        are this step's session bucket (fetches, kv appends, costs).
        """
        if self.t >= self.window:
            raise ValueError(f"KV window exhausted ({self.window})")
        x = np.asarray(x_t, np.float32).reshape(1, self.d)
        step = self.session.begin_step()
        qx = self._qfix(x, self._cal("sx", x))

        qkv = fabric_fused_matmul(
            qx, (self._qwq, self._qwk, self._qwv), nbits=self.bits,
            cfg=self.cfg, signed=True, names=("wq", "wk", "wv"),
            session=self.session, device=self.device)
        q_f = qkv.outs[0] * (self.sx * self.swq)
        k_f = qkv.outs[1] * (self.sx * self.swk)
        v_f = qkv.outs[2] * (self.sx * self.swv)

        qq = self._qfix(q_f, self._cal("sq", q_f))
        qk = self._qfix(k_f, self._cal("sk", k_f))
        qv = self._qfix(v_f, self._cal("sv", v_f))
        # append this position's K column / V row -- grows IN PLACE on
        # the fabric (the host mirror grows for the next launch's pack)
        self.k_cache = np.hstack([self.k_cache, qk.T])
        self.v_cache = np.vstack([self.v_cache, qv])
        self.session.kv_append("k")
        self.session.kv_append("v")
        t = self.t

        scores = fabric_fused_matmul(
            qq, (self.k_cache,), nbits=self.bits, cfg=self.cfg,
            signed=True,
            specs=(GemmSpec("scores", 1, self.hd, t,
                            kv="k", kv_axis="n"),),
            session=self.session, device=self.device)
        s_f = scores.outs[0] * (self.sq * self.sk * self.hd ** -0.5)
        e = np.exp(s_f - s_f.max(axis=-1, keepdims=True))
        p = e / e.sum(axis=-1, keepdims=True)
        qp = self._qfix(p, self.sp)

        av = fabric_fused_matmul(
            qp, (self.v_cache,), nbits=self.bits, cfg=self.cfg,
            signed=True,
            specs=(GemmSpec("av", 1, t, self.hd, kv="v", kv_axis="k"),),
            session=self.session, device=self.device)
        a_f = av.outs[0] * (self.sp * self.sv)

        qa = self._qfix(a_f, self._cal("so", a_f))
        proj = fabric_fused_matmul(
            qa, (self._qwo,), nbits=self.bits, cfg=self.cfg,
            signed=True, names=("wo",), session=self.session,
            device=self.device)
        y = (proj.outs[0] * (self.so * self.swo)).astype(np.float32)
        return y, step

    def report(self) -> dict:
        """Session stats + trajectory (cold vs steady-state)."""
        return self.session.stats()


class FabricLinearProbe:
    """Run one decode step's linear projection(s) on the simulated fabric.

    Attached to :class:`repro.serve.engine.ServeEngine`, the probe takes
    the engine's *live* per-step activations (the token embeddings of
    the batch being decoded), quantizes activations and weights to
    ``bits``, and runs the projection as a fabric-scheduled GEMM --
    i.e. a small slice of a real decode step executes on the
    cycle-accurate block grid, with a cost report per step.

    ``w`` may be a single ``(d_in, d_out)`` weight or a *sequence* of
    them sharing ``d_in`` (the Q/K/V/... projections of one layer): a
    multi-weight probe runs the whole decode step's projections as ONE
    fused :class:`FabricProgram` -- shared activation residency, one
    grid allocation, one batched launch -- and ``observe`` returns a
    tuple of outputs.

    The fabric simulator is an oracle, not a serving fast path, so the
    probe only samples the first ``max_steps`` decode steps.

    ``autotune=True`` runs :func:`search_program` on the first observed
    activation shape and serves every sampled step from the argmin
    program -- serving picks its grid split and placement
    automatically.  The search is restricted to the probe's own block
    geometry by default (split/placement sweep only: executing a new
    geometry would compile a new program mid-serve); pass
    ``search_geometries`` to widen it.

    ``session=True`` gives the probe its own :class:`FabricSession`
    spanning the whole serve loop (pass an existing session to share
    one): each ``observe`` becomes a session *step*, so the probe's
    stationary weights go resident at step 1 and steps 2..N schedule
    warm -- ``report()`` then carries the cold-vs-steady trajectory.
    Outputs stay bit-identical to the sessionless probe.  The fabric
    runs on ``device`` (``None``: the GPU).
    """

    def __init__(self, w, cfg: FabricConfig = FabricConfig(),
                 bits: int = 8, max_steps: int = 1,
                 autotune: bool = False,
                 search_geometries: Optional[tuple] = None,
                 faults: Optional[faults_core.FaultModel] = None,
                 session=None, device=None):
        self.device = engine.resolve_device(device)
        ws = list(w) if isinstance(w, (list, tuple)) else [w]
        self.ws = tuple(np.asarray(wi, np.float32) for wi in ws)
        self.fused = isinstance(w, (list, tuple))
        for wi in self.ws:
            if wi.ndim != 2 or wi.shape[0] != self.ws[0].shape[0]:
                raise ValueError(
                    f"probe weights must be 2-D and share d_in, got "
                    f"{[tuple(x.shape) for x in self.ws]}")
        self.cfg = cfg
        self.bits = bits
        self.max_steps = max_steps
        self.autotune = autotune
        self.search_geometries = search_geometries
        self.search: Optional[SearchResult] = None
        self.costs: list = []
        self.outputs: list = []
        # per-step observed batch rows (the GEMM's M): under continuous
        # batching the engine feeds only ACTIVE lanes, so this traces
        # the live-batch size as slots recycle (docs/serve.md)
        self.observed_m: list = []
        # stationary weights quantize ONCE -- the session residency
        # contract (stable name = stable weight) and less per-step host
        # work for sessionless probes too
        self._qws, self._sws = zip(
            *(_quantize_sym(wi, self.bits) for wi in self.ws))
        self.session: Optional[FabricSession] = (
            FabricSession(cfg) if session is True else session)
        # fault path: inject via `faults` and cross-check every fabric
        # output against the cheap host int matmul of the SAME quantized
        # operands -- an exact oracle, so any escaped corruption is
        # caught at the serving boundary and raised as FabricFaultError
        # (the ServeEngine's retry/fallback cue) instead of silently
        # wrong tokens.
        self.faults = faults
        self.escaped_outputs = 0

    @property
    def w(self) -> np.ndarray:
        """Legacy single-weight accessor."""
        return self.ws[0]

    @property
    def done(self) -> bool:
        return len(self.costs) >= self.max_steps

    def _program_for(self, M: int, K: int) -> Optional[FabricProgram]:
        if not self.autotune:
            return None
        specs = tuple(GemmSpec(f"proj{g}", M, K, wi.shape[1])
                      for g, wi in enumerate(self.ws))
        if self.search is None or self.search.schedule.gemms != specs:
            geoms = self.search_geometries if self.search_geometries \
                is not None else ((self.cfg.rows, self.cfg.cols),)
            self.search = search_program(specs, self.bits, base=self.cfg,
                                         signed=True, geometries=geoms)
        return self.search.schedule

    def observe(self, x):
        """x: (B, d_in) float activation of the current decode step.

        Returns the probe's dequantized projection output: one array for
        a single-weight probe, a tuple (one per projection) for a fused
        probe; ``None`` once ``max_steps`` steps have been sampled.
        """
        if self.done:
            return None
        x = np.asarray(x, np.float32)
        qx, sx = _quantize_sym(x, self.bits)
        qws, sws = self._qws, self._sws
        prog = self._program_for(qx.shape[0], qx.shape[1])
        fm = self.faults if (self.faults is not None
                             and self.faults.active) else None
        if self.session is not None:
            self.session.begin_step()
        res = fabric_fused_matmul(qx, qws, nbits=self.bits, cfg=self.cfg,
                                  signed=True, program=prog, faults=fm,
                                  names=tuple(f"proj{g}" for g
                                              in range(len(self.ws))),
                                  session=self.session, device=self.device)
        if fm is not None:
            for g, (qw, out) in enumerate(zip(qws, res.outs)):
                expect = qx.astype(np.int64) @ np.asarray(qw, np.int64)
                if not np.array_equal(np.asarray(out, np.int64), expect):
                    fm.escaped += 1
                    self.escaped_outputs += 1
                    raise FabricFaultError(
                        f"escaped corruption: fabric projection {g} "
                        f"disagrees with the host oracle")
        ys = tuple(out.astype(np.float32) * (sx * sw)
                   for out, sw in zip(res.outs, sws))
        y = ys if self.fused else ys[0]
        self.costs.append(res.cost)
        self.outputs.append(y)
        self.observed_m.append(int(qx.shape[0]))
        return y

    def observe_ref(self, x):
        """The probe's projections on the host (``mode="ref"``): the
        graceful-degradation fallback when the fabric keeps faulting.
        Same quantization, no fabric execution, no cost sample."""
        x = np.asarray(x, np.float32)
        qx, sx = _quantize_sym(x, self.bits)
        ys = []
        for qw, sw in zip(self._qws, self._sws):
            ys.append((qx.astype(np.int64) @ qw).astype(np.float32)
                      * (sx * sw))
        return tuple(ys) if self.fused else ys[0]

    def config_summary(self) -> dict:
        """The grid the probe actually serves from (autotuned or not)."""
        cfg = self.search.schedule.cfg if self.search is not None else self.cfg
        return {
            "geometry": f"{cfg.rows}x{cfg.cols}",
            "n_blocks": cfg.n_blocks,
            "min_compute": cfg.min_compute_blocks,
            "placement": cfg.placement,
            "projections": len(self.ws),
            "autotuned": self.search is not None,
        }

    def report(self) -> Optional[dict]:
        if not self.costs:
            return None
        rep = combine_costs("fabric/decode_step", self.costs).report()
        rep.update(self.config_summary())
        rep["observed_m"] = list(self.observed_m)
        if self.session is not None and self.session.steps:
            rep["session"] = self.session.trajectory().report()
        if self.faults is not None:
            rep["faults"] = self.faults.stats()
            rep["escaped_outputs"] = self.escaped_outputs
        return rep


def combine_costs(name: str, costs) -> costmodel.ScheduleCost:
    """Sum a list of :class:`ScheduleCost` (sequential launches)."""
    if not costs:
        raise ValueError("no costs to combine")
    c0 = costs[0]
    return costmodel.ScheduleCost(
        name=name, n_blocks=c0.n_blocks,
        n_compute=max(c.n_compute for c in costs),
        n_storage=max(c.n_storage for c in costs),
        rounds=sum(c.rounds for c in costs),
        compute_block_cycles=sum(c.compute_block_cycles for c in costs),
        round_cycles=sum(c.round_cycles for c in costs),
        storage_rows_touched=sum(c.storage_rows_touched for c in costs),
        fabric_bits_moved=sum(c.fabric_bits_moved for c in costs),
        spill_bits_moved=sum(c.spill_bits_moved for c in costs),
        ops=sum(c.ops for c in costs),
        energy_compute_pj=sum(c.energy_compute_pj for c in costs),
        energy_storage_pj=sum(c.energy_storage_pj for c in costs),
        energy_wire_pj=sum(c.energy_wire_pj for c in costs),
        # sequential launches: serial latencies add; overlap only exists
        # within each schedule, so the pipelined latencies add too
        serial_cycles=sum(c.serial_cycles_ for c in costs),
        overlapped_cycles=sum(c.overlapped_cycles_ for c in costs),
        fabric_bit_mm=sum(c.fabric_bit_mm for c in costs),
        spill_bit_mm=sum(c.spill_bit_mm for c in costs))
