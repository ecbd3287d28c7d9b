"""Area / frequency / energy / timing model (paper §IV-B, §IV-C, §V).

The paper evaluates Compute RAMs with VTR + COFFE + OpenRAM + Synopsys DC
at 22 nm.  None of those tools run here, so this module encodes their
*measured outputs* (Table II) as hardware constants and reimplements the
paper's energy/timing methodology on top:

* transistor (dynamic) energy: activity factor 0.1, energy proportional
  to transistor count derived from block area (§IV-C);
* wire energy: fJ/mm/bit numbers in the style of Keckler et al. [30]
  scaled to 22 nm, times bits moved, times VTR-style average net length;
* baseline-FPGA circuit composition: 1 BRAM + enough LB/DSP compute units
  to saturate the BRAM's 40-bit row bandwidth + LB control (§IV-C);
* Compute RAM circuit: a single block; cycle counts come from *executing
  the actual instruction sequences* (``repro.core.programs``).

Every constant is named and documented so the derivation chain from the
paper is auditable.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block-level constants (Table II, 22 nm)
# ---------------------------------------------------------------------------
AREA_LB_UM2 = 1938.0
AREA_DSP_UM2 = 12433.0
AREA_BRAM_UM2 = 8311.0

# Compute RAM component breakdown (§IV-B: BRAM + OpenRAM 4Kb imem +
# DC-synthesized controller & peripherals + 15% place&route overhead).
AREA_IMEM_UM2 = 1200.0
AREA_CTRL_UM2 = 700.0
AREA_PERIPH_UM2 = 501.3
PNR_OVERHEAD = 1.15
AREA_CR_UM2 = AREA_BRAM_UM2 + PNR_OVERHEAD * (
    AREA_IMEM_UM2 + AREA_CTRL_UM2 + AREA_PERIPH_UM2)   # = 11072.5

FREQ_BRAM_MHZ = 922.9
# compute mode: ~33% slower (lowered word-line voltage + same-cycle
# read/write, from the Jeloka prototype; §IV-B), ~3% peripherals included.
CR_COMPUTE_SLOWDOWN = 0.66
FREQ_CR_MHZ = FREQ_BRAM_MHZ * CR_COMPUTE_SLOWDOWN      # = 609.1
FREQ_DSP_FIXED_MHZ = 391.8
FREQ_DSP_FLOAT_MHZ = 336.4

# VTR-reported *circuit* frequencies (paper §V-B: Compute RAM circuits run
# 60-65% faster because few long interconnect paths remain).
FREQ_CIRCUIT_CR_MHZ = 606.0          # short paths outside the block only
FREQ_CIRCUIT_BASE_FIXED_MHZ = 374.0  # LB/DSP/BRAM paths through the fabric
FREQ_CIRCUIT_BASE_FLOAT_MHZ = 325.0

# Paper-reported per-block throughput constants for baseline blocks
# (Table II; vendor/VTR-derived, not re-derivable here).
GOPS_DSP = {"int4": 0.7, "int8": 0.5, "bf16": 0.2}
GOPS_LB = {"int4": 1.4, "int8": 0.6}

# ---------------------------------------------------------------------------
# Energy constants (22 nm)
# ---------------------------------------------------------------------------
ACTIVITY = 0.1                       # §IV-C
# Compute mode activates two word lines + a write-back every cycle plus
# all column peripherals; its effective switching activity is higher than
# the storage-mode 0.1.  Calibrated so the int-add energy ratio (where our
# cycle counts match the paper's exactly) lands on the paper's ~20%.
COMPUTE_MODE_ACTIVITY_FACTOR = 2.5
TR_PER_UM2_SRAM = 40.0               # 6T bit cells dominate
TR_PER_UM2_LOGIC = 8.0
E_PER_TR_FJ = 0.05                   # C_eff ~0.08 fF at V=0.8 V
# Keckler et al. [30]-style wire energy scaled to 22 nm; FPGA interconnect
# multiplies by a switch factor (pass transistors + buffers per segment).
WIRE_FJ_PER_BIT_MM = 34.0
FPGA_SWITCH_FACTOR = 4.0
NET_LENGTH_BASE_MM = 0.60            # VTR-style average net length, baseline
NET_LENGTH_CR_MM = 0.08              # only mode/start/done + host control
# Fabric-level operand movement (schedule roll-up): a storage-mode block
# feeding a compute-mode block is a short block-to-block hop; operands
# spilled to off-fabric memory ride the long I/O column nets.
NET_LENGTH_FABRIC_MM = 0.30
NET_LENGTH_SPILL_MM = 1.20
# Topology-aware wire model: blocks sit at (row, col) sites on the grid
# (FabricConfig.site) and every operand move is priced by the Manhattan
# hop count between the actual sites -- NET_LENGTH_HOP_MM is the wire
# length of ONE hop between adjacent sites.  Two hops equal the old
# average fabric net (NET_LENGTH_FABRIC_MM), so flat and hop-based
# pricing agree for a typical small grid and diverge as the grid --
# and therefore its diameter -- grows.
NET_LENGTH_HOP_MM = 0.15

GEOMETRIES = {(512, 40): "512x40", (1024, 20): "1024x20",
              (2048, 10): "2048x10"}
BRAM_BITS = 20 * 1024
BRAM_ROW_BITS = 40
BRAM_ROWS = 512


def _transistors(area_um2: float, sram_fraction: float) -> float:
    return area_um2 * (sram_fraction * TR_PER_UM2_SRAM
                       + (1 - sram_fraction) * TR_PER_UM2_LOGIC)


def block_energy_per_cycle_fj(area_um2: float, sram_fraction: float) -> float:
    """Dynamic transistor energy of one block for one active cycle."""
    return ACTIVITY * _transistors(area_um2, sram_fraction) * E_PER_TR_FJ


def wire_energy_fj(bits: float, net_length_mm: float) -> float:
    return bits * net_length_mm * WIRE_FJ_PER_BIT_MM * FPGA_SWITCH_FACTOR


def hop_net_length_mm(hops: float) -> float:
    """Wire length of one fabric net spanning ``hops`` Manhattan hops.

    Monotone (non-decreasing) in the hop count, and never shorter than
    one hop: even adjacent blocks pay one switch-box crossing.  The
    schedule roll-up uses this to price each load/broadcast/drain by the
    *actual* distance between the block sites involved, instead of one
    average net length -- the topology-aware half of the paper's
    data-movement claim (wires, not arithmetic, are the expensive
    resource at the fabric level).
    """
    return max(1.0, float(hops)) * NET_LENGTH_HOP_MM


def wire_energy_bit_mm_fj(bit_mm: float) -> float:
    """Wire energy of an arbitrary bits-times-millimetres total.

    Same Keckler-style constants as :func:`wire_energy_fj`; callers that
    price every net by its own length (hop-based schedules) accumulate
    ``bits * mm`` per move and convert once here.
    """
    return bit_mm * WIRE_FJ_PER_BIT_MM * FPGA_SWITCH_FACTOR


# ---------------------------------------------------------------------------
# Circuit designs (paper §IV-C): what gets instantiated on each FPGA
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CircuitCost:
    """Area/energy/time of one mapped circuit."""
    name: str
    area_um2: float
    cycles: float
    freq_mhz: float
    energy_pj: float
    ops: int

    @property
    def time_us(self) -> float:
        return self.cycles / self.freq_mhz

    @property
    def energy_per_op_pj(self) -> float:
        return self.energy_pj / max(self.ops, 1)

    @property
    def time_per_op_ns(self) -> float:
        return 1e3 * self.time_us / max(self.ops, 1)


# bits per tuple stored in the BRAM for each op/precision (operands+result)
def tuple_bits(op: str, precision: str) -> int:
    n = {"int4": 4, "int8": 8, "bf16": 16}[precision]
    if op == "add":
        return 3 * n
    if op == "mul":
        return 2 * n + (2 * n if precision != "bf16" else n)
    if op == "dot":
        return 2 * n          # accumulator lives in registers / acc rows
    raise ValueError(op)


@dataclasses.dataclass(frozen=True)
class BaselineDesign:
    """Baseline FPGA circuit: 1 BRAM + compute + control (paper §IV-C)."""
    op: str
    precision: str
    n_dsp: int
    n_lb_compute: int
    n_lb_control: int = 4
    pipeline_depth: int = 4

    def cost(self) -> CircuitCost:
        tb = tuple_bits(self.op, self.precision)
        tuples_per_row = max(1, BRAM_ROW_BITS // tb)
        rows_per_tuple = max(1, math.ceil(tb / BRAM_ROW_BITS))
        if tuples_per_row >= 1 and tb <= BRAM_ROW_BITS:
            n_ops = tuples_per_row * BRAM_ROWS
            rows_touched = BRAM_ROWS
        else:
            n_ops = BRAM_ROWS // rows_per_tuple
            rows_touched = BRAM_ROWS
        # dual-ported BRAM: read stream and write-back stream overlap
        cycles = rows_touched + self.pipeline_depth
        if self.op == "dot":
            # operands only (results accumulate in registers): the paper's
            # int4 example reads 480 operand rows and takes ~480 cycles.
            rows_touched = math.ceil(n_ops * tb / BRAM_ROW_BITS)
            cycles = rows_touched + self.pipeline_depth

        freq = (FREQ_CIRCUIT_BASE_FLOAT_MHZ if self.precision == "bf16"
                else FREQ_CIRCUIT_BASE_FIXED_MHZ)
        area = (AREA_BRAM_UM2 + self.n_dsp * AREA_DSP_UM2
                + (self.n_lb_compute + self.n_lb_control) * AREA_LB_UM2)

        # energy: every active cycle, all blocks toggle at ACTIVITY and a
        # full row (+ result writeback) moves through the interconnect.
        e_blocks = (block_energy_per_cycle_fj(AREA_BRAM_UM2, 0.9)
                    + self.n_dsp * block_energy_per_cycle_fj(AREA_DSP_UM2, 0.0)
                    + (self.n_lb_compute + self.n_lb_control)
                    * block_energy_per_cycle_fj(AREA_LB_UM2, 0.0))
        bits_moved = BRAM_ROW_BITS * 2        # operands out + results back
        e_wire = wire_energy_fj(bits_moved, NET_LENGTH_BASE_MM)
        energy_pj = cycles * (e_blocks + e_wire) / 1e3
        return CircuitCost(
            f"baseline/{self.op}/{self.precision}", area, cycles, freq,
            energy_pj, n_ops)


@dataclasses.dataclass(frozen=True)
class ComputeRamDesign:
    """One Compute RAM block running a generated instruction sequence.

    ``cols`` other than 40 model the paper's §V-D exploration of wider,
    shallower geometries (72 columns, Xilinx-style) for the *same* 20 Kb
    capacity: rows shrink accordingly, the block area/energy change only
    marginally (more sense amps / peripherals), parallelism grows.
    """
    op: str
    precision: str
    cols: int = 40
    rows: int | None = None
    n_lb_control: int = 1      # small host FSM asserting mode/start

    def cost(self) -> CircuitCost:
        from . import programs
        rows = self.rows if self.rows is not None else BRAM_BITS // self.cols
        gen = programs.GENERATORS[(self.op, self.precision)]
        prog, layout = gen(rows=rows)
        cycles = prog.cycles()
        n_ops = layout.tuples * self.cols
        periph_scale = 1.0 + 0.06 * (self.cols / 40.0 - 1.0)
        area = AREA_CR_UM2 * periph_scale + self.n_lb_control * AREA_LB_UM2
        e_block = COMPUTE_MODE_ACTIVITY_FACTOR * \
            block_energy_per_cycle_fj(AREA_CR_UM2 * periph_scale, 0.75)
        e_wire = wire_energy_fj(4, NET_LENGTH_CR_MM)   # mode/start/done only
        energy_pj = cycles * (e_block + e_wire) / 1e3
        return CircuitCost(
            f"compute_ram/{self.op}/{self.precision}/{self.cols}col",
            area, cycles, FREQ_CIRCUIT_CR_MHZ, energy_pj, n_ops)


# canonical baseline compositions per paper §IV-C --------------------------
BASELINES = {
    ("add", "int4"): BaselineDesign("add", "int4", n_dsp=0, n_lb_compute=3),
    ("add", "int8"): BaselineDesign("add", "int8", n_dsp=0, n_lb_compute=1),
    ("add", "bf16"): BaselineDesign("add", "bf16", n_dsp=1, n_lb_compute=0),
    ("mul", "int4"): BaselineDesign("mul", "int4", n_dsp=2, n_lb_compute=0),
    ("mul", "int8"): BaselineDesign("mul", "int8", n_dsp=1, n_lb_compute=0),
    ("mul", "bf16"): BaselineDesign("mul", "bf16", n_dsp=1, n_lb_compute=0),
    # dot: 5 int4 multipliers + 4-deep int32 adder tree (paper §V-D)
    ("dot", "int4"): BaselineDesign("dot", "int4", n_dsp=5, n_lb_compute=8),
    ("dot", "int8"): BaselineDesign("dot", "int8", n_dsp=2, n_lb_compute=8),
    # bf16 dot: 2 float DSP slices (mul + acc) + adder-tree glue -- the
    # paper's float column; the CR side runs floatprog.float_dot
    ("dot", "bf16"): BaselineDesign("dot", "bf16", n_dsp=2, n_lb_compute=8),
}


def compare(op: str, precision: str, cr_cols: int = 40) -> dict:
    """Baseline vs Compute RAM for one operation (one paper figure bar)."""
    base = BASELINES[(op, precision)].cost()
    cr = ComputeRamDesign(op, precision, cols=cr_cols).cost()
    return {
        "op": op, "precision": precision, "cols": cr_cols,
        "baseline": base, "compute_ram": cr,
        "area_ratio": cr.area_um2 / base.area_um2,
        "energy_ratio": (cr.energy_per_op_pj / base.energy_per_op_pj),
        "time_ratio": cr.time_per_op_ns / base.time_per_op_ns,
        "freq_gain": cr.freq_mhz / base.freq_mhz - 1.0,
    }


# ---------------------------------------------------------------------------
# Schedule-level roll-up (fabric scheduler, paper §IV/§V): many blocks,
# some in storage mode holding operands, some in compute mode executing
# instruction sequences, cooperating on one workload.  ``repro.pim.fabric``
# counts *events* (cycles, rows touched, bits moved); this section turns
# the counts into energy/time with the same constants as the per-block
# model, so per-block and fabric numbers are directly comparable.
# ---------------------------------------------------------------------------
# Storage-mode row accesses run at the (faster) BRAM frequency; one row
# access therefore costs this many CR-circuit-frequency cycle
# equivalents.  Having one cycle unit lets serial and overlapped latency
# be compared directly.
STORAGE_ROW_CR_CYCLES = FREQ_CIRCUIT_CR_MHZ / FREQ_BRAM_MHZ


@dataclasses.dataclass(frozen=True)
class ScheduleCost:
    """Energy/time roll-up of one executed fabric schedule."""
    name: str
    n_blocks: int                 # grid size
    n_compute: int                # blocks in compute mode
    n_storage: int                # blocks in storage mode
    rounds: int                   # serialized execute_blocks launches
    compute_block_cycles: float   # sum over (active block, cycle) pairs
    round_cycles: float           # critical-path compute cycles (per round
    #                               blocks run in parallel -> max, summed)
    storage_rows_touched: float   # storage-mode row reads/writes (loads +
    #                               readback), across all blocks
    fabric_bits_moved: float      # operand/result bits on block-to-block nets
    spill_bits_moved: float       # bits to/from off-fabric memory
    ops: int                      # useful MACs (padding excluded)
    energy_compute_pj: float
    energy_storage_pj: float
    energy_wire_pj: float
    # Latency model (CR-circuit-frequency cycle units; storage rows are
    # converted via STORAGE_ROW_CR_CYCLES).  ``serial_cycles`` is every
    # round's load + compute + drain laid end to end -- identical to the
    # legacy ``time_us`` roll-up by construction.  ``overlapped_cycles``
    # is the double-buffered pipeline: round i+1's operand loads (and
    # round i's accumulator drain) hide behind round i's compute.  0.0
    # means "not modeled" (roll-ups that never saw per-round structure);
    # accessors fall back to the serial number.
    serial_cycles: float = 0.0
    overlapped_cycles: float = 0.0
    # Hop-priced wire totals (bits x mm, summed per net over the actual
    # Manhattan distances between block sites).  0.0 means "not modeled"
    # (roll-ups without placement information); the wire-energy term then
    # uses bits x the flat average net lengths above.
    fabric_bit_mm: float = 0.0
    spill_bit_mm: float = 0.0

    @property
    def energy_pj(self) -> float:
        return (self.energy_compute_pj + self.energy_storage_pj
                + self.energy_wire_pj)

    @property
    def time_us(self) -> float:
        """Compute rounds serialize at the compute-mode frequency; data
        movement overlaps row-by-row with storage-mode accesses at the
        (faster) storage frequency."""
        return (self.round_cycles / FREQ_CIRCUIT_CR_MHZ
                + self.storage_rows_touched / FREQ_BRAM_MHZ)

    @property
    def serial_cycles_(self) -> float:
        """serial_cycles, falling back to the legacy roll-up when the
        schedule walk did not provide per-round structure."""
        if self.serial_cycles > 0:
            return self.serial_cycles
        return (self.round_cycles
                + self.storage_rows_touched * STORAGE_ROW_CR_CYCLES)

    @property
    def overlapped_cycles_(self) -> float:
        return (self.overlapped_cycles if self.overlapped_cycles > 0
                else self.serial_cycles_)

    @property
    def time_us_overlapped(self) -> float:
        return self.overlapped_cycles_ / FREQ_CIRCUIT_CR_MHZ

    @property
    def overlap_speedup(self) -> float:
        return self.serial_cycles_ / max(self.overlapped_cycles_, 1e-12)

    @property
    def energy_per_op_pj(self) -> float:
        return self.energy_pj / max(self.ops, 1)

    @property
    def gops(self) -> float:
        return self.ops / max(self.time_us, 1e-12) / 1e3

    def report(self) -> dict:
        """Flat summary (benchmarks / examples / JSON artifacts)."""
        return {
            "name": self.name, "blocks": self.n_blocks,
            "compute": self.n_compute, "storage": self.n_storage,
            "rounds": self.rounds, "ops": self.ops,
            "energy_pj": round(self.energy_pj, 3),
            "energy_compute_pj": round(self.energy_compute_pj, 3),
            "energy_storage_pj": round(self.energy_storage_pj, 3),
            "energy_wire_pj": round(self.energy_wire_pj, 3),
            "time_us": round(self.time_us, 4),
            "serial_cycles": round(self.serial_cycles_, 1),
            "overlapped_cycles": round(self.overlapped_cycles_, 1),
            "time_us_overlapped": round(self.time_us_overlapped, 4),
            "overlap_speedup": round(self.overlap_speedup, 3),
            "energy_per_op_pj": round(self.energy_per_op_pj, 4),
            "gops": round(self.gops, 3),
            "fabric_bit_mm": round(self.fabric_bit_mm, 3),
            "spill_bit_mm": round(self.spill_bit_mm, 3),
            "avg_hop_mm": round(
                self.fabric_bit_mm / self.fabric_bits_moved, 4)
            if self.fabric_bit_mm > 0 and self.fabric_bits_moved > 0 else 0.0,
        }


def schedule_cost_rollup(name: str, *, n_blocks: int, n_compute: int,
                         n_storage: int, rounds: int,
                         compute_block_cycles: float, round_cycles: float,
                         storage_rows_touched: float,
                         fabric_bits_moved: float, spill_bits_moved: float,
                         ops: int, serial_cycles: float = 0.0,
                         overlapped_cycles: float = 0.0,
                         fabric_bit_mm: float = 0.0,
                         spill_bit_mm: float = 0.0) -> ScheduleCost:
    """Price a fabric schedule's event counts (see :class:`ScheduleCost`).

    * compute energy: every (active compute block, cycle) pair burns the
      compute-mode block energy (elevated activity factor, §IV-C);
    * storage energy: each storage-mode row access costs one cycle of a
      block at storage activity (0.1) -- the BRAM-like half of the
      dual-mode claim;
    * wire energy: operand/result bits times the wire length they cross,
      Keckler-style.  When the caller prices every net by its actual
      Manhattan distance (``fabric_bit_mm`` / ``spill_bit_mm`` > 0,
      bits x mm accumulated per move -- the topology-aware wire model),
      those totals are used directly; otherwise bits times the flat
      average net lengths (``NET_LENGTH_FABRIC_MM`` /
      ``NET_LENGTH_SPILL_MM``) -- the pre-placement fallback.

    ``serial_cycles`` / ``overlapped_cycles`` carry the per-round
    pipeline latency model when the caller walked the round structure
    (:func:`repro.pim.fabric.schedule_cost`); left at 0.0, the
    :class:`ScheduleCost` accessors fall back to the serial roll-up.
    """
    e_cr_compute = COMPUTE_MODE_ACTIVITY_FACTOR * \
        block_energy_per_cycle_fj(AREA_CR_UM2, 0.75)
    e_cr_storage = block_energy_per_cycle_fj(AREA_CR_UM2, 0.9)
    e_wire_fabric = (wire_energy_bit_mm_fj(fabric_bit_mm)
                     if fabric_bit_mm > 0 else
                     wire_energy_fj(fabric_bits_moved, NET_LENGTH_FABRIC_MM))
    e_wire_spill = (wire_energy_bit_mm_fj(spill_bit_mm)
                    if spill_bit_mm > 0 else
                    wire_energy_fj(spill_bits_moved, NET_LENGTH_SPILL_MM))
    return ScheduleCost(
        name=name, n_blocks=n_blocks, n_compute=n_compute,
        n_storage=n_storage, rounds=rounds,
        compute_block_cycles=compute_block_cycles,
        round_cycles=round_cycles,
        storage_rows_touched=storage_rows_touched,
        fabric_bits_moved=fabric_bits_moved,
        spill_bits_moved=spill_bits_moved, ops=ops,
        energy_compute_pj=compute_block_cycles * e_cr_compute / 1e3,
        energy_storage_pj=storage_rows_touched * e_cr_storage / 1e3,
        energy_wire_pj=(e_wire_fabric + e_wire_spill) / 1e3,
        serial_cycles=serial_cycles, overlapped_cycles=overlapped_cycles,
        fabric_bit_mm=fabric_bit_mm, spill_bit_mm=spill_bit_mm,
    )


def fault_cost(name: str, *, n_blocks: int, cols: int, parity_bits: float,
               scrub_rows: float, refetch_bits: float,
               edge_hops: float = 1.0) -> ScheduleCost:
    """Price fault-tolerance overhead as a :class:`ScheduleCost`.

    The fault subsystem (``repro.core.faults``, docs/faults.md) adds
    three kinds of honest overhead on top of a schedule's own roll-up:

    * **parity storage**: the 2-D parity signature of every protected
      block (``rows + cols`` bits each) is written once at load time --
      ``ceil(parity_bits / cols)`` storage-mode row writes plus the bits
      crossing the fabric to the parity words;
    * **scrub reads**: every scrub pass re-reads the rows it verifies
      (``scrub_rows`` storage-mode row reads, at BRAM frequency);
    * **re-fetch traffic**: a dirty tile is evicted and re-fetched from
      its backing store -- ``refetch_bits`` moved across the fabric
      (priced at ``edge_hops`` Manhattan hops, the conservative
      worst-case span) plus the row writes to land them.

    All three are storage/wire costs -- detection and repair burn no
    compute-mode cycles.  Combine with the schedule's own cost via
    :func:`repro.pim.fabric.combine_costs` (sequential: the scrub stage
    serializes with the rounds it protects).
    """
    row_bits = max(int(cols), 1)
    rows_touched = (float(scrub_rows)
                    + math.ceil(parity_bits / row_bits)
                    + math.ceil(refetch_bits / row_bits))
    moved = float(parity_bits + refetch_bits)
    serial = rows_touched * STORAGE_ROW_CR_CYCLES
    return schedule_cost_rollup(
        name, n_blocks=n_blocks, n_compute=0, n_storage=0, rounds=0,
        compute_block_cycles=0.0, round_cycles=0.0,
        storage_rows_touched=rows_touched,
        fabric_bits_moved=moved, spill_bits_moved=0.0, ops=0,
        serial_cycles=serial, overlapped_cycles=serial,
        fabric_bit_mm=moved * hop_net_length_mm(edge_hops))


def kv_append_cost(name: str, *, n_blocks: int, cols: int, bits: float,
                   edge_hops: float = 1.0,
                   spilled: bool = False) -> ScheduleCost:
    """Price appending ``bits`` of new KV-cache entries into a storage
    block (the on-fabric KV cache of a :class:`repro.pim.fabric`
    session).

    An append is the *write half* of a fetch: the new entries cross the
    fabric from the host edge to the cache's home block (``edge_hops``
    Manhattan hops; the spill path when the cache did not fit on-fabric)
    and land as ``ceil(bits / cols)`` storage-mode row writes.  Nothing
    is re-read and no compute-mode cycles burn -- which is exactly the
    session's append-not-refetch claim: the K/V history already resident
    on the grid is never moved again.
    """
    row_bits = max(int(cols), 1)
    rows_touched = float(math.ceil(bits / row_bits))
    serial = rows_touched * STORAGE_ROW_CR_CYCLES
    fabric_bits = 0.0 if spilled else float(bits)
    spill_bits = float(bits) if spilled else 0.0
    return schedule_cost_rollup(
        name, n_blocks=n_blocks, n_compute=0, n_storage=1, rounds=0,
        compute_block_cycles=0.0, round_cycles=0.0,
        storage_rows_touched=rows_touched,
        fabric_bits_moved=fabric_bits, spill_bits_moved=spill_bits, ops=0,
        serial_cycles=serial, overlapped_cycles=serial,
        fabric_bit_mm=fabric_bits * hop_net_length_mm(edge_hops),
        spill_bit_mm=spill_bits * (NET_LENGTH_SPILL_MM
                                   + hop_net_length_mm(edge_hops)))


def _mean(vals) -> float:
    vals = list(vals)
    return sum(vals) / len(vals) if vals else 0.0


@dataclasses.dataclass(frozen=True)
class CostTrajectory:
    """Per-step cost/fetch trajectory of a persistent fabric session.

    One entry per *decode step* (a :meth:`FabricSession.begin_step`
    bucket): the combined :class:`ScheduleCost` of every program the
    step executed, plus the step's operand-fetch counters from the
    schedule IR.  Step 0 is the **cold** step (every weight tile
    fetched); steps 1.. are **steady state** (warm residency), and the
    cold/steady split is the session win the fabric benchmark gates:
    ``steady_fetch_reduction = cold fetches / mean(steady fetches)``.

    ``costs`` entries may be ``None`` for steps that were scheduled but
    never executed (cost samples come from the execution layer).
    """
    name: str
    costs: Tuple[Optional[ScheduleCost], ...]
    fetches: Tuple[int, ...]
    fetch_bits: Tuple[float, ...]
    w_fetches: Tuple[int, ...] = ()
    kv_fetch_bits: Tuple[float, ...] = ()

    @property
    def steps(self) -> int:
        return len(self.fetches)

    @property
    def cold_fetches(self) -> int:
        return self.fetches[0] if self.fetches else 0

    @property
    def steady_fetches(self) -> float:
        return _mean(self.fetches[1:])

    @property
    def steady_fetch_reduction(self) -> float:
        """Cold step-1 fetch count over the steady-state mean (>= 1 when
        residency carries across programs; 1.0 for a single step)."""
        if self.steps < 2:
            return 1.0
        return self.cold_fetches / max(self.steady_fetches, 1e-12)

    @property
    def steady_w_fetch_reduction(self) -> float:
        """Like :attr:`steady_fetch_reduction` for weight fetches only.
        A fully weight-stationary steady state fetches ZERO weights;
        report the cold count then (the reduction is 'all of them')
        so the number stays finite/JSON-able."""
        if self.steps < 2 or not self.w_fetches:
            return 1.0
        steady = _mean(self.w_fetches[1:])
        if steady == 0:
            return float(max(self.w_fetches[0], 1))
        return self.w_fetches[0] / steady

    def _cost_attr(self, idx: int, attr: str) -> float:
        c = self.costs[idx] if idx < len(self.costs) else None
        return float(getattr(c, attr)) if c is not None else 0.0

    @property
    def cold_energy_pj(self) -> float:
        return self._cost_attr(0, "energy_pj")

    @property
    def steady_energy_pj(self) -> float:
        return _mean(self._cost_attr(i, "energy_pj")
                     for i in range(1, self.steps))

    @property
    def cold_overlapped_cycles(self) -> float:
        return self._cost_attr(0, "overlapped_cycles_")

    @property
    def steady_overlapped_cycles(self) -> float:
        return _mean(self._cost_attr(i, "overlapped_cycles_")
                     for i in range(1, self.steps))

    def report(self) -> dict:
        """Flat JSON-able summary (benchmarks / serve artifacts)."""
        rep = {
            "name": self.name,
            "steps": self.steps,
            "per_step_fetches": list(self.fetches),
            "per_step_fetch_bits": [round(b, 1) for b in self.fetch_bits],
            "cold_fetches": self.cold_fetches,
            "steady_fetches": round(self.steady_fetches, 3),
            "steady_fetch_reduction": round(self.steady_fetch_reduction, 3),
        }
        if self.w_fetches:
            rep["per_step_w_fetches"] = list(self.w_fetches)
            rep["steady_w_fetch_reduction"] = round(
                self.steady_w_fetch_reduction, 3)
        if self.kv_fetch_bits:
            rep["per_step_kv_fetch_bits"] = [round(b, 1)
                                             for b in self.kv_fetch_bits]
        if any(c is not None for c in self.costs):
            rep.update({
                "cold_energy_pj": round(self.cold_energy_pj, 3),
                "steady_energy_pj": round(self.steady_energy_pj, 3),
                "cold_overlapped_cycles": round(
                    self.cold_overlapped_cycles, 1),
                "steady_overlapped_cycles": round(
                    self.steady_overlapped_cycles, 1),
            })
        return rep


def cr_throughput_gops(op: str, precision: str, cols: int = 40,
                       rows: int = 512) -> float:
    """Compute RAM throughput from executed instruction sequences."""
    from . import programs
    prog, layout = programs.GENERATORS[(op, precision)](rows=rows)
    ops_per_pass = layout.tuples * cols
    seconds = prog.cycles() / (FREQ_CR_MHZ * 1e6)
    return ops_per_pass / seconds / 1e9
