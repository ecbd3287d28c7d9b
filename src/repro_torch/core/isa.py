"""Compute RAM instruction set (paper §III).

The Compute RAM block executes 16-bit instructions from a 4 Kb instruction
memory (256 instructions).  Instructions are of two kinds (paper §III-A3):

  * array micro-ops -- sent to the main array / per-column logic
    peripherals.  One micro-op per cycle; every column executes it
    simultaneously (bit-line computing + bit-serial arithmetic).
  * controller ops -- executed by the in-block controller (8 registers,
    adder/comparator/logical unit, zero-overhead hardware loops).

We model both levels explicitly:

  * ``Program`` is what sits in the instruction memory: a list of
    ``Instr`` and ``Loop`` nodes.  ``Program.footprint()`` is the number of
    instruction-memory slots used (a hardware loop costs 1 slot for the
    LOOP marker + its body once) -- this validates the paper's claim that
    common operations fit in <= 200 of the 256 slots.
  * ``Program.expand()`` resolves loops and register-relative row
    addressing into the *executed micro-op stream*.  Its length is the
    cycle count (hardware loops have zero branch overhead, so loop
    management contributes no cycles; controller ALU instructions placed
    inside the stream cost 1 cycle each, like in the paper's simple
    pipelined controller).

Row operands may be absolute ints or ``R(reg, offset)`` register-relative
references; registers are maintained by the expansion (the controller).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import List, Sequence, Union

# ---------------------------------------------------------------------------
# Array micro-op opcodes (per-column logic peripherals; 1 cycle each).
# The underlying bit-line primitive senses A.B on BL and ~A.~B on BLB
# (Jeloka et al.); the peripherals derive XOR/OR/full-add from these plus
# the carry and tag latches (Neural Cache-style).
# ---------------------------------------------------------------------------
OP_NOP = 0
OP_COPY = 1    # dst <- row[a]
OP_NOT = 2     # dst <- ~row[a]
OP_AND = 3     # dst <- row[a] & row[b]
OP_OR = 4      # dst <- row[a] | row[b]
OP_XOR = 5     # dst <- row[a] ^ row[b]
OP_NOR = 6     # dst <- ~(row[a] | row[b])
OP_FA = 7      # full add: dst <- a ^ b ^ carry ; carry <- maj(a, b, carry)
OP_FS = 8      # full sub: dst <- a ^ b ^ borrow; borrow <- ~a&b | borrow&~(a^b)
OP_W0 = 9      # dst <- 0
OP_W1 = 10     # dst <- 1
OP_C0 = 11     # carry <- 0
OP_C1 = 12     # carry <- 1
OP_CROW = 13   # carry <- row[a]
OP_CSTORE = 14 # dst <- carry (then carry <- 0)
OP_TC = 15     # tag <- carry
OP_TNC = 16    # tag <- ~carry
OP_TROW = 17   # tag <- row[a]
OP_TNROW = 18  # tag <- ~row[a]
OP_T1 = 19     # tag <- 1
OP_TAND = 20   # tag <- tag & row[a]
OP_TOR = 21    # tag <- tag | row[a]
OP_TSTORE = 22 # dst <- tag
OP_TNOT = 23   # tag <- ~tag

N_ARRAY_OPS = 24

ARRAY_OP_NAMES = {
    OP_NOP: "nop", OP_COPY: "copy", OP_NOT: "not", OP_AND: "and",
    OP_OR: "or", OP_XOR: "xor", OP_NOR: "nor", OP_FA: "fa", OP_FS: "fs",
    OP_W0: "w0", OP_W1: "w1", OP_C0: "c0", OP_C1: "c1", OP_CROW: "crow",
    OP_CSTORE: "cstore", OP_TC: "tc", OP_TNC: "tnc", OP_TROW: "trow",
    OP_TNROW: "tnrow", OP_T1: "t1", OP_TAND: "tand", OP_TOR: "tor",
    OP_TSTORE: "tstore", OP_TNOT: "tnot",
}

#: inverse of :data:`ARRAY_OP_NAMES` -- the corpus text format and the
#: fuzzer's program parser address opcodes by mnemonic.
OP_BY_NAME = {name: op for op, name in ARRAY_OP_NAMES.items()}

# Ops that write an array row (predication masks this write with tag).
_WRITES_ROW = {OP_COPY, OP_NOT, OP_AND, OP_OR, OP_XOR, OP_NOR, OP_FA,
               OP_FS, OP_W0, OP_W1, OP_CSTORE, OP_TSTORE}
# Ops that read row operand ``a`` / ``b``
_READS_A = {OP_COPY, OP_NOT, OP_AND, OP_OR, OP_XOR, OP_NOR, OP_FA, OP_FS,
            OP_CROW, OP_TROW, OP_TNROW, OP_TAND, OP_TOR}
_READS_B = {OP_AND, OP_OR, OP_XOR, OP_NOR, OP_FA, OP_FS}

NUM_REGS = 8       # paper §III-A3: register file of 8 (flip-flop based)
IMEM_SLOTS = 256   # paper §III-A2: 4 Kb / 16-bit = 256 instructions


@dataclasses.dataclass(frozen=True)
class R:
    """Register-relative row reference: row = regs[reg] + offset."""
    reg: int
    offset: int = 0

    def __post_init__(self):
        if not (0 <= self.reg < NUM_REGS):
            raise ValueError(f"register {self.reg} out of range")


RowRef = Union[int, R]


@dataclasses.dataclass(frozen=True)
class Instr:
    """One array micro-op (possibly tag-predicated).

    ``inc`` is a tuple of ``(reg, delta)`` post-increments applied after
    the micro-op executes -- the controller's address-generation unit
    (like DSP AGUs, paper §III-A3 cites DSP processor fundamentals), so
    pointer walks inside hardware loops cost zero extra cycles.
    """
    op: int
    dst: RowRef = 0
    a: RowRef = 0
    b: RowRef = 0
    pred: bool = False
    inc: tuple = ()

    def __repr__(self):
        name = ARRAY_OP_NAMES.get(self.op, f"op{self.op}")
        p = "?t " if self.pred else ""
        return f"<{p}{name} d={self.dst} a={self.a} b={self.b}>"


@dataclasses.dataclass(frozen=True)
class SetReg:
    """Controller op: regs[reg] <- value (1 cycle)."""
    reg: int
    value: int


@dataclasses.dataclass(frozen=True)
class AddReg:
    """Controller op: regs[reg] += delta (1 cycle)."""
    reg: int
    delta: int


@dataclasses.dataclass(frozen=True)
class MovReg:
    """Controller op: regs[dst] <- regs[src] + offset (1 cycle)."""
    dst: int
    src: int
    offset: int = 0


@dataclasses.dataclass(frozen=True)
class Loop:
    """Zero-overhead hardware loop: repeat body ``count`` times.

    Occupies 1 instruction-memory slot (the loop marker) plus the body;
    the repetition itself costs no extra cycles (paper §III-A3, DSP-style
    dedicated hardware loop control).
    """
    count: int
    body: List["Node"]


Node = Union[Instr, SetReg, AddReg, MovReg, Loop]


@dataclasses.dataclass(frozen=True)
class StreamMeta:
    """Static metadata of an expanded micro-op stream.

    This is what the compiled executor (``engine.compile_program``)
    consumes: it bounds the rows a program touches (so geometry
    mismatches fail loudly at compile time instead of silently indexing
    out of range) and summarizes the op mix for diagnostics.
    """
    n_cycles: int                 # array micro-ops executed
    rows_read: frozenset          # absolute rows read as operands
    rows_written: frozenset       # absolute rows written
    max_row: int                  # highest row touched (-1: none)
    uses_pred: bool               # any tag-predicated micro-op?
    op_histogram: tuple           # ((opcode, count), ...) sorted by opcode


def stream_meta(stream: Sequence["Instr"]) -> StreamMeta:
    """Compute :class:`StreamMeta` for an expanded micro-op stream."""
    reads, writes = set(), set()
    hist: dict = {}
    uses_pred = False
    for ins in stream:
        hist[ins.op] = hist.get(ins.op, 0) + 1
        uses_pred = uses_pred or ins.pred
        if ins.op in _READS_A:
            reads.add(ins.a)
        if ins.op in _READS_B:
            reads.add(ins.b)
        if ins.op in _WRITES_ROW:
            writes.add(ins.dst)
            if ins.pred:          # predicated writes read back dst
                reads.add(ins.dst)
    max_row = max(reads | writes, default=-1)
    return StreamMeta(len(stream), frozenset(reads), frozenset(writes),
                      max_row, uses_pred, tuple(sorted(hist.items())))


@dataclasses.dataclass
class Program:
    """A Compute RAM program (contents of the instruction memory)."""
    name: str
    nodes: List[Node]
    # rows the program assumes are scratch (for capacity accounting)
    temp_rows: int = 0

    # -- instruction-memory footprint (slots) -------------------------------
    def footprint(self) -> int:
        def count(nodes: Sequence[Node]) -> int:
            n = 0
            for nd in nodes:
                if isinstance(nd, Loop):
                    n += 1 + count(nd.body)   # LOOP marker + body
                else:
                    n += 1
            return n
        return count(self.nodes) + 1          # +1 for END

    def fits_imem(self) -> bool:
        return self.footprint() <= IMEM_SLOTS

    def imem_images(self) -> int:
        """Instruction-memory images needed to stream this program.

        Every integer program (and the float add/mul sequences) fits the
        paper's single 4 Kb image; the fused float MAC is the first
        library program that does not -- the host FSM would reload the
        imem between segments (a storage-mode row-write burst, amortized
        over every column x tuple of the pass).
        """
        return max(1, math.ceil(self.footprint() / IMEM_SLOTS))

    # -- expansion to the executed micro-op stream --------------------------
    def expand(self) -> List[Instr]:
        """Resolve loops + registers into absolute-row micro-ops.

        The returned list length == cycle count of the array portion;
        controller ALU ops (SetReg/AddReg) each cost 1 cycle and are
        accounted in ``cycles()``.  Memoized: like ``fingerprint()``,
        a Program is frozen once executed -- don't mutate ``nodes``.
        """
        cached = self.__dict__.get("_expanded")
        if cached is None:
            regs = [0] * NUM_REGS
            ctrl = [0]
            cached = self._expand_with(regs, ctrl)
            self._ctrl_cycles = ctrl[0]
            self.__dict__["_expanded"] = cached
        return cached

    def cycles(self) -> int:
        """Total cycles = array micro-ops + controller ALU ops executed."""
        stream = self.expand()
        return len(stream) + self._ctrl_cycles

    def meta(self) -> StreamMeta:
        """Metadata of the expanded stream (compiled-executor input)."""
        return stream_meta(self.expand())

    def expand_grouped(self):
        """Expand, split at the dominant top-level hardware loop.

        Returns ``(pre, iters, post)`` where ``iters`` is one micro-op
        stream per iteration of the top-level :class:`Loop` contributing
        the most cycles, and ``pre``/``post`` are the surrounding
        streams; or ``None`` when there is no top-level loop with at
        least 2 iterations.  ``pre + sum(iters) + post`` is always
        identical to :meth:`expand` -- the grouping only adds boundaries,
        so compilers can fall back to the flat stream at any point.
        """
        best, best_cycles = None, 0
        for idx, nd in enumerate(self.nodes):
            if isinstance(nd, Loop) and nd.count >= 2:
                body_cycles = Program("_", nd.body).cycles()
                if nd.count * body_cycles > best_cycles:
                    best, best_cycles = idx, nd.count * body_cycles
        if best is None:
            return None
        loop = self.nodes[best]
        regs = [0] * NUM_REGS
        ctrl = [0]

        def expand_nodes(nodes):
            sub = Program("_", list(nodes))
            stream = sub._expand_with(regs, ctrl)
            return stream

        pre = expand_nodes(self.nodes[:best])
        iters = [expand_nodes(loop.body) for _ in range(loop.count)]
        post = expand_nodes(self.nodes[best + 1:])
        return pre, iters, post

    def expand_segments(self):
        """Expand, splitting at EVERY top-level hardware loop.

        Returns a list of ``("flat", stream)`` and ``("loop", iters)``
        segments in program order, where ``iters`` is one micro-op
        stream per iteration of a top-level :class:`Loop` with at least
        2 iterations.  Register state threads through the segments in
        order, so the concatenation of all streams is always identical
        to :meth:`expand` -- like :meth:`expand_grouped` this only adds
        boundaries.  Programs built by concatenation (``__add__``) keep
        one segment per constituent loop, which is what lets the
        compiled executor lane-vectorize each dominant loop of a chained
        program instead of only the single biggest one.
        """
        regs = [0] * NUM_REGS
        ctrl = [0]
        segs = []
        flat: List[Node] = []

        def expand_nodes(nodes):
            return Program("_", list(nodes))._expand_with(regs, ctrl)

        def flush():
            if flat:
                stream = expand_nodes(flat)
                if stream:
                    segs.append(("flat", stream))
                del flat[:]

        for nd in self.nodes:
            if isinstance(nd, Loop) and nd.count >= 2:
                flush()
                segs.append(("loop",
                             [expand_nodes(nd.body)
                              for _ in range(nd.count)]))
            else:
                flat.append(nd)
        flush()
        return segs

    def _expand_with(self, regs, ctrl):
        """Like :meth:`expand` but threading caller-owned register state
        (``regs``) and a 1-element controller-cycle accumulator."""
        stream: List[Instr] = []

        def resolve(ref: RowRef) -> int:
            if isinstance(ref, R):
                return regs[ref.reg] + ref.offset
            return int(ref)

        def run(nodes: Sequence[Node]):
            for nd in nodes:
                if isinstance(nd, Loop):
                    for _ in range(nd.count):
                        run(nd.body)
                elif isinstance(nd, SetReg):
                    regs[nd.reg] = nd.value
                    ctrl[0] += 1
                elif isinstance(nd, AddReg):
                    regs[nd.reg] += nd.delta
                    ctrl[0] += 1
                elif isinstance(nd, MovReg):
                    regs[nd.dst] = regs[nd.src] + nd.offset
                    ctrl[0] += 1
                else:
                    stream.append(Instr(nd.op, resolve(nd.dst),
                                        resolve(nd.a), resolve(nd.b),
                                        nd.pred))
                    for reg, delta in nd.inc:
                        regs[reg] += delta
        run(self.nodes)
        return stream

    def fingerprint(self) -> str:
        """Stable content hash of the program.

        Covers both the 16-bit encoded instruction words (structure) and
        the expanded micro-op stream (absolute row operands, which the
        16-bit encoding carries in registers and therefore does not pin
        down by itself).  Two programs sharing a name but differing in
        nodes hash differently, so compiled-executor caches keyed on
        this never cross-contaminate.

        Memoized on first use (it feeds every compiled-executor cache
        lookup): treat a Program as frozen once it has been executed --
        mutating ``nodes`` in place afterwards is not supported (build
        a new Program instead, as ``__add__`` does).
        """
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            h = hashlib.sha256()
            for w in encode(self):
                h.update(w.to_bytes(2, "little"))
            for ins in self.expand():
                h.update(f"{ins.op},{ins.dst},{ins.a},{ins.b},"
                         f"{int(ins.pred)};".encode())
            fp = self.__dict__["_fingerprint"] = h.hexdigest()[:16]
        return fp

    def __add__(self, other: "Program") -> "Program":
        return Program(f"{self.name}+{other.name}", self.nodes + other.nodes,
                       max(self.temp_rows, other.temp_rows))


# ---------------------------------------------------------------------------
# Program validity (the fuzzer's well-formed-by-construction contract)
# ---------------------------------------------------------------------------
def validate_program(program: Program, rows: int,
                     max_cycles: int | None = None) -> List[str]:
    """Check that ``program`` is well-formed for a ``rows``-row geometry.

    Returns a list of human-readable violations (empty = valid).  This
    is the contract the constrained-random fuzzer guarantees *by
    construction* and re-checks before every differential replay: a
    stream that indexes outside the array is not a program the hardware
    could run, so executor divergence on it would be noise, not signal.

    Checks, on the *expanded* stream (register-relative addressing
    resolved, exactly what the executors consume):

    * every row operand a micro-op actually reads/writes is in
      ``[0, rows)`` -- negative rows wrap in the unroll executor but
      clamp in the scan executor's gathers, so an out-of-range row is
      not merely invalid, it is a false differential;
    * opcodes are known array micro-ops;
    * structural checks on the node tree: loop trip counts >= 1,
      post-increment register indices in range;
    * optionally, the expanded stream stays under ``max_cycles``.
    """
    bad: List[str] = []

    def check_nodes(nodes: Sequence[Node], depth: int = 0):
        for nd in nodes:
            if isinstance(nd, Loop):
                if nd.count < 1:
                    bad.append(f"loop count {nd.count} < 1")
                if depth >= 8:
                    bad.append("loop nesting deeper than 8")
                check_nodes(nd.body, depth + 1)
            elif isinstance(nd, Instr):
                if not (0 <= nd.op < N_ARRAY_OPS):
                    bad.append(f"unknown opcode {nd.op}")
                for reg, _delta in nd.inc:
                    if not (0 <= reg < NUM_REGS):
                        bad.append(f"inc register {reg} out of range")
            elif isinstance(nd, (SetReg, AddReg, MovReg)):
                pass      # register indices enforced by the dataclasses
            else:
                bad.append(f"unknown node type {type(nd).__name__}")

    check_nodes(program.nodes)
    if bad:
        return bad                     # expansion may not be meaningful
    stream = program.expand()
    for i, ins in enumerate(stream):
        used = []
        if ins.op in _READS_A:
            used.append(("a", ins.a))
        if ins.op in _READS_B:
            used.append(("b", ins.b))
        if ins.op in _WRITES_ROW:
            used.append(("dst", ins.dst))
        for field, row in used:
            if not (0 <= row < rows):
                bad.append(f"cycle {i} ({ARRAY_OP_NAMES[ins.op]}): "
                           f"{field}={row} outside [0, {rows})")
    if max_cycles is not None and len(stream) > max_cycles:
        bad.append(f"{len(stream)} micro-ops > cap {max_cycles}")
    return bad


def describe_stream(program: Program) -> str:
    """One-line op-mix summary of the expanded stream (diagnostics)."""
    meta = program.meta()
    mix = " ".join(f"{ARRAY_OP_NAMES[op]}:{n}"
                   for op, n in meta.op_histogram)
    return (f"{program.name}: {meta.n_cycles} cycles, rows<= {meta.max_row},"
            f" pred={meta.uses_pred} [{mix}]")


# ---------------------------------------------------------------------------
# 16-bit encoding (paper: each instruction is 16 bits wide).
#
# Array micro-op:  [15] = 0 | [14:10] opcode(5) | [9] pred |
#                  [8:6] dst reg | [5:3] a reg | [2:0] b reg
# Controller op:   [15] = 1 | [14] kind (0=set,1=add) | [13:11] reg |
#                  [10:0] signed immediate
# Loop marker:     encoded as a controller op on a dedicated loop register.
#
# Row *offsets* are carried in registers (SetReg/AddReg), matching the
# register-relative addressing a 16-bit encoding forces; ``encode`` is a
# structural check that the program is representable, used by tests.
# ---------------------------------------------------------------------------
def encode(program: Program) -> List[int]:
    words: List[int] = []

    def enc(nodes: Sequence[Node]):
        for nd in nodes:
            if isinstance(nd, Loop):
                words.append(0x8000 | (0x7FF & min(nd.count, 0x7FF)))
                enc(nd.body)
            elif isinstance(nd, SetReg):
                words.append(0xC000 | (nd.reg << 11) | (nd.value & 0x7FF))
            elif isinstance(nd, AddReg):
                words.append(0xE000 | (nd.reg << 11) | (nd.delta & 0x7FF))
            elif isinstance(nd, MovReg):
                words.append(0xA000 | (nd.dst << 11) | (nd.src << 8)
                             | (nd.offset & 0xFF))
            else:
                def regof(ref):
                    return ref.reg if isinstance(ref, R) else 0
                words.append((nd.op << 10) | (int(nd.pred) << 9)
                             | (regof(nd.dst) << 6) | (regof(nd.a) << 3)
                             | regof(nd.b))
    enc(program.nodes)
    words.append(0xFFFF)   # END
    return words
