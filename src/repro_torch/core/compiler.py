"""Static compiler: Compute RAM programs -> specialized torch functions.

The counterpart of ``repro.core.compiler``.  ``engine.compile_program``
lowers the *expanded* micro-op stream of a :class:`isa.Program` into a
function over :class:`engine.CRState` tensors: opcodes are constants
known when the function is built, row values live in Python
dictionaries so runs of row writes become one batched ``index_copy``,
and the bool column axis is optionally bit-packed into 32-bit words so
one tensor op covers 32 columns.

The analysis half (``_segment``, ``analyze_multi``, ``_plan_loop``,
``_coverage_kills``, :class:`LanePlan`) is pure Python over :mod:`isa`
and is a copy of the reference.  It runs once, when :func:`lower`
builds the function; only the tensor emission (``_Machine``,
``_run_flat``, ``_run_loop``) runs on every call.  Two lowering
strategies, tried in order:

1. **Lane vectorization**: a dominant top-level hardware loop whose
   iterations touch disjoint ("affine") row windows runs all T
   iterations as *lanes* of one vectorized body on ``(T, ...)``-shaped
   values.  Rows carrying a loop-serial dependence (the ``idot``
   accumulator) run the minimal suffix of the body serially per lane,
   or, for an in-place accumulate chain, as one lane fold
   (``kernels.bitplane_ops.lane_fold``).
2. **Flat lowering** (`_lower_flat`): straight-line specialization of
   the whole stream, used when the loop analysis bails.

Word convention: packed planes are ``torch.int32`` words (torch's
``uint32`` lacks the bitwise and shift operators the interior needs).
Every right shift of a word or of an int32-domain integer is followed
by ``& 1`` or by a mask of fewer than 32 bits, so the arithmetic shift
of int32 gives the same bits as the reference's shifts.  The bool
interior's int32 integers wrap exactly as the reference's do.
"""

from __future__ import annotations

import dataclasses
import operator
import warnings
from typing import Dict, List, Optional, Sequence

import torch

from . import isa
from ..kernels import bitplane_ops
from .isa import (Instr, _READS_A, _READS_B, _WRITES_ROW,
                  OP_NOP, OP_COPY, OP_NOT, OP_AND, OP_OR, OP_XOR, OP_NOR,
                  OP_FA, OP_FS, OP_W0, OP_W1, OP_C0, OP_C1, OP_CROW,
                  OP_CSTORE, OP_TC, OP_TNC, OP_TROW, OP_TNROW, OP_T1,
                  OP_TAND, OP_TOR, OP_TSTORE, OP_TNOT)

WORD = 32

# carry / tag access classification (predication adds tag reads and, for
# the carry-latch writes, a read of the old carry)
_CARRY_READ = {OP_FA, OP_FS, OP_CSTORE, OP_TC, OP_TNC}
_CARRY_WRITE = {OP_C0, OP_C1, OP_CROW, OP_FA, OP_FS, OP_CSTORE}
_CARRY_KILL = {OP_C0, OP_C1, OP_CROW}          # unpredicated only
_TAG_READ = {OP_TAND, OP_TOR, OP_TNOT, OP_TSTORE}
_TAG_WRITE = {OP_TC, OP_TNC, OP_TROW, OP_TNROW, OP_T1, OP_TAND, OP_TOR,
              OP_TNOT}
_TAG_KILL = {OP_T1, OP_TROW, OP_TNROW, OP_TC, OP_TNC}

# Longest FA/FS run folded into one integer add: keeps the per-column
# integers comfortably inside int32 (sum < 2^25).
MAX_CHAIN = 24
# Minimum run length worth the pack/unpack overhead of the integer form.
MIN_CHAIN = 4

# With the packed (int32-word) interior, run folds stay in the *bit
# plane* domain: integers are lists of packed planes and a ripple chain
# is 5 bitwise word-ops per bit (kernels/bitplane_ops.py) instead of an
# unpack -> int32 weighted-sum -> repack ladder.


def n_words(cols: int) -> int:
    return (cols + WORD - 1) // WORD


def pack_cols(x: torch.Tensor) -> torch.Tensor:
    """Bit-pack the trailing (column) axis of a bool tensor into int32
    words (column ``32*w + j`` is bit ``j`` of word ``w``)."""
    cols = x.shape[-1]
    pad = n_words(cols) * WORD - cols
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    x = x.reshape(x.shape[:-1] + (n_words(cols), WORD)).to(torch.int64)
    weights = torch.ones(WORD, dtype=torch.int64, device=x.device) \
        << torch.arange(WORD, dtype=torch.int64, device=x.device)
    v = torch.sum(x * weights, dim=-1)            # in [0, 2^32)
    # wrap to two's complement explicitly: bit 31 becomes the sign
    return (v - ((v >> 31) << 32)).to(torch.int32)


def unpack_cols(xw: torch.Tensor, cols: int) -> torch.Tensor:
    """Inverse of :func:`pack_cols`: int32 words -> (..., cols) bool."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=xw.device)
    bits = (xw[..., None] >> shifts) & 1          # & 1 masks the sign fill
    return bits.reshape(xw.shape[:-1] + (-1,))[..., :cols].to(torch.bool)


# ---------------------------------------------------------------------------
# References.  The machine below is generic over *where* a row lives:
#   ("k", row)  -- a concrete array row (flat lowering, shared scratch)
#   ("l", c)    -- the lane-relative row c + t*stride of lane t
# Unused operand slots are None so they never pollute the analysis.
# ---------------------------------------------------------------------------
def _to_refs(stream: Sequence[Instr], slotfn) -> List[Instr]:
    out = []
    for p, ins in enumerate(stream):
        dst = slotfn(p, "dst") if ins.op in _WRITES_ROW else None
        a = slotfn(p, "a") if ins.op in _READS_A else None
        b = slotfn(p, "b") if ins.op in _READS_B else None
        out.append(Instr(ins.op, dst, a, b, ins.pred))
    return out


def _flat_refs(stream: Sequence[Instr]) -> List[Instr]:
    return _to_refs(stream,
                    lambda p, slot: ("k", getattr(stream[p], slot)))


def _ref_delta(a, b):
    """Row distance between two refs of the same kind (None: unrelated)."""
    if isinstance(a, tuple) and isinstance(b, tuple) and a[0] == b[0]:
        return b[1] - a[1]
    return None


def _segment(stream: Sequence[Instr]):
    """Split a ref-stream into ('op', ins) and ('chain', [ins...]) items.

    A chain is a maximal run of same-opcode, same-predication OP_FA or
    OP_FS micro-ops in which no cycle reads a row written by an earlier
    cycle of the run (read-before-write within one cycle is fine: the
    bit-lines sense operands before write-back).  Such a run is a
    ripple-carry add/sub over bit-planes and folds into ONE per-column
    integer op; any run violating the conditions simply splits, so
    correctness never depends on the matcher being clever.

    Runs of OP_COPY with a uniform +/-1 row stride on dst and src
    ("copyrun"), and of predicated OP_W0/OP_W1 ("fillrun"), fold the
    same way: the whole run is one integer-domain move/mux instead of a
    per-row select -- the float programs' big/small builds, align
    shifts, flushes, and accumulator writebacks are made of exactly
    these.
    """
    items = []
    i, n = 0, len(stream)
    while i < n:
        ins = stream[i]
        if ins.op in (OP_FA, OP_FS):
            run = [ins]
            written = {ins.dst}
            j = i + 1
            while (j < n and len(run) < MAX_CHAIN
                   and stream[j].op == ins.op
                   and stream[j].pred == ins.pred
                   and stream[j].a not in written
                   and stream[j].b not in written):
                run.append(stream[j])
                written.add(stream[j].dst)
                j += 1
            if len(run) >= MIN_CHAIN:
                items.append(("chain", run))
            else:
                items.extend(("op", r) for r in run)
            i = j
        elif ins.op == OP_AND and not ins.pred:
            # partial-product idiom: a run of ANDs against one shared
            # operand row (the multiplier bit) is the bit-plane product
            # a_int * bit -- one integer multiply
            run = [ins]
            written = {ins.dst}
            j = i + 1
            while (j < n and len(run) < MAX_CHAIN
                   and stream[j].op == OP_AND
                   and not stream[j].pred
                   and stream[j].b == ins.b
                   and stream[j].a not in written
                   and stream[j].b not in written
                   and stream[j].dst not in written):
                run.append(stream[j])
                written.add(stream[j].dst)
                j += 1
            if len(run) >= MIN_CHAIN:
                items.append(("andrun", run))
            else:
                items.extend(("op", r) for r in run)
            i = j
        elif ins.op in (OP_OR, OP_XOR):
            # bitwise runs: OR/XOR over uniform-stride row windows (b
            # may also be one shared row) fold to a single integer-
            # domain bitwise op -- | and ^ act bit-plane-wise on the
            # packed integers, so no carry structure is needed at all
            run = [ins]
            written = {ins.dst}
            d = db = None
            j = i + 1
            while (j < n and len(run) < MAX_CHAIN
                   and stream[j].op == ins.op
                   and stream[j].pred == ins.pred):
                prev, nxt = run[-1], stream[j]
                dd = _ref_delta(prev.dst, nxt.dst)
                if dd not in (1, -1) or (d is not None and dd != d):
                    break
                if _ref_delta(prev.a, nxt.a) != dd or nxt.a in written:
                    break
                dbd = _ref_delta(prev.b, nxt.b)
                if dbd not in (0, dd) or (db is not None and dbd != db):
                    break
                if nxt.b in written or nxt.dst in written:
                    break
                d, db = dd, dbd
                run.append(nxt)
                written.add(nxt.dst)
                j += 1
            if len(run) >= MIN_CHAIN:
                items.append(("bitrun", run))
            else:
                items.extend(("op", r) for r in run)
            i = j
        elif (ins.op == OP_COPY
              or (ins.pred and ins.op in (OP_W0, OP_W1))):
            run = [ins]
            written = {ins.dst}
            d = None
            j = i + 1
            while (j < n and len(run) < MAX_CHAIN
                   and stream[j].op == ins.op
                   and stream[j].pred == ins.pred):
                prev, nxt = run[-1], stream[j]
                dd = _ref_delta(prev.dst, nxt.dst)
                if dd not in (1, -1) or (d is not None and dd != d):
                    break
                if ins.op == OP_COPY and (
                        _ref_delta(prev.a, nxt.a) != dd
                        or nxt.a in written):
                    break
                if nxt.dst in written:
                    break
                d = dd
                run.append(nxt)
                written.add(nxt.dst)
                j += 1
            if len(run) >= MIN_CHAIN:
                items.append(("copyrun" if ins.op == OP_COPY
                              else "fillrun", run))
            else:
                items.extend(("op", r) for r in run)
            i = j
        else:
            items.append(("op", ins))
            i += 1
    return items


# ---------------------------------------------------------------------------
# The abstract machine: executes a segmented ref-stream with pluggable
# row storage.  Values are (cols,) bool or (W,) int32 vectors, with an
# optional leading lane axis; &, |, ^, ~ mean the same thing column-wise
# in every case, which is why one op-semantics body serves all stages.
# ---------------------------------------------------------------------------
class _Ctx:
    def __init__(self, cols: int, packed: bool, device, consts: dict):
        self.cols = cols
        self.packed = packed
        self.device = device
        # device copies of the host-side index/shift constants, kept by
        # the lowered function so no call re-uploads (and syncs on) them
        self._consts = consts
        # packed interiors keep folded integers in the bit-plane domain:
        # each plane IS a row's repr value, so building/extracting
        # integers is free and every arithmetic step is a bitwise op on
        # int32 words.
        self.planes = packed
        if packed:
            self.empty = torch.zeros((n_words(cols),), dtype=torch.int32,
                                     device=device)
            self.full = torch.full((n_words(cols),), -1, dtype=torch.int32,
                                   device=device)      # 0xFFFFFFFF
        else:
            self.empty = torch.zeros((cols,), dtype=torch.bool,
                                     device=device)
            self.full = torch.ones((cols,), dtype=torch.bool, device=device)

    def const(self, values, dtype=torch.int64):
        """A host int sequence as a device tensor, uploaded once."""
        key = (tuple(values), dtype, self.device)
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.tensor(
                key[0], dtype=dtype, device=self.device)
        return t

    def to_bits(self, v):
        """repr value(s) -> (..., cols) int32 of 0/1 bits."""
        if self.packed:
            return unpack_cols(v, self.cols).to(torch.int32)
        return v.to(torch.int32)

    def from_bools(self, bits):
        """(..., cols) bool -> repr value(s)."""
        return pack_cols(bits) if self.packed else bits


def _select(mask, x, y):
    # column-wise mux; 3 ops instead of 4 for (m & x) | (~m & y)
    return y ^ ((x ^ y) & mask)


def _stack(vals):
    """torch.stack with broadcasting of base-shaped values to lane shape."""
    nd = max(v.ndim for v in vals)
    if any(v.ndim != nd for v in vals):
        shp = next(v.shape for v in vals if v.ndim == nd)
        vals = [v if v.ndim == nd else v.expand(shp) for v in vals]
    return torch.stack(vals)


class _Lazy:
    """A row value defined as bit ``k`` of a per-column integer.

    Ripple chains compute whole integers; each written row is one bit of
    that integer.  Deferring the bit extraction keeps dependent chains in
    the integer domain (the next chain reads ``(s >> k) & mask`` instead
    of restacking bit-planes) and skips the extraction of rows nobody
    reads.
    """
    __slots__ = ("src", "bit", "_mat")

    def __init__(self, src, bit: int):
        self.src = src            # (..., cols) int32
        self.bit = bit
        self._mat = None

    def materialize(self, ctx: "_Ctx"):
        if self._mat is None:
            bit = ((self.src >> self.bit) & 1).to(torch.bool)
            self._mat = ctx.from_bools(bit)
        return self._mat


def _mat(ctx, v):
    return v.materialize(ctx) if isinstance(v, _Lazy) else v


def _mat_many(ctx, vals):
    """Materialize a batch of values, extracting bits of a shared source
    integer together (one shift/pack for the whole group)."""
    groups: Dict[int, list] = {}
    for v in vals:
        if isinstance(v, _Lazy) and v._mat is None:
            groups.setdefault(id(v.src), []).append(v)
    for lazies in groups.values():
        if len(lazies) < 2:
            continue
        src = lazies[0].src
        ks = ctx.const([v.bit for v in lazies], torch.int32)
        ks = ks.reshape((len(lazies),) + (1,) * src.ndim)
        bits = ((src[None] >> ks) & 1).to(torch.bool)
        reprs = ctx.from_bools(bits)
        for j, v in enumerate(lazies):
            v._mat = reprs[j]
    return [_mat(ctx, v) for v in vals]


class _Machine:
    """Runs segmented micro-ops against read/write callbacks.

    ``prov`` maps row refs to ``(src_int, bit)`` -- the provenance of a
    row as one bit of a chain's integer result.  Chains whose operands
    are consecutive bits of one source skip bit-plane restacking
    entirely: ``a_int = (src >> k) & mask``.  The dict may be shared
    across machines (prefix -> serial suffix); ``lane_view`` then maps a
    lane-shaped (T, cols) source into this machine's frame.
    """

    def __init__(self, ctx: _Ctx, read, write, carry, tag,
                 prov=None, lane_view=None, peek=None, planes=None):
        self.ctx = ctx
        self._read_cb = read
        self._write_cb = write
        self.carry = carry        # repr array, _Lazy bit, or None (poison)
        self.tag = tag
        self.prov = {} if prov is None else prov
        self.lane_view = lane_view or (lambda v: v)
        self.peek = peek or (lambda ref: None)
        self._int_cache: Dict[tuple, torch.Tensor] = {}
        self._int_deps: Dict[tuple, set] = {}
        self._tagb = None
        # per-machine domain choice, as in the reference: serial
        # per-lane suffix machines use the int32 domain, flat and
        # vectorized-prefix machines default to ctx.planes
        self.planes = ctx.planes if planes is None else planes

    # -- value access -------------------------------------------------------
    def read(self, ref):
        return _mat(self.ctx, self._read_cb(ref))

    def write(self, ref, v):
        self.prov.pop(ref, None)
        for key in self._int_deps.pop(ref, ()):
            self._int_cache.pop(key, None)
        self._write_cb(ref, v)

    def carry_repr(self):
        assert self.carry is not None, "read of uninitialized carry latch"
        return _mat(self.ctx, self.carry)

    def _carry_bits(self):
        c = self.carry
        assert c is not None, "read of uninitialized carry latch"
        if c is self.ctx.empty:
            return 0
        if isinstance(c, _Lazy):
            return (self.lane_view(c.src) >> c.bit) & 1
        return self.ctx.to_bits(c)

    def _tag_bits(self):
        if self._tagb is None or self._tagb[0] is not self.tag:
            self._tagb = (self.tag,
                          self.ctx.to_bits(_mat(self.ctx, self.tag)))
        return self._tagb[1]

    # -- integers -----------------------------------------------------------
    def _int_prov(self, refs, m):
        """(src >> k) & mask when refs are consecutive bits of one
        source int, optionally tailed by known-zero rows."""
        p0 = self.prov.get(refs[0])
        if p0 is None:
            return None
        src0, k0 = p0
        n = 1
        for r in refs[1:]:
            p = self.prov.get(r)
            if p is not None and p[0] is src0 and p[1] == k0 + n:
                n += 1
            else:
                break
        for r in refs[n:]:
            if self.peek(r) is not self.ctx.empty:
                return None
        src = self.lane_view(src0)
        out = (src >> k0) if k0 else src
        # n <= MAX_CHAIN < 32, so the mask fits int32 and removes the
        # sign fill of the arithmetic shift
        return out & ((1 << n) - 1)

    def _int_of(self, refs, m):
        key = tuple(refs)
        v = self._int_cache.get(key)
        if v is not None:
            return v
        v = self._int_prov(refs, m)
        if v is None:
            bits = self.ctx.to_bits(_stack(
                _mat_many(self.ctx, [self._read_cb(r) for r in refs])))
            w = self.ctx.const([1 << i for i in range(m)], torch.int32)
            w = w.reshape((m,) + (1,) * (bits.ndim - 1))
            v = torch.sum(bits * w, dim=0, dtype=torch.int32)
        self._int_cache[key] = v
        for r in refs:
            self._int_deps.setdefault(r, set()).add(key)
        return v

    # -- bit-plane domain (packed interior) ---------------------------------
    def _plane_tag(self):
        return _mat(self.ctx, self.tag)

    def _plane_zero(self, v):
        """None (known zero) <-> repr sentinel conversion helpers."""
        return None if v is self.ctx.empty else v

    def _plane_val(self, v):
        return self.ctx.empty if v is None else v

    def _chain_planes(self, run):
        """FA/FS chain in the plane domain: one bitwise ripple
        (kernels.bitplane_ops.planes_add) whose planes are written back
        directly -- no int32 build, no bit extraction, exact carry."""
        ctx = self.ctx
        a = [self._plane_zero(self.read(c.a)) for c in run]
        b = [self._plane_zero(self.read(c.b)) for c in run]
        cin = self.carry
        assert cin is not None, "read of uninitialized carry latch"
        s, cout = bitplane_ops.planes_add(
            a, b, self._plane_zero(_mat(ctx, cin)),
            sub=run[0].op == OP_FS)
        if run[0].pred:
            # tag=0 columns keep their old rows and old carry -- the
            # same end-of-chain mux the int32 fold applies
            t = self._plane_tag()
            s = [_select(t, self._plane_val(x), self.read(c.dst))
                 for x, c in zip(s, run)]
            cout = _select(t, self._plane_val(cout), _mat(ctx, cin))
        for c, x in zip(run, s):
            self.write(c.dst, self._plane_val(x))
        self.carry = self._plane_val(cout)

    def _and_run_planes(self, run):
        b_bit = self.read(run[0].b)
        vals = [self.read(c.a) & b_bit for c in run]
        for c, v in zip(run, vals):
            self.write(c.dst, v)

    def _copy_run_planes(self, run):
        vals = [self.read(c.a) for c in run]
        if run[0].pred:
            t = self._plane_tag()
            vals = [_select(t, v, self.read(c.dst))
                    for v, c in zip(vals, run)]
        for c, v in zip(run, vals):
            self.write(c.dst, v)

    def _fill_run_planes(self, run):
        t = self._plane_tag()
        if run[0].op == OP_W0:
            vals = [self.read(c.dst) & ~t for c in run]
        else:
            vals = [self.read(c.dst) | t for c in run]
        for c, v in zip(run, vals):
            self.write(c.dst, v)

    def _bit_run_planes(self, run):
        op = run[0].op
        a = [self.read(c.a) for c in run]
        b = [self.read(c.b) for c in run]
        vals = [(x | y) if op == OP_OR else (x ^ y) for x, y in zip(a, b)]
        if run[0].pred:
            t = self._plane_tag()
            vals = [_select(t, v, self.read(c.dst))
                    for v, c in zip(vals, run)]
        for c, v in zip(run, vals):
            self.write(c.dst, v)

    # -- int32 domain (bool interior) ---------------------------------------
    def _chain(self, run):
        """One FA/FS ripple chain == one per-column integer add/sub,
        computed and kept in the integer domain (writes become lazy
        bit extractions; the carry latch becomes a lazy bit)."""
        if self.planes:
            return self._chain_planes(run)
        m = len(run)
        a_refs = [c.a for c in run]
        b_refs = [c.b for c in run]
        a_int = self._int_of(a_refs, m)
        b_int = self._int_of(b_refs, m)
        c_in = self._carry_bits()
        is_fa = run[0].op == OP_FA
        if is_fa:
            s = a_int + b_int + c_in
            c_out = None                # bit m of s (kept implicit)
        else:                           # OP_FS: d = a - b - borrow
            s = a_int - b_int - c_in
            c_out = (s < 0).to(torch.int32)
        if run[0].pred:
            # integer-domain mux: tag=0 columns keep old rows and carry
            tb = self._tag_bits()
            dst_refs = [c.dst for c in run]
            old = (a_int if dst_refs == a_refs
                   else self._int_of(dst_refs, m))
            zero_cin = isinstance(c_in, int) and c_in == 0
            if is_fa and not zero_cin:
                c_out = (s >> m) & 1
            s = old + (s - old) * tb
            if is_fa and zero_cin:
                # _int_of masks old to m bits, so bit m of the muxed sum
                # is tag & carry-out == select(tag, carry_out, c_in=0)
                c_out = None
            elif c_out is not None:
                c_out = c_in + (c_out - c_in) * tb
        # arithmetic >> keeps the low bits of s mod 2^m correct even for
        # a negative FS difference (two's complement)
        for i, c in enumerate(run):
            self.write(c.dst, _Lazy(s, i))
            self.prov[c.dst] = (s, i)
        # FA carry-out is bit m of the same sum: keeping that provenance
        # lets the next chain read [rows..., CSTORE row] as one integer
        self.carry = _Lazy(s, m) if c_out is None else _Lazy(c_out, 0)

    def _and_run(self, run):
        """Partial-product AND run == integer multiply by the shared bit."""
        if self.planes:
            return self._and_run_planes(run)
        m = len(run)
        a_int = self._int_of([c.a for c in run], m)
        b_bit = self.ctx.to_bits(self.read(run[0].b))
        s = a_int * b_bit
        for i, c in enumerate(run):
            self.write(c.dst, _Lazy(s, i))
            self.prov[c.dst] = (s, i)

    def _copy_run(self, run):
        """Uniform-stride COPY run == one integer-domain move (mux)."""
        if self.planes:
            return self._copy_run_planes(run)
        m = len(run)
        s = self._int_of([c.a for c in run], m)
        if run[0].pred:
            old = self._int_of([c.dst for c in run], m)
            s = old + (s - old) * self._tag_bits()
        for i, c in enumerate(run):
            self.write(c.dst, _Lazy(s, i))
            self.prov[c.dst] = (s, i)

    def _fill_run(self, run):
        """Predicated W0/W1 run == one integer-domain mask merge."""
        if self.planes:
            return self._fill_run_planes(run)
        m = len(run)
        old = self._int_of([c.dst for c in run], m)
        tb = self._tag_bits()
        if run[0].op == OP_W0:
            s = old - old * tb
        else:
            s = old + (((1 << m) - 1) - old) * tb
        for i, c in enumerate(run):
            self.write(c.dst, _Lazy(s, i))
            self.prov[c.dst] = (s, i)

    def _bit_run(self, run):
        """OR/XOR run over strided windows == one integer bitwise op
        (| and ^ distribute over bit planes of the packed integers)."""
        if self.planes:
            return self._bit_run_planes(run)
        m = len(run)
        a_int = self._int_of([c.a for c in run], m)
        b_int = self._int_of([c.b for c in run], m)
        s = (a_int | b_int) if run[0].op == OP_OR else (a_int ^ b_int)
        if run[0].pred:
            old = self._int_of([c.dst for c in run], m)
            s = old + (s - old) * self._tag_bits()
        for i, c in enumerate(run):
            self.write(c.dst, _Lazy(s, i))
            self.prov[c.dst] = (s, i)

    # -- main loop ----------------------------------------------------------
    def run(self, items):
        ctx = self.ctx
        empty, full = ctx.empty, ctx.full
        for kind, ins in items:
            if kind == "chain":
                self._chain(ins)
                continue
            if kind == "andrun":
                self._and_run(ins)
                continue
            if kind == "copyrun":
                self._copy_run(ins)
                continue
            if kind == "fillrun":
                self._fill_run(ins)
                continue
            if kind == "bitrun":
                self._bit_run(ins)
                continue
            op = ins.op
            if op == OP_NOP:
                continue
            # carry / tag latch ops ----------------------------------------
            if op == OP_C0:
                self.carry = (_select(self.tag, empty, self.carry_repr())
                              if ins.pred else empty)
            elif op == OP_C1:
                self.carry = (_select(self.tag, full, self.carry_repr())
                              if ins.pred else full)
            elif op == OP_CROW:
                ra = self.read(ins.a)
                self.carry = (_select(self.tag, ra, self.carry_repr())
                              if ins.pred else ra)
            elif op == OP_TC:
                self.tag = self.carry_repr()
            elif op == OP_TNC:
                self.tag = ~self.carry_repr()
            elif op == OP_TROW:
                self.tag = self.read(ins.a)
            elif op == OP_TNROW:
                self.tag = ~self.read(ins.a)
            elif op == OP_T1:
                self.tag = full
            elif op == OP_TAND:
                self.tag = self.tag & self.read(ins.a)
            elif op == OP_TOR:
                self.tag = self.tag | self.read(ins.a)
            elif op == OP_TNOT:
                self.tag = ~self.tag
            # row-writing ops ----------------------------------------------
            else:
                new_carry = self.carry
                if op == OP_COPY:
                    val = self.read(ins.a)
                elif op == OP_NOT:
                    val = ~self.read(ins.a)
                elif op == OP_AND:
                    val = self.read(ins.a) & self.read(ins.b)
                elif op == OP_OR:
                    val = self.read(ins.a) | self.read(ins.b)
                elif op == OP_XOR:
                    val = self.read(ins.a) ^ self.read(ins.b)
                elif op == OP_NOR:
                    val = ~(self.read(ins.a) | self.read(ins.b))
                elif op == OP_FA:
                    ra, rb = self.read(ins.a), self.read(ins.b)
                    carry = self.carry_repr()
                    axb = ra ^ rb
                    val = axb ^ carry
                    new_carry = (ra & rb) | (carry & axb)
                elif op == OP_FS:
                    ra, rb = self.read(ins.a), self.read(ins.b)
                    carry = self.carry_repr()
                    axb = ra ^ rb
                    val = axb ^ carry
                    new_carry = (~ra & rb) | (carry & ~axb)
                elif op == OP_W0:
                    val = empty
                elif op == OP_W1:
                    val = full
                elif op == OP_CSTORE:
                    val = self.carry   # may stay lazy on the unpred path
                    new_carry = empty
                elif op == OP_TSTORE:
                    val = self.tag
                else:
                    raise ValueError(f"unknown opcode {op}")
                if ins.pred:
                    val = _select(self.tag, _mat(ctx, val),
                                  self.read(ins.dst))
                    if new_carry is not self.carry:   # op touched carry
                        new_carry = _select(self.tag, _mat(ctx, new_carry),
                                            self.carry_repr())
                keep_prov = (op == OP_CSTORE and not ins.pred
                             and isinstance(val, _Lazy))
                self.write(ins.dst, val)
                if keep_prov:     # CSTORE forwards the carry bit's source
                    self.prov[ins.dst] = (val.src, val.bit)
                self.carry = new_carry


# ---------------------------------------------------------------------------
# Lane analysis
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class LanePlan:
    lanes: int                  # T
    stride: int                 # row offset between consecutive lanes
    serial_start: int           # body position where the serial suffix begins
    pre: List[Instr]            # flat streams around the lane loop
    post: List[Instr]
    body: List[Instr]           # ref-stream of one iteration (lane 0 rows)
    const_kind: Dict[int, str]  # const row -> "kill" | "ro" | "red"
    carry_in_prefix: bool       # prefix writes the carry latch
    tag_in_prefix: bool
    carry_in_body: bool
    tag_in_body: bool


def _used_slots(ins: Instr):
    reads, writes = [], []
    if ins.op in _READS_A:
        reads.append("a")
    if ins.op in _READS_B:
        reads.append("b")
    if ins.op in _WRITES_ROW:
        writes.append("dst")
        if ins.pred:
            reads.append("dst")   # predicated writes read back dst
    return reads, writes


def _coverage_kills(stream: Sequence[Instr]) -> set:
    """Rows fully written before any exposed read, counting predicated
    complementary pairs as one full write.

    The float programs build scratch values with two predicated passes:

        trow g ; ?t copy r, ...     # columns where g
        tnrow g ; ?t copy r, ...    # columns where ~g

    Together the pair overwrites every column of ``r``, so ``r`` is
    lane-private scratch exactly like an unpredicated ("kill") write --
    but the per-position classification in :func:`analyze` only sees a
    predicated first write and pins it "red", forcing the serial suffix
    to start there.  This pass walks one iteration tracking the tag
    latch as an abstract value and returns the rows proven *covered*:

    * an unpredicated write (or one under ``t1``) covers immediately;
    * a predicated write under ``tag <- row[g]`` (or its negation)
      records a *half*; the complementary half -- same guard row ``g``,
      opposite polarity, ``g`` unwritten between the two tag latches --
      completes the cover;
    * any exposed read before the cover completes (operand reads and
      guard reads; a predicated write's read-back of its own dst is the
      mux being modeled, not an exposed read) disqualifies the row --
      EXCEPT *masked* reads, which only observe columns the pending
      half-write already covered:

      - ``tand r`` (and operand reads of predicated ops) observe ``r``
        only where the tag is 1: safe when the half was written under
        the exact current tag ``(g, neg)``;
      - ``tor r`` observes ``r`` only where the tag is 0: safe when the
        half was written under the *complementary* ``(g, ~neg)``.

      This is what unseals the float adder's carry-out idiom
      (``?t cstore COUT`` under ``tag<-row[SUB]`` followed by
      ``trow SUB; tand COUT``): the tand reads exactly the half-written
      columns, the later unpredicated ``tstore COUT`` completes the
      cover, so COUT is lane-private scratch and no longer pins a
      serial suffix.

    Rows never pair-written are simply absent -- the default
    classification applies, so this only ever *upgrades* red to kill.
    """
    ver: Dict[int, int] = {}
    tag = None                    # ("row", g, neg, ver) | ("one",) | None
    halves: Dict[int, tuple] = {}
    covered: set = set()
    dead: set = set()

    def spoil(r):
        dead.add(r)
        halves.pop(r, None)

    for ins in stream:
        reads, writes = _used_slots(ins)
        for slot in reads:
            if slot == "dst":
                continue          # predicated write read-back: the mux
            r = getattr(ins, slot)
            if r in covered:
                continue
            half = halves.get(r)
            if half is not None and tag is not None and tag[0] == "row":
                g, neg, gv = tag[1], tag[2], tag[3]
                masked_by_tag = (ins.op == OP_TAND
                                 or (ins.pred and ins.op in _WRITES_ROW))
                if masked_by_tag and half == (g, neg, gv):
                    continue      # observes only half-written columns
                if ins.op == OP_TOR and half == (g, not neg, gv):
                    continue      # tor reads where tag=0: the other half
            spoil(r)
        if ins.op in (OP_TROW, OP_TNROW):
            tag = ("row", ins.a, ins.op == OP_TNROW, ver.get(ins.a, 0))
        elif ins.op == OP_T1:
            tag = ("one",)
        elif ins.op in _TAG_WRITE:
            tag = None            # TC/TNC/TAND/TOR/TNOT: unknown mask
        if not writes:
            continue
        r = ins.dst
        ver[r] = ver.get(r, 0) + 1
        if r in covered or r in dead:
            continue
        if not ins.pred or tag == ("one",):
            covered.add(r)
            halves.pop(r, None)
        elif tag is None:
            spoil(r)
        else:
            _, g, neg, gv = tag
            prev = halves.get(r)
            if prev is None:
                halves[r] = (g, neg, gv)
            elif prev == (g, not neg, gv):
                covered.add(r)
                halves.pop(r, None)
            elif prev != (g, neg, gv):
                spoil(r)
    return covered


def analyze(program: isa.Program) -> Optional[LanePlan]:
    """Plan for the single dominant top-level loop; None = fall back.

    Kept as the introspection API (tests/benchmarks assert on it); the
    lowering itself goes through :func:`analyze_multi`, which plans
    EVERY top-level loop so chained/concatenated programs with two or
    more dominant loops vectorize each of them.
    """
    grouped = program.expand_grouped()
    if grouped is None:
        return None
    pre, iters, post = grouped
    return _plan_loop(pre, iters, post)


def analyze_multi(program: isa.Program):
    """Segment the program at every top-level loop and plan each.

    Returns a list of ``("flat", stream)`` / ``("loop", LanePlan)``
    segments (plans carry empty pre/post), or None when no loop admits
    a plan -- the caller then flat-lowers the whole stream.  Loops whose
    plan fails degrade to flat segments, so correctness never depends
    on any individual loop vectorizing.
    """
    out, any_plan = [], False
    for kind, payload in program.expand_segments():
        if kind == "loop":
            plan = _plan_loop([], payload, [])
            if plan is not None:
                out.append(("loop", plan))
                any_plan = True
                continue
            payload = [i for it in payload for i in it]
        if out and out[-1][0] == "flat":
            out[-1] = ("flat", out[-1][1] + list(payload))
        else:
            out.append(("flat", list(payload)))
    return out if any_plan else None


def _plan_loop(pre, iters, post) -> Optional[LanePlan]:
    """Lane-vectorization analysis of one loop's iteration streams."""
    T = len(iters)
    L = len(iters[0])
    if T < 2 or L == 0:
        return None
    sig = [(i.op, i.pred) for i in iters[0]]
    if any([(i.op, i.pred) for i in it] != sig for it in iters[1:]):
        return None

    # per-position operand rows across lanes -> const or affine refs
    stride = None
    refs: List[Dict[str, tuple]] = []
    for p in range(L):
        slots = {}
        reads, writes = _used_slots(iters[0][p])
        for slot in set(reads + writes):
            rows = [getattr(iters[t][p], slot) for t in range(T)]
            d = rows[1] - rows[0]
            if any(rows[t] != rows[0] + t * d for t in range(T)):
                return None
            if d == 0:
                slots[slot] = ("k", rows[0])
            else:
                if stride is None:
                    stride = d
                elif d != stride:
                    return None
                slots[slot] = ("l", rows[0])
        refs.append(slots)
    if stride is None:
        return None               # nothing varies; vectorizing buys nothing

    # lanes must occupy disjoint row windows
    residues = [ref[1] for slots in refs for ref in slots.values()
                if ref[0] == "l"]
    if not residues or max(residues) - min(residues) >= abs(stride):
        return None
    affine_rows = {c + t * stride for c in residues for t in range(T)}
    const_rows = {ref[1] for slots in refs for ref in slots.values()
                  if ref[0] == "k"}
    if affine_rows & const_rows:
        return None

    # classify const rows by their first access within an iteration.
    # Rows whose first access is a predicated write may still be lane-
    # private scratch when complementary predicated passes are proven to
    # fully overwrite them (the float-program idiom) -- _coverage_kills
    # upgrades exactly those from "red" to "kill".
    const_written = set()
    for p in range(L):
        _, writes = _used_slots(iters[0][p])
        for slot in writes:
            if refs[p].get(slot, (None,))[0] == "k":
                const_written.add(refs[p][slot][1])
    covered = _coverage_kills(iters[0])
    const_kind: Dict[int, str] = {}
    for p in range(L):
        ins = iters[0][p]
        reads, writes = _used_slots(ins)
        for slot in reads:
            r = refs[p].get(slot)
            if not (r and r[0] == "k") or r[1] in const_kind:
                continue
            if slot == "dst" and r[1] in covered:
                continue      # covered row's own predicated-write mux
            const_kind[r[1]] = ("ro" if r[1] not in const_written
                                else "red")
        for slot in writes:
            r = refs[p].get(slot)
            if r and r[0] == "k" and r[1] not in const_kind:
                const_kind[r[1]] = ("kill" if not ins.pred
                                    or r[1] in covered else "red")

    # find where the serial suffix must begin: the first position that
    # touches a reduction row, or reads a carry/tag value inherited from
    # the previous iteration
    carry_in_body = any(i.op in _CARRY_WRITE for i in iters[0])
    tag_in_body = any(i.op in _TAG_WRITE for i in iters[0])
    carry_ok = not carry_in_body
    tag_ok = not tag_in_body
    serial_start = L
    for p, ins in enumerate(iters[0]):
        reads_carry = (ins.op in _CARRY_READ
                       or (ins.pred and ins.op in (OP_C0, OP_C1, OP_CROW)))
        reads_tag = ins.pred or ins.op in _TAG_READ
        touches_red = any(
            ref[0] == "k" and const_kind.get(ref[1]) == "red"
            for ref in refs[p].values())
        if ((reads_carry and not carry_ok) or (reads_tag and not tag_ok)
                or touches_red):
            serial_start = p
            break
        if not ins.pred and ins.op in _CARRY_KILL:
            carry_ok = True
        if ins.op in _TAG_KILL:
            tag_ok = True         # TC/TNC read carry: checked above
    if serial_start == 0:
        return None

    body = _to_refs(iters[0], lambda p, s: refs[p][s])
    prefix_ins = iters[0][:serial_start]
    return LanePlan(
        lanes=T, stride=stride, serial_start=serial_start,
        pre=pre, post=post, body=body, const_kind=const_kind,
        carry_in_prefix=any(i.op in _CARRY_WRITE for i in prefix_ins),
        tag_in_prefix=any(i.op in _TAG_WRITE for i in prefix_ins),
        carry_in_body=carry_in_body, tag_in_body=tag_in_body)


# ---------------------------------------------------------------------------
# Lowerings.  Every tensor update is out of place: row values held in the
# stores are views of an earlier ``arr`` and must keep their values, as
# the reference's immutable arrays do.
# ---------------------------------------------------------------------------
def _row(arr, r: int):
    """Static single-row read (a view)."""
    return arr[r]


def _lane_rows(arr, c: int, lanes: int, stride: int):
    """Rows ``c + t*stride`` for ``t < lanes`` as a ``(lanes, ...)``
    strided view (a copy when the stride is negative)."""
    if stride > 0:
        return arr[c:c + (lanes - 1) * stride + 1:stride]
    lo = c + (lanes - 1) * stride
    return arr[lo:c + 1:-stride].flip(0)


def _lane_last(v):
    """Final (lane T-1) view of a possibly lane-shaped value."""
    if isinstance(v, _Lazy):
        return _Lazy(v.src[-1], v.bit) if v.src.ndim == 2 else v
    return v if v.ndim == 1 else v[-1]


def _lane_at(v, t):
    if isinstance(v, _Lazy):
        return _Lazy(v.src[t], v.bit) if v.src.ndim == 2 else v
    return v if v.ndim == 1 else v[t]


def _scatter(ctx, arr, updates: Dict[int, torch.Tensor]):
    """One batched row update from a {row: value} dict."""
    if not updates:
        return arr
    rows = sorted(updates)
    vals = torch.stack(_mat_many(ctx, [updates[r] for r in rows]))
    return arr.index_copy(0, ctx.const(rows), vals)


def _run_flat(ctx, items, arr, store, carry, tag):
    """Run a flat ('k'-ref) segmented stream over a row store."""
    def read(ref):
        v = store.get(ref[1])
        if v is None:
            v = store[ref[1]] = _row(arr, ref[1])
        return v

    written = {}

    def write(ref, v):
        store[ref[1]] = written[ref[1]] = v

    m = _Machine(ctx, read, write, carry, tag,
                 peek=lambda ref: store.get(ref[1]))
    m.run(items)
    return written, m.carry, m.tag


def _consts_for(state, consts: dict) -> dict:
    """The constants cache a call may use: the lowered function's own
    for a call on plain tensors; a fresh dict for a call under a tracer
    (fake or proxy tensors), so no traced value ever enters the cache
    that later plain calls read."""
    return consts if type(state.array) is torch.Tensor else {}


def _io(state, cols: int, packed: bool, packed_io: bool):
    """Enter the interior's representation: (arr, carry, tag)."""
    if packed and not packed_io:
        return (pack_cols(state.array), pack_cols(state.carry),
                pack_cols(state.tag))
    return state.array, state.carry, state.tag


def _out(state, ctx, arr, carry, tag, packed_io: bool):
    """Leave the interior: a state of the input's representation."""
    carry, tag = _mat(ctx, carry), _mat(ctx, tag)
    if ctx.packed and not packed_io:
        return type(state)(unpack_cols(arr, ctx.cols),
                           unpack_cols(carry, ctx.cols),
                           unpack_cols(tag, ctx.cols))
    return type(state)(arr, carry, tag)


def _lower_flat(program: isa.Program, rows: int, cols: int, packed: bool,
                packed_io: bool = False):
    items = _segment(_flat_refs(program.expand()))
    consts: dict = {}

    def fn(state):
        ctx = _Ctx(cols, packed, state.array.device,
                   _consts_for(state, consts))
        arr, carry, tag = _io(state, cols, packed, packed_io)
        written, carry, tag = _run_flat(ctx, items, arr, {}, carry, tag)
        arr = _scatter(ctx, arr, written)
        return _out(state, ctx, arr, carry, tag, packed_io)

    fn.consts = consts
    return fn


@dataclasses.dataclass
class _LoopLow:
    """Per-loop static lowering data (shared by every call)."""
    plan: LanePlan
    prefix_items: list
    suffix_items: list
    suffix: list                 # raw suffix ref-stream
    suffix_affine_writes: set
    prefetch: list
    written_rows: set            # absolute rows the loop writes
    fold: Optional[list]         # foldable accumulate chain, or None


def _loop_static(plan: LanePlan) -> _LoopLow:
    T, s = plan.lanes, plan.stride
    prefix = plan.body[:plan.serial_start]
    suffix = plan.body[plan.serial_start:]
    suffix_affine_writes = {ins.dst[1] for ins in suffix
                            if ins.op in _WRITES_ROW and ins.dst[0] == "l"}

    # affine rows whose first body access is a read come straight from
    # the array (strided views, no copy)
    written_refs, prefetch = set(), []
    for ins in plan.body:
        reads, writes = _used_slots(ins)
        for slot in reads:
            ref = getattr(ins, slot)
            if (ref is not None and ref[0] == "l"
                    and ref not in written_refs
                    and ref[1] not in prefetch):
                prefetch.append(ref[1])
        if writes:
            written_refs.add(ins.dst)
    prefetch = sorted(prefetch)

    written_rows = set()
    for ins in plan.body:
        if ins.op in _WRITES_ROW:
            if ins.dst[0] == "k":
                written_rows.add(ins.dst[1])
            else:
                written_rows.update(ins.dst[1] + t * s for t in range(T))

    # the serial-suffix ACCUMULATION FOLD: a suffix that is exactly one
    # unpredicated in-place FA chain over shared reduction rows
    # (``acc += lane_value``, carry killed in the prefix) is T modular
    # adds -- associative, so the per-lane serial loop collapses into a
    # lane fold (kernels.bitplane_ops.lane_fold) plus one carry-exact
    # final add with the last lane.
    suffix_items = _segment(suffix)
    fold = None
    if len(suffix_items) == 1 and suffix_items[0][0] == "chain":
        run = suffix_items[0][1]
        a_refs = [c.a for c in run]
        prefix_writes = {ins.dst for ins in prefix if ins.op in _WRITES_ROW}
        if (run[0].op == OP_FA and not run[0].pred
                and all(c.dst == c.a for c in run)
                and all(r[0] == "k" for r in a_refs)
                and not ({c.b for c in run} & set(a_refs))
                and not (set(a_refs) & prefix_writes)
                and plan.carry_in_prefix):
            fold = run
    return _LoopLow(plan, _segment(prefix), suffix_items, suffix,
                    suffix_affine_writes, prefetch, written_rows, fold)


def _run_loop(ctx, ll: _LoopLow, arr, carry, tag, store):
    """Execute one planned loop against (arr, carry, tag).

    ``store`` caches const-row values across segments (reads reuse it;
    rows this loop writes are refreshed/invalidated on exit).
    """
    plan = ll.plan
    T, s = plan.lanes, plan.stride
    suffix = ll.suffix

    # ---- vectorized prefix: all lanes at once ----------------------------
    lane_store: Dict[tuple, torch.Tensor] = {}
    lane_written: Dict[tuple, bool] = {}
    for c in ll.prefetch:
        lane_store[("l", c)] = _lane_rows(arr, c, T, s)

    def lane_read(ref):
        v = lane_store.get(ref)
        if v is None:
            if ref[0] == "k":
                v = store.get(ref[1])
                if v is None:
                    v = _row(arr, ref[1])
            else:
                v = _lane_rows(arr, ref[1], T, s)
            lane_store[ref] = v
        return v

    def lane_write(ref, v):
        lane_store[ref] = v
        lane_written[ref] = True

    def lane_peek(ref):
        v = lane_store.get(ref)
        if v is None and ref[0] == "k":
            v = store.get(ref[1])
        return v

    # a poisoned latch would mean the analysis mis-ordered a kill;
    # reading it raises rather than miscomputing
    pm = _Machine(ctx, lane_read, lane_write,
                  None if plan.carry_in_prefix else carry,
                  None if plan.tag_in_prefix else tag,
                  peek=lane_peek)
    pm.run(ll.prefix_items)

    # ---- suffix ----------------------------------------------------------
    suffix_store: Dict[int, torch.Tensor] = {}
    suffix_lane_vals: Dict[int, list] = {c: [] for c
                                         in ll.suffix_affine_writes}
    if suffix and ll.fold is not None and pm.carry is ctx.empty:
        run = ll.fold
        m = len(run)

        def as_planes(vals):
            return [None if v is ctx.empty else v for v in vals]

        bplanes = []
        for c in run:
            v = lane_read(c.b)
            if v is ctx.empty:
                bplanes.append(None)
                continue
            v = _mat(ctx, v)
            if v.ndim == 1:        # shared row: same addend every lane
                v = v.expand((T,) + tuple(v.shape))
            bplanes.append(v)
        acc0 = []
        for c in run:
            v = store.get(c.a[1])
            v = _row(arr, c.a[1]) if v is None else _mat(ctx, v)
            acc0.append(v)
        acc0 = as_planes(acc0)
        if T > 1:
            main = [None if p is None else p[:T - 1] for p in bplanes]
            red = bitplane_ops.lane_fold(main, m, packed=ctx.packed)
            accm, _ = bitplane_ops.planes_add(acc0, red, None, width=m)
        else:
            accm = acc0
        last = [None if p is None else p[T - 1] for p in bplanes]
        # the final add runs carry-exact: its carry-out IS the latch the
        # last serial lane would have left (bit m of acc_{T-1} + b_{T-1})
        final, cout = bitplane_ops.planes_add(accm, last, None, width=m)
        for c, x in zip(run, final):
            suffix_store[c.a[1]] = ctx.empty if x is None else x
        carry = ctx.empty if cout is None else cout
        if plan.tag_in_prefix:
            tag = _lane_last(pm.tag)
    elif suffix:
        # chain operands produced by the prefix (e.g. idot's product
        # rows) are integer-summarized ONCE across all lanes here,
        # instead of once per lane inside the serial loop
        suffix_written = {ins.dst for ins in suffix
                          if ins.op in _WRITES_ROW}
        shared_ints: Dict[tuple, torch.Tensor] = {}
        for kind, run in ll.suffix_items:
            if kind not in ("chain", "andrun", "copyrun"):
                continue
            ref_lists = [[c.a for c in run]]
            if kind == "chain":
                ref_lists.append([c.b for c in run])
            for refs in ref_lists:
                key = tuple(refs)
                if key in shared_ints or (set(refs) & suffix_written):
                    continue
                shared_ints[key] = pm._int_of(refs, len(run))
        ser_carry = carry if not plan.carry_in_prefix else None
        ser_tag = tag if not plan.tag_in_prefix else None
        kill_scoped: Dict[int, torch.Tensor] = {}
        for t in range(T):
            # "kill" rows are lane-private scratch: every lane
            # overwrites them before reading, so suffix writes to
            # them must not leak into the next lane (which still
            # sees its own prefix value)
            kill_scoped = {}
            if t:
                # provenance written by the previous lane's suffix
                # (1-D sources) is stale for this lane on exactly
                # the lane-private refs: kill consts and affine
                # rows.  Prefix provenance (lane-shaped 2-D
                # sources, mapped by lane_view) and shared
                # reduction rows stay valid.
                for ref, (src, _b) in list(pm.prov.items()):
                    if getattr(src, "ndim", 1) == 2:
                        continue
                    if (ref[0] == "l"
                            or plan.const_kind.get(ref[1]) == "kill"):
                        del pm.prov[ref]

            def ser_read(ref, t=t, ks=kill_scoped):
                if ref[0] == "k":
                    r = ref[1]
                    if plan.const_kind.get(r) == "kill":
                        v = ks.get(r)
                        if v is None:
                            v = lane_store.get(ref)
                            return (_row(arr, r) if v is None
                                    else _lane_at(v, t))
                        return v
                    v = suffix_store.get(r)
                    if v is not None:
                        return v
                    v = lane_store.get(ref)
                    if v is not None:
                        return _lane_at(v, t)
                    v = store.get(r)
                    return _row(arr, r) if v is None else v
                lst = suffix_lane_vals.get(ref[1])
                if lst is not None and len(lst) > t:
                    return lst[t]
                v = lane_store.get(ref)
                if v is not None:
                    return _lane_at(v, t)
                return _row(arr, ref[1] + t * s)

            def ser_peek(ref, t=t, ks=kill_scoped):
                if ref[0] == "k":
                    r = ref[1]
                    for d in (ks, suffix_store, store):
                        if r in d:
                            return d[r]
                    return None
                lst = suffix_lane_vals.get(ref[1])
                if lst is not None and len(lst) > t:
                    return lst[t]
                return None

            def ser_write(ref, v, t=t, ks=kill_scoped):
                if ref[0] == "k":
                    if plan.const_kind.get(ref[1]) == "kill":
                        ks[ref[1]] = v
                    else:
                        suffix_store[ref[1]] = v
                else:
                    lst = suffix_lane_vals[ref[1]]
                    if len(lst) == t:      # first write this lane
                        lst.append(v)
                    else:                  # rewrite: last value wins
                        lst[t] = v

            sm = _Machine(
                ctx, ser_read, ser_write,
                _lane_at(pm.carry, t) if plan.carry_in_prefix
                else ser_carry,
                _lane_at(pm.tag, t) if plan.tag_in_prefix else ser_tag,
                prov=pm.prov, peek=ser_peek,
                lane_view=lambda v, t=t: v[t] if v.ndim == 2 else v,
                planes=False)
            for key, v in shared_ints.items():
                sm._int_cache[key] = v[t] if v.ndim == 2 else v
            sm.run(ll.suffix_items)
            ser_carry, ser_tag = sm.carry, sm.tag
        carry, tag = ser_carry, ser_tag
        # final values of lane-private rows rewritten by the last
        # lane's suffix override its prefix values
        suffix_store.update(kill_scoped)
    else:
        if plan.carry_in_body:
            carry = _lane_last(pm.carry)
        if plan.tag_in_body:
            tag = _lane_last(pm.tag)

    # ---- materialize final rows ------------------------------------------
    const_updates: Dict[int, torch.Tensor] = {}
    for ref in lane_written:
        if ref[0] == "k":
            const_updates[ref[1]] = _lane_last(lane_store[ref])
    const_updates.update(suffix_store)
    arr = _scatter(ctx, arr, const_updates)

    # all affine row groups land in one batched scatter
    aff_idx, aff_vals = [], []
    for ref in lane_written:            # prefix affine writes
        if ref[0] == "l" and ref[1] not in ll.suffix_affine_writes:
            aff_idx.extend(ref[1] + t * s for t in range(T))
            v = _mat(ctx, lane_store[ref])
            if v.ndim == 1:
                v = v.expand((T,) + tuple(v.shape))
            aff_vals.append(v)
    for c, lst in suffix_lane_vals.items():
        aff_idx.extend(c + t * s for t in range(T))
        aff_vals.append(_stack(_mat_many(ctx, lst)))
    if aff_idx:
        arr = arr.index_copy(0, ctx.const(aff_idx), torch.cat(aff_vals))

    # keep the cross-segment row store coherent: rows this loop wrote
    # are refreshed (const rows) or dropped (affine rows); everything
    # the loop left alone stays resident for the next segment
    for r in ll.written_rows:
        store.pop(r, None)
    for r, v in const_updates.items():
        store[r] = v
    return arr, carry, tag


def _lower_multi(program: isa.Program, rows: int, cols: int, packed: bool,
                 segs, packed_io: bool = False):
    """Lower a segmented program: flat runs + one `_run_loop` per plan.

    ``segs`` comes from :func:`analyze_multi`.  A shared row store keeps
    const rows resident across segment boundaries so chained loops don't
    re-read rows the previous segment just computed.
    """
    lowered = []
    for kind, payload in segs:
        if kind == "loop":
            lowered.append(("loop", _loop_static(payload)))
        else:
            lowered.append(("flat", _segment(_flat_refs(payload))))
    consts: dict = {}

    def fn(state):
        ctx = _Ctx(cols, packed, state.array.device,
                   _consts_for(state, consts))
        arr, carry, tag = _io(state, cols, packed, packed_io)
        store: Dict[int, torch.Tensor] = {}
        for kind, payload in lowered:
            if kind == "flat":
                written, carry, tag = _run_flat(ctx, payload, arr, store,
                                                carry, tag)
                arr = _scatter(ctx, arr, written)
            else:
                arr, carry, tag = _run_loop(ctx, payload, arr, carry, tag,
                                            store)
        return _out(state, ctx, arr, carry, tag, packed_io)

    fn.consts = consts
    return fn


def lower(program: isa.Program, rows: int, cols: int, packed: bool, *,
          packed_io: bool = False):
    """Lower ``program`` to a fn(CRState) -> CRState.

    The analysis runs here, once; the returned fn only emits tensor ops.
    ``packed_io`` (implies ``packed``) makes the fn take and return a
    state whose fields are already column-packed int32 words; callers
    that chain launches keep state packed end-to-end and skip the
    per-launch pack/unpack ladders entirely.  The fn runs on the device
    of the state it is given and never modifies that state; its
    ``consts`` attribute is the cache of device constants it keeps
    between calls (see :func:`_consts_for`).
    """
    if packed_io:
        packed = True
    meta = program.meta()
    if meta.max_row >= rows:
        raise ValueError(
            f"program {program.name!r} touches row {meta.max_row} but the "
            f"geometry has only {rows} rows")
    segs = analyze_multi(program)
    if segs is not None:
        return _lower_multi(program, rows, cols, packed, segs, packed_io)
    return _lower_flat(program, rows, cols, packed, packed_io)


# ---------------------------------------------------------------------------
# Graph-level CSE, the counterpart of the reference's jaxpr pass.  Big
# lowered programs (the float sequences, the 512-row idot programs)
# trace to graphs with repeated pure ops -- identical selects, mask
# extractions, pack/unpack ladders.  The function is traced once with
# ``make_fx`` on fake tensors (nothing runs on the device, no kernel
# launches), the graph's call nodes are deduplicated in one forward
# walk keyed on (target, canonicalised args, frozen kwargs), and the
# resulting ``GraphModule`` replays only what is left: no Python
# lowering logic, fewer ops.  Anything the walk cannot prove safe to key
# (mutation, aliasing of a mutated value, uninitialised or random
# factories, unknown argument types) is simply kept, so correctness
# never depends on coverage.
# ---------------------------------------------------------------------------
_SCALARS = (bool, int, str, type(None), torch.dtype, torch.device,
            torch.layout, torch.memory_format)


def _freeze(v):
    """Hashable snapshot of a node argument; None = give up.

    Nodes key by identity (earlier duplicates are already replaced);
    scalars key with their type, and floats by their exact bits, so
    ``1`` and ``True`` or ``0.0`` and ``-0.0`` never collide."""
    if isinstance(v, torch.fx.Node):
        return ("node", v)
    if isinstance(v, float):
        return ("float", v.hex())
    if isinstance(v, _SCALARS):
        return (type(v).__name__, v)
    if isinstance(v, (tuple, list)):
        parts = tuple(_freeze(x) for x in v)
        return None if any(p is None for p in parts) else ("seq", parts)
    if isinstance(v, dict):
        items = tuple((k, _freeze(x)) for k, x in sorted(v.items()))
        return None if any(p is None for _, p in items) else ("dict", items)
    return None


def _schema(node):
    t = node.target
    return t._schema if isinstance(t, torch._ops.OpOverload) else None


def _is_view(schema) -> bool:
    """An op whose output aliases an input (a view)."""
    return any(r.alias_info is not None for r in schema.returns)


def _uninitialised_or_random(target) -> bool:
    """``empty*`` / ``new_empty*`` factories (their values are whatever
    memory held) and ops that draw from a generator."""
    base = target._schema.name.split("::")[-1]
    return (base.startswith(("empty", "new_empty"))
            or torch.Tag.nondeterministic_seeded in target.tags)


def _mutated_aliases(graph) -> set:
    """Nodes whose value some op in ``graph`` writes in place, with every
    view of them and every node they are views of."""
    parent = {}

    def root(n):
        while n in parent:
            n = parent[n]
        return n

    written = []
    for node in graph.nodes:
        schema = _schema(node)
        if schema is None:
            continue
        if _is_view(schema) and node.args and \
                isinstance(node.args[0], torch.fx.Node):
            parent[node] = node.args[0]
        if schema.is_mutable:
            for arg, val in zip(schema.arguments, node.args):
                if arg.alias_info is not None and arg.alias_info.is_write \
                        and isinstance(val, torch.fx.Node):
                    written.append(val)
            for name, val in node.kwargs.items():
                arg = next((a for a in schema.arguments if a.name == name),
                           None)
                if arg is not None and arg.alias_info is not None \
                        and arg.alias_info.is_write \
                        and isinstance(val, torch.fx.Node):
                    written.append(val)
    roots = {root(n) for n in written}
    return {n for n in graph.nodes if root(n) in roots}


def _node_key(node, mutated: set, graph_mutates: bool):
    """The CSE key of a call node, or None when it must be kept."""
    if node.op != "call_function" or node in mutated:
        return None
    target = node.target
    if target is operator.getitem:
        pass                            # picks an output: pure
    elif isinstance(target, torch._ops.OpOverload):
        schema = target._schema
        if schema.is_mutable or _uninitialised_or_random(target):
            return None
        # a view shares its input's memory: two equal views hold equal
        # values only while nothing in the graph writes memory
        if _is_view(schema) and graph_mutates:
            return None
    else:
        return None
    if any(isinstance(a, torch.fx.Node) and a in mutated
           for a in node.all_input_nodes):
        return None
    args, kwargs = _freeze(node.args), _freeze(dict(node.kwargs))
    if args is None or kwargs is None:
        return None
    return (target, args, kwargs)


def n_call_nodes(gm) -> int:
    """Call nodes of a traced graph (the pass's unit of count)."""
    return sum(1 for n in gm.graph.nodes if n.op == "call_function")


def cse_graph(gm):
    """Common-subexpression-eliminate a traced ``GraphModule`` in place.

    One forward walk: each call node is keyed on (target, canonicalised
    args, frozen kwargs); a node whose key was seen is replaced by the
    earlier node everywhere and erased.  Then dead code is eliminated
    and the module recompiled.  Returns ``(gm, n_removed)``, the count
    of call nodes that went (the duplicates and what only they used).
    """
    graph = gm.graph
    before = n_call_nodes(gm)
    mutated = _mutated_aliases(graph)
    graph_mutates = any(
        (s := _schema(n)) is not None and s.is_mutable for n in graph.nodes)
    table: Dict = {}
    for node in list(graph.nodes):
        key = _node_key(node, mutated, graph_mutates)
        if key is None:
            continue
        hit = table.get(key)
        if hit is not None:
            node.replace_all_uses_with(hit)
            graph.erase_node(node)
        else:
            table[key] = node
    graph.eliminate_dead_code()
    graph.lint()
    gm.recompile()
    return gm, before - n_call_nodes(gm)


def _python_call(node):
    """The Python binding that computes ``node``'s aten op on its own
    arguments, or None to keep the ``OpOverload``.

    A graph calls ``torch.ops.aten.<op>.<overload>``, which parses its
    arguments against the schema on every call: 1-3 us more per op than
    the ``torch.<op>`` / ``Tensor.<op>`` bindings an eager run goes
    through, which on ~1000-op graphs costs more host time than the
    pass removes.  The binding of the same name dispatches to the same
    aten op.  Two ops have none: ``_to_copy`` of a dtype alone (which a
    trace records only for a real conversion) is ``Tensor.to``, and a
    unit-step ``slice`` of the traced static shape is ``narrow``."""
    t = node.target
    if t.namespace != "aten":
        return None
    name = t._schema.name.split("::")[1]
    args, kwargs = node.args, node.kwargs
    if name == "_to_copy":
        src = args[0].meta["val"].dtype if len(args) == 1 else None
        if set(kwargs) == {"dtype"} and kwargs["dtype"] != src:
            return torch.Tensor.to, args, kwargs
        return None
    if name == "slice":
        # aten::slice.Tensor(self, dim=0, start=None, end=None, step=1)
        x, dim, start, end, step = (*args, *(0, None, None, 1)[len(args) - 1:])
        if kwargs or step != 1:
            return None
        r = range(x.meta["val"].shape[dim])[start:end]
        return torch.narrow, (x, dim, r.start, len(r)), {}
    f = (getattr(torch.Tensor, name, None) if name.startswith("__")
         else getattr(torch._C._VariableFunctions, name, None))
    return None if f is None else (f, args, kwargs)


def bind_python_calls(gm):
    """Point each aten call node of ``gm`` at its Python binding (see
    :func:`_python_call`) and recompile; the graph computes the same
    ops on the same arguments.  Returns ``gm``."""
    for node in gm.graph.nodes:
        if node.op == "call_function" and \
                isinstance(node.target, torch._ops.OpOverload):
            call = _python_call(node)
            if call is not None:
                node.target, node.args, node.kwargs = call
    gm.recompile()
    return gm


def apply_cse(fn, *example_args):
    """``fn`` as a traced, CSE'd ``GraphModule``.

    ``example_args`` are the tensors (or pytrees of tensors, such as a
    ``CRState``) of a call to trace; ``fn`` is traced on fake tensors of
    their shapes, dtypes and devices, so it computes nothing and
    launches no kernel.  After :func:`cse_graph` the calls are bound to
    their Python bindings (:func:`bind_python_calls`).  The graph holds
    the devices its factories and constants were traced on: call it on
    those devices only.  On ANY failure the original ``fn`` is returned
    untouched, with a warning that names the error -- the pass is an
    optimization, never a correctness dependency.  The returned module
    carries a ``_cse_stats`` dict (``eqns_before``, ``eqns_after``,
    ``removed``: call nodes) for benchmarks.
    """
    from torch.fx.experimental.proxy_tensor import make_fx

    try:
        # traced through ``*args`` so defaulted parameters of ``fn``
        # stay out of the graph's signature
        gm = make_fx(lambda *args: fn(*args),
                     tracing_mode="fake")(*example_args)
        before = n_call_nodes(gm)
        gm, removed = cse_graph(gm)
        bind_python_calls(gm)
    except Exception as e:                              # noqa: BLE001
        warnings.warn(f"CSE trace failed ({type(e).__name__}: {e}); "
                      f"running the un-CSE'd function", RuntimeWarning,
                      stacklevel=2)
        return fn
    gm._cse_stats = {"eqns_before": before, "eqns_after": before - removed,
                     "removed": removed}
    return gm
