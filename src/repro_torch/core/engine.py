"""PyTorch execution engine for Compute RAM blocks.

The counterpart of ``repro.core.engine``.  A Compute RAM's main array is
a boolean tensor ``(rows, cols)`` plus per-column ``carry`` and ``tag``
latches (the logic peripherals of paper §III-A4).  Every micro-op
operates on *all columns simultaneously*.

Three executors (``run(..., executor=...)`` dispatches):

* :func:`execute` (``"unroll"``) -- one step per micro-op of the
  expanded stream.  The simplest oracle.
* :func:`execute_scan` (``"scan"``) -- the in-block controller: the
  program is assembled into opcode/operand arrays (host ints) and a
  loop fetches, decodes and executes one cycle per step.
* :func:`execute_compiled` (``"compiled"``) -- the stream lowered by
  :mod:`compiler` into a specialized function (batched row writes,
  optional 32-column int32 word packing, the lane fold on the CUDA
  kernel), built once per (program, geometry) and cached.

Every executor runs on the device of the state it is given and leaves
that state unchanged: ``unroll`` and ``scan`` copy the array once and
then update the copy in place.  Entry points that create state take
``device=None``, which means the GPU; they raise when there is none.
Many blocks run as one wide block through :func:`execute_blocks`.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from . import compiler, isa


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; raises when CUDA is absent.

    There is no CPU default: a caller who wants the CPU says so.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


class CRState(NamedTuple):
    """State of one Compute RAM block in compute mode."""
    array: torch.Tensor   # (rows, cols) bool -- the main array
    carry: torch.Tensor   # (cols,) bool -- per-column carry latch
    tag: torch.Tensor     # (cols,) bool -- per-column predication latch


def make_state(rows: int = 512, cols: int = 40, device=None) -> CRState:
    """Fresh block state (paper default geometry 512x40 = 20 Kb)."""
    dev = resolve_device(device)
    return CRState(
        array=torch.zeros((rows, cols), dtype=torch.bool, device=dev),
        carry=torch.zeros((cols,), dtype=torch.bool, device=dev),
        tag=torch.ones((cols,), dtype=torch.bool, device=dev),
    )


def state_from_numpy(array, carry, tag, device=None) -> CRState:
    """A state from numpy bool fields, with or without a leading block
    axis (the fields of a reference ``CRState`` as numpy arrays)."""
    dev = resolve_device(device)
    return CRState(*(torch.as_tensor(np.asarray(f, dtype=bool), device=dev)
                     for f in (array, carry, tag)))


def state_to_numpy(state: CRState):
    """``(array, carry, tag)`` of a state as numpy arrays."""
    return tuple(f.detach().cpu().numpy() for f in state)


# ---------------------------------------------------------------------------
# Executor 1: unroll
# ---------------------------------------------------------------------------
def _apply(arr, carry, tag, op: int, dst, a, b, pred: bool):
    """One micro-op; writes ``arr`` in place, returns (carry, tag)."""
    O = isa
    if op == O.OP_NOP:
        return carry, tag
    ra = arr[a]
    # tag / carry latch ops -------------------------------------------------
    if op in (O.OP_C0, O.OP_C1, O.OP_CROW):
        new_c = (torch.zeros_like(carry) if op == O.OP_C0
                 else torch.ones_like(carry) if op == O.OP_C1
                 else ra.clone())
        return (torch.where(tag, new_c, carry) if pred else new_c), tag
    if op == O.OP_TC:
        return carry, carry
    if op == O.OP_TNC:
        return carry, ~carry
    if op == O.OP_TROW:
        return carry, ra.clone()
    if op == O.OP_TNROW:
        return carry, ~ra
    if op == O.OP_T1:
        return carry, torch.ones_like(tag)
    if op == O.OP_TAND:
        return carry, tag & ra
    if op == O.OP_TOR:
        return carry, tag | ra
    if op == O.OP_TNOT:
        return carry, ~tag

    # row-writing ops ---------------------------------------------------------
    rb = arr[b]
    new_carry = carry
    if op == O.OP_COPY:
        val = ra
    elif op == O.OP_NOT:
        val = ~ra
    elif op == O.OP_AND:
        val = ra & rb
    elif op == O.OP_OR:
        val = ra | rb
    elif op == O.OP_XOR:
        val = ra ^ rb
    elif op == O.OP_NOR:
        val = ~(ra | rb)
    elif op == O.OP_FA:
        val = ra ^ rb ^ carry
        new_carry = (ra & rb) | (carry & (ra ^ rb))
    elif op == O.OP_FS:   # dst = a - b - borrow (carry latch holds borrow)
        val = ra ^ rb ^ carry
        new_carry = ((~ra) & rb) | (carry & (~(ra ^ rb)))
    elif op == O.OP_W0:
        val = torch.zeros_like(ra)
    elif op == O.OP_W1:
        val = torch.ones_like(ra)
    elif op == O.OP_CSTORE:
        val = carry
        new_carry = torch.zeros_like(carry)
    elif op == O.OP_TSTORE:
        val = tag
    else:
        raise ValueError(f"unknown opcode {op}")

    if pred:
        val = torch.where(tag, val, arr[dst])
        new_carry = torch.where(tag, new_carry, carry)
    arr[dst] = val
    return new_carry, tag


def execute(program: isa.Program, state: CRState) -> CRState:
    """Run ``program`` on ``state`` one micro-op at a time."""
    arr, carry, tag = state.array.clone(), state.carry, state.tag
    for ins in program.expand():
        carry, tag = _apply(arr, carry, tag, ins.op, ins.dst, ins.a, ins.b,
                            ins.pred)
    return CRState(arr, carry, tag)


# ---------------------------------------------------------------------------
# Executor 2: the in-block controller
# ---------------------------------------------------------------------------
def assemble(program: isa.Program):
    """Assemble the executed stream into dense operand arrays."""
    stream = program.expand()
    ops = np.array([i.op for i in stream], np.int32)
    dst = np.array([i.dst for i in stream], np.int32)
    a = np.array([i.a for i in stream], np.int32)
    b = np.array([i.b for i in stream], np.int32)
    pred = np.array([i.pred for i in stream], np.bool_)
    return ops, dst, a, b, pred


def _branches():
    """Opcode -> fn(ra, rb, rd, carry, tag) -> (row_value, new_carry,
    new_tag, writes_row): the decode table of the controller."""
    O = isa
    z, o = torch.zeros_like, torch.ones_like
    br = [None] * O.N_ARRAY_OPS
    br[O.OP_NOP] = lambda ra, rb, rd, c, t: (rd, c, t, False)
    br[O.OP_COPY] = lambda ra, rb, rd, c, t: (ra, c, t, True)
    br[O.OP_NOT] = lambda ra, rb, rd, c, t: (~ra, c, t, True)
    br[O.OP_AND] = lambda ra, rb, rd, c, t: (ra & rb, c, t, True)
    br[O.OP_OR] = lambda ra, rb, rd, c, t: (ra | rb, c, t, True)
    br[O.OP_XOR] = lambda ra, rb, rd, c, t: (ra ^ rb, c, t, True)
    br[O.OP_NOR] = lambda ra, rb, rd, c, t: (~(ra | rb), c, t, True)
    br[O.OP_FA] = lambda ra, rb, rd, c, t: (
        ra ^ rb ^ c, (ra & rb) | (c & (ra ^ rb)), t, True)
    br[O.OP_FS] = lambda ra, rb, rd, c, t: (
        ra ^ rb ^ c, ((~ra) & rb) | (c & (~(ra ^ rb))), t, True)
    br[O.OP_W0] = lambda ra, rb, rd, c, t: (z(ra), c, t, True)
    br[O.OP_W1] = lambda ra, rb, rd, c, t: (o(ra), c, t, True)
    br[O.OP_C0] = lambda ra, rb, rd, c, t: (rd, z(c), t, False)
    br[O.OP_C1] = lambda ra, rb, rd, c, t: (rd, o(c), t, False)
    br[O.OP_CROW] = lambda ra, rb, rd, c, t: (rd, ra.clone(), t, False)
    br[O.OP_CSTORE] = lambda ra, rb, rd, c, t: (c, z(c), t, True)
    br[O.OP_TC] = lambda ra, rb, rd, c, t: (rd, c, c, False)
    br[O.OP_TNC] = lambda ra, rb, rd, c, t: (rd, c, ~c, False)
    br[O.OP_TROW] = lambda ra, rb, rd, c, t: (rd, c, ra.clone(), False)
    br[O.OP_TNROW] = lambda ra, rb, rd, c, t: (rd, c, ~ra, False)
    br[O.OP_T1] = lambda ra, rb, rd, c, t: (rd, c, o(t), False)
    br[O.OP_TAND] = lambda ra, rb, rd, c, t: (rd, c, t & ra, False)
    br[O.OP_TOR] = lambda ra, rb, rd, c, t: (rd, c, t | ra, False)
    br[O.OP_TSTORE] = lambda ra, rb, rd, c, t: (t, c, t, True)
    br[O.OP_TNOT] = lambda ra, rb, rd, c, t: (rd, c, ~t, False)
    return br


_BRANCHES = _branches()


def execute_scan(program: isa.Program, state: CRState) -> CRState:
    """Run ``program`` with the controller: fetch the assembled operands
    of each cycle (host ints, so no device sync per cycle), decode the
    opcode through the branch table, then apply predication uniformly
    (a predicated cycle writes its row and carry only where tag is 1)."""
    ops, dst, a, b, pred = (x.tolist() for x in assemble(program))
    arr, carry, tag = state.array.clone(), state.carry, state.tag
    for op, d, ai, bi, p in zip(ops, dst, a, b, pred):
        rd = arr[d]
        val, new_carry, new_tag, writes = _BRANCHES[op](
            arr[ai], arr[bi], rd, carry, tag)
        if p:
            val = torch.where(tag, val, rd)
            new_carry = torch.where(tag, new_carry, carry)
        if writes:
            arr[d] = val
        carry, tag = new_carry, new_tag
    return CRState(arr, carry, tag)


# ---------------------------------------------------------------------------
# Executor 3: compiled.  See :mod:`compiler`; with ``packed=True`` the
# bool column axis is bit-packed into int32 words
# (:func:`compiler.pack_cols`) so one tensor op covers 32 columns.
# ---------------------------------------------------------------------------
pack_cols = compiler.pack_cols
unpack_cols = compiler.unpack_cols


class _LRUCache:
    """Bounded mapping with LRU eviction (insertion + touch order).

    Eviction only drops the host handle; re-compiling an evicted program
    is always correct, just slower.
    """

    def __init__(self, limit: int):
        self._d: OrderedDict = OrderedDict()
        self.limit = limit
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key):
        v = self._d.get(key)
        if v is None:
            self.misses += 1
            return None
        self.hits += 1
        self._d.move_to_end(key)
        return v

    def put(self, key, value):
        self._d[key] = value
        self._d.move_to_end(key)
        self._evict()
        return value

    def _evict(self):
        while len(self._d) > self.limit:
            self._d.popitem(last=False)
            self.evictions += 1

    def clear(self):
        self._d.clear()

    def __len__(self):
        return len(self._d)

    def __contains__(self, key):
        return key in self._d


# Module-level compiled-program cache: repeated replays compile once per
# (program content, geometry, representation).
COMPILE_CACHE_LIMIT = 64
_COMPILE_CACHE = _LRUCache(COMPILE_CACHE_LIMIT)

# Programs whose expanded stream is at least this many micro-ops resolve
# ``cse=None`` to True.  The flag only keeps the reference's cache key:
# the reference runs a jaxpr CSE pass there, the port has no such pass
# and runs the same function either way.
CSE_MIN_CYCLES = 1500

# Packed-by-default policy, as in the reference: programs up to this many
# expanded micro-ops resolve ``packed=None`` to the int32 bit-plane
# interior; above it (the long flat float sequences, and idot8) the bool
# interior is the default.
PACKED_DEFAULT_MAX_CYCLES = 2500

#: canonical wide-block compile budgets: `execute_blocks` rounds the
#: block count up to the next budget (zero-padding the batch) so ONE
#: compiled fn serves every count in (prev, budget].
BLOCK_BUDGETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


def default_packed(program: isa.Program) -> bool:
    """Resolve the ``packed=None`` default for ``program`` (see
    :data:`PACKED_DEFAULT_MAX_CYCLES`)."""
    return len(program.expand()) <= PACKED_DEFAULT_MAX_CYCLES


def canonical_block_budget(blocks: int) -> int:
    """Smallest canonical budget >= ``blocks`` (identity above the
    largest budget)."""
    for b in BLOCK_BUDGETS:
        if blocks <= b:
            return b
    return blocks


def set_compile_cache_limit(limit: int) -> None:
    """Re-bound the compiled-program cache (evicts LRU down to fit)."""
    if limit < 1:
        raise ValueError("cache limit must be >= 1")
    _COMPILE_CACHE.limit = limit
    _COMPILE_CACHE._evict()


def compile_cache_stats() -> dict:
    return {"size": len(_COMPILE_CACHE), "limit": _COMPILE_CACHE.limit,
            "hits": _COMPILE_CACHE.hits, "misses": _COMPILE_CACHE.misses,
            "evictions": _COMPILE_CACHE.evictions}


def _use_cse(program: isa.Program, cse) -> bool:
    """Resolve the cse flag (None = auto by expanded-stream size)."""
    if cse is not None:
        return bool(cse)
    return len(program.expand()) >= CSE_MIN_CYCLES


def compile_program(program: isa.Program, rows: int = 512, cols: int = 40,
                    *, packed: bool | None = None, cse: bool | None = None):
    """Compile ``program`` for a fixed geometry into ``fn(CRState) ->
    CRState``.

    The lowering's analysis runs once per cache key; a call only emits
    tensor ops, on the device of the state it is given.  Results are
    cached module-wide in a bounded LRU keyed on the program's
    fingerprint, the geometry and the resolved ``packed`` and ``cse``
    flags.  ``cse`` changes nothing in the port (see
    :data:`CSE_MIN_CYCLES`); it is kept so the API and the cache key
    match the reference.
    """
    use_cse = _use_cse(program, cse)
    if packed is None:
        packed = default_packed(program)
    key = (program.name, rows, cols, bool(packed), use_cse,
           program.fingerprint())
    fn = _COMPILE_CACHE.get(key)
    if fn is None:
        fn = _COMPILE_CACHE.put(key, compiler.lower(program, rows, cols,
                                                    packed))
    return fn


def clear_compile_cache() -> None:
    """Drop all cached compiled programs (tests / memory pressure)."""
    _COMPILE_CACHE.clear()


def execute_compiled(program: isa.Program, state: CRState,
                     *, packed: bool | None = None) -> CRState:
    """Run ``program`` through the specialized compiled path."""
    rows, cols = state.array.shape
    return compile_program(program, rows, cols, packed=packed)(state)


# ---------------------------------------------------------------------------
# Executor dispatch
# ---------------------------------------------------------------------------
EXECUTORS = ("unroll", "scan", "compiled")


def run(program: isa.Program, state: CRState, executor: str = "compiled",
        *, packed: bool | None = None) -> CRState:
    """Run ``program`` with the chosen executor (see module docstring)."""
    if executor == "unroll":
        return execute(program, state)
    if executor == "scan":
        return execute_scan(program, state)
    if executor == "compiled":
        return execute_compiled(program, state, packed=packed)
    raise ValueError(
        f"unknown executor {executor!r}; expected one of {EXECUTORS}")


# multi-block execution -----------------------------------------------------
def _to_wide(states: CRState) -> CRState:
    """``(blocks, rows, cols)`` batch -> one block of blocks*cols columns."""
    blocks, rows, cols = states.array.shape
    return CRState(
        array=states.array.movedim(0, 1).reshape(rows, blocks * cols),
        carry=states.carry.reshape(blocks * cols),
        tag=states.tag.reshape(blocks * cols))


def _from_wide(wide: CRState, blocks: int, cols: int) -> CRState:
    rows = wide.array.shape[0]
    return CRState(
        array=wide.array.reshape(rows, blocks, cols).movedim(1, 0),
        carry=wide.carry.reshape(blocks, cols),
        tag=wide.tag.reshape(blocks, cols))


def execute_blocks(program: isa.Program, states: CRState,
                   executor: str = "compiled",
                   *, packed: bool | None = None,
                   faults=None) -> CRState:
    """Run the same program on many blocks: states have a leading block dim.

    The compiled path exploits that every micro-op is column-parallel:
    B blocks of C columns are exactly one block of B*C columns, so the
    blocks run as a single wide block.  The block count is rounded up to
    the next canonical budget (:func:`canonical_block_budget`) and the
    batch zero-padded, so one compiled fn serves a whole range of ragged
    counts; columns are independent, so the pad columns cannot perturb
    the live ones and are sliced off on return.  The scan/unroll paths
    loop over the blocks.

    ``faults`` (a :class:`repro_torch.core.faults.FaultModel`, default
    None = pristine SRAM) injects seeded bit flips / dead-block garbage
    into the row-states before dispatch and parity-scrubs on the model's
    cadence; injection happens on the host before lowering, so packed
    and bool interiors see identical corruption.
    """
    if faults is not None and faults.active:
        from . import faults as faults_mod
        return faults_mod.apply_block_faults(
            program, states, faults, executor=executor, packed=packed)
    if executor == "compiled":
        blocks, rows, cols = states.array.shape
        if packed is None:
            packed = default_packed(program)
        budget = canonical_block_budget(blocks)
        use_cse = _use_cse(program, None)
        key = ("blocks", program.name, budget, rows, cols, bool(packed),
               use_cse, program.fingerprint())
        fn = _COMPILE_CACHE.get(key)
        if fn is None:
            inner = compiler.lower(program, rows, budget * cols, packed)

            def wide_fn(st: CRState, blocks=budget, cols=cols):
                return _from_wide(inner(_to_wide(st)), blocks, cols)

            fn = _COMPILE_CACHE.put(key, wide_fn)
        if budget != blocks:
            pad = budget - blocks
            padded = CRState(*(
                torch.cat([f, f.new_zeros((pad,) + tuple(f.shape[1:]))])
                for f in states))
            out = fn(padded)
            return CRState(*(f[:blocks] for f in out))
        return fn(states)
    if executor not in ("unroll", "scan"):
        raise ValueError(
            f"unknown executor {executor!r}; expected one of {EXECUTORS}")
    inner = execute if executor == "unroll" else execute_scan
    outs = [inner(program, CRState(*(f[i] for f in states)))
            for i in range(states.array.shape[0])]
    return CRState(*(torch.stack(f) for f in zip(*outs)))


# packed-resident execution -------------------------------------------------
#
# Replay loops (chained small programs) keep the state packed-resident:
# pack once, replay any number of launches on int32 words, unpack once.
def pack_state(state: CRState) -> CRState:
    """Column-pack every field of a state (bool -> int32 words)."""
    return CRState(pack_cols(state.array), pack_cols(state.carry),
                   pack_cols(state.tag))


def unpack_state(state: CRState, cols: int) -> CRState:
    """Invert :func:`pack_state` back to ``cols`` bool columns."""
    return CRState(unpack_cols(state.array, cols),
                   unpack_cols(state.carry, cols),
                   unpack_cols(state.tag, cols))


def pack_block_states(states: CRState) -> CRState:
    """Fuse a ``(blocks, rows, cols)`` batch into one packed wide state.

    Returns a packed single-block state of ``blocks * cols`` columns
    (``array`` is ``(rows, n_words)`` int32) -- the resident form the
    :func:`compile_packed` fns operate on.
    """
    return pack_state(_to_wide(states))


def unpack_block_states(wide: CRState, blocks: int, cols: int) -> CRState:
    """Invert :func:`pack_block_states` back to a block batch."""
    return _from_wide(unpack_state(wide, blocks * cols), blocks, cols)


def compile_packed(program: isa.Program, rows: int, cols: int,
                   *, cse: bool | None = None):
    """Compile ``program`` into a fn over *packed* states.

    The returned fn maps a packed state of ``cols`` total columns (see
    :func:`pack_state` / :func:`pack_block_states`) to a packed state:
    no per-launch pack/unpack ladder at all.  Bit-identical to the other
    executors after :func:`unpack_state`.  Cached like
    :func:`compile_program`.
    """
    use_cse = _use_cse(program, cse)
    key = ("pio", program.name, rows, cols, use_cse, program.fingerprint())
    fn = _COMPILE_CACHE.get(key)
    if fn is None:
        fn = _COMPILE_CACHE.put(key, compiler.lower(
            program, rows, cols, True, packed_io=True))
    return fn


def run_chain(programs, state: CRState, *, cse: bool | None = None,
              faults=None) -> CRState:
    """Run several programs back-to-back, state packed across launches.

    Pack once, run every program's packed-io body, unpack once.
    Bit-identical to ``for p in programs: state = run(p, state)``.
    Cached per chain fingerprint.

    An active ``faults`` model injects flips *between* chained programs,
    which needs the intermediate states on the host: the chain falls
    back to a sequential per-program replay (each leg still compiled and
    cached); the fused path is untouched when faults are off.
    """
    programs = tuple(programs)
    if faults is not None and faults.active:
        from . import faults as faults_mod
        return faults_mod.apply_chain_faults(programs, state, faults, cse=cse)
    if not programs:
        return state
    rows, cols = state.array.shape
    if cse is None:
        cse = sum(len(p.expand()) for p in programs) >= CSE_MIN_CYCLES
    key = ("chain", rows, cols, bool(cse),
           tuple(p.fingerprint() for p in programs))
    fn = _COMPILE_CACHE.get(key)
    if fn is None:
        bodies = [compiler.lower(p, rows, cols, True, packed_io=True)
                  for p in programs]

        def chain_fn(st: CRState):
            pst = pack_state(st)
            for body in bodies:
                pst = body(pst)
            return unpack_state(pst, cols)

        fn = _COMPILE_CACHE.put(key, chain_fn)
    return fn(state)
