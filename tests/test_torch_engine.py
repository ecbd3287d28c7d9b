"""The port's engine against the reference engine on identical images.

Every executor of ``repro_torch.core.engine`` (``unroll``, ``scan``,
``compiled`` with the packed int32 and the bool interior) is held bit
for bit against ``repro.core.engine`` on the same seeded numpy states,
with the blocks, budget-padding, cache-key and packed-resident behaviour
of ``test_engine_executors.py`` / ``test_engine_blocks.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import bitplane as ref_bitplane  # noqa: E402
from repro.core import engine as ref_engine  # noqa: E402
from repro.core import programs as ref_programs  # noqa: E402
from repro_torch.core import (bitplane, engine, harness, isa,  # noqa: E402
                              programs)
from repro_torch.core.isa import Instr, Loop, Program, R, SetReg  # noqa: E402


def _np_state(rng, rows, cols, blocks=None):
    lead = () if blocks is None else (blocks,)
    return (rng.integers(0, 2, lead + (rows, cols)).astype(bool),
            rng.integers(0, 2, lead + (cols,)).astype(bool),
            rng.integers(0, 2, lead + (cols,)).astype(bool))


def _ref(fields):
    return ref_engine.CRState(*(jnp.asarray(f) for f in fields))


def _port(fields):
    return engine.state_from_numpy(*fields, device="cpu")


def _assert_same(port_state, ref_state, what=""):
    for i, name in enumerate(("array", "carry", "tag")):
        np.testing.assert_array_equal(
            engine.state_to_numpy(port_state)[i],
            np.asarray(getattr(ref_state, name)), err_msg=f"{what} {name}")


_EXECUTORS = [("unroll", None), ("scan", None), ("compiled", False),
              ("compiled", True)]


def _run_all(prog, fields):
    st = _port(fields)
    return {(ex, pk): engine.run(prog, st, ex, packed=pk)
            for ex, pk in _EXECUTORS}


# ---------------------------------------------------------------------------
# Every opcode, predicated or not, and the chain idioms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pred", [False, True])
def test_every_opcode_matches_reference(pred):
    rng = np.random.default_rng(10 + pred)
    rows, cols = 16, 8
    row_ops = sorted(isa._WRITES_ROW)
    latch_ops = sorted(set(range(isa.N_ARRAY_OPS)) - isa._WRITES_ROW)
    nodes = []
    for i, op in enumerate(row_ops + latch_ops):
        nodes.append(Instr(op, dst=(3 + i) % rows, a=(5 + 2 * i) % rows,
                           b=(1 + 3 * i) % rows, pred=pred))
        nodes.append(Instr(isa.OP_TROW, a=(7 * i) % rows))
    prog = Program(f"allops_pred{pred}", nodes)
    fields = _np_state(rng, rows, cols)
    want = ref_engine.run(prog, _ref(fields), "unroll")
    for key, got in _run_all(prog, fields).items():
        _assert_same(got, want, str(key))


def test_chain_idioms_match_reference():
    rng = np.random.default_rng(11)
    nodes = [
        Instr(isa.OP_C0),
        SetReg(1, 16), SetReg(2, 0), SetReg(3, 8),
        Loop(8, [Instr(isa.OP_FA, R(1), R(2), R(3),
                       inc=((1, 1), (2, 1), (3, 1)))]),
        Instr(isa.OP_TROW, a=40),
        Instr(isa.OP_C0),
        SetReg(1, 16), SetReg(2, 0),
        Loop(8, [Instr(isa.OP_FS, R(1), R(1), R(2),
                       inc=((1, 1), (2, 1)))]),
        Instr(isa.OP_CSTORE, 30),
        SetReg(1, 48), SetReg(2, 8),
        Loop(6, [Instr(isa.OP_AND, R(1), R(2), 41,
                       inc=((1, 1), (2, 1)))]),
    ]
    prog = Program("chains", nodes)
    fields = _np_state(rng, 64, 8)
    want = ref_engine.run(prog, _ref(fields), "unroll")
    for key, got in _run_all(prog, fields).items():
        _assert_same(got, want, str(key))


# ---------------------------------------------------------------------------
# The program set: all executors x interiors vs the reference
# ---------------------------------------------------------------------------
_GEN = {
    "iadd4": lambda p: p.iadd(4, rows=128),
    "iadd8": lambda p: p.iadd(8, rows=128),
    "isub8": lambda p: p.isub(8, rows=128),
    "imul4": lambda p: p.imul(4, rows=128),
    "imul8": lambda p: p.imul(8, rows=256),
    "idot4": lambda p: p.idot(4, rows=128),
    "idot8": lambda p: p.idot(8, rows=256),
    "vsearch8": lambda p: p.vsearch(8, rows=128),
    "vcmp_gt4": lambda p: p.vcmp_gt(4, rows=128),
    "bf16_dot": lambda p: p.bf16_dot(rows=512, tuples=2),
}


def _operands(rng, lay, cols):
    w = lay.fields["a"][1]
    out = {}
    for n in (n for n in lay.fields if n in ("a", "b", "q")):
        v = rng.integers(0, 1 << min(w, 16), (lay.tuples, cols),
                         dtype=np.uint64)
        out[n] = np.where(rng.random((lay.tuples, cols)) < 0.1, 0, v)
    return out


@pytest.mark.parametrize("name", sorted(_GEN))
def test_program_set_matches_reference(name):
    rng = np.random.default_rng(12)
    prog, lay = _GEN[name](programs)
    rprog, _ = _GEN[name](ref_programs)
    cols = 8
    img = harness.pack_state(lay, _operands(rng, lay, cols), cols)
    fields = (img, np.zeros(cols, bool), np.ones(cols, bool))
    want = ref_engine.run(rprog, _ref(fields), "unroll")
    for key, got in _run_all(prog, fields).items():
        _assert_same(got, want, f"{name} {key}")


def test_idot4_compiled_matches_reference_compiled():
    """The main path's program, compiled on both sides (packed)."""
    rng = np.random.default_rng(13)
    prog, lay = programs.idot(4, rows=128)
    rprog, _ = ref_programs.idot(4, rows=128)
    fields = _np_state(rng, 128, 40)
    want = ref_engine.run(rprog, _ref(fields), "compiled", packed=True)
    _assert_same(engine.run(prog, _port(fields), "compiled", packed=True),
                 want)


def test_golden_cycles_and_footprints():
    golden = {
        ("add", "int4"): (211, 6),
        ("add", "int8"): (190, 6),
        ("mul", "int4"): (931, 16),
        ("mul", "int8"): (1351, 16),
        ("dot", "int4"): (2820, 28),
        ("dot", "int8"): (3256, 28),
    }
    for key, (cycles, slots) in golden.items():
        prog, _ = programs.GENERATORS[key](rows=512)
        assert (prog.cycles(), prog.footprint()) == (cycles, slots), key


def test_run_rejects_unknown_executor_and_small_geometry():
    prog, _ = programs.iadd(4, rows=64)
    with pytest.raises(ValueError, match="unknown executor"):
        engine.run(prog, engine.make_state(64, 8, device="cpu"), "warp")
    big, _ = programs.iadd(8, rows=512)
    with pytest.raises(ValueError, match="rows"):
        engine.compile_program(big, rows=16, cols=8)


# ---------------------------------------------------------------------------
# Multi-block execution
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("blocks", [1, 3, 17])
def test_ragged_blocks_match_reference(blocks):
    """Block counts hitting budgets 1, 4 and 32: every port executor and
    interior == the reference's vmapped controller (scan), pad sliced
    away."""
    rng = np.random.default_rng(14)
    prog, _ = programs.idot(4, rows=128)
    rprog, _ = ref_programs.idot(4, rows=128)
    fields = _np_state(rng, 128, 8, blocks)
    want = ref_engine.execute_blocks(rprog, _ref(fields), "scan")
    st = _port(fields)
    for ex, packed in [("unroll", None), ("scan", None),
                       ("compiled", False), ("compiled", True),
                       ("compiled", None)]:
        got = engine.execute_blocks(prog, st, ex, packed=packed)
        assert got.array.shape == st.array.shape
        _assert_same(got, want, f"{ex} packed={packed}")


def test_canonical_block_budget_and_default_packed():
    assert [engine.canonical_block_budget(b) for b in
            (1, 2, 3, 4, 5, 17, 64, 65, 512, 513)] \
        == [1, 2, 4, 4, 8, 32, 64, 128, 512, 513]
    assert engine.default_packed(programs.iadd(8)[0])
    assert engine.default_packed(programs.idot(4)[0])
    assert not engine.default_packed(programs.idot(8)[0])
    assert not engine.default_packed(programs.bf16_dot(rows=512)[0])


def test_blocks_budget_cache_reuse():
    """Block counts 5..8 share the budget-8 compiled fn."""
    rng = np.random.default_rng(15)
    prog, _ = programs.iadd(8, rows=64)
    engine.execute_blocks(prog, _port(_np_state(rng, 64, 8, 5)))
    s0 = engine.compile_cache_stats()
    for blocks in (6, 7, 8, 5):
        out = engine.execute_blocks(prog, _port(_np_state(rng, 64, 8,
                                                          blocks)))
        assert out.array.shape == (blocks, 64, 8)
    s1 = engine.compile_cache_stats()
    assert s1["misses"] == s0["misses"]
    assert s1["hits"] >= s0["hits"] + 4


def test_cache_key_separates_packed_budget_and_program():
    engine.clear_compile_cache()
    p1, _ = programs.iadd(4, rows=64)
    p2, _ = programs.iadd(4, rows=64)
    f1 = engine.compile_program(p1, 64, 8)
    assert engine.compile_program(p2, 64, 8) is f1     # same content
    assert engine.compile_program(p1, 64, 8, packed=False) is not f1
    assert engine.compile_program(p1, 64, 8, cse=True) is not f1
    assert engine.compile_program(p1, 64, 16) is not f1
    rng = np.random.default_rng(16)
    n0 = len(engine._COMPILE_CACHE)
    engine.execute_blocks(p1, _port(_np_state(rng, 64, 8, 2)))
    engine.execute_blocks(p1, _port(_np_state(rng, 64, 8, 3)))   # budget 4
    engine.execute_blocks(p1, _port(_np_state(rng, 64, 8, 4)))   # reuse
    engine.execute_blocks(p1, _port(_np_state(rng, 64, 8, 4)),
                          packed=False)
    assert len(engine._COMPILE_CACHE) == n0 + 3


def test_compile_cache_is_bounded():
    engine.clear_compile_cache()
    try:
        engine.set_compile_cache_limit(2)
        for n in (4, 8, 16):
            engine.compile_program(programs.iadd(n, rows=128)[0], 128, 8)
        assert engine.compile_cache_stats()["size"] == 2
    finally:
        engine.set_compile_cache_limit(engine.COMPILE_CACHE_LIMIT)


def test_state_numpy_round_trip():
    rng = np.random.default_rng(17)
    for blocks in (None, 3):
        fields = _np_state(rng, 32, 8, blocks)
        back = engine.state_to_numpy(engine.state_from_numpy(
            *fields, device="cpu"))
        for f, b in zip(fields, back):
            assert b.dtype == np.bool_
            np.testing.assert_array_equal(f, b)


class _Faults:
    def __init__(self, active):
        self.active = active


def test_active_faults_raise_inactive_run():
    """An active fault model runs the faulted paths, bit-identical to
    the reference's with equal counters; an inactive one runs the plain
    path.  The name dates from when an active model raised, before the
    fault hooks were ported; it is kept so the test keeps its id."""
    from repro.core import faults as ref_faults
    from repro_torch.core import faults

    rng = np.random.default_rng(18)
    prog, _ = programs.iadd(4, rows=64)
    ref_prog, _ = ref_programs.iadd(4, rows=64)
    fields = _np_state(rng, 64, 8, 2)
    one = _np_state(rng, 64, 8)
    for scrub in (True, False):
        kw = dict(bit_rate=0.01, seed=7, scrub=scrub)
        fm, ref_fm = faults.FaultModel(**kw), ref_faults.FaultModel(**kw)
        _assert_same(engine.execute_blocks(prog, _port(fields), faults=fm),
                     ref_engine.execute_blocks(ref_prog, _ref(fields),
                                               faults=ref_fm), "blocks")
        _assert_same(engine.run_chain([prog, prog], _port(one), faults=fm),
                     ref_engine.run_chain([ref_prog, ref_prog], _ref(one),
                                          faults=ref_fm), "chain")
        assert fm.stats() == ref_fm.stats()
        assert fm.injected_flips > 0 and (fm.detected > 0) == scrub
    st = _port(fields)
    _assert_same(engine.execute_blocks(prog, st, faults=_Faults(False)),
                 engine.execute_blocks(prog, st, "unroll"))


def test_entry_points_default_to_cuda_and_raise_without(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.make_state(16, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        harness.make_torch_state(np.zeros((16, 8), bool))
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.state_from_numpy(np.zeros((16, 8), bool),
                                np.zeros(8, bool), np.ones(8, bool))
    assert engine.make_state(16, 8, device="cpu").array.device.type == "cpu"


# ---------------------------------------------------------------------------
# Packed-resident replay
# ---------------------------------------------------------------------------
def test_pack_block_states_match_reference():
    rng = np.random.default_rng(19)
    fields = _np_state(rng, 32, 8, 5)
    wide = engine.pack_block_states(_port(fields))
    rwide = ref_engine.pack_block_states(_ref(fields))
    assert wide.array.dtype == torch.int32
    for got, want in zip(wide, rwide):
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want))
    _assert_same(engine.unpack_block_states(wide, 5, 8), _ref(fields))


def test_compile_packed_replay_matches_reference():
    rng = np.random.default_rng(20)
    prog, _ = programs.idot(4, rows=128)
    rprog, _ = ref_programs.idot(4, rows=128)
    blocks, cols = 3, 8
    fields = _np_state(rng, 128, cols, blocks)
    fn = engine.compile_packed(prog, 128, blocks * cols)
    wide = engine.pack_block_states(_port(fields))
    for _ in range(2):
        wide = fn(wide)
    want = _ref(fields)
    for _ in range(2):
        want = ref_engine.execute_blocks(rprog, want, "scan")
    _assert_same(engine.unpack_block_states(wide, blocks, cols), want)


def test_run_chain_matches_reference():
    rng = np.random.default_rng(21)
    gens = [lambda p: p.iadd(8, rows=128), lambda p: p.imul(4, rows=128),
            lambda p: p.idot(4, rows=128), lambda p: p.iadd(8, rows=128)]
    fields = _np_state(rng, 128, 8)
    got = engine.run_chain([g(programs)[0] for g in gens], _port(fields))
    want = _ref(fields)
    for g in gens:
        want = ref_engine.run(g(ref_programs)[0], want, "unroll")
    _assert_same(got, want)


def test_bitplane_layout_helpers_match_reference():
    """int/bf16 <-> transposed bit planes, and row store/load, equal the
    reference's (values up to 32 bits, bf16 bit patterns)."""
    rng = np.random.default_rng(22)
    x = rng.integers(0, 1 << 32, 16, dtype=np.uint64)
    planes = bitplane.int_to_planes(torch.from_numpy(x.astype(np.int64)), 32)
    np.testing.assert_array_equal(
        planes.numpy(), np.asarray(ref_bitplane.int_to_planes(
            jnp.asarray(x.astype(np.uint32)), 32)))
    np.testing.assert_array_equal(bitplane.planes_to_int(planes).numpy(), x)
    np.testing.assert_array_equal(bitplane.np_int_to_planes(x, 32),
                                  ref_bitplane.np_int_to_planes(x, 32))
    f = rng.standard_normal(16).astype(np.float32)
    tb = torch.from_numpy(f).to(torch.bfloat16)
    bp_planes = bitplane.bf16_to_planes(tb)
    np.testing.assert_array_equal(
        bp_planes.numpy(), np.asarray(ref_bitplane.bf16_to_planes(
            jnp.asarray(f).astype(jnp.bfloat16))))
    assert torch.equal(bitplane.planes_to_bf16(bp_planes).view(torch.int16),
                       tb.view(torch.int16))
    arr = torch.zeros((8, 16), dtype=torch.bool)
    out = bitplane.store(arr, 2, planes[:4])
    assert not arr.any()                       # input left unchanged
    assert torch.equal(bitplane.load(out, 2, 4), planes[:4])


# ---------------------------------------------------------------------------
# The graph-level CSE pass
# ---------------------------------------------------------------------------
def test_cse_pass_bit_identical_and_smaller():
    """compile_program(cse=True) routes through the graph-level CSE
    pass: never more call nodes, identical results, and a distinct cache
    key from the un-CSE'd variant; both equal numpy and the reference's
    compile_program(cse=False)."""
    from repro.core import harness as ref_harness

    rng = np.random.default_rng(0)
    engine.clear_compile_cache()
    prog, lay = programs.idot(8, rows=128)
    rprog, _ = ref_programs.idot(8, rows=128)
    a = rng.integers(0, 256, (lay.tuples, 8), dtype=np.uint64)
    b = rng.integers(0, 256, (lay.tuples, 8), dtype=np.uint64)
    img = harness.pack_state(lay, {"a": a, "b": b}, 8)
    state = harness.make_torch_state(img, "cpu")
    f_raw = engine.compile_program(prog, 128, 8, cse=False)
    f_cse = engine.compile_program(prog, 128, 8, cse=True)
    assert f_raw is not f_cse          # resolved flag is in the cache key
    assert len(engine._COMPILE_CACHE) == 2
    assert isinstance(f_cse, engine.CSEProgram)
    gm = f_cse.trace("cpu")
    assert isinstance(gm, torch.fx.GraphModule)
    assert f_cse.graphs == {torch.device("cpu"): gm}
    stats = engine.last_cse_stats
    assert stats is not None and stats == gm._cse_stats
    assert 0 < stats["eqns_after"] <= stats["eqns_before"]
    raw, cse = f_raw(state).array.numpy(), f_cse(state).array.numpy()
    np.testing.assert_array_equal(raw, cse)
    np.testing.assert_array_equal(harness.unpack_acc(cse, lay),
                                  (a * b).sum(axis=0))
    want = ref_engine.compile_program(rprog, 128, 8, cse=False)(
        ref_harness.make_jax_state(img))
    np.testing.assert_array_equal(cse, np.asarray(want.array))


def test_cse_graph_pass_direct():
    """The raw pass: duplicate pure computations collapse; the CSE'd
    graph's outputs equal the original function's exactly."""
    from repro_torch.core import compiler

    def f(x):
        a = (x + 1.0) * 2.0
        b = (x + 1.0) * 2.0          # duplicate of a
        return a + b, a - b

    g = compiler.apply_cse(f, torch.zeros(8))
    assert g._cse_stats["removed"] >= 2
    x = torch.arange(8, dtype=torch.float32)
    for got, want in zip(g(x), f(x)):
        assert torch.equal(got, want)


def test_cse_graph_calls_the_python_bindings():
    """After the pass, aten calls go through their Python bindings:
    unit-step slices of every bound form become ``narrow`` with the
    same shape, strides and offset; a real dtype conversion becomes
    ``Tensor.to``; what has no binding keeps its ``OpOverload``.  The
    outputs equal the function's."""
    from repro_torch.core import compiler

    def f(x):
        return (x[:, 2:-1], x[:, -3:], x[1:100], x[:, 5:2], x[:, ::2],
                x.to(torch.int64), x[0] >> 1, torch.select(x, 0, 3) & x[2])

    x = torch.arange(60, dtype=torch.int32).reshape(6, 10)
    g = compiler.apply_cse(f, torch.zeros(6, 10, dtype=torch.int32))
    targets = [n.target for n in g.graph.nodes if n.op == "call_function"]
    assert targets.count(torch.narrow) == 4
    assert torch.Tensor.to in targets
    assert torch.ops.aten.slice.Tensor in targets         # the step-2 slice
    assert not any(t in (torch.ops.aten.select.int,
                         torch.ops.aten._to_copy.default) for t in targets)
    for got, want in zip(g(x), f(x)):
        assert torch.equal(got, want) and got.dtype == want.dtype
        assert got.stride() == want.stride()
        assert got.storage_offset() == want.storage_offset()


def test_cse_graph_keeps_mutation_uninitialised_and_random():
    """What the walk must not merge: a value written in place later
    (and what reads it), ``empty`` buffers, random draws; equal
    scalars of another type or sign stay apart."""
    from repro_torch.core import compiler

    def f(x):
        a = x * 2.0
        b = x * 2.0                  # a is written below: not merged
        a.add_(1.0)
        e1, e2 = torch.empty_like(x), torch.empty_like(x)
        r1, r2 = torch.rand_like(x), torch.rand_like(x)
        return a, b, e1, e2, r1, r2, x + 0.0, x + -0.0, x + 1, x + True

    g = compiler.apply_cse(f, torch.zeros(4))
    calls = [n.target for n in g.graph.nodes if n.op == "call_function"]
    assert calls.count(torch.mul) == 2      # the aten ops' Python bindings
    assert calls.count(torch.empty_like) == 2
    assert calls.count(torch.rand_like) == 2
    assert calls.count(torch.add) == 4
    assert calls.count(torch.ops.aten.add_.Tensor) == 1
    x = torch.arange(4, dtype=torch.float32)
    out = g(x)
    assert torch.equal(out[0], x * 2 + 1) and torch.equal(out[1], x * 2)
    assert not torch.equal(out[4], out[5])

    def g_views(x):                   # no mutation: equal views merge
        return x[1:3] + 1, x[1:3] + 1

    h = compiler.apply_cse(g_views, torch.zeros(4))
    assert h._cse_stats["removed"] == 2


def test_cse_trace_failure_falls_back_and_says_so():
    """A function the tracer cannot follow (a data-dependent Python
    branch) comes back untouched; the engine records no stats, counts
    the fallback and warns."""
    from repro_torch.core import compiler

    def f(x):
        return x + 1 if bool(x.sum() > 0) else x - 1

    x = torch.ones(3)
    with pytest.warns(RuntimeWarning, match="CSE trace failed"):
        assert compiler.apply_cse(f, x) is f
    n = engine.cse_counts["fallback"]
    with pytest.warns(RuntimeWarning, match="CSE trace failed"):
        assert engine._cse_pass(f, x) is f
    assert engine.last_cse_stats is None
    assert engine.cse_counts["fallback"] == n + 1


_CSE_PROGRAMS = {
    "bf16_add": lambda p: p.bf16_add(rows=512),
    "bf16_mul": lambda p: p.bf16_mul(rows=512),
    "idot4x58": lambda p: p.idot(4, rows=512),
    "idot8x28": lambda p: p.idot(8, rows=512),
}


@pytest.mark.parametrize("name", sorted(_CSE_PROGRAMS))
def test_cse_programs_at_512_rows_bit_identical(name):
    """The main path's and the float programs at 512 rows, each at its
    default interior: the CSE'd graph removes nodes and equals the
    un-CSE'd function bit for bit on a random state."""
    rng = np.random.default_rng(23)
    prog, _ = _CSE_PROGRAMS[name](programs)
    st = _port(_np_state(rng, 512, 40))
    raw = engine.compile_program(prog, 512, 40, cse=False)(st)
    fn = engine.compile_program(prog, 512, 40, cse=True)
    fn.trace("cpu")
    stats = engine.last_cse_stats
    assert stats["removed"] > 0
    assert 0 < stats["eqns_after"] <= stats["eqns_before"]
    for got, want in zip(fn(st), raw):
        assert torch.equal(got, want)


def test_cse_trace_leaves_the_constants_cache_real():
    """A trace runs the lowered function on fake tensors: its device
    constants go to a dict of its own, and the function's cache keeps
    only the real tensors of plain calls."""
    from repro_torch.core import compiler

    prog, _ = programs.idot(4, rows=512)
    raw = compiler.lower(prog, 512, 40, True)
    st = engine.make_state(512, 40, device="cpu")
    gm = compiler.apply_cse(raw, st)               # trace before any call
    assert isinstance(gm, torch.fx.GraphModule) and raw.consts == {}
    want = raw(st)
    n = len(raw.consts)
    assert n > 0
    assert compiler.apply_cse(raw, st) is not raw  # a trace after it
    assert len(raw.consts) == n
    assert all(type(t) is torch.Tensor for t in raw.consts.values())
    for got, w in zip(gm(st), raw(st)):
        assert torch.equal(got, w)
    for got, w in zip(want, raw(st)):
        assert torch.equal(got, w)


def test_cse_blocks_and_chain_match_reference():
    """execute_blocks (a CSE'd program, traced at the block budget; with
    ``cse=False`` the lowered function, cached apart) and
    run_chain(cse=True) equal the reference's outputs."""
    rng = np.random.default_rng(24)
    prog, _ = programs.idot(4, rows=512)
    rprog, _ = ref_programs.idot(4, rows=512)
    assert engine._use_cse(prog, None)
    fields = _np_state(rng, 512, 8, 3)
    got = engine.execute_blocks(prog, _port(fields))
    assert engine.last_cse_stats is not None
    _assert_same(got, ref_engine.execute_blocks(rprog, _ref(fields), "scan"),
                 "blocks")
    raw = engine.execute_blocks(prog, _port(fields), cse=False)
    for g, r in zip(got, raw):
        assert torch.equal(g, r)
    kinds = {k[6]: type(f) for k, f in engine._COMPILE_CACHE._d.items()
             if k[0] == "blocks" and k[2] == 4 and k[-1] == prog.fingerprint()}
    assert kinds[True] is engine.CSEProgram
    assert kinds[False] is not engine.CSEProgram
    gens = [lambda p: p.iadd(8, rows=128), lambda p: p.imul(4, rows=128),
            lambda p: p.iadd(8, rows=128)]
    one = _np_state(rng, 128, 8)
    engine.last_cse_stats = None
    got = engine.run_chain([g(programs)[0] for g in gens], _port(one),
                           cse=True)
    assert engine.last_cse_stats["eqns_after"] > 0
    want = _ref(one)
    for g in gens:
        want = ref_engine.run(g(ref_programs)[0], want, "unroll")
    _assert_same(got, want, "chain")
    pst = engine.pack_state(_port(one))
    fn = engine.compile_packed(gens[1](programs)[0], 128, 8, cse=True)
    out = engine.unpack_state(fn(pst), 8)
    _assert_same(out, ref_engine.run(gens[1](ref_programs)[0], _ref(one),
                                     "unroll"), "packed io")


def test_cse_graph_holds_the_fold_op_and_counts_like_eager(monkeypatch):
    """On the kernel route (packed planes; here a counting stand-in for
    the CUDA wrapper and the route forced on the CPU) the CSE'd idot4
    graph holds one ``repro_torch::lane_fold`` node per eager fold, and a
    call launches as many folds as an eager call: the trace itself
    launches none.  The route is patched before the compile, so the
    graph is traced on it."""
    from repro_torch.kernels import bitplane_ops as bp

    def fold(x, width):
        fold.launches += 1
        out = bp.lane_fold_torch(list(x), width)
        return torch.stack([torch.zeros_like(x[0, 0]) if p is None else p
                            for p in out])

    rng = np.random.default_rng(25)
    prog, _ = programs.idot(4, rows=512)
    st = _port(_np_state(rng, 512, 40))
    engine.clear_compile_cache()
    tree = engine.compile_program(prog, 512, 40)(st)
    fold.launches = 0
    monkeypatch.setattr(bp, "lane_fold_cuda", fold)
    monkeypatch.setattr(bp, "use_kernel_fold", lambda device, packed: packed)
    engine.clear_compile_cache()
    fn = engine.compile_program(prog, 512, 40)
    gm = fn.trace("cpu")
    assert fold.launches == 0
    assert fn.graphs == {torch.device("cpu"): gm}
    ops = [n for n in gm.graph.nodes
           if n.target is torch.ops.repro_torch.lane_fold.default]
    eager = fn.fn(st)
    per_call = fold.launches
    assert len(ops) == per_call >= 1
    got = fn(st)
    assert fold.launches == 2 * per_call
    for g, e, t in zip(got, eager, tree):
        assert torch.equal(g, e) and torch.equal(g, t)
    assert fn.graphs == {torch.device("cpu"): gm}


def test_lane_fold_op_fake_gives_the_plain_shape_and_dtype():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import bitplane_ops as bp

    rng = np.random.default_rng(26)
    for m, lanes, words, width in ((3, 5, 7, 6), (8, 57, 160, 15)):
        x = torch.from_numpy(rng.integers(-2**31, 2**31, (m, lanes, words),
                                          dtype=np.int64).astype(np.int32))
        plain = torch.stack([torch.zeros(words, dtype=torch.int32)
                             if p is None else p
                             for p in bp.lane_fold_torch(list(x), width)])
        with FakeTensorMode() as mode:
            out = torch.ops.repro_torch.lane_fold(mode.from_tensor(x), width)
        assert tuple(out.shape) == tuple(plain.shape) == (width, words)
        assert out.dtype == plain.dtype == torch.int32
    with pytest.raises(ValueError, match="CUDA tensor"):
        torch.ops.repro_torch.lane_fold(x, width)
