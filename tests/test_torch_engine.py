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
    rng = np.random.default_rng(18)
    prog, _ = programs.iadd(4, rows=64)
    st = _port(_np_state(rng, 64, 8, 2))
    with pytest.raises(NotImplementedError, match="faults"):
        engine.execute_blocks(prog, st, faults=_Faults(True))
    with pytest.raises(NotImplementedError, match="faults"):
        engine.run_chain([prog], _port(_np_state(rng, 64, 8)),
                         faults=_Faults(True))
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
