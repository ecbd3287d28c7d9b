"""The port's fabric against the JAX package's, on the CPU.

``repro_torch.pim.fabric`` keeps the reference's scheduler, residency
sessions, repair, cost model and search, and runs every round launch on
the torch engine.  On identical numpy operands the two packages must
give bit-identical GEMM outputs (int4, int8, bf16, fused and mixed
precision), with sessions, KV appends, fault scrub and dead-block
repair on, equal fault counters, and equal schedules, costs and search
results field by field.  The fabric mode of the port's PIM linear layer
must equal its own mode ``ref`` and the JAX package's fabric mode.

Small block geometry (128 x 8, as ``tests/test_fabric.py``) keeps every
program small; the float programs need the default 512-row blocks.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import faults as ref_faults  # noqa: E402
from repro.core import ref as core_ref  # noqa: E402
from repro.pim import fabric as jf  # noqa: E402
from repro.pim import linear as jl  # noqa: E402
from repro_torch.core import engine, faults  # noqa: E402
from repro_torch.pim import cram  # noqa: E402
from repro_torch.pim import fabric as tf  # noqa: E402
from repro_torch.pim import linear as pl  # noqa: E402

ROWS, COLS = 128, 8


def _grids(n_blocks=4, **kw):
    """The same grid in both packages: (port cfg, JAX cfg)."""
    kw = {"rows": ROWS, "cols": COLS, **kw}
    return (tf.FabricConfig(n_blocks=n_blocks, **kw),
            jf.FabricConfig(n_blocks=n_blocks, **kw))


def _ints(rng, shape, bits, signed=True):
    lo, hi = (-(1 << (bits - 1)), 1 << (bits - 1)) if signed \
        else (0, 1 << bits)
    return rng.integers(lo, hi, shape).astype(np.int64)


def _same(a, b):
    """Dataclass trees of the two packages are equal field by field."""
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def _plain(obj):
    """Stats and reports with every dataclass as a dict, so the two
    packages' records compare by value."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    return obj


def _same_result(port, ref):
    """Equal outputs, float bit patterns, schedules and costs."""
    outs = getattr(port, "outs", None) or (port.out,)
    ref_outs = getattr(ref, "outs", None) or (ref.out,)
    assert len(outs) == len(ref_outs)
    for o, r in zip(outs, ref_outs):
        assert o.dtype == r.dtype and o.shape == r.shape
        np.testing.assert_array_equal(o, r)
    bits = getattr(port, "bits", None) or (getattr(port, "out_bits", None),)
    ref_bits = getattr(ref, "bits", None) or (getattr(ref, "out_bits", None),)
    for b, r in zip(bits, ref_bits):
        assert (b is None) == (r is None)
        if b is not None:
            np.testing.assert_array_equal(b, r)
    assert _same(port.schedule, ref.schedule)
    assert _same(port.cost, ref.cost)


COUNTERS = ("injected_flips", "injection_events", "detected", "repaired",
            "escaped", "refetch_bits", "scrub_rows", "parity_bits",
            "remaps")


def _models(**kw):
    return faults.FaultModel(**kw), ref_faults.FaultModel(**kw)


def _counters(fm):
    return {c: getattr(fm, c) for c in COUNTERS}


# ---------------------------------------------------------------------------
# Integer GEMMs: port == JAX == numpy
# ---------------------------------------------------------------------------
_MATRIX = [
    # (nbits, n_blocks, (M, K, N), signed): K/N/M not tile multiples
    (4, 1, (3, 10, 11), True),
    (4, 4, (2, 20, 16), True),
    (4, 64, (5, 23, 17), True),
    (4, 4, (3, 25, 13), False),
    (8, 4, (2, 23, 5), True),
    (8, 64, (3, 9, 10), True),
]


@pytest.mark.parametrize("nbits,blocks,shape,signed", _MATRIX,
                         ids=[f"int{n}-{b}blk-{'x'.join(map(str, s))}"
                              f"{'s' if sg else 'u'}"
                              for n, b, s, sg in _MATRIX])
def test_fabric_matmul_int_matches_reference(nbits, blocks, shape, signed):
    rng = np.random.default_rng(blocks * 100 + nbits)
    m, k, n = shape
    x, w = _ints(rng, (m, k), nbits, signed), _ints(rng, (k, n), nbits,
                                                     signed)
    cfg, ref_cfg = _grids(blocks)
    got = tf.fabric_matmul(x, w, nbits=nbits, cfg=cfg, signed=signed,
                           device="cpu")
    want = jf.fabric_matmul(x, w, nbits=nbits, cfg=ref_cfg, signed=signed)
    _same_result(got, want)
    np.testing.assert_array_equal(np.asarray(got.out, np.int64), x @ w)


def test_fused_program_matches_reference():
    """q/k/v-style fusion: three GEMMs sharing x in one program."""
    rng = np.random.default_rng(3)
    x = _ints(rng, (3, 21), 4)
    ws = [_ints(rng, (21, n), 4) for n in (9, 4, 4)]
    cfg, ref_cfg = _grids(6)
    got = tf.fabric_fused_matmul(x, ws, nbits=4, cfg=cfg, signed=True,
                                 names=("q", "k", "v"), device="cpu")
    want = jf.fabric_fused_matmul(x, ws, nbits=4, cfg=ref_cfg, signed=True,
                                  names=("q", "k", "v"))
    _same_result(got, want)
    for o, w in zip(got.outs, ws):
        np.testing.assert_array_equal(np.asarray(o, np.int64), x @ w)


@pytest.mark.parametrize("batch_rounds", [False, True])
def test_round_batching_and_chunks_match_reference(batch_rounds):
    """Per-round launches, and batched launches chunked below the round
    count (the last chunk zero-padded), against the reference."""
    rng = np.random.default_rng(4)
    x, w = _ints(rng, (7, 20, ), 4, False), _ints(rng, (20, 16), 4, False)
    cfg, ref_cfg = _grids(4)
    sched = tf.schedule_gemm(7, 20, 16, 4, cfg=cfg)
    ref_sched = jf.schedule_gemm(7, 20, 16, 4, cfg=ref_cfg)
    assert _same(sched, ref_sched)
    got = tf.execute_program(sched, x, (w,), batch_rounds=batch_rounds,
                             max_batch_blocks=12, device="cpu")
    want = jf.execute_program(ref_sched, x, (w,), batch_rounds=batch_rounds,
                              max_batch_blocks=12)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0].astype(np.int64), x @ w)
    np.testing.assert_array_equal(
        tf.execute_schedule(sched, x, w, device="cpu"), want[0])


def test_ragged_last_chunk_reuses_the_compiled_launch():
    """The last chunk of a group is zero-padded to the chunk shape, so a
    schedule of many chunks adds one wide compiled fn, not one per
    chunk shape."""
    rng = np.random.default_rng(5)
    x, w = _ints(rng, (9, 20), 4, False), _ints(rng, (20, 16), 4, False)
    cfg, _ = _grids(4)
    sched = tf.schedule_gemm(9, 20, 16, 4, cfg=cfg)
    chunk = 5                                  # rounds per launch
    assert len(sched.rounds) % chunk != 0      # a ragged last chunk
    engine.clear_compile_cache()
    out = tf.execute_program(sched, x, (w,),
                             max_batch_blocks=chunk * sched.n_compute,
                             device="cpu")[0]
    np.testing.assert_array_equal(out.astype(np.int64), x @ w)
    keys = [k for k in engine._COMPILE_CACHE._d if k[0] == "blocks"]
    assert len(keys) == 1, keys


# ---------------------------------------------------------------------------
# Float GEMMs (default 512-row blocks: the fused-MAC program needs them)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bf16_case():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 12)).astype(np.float32)
    w = rng.normal(size=(12, 9)).astype(np.float32)
    want = jf.fabric_matmul(x, w, nbits=8, signed=True, dtype="bf16",
                            cfg=jf.FabricConfig(n_blocks=4, cols=COLS))
    return x, w, want


def test_fabric_bf16_matches_reference(bf16_case):
    x, w, want = bf16_case
    got = tf.fabric_matmul(x, w, nbits=8, signed=True, dtype="bf16",
                           cfg=tf.FabricConfig(n_blocks=4, cols=COLS),
                           device="cpu")
    _same_result(got, want)
    # and the port's own float oracles on the same bit patterns
    xb, wb = (core_ref.to_bits(a, 8, 7) for a in (x, w))
    np.testing.assert_array_equal(got.out_bits, core_ref.float_matmul(
        xb, wb, 8, 7))
    np.testing.assert_array_equal(got.out_bits, cram.cram_fmatmul(
        xb, wb, "bf16", cols=COLS, device="cpu"))


def test_fabric_bf16_session_matches_reference(bf16_case):
    """bf16 GEMMs through a session in both packages: equal outputs,
    schedules and session records, and equal to the sessionless run."""
    x, w, want = bf16_case
    cfg = tf.FabricConfig(n_blocks=4, cols=COLS)
    ref_cfg = jf.FabricConfig(n_blocks=4, cols=COLS)
    sess, ref_sess = tf.FabricSession(cfg), jf.FabricSession(ref_cfg)
    for step in range(2):
        xs = x * (step + 1)
        sess.begin_step()
        ref_sess.begin_step()
        got = tf.fabric_matmul(xs, w, nbits=8, signed=True, dtype="bf16",
                               cfg=cfg, session=sess, device="cpu")
        ref = jf.fabric_matmul(xs, w, nbits=8, signed=True, dtype="bf16",
                               cfg=ref_cfg, session=ref_sess)
        _same_result(got, ref)
        if step == 0:
            np.testing.assert_array_equal(got.out_bits, want.out_bits)
    assert _plain(sess.stats()) == _plain(ref_sess.stats())


def test_mixed_precision_program_is_exact():
    """int4, int8 and bf16 GEMMs in one program on one grid: each class
    exact against its oracle, and the program equal to the reference's
    schedule and cost."""
    rng = np.random.default_rng(7)
    x = _ints(rng, (2, 12), 4).astype(np.float32)
    w4, w8 = _ints(rng, (12, 5), 4), _ints(rng, (12, 6), 8)
    wf = rng.normal(size=(12, 7)).astype(np.float32)
    cfg = tf.FabricConfig(n_blocks=6, cols=COLS)
    got = tf.fabric_fused_matmul(x, (w4, w8, wf), nbits=8, cfg=cfg,
                                 signed=True,
                                 dtypes=("int4", "int8", "bf16"),
                                 device="cpu")
    xi = x.astype(np.int64)
    np.testing.assert_array_equal(np.asarray(got.outs[0], np.int64),
                                  xi @ w4)
    np.testing.assert_array_equal(np.asarray(got.outs[1], np.int64),
                                  xi @ w8)
    np.testing.assert_array_equal(got.bits[2], core_ref.float_matmul(
        core_ref.to_bits(x, 8, 7), core_ref.to_bits(wf, 8, 7), 8, 7))
    ref_sched = jf.schedule_program(
        tuple(jf.GemmSpec(f"gemm{g}", 2, 12, n, dtype=d) for g, (n, d)
              in enumerate(((5, "int4"), (6, "int8"), (7, "bf16")))),
        8, cfg=jf.FabricConfig(n_blocks=6, cols=COLS), signed=True)
    assert _same(got.schedule, ref_sched)
    assert _same(got.cost, jf.schedule_cost(ref_sched))


# ---------------------------------------------------------------------------
# Sessions and KV appends
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nbits", [4, 8])
def test_session_decode_matches_reference(nbits):
    rng = np.random.default_rng(8 + nbits)
    cfg, ref_cfg = _grids(8)
    sess, ref_sess = tf.FabricSession(cfg), jf.FabricSession(ref_cfg)
    ws = [_ints(rng, (20, n), nbits) for n in (12, 4)]
    for step in range(3):
        x = _ints(rng, (2, 20), nbits)
        sess.begin_step()
        ref_sess.begin_step()
        got = tf.fabric_fused_matmul(x, ws, nbits=nbits, cfg=cfg,
                                     signed=True, session=sess,
                                     device="cpu")
        want = jf.fabric_fused_matmul(x, ws, nbits=nbits, cfg=ref_cfg,
                                      signed=True, session=ref_sess)
        _same_result(got, want)
        cold = tf.fabric_fused_matmul(x, ws, nbits=nbits, cfg=cfg,
                                      signed=True, device="cpu")
        for a, b in zip(got.outs, cold.outs):
            np.testing.assert_array_equal(a, b)
    assert _plain(sess.stats()) == _plain(ref_sess.stats())
    if nbits == 4:      # int8 tiles overflow the 1 Kb blocks: LRU refetch
        assert tuple(sess.trajectory().w_fetches[1:]) == (0, 0)


def test_attention_block_matches_reference_over_three_steps():
    rng = np.random.default_rng(9)
    d, hd = 16, 8
    wq, wk, wv = (rng.normal(size=(d, hd)).astype(np.float32) * 0.3
                  for _ in range(3))
    wo = rng.normal(size=(hd, d)).astype(np.float32) * 0.3
    cfg, ref_cfg = _grids(8)
    blk = tf.FabricAttentionBlock(wq, wk, wv, wo, cfg=cfg, bits=8, window=4,
                                  device="cpu")
    ref_blk = jf.FabricAttentionBlock(wq, wk, wv, wo, cfg=ref_cfg, bits=8,
                                      window=4)
    for _ in range(3):
        x = rng.normal(size=(d,)).astype(np.float32)
        y, st = blk.decode_step(x)
        ry, rst = ref_blk.decode_step(x)
        assert y.dtype == ry.dtype
        np.testing.assert_array_equal(y, ry)
        assert _plain(st) == _plain(rst)
    np.testing.assert_array_equal(blk.k_cache, ref_blk.k_cache)
    np.testing.assert_array_equal(blk.v_cache, ref_blk.v_cache)
    assert _plain(blk.report()) == _plain(ref_blk.report())
    assert blk.report()["kv"]["k"]["len"] == 3


def test_probe_matches_reference_with_autotune_and_session():
    rng = np.random.default_rng(10)
    ws = [rng.normal(size=(16, n)).astype(np.float32) for n in (8, 4)]
    cfg, ref_cfg = _grids(8)
    probe = tf.FabricLinearProbe(ws, cfg=cfg, bits=8, max_steps=2,
                                 autotune=True, session=True, device="cpu")
    ref_probe = jf.FabricLinearProbe(ws, cfg=ref_cfg, bits=8, max_steps=2,
                                     autotune=True, session=True)
    for m in (2, 3):
        x = rng.normal(size=(m, 16)).astype(np.float32)
        for a, b in zip(probe.observe(x), ref_probe.observe(x)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(probe.observe_ref(x), ref_probe.observe_ref(x)):
            np.testing.assert_array_equal(a, b)
    assert probe.done and probe.observe(x) is None
    assert _plain(probe.report()) == _plain(ref_probe.report())


def test_attention_scores_match_reference():
    rng = np.random.default_rng(11)
    q = rng.normal(size=(1, 3, 2, 8)).astype(np.float32)
    k = rng.normal(size=(1, 5, 2, 8)).astype(np.float32)
    cfg, ref_cfg = _grids(4)
    s, si, costs = tf.fabric_attention_scores(q, k, cfg=cfg, bits=8,
                                              device="cpu")
    rs, rsi, rcosts = jf.fabric_attention_scores(q, k, cfg=ref_cfg, bits=8)
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(si, rsi)
    assert [dataclasses.asdict(c) for c in costs] \
        == [dataclasses.asdict(c) for c in rcosts]


# ---------------------------------------------------------------------------
# Fault scrub and dead-block repair on the fabric
# ---------------------------------------------------------------------------
def _fault_gemm(seed=12, m=6, k=40, n=5):
    rng = np.random.default_rng(seed)
    return _ints(rng, (m, k), 4), _ints(rng, (k, n), 4)


@pytest.mark.parametrize("scrub", [True, False])
def test_fabric_scrub_matches_reference(scrub):
    x, w = _fault_gemm()
    cfg, ref_cfg = _grids(8, cols=16)
    fm, ref_fm = _models(bit_rate=2e-3, seed=0, scrub=scrub)
    got = tf.fabric_matmul(x, w, nbits=4, signed=True, cfg=cfg, faults=fm,
                           device="cpu")
    want = jf.fabric_matmul(x, w, nbits=4, signed=True, cfg=ref_cfg,
                            faults=ref_fm)
    _same_result(got, want)
    assert _counters(fm) == _counters(ref_fm) and fm.injected_flips > 0
    exact = np.array_equal(np.asarray(got.out, np.int64), x @ w)
    assert exact == scrub
    if scrub:
        assert fm.detected > 0 and "+faults" in got.cost.name


@pytest.mark.parametrize("case", ["spare-remap", "degraded"])
def test_fabric_repair_matches_reference(case):
    x, w = _fault_gemm(seed=13)
    if case == "spare-remap":
        cfg, ref_cfg = _grids(8, cols=16, spare_blocks=2)
        fm, ref_fm = _models(dead_blocks=(2,), seed=0)
    else:
        cfg, ref_cfg = _grids(8, cols=16)
        fm, ref_fm = _models(dead_blocks=(1, 3), seed=0)
    got = tf.fabric_matmul(x, w, nbits=4, signed=True, cfg=cfg, faults=fm,
                           device="cpu")
    want = jf.fabric_matmul(x, w, nbits=4, signed=True, cfg=ref_cfg,
                            faults=ref_fm)
    _same_result(got, want)
    assert _counters(fm) == _counters(ref_fm) and fm.remaps > 0
    np.testing.assert_array_equal(np.asarray(got.out, np.int64), x @ w)
    # repair_program alone, on the same schedule, gives the same plan
    sched = tf.schedule_gemm(6, 40, 5, 4, cfg=cfg, signed=True)
    ref_sched = jf.schedule_gemm(6, 40, 5, 4, cfg=ref_cfg, signed=True)
    fm2, ref_fm2 = _models(dead_blocks=fm.dead_blocks, seed=0)
    assert _same(tf.repair_program(sched, fm.dead_blocks, fm=fm2),
                 jf.repair_program(ref_sched, fm.dead_blocks, fm=ref_fm2))
    assert _counters(fm2) == _counters(ref_fm2)


def test_scrub_under_a_session_invalidates_like_reference():
    x, w = _fault_gemm(seed=14)
    cfg, ref_cfg = _grids(8, cols=16)
    sess, ref_sess = tf.FabricSession(cfg), jf.FabricSession(ref_cfg)
    fm, ref_fm = _models(bit_rate=2e-2, seed=0)
    for faulted in (False, True, False):
        sess.begin_step()
        ref_sess.begin_step()
        got = tf.fabric_matmul(x, w, nbits=4, signed=True, cfg=cfg,
                               session=sess, faults=fm if faulted else None,
                               device="cpu")
        want = jf.fabric_matmul(x, w, nbits=4, signed=True, cfg=ref_cfg,
                                session=ref_sess,
                                faults=ref_fm if faulted else None)
        _same_result(got, want)
    assert _plain(sess.stats()) == _plain(ref_sess.stats())
    assert _counters(fm) == _counters(ref_fm)
    assert sess.steps[-1]["w_fetches"] > 0          # scrubbed -> refetch


def test_unrepaired_dead_block_refuses_to_launch():
    rng = np.random.default_rng(15)
    x = rng.integers(0, 16, (6, 40)).astype(np.uint64)
    w = rng.integers(0, 16, (40, 5)).astype(np.uint64)
    cfg, _ = _grids(4)
    sched = tf.schedule_program((tf.GemmSpec("g", 6, 40, 5),), nbits=4,
                                cfg=cfg)
    used = [b for b in range(4) if sched.modes[b] in ("compute", "storage")]
    with pytest.raises(tf.FabricFaultError):
        tf.execute_program(sched, x, (w,), device="cpu",
                           faults=faults.FaultModel(dead_blocks=(used[0],)))
    with pytest.raises(tf.FabricFaultError):
        tf.fabric_matmul(x, w, nbits=4, cfg=_grids(2)[0], device="cpu",
                         faults=faults.FaultModel(dead_blocks=(0, 1)))


# ---------------------------------------------------------------------------
# Schedules, costs and search: numpy on both sides, equal field by field
# ---------------------------------------------------------------------------
_SPECS = {
    "single": ((("g", 5, 23, 17, None),), 4, 8, {}),
    "fused": ((("q", 4, 30, 12, None), ("k", 4, 30, 4, None),
               ("v", 4, 30, 4, None)), 4, 6, {"placement": "interleaved"}),
    "int8-spill": ((("g", 2, 7, 5, None),), 8, 1, {}),
    "mixed": ((("a", 2, 12, 5, "int4"), ("b", 2, 12, 7, "bf16")), 8, 6,
              {"rows": 512}),
    "no-residency": ((("g", 6, 20, 9, None),), 4, 4, {"residency": False}),
}


@pytest.mark.parametrize("name", sorted(_SPECS))
def test_schedules_costs_and_search_match_reference(name):
    specs, nbits, blocks, kw = _SPECS[name]
    cfg, ref_cfg = _grids(blocks, **kw)
    sp = tuple(tf.GemmSpec(*s) for s in specs)
    rsp = tuple(jf.GemmSpec(*s) for s in specs)
    sched = tf.schedule_program(sp, nbits, cfg=cfg, signed=True)
    ref_sched = jf.schedule_program(rsp, nbits, cfg=ref_cfg, signed=True)
    assert _same(sched, ref_sched)
    assert sched.describe() == ref_sched.describe()
    assert _same(tf.schedule_cost(sched), jf.schedule_cost(ref_sched))
    assert tf.residency_stats(sched) == jf.residency_stats(ref_sched)
    res = tf.search_program(sp, nbits, base=cfg, signed=True,
                            geometries=((cfg.rows, cfg.cols),))
    ref_res = jf.search_program(rsp, nbits, base=ref_cfg, signed=True,
                                geometries=((cfg.rows, cfg.cols),))
    assert _same(res.schedule, ref_res.schedule)
    assert _same(res.cost, ref_res.cost)
    assert res.candidates == ref_res.candidates
    assert res.describe() == ref_res.describe()
    assert _same(tf.combine_costs("t", [res.cost, tf.schedule_cost(sched)]),
                 jf.combine_costs("t", [ref_res.cost,
                                        jf.schedule_cost(ref_sched)]))


def test_search_schedule_over_geometries_matches_reference():
    cfg, ref_cfg = _grids(8)
    geoms = ((128, 8), (256, 16), (512, 40))
    res = tf.search_schedule(4, 40, 24, 4, base=cfg, signed=True,
                             geometries=geoms)
    ref_res = jf.search_schedule(4, 40, 24, 4, base=ref_cfg, signed=True,
                                 geometries=geoms)
    assert _same(res.schedule, ref_res.schedule)
    assert res.candidate_table() == ref_res.candidate_table()


# ---------------------------------------------------------------------------
# The PIM linear layer in fabric mode
# ---------------------------------------------------------------------------
def _linear_params(seed, shapes, bits):
    """Packed linears made by the reference, in both packages."""
    rc = jl.PimConfig(weight_bits=bits)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(shapes))
    ref = [jl.pack_linear(jl.linear_init(kk, k, n, rc), rc)
           for kk, (k, n) in zip(keys, shapes)]
    port = pl.params_from_numpy(
        [jax.tree_util.tree_map(np.asarray, p) for p in ref], device="cpu")
    return port, ref


@pytest.mark.parametrize("wbits,abits", [(4, 4), (4, 8)])
def test_fabric_linear_equals_ref_mode_and_reference(wbits, abits):
    port, ref = _linear_params(20 + abits, [(32, 8), (32, 5)], wbits)
    cfg, ref_cfg = _grids(6)
    kw = dict(weight_bits=wbits, act_bits=abits)
    xn = np.random.default_rng(abits).normal(size=(2, 3, 32)).astype(
        np.float32)
    x = torch.from_numpy(xn).to(torch.bfloat16)
    xj = jax.numpy.asarray(xn).astype(jax.numpy.bfloat16)
    fab = pl.PimConfig(mode="fabric", fabric=cfg, **kw)
    refm = pl.PimConfig(mode="ref", **kw)
    got = pl.fused_linear_apply(port, x, fab)
    want = jl.fused_linear_apply(ref, xj, jl.PimConfig(
        mode="fabric", fabric=ref_cfg, **kw))
    for g, p, r in zip(got, port, want):
        assert g.dtype == torch.bfloat16 and g.shape == (2, 3, p[
            "w_scale"].shape[0])
        assert torch.equal(g.view(torch.int16),
                           pl.linear_apply(p, x, refm).view(torch.int16))
        assert torch.equal(g.view(torch.int16),
                           pl.linear_apply(p, x, fab).view(torch.int16))
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      np.asarray(r).view(np.int16))


def test_fabric_linear_with_autotune_and_session():
    port, ref = _linear_params(30, [(32, 8), (32, 8)], 8)
    cfg, ref_cfg = _grids(8)
    sess, ref_sess = tf.FabricSession(cfg), jf.FabricSession(ref_cfg)
    kw = dict(weight_bits=8, act_bits=8, fabric_autotune=True)
    fab = pl.PimConfig(mode="fabric", fabric=cfg, fabric_session=sess, **kw)
    ref_fab = jl.PimConfig(mode="fabric", fabric=ref_cfg,
                           fabric_session=ref_sess, **kw)
    assert hash(fab) is not None
    rng = np.random.default_rng(31)
    for _ in range(2):
        xn = rng.normal(size=(1, 32)).astype(np.float32)
        sess.begin_step()
        ref_sess.begin_step()
        got = pl.fused_linear_apply(port, torch.from_numpy(xn), fab)
        want = jl.fused_linear_apply(ref, jax.numpy.asarray(xn), ref_fab)
        for g, r in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert _plain(sess.stats()) == _plain(ref_sess.stats())
    assert sess.trajectory().w_fetches[1] == 0


def test_fabric_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones((2, 4), np.int64)
    cfg, _ = _grids(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.fabric_matmul(x, x.T, nbits=4, cfg=cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.execute_schedule(tf.schedule_gemm(2, 4, 2, 4, cfg=cfg), x, x.T)
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.FabricAttentionBlock(*(np.ones((4, 2), np.float32),) * 3,
                                np.ones((2, 4), np.float32), cfg=cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.FabricLinearProbe(np.ones((4, 2), np.float32), cfg=cfg)


def test_smoke_fabric_phases_count_their_kernel(monkeypatch):
    """``chip_smoke``'s fabric phases at smoke widths on the CPU, with a
    counting stand-in for the ``lane_fold`` kernel taken wherever packed
    planes fold: the fabric path launches it once per round launch, and
    every phase's checks pass."""
    import sys
    from pathlib import Path

    from repro_torch.configs import get_config
    from repro_torch.kernels import bitplane_ops as bp

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    def fold(x, width):
        fold.launches += 1
        out = bp.lane_fold_torch(list(x), width)
        return torch.stack([torch.zeros_like(x[0, 0]) if p is None else p
                            for p in out])

    fold.launches = 0
    monkeypatch.setattr(bp, "lane_fold_cuda", fold)
    monkeypatch.setattr(bp, "use_kernel_fold", lambda device, packed: packed)
    cfg = get_config("qwen2-0.5b", True)
    grid, _ = _grids(8)
    launches, groups = chip_smoke.phase_fabric_layer(0, dev="cpu", cfg=cfg,
                                                     fabric_cfg=grid)
    assert launches == sum(g["execute_blocks_launches"]
                           for g in groups.values()) > 0
    assert [g["lane_fold_launches"] for g in groups.values()] \
        == [g["execute_blocks_launches"] for g in groups.values()]
    rng = np.random.default_rng(0)
    chip_smoke.phase_fabric_dtypes(
        rng, dev="cpu", cfg=cfg, fabric_cfg=tf.FabricConfig(n_blocks=8,
                                                            cols=COLS),
        shapes={"int4": (2, 40, 16), "int8": (2, 40, 8), "bf16": (2, 12, 9)})
    chip_smoke.phase_fabric_faults(rng, dev="cpu", fabric_cfg=grid,
                                   shape=(3, 40, 9))
    chip_smoke.phase_fuzz(dev="cpu", budget=2)
