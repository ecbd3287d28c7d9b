"""The port's fault hooks against the JAX package's, on the CPU.

``repro_torch.core.faults`` keeps the reference's fault process, parity
and scrub, and rewrites the two engine hooks for the torch engine.  The
same ``FaultModel`` arguments on the same seeded states must give
bit-identical faulted outputs of ``execute_blocks`` and ``run_chain``
and equal counters (flips, detections, repairs, re-fetch traffic) in
both packages: the flips come from one numpy Generator drawn in the
same order on both sides.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import engine as ref_engine  # noqa: E402
from repro.core import faults as ref_faults  # noqa: E402
from repro.core import fuzz as ref_fuzz  # noqa: E402
from repro_torch.core import engine, faults, fuzz  # noqa: E402

COUNTERS = ("injected_flips", "injection_events", "detected", "repaired",
            "escaped", "refetch_bits", "scrub_rows", "parity_bits",
            "remaps")


def _case(seed=3, blocks=None):
    """A fuzz program and its seeded initial state in both packages."""
    cfg = fuzz.FuzzConfig()
    blocks = cfg.blocks if blocks is None else blocks
    prog = fuzz.gen_program(seed, cfg).program
    ref_prog = ref_fuzz.gen_program(seed, ref_fuzz.FuzzConfig()).program
    assert prog.fingerprint() == ref_prog.fingerprint()
    st = fuzz.gen_state(seed, cfg, blocks=blocks, device="cpu")
    ref_st = ref_fuzz.gen_state(seed, ref_fuzz.FuzzConfig(), blocks=blocks)
    return prog, ref_prog, st, ref_st


def _assert_same(got, want, what=""):
    for f in ("array", "carry", "tag"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{what} {f}")


def _counters(fm):
    return {c: getattr(fm, c) for c in COUNTERS}


def _models(**kw):
    return faults.FaultModel(**kw), ref_faults.FaultModel(**kw)


_BLOCK_CASES = {
    "scrub-packed": (dict(bit_rate=3e-3, seed=1), True),
    "scrub-bool": (dict(bit_rate=3e-3, seed=1), False),
    "scrub-default": (dict(bit_rate=3e-3, seed=1), None),
    "no-scrub": (dict(bit_rate=3e-3, seed=1, scrub=False), True),
    "dead-block": (dict(dead_blocks=(1,), seed=2), True),
    "dead-no-scrub": (dict(dead_blocks=(0, 2), bit_rate=1e-3, seed=5,
                           scrub=False), None),
}


@pytest.mark.parametrize("case", sorted(_BLOCK_CASES))
def test_faulted_execute_blocks_matches_reference(case):
    kw, packed = _BLOCK_CASES[case]
    prog, ref_prog, st, ref_st = _case()
    fm, ref_fm = _models(**kw)
    got = engine.execute_blocks(prog, st, "compiled", packed=packed,
                                faults=fm)
    want = ref_engine.execute_blocks(ref_prog, ref_st, "compiled",
                                     packed=packed, faults=ref_fm)
    _assert_same(got, want, case)
    assert _counters(fm) == _counters(ref_fm)
    assert fm.injected_flips > 0
    clean = engine.execute_blocks(prog, st, "compiled", packed=packed)
    if fm.scrub:
        # the scrub repairs every flip: exact against the clean run
        assert fm.detected > 0 and fm.repaired == fm.detected
        _assert_same(got, ref_engine.execute_blocks(ref_prog, ref_st,
                                                    "compiled"), case)
        assert torch.equal(got.array, clean.array)
    else:
        assert fm.repaired == 0 and not torch.equal(got.array, clean.array)


@pytest.mark.parametrize("executor", ["unroll", "scan"])
def test_faulted_loop_executors_match_reference(executor):
    prog, ref_prog, st, ref_st = _case(seed=7, blocks=2)
    fm, ref_fm = _models(bit_rate=4e-3, seed=9, scrub=False)
    got = engine.execute_blocks(prog, st, executor, faults=fm)
    want = ref_engine.execute_blocks(ref_prog, ref_st, executor,
                                     faults=ref_fm)
    _assert_same(got, want, executor)
    assert _counters(fm) == _counters(ref_fm) and fm.injected_flips > 0


def test_scrub_cadence_and_heal_match_reference_across_calls():
    """Three faulted launches on one model: scrub every 2nd point, heal
    after 2 events; outputs and counters agree after every call."""
    prog, ref_prog, st, ref_st = _case(seed=4)
    fm, ref_fm = _models(bit_rate=3e-3, seed=6, scrub_every=2,
                         heal_after=2)
    for call in range(3):
        got = engine.execute_blocks(prog, st, "compiled", faults=fm)
        want = ref_engine.execute_blocks(ref_prog, ref_st, "compiled",
                                         faults=ref_fm)
        _assert_same(got, want, f"call {call}")
        assert _counters(fm) == _counters(ref_fm), call
    assert fm.healed and fm.injection_events == 3


@pytest.mark.parametrize("scrub", [True, False])
def test_faulted_run_chain_matches_reference(scrub):
    prog, ref_prog, _, _ = _case()
    st = fuzz.gen_state(3, fuzz.FuzzConfig(), device="cpu")
    ref_st = ref_fuzz.gen_state(3, ref_fuzz.FuzzConfig())
    fm, ref_fm = _models(bit_rate=4e-3, seed=4, scrub=scrub)
    got = engine.run_chain([prog, prog], st, faults=fm)
    want = ref_engine.run_chain([ref_prog, ref_prog], ref_st, faults=ref_fm)
    _assert_same(got, want, f"scrub={scrub}")
    assert _counters(fm) == _counters(ref_fm)
    assert fm.injection_events == 2 and fm.injected_flips > 0
    clean = engine.run_chain([prog, prog], st)
    assert torch.equal(got.array, clean.array) == scrub


def test_inactive_model_runs_the_plain_paths():
    prog, _, st, _ = _case()
    fm = faults.FaultModel(seed=3)
    assert not fm.active
    _assert_same(engine.execute_blocks(prog, st, faults=fm),
                 engine.execute_blocks(prog, st, "unroll"))
    one = fuzz.gen_state(3, fuzz.FuzzConfig(), device="cpu")
    _assert_same(engine.run_chain([prog], one, faults=fm),
                 engine.execute(prog, one))
    assert all(v == 0 for v in _counters(fm).values())


def test_inject_and_scrub_draw_like_reference():
    """The host-side process the hooks share: same flips, same garbage
    for dead slots, same repairs, same Generator state afterwards."""
    rng = np.random.default_rng(11)
    arrs = rng.integers(0, 2, (5, 24, 16)).astype(bool)
    fm, ref_fm = _models(bit_rate=0.02, dead_blocks=(3,), seed=8)
    sig = faults.parity_signature(arrs)
    for dead in (None, (), (0, 4)):
        got = faults.inject(arrs.copy(), fm, dead_slots=dead)
        want = ref_faults.inject(arrs.copy(), ref_fm, dead_slots=dead)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            faults.scrub_states(got, arrs, sig, fm),
            ref_faults.scrub_states(want, arrs, sig, ref_fm))
    assert _counters(fm) == _counters(ref_fm)
    assert fm._rng.random() == ref_fm._rng.random()


def test_faulted_state_keeps_the_incoming_device_and_input():
    prog, _, st, _ = _case()
    before = st.array.clone()
    got = engine.execute_blocks(prog, st, faults=faults.FaultModel(
        bit_rate=0.05, seed=1))
    assert got.array.device == st.array.device
    assert torch.equal(st.array, before)     # the caller's state is intact
