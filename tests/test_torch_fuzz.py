"""The port's fuzz replay against the JAX package's, on the CPU.

``repro_torch.core.fuzz`` keeps the reference's generators, shrinking,
corpus format and budget driver; its initial states, mutations and
replay run on the torch engine.  Held here:

* the same seed gives the same program and the same initial state in
  both packages;
* every committed corpus file under ``tests/corpus/`` replays clean on
  the port across every variant, and ``fuzz_faults.txt`` keeps its
  two-sided pin (scrub on exact, scrub off escapes);
* a cross-package family: the JAX package's ``unroll`` oracle against
  every port variant on the same seeded programs;
* the mutation -> shrink -> corpus pipeline on the port.
"""

import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import engine as ref_engine  # noqa: E402
from repro.core import fuzz as ref_fuzz  # noqa: E402
from repro_torch.core import engine, faults, fuzz, isa  # noqa: E402

CORPUS = pathlib.Path(__file__).parent / "corpus"
_corpus_files = sorted(CORPUS.glob("fuzz_*.txt"))


def _why(rep):
    return [f"{m.variant}/{m.field}: {m.detail}" for m in rep.mismatches]


def _tuples(rep):
    return [dataclasses.astuple(m) for m in rep.mismatches]


def _np(state):
    return tuple(np.asarray(f) for f in state)


def _port_np(state):
    return tuple(f.cpu().numpy() for f in state)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_seed_same_program_and_state(seed):
    cfg, ref_cfg = fuzz.FuzzConfig(), ref_fuzz.FuzzConfig()
    fp, ref_fp = fuzz.gen_program(seed, cfg), ref_fuzz.gen_program(
        seed, ref_cfg)
    assert fp.program.fingerprint() == ref_fp.program.fingerprint()
    assert fuzz.program_to_text(fp) == ref_fuzz.program_to_text(ref_fp)
    for blocks in (0, cfg.blocks):
        got = _port_np(fuzz.gen_state(seed, cfg, blocks, device="cpu"))
        want = _np(ref_fuzz.gen_state(seed, ref_cfg, blocks))
        for g, w in zip(got, want):
            assert g.dtype == np.bool_
            np.testing.assert_array_equal(g, w)


def test_corpus_is_committed():
    assert len(_corpus_files) == 8, _corpus_files


@pytest.mark.parametrize("path", _corpus_files,
                         ids=[p.stem for p in _corpus_files])
def test_corpus_replays_bit_identical_on_the_port(path):
    fp, pins = fuzz.load_corpus(path)
    ref_fp, ref_pins = ref_fuzz.load_corpus(path)
    assert pins == ref_pins
    assert fp.program.fingerprint() == ref_fp.program.fingerprint()
    assert fp.program.cycles() == pins["cycles"]
    assert fp.program.footprint() == pins["footprint"]
    rep = fuzz.replay(fp, device="cpu")
    assert rep.ok, _why(rep)
    assert rep.variants == fuzz.VARIANTS


def test_fault_corpus_two_sided_on_the_port():
    """The committed fault repro: exact with the scrub on, escaping with
    the identical flip sequence once the scrub is off -- the same
    mismatches as the JAX package reports."""
    fp, _ = fuzz.load_corpus(CORPUS / "fuzz_faults.txt")
    assert fp.cfg.fault_scrub and fp.cfg.fault_rate > 0
    assert fuzz.replay(fp, variants=("faults",), device="cpu").ok
    off = fp.with_groups(
        fp.groups, cfg=dataclasses.replace(fp.cfg, fault_scrub=False))
    rep = fuzz.replay(off, variants=("faults",), device="cpu")
    assert not rep.ok
    assert all(m.variant == "faults" for m in rep.mismatches)
    ref_fp, _ = ref_fuzz.load_corpus(CORPUS / "fuzz_faults.txt")
    ref_off = ref_fp.with_groups(ref_fp.groups, cfg=dataclasses.replace(
        ref_fp.cfg, fault_scrub=False))
    ref_rep = ref_fuzz.replay(ref_off, variants=("faults",))
    assert _tuples(rep) == _tuples(ref_rep)


# ---------------------------------------------------------------------------
# Cross-package family: the reference's unroll oracle vs every port variant
# ---------------------------------------------------------------------------
def _variant_outputs(fp, variant):
    """(port output, reference unroll oracle) of one replay variant, as
    numpy fields, on the seeded states of ``fp``."""
    prog, cfg = fp.program, fp.cfg
    ref_prog = ref_fuzz.gen_program(fp.seed, ref_fuzz.FuzzConfig()).program
    ref_cfg = ref_fuzz.FuzzConfig()
    if variant in ("blocks", "faults"):
        st = fuzz.gen_state(fp.seed, cfg, cfg.blocks, device="cpu")
        want = ref_engine.execute_blocks(
            ref_prog, ref_fuzz.gen_state(fp.seed, ref_cfg, cfg.blocks),
            "unroll")
        fm = None if variant == "blocks" else faults.FaultModel(
            bit_rate=cfg.fault_rate, seed=fp.seed ^ cfg.fault_seed)
        got = engine.execute_blocks(prog, st, "compiled", faults=fm)
        return _port_np(got), _np(want), fm
    st = fuzz.gen_state(fp.seed, cfg, device="cpu")
    ref_st = ref_fuzz.gen_state(fp.seed, ref_cfg)
    want = ref_engine.execute(ref_prog, ref_st)
    if variant == "scan":
        got = engine.execute_scan(prog, st)
    elif variant == "chain":
        want = ref_engine.execute(ref_prog, want)
        got = engine.run_chain([prog, prog], st)
    else:
        pk = {"False": False, "True": True,
              "None": None}[variant.split("=", 1)[1]]
        got = engine.execute_compiled(prog, st, packed=pk)
    return _port_np(got), _np(want), None


@pytest.mark.parametrize("seed", [0, 5, 11, 17, 23])
@pytest.mark.parametrize("variant", fuzz.VARIANTS)
def test_port_variant_equals_reference_unroll(seed, variant):
    fp = fuzz.gen_program(seed, fuzz.FuzzConfig())
    got, want, fm = _variant_outputs(fp, variant)
    for name, g, w in zip(("array", "carry", "tag"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=f"{variant} {name}")
    if fm is not None and fm.injected_flips:
        assert fm.detected > 0


# ---------------------------------------------------------------------------
# Budget driver, mutations and shrinking on the port
# ---------------------------------------------------------------------------
def test_bounded_budget_clean_on_the_port():
    stats = fuzz.run_budget(6, seed=0, corpus_dir=None, device="cpu")
    assert stats["programs"] == 6 and stats["mismatch"] is None
    assert stats["ops"] > 0 and sum(stats["seq_histogram"].values()) > 0


def test_budget_catches_forced_fault_escape_on_the_port():
    cfg = fuzz.FuzzConfig(fault_rate=5e-3, fault_scrub=False)
    stats = fuzz.run_budget(5, seed=0, cfg=cfg, corpus_dir=None,
                            do_shrink=False, device="cpu")
    ref_stats = ref_fuzz.run_budget(5, seed=0, cfg=ref_fuzz.FuzzConfig(
        fault_rate=5e-3, fault_scrub=False), corpus_dir=None,
        do_shrink=False)
    assert stats["mismatch"] is not None
    assert stats["last_seed"] == ref_stats["last_seed"]
    assert _tuples(stats["mismatch"]) == _tuples(ref_stats["mismatch"])


@pytest.mark.parametrize("bug,variant", [("fa-flip", "compiled:packed=True"),
                                         ("pred-carry", "scan")])
def test_forced_mutation_shrinks_to_a_replayable_repro(tmp_path, bug,
                                                      variant):
    stats = fuzz.run_budget(20, seed=0, mutate=fuzz.MUTATIONS[bug],
                            corpus_dir=tmp_path, device="cpu")
    assert stats["mismatch"] is not None
    assert {m.variant for m in stats["mismatch"].mismatches} == {variant}
    assert stats["shrunk_ops"] <= 3
    fp, pins = fuzz.load_corpus(stats["repro_path"])
    assert fp.program.cycles() == pins["cycles"]
    assert not fuzz.replay(fp, mutate=fuzz.MUTATIONS[bug],
                           device="cpu").ok
    assert fuzz.replay(fp, device="cpu").ok
    # the port's repro is the reference's text format: it loads there
    ref_fp, _ = ref_fuzz.load_corpus(stats["repro_path"])
    assert ref_fp.program.fingerprint() == fp.program.fingerprint()


def test_mutations_flip_a_copy_and_leave_their_input_untouched():
    prog = isa.Program("fa", [isa.Instr(isa.OP_FA, 2, 0, 1)])
    st = fuzz.gen_state(0, fuzz.FuzzConfig(), device="cpu")
    before = tuple(f.clone() for f in st)
    out = fuzz.MUTATIONS["fa-flip"]("compiled:packed=True", prog, st)
    assert bool(out.array[0, 0]) != bool(before[0][0, 0])
    assert torch.equal(out.array[1:], before[0][1:])
    pred = isa.Program("p", [isa.Instr(isa.OP_AND, 2, 0, 1, pred=True)])
    out = fuzz.MUTATIONS["pred-carry"]("scan", pred, st)
    assert torch.equal(out.carry, ~before[1])
    for f, b in zip(st, before):
        assert torch.equal(f, b)


def test_replay_device_none_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fuzz.replay(fuzz.gen_program(0, fuzz.FuzzConfig()))
    with pytest.raises(RuntimeError, match="CUDA"):
        fuzz.gen_state(0, fuzz.FuzzConfig())
