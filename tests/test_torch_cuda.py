"""Tests of the port that need the card: the CUDA kernels against their
plain PyTorch versions, and the main path through them.

Marked ``cuda``; each skips without a CUDA device.  On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only the port is installed.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

from repro_torch.kernels import bitplane_ops as bp  # noqa: E402
from repro_torch.pim import cram  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _planes(rng, m, lanes, words, live, top, device):
    x = rng.integers(0, 1 << 32, (m, lanes, words),
                     dtype=np.uint64).astype(np.uint32)
    if top:
        x |= np.uint32(1 << 31)
    return [torch.from_numpy(x[i].view(np.int32)).to(device)
            if live is None or i in live else None for i in range(m)]


def _words(p, words):
    if p is None:
        return np.zeros(words, np.uint32)
    return p.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("top", [False, True], ids=["rand", "bit31"])
@pytest.mark.parametrize("m,lanes,words,width,live", [
    (3, 3, 4, 5, None), (4, 8, 16, 8, None), (4, 17, 33, 12, None),
    (6, 5, 7, 6, {0, 1, 3, 5}), (6, 5, 7, 6, {0, 2}),
    (15, 57, 160, 15, set(range(8))),
    (32, 9, 70, 32, None)])
def test_lane_fold_kernel_matches_plain(card, m, lanes, words, width, live,
                                        top):
    rng = np.random.default_rng(60)
    planes = _planes(rng, m, lanes, words, live, top, card)
    before = bp.lane_fold_cuda.launches
    got = bp.lane_fold(planes, width, packed=True)
    assert bp.lane_fold_cuda.launches == before + 1
    want = bp.lane_fold_torch(planes, width)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_words(g, words), _words(w, words))


#: (m planes read, width, bit 31 forced) of the edge sweep: the main
#: path's 8 of 15, the widest fold, and m well below width
_FOLD_EDGE_CASES = {"m8w15": (8, 15, False), "m32w32bit31": (32, 32, True),
                    "m3w20": (3, 20, False)}


@pytest.mark.parametrize("case", sorted(_FOLD_EDGE_CASES))
@pytest.mark.parametrize("words", [1, 32, 33, 160, 4096])
@pytest.mark.parametrize("lanes", [1, 2, 31, 33, 57, 1000])
def test_lane_fold_kernel_edges(card, lanes, words, case):
    """The lane-group partition and the group tree at their edges: one
    lane, fewer lanes than groups, a ragged last group, many batches;
    one word column, a ragged last block, many blocks; every width
    bucket.  Bit-identical to the plain tree."""
    m, width, top = _FOLD_EDGE_CASES[case]
    gen = torch.Generator(device=card).manual_seed(lanes * 7919 + words)
    x = torch.randint(-2 ** 31, 2 ** 31, (m, lanes, words),
                      dtype=torch.int32, device=card, generator=gen)
    if top:
        x |= -2 ** 31
    before = bp.lane_fold_cuda.launches
    got = bp.lane_fold_cuda(x, width)
    assert bp.lane_fold_cuda.launches == before + 1
    zero = torch.zeros(words, dtype=torch.int32, device=card)
    want = torch.stack([zero if p is None else p
                        for p in bp.lane_fold_torch(list(x), width)])
    torch.cuda.synchronize()
    assert got.shape == (width, words)
    assert torch.equal(got, want)


def test_lane_fold_kernel_rejects_what_it_does_not_take(card):
    x = torch.zeros((3, 4, 5), dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        bp.lane_fold_cuda(x.to(torch.int64), 3)
    with pytest.raises(ValueError):
        bp.lane_fold_cuda(x.transpose(1, 2), 3)
    with pytest.raises(ValueError):
        bp.lane_fold_cuda(x, 2)                       # m > width
    with pytest.raises(ValueError):
        bp.lane_fold_cuda(x, bp.LANE_FOLD_MAX_WIDTH + 1)


def test_cram_matmul_on_card_runs_the_kernel(card):
    rng = np.random.default_rng(61)
    x = rng.integers(-8, 8, (5, 70))
    w = rng.integers(-8, 8, (70, 48))
    before = bp.lane_fold_cuda.launches
    got = cram.cram_matmul(x, w, n=4, signed=True)
    assert bp.lane_fold_cuda.launches > before
    np.testing.assert_array_equal(got, x.astype(np.int64) @ w)


# ---------------------------------------------------------------------------
# The GEMM kernels and flash attention
# ---------------------------------------------------------------------------
from repro_torch.kernels import bitserial_matmul as bsm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402


def _ints(rng, bits, signed, shape):
    lo, hi = (-(1 << (bits - 1)), 1 << (bits - 1)) if signed \
        else (0, 1 << bits)
    return rng.integers(lo, hi, shape)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m,k,n", [(1, 32, 1), (1, 896, 128), (7, 64, 130),
                                   (33, 4864, 96), (128, 96, 4864)])
def test_quant_matmul_kernel_matches_plain(card, m, k, n, bits):
    rng = np.random.default_rng(70 + bits)
    a = torch.from_numpy(_ints(rng, 8, True, (m, k))).to(torch.int8)
    w = torch.from_numpy(_ints(rng, bits, True, (k, n)))
    scale = torch.from_numpy(rng.uniform(0.001, 0.1, n).astype(np.float32))
    a, scale = a.to(card), scale.to(card)
    wp = ops.pack_bitplanes(w.to(card), bits, axis=0)
    before = bsm.quant_matmul_cuda.launches
    got = ops.quant_matmul(a, wp, scale, bits=bits)
    assert bsm.quant_matmul_cuda.launches == before + 1
    want = bsm.quant_matmul_torch(a, wp, scale, bits=bits)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                  want.cpu().numpy().view(np.int32))
    exact = (a.cpu().numpy().astype(np.int64) @ w.numpy()
             ).astype(np.float32) * scale.cpu().numpy()[None, :]
    np.testing.assert_array_equal(got.cpu().numpy(), exact)


def _quant_on_card(card, m, k, n, bits, seed):
    """The kernel, the plain version and the exact product (float64 on the
    card: every partial sum is an integer below 2**53) on seeded inputs;
    asserts that all three agree bit for bit."""
    gen = torch.Generator(device=card).manual_seed(seed)
    a = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=card,
                      generator=gen)
    w = torch.randint(-(1 << (bits - 1)), 1 << (bits - 1), (k, n),
                      dtype=torch.int32, device=card, generator=gen)
    scale = torch.rand(n, device=card, generator=gen) * 0.099 + 0.001
    wp = ops.pack_bitplanes(w, bits, axis=0)
    before = bsm.quant_matmul_cuda.launches
    got = bsm.quant_matmul_cuda(a, wp, scale, bits=bits)
    assert bsm.quant_matmul_cuda.launches == before + 1
    want = bsm.quant_matmul_torch(a, wp, scale, bits=bits)
    exact = (a.double() @ w.double()).to(torch.int64).to(torch.float32) \
        * scale[None, :]
    torch.cuda.synchronize()
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.view(torch.int32), exact.view(torch.int32))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("n", [1, 8, 130, 4864])
@pytest.mark.parametrize("k", [32, 96, 896, 4864])
@pytest.mark.parametrize("m", [1, 7, 8, 64, 65, 128, 129, 256])
def test_quant_matmul_kernel_tiles(card, m, k, n, bits):
    """Every token tile (8, 64, 128 and ragged ones), one to many weight
    tiles with a ragged last one, K from one word to 152, and the split
    of K that the tile count picks, against the plain version and the
    exact product."""
    _quant_on_card(card, m, k, n, bits, seed=m * 10007 + k * 31 + n + bits)


@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("m,k,n", [(7, 96, 130), (129, 896, 8),
                                   (8, 4864, 130)])
def test_quant_matmul_kernel_every_width(card, m, k, n, bits):
    _quant_on_card(card, m, k, n, bits, seed=500 + bits)


@pytest.mark.parametrize("m,k,n", [(8, 416, 64), (1, 1184, 130),
                                   (128, 416, 896), (8, 928, 4864)])
def test_quant_matmul_kernel_ragged_split(card, m, k, n):
    """K words that the split does not divide (13 and 37 words over a
    split of 8 at one, three and 14 tiles; 29 over 4 at 76 tiles, on a
    card of 132 SMs), so the parts differ in length."""
    _quant_on_card(card, m, k, n, 4, seed=600 + k)


@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
@pytest.mark.parametrize("ba,bw", [(8, 4), (4, 4), (4, 8), (1, 3), (8, 8)])
@pytest.mark.parametrize("m,k,n", [(1, 4864, 70), (9, 288, 129)] + [
    (m, 32, n) for m in (1, 7, 8, 65) for n in (70, 129)])
def test_popcount_matmul_kernel_matches_plain(card, m, k, n, ba, bw, signed):
    rng = np.random.default_rng(80 + ba + bw)
    a = _ints(rng, ba, signed, (m, k))
    w = _ints(rng, bw, signed, (k, n))
    ap = ops.pack_bitplanes(torch.from_numpy(a).to(card), ba, axis=1)
    wp = ops.pack_bitplanes(torch.from_numpy(w).to(card), bw, axis=0)
    before = bsm.popcount_matmul_cuda.launches
    got = ops.popcount_matmul(ap, wp, a_signed=signed, w_signed=signed)
    assert bsm.popcount_matmul_cuda.launches == before + 1
    want = bsm.popcount_matmul_torch(ap, wp, a_signed=signed,
                                     w_signed=signed)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  a.astype(np.int64) @ w.astype(np.int64))


def test_popcount_matmul_kernel_wraps_like_plain(card):
    """Unsigned A8W8 at K = 34816: the int32 sum of row 0 and column 0
    (255 * 255 * K) passes 2**31 and wraps, bit-identical to the plain
    version and to the exact product mod 2**32."""
    rng = np.random.default_rng(85)
    k = 34816
    a = rng.integers(0, 256, (3, k))
    w = rng.integers(0, 256, (k, 5))
    a[0], w[:, 0] = 255, 255
    ap = ops.pack_bitplanes(torch.from_numpy(a).to(card), 8, axis=1)
    wp = ops.pack_bitplanes(torch.from_numpy(w).to(card), 8, axis=0)
    got = bsm.popcount_matmul_cuda(ap, wp, a_signed=False, w_signed=False)
    want = bsm.popcount_matmul_torch(ap, wp, a_signed=False, w_signed=False)
    torch.cuda.synchronize()
    exact = a.astype(np.int64) @ w.astype(np.int64)
    assert exact[0, 0] >= 2 ** 31
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  exact.astype(np.uint32).view(np.int32))


def test_gemm_kernels_reject_what_they_do_not_take(card):
    a = torch.zeros((4, 64), dtype=torch.int8, device=card)
    wp = torch.zeros((4, 2, 8), dtype=torch.int32, device=card)
    s = torch.ones(8, device=card)
    with pytest.raises(ValueError):
        bsm.quant_matmul_cuda(a[:, :48], wp, s, bits=4)      # K % 32
    with pytest.raises(ValueError):
        bsm.quant_matmul_cuda(a, wp.transpose(1, 2).contiguous()
                              .transpose(1, 2), s, bits=4)   # strided
    with pytest.raises(ValueError):
        bsm.quant_matmul_cuda(a, wp, s, bits=9)
    raw = torch.zeros(4 * 64 + 16, dtype=torch.int8, device=card)
    for off in (1, 4, 8):                     # not on a 16-byte boundary
        with pytest.raises(ValueError, match="16-byte"):
            bsm.quant_matmul_cuda(raw[off:off + 256].view(4, 64), wp, s,
                                  bits=4)
    with pytest.raises(TypeError):
        bsm.popcount_matmul_cuda(wp.to(torch.int64), wp)
    with pytest.raises(ValueError):
        bsm.popcount_matmul_cuda(torch.zeros((9, 4, 2), dtype=torch.int32,
                                             device=card), wp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("bh,s,hd", [(14, 256, 64), (3, 1000, 128),
                                     (2, 77, 32), (5, 9, 96), (4, 1, 64),
                                     (112, 1, 64)] + [
    (2, s, hd) for s in (1, 63, 64, 65, 127, 1000)
    for hd in (32, 64, 96, 128)])
def test_flash_attention_kernel_matches_plain(card, bh, s, hd, causal,
                                              dtype):
    rng = np.random.default_rng(90)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (bh, s, hd))
                                .astype(np.float32)).to(card, dtype)
               for _ in range(3))
    before = fa.flash_attention_cuda.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    assert fa.flash_attention_cuda.launches == before + 1
    want = fa.flash_attention_torch(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    # float32: the reference's 2e-4; bf16: the plain version's bf16 value
    # or its neighbour, or within 1e-5
    assert chip_smoke.flash_agrees(got, want), chip_smoke.flash_error(got,
                                                                      want)


def test_flash_attention_kernel_rejects_what_it_does_not_take(card):
    q = torch.zeros((2, 8, 64), device=card)
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q[..., :48].contiguous(),
                                q[..., :48].contiguous(),
                                q[..., :48].contiguous())
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q.transpose(0, 1), q.transpose(0, 1),
                                q.transpose(0, 1))


def test_flash_attention_kernel_takes_unaligned_views(card):
    """Contiguous views that start off the kernel's 16-byte copies give
    the plain version's output."""
    rng = np.random.default_rng(91)
    flat = [torch.from_numpy(rng.normal(0, 1, 2 * 70 * 64 + 1)
                             .astype(np.float32)).to(card) for _ in range(3)]
    q, k, v = (x[1:].view(2, 70, 64) for x in flat)
    assert q.is_contiguous() and q.data_ptr() % 16
    got = fa.flash_attention_cuda(q, k, v, causal=True)
    want = fa.flash_attention_torch(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert chip_smoke.flash_agrees(got, want)


def test_pim_linear_on_card_runs_the_kernels(card):
    from repro_torch.pim import linear as pl
    gen = torch.Generator().manual_seed(3)
    dense = pl.linear_init(gen, 256, 96, pl.PimConfig())
    assert dense["w"].device.type == "cuda"
    x = torch.randn((5, 256), generator=gen).to(card, torch.bfloat16)
    packed = pl.pack_linear(dense, pl.PimConfig(weight_bits=4))
    want = pl.linear_apply(packed, x, pl.PimConfig(mode="ref"))
    for mode, fn in (("pallas", bsm.quant_matmul_cuda),
                     ("popcount", bsm.popcount_matmul_cuda)):
        before = fn.launches
        got = pl.linear_apply(packed, x, pl.PimConfig(mode=mode))
        assert fn.launches == before + 1
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_faulted_engine_on_card_equals_cpu(card):
    """The fault hooks copy the state to the host, inject and scrub there
    and put it back on the card: the same flips, counters and outputs as
    on the CPU, and the result stays on the card."""
    from repro_torch.core import engine, faults, fuzz

    cfg = fuzz.FuzzConfig()
    prog = fuzz.gen_program(3, cfg).program
    outs = {}
    for dev in ("cpu", card):
        fm = faults.FaultModel(bit_rate=3e-3, seed=1, scrub=False)
        st = fuzz.gen_state(3, cfg, blocks=cfg.blocks, device=dev)
        got = engine.execute_blocks(prog, st, "compiled", faults=fm)
        assert got.array.device.type == torch.device(dev).type
        one = fuzz.gen_state(3, cfg, device=dev)
        chain = engine.run_chain([prog, prog], one, faults=fm)
        outs[str(dev)] = ([f.cpu() for f in got + chain], fm.stats())
    (a, sa), (b, sb) = outs.values()
    assert sa == sb and sa["injected_flips"] > 0
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_fuzz_corpus_replays_on_card(card):
    from repro_torch.core import fuzz

    files = sorted((Path(__file__).parent / "corpus").glob("fuzz_*.txt"))
    assert len(files) == 8
    for path in files:
        rep = fuzz.replay(fuzz.load_corpus(path)[0], device=card)
        assert rep.ok, (path.name, rep.mismatches)


@pytest.mark.parametrize("bits", [4, 8])
def test_fabric_on_card_runs_the_kernel_and_equals_cpu(card, bits):
    """A 512-block fabric launch on the card equals the CPU's and numpy's
    product; int4 rounds (the packed interior) launch ``lane_fold``."""
    from repro_torch.pim import fabric

    rng = np.random.default_rng(61)
    x = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), (3, 300))
    w = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), (300, 50))
    before = bp.lane_fold_cuda.launches
    packs = fabric.fpk.fabric_pack_cuda.launches
    got = fabric.fabric_matmul(x, w, nbits=bits, signed=True, device=card)
    folds = bp.lane_fold_cuda.launches - before
    packs = fabric.fpk.fabric_pack_cuda.launches - packs
    cpu = fabric.fabric_matmul(x, w, nbits=bits, signed=True, device="cpu")
    np.testing.assert_array_equal(got.out, cpu.out)
    np.testing.assert_array_equal(np.asarray(got.out, np.int64),
                                  x.astype(np.int64) @ w)
    assert (folds > 0) == (bits == 4)
    # every launch of an int program packs its images on the card
    assert packs > 0 and (bits != 4 or packs == folds)


@pytest.mark.parametrize("rows,cols,bits", [
    (512, 40, 4), (512, 40, 8), (512, 40, 16), (128, 8, 32), (9, 7, 8),
    (3, 1, 8)])
def test_fabric_pack_kernel_matches_plain(card, rows, cols, bits):
    """The pack kernel against its plain version on random operands, row
    maps and descriptors (a padded slot among them): bytes and 32-bit
    words, slot images of 4k bytes and of others; one launch a call."""
    from repro_torch.kernels import fabric_pack as fpk

    before = fpk.fabric_pack_cuda.launches
    chip_smoke.pack_random_case(np.random.default_rng(rows + bits), rows,
                                cols, bits, card, tuples=min(4, rows // 2))
    assert fpk.fabric_pack_cuda.launches == before + 1


def test_fabric_pack_at_the_launch_shape_equals_plain_and_host(card):
    """A W4A4 gate+up launch of 512 x 512 x 40 packed on the card equals
    its plain version and the host's numpy pack (``chip_smoke``'s
    phase)."""
    st = chip_smoke.phase_fabric_pack(np.random.default_rng(62))
    assert st["shape"] == [512, 512, 40] and st["max_abs_err"] == 0


def test_fabric_pack_kernel_rejects_what_it_does_not_take(card):
    from repro_torch.kernels import fabric_pack as fpk

    x = torch.zeros((2, 4), dtype=torch.uint8, device=card)
    w = torch.zeros((4, 8), dtype=torch.uint8, device=card)
    d = torch.zeros((3, fpk.DESC_FIELDS), dtype=torch.int32, device=card)
    rm = torch.full((16,), -1, dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        fpk.fabric_pack_cuda(x.to(torch.int16), w.to(torch.int16), d, rm, 8)
    with pytest.raises(ValueError, match="contiguous"):
        fpk.fabric_pack_cuda(x, w.t().contiguous().t(), d, rm, 8)
    with pytest.raises(ValueError, match="one device"):
        fpk.fabric_pack_cuda(x, w, d.cpu(), rm, 8)
    assert not fpk.fabric_pack_cuda(x, w, d, rm, 8).any()


def test_lane_fold_op_launches_and_counts_per_call(card):
    """``repro_torch::lane_fold`` on CUDA words launches the kernel once a
    call, equal to the plain tree; a CPU tensor is refused."""
    rng = np.random.default_rng(70)
    planes = _planes(rng, 8, 57, 160, None, False, card)
    x = torch.stack(planes)
    before = bp.lane_fold_cuda.launches
    got = torch.ops.repro_torch.lane_fold(x, 15)
    assert bp.lane_fold_cuda.launches == before + 1
    want = bp.lane_fold_torch(planes, 15)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_words(g, 160), _words(w, 160))
    with pytest.raises(ValueError, match="CUDA tensor"):
        torch.ops.repro_torch.lane_fold(x.cpu(), 15)


def test_cse_graph_on_the_card_launches_like_eager(card):
    """The CSE'd ``idot4x58`` graph traced on the card holds one fold
    node, equals the eager lowered function and the CPU's graph, and
    launches the kernel once a call, as the eager function does; the
    trace launches nothing."""
    from repro_torch.core import engine, programs

    rng = np.random.default_rng(71)
    prog, _ = programs.idot(4, rows=512)
    fields = [rng.integers(0, 2, s).astype(bool)
              for s in ((512, 40), (40,), (40,))]
    st = engine.state_from_numpy(*fields, device=card)
    engine.clear_compile_cache()
    fn = engine.compile_program(prog, 512, 40, cse=True)
    before = bp.lane_fold_cuda.launches
    gm = fn.trace(card)
    assert bp.lane_fold_cuda.launches == before
    assert engine.last_cse_stats["removed"] > 0
    assert sum(n.target is torch.ops.repro_torch.lane_fold.default
               for n in gm.graph.nodes) == 1
    eager = fn.fn(st)
    assert bp.lane_fold_cuda.launches == before + 1
    got = fn(st)
    assert bp.lane_fold_cuda.launches == before + 2
    assert fn.graphs == {st.array.device: gm}   # the call ran this graph
    cpu = fn(engine.state_from_numpy(*fields, device="cpu"))
    for g, e, c in zip(got, eager, cpu):
        assert torch.equal(g, e) and torch.equal(g.cpu(), c)
    assert [k.type for k in fn.graphs] == ["cuda", "cpu"]


def test_mla_moe_layers_at_published_widths_against_reference(card):
    """deepseek-v2-lite at its published widths, cut to its leading dense
    layer and one MoE layer: a 480-token prefill into a 1024-slot latent
    cache (expanded keys and values, the experts grouped by
    ``torch._grouped_mm``), then 32 decode steps through the cache
    (``W_uk``/``W_uv`` absorbed, float32-output products), against the
    plain float32 reference's forward over the 512 tokens.  Bounds as in
    ``test_torch_arch_mla_moe.py``: the median position within 0.1 (bf16
    rounding; the fp8 control fails it), and so the median of the decoded
    positions on their own, which a decode without YaRN's ``mscale**2``
    fails; every position within 0.6 (a router tie flipped by
    rounding)."""
    import dataclasses
    import importlib
    import importlib.util

    from repro_torch.configs import get_config
    from repro_torch.models import mla
    from repro_torch.models.model import LM

    bench = Path(__file__).resolve().parents[1] / "portbench"
    for name, path, pkg in (("portbench_reference", bench / "reference",
                             True),
                            ("portbench_pb_mla_moe", bench / "pb_mla_moe.py",
                             False)):
        spec = importlib.util.spec_from_file_location(
            name, path / "__init__.py" if pkg else path,
            submodule_search_locations=[str(path)] if pkg else None)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    ref = importlib.import_module("portbench_reference.deepseek_v2")
    weights = sys.modules["portbench_pb_mla_moe"].weights
    cfg = dataclasses.replace(get_config("deepseek-v2-lite"), n_layers=2)
    w = weights(cfg, 2**31 + 7, card)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, 512), dtype=torch.int32, device=card)
    want = ref.forward(w, cfg, tokens)
    model = LM(cfg, device=card)
    def errors(scale=None):
        with torch.no_grad():
            logits, caches = model.prefill(w, tokens=tokens[None, :480],
                                           capacity=1024)
            got = [logits[0]]
            real = mla.softmax_scale
            if scale is not None:
                mla.softmax_scale = scale
            try:
                for i in range(480, 512):
                    step, caches = model.decode_step(
                        w, caches, tokens[None, i:i + 1],
                        torch.tensor([i], dtype=torch.int32, device=card))
                    got.append(step[0])
            finally:
                mla.softmax_scale = real
        return (torch.cat(got).float() - want).abs().amax(-1)

    err = errors()
    print("mla_moe prefill+decode logit error: median", err.median().item(),
          "max", err.max().item(), "decode median", err[480:].median().item(),
          "decode max", err[480:].max().item())
    assert err.median().item() < 0.1 and err.max().item() < 0.6
    assert err[480:].median().item() < 0.1
    ctl = (ref.forward(w, cfg, tokens, quant="fp8") - want).abs().amax(-1)
    print("fp8 control median", ctl.median().item(), "decode median",
          ctl[480:].median().item())
    assert ctl.median().item() > 0.1 and ctl[480:].median().item() > 0.1
    fault = errors(lambda c: c.mla.qk_head_dim ** -0.5)
    print("decode without mscale**2: decode median",
          fault[480:].median().item())
    assert fault[480:].median().item() > 0.1


@pytest.mark.parametrize("B,T,D,tiny", [
    (2, 1, 5, False), (1, 7, 33, False), (2, 88, 4100, False),
    (1, 256, 131072, False), (2, 255, 96, True)])
def test_linear_scan_kernel_matches_plain_bit_for_bit(card, B, T, D, tiny):
    """The chunk-scan kernel against the recurrence's plain version on the
    card, bit for bit: one step, ragged chunks, a whole chunk at a Mamba
    layer's 8192 x 16 lanes, lanes that are no multiple of 32, and states
    in the subnormal range."""
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.models import recurrence

    g = torch.Generator().manual_seed(B * 1000 + T)
    a = torch.rand((B, T, D), generator=g).to(card)
    b = torch.randn((B, T, D), generator=g).to(card)
    h0 = torch.randn((B, D), generator=g).to(card)
    if tiny:            # states in the subnormal range
        a, b, h0 = a * 1e-3, b * 1e-37, h0 * 1e-37
    assert ls.takes(a, b, h0)
    n = ls.linear_scan_cuda.launches
    got = ls.linear_scan_cuda(a, b, h0)
    pa, pb = recurrence._inclusive_scan(a, b)
    want = pa * h0[:, None] + pb
    torch.cuda.synchronize()
    assert ls.linear_scan_cuda.launches == n + 1
    assert torch.equal(got, want)
    if tiny:
        assert ((want != 0)
                & (want.abs() < torch.finfo(torch.float32).tiny)).any()


def test_linear_scan_kernel_reads_strided_views(card):
    """Chunks sliced along time out of a longer (B, S, D) sequence and the
    state as the last step of the previous chunk's states (views with
    batch and time strides of their own)."""
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.models import recurrence

    g = torch.Generator().manual_seed(7)
    a = torch.rand((3, 300, 2, 48), generator=g).to(card)
    b = torch.randn((3, 300, 2, 48), generator=g).to(card)
    h = torch.randn((3, 5, 2, 48), generator=g).to(card)[:, -1]
    for c0, c1 in ((0, 256), (256, 300)):
        ac, bc = a[:, c0:c1], b[:, c0:c1]
        got = ls.linear_scan_cuda(ac, bc, h)
        pa, pb = recurrence._inclusive_scan(ac, bc)
        want = pa * h[:, None] + pb
        assert torch.equal(got, want)
        h = got[:, -1]


def test_mamba_prefill_on_card_scans_through_the_kernel(card, monkeypatch):
    """A Mamba mixer at Jamba's published widths over a 700-token prompt
    (chunks of 256, 256 and 188): the kernel's outputs and last state are
    the plain scan's on the card, bit for bit, with one launch a chunk."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.models import recurrence, ssm

    cfg = dataclasses.replace(get_config("jamba2-mini"), n_layers=8)
    p = ssm.ssm_init(torch.Generator(device=card).manual_seed(1), cfg,
                     device=card)
    x = torch.randn((1, 700, cfg.d_model), device=card).to(torch.bfloat16)
    n = ls.linear_scan_cuda.launches
    with torch.no_grad():
        got, got_c = ssm.ssm_apply(p, x, cfg)
    assert ls.linear_scan_cuda.launches == n + 3
    monkeypatch.setattr(recurrence, "_on_host", lambda t: True)
    with torch.no_grad():
        want, want_c = ssm.ssm_apply(p, x, cfg)
    assert ls.linear_scan_cuda.launches == n + 3
    assert torch.equal(got, want) and torch.equal(got_c["h"], want_c["h"])


@pytest.mark.parametrize("S,chunk", [(300, 256), (64, 16)])
def test_linear_scan_backward_on_card_matches_plain_autograd(card, S,
                                                             chunk,
                                                             monkeypatch):
    """A gradient through the scan on the card: the operator's backward
    runs the kernel on each chunk reversed in time (one launch a chunk
    forward, one back, with a gradient recorded through ``a``, ``b`` and
    ``h0``), and its gradients are the plain version's autograd ones on
    the card within float32 rounding (the same products summed in
    another order: 1e-5 relative, an absolute floor of 1e-6 of the
    largest gradient, as on the host)."""
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.models import recurrence

    g = torch.Generator().manual_seed(S)
    a0 = torch.rand((2, S, 3, 1000), generator=g).to(card)
    b0 = torch.randn((2, S, 3, 1000), generator=g).to(card)
    h00 = torch.randn((2, 3, 1000), generator=g).to(card)
    w = torch.randn((2, S, 3, 1000), generator=g).to(card)

    def grads():
        leaves = [t.clone().requires_grad_(True) for t in (a0, b0, h00)]
        hs, h = recurrence.chunked_linear_scan(*leaves, chunk=chunk)
        return torch.autograd.grad((hs * w).sum() + h.sum(), leaves)

    n = ls.linear_scan_cuda.launches
    got = grads()
    torch.cuda.synchronize()
    assert ls.linear_scan_cuda.launches == n + 2 * -(-S // chunk)
    monkeypatch.setattr(recurrence, "_on_host", lambda t: True)
    want = grads()
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-5,
                                   atol=1e-6 * y.abs().max().item())


def test_linear_scan_operator_copies_what_the_kernel_cannot_read(card):
    """Chunks whose trailing dims are no contiguous run (lanes
    transposed) scan through the operator, copied into one run, with the
    plain version's states bit for bit; the raw launch refuses them."""
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.models import recurrence

    g = torch.Generator().manual_seed(3)
    a = torch.rand((2, 100, 16, 64), generator=g).to(card).transpose(2, 3)
    b = torch.randn((2, 100, 16, 64), generator=g).to(card).transpose(2, 3)
    h = torch.randn((2, 16, 64), generator=g).to(card).transpose(1, 2)
    assert not ls.takes(a, b, h)
    with pytest.raises(ValueError, match="does not take"):
        ls.linear_scan_cuda(a, b, h)
    got = torch.ops.repro_torch.linear_scan(a, b, h)
    pa, pb = recurrence._inclusive_scan(a, b)
    assert torch.equal(got, pa * h[:, None] + pb)


def test_jamba_layers_at_published_widths_against_reference(card):
    """Jamba2-Mini at its published widths, cut to two layers of a period
    of 2: a Mamba mixer with the dense FFN, then the position-free
    attention layer with the 16 experts.  A 700-token prefill (the scan's
    last chunk of 256 ragged, the experts grouped by
    ``torch._grouped_mm``) into 1024-slot caches, then 32 decode steps
    (the conv and scan states, the KV ring through the decode attention
    kernel at hd 128, group 4), against the plain float32 reference's
    forward over the 732 tokens.  The median position within 0.2 (bf16
    rounding: 0.061, decoded 0.060; the fp8 control reads 0.596, decoded
    0.580), and so the median of the decoded positions on their own,
    which the attention with a rotation put back fails (0.424); 0.2 is
    about the geometric mean of the port's and the nearer control's
    readings (on an H100, seed 2**31 + 9).  Every position within 2.5, as
    in ``test_torch_arch_jamba.py`` (a router tie flipped by rounding;
    0.94 here)."""
    import dataclasses
    import importlib
    import importlib.util

    from repro_torch.configs import get_config
    from repro_torch.models.model import LM

    bench = Path(__file__).resolve().parents[1] / "portbench"
    for name, path, pkg in (("portbench_reference", bench / "reference",
                             True),
                            ("portbench_pb_jamba", bench / "pb_jamba.py",
                             False)):
        spec = importlib.util.spec_from_file_location(
            name, path / "__init__.py" if pkg else path,
            submodule_search_locations=[str(path)] if pkg else None)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    ref = importlib.import_module("portbench_reference.jamba")
    weights = sys.modules["portbench_pb_jamba"].weights
    cfg = dataclasses.replace(get_config("jamba2-mini"), n_layers=2,
                              attn_layer_period=2, attn_layer_offset=1)
    assert cfg.layer_types() == ["ssm", "attn"] and cfg.moe_at(1)
    w = weights(cfg, 2**31 + 9, card)
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, 732), dtype=torch.int32, device=card)
    want = ref.forward(w, cfg, tokens)

    def errors(cfg):
        model = LM(cfg, device=card)
        with torch.no_grad():
            logits, caches = model.prefill(w, tokens=tokens[None, :700],
                                           capacity=1024)
            got = [logits[0]]
            for i in range(700, 732):
                step, caches = model.decode_step(
                    w, caches, tokens[None, i:i + 1],
                    torch.tensor([i], dtype=torch.int32, device=card))
                got.append(step[0])
        return (torch.cat(got).float() - want).abs().amax(-1)

    err = errors(cfg)
    ctl = (ref.forward(w, cfg, tokens, quant="fp8") - want).abs().amax(-1)
    roped = errors(dataclasses.replace(cfg, rope_theta=10_000.0))
    for name, e in (("port", err), ("fp8 control", ctl),
                    ("with a rotation", roped)):
        print(f"jamba {name} logit error: median {e.median().item()} max "
              f"{e.max().item()} decode median {e[700:].median().item()}")
    assert err.median().item() < 0.2 and err.max().item() < 2.5
    assert err[700:].median().item() < 0.2
    assert ctl.median().item() > 0.2 and ctl[700:].median().item() > 0.2
    assert roped[700:].median().item() > 0.2


# ---------------------------------------------------------------------------
# decode attention over the bf16 cache
# ---------------------------------------------------------------------------
import test_torch_decode_attention as tda  # noqa: E402

from repro_torch.kernels import decode_attention as da  # noqa: E402

#: (B, H, KV, hd, cap, window): danube's decode shape in the chat cell,
#: qwen2's group of 7, granite-20b's MQA, a smoke config's ring,
#: recurrentgemma's windowed ring (hd 256, g 16)
DECODE_SHAPES = {
    "danube": (16, 32, 8, 80, 2048, 4096),
    "qwen2": (4, 14, 2, 64, 1000, None),
    "granite20b": (4, 48, 1, 128, 512, None),
    "smoke": (4, 4, 2, 16, 32, 32),
    "recurrentgemma": (2, 16, 1, 256, 256, 128),
}


def _decode_inputs(card, name, state):
    shape = DECODE_SHAPES[name]
    ins = tda._cache(np.random.default_rng(len(name)), shape, state)
    return [t.to(card) for t in ins], shape[5]


@pytest.mark.parametrize("state", tda.STATES)
@pytest.mark.parametrize("name", sorted(DECODE_SHAPES))
def test_decode_attention_kernel_matches_plain(card, name, state):
    """The kernel against its plain version and ``attn_decode``'s widened
    path (``_attend_cache``), within ``tda.TOL`` (float32 sum
    order); the same bits from run to run; a float32 query the same bits
    as its bf16 original."""
    (q, k, v, pos, cur), window = _decode_inputs(card, name, state)
    before = da.decode_attention_cuda.launches
    got = da.decode_attention_cuda(q, k, v, pos, cur, window=window)
    again = da.decode_attention_cuda(q, k, v, pos, cur, window=window)
    got32 = da.decode_attention_cuda(q.float(), k, v, pos, cur,
                                     window=window)
    assert da.decode_attention_cuda.launches == before + 3
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert torch.equal(got, again) and torch.equal(got, got32)
    plain = da.decode_attention_torch(q, k, v, pos, cur, window=window)
    torch.testing.assert_close(got, plain, **tda.TOL)
    torch.testing.assert_close(
        got, chip_smoke.decode_plain_path(q, k, v, pos, cur, window),
        **tda.TOL)


def test_decode_attention_kernel_reads_strided_cache_views(card):
    """A layer of a stacked cache, every other head of a wider one, and a
    cache whose dead chunks hold NaN: the kernel reads what the strides
    say and never a chunk no lane can see."""
    (q, k, v, pos, cur), window = _decode_inputs(card, "qwen2", "mixed")
    want = da.decode_attention_cuda(q, k, v, pos, cur, window=window)
    stacked = torch.zeros((3,) + k.shape[:2] + (2 * k.shape[2], k.shape[3]),
                          dtype=k.dtype, device=card)
    stacked[2, :, :, 1::2] = k
    kview = stacked[2, :, :, 1::2]
    assert not kview.is_contiguous()
    got = da.decode_attention_cuda(q, kview, v, pos, cur, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    pos[:] = -1
    cur[:] = torch.tensor([5, 70, 127, 3], dtype=torch.int32)
    for i, c in enumerate(cur.tolist()):
        pos[i, :c + 1] = torch.arange(c + 1)
    clean = da.decode_attention_cuda(q, k, v, pos, cur)
    k[:, 2 * da.CHUNK:] = float("nan")
    v[:, 2 * da.CHUNK:] = float("nan")
    got = da.decode_attention_cuda(q, k, v, pos, cur)
    torch.cuda.synchronize()
    assert torch.equal(got, clean)


def test_decode_attention_kernel_rejects_what_it_does_not_take(card):
    (q, k, v, pos, cur), _ = _decode_inputs(card, "smoke", "full")
    with pytest.raises(TypeError, match="bf16 cache"):
        da.decode_attention_cuda(q, k.float(), v.float(), pos, cur)
    with pytest.raises(TypeError, match="float32 or bf16 query"):
        da.decode_attention_cuda(q.half(), k, v, pos, cur)
    with pytest.raises(ValueError, match="head widths"):
        da.decode_attention_cuda(q[..., :12].contiguous(),
                                 k[..., :12].contiguous(),
                                 v[..., :12].contiguous(), pos, cur)
    with pytest.raises(ValueError, match="layout"):
        da.decode_attention_cuda(q[..., :8].contiguous(), k[..., 1:9],
                                 v[..., 1:9], pos, cur)   # 2-byte offset
    with pytest.raises(ValueError, match="layout"):
        da.decode_attention_cuda(q, k.transpose(2, 3).contiguous()
                                 .transpose(2, 3), v, pos, cur)
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention_cuda(q.transpose(0, 1).contiguous()
                                 .transpose(0, 1), k, v, pos, cur)
    with pytest.raises(ValueError, match="one device"):
        da.decode_attention_cuda(q, k, v, pos.cpu(), cur)


def _smoke_lm(card, arch="h2o-danube-1.8b", **changes):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.convert import init_numpy
    from repro_torch.models.model import LM

    cfg = dataclasses.replace(get_config(arch, smoke=True), **changes)
    return cfg, LM(cfg, device=card), init_numpy(cfg, 0, card)


@pytest.mark.parametrize("kv_bits", [None, 8])
def test_decode_step_on_card_counts_its_path(card, kv_bits):
    """A decode step of smoke danube on the card: a bf16 cache runs the
    kernel once a layer and counts ``attn.decode_kernel`` as often; an
    int8 cache takes the plain path and counts ``attn.decode_plain``."""
    from repro_torch import trace

    cfg, model, params = _smoke_lm(card, kv_quant_bits=kv_bits)
    tokens = torch.tensor([[3, 5, 7, 9], [2, 4, 6, 8]], dtype=torch.int32,
                          device=card)
    _, caches = model.prefill(params, tokens=tokens, capacity=16)
    before = da.decode_attention_cuda.launches
    trace.enable()
    try:
        model.decode_step(params, caches,
                          tokens[:, :1], torch.full((2,), 4,
                                                    dtype=torch.int32,
                                                    device=card))
        _, counters = trace.take()
    finally:
        trace.disable()
    path = "attn.decode_plain" if kv_bits else "attn.decode_kernel"
    assert counters.get(path) == cfg.n_layers
    assert da.decode_attention_cuda.launches - before == (
        0 if kv_bits else cfg.n_layers)


def test_greedy_chat_on_card_matches_the_plain_decode(card, monkeypatch):
    """Smoke danube served greedily in 4 slots (capacity 128 over a ring
    of 32 slots under its window of 32, so the rings wrap): the tokens of
    every request with the kernel equal those of today's path (the cache
    widened and repeated), which the dispatch is told to take.  The
    kernel's step is replayed as the engine's CUDA graph, which runs no
    Python: the wrapper's count and ``attn.decode_kernel`` see the
    capturing call's eager step and its capture, a layer each, and no
    replay."""
    from repro_torch import trace
    from repro_torch.models import attention as mattn
    from repro_torch.serve.engine import Request, ServeEngine

    cfg, model, params = _smoke_lm(card)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
               for n in (5, 12, 30, 3, 17, 9)]

    def serve():
        eng = ServeEngine(model, params, batch_slots=4, capacity=128,
                          device=card)
        for i, p in enumerate(prompts):
            eng.add(Request(rid=i, prompt=p, max_new=40))
        return {r.rid: list(r.out) for r in eng.run()}

    before = da.decode_attention_cuda.launches
    trace.enable()
    try:
        got = serve()
        _, counters = trace.take()
    finally:
        trace.disable()
    launched = da.decode_attention_cuda.launches - before
    assert launched == counters["attn.decode_kernel"] == 2 * cfg.n_layers
    assert counters["serve.decode_graph"] > 0
    assert "attn.decode_plain" not in counters
    monkeypatch.setattr(mattn, "_decode_kernel_takes", lambda cache: False)
    want = serve()
    assert da.decode_attention_cuda.launches - before == launched
    assert got == want and all(len(t) == 40 for t in got.values())


# ---------------------------------------------------------------------------
# The serve engine's decode step as one CUDA graph (serve/engine.py)
# ---------------------------------------------------------------------------
def _recorded_engine(model, params, **kw):
    """A ``ServeEngine`` whose decode steps' logits are kept (cloned
    before the next replay overwrites them)."""
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(model, params, **kw)
    eng.holder, eng.logits = eng._decode, []

    def recorded(*args):
        logits, caches = eng.holder(*args)
        eng.logits.append(logits.clone())
        return logits, caches

    eng._decode = recorded
    return eng


def _chat(model, params, prompts, monkeypatch, max_new=40, graphed=True,
          **kw):
    """Serve ``prompts`` in 4 slots of capacity 128; with ``graphed``
    false, ``_decode_graph_takes`` is told to refuse every stack.  Returns
    the engine and the chains by request."""
    from repro_torch.serve import engine as se
    from repro_torch.serve.engine import Request

    with monkeypatch.context() as m:
        if not graphed:
            m.setattr(se, "_decode_graph_takes", lambda *a: False)
        eng = _recorded_engine(model, params, batch_slots=4, capacity=128,
                               device=params["embed"].device, **kw)
        for i, p in enumerate(prompts):
            eng.add(Request(rid=i, prompt=p, max_new=max_new))
        chains = {r.rid: list(r.out) for r in eng.run()}
    return eng, chains


def _chat_prompts(cfg, seed, lens=(5, 12, 30, 3, 17, 9, 44)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("temperature,chunk", [(0.0, None), (0.8, 8)],
                         ids=["greedy", "sampled-streamed"])
def test_graphed_decode_is_bit_identical_to_eager(card, monkeypatch,
                                                  temperature, chunk):
    """Smoke danube served with its decode step replayed as one CUDA graph
    against the same engine decoding eagerly: the same logits bit for bit
    at every step and the same chains, through admissions, retirements,
    rings that wrap (capacity 128 over a window of 32), with a prompt
    streamed through the decode step (``prefill_chunk``) and seeded
    sampling; every step after the first replays the graph."""
    from repro_torch import trace

    cfg, model, params = _smoke_lm(card)
    prompts = _chat_prompts(cfg, 8)
    kw = dict(temperature=temperature, prefill_chunk=chunk, seed=5)
    trace.enable()
    try:
        eng, got = _chat(model, params, prompts, monkeypatch, **kw)
        _, counters = trace.take()
    finally:
        trace.disable()
    ref, want = _chat(model, params, prompts, monkeypatch, graphed=False,
                      **kw)
    steps = eng._decode_count
    assert steps == ref._decode_count > 40
    assert eng.stats["decode_graph_replays"] == steps - 1
    assert eng.stats["decode_eager"] == 1
    assert counters["serve.decode_graph"] == steps - 1
    assert counters["serve.decode_eager"] == 1
    assert ref.stats["decode_graph_replays"] == 0
    assert ref.stats["decode_eager"] == steps
    if chunk:
        assert eng.stats["stream_prefill_tokens"] > 0
    assert len(eng.logits) == len(ref.logits) == steps
    for i, (a, b) in enumerate(zip(eng.logits, ref.logits)):
        assert torch.equal(a, b), i
    assert got == want and len(got) == len(prompts)


def test_two_engines_on_one_model_keep_their_own_graphs(card, monkeypatch):
    """Two engines on one model, stepped in turns: each captures its own
    graph over its own caches, and each one's chains and logits equal
    those of an eager engine serving its requests alone."""
    from repro_torch.serve.engine import Request

    cfg, model, params = _smoke_lm(card)
    mine = (_chat_prompts(cfg, 1, (7, 20, 3)), _chat_prompts(cfg, 2,
                                                            (11, 4, 26)))
    engines = [_recorded_engine(model, params, batch_slots=4, capacity=128,
                                device=card) for _ in mine]
    for eng, prompts in zip(engines, mine):
        for i, p in enumerate(prompts):
            eng.add(Request(rid=i, prompt=p, max_new=30))
    done = [[], []]
    while any(e.queue or any(s is not None for s in e.slots)
              for e in engines):
        for k, eng in enumerate(engines):
            if eng.queue or any(s is not None for s in eng.slots):
                done[k] += eng.step()
    a, b = (e.holder for e in engines)
    assert a.graph is not None and b.graph is not None
    assert a.graph is not b.graph and a.logits is not b.logits
    for eng, prompts, finished in zip(engines, mine, done):
        assert eng.stats["decode_graph_replays"] == eng._decode_count - 1
        ref, want = _chat(model, params, prompts, monkeypatch, max_new=30,
                          graphed=False)
        assert {r.rid: list(r.out) for r in finished} == want
        assert len(eng.logits) == len(ref.logits)
        assert all(torch.equal(x, y) for x, y in zip(eng.logits,
                                                     ref.logits))


@pytest.mark.parametrize("arch,changes", [
    ("deepseek-v2-lite", {}), ("h2o-danube-1.8b", {"kv_quant_bits": 8}),
    ("jamba2-mini", {})], ids=["mla-moe", "int8-kv", "hybrid"])
def test_engine_decodes_other_stacks_eagerly(card, monkeypatch, arch,
                                             changes):
    """A smoke DeepSeek-V2-Lite engine (latent attention, experts), an
    int8-KV danube engine and a smoke Jamba engine (Mamba states,
    experts) never capture: every decode step is eager."""
    from repro_torch import trace

    cfg, model, params = _smoke_lm(card, arch, **changes)
    trace.enable()
    try:
        eng, chains = _chat(model, params,
                            _chat_prompts(cfg, 3, (6, 13, 4)), monkeypatch,
                            max_new=12)
        _, counters = trace.take()
    finally:
        trace.disable()
    assert eng._decode_count > 0 and len(chains) == 3
    assert eng.stats["decode_eager"] == eng._decode_count \
        == counters["serve.decode_eager"]
    assert eng.stats["decode_graph_replays"] == 0
    assert "serve.decode_graph" not in counters
