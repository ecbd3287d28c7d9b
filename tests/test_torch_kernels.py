"""The port's kernel library against the JAX package's, on the CPU.

``repro_torch.kernels`` runs its plain PyTorch versions here (CPU
tensors); the reference runs its Pallas kernels in interpret mode and
its jnp oracles.  Inputs come from ``numpy.random.default_rng``.  Packed
words, quantization codes and scales, and GEMM results must be
bit-identical; attention agrees within 2e-4, the reference's tolerance.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.attention import chunked_attention  # noqa: E402
from repro_torch.kernels import bitserial_matmul as bsm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.pim import cram  # noqa: E402


def _ints(rng, bits, signed, shape):
    lo, hi = (-(1 << (bits - 1)), 1 << (bits - 1)) if signed \
        else (0, 1 << bits)
    return rng.integers(lo, hi, shape)


def _words(t):
    """int32 words of the port as the reference's uint32."""
    return t.numpy().view(np.uint32)


def _t(a):
    return torch.from_numpy(np.array(a))          # a writable copy


def _u32(planes):
    return _t(np.asarray(planes).view(np.int32))


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("bits", [1, 3, 4, 8])
def test_plane_coefs_match_reference(bits, signed):
    assert ref.plane_coefs(bits, signed) == jref.plane_coefs(bits, signed)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("axis", [0, 1])
def test_pack_words_match_reference_and_round_trip(bits, axis):
    rng = np.random.default_rng(100 + bits + axis)
    x = _ints(rng, bits, True, (64, 96)).astype(np.int8)
    x[0, :32] = -1                         # bit 31 set in every plane word
    got = ops.pack_bitplanes(_t(x), bits, axis=axis)
    want = np.asarray(jref.pack_bitplanes(jnp.asarray(x), bits, axis=axis))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_words(got), want)
    back = ops.unpack_bitplanes(got, axis=axis, signed=True)
    np.testing.assert_array_equal(back.numpy(), x.astype(np.int32))
    jback = jref.unpack_bitplanes(jnp.asarray(want), axis=axis, signed=True)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))


def test_pack_rejects_ragged_axis():
    with pytest.raises(ValueError):
        ops.pack_bitplanes(torch.zeros((4, 48), dtype=torch.int8), 4, axis=1)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_codes_and_scales_bit_identical(bits, axis):
    """The scale is the reference's bit for bit (XLA multiplies by the
    float32 reciprocal of qmax), so are the int8 codes; a zero slice
    takes the 1e-8 floor."""
    for seed in range(6):
        rng = np.random.default_rng(200 + seed)
        x = rng.normal(0, 1, (40, 96)).astype(np.float32)
        if seed == 0:
            x[3, :] = 0.0
            x[:, 5] = 0.0
        q, s = ops.quantize(_t(x), bits=bits, axis=axis)
        jq, js = jops.quantize(jnp.asarray(x), bits=bits, axis=axis)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                      np.asarray(js).view(np.uint32))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("mnk", [(16, 64, 128), (1, 33, 96), (7, 5, 32),
                                 (9, 40, 544)])
def test_quant_matmul_matches_reference(bits, mnk):
    """Plain version == JAX Pallas (interpret) == JAX oracle == port
    oracle == the exact int64 product scaled once, bit for bit."""
    m, n, k = mnk
    rng = np.random.default_rng(300 + bits)
    a = _ints(rng, 8, True, (m, k)).astype(np.int8)
    w = _ints(rng, bits, True, (k, n)).astype(np.int8)
    scale = rng.uniform(0.001, 0.1, n).astype(np.float32)
    wp = jref.pack_bitplanes(jnp.asarray(w), bits, axis=0)
    want = np.asarray(jops.quant_matmul(jnp.asarray(a), wp,
                                        jnp.asarray(scale), bits=bits,
                                        interpret=True))
    got = ops.quant_matmul(_t(a), _u32(wp), _t(scale), bits=bits)
    oracle = ref.quant_matmul(_t(a), _u32(wp), _t(scale), bits=bits)
    joracle = np.asarray(jref.quant_matmul(jnp.asarray(a), wp,
                                           jnp.asarray(scale), bits=bits))
    exact = (a.astype(np.int64) @ w.astype(np.int64)).astype(np.float32) \
        * scale[None, :]
    for x in (got.numpy(), oracle.numpy(), joracle, exact):
        np.testing.assert_array_equal(x.view(np.uint32), want.view(np.uint32))


def test_quant_matmul_out_dtype_and_checks():
    rng = np.random.default_rng(310)
    a = _t(_ints(rng, 8, True, (3, 64)).astype(np.int8))
    wp = ops.pack_bitplanes(_t(_ints(rng, 4, True, (64, 8))), 4, axis=0)
    s = torch.ones(8)
    y = ops.quant_matmul(a, wp, s, bits=4, out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, ops.quant_matmul(a, wp, s, bits=4)
                       .to(torch.bfloat16))
    with pytest.raises(ValueError):
        ops.quant_matmul(a, wp, s, bits=8)                 # planes != bits
    with pytest.raises(ValueError):
        ops.quant_matmul(a, wp, torch.ones(7), bits=4)
    with pytest.raises(TypeError):
        ops.quant_matmul(a.to(torch.int32), wp, s, bits=4)


# ---------------------------------------------------------------------------
# quant_matmul's CUDA kernel, emulated on the CPU: the unpack of packed
# words into wgmma's register A fragments, the split of K over a cluster,
# the staged partial tiles and the cluster's reduction
# ---------------------------------------------------------------------------
_QM_CU = Path(bsm.__file__).with_name("csrc") / "quant_matmul.cu"


def _qm_defines():
    return {k: int(v) for k, v in re.findall(
        r"^#define (\w+) (\d+)\b", _QM_CU.read_text(), flags=re.M)}


def _qm_token_tile(m):
    """The token tile (wgmma's N) the launch picks for M rows."""
    src = _QM_CU.read_text()
    for limit, tile in re.findall(
            r"if \(M <= (\d+)\) return launch_bits<(\d+)>", src):
        if m <= int(limit):
            return int(tile)
    return int(re.findall(r"\n  return launch_bits<(\d+)>", src)[-1])


def _qm_split(tiles, kw, sms, per_sm, max_split):
    """The launch's split of K: ``per_sm`` blocks an SM, at most
    ``max_split`` (one cluster) and at most one part per word."""
    return max(1, min(-(-(per_sm * sms) // tiles), max_split, kw))


def _spread4(x):
    """The kernel's ``spread4``: bit i of the low nibble -> bit 0 of byte
    i (one multiply)."""
    return ((x & np.uint32(0xF)) * np.uint32(0x00204081)) \
        & np.uint32(0x01010101)


def _emulate_quant_matmul_kernel(a, wp, scale, bits, sms, cover):
    """``quant_matmul_kernel`` on numpy arrays, thread by thread where the
    kernel's index arithmetic lives.  Each thread's A fragment registers
    are unpacked as the kernel does; the m16n8k32 fragment layout the
    tensor core gives each (register, byte) places them in W^T, whose
    product with the token tile accumulates in int32; the C layout and
    the kernel's store indices stage each block's partial tile, and the
    cluster's blocks sum their shares.  ``cover`` (M, N) counts the
    stores of each output element."""
    d = _qm_defines()
    bn, sw, nthr = d["QM_BN"], d["QM_STAGE_WORDS"], d["QM_THREADS"]
    m, k = a.shape
    n = wp.shape[2]
    kw = k // 32
    mt = _qm_token_tile(m)
    ntiles, mtiles = -(-n // bn), -(-m // mt)
    split = _qm_split(ntiles * mtiles, kw, sms, d["QM_BLOCKS_PER_SM"],
                      d["QM_MAX_SPLIT"])
    warp, lane = np.divmod(np.arange(nthr), 32)
    g, t = lane // 4, lane % 4
    r0 = 16 * warp + g
    # f[q][j]: (weight column, nibble shift) of register j, as unpacked
    rows, shifts = (r0, r0 + 8, r0, r0 + 8), (4 * t, 4 * t, 16 + 4 * t,
                                              16 + 4 * t)
    coefs = [np.uint32((0xFF << b) & 0xFF if b == bits - 1 else 1 << b)
             for b in range(bits)]
    out = np.zeros((m, n), np.float32)
    for nt in range(ntiles):
        n0 = nt * bn
        nv = min(bn, n - n0)
        for mi in range(mtiles):
            m0 = mi * mt
            mv = min(mt, m - m0)
            parts = []
            for z in range(split):
                kw0, kw1 = kw * z // split, kw * (z + 1) // split
                acc = np.zeros((bn, mt), np.int64)
                for s in range(-(-(kw1 - kw0) // sw)):
                    c0 = kw0 + s * sw
                    for q in range(min(sw, kw1 - c0)):
                        words = np.zeros((bits, bn), np.uint32)
                        words[:, :nv] = wp[:, c0 + q, n0:n0 + nv]
                        regs = np.zeros((nthr, 4), np.uint32)
                        for b in range(bits):
                            for j in range(4):
                                regs[:, j] += _spread4(
                                    words[b, rows[j]] >> shifts[j].astype(
                                        np.uint32)) * coefs[b]
                        byte = regs.view(np.uint8).reshape(nthr, 4, 4) \
                            .view(np.int8)
                        fa_ = np.zeros((bn, 32), np.int64)
                        hits = np.zeros((bn, 32), np.int64)
                        for j in range(4):       # m16n8k32's A layout
                            for i in range(4):
                                row = 16 * warp + g + 8 * (j & 1)
                                col = 4 * t + i + 16 * (j >> 1)
                                fa_[row, col] = byte[:, j, i]
                                hits[row, col] += 1
                        assert (hits == 1).all()
                        tok = np.zeros((32, mt), np.int64)
                        word = c0 + q
                        tok[:, :mv] = a[m0:m0 + mv,
                                        32 * word:32 * word + 32].T
                        acc += fa_ @ tok
                part = np.full((mt, bn), -1, np.int64)
                for j in range(mt // 8):
                    for e in range(4):
                        row = 16 * warp + g + 8 * (e >> 1)   # C layout
                        col = 8 * j + 2 * t + (e & 1)
                        part[8 * j + 2 * t + (e & 1), r0 + 8 * (e >> 1)] = \
                            acc[row, col]
                parts.append(part)
            quads = bn // 4                 # 4 columns of one token
            for rank in range(split):
                idx = (np.arange(rank * nthr, mt * quads,
                                 nthr * split)[:, None]
                       + np.arange(nthr)[None, :]).ravel()
                idx = idx[idx < mt * quads]
                tok, quad = np.divmod(idx, quads)
                tok = np.repeat(tok, 4)
                col = (4 * quad[:, None] + np.arange(4)[None, :]).ravel()
                ok = (m0 + tok < m) & (n0 + col < n)
                tok, col = tok[ok], col[ok]
                tot = sum(p[tok, col] for p in parts)
                tot = ((tot + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
                out[m0 + tok, n0 + col] = tot.astype(np.float32) \
                    * scale[n0 + col]
                np.add.at(cover, (m0 + tok, n0 + col), 1)
    return out


@pytest.mark.parametrize("m,k,n,bits,sms", [
    (5, 64, 70, 4, 132), (16, 96, 130, 8, 132), (1, 32, 1, 1, 132),
    (9, 160, 64, 3, 2), (129, 416, 40, 5, 132), (70, 288, 96, 2, 4),
    (8, 1184, 70, 6, 132), (3, 128, 33, 7, 1)])
def test_quant_matmul_kernel_unpack_map(m, k, n, bits, sms):
    """The kernel's unpack map, split of K (ragged parts: 5 words over 4,
    13 over 8, 9 over 4, 37 over 8), partial tiles and cluster reduction,
    emulated: bit-identical to quant_matmul_torch, the JAX Pallas
    kernel (interpret mode) and the exact product, every output stored
    once."""
    rng = np.random.default_rng(320 + bits)
    a = _ints(rng, 8, True, (m, k)).astype(np.int8)
    w = _ints(rng, bits, True, (k, n)).astype(np.int8)
    scale = rng.uniform(0.001, 0.1, n).astype(np.float32)
    wp = np.asarray(jref.pack_bitplanes(jnp.asarray(w), bits, axis=0))
    cover = np.zeros((m, n), np.int64)
    got = _emulate_quant_matmul_kernel(a, wp, scale, bits, sms, cover)
    assert (cover == 1).all()
    plain = bsm.quant_matmul_torch(_t(a), _u32(wp), _t(scale), bits=bits)
    jgot = np.asarray(jops.quant_matmul(jnp.asarray(a), jnp.asarray(wp),
                                        jnp.asarray(scale), bits=bits,
                                        interpret=True))
    exact = (a.astype(np.int64) @ w.astype(np.int64)).astype(np.float32) \
        * scale[None, :]
    for x in (plain.numpy(), jgot, exact):
        np.testing.assert_array_equal(got.view(np.uint32), x.view(np.uint32))


def test_quant_matmul_kernel_constants():
    """The kernel's widest plane count is the wrapper's, a stage is one
    128-byte row of int8 activations, one warpgroup owns wgmma's 64
    rows, and a split fits a portable cluster."""
    d = _qm_defines()
    assert d["QM_MAX_BITS"] == bsm.MAX_PLANES
    assert d["QM_STAGE_WORDS"] * 32 == 128
    assert d["QM_BN"] == 64 and d["QM_THREADS"] == 128
    assert 1 <= d["QM_MAX_SPLIT"] <= 8
    assert [_qm_token_tile(x) for x in (1, 8, 9, 64, 65, 128, 129)] == \
        [8, 8, 64, 64, 128, 128, 128]


def test_build_target_tracks_sources_and_headers(tmp_path, monkeypatch):
    """A library's name hashes its source and every shared header, so an
    edit to either builds a new library instead of loading a stale one;
    the shared header is beside the sources the build compiles."""
    from repro_torch.kernels import build
    assert (build.CSRC / "hopper.cuh").is_file()
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    first = build.target("k")
    assert build.target("k") == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = build.target("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// edit\n')
    assert build.target("k") not in (first, second)


@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
@pytest.mark.parametrize("ba,bw", [(4, 4), (8, 4), (4, 8)])
def test_popcount_matmul_matches_reference(ba, bw, signed):
    """Plain version == JAX Pallas (interpret) == both oracles == the
    exact integer product."""
    m, n, k = 16, 48, 160
    rng = np.random.default_rng(400 + ba + 2 * bw + signed)
    a = _ints(rng, ba, signed, (m, k))
    w = _ints(rng, bw, signed, (k, n))
    ap = jref.pack_bitplanes(jnp.asarray(a), ba, axis=1)
    wp = jref.pack_bitplanes(jnp.asarray(w), bw, axis=0)
    want = a.astype(np.int64) @ w.astype(np.int64)
    jgot = np.asarray(jops.popcount_matmul(ap, wp, a_signed=signed,
                                           w_signed=signed, interpret=True))
    got = ops.popcount_matmul(_u32(ap), _u32(wp), a_signed=signed,
                              w_signed=signed)
    oracle = ref.popcount_matmul(_u32(ap), _u32(wp), signed, signed)
    assert got.dtype == torch.int32
    for x in (jgot, got.numpy(), oracle.numpy()):
        np.testing.assert_array_equal(x, want)


def test_popcount_matches_port_cram_matmul():
    """Cross-layer: the popcount path == the port's Compute RAM engine
    (unsigned int4), every output of the product."""
    rng = np.random.default_rng(410)
    x = rng.integers(0, 16, (8, 64))
    w = rng.integers(0, 16, (64, 8))
    pc = ops.popcount_matmul(ops.pack_bitplanes(_t(x), 4, axis=1),
                             ops.pack_bitplanes(_t(w), 4, axis=0),
                             a_signed=False, w_signed=False)
    eng = cram.cram_matmul(x, w, n=4, signed=False, device="cpu")
    np.testing.assert_array_equal(pc.numpy().astype(np.int64), eng)
    np.testing.assert_array_equal(eng, x @ w)


def test_popcount32_counts_every_bit():
    rng = np.random.default_rng(420)
    x = rng.integers(-(1 << 31), 1 << 31, 4000).astype(np.int32)
    x[:4] = [0, -1, np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    want = [bin(int(v) & 0xFFFFFFFF).count("1") for v in x]
    np.testing.assert_array_equal(bsm.popcount32(_t(x)).numpy(), want)


def test_cpu_tensors_run_the_plain_versions():
    """The dispatch gives CPU tensors to the plain versions: no kernel
    launch is counted, and the kernel wrappers refuse CPU tensors
    before building anything."""
    rng = np.random.default_rng(430)
    a = _t(_ints(rng, 8, True, (4, 64)).astype(np.int8))
    wp = ops.pack_bitplanes(_t(_ints(rng, 4, True, (64, 8))), 4, axis=0)
    ap = ops.pack_bitplanes(a, 8, axis=1)
    q = torch.zeros((2, 8, 32))
    counts = (bsm.quant_matmul_cuda.launches,
              bsm.popcount_matmul_cuda.launches,
              fa.flash_attention_cuda.launches)
    ops.quant_matmul(a, wp, torch.ones(8), bits=4)
    ops.popcount_matmul(ap, wp)
    fa.flash_attention(q, q, q)
    assert counts == (bsm.quant_matmul_cuda.launches,
                      bsm.popcount_matmul_cuda.launches,
                      fa.flash_attention_cuda.launches)
    with pytest.raises(ValueError):
        bsm.quant_matmul_cuda(a, wp, torch.ones(8), bits=4)
    with pytest.raises(ValueError):
        bsm.popcount_matmul_cuda(ap, wp)
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, q, q)


def _qkv(rng, shape):
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", [(2, 128, 32), (4, 256, 64)])
def test_flash_attention_matches_reference(causal, shape):
    q, k, v = _qkv(np.random.default_rng(500), shape)
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=64, block_k=64, interpret=True))
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    plain = fa.flash_attention_torch(_t(q), _t(k), _t(v), causal=causal)
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    jnaive = np.asarray(jfa.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal=causal))
    naive = fa.attention_ref(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(naive.numpy(), jnaive, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), jnaive, rtol=2e-4, atol=2e-4)


def test_flash_attention_matches_model_chunked_path():
    """The plain version == the JAX model zoo's chunked attention."""
    b, s, h, hd = 2, 128, 4, 32
    q, k, v = _qkv(np.random.default_rng(510), (b, s, h, hd))
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    want = np.asarray(chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), pos, pos,
                                        causal=True, chunk=64))

    def fold(x):
        return _t(np.moveaxis(x, 2, 1).reshape(b * h, s, hd))

    got = fa.flash_attention(fold(q), fold(k), fold(v), causal=True)
    got = np.moveaxis(got.numpy().reshape(b, h, s, hd), 1, 2)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_ragged_and_bf16(causal):
    """A sequence that is not a multiple of the key block (200 = 128 +
    72), and bf16 inputs against the reference's bf16 path (one bf16
    rounding of the output apart)."""
    q, k, v = _qkv(np.random.default_rng(520), (3, 200, 32))
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    naive = fa.attention_ref(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), naive.numpy(), rtol=2e-4,
                               atol=2e-4)
    qb, kb, vb = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    got = fa.flash_attention(qb[:, :128], kb[:, :128], vb[:, :128],
                             causal=causal)
    assert got.dtype == torch.bfloat16

    def jbf(x):
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)

    want = jfa.flash_attention(jbf(qb[:, :128]), jbf(kb[:, :128]),
                               jbf(vb[:, :128]), causal=causal,
                               interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_flash_attention_checks_its_inputs():
    q = torch.zeros((2, 8, 32))
    with pytest.raises(ValueError):
        fa.flash_attention(q, q[:, :4], q)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q.double(), q)
