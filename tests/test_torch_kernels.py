"""The port's kernel library against the JAX package's, on the CPU.

``repro_torch.kernels`` runs its plain PyTorch versions here (CPU
tensors); the reference runs its Pallas kernels in interpret mode and
its jnp oracles.  Inputs come from ``numpy.random.default_rng``.  Packed
words, quantization codes and scales, and GEMM results must be
bit-identical; attention agrees within 2e-4, the reference's tolerance.
"""

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
