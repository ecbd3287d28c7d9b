"""The port's Compute-RAM GEMMs against the reference's, bit for bit.

``repro_torch.pim.cram`` runs on the CPU here (``device="cpu"``) through
its compiled executor, the path the GPU runs; the reference runs its
controller executor (``scan``), which its own tests hold equal to every
other executor.  Integer results must equal both the reference and the
exact numpy product; bf16 results are compared as bit patterns.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import harness as ref_harness  # noqa: E402
from repro.core import ref as ref_oracles  # noqa: E402
from repro.pim import cram as ref_cram  # noqa: E402
from repro_torch.core import floatprog, harness, programs, ref  # noqa: E402
from repro_torch.pim import cram  # noqa: E402


def _ints(rng, n, signed, shape):
    lo, hi = (-(1 << (n - 1)), 1 << (n - 1)) if signed else (0, 1 << n)
    return rng.integers(lo, hi, shape)


def _bf16_bits(rng, shape, zero_p=0.15):
    s = rng.integers(0, 2, shape).astype(np.uint32)
    e = rng.integers(85, 170, shape).astype(np.uint32)
    m = rng.integers(0, 1 << 7, shape).astype(np.uint32)
    bits = (s << 15) | (e << 7) | m
    return np.where(rng.random(shape) < zero_p, 0, bits).astype(np.uint64)


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("n,rows", [(4, 128), (8, 256)], ids=["int4", "int8"])
def test_cram_dot_matches_reference(n, rows, signed):
    """K past one program's capacity: two launches, host accumulation."""
    rng = np.random.default_rng(30 + n + signed)
    T = cram.idot_tile(n, rows) + 3
    a = _ints(rng, n, signed, (T, 8))
    b = _ints(rng, n, signed, (T, 8))
    got = cram.cram_dot(a, b, n, rows=rows, signed=signed, device="cpu")
    want = ref_cram.cram_dot(a, b, n, rows=rows, signed=signed,
                             executor="scan")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got.astype(np.int64), (a.astype(np.int64) * b).sum(axis=0))


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("n,rows", [(4, 128), (8, 256)], ids=["int4", "int8"])
def test_cram_matmul_matches_reference(n, rows, signed):
    """Ragged K and N tiles: K = capacity + 2, N = 8 + 5 columns."""
    rng = np.random.default_rng(40 + n + signed)
    K = cram.idot_tile(n, rows) + 2
    x = _ints(rng, n, signed, (3, K))
    w = _ints(rng, n, signed, (K, 13))
    got = cram.cram_matmul(x, w, n=n, rows=rows, cols=8, signed=signed,
                           device="cpu")
    want = ref_cram.cram_matmul(x, w, n=n, rows=rows, cols=8,
                                signed=signed, executor="scan")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  x.astype(np.int64) @ w)


def test_slice_end_to_end_int4_signed_matches_reference():
    """The slice at a small size: int4 signed GEMM on 512-row blocks
    (the paper geometry), M=4 blocks, K=70 (two K tiles), N=48 (two
    column tiles), packed compiled interior with the lane fold."""
    rng = np.random.default_rng(50)
    x = _ints(rng, 4, True, (4, 70))
    w = _ints(rng, 4, True, (70, 48))
    got = cram.cram_matmul(x, w, n=4, signed=True, device="cpu")
    want = ref_cram.cram_matmul(x, w, n=4, signed=True, executor="scan")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x.astype(np.int64) @ w)


def test_cram_matmul_executors_agree():
    rng = np.random.default_rng(51)
    x = _ints(rng, 4, False, (2, 12))
    w = _ints(rng, 4, False, (12, 10))
    outs = [cram.cram_matmul(x, w, n=4, rows=128, cols=8, executor=ex,
                             device="cpu")
            for ex in ("compiled", "scan", "unroll")]
    for o in outs:
        np.testing.assert_array_equal(o, x.astype(np.uint64) @ w)


def test_cram_fdot_bf16_matches_reference():
    """K = capacity + 1: the wide accumulator image chains across two
    launches; bit patterns equal the reference engine and the oracle."""
    rng = np.random.default_rng(52)
    fmt = floatprog.BF16
    K = cram.fdot_geometry(fmt) + 1
    a = _bf16_bits(rng, (K, 8))
    b = _bf16_bits(rng, (K, 8))
    got = cram.cram_fdot(a, b, fmt, device="cpu")
    np.testing.assert_array_equal(
        got, ref_cram.cram_fdot(a, b, "bf16", executor="scan"))
    np.testing.assert_array_equal(got, ref.float_dot(a, b))
    np.testing.assert_array_equal(got, ref_oracles.float_dot(a, b))


def test_cram_fmatmul_bf16_matches_oracle():
    rng = np.random.default_rng(53)
    x = _bf16_bits(rng, (2, 7))
    w = _bf16_bits(rng, (7, 10))
    got = cram.cram_fmatmul(x, w, "bf16", cols=8, device="cpu")
    np.testing.assert_array_equal(got, ref.float_matmul(x, w))


def test_batched_image_helpers_match_per_block_ones():
    """harness.pack_states / the batched unpack_acc that cram_matmul
    uses == the reference's per-block pack_state / unpack_acc; the
    port's pack_state (one block of pack_states) keeps the reference's
    shape check."""
    rng = np.random.default_rng(54)
    _, lay = programs.idot(4, rows=128)
    x = rng.integers(0, 16, (3, lay.tuples))
    w = rng.integers(0, 16, (lay.tuples, 5))
    batch = harness.pack_states(lay, {"a": x[:, :, None], "b": w}, 5, 3)
    for m in range(3):
        one = harness.pack_state(
            lay, {"a": np.repeat(x[m][:, None], 5, axis=1), "b": w}, 5)
        np.testing.assert_array_equal(batch[m], one)
        np.testing.assert_array_equal(one, ref_harness.pack_state(
            lay, {"a": np.repeat(x[m][:, None], 5, axis=1), "b": w}, 5))
    with pytest.raises(ValueError, match="expected"):
        harness.pack_state(lay, {"a": x, "b": w}, 5)
    acc = rng.integers(0, 2, (3, 128, 5)).astype(bool)
    np.testing.assert_array_equal(
        harness.unpack_acc(acc, lay),
        np.stack([harness.unpack_acc(acc[m], lay) for m in range(3)]))


def test_resolve_dtype_accepts_torch_dtypes():
    assert cram.resolve_dtype(torch.bfloat16) is cram.DTYPES["bf16"]
    assert cram.resolve_dtype(torch.float16) is cram.DTYPES["fp16"]
    assert cram.resolve_dtype("int4") is cram.DTYPES["int4"]
    assert cram.resolve_dtype(np.uint8) is cram.DTYPES["int8"]
    with pytest.raises(ValueError, match="unsupported dtype"):
        cram.resolve_dtype(torch.float64)


def test_cram_rejects_out_of_range_operands():
    with pytest.raises(ValueError, match="< 2\\^4"):
        cram.cram_matmul(np.full((1, 2), 16), np.ones((2, 2), int),
                         n=4, device="cpu")
    with pytest.raises(ValueError, match="signed operands"):
        cram.cram_dot(np.full((2, 2), 8), np.ones((2, 2), int), 4,
                      signed=True, device="cpu")


def test_cram_defaults_to_cuda_and_raises_without(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones((1, 2), int)
    for call in (lambda: cram.cram_matmul(x, x.T, n=4),
                 lambda: cram.cram_dot(x, x, 4),
                 lambda: cram.cram_fdot(x, x, "bf16"),
                 lambda: cram.cram_fmatmul(x, x.T, "bf16")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
