"""The fabric's device pack against its host pack, on the CPU.

``execute_program`` packs an integer class's block images on the device
(``pack_descriptor`` -> ``pack_blocks_device`` -> the ``fabric_pack``
kernel) and keeps the host's numpy ``pack_blocks`` for float classes and
faulted launches.  The kernel runs only on the card
(``test_torch_cuda.py``); here its plain torch version, which the card
tests hold the kernel to, is held bit for bit to ``pack_blocks`` on every
launch of a range of schedules, a numpy emulation of the kernel's
thread-to-byte arithmetic (read from the ``#define``\\ s of
``csrc/fabric_pack.cu``) to the plain version, and the counters to the
path each launch takes.  The outputs of ``execute_program`` against the
JAX package's stay in ``test_torch_fabric.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace  # noqa: E402
from repro_torch.core import faults  # noqa: E402
from repro_torch.kernels import fabric_pack as fpk  # noqa: E402
from repro_torch.pim import cram  # noqa: E402
from repro_torch.pim import fabric as tf  # noqa: E402

_CU = Path(fpk.__file__).with_name("csrc") / "fabric_pack.cu"


def _launches(sched, max_batch_blocks=tf.MAX_BATCH_BLOCKS):
    """``(class, [(task, slot)], n_slots)`` of every launch, grouped and
    chunked as ``execute_program`` groups and chunks its rounds."""
    compute = sched.compute_blocks
    slot_of = {b: i for i, b in enumerate(compute)}
    n = len(compute)
    groups = []
    for rnd in sched.rounds:
        c = rnd.dtype or sched.classes[0]
        if groups and groups[-1][0] == c:
            groups[-1][1].append(rnd)
        else:
            groups.append((c, [rnd]))
    for c, rlist in groups:
        chunk_r = max(1, min(len(rlist), max(max_batch_blocks, n) // n))
        for c0 in range(0, len(rlist), chunk_r):
            chunk = rlist[c0:c0 + chunk_r]
            yield c, [(t, ri * n + slot_of[t.block])
                      for ri, rnd in enumerate(chunk)
                      for t in rnd.tasks], chunk_r * n


def _encodings(rng, sched, signed):
    """Each class's ``(M, K)`` activation encoding and every GEMM's
    weight encoding, as ``fabric_fused_matmul`` makes them."""
    x_encs, w_us = {}, []
    for g, spec in enumerate(sched.gemms):
        bits = tf._dtype_info(sched.dtype_of(g)).bits
        lo, hi = (-(1 << (bits - 1)), 1 << (bits - 1)) if signed \
            else (0, 1 << bits)

        def enc(shape):
            v = rng.integers(lo, hi, shape)
            return cram._bias_signed(v, bits)[0] if signed \
                else v.astype(np.uint64)

        x_encs.setdefault(sched.dtype_of(g), enc((spec.M, spec.K)))
        w_us.append(enc((spec.K, spec.N)))
    return x_encs, w_us


#: (id, GEMMs as (N, dtype), M, K, grid, signed, max_batch_blocks)
_CASES = [
    ("int4-signed", ((11, "int4"),), 3, 25, dict(n_blocks=4), True, 512),
    ("int4-unsigned", ((13, "int4"),), 3, 25, dict(n_blocks=4), False, 512),
    ("int8-signed", ((9, "int8"),), 2, 23, dict(n_blocks=4), True, 512),
    ("int8-unsigned", ((5, "int8"),), 4, 9, dict(n_blocks=64), False, 512),
    # fused GEMMs of different N, the second narrower than a tile
    ("fused-int4", ((16, "int4"), (5, "int4"), (12, "int4")), 2, 20,
     dict(n_blocks=6), True, 512),
    # partial tiles in both K and N (kw < kt, nw < cols)
    ("partial-tiles", ((19, "int4"),), 2, 31, dict(n_blocks=4), False, 512),
    # chunks of 5 rounds: a ragged, zero-padded last chunk
    ("padded-last-chunk", ((16, "int4"),), 9, 20, dict(n_blocks=4), False,
     20),
    ("mixed-int4-int8", ((7, "int4"), (6, "int8"), (9, "int4")), 2, 22,
     dict(n_blocks=6), True, 512),
    # 32-bit words in place of bytes
    ("int16", ((5, "int16"),), 2, 6, dict(n_blocks=4, rows=256), True, 512),
]


@pytest.mark.parametrize("case", [c[0] for c in _CASES])
def test_device_pack_matches_host_pack(case):
    """Every launch's image from the descriptor and the plain kernel
    equals the host's ``pack_blocks`` bit for bit, padded slots
    included."""
    gemms, M, K, grid, signed, max_blocks = \
        {c[0]: c[1:] for c in _CASES}[case]
    cfg = tf.FabricConfig(**{"rows": 128, "cols": 8, **grid})
    specs = tuple(tf.GemmSpec(f"g{i}", M, K, n, dtype=d)
                  for i, (n, d) in enumerate(gemms))
    sched = tf.schedule_program(specs, 8, cfg=cfg, signed=signed)
    x_encs, w_us = _encodings(np.random.default_rng(len(gemms) * 7 + K),
                              sched, signed)
    ops = {}
    for c in sched.classes:
        _, lay = sched.class_program(c)
        ops[c] = tf.device_operands(
            lay, tf._dtype_info(c).bits, x_encs[c],
            {g: w for g, w in enumerate(w_us) if sched.dtype_of(g) == c},
            "cpu")
    seen = set()
    for c, slots, n_slots in _launches(sched, max_blocks):
        _, lay = sched.class_program(c)
        want = tf.pack_blocks(lay, cfg.cols, slots, n_slots, x_encs[c], w_us)
        desc = tf.pack_descriptor(slots, n_slots, ops[c].col_off, ops[c].kt,
                                  cfg.cols)
        got = tf.pack_blocks_device(ops[c], torch.from_numpy(desc), cfg.cols)
        assert got.dtype == torch.bool and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        seen.add((c, len(slots) < n_slots,
                  any(t.k1 - t.k0 < ops[c].kt for t, _ in slots),
                  any(t.n1 - t.n0 < cfg.cols for t, _ in slots)))
    # the schedule gave the case what its name says
    assert {c for c, *_ in seen} == set(sched.classes)
    if max_blocks < tf.MAX_BATCH_BLOCKS:
        assert any(padded for _, padded, _, _ in seen)
    if case == "partial-tiles":
        assert any(kp for *_, kp, _ in seen) and any(np_ for *_, np_ in seen)


def _cu_defines():
    return {k: int(v) for k, v in re.findall(
        r"^#define (\w+) (\d+)\b", _CU.read_text(), flags=re.M)}


def _kernel_emulated(x, w, desc, rowmap, cols):
    """The CUDA kernel's arithmetic in numpy, thread by thread (one entry
    of each array per thread of every block): which row and columns a
    thread packs, how it finds their operand elements, and which bytes it
    stores."""
    d = _cu_defines()
    threads, nbytes = d["FP_THREADS"], d["FP_BYTES"]
    slots, rows = desc.shape[0], rowmap.shape[0]
    per_row = -(-cols // nbytes)
    chunks = -(-(rows * per_row) // threads)
    out = np.full(slots * rows * cols, 7, np.uint8)  # unwritten bytes show
    blk, tid = np.divmod(np.arange(chunks * slots * threads), threads)
    s = blk // chunks
    t = (blk - s * chunks) * threads + tid
    live = t < rows * per_row
    s, t = s[live], t[live]
    r = t // per_row
    c0 = (t - r * per_row) * nbytes
    m, k0, kw, col0, nw, used = desc[s].T
    code = rowmap[r]
    i, bit = code >> d["FP_TUPLE_SHIFT"], code & 0xFF
    on = (used != 0) & (code >= 0) & (i < kw)
    k = np.where(on, k0 + i, 0)
    field_b = (code & d["FP_FIELD_B"]) != 0
    word = np.zeros(len(t), np.int64)
    a_bit = (x[np.where(on, m, 0), k].astype(np.int64) >> bit) & 1
    for q in range(nbytes):
        c = c0 + q
        in_b = on & field_b & (c < nw)
        v = w[k, np.where(in_b, col0 + c, 0)].astype(np.int64)
        byte = np.where(field_b, np.where(in_b, (v >> bit) & 1, 0),
                        np.where(on, a_bit, 0))
        word |= byte << (8 * q)
    for q in range(nbytes):
        c = c0 + q
        keep = c < cols
        out[((s * rows + r) * cols + c)[keep]] = (word >> (8 * q))[keep] & 0xFF
    return out.reshape(slots, rows, cols)


@pytest.mark.parametrize("rows,cols,dtype", [(128, 8, np.uint8),
                                             (9, 7, np.uint8),
                                             (40, 3, np.int32),
                                             (24, 40, np.int32)])
def test_kernel_arithmetic_matches_plain(rows, cols, dtype):
    """The kernel's thread-to-byte arithmetic (emulated from the
    source's constants) writes every byte and gives the plain version's
    image, at rows of 4k columns (word stores) and of others (byte
    stores), on bytes and 32-bit words."""
    rng = np.random.default_rng(rows + cols)
    bits = 8 if dtype == np.uint8 else 32
    M, K, ntot, slots, tuples = 3, 17, cols + 13, 5, 4
    rowmap = np.full(rows, -1, np.int32)
    free = rng.permutation(rows)[:2 * tuples]
    for n, r in enumerate(free):
        rowmap[r] = fpk.row_code(n // 2, "ab"[n % 2], int(rng.integers(bits)))
    hi = 1 << bits
    x = rng.integers(0, hi, (M, K), dtype=np.uint64).astype(
        np.uint32 if bits == 32 else np.uint8)
    w = rng.integers(0, hi, (K, ntot), dtype=np.uint64).astype(x.dtype)
    desc = np.zeros((slots, fpk.DESC_FIELDS), np.int32)
    for s in range(slots - 1):          # the last slot is padding
        kw = int(rng.integers(1, tuples + 1))
        nw = int(rng.integers(1, cols + 1))
        desc[s] = (rng.integers(M), rng.integers(K - kw + 1), kw,
                   rng.integers(ntot - nw + 1), nw, 1)
    got = _kernel_emulated(x, w, desc, rowmap, cols)
    tx, tw = (torch.from_numpy(a.view(np.int32) if bits == 32 else a)
              for a in (x, w))
    want = fpk.fabric_pack_torch(tx, tw, torch.from_numpy(desc),
                                 torch.from_numpy(rowmap), cols)
    np.testing.assert_array_equal(got, want.numpy().astype(np.uint8))
    assert not want[-1].any() and want[:-1].any()


def test_kernel_constants_match_the_wrapper():
    d = _cu_defines()
    assert (d["FP_DESC"], d["FP_FIELD_B"], d["FP_TUPLE_SHIFT"]) \
        == (fpk.DESC_FIELDS, fpk.ROW_FIELD_B, fpk.ROW_TUPLE_SHIFT)
    assert 1 << d["FP_TUPLE_SHIFT"] == 2 * fpk.ROW_FIELD_B


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_rowmap_names_every_operand_row_of_the_layout(bits):
    """Each operand row of an ``idot`` layout is named once, with its
    tuple, field and bit; every other row (accumulator, product scratch,
    the zero row) is -1."""
    from repro_torch.core import programs

    _, lay = programs.idot(bits, rows=512)
    rowmap = tf.pack_rowmap(lay)
    assert rowmap.shape == (512,) and rowmap.dtype == np.int32
    named = {}
    for i in range(lay.tuples):
        for name in ("a", "b"):
            off, width = lay.fields[name]
            for j in range(width):
                named[lay.base(i) + off + j] = fpk.row_code(i, name, j)
    assert {r: int(v) for r, v in enumerate(rowmap) if v >= 0} == named
    assert (rowmap[:lay.acc_bits] == -1).all()


def test_descriptor_and_wrappers_refuse_what_the_kernel_does_not_take():
    cfg = tf.FabricConfig(n_blocks=4, rows=128, cols=8)
    sched = tf.schedule_gemm(2, 20, 16, 4, cfg=cfg)
    slots = next(_launches(sched))[1]
    with pytest.raises(ValueError, match="columns"):
        tf.pack_descriptor(slots, 64, {0: 0}, sched.kt, cols=4)
    with pytest.raises(ValueError, match="slots"):
        tf.pack_descriptor(slots, 1, {0: 0}, sched.kt, cfg.cols)
    desc = tf.pack_descriptor(slots, 64, {0: 0}, sched.kt, cfg.cols)
    assert desc.dtype == np.int32 and desc.shape == (64, fpk.DESC_FIELDS)
    assert (desc[:, 5] == 1).sum() == len(slots)
    for t, slot in slots:
        assert tuple(desc[slot]) == (t.m, t.k0, t.k1 - t.k0, t.n0,
                                     t.n1 - t.n0, 1)
    x = torch.zeros((2, 20), dtype=torch.uint8)
    w = torch.zeros((20, 16), dtype=torch.uint8)
    d = torch.from_numpy(desc)
    rm = torch.full((128,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fpk.fabric_pack_cuda(x, w, d, rm, 8)
    with pytest.raises(TypeError, match="uint8 or int32"):
        fpk.fabric_pack(x.long(), w.long(), d, rm, 8)
    with pytest.raises(ValueError, match="desc"):
        fpk.fabric_pack(x, w, d[:, :5], rm, 8)
    with pytest.raises(ValueError, match="device pack"):
        tf.device_operands(sched.class_program("int4")[1], 33,
                           np.zeros((2, 20), np.uint64),
                           {0: np.zeros((20, 16), np.uint64)}, "cpu")
    for bad in ((0, "c", 0), (0, "a", 32), (-1, "b", 0)):
        with pytest.raises(ValueError):
            fpk.row_code(*bad)


@pytest.mark.parametrize("bits", [4, 16])
def test_device_operands_are_contiguous_whatever_the_operands_order(bits):
    """Operands handed over transposed (Fortran order, as a layer's
    ``(K, N)`` view of its ``(N, K)`` weights) still go up as contiguous
    rows: bytes up to 8 bits, 32-bit words above; each GEMM's columns at
    its offset."""
    rng = np.random.default_rng(bits)
    _, lay = tf.schedule_gemm(2, 20, 16, bits, cfg=tf.FabricConfig(
        n_blocks=4, rows=256, cols=8)).class_program(f"int{bits}")
    x = np.asfortranarray(rng.integers(0, 1 << bits, (2, 20),
                                       dtype=np.uint64))
    ws = {0: rng.integers(0, 1 << bits, (7, 20), dtype=np.uint64).T,
          2: rng.integers(0, 1 << bits, (5, 20), dtype=np.uint64).T}
    ops = tf.device_operands(lay, bits, x, ws, "cpu")
    want_dtype = torch.uint8 if bits <= 8 else torch.int32
    for t in (ops.x, ops.w, ops.rowmap):
        assert t.is_contiguous()
    assert ops.x.dtype == ops.w.dtype == want_dtype
    assert ops.col_off == {0: 0, 2: 7} and ops.kt == lay.tuples
    np.testing.assert_array_equal(ops.x.numpy().astype(np.uint64), x)
    np.testing.assert_array_equal(ops.w.numpy().astype(np.uint64),
                                  np.concatenate([ws[0], ws[2]], axis=1))


def _counted(run):
    trace.enable()
    try:
        run()
    finally:
        _, counters = trace.take()
        trace.disable()
    return counters


def _int_gemm(seed=0, m=3, k=20, n=9):
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 8, (m, k)), rng.integers(-8, 8, (k, n)))


@pytest.mark.parametrize("case", ["int", "bf16", "faulted-int", "mixed"])
def test_each_launch_counts_where_it_packed(case):
    """Integer launches without a fault model pack on the device; a bf16
    class and every launch under an active fault model pack on the host;
    a mixed program chooses per class.  Outputs stay exact."""
    x, w = _int_gemm()
    cfg = tf.FabricConfig(n_blocks=4, rows=128, cols=8)
    if case == "int":
        run = lambda: tf.fabric_matmul(x, w, nbits=4, signed=True, cfg=cfg,
                                       device="cpu")
    elif case == "faulted-int":
        run = lambda: tf.fabric_matmul(
            x, w, nbits=4, signed=True, cfg=cfg, device="cpu",
            faults=faults.FaultModel(bit_rate=1e-3, seed=1))
    else:
        cfg = tf.FabricConfig(n_blocks=6, cols=8)       # 512 rows: bf16
        x, w = x[:1, :12], w[:12, :5]
        dtypes = ("bf16",) if case == "bf16" else ("int4", "bf16")
        ws = (w,) * len(dtypes)
        run = lambda: tf.fabric_fused_matmul(
            x.astype(np.float32), ws, nbits=4, signed=True, cfg=cfg,
            dtypes=dtypes, device="cpu")
    out = {}
    counters = _counted(lambda: out.setdefault("res", run()))
    res = out["res"]
    sched = res.schedule
    launches = counters.get("fabric.packed_on_device", 0) \
        + counters.get("fabric.packed_on_host", 0)
    assert launches > 0
    on_device = {"int": launches, "faulted-int": 0, "bf16": 0}.get(case)
    if on_device is not None:
        assert counters.get("fabric.packed_on_device", 0) == on_device
    else:        # one launch group per class: int4 on the card, bf16 not
        assert counters["fabric.packed_on_device"] >= 1
        assert counters["fabric.packed_on_host"] >= 1
    if case == "int":
        np.testing.assert_array_equal(np.asarray(res.out, np.int64), x @ w)
    if case == "mixed":
        np.testing.assert_array_equal(np.asarray(res.outs[0], np.int64),
                                      x @ w)
    assert counters["fabric.slots_used"] \
        == sum(len(r.tasks) for r in sched.rounds)
