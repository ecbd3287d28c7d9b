"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
sm_90a, one process per source, all at once), holds each kernel against
its plain PyTorch version on the card, then drives the port's two paths
through their public entry points:

* the Compute RAM engine: ``cram_matmul`` int4 on the attention
  projections of layer 0 of qwen2-0.5b at their published widths
  (896 -> 896/128/128/896, 128 tokens), which runs the engine's packed
  compiled interior and its ``lane_fold`` kernel; ``cram_matmul`` int8
  and ``cram_fdot`` bf16; and the three executors on one block;
* the PIM linear layer and the kernel library: layer 0 of qwen2-0.5b
  (q/k/v, o, gate/up, down at the published widths, with the attention
  between them) through ``linear_apply`` / ``fused_linear_apply`` in
  modes ``pallas`` (``quant_matmul``) and ``popcount``
  (``popcount_matmul``) and ``flash_attention``, on 128 tokens and on a
  decode step of 8.

Every result is checked exactly against numpy or the port's oracles, or
within a stated tolerance.  Prints one JSON object per phase, the card's
name and power limit, the kernels line, then ``{"ok": true, "device":
{...}}`` last.  Exits non-zero, printing no result, when no CUDA device
is present or a phase fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (engine, floatprog, harness,  # noqa: E402
                              programs, ref)
from repro_torch.kernels import bitplane_ops as bp  # noqa: E402
from repro_torch.kernels import bitserial_matmul as bsm  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.pim import cram  # noqa: E402
from repro_torch.pim import linear as pl  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
INT32_OPS_PER_S = 67e12        # 32-bit non-tensor-core peak (data sheet)
TF32_FLOPS = 495e12            # TF32 tensor cores, dense
BF16_FLOPS = 989e12            # bf16 tensor cores, dense
INT8_OPS_PER_S = 1979e12       # int8 tensor cores, dense


#: kernels whose design runs on the tensor cores: the build phase fails
#: when their SASS holds no tensor-core instruction
TENSOR_CORE_KERNELS = ("quant_matmul", "popcount_matmul", "flash_attention")


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps=50, warmup=5):
    """Min over ``reps`` single calls timed with CUDA events (ms); the
    host's launch gap after the start event is inside the time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def cuda_events(prof):
    """(device us, count, name) of each CUDA item of a profile."""
    out = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        out.append((us, e.count, e.key))
    return sorted(out, reverse=True)


def graph_ms(fn, reps=20):
    """Device time of one call of ``fn`` (ms): ``reps`` calls captured in
    one CUDA graph and replayed between two CUDA events, after a warm-up
    call and a warm-up replay.  The kernels run back to back, so the
    host's launch costs are not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                       # lazy set-up stays outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timings(fn, reps=50, warmup=5, graph_reps=20):
    """``{"ms": graph_ms, "event_ms": time_ms}`` of ``fn``."""
    return {"ms": graph_ms(fn, graph_reps),
            "event_ms": time_ms(fn, reps=reps, warmup=warmup)}


def fold_inputs(rng, m, lanes, words, live=None, top=False):
    x = rng.integers(0, 1 << 32, (m, lanes, words), dtype=np.uint64)
    x = x.astype(np.uint32)
    if top:
        x |= np.uint32(1 << 31)
    planes = [torch.from_numpy(x[i].view(np.int32)).cuda()
              if live is None or i in live else None for i in range(m)]
    return planes


def words_u64(planes, words):
    """Fold result planes (None = zero) -> (width, W) int64 of uint32."""
    return torch.stack([
        torch.zeros(words, dtype=torch.int64, device="cuda") if p is None
        else p.to(torch.int64) & 0xFFFFFFFF for p in planes])


def phase_kernel(rng):
    """lane_fold on the card == lane_fold_torch on the same tensors."""
    shapes = [  # (m, T, W, width, live planes, top bit forced)
        (3, 3, 4, 5, None, False), (4, 8, 16, 8, None, False),
        (4, 17, 33, 12, None, False), (6, 5, 7, 6, {0, 1, 3, 5}, False),
        (6, 5, 7, 6, {0, 2}, False),
        (15, 57, 160, 15, set(range(8)), False),
        (15, 57, 160, 15, set(range(8)), True),
        (4, 17, 33, 12, None, True), (15, 25, 160, 15, set(range(8)), False),
    ]
    max_err = 0
    for m, lanes, words, width, live, top in shapes:
        planes = fold_inputs(rng, m, lanes, words, live, top)
        got = bp.lane_fold(planes, width, packed=True)
        want = bp.lane_fold_torch(planes, width)
        torch.cuda.synchronize()
        err = int((words_u64(got, words) - words_u64(want, words))
                  .abs().max().item())
        if err:
            raise AssertionError(
                f"lane_fold kernel != plain at {(m, lanes, words, width)}: "
                f"max abs diff {err}")
        max_err = max(max_err, err)
    # timing at the main path's shape: 15 planes of which the low 8 are
    # live, 57 lanes, 160 words (128 blocks x 40 columns).  lane_fold
    # hands the kernel the planes up to the last live one, so the timed
    # call is the main path's: m = 8 planes read, 15 written.
    planes_given, lanes, words, width, live = 15, 57, 160, 15, range(8)
    planes = fold_inputs(rng, planes_given, lanes, words, set(live))
    m = max(live) + 1
    x = torch.stack(planes[:m])
    kern = timings(lambda: bp.lane_fold_cuda(x, width))
    plain = timings(lambda: bp.lane_fold_torch(planes, width), reps=20)
    nbytes = (m * lanes * words + width * words) * 4
    # word operations of the adds: a full adder (5 ops) per live plane,
    # carry propagation (2 ops) per plane above them, per lane and word
    ops = (5 * m + 2 * (width - m)) * lanes * words
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    stats = {"max_abs_err": max_err, "ms": kern["ms"],
             "plain_ms": plain["ms"], "event_ms": kern["event_ms"],
             "plain_event_ms": plain["event_ms"],
             "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
             "shape": [m, lanes, words, width],
             "planes_given": planes_given, "bytes": nbytes, "ops": ops}
    stats["sweep"] = fold_sweep(rng, planes_given, lanes, width, live)
    emit({"phase": "kernel_vs_plain", "ok": True, "shapes": len(shapes),
          **stats})
    return stats


#: word columns of the fold sweep: the main path's 160 and both sides
FOLD_SWEEP_WORDS = (1, 32, 160, 2048, 4096)


def fold_sweep(rng, planes_given, lanes, width, live):
    """The kernel against the plain tree on the card at the main path's
    planes and lanes over :data:`FOLD_SWEEP_WORDS` word columns: both
    graph times, bit for bit equal, and the widths at which the kernel
    is the quicker (the question the TPU's ``PALLAS_FOLD_MIN_COLS``
    answers there)."""
    rows = []
    m = max(live) + 1
    for words in FOLD_SWEEP_WORDS:
        planes = fold_inputs(rng, planes_given, lanes, words, set(live))
        x = torch.stack(planes[:m])
        got = bp.lane_fold(planes, width, packed=True)
        want = bp.lane_fold_torch(planes, width)
        torch.cuda.synchronize()
        if not torch.equal(words_u64(got, words), words_u64(want, words)):
            raise AssertionError(f"lane_fold kernel != plain at W={words}")
        kern = graph_ms(lambda: bp.lane_fold_cuda(x, width))
        plain = graph_ms(lambda: bp.lane_fold_torch(planes, width), reps=5)
        nbytes = (m * lanes * words + width * words) * 4
        rows.append({"words": words, "ms": kern, "plain_ms": plain,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
    return {"shape": [m, lanes, width], "rows": rows,
            "kernel_quicker_at": [r["words"] for r in rows
                                  if r["ms"] < r["plain_ms"]]}


def phase_main_path(rng):
    """Layer 0 attention projections of qwen2-0.5b, int4 signed, on CR
    blocks: every output equals the exact int64 product."""
    cfg = get_config("qwen2-0.5b")
    d, kv = cfg.d_model, cfg.n_kv_heads * (cfg.d_model // cfg.n_heads)
    tokens = 128
    projs = {"q": (d, d), "k": (d, kv), "v": (d, kv), "o": (d, d)}
    data = {name: (rng.integers(-8, 8, (tokens, k)),
                   rng.integers(-8, 8, (k, n)))
            for name, (k, n) in projs.items()}
    torch.cuda.synchronize()
    bp.lane_fold_cuda.launches = 0
    c0 = engine.compile_cache_stats()
    t0 = time.perf_counter()
    outs = {name: cram.cram_matmul(x, w, n=4, signed=True)
            for name, (x, w) in data.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bp.lane_fold_cuda.launches
    c1 = engine.compile_cache_stats()
    calls = (c1["hits"] + c1["misses"]) - (c0["hits"] + c0["misses"])
    for name, (x, w) in data.items():
        want = x.astype(np.int64) @ w.astype(np.int64)
        if outs[name].shape != want.shape or not np.array_equal(
                outs[name], want):
            raise AssertionError(f"int4 {name} projection != numpy")
    if launches == 0:
        raise AssertionError("main path never launched the lane_fold kernel")
    emit({"phase": "main_path_int4", "ok": True, "model": cfg.name,
          "layer": 0, "tokens": tokens,
          "projections": {k: list(v) for k, v in projs.items()},
          "wall_s": wall, "execute_blocks_calls": calls,
          "lane_fold_launches": launches})
    return launches, wall, calls


def phase_profile(rng, reps=3):
    """Where the time of one main-path tile goes: ``reps`` calls of an
    int4 GEMM that is exactly one ``execute_blocks`` launch (128 blocks,
    58 tuples, 40 columns) under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    x = rng.integers(-8, 8, (128, 58))
    w = rng.integers(-8, 8, (58, 40))
    cram.cram_matmul(x, w, n=4, signed=True)          # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            cram.cram_matmul(x, w, n=4, signed=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = cuda_events(prof)
    busy_us = sum(k[0] for k in kernels)
    fold_us = sum(k[0] for k in kernels if "lane_fold" in k[2])
    emit({"phase": "profile_one_tile", "ok": True, "calls": reps,
          "wall_ms_per_call": wall / reps * 1e3,
          "device_busy_ms_per_call": busy_us / reps / 1e3 if kernels
          else None,
          "device_kernels_per_call": sum(k[1] for k in kernels) / reps,
          "lane_fold_ms_per_call": fold_us / reps / 1e3,
          "top_kernels": [{"name": k[2][:80], "count": k[1] // reps,
                           "ms_per_call": k[0] / reps / 1e3}
                          for k in kernels[:8]]})


def phase_int8_bf16(rng):
    cfg = get_config("qwen2-0.5b")
    d = cfg.d_model
    x = rng.integers(-128, 128, (16, d))
    w = rng.integers(-128, 128, (d, d))
    t0 = time.perf_counter()
    got = cram.cram_matmul(x, w, n=8, signed=True)
    wall8 = time.perf_counter() - t0
    if not np.array_equal(got, x.astype(np.int64) @ w.astype(np.int64)):
        raise AssertionError("int8 q projection != numpy")
    K = cram.fdot_geometry(floatprog.BF16)
    s = rng.integers(0, 2, (2, K, 40)).astype(np.uint64)
    e = rng.integers(85, 170, (2, K, 40)).astype(np.uint64)
    m = rng.integers(0, 128, (2, K, 40)).astype(np.uint64)
    a, b = (s << np.uint64(15)) | (e << np.uint64(7)) | m
    t0 = time.perf_counter()
    fd = cram.cram_fdot(a, b, "bf16")
    wallf = time.perf_counter() - t0
    if not np.array_equal(fd, ref.float_dot(a, b)):
        raise AssertionError("bf16 cram_fdot != core.ref.float_dot")
    emit({"phase": "int8_bf16", "ok": True, "int8_shape": [16, d, d],
          "int8_wall_s": wall8, "bf16_tuples": K, "bf16_cols": 40,
          "bf16_wall_s": wallf})


def phase_executors(rng):
    """unroll, scan, compiled packed and compiled bool agree bit for bit
    on one 512 x 40 block."""
    for name, (prog, lay) in {"idot4": programs.idot(4, rows=512),
                              "imul8": programs.imul(8, rows=512)}.items():
        w = lay.fields["a"][1]
        data = {f: rng.integers(0, 1 << w, (lay.tuples, 40))
                for f in ("a", "b")}
        state = harness.make_torch_state(harness.pack_state(lay, data, 40))
        outs = {(ex, pk): engine.state_to_numpy(
                    engine.run(prog, state, ex, packed=pk))
                for ex, pk in [("unroll", None), ("scan", None),
                               ("compiled", True), ("compiled", False)]}
        base = outs[("unroll", None)]
        for key, out in outs.items():
            if not all(np.array_equal(p, q) for p, q in zip(base, out)):
                raise AssertionError(f"{name}: {key} != unroll")
    emit({"phase": "executors_agree", "ok": True,
          "programs": ["idot4", "imul8"], "rows": 512, "cols": 40})


# ---------------------------------------------------------------------------
# The PIM linear layer and the kernel library
# ---------------------------------------------------------------------------
def layer_linears(cfg):
    """(d_in, d_out) of the seven linears of one layer of ``cfg``."""
    d, kv = cfg.d_model, cfg.n_kv_heads * cfg.hd
    return {"q": (d, d), "k": (d, kv), "v": (d, kv), "o": (d, d),
            "gate": (d, cfg.d_ff), "up": (d, cfg.d_ff), "down": (cfg.d_ff, d)}


def signed_ints(rng, bits, shape):
    return rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), shape)


def bound_ms(nbytes, ops, peak):
    """Least time for the work: bytes at the memory rate or operations at
    ``peak``, whichever is longer; and which of the two it is."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / peak * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms \
        else "operations"


def gemm_work(kind, m, k, n, ba=8, bw=4):
    """Bytes each GEMM kernel must move (inputs once, output once) and
    the integer operations of the product, 2*M*N*K."""
    if kind == "quant_matmul":        # int8 a, packed w, f32 scale, f32 out
        nbytes = m * k + bw * (k // 32) * n * 4 + 4 * n + 4 * m * n
    else:                             # packed a and w, int32 out
        nbytes = (ba * m + bw * n) * (k // 32) * 4 + 4 * m * n
    return nbytes, 2 * m * n * k


def try_timings(fn, **kw):
    """``timings`` of a yardstick call, or the error it raised."""
    try:
        return timings(fn, **kw), None
    except Exception as e:  # the library call is not on any path
        return {"ms": None, "event_ms": None}, \
            f"{type(e).__name__}: {e}"[:200]


TOKENS, DECODE_SEQS = 128, 8    # the main path's prefill and decode M

#: (M, K, N) besides the main path's: M = 1 and 7, K = 32
OTHER_GEMM_SHAPES = [(1, 4864, 896), (1, 896, 4864), (7, 896, 4864),
                     (7, 32, 128), (128, 32, 4864)]


def gemm_shapes(cfg):
    """Every (M, K, N) the main path gives the GEMM kernels (layer 0's
    linears at the prefill and decode M), then the others."""
    path = sorted({(m, k, n) for m in (TOKENS, DECODE_SEQS)
                   for k, n in layer_linears(cfg).values()})
    return path + OTHER_GEMM_SHAPES


def quant_more(rng, t, k, n):
    """quant_matmul at one linear's (K, N) beside the W4, M = 128 time:
    W8 at M = 128, and W4 at the decode step's M = 8 with
    ``torch._int_mm`` on the same int8 operands where it takes them;
    each checked bit for bit against the plain version first."""
    out = {}
    for label, m, bits in (("W8 M=128", TOKENS, 8), ("W4 M=8", DECODE_SEQS,
                                                      4)):
        a8 = t(signed_ints(rng, 8, (m, k)).astype(np.int8))
        w = t(signed_ints(rng, bits, (k, n)).astype(np.int8))
        st = t(rng.uniform(0.001, 0.1, n).astype(np.float32))
        wp = kref.pack_bitplanes(w, bits, axis=0)
        got = bsm.quant_matmul_cuda(a8, wp, st, bits=bits)
        want = bsm.quant_matmul_torch(a8, wp, st, bits=bits)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"quant_matmul {label} at {(m, k, n)} "
                                 f"!= plain")
        nbytes, ops = gemm_work("quant_matmul", m, k, n, bw=bits)
        lib, lib_err = try_timings(lambda: torch._int_mm(a8, w))
        out[label] = {"shape": [m, k, n], "bits": bits,
                      "ms": graph_ms(lambda: bsm.quant_matmul_cuda(
                          a8, wp, st, bits=bits)),
                      "library_ms": lib["ms"], "library_error": lib_err,
                      "bound_ms": bound_ms(nbytes, ops, INT8_OPS_PER_S)[0]}
    return out


def phase_gemm(rng):
    """quant_matmul (W4, W8) and popcount_matmul (A8W4, A4W4, signed and
    unsigned) on the card == their plain versions == the ``ref`` oracles
    == numpy's int64 product, bit for bit, at every shape of the main
    path and a few more; popcount_matmul == the engine's cram_matmul;
    then each kernel's time over the seven linears of qwen2-0.5b's layer
    0 at 128 tokens."""
    cfg = get_config("qwen2-0.5b")
    shapes = gemm_shapes(cfg)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).cuda()

    def same(name, shape, got, want):
        got = got.cpu().numpy()
        if got.shape != want.shape or not np.array_equal(
                got.view(np.int32), want.view(np.int32)):
            raise AssertionError(f"{name} at {shape} differs from numpy")
        return got

    def diff(x, y):
        return float(np.abs(x.astype(np.float64) - y).max())

    checks = 0
    max_err = {"quant_matmul": 0.0, "popcount_matmul": 0.0}
    for m, k, n in shapes:
        a8 = signed_ints(rng, 8, (m, k)).astype(np.int8)
        for bits in (4, 8):
            w = signed_ints(rng, bits, (k, n)).astype(np.int8)
            scale = rng.uniform(0.001, 0.1, n).astype(np.float32)
            exact = (a8.astype(np.int64) @ w.astype(np.int64)
                     ).astype(np.float32) * scale[None, :]
            at, st = t(a8), t(scale)
            wp = kref.pack_bitplanes(t(w), bits, axis=0)
            got = {name: same(f"quant_matmul W{bits} {name}", (m, k, n),
                              fn(at, wp, st, bits=bits), exact)
                   for name, fn in (("kernel", bsm.quant_matmul_cuda),
                                    ("plain", bsm.quant_matmul_torch),
                                    ("ref", kref.quant_matmul))}
            checks += len(got)
            max_err["quant_matmul"] = max(max_err["quant_matmul"],
                                          diff(got["kernel"], got["plain"]))
        cases = {"A8W4s": (8, 4, True), "A4W4s": (4, 4, True),
                 "A8W4u": (8, 4, False), "A4W4u": (4, 4, False)}
        for case, (ba, bw, sg) in cases.items():
            if sg:
                a = a8 if ba == 8 else signed_ints(rng, ba, (m, k))
                w = signed_ints(rng, bw, (k, n))
            else:
                a = rng.integers(0, 1 << ba, (m, k))
                w = rng.integers(0, 1 << bw, (k, n))
            exact = (a.astype(np.int64) @ w.astype(np.int64)).astype(np.int32)
            ap = kref.pack_bitplanes(t(a), ba, axis=1)
            wp = kref.pack_bitplanes(t(w), bw, axis=0)
            got = {name: same(f"popcount_matmul {case} {name}", (m, k, n),
                              out, exact)
                   for name, out in (
                       ("kernel", bsm.popcount_matmul_cuda(
                           ap, wp, a_signed=sg, w_signed=sg)),
                       ("plain", bsm.popcount_matmul_torch(
                           ap, wp, a_signed=sg, w_signed=sg)),
                       ("ref", kref.popcount_matmul(ap, wp, sg, sg)))}
            checks += len(got)
            max_err["popcount_matmul"] = max(
                max_err["popcount_matmul"], diff(got["kernel"], got["plain"]))
    # cross-layer: the popcount path == the Compute RAM engine's idot
    # (unsigned int4, every output of an 8 x 64 @ 64 x 8 product)
    x = rng.integers(0, 16, (8, 64))
    w = rng.integers(0, 16, (64, 8))
    pc = bsm.popcount_matmul_cuda(
        kref.pack_bitplanes(t(x), 4, axis=1),
        kref.pack_bitplanes(t(w), 4, axis=0), a_signed=False, w_signed=False)
    eng = cram.cram_matmul(x, w, n=4, signed=False)
    if not np.array_equal(pc.cpu().numpy().astype(np.int64), eng):
        raise AssertionError("popcount_matmul != cram_matmul (int4 unsigned)")

    # times over the main path's seven linears at M = 128 tokens, W4A8
    m = TOKENS
    keys = ("ms", "event_ms", "plain_ms", "plain_event_ms", "library_ms",
            "library_event_ms")
    tot = {kind: {**{key: 0.0 for key in keys}, "bytes": 0, "ops": 0,
                  "library_error": None}
           for kind in ("quant_matmul", "popcount_matmul")}
    per = []
    for lin, (k, n) in layer_linears(cfg).items():
        a8 = signed_ints(rng, 8, (m, k)).astype(np.int8)
        w4 = signed_ints(rng, 4, (k, n)).astype(np.int8)
        at, st = t(a8), t(rng.uniform(0.001, 0.1, n).astype(np.float32))
        wp = kref.pack_bitplanes(t(w4), 4, axis=0)
        ap = kref.pack_bitplanes(at, 8, axis=1)
        wi8 = t(w4)
        lib, lib_err = try_timings(lambda: torch._int_mm(at, wi8))
        row = {"linear": lin, "shape": [m, k, n]}
        for kind, kern, plain in (
                ("quant_matmul",
                 lambda: bsm.quant_matmul_cuda(at, wp, st, bits=4),
                 lambda: bsm.quant_matmul_torch(at, wp, st, bits=4)),
                ("popcount_matmul",
                 lambda: bsm.popcount_matmul_cuda(ap, wp),
                 lambda: bsm.popcount_matmul_torch(ap, wp))):
            kt = timings(kern)
            pt = timings(plain, reps=3, warmup=1, graph_reps=3)
            nbytes, ops = gemm_work(kind, m, k, n)
            got = {"ms": kt["ms"], "event_ms": kt["event_ms"],
                   "plain_ms": pt["ms"], "plain_event_ms": pt["event_ms"],
                   "library_ms": lib["ms"],
                   "library_event_ms": lib["event_ms"]}
            tt = tot[kind]
            for key in keys:
                tt[key] = None if got[key] is None or tt[key] is None \
                    else tt[key] + got[key]
            tt["bytes"] += nbytes
            tt["ops"] += ops
            tt["library_error"] = tt["library_error"] or lib_err
            row[kind] = {**got, "bound_ms": bound_ms(nbytes, ops,
                                                     INT8_OPS_PER_S)[0]}
        row["quant_matmul_more"] = quant_more(rng, t, k, n)
        per.append(row)
    for kind, tt in tot.items():
        tt["bound_ms"], tt["bound_by"] = bound_ms(tt["bytes"], tt["ops"],
                                                  INT8_OPS_PER_S)
        tt["max_abs_err"] = max_err[kind]
    emit({"phase": "gemm_kernels_vs_plain", "ok": True,
          "shapes": [list(s) for s in shapes], "checks": checks,
          "cram_cross_check": True, "timed": "W4A8, layer-0 linears, M=128",
          "per_linear": per, "totals": tot})
    return tot


def fold_heads(x, seqs, heads, hd):
    """(seqs * S, heads * hd) -> (seqs * heads, S, hd), contiguous."""
    s = x.shape[0] // seqs
    return x.reshape(seqs, s, heads, hd).permute(0, 2, 1, 3) \
        .reshape(seqs * heads, s, hd).contiguous()


def unfold_heads(x, seqs, heads):
    """Inverse of :func:`fold_heads`."""
    bh, s, hd = x.shape
    return x.reshape(seqs, heads, s, hd).permute(0, 2, 1, 3) \
        .reshape(seqs * s, heads * hd)


def attention(q, k, v, cfg, seqs):
    """Causal GQA attention of ``seqs`` sequences through the library's
    ``flash_attention``; each KV head is repeated to its query group, as
    the reference's ``models/attention.py::_repeat_kv`` does.  Returns
    the attention output and the (BH, S, hd) q, k, v and output that
    ``flash_attention`` took and gave."""
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    qf = fold_heads(q, seqs, h, hd)
    kf = fold_heads(k, seqs, kvh, hd).reshape(seqs, kvh, -1, hd) \
        .repeat_interleave(h // kvh, dim=1).reshape(seqs * h, -1, hd)
    vf = fold_heads(v, seqs, kvh, hd).reshape(seqs, kvh, -1, hd) \
        .repeat_interleave(h // kvh, dim=1).reshape(seqs * h, -1, hd)
    af = fa.flash_attention(qf, kf, vf, causal=True)
    return unfold_heads(af, seqs, h), (qf, kf, vf, af)


def layer0(params, x, pim, cfg, seqs):
    """Layer 0's linears with the attention between them (no norms, no
    biases): returns every linear's output, the input it was given, and
    the attention's (q, k, v, out) as :func:`attention` gives them."""
    q, k, v = pl.fused_linear_apply([params[n] for n in ("q", "k", "v")],
                                    x, pim)
    a, attn = attention(q, k, v, cfg, seqs)
    o = pl.linear_apply(params["o"], a, pim)
    h = x + o
    gate, up = pl.fused_linear_apply([params["gate"], params["up"]], h, pim)
    act = torch.nn.functional.silu(gate) * up
    down = pl.linear_apply(params["down"], act, pim)
    outs = {"q": q, "k": k, "v": v, "o": o, "gate": gate, "up": up,
            "down": down}
    ins = {"q": x, "k": x, "v": x, "o": a, "gate": h, "up": h, "down": act}
    return outs, ins, attn


def dense_bound(bits, k):
    """Bound on a packed linear's mean error over the mean magnitude of
    the dense result.  The reference's own (tests/test_pim_serve.py, at
    K = 128): 0.15 for W4A8, 0.03 for W8A8.  Per-channel W4 scales grow
    with the largest of a column's K weights, and at K = 4864 (the down
    projection) the JAX package's own W4A8 ``linear_apply`` gives
    0.158-0.161 over its dense result at this linear's shape
    (tests/test_torch_linear.py::test_w4a8_error_over_dense_by_k, which
    holds the port's ratio equal to it), so that one linear is held to
    0.17."""
    if bits == 4:
        return 0.15 if k <= 896 else 0.17
    return 0.03


def prefill_pass(params, x, pim, cfg, seqs):
    """Where the time of one prefill pass of :func:`layer0` goes: the
    unprofiled wall over 5 passes, then, on the card, 3 passes under
    torch.profiler: device busy time, kernels and the top 8 by time."""
    cuda = x.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(5):
        layer0(params, x, pim, cfg, seqs)
    sync()
    out = {"wall_ms_per_pass": (time.perf_counter() - t0) / 5 * 1e3}
    if not cuda:
        return out
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            layer0(params, x, pim, cfg, seqs)
        sync()
    ev = cuda_events(prof)
    out.update({
        "device_busy_ms_per_pass": sum(e[0] for e in ev) / 3 / 1e3,
        "device_kernels_per_pass": sum(e[1] for e in ev) / 3,
        "top_kernels": [{"name": n[:80], "count": c // 3,
                         "ms_per_pass": us / 3 / 1e3}
                        for us, c, n in ev[:8]]})
    return out


def phase_pim_linear(seed, dev=None, cfg=None, tokens=TOKENS,
                     decode=DECODE_SEQS):
    """The slice's main path: layer 0 of qwen2-0.5b at its published
    widths through ``linear_init`` / ``pack_linear`` / ``linear_apply``
    / ``fused_linear_apply`` on the card, W4A8 in modes ``pallas`` and
    ``popcount`` and W8A8 in ``pallas``, 128 tokens of one sequence and
    a decode step of 8 sequences (each attends over its own token only:
    there is no KV cache); ``pallas`` and ``popcount`` outputs
    bit-identical to ``ref``, each linear within the reference's bound
    of the dense ``off`` result on the same input, each attention output
    within :func:`flash_agrees` of the plain version on its inputs."""
    cfg = cfg or get_config("qwen2-0.5b")
    gen = torch.Generator().manual_seed(seed)
    dense = {n: pl.linear_init(gen, k, o, pl.PimConfig(), device=dev)
             for n, (k, o) in layer_linears(cfg).items()}
    packed = {bits: {n: pl.pack_linear(p, pl.PimConfig(weight_bits=bits))
                     for n, p in dense.items()} for bits in (4, 8)}
    dev = dense["q"]["w"].device
    steps = {"prefill": (torch.randn((tokens, cfg.d_model), generator=gen)
                         .to(dev, torch.bfloat16), 1),
             "decode": (torch.randn((decode, cfg.d_model), generator=gen)
                        .to(dev, torch.bfloat16), decode)}
    modes = {"W4A8 pallas": (4, "pallas"), "W4A8 popcount": (4, "popcount"),
             "W8A8 pallas": (8, "pallas")}

    def run(bits, mode):
        pim = pl.PimConfig(mode=mode, weight_bits=bits)
        return {st: layer0(packed[bits], x, pim, cfg, seqs)
                for st, (x, seqs) in steps.items()}

    for bits, mode in modes.values():                  # warm-up
        run(bits, mode)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    counters = (bsm.quant_matmul_cuda, bsm.popcount_matmul_cuda,
                fa.flash_attention_cuda)
    for c in counters:
        c.launches = 0
    res, wall = {}, {}
    for label, (bits, mode) in modes.items():
        t0 = time.perf_counter()
        res[label] = run(bits, mode)
        sync()
        wall[label] = time.perf_counter() - t0
    launches = {c.__name__.removesuffix("_cuda"): c.launches
                for c in counters}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"main path never launched {name}")

    refs = {bits: run(bits, "ref") for bits in (4, 8)}
    errs, attn_steps = {}, {}
    for label, (bits, mode) in modes.items():
        for st in steps:
            outs, ins, (qf, kf, vf, af) = res[label][st]
            want = refs[bits][st][0]
            plain = fa.flash_attention_torch(qf, kf, vf, causal=True)
            if af.dtype != plain.dtype or not flash_agrees(af, plain):
                raise AssertionError(
                    f"{label} {st}: flash_attention != plain at "
                    f"{tuple(qf.shape)} {qf.dtype}")
            attn_steps[f"{label} {st}"] = flash_error(af, plain)
            for n, y in outs.items():
                if y.shape != want[n].shape or not torch.equal(
                        y.view(torch.int16), want[n].view(torch.int16)):
                    raise AssertionError(f"{label} {st} {n} != ref")
                if not torch.isfinite(y).all():
                    raise AssertionError(f"{label} {st} {n} not finite")
                yd = pl.linear_apply(dense[n], ins[n], pl.PimConfig()).float()
                err = (y.float() - yd).abs().mean().item()
                mag = max(yd.abs().mean().item(), 1e-3)
                ratio = err / mag
                if ratio >= dense_bound(bits, ins[n].shape[-1]):
                    raise AssertionError(
                        f"{label} {st} {n}: mean error {ratio:.4f} x mean "
                        f"magnitude of the dense result")
                errs[f"{label} {st} {n}"] = ratio
    # where the time of one prefill pass goes (not counted above)
    x, seqs = steps["prefill"]
    where = {label: prefill_pass(packed[modes[label][0]], x, pl.PimConfig(
        mode=modes[label][1], weight_bits=modes[label][0]), cfg, seqs)
        for label in ("W4A8 pallas", "W4A8 popcount")}
    # flash_attention at the path's own shapes (bf16, causal)
    flash_times = {}
    if dev.type == "cuda":
        for st in steps:
            qf, kf, vf, _ = res["W4A8 pallas"][st][2]
            kt = timings(lambda: fa.flash_attention_cuda(qf, kf, vf))
            pt = timings(lambda: fa.flash_attention_torch(qf, kf, vf),
                         reps=5, warmup=1, graph_reps=3)
            flash_times[st] = {"shape": list(qf.shape), "ms": kt["ms"],
                               "event_ms": kt["event_ms"],
                               "plain_ms": pt["ms"],
                               "plain_event_ms": pt["event_ms"]}
    emit({"phase": "pim_linear_qwen2_layer0", "ok": True, "model": cfg.name,
          "layer": 0, "tokens": tokens, "decode_seqs": decode,
          "linears": {k: list(v) for k, v in layer_linears(cfg).items()},
          "wall_s": wall, "launches": launches, "prefill_pass": where,
          "bit_identical_to_ref": True,
          "err_over_dense": errs, "attention_vs_plain": attn_steps,
          "flash_at_path_shapes": flash_times})
    return launches, wall


def attn_inputs(rng, cfg, s):
    """qwen2-0.5b attention inputs of one sequence of ``s`` tokens: q
    (heads, S, hd); k and v with the KV heads repeated to 14 heads."""
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = rng.normal(0, 1, (h, s, hd)).astype(np.float32)
    k, v = (np.repeat(rng.normal(0, 1, (kvh, s, hd)).astype(np.float32),
                      h // kvh, axis=0) for _ in range(2))
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda()
            for a in (q, k, v)]


FLASH_F32_TOL = 2e-4     # tests/test_kernels.py's tolerance
#: below this the bf16 check is absolute: float32 sums taken in another
#: order differ by ~1e-6 of the terms, which is many bf16 steps of an
#: output that cancels to near zero
FLASH_BF16_ATOL = 1e-5


def bf16_steps(got, want):
    """Elementwise distance, in representable bf16 values, between two
    bf16 tensors (+0 and -0 are one value)."""
    def ordered(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(got) - ordered(want)).abs()


def flash_agrees(got, want):
    """float32: allclose at :data:`FLASH_F32_TOL`.  bf16: every element is
    the same bf16 value as ``want`` or its neighbour (the two round
    float32 results that differ in the last float32 bits, so one rounding
    may fall the other way), or within :data:`FLASH_BF16_ATOL`."""
    if got.dtype == torch.float32:
        return torch.allclose(got, want, atol=FLASH_F32_TOL,
                              rtol=FLASH_F32_TOL)
    near = (got.float() - want.float()).abs() <= FLASH_BF16_ATOL
    return bool(((bf16_steps(got, want) <= 1) | near).all())


def flash_error(got, want):
    """Max abs difference, and for bf16 the most bf16 steps apart."""
    err = {"max_abs_err": (got.float() - want.float()).abs().max().item()}
    if got.dtype == torch.bfloat16:
        err["max_bf16_steps"] = int(bf16_steps(got, want).max())
    return err


def phase_flash(rng):
    """flash_attention on the card == its plain version (and the naive
    oracle) at qwen2-0.5b's attention widths, causal and full, float32
    and bf16, plus ragged sequence lengths; then their times."""
    cfg = get_config("qwen2-0.5b")
    q32, k32, v32 = attn_inputs(rng, cfg, 1024)
    out = {"shape": list(q32.shape), "variants": {}}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (x.to(dt) for x in (q32, k32, v32))
        for causal in (True, False):
            got = fa.flash_attention_cuda(q, k, v, causal=causal)
            plain = fa.flash_attention_torch(q, k, v, causal=causal)
            naive = fa.attention_ref(q, k, v, causal=causal)
            for name, want in (("plain", plain), ("attention_ref", naive)):
                if got.dtype != dt or not flash_agrees(got, want):
                    raise AssertionError(
                        f"flash {dt} causal={causal} != {name}: "
                        f"{flash_error(got, want)}")
            kt = timings(lambda: fa.flash_attention_cuda(q, k, v,
                                                         causal=causal))
            pt = timings(lambda: fa.flash_attention_torch(
                q, k, v, causal=causal), reps=5, warmup=1, graph_reps=3)
            # (1, BH, S, hd): the layout SDPA's fused backends take
            lib, lib_err = try_timings(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=causal))
            bh, sl, hd = q.shape
            pairs = bh * sl * (sl + 1) // 2 if causal else bh * sl * sl
            nbytes = 4 * q.numel() * q.element_size()
            # float32's quickest route at float32 accuracy is 3xTF32 on
            # the tensor cores: 495 / 3 TFLOP/s beats 67 on the SIMT pipes
            bms, bby = bound_ms(nbytes, 4 * hd * pairs, BF16_FLOPS) \
                if dt == torch.bfloat16 else \
                bound_ms(nbytes, 3 * 4 * hd * pairs, TF32_FLOPS)
            out["variants"][f"{str(dt)[6:]} causal={causal}"] = {
                **flash_error(got, plain), "ms": kt["ms"],
                "event_ms": kt["event_ms"], "plain_ms": pt["ms"],
                "plain_event_ms": pt["event_ms"], "library_ms": lib["ms"],
                "library_event_ms": lib["event_ms"],
                "library_error": lib_err,
                "bound_ms": bms, "bound_by": bby, "bytes": nbytes,
                "flops": 4 * hd * pairs}
    # the main path's prefill attention, (14, 128, 64) bf16 causal, beside
    # SDPA on the same inputs
    q, k, v = (x.to(torch.bfloat16) for x in attn_inputs(rng, cfg, 128))
    got = fa.flash_attention_cuda(q, k, v)
    if not flash_agrees(got, fa.flash_attention_torch(q, k, v)):
        raise AssertionError("flash (14, 128, 64) bf16 causal != plain")
    kt = timings(lambda: fa.flash_attention_cuda(q, k, v))
    lib, lib_err = try_timings(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True))
    out["path_prefill"] = {
        "shape": list(q.shape), "dtype": "bfloat16", "causal": True,
        "ms": kt["ms"], "event_ms": kt["event_ms"], "library_ms": lib["ms"],
        "library_event_ms": lib["event_ms"], "library_error": lib_err}
    # ragged lengths and other head dims against the plain version
    for bh, sl, hd in ((3, 1000, 128), (2, 77, 32), (5, 9, 96)):
        q, k, v = (torch.from_numpy(rng.normal(0, 1, (bh, sl, hd))
                                    .astype(np.float32)).cuda()
                   for _ in range(3))
        for causal in (True, False):
            got = fa.flash_attention_cuda(q, k, v, causal=causal)
            want = fa.flash_attention_torch(q, k, v, causal=causal)
            if not flash_agrees(got, want):
                raise AssertionError(
                    f"flash {(bh, sl, hd)} causal={causal} != plain")
    out["ragged_checked"] = [[3, 1000, 128], [2, 77, 32], [5, 9, 96]]
    emit({"phase": "flash_vs_plain", "ok": True, **out})
    return out["variants"]["float32 causal=True"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    built = build.build_all()
    sass = {name: build.tensor_core_ops(name) for name in build.SOURCES}
    for name in TENSOR_CORE_KERNELS:
        if not any(sass[name].values()):
            raise AssertionError(f"{name}: no tensor-core instruction in "
                                 f"its SASS {sass[name]}")
    emit({"phase": "build", "ok": True,
          "seconds": time.perf_counter() - t0,
          "built": {k: v["seconds"] for k, v in built.items()},
          "ptxas": [ln for v in built.values()
                    for ln in v["log"].splitlines() if "ptxas" in ln],
          "tensor_core_sass": sass,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    rng = np.random.default_rng(args.seed)
    stats = phase_kernel(rng)
    launches, _, _ = phase_main_path(rng)
    phase_profile(rng)
    phase_int8_bf16(rng)
    phase_executors(rng)
    gemm = phase_gemm(rng)
    flash = phase_flash(rng)
    linear_launches, _ = phase_pim_linear(args.seed)
    kernels = [{
        "name": "lane_fold", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lane_fold.cu",
        "replaces": "src/repro/kernels/bitplane_ops.py:187",
        "launches": launches, "max_abs_err": stats["max_abs_err"],
        "ms": stats["ms"], "plain_ms": stats["plain_ms"],
        "bound_ms": stats["bound_ms"], "bound_by": stats["bound_by"],
        "library_ms": None}]
    for name, line, st in (
            ("quant_matmul", "bitserial_matmul.py:106", gemm["quant_matmul"]),
            ("popcount_matmul", "bitserial_matmul.py:167",
             gemm["popcount_matmul"]),
            ("flash_attention", "flash_attention.py:80", flash)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{line}",
            "launches": linear_launches[name],
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "library_ms": st["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
