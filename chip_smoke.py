"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
sm_90a), holds each kernel against its plain PyTorch version on the card,
then drives the port's main path through its public entry points:
``cram_matmul`` int4 on the attention projections of layer 0 of
qwen2-0.5b at their published widths (896 -> 896/128/128/896, 128 tokens),
which runs the Compute RAM engine's packed compiled interior and its
``lane_fold`` kernel; ``cram_matmul`` int8 and ``cram_fdot`` bf16; and
the three executors on one block.  Every result is checked exactly
against numpy or the port's oracles.  Prints one JSON object per phase,
then the kernels line, then ``{"ok": true, "device": {...}}`` last.
Exits non-zero, printing no result, when no CUDA device is present or a
phase fails.
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
from repro_torch.kernels import build  # noqa: E402
from repro_torch.pim import cram  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
INT32_OPS_PER_S = 67e12        # 32-bit non-tensor-core peak (data sheet)


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps=50, warmup=5):
    """Min over ``reps`` single calls timed with CUDA events (ms)."""
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
    kernel_ms = time_ms(lambda: bp.lane_fold_cuda(x, width))
    plain_ms = time_ms(lambda: bp.lane_fold_torch(planes, width), reps=20)
    nbytes = (m * lanes * words + width * words) * 4
    # word operations of the adds: a full adder (5 ops) per live plane,
    # carry propagation (2 ops) per plane above them, per lane and word
    ops = (5 * m + 2 * (width - m)) * lanes * words
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    stats = {"max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
             "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
             "shape": [m, lanes, words, width],
             "planes_given": planes_given, "bytes": nbytes, "ops": ops}
    emit({"phase": "kernel_vs_plain", "ok": True, "shapes": len(shapes),
          **stats})
    return stats


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
    kernels = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        kernels.append((us, e.count, e.key))
    kernels.sort(reverse=True)
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
    emit({"phase": "build", "ok": True,
          "seconds": time.perf_counter() - t0,
          "built": {k: v["seconds"] for k, v in built.items()},
          "ptxas": [ln for v in built.values()
                    for ln in v["log"].splitlines() if "ptxas" in ln],
          "torch": torch.__version__, "cuda": torch.version.cuda})
    rng = np.random.default_rng(args.seed)
    stats = phase_kernel(rng)
    launches, _, _ = phase_main_path(rng)
    phase_profile(rng)
    phase_int8_bf16(rng)
    phase_executors(rng)
    emit({"kernels": [{
        "name": "lane_fold", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lane_fold.cu",
        "replaces": "src/repro/kernels/bitplane_ops.py:187",
        "launches": launches, "max_abs_err": stats["max_abs_err"],
        "ms": stats["ms"], "plain_ms": stats["plain_ms"],
        "bound_ms": stats["bound_ms"], "bound_by": stats["bound_by"],
        "library_ms": None}]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
