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
  decode step of 8;
* the serve engine over the model zoo: full-width qwen2-0.5b (24
  layers, random weights from a seeded numpy Generator) answering 6
  requests in 4 slots through ``ServeEngine``, with a
  ``FabricLinearProbe`` sending layer 0's q/k/v projections of the first
  decode steps' live activations through the fabric at 4 bits (every
  round launch folds through ``lane_fold``); and ``flash_attention``
  against the models' ``chunked_attention`` at the model's shape;
* the training loop: full-width qwen2-0.5b (24 layers, ``remat_policy``
  "full") taking 8 AdamW steps on 4 x 256 synthetic tokens through
  ``Trainer``, checkpointing every 3 steps, failing once at step 5,
  restoring and replaying bit for bit under
  ``torch.use_deterministic_algorithms``; one step on the card against
  the same step on the CPU; the card's checkpoint restored on the CPU
  bit for bit; and ``python -m repro_torch.launch.train`` for 4 steps.
  Training launches none of the four kernels, and the phase holds their
  counters unchanged;
* the launch layer: qwen2-0.5b's decode_32k, prefill_32k and train_4k
  cells traced by ``launch.dryrun`` on fake tensors over a fake process
  group of 256 ranks (a (16, 16) mesh) and decode_32k on 512 ((2, 16,
  16)); a one-card decode of 32768-position sequences at the largest
  batch whose estimated peak fits the card, run for real through a (1,
  1) mesh and held to the estimate (argument bytes and FLOPs exactly,
  peak memory within 10 %) beside its H100 roofline; and
  ``launch.train`` on a one-rank NCCL mesh against the mesh-free train
  step (losses, final state bit for bit).  It launches none of the four
  kernels;
* the compiler's CSE pass: ``idot4x58``, ``idot8x28``, ``bf16_add`` and
  ``bf16_mul`` at 512 rows, each compiled with and without the pass and
  run on one block and on 512 blocks, bit for bit equal, with node
  counts, trace time and per-call times; the CSE'd ``idot4x58`` graph
  holds the ``repro_torch::lane_fold`` node and launches the kernel as
  often as the eager function.  Every path above runs its long
  programs (the int4 ``idot4x58`` of the main path, the fabric and the
  serve probe among them) as CSE'd graphs, and the run fails if a trace
  falls back to the un-CSE'd function;
* the five examples (``examples/torch_*.py``) through ``main(argv)`` on
  the card: quickstart, pim_matmul (``quant_matmul``,
  ``popcount_matmul`` and ``lane_fold``), fabric_attention
  (``lane_fold``), serve_lm, and train_lm at its 100m preset for 40
  steps, failing at step 24 and resuming from the step-20 checkpoint;
* the fabric: the same seven linears of layer 0 on 8 decode tokens
  through ``fused_linear_apply`` with ``PimConfig(mode="fabric")`` at
  W4A4 (every round launch of 512 blocks folds through ``lane_fold``);
  the ``fabric_pack`` kernel that packs those launches' block images on
  the card, against its plain version and the host's numpy pack at the
  launch shape (512 x 512 x 40) and timed there;
  ``fabric_matmul`` at int4, int8 and bf16, a ``FabricSession`` decode
  loop and a ``FabricAttentionBlock`` head with KV appends; the fault
  hooks (parity scrub, spare-block repair); the fuzz corpus and a fuzz
  budget through every executor variant; and the packed against the
  bool interior on 512-block launches;
* decode attention: the ``decode_attention`` kernel at
  h2o-danube-1.8b's decode shape (16 lanes of 2048 slots) against its
  plain version and the widened path, timed at three live lengths beside
  their byte bound and SDPA; one decode step of the full-width model
  with the kernel against the plain path (launches, counters, logits,
  the allocator's peak);
* the recurrent scan: the ``linear_scan`` kernel on a Mamba layer's
  chunk at Jamba2-Mini's widths (256 and a ragged 188 steps of 8192 x
  16 lanes), raw and through the ``repro_torch::linear_scan`` operator,
  equal bit for bit to its plain version and timed beside it and its
  byte bound; its backward against the plain version's autograd; and a
  published-width Mamba mixer prefilling the longdoc pool's mean and
  longest prompts, one launch a chunk, its output and state the plain
  scan's bit for bit.

Every result is checked exactly against numpy or the port's oracles, or
within a stated tolerance.  Prints one JSON object per phase, the card's
name and power limit, the kernels line, then ``{"ok": true, "device":
{...}}`` last.  Exits non-zero, printing no result, when no CUDA device
is present or a phase fails.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import dataclasses
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# cuBLAS is deterministic only with a fixed workspace, which must be set
# before CUDA starts (the training phase runs under
# torch.use_deterministic_algorithms)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (engine, faults, floatprog,  # noqa: E402
                              fuzz, harness, programs, ref)
from repro_torch.kernels import bitplane_ops as bp  # noqa: E402
from repro_torch.kernels import bitserial_matmul as bsm  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as dattn  # noqa: E402
from repro_torch.kernels import fabric_pack as fpk  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import linear_scan as lscan  # noqa: E402
from repro_torch.models import attention as mattn  # noqa: E402
from repro_torch.models import recurrence, ssm  # noqa: E402
from repro_torch.models.convert import init_numpy  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.models.qweight import tree_leaves, tree_map  # noqa
from repro_torch.pim import cram  # noqa: E402
from repro_torch.pim import fabric  # noqa: E402
from repro_torch.pim import linear as pl  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine, _bucket  # noqa
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as optim  # noqa: E402
from repro_torch.train import tree as ttree  # noqa: E402
from repro_torch.train.data import DataConfig, Pipeline  # noqa: E402
from repro_torch.train.runner import RunnerConfig, Trainer  # noqa: E402
from repro_torch.train.step import make_train_step, value_and_grad  # noqa

ROOT = Path(__file__).resolve().parent

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
    # the same launch through the repro_torch::lane_fold operator, the
    # binding the engine's graphs and eager calls use
    op = timings(lambda: torch.ops.repro_torch.lane_fold(x, width))
    plain = timings(lambda: bp.lane_fold_torch(planes, width), reps=20)
    nbytes = (m * lanes * words + width * words) * 4
    # word operations of the adds: a full adder (5 ops) per live plane,
    # carry propagation (2 ops) per plane above them, per lane and word
    ops = (5 * m + 2 * (width - m)) * lanes * words
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    stats = {"max_abs_err": max_err, "ms": kern["ms"],
             "plain_ms": plain["ms"], "event_ms": kern["event_ms"],
             "op_ms": op["ms"], "op_event_ms": op["event_ms"],
             "plain_event_ms": plain["event_ms"],
             "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
             "shape": [m, lanes, words, width],
             "planes_given": planes_given, "bytes": nbytes, "ops": ops}
    stats["sweep"] = fold_sweep(rng, planes_given, lanes, width, live)
    stats["fabric_shape"] = fold_at_fabric_shape(rng)
    emit({"phase": "kernel_vs_plain", "ok": True, "shapes": len(shapes),
          **stats})
    return stats


#: the fabric's round launch at W4A4 on the default grid: ``idot4x58``
#: on 512 blocks of 40 columns folds 8 live of 15 planes over 57 lanes
#: of 640 word columns
FABRIC_FOLD = (15, 57, 640, 15, range(8))


def fold_at_fabric_shape(rng):
    """lane_fold at the fabric's launch shape: bit for bit equal to the
    plain tree, both graph times and the kernel's byte bound."""
    planes_given, lanes, words, width, live = FABRIC_FOLD
    planes = fold_inputs(rng, planes_given, lanes, words, set(live))
    got = bp.lane_fold(planes, width, packed=True)
    want = bp.lane_fold_torch(planes, width)
    torch.cuda.synchronize()
    err = int((words_u64(got, words) - words_u64(want, words))
              .abs().max().item())
    if err:
        raise AssertionError(f"lane_fold kernel != plain at the fabric's "
                             f"shape: max abs diff {err}")
    m = max(live) + 1
    x = torch.stack(planes[:m])
    kern = timings(lambda: bp.lane_fold_cuda(x, width))
    op = timings(lambda: torch.ops.repro_torch.lane_fold(x, width))
    plain = timings(lambda: bp.lane_fold_torch(planes, width), reps=10,
                    graph_reps=5)
    nbytes = (m * lanes * words + width * words) * 4
    ops = (5 * m + 2 * (width - m)) * lanes * words
    bms, bby = bound_ms(nbytes, ops, INT32_OPS_PER_S)
    return {"shape": [m, lanes, words, width], "planes_given": planes_given,
            "max_abs_err": err, "ms": kern["ms"],
            "event_ms": kern["event_ms"], "op_ms": op["ms"],
            "op_event_ms": op["event_ms"], "plain_ms": plain["ms"],
            "plain_event_ms": plain["event_ms"], "bound_ms": bms,
            "bound_by": bby, "bytes": nbytes, "ops": ops}


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
#: decode attention against its plain version and the widened path: the
#: same float32 products and exponentials summed in another order (per
#: chunk, then merged), at most ~6e-7 apart at unit-scale values
DECODE_TOL = dict(rtol=1e-5, atol=1e-5)
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
    pt = timings(lambda: fa.flash_attention_torch(q, k, v), reps=5,
                 warmup=1, graph_reps=3)
    lib, lib_err = try_timings(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True))
    out["path_prefill"] = {
        "shape": list(q.shape), "dtype": "bfloat16", "causal": True,
        "ms": kt["ms"], "event_ms": kt["event_ms"], "plain_ms": pt["ms"],
        "plain_event_ms": pt["event_ms"], "library_ms": lib["ms"],
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


def phase_flash_model(rng):
    """``flash_attention`` on the card against the model zoo's
    ``chunked_attention`` (the counterpart of
    tests/test_kernels.py::test_flash_attention_matches_model_chunked_path)
    at qwen2-0.5b's attention shape, (b, s, h, hd) = (1, 128, 14, 64),
    causal, 64-key chunks: float32 within :data:`FLASH_F32_TOL`, bf16 by
    :func:`flash_agrees` against the chunked result rounded to bf16."""
    cfg = get_config("qwen2-0.5b")
    b, s, h, hd = 1, 128, cfg.n_heads, cfg.hd
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (b, s, h, hd))
                                .astype(np.float32)).cuda()
               for _ in range(3))
    pos = torch.arange(s, dtype=torch.int32, device="cuda").expand(b, s)

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, s, hd).contiguous()

    out = {}
    for dt in (torch.float32, torch.bfloat16):
        qd, kd, vd = (x.to(dt) for x in (q, k, v))
        want = mattn.chunked_attention(qd, kd, vd, pos, pos, causal=True,
                                       chunk=64).to(dt)
        got = fa.flash_attention_cuda(fold(qd), fold(kd), fold(vd))
        got = got.reshape(b, h, s, hd).transpose(1, 2)
        if got.dtype != dt or not flash_agrees(got, want):
            raise AssertionError(f"flash {dt} != chunked_attention: "
                                 f"{flash_error(got, want)}")
        out[str(dt)[6:]] = flash_error(got, want)
    emit({"phase": "flash_vs_chunked_attention", "ok": True,
          "shape_bshd": [b, s, h, hd], "causal": True, "chunk": 64, **out})
    return out


# ---------------------------------------------------------------------------
# The fabric: its execute side, fault hooks and fuzz replay
# ---------------------------------------------------------------------------
#: layer 0's linears as the fabric runs them: each group is one fused
#: fabric program sharing its input
FABRIC_GROUPS = (("q+k+v", ("q", "k", "v")), ("o", ("o",)),
                 ("gate+up", ("gate", "up")), ("down", ("down",)))


class FabricCalls:
    """While active, records every ``fabric.fabric_fused_matmul`` call:
    its quantized operands and its result (schedule, raw accumulators),
    so a phase can check what the PIM linear layer handed the fabric.
    It swaps the module attribute, which ``pim/linear.py`` looks up at
    each call; a phase that expects a call and finds none fails."""

    def __enter__(self):
        self.calls = []
        self._orig = fabric.fabric_fused_matmul

        def recorded(x, ws, *args, **kw):
            res = self._orig(x, ws, *args, **kw)
            self.calls.append((np.asarray(x), [np.asarray(w) for w in ws],
                               res))
            return res

        fabric.fabric_fused_matmul = recorded
        return self

    def __exit__(self, *exc):
        fabric.fabric_fused_matmul = self._orig


def scheduled_launches(sched):
    """The ``execute_blocks`` launches that ``fabric.execute_program``
    makes for ``sched`` at its defaults: with the compiled executor,
    consecutive rounds of one dtype class (and, for floats, one K stage)
    batch into launches of ``MAX_BATCH_BLOCKS // n_compute`` rounds;
    otherwise each round is one launch."""
    rounds = sched.rounds
    if sched.cfg.executor != "compiled" or len(rounds) <= 1:
        return len(rounds)
    primary = sched.classes[0]

    def stage(rnd):
        c = rnd.dtype or primary
        if fabric._dtype_info(c).is_float and rnd.tasks:
            return c, rnd.tasks[0].k0
        return c, None

    per = max(fabric.MAX_BATCH_BLOCKS, sched.n_compute) // sched.n_compute
    runs = [len(list(g)) for _, g in itertools.groupby(map(stage, rounds))]
    return sum(-(-r // per) for r in runs)


def launches_of(run, sched_of=lambda res: res.schedule):
    """``(result, execute_blocks launches, seconds)`` of ``run()``.  The
    count is :func:`scheduled_launches` of the result's schedule, held
    equal to the engine compile cache's lookups in the run (one lookup
    per ``execute_blocks`` call)."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    sync()
    c0 = engine.compile_cache_stats()
    t0 = time.perf_counter()
    out = run()
    sync()
    wall = time.perf_counter() - t0
    c1 = engine.compile_cache_stats()
    looked_up = (c1["hits"] + c1["misses"]) - (c0["hits"] + c0["misses"])
    launches = scheduled_launches(sched_of(out))
    if looked_up != launches:
        raise AssertionError(f"{launches} launches scheduled, "
                             f"{looked_up} compiled fns looked up")
    return out, launches, wall


def phase_fabric_layer(seed, dev=None, cfg=None, fabric_cfg=None):
    """The fabric's main path: the seven linears of qwen2-0.5b's layer 0
    at their published widths, on ``DECODE_SEQS`` decode tokens, through
    ``fused_linear_apply`` with ``PimConfig(mode="fabric")`` at W4A4 on
    the default grid (one fused program per group of
    :data:`FABRIC_GROUPS`).  Every output bit-identical to mode ``ref``
    on the same params and input; every raw fabric accumulator equal to
    numpy's int64 product of the quantized operands; ``lane_fold``
    launched."""
    cfg = cfg or get_config("qwen2-0.5b")
    lin = layer_linears(cfg)
    gen = torch.Generator().manual_seed(seed)
    pim = pl.PimConfig(mode="fabric", weight_bits=4, act_bits=4,
                       fabric=fabric_cfg)
    ref_pim = pl.PimConfig(mode="ref", weight_bits=4, act_bits=4)
    params = {n: pl.pack_linear(pl.linear_init(gen, k, o, pim, device=dev),
                                pim) for n, (k, o) in lin.items()}
    dev = params["q"]["w_packed"].device
    xs = {g: torch.randn((DECODE_SEQS, lin[names[0]][0]), generator=gen)
          .to(dev, torch.bfloat16) for g, names in FABRIC_GROUPS}

    def run(g, names):
        return pl.fused_linear_apply([params[n] for n in names], xs[g], pim)

    run(*FABRIC_GROUPS[1])     # warm-up: lowers the 512-block round fn
    bp.lane_fold_cuda.launches = 0
    groups, outs = {}, {}
    packs = fpk.fabric_pack_cuda
    with FabricCalls() as rec:
        for i, (g, names) in enumerate(FABRIC_GROUPS):
            f0, p0 = bp.lane_fold_cuda.launches, packs.launches

            def schedule(_):
                if len(rec.calls) != i + 1:
                    raise AssertionError(f"{g}: fused_linear_apply made "
                                         f"{len(rec.calls) - i} fabric calls")
                return rec.calls[-1][2].schedule

            outs[g], calls, wall = launches_of(lambda: run(g, names),
                                               schedule)
            xq, wqs, res = rec.calls[-1]
            sched = res.schedule
            groups[g] = {
                "linears": list(names), "K": int(xq.shape[1]),
                "N": [int(w.shape[1]) for w in wqs], "wall_s": wall,
                "rounds": len(sched.rounds),
                "execute_blocks_launches": calls,
                "lane_fold_launches": bp.lane_fold_cuda.launches - f0,
                "fabric_pack_launches": packs.launches - p0,
                "program": sched.class_program(sched.classes[0])[0].name,
                "n_compute": sched.n_compute}
            # on the card, every launch of the int program packs there
            if dev.type == "cuda" and groups[g]["fabric_pack_launches"] \
                    != calls:
                raise AssertionError(f"{g}: {calls} launches, "
                                     f"{groups[g]['fabric_pack_launches']} "
                                     f"fabric_pack launches")
            # the raw accumulators against numpy on the quantized operands
            for n, w, raw in zip(names, wqs, res.outs):
                want = xq.astype(np.int64) @ w.astype(np.int64)
                if raw.shape != want.shape or not np.array_equal(
                        np.asarray(raw, np.int64), want):
                    raise AssertionError(f"fabric {n} accumulators != "
                                         f"numpy's int64 product")
    launches = bp.lane_fold_cuda.launches
    if launches == 0:
        raise AssertionError("the fabric path never launched lane_fold")
    for g, names in FABRIC_GROUPS:
        want = pl.fused_linear_apply([params[n] for n in names], xs[g],
                                     ref_pim)
        for n, y, w in zip(names, outs[g], want):
            if y.shape != (DECODE_SEQS, lin[n][1]) or not torch.equal(
                    y.view(torch.int16), w.view(torch.int16)):
                raise AssertionError(f"fabric {n} != mode ref")
            if not torch.isfinite(y).all():
                raise AssertionError(f"fabric {n} not finite")
    where = device_profile(lambda: run(*FABRIC_GROUPS[1])) \
        if dev.type == "cuda" else None
    emit({"phase": "fabric_qwen2_layer0", "ok": True, "model": cfg.name,
          "layer": 0, "tokens": DECODE_SEQS, "bits": "W4A4",
          "grid": dataclasses.asdict(pim.fabric or fabric.FabricConfig()),
          "groups": groups, "wall_s": sum(v["wall_s"] for v in
                                          groups.values()),
          "execute_blocks_launches": sum(
              v["execute_blocks_launches"] for v in groups.values()),
          "lane_fold_launches": launches,
          "fabric_pack_launches": sum(v["fabric_pack_launches"]
                                      for v in groups.values()),
          "bit_identical_to_ref": True,
          "accumulators_exact": True, "profiled_group_o": where})
    return launches, groups


#: the fabric cell's gate+up launch: qwen2-0.5b's gate and up (896 ->
#: 4864 each) fused at W4A4 on 8 decode rows, on the default grid
FABRIC_PACK_GEMMS = (("gate", 4864), ("up", 4864))
FABRIC_PACK_MK = (DECODE_SEQS, 896)


def pack_random_case(rng, rows, cols, bits, dev, tuples=4, M=3, K=17,
                     N=53):
    """``fabric_pack_cuda`` against ``fabric_pack_torch`` on random
    operands of ``bits`` bits, a random row map of ``tuples`` tuples and
    five random tasks in six slots (the last one padding)."""
    dt = np.uint8 if bits <= 8 else np.uint32

    def up(a):
        a = a.astype(dt)
        return torch.from_numpy(a.view(np.int32) if dt == np.uint32
                                else a).to(dev)

    x = up(rng.integers(0, 1 << bits, (M, K), dtype=np.uint64))
    w = up(rng.integers(0, 1 << bits, (K, N), dtype=np.uint64))
    rowmap = np.full(rows, -1, np.int32)
    for n, r in enumerate(rng.permutation(rows)[:2 * tuples]):
        rowmap[r] = fpk.row_code(n // 2, "ab"[n % 2], int(rng.integers(bits)))
    desc = np.zeros((6, fpk.DESC_FIELDS), np.int32)
    for i in range(5):
        kw = int(rng.integers(1, tuples + 1))
        nw = int(rng.integers(1, cols + 1))
        desc[i] = (rng.integers(M), rng.integers(K - kw + 1), kw,
                   rng.integers(N - nw + 1), nw, 1)
    desc, rowmap = (torch.from_numpy(a).to(dev) for a in (desc, rowmap))
    if not torch.equal(fpk.fabric_pack_cuda(x, w, desc, rowmap, cols),
                       fpk.fabric_pack_torch(x, w, desc, rowmap, cols)):
        raise AssertionError(f"fabric_pack != plain at rows {rows}, cols "
                             f"{cols}, {bits}-bit operands")


def phase_fabric_pack(rng, dev="cuda"):
    """The ``fabric_pack`` kernel on the card at the fabric's launch shape
    (the first 512-block launch of a W4A4 gate+up program on the default
    grid, 512 x 512 x 40): equal to its plain torch version on the same
    tensors and to the host's numpy ``pack_blocks``; its graph time
    beside the bound of the image's bytes written once at the memory
    rate, the plain version's time and the host pack's wall.  Then the
    kernel against the plain version on 32-bit words and on slot images
    of a size not a multiple of 4 bytes."""
    M, K = FABRIC_PACK_MK
    cfg = fabric.FabricConfig()
    specs = tuple(fabric.GemmSpec(n, M, K, N) for n, N in FABRIC_PACK_GEMMS)
    sched = fabric.schedule_program(specs, 4, cfg=cfg, signed=True)
    _, lay = sched.class_program("int4")
    x_enc = rng.integers(0, 16, (M, K), dtype=np.uint64)
    w_us = [rng.integers(0, 16, (K, N), dtype=np.uint64)
            for _, N in FABRIC_PACK_GEMMS]
    ops = fabric.device_operands(lay, 4, x_enc, dict(enumerate(w_us)), dev)
    compute = sched.compute_blocks
    slot_of = {b: i for i, b in enumerate(compute)}
    per = fabric.MAX_BATCH_BLOCKS // len(compute)
    slots = [(t, ri * len(compute) + slot_of[t.block])
             for ri, rnd in enumerate(sched.rounds[:per]) for t in rnd.tasks]
    n_slots = per * len(compute)
    desc = torch.from_numpy(fabric.pack_descriptor(
        slots, n_slots, ops.col_off, ops.kt, cfg.cols)).to(dev)
    before = fpk.fabric_pack_cuda.launches
    got = fabric.pack_blocks_device(ops, desc, cfg.cols)
    if fpk.fabric_pack_cuda.launches != before + 1:
        raise AssertionError("pack_blocks_device did not launch the kernel")
    plain = fpk.fabric_pack_torch(ops.x, ops.w, desc, ops.rowmap, cfg.cols)
    t0 = time.perf_counter()
    host = fabric.pack_blocks(lay, cfg.cols, slots, n_slots, x_enc, w_us)
    host_ms = (time.perf_counter() - t0) * 1e3
    shape = (n_slots, cfg.rows, cfg.cols)
    if tuple(got.shape) != shape or not torch.equal(got, plain) \
            or not np.array_equal(got.cpu().numpy(), host):
        raise AssertionError(f"fabric_pack != its plain version or the "
                             f"host pack at {shape}")
    kern = timings(lambda: fpk.fabric_pack_cuda(
        ops.x, ops.w, desc, ops.rowmap, cfg.cols))
    # the plain version selects rows with ``nonzero``, which a CUDA graph
    # cannot capture: event time, the host's launches included
    plain_ms = time_ms(lambda: fpk.fabric_pack_torch(
        ops.x, ops.w, desc, ops.rowmap, cfg.cols), reps=10, warmup=2)
    nbytes = n_slots * cfg.rows * cfg.cols
    bms, bby = bound_ms(nbytes, 0, INT32_OPS_PER_S)
    # 32-bit words (int16 and int32 operands), and slot images of 9 x 7
    # bytes (byte stores)
    others = [[512, 40, 16], [9, 7, 8], [128, 8, 32]]
    for rows, cols, bits in others:
        pack_random_case(rng, rows, cols, bits, dev)
    stats = {"shape": list(shape), "operand_bits": 4,
             "tasks": len(slots), "max_abs_err": 0, "ms": kern["ms"],
             "event_ms": kern["event_ms"], "plain_event_ms": plain_ms,
             "host_pack_ms": host_ms,
             "bound_ms": bms, "bound_by": bby, "bytes": nbytes,
             "roofline_pct": 100 * bms / kern["ms"], "also_checked": others}
    emit({"phase": "fabric_pack_vs_plain", "ok": True, **stats})
    return stats


#: (B, H, KV, hd, cap, window) of h2o-danube-1.8b's decode in the chat
#: cell (16 slots of 2048), and the live lengths its kernel is timed at
DECODE_SHAPE = (16, 32, 8, 80, 2048, 4096)
DECODE_LIVE = (256, 1024, 2048)
#: the lanes' live lengths of the decode step held against the plain
#: path: the chat mix's (median prompt 256 plus an answer on the way)
DECODE_STEP_LENS = (37, 96, 180, 260, 300, 330, 360, 380, 400, 430, 520,
                    600, 700, 900, 1200, 1700)


def decode_plain_path(q, k, v, pos, cur, window):
    """``attn_decode``'s path for a cache the kernel does not take: the
    cache widened to float32, repeated to the query heads,
    ``_attend_cache``."""
    h = q.shape[1]
    qh = (q.to(torch.float32) * q.shape[-1] ** -0.5)[:, None]
    kh = mattn._repeat_kv(k.to(torch.float32), h)
    vh = mattn._repeat_kv(v.to(torch.float32), h)
    return mattn._attend_cache(qh, kh, vh, pos, cur[:, None],
                               window=window)[:, 0]


def peak_above_base(run):
    """``run()``'s allocator peak above what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def decode_step_reading(model, params, caches, tokens, pos, plain):
    """One decode step of ``model``, warmed: its kernel launches and
    ``attn.*`` counters; the allocator's peak above what was allocated
    before it, for the step and for layer 0's ``attn_decode`` alone; the
    median over 5 steps of the wall (CUDA events) and of the host's time
    to enqueue the step; the host syncs one step makes (CUDA's sync
    debug mode); a profile of one step.  With ``plain`` the dispatch is
    told to take the plain path."""
    import warnings

    from repro_torch import trace

    cfg = model.cfg
    layer = {n: t[0] for n, t in caches["unit"]["b0"]["kv"].items()}
    lp = tree_map(lambda t: t[0], params["unit"]["b0"]["attn"])
    x = torch.randn((tokens.shape[0], 1, cfg.d_model), device=tokens.device,
                    dtype=torch.bfloat16)
    real = mattn._decode_kernel_takes
    if plain:
        mattn._decode_kernel_takes = lambda cache: False
    try:
        with torch.no_grad():
            model.decode_step(params, caches, tokens, pos)
            before = dattn.decode_attention_cuda.launches
            trace.enable()
            try:
                out, peak = peak_above_base(
                    lambda: model.decode_step(params, caches, tokens, pos))
                _, counters = trace.take()
            finally:
                trace.disable()
            launches = dattn.decode_attention_cuda.launches - before
            _, attn_peak = peak_above_base(lambda: mattn.attn_decode(
                lp, x, layer, cfg, pos, window=cfg.sliding_window))
            walls, enqueue = [], []
            for _ in range(5):
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                torch.cuda.synchronize()
                e0.record()
                t0 = time.perf_counter()
                model.decode_step(params, caches, tokens, pos)
                enqueue.append((time.perf_counter() - t0) * 1e3)
                e1.record()
                torch.cuda.synchronize()
                walls.append(e0.elapsed_time(e1))
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as syncs:
                    warnings.simplefilter("always")
                    model.decode_step(params, caches, tokens, pos)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            prof = device_profile(
                lambda: model.decode_step(params, caches, tokens, pos))
    finally:
        mattn._decode_kernel_takes = real
    return out[0], {"launches": launches,
                    "counters": {k: v for k, v in counters.items()
                                 if k.startswith("attn.")},
                    "peak_above_base_bytes": peak,
                    "attn_decode_peak_bytes": attn_peak,
                    "step_ms": sorted(walls)[2],
                    "enqueue_ms": sorted(enqueue)[2],
                    "host_syncs": len(syncs),
                    "first_sync": str(syncs[0].message)[:200] if syncs
                    else None, "profile": prof}


def decode_graph_reading(model, params, caches, tokens, pos, want):
    """The same decode step through a ``ServeEngine``'s CUDA graph, the
    engine's caches a copy of ``caches``: the capturing call's allocator
    peak above what was allocated before it (the eager step and the
    capture), the bytes the graph's private pool reserved and those its
    static outputs hold; over 20 replays after the first, the
    median wall (CUDA events) and the host's time to copy ``tokens`` and
    ``pos`` in and launch; the first replay's wall; a profile of one
    replay and the ``decode_attention_chunk`` kernels it ran (a replay
    runs no Python, so ``decode_attention_cuda.launches`` does not count
    it: the trace does); whether the capturing call's and every replay's
    logits equal ``want`` bit for bit; the engine's counts of replays
    and eager steps."""
    eng = ServeEngine(model, params, batch_slots=tokens.shape[0],
                      capacity=caches["unit"]["b0"]["kv"]["k"].shape[2],
                      device=tokens.device)
    for mine, theirs in zip(tree_leaves(eng.caches), tree_leaves(caches)):
        mine.copy_(theirs)
    with torch.no_grad():
        def step():
            return eng._decode(params, eng.caches, tokens, pos)[0]

        first, peak = peak_above_base(step)
        pool = [seg for seg in torch.cuda.memory_snapshot()
                if tuple(seg["segment_pool_id"])
                == tuple(eng._decode.graph.pool())]
        same = torch.equal(first, want)
        walls, host = [], []
        for _ in range(21):
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            torch.cuda.synchronize()
            e0.record()
            t0 = time.perf_counter()
            logits = step()
            host.append((time.perf_counter() - t0) * 1e3)
            e1.record()
            torch.cuda.synchronize()
            walls.append(e0.elapsed_time(e1))
            same = same and torch.equal(logits, want)
        prof = device_profile(step, count=("decode_attention_chunk",))
    return {"bit_identical": bool(same),
            "capture_peak_above_base_bytes": peak,
            "pool_reserved_bytes": sum(seg["total_size"] for seg in pool),
            "pool_allocated_bytes": sum(seg["allocated_size"]
                                        for seg in pool),
            "first_replay_ms": walls[0],
            "replay_ms": sorted(walls[1:])[10],
            "copy_in_and_launch_ms": sorted(host[1:])[10],
            "launches": prof["kernels_named"]["decode_attention_chunk"],
            "replays": eng.stats["decode_graph_replays"],
            "eager": eng.stats["decode_eager"], "profile": prof}


def phase_decode_attention(rng, seed=0, shape=DECODE_SHAPE,
                           live=DECODE_LIVE, step_lens=DECODE_STEP_LENS,
                           cfg=None, dev="cuda"):
    """The decode attention kernel on the card at h2o-danube-1.8b's decode
    shape: for each live length, against its plain version and
    ``attn_decode``'s path for other caches within ``DECODE_TOL``, the
    same bits twice; its graph time beside the bound of the live K and V
    rows read once at the memory rate, the plain version's event time,
    the widened path's graph time and SDPA with ``enable_gqa`` on the
    same bf16 inputs (a yardstick: the port never calls it).  Then one
    decode step of the full-width model (24 layers, weights drawn on the
    card) at the chat mix's lane lengths, with the kernel and with the
    dispatch told to take the plain path: the kernel launched and
    counted once a layer, nothing on the plain path, the two steps'
    logits within the chat cell's gap limit of each other, layer 0's
    ``attn_decode`` peak lower by at least one float32 head-repeated
    copy of its K cache, and both steps' wall, allocator peak, host
    enqueue time, host syncs and device kernels; then the kernel's step
    through a ``ServeEngine``'s CUDA graph (``decode_graph_reading``),
    its logits the eager step's bit for bit and one replay running the
    kernel once a layer."""
    b, h, kv, hd, cap, window = shape
    dev = torch.device(dev)
    built = build.build_all(("decode_attention",))
    cases = []
    for n in live:
        def bf16(*sh):
            return torch.from_numpy(rng.normal(size=sh).astype(
                np.float32)).to(dev, torch.bfloat16)

        q, k, v = bf16(b, h, hd), bf16(b, cap, kv, hd), bf16(b, cap, kv, hd)
        pos = torch.full((b, cap), -1, dtype=torch.int32, device=dev)
        pos[:, :n] = torch.arange(n, dtype=torch.int32, device=dev)
        cur = torch.full((b,), n - 1, dtype=torch.int32, device=dev)

        def kernel():
            return dattn.decode_attention_cuda(q, k, v, pos, cur,
                                               window=window)

        got, again = kernel(), kernel()
        plain = dattn.decode_attention_torch(q, k, v, pos, cur,
                                             window=window)
        widened = decode_plain_path(q, k, v, pos, cur, window)
        torch.cuda.synchronize()
        errs = {name: (got - want).abs().max().item()
                for name, want in (("plain", plain), ("widened", widened))}
        if not torch.equal(got, again) or not all(
                torch.allclose(got, want, **DECODE_TOL)
                for want in (plain, widened)):
            raise AssertionError(f"decode_attention at live {n}: {errs}, "
                                 f"repeatable {torch.equal(got, again)}")
        kt = timings(kernel)
        plain_ms = time_ms(lambda: dattn.decode_attention_torch(
            q, k, v, pos, cur, window=window), reps=10, warmup=2)
        wt = timings(lambda: decode_plain_path(q, k, v, pos, cur, window),
                     reps=10, warmup=2, graph_reps=5)
        k4, v4 = (t.transpose(1, 2).contiguous() for t in (k, v))
        mask = (pos >= 0)[:, None, None, :]
        lib, lib_err = try_timings(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], k4, v4, attn_mask=mask, enable_gqa=True))
        nbytes = 2 * b * n * kv * hd * 2
        bms, bby = bound_ms(nbytes, 0, INT32_OPS_PER_S)
        cases.append({"live": n, "max_abs_err": errs, "ms": kt["ms"],
                      "event_ms": kt["event_ms"], "plain_event_ms": plain_ms,
                      "widened_ms": wt["ms"],
                      "widened_event_ms": wt["event_ms"],
                      "library_ms": lib["ms"],
                      "library_event_ms": lib["event_ms"],
                      "library_error": lib_err, "bound_ms": bms,
                      "bound_by": bby, "live_bytes": nbytes,
                      "roofline_pct": 100 * bms / kt["ms"]})
        del q, k, v, k4, v4, got, again, plain, widened

    # one decode step of the full-width model, kernel against plain path
    cfg = cfg or get_config("h2o-danube-1.8b")
    model = LM(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    caches = model.init_cache(b, cap)
    lens = torch.tensor(step_lens, dtype=torch.int32, device=dev)
    layer_kv = caches["unit"]["b0"]["kv"]
    for name in ("k", "v"):
        layer_kv[name].normal_()
    slots = torch.arange(layer_kv["pos"].shape[-1], dtype=torch.int32,
                         device=dev)
    layer_kv["pos"][:] = torch.where(slots[None] < lens[:, None],
                                     slots[None], -1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, 1)).astype(
        np.int32)).to(dev)
    logits_k, with_kernel = decode_step_reading(model, params, caches,
                                                tokens, lens, False)
    logits_p, with_plain = decode_step_reading(model, params, caches,
                                               tokens, lens, True)
    graph = decode_graph_reading(model, params, caches, tokens, lens,
                                 logits_k)
    layers = cfg.n_layers
    # one layer's K cache widened to float32 and repeated to H heads
    repeated = layer_kv["k"][0].numel() * 4 * (cfg.n_heads // cfg.n_kv_heads)
    gap = (logits_k.float() - logits_p.float()).abs().max().item()
    step = {"lanes": b, "capacity": cap, "live": list(step_lens),
            "layers": layers, "kernel": with_kernel, "plain": with_plain,
            "graph": graph, "logit_gap": gap,
            "repeated_copy_bytes": repeated,
            "peak_saved_bytes": with_plain["attn_decode_peak_bytes"]
            - with_kernel["attn_decode_peak_bytes"]}
    if with_kernel["launches"] != layers \
            or with_kernel["counters"] != {"attn.decode_kernel": layers} \
            or with_plain["launches"] != 0 \
            or with_plain["counters"] != {"attn.decode_plain": layers} \
            or step["peak_saved_bytes"] < repeated or gap > 0.25 \
            or not graph["bit_identical"] or graph["replays"] != 22 \
            or graph["eager"] != 1 or graph["launches"] != layers:
        raise AssertionError(f"danube decode step: {step}")
    out = {"shape": list(shape), "cases": cases, "step": step,
           "built": {k: v["seconds"] for k, v in built.items()},
           "ptxas": [ln for v in built.values()
                     for ln in v["log"].splitlines() if "ptxas" in ln]}
    emit({"phase": "decode_attention_vs_plain", "ok": True, **out})
    return out


def device_profile(run, count=()):
    """Wall and device busy time of one ``run()`` under torch.profiler:
    the busy share says how far the host holds the card back; for each
    name in ``count``, the device kernels whose names hold it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = cuda_events(prof)
    busy = sum(e[0] for e in ev) / 1e3
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_busy_share": busy / (wall * 1e3),
            "device_kernels": sum(e[1] for e in ev),
            "lane_fold_ms": sum(e[0] for e in ev if "lane_fold" in e[2])
            / 1e3,
            "kernels_named": {k: sum(c for _, c, n in ev if k in n)
                              for k in count},
            "top_kernels": [{"name": n[:80], "count": c, "ms": us / 1e3}
                            for us, c, n in ev[:6]]}


def attention_oracle(blk, xs):
    """Host int replay of a ``FabricAttentionBlock`` with its own fixed
    scales (as tests/test_fabric_session.py builds it): the bit-exact
    oracle of its decode steps."""
    hd = blk.hd
    kc = np.zeros((hd, 0), np.int64)
    vc = np.zeros((0, hd), np.int64)
    ys = []
    for x in xs:
        x = np.asarray(x, np.float32).reshape(1, -1)
        qx = blk._qfix(x, blk.sx)
        q = blk._qfix(qx @ blk._qwq * (blk.sx * blk.swq), blk.sq)
        k = blk._qfix(qx @ blk._qwk * (blk.sx * blk.swk), blk.sk)
        v = blk._qfix(qx @ blk._qwv * (blk.sx * blk.swv), blk.sv)
        kc = np.hstack([kc, k.T])
        vc = np.vstack([vc, v])
        s = (q @ kc) * (blk.sq * blk.sk * hd ** -0.5)
        e = np.exp(s - s.max(axis=-1, keepdims=True))
        p = blk._qfix(e / e.sum(axis=-1, keepdims=True), blk.sp)
        a = blk._qfix((p @ vc) * (blk.sp * blk.sv), blk.so)
        ys.append((a @ blk._qwo * (blk.so * blk.swo)).astype(np.float32))
    return ys


#: decode steps of the session loop and the attention block
FABRIC_STEPS = 4
#: the session loop's grid size: 512 blocks, at least 256 of them
#: computing, so layer 0's q/k/v weight tiles stay resident after step 1
SESSION_GRID = {"n_blocks": 512, "min_compute_blocks": 256}


#: a Mamba layer's scan chunk at Jamba2-Mini's widths: (B, T, d_inner x
#: d_state), and the steps of a ragged last chunk (a 700-token prompt's)
SCAN_SHAPE = (1, 256, 8192 * 16)
SCAN_RAGGED = 188
#: prompt lengths a Mamba mixer prefills: the longdoc pool's mean and its
#: longest (PERF.md section 4)
SCAN_PROMPTS = (3610, 9322)
#: the backward against the plain version's autograd: the same products
#: summed in another order (relative; the absolute floor is this share of
#: the largest gradient)
SCAN_GRAD_RTOL = 1e-5


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def plain_scan():
    """Every chunk of the recurrence scanned by its plain version, as on
    the host."""
    real = recurrence._on_host
    recurrence._on_host = lambda t: True
    try:
        yield
    finally:
        recurrence._on_host = real


def back_to_back_ms(fn, reps=100):
    """Device time of one call of ``fn`` (ms): ``reps`` calls enqueued
    back to back between two CUDA events, after a warm-up call.  For a
    kernel that runs far longer than its launch takes on the host, as
    one whose launch sets an attribute a graph capture may refuse."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_linear_scan(seed=0, shape=SCAN_SHAPE, ragged=SCAN_RAGGED,
                      prompts=SCAN_PROMPTS, cfg=None, dev="cuda"):
    """The chunk-scan kernel on the card.  At a Mamba layer's chunk and a
    ragged one (seeded decay in [0, 1), inputs and state normal): the raw
    launch twice and the ``repro_torch::linear_scan`` operator, each the
    plain version's states bit for bit; the kernel's time over 100
    launches back to back and its event time a call, the operator's
    event time (the host's dispatch in it) and the plain version's,
    beside the bound of the chunk's decay and input read once,
    its states written once and the state before it read once at the
    memory rate; no library computes a linear recurrence.  A gradient
    through the operator at the ragged chunk against the plain version's
    autograd within :data:`SCAN_GRAD_RTOL`, one launch forward and one
    back.  Then a Mamba mixer of ``cfg`` (default Jamba2-Mini at its
    published widths, weights drawn on the card) prefilling each of
    ``prompts``: ``linear_scan_cuda.launches`` set to 0 just before,
    one launch a chunk of 256, the output and the last state those of
    the plain scan bit for bit."""
    B, T, D = shape
    dev = torch.device(dev)
    built = build.build_all(("linear_scan",)) if dev.type == "cuda" else {}
    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = []
    for t in (T, ragged):
        a = torch.rand((B, t, D), generator=gen, device=dev)
        b = torch.randn((B, t, D), generator=gen, device=dev)
        h0 = torch.randn((B, D), generator=gen, device=dev)

        def kernel():
            return lscan.linear_scan_cuda(a, b, h0)

        def op():
            return torch.ops.repro_torch.linear_scan(a, b, h0)

        def plain():
            pa, pb = recurrence._inclusive_scan(a, b)
            return pa * h0[:, None] + pb

        got, again, through, want = kernel(), kernel(), op(), plain()
        _sync(dev)
        same = {"again": torch.equal(got, again),
                "operator": torch.equal(through, want),
                "plain": torch.equal(got, want)}
        if not all(same.values()):
            raise AssertionError(f"linear_scan at {(B, t, D)}: {same}, "
                                 f"max abs err "
                                 f"{(got - want).abs().max().item()}")
        del got, again, through, want
        kt = {"ms": back_to_back_ms(kernel), "event_ms": time_ms(kernel)}
        nbytes = 4 * (3 * a.numel() + h0.numel())
        bms, bby = bound_ms(nbytes, 0, INT32_OPS_PER_S)
        cases.append({"shape": [B, t, D], "bit_identical": True,
                      "ms": kt["ms"], "event_ms": kt["event_ms"],
                      "op_event_ms": time_ms(op),
                      "plain_event_ms": time_ms(plain, reps=10, warmup=2),
                      "bound_ms": bms, "bound_by": bby, "bytes": nbytes,
                      "library_ms": None,
                      "roofline_pct": 100 * bms / kt["ms"]})
    leaves = [t.clone().requires_grad_(True) for t in (a, b, h0)]
    w = torch.randn(a.shape, generator=gen, device=dev)

    def grads():
        hc = recurrence._scan_chunk(*leaves)
        return torch.autograd.grad((hc * w).sum(), leaves)

    n0 = lscan.linear_scan_cuda.launches
    got = grads()
    _sync(dev)
    grad_launches = lscan.linear_scan_cuda.launches - n0
    with plain_scan():
        want = grads()
    grad_err = [((g - v).abs() / (v.abs() + v.abs().max())).max().item()
                for g, v in zip(got, want)]
    for g, v in zip(got, want):
        torch.testing.assert_close(g, v, rtol=SCAN_GRAD_RTOL,
                                   atol=1e-6 * v.abs().max().item())
    if grad_launches != 2:
        raise AssertionError(f"linear_scan backward: {grad_launches} "
                             f"launches")
    del a, b, h0, leaves, w, got, want

    cfg = cfg or get_config("jamba2-mini")
    p = ssm.ssm_init(torch.Generator(device=dev).manual_seed(seed), cfg,
                     device=dev)
    by_path, mixer = {}, []
    for n in prompts:
        x = torch.randn((1, n, cfg.d_model), generator=gen,
                        device=dev).to(torch.bfloat16)
        with torch.no_grad():
            _sync(dev)
            lscan.linear_scan_cuda.launches = 0
            t0 = time.perf_counter()
            y, c = ssm.ssm_apply(p, x, cfg)
            _sync(dev)
            wall = time.perf_counter() - t0
            launches = lscan.linear_scan_cuda.launches
            with plain_scan():
                y_plain, c_plain = ssm.ssm_apply(p, x, cfg)
        chunks = -(-n // 256)
        row = {"tokens": n, "launches": launches, "chunks": chunks,
               "first_call_s": wall,
               "bit_identical": torch.equal(y, y_plain)
               and torch.equal(c["h"], c_plain["h"])}
        if launches != chunks or not row["bit_identical"]:
            raise AssertionError(f"Mamba mixer prefill: {row}")
        by_path[f"jamba_mamba_layer_prefill_{n}"] = launches
        mixer.append(row)
        del x, y, c, y_plain, c_plain
    out = {"cases": cases, "grad": {"shape": [B, ragged, D],
                                    "launches": grad_launches,
                                    "max_rel_err": grad_err},
           "mixer": mixer, "launches_by_path": by_path,
           "built": {k: v["seconds"] for k, v in built.items()}}
    emit({"phase": "linear_scan_vs_plain", "ok": True, **out})
    return out


def phase_fabric_dtypes(rng, dev=None, cfg=None, fabric_cfg=None,
                        shapes=None):
    """``fabric_matmul`` at int4, int8 (W4A8's class: ``idot8x28``, the
    bool interior) and bf16, each exact (ints against numpy's int64
    product, bf16 bit for bit against ``cram_fmatmul`` and
    ``core.ref.float_matmul``, the float accumulator carried over every
    K stage of the model's K); a ``FabricSession`` decode loop of the
    q/k/v projections (the grid grown to :data:`SESSION_GRID`)
    bit-identical to the sessionless replay, its weight tiles fetched in
    step 1 only; one ``FabricAttentionBlock`` head at
    qwen2-0.5b widths, :data:`FABRIC_STEPS` decode steps with KV
    appends, exact against the host int oracle."""
    cfg = cfg or get_config("qwen2-0.5b")
    fcfg = fabric_cfg or fabric.FabricConfig()
    d, kv = cfg.d_model, cfg.n_kv_heads * cfg.hd
    shapes = shapes or {"int4": (8, d, 256), "int8": (8, d, 128),
                        "bf16": (1, d, 64)}
    out = {}
    for name, bits in (("int4", 4), ("int8", 8)):
        m, k, n = shapes[name]
        x, w = signed_ints(rng, bits, (m, k)), signed_ints(rng, bits, (k, n))
        res, calls, wall = launches_of(lambda: fabric.fabric_matmul(
            x, w, nbits=bits, cfg=fcfg, signed=True, device=dev))
        if not np.array_equal(np.asarray(res.out, np.int64),
                              x.astype(np.int64) @ w.astype(np.int64)):
            raise AssertionError(f"fabric {name} != numpy")
        prog = res.schedule.class_program(res.schedule.classes[0])[0]
        out[name] = {"shape": [m, k, n], "wall_s": wall,
                     "rounds": len(res.schedule.rounds),
                     "execute_blocks_launches": calls, "program": prog.name,
                     "packed": engine.default_packed(prog)}
    m, k, n = shapes["bf16"]
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    res, calls, wall = launches_of(lambda: fabric.fabric_matmul(
        x, w, cfg=fcfg, dtype="bf16", device=dev))
    xb, wb = ref.to_bits(x, 8, 7), ref.to_bits(w, 8, 7)
    got = res.out_bits.astype(np.uint64)
    if not np.array_equal(got, cram.cram_fmatmul(
            xb, wb, "bf16", cols=fcfg.cols, device=dev)) \
            or not np.array_equal(got, ref.float_matmul(xb, wb, 8, 7)):
        raise AssertionError("fabric bf16 != cram_fmatmul / float_matmul")
    out["bf16"] = {"shape": [m, k, n], "wall_s": wall,
                   "rounds": len(res.schedule.rounds),
                   "execute_blocks_launches": calls}
    # a session decode loop of the q/k/v projections, one token a step
    ws = [signed_ints(rng, 4, (d, nn)) for nn in (d, kv, kv)]
    scfg = dataclasses.replace(fcfg, **SESSION_GRID)
    sess = fabric.FabricSession(scfg)
    t0 = time.perf_counter()
    for _ in range(FABRIC_STEPS):
        x = signed_ints(rng, 4, (1, d))
        sess.begin_step()
        warm = fabric.fabric_fused_matmul(x, ws, nbits=4, cfg=scfg,
                                          signed=True, session=sess,
                                          device=dev)
        cold = fabric.fabric_fused_matmul(x, ws, nbits=4, cfg=scfg,
                                          signed=True, device=dev)
        for a, b, w in zip(warm.outs, cold.outs, ws):
            if not np.array_equal(a, b) or not np.array_equal(
                    np.asarray(a, np.int64), x.astype(np.int64) @ w):
                raise AssertionError("session step != sessionless / numpy")
    fetches = list(sess.trajectory().w_fetches)
    if fetches[0] == 0 or any(fetches[1:]):
        raise AssertionError(f"session weight fetches per step {fetches}: "
                             f"not resident after step 1")
    out["session"] = {"steps": FABRIC_STEPS, "n_blocks": scfg.n_blocks,
                      "n_compute": warm.schedule.n_compute,
                      "wall_s": time.perf_counter() - t0,
                      "w_fetches": fetches}
    # one attention head at the model's widths, KV appended per step
    hd = cfg.hd
    wq, wk, wv = (rng.normal(size=(d, hd)).astype(np.float32) * d ** -0.5
                  for _ in range(3))
    wo = rng.normal(size=(hd, d)).astype(np.float32) * hd ** -0.5
    blk = fabric.FabricAttentionBlock(wq, wk, wv, wo, cfg=fcfg, bits=8,
                                      window=FABRIC_STEPS, device=dev)
    xs = [rng.normal(size=(d,)).astype(np.float32)
          for _ in range(FABRIC_STEPS)]
    t0 = time.perf_counter()
    ys = [blk.decode_step(x)[0] for x in xs]
    wall = time.perf_counter() - t0
    for i, (y, want) in enumerate(zip(ys, attention_oracle(blk, xs))):
        if y.shape != (1, d) or not np.isfinite(y).all() \
                or not np.array_equal(y, want):
            raise AssertionError(f"attention block step {i} != oracle")
    kvs = blk.report()["kv"]
    out["attention_block"] = {"d": d, "hd": hd, "steps": FABRIC_STEPS,
                              "wall_s": wall, "kv_len": [kvs["k"]["len"],
                                                         kvs["v"]["len"]]}
    emit({"phase": "fabric_dtypes", "ok": True, **out})
    return out


def phase_fabric_faults(rng, dev=None, fabric_cfg=None, shape=(8, 896, 128)):
    """An int4 fabric GEMM under seeded bit flips with the parity scrub
    on: exact, with flips injected and detected; then a dead block
    remapped to a spare by ``repair_program``: exact."""
    base = fabric_cfg or fabric.FabricConfig()
    m, k, n = shape
    x, w = signed_ints(rng, 4, (m, k)), signed_ints(rng, 4, (k, n))
    want = x.astype(np.int64) @ w.astype(np.int64)
    fm = faults.FaultModel(bit_rate=1e-4, scrub=True)
    res, calls, wall = launches_of(lambda: fabric.fabric_matmul(
        x, w, nbits=4, cfg=base, signed=True, faults=fm, device=dev))
    if not np.array_equal(np.asarray(res.out, np.int64), want):
        raise AssertionError("fabric under scrubbed faults != numpy")
    if not (fm.injected_flips > 0 and fm.detected > 0 and fm.escaped == 0):
        raise AssertionError(f"fault counters: {fm.stats()}")
    cfg = dataclasses.replace(base, spare_blocks=1)
    sched = fabric.schedule_gemm(m, k, n, 4, cfg=cfg, signed=True)
    dead = next(b for b, mode in enumerate(sched.modes)
                if mode in ("compute", "storage"))
    plan = fabric.repair_program(sched, (dead,),
                                 fm=faults.FaultModel(dead_blocks=(dead,)))
    fm2 = faults.FaultModel(dead_blocks=(dead,))
    res2, calls2, wall2 = launches_of(lambda: fabric.fabric_matmul(
        x, w, nbits=4, cfg=cfg, signed=True, faults=fm2, device=dev))
    if not np.array_equal(np.asarray(res2.out, np.int64), want):
        raise AssertionError("fabric with a repaired dead block != numpy")
    if fm2.remaps != 1 or res2.schedule.modes != plan.modes \
            or plan.modes[dead] != "dead":
        raise AssertionError(f"repair: {fm2.stats()} {plan.modes}")
    emit({"phase": "fabric_faults", "ok": True, "shape": list(shape),
          "scrub": {"wall_s": wall, "execute_blocks_launches": calls,
                    **fm.stats()},
          "dead_block": {"dead": dead, "modes": list(plan.modes),
                         "wall_s": wall2, "execute_blocks_launches": calls2,
                         **fm2.stats()}})


def phase_fuzz(dev=None, budget=32):
    """Every committed corpus file through every executor variant on the
    card, the fault pin two-sided, then a budget of ``budget`` generated
    programs: all bit-identical to the port's ``unroll`` oracle there."""
    files = sorted((ROOT / "tests" / "corpus").glob("fuzz_*.txt"))
    if len(files) != 8:
        raise AssertionError(f"expected 8 corpus files, found {files}")
    bp.lane_fold_cuda.launches = 0
    t0 = time.perf_counter()
    for path in files:
        fp, pins = fuzz.load_corpus(path)
        rep = fuzz.replay(fp, device=dev)
        if not rep.ok or rep.cycles != pins["cycles"]:
            raise AssertionError(f"{path.name}: {rep.mismatches}")
    fp, _ = fuzz.load_corpus(ROOT / "tests" / "corpus" / "fuzz_faults.txt")
    off = fp.with_groups(fp.groups, cfg=dataclasses.replace(
        fp.cfg, fault_scrub=False))
    if fuzz.replay(off, variants=("faults",), device=dev).ok:
        raise AssertionError("fuzz_faults.txt: scrub off did not escape")
    corpus_s = time.perf_counter() - t0
    stats = fuzz.run_budget(budget, seed=0, corpus_dir=None, device=dev)
    if stats["mismatch"] is not None or stats["programs"] != budget:
        raise AssertionError(f"fuzz budget: {stats['mismatch']}")
    emit({"phase": "fuzz_replay", "ok": True,
          "corpus": [p.name for p in files], "variants": list(fuzz.VARIANTS),
          "corpus_s": corpus_s, "budget": budget,
          "budget_ops": stats["ops"], "budget_s": stats["seconds"],
          "seq_histogram": stats["seq_histogram"],
          "lane_fold_launches": bp.lane_fold_cuda.launches})
    return bp.lane_fold_cuda.launches


def phase_packed_vs_bool(rng):
    """One full fabric launch (``MAX_BATCH_BLOCKS`` = 512 blocks) of
    ``idot4x58``, ``idot8x28`` and the
    bf16 ``float_dot`` with the packed and the bool interior: bit for bit
    equal, and each one's graph and event time: the measurement behind
    ``engine.PACKED_DEFAULT_MAX_CYCLES`` on this card."""
    bf16_t = cram.fdot_geometry(floatprog.BF16)
    progs = {"idot4x58": programs.idot(4, rows=512, tuples=58)[0],
             "idot8x28": programs.idot(8, rows=512, tuples=28)[0],
             f"bf16_dot x{bf16_t}": floatprog.float_dot(
                 floatprog.BF16, rows=512, tuples=bf16_t)[0]}
    blocks = fabric.MAX_BATCH_BLOCKS
    st = engine.CRState(
        array=torch.from_numpy(rng.integers(0, 2, (blocks, 512, 40))
                               .astype(bool)).cuda(),
        carry=torch.zeros((blocks, 40), dtype=torch.bool, device="cuda"),
        tag=torch.ones((blocks, 40), dtype=torch.bool, device="cuda"))
    out = {}
    for name, prog in progs.items():
        res = {pk: engine.execute_blocks(prog, st, packed=pk)
               for pk in (True, False)}
        if not all(torch.equal(a, b) for a, b in zip(res[True], res[False])):
            raise AssertionError(f"{name}: packed != bool interior")
        row = {"cycles": len(prog.expand()),
               "default_packed": engine.default_packed(prog)}
        for pk in (True, False):
            row["packed" if pk else "bool"] = timings(
                lambda: engine.execute_blocks(prog, st, packed=pk), reps=5,
                warmup=1, graph_reps=3)
        out[name] = row
    emit({"phase": "fabric_packed_vs_bool", "ok": True, "blocks": blocks,
          "cols": 40, "threshold_cycles": engine.PACKED_DEFAULT_MAX_CYCLES,
          "programs": out})
    return out


# ---------------------------------------------------------------------------
# The compiler's CSE pass on the card
# ---------------------------------------------------------------------------
#: the programs ``phase_cse`` holds CSE'd against un-CSE'd at 512 rows,
#: each at its default interior: the main path's and the fabric's int4
#: program (packed, through ``lane_fold``), int8 (bool) and the bf16
#: add and multiply (bool and packed)
CSE_PROGRAMS = {
    "idot4x58": lambda: programs.idot(4, rows=512, tuples=58)[0],
    "idot8x28": lambda: programs.idot(8, rows=512, tuples=28)[0],
    "bf16_add x8": lambda: programs.bf16_add(rows=512)[0],
    "bf16_mul x8": lambda: programs.bf16_mul(rows=512)[0],
}
CSE_BLOCKS = 512
LANE_FOLD_OP = "repro_torch::lane_fold"


def wall_ms(fn, reps=10, warmup=2):
    """Min over ``reps`` single calls of the host's wall time (ms) from
    the call to the end of its device work (a synchronize)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def same_state(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def phase_cse(rng, dev=None, blocks=CSE_BLOCKS, progs=CSE_PROGRAMS):
    """``compile_program(cse=True)`` against ``cse=False`` on the card
    for :data:`CSE_PROGRAMS` on one 512 x 40 block and through
    ``execute_blocks`` on :data:`CSE_BLOCKS` blocks: bit for bit equal,
    ``0 < eqns_after <= eqns_before``, the trace time and each way's
    per-call wall and CUDA-event time.  The CSE'd ``idot4x58`` graph
    holds the ``repro_torch::lane_fold`` node, and one call of it
    launches the kernel as often as an eager call of the lowered
    function."""
    dev = engine.resolve_device(dev)
    engine.clear_compile_cache()        # every graph below is traced here
    out = {}
    for name, make in progs.items():
        prog = make()
        st = engine.CRState(*(torch.from_numpy(
            rng.integers(0, 2, shape).astype(bool)).to(dev)
            for shape in ((512, 40), (40,), (40,))))
        raw = engine.compile_program(prog, 512, 40, cse=False)
        cse = engine.compile_program(prog, 512, 40, cse=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gm = cse.trace(dev)
        trace_s = time.perf_counter() - t0
        if not isinstance(gm, torch.fx.GraphModule):
            raise AssertionError(f"{name}: the CSE trace fell back")
        stats = gm._cse_stats
        if not 0 < stats["eqns_after"] <= stats["eqns_before"]:
            raise AssertionError(f"{name}: CSE stats {stats}")
        want, got = raw(st), cse(st)
        if not same_state(want, got):
            raise AssertionError(f"{name}: CSE'd graph != un-CSE'd")
        fold_nodes = sum(1 for n in gm.graph.nodes
                         if n.target is torch.ops.repro_torch.lane_fold
                         .default)
        torch.cuda.synchronize()
        f0 = bp.lane_fold_cuda.launches
        raw(st)
        torch.cuda.synchronize()
        f1 = bp.lane_fold_cuda.launches
        cse(st)
        torch.cuda.synchronize()
        f2 = bp.lane_fold_cuda.launches
        eager_folds, graph_folds = f1 - f0, f2 - f1
        packed = engine.default_packed(prog)
        if not eager_folds == graph_folds == fold_nodes:
            raise AssertionError(
                f"{name}: {fold_nodes} {LANE_FOLD_OP} nodes, folds per "
                f"call eager {eager_folds}, graph {graph_folds}")
        row = {"cycles": len(prog.expand()), "packed": packed, **stats,
               "trace_s": trace_s, "lane_fold_nodes": fold_nodes,
               "lane_fold_per_call": graph_folds}
        for way, fn in (("raw", raw), ("cse", cse)):
            row[way] = {"wall_ms": wall_ms(lambda: fn(st)),
                        "event_ms": time_ms(lambda: fn(st), reps=10,
                                            warmup=2)}
        # the same program through execute_blocks on CSE_BLOCKS blocks,
        # traced at that budget
        bst = engine.CRState(*(torch.from_numpy(
            rng.integers(0, 2, shape).astype(bool)).to(dev)
            for shape in ((blocks, 512, 40), (blocks, 40), (blocks, 40))))
        bwant = engine.execute_blocks(prog, bst, cse=False)
        traced = engine.cse_counts["traced"]
        t0 = time.perf_counter()
        bgot = engine.execute_blocks(prog, bst)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        bstats = engine.last_cse_stats
        if bstats is None or engine.cse_counts["traced"] != traced + 1:
            raise AssertionError(f"{name}: the blocks trace fell back")
        if not same_state(bwant, bgot):
            raise AssertionError(f"{name}: CSE'd blocks != un-CSE'd")
        row["blocks"] = {"blocks": blocks, **bstats,
                         "first_call_s": first_s}
        for way, on in (("raw", False), ("cse", True)):
            def call(on=on):
                return engine.execute_blocks(prog, bst, cse=on)
            row["blocks"][way] = {"wall_ms": wall_ms(call, reps=3,
                                                     warmup=1),
                                  "event_ms": time_ms(call, reps=3,
                                                      warmup=1)}
        out[name] = row
    if not out["idot4x58"]["lane_fold_nodes"]:
        raise AssertionError(f"the CSE'd idot4x58 graph holds no "
                             f"{LANE_FOLD_OP} node")
    emit({"phase": "cse_vs_raw", "ok": True, "rows": 512, "cols": 40,
          "programs": out,
          "removed": {k: v["removed"] for k, v in out.items()}})
    return out


# ---------------------------------------------------------------------------
# The serve engine over the model zoo
# ---------------------------------------------------------------------------
#: prompt lengths of the serve phase's requests: more requests than the
#: engine's slots, prefill buckets 8, 16 and 64, and a 100-token prompt
#: whose tail streams through chunked prefill
SERVE_PROMPTS = (5, 12, 16, 33, 64, 100)
SERVE_MAX_NEW = 8
SERVE_SLOTS, SERVE_CAPACITY, SERVE_CHUNK = 4, 256, 64
#: decode steps the fabric probe samples (a 4-bit fabric launch of the
#: q/k/v projections takes tens of ms of host time)
PROBE_STEPS = 2
#: the card's prefill logits against the port's CPU run on the same
#: weights: rtol = atol, the bound the reference holds its own decode
#: against its prefill to (tests/test_arch_smoke.py).  The two devices
#: sum each bf16 GEMM in float32 in another order, so the bf16 roundings
#: of the 24 layers fall apart here and there; a wrong kernel, cache or
#: layout moves logits by far more.
SERVE_CPU_TOL = 0.05


def replicated(caches, b):
    """A batch-1 model cache replicated over ``b`` slots: the batch dim is
    1 under "unit" (stacked layers), 0 under "lead" and "rest"."""
    def rep(x, d):
        return x.expand(x.shape[:d] + (b,) + x.shape[d + 1:]).clone()

    return {k: tree_map(lambda x, d=int(k == "unit"): rep(x, d), v)
            for k, v in caches.items()}


def manual_greedy(model, params, prompt, max_new, slots, capacity,
                  bucket=None):
    """Greedy ``prefill`` + ``decode_step`` of one prompt at the serve
    engine's shapes: the prompt zero-padded to ``bucket`` (the engine's
    prefill bucket; ``None``: unpadded), the cache replicated over
    ``slots`` lanes that all decode the same token."""
    dev = model.device
    n = len(prompt)
    padded = np.zeros((bucket or n,), np.int32)
    padded[:n] = prompt
    logits, caches = model.prefill(
        params, tokens=torch.from_numpy(padded)[None].to(dev),
        capacity=capacity)
    cur = int(torch.argmax(logits[0, n - 1]))
    outs, caches = [cur], replicated(caches, slots)
    for pos in range(n, n + max_new - 1):
        lg, caches = model.decode_step(
            params, caches,
            torch.full((slots, 1), cur, dtype=torch.int32, device=dev),
            torch.full((slots,), pos, dtype=torch.int32, device=dev))
        cur = int(torch.argmax(lg[0, 0]))
        outs.append(cur)
    return outs


def phase_serve(seed, dev=None, cfg=None, fabric_cfg=None,
                prompts=SERVE_PROMPTS, capacity=SERVE_CAPACITY,
                chunk=SERVE_CHUNK):
    """The system's serving entry point: ``ServeEngine`` over ``LM`` of
    qwen2-0.5b at its published widths, params from ``init_numpy(cfg,
    seed)``, 6 greedy requests of 8 new tokens in 4 slots, with a
    ``FabricLinearProbe`` of layer 0's q/k/v at 4 bits on the first
    :data:`PROBE_STEPS` decode steps.  Every request finishes with 8
    tokens; request 0's chain equals :func:`manual_greedy` at the
    engine's bucketed shape; each probe output equals ``observe_ref`` on
    the same activations bit for bit; ``lane_fold`` is launched by the
    probe; the card's prefill logits of the 16-token prompt agree with
    the port's CPU run on the same weights within :data:`SERVE_CPU_TOL`.
    Then the times: prefill per bucket, one warm decode step and its
    device busy share."""
    cfg = cfg or get_config("qwen2-0.5b")
    cuda = dev is None or torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t_phase = t0 = time.perf_counter()
    model = LM(cfg, dev)
    params = init_numpy(cfg, seed, dev)
    sync()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    toks = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in prompts]
    d = cfg.d_model
    attn0 = tree_map(lambda x: x[0], params["unit"]["b0"]["attn"])
    ws = [attn0[n].reshape(d, -1).float().cpu().numpy()
          for n in ("wq", "wk", "wv")]
    probe = fabric.FabricLinearProbe(
        ws, cfg=fabric_cfg or fabric.FabricConfig(), bits=4,
        max_steps=PROBE_STEPS, device=model.device)
    seen, observe = [], probe.observe

    def recorded(x):
        seen.append(np.array(x))
        return observe(x)

    probe.observe = recorded
    eng = ServeEngine(model, params, batch_slots=SERVE_SLOTS,
                      capacity=capacity, prefill_chunk=chunk,
                      fabric_probe=probe, device=model.device)
    for rid, p in enumerate(toks):
        eng.add(Request(rid=rid, prompt=p, max_new=SERVE_MAX_NEW))
    bp.lane_fold_cuda.launches = 0
    sync()
    t0 = time.perf_counter()
    done = eng.run()
    sync()
    wall = time.perf_counter() - t0
    launches = bp.lane_fold_cuda.launches

    if sorted(r.rid for r in done) != list(range(len(toks))) \
            or any(len(r.out) != SERVE_MAX_NEW for r in done):
        raise AssertionError(f"served {[(r.rid, len(r.out)) for r in done]}")
    if launches == 0:
        raise AssertionError("the serve probe never launched lane_fold")
    if len(seen) != PROBE_STEPS or len(probe.outputs) != PROBE_STEPS:
        raise AssertionError(f"probe sampled {len(probe.outputs)} steps")
    for x, ys in zip(seen, probe.outputs):
        if not all(np.array_equal(y, w) for y, w in
                   zip(ys, probe.observe_ref(x))):
            raise AssertionError("probe output != observe_ref")
    req0 = next(r for r in done if r.rid == 0)
    bucket = min(_bucket(len(toks[0])), capacity)
    manual = manual_greedy(model, params, toks[0], SERVE_MAX_NEW,
                           SERVE_SLOTS, capacity, bucket)
    if req0.out != manual:
        raise AssertionError(f"request 0 {req0.out} != manual {manual}")
    # reported, not held: the same loop with the prompt unpadded
    unpadded = manual_greedy(model, params, toks[0], SERVE_MAX_NEW,
                             SERVE_SLOTS, capacity)

    # the card against the port's CPU run on the same weights, with
    # cuBLAS's bf16 reductions in float32 as the CPU's are (held), and
    # at torch's default, which lets split-K reduce in bf16 (reported)
    t_cpu = time.perf_counter()
    p16 = next(p for p in toks if len(p) == 16)
    t16 = torch.from_numpy(p16)[None]
    want = LM(cfg, "cpu").prefill(init_numpy(cfg, seed, "cpu"), tokens=t16,
                                  capacity=16)[0].float()

    def card_logits(reduced_bf16):
        mm = torch.backends.cuda.matmul
        keep = mm.allow_bf16_reduced_precision_reduction
        mm.allow_bf16_reduced_precision_reduction = reduced_bf16
        try:
            return model.prefill(params, tokens=t16.to(model.device),
                                 capacity=16)[0].float().cpu()
        finally:
            mm.allow_bf16_reduced_precision_reduction = keep

    cpu_check = {"prompt_len": 16, "rtol_atol": SERVE_CPU_TOL,
                 "max_abs_logit": want.abs().max().item()}
    for reduced in (False, True):
        got = card_logits(reduced)
        err = (got - want).abs()
        cpu_check["bf16_reductions" if reduced else "f32_reductions"] = {
            "max_abs_err": err.max().item(),
            "max_over_bound": (err / (SERVE_CPU_TOL * (1 + want.abs())))
            .max().item(),
            "greedy_tokens_equal": bool(torch.equal(got.argmax(-1),
                                                    want.argmax(-1)))}
        if not reduced and (not torch.isfinite(got).all()
                            or not torch.allclose(got, want,
                                                  rtol=SERVE_CPU_TOL,
                                                  atol=SERVE_CPU_TOL)):
            raise AssertionError(f"prefill logits, card against CPU: "
                                 f"{cpu_check}")
    cpu_check["seconds"] = time.perf_counter() - t_cpu

    # times: prefill per bucket, a warm decode step at the engine's batch
    buckets = sorted(eng.fault_report()["prefill_bucket_shapes"])
    per_bucket = {}
    for bk in buckets:
        t = torch.zeros((1, bk), dtype=torch.int32, device=model.device)
        runs = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            model.prefill(params, tokens=t, capacity=capacity)
            sync()
            runs.append(time.perf_counter() - t0)
        per_bucket[bk] = {"min_ms": min(runs) * 1e3,
                          "runs_ms": [r * 1e3 for r in runs]}
    tok = torch.zeros((SERVE_SLOTS, 1), dtype=torch.int32,
                      device=model.device)
    pos = torch.full((SERVE_SLOTS,), 120, dtype=torch.int32,
                     device=model.device)

    def decode():
        model.decode_step(params, eng.caches, tok, pos)

    decode()
    steps = []
    for _ in range(10):
        sync()
        t0 = time.perf_counter()
        decode()
        sync()
        steps.append(time.perf_counter() - t0)
    step_ms = float(np.median(steps)) * 1e3
    st = eng.stats
    emit({"phase": "serve_qwen2_0_5b", "ok": True, "model": cfg.name,
          "layers": cfg.n_layers, "d_model": d, "vocab": cfg.vocab,
          "params_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(params)),
          "init_s": init_s, "slots": SERVE_SLOTS, "capacity": capacity,
          "prefill_chunk": chunk, "prompts": list(prompts),
          "max_new": SERVE_MAX_NEW, "wall_s": wall,
          "requests_done": len(done), "chains": {r.rid: r.out for r in done},
          "chain_equals_manual": True,
          "unpadded_chain_equals_manual": unpadded == manual,
          "probe_steps": len(probe.outputs),
          "probe_observed_m": list(probe.observed_m),
          "probe_equals_observe_ref": True, "lane_fold_launches": launches,
          "cpu_check": cpu_check,
          "engine_stats": {k: st[k] for k in (
              "steps", "prefill_compiles", "stream_prefill_tokens",
              "prefill_tokens", "decode_tokens", "decode_warm_steps",
              "decode_graph_replays", "decode_eager")},
          "prefill_ms_per_bucket": per_bucket,
          "decode_step_ms": {"median": step_ms,
                             "runs": [x * 1e3 for x in steps]},
          "decode_tokens_per_s": SERVE_SLOTS / (step_ms / 1e3),
          "decode_step_profile": device_profile(decode) if cuda else None,
          "phase_s": time.perf_counter() - t_phase})
    return {"lane_fold_launches": launches, "requests_done": len(done),
            "probe_steps": len(probe.outputs),
            "probe_equals_observe_ref": True, "chain_equals_manual": True}


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 4, 256
TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 3, 5
#: the card's train step against the port's CPU run on the same params,
#: optimizer state and 1 x 32 tokens: the loss and the global gradient
#: norm within these relative bounds, each gradient leaf within
#: TRAIN_GRAD_SHARE of that leaf's largest |g|.  The two devices sum
#: each bf16 GEMM in float32 in another order, so the bf16 roundings of
#: the 24 layers' activations and gradients fall apart here and there
#: (the port against the JAX package on the CPU: at most 0.033 of a
#: leaf's max at the smoke widths, tests/test_torch_train.py).
TRAIN_CPU_TOKENS = 32
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_GRAD_SHARE = 1e-3, 1e-2, 0.05


def kernel_launches():
    """The launch counters of the four kernel wrappers."""
    return {c.__name__.removesuffix("_cuda"): c.launches
            for c in (bp.lane_fold_cuda, bsm.quant_matmul_cuda,
                      bsm.popcount_matmul_cuda, fa.flash_attention_cuda)}


def same_bits(a, b):
    """Two trees of tensors (and python scalars) equal bit for bit."""
    la, da = ttree.tree_flatten(a)
    lb, db = ttree.tree_flatten(b)
    if da != db:
        return False
    for x, y in zip(la, lb):
        if not isinstance(x, torch.Tensor):
            if x != y:
                return False
            continue
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        ints = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[x.element_size()]
        if not torch.equal(x.view(ints).cpu(), y.view(ints).cpu()):
            return False
    return True


def grad_share(got, want):
    """Per leaf of two gradient trees: max |got - want| over max |want|;
    returns the worst leaf's share and its index in leaf order."""
    shares = []
    for g, w in zip(ttree.tree_leaves(got), ttree.tree_leaves(want)):
        g, w = g.float().cpu(), w.float().cpu()
        shares.append((g - w).abs().max().item()
                      / max(w.abs().max().item(), 1e-30))
    worst = int(np.argmax(shares))
    return shares[worst], worst


def phase_train(seed, dev=None, cfg=None, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                cpu_tokens=TRAIN_CPU_TOKENS, launch_args=("--full",)):
    """The system's training entry point: ``Trainer`` over ``LM`` of
    qwen2-0.5b at its published widths (``remat_policy`` "full"), params
    from ``init_numpy(cfg, seed)``, AdamW at lr 3e-3 with 2 warm-up
    steps, :data:`TRAIN_STEPS` steps of ``batch`` x ``seq`` synthetic
    tokens, a checkpoint every :data:`TRAIN_CKPT_EVERY` steps and one
    injected failure at step :data:`TRAIN_FAIL_AT`, all under
    ``torch.use_deterministic_algorithms``.  Held: the run ends at step
    8 after one restart with its step-8 checkpoint latest; every loss is
    finite and the last three average below the first three; the
    replayed steps' losses and the final state equal an uninterrupted
    run's bit for bit; the step-8 checkpoint restores on the CPU bit for
    bit; one step on ``cpu_tokens`` tokens on the card agrees with the
    CPU's (loss, grad norm, every gradient leaf; the bounds above); the
    four kernels' launch counters do not move.  Then the times (a warm
    step; the step outside deterministic mode, whole and in its two
    halves under the profiler; peak memory; a synchronous and an async
    checkpoint save) and ``python -m repro_torch.launch.train`` for 4
    steps in a subprocess (``launch_args`` after its shared flags)."""
    cfg = cfg or get_config("qwen2-0.5b")
    if cfg.remat_policy != "full":
        raise AssertionError(f"remat_policy {cfg.remat_policy!r}")
    cuda = dev is None or torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t_phase = time.perf_counter()
    before = kernel_launches()
    model = LM(cfg, dev)
    dev = model.device
    opt_cfg = optim.OptConfig(lr=3e-3, warmup_steps=2,
                              total_steps=TRAIN_STEPS)
    pipe = Pipeline(DataConfig(seed=0, global_batch=batch, seq_len=seq,
                               vocab=cfg.vocab), device=dev)
    train_step = make_train_step(model, opt_cfg)
    t0 = time.perf_counter()
    params0 = init_numpy(cfg, seed, dev)
    opt0 = optim.init(params0, opt_cfg)
    sync()
    init_s = time.perf_counter() - t0

    def run(ckpt_dir, ckpt_every, fail_at=None):
        losses, logs = [], []

        def step_fn(p, o, b):
            s = int(o.step)
            p, o, m = train_step(p, o, b)
            losses.append((s, m["loss"].item()))
            return p, o, m

        def fail_hook(step):
            if step == fail_at and not fail_hook.fired:
                fail_hook.fired = True
                raise RuntimeError("simulated node failure")

        fail_hook.fired = False
        tr = Trainer(RunnerConfig(total_steps=TRAIN_STEPS,
                                  ckpt_every=ckpt_every, ckpt_dir=ckpt_dir,
                                  keep=2, log_every=1),
                     step_fn, params0, opt0, pipe, fail_hook=fail_hook,
                     log=logs.append)
        t0 = time.perf_counter()
        end, _ = tr.run()
        return tr, end, losses, logs, time.perf_counter() - t0

    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as fault_dir, \
                tempfile.TemporaryDirectory() as clean_dir:
            faulty, end, fault_losses, fault_log, fault_wall = run(
                fault_dir, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT)
            latest = ckpt.latest_step(fault_dir)
            if (end, faulty.restarts, latest) != (TRAIN_STEPS, 1,
                                                   TRAIN_STEPS):
                raise AssertionError(f"end {end}, restarts "
                                     f"{faulty.restarts}, latest {latest}")
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            clean, _, clean_losses, _, clean_wall = run(
                clean_dir, 10 * TRAIN_STEPS)
            peak = torch.cuda.max_memory_allocated(dev) if cuda else None
            restart = next(i for i in range(1, len(fault_losses))
                           if fault_losses[i][0] <= fault_losses[i - 1][0])
            replayed = fault_losses[restart:]
            clean_at = dict(clean_losses)
            if [s for s, _ in replayed] != list(range(
                    TRAIN_CKPT_EVERY, TRAIN_STEPS)):
                raise AssertionError(f"replayed steps {replayed}")
            if any(v != clean_at[s] for s, v in fault_losses):
                raise AssertionError(f"losses {fault_losses} != "
                                     f"{clean_losses}")
            if not same_bits(
                    {"params": faulty.params, "opt": faulty.opt_state},
                    {"params": clean.params, "opt": clean.opt_state}):
                raise AssertionError("the replayed run's final state "
                                     "differs from the uninterrupted run's")
            losses = [v for _, v in clean_losses]
            if not all(np.isfinite(losses)) \
                    or np.mean(losses[-3:]) >= np.mean(losses[:3]):
                raise AssertionError(f"losses {losses}")

            # the card's step-8 checkpoint on the CPU, bit for bit
            t0 = time.perf_counter()
            state = {"params": faulty.params, "opt": faulty.opt_state,
                     "data": pipe.state_dict(0)}
            on_cpu = ttree.tree_map(
                lambda x: x.cpu() if isinstance(x, torch.Tensor) else x,
                state)
            restored, meta = ckpt.restore(fault_dir, on_cpu)
            on_cpu["data"] = pipe.state_dict(TRAIN_STEPS)
            if meta["step"] != TRAIN_STEPS or not same_bits(restored,
                                                            on_cpu):
                raise AssertionError("the step-8 checkpoint restored on "
                                     "the CPU differs from the card's")
            restore_s = time.perf_counter() - t0
            del on_cpu
    finally:
        torch.use_deterministic_algorithms(False)

    # one step on the card against the same step on the CPU, from the
    # step-8 state, taken in the train step's two halves so that the
    # gradients can be compared
    t_cpu = time.perf_counter()
    small = Pipeline(DataConfig(seed=0, global_batch=1, seq_len=cpu_tokens,
                                vocab=cfg.vocab), device="cpu").batch(
                                    TRAIN_STEPS)
    cpu_model = LM(cfg, "cpu")
    out = {}
    for where, m, tree in (("card", model, state), ("cpu", cpu_model,
                                                    restored)):
        b = {k: v.to(m.device) for k, v in small.items()}
        loss, grads = value_and_grad(m.loss)(tree["params"], b)
        _, _, met = optim.apply(tree["params"], grads, tree["opt"], opt_cfg)
        out[where] = (loss.item(), met["grad_norm"].item(), grads)
    (l_card, n_card, g_card), (l_cpu, n_cpu, g_cpu) = out["card"], out["cpu"]
    share, worst_leaf = grad_share(g_card, g_cpu)
    cpu_check = {
        "tokens": cpu_tokens, "loss": [l_card, l_cpu],
        "loss_rel_err": abs(l_card - l_cpu) / abs(l_cpu),
        "loss_rtol": TRAIN_LOSS_RTOL, "grad_norm": [n_card, n_cpu],
        "grad_norm_rel_err": abs(n_card - n_cpu) / abs(n_cpu),
        "grad_norm_rtol": TRAIN_GNORM_RTOL,
        "worst_grad_share": share, "worst_grad_leaf": worst_leaf,
        "grad_share_bound": TRAIN_GRAD_SHARE}
    if not (cpu_check["loss_rel_err"] <= TRAIN_LOSS_RTOL
            and cpu_check["grad_norm_rel_err"] <= TRAIN_GNORM_RTOL
            and share <= TRAIN_GRAD_SHARE):
        raise AssertionError(f"train step, card against CPU: {cpu_check}")
    cpu_check["seconds"] = time.perf_counter() - t_cpu
    restarts = faulty.restarts
    del out, g_card, g_cpu, restored, state, faulty

    # times: a warm step, one step under the profiler, checkpoint saves
    step_s = float(np.median(clean.step_times[1:]))
    batch0 = pipe.batch(0)

    def one_step():
        train_step(clean.params, clean.opt_state, batch0)

    tree = {"params": clean.params, "opt": clean.opt_state,
            "data": pipe.state_dict(TRAIN_STEPS)}
    ckpt_bytes = sum(t.numel() * t.element_size()
                     for t in ttree.tree_leaves(tree)
                     if isinstance(t, torch.Tensor))
    with tempfile.TemporaryDirectory() as save_dir:
        sync()
        t0 = time.perf_counter()
        ckpt.save(save_dir, 1, tree)
        save_s = time.perf_counter() - t0
        saver = ckpt.AsyncSaver()
        t0 = time.perf_counter()
        saver.submit(save_dir, 2, tree)
        submit_s = time.perf_counter() - t0
        saver.wait()
        async_s = time.perf_counter() - t0

    # the same step outside deterministic mode, whole and in its two
    # halves (forward + remat + backward; the optimizer)
    default_mode_ms = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        one_step()
        sync()
        default_mode_ms.append((time.perf_counter() - t0) * 1e3)
    grad_fn = value_and_grad(model.loss)
    grads = grad_fn(clean.params, batch0)[1]
    profile = split = None
    if cuda:
        profile = device_profile(one_step)
        split = {"grad": device_profile(
                     lambda: grad_fn(clean.params, batch0)),
                 "apply": device_profile(lambda: optim.apply(
                     clean.params, grads, clean.opt_state, opt_cfg))}
    step_times = clean.step_times

    # the entry point, in a process of its own
    del clean, tree, batch0, grads
    if cuda:
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as launch_dir:
        cmd = [sys.executable, "-m", "repro_torch.launch.train",
               "--arch", "qwen2-0.5b", "--steps", "4", "--batch",
               str(batch), "--seq", str(seq), "--ckpt-dir", launch_dir,
               *launch_args]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src")] + [p for p in [os.environ.get(
                "PYTHONPATH")] if p]))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        launch_s = time.perf_counter() - t0
        last = (proc.stdout.strip().splitlines() or [""])[-1]
        if proc.returncode != 0 or not last.startswith(
                "finished at step 4"):
            raise AssertionError(f"launch.train exited {proc.returncode}: "
                                 f"{proc.stdout[-2000:]}"
                                 f"{proc.stderr[-2000:]}")
    after = kernel_launches()
    if after != before:
        raise AssertionError(f"training launched a kernel: {before} -> "
                             f"{after}")
    emit({"phase": "train_qwen2_0_5b", "ok": True, "model": cfg.name,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab, "remat_policy": cfg.remat_policy,
          "params": sum(t.numel() for t in ttree.tree_leaves(params0)),
          "batch": batch, "seq": seq, "steps": TRAIN_STEPS,
          "init_s": init_s, "restarts": restarts,
          "latest_checkpoint": latest, "losses": losses,
          "fault_run": {"losses": fault_losses, "wall_s": fault_wall,
                        "log": fault_log},
          "replayed_bit_identical": True,
          "final_state_bit_identical": True,
          "checkpoint_restored_on_cpu_bit_identical": True,
          "restore_on_cpu_s": restore_s, "cpu_check": cpu_check,
          "clean_run_wall_s": clean_wall,
          "step_ms": {"median_warm": step_s * 1e3,
                      "first": step_times[0] * 1e3,
                      "runs": [x * 1e3 for x in step_times]},
          "tokens_per_s": batch * seq / step_s,
          "step_ms_default_mode": default_mode_ms,
          "step_profile": profile, "step_profile_halves": split,
          "max_memory_allocated_bytes": peak,
          "checkpoint_bytes": ckpt_bytes,
          "checkpoint_save_s": {"sync": save_s, "async_submit": submit_s,
                                "async_total": async_s},
          "launch": {"cmd": cmd[1:], "returncode": proc.returncode,
                     "last_line": last, "wall_s": launch_s},
          "kernel_launches_before": before, "kernel_launches_after": after,
          "phase_s": time.perf_counter() - t_phase})
    return {"restarts": restarts, "latest": latest,
            "losses": losses, "replayed": replayed,
            "cpu_check": cpu_check, "launch_rc": proc.returncode,
            "kernel_launches": (before, after)}


# ---------------------------------------------------------------------------
# The launch layer: the dry-run on fake process groups, held against the
# card, and training through a mesh
# ---------------------------------------------------------------------------
#: qwen2-0.5b's production cells the dry-run traces: (shape, multi_pod)
LAUNCH_CELLS = (("decode_32k", False), ("prefill_32k", False),
                ("train_4k", False), ("decode_32k", True))
#: batches of 32768-position sequences tried for the one-card decode, from
#: decode_32k's 128 down: the largest whose estimated peak is under
#: LAUNCH_MEM_SHARE of the card's memory runs
LAUNCH_BATCHES = (128, 64, 32, 16, 8)
LAUNCH_MEM_SHARE = 0.8
LAUNCH_PEAK_RTOL = 0.10         # the real peak against the estimate
LAUNCH_TRAIN_STEPS = 4
#: the production cells' per-rank temp (GB) and collectives by kind (MB)
#: while the port replicated the vocabulary: the table all-gathered before
#: the lookup, the loss on all-gathered float32 logits (H100 80GB HBM3,
#: 700.00 W, fake CUDA tensors); printed beside each cell
LAUNCH_VOCAB_REPLICATED = {
    ("decode_32k", False): {"temp_gb": 6.493, "collective_mb": {
        "all-gather": 272.27, "all-reduce": 0.69}},
    ("prefill_32k", False): {"temp_gb": 30.052, "collective_mb": {
        "all-reduce": 5637.14, "all-gather": 272.27}},
    ("train_4k", False): {"temp_gb": 132.824, "collective_mb": {
        "all-gather": 40300.85, "reduce-scatter": 18328.58,
        "all-reduce": 12735.22, "all-to-all": 956.30}},
    ("decode_32k", True): {"temp_gb": 3.246, "collective_mb": {
        "all-gather": 272.27, "all-reduce": 0.34}},
}
#: with the vocabulary split as the reference keeps it: train_4k's
#: per-rank temp, and its all-gather on the card (a CPU group records its
#: all-to-all fallback as all-gather); decode and prefill gather nothing
LAUNCH_TRAIN_TEMP_MAX = 48e9
LAUNCH_TRAIN_GATHER_MAX = 500e6


def train_log(stdout):
    """(losses, step ms) of ``Trainer``'s ``[train]`` lines, and the last
    metrics of ``launch.train``'s closing line."""
    losses, ms, last = [], [], None
    for line in stdout.splitlines():
        if line.startswith("[train] step "):
            parts = line.split()
            losses.append(float(parts[4]))
            ms.append(float(parts[5].strip("(")))
        elif line.startswith("finished at step "):
            last = ast.literal_eval(line.split(": ", 1)[1])
    return losses, ms, last


def phase_launch(seed, dev=None, cfg=None, cells=LAUNCH_CELLS, seq=32768,
                 batches=LAUNCH_BATCHES, mem_bytes=None,
                 train_batch=TRAIN_BATCH, train_seq=TRAIN_SEQ,
                 launch_args=("--full",)):
    """The launch layer (``repro_torch.launch``) on the card, in three
    parts.  1: ``dryrun.lower_cell`` for qwen2-0.5b's ``cells`` on the
    (16, 16) and (2, 16, 16) meshes of a fake process group, fake tensors
    on the card's device type: each ok, on 256 or 512 ranks, with
    collectives (d_ff 4864 splits on "model") and a temp, and the
    vocabulary split as the reference keeps it: decode and prefill
    gather nothing, train_4k holds at most :data:`LAUNCH_TRAIN_TEMP_MAX`
    a rank (and gathers at most :data:`LAUNCH_TRAIN_GATHER_MAX` on the
    card); each cell is reported beside
    :data:`LAUNCH_VOCAB_REPLICATED`.  2: the dry-run
    of a one-card decode of ``cfg`` at ``seq`` positions, for each of
    ``batches`` until the estimated peak (arguments + temp) is under
    :data:`LAUNCH_MEM_SHARE` of ``mem_bytes`` (default: the card's); then
    that decode step for real through a (1, 1) mesh on a one-rank group,
    from ``init_numpy(cfg, seed)`` weights and ``init_cache``: its
    arguments' bytes and ``FlopCounterMode``'s count equal the
    estimate's exactly, its peak (``max_memory_allocated`` over the step
    beyond what was allocated before it, plus the arguments) lies within
    :data:`LAUNCH_PEAK_RTOL` of the estimate; a warm step's wall (CUDA
    events, median of 5) beside the H100 roofline of the same cell.  3:
    ``launch.train`` (always on a mesh; here ``make_mesh(1, 1)`` on a
    one-rank group) for :data:`LAUNCH_TRAIN_STEPS` steps of
    ``train_batch`` x ``train_seq`` in a subprocess under
    ``torch.use_deterministic_algorithms``, its losses within
    ``TRAIN_LOSS_RTOL`` of the same steps of the mesh-free
    ``make_train_step`` in this process, and whether its final state is
    bit-identical to theirs; then one mesh step against one mesh-free
    step in this process: wall and kernels.  No kernel of the four is
    launched."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import analysis, dryrun
    from repro_torch.launch import sharding as lsh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import init_group
    from repro_torch.models.common import use_mesh

    cfg = cfg or get_config("qwen2-0.5b")
    dev = engine.resolve_device(dev)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t_phase = time.perf_counter()
    before = kernel_launches()

    # 1. the production dry-run
    production = []
    for shape, multi in cells:
        r = dryrun.lower_cell("qwen2-0.5b", shape, multi_pod=multi,
                              device=dev)
        mem = r.get("memory_analysis", {})
        if not (r["status"] == "ok" and r["chips"] == (512 if multi else 256)
                and r["collective_bytes"] > 0
                and mem["temp_size_in_bytes"] > 0):
            raise AssertionError(f"dry-run {shape} multi_pod={multi}: {r}")
        gathered = r["collective_by_kind"]["all-gather"]
        if shape == "train_4k":
            kept = mem["temp_size_in_bytes"] <= LAUNCH_TRAIN_TEMP_MAX and (
                not cuda or gathered <= LAUNCH_TRAIN_GATHER_MAX)
        else:
            kept = gathered == 0
        if not kept:
            raise AssertionError(f"dry-run {shape} multi_pod={multi}: the "
                                 f"vocabulary is not kept split: temp "
                                 f"{mem['temp_size_in_bytes']}, "
                                 f"{r['collective_by_kind']}")
        production.append({
            "shape": shape, "multi_pod": multi, "status": r["status"],
            "chips": r["chips"], "trace_s": r["compile_s"],
            "per_rank_argument_bytes": mem["argument_size_in_bytes"],
            "per_rank_temp_bytes": mem["temp_size_in_bytes"],
            "per_rank_output_bytes": mem["output_size_in_bytes"],
            "collective_bytes": r["collective_bytes"],
            "collective_by_kind": r["collective_by_kind"],
            "collective_ops": r["collective_ops"],
            "per_rank_temp_gb": mem["temp_size_in_bytes"] / 1e9,
            "collective_mb": {k: v / 1e6 for k, v in
                              r["collective_by_kind"].items() if v},
            "vocab_replicated": LAUNCH_VOCAB_REPLICATED.get((shape, multi)),
            "counted_flops": r["counted_flops"],
            "counted_bytes": r["counted_bytes"],
            "analytic_flops": r["analytic_flops"],
            "analytic_bytes": r["analytic_bytes"],
            "model_flops_6nd": r["model_flops_6nd"],
            "h100_roofline": analysis.roofline(
                r["analytic_flops"], r["analytic_bytes"],
                r["collective_bytes"], r["chips"])})

    # 2. the one-card estimate, held against the card
    mem_bytes = mem_bytes or torch.cuda.get_device_properties(
        dev).total_memory
    estimates = []
    for b in batches:
        sh = {"kind": "decode", "seq": seq, "batch": b}
        with dryrun.fake_group(1):
            est = dryrun.trace_step(cfg, sh, make_mesh(
                1, 1, device_type=dev.type), device=dev)
        ma = est["memory_analysis"]
        est_peak = ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]
        estimates.append({"batch": b, "est_peak_bytes": est_peak,
                          "trace_s": est["compile_s"]})
        if est_peak < LAUNCH_MEM_SHARE * mem_bytes:
            break
    else:
        raise AssertionError(f"no decode batch fits: {estimates}")
    model = LM(cfg, dev)
    rng = np.random.default_rng(seed)
    init_group(dev)
    try:
        mesh = make_mesh(1, 1, device_type=dev.type)
        params = init_numpy(cfg, seed, dev)
        caches = model.init_cache(b, seq)
        ins = [torch.from_numpy(rng.integers(0, cfg.vocab, (b, 1)).astype(
                   np.int32)).to(dev),
               torch.full((b,), seq - 1, dtype=torch.int32, device=dev)]
        args = (lsh.distribute(params, lsh.params_sharding(params, mesh),
                               mesh),
                lsh.distribute(caches, lsh.cache_sharding(caches, mesh),
                               mesh),
                *lsh.distribute(ins, lsh.batch_sharding(ins, mesh), mesh))
        del params, caches, ins
        arg_bytes = dryrun.local_bytes(args)
        sync()
        base = torch.cuda.memory_allocated(dev) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        with use_mesh(mesh), FlopCounterMode(display=False) as fc:
            out = model.decode_step(*args)
        sync()
        real_peak = (torch.cuda.max_memory_allocated(dev) - base + arg_bytes
                     if cuda else None)
        logits = out[0].full_tensor()
        if tuple(logits.shape) != (b, 1, cfg.vocab) \
                or not torch.isfinite(logits.float()).all():
            raise AssertionError(f"decode logits {tuple(logits.shape)}")
        del out, logits
        walls = []
        for _ in range(5 if cuda else 1):
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2)) if cuda else (None, None)
            t0 = time.perf_counter()
            if cuda:
                e0.record()
            with use_mesh(mesh):
                out = model.decode_step(*args)
            if cuda:
                e1.record()
            sync()
            walls.append(e0.elapsed_time(e1) if cuda
                         else (time.perf_counter() - t0) * 1e3)
            del out
        del args
    finally:
        dist.destroy_process_group()
    if cuda:
        torch.cuda.empty_cache()
    terms = analysis.terms_for(cfg, sh, 1)
    card = {
        "batch": b, "seq": seq, "mem_bytes": mem_bytes,
        "estimates": estimates,
        "argument_bytes": [arg_bytes, ma["argument_size_in_bytes"]],
        "counted_flops": [fc.get_total_flops(), est["counted_flops"]],
        "peak_bytes": [real_peak, est_peak],
        "peak_rel_err": (abs(real_peak - est_peak) / est_peak
                         if cuda else None),
        "peak_rtol": LAUNCH_PEAK_RTOL,
        "est_temp_bytes": ma["temp_size_in_bytes"],
        "est_collective_ops": est["collective_ops"],
        "warm_step_ms": float(np.median(walls)), "step_ms_runs": walls,
        "h100_roofline": analysis.roofline(
            terms["analytic_flops"], terms["analytic_bytes"], 0.0, 1),
        "counted_roofline": analysis.roofline(
            est["counted_flops"], est["counted_bytes"], 0.0, 1),
        "analytic": terms}
    card["roofline_share"] = card["h100_roofline"]["roofline_s"] * 1e3 \
        / card["warm_step_ms"]
    if arg_bytes != ma["argument_size_in_bytes"] \
            or fc.get_total_flops() != est["counted_flops"] \
            or (cuda and card["peak_rel_err"] > LAUNCH_PEAK_RTOL):
        raise AssertionError(f"one-card decode against its estimate: {card}")

    # 3. training through the mesh: launch.train against the mesh-free
    # step, the same 4 steps, both deterministic
    opt_cfg = optim.OptConfig(lr=3e-3, warmup_steps=10,
                              total_steps=LAUNCH_TRAIN_STEPS)  # the launcher's
    pipe = Pipeline(DataConfig(seed=0, global_batch=train_batch,
                               seq_len=train_seq, vocab=cfg.vocab),
                    device=dev)
    train_step = make_train_step(model, opt_cfg)
    p = init_numpy(cfg, 0, dev)
    o = optim.init(p, opt_cfg)
    free_losses = []
    torch.use_deterministic_algorithms(True)
    try:
        for s in range(LAUNCH_TRAIN_STEPS):
            p, o, m = train_step(p, o, pipe.batch(s))
            free_losses.append(m["loss"].item())
        with tempfile.TemporaryDirectory() as launch_dir:
            code = ("import sys, torch; "
                    "torch.use_deterministic_algorithms(True); "
                    "from repro_torch.launch import train; "
                    "train.main(sys.argv[1:])")
            cmd = [sys.executable, "-c", code, "--arch", "qwen2-0.5b",
                   "--steps", str(LAUNCH_TRAIN_STEPS), "--batch",
                   str(train_batch), "--seq", str(train_seq), "--ckpt-dir",
                   launch_dir, "--log-every", "1", *launch_args]
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [str(ROOT / "src")] + [x for x in [os.environ.get(
                    "PYTHONPATH")] if x]))
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, env=env,
                                  capture_output=True, text=True,
                                  timeout=600)
            launch_s = time.perf_counter() - t0
            mesh_losses, mesh_ms, last = train_log(proc.stdout)
            if proc.returncode != 0 or last is None \
                    or len(mesh_losses) != LAUNCH_TRAIN_STEPS:
                raise AssertionError(f"launch.train exited "
                                     f"{proc.returncode}: "
                                     f"{proc.stdout[-2000:]}"
                                     f"{proc.stderr[-2000:]}")
            like = {"params": p, "opt": o, "data": pipe.state_dict(0)}
            state, meta = ckpt.restore(launch_dir, like)
            state_bits = meta["step"] == LAUNCH_TRAIN_STEPS and same_bits(
                {"params": state["params"], "opt": state["opt"]},
                {"params": p, "opt": o})
            del state
    finally:
        torch.use_deterministic_algorithms(False)
    rel = [abs(a - b) / abs(b) for a, b in zip(mesh_losses, free_losses)]
    last_exact = last["loss"] == free_losses[-1]
    if max(rel) > TRAIN_LOSS_RTOL:
        raise AssertionError(f"launch.train losses {mesh_losses} against "
                             f"the mesh-free {free_losses}")

    # one mesh step against one mesh-free step, in this process
    batch0 = pipe.batch(0)
    init_group(dev)
    try:
        mesh = make_mesh(1, 1, device_type=dev.type)
        ps = lsh.params_sharding(p, mesh)
        mp = lsh.distribute(p, ps, mesh)
        mo = lsh.distribute(o, lsh.opt_sharding(o, ps, mesh), mesh)

        def mesh_step():
            b_ = lsh.distribute(batch0, lsh.batch_sharding(batch0, mesh),
                                mesh)
            with use_mesh(mesh):
                return train_step(mp, mo, b_)

        def free_step():
            return train_step(p, o, batch0)

        step_ms = {}
        for name, fn in (("mesh", mesh_step), ("mesh_free", free_step),
                         ("mesh", mesh_step), ("mesh_free", free_step)):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            step_ms.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
        profiles = ({"mesh": device_profile(mesh_step),
                     "mesh_free": device_profile(free_step)}
                    if cuda else None)
        del mp, mo
    finally:
        dist.destroy_process_group()
    del p, o, batch0
    if cuda:
        torch.cuda.empty_cache()
    after = kernel_launches()
    if after != before:
        raise AssertionError(f"the launch phase launched a kernel: "
                             f"{before} -> {after}")
    train = {
        "steps": LAUNCH_TRAIN_STEPS, "batch": train_batch, "seq": train_seq,
        "mesh_losses_4dp": mesh_losses, "mesh_free_losses": free_losses,
        "loss_rel_err": rel, "loss_rtol": TRAIN_LOSS_RTOL,
        "last_loss": [last["loss"], free_losses[-1]],
        "last_loss_bit_identical": last_exact,
        "final_state_bit_identical": state_bits,
        "launch_step_ms": mesh_ms, "launch_wall_s": launch_s,
        "in_process_step_ms": step_ms, "step_profile": profiles,
        # the mesh-free step as PERF.md records it before the launch
        # layer (H100 80GB HBM3, 700.00 W)
        "earlier_mesh_free_step": {"ms": 412.00, "kernels": 8854}}
    emit({"phase": "launch_qwen2_0_5b", "ok": True,
          "production_dry_run": production, "one_card_decode": card,
          "train_through_mesh": train,
          "kernel_launches_before": before, "kernel_launches_after": after,
          "phase_s": time.perf_counter() - t_phase})
    return {"production": production, "card": card, "train": train,
            "kernel_launches": (before, after)}


# ---------------------------------------------------------------------------
# The examples
# ---------------------------------------------------------------------------
#: the port's examples as ``phase_examples`` runs them: ``main(argv)`` on
#: the card (the default device); train_lm at the 100m preset, its
#: "paper-scale end-to-end target", failing at step 24 of 40
EXAMPLE_ARGS = {
    "torch_quickstart": (), "torch_pim_matmul": (),
    "torch_fabric_attention": (), "torch_serve_lm": (),
    "torch_train_lm": ("--preset", "100m", "--steps", "40"),
}
#: examples whose output is a pure function of their numpy seeds: the
#: card must print what the CPU prints, line for line
EXAMPLES_EXACT = ("torch_quickstart", "torch_fabric_attention")
#: the reference's bounds on a packed linear's error (PERF.md section 2)
PIM_REL_ERR = {8: 0.03, 4: 0.15}


def load_example(name):
    """``examples/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name, argv):
    """``main(argv)`` of an example with its stdout captured: (result,
    stdout lines)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = load_example(name).main(list(argv))
    return res, buf.getvalue().splitlines()


def reset_launches():
    for c in (bp.lane_fold_cuda, bsm.quant_matmul_cuda,
              bsm.popcount_matmul_cuda, fa.flash_attention_cuda):
        c.launches = 0


def check_example(name, res, lines, launches):
    """The checks of one example's run on the card beyond its own
    asserts; returns what the phase reports of it."""
    if name == "torch_quickstart":
        if res["bf16_products"] != [4.5, -1.125]:
            raise AssertionError(f"quickstart bf16: {res['bf16_products']}")
        return {}
    if name == "torch_pim_matmul":
        if res["popcount_vs_ref"] != 0 or not res["cram_exact"]:
            raise AssertionError(f"pim_matmul: {res}")
        for bits, bound in PIM_REL_ERR.items():
            if not res["packed"][bits]["rel_err"] <= bound:
                raise AssertionError(f"pim_matmul W{bits}: {res['packed']}")
        want = {"quant_matmul": 2, "popcount_matmul": 1}
        if any(launches[k] != v for k, v in want.items()) \
                or not launches["lane_fold"]:
            raise AssertionError(f"pim_matmul launches {launches}")
        return {"rel_err": {b: r["rel_err"] for b, r in
                            res["packed"].items()}}
    if name == "torch_fabric_attention":
        if not launches["lane_fold"]:
            raise AssertionError("fabric_attention never launched "
                                 "lane_fold")
        return {"scores_max_abs_err": res["scores_max_abs_err"]}
    if name == "torch_serve_lm":
        if sorted(res["outs"]) != list(range(6)) or any(
                len(o) != 8 for o in res["outs"].values()):
            raise AssertionError(f"serve_lm: {res['outs']}")
        return {"outs": res["outs"], "w8_agree": res["w8_agree"],
                "tree_bytes": res["bytes"]}
    if name == "torch_train_lm":
        losses = [float(v) for v in re.findall(
            r"\[train\] step \d+ loss ([\d.]+)", "\n".join(lines))]
        if res["restarts"] != 1 or res["end"] != 40 or len(losses) != 4 \
                or not all(np.isfinite(losses)) \
                or not any("[fault] step 24" in ln for ln in lines) \
                or not any("restored step 20" in ln for ln in lines):
            raise AssertionError(f"train_lm: {res} {lines}")
        return {"restarts": res["restarts"], "end": res["end"],
                "losses_at_10_20_30_40": losses,
                "step_ms_median": float(np.median(res["step_times"])) * 1e3,
                "steps_run": len(res["step_times"])}
    raise KeyError(name)


def phase_examples(args=EXAMPLE_ARGS):
    """The five port examples through ``main(argv)`` on the card: each
    one's asserts, the checks of :func:`check_example`, its wall time
    and the four kernels' launches (counters set to 0 just before each
    example and read just after).  The numpy-seeded examples print on
    the card what they print with ``--device cpu``."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv in args.items():
            if name == "torch_train_lm":
                argv = (*argv, "--ckpt-dir", os.path.join(tmp, "ckpt"))
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            res, lines = run_example(name, argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernel_launches()
            row = {"argv": list(argv), "wall_s": wall, "launches": launches,
                   "lines": len(lines),
                   **check_example(name, res, lines, launches)}
            if name in EXAMPLES_EXACT:
                _, cpu = run_example(name, ("--device", "cpu"))
                if cpu != lines:
                    raise AssertionError(f"{name}: the card printed other "
                                         f"lines than the CPU")
                row["same_lines_as_cpu"] = True
            out[name] = row
    emit({"phase": "examples", "ok": True, "examples": out})
    return out


#: CSE graphs traced in each phase of the run (``cse_checked``)
CSE_TRACED = {}


def cse_checked(phase, *args):
    """Run ``phase(*args)``; fail when one of its CSE traces fell back to
    the un-CSE'd function, and record how many it traced."""
    before = dict(engine.cse_counts)
    out = phase(*args)
    fell = engine.cse_counts["fallback"] - before["fallback"]
    if fell:
        raise AssertionError(f"{phase.__name__}: {fell} CSE trace(s) fell "
                             f"back to the un-CSE'd function")
    CSE_TRACED[phase.__name__] = engine.cse_counts["traced"] \
        - before["traced"]
    return out


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
    stats = cse_checked(phase_kernel, rng)
    launches, _, _ = cse_checked(phase_main_path, rng)
    cse_checked(phase_profile, rng)
    cse_checked(phase_int8_bf16, rng)
    cse_checked(phase_executors, rng)
    cse_checked(phase_cse, rng)
    gemm = cse_checked(phase_gemm, rng)
    flash = cse_checked(phase_flash, rng)
    cse_checked(phase_flash_model, rng)
    linear_launches, _ = cse_checked(phase_pim_linear, args.seed)
    fabric_launches, fabric_groups = cse_checked(phase_fabric_layer,
                                                 args.seed)
    pack = cse_checked(phase_fabric_pack, rng)
    decode = cse_checked(phase_decode_attention, rng, args.seed)
    scan = cse_checked(phase_linear_scan, args.seed)
    serve_launches = cse_checked(phase_serve,
                                 args.seed)["lane_fold_launches"]
    cse_checked(phase_train, args.seed)
    cse_checked(phase_fabric_dtypes, rng)
    cse_checked(phase_fabric_faults, rng)
    fuzz_launches = cse_checked(phase_fuzz)
    cse_checked(phase_packed_vs_bool, rng)
    cse_checked(phase_launch, args.seed)
    examples = cse_checked(phase_examples)
    emit({"phase": "cse_traces", "ok": True, "traced": CSE_TRACED,
          "fallbacks": 0, "smoke_s": time.perf_counter() - t0})
    kernels = [{
        "name": "lane_fold", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lane_fold.cu",
        "replaces": "src/repro/kernels/bitplane_ops.py:187",
        "launches": launches, "max_abs_err": stats["max_abs_err"],
        "ms": stats["ms"], "plain_ms": stats["plain_ms"],
        "bound_ms": stats["bound_ms"], "bound_by": stats["bound_by"],
        "library_ms": None,
        "launches_by_path": {"main_path_int4": launches,
                             "fabric_qwen2_layer0": fabric_launches,
                             "serve_qwen2_0_5b": serve_launches,
                             "fuzz_replay": fuzz_launches,
                             **{f"example_{k}": v["launches"]["lane_fold"]
                                for k, v in examples.items()}},
        "op_ms": stats["op_ms"],
        "at_fabric_shape": {k: stats["fabric_shape"][k] for k in (
            "shape", "max_abs_err", "ms", "op_ms", "plain_ms", "bound_ms",
            "bound_by")}}]
    kernels.append({
        "name": "fabric_pack", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fabric_pack.cu",
        "replaces": None,
        "launches": sum(g["fabric_pack_launches"]
                        for g in fabric_groups.values()),
        "launches_by_path": {"fabric_qwen2_layer0": sum(
            g["fabric_pack_launches"] for g in fabric_groups.values())},
        **{k: pack[k] for k in ("shape", "max_abs_err", "ms",
                                "plain_event_ms", "host_pack_ms", "bound_ms",
                                "bound_by")},
        "library_ms": None})
    step = decode["step"]
    kernels.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": None, "launches": step["kernel"]["launches"],
        "launches_by_path": {"danube_decode_step": step["kernel"]["launches"],
                             "danube_decode_graph": step["graph"]["launches"]},
        "shape": decode["shape"],
        "by_live": [{k: c[k] for k in (
            "live", "max_abs_err", "ms", "plain_event_ms", "widened_ms",
            "bound_ms", "bound_by", "library_ms")} for c in decode["cases"]],
        "library": "scaled_dot_product_attention(enable_gqa=True)"})
    whole = scan["cases"][0]
    kernels.append({
        "name": "linear_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/linear_scan.cu",
        "replaces": None,
        "launches": sum(scan["launches_by_path"].values()),
        "launches_by_path": scan["launches_by_path"],
        "shape": whole["shape"], "max_abs_err": 0.0,
        "plain_ms": whole["plain_event_ms"],
        **{k: whole[k] for k in ("ms", "op_event_ms", "bound_ms", "bound_by",
                                 "library_ms")},
        "by_chunk": [{k: c[k] for k in (
            "shape", "ms", "op_event_ms", "plain_event_ms", "bound_ms",
            "roofline_pct")} for c in scan["cases"]],
        "backward_launches": scan["grad"]["launches"]})
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
            "launches_by_path": {
                "pim_linear_qwen2_layer0": linear_launches[name],
                **{f"example_{k}": v["launches"][name]
                   for k, v in examples.items()}},
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
