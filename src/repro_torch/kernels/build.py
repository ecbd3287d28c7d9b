"""Build the CUDA sources under ``csrc/`` into shared libraries.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/lib<name>-<hash>.so``
beside this file; the hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header never
loads a stale library.  The kernels' wrappers load
the libraries with ``ctypes`` on first use.  :func:`build_all` starts
one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD = Path(__file__).with_name("build")
SOURCES = ("lane_fold", "quant_matmul", "popcount_matmul", "flash_attention",
           "fabric_pack", "decode_attention", "linear_scan")
#: SASS mnemonics of the tensor cores: warpgroup (wgmma) and warp
#: (mma.sync) MMAs, floating point and integer
TENSOR_CORE_OPS = ("HGMMA", "IGMMA", "HMMA", "IMMA")
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on
    the PATH, or ``/usr/local/cuda/bin/nvcc``."""
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")] \
        if os.environ.get("CUDA_HOME") else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise FileNotFoundError("nvcc not found (set CUDA_HOME)")


def target(name: str) -> Path:
    """The library path for ``csrc/<name>.cu`` at its current content and
    that of the headers beside it."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Build every listed source that is not built yet, in parallel.

    Returns ``{name: {"seconds": wall, "log": nvcc stderr}}`` for the
    sources it compiled (``ptxas -v`` register/spill lines are in the
    log).  Raises ``RuntimeError`` with the compiler output on failure.
    """
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True),
                       tmp, out, time.perf_counter())
    done, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
        done[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return done


def library(name: str) -> Path:
    """Path of the built library for ``csrc/<name>.cu`` (builds it first
    when missing)."""
    out = target(name)
    if not out.exists():
        build_all([name])
    return out


def tensor_core_ops(name: str, timeout: float = 120) -> dict:
    """Count of each of :data:`TENSOR_CORE_OPS` in the SASS of the built
    library for ``csrc/<name>.cu``, from ``cuobjdump -sass`` (beside
    ``nvcc``).  Raises when the tool is missing, fails or times out."""
    tool = Path(nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        raise FileNotFoundError(f"cuobjdump not found beside {nvcc()}")
    sass = subprocess.run([str(tool), "-sass", str(library(name))],
                          capture_output=True, text=True, check=True,
                          timeout=timeout).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in TENSOR_CORE_OPS}
