"""The benchmark's machinery: the manifest, the lookup of a cell's files by
name, spans and counters wrapped around the program's callables, the
reduction of a device trace, and the result line.

Everything that belongs to one configuration, traffic mix, driver or
metric lives in a file of its own under this folder, found by the name
that ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``  -- the sizes, as run, and their source;
* ``traffic/<mix>.json``     -- the driver a mix uses and its parameters;
* ``drivers/<driver>.py``    -- ``setup``, ``window``, ``release``,
  ``check`` and ``control`` for one kind of work (fabric, serve, ...);
* ``metrics/<metric>.py``    -- ``UNIT``, ``LAYER``, optional ``SPANS``
  and ``CALLS`` (callables to wrap), and ``read(rec)``;
* ``limits/<workload>.json`` -- each compared number's limit.

A later cell, mix, configuration or metric is new files and new manifest
entries; no file here needs an edit.
"""

from __future__ import annotations

import bisect
import functools
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pb_spans

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: top-level module names the port must never load
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


class Layout:
    """Where a cell's files are looked up: ``dirs`` in order, each laid
    out as this folder is (``configs/``, ``traffic/``, ...)."""

    def __init__(self, manifest=None, dirs=(BENCH,)):
        self.dirs = [Path(d) for d in dirs]
        self.manifest_path = Path(manifest or ROOT / "BENCHMARK.json")

    def manifest(self) -> dict:
        return json.loads(self.manifest_path.read_text())

    def find(self, kind: str, name: str, suffix: str) -> Path:
        for d in self.dirs:
            p = d / kind / f"{name}{suffix}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {kind}/{name}{suffix} under "
                                f"{[str(d) for d in self.dirs]}")

    def data(self, kind: str, name: str) -> dict:
        return json.loads(self.find(kind, name, ".json").read_text())

    def module(self, kind: str, name: str):
        path = self.find(kind, name, ".py")
        key = f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def resolve_cell(layout: Layout, workload: str) -> SimpleNamespace:
    """The cell ``workload`` with its configuration, mix, driver, limits
    and the metrics it reports, each looked up by name."""
    man = layout.manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {layout.manifest_path}")
    w = cells[workload]

    def applies(m):
        return workload in m.get("workloads", [workload])

    mix = layout.data("traffic", w["traffic"])
    return SimpleNamespace(
        name=workload, chips=int(w["chips"]),
        config=layout.data("configs", w["config"]),
        traffic=mix, driver=layout.module("drivers", mix["driver"]),
        limits=layout.data("limits", workload),
        end_to_end=[(m, layout.module("metrics", m["name"]))
                    for m in man["end_to_end"] if applies(m)],
        per_layer=[(m, layout.module("metrics", m["name"]))
                   for m in man["per_layer"] if applies(m)])


#: ``ModelConfig`` fields that give a tensor's shape: the file's value
#: has to be the port's own (``model`` sets every other field as run)
WIDTHS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
          "head_dim", "encoder_layers", "tie_embeddings", "qkv_bias",
          "mlp_variant", "family")


def model_config(cfg: dict):
    """The port's ``ModelConfig`` that ``cfg`` names with the file's
    ``model`` values applied: the file is the configuration as run.  A
    shape that differs from the port's config (``WIDTHS``) fails here,
    so a port whose config drifted is seen, not run at another size."""
    import dataclasses

    from repro_torch.configs import get_config
    mc = get_config(cfg["arch"], smoke=bool(cfg.get("smoke", False)))
    have = dataclasses.asdict(mc)
    diff = {k: (v, have.get(k)) for k, v in cfg["model"].items()
            if k in WIDTHS and have.get(k) != v}
    if diff:
        raise ValueError(f"{cfg['arch']}: the port's shapes differ from "
                         f"the file's (file, port): {diff}")
    return dataclasses.replace(mc, **cfg["model"])


# ---------------------------------------------------------------------------
# Spans and counters: wrappers on the program's callables, installed only
# in a traced run
# ---------------------------------------------------------------------------
def _resolve(target: str, roots: dict):
    """``"pkg.mod:attr"`` (a module attribute) or ``"@root:attr"`` (an
    attribute of an object the driver names) -> (owner, attr)."""
    where, attr = target.split(":")
    if where.startswith("@"):
        return roots[where[1:]], attr
    return importlib.import_module(where), attr


class Tracer:
    """Spans (host clock, ended after the device finished) and call
    records (argument shapes, no synchronisation) around callables."""

    def __init__(self, sync):
        self.sync = sync
        self.spans = {}
        self.calls = {}
        self._undo = []

    def span(self, target: str, roots: dict):
        owner, attr = _resolve(target, roots)
        fn = getattr(owner, attr)
        out = self.spans.setdefault(target, [])
        sync = self.sync

        @functools.wraps(fn)
        def spanned(*a, **kw):
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            sync()
            out.append((t0, time.perf_counter()))
            return r

        self._swap(owner, attr, fn, spanned)

    def record(self, target: str, roots: dict):
        owner, attr = _resolve(target, roots)
        fn = getattr(owner, attr)
        out = self.calls.setdefault(target, [])

        @functools.wraps(fn)
        def recorded(*a, **kw):
            out.append(tuple(tuple(x.shape) if hasattr(x, "shape") else x
                             for x in a))
            return fn(*a, **kw)

        self._swap(owner, attr, fn, recorded)

    def _swap(self, owner, attr, fn, new):
        # keep attributes the callable keeps on itself (a launch counter
        # that the function bumps through its global name)
        new.__dict__.update(getattr(fn, "__dict__", {}))
        setattr(owner, attr, new)
        self._undo.append((owner, attr, fn, new))

    def close(self):
        for owner, attr, fn, new in reversed(self._undo):
            fn.__dict__.update(new.__dict__)
            setattr(owner, attr, fn)
        self._undo = []


# ---------------------------------------------------------------------------
# The device trace
# ---------------------------------------------------------------------------
def start_profiler():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def _device_events(prof):
    """(name, start_ns, end_ns) of every operation that ran on the
    device (kernels, copies, fills), on the profiler's clock."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        s = e.start_ns()
        out.append((e.name(), s, s + e.duration_ns()))
    return out


def reduce_trace(prof, window, clocks, spans):
    """The traced window's device record.

    ``window`` is ``(t0, t1)`` on ``time.perf_counter``; ``clocks`` maps
    a clock's name to its offset from ``perf_counter`` in ns (sampled at
    the window's start), and the clock that puts the most device
    operations inside the window is taken as the profiler's.  Returns
    ``busy_s`` (the union of device operations inside the window),
    per-name device seconds and counts, and the idle gaps labelled by the
    innermost span the host was in (``spans``: name -> [(t0, t1)])."""
    ev = _device_events(prof)
    w0 = int(window[0] * 1e9)
    w1 = int(window[1] * 1e9)

    def inside(off):
        lo, hi = w0 + off - 10**9, w1 + off + 10**9
        return sum(lo <= s <= hi for _, s, _ in ev)

    clock, off = max(clocks.items(), key=lambda kv: inside(kv[1]))
    lo, hi = w0 + off, w1 + off
    per_name = {}
    ivals = []
    for name, s, e in ev:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        ivals.append((s, e))
        t = per_name.setdefault(name, [0, 0.0])
        t[0] += 1
        t[1] += (e - s) / 1e9
    busy = pb_spans.merged(ivals)
    busy_s = sum(e - s for s, e in busy) / 1e9
    # idle gaps, labelled by the innermost host span around their middle
    # (one name's spans never overlap: a bisection per name)
    by_name = {n: sorted((int(a * 1e9) + off, int(b * 1e9) + off)
                         for a, b in ss) for n, ss in spans.items() if ss}
    starts = {n: [a for a, _ in ss] for n, ss in by_name.items()}

    def label(t):
        best, name = None, "outside spans"
        for n, ss in by_name.items():
            i = bisect.bisect_right(starts[n], t) - 1
            if i >= 0 and ss[i][1] >= t and (best is None
                                             or ss[i][1] - ss[i][0] < best):
                best, name = ss[i][1] - ss[i][0], n
        return name

    gaps = {}
    prev = lo
    for s, e in busy + [[hi, hi]]:
        if s > prev:
            n = label((prev + s) // 2)
            gaps[n] = gaps.get(n, 0.0) + (s - prev) / 1e9
        prev = max(prev, e)
    return {"clock": clock, "busy_s": busy_s, "events": len(ev),
            "per_name": per_name, "idle_by_span": gaps}


def breakdown(trace) -> dict:
    ops = sorted(trace["per_name"].items(), key=lambda kv: -kv[1][1])[:10]
    gaps = sorted(trace["idle_by_span"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], v[1]] for n, v in ops],
            "idle_gaps": [[n[:120], v] for n, v in gaps]}


def forbidden_modules():
    """Top-level names of loaded modules that the port must not load."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))
