"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on fake
tensors over a fake process group.

The counterpart of ``repro.launch.dryrun``.  Proves the distribution
config is coherent without hardware: sharding mismatches, per-rank
memory and the collectives each step runs all surface here.  Where
the reference lowers and compiles on 512 fake XLA host devices, one
cell here starts a fake ``torch.distributed`` group of ``chips`` ranks
in this process (backend ``"fake"``, torch's ``FakeStore``), builds
params, optimizer state, caches and inputs as fake tensors under
``FakeTensorMode`` (nothing is allocated), distributes them by the
sharding rules as rank 0 holds them, and runs the step eagerly while it
records:

* ``collective_*``: every collective rank 0 runs
  (``analysis.CollectiveRecorder``), the reference's kinds and
  convention;
* ``counted_flops``: ``torch.utils.flop_counter.FlopCounterMode`` over
  the step as the model writes it (global shapes): matmuls and
  attention only, so it is not XLA's ``hlo_flops``, which counts every
  op;
* ``counted_bytes``: the bytes in and out of every aten op at global
  shapes, unfused (no op's output stays on chip for the next);
* ``memory_analysis``: ``argument_size_in_bytes`` and
  ``output_size_in_bytes``, the bytes of rank 0's shards of the inputs
  and outputs; ``temp_size_in_bytes``, the peak of the storages rank
  0's program holds alive beyond its arguments (outputs included while
  they live).  There is no ``generated_code_size_in_bytes``.

``compile_s`` is the trace's seconds.  The eager layer loop runs every
layer, so ``scan_trip_multiplier`` is 1.0.  Results are written as JSON.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out results/
  python -m repro_torch.launch.dryrun --arch ... --shape ... --multi-pod

``--device cpu`` traces on fake CPU tensors; the default is the card
(fake CUDA tensors), which raises where there is none.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.core.engine import resolve_device
from repro_torch.launch import analysis, shapes as shp
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.sharding import (batch_sharding, cache_sharding,
                                         distribute, map_with_path,
                                         opt_sharding, params_sharding)
from repro_torch.models.common import use_mesh
from repro_torch.models.model import LM
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.step import make_train_step


def apply_overrides(cfg, overrides: dict):
    """dataclasses.replace with dotted keys ("moe.dispatch_chunks")."""
    flat, nested = {}, {}
    for key, v in (overrides or {}).items():
        if "." in key:
            head, tail = key.split(".", 1)
            nested.setdefault(head, {})[tail] = v
        else:
            flat[key] = v
    for head, sub in nested.items():
        flat[head] = dataclasses.replace(getattr(cfg, head), **sub)
    return dataclasses.replace(cfg, **flat)


@contextlib.contextmanager
def fake_group(chips: int):
    """A fake process group of ``chips`` ranks in this process, as rank
    0; torn down on exit (the group is process-global)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=chips)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _is_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def _tensors(tree):
    out = []
    map_with_path(lambda _, t: out.append(t), tree)
    return [t for t in out if isinstance(t, torch.Tensor)]


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of a tree's tensors."""
    return sum(t.to_local().numel() * t.element_size()
               if hasattr(t, "to_local") else t.numel() * t.element_size()
               for t in _tensors(tree))


class StorageTracker(TorchDispatchMode):
    """Peak bytes of the storages that this rank's ops create and that
    are alive at once (each storage counted once, however many views
    share it; freed when its last reference goes).  The storages of
    ``known`` (the step's arguments) are not counted, nor are the
    global-shape fake tensors that DTensor's sharding propagation makes
    under a fake mode of its own (no rank allocates them)."""

    def __init__(self, known=()):
        super().__init__()
        self.live = self.peak = 0
        self._sizes = {}
        self._known = {id(t.untyped_storage()): t.untyped_storage()
                       for t in known}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out                      # sharding propagation
        for t in analysis._tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key not in self._sizes and key not in self._known:
                self._sizes[key] = st.nbytes()
                self.live += st.nbytes()
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, key)
        return out

    def _free(self, key):
        self.live -= self._sizes.pop(key)


class ByteCounter(TorchDispatchMode):
    """Bytes in and out of every aten op at global shapes: above DTensor,
    it sees each op once as the model writes it.  A view moves nothing
    and is not counted."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(func, "is_view", False):
            return out
        self.bytes += sum(analysis._nbytes(t) for t in (
            *analysis._tensors(args), *analysis._tensors(
                list(kwargs.values())), *analysis._tensors(out)))
        return out


def trace_step(cfg, sh: dict, mesh, wq_bits=None, device=None):
    """Trace one step of ``cfg`` at shape ``sh`` (a ``SHAPES`` entry) on
    ``mesh`` with fake tensors on ``device``; returns the recorded
    measurements.  The mesh's process group must be live."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    model = LM(cfg, device)
    dev = model.device
    kind = sh["kind"]
    spec = shp.specs_for(cfg, sh)
    t0 = time.time()
    # inputs are made under the fake mode; the step runs outside it (on
    # fake inputs, so every op is still fake), because DTensor's own
    # bookkeeping makes small real tensors and reads them back
    enc = {}
    with FakeTensorMode(allow_non_fake_inputs=True), use_mesh(mesh):
        params = model.init(torch.Generator().manual_seed(0))
        if wq_bits:
            from repro_torch.models.qweight import quantize_tree
            params = quantize_tree(params, bits=wq_bits)
        p_shard = params_sharding(params, mesh)
        params = distribute(params, p_shard, mesh)
        ins = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
               for k, v in spec.get("batch", spec).items()}
        ins = distribute(ins, batch_sharding(ins, mesh), mesh)
        if kind == "train":
            opt_cfg = opt_mod.OptConfig()
            opt = opt_mod.init(params, opt_cfg)
            opt = distribute(opt, opt_sharding(opt, p_shard, mesh), mesh)
            step = make_train_step(model, opt_cfg)
            args = (params, opt, ins)
        else:
            enc = {k: ins[k] for k in ("enc_out", "enc_pos") if k in ins}
            if kind == "prefill":
                def step(params, tokens, **enc):
                    return model.prefill(params, tokens=tokens, **enc)
                args = (params, ins["tokens"])
            else:
                caches = model.init_cache(sh["batch"], sh["seq"])
                caches = distribute(caches, cache_sharding(caches, mesh),
                                    mesh)

                def step(params, caches, tokens, pos, **enc):
                    return model.decode_step(params, caches, tokens, pos,
                                             **enc)
                args = (params, caches, ins["tokens"], ins["pos"])
    arg_bytes = local_bytes([args, enc])
    locals_ = [t.to_local() if hasattr(t, "to_local") else t
               for t in _tensors([args, enc])]
    colls, store = analysis.CollectiveRecorder(), StorageTracker(locals_)
    nbytes, flops = ByteCounter(), FlopCounterMode(display=False)
    with use_mesh(mesh), colls, store, nbytes, flops:
        out = step(*args, **enc)
    out_bytes = local_bytes(out)
    coll = analysis.collective_bytes(colls.records)
    return {
        "compile_s": round(time.time() - t0, 1),
        "counted_flops": float(flops.get_total_flops()),
        "counted_bytes": float(nbytes.bytes),
        "scan_trip_multiplier": 1.0,
        "collective_bytes": coll.total_bytes,
        "collective_by_kind": coll.bytes_by_kind,
        "collective_ops": coll.count,
        "memory_analysis": {
            "temp_size_in_bytes": int(store.peak),
            "argument_size_in_bytes": int(arg_bytes),
            "output_size_in_bytes": int(out_bytes)},
    }


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               opt_overrides: dict | None = None,
               mesh_shape: tuple | None = None, device=None) -> dict:
    opt_overrides = dict(opt_overrides or {})
    wq_bits = opt_overrides.pop("wq_bits", None)
    cfg = configs.get_config(arch)
    if opt_overrides:
        cfg = apply_overrides(cfg, opt_overrides)
    if not shp.applicable(cfg, shape_name):
        return {"arch": arch, "shape": shape_name,
                "multi_pod": multi_pod, "status": "skipped",
                "reason": shp.skip_reason(cfg, shape_name)}

    dev = resolve_device(device)
    if mesh_shape is not None:
        chips = 1
        for s in mesh_shape:
            chips *= s
    else:
        chips = 512 if multi_pod else 256
    with fake_group(chips):
        if mesh_shape is not None:
            mesh = make_mesh(*mesh_shape, device_type=dev.type)
        else:
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type=dev.type)
        traced = trace_step(cfg, shp.SHAPES[shape_name], mesh, wq_bits,
                            dev)

    res = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "status": "ok", "chips": int(chips),
        "params_b": int(cfg.param_count()),
        "active_params_b": int(cfg.active_param_count()),
        **traced,
    }
    res.update(analysis.analytic_terms(cfg, shape_name, chips))
    return with_weight_bits(res, cfg, wq_bits)


def with_weight_bits(res, cfg, wq_bits):
    """``res``'s analytic terms for weights stored at ``wq_bits``."""
    if wq_bits:
        # params move at 1 B/elt (w8) or 0.5 B/elt (w4 planes) vs bf16
        n_total = cfg.param_count()
        res["analytic_bytes"] -= 2.0 * n_total \
            - (n_total if wq_bits == 8 else n_total / 2)
        res["wq_bits"] = wq_bits
    return res


ALL_CELLS = [(a, s) for a in configs.list_archs() for s in shp.SHAPES]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--degraded", action="store_true",
                    help="elastic re-mesh after node loss: (data=8, model=16)"
                         " = half a pod; proves the re-meshed topology"
                         " traces")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--device", default=None,
                    help="device type of the fake tensors (default: the "
                         "GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    cells = ALL_CELLS if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]

    mesh_shape = (8, 16) if args.degraded else None
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__" + (
                "degraded" if args.degraded else
                ("multi" if mp else "single"))
            fp = out / f"{tag}.json"
            if fp.exists():
                print(f"[skip] {tag} (exists)")
                continue
            print(f"[dryrun] {tag} ...", flush=True)
            try:
                res = lower_cell(arch, shape, mp, mesh_shape=mesh_shape,
                                 device=dev)
            except Exception as e:                    # noqa: BLE001
                res = {"arch": arch, "shape": shape, "multi_pod": mp,
                       "status": "error", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-3000:]}
            fp.write_text(json.dumps(res, indent=1))
            print(f"[done] {tag}: {res['status']}", flush=True)


if __name__ == "__main__":
    main()
