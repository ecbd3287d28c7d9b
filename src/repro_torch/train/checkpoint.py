"""Fault-tolerant checkpointing: atomic, keep-N, resumable.

The counterpart of ``repro.train.checkpoint``, with its layout:
``<dir>/step_<n>/arrays.npz + meta.json``, written to a temp dir and
atomically renamed (a crash mid-write never corrupts the latest valid
checkpoint).  ``latest_step`` scans for complete checkpoints only.
Leaf ``i`` of the tree, in the JAX package's leaf order, is stored as
``a{i}``, or as ``__bf16__{i}`` holding a bfloat16 leaf's bits as
uint16 (npz has no bf16); python scalars are stored as the 0-d arrays
``np.asarray`` makes of them.  So a checkpoint written by either package
loads in the other bit for bit.

On a mesh a DTensor leaf is saved as its full tensor (``full_tensor()``,
a collective: every rank calls ``save`` or ``AsyncSaver.submit``) and
only rank 0 of the process group writes; ``restore`` gives each rank its
shard of the stored full tensor on the placements of ``like``'s leaf.
So a run restores on another mesh, as after a node loss.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time

import numpy as np
import torch

from .tree import tree_flatten, tree_map, tree_unflatten

_BF16_TAG = "__bf16__"


def _full(leaf):
    """A tensor leaf whole: a DTensor's full tensor (a collective)."""
    if hasattr(leaf, "full_tensor"):
        return leaf.detach().full_tensor()
    return leaf


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0, or no group."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _array(leaf):
    """``(name prefix, numpy array)`` of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _BF16_TAG, t.view(torch.int16).numpy().view(np.uint16)
        return "a", t.numpy()
    return "a", np.asarray(leaf)


def save(ckpt_dir, step: int, tree, extra_meta: dict | None = None,
         keep: int = 3) -> str:
    ckpt_dir = pathlib.Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    leaves, treedef = tree_flatten(tree)
    leaves = [_full(x) for x in leaves]
    if not _writer():
        return str(final)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f".tmp_step_{step:08d}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    arrays = {}
    for i, leaf in enumerate(leaves):
        prefix, a = _array(leaf)
        arrays[f"{prefix}{i}"] = a
    np.savez(tmp / "arrays.npz", **arrays)
    meta = {"step": step, "n_leaves": len(leaves),
            "treedef": str(treedef), "time": time.time(),
            "extra": extra_meta or {}}
    (tmp / "meta.json").write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                     # atomic publish

    # retention
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)
    return str(final)


def _snapshot(leaf):
    """A host copy of a tensor leaf that later in-place writes to the
    tensor cannot reach (``.cpu()`` of a CPU tensor would be the tensor
    itself)."""
    if isinstance(leaf, torch.Tensor):
        return _full(leaf).detach().to("cpu", copy=True)
    return leaf


class AsyncSaver:
    """Overlap checkpoint IO with training (one in-flight save).

    ``submit`` copies every tensor to the host before it returns
    (blocking only on the device->host copies; the next step may write
    the tensors in place), then serializes + atomically publishes on a
    background thread.  ``wait`` joins the in-flight save (call before
    shutdown or before restoring).
    """

    def __init__(self):
        self._thread = None
        self._error = None

    def submit(self, ckpt_dir, step, tree, extra_meta=None, keep=3):
        self.wait()
        host_tree = tree_map(_snapshot, tree)

        def run():
            try:
                save(ckpt_dir, step, host_tree, extra_meta, keep)
            except Exception as e:                    # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def all_steps(ckpt_dir) -> list:
    ckpt_dir = pathlib.Path(ckpt_dir)
    out = []
    if not ckpt_dir.exists():
        return out
    for p in ckpt_dir.iterdir():
        if p.name.startswith("step_") and (p / "meta.json").exists() \
                and (p / "arrays.npz").exists():
            out.append(int(p.name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir):
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir, like, step: int | None = None):
    """Restore into the structure, dtypes and devices of ``like``.

    Returns (tree, meta).  The stored ``treedef`` string is not read, as
    in the reference: leaf ``i`` of ``like`` takes stored leaf ``i``.
    """
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    meta = json.loads((d / "meta.json").read_text())

    leaves, treedef = tree_flatten(like)
    out = []
    with np.load(d / "arrays.npz") as data:
        for i, leaf in enumerate(leaves):
            if f"{_BF16_TAG}{i}" in data:
                a = torch.from_numpy(
                    data[f"{_BF16_TAG}{i}"].view(np.int16)).view(
                        torch.bfloat16)
            else:
                a = torch.from_numpy(data[f"a{i}"])
            if isinstance(leaf, (int, float)):   # python scalars (metadata)
                out.append(type(leaf)(a))
                continue
            if tuple(a.shape) != tuple(leaf.shape):
                raise ValueError(f"leaf {i}: stored shape {tuple(a.shape)}"
                                 f" != {tuple(leaf.shape)}")
            a = a.to(device=leaf.device, dtype=leaf.dtype)
            if hasattr(leaf, "placements"):
                from torch.distributed.tensor import distribute_tensor
                a = distribute_tensor(a, leaf.device_mesh, leaf.placements,
                                      src_data_rank=None)
            out.append(a)
    return tree_unflatten(treedef, out), meta
