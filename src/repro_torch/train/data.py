"""Deterministic, shardable, checkpointable data pipeline.

The counterpart of ``repro.train.data``.  Every host draws the *same*
global batch definition from a counter-based RNG (``(seed, step)`` fully
determines the batch: numpy's ``Philox`` keyed by the seed at counter
``step``, statement for statement as the reference draws it), then
slices its per-host shard.  So the port's batches are bit-identical to
the reference's; restart-from-checkpoint resumes at the recorded step
with zero drift, and elastic re-sharding only changes the slice
boundaries, not the stream.

Two sources:

* synthetic -- zipf-ish token stream (benchmarks, dry-runs, tests)
* file      -- memory-mapped uint16 token file (real runs)

Batches are tensors on the pipeline's device: int32 ``tokens`` and, for
encoder-decoder models, bfloat16 ``src_embeds`` (rounded from float64
on the host, as ``jnp.asarray(emb, jnp.bfloat16)`` rounds them).
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch

from repro_torch.core.engine import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    vocab: int = 256
    path: str | None = None          # None -> synthetic
    src_len: int | None = None       # enc-dec source length
    d_model: int | None = None       # for frontend-stub embeds


class Pipeline:
    """state = just the step counter; batch(step) is a pure function.

    ``device``: where batches land (``None``: the GPU)."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1,
                 device=None):
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.device = resolve_device(device)
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"divide over {n_hosts} hosts")
        self._mm = None
        if cfg.path is not None:
            self._mm = np.memmap(pathlib.Path(cfg.path), dtype=np.uint16,
                                 mode="r")

    def _host_slice(self):
        per = self.cfg.global_batch // self.n_hosts
        return self.host_id * per, per

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        start, per = self._host_slice()
        if self._mm is not None:
            # deterministic offsets from a counter-based hash
            rs = np.random.Generator(np.random.Philox(
                key=cfg.seed, counter=step))
            max_start = len(self._mm) - cfg.seq_len - 1
            offs = rs.integers(0, max_start, cfg.global_batch)
            offs = offs[start:start + per]
            toks = np.stack([self._mm[o:o + cfg.seq_len] for o in offs])
            toks = toks.astype(np.int32)
        else:
            rs = np.random.Generator(np.random.Philox(
                key=cfg.seed, counter=step))
            # zipf-ish synthetic distribution over the real vocab
            u = rs.random((cfg.global_batch, cfg.seq_len))
            toks = np.minimum((u ** 3 * cfg.vocab).astype(np.int32),
                              cfg.vocab - 1)
            toks = np.ascontiguousarray(toks[start:start + per])
        out = {"tokens": torch.from_numpy(toks).to(self.device)}
        if cfg.src_len and cfg.d_model:
            rs2 = np.random.Generator(np.random.Philox(
                key=cfg.seed + 1, counter=step))
            emb = rs2.normal(0, 1, (per, cfg.src_len, cfg.d_model))
            out["src_embeds"] = torch.from_numpy(emb).to(
                torch.bfloat16).to(self.device)
        return out

    # checkpointable state ---------------------------------------------------
    def state_dict(self, step: int) -> dict:
        return {"step": step, "seed": self.cfg.seed,
                "global_batch": self.cfg.global_batch}

    @staticmethod
    def resume_step(state: dict) -> int:
        return int(state["step"])
