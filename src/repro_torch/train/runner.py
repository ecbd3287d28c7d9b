"""Fault-tolerant training runner.

The counterpart of ``repro.train.runner``, with the same posture:

* checkpoint/restart -- atomic keep-N checkpoints (params + optimizer +
  data-pipeline state) every ``ckpt_every`` steps; on *any* step failure
  the runner restores the latest checkpoint and replays.  The data
  pipeline is counter-based, so replayed batches are bit-identical.
* node failure -- surfaces as a failed step; restart from checkpoint on
  the surviving topology via ``elastic_remesh``: batches are re-sliced
  over the new data-parallel extent.
* straggler mitigation -- a step-time watchdog tracks a running median;
  steps slower than ``straggler_factor`` x median are logged and counted
  so the scheduler can evict the slow host.

The step timer waits for the step's device (a CUDA synchronize) where
the reference blocks on the loss.  After a fault the runner joins an
in-flight async save before it looks for the latest checkpoint: the
reference looks first, so a fault while the last checkpoint is still
being written restarts from step 0.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import checkpoint as ckpt_mod


@dataclasses.dataclass
class RunnerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    max_restarts: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10
    async_ckpt: bool = True      # overlap checkpoint IO with training


def _block_until_ready(x):
    """Wait until the device that holds ``x`` has computed it."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class Trainer:
    def __init__(self, cfg: RunnerConfig, train_step: Callable,
                 params, opt_state, pipeline,
                 fail_hook: Optional[Callable] = None,
                 log: Callable = print):
        self.cfg = cfg
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.pipeline = pipeline
        self.fail_hook = fail_hook          # test hook: raise to simulate
        self.log = log
        self.step_times: list = []
        self.straggler_events = 0
        self.restarts = 0
        self._saver = ckpt_mod.AsyncSaver()

    # -- checkpoint glue -----------------------------------------------------
    def _save(self, step, final=False):
        tree = {"params": self.params, "opt": self.opt_state,
                "data": self.pipeline.state_dict(step)}
        if self.cfg.async_ckpt and not final:
            self._saver.submit(self.cfg.ckpt_dir, step, tree,
                               keep=self.cfg.keep)
            self.log(f"[ckpt] step {step} (async)")
        else:
            self._saver.wait()
            path = ckpt_mod.save(self.cfg.ckpt_dir, step, tree,
                                 keep=self.cfg.keep)
            self.log(f"[ckpt] step {step} -> {path}")

    def _restore(self):
        self._saver.wait()
        like = {"params": self.params, "opt": self.opt_state,
                "data": self.pipeline.state_dict(0)}
        tree, meta = ckpt_mod.restore(self.cfg.ckpt_dir, like)
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        step = int(meta["step"])
        self.log(f"[ckpt] restored step {step}")
        return step

    # -- main loop -------------------------------------------------------------
    def run(self, start_step: int = 0):
        step = start_step
        last_metrics = {}
        while step < self.cfg.total_steps:
            try:
                batch = self.pipeline.batch(step)
                t0 = time.perf_counter()
                if self.fail_hook is not None:
                    self.fail_hook(step)
                self.params, self.opt_state, metrics = self.train_step(
                    self.params, self.opt_state, batch)
                _block_until_ready(metrics["loss"])
                dt = time.perf_counter() - t0

                # straggler watchdog
                self.step_times.append(dt)
                med = float(np.median(self.step_times[-50:]))
                if len(self.step_times) > 5 and \
                        dt > self.cfg.straggler_factor * med:
                    self.straggler_events += 1
                    self.log(f"[straggler] step {step}: {dt:.3f}s "
                             f"(median {med:.3f}s)")

                step += 1
                last_metrics = {k: float(v) for k, v in metrics.items()}
                if step % self.cfg.log_every == 0:
                    self.log(f"[train] step {step} "
                             f"loss {last_metrics['loss']:.4f} "
                             f"({dt*1e3:.0f} ms)")
                if step % self.cfg.ckpt_every == 0:
                    self._save(step)
            except KeyboardInterrupt:
                raise
            except Exception as e:                      # noqa: BLE001
                self.restarts += 1
                self.log(f"[fault] step {step}: {type(e).__name__}: {e}")
                if self.restarts > self.cfg.max_restarts:
                    raise
                # an async save still in flight is the latest checkpoint
                # (the reference looks for one before joining the save)
                self._saver.wait()
                if ckpt_mod.latest_step(self.cfg.ckpt_dir) is not None:
                    step = self._restore()
                else:
                    self.log("[fault] no checkpoint; restarting from 0")
                    step = start_step
        self._save(step, final=True)
        return step, last_metrics


def elastic_remesh(global_batch: int, n_data_old: int, n_data_new: int):
    """Re-slice the global batch over a changed data-parallel extent.

    Returns the new per-shard batch.  The synchronous semantics (same
    global batch, same RNG counters) are preserved exactly, which is why
    shrink/grow needs no optimizer adjustments.
    """
    if global_batch % n_data_new:            # the reference's assert
        raise AssertionError(f"global_batch {global_batch} must divide "
                             f"data axis {n_data_new}")
    return global_batch // n_data_new
