"""Production training entry point.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --full --steps 8 --batch 4 --seq 256
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --device cpu --data 2 --model 2

The counterpart of ``repro.launch.train``, with its flags and ``--device``
(default: the GPU; ``--device cpu`` runs on the host).  It always trains
on a ``make_mesh(data, model, pod)`` mesh: under ``torchrun`` (or any
launcher that sets ``RANK`` and ``WORLD_SIZE``) it joins that process
group, NCCL on the GPU and gloo on the host, one rank per mesh device;
alone it starts a one-rank group on a ``HashStore``.  Params (drawn from
a seeded numpy Generator, ``models.convert.init_numpy``, seed 0) and
the optimizer state are distributed by the sharding rules; every rank
draws the same global batch and keeps its shard, so the batches do not
depend on the mesh.  ``--smoke`` (the default) uses the reduced config,
``--full`` the published one.  Fault tolerance: restarts from the
latest checkpoint in ``--ckpt-dir`` automatically (checkpoints hold full
tensors, so a run restores on another mesh).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch import configs
from repro_torch.core.engine import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import (batch_sharding, distribute,
                                         opt_sharding, params_sharding)
from repro_torch.models.common import use_mesh
from repro_torch.models.convert import init_numpy
from repro_torch.models.model import LM
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.runner import RunnerConfig, Trainer
from repro_torch.train.step import make_train_step


def init_group(device=None) -> torch.device:
    """Join the launcher's process group (``RANK``/``WORLD_SIZE`` set) or
    start a one-rank group; returns this rank's device (``None``: its
    GPU, ``LOCAL_RANK`` under a launcher)."""
    import torch.distributed as dist
    if device is None and torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dev


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=configs.list_archs())
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--pod", type=int, default=1)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_train_ckpt in the temp dir")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10,
                    help="print the loss and step time every N steps")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_train_ckpt")

    import torch.distributed as dist
    cfg = configs.get_config(args.arch, smoke=args.smoke)
    dev = init_group(args.device)
    try:
        mesh = make_mesh(args.data, args.model, args.pod,
                         device_type=dev.type)
        model = LM(cfg, dev)
        opt_cfg = opt_mod.OptConfig(lr=args.lr, warmup_steps=10,
                                    total_steps=args.steps)
        dcfg = data_mod.DataConfig(
            global_batch=args.batch, seq_len=args.seq, vocab=cfg.vocab,
            path=args.data_path,
            src_len=args.seq if cfg.is_encdec else None,
            d_model=cfg.d_model if cfg.is_encdec else None)
        pipe = data_mod.Pipeline(dcfg, device=dev)

        params = init_numpy(cfg, 0, dev)
        opt_state = opt_mod.init(params, opt_cfg)
        p_shard = params_sharding(params, mesh)
        opt_state = distribute(opt_state,
                               opt_sharding(opt_state, p_shard, mesh), mesh)
        params = distribute(params, p_shard, mesh)
        step = make_train_step(model, opt_cfg, accum=args.accum)

        def mesh_step(p, o, b):
            b = distribute(b, batch_sharding(b, mesh), mesh)
            with use_mesh(mesh):
                return step(p, o, b)

        start = 0
        latest = ckpt_mod.latest_step(ckpt_dir)
        trainer = Trainer(
            RunnerConfig(total_steps=args.steps,
                         ckpt_every=args.ckpt_every, ckpt_dir=ckpt_dir,
                         log_every=args.log_every),
            mesh_step, params, opt_state, pipe)
        if latest is not None:
            start = trainer._restore()
            print(f"resuming from step {start}")
        end, metrics = trainer.run(start)
        print(f"finished at step {end}: {metrics}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
