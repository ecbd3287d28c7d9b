"""Training entry point on one card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --full --steps 8 --batch 4 --seq 256

The counterpart of ``repro.launch.train``, with its flags and ``--device``
(default: the GPU; ``--device cpu`` runs on the host).  ``--smoke`` (the
default) uses the reduced config, ``--full`` the published one.  Params
are drawn from a seeded numpy Generator (``models.convert.init_numpy``,
seed 0).  Fault tolerance: restarts from the latest checkpoint in
``--ckpt-dir`` automatically.  The port trains on one device:
``--data``, ``--model`` and ``--pod`` other than 1 need the mesh and
sharding of the launch slice, which is not ported yet.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch import configs
from repro_torch.core.engine import resolve_device
from repro_torch.models.convert import init_numpy
from repro_torch.models.model import LM
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.runner import RunnerConfig, Trainer
from repro_torch.train.step import make_train_step


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
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    if (args.data, args.model, args.pod) != (1, 1, 1):
        ap.error("--data/--model/--pod other than 1 need a device mesh, "
                 "which comes with the launch slice of the port (not "
                 "ported yet); this entry point trains on one device")
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_train_ckpt")

    cfg = configs.get_config(args.arch, smoke=args.smoke)
    dev = resolve_device(args.device)
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
    step = make_train_step(model, opt_cfg, accum=args.accum)

    start = 0
    latest = ckpt_mod.latest_step(ckpt_dir)
    trainer = Trainer(
        RunnerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                     ckpt_dir=ckpt_dir),
        step, params, opt_state, pipe)
    if latest is not None:
        start = trainer._restore()
        print(f"resuming from step {start}")
    end, metrics = trainer.run(start)
    print(f"finished at step {end}: {metrics}")


if __name__ == "__main__":
    main()
