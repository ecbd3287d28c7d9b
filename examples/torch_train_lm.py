"""End-to-end training example on the PyTorch port: train a small
llama-family model on synthetic data with checkpointing, kill it
mid-run, and watch it resume from the latest checkpoint.

The counterpart of ``examples/train_lm.py``; prints the same lines (the
step times and checkpoint paths aside).  The weights are drawn from a
seeded numpy Generator (``LM.init``; ``jax.random`` cannot be
reproduced): :func:`train` takes any params tree of the port, such as
the JAX example's carried across by ``models.convert.params_from_numpy``.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]
      PYTHONPATH=src python examples/torch_train_lm.py --preset 100m \
          --steps 300
      (the default device is the GPU; it raises when there is none)
"""

import argparse
import os
import shutil
import tempfile

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models.model import LM
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.runner import RunnerConfig, Trainer
from repro_torch.train.step import jit_train_step

PRESETS = {
    # ~8M params: fast on CPU
    "tiny": ModelConfig(name="tiny-lm", family="dense", n_layers=4,
                        d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
                        vocab=2048, tie_embeddings=True),
    # ~100M params: the paper-scale end-to-end target (use on real HW)
    "100m": ModelConfig(name="lm-100m", family="dense", n_layers=12,
                        d_model=768, n_heads=12, n_kv_heads=4, d_ff=3072,
                        vocab=32000, tie_embeddings=True),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="tiny", choices=PRESETS)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_example_ckpt"))
    ap.add_argument("--simulate-failure", action="store_true",
                    default=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    return ap.parse_args(argv)


def train(model, params, args, log=print) -> dict:
    """Train ``params`` (the port's tree of ``model``) for ``args.steps``
    steps with one simulated node failure at 60% of the run."""
    cfg = model.cfg
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    opt_cfg = opt_mod.OptConfig(lr=3e-3, warmup_steps=10,
                                total_steps=args.steps)
    opt_state = opt_mod.init(params, opt_cfg)
    pipe = data_mod.Pipeline(data_mod.DataConfig(
        global_batch=args.batch, seq_len=args.seq, vocab=cfg.vocab),
        device=model.device)
    step_fn = jit_train_step(model, opt_cfg)

    # inject one simulated node failure at 60% of the run
    fail_at = int(args.steps * 0.6)
    armed = {"on": args.simulate_failure}

    def fail_hook(step):
        if step == fail_at and armed["on"]:
            armed["on"] = False
            raise RuntimeError("simulated node failure (example)")

    trainer = Trainer(
        RunnerConfig(total_steps=args.steps, ckpt_every=20,
                     ckpt_dir=args.ckpt_dir, log_every=10),
        step_fn, params, opt_state, pipe, fail_hook=fail_hook, log=log)
    end, metrics = trainer.run()
    print(f"done at step {end}; final loss {metrics['loss']:.4f}; "
          f"restarts={trainer.restarts}")
    return {"end": end, "metrics": metrics, "restarts": trainer.restarts,
            "step_times": trainer.step_times}


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = PRESETS[args.preset]
    model = LM(cfg, dev)
    print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params")
    params = model.init(np.random.default_rng(0))
    return train(model, params, args)


if __name__ == "__main__":
    main()
