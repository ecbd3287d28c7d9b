"""Worker of ``test_torch_launch.py``'s gloo tests: one rank of a
``torch.distributed`` CPU group training qwen2-0.5b's smoke config on a
(data, model) mesh through the port's launch layer.

Imports torch and the port only, so that each spawned rank starts
quickly.
"""

import json

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import (batch_sharding, distribute,
                                         opt_sharding, params_sharding)
from repro_torch.models.common import use_mesh
from repro_torch.models.convert import init_numpy
from repro_torch.models.model import LM
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.step import make_train_step

#: the elastic scenario's optimizer and batches (tests/elastic_scenario.py)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
DATA = dict(global_batch=4, seq_len=16)


def rank_main(rank, world, port, mesh_shape, in_dir, in_step, lo, hi,
              out_path, save_dir=None, save_at=None):
    """Restore params and AdamW state from ``in_dir`` at ``in_step`` onto
    a ``mesh_shape`` mesh, take steps ``lo`` to ``hi``, checkpoint the
    state after step ``save_at`` into ``save_dir``; rank 0 writes the
    losses to ``out_path`` as JSON."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        cfg = configs.get_config("qwen2-0.5b", smoke=True)
        model = LM(cfg, "cpu")
        mesh = make_mesh(*mesh_shape, device_type="cpu")
        opt_cfg = opt_mod.OptConfig(**OPT)
        pipe = data_mod.Pipeline(data_mod.DataConfig(vocab=cfg.vocab,
                                                     **DATA), device="cpu")
        params = init_numpy(cfg, 0, "cpu")
        opt = opt_mod.init(params, opt_cfg)
        p_shard = params_sharding(params, mesh)
        like = {"params": distribute(params, p_shard, mesh),
                "opt": distribute(opt, opt_sharding(opt, p_shard, mesh),
                                  mesh)}
        state, _ = ckpt.restore(in_dir, like, step=in_step)
        params, opt = state["params"], state["opt"]
        step = make_train_step(model, opt_cfg)
        losses = []
        for s in range(lo, hi):
            batch = pipe.batch(s)
            batch = distribute(batch, batch_sharding(batch, mesh), mesh)
            with use_mesh(mesh):
                params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            if s + 1 == save_at:
                ckpt.save(save_dir, save_at, {"params": params, "opt": opt})
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(losses, f)
    finally:
        dist.destroy_process_group()
