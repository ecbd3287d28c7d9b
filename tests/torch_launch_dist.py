"""Workers of ``test_torch_launch.py``'s gloo tests: one rank of a
``torch.distributed`` CPU group training qwen2-0.5b's smoke config on a
(data, model) mesh through the port's launch layer, or running the
vocab-parallel embedding lookup and loss beside their plain versions.

Imports torch and the port only, so that each spawned rank starts
quickly.
"""

import json

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import (batch_sharding, distribute,
                                         opt_sharding, params_sharding)
from repro_torch.models import model as model_mod
from repro_torch.models.common import shard, split_on, use_mesh
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


#: the vocab-parallel checks' shapes: batch, positions, vocabulary, width
VOCAB = dict(batch=4, seq=16, vocab=256, width=64)


def vocab_inputs(seed=0):
    """Seeded numpy inputs of the vocab-parallel checks: float32 logits
    (B, S - 1, V) and their targets, a bfloat16-exact table (V, D), the
    tokens (B, S) and the upstream gradient of the lookup (B, S, D)."""
    b, s, v, d = (VOCAB[k] for k in ("batch", "seq", "vocab", "width"))
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.standard_normal((v, d), dtype=np.float32))
    return {
        "logits": 3 * rng.standard_normal((b, s - 1, v), dtype=np.float32),
        "targets": rng.integers(0, v, (b, s - 1)),
        "table": table.to(torch.bfloat16).float().numpy(),
        "tokens": rng.integers(0, v, (b, s)).astype(np.int32),
        "grad": rng.standard_normal((b, s, d), dtype=np.float32)}


def vocab_main(rank, world, port, mesh_shape, out_path):
    """On a ``mesh_shape`` mesh: the loss of ``vocab_inputs``' logits and
    its logit gradient through ``model._vocab_parallel_nll`` (logits
    split as ``LM._head`` splits them), and the lookup of its tokens and
    its table gradient through ``model._vocab_parallel_embedding`` (the
    table split as the rules split it); each rank writes its results,
    local shards and placements to ``out_path`` with its rank."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(*mesh_shape, device_type="cpu")
        x = vocab_inputs()
        table_like = torch.empty(x["table"].shape, device="meta")
        with use_mesh(mesh):
            logits = shard(distribute_tensor(
                torch.from_numpy(x["logits"]), mesh,
                [Replicate()] * mesh.ndim), "batch", None, "model")
            targets = shard(distribute_tensor(
                torch.from_numpy(x["targets"]), mesh,
                [Replicate()] * mesh.ndim), "batch", None)
            logits.requires_grad_()
            ax = split_on(logits, "model", -1)
            loss = torch.mean(model_mod._vocab_parallel_nll(
                logits, targets, ax))
            loss.backward()

            table = distribute_tensor(
                torch.from_numpy(x["table"]).to(torch.bfloat16), mesh,
                params_sharding({"embed": table_like}, mesh)["embed"]
                .placements)
            tokens = shard(distribute_tensor(
                torch.from_numpy(x["tokens"]), mesh,
                [Replicate()] * mesh.ndim), "batch", None)
            table.requires_grad_()
            e = shard(model_mod._vocab_parallel_embedding(
                tokens, table, split_on(table, "model", 0)),
                "batch", None, None)
            grad = distribute_tensor(torch.from_numpy(x["grad"]).to(
                torch.bfloat16), mesh, e.placements)
            e.backward(grad)
        out = {
            "rank": rank, "coords": mesh.get_coordinate(),
            "loss": loss.full_tensor().item(),
            "logit_grad": _listed(logits.grad.full_tensor()),
            "lookup": _listed(e.full_tensor()),
            "lookup_placements": [str(p) for p in e.placements],
            "table_grad_local": _listed(table.grad.to_local()),
            "table_grad_placements": [str(p) for p in table.grad.placements],
            "table_grad_full": _listed(table.grad.full_tensor())}
        with open(f"{out_path}.{rank}", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _listed(t):
    """A tensor as nested lists of float32 values (bfloat16 is exact)."""
    return t.detach().float().numpy().tolist()
