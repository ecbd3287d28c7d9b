"""Worker of ``test_torch_train.py``'s gloo test: one rank of a
``torch.distributed`` CPU group running the port's ``compressed_psum``
and ``make_compressed_grad_fn`` on its shard.

Imports torch and the port only, so that each spawned rank starts
quickly.
"""

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.train.compress import (compressed_psum,
                                        make_compressed_grad_fn)


def regression_loss(params, batch):
    """``test_train.py::test_compressed_gradient_allreduce``'s loss."""
    pred = batch["x"] @ params["w"]
    return torch.mean((pred - batch["y"]) ** 2)


def bf16_bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


def rank_main(rank, world, port, in_path, out_path):
    """Reduce this rank's shard of ``in_path``'s arrays over the group;
    write the results to ``out_path``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        data = np.load(in_path)
        grads = {"w": torch.from_numpy(data["w"][rank]),
                 "b": {"h": torch.from_numpy(
                     data["h_bits"][rank].view(np.int16)).view(
                         torch.bfloat16)}}
        summed = compressed_psum(grads, dist.group.WORLD)
        per = data["x"].shape[0] // world
        rows = slice(rank * per, (rank + 1) * per)
        params = {"w": torch.from_numpy(data["p"])}
        batch = {"x": torch.from_numpy(data["x"][rows]),
                 "y": torch.from_numpy(data["y"][rows])}
        loss, g = make_compressed_grad_fn(regression_loss,
                                          dist.group.WORLD)(params, batch)
        np.savez(out_path, w=summed["w"].numpy(),
                 h_bits=bf16_bits(summed["b"]["h"]), loss=loss.numpy(),
                 grad=g["w"].numpy())
    finally:
        dist.destroy_process_group()
