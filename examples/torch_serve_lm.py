"""Serving example on the PyTorch port: batched requests through the
slot-based engine, optionally with PIM-packed (int8 storage-mode)
weights.

The counterpart of ``examples/serve_lm.py``; prints the same lines.  The
weights are drawn from a seeded numpy Generator
(``convert.init_numpy``; ``jax.random`` cannot be reproduced): :func:`run`
takes any params tree of the port, such as the JAX example's carried
across by ``models.convert.params_from_numpy``.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
      (the default device is the GPU; it raises when there is none)
"""

import argparse

import numpy as np

from repro_torch import configs
from repro_torch.core.engine import resolve_device
from repro_torch.models.convert import init_numpy
from repro_torch.models.model import LM
from repro_torch.models.qweight import quantize_tree, tree_bytes
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "llama3.2-1b"


def run(params, device) -> dict:
    """Serve the example's six requests on ``params`` (the port's tree
    of ``LM(get_config(ARCH, smoke=True))``), then three of them on the
    int8 storage-mode weights."""
    cfg = configs.get_config(ARCH, smoke=True)
    model = LM(cfg, device)

    eng = ServeEngine(model, params, batch_slots=4, capacity=64,
                      device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(3, 9)).astype(
        np.int32) for _ in range(6)]
    for i, p in enumerate(prompts):
        eng.add(Request(rid=i, prompt=p, max_new=8))

    done = eng.run()
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt={[int(t) for t in r.prompt]} -> {r.out}")
    print(f"{len(done)} requests served through {eng.B} slots "
          f"(continuous batching)")

    # --- same engine, PIM storage-mode weights (int8 "compute RAM" style)
    qparams = quantize_tree(params, bits=8)
    print(f"\nstorage-mode weights: {tree_bytes(params):,} -> "
          f"{tree_bytes(qparams):,} bytes")
    eng_q = ServeEngine(model, qparams, batch_slots=4, capacity=64,
                        device=device)
    for i, p in enumerate(prompts[:3]):
        eng_q.add(Request(rid=i, prompt=p, max_new=8))
    done_q = {r.rid: r.out for r in eng_q.run()}
    ref = {r.rid: r.out for r in done}
    agree = sum(sum(a == b for a, b in zip(done_q[i], ref[i]))
                for i in done_q)
    total = sum(len(done_q[i]) for i in done_q)
    print(f"w8-served tokens matching bf16: {agree}/{total} "
          f"(greedy decode is sensitive on a random-init model)")
    return {"outs": ref, "outs_w8": done_q,
            "bytes": (tree_bytes(params), tree_bytes(qparams)),
            "w8_agree": (agree, total)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params = init_numpy(configs.get_config(ARCH, smoke=True), 0, dev)
    return run(params, dev)


if __name__ == "__main__":
    main()
