"""PIM matmul as a framework feature on the PyTorch port: store weights
bit-plane packed (storage mode), compute directly on the packed planes
(compute mode).

The counterpart of ``examples/pim_matmul.py``; prints the same lines.
On the GPU the packed linears run the ``quant_matmul`` and
``popcount_matmul`` kernels and ``cram_matmul``'s int4 blocks fold
through ``lane_fold``.  The weights and activations are drawn from
seeded ``torch.Generator``s (``jax.random`` cannot be reproduced);
:func:`run` takes them as arguments, so any others can be passed in.

Run:  PYTHONPATH=src python examples/torch_pim_matmul.py [--device cpu]
      (the default device is the GPU; it raises when there is none)
"""

import argparse

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.pim import (PimConfig, cram_matmul, linear_apply,
                             linear_init, pack_linear)


def run(dense: dict, x: torch.Tensor) -> dict:
    """The example on the dense bf16 weights ``dense["w"]`` ``(d_in,
    d_out)`` and activations ``x`` ``(M, d_in)``, on their device."""
    d_in, d_out = dense["w"].shape
    y_ref = linear_apply(dense, x, PimConfig(mode="off"))
    print(f"dense bf16 weights: {d_in * d_out * 2:,} bytes in HBM")
    out = {"dense_bytes": d_in * d_out * 2, "packed": {}}

    for bits in (8, 4):
        cfg = PimConfig(mode="pallas", weight_bits=bits)
        packed = pack_linear(dense, cfg)
        nbytes = packed["w_packed"].numel() * 4
        y = linear_apply(packed, x, cfg)
        err = float(torch.mean(torch.abs(
            y.to(torch.float32) - y_ref.to(torch.float32))))
        mag = float(torch.mean(torch.abs(y_ref.to(torch.float32))))
        print(f"W{bits}A8 bit-plane packed: {nbytes:,} bytes "
              f"({d_in * d_out * 2 / nbytes:.1f}x less traffic), "
              f"rel.err {err / mag:.4f}")
        out["packed"][bits] = {"bytes": nbytes, "rel_err": err / mag}

    # PIM-faithful popcount path == same math
    cfg = PimConfig(mode="popcount", weight_bits=4)
    packed = pack_linear(dense, cfg)
    y_pc = linear_apply(packed, x, cfg)
    cfg_ref = PimConfig(mode="ref", weight_bits=4)
    y_rf = linear_apply(packed, x, cfg_ref)
    diff = float(torch.max(torch.abs(y_pc.to(torch.float32)
                                     - y_rf.to(torch.float32))))
    print(f"popcount (AND/popcount bit-serial) vs ref path: "
          f"max diff {diff:.2e} (exact integer arithmetic)")
    out["popcount_vs_ref"] = diff

    # ... and the same arithmetic on the cycle-accurate Compute RAM
    # block simulator itself (idot programs, compiled executor)
    rng = np.random.default_rng(0)
    xi = rng.integers(0, 16, (4, 24), dtype=np.uint64)
    wi = rng.integers(0, 16, (24, 40), dtype=np.uint64)
    yi = cram_matmul(xi, wi, n=4, device=x.device)
    assert (yi == xi @ wi).all()
    print(f"cram_matmul: {xi.shape} @ {wi.shape} int4 GEMM executed "
          f"cycle-accurately on simulated Compute RAM blocks -- exact")
    out["cram_exact"] = True
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    d_in, d_out = 512, 256
    dense = linear_init(torch.Generator().manual_seed(0), d_in, d_out,
                        PimConfig(), device=dev)
    x = torch.randn((16, d_in), generator=torch.Generator().manual_seed(1))
    return run(dense, x.to(device=dev, dtype=torch.bfloat16))


if __name__ == "__main__":
    main()
