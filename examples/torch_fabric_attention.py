"""An attention score matmul scheduled across a Compute RAM block grid,
on the PyTorch port.

The paper's fabric-level story (§IV/§V) end-to-end: quantized q/k from
the attention layer layout, tiled over a grid of blocks (storage vs
compute mode allocation), executed exactly on the cycle-accurate block
simulator, and accounted with the paper's energy/timing methodology.
The counterpart of ``examples/fabric_attention.py``; prints the same
lines.  Every int4 round on the GPU folds through the ``lane_fold``
kernel.

Run:  PYTHONPATH=src python examples/torch_fabric_attention.py [--device cpu]
      (the default device is the GPU; it raises when there is none)
"""

import argparse

import numpy as np

from repro_torch.core.engine import resolve_device
from repro_torch.pim import (FabricConfig, fabric_fused_matmul,
                             fabric_matmul, residency_stats, search_schedule)
from repro_torch.pim.fabric import combine_costs, fabric_attention_scores


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # -- a quantized GEMM on a 16-block grid --------------------------------
    cfg = FabricConfig(n_blocks=16)
    x = rng.integers(-8, 8, (4, 96)).astype(np.int64)      # int4 activations
    w = rng.integers(-8, 8, (96, 64)).astype(np.int64)     # int4 weights
    res = fabric_matmul(x, w, nbits=4, cfg=cfg, signed=True, device=dev)
    assert (res.out == x @ w).all()
    print(res.schedule.describe())
    rep = res.cost.report()
    print(f"  exact int4 GEMM: {rep['energy_pj']:.0f} pJ "
          f"({rep['energy_compute_pj']:.0f} compute / "
          f"{rep['energy_storage_pj']:.0f} storage / "
          f"{rep['energy_wire_pj']:.0f} wire), "
          f"{rep['time_us']:.1f} us, {rep['gops']:.3f} GOPS")
    # the wire split is hop-priced: every load/broadcast/drain is billed
    # by the Manhattan distance between its actual block sites
    print(f"  hop-priced wires: {rep['fabric_bit_mm']:.0f} bit*mm fabric "
          f"+ {rep['spill_bit_mm']:.0f} bit*mm spill "
          f"(avg net {rep['avg_hop_mm']:.2f} mm on the "
          f"{cfg.grid_rows}x{cfg.grid_cols} grid) "
          f"-> {rep['energy_wire_pj']:.0f} pJ")
    # serial vs overlapped: round i+1's loads double-buffer against
    # round i's compute (docs/fabric.md, "Overlapped rounds")
    print(f"  latency: serial {rep['serial_cycles']:.0f} cyc "
          f"({rep['time_us']:.1f} us) -> overlapped "
          f"{rep['overlapped_cycles']:.0f} cyc "
          f"({rep['time_us_overlapped']:.1f} us), "
          f"{rep['overlap_speedup']:.2f}x\n")

    # -- the schedule autotuner picks the grid split + placement ------------
    sr = search_schedule(x.shape[0], x.shape[1], w.shape[1], 4,
                         base=cfg, signed=True)
    print(sr.describe())
    print(sr.candidate_table())
    tuned = sr.cost.report()
    print(f"  autotuned: {tuned['overlapped_cycles']:.0f} overlapped cyc "
          f"vs default {rep['overlapped_cycles']:.0f} "
          f"({rep['overlapped_cycles'] / tuned['overlapped_cycles']:.2f}x)"
          "\n")

    # -- fused QKV: one FabricProgram, shared activation residency ----------
    wq = rng.integers(-8, 8, (96, 32)).astype(np.int64)
    wk = rng.integers(-8, 8, (96, 32)).astype(np.int64)
    wv = rng.integers(-8, 8, (96, 32)).astype(np.int64)
    fused = fabric_fused_matmul(x, (wq, wk, wv), nbits=4, cfg=cfg,
                                signed=True, names=("q", "k", "v"),
                                device=dev)
    for out, wi in zip(fused.outs, (wq, wk, wv)):
        assert (out == x @ wi).all()
    print(fused.schedule.describe())
    st = residency_stats(fused.schedule)
    frep = fused.cost.report()
    print(f"  fused QKV: {st['fetches']} fetches for {st['reads']} tile "
          f"reads ({st['fetch_reduction']:.2f}x fewer than reload), "
          f"{frep['energy_wire_pj']:.0f} pJ wire\n")

    # -- attention scores: q @ k^T per (batch, head) ------------------------
    B, Sq, Sk, H, hd = 1, 8, 8, 2, 32
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, H, hd)).astype(np.float32)
    scores, _, costs = fabric_attention_scores(q, k, cfg=cfg, bits=8,
                                               device=dev)
    ref = np.einsum("bqhd,bchd->bqhc", q, k) * hd ** -0.5
    err = np.abs(scores - ref).max()
    total = combine_costs("attention_scores", costs)
    rep = total.report()
    print(f"attention scores {q.shape} x {k.shape} on "
          f"{cfg.n_blocks} blocks: max |err| {err:.4f} (int8 quant)")
    print(f"  {rep['rounds']} rounds, {rep['ops']} MACs, "
          f"{rep['energy_pj']:.0f} pJ, {rep['time_us']:.1f} us, "
          f"{rep['energy_per_op_pj']:.2f} pJ/MAC")
    return {"gemm_exact": True, "fused_exact": True,
            "scores_max_abs_err": float(err)}


if __name__ == "__main__":
    main()
