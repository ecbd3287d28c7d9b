"""Quickstart on the PyTorch port: program a Compute RAM block and run it
(paper's Fig 2 flow).

1. storage mode: load operands (transposed bit-plane layout)
2. load an instruction sequence into the instruction memory
3. compute mode: the controller executes the sequence; every column
   computes in parallel
4. storage mode: read results back

The counterpart of ``examples/quickstart.py``; prints the same lines.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
      (the default device is the GPU; it raises when there is none)
"""

import argparse

import numpy as np

from repro_torch.core import costmodel, engine, harness, isa, programs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    dev = engine.resolve_device(args.device)
    rng = np.random.default_rng(0)

    # --- int8 addition on a 512x40 block -------------------------------
    prog, layout = programs.iadd(8, rows=512)
    print(f"program: {prog.name}")
    print(f"  instruction-memory footprint: {prog.footprint()} / "
          f"{isa.IMEM_SLOTS} slots")
    print(f"  cycles: {prog.cycles()} for {layout.tuples} adds/column "
          f"x 40 columns = {layout.tuples * 40} ops")

    a = rng.integers(0, 256, (layout.tuples, 40), dtype=np.uint64)
    b = rng.integers(0, 256, (layout.tuples, 40), dtype=np.uint64)

    arr = harness.pack_state(layout, {"a": a, "b": b}, cols=40)  # storage
    state = harness.make_torch_state(arr, dev)
    out = engine.execute_scan(prog, state)                       # compute
    d = harness.unpack_field(out.array.cpu().numpy(), layout, "d")

    assert (d == (a + b) % 256).all()
    print(f"  all {layout.tuples * 40} results correct "
          f"(e.g. {a[0, 0]} + {b[0, 0]} = {d[0, 0]})")

    # --- adaptable precision: same block, new program -> bfloat16 -------
    prog16, lay16 = programs.bf16_mul(rows=512, tuples=2)
    fa = np.asarray([1.5, -2.25], np.float32)
    fb = np.asarray([3.0, 0.5], np.float32)
    bits_a = np.tile((fa.view(np.uint32) >> 16).astype(np.uint16)[:, None],
                     (1, 8))
    bits_b = np.tile((fb.view(np.uint32) >> 16).astype(np.uint16)[:, None],
                     (1, 8))
    arr = harness.pack_state(lay16, {"a": bits_a, "b": bits_b}, cols=8)
    out = engine.execute_scan(prog16, harness.make_torch_state(arr, dev))
    dd = harness.unpack_field(out.array.cpu().numpy(), lay16, "d")
    vals = (dd.astype(np.uint32) << 16).view(np.float32)[:, 0]
    assert vals.tolist() == (fa * fb).tolist()
    print("\nbfloat16 via new instruction sequence (no new hardware):")
    print(f"  {fa[0]} * {fb[0]} = {vals[0]},  {fa[1]} * {fb[1]} = {vals[1]}")

    # --- the paper's headline comparison --------------------------------
    print("\nbaseline FPGA vs Compute RAM (paper Fig 4, int8 add):")
    r = costmodel.compare("add", "int8")
    print(f"  energy: {r['energy_ratio']:.0%} of baseline")
    print(f"  time:   {r['time_ratio']:.0%} of baseline")
    print(f"  circuit frequency: +{r['freq_gain']:.0%}")
    return {"int8_add_results": int(d.size), "bf16_products": vals.tolist(),
            "compare": r}


if __name__ == "__main__":
    main()
