"""Perf hillclimb: trace a cell with optimization overrides and
record its measurements per iteration.

The counterpart of ``repro.launch.perf``, with its plans, over
``dryrun.lower_cell``.

Usage: python -m repro_torch.launch.perf [--cell granite_moe_train]
       [--device cpu]
"""

import argparse
import json
import pathlib
import traceback

# iteration plans: (cell tag, arch, shape, [(iter name, overrides), ...])
PLANS = {
    "granite_moe_train": (
        "granite-moe-3b-a800m", "train_4k", [
            ("it0_baseline", {}),
            ("it1_chunked_dispatch", {"moe.dispatch_chunks": 32}),
            ("it2_chunked_cf1", {"moe.dispatch_chunks": 32,
                                 "moe.capacity_factor": 1.0}),
        ]),
    "granite_moe_decode": (
        "granite-moe-3b-a800m", "decode_32k", [
            ("it0_baseline", {}),
            ("it1_kv_int8", {"kv_quant_bits": 8}),
            ("it2_kv_int8_w8", {"kv_quant_bits": 8, "wq_bits": 8}),
            ("it3_kv_int8_w8_chunked", {"kv_quant_bits": 8, "wq_bits": 8,
                                        "moe.dispatch_chunks": 8}),
        ]),
    "chameleon_decode": (
        "chameleon-34b", "decode_32k", [
            ("it0_baseline", {}),
            ("it1_kv_int8", {"kv_quant_bits": 8}),
            ("it2_kv_int8_w8", {"kv_quant_bits": 8, "wq_bits": 8}),
            ("it3_kv_int8_w4planes", {"kv_quant_bits": 8, "wq_bits": 4}),
            ("it4_kv_int4_w4planes", {"kv_quant_bits": 4, "wq_bits": 4}),
        ]),
    # compute-bound cell: remat-policy trade (recompute FLOPs vs memory)
    "chameleon_train": (
        "chameleon-34b", "train_4k", [
            ("it0_baseline_full_remat", {}),
            ("it1_dots_remat", {"remat_policy": "dots"}),
            ("it2_no_remat", {"remat_policy": "none"}),
        ]),
    # bonus: same dispatch fix on the other MoE cell
    "mixtral_prefill": (
        "mixtral-8x7b", "prefill_32k", [
            ("it0_baseline", {}),
            ("it1_chunked_dispatch", {"moe.dispatch_chunks": 32}),
        ]),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=sorted(PLANS), default=None)
    ap.add_argument("--out", default="results/perf")
    ap.add_argument("--device", default=None,
                    help="device type of the fake tensors (default: the "
                         "GPU)")
    args = ap.parse_args(argv)

    from repro_torch.core.engine import resolve_device
    from repro_torch.launch.dryrun import lower_cell
    dev = resolve_device(args.device)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    cells = [args.cell] if args.cell else sorted(PLANS)
    for cell in cells:
        arch, shape, iters = PLANS[cell]
        for name, overrides in iters:
            fp = out / f"{cell}__{name}.json"
            if fp.exists():
                print(f"[skip] {cell}/{name}")
                continue
            print(f"[perf] {cell}/{name} ...", flush=True)
            try:
                res = lower_cell(arch, shape, multi_pod=False,
                                 opt_overrides=overrides, device=dev)
                res["iteration"] = name
                res["overrides"] = overrides
            except Exception as e:                     # noqa: BLE001
                res = {"iteration": name, "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-3000:]}
            fp.write_text(json.dumps(res, indent=1))
            print(f"[done] {cell}/{name}: {res['status']}", flush=True)


if __name__ == "__main__":
    main()
