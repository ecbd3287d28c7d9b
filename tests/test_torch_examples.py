"""The port's examples against the JAX package's, on the CPU.

Each ``examples/torch_*.py`` runs with ``--device cpu`` (its plain path)
beside its counterpart in ``examples/``.  The numpy-seeded examples
(quickstart, fabric attention) must print the same lines; the others
take the JAX example's own weights (``linear_init`` / ``LM.init`` under
``jax.random``, carried across as numpy) through the function each port
example exposes for that, and are held to the reference's printed
numbers.
"""

import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.models import convert  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.pim import params_from_numpy  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _run_ref(capsys, name, argv=()):
    """The JAX example's ``main()`` with ``argv``; its stdout lines."""
    mod = _load(name)
    old = sys.argv
    sys.argv = [name, *argv]
    try:
        capsys.readouterr()
        mod.main()
    finally:
        sys.argv = old
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("name", ["quickstart", "fabric_attention"])
def test_numpy_seeded_examples_print_the_reference_lines(capsys, name):
    want = _run_ref(capsys, name)
    _load(f"torch_{name}").main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(want) > 5
    assert got == want


def test_examples_refuse_to_run_without_a_gpu(monkeypatch):
    """Each example's default device is the GPU: without one it raises
    before computing anything instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("quickstart", "pim_matmul", "fabric_attention",
                 "serve_lm", "train_lm"):
        with pytest.raises(RuntimeError, match="CUDA"):
            _load(f"torch_{name}").main([])


#: rel.err of a packed linear: the port's value against the reference's
#: printed one (4 decimals) differs by the printing's rounding (5e-5)
#: plus the float32 order of the scales' and the mean's sums (measured
#: on the CPU: 0.0099486 and 0.1311909 against 0.0099 and 0.1312)
REL_ERR_TOL = 2e-4


def test_pim_matmul_on_the_jax_examples_weights(capsys):
    from repro.pim import PimConfig, linear_init

    lines = _run_ref(capsys, "pim_matmul")
    dense = linear_init(jax.random.PRNGKey(0), 512, 256, PimConfig())
    x = jax.random.normal(jax.random.PRNGKey(1), (16, 512), jnp.bfloat16)
    got = _load("torch_pim_matmul").run(
        params_from_numpy(_np_tree(dense), "cpu"),
        params_from_numpy(np.asarray(x), "cpu"))
    out = capsys.readouterr().out.splitlines()
    assert out[0] == lines[0]
    assert got["dense_bytes"] == int(re.search(
        r"([\d,]+) bytes", lines[0]).group(1).replace(",", ""))
    for bits, line in zip((8, 4), lines[1:3]):
        nbytes, err = re.search(r"([\d,]+) bytes .* rel\.err ([\d.]+)",
                                line).groups()
        assert got["packed"][bits]["bytes"] == int(nbytes.replace(",", ""))
        assert abs(got["packed"][bits]["rel_err"] - float(err)) \
            <= REL_ERR_TOL, (bits, got["packed"][bits], line)
    assert "max diff 0.00e+00" in lines[3]
    assert got["popcount_vs_ref"] == 0.0
    assert got["cram_exact"] and out[4] == lines[4]


#: greedy chains of the smoke-width llama under bf16: the port's eager
#: ops round every intermediate, the JAX example's jit keeps fused
#: chains in float32, so once two logits come within that rounding a
#: chain may part and stays parted.  Measured agreement over the 48
#: generated tokens: 48 / 48; the bound leaves room for one near-tie.
SERVE_MIN_AGREE = 40


def test_serve_lm_on_the_jax_examples_params(capsys):
    from repro import configs as ref_configs
    from repro.models.model import LM as RefLM

    lines = _run_ref(capsys, "serve_lm")
    cfg = ref_configs.get_config("llama3.2-1b", smoke=True)
    params = RefLM(cfg).init(jax.random.PRNGKey(0))
    got = _load("torch_serve_lm").run(
        convert.params_from_numpy(_np_tree(params), "cpu"), "cpu")
    capsys.readouterr()
    want = {}
    for line in lines:
        m = re.match(r"req (\d+): prompt=(\[.*\]) -> (\[.*\])", line)
        if m:
            want[int(m.group(1))] = eval(m.group(3))      # a list of ints
    assert sorted(want) == sorted(got["outs"]) == list(range(6))
    for rid, chain in want.items():
        assert got["outs"][rid][0] == chain[0], rid
    agree = sum(a == b for rid in want
                for a, b in zip(got["outs"][rid], want[rid]))
    assert agree >= SERVE_MIN_AGREE, (agree, got["outs"], want)
    a, b = re.search(r"storage-mode weights: ([\d,]+) -> ([\d,]+)",
                     "\n".join(lines)).groups()
    assert got["bytes"] == (int(a.replace(",", "")),
                            int(b.replace(",", "")))


def test_train_lm_on_the_jax_examples_params(capsys, tmp_path):
    """40 steps of 2 x 32 tokens with the failure at step 24: the same
    losses at every logged step (within 0.05; measured on the CPU at
    most 0.0028 apart, the two frameworks' bf16 roundings), one restart
    and the same final step on both sides."""
    lines = _run_ref(capsys, "train_lm", [
        "--steps", "40", "--batch", "2", "--seq", "32",
        "--ckpt-dir", str(tmp_path / "ref")])
    ex = _load("torch_train_lm")
    args = ex.parse_args(["--steps", "40", "--batch", "2", "--seq", "32",
                          "--ckpt-dir", str(tmp_path / "port"),
                          "--device", "cpu"])
    from repro.models.model import LM as RefLM

    cfg = ex.PRESETS[args.preset]
    ref_params = RefLM(_load("train_lm").PRESETS[args.preset]).init(
        jax.random.PRNGKey(0))
    model = LM(cfg, "cpu")
    logged = []
    got = ex.train(model, convert.params_from_numpy(_np_tree(ref_params),
                                                    "cpu"),
                   args, log=logged.append)
    capsys.readouterr()

    def losses(text):
        return [(int(s), float(v)) for s, v in
                re.findall(r"\[train\] step (\d+) loss ([\d.]+)", text)]

    want = losses("\n".join(lines))
    have = losses("\n".join(logged))
    assert [s for s, _ in have] == [s for s, _ in want] == [10, 20, 30, 40]
    for (s, a), (_, b) in zip(have, want):
        assert abs(a - b) <= 0.05, (s, a, b)
    end, restarts = re.search(r"done at step (\d+); .* restarts=(\d+)",
                              "\n".join(lines)).groups()
    assert got["restarts"] == int(restarts) == 1
    assert got["end"] == int(end) == 40
    assert any("[fault] step 24" in ln for ln in logged)


def test_smoke_cse_and_examples_phases_on_the_cpu(monkeypatch):
    """``chip_smoke.phase_cse`` (2 blocks, two of its programs) and
    ``phase_examples`` (train_lm at its tiny preset, 40 steps of 2 x 32)
    on the CPU, with counting stand-ins for the kernel wrappers and the
    fold's kernel route forced: their checks pass, no CSE trace falls
    back, and each example's launches are counted."""
    from repro_torch.core import engine
    from repro_torch.kernels import bitplane_ops as bp
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import flash_attention as fa

    sys.path.insert(0, str(EXAMPLES.parent))
    import chip_smoke

    def counting(fn, name):
        def w(*a, **k):
            w.launches += 1
            return fn(*a, **k)
        w.launches, w.__name__ = 0, name
        return w

    def fold(x, width):
        return torch.stack([torch.zeros_like(x[0, 0]) if p is None else p
                            for p in bp.lane_fold_torch(list(x), width)])

    monkeypatch.setattr(bp, "lane_fold_cuda",
                        counting(fold, "lane_fold_cuda"))
    monkeypatch.setattr(bp, "use_kernel_fold", lambda device, packed: packed)
    for mod, name, plain in ((bsm, "quant_matmul", bsm.quant_matmul_torch),
                             (bsm, "popcount_matmul",
                              bsm.popcount_matmul_torch),
                             (fa, "flash_attention",
                              fa.flash_attention_torch)):
        monkeypatch.setattr(mod, f"{name}_cuda",
                            counting(plain, f"{name}_cuda"))
    monkeypatch.setattr(bsm, "_device_of", lambda *xs: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda fn, reps=50, warmup=5: (fn(), 0.0)[1])
    progs = {k: chip_smoke.CSE_PROGRAMS[k] for k in ("idot4x58",
                                                     "bf16_mul x8")}
    engine.clear_compile_cache()
    out = chip_smoke.cse_checked(chip_smoke.phase_cse,
                                 np.random.default_rng(0), "cpu", 2, progs)
    assert out["idot4x58"]["lane_fold_nodes"] == 1
    assert out["idot4x58"]["removed"] > 0 and out["bf16_mul x8"]["removed"]
    assert chip_smoke.CSE_TRACED["phase_cse"] == 4

    real = engine.resolve_device
    monkeypatch.setattr(engine, "resolve_device",
                        lambda d=None: real("cpu" if d is None else d))
    args = dict(chip_smoke.EXAMPLE_ARGS)
    args["torch_train_lm"] = ("--steps", "40", "--batch", "2", "--seq",
                              "32")
    ex = chip_smoke.cse_checked(chip_smoke.phase_examples, args)
    assert ex["torch_pim_matmul"]["launches"] == {
        "lane_fold": 1, "quant_matmul": 2, "popcount_matmul": 1,
        "flash_attention": 0}
    assert ex["torch_fabric_attention"]["launches"]["lane_fold"] == 2
    assert ex["torch_train_lm"]["restarts"] == 1
    assert all(ex[k]["same_lines_as_cpu"] for k in chip_smoke.EXAMPLES_EXACT)
