"""The port's PIM linear layer against the JAX package's, on the CPU.

Weights are made by the reference (``jax.random``) and carried to the
port with ``params_from_numpy``; activations come from
``numpy.random.default_rng``.  The packed modes (``ref``, ``pallas``,
``popcount``) must be bit-identical to the reference; the dense ``off``
mode is a bf16 matmul on both sides and agrees within one bf16 step.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.models.attention import _repeat_kv  # noqa: E402
from repro.pim import linear as jl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import bitserial_matmul as bsm  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.pim import linear as pl  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

MODES = ["off", "ref", "pallas", "popcount"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits_equal(got, want):
    """bf16 tensor of the port == bf16 array of the reference, bit for
    bit."""
    g = got.view(torch.int16).numpy()
    w = np.asarray(want).view(np.int16)
    assert g.shape == w.shape
    np.testing.assert_array_equal(g, w)


def _x(rng, shape):
    x = jnp.asarray(rng.normal(0, 1, shape).astype(np.float32), jnp.bfloat16)
    return x, pl.params_from_numpy(np.asarray(x), device="cpu")


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("mode", MODES)
def test_linear_apply_matches_reference(mode, bits):
    jc = jl.PimConfig(mode=mode, weight_bits=bits)
    tc = pl.PimConfig(mode=mode, weight_bits=bits)
    dense = jl.linear_init(jax.random.PRNGKey(bits), 128, 64, jc)
    params = dense if mode == "off" else jl.pack_linear(dense, jc)
    xj, xt = _x(np.random.default_rng(600 + bits), (4, 10, 128))
    want = jl.linear_apply(params, xj, jc)
    got = pl.linear_apply(pl.params_from_numpy(_np(params), device="cpu"),
                          xt, tc)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    if mode == "off":
        # bf16 matmul on both sides; the sums may be taken in another order
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=1e-2, atol=1e-2)
    else:
        _bits_equal(got, want)


@pytest.mark.parametrize("bits", [4, 8])
def test_pack_linear_matches_reference(bits):
    jc = jl.PimConfig(mode="pallas", weight_bits=bits)
    dense = jl.linear_init(jax.random.PRNGKey(7), 96, 40, jc)
    want = _np(jl.pack_linear(dense, jc))
    got = pl.pack_linear(pl.params_from_numpy(_np(dense), device="cpu"),
                         pl.PimConfig(mode="pallas", weight_bits=bits))
    np.testing.assert_array_equal(got["w_packed"].numpy().view(np.uint32),
                                  want["w_packed"])
    np.testing.assert_array_equal(got["w_scale"].numpy().view(np.uint32),
                                  want["w_scale"].view(np.uint32))


@pytest.mark.parametrize("mode", ["ref", "pallas", "popcount"])
@pytest.mark.parametrize("bits", [4, 8])
def test_packed_modes_stay_near_dense(mode, bits):
    """The reference's own bound (tests/test_pim_serve.py): mean error
    under 0.15 (W4A8) / 0.03 (W8A8) of the dense result's magnitude."""
    cfg = pl.PimConfig(mode=mode, weight_bits=bits)
    dense = pl.linear_init(torch.Generator().manual_seed(0), 128, 64, cfg,
                           device="cpu")
    packed = pl.pack_linear(dense, cfg)
    x = torch.randn((4, 10, 128), generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    y_dense = pl.linear_apply(dense, x, pl.PimConfig()).float()
    err = (pl.linear_apply(packed, x, cfg).float() - y_dense).abs()
    tol = 0.15 if bits == 4 else 0.03
    assert err.mean() < tol * max(y_dense.abs().mean().item(), 1e-3)


@pytest.mark.parametrize("mode", MODES)
def test_fused_linear_apply_equals_per_layer_calls(mode):
    jc = jl.PimConfig(mode=mode)
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    dims = [(96, 96), (96, 32), (96, 32)]
    layers = [jl.linear_init(kk, i, o, jc) for kk, (i, o) in zip(keys, dims)]
    if mode != "off":
        layers = [jl.pack_linear(p, jc) for p in layers]
    tp = pl.params_from_numpy(_np(layers), device="cpu")
    assert isinstance(tp, list) and len(tp) == 3
    xj, xt = _x(np.random.default_rng(610), (6, 96))
    cfg = pl.PimConfig(mode=mode)
    fused = pl.fused_linear_apply(tp, xt, cfg)
    want = jl.fused_linear_apply(layers, xj, jc)
    assert isinstance(fused, tuple) and len(fused) == 3
    for f, p, w in zip(fused, tp, want):
        assert torch.equal(f.view(torch.int16),
                           pl.linear_apply(p, xt, cfg).view(torch.int16))
        if mode != "off":
            _bits_equal(f, w)


def test_fabric_mode_is_not_ported_yet():
    """Fabric mode equals mode ``ref`` bit for bit, single and fused.
    The name dates from when fabric mode raised, before the fabric's
    execute side was ported; it is kept so the test keeps its id."""
    from repro_torch.pim.fabric import FabricConfig

    grid = FabricConfig(n_blocks=6, rows=128, cols=8)
    cfg = pl.PimConfig(mode="fabric", fabric=grid)
    ref = pl.PimConfig(mode="ref")
    gen = torch.Generator().manual_seed(0)
    p, q = (pl.pack_linear(pl.linear_init(gen, 64, n, cfg, device="cpu"),
                           cfg) for n in (32, 7))
    x = torch.randn((2, 64), generator=gen).to(torch.bfloat16)
    assert torch.equal(pl.linear_apply(p, x, cfg).view(torch.int16),
                       pl.linear_apply(p, x, ref).view(torch.int16))
    for got, want in zip(pl.fused_linear_apply([p, q], x, cfg),
                         pl.fused_linear_apply([p, q], x, ref)):
        assert got.shape == want.shape
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_device_none_means_the_card(monkeypatch):
    """``device=None`` resolves to CUDA and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        pl.linear_init(gen, 64, 32, pl.PimConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        pl.params_from_numpy({"w": np.zeros((4, 4), np.float32)})


def test_params_from_numpy_keeps_bits_and_structure():
    rng = np.random.default_rng(620)
    words = rng.integers(0, 1 << 32, (4, 2, 5), dtype=np.uint64) \
        .astype(np.uint32)
    words[0, 0, 0] = 0x80000001
    w = np.asarray(jnp.asarray(rng.normal(0, 1, (3, 5)), jnp.bfloat16))
    scale = rng.uniform(0, 1, 5).astype(np.float32)
    tree = {"a": [{"w_packed": words, "w_scale": scale}, {"w": w}],
            "b": ({"w": scale[None]},)}
    got = pl.params_from_numpy(tree, device="cpu")
    assert isinstance(got["a"], list) and isinstance(got["b"], tuple)
    wp = got["a"][0]["w_packed"]
    assert wp.dtype == torch.int32
    np.testing.assert_array_equal(wp.numpy().view(np.uint32), words)
    assert got["a"][0]["w_scale"].dtype == torch.float32
    wb = got["a"][1]["w"]
    assert wb.dtype == torch.bfloat16
    np.testing.assert_array_equal(wb.view(torch.int16).numpy(),
                                  w.view(np.int16))
    assert got["b"][0]["w"].shape == (1, 5)


def test_linear_init_is_seeded_and_device_independent():
    cfg = pl.PimConfig()
    a = pl.linear_init(torch.Generator().manual_seed(5), 256, 48, cfg,
                       device="cpu")["w"]
    b = pl.linear_init(torch.Generator().manual_seed(5), 256, 48, cfg,
                       device="cpu")["w"]
    assert a.dtype == torch.bfloat16 and a.shape == (256, 48)
    assert torch.equal(a, b)
    assert abs(a.float().std().item() - 256 ** -0.5) < 0.1 * 256 ** -0.5
    f = pl.linear_init(torch.Generator().manual_seed(5), 8, 4, cfg,
                       dtype=torch.float32, scale=1.0, device="cpu")["w"]
    assert f.dtype == torch.float32


def test_pim_config_carries_over():
    names = [f.name for f in dataclasses.fields(jl.PimConfig)]
    assert [f.name for f in dataclasses.fields(pl.PimConfig)] == names
    for n in names:
        assert getattr(pl.PimConfig(), n) == getattr(jl.PimConfig(), n)
    assert not pl.PimConfig().packed and pl.PimConfig(mode="ref").packed


def _jax_layer0(params, x, cfg, mcfg):
    """The reference's counterpart of ``chip_smoke.layer0``: JAX linears,
    the Pallas flash kernel (interpret) over the repeated KV heads."""
    h, kvh, hd = mcfg.n_heads, mcfg.n_kv_heads, mcfg.hd
    q, k, v = jl.fused_linear_apply([params[n] for n in ("q", "k", "v")],
                                    x, cfg)
    s = x.shape[0]

    def fold(t, heads):
        t = _repeat_kv(t.reshape(1, s, heads, hd), h)
        return jnp.moveaxis(t, 2, 1).reshape(h, s, hd)

    a = jfa.flash_attention(fold(q, h), fold(k, kvh), fold(v, kvh),
                            causal=True, interpret=True)
    a = jnp.moveaxis(a.reshape(1, h, s, hd), 1, 2).reshape(s, h * hd)
    o = jl.linear_apply(params["o"], a, cfg)
    hh = x + o
    gate, up = jl.fused_linear_apply([params["gate"], params["up"]], hh, cfg)
    down = jl.linear_apply(params["down"], jax.nn.silu(gate) * up, cfg)
    return {"q": q, "k": k, "v": v, "o": o, "gate": gate, "up": up,
            "down": down}


@pytest.mark.parametrize("mode", ["pallas", "popcount"])
def test_slice_layer0_matches_reference(mode):
    """The slice as a whole, at qwen2-0.5b's smoke widths: the smoke's
    layer (q/k/v, attention, o, gate/up, down) on the port against the
    same layer on the reference, on the reference's weights.  The q, k,
    v projections are bit-identical; past the attention (float sums in
    another order) every output stays within 2% of its largest value,
    and the port's packed mode stays bit-identical to its ``ref``."""
    mcfg = get_config("qwen2-0.5b", True)
    assert dataclasses.asdict(mcfg) == dataclasses.asdict(
        ref_get_config("qwen2-0.5b", True))
    jc = jl.PimConfig(mode=mode)
    lins = chip_smoke.layer_linears(mcfg)
    keys = jax.random.split(jax.random.PRNGKey(21), len(lins))
    jparams = {n: jl.pack_linear(jl.linear_init(kk, i, o, jc), jc)
               for kk, (n, (i, o)) in zip(keys, lins.items())}
    xj, xt = _x(np.random.default_rng(630), (32, mcfg.d_model))
    want = _jax_layer0(jparams, xj, jc, mcfg)
    tparams = pl.params_from_numpy(_np(jparams), device="cpu")
    got, _, _ = chip_smoke.layer0(tparams, xt, pl.PimConfig(mode=mode),
                                  mcfg, 1)
    refd, _, _ = chip_smoke.layer0(tparams, xt, pl.PimConfig(mode="ref"),
                                   mcfg, 1)
    for n in ("q", "k", "v"):
        _bits_equal(got[n], want[n])
    for n, y in got.items():
        w = np.asarray(want[n], np.float32)
        assert np.abs(y.float().numpy() - w).max() <= 0.02 * np.abs(w).max()
        assert torch.equal(y.view(torch.int16), refd[n].view(torch.int16))


@pytest.mark.parametrize("k,seed", [(896, 0), (4864, 0), (4864, 1)])
def test_w4a8_error_over_dense_by_k(k, seed):
    """The grounds of ``chip_smoke.dense_bound``: at the smoke's shapes
    (M = 128 tokens, N = 896, input ``silu(g) * u`` as the down
    projection gets it) the JAX package's W4A8 ``linear_apply`` stays
    under its own 0.15 at K = 896 but not at K = 4864, where the
    per-channel scale follows the largest of more weights.  The port, on
    the same weights carried over, gives the same packed output and the
    same ratio, and both stay under the smoke's bound."""
    jc = jl.PimConfig(mode="pallas", weight_bits=4)
    dense = jl.linear_init(jax.random.PRNGKey(seed), k, 896, jc)
    packed = jl.pack_linear(dense, jc)
    g, u = np.random.default_rng(640 + seed).normal(0, 1, (2, 128, k)) \
        .astype(np.float32)
    xj = jnp.asarray(g / (1 + np.exp(-g)) * u, jnp.bfloat16)
    xt = pl.params_from_numpy(np.asarray(xj), device="cpu")

    def ratio(y, yd):
        y, yd = np.asarray(y, np.float32), np.asarray(yd, np.float32)
        return np.abs(y - yd).mean() / np.abs(yd).mean()

    want = jl.linear_apply(packed, xj, jc)
    ref_ratio = ratio(want, jl.linear_apply(dense, xj, jl.PimConfig()))
    tc = pl.PimConfig(mode="pallas", weight_bits=4)
    got = pl.linear_apply(pl.params_from_numpy(_np(packed), device="cpu"),
                          xt, tc)
    _bits_equal(got, want)
    yd = pl.linear_apply(pl.params_from_numpy(_np(dense), device="cpu"), xt,
                         pl.PimConfig())
    port_ratio = ratio(got.float().numpy(), yd.float().numpy())
    assert port_ratio == pytest.approx(ref_ratio, rel=1e-3)
    bound = chip_smoke.dense_bound(4, k)
    assert max(ref_ratio, port_ratio) < bound
    assert (ref_ratio > 0.15) == (k > 896)


def _tf32(x):
    """``x`` rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _flash_rounding(q, k, v, round_p=False, round_acc=False, split_p=False,
                    tf32_p=False, tile=32):
    """A CUDA kernel's loop (key tiles of ``tile`` from key 0, float32
    state) in torch, optionally with one of the ways a bf16 kernel can take
    ``p`` into P.V: rounded to bf16 (``round_p``), split into bf16 hi + lo
    and multiplied twice (``split_p``, the kernel's), or rounded to TF32
    (``tf32_p``); or with the accumulator rounded to bf16 (``round_acc``)."""
    bh, s, hd = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((bh, s, 1), -1e30)
    l, acc = torch.zeros((bh, s, 1)), torch.zeros((bh, s, hd))
    rows = torch.arange(s)[:, None]
    for t0 in range(0, s, tile):
        sc = (qf @ kf[:, t0:t0 + tile].transpose(1, 2)) * hd ** -0.5
        cols = torch.arange(t0, min(t0 + tile, s))[None]
        sc = torch.where(cols <= rows, sc, -1e30)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p, alpha = torch.exp(sc - m_new), torch.exp(m - m_new)
        vb = vf[:, t0:t0 + tile]
        l = l * alpha + p.sum(-1, keepdim=True)
        if split_p:
            hi = p.bfloat16().float()
            pv = (p - hi).bfloat16().float() @ vb + hi @ vb
        else:
            pv = (p.bfloat16().float() if round_p
                  else _tf32(p) if tf32_p else p) @ vb
        acc = acc * alpha + pv
        if round_acc:
            acc = acc.bfloat16().float()
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


@pytest.mark.parametrize("fault", [None, "round_p", "round_acc", "split_p",
                                   "tf32_p"])
def test_smoke_bf16_flash_check_catches_bf16_rounding(fault):
    """``chip_smoke.flash_agrees`` on bf16: a float32 loop over 32-key
    tiles passes against the plain version (other tile size, other sum
    order); the same loop rounding ``p`` or the accumulator to bf16 fails.
    At the tensor-core kernel's 64-key tiles, ``p`` split into bf16 hi +
    lo passes and ``p`` rounded to TF32 fails."""
    rng = np.random.default_rng(650)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (2, 512, 64))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    want = fa.flash_attention_torch(q, k, v)
    got = _flash_rounding(q, k, v, round_p=fault == "round_p",
                          round_acc=fault == "round_acc",
                          split_p=fault == "split_p",
                          tf32_p=fault == "tf32_p",
                          tile=64 if fault in ("split_p", "tf32_p") else 32)
    assert chip_smoke.flash_agrees(got, want) == (fault in (None, "split_p"))


def _tf32_matmul(a, b, terms):
    """``a @ b`` as the TF32 tensor cores take it: ``hi.hi`` (1 term) or
    ``lo.hi + hi.lo + hi.hi`` (3 terms), with ``x = hi + lo`` and both parts
    rounded by :func:`_tf32`; products are exact in float32."""
    ah, bh = _tf32(a), _tf32(b)
    if terms == 1:
        return ah @ bh
    return _tf32(a - ah) @ bh + ah @ _tf32(b - bh) + ah @ bh


def _flash_tf32(q, k, v, terms, tile=64):
    """The float32 kernel's loop (64-key tiles, causal) with both products
    on TF32 tensor cores in ``terms`` terms."""
    bh, s, hd = q.shape
    m = torch.full((bh, s, 1), -1e30)
    l, acc = torch.zeros((bh, s, 1)), torch.zeros((bh, s, hd))
    rows = torch.arange(s)[:, None]
    for t0 in range(0, s, tile):
        sc = _tf32_matmul(q, k[:, t0:t0 + tile].transpose(1, 2), terms) \
            * hd ** -0.5
        cols = torch.arange(t0, min(t0 + tile, s))[None]
        sc = torch.where(cols <= rows, sc, -1e30)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p, alpha = torch.exp(sc - m_new), torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _tf32_matmul(p, v[:, t0:t0 + tile], terms)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)


@pytest.mark.parametrize("terms", [3, 1], ids=["3xtf32", "1xtf32"])
def test_smoke_f32_flash_check_needs_3xtf32(terms):
    """``chip_smoke.flash_agrees`` on float32 (``FLASH_F32_TOL``): the
    kernel's loop with 3xTF32 products passes against the plain version,
    with one TF32 product it fails."""
    rng = np.random.default_rng(651)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (2, 512, 64))
                                .astype(np.float32)) for _ in range(3))
    want = fa.flash_attention_torch(q, k, v)
    got = _flash_tf32(q, k, v, terms)
    assert chip_smoke.flash_agrees(got, want) == (terms == 3)


@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
def test_popcount_kernel_operand_types_hold_every_value(signed):
    """``csrc/popcount_matmul.cu`` unpacks a signed operand to s8 and an
    unsigned one to u8: for 1..8 planes every value ``unpack_bitplanes``
    gives fits that type, and the kernel's byte arithmetic (each nibble
    of a plane word spread to the low bits of four bytes by one multiply,
    times the plane's coefficient mod 256, summed over the planes) gives
    each value's byte."""
    dtype = np.int8 if signed else np.uint8
    info = np.iinfo(dtype)
    for bits in range(1, 9):
        lo, hi = (-(1 << (bits - 1)), 1 << (bits - 1)) if signed \
            else (0, 1 << bits)
        x = np.resize(np.arange(lo, hi), max(32, hi - lo))
        planes = kref.pack_bitplanes(torch.from_numpy(x)[None], bits, axis=1)
        vals = kref.unpack_bitplanes(planes, axis=1, signed=signed).numpy()
        np.testing.assert_array_equal(vals[0], x)
        assert info.min <= vals.min() and vals.max() <= info.max
        words = planes[:, 0].numpy().view(np.uint32).astype(np.uint64)
        quads = np.zeros((words.shape[1], 8), np.uint64)
        for p in range(bits):
            coef = (0xFF << p) & 0xFF if signed and p == bits - 1 else 1 << p
            for u in range(8):
                nib = (words[p] >> np.uint64(4 * u)) & np.uint64(0xF)
                quads[:, u] += ((nib * np.uint64(0x00204081))
                                & np.uint64(0x01010101)) * np.uint64(coef)
        assert quads.max() <= 0xFFFFFFFF          # no carry past a word
        got = quads.astype("<u4").view(np.uint8).reshape(-1).view(dtype)
        np.testing.assert_array_equal(got, x.astype(dtype))


def test_bf16_steps_counts_representable_values():
    x = torch.tensor([1.0, 1.0, -1.0, 0.0, 2.0 ** -133], dtype=torch.bfloat16)
    y = torch.tensor([1.0078125, 1.015625, -1.0078125, -0.0, -2.0 ** -133],
                     dtype=torch.bfloat16)
    assert chip_smoke.bf16_steps(x, y).tolist() == [1, 2, 1, 0, 2]
    assert chip_smoke.flash_agrees(x, y) is False     # 1.0 vs 1.015625
    assert chip_smoke.flash_agrees(x[2:], y[2:]) is True


def test_smoke_main_path_counts_its_kernels(monkeypatch):
    """``chip_smoke.phase_pim_linear`` at smoke widths on the CPU, with
    counting stand-ins for the kernels: every kernel of the path is
    launched in the counted run, and its checks pass."""
    def counting(fn, name):
        def w(*a, **k):
            w.launches += 1
            return fn(*a, **k)
        w.launches, w.__name__ = 0, name
        return w

    monkeypatch.setattr(bsm, "quant_matmul_cuda", counting(
        bsm.quant_matmul_torch, "quant_matmul_cuda"))
    monkeypatch.setattr(bsm, "popcount_matmul_cuda", counting(
        bsm.popcount_matmul_torch, "popcount_matmul_cuda"))
    monkeypatch.setattr(fa, "flash_attention_cuda", counting(
        fa.flash_attention_torch, "flash_attention_cuda"))
    monkeypatch.setattr(bsm, "_device_of", lambda *xs: torch.device("cuda"))
    monkeypatch.setattr(fa, "flash_attention",
                        lambda q, k, v, causal=True:
                        fa.flash_attention_cuda(q, k, v, causal=causal))
    launches, wall = chip_smoke.phase_pim_linear(
        0, dev="cpu", cfg=get_config("qwen2-0.5b", True), tokens=16,
        decode=4)
    assert launches == {"quant_matmul": 28, "popcount_matmul": 14,
                        "flash_attention": 6}
    assert set(wall) == {"W4A8 pallas", "W4A8 popcount", "W8A8 pallas"}
