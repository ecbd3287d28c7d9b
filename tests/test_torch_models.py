"""The port's model modules against the JAX package's, on the CPU.

Same numpy inputs through ``repro.models.*`` and ``repro_torch.models.*``:
quantized weights, KV codes and scales bit-identical; norms, rope, the
causal conv and the MoE dispatch exact; float32 attention and the linear
scan within the tolerances stated at each test.  The JAX side runs
eagerly, or compiled without excess precision where the reference
itself only ever runs compiled (``torch_arch_parity.run_ref``).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import common as jc  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import qweight as jq  # noqa: E402
from repro.models import recurrence as jrec  # noqa: E402
from repro.models.model import LM as RefLM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import common as tc  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import qweight as tq  # noqa: E402
from repro_torch.models import recurrence as trec  # noqa: E402
from repro_torch.models.convert import init_numpy  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from torch_arch_parity import run_ref, to_torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _bits(t):
    """A tensor's raw bits as numpy (bf16 as int16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _ref_bits(a):
    """A reference array's raw bits as the port keeps them (bf16 as
    int16, uint32 plane words as int32)."""
    a = np.asarray(a)
    view = {"bfloat16": np.int16, "uint32": np.int32}.get(a.dtype.name)
    return a.view(view) if view else a


def _same_bits(got, want):
    np.testing.assert_array_equal(_bits(got), _ref_bits(want))


def _bf16(rng, shape, scale=1.0):
    return jnp.asarray(rng.normal(size=shape) * scale, jnp.bfloat16)


# ---------------------------------------------------------------------------
# qweight
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("stacked", [False, True])
def test_quantize_leaf_is_bit_identical(bits, stacked):
    rng = np.random.default_rng(bits)
    shape = (3, 64, 4, 16) if stacked else (64, 4, 16)
    w = _bf16(rng, shape, 0.1)
    want = jq._quantize_leaf(w, bits, stacked)
    got = tq._quantize_leaf(to_torch(w), bits, stacked)
    if isinstance(want, jq.PackedWeight):
        assert isinstance(got, tq.PackedWeight) and got.shape == want.shape
        assert got.planes.dtype == torch.int32
        np.testing.assert_array_equal(
            _bits(got.planes), np.asarray(want.planes).view(np.int32))
        _same_bits(got.scale, want.scale)
    else:
        _same_bits(got["q"], want["q"])
        _same_bits(got["scale"], want["scale"])
    layer = (lambda t: tq.tree_map(lambda x: x[1], t)) if stacked \
        else (lambda t: t)
    ref_layer = (lambda t: jax.tree.map(lambda x: x[1], t)) if stacked \
        else (lambda t: t)
    _same_bits(tq.dq(layer(got)), jq.dq(ref_layer(want)))


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_rounds_half_to_even(bits):
    """Exact halves after the scale: both packages round to even."""
    qmax = (1 << (bits - 1)) - 1
    col = np.array([qmax, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5]
                   + [0.0] * 25, np.float32)
    w = np.stack([col, -col], axis=1)                  # (32, 2)
    want = jq._quantize_leaf(jnp.asarray(w), bits)
    got = tq._quantize_leaf(torch.from_numpy(w), bits)
    dq_got, dq_want = tq.dq(got, torch.float32), jq.dq(want, jnp.float32)
    np.testing.assert_array_equal(dq_got.numpy(), np.asarray(dq_want))
    np.testing.assert_array_equal(dq_got[1:7, 0].numpy(),
                                  [0, 2, 2, 0, -2, -2])


def test_quantize_tree_and_tree_bytes_match_reference():
    cfg = ref_configs.get_config("qwen2-0.5b", smoke=True)
    ref_params = jax.jit(RefLM(cfg).init)(jax.random.PRNGKey(1))
    params = to_torch(ref_params)
    for bits in (4, 8):
        want = jq.quantize_tree(ref_params, bits=bits)
        got = tq.quantize_tree(params, bits=bits)
        assert tq.tree_bytes(got) == jq.tree_bytes(want)
        ref_leaves = {jax.tree_util.keystr(k): v for k, v
                      in jax.tree_util.tree_leaves_with_path(want)}
        assert len(tq.tree_leaves(got)) == len(ref_leaves)
        for path, t in _with_paths(got):
            _same_bits(t, ref_leaves[path])
    assert tq.tree_bytes(params) == jq.tree_bytes(ref_params)


def _with_paths(tree, path=""):
    """(JAX ``keystr`` path, tensor) of each leaf of a port tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _with_paths(v, f"{path}['{k}']")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _with_paths(v, f"{path}[{i}]")
    elif isinstance(tree, tq.PackedWeight):
        yield f"{path}[<flat index 0>]", tree.planes
        yield f"{path}[<flat index 1>]", tree.scale
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------
def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(2)
    x = _bf16(rng, (2, 8, 64))
    w = jnp.asarray(rng.normal(size=(64,)) * 0.1, jnp.float32)
    _same_bits(tc.rmsnorm(to_torch(x), to_torch(w)), jc.rmsnorm(x, w))
    q = _bf16(rng, (2, 8, 4, 16))
    pos = jnp.asarray(rng.integers(0, 4096, (2, 8)), jnp.int32)
    for theta in (10_000.0, 1_000_000.0):
        _same_bits(tc.rope(to_torch(q), to_torch(pos), theta),
                   jc.rope(q, pos, theta))


def test_activations_round_like_the_reference():
    """bf16 silu / gelu / sigmoid bit-identical to ``jax.nn``'s."""
    x = _bf16(np.random.default_rng(3), (4096,), 3.0)
    for got, want in ((tc.silu, jax.nn.silu), (tc.gelu, jax.nn.gelu),
                      (tc.sigmoid, jax.nn.sigmoid)):
        with jax.disable_jit():
            _same_bits(got(to_torch(x)), want(x))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)])
def test_chunked_attention_matches_reference(causal, window):
    """float32, 4 key chunks, a third of the key slots invalid
    (pos = -1); within 1e-5 (float32 sums in another order)."""
    rng = np.random.default_rng(4)
    b, sq, sk, h, hd = 2, 8, 32, 4, 16
    q, k, v = (jnp.asarray(rng.normal(size=(b, s, h, hd)), jnp.float32)
               for s in (sq, sk, sk))
    pos_q = jnp.asarray(rng.integers(0, 32, (b, sq)), jnp.int32)
    pos_k = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
    pos_k[rng.random((b, sk)) < 1 / 3] = -1
    pos_k = jnp.asarray(pos_k)
    want = ja.chunked_attention(q, k, v, pos_q, pos_k, causal=causal,
                                window=window, chunk=8)
    got = ta.chunked_attention(*(to_torch(a) for a in (q, k, v, pos_q,
                                                       pos_k)),
                               causal=causal, window=window, chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_chunked_attention(dtype):
    """The kernel library's attention (its plain version here; the CUDA
    kernel in ``chip_smoke.phase_flash_model``) against the models'
    ``chunked_attention`` at qwen2-0.5b's shape, (b, s, h, hd) =
    (1, 128, 14, 64), causal: float32 within 2e-4 (the reference's,
    tests/test_kernels.py), bf16 by ``chip_smoke.flash_agrees``."""
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa
    dt = getattr(torch, dtype)
    b, s, h, hd = 1, 128, 14, 64
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (b, s, h, hd))
                                .astype(np.float32)).to(dt) for _ in range(3))
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    want = ta.chunked_attention(q, k, v, pos, pos, causal=True,
                                chunk=64).to(dt)

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, s, hd).contiguous()

    got = fa.flash_attention(fold(q), fold(k), fold(v), causal=True)
    got = got.reshape(b, h, s, hd).transpose(1, 2)
    assert got.dtype == dt and chip_smoke.flash_agrees(got, want)


@pytest.mark.parametrize("bits", [4, 8])
def test_kv_quantize_and_read_are_bit_identical(bits):
    """Codes and bf16 scales bit-identical to the reference as it runs,
    compiled; the cache read back likewise."""
    x = _bf16(np.random.default_rng(bits), (2, 16, 2, 16), 2.0)
    want_q, want_s = run_ref(lambda a: ja._kv_quantize(a, bits), x)
    got_q, got_s = ta._kv_quantize(to_torch(x), bits)
    assert got_q.dtype == (torch.uint8 if bits == 4 else torch.int8)
    _same_bits(got_q, want_q)
    _same_bits(got_s, want_s)
    cache = {"k": want_q, "k_s": want_s}
    _same_bits(ta._kv_read(to_torch(cache), "k"), ja._kv_read(cache, "k"))


def _attn_setup(kv_bits, window=None):
    import dataclasses
    rcfg = dataclasses.replace(
        ref_configs.get_config("qwen2-0.5b", smoke=True),
        kv_quant_bits=kv_bits)
    cfg = dataclasses.replace(configs.get_config("qwen2-0.5b", smoke=True),
                              kv_quant_bits=kv_bits)
    p = ja.attn_init(jax.random.PRNGKey(5), rcfg)
    p = {**p, **{n: jnp.asarray(np.random.default_rng(6).normal(
        size=p[n].shape) * 0.1, jnp.bfloat16) for n in ("bq", "bk", "bv")}}
    return rcfg, cfg, p


@pytest.mark.parametrize("kv_bits", [None, 4, 8])
def test_prefill_kv_cache_and_attn_decode_match_reference(kv_bits):
    """Prefill a 6-token cache of capacity 8, then decode two tokens,
    one wrapping the ring for a window of 7: every cache leaf
    bit-identical, the decoded outputs within 0.05 (bf16 outputs, the
    models' bound).  The decode writes the given cache in place and
    returns it."""
    rcfg, cfg, p = _attn_setup(kv_bits)
    rng = np.random.default_rng(7)
    x = _bf16(rng, (2, 6, rcfg.d_model))
    positions = jnp.broadcast_to(jnp.arange(6, dtype=jnp.int32), (2, 6))
    want = run_ref(lambda p, x, q: ja.prefill_kv_cache(p, x, rcfg, q, 8),
                   p, x, positions)
    tp = to_torch(p)
    got = ta.prefill_kv_cache(tp, to_torch(x), cfg, to_torch(positions), 8)
    assert got.keys() == want.keys()
    for n in got:
        _same_bits(got[n], want[n])
    for step, window in ((6, None), (7, 7)):
        xs = _bf16(rng, (2, 1, rcfg.d_model))
        pos = jnp.full((2,), step, jnp.int32)
        y, want = run_ref(lambda p, x, c, q: ja.attn_decode(
            p, x, c, rcfg, q, window=window), p, xs, want, pos)
        leaves = dict(got)
        ty, new = ta.attn_decode(tp, to_torch(xs), got, cfg, to_torch(pos),
                                 window=window)
        assert new is got
        for n in got:
            assert new[n] is leaves[n], "cache leaf rebuilt"
            _same_bits(new[n], want[n])
        np.testing.assert_allclose(ty.float().numpy(),
                                   np.asarray(y, np.float32),
                                   rtol=0.05, atol=0.05)
        got = new


def _select_write(t, slot, val):
    """The select that wrote a decode step's slot before the in-place
    write: ``t.at[arange(B), slot].set(val)`` as a whole-cache
    ``torch.where``, copied back into ``t``."""
    hit = torch.arange(t.shape[1]) == slot[:, None]
    hit = hit.reshape(hit.shape + (1,) * (t.ndim - 2))
    t.copy_(torch.where(hit, val[:, None].to(t.dtype), t))


def _recurrent_states(model, caches):
    """The recurrent layers' states in ``caches``, in layer order."""
    out = []
    for i in range(model.n_units):
        for k, t in enumerate(model.unit):
            if t in ("ssm", "rec"):
                out.append({n: x[i] for n, x in
                            caches["unit"][f"b{k}"][t].items()})
    out += [c[t] for c, t in zip(caches["rest"], model.rest)
            if t in ("ssm", "rec")]
    return out


@pytest.mark.parametrize("arch,kv_bits", [
    ("h2o-danube-1.8b", None), ("deepseek-v2-lite", None),
    ("qwen2-0.5b", 8), ("recurrentgemma-9b", None)])
def test_decode_step_writes_each_lane_slot_in_place(arch, kv_bits,
                                                    monkeypatch):
    """After a prefill of 6 tokens into 8 slots, one decode step with the
    lanes at positions 6, 7 and 11 (the last wrapped around the ring)
    returns the caches it was given, leaf for leaf the same tensors, and
    restacks none.  An attention leaf changes only at each lane's
    ``pos % cap``, where it holds what the whole-cache select wrote; a
    recurrent layer's state is the one its layer returns; the logits are
    bit for bit those of the decode through the select."""
    import dataclasses
    from repro_torch.models import mla as tmla
    from repro_torch.models import model as tmodel

    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              kv_quant_bits=kv_bits)
    model = LM(cfg, device="cpu")
    params = init_numpy(cfg, 0, device="cpu")
    rng = np.random.default_rng(11)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab, (3, 7)).astype(np.int32))
    pos = torch.tensor([6, 7, 11], dtype=torch.int32)
    _, caches = model.prefill(params, tokens=tokens[:, :6], capacity=8)
    before = tq.tree_map(torch.clone, caches)
    given = list(_with_paths(caches))

    def restack(trees):
        raise AssertionError("a decode step restacked its caches")

    monkeypatch.setattr(tmodel, "_stack", restack)
    logits, got = model.decode_step(params, caches, tokens[:, 6:], pos)
    assert got is caches
    assert all(t is g for (_, t), (_, g) in zip(_with_paths(got), given))

    # the same step with the select in place of each slot write and the
    # recurrent states taken as their layers return them
    states = []

    def functional(cache, new):
        states.append(new)
        return new

    monkeypatch.setattr(ta, "write_slot", _select_write)
    monkeypatch.setattr(tmla, "write_slot", _select_write)
    monkeypatch.setattr(tmodel, "_write_state", functional)
    oracle = tq.tree_map(torch.clone, before)
    want, _ = model.decode_step(params, oracle, tokens[:, 6:], pos)
    assert torch.equal(logits, want)

    attention = 0
    for (path, t), (_, old), (_, sel) in zip(
            _with_paths(got), _with_paths(before), _with_paths(oracle)):
        if "['kv']" not in path and "['mla']" not in path:
            continue
        attention += 1
        lanes = (slice(None),) if path.startswith("['unit']") else ()
        slots = lanes + (torch.arange(3), pos % t.shape[len(lanes) + 1])
        kept = t.clone()
        kept[slots] = old[slots]
        assert torch.equal(kept, old), f"{path}: written off its slots"
        assert torch.equal(t, sel), f"{path}: not the select's write"
        if path.endswith("['pos']"):
            assert torch.equal(t[slots], pos.expand(t[slots].shape)), path
    assert attention > 0
    recurrent = _recurrent_states(model, got)
    assert len(recurrent) == len(states)
    for mine, theirs in zip(recurrent, states):
        assert mine.keys() == theirs.keys()
        for n in mine:
            assert torch.equal(mine[n], theirs[n]), n


# ---------------------------------------------------------------------------
# recurrence
# ---------------------------------------------------------------------------
def test_causal_conv_is_bit_identical():
    rng = np.random.default_rng(8)
    x, w, b = _bf16(rng, (2, 16, 32)), _bf16(rng, (4, 32)), \
        _bf16(rng, (32,))
    state = _bf16(rng, (2, 3, 32))
    for st in (None, state):
        y, ns = jrec.causal_conv(x, w, b, st)
        ty, tns = trec.causal_conv(to_torch(x), to_torch(w), to_torch(b),
                                   None if st is None else to_torch(st))
        _same_bits(ty, y)
        _same_bits(tns, ns)


def test_chunked_linear_scan_matches_reference():
    """float32; the in-chunk scan is a Hillis-Steele scan, not XLA's
    associative scan, so the sums differ in the last bits: within
    rtol = 1e-5, atol = 1e-6."""
    rng = np.random.default_rng(9)
    a = jnp.asarray(rng.uniform(0.5, 1.0, (2, 64, 3, 4)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(2, 64, 3, 4)), jnp.float32)
    h0 = jnp.asarray(rng.normal(size=(2, 3, 4)), jnp.float32)
    for chunk in (16, 64, 256):
        hs, h = jrec.chunked_linear_scan(a, b, h0, chunk=chunk)
        ths, th = trec.chunked_linear_scan(to_torch(a), to_torch(b),
                                           to_torch(h0), chunk=chunk)
        np.testing.assert_allclose(ths.numpy(), np.asarray(hs),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(th.numpy(), ths[:, -1].numpy())
    # and the sequential definition of the recurrence
    seq, hh = [], to_torch(h0)
    for t in range(64):
        hh = trec.linear_scan_step(to_torch(a)[:, t], to_torch(b)[:, t], hh)
        seq.append(hh)
    np.testing.assert_allclose(ths.numpy(), torch.stack(seq, 1).numpy(),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# moe
# ---------------------------------------------------------------------------
class _Recorder:
    """Wraps a function and keeps the arguments and result of each call."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args):
        out = self.fn(*args)
        self.calls.append((args, out))
        return out


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mixtral-8x7b"])
def test_moe_dispatch_exact_and_output_close(arch, monkeypatch):
    """Expert choice, sort order, slots and capacity drops of every
    dispatch chunk exactly the reference's (random router inputs have no
    ties); outputs within 1e-2 (bf16), aux loss within 1e-6."""
    rcfg = ref_configs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    p = jmoe.moe_init(jax.random.PRNGKey(10), rcfg)
    x = _bf16(np.random.default_rng(11), (2, 24, rcfg.d_model))

    vmaps, vmap = [], jax.vmap

    def recording_vmap(fn, *a, **kw):
        vmapped = vmap(fn, *a, **kw)
        rec = _Recorder(vmapped)
        vmaps.append(rec)
        return rec

    monkeypatch.setattr(jmoe.jax, "vmap", recording_vmap)
    want, want_aux = jmoe.moe_apply(p, x, rcfg)
    monkeypatch.undo()
    (ref_args, (_, ref_meta)), = vmaps[0].calls     # the dispatch vmap
    ref_eidx = np.asarray(ref_args[2])
    ref_order, _, ref_keep, ref_slot, _ = (np.asarray(m) for m in ref_meta)

    rec = _Recorder(tmoe._dispatch)
    monkeypatch.setattr(tmoe, "_dispatch", rec)
    got, got_aux = tmoe.moe_apply(to_torch(p), to_torch(x), cfg)
    assert len(rec.calls) == ref_eidx.shape[0] > 0
    for c, (args, (_, (order, keep, slot, _))) in enumerate(rec.calls):
        np.testing.assert_array_equal(args[2].numpy(), ref_eidx[c])
        np.testing.assert_array_equal(order.numpy(), ref_order[c])
        np.testing.assert_array_equal(keep.numpy(), ref_keep[c])
        np.testing.assert_array_equal(slot.numpy(), ref_slot[c])
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)


def test_moe_combine_sums_in_the_reference_order():
    """The combine adds each token's contributions in sorted (expert)
    order with a bf16 rounding after each add, as the reference's
    scatter-add does; summed in f32 instead, some tokens differ."""
    cfg = configs.get_config("mixtral-8x7b", smoke=True)
    rcfg = ref_configs.get_config("mixtral-8x7b", smoke=True)
    p = jmoe.moe_init(jax.random.PRNGKey(12), rcfg)
    x = _bf16(np.random.default_rng(13), (1, 64, rcfg.d_model), 4.0)
    with jax.disable_jit():
        want, _ = jmoe.moe_apply(p, x, rcfg)
    got, _ = tmoe.moe_apply(to_torch(p), to_torch(x), cfg)
    _same_bits(got, want)


# ---------------------------------------------------------------------------
# model entry points and weights
# ---------------------------------------------------------------------------
def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config("qwen2-0.5b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_numpy(cfg, 0)


@pytest.mark.parametrize("arch", configs.list_archs())
def test_init_tree_matches_reference(arch):
    """``init_numpy`` draws the reference's tree: the same keys, shapes
    and dtypes leaf for leaf, the non-random leaves (norms, biases, SSM
    and RG-LRU constants) equal to the reference's values, the random
    ones with std fan_in**-0.5; the same seed gives the same params."""
    rcfg = ref_configs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    ref = jax.eval_shape(RefLM(rcfg).init, jax.random.PRNGKey(0))
    params = init_numpy(cfg, 0, device="cpu")
    ref_leaves = {jax.tree_util.keystr(k): v for k, v
                  in jax.tree_util.tree_leaves_with_path(ref)}
    got = dict(_with_paths(params))
    assert got.keys() == ref_leaves.keys()
    for path, t in got.items():
        assert tuple(t.shape) == ref_leaves[path].shape, path
        assert str(t.dtype)[6:] == str(ref_leaves[path].dtype), path
    consts = {"ln1": 0.0, "ln2": 0.0, "lnx": 0.0, "final_norm": 0.0,
              "bq": 0.0, "bk": 0.0, "bv": 0.0, "conv_b": 0.0, "D": 1.0,
              "dt_b": -4.6, "lambda_p": 1.0}
    for path, t in got.items():
        name = path.rsplit("['", 1)[-1][:-2]
        if name in consts:
            assert torch.all(t == torch.tensor(consts[name], dtype=t.dtype))
        elif name == "A_log":
            st = t.shape[-1]
            assert torch.equal(t[..., 0, :], torch.log(
                torch.arange(1, st + 1, dtype=torch.float32)).expand(
                    t[..., 0, :].shape))
        elif t.numel() >= 4096:
            # dense_init's in_axis: 1 for the experts' w_down, else 0,
            # after the layer axis of a stacked leaf
            in_axis = ("['unit']" in path) + (
                name == "w_down" and "['moe']" in path)
            fan_in = t.shape[in_axis]
            std = t.float().std().item()
            assert abs(std * fan_in ** 0.5 - 1) < 0.1, (path, std)
    again = init_numpy(cfg, 0, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(tq.tree_leaves(params), tq.tree_leaves(again)))


def test_params_from_numpy_keeps_bits_of_packed_trees():
    cfg = ref_configs.get_config("qwen2-0.5b", smoke=True)
    ref = jq.quantize_tree(jax.jit(RefLM(cfg).init)(jax.random.PRNGKey(2)),
                           bits=4)
    got = to_torch(ref)
    packed = got["unit"]["b0"]["attn"]["wq"]
    assert isinstance(packed, tq.PackedWeight)
    assert packed.shape == ref["unit"]["b0"]["attn"]["wq"].shape
    ref_leaves = dict((jax.tree_util.keystr(k), v) for k, v in
                      jax.tree_util.tree_leaves_with_path(ref))
    for path, t in _with_paths(got):
        if np.asarray(ref_leaves[path]).dtype == np.uint32:
            assert t.dtype == torch.int32
        _same_bits(t, ref_leaves[path])
