"""The decode attention kernel's plain version and its dispatch, on the CPU.

``kernels/decode_attention.py`` attends a lane's query against its bf16
ring-buffer cache without widening or repeating it.  The kernel runs only
on the card (``test_torch_cuda.py``); here its plain torch version, which
the card tests hold the kernel to, is held to ``attn_decode``'s widened
path (``chip_smoke.decode_plain_path``: ``_attend_cache`` on the cache
widened to float32 and repeated to the query heads) at the zoo's head widths
and group sizes and in the cache states decode meets; a numpy emulation
of the kernel's index arithmetic (read from the ``#define``\\ s of
``csrc/decode_attention.cu``) is held to the plain version; and
``attn_decode``'s dispatch is checked path by path, with its counters.
"""

import dataclasses
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

from repro_torch import trace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

_CU = Path(da.__file__).with_name("csrc") / "decode_attention.cu"

#: the chunked version against the widened path (float32 sum order)
TOL = chip_smoke.DECODE_TOL

#: (B, H, KV, hd, cap, window): danube's widths and window, qwen2's group
#: of 7 (hd 64), granite-20b's MQA (48 heads on one, hd 128), a smoke
#: config's (hd 16, window 32), recurrentgemma's ring (hd 256, g 16)
SHAPES = {
    "danube": (4, 32, 8, 80, 2048, 4096),
    "qwen2": (3, 14, 2, 64, 300, None),
    "granite20b": (2, 48, 1, 128, 256, None),
    "smoke": (4, 4, 2, 16, 32, 32),
    "recurrentgemma": (2, 16, 1, 256, 192, 128),
}
STATES = ("start", "full", "wrapped", "mixed")


def _cache(rng, shape, state):
    """``q, k, v, pos, cur`` of a cache in ``state``: every lane at
    position 0; every slot live; a ring that wrapped under a window (or,
    with none, wrapped its capacity); lanes of mixed lengths, some with a
    padded prefill's positions beyond the current one."""
    b, h, kv, hd, cap, window = shape

    def bf16(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32)) \
            .to(torch.bfloat16)

    q, k, v = bf16(b, h, hd), bf16(b, cap, kv, hd), bf16(b, cap, kv, hd)
    pos = np.full((b, cap), -1, np.int64)
    if state == "start":
        cur = np.zeros(b, np.int64)
        pos[:, 0] = 0
    elif state == "full":
        cur = np.full(b, cap - 1)
        pos[:] = np.arange(cap)
    elif state == "wrapped":
        cur = 3 * cap + rng.integers(0, cap, b)
        slots = np.arange(cap)
        for i in range(b):
            # the latest position written to each slot
            pos[i] = cur[i] - (cur[i] - slots) % cap
    else:
        cur = rng.integers(0, cap, b)
        cur[0] = cap - 1
        for i in range(b):
            n = min(cap, int(cur[i]) + 1 + int(rng.integers(0, 40)))
            pos[i, :n] = np.arange(n)          # pads beyond cur
    return (q, k, v, torch.from_numpy(pos.astype(np.int32)),
            torch.from_numpy(cur.astype(np.int32)))


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_version_matches_attend_cache(name, state):
    shape = SHAPES[name]
    q, k, v, pos, cur = _cache(np.random.default_rng(len(name)), shape,
                               state)
    window = shape[5]
    want = chip_smoke.decode_plain_path(q, k, v, pos, cur, window)
    got = da.decode_attention_torch(q, k, v, pos, cur, window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    torch.testing.assert_close(got, want, **TOL)
    # a float32 query takes the same arithmetic
    got32 = da.decode_attention_torch(q.float(), k, v, pos, cur,
                                      window=window)
    assert torch.equal(got32, got)


def test_chunks_dead_in_every_lane_are_never_read():
    """NaN in every slot of the chunks no lane can see leaves the output
    as it was: those chunks are skipped, not masked."""
    shape = (3, 8, 2, 32, 5 * da.CHUNK, None)
    q, k, v, pos, cur = _cache(np.random.default_rng(2), shape, "mixed")
    pos[:] = -1
    cur[:] = torch.tensor([10, da.CHUNK + 3, 2 * da.CHUNK - 1])
    for i, c in enumerate(cur.tolist()):
        pos[i, :c + 1] = torch.arange(c + 1)
    want = da.decode_attention_torch(q, k, v, pos, cur)
    for t in (k, v):
        t[:, 2 * da.CHUNK:] = float("nan")
    got = da.decode_attention_torch(q, k, v, pos, cur)
    assert torch.equal(got, want)
    torch.testing.assert_close(got, chip_smoke.decode_plain_path(
        q, k.nan_to_num(), v.nan_to_num(), pos, cur, None), **TOL)


# ---------------------------------------------------------------------------
# the kernel's arithmetic, emulated
# ---------------------------------------------------------------------------
def _cu_defines():
    return {k: int(v) for k, v in re.findall(
        r"^#define (\w+) (\d+)\b", _CU.read_text(), flags=re.M)}


def test_kernel_constants_match_the_wrapper():
    d = _cu_defines()
    assert (d["DA_CHUNK"], d["DA_MAX_HD"], d["DA_MAX_GROUP"]) == \
        (da.CHUNK, da.MAX_HEAD_DIM, da.MAX_GROUP)
    assert d["DA_THREADS"] % 32 == 0 and d["DA_CHUNK"] % 32 == 0


def _f32(bits16):
    """bf16 bit patterns (uint32 holding 16 bits in the high half) as
    float32."""
    return bits16.astype(np.uint32).view(np.float32)


def _emulate(q, k, v, pos, cur, window, scale):
    """``decode_attention_chunk`` and ``decode_attention_merge`` block by
    block over flat buffers, with the ``.cu``'s offsets: the partials'
    layout, the tile's padded rows of 32-bit words, the bf16 halves and
    the chunk-ordered merge."""
    d = _cu_defines()
    chunk = d["DA_CHUNK"]
    b_, h, hd = q.shape
    _, cap, kv, _ = k.shape
    g = h // kv

    def storage(t):
        """``t``'s whole storage as uint16, and ``t``'s first element's
        offset in it: the kernel gets a data pointer and strides."""
        flat = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
        return flat.view(torch.int16).numpy().view(np.uint16), \
            t.storage_offset()

    (kf, k0), (vf, v0) = storage(k), storage(v)
    ks, vs = k.stride(), v.stride()
    qf = q.float().numpy().ravel()
    posf, curf = pos.numpy().ravel(), cur.numpy()
    chunks = -(-cap // chunk)
    stride = hd + 2
    head_stride = chunks * stride
    part = np.full(b_ * h * chunks * stride, np.nan, np.float32)
    wpr = hd // 2 + 1
    for b in range(b_):
        for kh in range(kv):
            for c in range(chunks):
                c0 = c * chunk
                rows = min(chunk, cap - c0)
                now = int(curf[b])
                valid = np.zeros(chunk, bool)
                for r in range(rows):
                    p = int(posf[b * cap + c0 + r])
                    valid[r] = p >= 0 and p <= now and (
                        window is None or p > now - window)
                out = ((b * kv + kh) * g * chunks + c) * stride
                if not valid.any():
                    for j in range(g):
                        part[out + j * head_stride + hd] = -1e30
                        part[out + j * head_stride + hd + 1] = 0
                    continue
                qb = (b * kv + kh) * g * hd
                qs = (qf[qb:qb + g * hd] * np.float32(scale)) \
                    .reshape(g, hd)

                def stage(flat, off, st):
                    tile = np.zeros(chunk * wpr, np.uint32)
                    base = off + b * st[0] + c0 * st[1] + kh * st[2]
                    for r in range(rows):
                        if not valid[r]:
                            continue
                        for e in range(hd // 8):
                            x = flat[base + r * st[1] + e * 8:][:8] \
                                .astype(np.uint32)
                            tile[r * wpr + e * 4:][:4] = \
                                x[0::2] | (x[1::2] << 16)
                    return tile

                tile = stage(kf, k0, ks)
                ps = np.full((g, chunk), -1e30, np.float32)
                for r in range(chunk):
                    if valid[r]:
                        t = tile[r * wpr:r * wpr + hd // 2]
                        lo, hi = _f32(t << 16), _f32(t & 0xFFFF0000)
                        ps[:, r] = qs[:, 0::2] @ lo + qs[:, 1::2] @ hi
                m = ps.max(axis=1)
                p = np.where(valid[None], np.exp(ps - m[:, None]), 0)
                tile = stage(vf, v0, vs)
                th = tile.view(np.uint16)
                for j in range(g):
                    o = out + j * head_stride
                    part[o + hd], part[o + hd + 1] = m[j], p[j].sum()
                    acc = np.zeros(hd, np.float32)
                    for r in range(rows):
                        if valid[r]:
                            acc += p[j, r] * _f32(
                                th[2 * r * wpr:][:hd].astype(np.uint32)
                                << 16)
                    part[o:o + hd] = acc
    res = np.zeros((b_ * h, hd), np.float32)
    for bh in range(b_ * h):
        pb = part[bh * chunks * stride:][:chunks * stride].reshape(
            chunks, stride)
        live = pb[:, hd + 1] > 0
        big = pb[live, hd].max() if live.any() else -1e30
        w = np.where(live, np.exp(np.where(live, pb[:, hd], 0) - big), 0)
        res[bh] = (w[live, None] * pb[live, :hd]).sum(0) \
            / max((w[live] * pb[live, hd + 1]).sum(), 1e-30)
    return torch.from_numpy(res.reshape(b_, h, hd))


@pytest.mark.parametrize("state", STATES)
def test_kernel_arithmetic_matches_plain(state):
    """The emulation on a cache of three chunks, the last ragged, 3 query
    heads a KV head, hd 24, under a window; K read through a strided
    view (every other head of a layer of a stacked cache)."""
    b, h, kv, hd, cap, window = 2, 6, 2, 24, 2 * da.CHUNK + 9, 100
    q, k, v, pos, cur = _cache(np.random.default_rng(5),
                               (b, h, kv, hd, cap, window), state)
    stacked = torch.zeros((2, b, cap, 2 * kv, hd), dtype=k.dtype)
    stacked[1, :, :, ::2] = k
    view = stacked[1, :, :, ::2]
    assert view.storage_offset() and not view.is_contiguous()
    want = da.decode_attention_torch(q, k, v, pos, cur, window=window)
    got = _emulate(q, view, v, pos, cur, window, hd ** -0.5)
    torch.testing.assert_close(got, want, **TOL)


# ---------------------------------------------------------------------------
# the wrapper's refusals and attn_decode's dispatch
# ---------------------------------------------------------------------------
def test_wrappers_refuse_what_the_kernel_does_not_take():
    q, k, v, pos, cur = _cache(np.random.default_rng(3), SHAPES["smoke"],
                               "full")
    with pytest.raises(TypeError, match="bf16 cache"):
        da.decode_attention_torch(q, k.float(), v.float(), pos, cur)
    with pytest.raises(TypeError, match="float32 or bf16 query"):
        da.decode_attention_torch(q.half(), k, v, pos, cur)
    with pytest.raises(TypeError, match="int32"):
        da.decode_attention_torch(q, k, v, pos.long(), cur)
    with pytest.raises(ValueError, match="head widths"):
        da.decode_attention_torch(q[..., :12], k[..., :12], v[..., :12], pos, cur)
    with pytest.raises(ValueError, match="head widths"):
        da.decode_attention_torch(q[:, :3], k, v, pos, cur)     # 3 heads on 2
    big = torch.zeros((1, 65, 1, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head widths"):
        da.decode_attention_torch(big[:, :, 0], big[:, :1], big[:, :1],
                            pos[:1, :1], cur[:1])           # g 65
    with pytest.raises(ValueError, match="shapes disagree"):
        da.decode_attention_torch(q, k, v, pos[:, :-1], cur)
    with pytest.raises(ValueError, match="window"):
        da.decode_attention_torch(q, k, v, pos, cur, window=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        da.decode_attention_cuda(q, k, v, pos, cur)


def _attn_case(cfg, kv_bits=None, seed=0):
    cfg = dataclasses.replace(cfg, kv_quant_bits=kv_bits)
    rng = np.random.default_rng(seed)
    p = attn.attn_init(torch.Generator().manual_seed(seed), cfg)
    b, cap = 3, 40
    x = torch.from_numpy(rng.normal(size=(b, 6, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    positions = torch.arange(6, dtype=torch.int32).expand(b, 6)
    cache = attn.prefill_kv_cache(p, x, cfg, positions, cap)
    xs = torch.from_numpy(rng.normal(size=(b, 1, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    return cfg, p, xs, cache, torch.full((b,), 6, dtype=torch.int32)


@pytest.mark.parametrize("kv_bits", [None, 8, 4])
def test_attn_decode_on_the_cpu_takes_the_plain_path(kv_bits):
    cfg, p, xs, cache, pos = _attn_case(
        get_config("qwen2-0.5b", smoke=True), kv_bits)
    assert not attn._decode_kernel_takes(cache)
    trace.enable()
    try:
        attn.attn_decode(p, xs, cache, cfg, pos)
        _, counters = trace.take()
    finally:
        trace.disable()
    assert counters.get("attn.decode_plain") == 1
    assert "attn.decode_kernel" not in counters


@pytest.fixture
def kernel_on_the_cpu(monkeypatch):
    """``attn_decode``'s kernel branch on CPU tensors: the dispatch told
    every cache is the kernel's, the kernel's wrapper replaced by a
    counting plain version.  Yields the list of calls' arguments."""
    calls = []

    def fake(q, k, v, pos, cur, *, window=None, scale=None):
        calls.append((q, k, v, pos, cur, window, scale))
        return da.decode_attention_torch(q, k, v, pos, cur, window=window,
                                         scale=scale)

    monkeypatch.setattr(attn, "_decode_kernel_takes", lambda cache: True)
    monkeypatch.setattr(da, "decode_attention_cuda", fake)
    yield calls


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "h2o-danube-1.8b",
                                  "granite-20b"])
def test_attn_decode_kernel_branch_equals_the_plain_path(arch,
                                                         kernel_on_the_cpu):
    """The kernel branch hands the kernel the rotated bf16 query, the
    updated cache as it is, its positions and the current ones, and
    gives the plain path's output (bf16, so within a bf16 step) and the
    same new cache."""
    cfg = get_config(arch, smoke=True)
    cfg, p, xs, cache, pos = _attn_case(cfg, seed=1)
    window = cfg.sliding_window
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attn, "_decode_kernel_takes", lambda cache: False)
        want_y, want_c = attn.attn_decode(p, xs, cache, cfg, pos,
                                          window=window)
    assert not kernel_on_the_cpu
    trace.enable()
    try:
        y, new = attn.attn_decode(p, xs, cache, cfg, pos, window=window)
        _, counters = trace.take()
    finally:
        trace.disable()
    (q, k, v, cp, cur, w, scale), = kernel_on_the_cpu
    assert counters.get("attn.decode_kernel") == 1
    assert "attn.decode_plain" not in counters
    assert q.dtype == torch.bfloat16 and q.shape == (3, cfg.n_heads, cfg.hd)
    assert k is new["k"] and v is new["v"] and cp is new["pos"]
    assert torch.equal(cur, pos) and w == window and scale == cfg.hd ** -0.5
    for n in want_c:
        assert torch.equal(new[n], want_c[n])
    torch.testing.assert_close(y.float(), want_y.float(), rtol=0.02,
                               atol=0.02)


def test_model_decode_step_attends_each_layer_once(kernel_on_the_cpu):
    """A decode step of smoke danube through ``LM`` counts the kernel once
    a layer and nothing on the plain path; its logits are the plain
    path's within the models' bound."""
    from repro_torch.models.model import LM

    cfg = get_config("h2o-danube-1.8b", smoke=True)
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.tensor([[3, 5, 7, 9], [2, 4, 6, 8]], dtype=torch.int32)
    _, caches = model.prefill(params, tokens=tokens, capacity=16)
    step = (torch.tensor([[1], [2]], dtype=torch.int32),
            torch.tensor([4, 4], dtype=torch.int32))
    trace.enable()
    try:
        got, _ = model.decode_step(params, caches, *step)
        _, counters = trace.take()
    finally:
        trace.disable()
    assert counters.get("attn.decode_kernel") == cfg.n_layers
    assert len(kernel_on_the_cpu) == cfg.n_layers
    assert "attn.decode_plain" not in counters
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attn, "_decode_kernel_takes", lambda cache: False)
        want, _ = model.decode_step(params, caches, *step)
    torch.testing.assert_close(got.float(), want.float(), rtol=0.05,
                               atol=0.05)
