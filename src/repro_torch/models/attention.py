"""Attention: GQA / MQA / sliding-window / cross, with chunked
online-softmax (memory-safe at long contexts) and ring-buffer KV caches.

The counterpart of ``repro.models.attention``.  The reference's
``lax.scan`` over KV chunks is a loop over the same chunks in the same
order, and its ``.at[...].set`` writes to a given cache are
out-of-place copies: no function here mutates a cache it was given.
"""

from __future__ import annotations

import torch

from . import common
from .common import dense_init, rope, shard
from .qweight import dq

NEG_INF = -1e30


def attn_init(key, cfg, cross: bool = False, device=None) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ks = common.split_keys(key, 4)
    p = {
        "wq": dense_init(ks[0], (d, H, hd), device=device),
        "wk": dense_init(ks[1], (d, KV, hd), device=device),
        "wv": dense_init(ks[2], (d, KV, hd), device=device),
        "wo": dense_init(ks[3], (H, hd, d), in_axis=0, device=device),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((H, hd), dtype=torch.bfloat16, device=device)
        p["bk"] = torch.zeros((KV, hd), dtype=torch.bfloat16, device=device)
        p["bv"] = torch.zeros((KV, hd), dtype=torch.bfloat16, device=device)
    return p


def _qkv(params, x, kv_src, cfg, positions, kv_positions, use_rope=True):
    q = torch.einsum("bsd,dhk->bshk", x, dq(params["wq"]))
    k = torch.einsum("bsd,dhk->bshk", kv_src, dq(params["wk"]))
    v = torch.einsum("bsd,dhk->bshk", kv_src, dq(params["wv"]))
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k, n_heads):
    """(B, S, KV, hd) -> (B, S, H, hd) by repeating each group."""
    g = n_heads // k.shape[2]
    return torch.repeat_interleave(k, g, dim=2) if g > 1 else k


def chunked_attention(q, k, v, pos_q, pos_k, *, causal: bool,
                      window=None, chunk: int = 1024):
    """Online-softmax attention, looping over KV chunks.

    q: (B, Sq, H, hd);  k, v: (B, Sk, H, hd) (KV already repeated);
    pos_q: (B, Sq), pos_k: (B, Sk) int32 (-1 = invalid key slot).
    Working set per step is O(Sq * chunk), never O(Sk^2).
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    chunk = min(chunk, sk)
    assert sk % chunk == 0, (sk, chunk)
    scale = hd ** -0.5

    qf = q.to(torch.float32) * scale
    m = torch.full((b, sq, h), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, sq, h), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, sk, chunk):
        kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        pc = pos_k[:, c0:c0 + chunk]
        s = torch.einsum("bqhd,bchd->bqhc", qf, kc.to(torch.float32))
        valid = (pc >= 0)[:, None, :]
        if causal:
            valid = valid & (pc[:, None, :] <= pos_q[:, :, None])
        if window is not None:
            valid = valid & (pc[:, None, :] > pos_q[:, :, None] - window)
        s = torch.where(valid[:, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqhc,bchd->bqhd", p, vc.to(torch.float32))
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def attn_apply(params, x, cfg, positions, *, causal=True, window=None,
               kv_src=None, kv_positions=None, chunk=1024):
    """Full-sequence attention (training / prefill / encoder / cross)."""
    cross = kv_src is not None
    src = kv_src if cross else x
    kpos = kv_positions if cross else positions
    q, k, v = _qkv(params, x, src, cfg, positions, kpos,
                   use_rope=not cross)
    q = shard(q, "batch", None, "model", None)
    k = _repeat_kv(k, cfg.n_heads)
    v = _repeat_kv(v, cfg.n_heads)
    k = shard(k, "batch", None, "model", None)
    v = shard(v, "batch", None, "model", None)
    out = chunked_attention(q, k, v, positions, kpos,
                            causal=causal and not cross,
                            window=window, chunk=chunk)
    out = out.to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, dq(params["wo"]))
    return shard(y, "batch", None, None)


# ---------------------------------------------------------------------------
# Decode path: ring-buffer KV cache (optionally int8/int4 "storage mode",
# the Compute RAM dual-mode idea applied to the cache)
# ---------------------------------------------------------------------------
def init_kv_cache(cfg, batch: int, capacity: int, window=None,
                  device=None) -> dict:
    cap = capacity if window is None else min(capacity, window)
    shape = (batch, cap, cfg.n_kv_heads, cfg.hd)
    if cfg.kv_quant_bits == 4:
        # two nibbles per byte along hd: 4x smaller than bf16
        assert cfg.hd % 2 == 0
        kv_shape, kv_dtype = shape[:3] + (cfg.hd // 2,), torch.uint8
    elif cfg.kv_quant_bits:
        kv_shape, kv_dtype = shape, torch.int8
    else:
        kv_shape, kv_dtype = shape, torch.bfloat16
    cache = {n: torch.zeros(kv_shape, dtype=kv_dtype, device=device)
             for n in ("k", "v")}
    if cfg.kv_quant_bits:
        for n in ("k_s", "v_s"):
            cache[n] = torch.zeros(shape[:3], dtype=torch.bfloat16,
                                   device=device)
    cache["pos"] = torch.full((batch, cap), -1, dtype=torch.int32,
                              device=device)
    return cache


def _kv_quantize(x, bits: int):
    """x: (..., hd) -> (int8 / nibble-packed uint8 values, bf16 scale).

    The reference runs this only inside a jitted model step, where XLA
    lowers ``amax / qmax`` as a multiply by the float32 reciprocal of
    ``qmax`` (a true division differs from it by an ulp in some rows);
    the port multiplies the same way, as ``kernels/ops.quantize`` does.
    """
    qmax = (1 << (bits - 1)) - 1
    xf = x.to(torch.float32)
    amax = torch.clamp(torch.amax(torch.abs(xf), dim=-1), min=1e-6)
    scale = amax * torch.tensor(1 / qmax, dtype=torch.float32,
                                device=x.device)
    q = torch.clamp(torch.round(xf / scale[..., None]),
                    -qmax - 1, qmax).to(torch.int32)
    if bits == 4:
        u = (q & 0xF).to(torch.uint8)                   # two's complement
        lo, hi = u[..., 0::2], u[..., 1::2]
        return lo | (hi << 4), scale.to(torch.bfloat16)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _nib_signed(u):
    s = u.to(torch.int32)
    return torch.where(s >= 8, s - 16, s)


def _kv_read(cache, name):
    x = cache[name]
    if x.dtype == torch.uint8:                          # 4-bit packed
        lo = _nib_signed(x & 0xF)
        hi = _nib_signed(x >> 4)
        vals = torch.stack([lo, hi], dim=-1).reshape(
            x.shape[:-1] + (x.shape[-1] * 2,))
        return vals.to(torch.float32) \
            * cache[name + "_s"].to(torch.float32)[..., None]
    if x.dtype == torch.int8:
        return x.to(torch.float32) \
            * cache[name + "_s"].to(torch.float32)[..., None]
    return x.to(torch.float32)


def _kv_values(cfg, k, v, pos):
    """The cache leaves to write for keys ``k``, values ``v`` (quantized
    when the cache is) at positions ``pos``, by leaf name."""
    if not cfg.kv_quant_bits:
        return {"k": k, "v": v, "pos": pos}
    kq, ks_ = _kv_quantize(k, cfg.kv_quant_bits)
    vq, vs_ = _kv_quantize(v, cfg.kv_quant_bits)
    return {"k": kq, "v": vq, "k_s": ks_, "v_s": vs_, "pos": pos}


def _set(t, idx, val):
    """``t.at[idx].set(val)``: a copy of ``t`` with ``val`` written."""
    t = t.clone()
    t[idx] = val.to(t.dtype)
    return t


def attn_decode(params, x, cache, cfg, pos, *, window=None):
    """One-token decode.  x: (B, 1, d); pos: (B,) int32 current position."""
    b, s, d = x.shape
    assert s == 1
    positions = pos[:, None]
    q, k, v = _qkv(params, x, x, cfg, positions, positions)

    cap = cache["k"].shape[1]
    idx = (torch.arange(b, device=x.device), pos % cap)   # ring buffer
    vals = _kv_values(cfg, k[:, 0], v[:, 0], pos)
    new_cache = {n: _set(t, idx, vals[n]) for n, t in cache.items()}
    ck = _kv_read(new_cache, "k")
    cv = _kv_read(new_cache, "v")
    cp = new_cache["pos"]

    scale = cfg.hd ** -0.5
    qh = shard(q.to(torch.float32) * scale, "batch", None, "model", None)
    kh = _repeat_kv(ck, cfg.n_heads)
    vh = _repeat_kv(cv, cfg.n_heads)
    kh = shard(kh, "batch", None, "model", None)
    vh = shard(vh, "batch", None, "model", None)
    s_ = torch.einsum("bqhd,bchd->bqhc", qh, kh)
    valid = (cp >= 0)[:, None, :] & (cp[:, None, :] <= positions[:, :, None])
    if window is not None:
        valid = valid & (cp[:, None, :] > positions[:, :, None] - window)
    s_ = torch.where(valid[:, :, None, :], s_, NEG_INF)
    p = torch.softmax(s_, dim=-1)
    out = torch.einsum("bqhc,bchd->bqhd", p, vh).to(x.dtype)
    y = torch.einsum("bshk,hkd->bsd", out, dq(params["wo"]))
    return y, new_cache


def prefill_kv_cache(params, x, cfg, positions, capacity, window=None):
    """Build a cache from a prefilled sequence (keys of the last `cap`)."""
    b, s, d = x.shape
    _, k, v = _qkv(params, x, x, cfg, positions, positions)
    cap = capacity if window is None else min(capacity, window)
    if s >= cap:
        ks, vs, ps = k[:, -cap:], v[:, -cap:], positions[:, -cap:]
    else:
        pad = cap - s
        ks = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        vs = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        ps = torch.nn.functional.pad(positions, (0, pad), value=-1)
    # ring-consistent placement: slot = pos % cap
    ring = torch.arange(cap, device=x.device)[None, :] % cap
    idx = (torch.arange(b, device=x.device)[:, None],
           torch.where(ps >= 0, ps % cap, ring))
    cache = init_kv_cache(cfg, b, cap, device=x.device)
    for n, val in _kv_values(cfg, ks, vs, ps).items():
        cache[n][idx] = val.to(cache[n].dtype)      # a fresh cache
    return cache
