"""Attention: GQA / MQA / sliding-window / cross, with chunked
online-softmax (memory-safe at long contexts) and ring-buffer KV caches.

The counterpart of ``repro.models.attention``.  The reference's
``lax.scan`` over KV chunks is a loop over the same chunks in the same
order, and its ``.at[...].set`` writes to a given cache are
out-of-place copies: no function here mutates a cache it was given.
"""

from __future__ import annotations

import functools

import torch

from .. import trace
from ..kernels import decode_attention as dattn
from . import common
from .common import dense_init, per_shard, rope, shard, shard_like
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
                      window=None, chunk: int = 1024, scale=None):
    """Online-softmax attention, looping over KV chunks.

    q, k: (B, Sq | Sk, H, hd);  v: (B, Sk, H, hd_v) (KV already repeated);
    pos_q: (B, Sq), pos_k: (B, Sk) int32 (-1 = invalid key slot); the
    scores carry ``scale`` (``None``: ``hd**-0.5``).
    Working set per step is O(Sq * chunk), never O(Sk^2).  On a mesh it
    runs on each rank's shards (``common.per_shard``).
    """
    return per_shard(functools.partial(
        _chunked_attention, causal=causal, window=window, chunk=chunk,
        scale=scale), q, k, v, pos_q, pos_k, out_like=q)


def _chunked_attention(q, k, v, pos_q, pos_k, *, causal, window, chunk,
                       scale=None):
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    chunk = min(chunk, sk)
    assert sk % chunk == 0, (sk, chunk)
    scale = hd ** -0.5 if scale is None else scale

    qf = q.to(torch.float32) * scale
    # the accumulators take qf's layout (its placements on a mesh)
    m = torch.full_like(qf[..., 0], NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf) if v.shape[-1] == hd \
        else qf.new_zeros(qf.shape[:-1] + v.shape[-1:])
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


def _set(t, slot, val):
    """``t.at[arange(B), slot].set(val)``: a copy of the ``(B, cap, ...)``
    leaf ``t`` with each row's ``val`` written at its ring slot, as a
    select, which keeps ``t``'s placements on a mesh (an indexed write
    into a batch-sharded DTensor has no sharding strategy)."""
    hit = torch.arange(t.shape[1], device=t.device) == slot[:, None]
    hit = hit.reshape(hit.shape + (1,) * (t.ndim - 2))
    return torch.where(hit, shard_like(val[:, None].to(t.dtype), t), t)


def _decode_kernel_takes(cache) -> bool:
    """Whether ``kernels/decode_attention``'s kernel attends ``cache``: a
    bf16 (not quantized) cache in plain CUDA tensors (not DTensors)."""
    k = cache["k"]
    return k.dtype == torch.bfloat16 and type(k) is torch.Tensor \
        and k.device.type == "cuda"


def attn_decode(params, x, cache, cfg, pos, *, window=None):
    """One-token decode.  x: (B, 1, d); pos: (B,) int32 current position.

    A bf16 cache in plain CUDA tensors is attended by the decode
    attention kernel, in place of widening and repeating it (counter
    ``attn.decode_kernel``); any other cache by the reference's steps
    (``attn.decode_plain``)."""
    b, s, d = x.shape
    assert s == 1
    positions = pos[:, None]
    q, k, v = _qkv(params, x, x, cfg, positions, positions)

    cap = cache["k"].shape[1]
    slot = pos % cap                                      # ring buffer
    vals = _kv_values(cfg, k[:, 0], v[:, 0], pos)
    new_cache = {n: _set(t, slot, vals[n]) for n, t in cache.items()}
    scale = cfg.hd ** -0.5
    if _decode_kernel_takes(new_cache):
        trace.count("attn.decode_kernel")
        out = dattn.decode_attention_cuda(
            q[:, 0], new_cache["k"], new_cache["v"], new_cache["pos"],
            pos.to(torch.int32), window=window, scale=scale)[:, None]
    else:
        trace.count("attn.decode_plain")
        ck = _kv_read(new_cache, "k")
        cv = _kv_read(new_cache, "v")
        cp = new_cache["pos"]
        qh = shard(q.to(torch.float32) * scale, "batch", None, "model",
                   None)
        kh = _repeat_kv(ck, cfg.n_heads)
        vh = _repeat_kv(cv, cfg.n_heads)
        kh = shard(kh, "batch", None, "model", None)
        vh = shard(vh, "batch", None, "model", None)
        out = per_shard(functools.partial(_attend_cache, window=window),
                        qh, kh, vh, cp, positions, out_like=qh)
    y = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), dq(params["wo"]))
    return y, new_cache


def _attend_cache(qh, kh, vh, cp, positions, *, window):
    """One query a row against its whole ring-buffer cache."""
    s_ = torch.einsum("bqhd,bchd->bqhc", qh, kh)
    valid = (cp >= 0)[:, None, :] & (cp[:, None, :] <= positions[:, :, None])
    if window is not None:
        valid = valid & (cp[:, None, :] > positions[:, :, None] - window)
    s_ = torch.where(valid[:, :, None, :], s_, NEG_INF)
    p = torch.softmax(s_, dim=-1)
    return torch.einsum("bqhc,bchd->bqhd", p, vh)


def prefill_kv_cache(params, x, cfg, positions, capacity, window=None):
    """Build a cache from a prefilled sequence (keys of the last `cap`)."""
    b, s, d = x.shape
    _, k, v = _qkv(params, x, x, cfg, positions, positions)
    cap = capacity if window is None else min(capacity, window)
    ks, vs, ps = _last(k, cap), _last(v, cap), _last(positions, cap, -1)
    return _ring_place(_kv_values(cfg, ks, vs, ps), ps, cap)


def _last(t, cap, fill=0):
    """The last ``cap`` entries of ``t`` along dim 1, or ``t`` padded with
    ``fill`` to ``cap``."""
    s = t.shape[1]
    if s >= cap:
        return t[:, -cap:]
    pad = (0, 0) * (t.ndim - 2) + (0, cap - s)
    return torch.nn.functional.pad(t, pad, value=fill)


def _ring_place(vals, ps, cap):
    """The leaves ``vals`` (each (B, cap, ...)) of tokens at positions
    ``ps`` (B, cap; -1 an empty entry) moved to their ring slots."""
    # ring-consistent placement: slot = pos % cap.  A row's positions
    # are consecutive from 0 (prefill's), so its slots are a permutation
    # of the ring and the cache is gathered by the inverse permutation:
    # out of place, which keeps each leaf's layout on a mesh (an indexed
    # write into a fresh cache would replicate it on every rank)
    ring = torch.arange(cap, device=ps.device)[None, :] % cap
    inv = torch.argsort(torch.where(ps >= 0, ps % cap, ring), dim=1)
    cache = {}
    for n, val in vals.items():
        idx = inv.reshape(inv.shape + (1,) * (val.ndim - 2))
        cache[n] = torch.gather(val, 1, idx.expand(val.shape))
    return cache


def ring_cache(leaves: dict, positions, cap: int) -> dict:
    """A decode cache of ``cap`` slots from a prefilled sequence's cache
    ``leaves`` (each (B, S, ...)) at ``positions`` (B, S): the last
    ``cap`` tokens at their ring slots, ``"pos"`` beside them."""
    ps = _last(positions, cap, -1)
    vals = {n: _last(v, cap) for n, v in leaves.items()}
    vals["pos"] = ps
    return _ring_place(vals, ps, cap)
