"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434 §2.1), with
a latent ring cache for decode.

Per token: ``q = x W_q`` (H heads of ``qk_nope + qk_rope`` dims, no query
compression); ``a = x W_dkv`` splits into the latent ``c = RMSNorm(a[:r],
g_kv)`` and one rotary key ``k_pe = a[r:]`` shared by every head; the
rotary parts of the query and key rotate by YaRN's frequencies
(``common.rope_pairs``).  Each head's key is ``[c W_uk, k_pe]`` and its
value ``c W_uv``; the scores carry ``qk_head_dim**-0.5`` times YaRN's
``mscale**2``.

Two paths compute the same attention, the products grouped otherwise:

* ``mla_apply`` (training, prefill) expands the keys and values per head
  and runs ``attention.chunked_attention`` over them;
* ``mla_decode`` absorbs ``W_uk`` into the query and ``W_uv`` into the
  output: the scores are ``(q_nope W_uk^T) c + q_pe k_pe`` and the output
  ``(p c) W_uv``, against a cache that holds per token only ``c`` (after
  its norm) and ``k_pe`` (after the rotation): ``r + qk_rope`` values,
  ring-placed at ``pos % capacity`` as ``attention``'s KV cache is.

The decode products read the bf16 cache as it is and accumulate in
float32 (cuBLAS's float32 output on the card): the cache is never
widened.  Spans: ``mla.latent`` (the projections, the norm, the rotation
and the in-place write of each lane's ring slot) and ``mla.attend``
(scores, softmax, values and the output projection).
"""

from __future__ import annotations

import functools

import torch

from repro_torch import trace
from . import common
from .attention import NEG_INF, chunked_attention, ring_cache, write_slot
from .common import dense_init, rmsnorm, rope_pairs, yarn_inv_freq
from .qweight import dq


def mla_init(key, cfg, device=None) -> dict:
    d, H, m = cfg.d_model, cfg.n_heads, cfg.mla
    ks = common.split_keys(key, 5)
    return {
        "wq": dense_init(ks[0], (d, H, m.qk_head_dim), device=device),
        "w_dkv": dense_init(ks[1], (d, m.kv_lora_rank + m.qk_rope_head_dim),
                            device=device),
        "kv_norm": torch.zeros((m.kv_lora_rank,), dtype=torch.float32,
                               device=device),
        "w_uk": dense_init(ks[2], (m.kv_lora_rank, H, m.qk_nope_head_dim),
                           device=device),
        "w_uv": dense_init(ks[3], (m.kv_lora_rank, H, m.v_head_dim),
                           device=device),
        "wo": dense_init(ks[4], (H, m.v_head_dim, d), in_axis=0,
                         device=device),
    }


def init_mla_cache(cfg, batch: int, capacity: int, device=None) -> dict:
    m = cfg.mla
    return {"c": torch.zeros((batch, capacity, m.kv_lora_rank),
                             dtype=torch.bfloat16, device=device),
            "k_pe": torch.zeros((batch, capacity, m.qk_rope_head_dim),
                                dtype=torch.bfloat16, device=device),
            "pos": torch.full((batch, capacity), -1, dtype=torch.int32,
                              device=device)}


def softmax_scale(cfg) -> float:
    return cfg.mla.qk_head_dim ** -0.5 * cfg.rope_scaling.attn_scale


@functools.lru_cache(maxsize=None)
def _inv_freq(cfg, device):
    """YaRN's rotary frequencies, made once per config and device."""
    return yarn_inv_freq(cfg.mla.qk_rope_head_dim, cfg.rope_theta,
                         cfg.rope_scaling, device)


def _latent(params, x, cfg, positions):
    """(q_nope, q_pe, c, k_pe) of the tokens ``x`` (B, S, d) at
    ``positions`` (B, S): the queries per head, the normed latent and the
    rotated shared key."""
    m = cfg.mla
    r, nope = m.kv_lora_rank, m.qk_nope_head_dim
    inv = _inv_freq(cfg, x.device)
    cos_scale = cfg.rope_scaling.cos_scale
    q = torch.einsum("bsd,dhk->bshk", x, dq(params["wq"]))
    q_pe = rope_pairs(q[..., nope:], positions, inv, cos_scale)
    a = x @ dq(params["w_dkv"])
    c = rmsnorm(a[..., :r], params["kv_norm"], cfg.norm_eps)
    k_pe = rope_pairs(a[..., None, r:], positions, inv, cos_scale)[..., 0, :]
    return q[..., :nope], q_pe, c, k_pe


def _expand(params, q_nope, q_pe, c, k_pe):
    """Per-head queries and keys of ``qk_head_dim`` and values: the
    decompressed form the prefill attends with."""
    k_nope = torch.einsum("bsr,rhk->bshk", c, dq(params["w_uk"]))
    v = torch.einsum("bsr,rhk->bshk", c, dq(params["w_uv"]))
    q = torch.cat([q_nope, q_pe], -1)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(
        k_nope.shape[:3] + k_pe.shape[-1:])], -1)
    return q, k, v


def mla_apply(params, x, cfg, positions, capacity=None, chunk=1024):
    """Full-sequence causal MLA (training, prefill): ``(y, cache)``, the
    cache ring-placed at ``capacity`` (``None``: no cache)."""
    with trace.span("mla.latent"):
        q_nope, q_pe, c, k_pe = _latent(params, x, cfg, positions)
        cache = None if capacity is None else ring_cache(
            {"c": c, "k_pe": k_pe}, positions, capacity)
    with trace.span("mla.attend"):
        q, k, v = _expand(params, q_nope, q_pe, c, k_pe)
        out = chunked_attention(q, k, v, positions, positions, causal=True,
                                chunk=chunk, scale=softmax_scale(cfg))
        y = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), dq(params["wo"]))
    return y, cache


def _bmm_f32(a, b):
    """``a @ b`` of bf16 batches with a float32 result, neither operand
    widened on the card (cuBLAS accumulates and writes float32); elsewhere
    the same products of the widened operands."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def mla_decode(params, x, cache, cfg, pos):
    """One-token decode through the latent cache.  x: (B, 1, d); pos:
    (B,) int32.  Writes each lane's ``c``, ``k_pe`` and position into
    ``cache`` at its ring slot (in place), then attends the cache;
    returns ``(y, cache)``."""
    positions = pos[:, None]
    with trace.span("mla.latent"):
        q_nope, q_pe, c, k_pe = _latent(params, x, cfg, positions)
        slot = pos % cache["c"].shape[1]
        for n, val in (("c", c[:, 0]), ("k_pe", k_pe[:, 0]), ("pos", pos)):
            write_slot(cache[n], slot, val)
    with trace.span("mla.attend"):
        q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], dq(params["w_uk"]))
        s = _bmm_f32(q_lat, cache["c"].transpose(1, 2)) \
            + _bmm_f32(q_pe[:, 0], cache["k_pe"].transpose(1, 2))
        cp = cache["pos"]
        valid = (cp >= 0) & (cp <= positions)
        s = torch.where(valid[:, None, :], s * softmax_scale(cfg), NEG_INF)
        p = torch.softmax(s, dim=-1)
        o_lat = _bmm_f32(p.to(cache["c"].dtype), cache["c"])  # (B, H, r)
        o = torch.einsum("bhr,rhk->bhk", o_lat.to(x.dtype), dq(params["w_uv"]))
        y = torch.einsum("bhk,hkd->bd", o, dq(params["wo"]))[:, None]
    return y, cache
