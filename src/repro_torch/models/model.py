"""LM assembly: embeds -> stacked layer groups -> norm -> logits.

The counterpart of ``repro.models.model``.  Layers are stacked per
repeating unit, as in the reference: every leaf under ``"unit"`` has a
leading layer axis, and the reference's ``lax.scan`` over that axis is a
loop that indexes it.  Three execution modes:

* ``apply``       -- full-sequence forward (training, encoder)
* ``prefill``     -- full-sequence forward that also emits decode caches
* ``decode_step`` -- one token with ring-buffer KV / recurrent state

``LM(cfg, device=None)`` runs on ``device`` (``None``: the GPU; it raises
when there is none).  The reference rematerializes each scanned layer in
training (``remat_policy``); that matters only for gradients, which come
with the training slice of the port.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import resolve_device
from . import attention as attn
from . import common, moe as moe_mod, rglru as rg, ssm as ssm_mod
from .common import dense_init, gelu, rmsnorm, shard, silu
from .qweight import dq, tree_leaves, tree_map


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_init(key, cfg, device=None):
    ks = common.split_keys(key, 3)
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_up": dense_init(ks[1], (d, f), device=device),
         "w_down": dense_init(ks[2], (f, d), device=device)}
    if cfg.mlp_variant == "swiglu":
        p["w_gate"] = dense_init(ks[0], (d, f), device=device)
    return p


def mlp_apply(params, x):
    if "w_gate" in params:
        h = silu(x @ dq(params["w_gate"])) * (x @ dq(params["w_up"]))
    else:
        h = gelu(x @ dq(params["w_up"]))
    h = shard(h, "batch", None, "model")
    return shard(h @ dq(params["w_down"]), "batch", None, None)


# ---------------------------------------------------------------------------
# Blocks (one per layer type)
# ---------------------------------------------------------------------------
def _block_init(key, cfg: ModelConfig, btype: str, device=None):
    d = cfg.d_model
    ks = common.split_keys(key, 4)

    def norm():
        return torch.zeros((d,), dtype=torch.float32, device=device)

    p = {"ln1": norm()}
    if btype == "attn":
        p["attn"] = attn.attn_init(ks[0], cfg, device=device)
        p["ln2"] = norm()
        if cfg.moe is not None:
            p["moe"] = moe_mod.moe_init(ks[1], cfg, device=device)
        elif cfg.d_ff > 0:
            p["mlp"] = mlp_init(ks[1], cfg, device=device)
    elif btype == "xattn":       # decoder layer of an encoder-decoder
        p["attn"] = attn.attn_init(ks[0], cfg, device=device)
        p["lnx"] = norm()
        p["xattn"] = attn.attn_init(ks[1], cfg, cross=True, device=device)
        p["ln2"] = norm()
        p["mlp"] = mlp_init(ks[2], cfg, device=device)
    elif btype == "ssm":
        p["ssm"] = ssm_mod.ssm_init(ks[0], cfg, device=device)
    elif btype == "rec":
        p["rec"] = rg.rglru_init(ks[0], cfg, device=device)
        p["ln2"] = norm()
        p["mlp"] = mlp_init(ks[1], cfg, device=device)
    else:
        raise ValueError(btype)
    return p


def _window_for(cfg, btype):
    if cfg.rglru is not None and btype == "attn":
        return cfg.rglru.window
    return cfg.sliding_window


def _ffn(params, cfg, x):
    if "moe" in params:
        y, aux = moe_mod.moe_apply(params["moe"], x, cfg)
        return y, aux
    if "mlp" in params:
        return mlp_apply(params["mlp"], x), 0.0
    return None, 0.0


def _block_apply(params, h, cfg, btype, positions, mode, cache,
                 enc_out=None, enc_pos=None, causal=True):
    """Returns (h, new_cache, aux)."""
    new_cache = {}
    aux = 0.0
    x = rmsnorm(h, params["ln1"], cfg.norm_eps)

    if btype in ("attn", "xattn"):
        window = _window_for(cfg, btype)
        if mode == "decode":
            pos = positions[:, 0]
            y, new_cache["kv"] = attn.attn_decode(
                params["attn"], x, cache["kv"], cfg, pos, window=window)
        else:
            y = attn.attn_apply(params["attn"], x, cfg, positions,
                                causal=causal, window=window)
            if mode == "prefill":
                cap = cache["kv"]["k"].shape[1]
                new_cache["kv"] = attn.prefill_kv_cache(
                    params["attn"], x, cfg, positions, cap, window=window)
        h = h + y
        if btype == "xattn":
            xx = rmsnorm(h, params["lnx"], cfg.norm_eps)
            y = attn.attn_apply(params["xattn"], xx, cfg, positions,
                                causal=False, kv_src=enc_out,
                                kv_positions=enc_pos)
            h = h + y
        f = rmsnorm(h, params["ln2"], cfg.norm_eps)
        y, aux = _ffn(params, cfg, f)
        if y is not None:
            h = h + y

    elif btype == "ssm":
        y, c = ssm_mod.ssm_apply(params["ssm"], x, cfg,
                                 cache=cache.get("ssm") if cache else None)
        if mode != "train":
            new_cache["ssm"] = c
        h = h + y

    elif btype == "rec":
        y, c = rg.rglru_apply(params["rec"], x, cfg,
                              cache=cache.get("rec") if cache else None)
        if mode != "train":
            new_cache["rec"] = c
        h = h + y
        f = rmsnorm(h, params["ln2"], cfg.norm_eps)
        y, _ = _ffn(params, cfg, f)
        if y is not None:
            h = h + y

    return h, new_cache, aux


def _block_cache(cfg, btype, batch, capacity, device=None):
    if btype in ("attn", "xattn"):
        window = _window_for(cfg, btype)
        return {"kv": attn.init_kv_cache(cfg, batch, capacity, window,
                                         device=device)}
    if btype == "ssm":
        return {"ssm": ssm_mod.ssm_init_cache(cfg, batch, device=device)}
    if btype == "rec":
        return {"rec": rg.rglru_init_cache(cfg, batch, device=device)}
    raise ValueError(btype)


def _stack(trees):
    """A list of equal trees -> one tree with a leading layer axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _layer(tree, i):
    """Layer ``i`` of a stacked tree (``None`` stays ``None``)."""
    return None if tree is None else tree_map(lambda x: x[i], tree)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
class LM:
    """Decoder-only LM (also hosts the encoder stack for enc-dec)."""

    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.unit, self.n_units, self.rest = cfg.scan_plan()
        if cfg.is_encdec:
            # decoder layers are xattn; encoder handled separately
            self.unit, self.n_units, self.rest = ["xattn"], cfg.n_layers, []

    # -- init ---------------------------------------------------------------
    def init(self, key):
        """Random params on the model's device.  ``key`` is a seeded
        ``torch.Generator`` or numpy ``Generator`` (see
        ``common.dense_init``); leaves are drawn in a fixed order."""
        cfg, dev = self.cfg, self.device

        def unit_init():
            return {f"b{i}": _block_init(key, cfg, t, dev)
                    for i, t in enumerate(self.unit)}

        params = {
            "embed": dense_init(key, (cfg.vocab, cfg.d_model), device=dev),
            "unit": _stack([unit_init() for _ in range(self.n_units)]),
            "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                      device=dev),
        }
        if self.rest:
            params["rest"] = [_block_init(key, cfg, t, dev)
                              for t in self.rest]
        if not cfg.tie_embeddings:
            params["head"] = dense_init(key, (cfg.d_model, cfg.vocab),
                                        device=dev)
        if cfg.is_encdec:
            params["encoder"] = {
                "unit": _stack([{"b0": _block_init(key, cfg, "attn", dev)}
                                for _ in range(cfg.encoder_layers)]),
                "final_norm": torch.zeros((cfg.d_model,),
                                          dtype=torch.float32, device=dev),
            }
        return params

    # -- stacked group execution ---------------------------------------------
    def _run_unit(self, stacked, h, positions, mode, caches, unit=None,
                  enc_out=None, enc_pos=None, causal=True):
        cfg = self.cfg
        unit = unit or self.unit
        new_caches, aux = [], 0.0
        for layer in range(tree_leaves(stacked)[0].shape[0]):
            lp, lc = _layer(stacked, layer), _layer(caches, layer)
            new_lc = {}
            for i, t in enumerate(unit):
                c_i = lc[f"b{i}"] if lc is not None else None
                h, nc, a = _block_apply(lp[f"b{i}"], h, cfg, t, positions,
                                        mode, c_i, enc_out, enc_pos, causal)
                new_lc[f"b{i}"] = nc
                aux = aux + a
            new_caches.append(new_lc)
        return h, _stack(new_caches), aux

    def _embed(self, params, tokens=None, embeds=None):
        if embeds is not None:
            return embeds
        e = dq(params["embed"])[tokens].to(torch.bfloat16)
        return shard(e, "batch", None, None)

    def _head(self, params, h):
        h = rmsnorm(h, params["final_norm"], self.cfg.norm_eps)
        w = (dq(params["embed"]).T if self.cfg.tie_embeddings
             else dq(params["head"]))
        logits = h @ w.to(h.dtype)
        return shard(logits, "batch", None, "model")

    def encode(self, params, embeds, positions):
        """Bidirectional encoder stack (enc-dec archs)."""
        enc = params["encoder"]
        h, _, _ = self._run_unit(enc["unit"], embeds, positions, "train",
                                 None, unit=["attn"], causal=False)
        return rmsnorm(h, enc["final_norm"], self.cfg.norm_eps)

    # -- public entry points --------------------------------------------------
    def _forward(self, params, tokens, embeds, positions, mode, caches,
                 enc_out=None, enc_pos=None):
        cfg = self.cfg
        b, s = (tokens if tokens is not None else embeds).shape[:2]
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=self.device).expand(b, s)
        h = self._embed(params, tokens, embeds)
        unit_caches = caches["unit"] if caches is not None else None
        h, new_unit_caches, aux = self._run_unit(
            params["unit"], h, positions, mode, unit_caches,
            enc_out=enc_out, enc_pos=enc_pos)
        new_rest = []
        for i, t in enumerate(self.rest):
            c_i = caches["rest"][i] if caches is not None else None
            h, nc, a = _block_apply(params["rest"][i], h, cfg, t,
                                    positions, mode, c_i, enc_out, enc_pos)
            new_rest.append(nc)
            aux = aux + a
        logits = self._head(params, h)
        new_caches = ({"unit": new_unit_caches, "rest": new_rest}
                      if mode != "train" else None)
        return logits, new_caches, aux

    def apply(self, params, tokens=None, embeds=None, positions=None,
              enc_out=None, enc_pos=None):
        logits, _, aux = self._forward(params, tokens, embeds, positions,
                                       "train", None, enc_out, enc_pos)
        return logits, aux

    @property
    def prefill_pad_safe(self) -> bool:
        """True when tail-padding a prompt cannot perturb the post-prefill
        cache.  Positional KV caches only hold pad entries at positions
        the decoder overwrites (or masks) before attending, but ``ssm`` /
        ``rec`` layers fold every pad token into their recurrent state --
        the serve engine's power-of-two prompt bucketing checks this
        before padding."""
        return not any(t in ("ssm", "rec")
                       for t in (*self.unit, *self.rest))

    def init_cache(self, batch: int, capacity: int):
        cfg, dev = self.cfg, self.device
        one_unit = {f"b{i}": _block_cache(cfg, t, batch, capacity, dev)
                    for i, t in enumerate(self.unit)}
        unit_cache = tree_map(
            lambda x: x[None].expand((self.n_units,) + x.shape).clone(),
            one_unit)
        rest = [_block_cache(cfg, t, batch, capacity, dev)
                for t in self.rest]
        return {"unit": unit_cache, "rest": rest}

    def prefill(self, params, tokens=None, embeds=None, capacity=None,
                enc_out=None, enc_pos=None):
        b, s = (tokens if tokens is not None else embeds).shape[:2]
        caches = self.init_cache(b, capacity or s)
        logits, caches, _ = self._forward(params, tokens, embeds, None,
                                          "prefill", caches,
                                          enc_out, enc_pos)
        return logits, caches

    def decode_step(self, params, caches, tokens, pos,
                    enc_out=None, enc_pos=None):
        """tokens: (B, 1); pos: (B,) int32."""
        positions = pos[:, None]
        logits, new_caches, _ = self._forward(
            params, tokens, None, positions, "decode", caches,
            enc_out, enc_pos)
        return logits, new_caches

    # -- loss -----------------------------------------------------------------
    def loss(self, params, batch):
        """Next-token cross entropy (+ MoE aux); forward only here."""
        tokens = batch["tokens"]
        enc_out = enc_pos = None
        if self.cfg.is_encdec:
            b, ss = batch["src_embeds"].shape[:2]
            enc_pos = torch.arange(ss, dtype=torch.int32,
                                   device=self.device).expand(b, ss)
            enc_out = self.encode(params, batch["src_embeds"], enc_pos)
        embeds = batch.get("embeds")
        logits, aux = self.apply(params, tokens=tokens, embeds=embeds,
                                 enc_out=enc_out, enc_pos=enc_pos)
        targets = tokens[:, 1:].long()
        lp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
        nll = -torch.gather(lp, -1, targets[..., None])[..., 0]
        return torch.mean(nll) + 0.01 * aux
