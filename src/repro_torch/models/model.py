"""LM assembly: embeds -> stacked layer groups -> norm -> logits.

The counterpart of ``repro.models.model``.  Layers are stacked per
repeating unit, as in the reference: every leaf under ``"unit"`` has a
leading layer axis, and the reference's ``lax.scan`` over that axis is a
loop that indexes it.  A config with leading dense layers
(``first_k_dense``, DeepSeek-V2's) keeps them as a list under
``"lead"``, ahead of the stacked unit, and their caches so; an MLA
config's attention blocks are ``models/mla.py``'s, with its latent cache
under ``"mla"`` in place of ``"kv"``.  Three execution modes:

* ``apply``       -- full-sequence forward (training, encoder)
* ``prefill``     -- full-sequence forward that also emits decode caches
* ``decode_step`` -- one token with ring-buffer KV / recurrent state,
  written in place into the caches it is given: each attention layer
  writes each lane's ring slot, each recurrent layer its new state, all
  through the views of the stacked caches that the layer loop hands out
  (nothing is restacked), so the caches keep their addresses

``LM(cfg, device=None)`` runs on ``device`` (``None``: the GPU; it raises
when there is none).  When autograd records a ``"train"`` forward, each
layer is rematerialized by ``cfg.remat_policy`` as the reference's
``jax.checkpoint`` does (the encoder stack always in full):
``torch.utils.checkpoint`` per layer for ``"full"``, selective
checkpointing that saves the matmuls without batch dims for ``"dots"``.
Gradients are the same under every policy; prefill and decode never
rematerialize.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import trace
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import resolve_device
from . import attention as attn
from . import common, mla as mla_mod, moe as moe_mod, rglru as rg
from . import ssm as ssm_mod
from .common import (dense_init, mlp_apply, per_shard, rmsnorm, shard,
                     shard_like)
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


# ---------------------------------------------------------------------------
# Blocks (one per layer type)
# ---------------------------------------------------------------------------
def _is_mla(cfg) -> bool:
    return getattr(cfg, "mla", None) is not None


def _block_init(key, cfg: ModelConfig, btype: str, device=None,
                dense=False):
    """``dense``: the layer's FFN is the dense MLP whatever ``cfg.moe``
    says (a leading layer, or a hybrid's layer without experts).  An
    ``ssm`` block of a config with an FFN (Jamba's) has one after its
    mixer, as an attention block does."""
    d = cfg.d_model
    ks = common.split_keys(key, 4)

    def norm():
        return torch.zeros((d,), dtype=torch.float32, device=device)

    def ffn(k):
        p["ln2"] = norm()
        if cfg.moe is not None and not dense:
            p["moe"] = moe_mod.moe_init(k, cfg, device=device)
        elif cfg.d_ff > 0:
            p["mlp"] = mlp_init(k, cfg, device=device)

    p = {"ln1": norm()}
    if btype == "attn":
        p["attn"] = (mla_mod.mla_init if _is_mla(cfg) else attn.attn_init)(
            ks[0], cfg, device=device)
        ffn(ks[1])
    elif btype == "xattn":       # decoder layer of an encoder-decoder
        p["attn"] = attn.attn_init(ks[0], cfg, device=device)
        p["lnx"] = norm()
        p["xattn"] = attn.attn_init(ks[1], cfg, cross=True, device=device)
        p["ln2"] = norm()
        p["mlp"] = mlp_init(ks[2], cfg, device=device)
    elif btype == "ssm":
        p["ssm"] = ssm_mod.ssm_init(ks[0], cfg, device=device)
        if cfg.moe is not None or cfg.d_ff > 0:
            ffn(ks[1])
    elif btype == "rec":
        p["rec"] = rg.rglru_init(ks[0], cfg, device=device)
        p["ln2"] = norm()
        p["mlp"] = mlp_init(ks[1], cfg, device=device)
    else:
        raise ValueError(btype)
    return p


def _dense_at(cfg, i: int) -> bool:
    """Whether layer ``i`` of a hybrid whose FFN kind varies by layer
    (``moe_at``, Jamba's) takes the dense MLP."""
    moe_at = getattr(cfg, "moe_at", None)
    return moe_at is not None and not moe_at(i)


def _window_for(cfg, btype):
    if cfg.rglru is not None and btype == "attn":
        return cfg.rglru.window
    return cfg.sliding_window


def _ffn(params, cfg, x, mode="train", layer=0):
    if "moe" in params:
        y, aux = moe_mod.moe_apply(params["moe"], x, cfg, mode, layer)
        return y, aux
    if "mlp" in params:
        return mlp_apply(params["mlp"], x), 0.0
    return None, 0.0


def _write_state(cache, new):
    """A recurrent layer's new state ``new`` copied into its decode cache
    ``cache`` leaf by leaf (in place, shard by shard on a mesh); returns
    ``cache``."""
    for n, t in cache.items():
        per_shard(lambda t, v: t.copy_(v), t, shard_like(new[n], t),
                  out_like=t)
    return cache


def _block_apply(params, h, cfg, btype, positions, mode, cache,
                 enc_out=None, enc_pos=None, causal=True, layer=0):
    """Returns (h, new_cache, aux).  In decode the new cache is ``cache``,
    written in place.  An attention block records the span
    ``model.attention`` (its norm, attention, KV write and residual), a
    Mamba block ``model.ssm`` (norm, mixer, state write and residual),
    and a block with an FFN ``model.mlp`` (norm, FFN and residual).
    ``layer`` is the layer's index in the model (the MoE's device
    counters)."""
    new_cache = {}

    if btype == "attn" and _is_mla(cfg):
        with trace.span("model.attention"):
            x = rmsnorm(h, params["ln1"], cfg.norm_eps)
            if mode == "decode":
                y, new_cache["mla"] = mla_mod.mla_decode(
                    params["attn"], x, cache["mla"], cfg, positions[:, 0])
            else:
                cap = (cache["mla"]["c"].shape[1] if mode == "prefill"
                       else None)
                y, c = mla_mod.mla_apply(params["attn"], x, cfg, positions,
                                         cap)
                if mode == "prefill":
                    new_cache["mla"] = c
            h = h + y
    elif btype in ("attn", "xattn"):
        with trace.span("model.attention"):
            x = rmsnorm(h, params["ln1"], cfg.norm_eps)
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
                        params["attn"], x, cfg, positions, cap,
                        window=window)
            h = h + y
            if btype == "xattn":
                xx = rmsnorm(h, params["lnx"], cfg.norm_eps)
                y = attn.attn_apply(params["xattn"], xx, cfg, positions,
                                    causal=False, kv_src=enc_out,
                                    kv_positions=enc_pos)
                h = h + y
    elif btype in ("ssm", "rec"):
        mixer = (ssm_mod.ssm_apply if btype == "ssm" else rg.rglru_apply)
        with (trace.span("model.ssm") if btype == "ssm" else trace.NULL):
            x = rmsnorm(h, params["ln1"], cfg.norm_eps)
            y, c = mixer(params[btype], x, cfg,
                         cache=cache[btype] if mode == "decode" else None)
            if mode == "decode":
                c = _write_state(cache[btype], c)
            if mode != "train":
                new_cache[btype] = c
            h = h + y
    else:
        raise ValueError(btype)

    aux = 0.0
    if "ln2" in params:
        with trace.span("model.mlp"):
            f = rmsnorm(h, params["ln2"], cfg.norm_eps)
            y, aux = _ffn(params, cfg, f, mode, layer)
            if y is not None:
                h = h + y
    return h, new_cache, aux


def _block_cache(cfg, btype, batch, capacity, device=None):
    if btype == "attn" and _is_mla(cfg):
        return {"mla": mla_mod.init_mla_cache(cfg, batch, capacity,
                                              device=device)}
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


def _unstack(tree):
    """A stacked tree as the list of its layers: one ``unbind`` per leaf,
    whose backward is one ``stack`` of the layers' gradients (indexing
    each layer would build a zero-filled full-size gradient per layer)."""
    cols = [torch.unbind(x) for x in tree_leaves(tree)]

    def layer(i):
        it = iter([c[i] for c in cols])
        return tree_map(lambda _: next(it), tree)

    return [layer(i) for i in range(len(cols[0]))]


def _positions(x):
    """int32 ``arange(S)`` for each row of ``x`` (B, S, ...), in ``x``'s
    layout: batch-sharded with it on a mesh, fake with it in a dry-run
    (a plain arange would be the whole (B, S) on every rank)."""
    rows = x if x.ndim == 2 else x[:, :, 0]
    return torch.zeros_like(rows, dtype=torch.int32) + torch.arange(
        x.shape[1], dtype=torch.int32, device=x.device)


_aten = torch.ops.aten


def _dots_saveable(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the outputs of the matmuls without batch dims (``mm``/``addmm``, and
    the batch-1 ``bmm`` that ``einsum`` makes of such a product) and
    recompute everything else."""
    if op in (_aten.mm.default, _aten.addmm.default) or (
            op is _aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(body, policy):
    """``body`` rematerialized by ``policy`` ("full" / "dots")."""
    kw = {"use_reentrant": False}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_saveable)
    return functools.partial(checkpoint, body, **kw)


# ---------------------------------------------------------------------------
# The vocabulary split on the mesh: the lookup and the loss each rank
# computes on its own rows of the table and columns of the logits, as the
# reference's GSPMD program partitions them (no all-gather)
# ---------------------------------------------------------------------------
def _vocab_parallel_embedding(tokens, table, ax):
    """``F.embedding(tokens, table)`` in bfloat16 for a table split by
    rows on mesh axis ``ax``.  Each rank looks up its own rows (a token
    it does not hold reads row 0, zeroed) and the result is ``Partial``
    on ``ax``: the next ``shard`` sums it there.  One rank contributes
    each row and the others zeros, so the sum is exact, in bfloat16.  The
    table's gradient is each rank's own scatter, ``Partial`` on the axes
    that split the tokens (the data-parallel sum), no collective on
    ``ax``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    rows = table.to_local().shape[0]
    start = mesh.get_local_rank(ax) * rows

    def lookup(ids, w):
        ids = ids - start
        mine = (ids >= 0) & (ids < rows)
        e = torch.nn.functional.embedding(torch.where(mine, ids, 0), w)
        return torch.where(mine[..., None], e.to(torch.bfloat16), 0)

    tok = tuple(tokens.placements)
    out = tuple(Partial() if i == ax else p for i, p in enumerate(tok))
    grad = tuple(Shard(0) if i == ax else
                 Partial() if isinstance(p, Shard) else Replicate()
                 for i, p in enumerate(tok))
    return local_map(lookup, out_placements=(out,),
                     in_placements=(tok, tuple(table.placements)),
                     in_grad_placements=(tok, grad),
                     device_mesh=mesh)(tokens, table)


class _SplitNLL(torch.autograd.Function):
    """Next-token NLL from this rank's columns ``[start, start + V/n)`` of
    the float32 logits, the row max, the sum of exponentials and the
    target's logit each all-reduced over ``group``; the gradient needs
    no collective."""

    @staticmethod
    def forward(ctx, logits, targets, start, group):
        import torch.distributed._functional_collectives as funcol

        def all_reduce(x, op):
            return funcol.wait_tensor(funcol.all_reduce(x, op, group))

        cols = torch.arange(logits.shape[-1], device=logits.device)
        hit = cols == (targets - start)[..., None]
        m = all_reduce(logits.amax(-1), "max")
        se = all_reduce(torch.exp(logits - m[..., None]).sum(-1), "sum")
        # one column holds the target, the others add zeros: exact
        t = all_reduce(torch.where(hit, logits, 0.0).sum(-1), "sum")
        ctx.save_for_backward(logits, targets, m, se)
        ctx.start = start
        return -((t - m) - torch.log(se))

    @staticmethod
    def backward(ctx, g):
        logits, targets, m, se = ctx.saved_tensors
        cols = torch.arange(logits.shape[-1], device=logits.device)
        hit = cols == (targets - ctx.start)[..., None]
        p = torch.exp(logits - m[..., None]) / se[..., None]
        return (p - hit.to(p.dtype)) * g[..., None], None, None, None


def _vocab_parallel_nll(logits, targets, ax):
    """``-log_softmax(logits)[targets]`` for float32 logits split along the
    vocabulary on mesh axis ``ax``, replicated there: the reference's
    log-softmax as GSPMD partitions it (``_SplitNLL``)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    start = mesh.get_local_rank(ax) * logits.to_local().shape[-1]
    out = tuple(Replicate() if i == ax else p
                for i, p in enumerate(logits.placements))
    targets = targets.redistribute(mesh, out)
    return local_map(
        lambda lg, tg: _SplitNLL.apply(lg, tg, start, (mesh, ax)),
        out_placements=(out,),
        in_placements=(tuple(logits.placements), out),
        device_mesh=mesh)(logits, targets)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
class LM:
    """Decoder-only LM (also hosts the encoder stack for enc-dec)."""

    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.unit, self.n_units, self.rest = cfg.scan_plan()
        # leading layers before the stacked unit, each with the dense FFN
        self.lead = ["attn"] * getattr(cfg, "first_k_dense", 0)
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
            # a unit is whole periods of the layer plan, so a place in
            # the unit fixes its layers' FFN kind
            first = len(self.lead)
            return {f"b{i}": _block_init(key, cfg, t, dev,
                                         dense=_dense_at(cfg, first + i))
                    for i, t in enumerate(self.unit)}

        params = {"embed": dense_init(key, (cfg.vocab, cfg.d_model),
                                      device=dev)}
        if self.lead:
            params["lead"] = [_block_init(key, cfg, t, dev, dense=True)
                              for t in self.lead]
        params.update({
            "unit": _stack([unit_init() for _ in range(self.n_units)]),
            "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                      device=dev),
        })
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
                  enc_out=None, enc_pos=None, causal=True, remat=None,
                  first=0):
        """``remat``: the policy of a training forward (``None``: the
        config's ``remat_policy``); ``first``: the model's index of the
        unit's first layer.  A decode writes each layer's caches through
        their views ``_layer(caches, i)`` and returns ``caches``."""
        cfg = self.cfg
        unit = unit or self.unit
        remat = remat or cfg.remat_policy

        def body(lp, h, lc, layer):
            new_lc, aux = {}, 0.0
            for i, t in enumerate(unit):
                c_i = lc[f"b{i}"] if lc is not None else None
                h, nc, a = _block_apply(lp[f"b{i}"], h, cfg, t, positions,
                                        mode, c_i, enc_out, enc_pos, causal,
                                        first + layer * len(unit) + i)
                new_lc[f"b{i}"] = nc
                aux = aux + a
            return h, new_lc, aux

        if mode == "train" and remat != "none" and torch.is_grad_enabled():
            body = _remat(body, remat)
        new_caches, aux = [], 0.0
        for layer, lp in enumerate(_unstack(stacked)):
            h, new_lc, a = body(lp, h, _layer(caches, layer), layer)
            new_caches.append(new_lc)
            aux = aux + a
        if mode == "decode":
            return h, caches, aux
        return h, _stack(new_caches), aux

    def _embed(self, params, tokens=None, embeds=None):
        if embeds is not None:
            return embeds
        table = dq(params["embed"])
        ax = common.split_on(table, "model", 0)
        if ax is not None:
            e = _vocab_parallel_embedding(tokens, table, ax)
        else:
            e = torch.nn.functional.embedding(tokens, table).to(
                torch.bfloat16)
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
                                 None, unit=["attn"], causal=False,
                                 remat="full")
        return rmsnorm(h, enc["final_norm"], self.cfg.norm_eps)

    # -- public entry points --------------------------------------------------
    def _forward(self, params, tokens, embeds, positions, mode, caches,
                 enc_out=None, enc_pos=None):
        cfg = self.cfg
        if positions is None:
            positions = _positions(tokens if tokens is not None else embeds)
        with trace.span("model.embed"):
            h = self._embed(params, tokens, embeds)
        aux = 0.0
        new_lead = []
        for i, t in enumerate(self.lead):
            c_i = caches["lead"][i] if caches is not None else None
            h, nc, a = _block_apply(params["lead"][i], h, cfg, t, positions,
                                    mode, c_i, layer=i)
            new_lead.append(nc)
            aux = aux + a
        unit_caches = caches["unit"] if caches is not None else None
        first = len(self.lead)
        h, new_unit_caches, a = self._run_unit(
            params["unit"], h, positions, mode, unit_caches,
            enc_out=enc_out, enc_pos=enc_pos, first=first)
        aux = aux + a
        first += self.n_units * len(self.unit)
        new_rest = []
        for i, t in enumerate(self.rest):
            c_i = caches["rest"][i] if caches is not None else None
            h, nc, a = _block_apply(params["rest"][i], h, cfg, t,
                                    positions, mode, c_i, enc_out, enc_pos,
                                    layer=first + i)
            new_rest.append(nc)
            aux = aux + a
        with trace.span("model.head"):
            logits = self._head(params, h)
        new_caches = None
        if mode == "decode":
            new_caches = caches                 # written in place
        elif mode == "prefill":
            new_caches = {"unit": new_unit_caches, "rest": new_rest}
            if self.lead:
                new_caches["lead"] = new_lead
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

    def init_cache(self, batch: int, capacity: int, device=None):
        """Zero decode caches on ``device`` (``None``: the model's)."""
        cfg, dev = self.cfg, device or self.device
        one_unit = {f"b{i}": _block_cache(cfg, t, batch, capacity, dev)
                    for i, t in enumerate(self.unit)}
        unit_cache = tree_map(
            lambda x: x[None].expand((self.n_units,) + x.shape).clone(),
            one_unit)
        rest = [_block_cache(cfg, t, batch, capacity, dev)
                for t in self.rest]
        caches = {"unit": unit_cache, "rest": rest}
        if self.lead:
            caches["lead"] = [_block_cache(cfg, t, batch, capacity, dev)
                              for t in self.lead]
        return caches

    def prefill(self, params, tokens=None, embeds=None, capacity=None,
                enc_out=None, enc_pos=None):
        b, s = (tokens if tokens is not None else embeds).shape[:2]
        # a prefill writes its caches anew (a recurrent layer starts from
        # zeros): only their shapes are read, so they are made on "meta"
        caches = self.init_cache(b, capacity or s, device="meta")
        logits, caches, _ = self._forward(params, tokens, embeds, None,
                                          "prefill", caches,
                                          enc_out, enc_pos)
        return logits, caches

    def decode_step(self, params, caches, tokens, pos,
                    enc_out=None, enc_pos=None):
        """tokens: (B, 1); pos: (B,) int32.  Writes the step's entries into
        ``caches`` in place and returns ``(logits, caches)``."""
        positions = pos[:, None]
        logits, new_caches, _ = self._forward(
            params, tokens, None, positions, "decode", caches,
            enc_out, enc_pos)
        return logits, new_caches

    # -- loss -----------------------------------------------------------------
    def loss(self, params, batch):
        """Next-token cross entropy (+ MoE aux)."""
        tokens = batch["tokens"]
        enc_out = enc_pos = None
        if self.cfg.is_encdec:
            enc_pos = _positions(batch["src_embeds"])
            enc_out = self.encode(params, batch["src_embeds"], enc_pos)
        embeds = batch.get("embeds")
        logits, aux = self.apply(params, tokens=tokens, embeds=embeds,
                                 enc_out=enc_out, enc_pos=enc_pos)
        targets = tokens[:, 1:].long()
        logits = logits[:, :-1].to(torch.float32)
        ax = common.split_on(logits, "model", -1)
        if ax is not None:
            nll = _vocab_parallel_nll(logits, targets, ax)
        else:
            lp = torch.log_softmax(logits, dim=-1)
            # take_along_axis(lp, targets) as a masked sum over the vocab:
            # exact (one term and zeros), and its backward keeps lp's
            # layout on a mesh, where a gather's backward scatters into
            # zeros of the global shape on every rank
            hit = torch.arange(lp.shape[-1], device=lp.device) \
                == targets[..., None]
            nll = -torch.sum(torch.where(hit, lp, 0.0), dim=-1)
        return torch.mean(nll) + 0.01 * aux
