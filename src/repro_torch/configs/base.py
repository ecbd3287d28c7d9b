"""Model/architecture configuration schema for the 10-arch zoo."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden size
    capacity_factor: float = 1.25
    # 1 = global sort-based dispatch (replicated expert buffer -> big
    # all-reduce).  >1 = hierarchical dispatch: tokens dispatched within
    # data-parallel chunks into per-chunk expert buffers; the buffer's
    # chunk dim lands on the data axes and its expert dim on the model
    # axis, so only an all-to-all-sized reshard remains (EXPERIMENTS.md
    # §Perf iteration 1).
    dispatch_chunks: int = 1


@dataclasses.dataclass(frozen=True)
class SSMSpec:                   # Mamba-1 selective SSM
    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None   # None -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class RGLRUSpec:                 # RecurrentGemma / Griffin
    lru_width: Optional[int] = None   # None -> d_model
    conv_width: int = 4
    window: int = 2048           # local-attention window in the 1:2 mix


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    sliding_window: Optional[int] = None   # SWA (mistral-style)
    rope_theta: float = 10_000.0
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    rglru: Optional[RGLRUSpec] = None
    encoder_layers: int = 0      # > 0 => encoder-decoder
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    mlp_variant: str = "swiglu"          # swiglu (3 mats) | gelu (2 mats)
    kv_quant_bits: Optional[int] = None  # 8 => int8 KV cache (PIM storage)
    remat_policy: str = "full"           # full | dots | none (train remat)
    # modality frontend stub: inputs arrive as precomputed embeddings
    # ("frames"/"patches") concatenated with token embeddings.
    frontend_stub: Optional[str] = None    # None | "patch" | "frame"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    # ---- layer plan for scan-over-layers ---------------------------------
    def layer_types(self) -> List[str]:
        if self.ssm is not None:
            return ["ssm"] * self.n_layers
        if self.rglru is not None:
            # Griffin pattern: (rec, rec, local attn) repeating
            pattern = ["rec", "rec", "attn"]
            return [pattern[i % 3] for i in range(self.n_layers)]
        return ["attn"] * self.n_layers

    def scan_plan(self) -> Tuple[List[str], int, List[str]]:
        """(repeating unit, repeat count, remainder) for lax.scan."""
        types = self.layer_types()
        if self.rglru is not None:
            unit = ["rec", "rec", "attn"]
            n = len(types) // 3
            return unit, n, types[3 * n:]
        return [types[0]], len(types), []

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context with bounded state?"""
        return (self.ssm is not None or self.rglru is not None
                or self.sliding_window is not None)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    # approximate parameter count (for 6ND roofline bookkeeping)
    def param_count(self) -> int:
        d, hd = self.d_model, self.hd
        n_attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        nmat = 3 if self.mlp_variant == "swiglu" else 2
        if self.moe:
            n_ffn = self.moe.num_experts * 3 * d * self.moe.d_ff \
                + d * self.moe.num_experts
        else:
            n_ffn = nmat * d * self.d_ff
        per_layer = {"attn": n_attn + n_ffn, "ssm": 0, "rec": 0}
        if self.ssm:
            di = self.ssm.expand * d
            dtr = self.ssm.dt_rank or -(-d // 16)
            per_layer["ssm"] = (d * 2 * di + di * self.ssm.conv_width
                                + di * (dtr + 2 * self.ssm.state_dim)
                                + dtr * di + di * self.ssm.state_dim
                                + di * d + n_ffn)
        if self.rglru:
            w = self.rglru.lru_width or d
            per_layer["rec"] = (2 * d * w + w * self.rglru.conv_width
                                + 2 * w * w // 1 + w * d + n_ffn)
        total = sum(per_layer[t] for t in self.layer_types())
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        total += self.encoder_layers * (n_attn * 2 + n_ffn)
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        moe_all = self.n_layers * self.moe.num_experts * 3 * self.d_model \
            * self.moe.d_ff
        moe_active = self.n_layers * self.moe.top_k * 3 * self.d_model \
            * self.moe.d_ff
        return int(full - moe_all + moe_active)
