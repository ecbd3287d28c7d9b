"""Configuration schema of the zoo's latent-attention MoE models, which the
port alone has (DeepSeek-V2, arXiv:2405.04434).

``base.py`` is a copy of the reference's schema and stays byte for byte
its own, so what DeepSeek-V2 adds lives here as subclasses:

* :class:`MLASpec` -- multi-head latent attention (§2.1): keys and
  values decompressed per head from a ``kv_lora_rank`` latent, a
  decoupled rotary key of ``qk_rope_head_dim`` shared by all heads, no
  query compression;
* :class:`YaRN` -- the rotary embedding's YaRN scaling, as DeepSeek's
  released code computes it (``rope_scaling`` of type ``yarn``);
* :class:`SharedMoESpec` -- DeepSeekMoE (§2.2): routed experts beside
  ``n_shared`` always-on experts, gates renormalised or not
  (``norm_topk_prob``) and scaled by ``routed_scaling_factor``;
* :class:`MLAConfig` -- a :class:`ModelConfig` with the three (an MLA
  model's rotary embedding is YaRN's), and ``first_k_dense`` leading
  layers whose FFN is the dense SwiGLU of width ``d_ff`` (the MoE layers
  follow).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

from .base import ModelConfig, MoESpec


@dataclasses.dataclass(frozen=True)
class MLASpec:
    kv_lora_rank: int            # width of the cached latent c
    qk_nope_head_dim: int        # per-head query/key dims without rotary
    qk_rope_head_dim: int        # rotary dims (one key head for all)
    v_head_dim: int

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class YaRN:
    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0

    @staticmethod
    def get_mscale(scale: float, mscale: float) -> float:
        """DeepSeek's ``yarn_get_mscale``."""
        return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0

    def correction_range(self, dim: int, base: float) -> Tuple[int, int]:
        """The rotary pair indices ``(low, high)`` between which YaRN ramps
        from extrapolation to interpolation (``yarn_find_correction_range``)."""
        def at(rot):
            return (dim * math.log(self.original_max_position
                                   / (rot * 2 * math.pi))
                    / (2 * math.log(base)))
        low = math.floor(at(self.beta_fast))
        high = math.ceil(at(self.beta_slow))
        return max(low, 0), min(high, dim - 1)

    @property
    def attn_scale(self) -> float:
        """Factor on the softmax scale: ``mscale(factor, mscale_all_dim)``
        squared."""
        return self.get_mscale(self.factor, self.mscale_all_dim) ** 2

    @property
    def cos_scale(self) -> float:
        """Factor on cos and sin: ``mscale(factor, mscale)`` over
        ``mscale(factor, mscale_all_dim)``."""
        return (self.get_mscale(self.factor, self.mscale)
                / self.get_mscale(self.factor, self.mscale_all_dim))


@dataclasses.dataclass(frozen=True)
class SharedMoESpec(MoESpec):
    n_shared: int = 0                    # shared experts, each of width d_ff
    norm_topk_prob: bool = True          # renormalise the top-k gates
    routed_scaling_factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class MLAConfig(ModelConfig):
    mla: Optional[MLASpec] = None
    rope_scaling: Optional[YaRN] = None
    first_k_dense: int = 0               # leading layers with the dense FFN

    def __post_init__(self):
        if self.kv_quant_bits:
            raise ValueError(
                f"{self.name}: kv_quant_bits={self.kv_quant_bits} has no "
                "meaning for the latent cache (it quantizes GQA's K/V)")

    def scan_plan(self) -> Tuple[List[str], int, List[str]]:
        """The stacked unit is the MoE layers after the leading ones."""
        return ["attn"], self.n_layers - self.first_k_dense, []

    def param_count(self) -> int:
        d, H, m, moe = self.d_model, self.n_heads, self.mla, self.moe
        attn = (d * H * m.qk_head_dim
                + d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank
                + m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
                + H * m.v_head_dim * d)
        norms = 2 * d
        dense = 3 * d * self.d_ff
        experts = (moe.num_experts + moe.n_shared) * 3 * d * moe.d_ff \
            + d * moe.num_experts
        k = self.first_k_dense
        total = self.n_layers * (attn + norms) + k * dense \
            + (self.n_layers - k) * experts
        total += self.vocab * d * (1 if self.tie_embeddings else 2) + d
        return int(total)

    def active_param_count(self) -> int:
        """Params a token touches: its top-k routed experts only."""
        moe = self.moe
        idle = (self.n_layers - self.first_k_dense) \
            * (moe.num_experts - moe.top_k) * 3 * self.d_model * moe.d_ff
        return int(self.param_count() - idle)
