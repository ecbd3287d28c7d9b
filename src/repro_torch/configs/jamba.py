"""Configuration schema of Jamba's hybrid stack, which the port alone has
(Jamba, arXiv:2403.19887; transformers' ``JambaConfig``).

``base.py`` is a copy of the reference's schema and stays byte for byte
its own, so what Jamba adds lives here as subclasses:

* :class:`JambaSSMSpec` -- Jamba's Mamba-1 mixer: the zoo's selective
  SSM with gained RMSNorms on the time step and on B and C
  (``inner_norms``), applied after ``x_proj`` and before ``dt_proj``;
* :class:`JambaConfig` -- a :class:`ModelConfig` whose layers are Mamba
  mixers but for one attention layer in every ``attn_layer_period``
  (at ``attn_layer_offset``), each mixer followed by an FFN that is the
  routed experts in every ``expert_layer_period``-th layer (at
  ``expert_layer_offset``) and the dense SwiGLU of width ``d_ff``
  elsewhere.  Its attention has no positional embedding
  (``rope_theta=None``, the port's switch for no rotation).  The
  stacked unit is one attention period of layers, so the period has to
  be a multiple of the expert period: a layer's FFN is then fixed by
  its place in the unit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .base import ModelConfig, SSMSpec


@dataclasses.dataclass(frozen=True)
class JambaSSMSpec(SSMSpec):
    inner_norms: bool = True     # RMSNorms with gains on dt, B and C


@dataclasses.dataclass(frozen=True)
class JambaConfig(ModelConfig):
    rope_theta: Optional[float] = None
    attn_layer_period: int = 8
    attn_layer_offset: int = 4
    expert_layer_period: int = 2
    expert_layer_offset: int = 1

    def __post_init__(self):
        if self.attn_layer_period % self.expert_layer_period:
            raise ValueError(
                f"{self.name}: attn_layer_period {self.attn_layer_period} "
                f"is no multiple of expert_layer_period "
                f"{self.expert_layer_period}")
        if self.n_layers % self.attn_layer_period:
            raise ValueError(
                f"{self.name}: n_layers {self.n_layers} is no whole number "
                f"of periods of {self.attn_layer_period}")

    def layer_types(self) -> List[str]:
        return ["attn" if i % self.attn_layer_period == self.attn_layer_offset
                else "ssm" for i in range(self.n_layers)]

    def moe_at(self, i: int) -> bool:
        """Whether layer ``i``'s FFN is the routed experts."""
        return i % self.expert_layer_period == self.expert_layer_offset

    def scan_plan(self) -> Tuple[List[str], int, List[str]]:
        """The stacked unit is one attention period of layers."""
        p = self.attn_layer_period
        return self.layer_types()[:p], self.n_layers // p, []

    def param_count(self) -> int:
        d, s, moe = self.d_model, self.ssm, self.moe
        di, dtr = s.expand * d, s.dt_rank
        mixer = {
            "attn": 2 * d * self.n_heads * self.hd
            + 2 * d * self.n_kv_heads * self.hd,
            # in/out projections, conv and its bias, x_proj, dt_proj and
            # its bias, A_log, D, and the inner norms' gains
            "ssm": (3 * d * di + di * (s.conv_width + 1)
                    + di * (dtr + 2 * s.state_dim) + (dtr + 1) * di
                    + di * s.state_dim + di
                    + (dtr + 2 * s.state_dim if s.inner_norms else 0))}
        dense = 3 * d * self.d_ff
        experts = moe.num_experts * 3 * d * moe.d_ff + d * moe.num_experts
        total = sum(mixer[t] + 2 * d + (experts if self.moe_at(i) else dense)
                    for i, t in enumerate(self.layer_types()))
        total += self.vocab * d * (1 if self.tie_embeddings else 2) + d
        return int(total)

    def active_param_count(self) -> int:
        """Params a token touches: its top-k routed experts only."""
        moe = self.moe
        n_moe = sum(self.moe_at(i) for i in range(self.n_layers))
        idle = n_moe * (moe.num_experts - moe.top_k) * 3 * self.d_model \
            * moe.d_ff
        return int(self.param_count() - idle)
