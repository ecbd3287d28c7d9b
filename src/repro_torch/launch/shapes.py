"""Assigned input shapes and ``(shape, dtype)`` stand-ins for every
model input (no allocation: the dry-run makes fake tensors of them).

The counterpart of ``repro.launch.shapes``; ``input_specs`` gives
:class:`Spec` pairs with torch dtypes where the reference gives
``ShapeDtypeStruct``s.
"""

from __future__ import annotations

import dataclasses

import torch

SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}

ENC_SRC_LEN = 4096      # encoder source length for enc-dec decode shapes


def applicable(cfg, shape_name: str) -> bool:
    """long_500k needs sub-quadratic attention (DESIGN.md §5)."""
    if shape_name == "long_500k":
        return cfg.subquadratic
    return True


def skip_reason(cfg, shape_name: str) -> str:
    if shape_name == "long_500k" and not cfg.subquadratic:
        return ("full quadratic attention at 524k context: KV cache + "
                "attention do not fit; noted in DESIGN.md §5")
    return ""


@dataclasses.dataclass(frozen=True)
class Spec:
    """A model input's shape and dtype."""
    shape: tuple
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


def input_specs(cfg, shape_name: str) -> dict:
    """Specs for the step function of this (arch, shape)."""
    return specs_for(cfg, SHAPES[shape_name])


def specs_for(cfg, sh: dict) -> dict:
    """:func:`input_specs` of a shape given as a :data:`SHAPES` entry."""
    b, s = sh["batch"], sh["seq"]
    kind = sh["kind"]

    if kind == "train":
        batch = {"tokens": Spec((b, s), torch.int32)}
        if cfg.is_encdec:
            batch["src_embeds"] = Spec((b, s, cfg.d_model), torch.bfloat16)
        return {"batch": batch}

    if kind == "prefill":
        out = {"tokens": Spec((b, s), torch.int32)}
        if cfg.is_encdec:
            out["enc_out"] = Spec((b, ENC_SRC_LEN, cfg.d_model),
                                  torch.bfloat16)
            out["enc_pos"] = Spec((b, ENC_SRC_LEN), torch.int32)
        return out

    if kind == "decode":
        out = {"tokens": Spec((b, 1), torch.int32),
               "pos": Spec((b,), torch.int32)}
        if cfg.is_encdec:
            out["enc_out"] = Spec((b, ENC_SRC_LEN, cfg.d_model),
                                  torch.bfloat16)
            out["enc_pos"] = Spec((b, ENC_SRC_LEN), torch.int32)
        return out

    raise ValueError(kind)
