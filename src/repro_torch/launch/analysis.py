"""Roofline terms and collective accounting for dry-run cells.

The counterpart of ``repro.launch.analysis``, for one NVIDIA H100 SXM5
80GB at its 700 W power limit (NVIDIA H100 Tensor Core GPU data sheet,
dense rates without sparsity):

compute term    = FLOPs / (chips * 989.4e12)            [bf16 tensor cores]
memory term     = bytes / (chips * 3.35e12)             [HBM3]
collective term = collective_bytes / (chips * 450e9)    [NVLink, a direction]

The reference parses collectives out of XLA's optimized HLO text and
scales loop bodies by their trip counts.  The port has no HLO: its
dry-run runs the step eagerly on fake tensors, every layer of the loop
included (so there is no trip count to scale by), and
:class:`CollectiveRecorder` records each functional collective that
rank 0's program runs.  :func:`collective_bytes` sums them with the
reference's convention: each op counts its largest operand or result
(an all-gather its gathered result), an all-reduce twice.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989.4e12   # dense bf16 tensor-core FLOP/s (H100 SXM5, 700 W)
HBM_BW = 3.35e12        # HBM3 bytes/s (H100 SXM5 80GB)
ICI_BW = 450e9          # NVLink 4 bytes/s a direction (900 GB/s both)

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# functional collectives (``torch.ops._c10d_functional`` and DTensor's
# own) by the reference's HLO kind
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "_dtensor")


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    total_bytes: float
    count: int


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def collective_kind(func):
    """The reference's kind of a collective op, or ``None``."""
    packet = getattr(func, "_overloadpacket", None)
    if packet is None or func.namespace not in _NAMESPACES:
        return None
    name = packet.__name__
    if name in _KINDS:
        return _KINDS[name]
    if any(w in name for w in ("all_", "reduce", "scatter", "gather",
                               "permute", "broadcast")):
        raise NotImplementedError(f"collective {func} has no kind")
    return None                        # wait_tensor and other plumbing


class CollectiveRecorder(TorchDispatchMode):
    """Records ``(kind, bytes)`` for every collective this rank runs
    while it is active: the largest operand or result of the op.  It
    lets DTensor ops pass, so it sees the collectives and local ops
    they lower to."""

    def __init__(self):
        super().__init__()
        self.records = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = collective_kind(func)
        if kind is not None:
            ts = [*_tensors(args), *_tensors(list(kwargs.values())),
                  *_tensors(out)]
            self.records.append((kind, max((_nbytes(t) for t in ts),
                                           default=0)))
        return out


def collective_bytes(records) -> CollectiveStats:
    by_kind = {k: 0.0 for k in _COLLECTIVES}
    for kind, b in records:
        factor = 2.0 if kind == "all-reduce" else 1.0
        by_kind[kind] += b * factor
    return CollectiveStats(by_kind, sum(by_kind.values()), len(records))


def analytic_terms(cfg, shape_name: str, chips: int) -> dict:
    """Closed-form FLOP/byte estimates (MODEL_FLOPS = 6ND etc.).

    The trustworthy absolute scale beside the counted numbers, which
    validate structure."""
    from repro_torch.launch.shapes import SHAPES
    return terms_for(cfg, SHAPES[shape_name], chips)


def terms_for(cfg, sh: dict, chips: int) -> dict:
    """:func:`analytic_terms` of a shape given as a ``SHAPES`` entry."""
    b, s = sh["batch"], sh["seq"]
    kind = sh["kind"]
    n_active = cfg.active_param_count()
    n_total = cfg.param_count()
    L, H, hd = cfg.n_layers, cfg.n_heads, cfg.hd

    attn_ctx = min(s, cfg.sliding_window or s)
    if cfg.rglru is not None:
        attn_layers = sum(1 for t in cfg.layer_types() if t == "attn")
        attn_ctx = min(s, cfg.rglru.window)
    elif cfg.ssm is not None:
        attn_layers = 0
    else:
        attn_layers = L

    if kind == "train":
        tokens = b * s
        flops = 6.0 * n_active * tokens \
            + 12.0 * attn_layers * b * s * attn_ctx * H * hd / 2
        # params+opt traffic (fwd read, bwd read, update rw) + activations
        bytes_ = (2 * n_total * 3) + (8.0 * n_total * 2) \
            + 4.0 * L * tokens * cfg.d_model * 2
    elif kind == "prefill":
        tokens = b * s
        flops = 2.0 * n_active * tokens \
            + 4.0 * attn_layers * b * s * attn_ctx * H * hd / 2
        bytes_ = 2.0 * n_total + 2.0 * L * tokens * cfg.d_model * 2
    else:  # decode: one token per sequence, full context in cache
        tokens = b
        ctx = attn_ctx
        flops = 2.0 * n_active * tokens \
            + 4.0 * attn_layers * b * ctx * H * hd
        kv_elt = {None: 2, 8: 1, 4: 0.5}[cfg.kv_quant_bits]
        kv_bytes = 2 * attn_layers * b * ctx * cfg.n_kv_heads * hd * kv_elt
        bytes_ = 2.0 * n_total + kv_bytes
    return {
        "analytic_flops": float(flops),
        "analytic_bytes": float(bytes_),
        "model_flops_6nd": float(6.0 * n_active * b * s) if kind == "train"
        else float(2.0 * n_active * (b * s if kind == "prefill" else b)),
    }


def roofline(flops: float, hbm_bytes: float, coll_bytes: float,
             chips: int) -> dict:
    t_comp = flops / (chips * PEAK_FLOPS)
    t_mem = hbm_bytes / (chips * HBM_BW)
    t_coll = coll_bytes / (chips * ICI_BW)
    dominant = max((t_comp, "compute"), (t_mem, "memory"),
                   (t_coll, "collective"))[1]
    bound = max(t_comp, t_mem, t_coll)
    return {
        "t_compute_s": t_comp, "t_memory_s": t_mem,
        "t_collective_s": t_coll, "dominant": dominant,
        "roofline_s": bound,
        "roofline_frac_compute": t_comp / bound if bound else 0.0,
    }
