"""The yardstick's peaks and the operations and bytes of the work.

Peaks of one NVIDIA H100 SXM5 80GB, NVIDIA's data sheet (dense rates,
no sparsity, at the 700 W power limit): HBM3 3.35 TB/s; bf16 tensor
cores 989 TFLOP/s; int8 tensor cores 1,979 TOP/s.  A share of a peak is
stated against these with the card's power limit beside it.
"""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS_PER_S = 1979e12


def bound_s(nbytes=0, ops=0, ops_per_s=INT8_OPS_PER_S) -> float:
    """Least time for the work: the larger of its bytes at the HBM rate
    and its operations at ``ops_per_s``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def lane_fold_bytes(x_shape, width) -> int:
    """Bytes one ``lane_fold`` needs: its ``(m, T, W)`` int32 input words
    read once and its ``(width, W)`` int32 output planes written once."""
    m, lanes, words = x_shape
    return 4 * (m * lanes * words + width * words)


def lm_matmul_flops(mc) -> int:
    """Forward FLOPs of one token through the model's matmuls: the
    attention projections, the MLP and the output head (2 per
    multiply-add; the embedding lookup is no matmul)."""
    d, hq, hkv = mc.d_model, mc.n_heads * mc.hd, mc.n_kv_heads * mc.hd
    mats = 3 if mc.mlp_variant == "swiglu" else 2
    per_layer = d * (hq + 2 * hkv) + hq * d + mats * d * mc.d_ff
    return 2 * (mc.n_layers * per_layer + d * mc.vocab)


def attention_flops(mc, keys) -> int:
    """Forward FLOPs of one query attending over ``keys`` cached keys in
    every layer: scores and the weighted sum of values, each 2 per
    multiply-add per head and head dimension."""
    window = mc.sliding_window
    k = min(keys, window) if window else keys
    return 2 * 2 * mc.n_layers * mc.n_heads * mc.hd * k
