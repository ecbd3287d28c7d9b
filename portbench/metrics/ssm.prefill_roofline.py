"""The Mamba mixers' share of their roofline in the prefills: for each
``ssm_apply`` call inside ``ServeEngine._prefill_one`` the least time of
its work, the larger of its matmul FLOPs (input projection, ``x_proj``,
``dt_proj``, output projection; ``pb_jamba.mixer_flops``) at the bf16
peak and its bytes (the mixer's weights read once,
``pb_jamba.mixer_weight_bytes``, and its bf16 input read and output
written once) at the HBM rate, summed, over the wall of those calls
(each ended after the device finished).  The driver gives the model's
numbers in ``rec.work["ssm_mixer"]``; a call's tokens are its input's
batch times length (the harness's call record).  The scan itself (the
discretized decay and input, the chunk-scan kernel over float32 states,
the read-out through C) is in the wall and not in the work: the share
is how near the mixers come to their matmuls' bound."""

import bisect

import pb_peaks
import pb_spans

UNIT = "%"
LAYER = "model"
SSM_APPLY = "repro_torch.models.ssm:ssm_apply"
SPANS = (pb_spans.SERVE_PREFILL, SSM_APPLY)
CALLS = (SSM_APPLY,)


def read(rec):
    m = rec.work.get("ssm_mixer")
    pre, spans = rec.spans.get(pb_spans.SERVE_PREFILL), rec.spans.get(
        SSM_APPLY)
    calls = rec.calls.get(SSM_APPLY)
    if m is None or not pre or not spans or not calls \
            or len(calls) != len(spans):
        return None
    pre = sorted(pre)
    starts = [a for a, _ in pre]

    def in_prefill(c):
        i = bisect.bisect_right(starts, c[0]) - 1
        return i >= 0 and c[1] <= pre[i][1]

    bound = wall = 0.0
    for (t0, t1), args in zip(spans, calls):
        if not in_prefill((t0, t1)):
            continue
        b, s = args[1][:2]
        wall += t1 - t0
        bound += max(b * s * m["flops_per_token"] / pb_peaks.BF16_FLOPS,
                     (m["weight_bytes"] + b * s * m["row_bytes"])
                     / pb_peaks.HBM_BYTES_PER_S)
    if wall <= 0:
        return None
    return 100 * bound / wall
