"""``lane_fold``'s share of its roofline (``kernels/bitplane_ops.py`` ->
``csrc/lane_fold.cu``): the least time the card could take for the
window's folds, the input words read once and the output planes written
once at the HBM rate (the fold has no multiply; its adds are a few
per byte, far under the integer rate), over the fold kernels' device
time in the trace."""

import pb_peaks

UNIT = "%"
LAYER = "kernels"
CALLS = ("repro_torch.kernels.bitplane_ops:lane_fold_cuda",)


def read(rec):
    calls = rec.calls.get(CALLS[0])
    if not calls or rec.trace is None:
        return None
    nbytes = sum(pb_peaks.lane_fold_bytes(x, width) for x, width in calls)
    t = sum(v[1] for n, v in rec.trace["per_name"].items()
            if "lane_fold" in n)
    if t <= 0:
        return None
    return 100 * pb_peaks.bound_s(nbytes=nbytes) / t
