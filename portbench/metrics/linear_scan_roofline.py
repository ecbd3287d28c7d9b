"""The chunk-scan kernel's share of its roofline
(``kernels/linear_scan.py`` -> ``csrc/linear_scan.cu``, the Mamba
mixers' prefill scan): the least time the card could take for the
window's chunks, each chunk's decay and input read once, its states
written once and the state before it read once at the HBM rate
(``pb_jamba.scan_chunk_bytes``; its doubling rounds are a few float32
operations a byte, far under the card's rate), over the kernel's device
time in the trace."""

import pb_jamba
import pb_peaks

UNIT = "%"
LAYER = "kernels"
CALLS = ("repro_torch.kernels.linear_scan:linear_scan_cuda",)


def read(rec):
    calls = rec.calls.get(CALLS[0])
    if not calls or rec.trace is None:
        return None
    nbytes = sum(pb_jamba.scan_chunk_bytes(a, h) for a, _, h in calls)
    t = sum(v[1] for n, v in rec.trace["per_name"].items()
            if "linear_scan_chunk" in n)
    if t <= 0:
        return None
    return 100 * pb_peaks.bound_s(nbytes=nbytes) / t
