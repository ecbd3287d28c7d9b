"""The serve window's whole-step share of the chip's bf16 peak: model
FLOPs of the tokens it processed (every prompt token and every decoded
token through the matmuls and the head, plus attention over each
token's context) over the window, against the H100's dense bf16 rate."""

import pb_peaks

UNIT = "%"
LAYER = "whole step"


def read(rec):
    return 100 * rec.work["flops"] / (rec.window_s * pb_peaks.BF16_FLOPS)
