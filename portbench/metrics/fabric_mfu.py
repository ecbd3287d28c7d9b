"""The fabric stream's whole-step share of the chip's peak: two
operations per simulated MAC over the window, against the H100's dense
int8 tensor-core rate.  It bounds every kernel's share whatever path the
jobs take."""

import pb_peaks

UNIT = "%"
LAYER = "whole step"


def read(rec):
    return 100 * 2 * rec.work["macs"] / (rec.window_s
                                          * pb_peaks.INT8_OPS_PER_S)
