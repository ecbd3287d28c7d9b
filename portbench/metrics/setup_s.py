"""Set-up time: from process start to the window (imports, extension
load, weights, packing, warm-up), on the host's clock."""

UNIT = "s"
LAYER = "whole run"


def read(rec):
    return rec.setup_s
