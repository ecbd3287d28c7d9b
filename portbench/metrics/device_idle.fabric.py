"""Share of the traced window in which no operation ran on the device
(the window minus the union of the profiler's device intervals), in the
fabric cells."""

UNIT = "%"
LAYER = "device"


def read(rec):
    if rec.trace is None:
        return None
    return 100 * (1 - rec.trace["busy_s"] / rec.window_s)
