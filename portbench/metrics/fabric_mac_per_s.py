"""Simulated multiply-accumulates of the window's completed fabric jobs
(sum of M * K * N over every linear of every job that started in the
window) per second of wall time until the last one ended."""

UNIT = "MAC/s"
LAYER = "whole run"


def read(rec):
    return rec.work["macs"] / rec.window_s
