"""Output tokens of every request in the window (each prefill's first
token and every decoded token) per second of the window."""

UNIT = "tokens/s"
LAYER = "whole run"


def read(rec):
    return rec.work["tokens"] / rec.window_s
