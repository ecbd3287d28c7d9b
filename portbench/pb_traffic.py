"""The general traffic generator: every mix is parameters in a data file
that these functions read.

Lengths come from a fixed pool: the ``n`` midpoint quantiles of a
lognormal through the mix's median and 99th percentile, rounded and
clipped to its range.  Every seed serves the same pool of sizes in its own order, so
the seed changes which tokens and in what order, not how much work."""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def length_pool(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths of ``spec`` = ``{"median", "p99", "min", "max"}``:
    a lognormal through its median and 99th percentile (sigma =
    ln(p99 / median) / z(0.99)), rounded and clipped to [min, max]."""
    z = NormalDist()
    mu = math.log(spec["median"])
    sigma = math.log(spec["p99"] / spec["median"]) / z.inv_cdf(0.99)
    out = [math.exp(mu + sigma * z.inv_cdf((i + 0.5) / n))
           for i in range(n)]
    return np.clip(np.rint(out), spec["min"], spec["max"]).astype(np.int64)


def rng(seed: int, stream: int) -> np.random.Generator:
    """The seed's generator for one stream of draws (lengths, ids, ...)."""
    return np.random.default_rng([seed, stream])


def requests(mix: dict, seed: int, vocab: int):
    """The mix's request sequence: ``(prompt int32 array, max_new)``
    pairs, ``mix["pool"]`` of them, prompt and output lengths each a
    seeded permutation of their pools, token ids uniform over the
    vocabulary."""
    n = mix["pool"]
    plen = rng(seed, 1).permutation(length_pool(mix["prompt"], n))
    olen = rng(seed, 2).permutation(length_pool(mix["output"], n))
    ids = rng(seed, 3)
    return [(ids.integers(0, vocab, int(p)).astype(np.int32), int(o))
            for p, o in zip(plen, olen)]

