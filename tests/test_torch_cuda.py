"""Tests of the port that need the card: the CUDA kernels against their
plain PyTorch versions, and the main path through them.

Marked ``cuda``; each skips without a CUDA device.  On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only the port is installed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import bitplane_ops as bp  # noqa: E402
from repro_torch.pim import cram  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _planes(rng, m, lanes, words, live, top, device):
    x = rng.integers(0, 1 << 32, (m, lanes, words),
                     dtype=np.uint64).astype(np.uint32)
    if top:
        x |= np.uint32(1 << 31)
    return [torch.from_numpy(x[i].view(np.int32)).to(device)
            if live is None or i in live else None for i in range(m)]


def _words(p, words):
    if p is None:
        return np.zeros(words, np.uint32)
    return p.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("top", [False, True], ids=["rand", "bit31"])
@pytest.mark.parametrize("m,lanes,words,width,live", [
    (3, 3, 4, 5, None), (4, 8, 16, 8, None), (4, 17, 33, 12, None),
    (6, 5, 7, 6, {0, 1, 3, 5}), (6, 5, 7, 6, {0, 2}),
    (15, 57, 160, 15, set(range(8))),
    (32, 9, 70, 32, None)])
def test_lane_fold_kernel_matches_plain(card, m, lanes, words, width, live,
                                        top):
    rng = np.random.default_rng(60)
    planes = _planes(rng, m, lanes, words, live, top, card)
    before = bp.lane_fold_cuda.launches
    got = bp.lane_fold(planes, width, packed=True)
    assert bp.lane_fold_cuda.launches == before + 1
    want = bp.lane_fold_torch(planes, width)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_words(g, words), _words(w, words))


def test_lane_fold_kernel_rejects_what_it_does_not_take(card):
    x = torch.zeros((3, 4, 5), dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        bp.lane_fold_cuda(x.to(torch.int64), 3)
    with pytest.raises(ValueError):
        bp.lane_fold_cuda(x.transpose(1, 2), 3)
    with pytest.raises(ValueError):
        bp.lane_fold_cuda(x, 2)                       # m > width
    with pytest.raises(ValueError):
        bp.lane_fold_cuda(x, bp.LANE_FOLD_MAX_WIDTH + 1)


def test_cram_matmul_on_card_runs_the_kernel(card):
    rng = np.random.default_rng(61)
    x = rng.integers(-8, 8, (5, 70))
    w = rng.integers(-8, 8, (70, 48))
    before = bp.lane_fold_cuda.launches
    got = cram.cram_matmul(x, w, n=4, signed=True)
    assert bp.lane_fold_cuda.launches > before
    np.testing.assert_array_equal(got, x.astype(np.int64) @ w)
