"""The port's bit-plane ops against the reference's on identical inputs.

Counterparts of the bitplane tests in ``test_kernels.py``: ``planes_add``
with known-zero (None) elision against integer arithmetic, and the plain
torch lane fold against the reference's jnp tree and its Pallas kernel
(interpret mode), bit for bit.  The CUDA kernel itself runs only on the
card (``test_torch_cuda.py``); here the dispatch rule and the wrapper's
refusal of CPU tensors are checked.
"""

import re
from itertools import product
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import bitplane_ops as ref_bp  # noqa: E402
from repro_torch.kernels import bitplane_ops as bp  # noqa: E402


def _t(x):
    """uint32 numpy words -> int32 torch words (same bits)."""
    return torch.from_numpy(np.asarray(x, np.uint32).view(np.int32))


def _u(x, words):
    """torch int32 words or None -> uint32 numpy (None -> zeros)."""
    if x is None:
        return np.zeros(words, np.uint32)
    return x.numpy().view(np.uint32)


def test_planes_add_none_elision_oracle():
    """planes_add with None planes == the dense add/sub, for every
    None/dense pattern of 4-bit operands, with and without carry-in,
    add and sub (the a-0 / 0-b borrow asymmetry)."""
    rng = np.random.default_rng(0)
    w = 4
    av = rng.integers(0, 1 << 32, (w, 8), dtype=np.uint64).astype(np.uint32)
    bv = rng.integers(0, 1 << 32, (w, 8), dtype=np.uint64).astype(np.uint32)
    cv = rng.integers(0, 1 << 32, (8,), dtype=np.uint64).astype(np.uint32)
    zero = torch.zeros(8, dtype=torch.int32)
    for mask_a, mask_b, cin, sub in product(
            range(1 << w), range(1 << w), (False, True), (False, True)):
        a = [_t(av[i]) if mask_a >> i & 1 else None for i in range(w)]
        b = [_t(bv[i]) if mask_b >> i & 1 else None for i in range(w)]
        ad = [zero if p is None else p for p in a]
        bd = [zero if p is None else p for p in b]
        got, gc = bp.planes_add(a, b, _t(cv) if cin else None, sub=sub)
        want, wc = bp.planes_add(ad, bd, _t(cv) if cin else zero, sub=sub)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(_u(g, 8), _u(x, 8))
        np.testing.assert_array_equal(_u(gc, 8), _u(wc, 8))


@pytest.mark.parametrize("dtype", ["int32", "bool"])
def test_planes_add_matches_integer_arithmetic(dtype):
    """Dense planes_add == add/sub mod 2^w with the exact carry-out, on
    packed words and on bool planes."""
    rng = np.random.default_rng(1)
    w, n = 6, 64
    a = rng.integers(0, 1 << w, n)
    b = rng.integers(0, 1 << w, n)
    c = rng.integers(0, 2, n)

    def planes(v):
        return [torch.from_numpy((v >> i & 1).astype(dtype))
                for i in range(w)]

    for sub in (False, True):
        out, cout = bp.planes_add(planes(a), planes(b),
                                  torch.from_numpy(c.astype(dtype)), sub=sub)
        got = sum((p & 1).numpy().astype(np.int64) << i
                  for i, p in enumerate(out))
        full = a - b - c if sub else a + b + c
        np.testing.assert_array_equal(got, full % (1 << w))
        np.testing.assert_array_equal((cout & 1).numpy().astype(bool),
                                      (full < 0) if sub
                                      else (full >> w).astype(bool))


def _fold_inputs(m, lanes, words, width, live=None, seed=2, top=False):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, (m, lanes, words),
                     dtype=np.uint64).astype(np.uint32)
    if top:
        x |= np.uint32(1 << 31)
    planes = [x[i] if live is None or i in live else None
              for i in range(m)]
    return x, planes


# (m, T, W, width, live planes): the reference's ragged test shapes,
# and the int4 cram_matmul main-path shape (15 planes, 8 of them live)
_FOLD_SHAPES = {
    "3x3x4w5": (3, 3, 4, 5, None),
    "4x8x16w8": (4, 8, 16, 8, None),
    "4x17x33w12": (4, 17, 33, 12, None),
    "main15x57x160w15": (15, 57, 160, 15, set(range(8))),
}


@pytest.mark.parametrize("top", [False, True], ids=["rand", "bit31"])
@pytest.mark.parametrize("shape", sorted(_FOLD_SHAPES))
def test_lane_fold_torch_matches_reference(shape, top):
    """lane_fold_torch == the reference jnp tree == the reference Pallas
    kernel (interpret mode), including words with bit 31 set."""
    m, lanes, words, width, live = _FOLD_SHAPES[shape]
    x, planes = _fold_inputs(m, lanes, words, width, live, top=top)
    got = bp.lane_fold_torch([None if p is None else _t(p) for p in planes],
                             width)
    want = ref_bp.lane_fold_jnp(
        [None if p is None else jnp.asarray(p) for p in planes], width)
    xz = np.stack([np.zeros((lanes, words), np.uint32) if p is None else p
                   for p in planes])
    pallas = np.asarray(ref_bp.lane_fold_pallas(
        jnp.asarray(xz), width, block_w=16 if words < 160 else 512,
        interpret=True))
    assert len(got) == width
    for i in range(width):
        g = _u(got[i], words)
        np.testing.assert_array_equal(
            g, np.zeros(words, np.uint32) if want[i] is None
            else np.asarray(want[i]))
        np.testing.assert_array_equal(g, pallas[i])


def test_lane_fold_torch_integer_oracle():
    """The fold is the per-column integer sum over lanes mod 2^width."""
    m, lanes, words, width = 4, 17, 33, 12
    x, planes = _fold_inputs(m, lanes, words, width, top=True)
    got = bp.lane_fold_torch([_t(p) for p in planes], width)
    folded = np.stack([_u(g, words) for g in got]).astype(np.uint64)
    xs = x.astype(np.uint64)
    for wi in range(0, words, 5):
        for bit in (0, 17, 31):
            tot = sum(sum((int(xs[i, t, wi]) >> bit & 1) << i
                          for i in range(m)) for t in range(lanes))
            have = sum((int(folded[i, wi]) >> bit & 1) << i
                       for i in range(width))
            assert have == tot % (1 << width), (wi, bit)


def test_lane_fold_dispatch_rule_cpu():
    """Packed planes on the CPU and bool planes anywhere take the tree;
    only packed planes on a CUDA device take the kernel."""
    assert bp.use_kernel_fold(torch.device("cuda"), True)
    assert bp.use_kernel_fold("cuda:0", True)
    assert not bp.use_kernel_fold(torch.device("cuda"), False)
    assert not bp.use_kernel_fold(torch.device("cpu"), True)
    assert not bp.use_kernel_fold(torch.device("cpu"), False)
    width, lanes, words = 6, 5, 7
    _, planes = _fold_inputs(width, lanes, words, width, live={0, 1, 3, 4, 5})
    tp = [None if p is None else _t(p) for p in planes]
    before = bp.lane_fold_cuda.launches
    got = bp.lane_fold(tp, width, packed=True)
    want = bp.lane_fold_torch(tp, width)
    assert bp.lane_fold_cuda.launches == before
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u(g, words), _u(w, words))
    assert bp.lane_fold([None] * width, width, packed=True) == [None] * width


@pytest.mark.parametrize("m,live", [
    (15, set(range(8))), (6, {0, 2}), (6, {5}), (6, {0, 1, 3, 5}),
    (4, None)])
def test_lane_fold_kernel_gets_planes_up_to_last_live(monkeypatch, m, live):
    """On the kernel route the wrapper is handed the planes up to the
    last live one (known-zero top planes are dropped, interior ones are
    zero words), and its result is the tree's.  The kernel is stood in
    for by the tree over the stacked planes it receives."""
    width, lanes, words = m, 5, 7
    _, planes = _fold_inputs(m, lanes, words, width, live=live)
    tp = [None if p is None else _t(p) for p in planes]
    seen = []

    def fake_kernel(x, w):
        seen.append(tuple(x.shape))
        out = bp.lane_fold_torch(list(x), w)
        return torch.stack([torch.zeros(words, dtype=torch.int32)
                            if p is None else p for p in out])

    monkeypatch.setattr(bp, "use_kernel_fold", lambda device, packed: True)
    monkeypatch.setattr(bp, "lane_fold_cuda", fake_kernel)
    got = bp.lane_fold(tp, width, packed=True)
    top = m if live is None else max(live) + 1
    assert seen == [(top, lanes, words)]
    want = bp.lane_fold_torch(tp, width)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u(g, words), _u(w, words))


def test_lane_fold_cuda_refuses_cpu_and_bad_inputs():
    """The CUDA wrapper launches or raises: it never computes a CPU
    tensor another way, and it rejects shapes the kernel does not take."""
    x = torch.zeros((3, 4, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bp.lane_fold_cuda(x, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bp.lane_fold_cuda(x.to("meta"), 3)


# ---------------------------------------------------------------------------
# The CUDA kernel's lane-group partition and tree, emulated on the CPU
# ---------------------------------------------------------------------------
_LANE_FOLD_CU = Path(bp.__file__).with_name("csrc") / "lane_fold.cu"


def _cu_defines(path):
    """Integer ``#define NAME value`` lines of a CUDA source."""
    return {k: int(v) for k, v in re.findall(
        r"^#define (\w+) (\d+)\b", path.read_text(), flags=re.M)}


def _lane_fold_buckets():
    """(accumulator planes, lanes loaded ahead) of each kernel
    instantiation the launch picks from, narrowest first."""
    return sorted((int(a), int(b)) for a, b in re.findall(
        r"lane_fold_kernel<(\d+), (\d+)>", _LANE_FOLD_CU.read_text()))


def _ripple_add(acc, b, width):
    """The kernel's ``ripple_add``: acc += b over planes [0, width)."""
    c = np.zeros_like(acc[0])
    for i in range(width):
        a = acc[i].copy()
        axb = a ^ b[i]
        acc[i] = axb ^ c
        c = (a & b[i]) | (c & axb)


def _emulate_lane_fold_kernel(x, width, visits=None):
    """``lane_fold_kernel`` on numpy words, block by block and thread by
    thread: group g of a block takes lanes g, g + G, ... in batches of
    LB, then the groups meet in the shared-memory tree.  ``visits``
    (T, W) counts the (lane, column) loads."""
    d = _cu_defines(_LANE_FOLD_CU)
    G, WB = d["LF_GROUPS"], d["LF_WORDS"]
    maxw, lb = next(b for b in _lane_fold_buckets() if b[0] >= width)
    m, lanes, words = x.shape
    out = np.zeros((width, words), np.uint32)
    for blk in range(-(-words // WB)):
        cols = blk * WB + np.arange(WB)
        live = cols < words
        xb = np.zeros((m, lanes, WB), np.uint32)
        xb[:, :, live] = x[:, :, cols[live]]
        acc = np.zeros((G, maxw, WB), np.uint32)
        for grp in range(G):
            for t0 in range(grp, lanes, lb * G):
                batch = [t0 + j * G for j in range(lb) if t0 + j * G < lanes]
                b = np.zeros((len(batch), maxw, WB), np.uint32)
                for j, t in enumerate(batch):
                    b[j, :m] = xb[:, t]
                    if visits is not None:
                        visits[t, cols[live]] += 1
                for j in range(len(batch)):
                    _ripple_add(acc[grp], b[j], width)
        h = 1
        while 2 * h < min(lanes, G):
            h *= 2
        if lanes == 1:
            h = 0
        while h >= 1:
            part = acc[h:2 * h].copy()            # the upper half hands down
            for grp in range(h):
                _ripple_add(acc[grp], part[grp], width)
            h //= 2
        out[:, cols[live]] = acc[0, :width][:, live]
    return out


@pytest.mark.parametrize("top", [False, True], ids=["rand", "bit31"])
@pytest.mark.parametrize("m,lanes,words,width", [
    (8, 57, 160, 15), (8, 25, 160, 15),            # the main path's folds
    (3, 1, 9, 5), (4, 2, 8, 4), (5, 31, 17, 12), (6, 33, 3, 6),
    (8, 70, 5, 8), (32, 40, 9, 32), (2, 100, 11, 20), (1, 65, 1, 1)])
def test_lane_fold_kernel_partition_and_tree(m, lanes, words, width, top):
    """The kernel's lane groups cover every lane of every column once,
    and its tree of group partials gives lane_fold_torch's planes and
    the reference's lane_fold_jnp, on ragged T and W, m < width, every
    width bucket, and bit 31 set."""
    x, planes = _fold_inputs(m, lanes, words, width, seed=lanes + words,
                             top=top)
    visits = np.zeros((lanes, words), np.int64)
    got = _emulate_lane_fold_kernel(x, width, visits)
    assert (visits == 1).all()
    want = bp.lane_fold_torch([_t(p) for p in planes], width)
    jwant = ref_bp.lane_fold_jnp([jnp.asarray(p) for p in planes], width)
    for i in range(width):
        np.testing.assert_array_equal(got[i], _u(want[i], words))
        np.testing.assert_array_equal(
            got[i], np.zeros(words, np.uint32) if jwant[i] is None
            else np.asarray(jwant[i]))


def test_lane_fold_kernel_constants_match_the_wrapper():
    """The wrapper's widest fold is the kernel's, and every width up to
    it has an instantiation."""
    d = _cu_defines(_LANE_FOLD_CU)
    assert d["LANE_FOLD_MAX_WIDTH"] == bp.LANE_FOLD_MAX_WIDTH
    buckets = _lane_fold_buckets()
    assert buckets[-1][0] == bp.LANE_FOLD_MAX_WIDTH
    assert d["LF_GROUPS"] & (d["LF_GROUPS"] - 1) == 0   # a power of two
