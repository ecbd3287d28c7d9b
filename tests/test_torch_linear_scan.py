"""The chunk-scan kernel's arithmetic and its dispatch, on the CPU.

``kernels/linear_scan.py`` scans one time chunk of ``h_t = a_t * h_{t-1}
+ b_t`` in shared memory.  The kernel runs only on the card
(``test_torch_cuda.py`` holds it bit for bit to the plain version there);
here a numpy emulation of its index arithmetic and rounding (block and
thread layout read from the ``#define``\\ s of ``csrc/linear_scan.cu``,
every product and sum rounded to float32 on its own) is held bit for bit
to ``models/recurrence.py``'s plain version, and the recurrence's
dispatch, the ``repro_torch::linear_scan`` operator's layouts, its
backward and its DTensor path are checked with a stand-in for the kernel
that runs on the host.
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import linear_scan as ls
from repro_torch.models import recurrence, rglru, ssm

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

_CU = Path(ls.__file__).with_name("csrc") / "linear_scan.cu"


def _cu_defines():
    text = _CU.read_text()
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"#define (LS_LANES|LS_GROUPS|LS_MAX_T)\s+(\d+)", text)}


def test_kernel_constants_match_the_wrapper():
    d = _cu_defines()
    assert d["LS_MAX_T"] == ls.MAX_T
    assert d["LS_MAX_T"] % d["LS_GROUPS"] == 0
    # a block's shared memory: a and b for every step and lane
    assert 2 * d["LS_MAX_T"] * d["LS_LANES"] * 4 <= 232448


def _emulate(a, b, h0):
    """The kernel's blocks and threads over ``a``, ``b`` (B, T, D) and
    ``h0`` (B, D), float32 numpy: each block's 32 lanes of one batch row
    staged (dead lanes as the identity), the doubling rounds with every
    thread reading its steps before the barrier and writing after, then
    ``pa * h0 + pb`` for the live lanes."""
    d = _cu_defines()
    lanes, groups, max_t = d["LS_LANES"], d["LS_GROUPS"], d["LS_MAX_T"]
    per = max_t // groups
    B, T, D = a.shape
    out = np.full((B, T, D), np.nan, np.float32)
    blocks = -(-D // lanes)
    for row in range(B):
        for bx in range(blocks):
            col = bx * lanes + np.arange(lanes)
            live = col < D
            sa = np.empty((max_t, lanes), np.float32)
            sb = np.empty((max_t, lanes), np.float32)
            seen = set()
            for y in range(groups):
                for k in range(per):
                    t = y + k * groups
                    if t < T:
                        seen.add(t)
                        sa[t] = np.where(live, a[row, t, np.minimum(
                            col, D - 1)], np.float32(1))
                        sb[t] = np.where(live, b[row, t, np.minimum(
                            col, D - 1)], np.float32(0))
            assert seen == set(range(T))
            step = 1
            while step < T:
                new = {}
                for y in range(groups):
                    for k in range(per):
                        t = y + k * groups
                        if step <= t < T:
                            a1, b1 = sa[t - step], sb[t - step]
                            a2, b2 = sa[t], sb[t]
                            new[t] = (np.multiply(a1, a2, dtype=np.float32),
                                      np.add(np.multiply(a2, b1,
                                                         dtype=np.float32),
                                             b2, dtype=np.float32))
                for t, (na, nb) in new.items():
                    sa[t], sb[t] = na, nb
                step *= 2
            h = h0[row, np.minimum(col, D - 1)]
            for t in range(T):
                o = np.add(np.multiply(sa[t], h, dtype=np.float32), sb[t],
                           dtype=np.float32)
                out[row, t, col[live]] = o[live]
    return out


def _chunk(seed, B, T, D, tiny=False):
    g = torch.Generator().manual_seed(seed)
    a = torch.rand((B, T, D), generator=g)
    b = torch.randn((B, T, D), generator=g)
    h0 = torch.randn((B, D), generator=g)
    if tiny:            # states in the subnormal range
        a, b, h0 = a * 1e-3, b * 1e-37, h0 * 1e-37
    return a, b, h0


@pytest.mark.parametrize("B,T,D,tiny", [(2, 1, 5, False), (1, 7, 33, False),
                                        (2, 88, 64, False),
                                        (1, 256, 40, False),
                                        (1, 255, 32, True)])
def test_kernel_arithmetic_matches_plain_bit_for_bit(B, T, D, tiny):
    a, b, h0 = _chunk(B * 1000 + T, B, T, D, tiny)
    pa, pb = recurrence._inclusive_scan(a, b)
    want = (pa * h0[:, None] + pb).numpy()
    got = _emulate(a.numpy(), b.numpy(), h0.numpy())
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    if tiny:
        assert ((want != 0) & (np.abs(want) < np.finfo(np.float32).tiny)
                ).any()


def test_kernel_takes_only_what_it_can_scan():
    """The raw launch refuses host tensors (it raises rather than scan
    them); a trailing layout that is no contiguous run is refused too
    (the operator copies such an operand into one first)."""
    a, b, h0 = _chunk(1, 2, 8, 12)
    assert not ls.takes(a, b, h0)
    with pytest.raises(ValueError, match="does not take"):
        ls.linear_scan_cuda(a, b, h0)
    base = torch.empty((2, 300, 3, 4))
    assert ls._trailing_contiguous(base[:, 10:20], 2)
    assert not ls._trailing_contiguous(base.transpose(2, 3), 2)
    assert ls._trailing_contiguous(base[:, -1], 1)


def _stand_in(calls, emulate=True):
    """A counting stand-in for ``linear_scan_cuda`` on host tensors that
    holds the kernel's contract (float32, the trailing dims one
    contiguous run) and runs the emulation (or the plain version, bit
    for bit the same and faster)."""
    def fake(a, b, h0):
        assert a.dtype == b.dtype == h0.dtype == torch.float32
        assert ls._trailing_contiguous(a, 2) and \
            ls._trailing_contiguous(b, 2) and ls._trailing_contiguous(h0, 1)
        calls.append(tuple(a.shape))
        if not emulate:
            pa, pb = recurrence._inclusive_scan(a, b)
            return pa * h0[:, None] + pb
        B, T = a.shape[:2]
        out = _emulate(a.reshape(B, T, -1).numpy(),
                       b.reshape(B, T, -1).numpy(),
                       h0.reshape(B, -1).numpy())
        return torch.from_numpy(out).reshape(a.shape)
    return fake


@pytest.fixture
def kernel_on_the_cpu(monkeypatch):
    """The recurrence's dispatch as off the host: every chunk goes
    through the ``repro_torch::linear_scan`` operator to a counting
    stand-in for the kernel that runs the emulation."""
    calls = []
    monkeypatch.setattr(recurrence, "_on_host", lambda t: False)
    monkeypatch.setattr(ls, "linear_scan_cuda", _stand_in(calls))
    return calls


def test_streamed_scan_sends_each_chunk_to_the_kernel(kernel_on_the_cpu,
                                                      monkeypatch):
    """A Mamba mixer over 300 tokens (chunks of 256 and 44) and an RG-LRU
    over 70 (chunks of 32, 32 and 6) scan every chunk through the kernel,
    with the same outputs and states as the plain version, bit for
    bit."""
    cfg = get_config("jamba2-mini", smoke=True)
    p = ssm.ssm_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    x = torch.randn((2, 300, cfg.d_model),
                    generator=torch.Generator().manual_seed(2)).to(
        torch.bfloat16)
    with torch.no_grad():
        got, got_c = ssm.ssm_apply(p, x, cfg)
    di = cfg.ssm.expand * cfg.d_model
    assert kernel_on_the_cpu == [(2, 256, di, cfg.ssm.state_dim),
                                 (2, 44, di, cfg.ssm.state_dim)]
    kernel_on_the_cpu.clear()
    rg = get_config("recurrentgemma-9b", smoke=True)
    q = rglru.rglru_init(torch.Generator().manual_seed(3), rg, device="cpu")
    y = torch.randn((2, 70, rg.d_model),
                    generator=torch.Generator().manual_seed(4)).to(
        torch.bfloat16)
    with torch.no_grad():
        rgot, rgot_c = rglru.rglru_apply(q, y, rg, chunk=32)
    assert [s[1] for s in kernel_on_the_cpu] == [32, 32, 6]
    monkeypatch.setattr(recurrence, "_on_host", lambda t: True)
    with torch.no_grad():
        want, want_c = ssm.ssm_apply(p, x, cfg)
        rwant, rwant_c = rglru.rglru_apply(q, y, rg, chunk=32)
    for g_, w_ in ((got, want), (got_c["h"], want_c["h"]), (rgot, rwant),
                   (rgot_c["h"], rwant_c["h"])):
        assert torch.equal(g_, w_)


def test_a_gradient_keeps_the_plain_version(monkeypatch):
    """On the host a training forward records its gradient through the
    plain version: no chunk reaches the kernel."""
    calls = []
    monkeypatch.setattr(ls, "linear_scan_cuda", _stand_in(calls))
    a, b, h0 = _chunk(5, 1, 40, 6)
    a.requires_grad_(True)
    hs, _ = recurrence.chunked_linear_scan(a, b, h0, chunk=16)
    hs.sum().backward()
    assert calls == [] and a.grad is not None


def _grads(a, b, h0, chunk):
    """Gradients of a weighted sum of the states and the last state with
    respect to ``a``, ``b`` and ``h0``."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (a, b, h0)]
    hs, h = recurrence.chunked_linear_scan(*leaves, chunk=chunk)
    w = torch.randn(hs.shape, generator=torch.Generator().manual_seed(9))
    return torch.autograd.grad((hs * w).sum() + h.sum(), leaves)


@pytest.mark.parametrize("S,chunk", [(40, 16), (256, 256), (300, 256),
                                     (1, 256)])
def test_a_gradient_off_the_host_runs_the_kernel_backward(monkeypatch, S,
                                                          chunk):
    """Off the host the operator's backward scans the adjoint recurrence
    on each chunk reversed in time through the same kernel (one launch
    a chunk forward, one back), and its gradients for ``a``, ``b`` and
    ``h0`` are the plain version's autograd ones within float32
    rounding: the two sum the same products in another order (each
    state's rounding error, ~6e-8 of it, carried through up to ``S``
    steps), so 1e-5 relative with an absolute floor of 1e-6 of the
    largest gradient."""
    a, b, h0 = _chunk(S, 2, S, 12)
    want = _grads(a, b, h0, chunk)
    calls = []
    monkeypatch.setattr(recurrence, "_on_host", lambda t: False)
    monkeypatch.setattr(ls, "linear_scan_cuda", _stand_in(calls, False))
    got = _grads(a, b, h0, chunk)
    n = -(-S // chunk)
    assert len(calls) == 2 * n
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-6 * w.abs().max().item())


def test_the_operator_lays_out_what_the_kernel_cannot_read(monkeypatch):
    """Operands whose trailing dims are no contiguous run (a transposed
    state, a chunk with its lanes strided) reach the kernel copied into
    one; views it can read reach it as they are; the result is the
    plain version's, bit for bit."""
    calls, seen = [], []
    inner = _stand_in(calls)

    def spy(a, b, h0):
        seen.append([t.is_contiguous() for t in (a, b, h0)])
        return inner(a, b, h0)

    monkeypatch.setattr(ls, "linear_scan_cuda", spy)
    a, b, h0 = _chunk(3, 2, 40, 24)
    at = a.reshape(2, 40, 4, 6).transpose(2, 3)
    bt = b.reshape(2, 40, 4, 6).transpose(2, 3)
    ht = h0.reshape(2, 4, 6).transpose(1, 2)
    got = torch.ops.repro_torch.linear_scan(at, bt, ht)
    pa, pb = recurrence._inclusive_scan(at, bt)
    assert torch.equal(got, pa * ht[:, None] + pb)
    assert seen == [[True, True, True]]
    long_a, long_b = (t.repeat(1, 3, 1) for t in (a, b))
    got = torch.ops.repro_torch.linear_scan(long_a[:, 40:80],
                                            long_b[:, 40:80], h0)
    assert seen[-1] == [False, False, True]
    pa, pb = recurrence._inclusive_scan(a, b)
    assert torch.equal(got, pa * h0[:, None] + pb)


def test_dtensor_chunks_scan_shard_by_shard(monkeypatch):
    """A falcon-mamba and an RG-LRU prefill and train step of the smoke
    configs, traced on fake tensors over a fake (2, 2) mesh as the
    launch layer's dry-run does on the card: every chunk scans through
    the operator shard by shard (its fake implementation gives the
    shapes, its backward the train step's), and the counted work is
    the plain version's less the doubling rounds' traffic."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    seen = []
    real = recurrence._scan_shards

    def spy(a, b, h):
        seen.append(tuple(a.placements))
        return real(a, b, h)

    monkeypatch.setattr(recurrence, "_scan_shards", spy)
    cells = {"prefill": {"kind": "prefill", "seq": 40, "batch": 4},
             "train": {"kind": "train", "seq": 40, "batch": 4}}
    for arch in ("falcon-mamba-7b", "recurrentgemma-9b"):
        cfg = configs.get_config(arch, smoke=True)
        for kind, sh in cells.items():
            got = {}
            for host in (True, False):
                monkeypatch.setattr(recurrence, "_on_host",
                                    lambda t, host=host: host)
                with dryrun.fake_group(4):
                    got[host] = dryrun.trace_step(
                        cfg, sh, make_mesh(2, 2, device_type="cpu"),
                        device="cpu")
            assert seen, (arch, kind)
            seen.clear()
            assert got[False]["counted_flops"] == got[True]["counted_flops"]
            assert 0 < got[False]["counted_bytes"] < \
                got[True]["counted_bytes"], (arch, kind)


def test_smoke_linear_scan_phase_on_the_cpu(monkeypatch):
    """``chip_smoke.phase_linear_scan`` on the CPU at small widths, the
    recurrence dispatched as off the host to a counting stand-in for the
    kernel and the card's timers answering 1 ms: the chunks through the
    raw launch and the operator equal to the plain version, the
    backward's two launches, and the smoke Jamba mixer's prefills
    launching once a chunk of 256, bit for bit the plain scan."""
    calls = []
    fake = _stand_in(calls, emulate=False)

    def counted(a, b, h0):
        counted.launches += 1
        return fake(a, b, h0)

    counted.launches = 0
    monkeypatch.setattr(recurrence, "_on_host", lambda t: False)
    monkeypatch.setattr(ls, "linear_scan_cuda", counted)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "back_to_back_ms",
                        lambda fn, **kw: (fn(), 1.0)[1])
    out = chip_smoke.phase_linear_scan(
        seed=3, shape=(2, 16, 96), ragged=9, prompts=(40, 300),
        cfg=get_config("jamba2-mini", smoke=True), dev="cpu")
    assert [c["shape"] for c in out["cases"]] == [[2, 16, 96], [2, 9, 96]]
    assert out["cases"][0]["bytes"] == 4 * (3 * 2 * 16 * 96 + 2 * 96)
    assert out["grad"]["launches"] == 2
    assert out["launches_by_path"] == {"jamba_mamba_layer_prefill_40": 1,
                                       "jamba_mamba_layer_prefill_300": 2}
    assert all(m["bit_identical"] for m in out["mixer"])
    assert recurrence._on_host(torch.zeros(1)) is False
