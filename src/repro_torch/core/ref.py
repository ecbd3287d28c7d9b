"""Pure-numpy oracles for Compute RAM programs.

Integer oracles are exact unsigned arithmetic.  The bfloat16 oracles
replicate the engine's documented semantics **bit-exactly**:

* FTZ: subnormal inputs are treated as zero; outputs whose packed
  exponent would be 0 are flushed to +0.
* RTZ: right-shifts truncate (no guard/round/sticky bits).
* finite-only: exponent 255 is treated as an ordinary value; tests
  avoid overflow regions (documented limitation, matches the paper's
  scope which evaluates throughput, not IEEE edge cases).
"""

from __future__ import annotations

import numpy as np


# -- integers ---------------------------------------------------------------
def iadd(a, b, n):
    return (np.asarray(a, np.uint64) + np.asarray(b, np.uint64)) % (1 << n)


def isub(a, b, n):
    return (np.asarray(a, np.int64) - np.asarray(b, np.int64)) % (1 << n)


def imul(a, b, n):
    return (np.asarray(a, np.uint64) * np.asarray(b, np.uint64)) % (1 << (2 * n))


def idot(a, b, acc_bits=32):
    """a, b: (T, cols) -> (cols,) accumulated dot product."""
    s = (np.asarray(a, np.uint64) * np.asarray(b, np.uint64)).sum(axis=0)
    return s % (1 << acc_bits)


# -- parameterized floats (bit-pattern in/out as unsigned ints) -------------
def _parts(u, e_bits=8, m_bits=7):
    u = np.asarray(u, np.uint32)
    emask = (1 << e_bits) - 1
    mmask = (1 << m_bits) - 1
    s = (u >> (e_bits + m_bits)) & 1
    e = (u >> m_bits) & emask
    m = u & mmask
    hidden = (e != 0).astype(np.uint32)
    m = np.where(hidden == 1, m, 0)          # FTZ inputs
    mant = m | (hidden << m_bits)            # mantissa with hidden bit
    return s, e, mant, hidden


def _pack(s, e, m, e_bits=8, m_bits=7):
    emask = (1 << e_bits) - 1
    mmask = (1 << m_bits) - 1
    return ((s.astype(np.uint32) << (e_bits + m_bits))
            | ((e & emask) << m_bits) | (m & mmask))


def float_add(a_bits, b_bits, e_bits=8, m_bits=7):
    """Matches the engine's float_add sequence bit-exactly."""
    import math
    sa, ea, ma, _ = _parts(a_bits, e_bits, m_bits)
    sb, eb, mb, _ = _parts(b_bits, e_bits, m_bits)
    emod = 1 << e_bits
    mm = m_bits + 3
    L = max(1, math.ceil(math.log2(mm)))
    wmask = (1 << (m_bits + 1)) - 1          # normalize window

    swap = ea > eb                           # engine SW: 1 -> BIG = a
    sbig = np.where(swap, sa, sb)
    ssml = np.where(swap, sb, sa)
    ebig = np.where(swap, ea, eb)
    esml = np.where(swap, eb, ea)
    mbig = np.where(swap, ma, mb)
    msml = np.where(swap, mb, ma)

    ediff = ebig - esml
    msml = np.where(ediff >= (1 << L), 0,
                    msml >> np.minimum(ediff, (1 << L) - 1))   # RTZ

    mod = 1 << mm
    sub = (sbig ^ ssml) == 1
    rr = np.where(sub, (mbig - msml) % mod, mbig + msml)
    neg = sub & (msml > mbig)
    rr = np.where(neg, (msml - mbig) % mod, rr)
    sgn = np.where(neg, 1 - sbig, sbig)

    ee = ebig.copy()
    ovf = (~sub) & ((rr >> (m_bits + 1)) & 1 == 1)
    rr = np.where(ovf, rr >> 1, rr)          # RTZ drop
    ee = np.where(ovf, (ee + 1) % emod, ee)

    sc = np.zeros_like(rr)
    k = 1
    shifts = []
    while k <= m_bits:
        shifts.append(k)
        k <<= 1
    for k in reversed(shifts):
        cond = (rr >> (m_bits - k + 1)) & ((1 << k) - 1) == 0
        rr = np.where(cond, (rr << k) & wmask, rr)
        sc = sc + k * cond

    und = sc > ee
    ee = (ee - sc) % emod

    flush = (rr == 0) | und | (ee == 0)
    return np.where(flush, 0,
                    _pack(sgn, ee, rr, e_bits, m_bits)).astype(np.uint32)


def float_mul(a_bits, b_bits, e_bits=8, m_bits=7):
    sa, ea, ma, ha = _parts(a_bits, e_bits, m_bits)
    sb, eb, mb, hb = _parts(b_bits, e_bits, m_bits)
    bias = (1 << (e_bits - 1)) - 1
    e2mod = 1 << (e_bits + 1)
    emask = (1 << e_bits) - 1
    mmask = (1 << m_bits) - 1

    sgn = sa ^ sb
    esum = (ea + eb) % e2mod
    und = esum < bias
    ee = (esum - bias) % e2mod

    p = (ma * mb) & ((1 << (2 * m_bits + 2)) - 1)
    top = (p >> (2 * m_bits + 1)) & 1 == 1
    mm = np.where(top, (p >> (m_bits + 1)) & mmask, (p >> m_bits) & mmask)
    ee = np.where(top, (ee + 1) % e2mod, ee)

    flush = und | (ha == 0) | (hb == 0) | ((ee & emask) == 0)
    return np.where(flush, 0,
                    _pack(sgn, ee & emask, mm, e_bits, m_bits)
                    ).astype(np.uint32)


def bf16_add(a_bits, b_bits):
    return float_add(a_bits, b_bits, 8, 7).astype(np.uint16)


def bf16_mul(a_bits, b_bits):
    return float_mul(a_bits, b_bits, 8, 7).astype(np.uint16)


# -- fused MAC (dot product) ------------------------------------------------
#: Extra low-order mantissa bits of the float_dot accumulator (the
#: "widened accumulator": same exponent field, m_bits + ACC_GUARD
#: mantissa bits, RTZ).  Matches repro.core.floatprog.ACC_GUARD.
ACC_GUARD = 8


def float_dot_acc(a_bits, b_bits, e_bits=8, m_bits=7, guard=ACC_GUARD,
                  acc=None):
    """Sequential fused-MAC reference: ``acc += sum_t a_t * b_t``.

    a_bits, b_bits: ``(T, cols)`` fmt bit patterns.  ``acc`` is an
    optional ``(cols,)`` *wide-format* accumulator image (exponent
    ``e_bits``, mantissa ``m_bits + guard``) carried from a previous
    K-tile; None starts from +0.  Returns ``(result_bits, acc_bits)``:
    the fmt result (guard bits RTZ-truncated, zero exponent flushed)
    and the wide accumulator for chaining.  Tuples accumulate **in
    order** -- float addition does not associate, so this, not a
    tree-sum, is the contract the engine program reproduces bit-exactly.
    """
    a = np.asarray(a_bits, np.uint32)
    b = np.asarray(b_bits, np.uint32)
    mw = m_bits + guard
    emask = (1 << e_bits) - 1
    mmask = (1 << m_bits) - 1
    acc = (np.zeros(a.shape[1:], np.uint32) if acc is None
           else np.asarray(acc, np.uint32))
    for t in range(a.shape[0]):
        p = float_mul(a[t], b[t], e_bits, m_bits)
        s = p >> (e_bits + m_bits)
        e = (p >> m_bits) & emask
        m = p & mmask
        pw = _pack(s, e, m << guard, e_bits, mw)     # widen: guard zeros
        acc = float_add(acc, pw, e_bits, mw)
    return float_dot_round(acc, e_bits, m_bits, guard), acc


def float_dot_round(acc_bits, e_bits=8, m_bits=7, guard=ACC_GUARD):
    """Final normalize/round of a wide accumulator: RTZ-truncate the
    guard bits and flush a zero exponent to +0."""
    mw = m_bits + guard
    acc = np.asarray(acc_bits, np.uint32)
    emask = (1 << e_bits) - 1
    s = acc >> (e_bits + mw)
    e = (acc >> mw) & emask
    m = (acc & ((1 << mw) - 1)) >> guard
    return np.where(e == 0, 0,
                    _pack(s, e, m, e_bits, m_bits)).astype(np.uint32)


def float_dot(a_bits, b_bits, e_bits=8, m_bits=7, guard=ACC_GUARD):
    """Fused-MAC dot product reference (see :func:`float_dot_acc`)."""
    return float_dot_acc(a_bits, b_bits, e_bits, m_bits, guard)[0]


def float_matmul(x_bits, w_bits, e_bits=8, m_bits=7, guard=ACC_GUARD):
    """``(M, K) @ (K, N)`` with :func:`float_dot` semantics per output
    element (K accumulated in order).  Bit patterns in / out."""
    x = np.asarray(x_bits, np.uint32)
    w = np.asarray(w_bits, np.uint32)
    M, K = x.shape
    out = np.zeros((M, w.shape[1]), np.uint32)
    for m in range(M):
        out[m] = float_dot(np.broadcast_to(x[m][:, None], w.shape), w,
                           e_bits, m_bits, guard)
    return out


def bf16_dot(a_bits, b_bits):
    return float_dot(a_bits, b_bits, 8, 7).astype(np.uint16)


# -- float <-> bit-pattern conversion (FTZ + RTZ, finite-only) --------------
def to_bits(x, e_bits=8, m_bits=7):
    """float32 array -> packed fmt bit patterns.

    RTZ (mantissa truncation), FTZ (anything below the smallest normal
    becomes +0), finite-only (overflow -- and inf/nan inputs -- clamp
    to the largest finite magnitude).  For bf16 this is exactly the
    truncating float32 >> 16 conversion.
    """
    x = np.ascontiguousarray(x, np.float32)
    u = x.view(np.uint32)
    s = (u >> 31).astype(np.uint32)
    e32 = ((u >> 23) & 0xFF).astype(np.int64)
    m32 = (u & 0x7FFFFF).astype(np.uint32)
    bias = (1 << (e_bits - 1)) - 1
    emax = (1 << e_bits) - 1
    e = e32 - 127 + bias
    m = m32 >> (23 - m_bits)
    m = np.where((e > emax) | (e32 == 255), (1 << m_bits) - 1, m)
    e = np.clip(e, 0, emax)
    out = _pack(s, e.astype(np.uint32), m, e_bits, m_bits)
    return np.where(e == 0, 0, out).astype(np.uint32)   # FTZ


def from_bits(u, e_bits=8, m_bits=7):
    """Packed fmt bit patterns -> float32 (exact: FTZ values are
    integer-mantissa scaled powers of two; only bf16's very top
    exponent codes exceed float32 range and map to +/-inf)."""
    s, e, mant, _ = _parts(u, e_bits, m_bits)
    bias = (1 << (e_bits - 1)) - 1
    val = mant.astype(np.float64) * np.exp2(
        e.astype(np.float64) - bias - m_bits)
    return np.where(s == 1, -val, val).astype(np.float32)
