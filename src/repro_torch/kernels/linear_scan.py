"""One time chunk of the linear recurrence ``h_t = a_t * h_{t-1} + b_t``
that Mamba's selective SSM and RecurrentGemma's RG-LRU share, as one
hand-written kernel (``csrc/linear_scan.cu``).

From a chunk's ``a`` and ``b`` ``(B, T, ...)`` float32 and the state
before it ``h0`` ``(B, ...)``, the kernel gives the chunk's states
``(B, T, ...)``: the Hillis-Steele inclusive scan of ``(a, b)`` and then
``pa * h0 + pb``, bit for bit as ``models/recurrence.py`` computes them in
plain torch (the same products and sums in the same order, each rounded on
its own).  It keeps the chunk in shared memory through the doubling
rounds, so the chunk is read once and its states written once.

``recurrence.streamed_linear_scan`` calls it for every chunk that is not
on the host, through the ``repro_torch::linear_scan`` operator
(:func:`linear_scan_op`): the operator lays out operands the kernel
cannot read, gives a traced graph the chunk's shape (its fake
implementation), and has a backward, the adjoint recurrence
``l_t = a_{t+1} * l_{t+1} + g_t`` run by the same kernel on the
time-reversed chunk, so training on the card scans through it too.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["takes", "linear_scan_cuda", "linear_scan_op", "MAX_T"]

#: longest chunk the kernel takes; LS_MAX_T in csrc/linear_scan.cu
MAX_T = 256


def _plain_cuda_f32(t) -> bool:
    return type(t) is torch.Tensor and t.device.type == "cuda" \
        and t.dtype == torch.float32


def takes(a, b, h0) -> bool:
    """Whether the kernel can be launched on this chunk as it is laid
    out: plain CUDA float32 tensors (not DTensors, not fakes) on one
    device, ``a`` and ``b`` of one shape ``(B, T, ...)`` with
    ``1 <= T <= MAX_T`` and ``h0`` of ``(B, ...)``, each with its
    trailing dims one contiguous run (any batch and time strides)."""
    if not all(_plain_cuda_f32(t) for t in (a, b, h0)):
        return False
    if a.shape != b.shape or a.ndim < 3 or not 1 <= a.shape[1] <= MAX_T \
            or tuple(h0.shape) != (a.shape[0],) + tuple(a.shape[2:]) \
            or len({a.device, b.device, h0.device}) != 1:
        return False
    return _trailing_contiguous(a, 2) and _trailing_contiguous(b, 2) \
        and _trailing_contiguous(h0, 1)


def _trailing_contiguous(t, first: int) -> bool:
    """Whether dims ``first:`` of ``t`` are laid out as one contiguous
    run."""
    want = 1
    for n, s in zip(reversed(t.shape[first:]), reversed(t.stride()[first:])):
        if n != 1 and s != want:
            return False
        want *= n
    return True


@functools.cache
def _kernel():
    fn = ctypes.CDLL(str(build.library("linear_scan"))).linear_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
        + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def linear_scan_cuda(a, b, h0):
    """The chunk's states ``(B, T, ...)`` float32 (a fresh contiguous
    tensor), launched on the current stream with no sync, for a chunk
    that :func:`takes` admits; counts the call in
    ``linear_scan_cuda.launches``.  Raises on any other input.  Records
    no gradient: :func:`linear_scan_op` is the differentiable entry."""
    if not takes(a, b, h0):
        raise ValueError(f"linear_scan_cuda does not take a {tuple(a.shape)} "
                         f"{a.dtype} chunk on {a.device} with state "
                         f"{tuple(h0.shape)}")
    B, T = a.shape[:2]
    D = a[0, 0].numel()
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    fn = _kernel()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(),
                 B, T, D, a.stride(0), a.stride(1), b.stride(0), b.stride(1),
                 h0.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"linear_scan kernel launch failed: CUDA error "
                           f"{err}")
    linear_scan_cuda.launches += 1
    return out


linear_scan_cuda.launches = 0


# The body looks ``linear_scan_cuda`` up when it runs, so the benchmark's
# call record and a stand-in for the kernel (the CPU tests) see every
# launch, the backward's included.
@torch.library.custom_op("repro_torch::linear_scan", mutates_args=())
def linear_scan_op(a: torch.Tensor, b: torch.Tensor,
                   h0: torch.Tensor) -> torch.Tensor:
    """``linear_scan_cuda`` on the chunk, each operand whose trailing
    dims are not one contiguous run copied into one first."""
    a, b, h0 = (t if _trailing_contiguous(t, first) else t.contiguous()
                for t, first in ((a, 2), (b, 2), (h0, 1)))
    return linear_scan_cuda(a, b, h0)


@linear_scan_op.register_fake
def _linear_scan_fake(a, b, h0):
    return torch.empty(a.shape, dtype=torch.float32, device=a.device)


def _setup_context(ctx, inputs, output):
    a, _, h0 = inputs
    ctx.save_for_backward(a, h0, output)


def _backward(ctx, g):
    """Adjoint of ``h_t = a_t * h_{t-1} + b_t`` over the chunk: with
    ``l_t = g_t + a_{t+1} * l_{t+1}`` (the chunk's states after it carry
    their gradient into ``g`` through the next chunk's ``h0``), the
    gradients are ``l_t * h_{t-1}`` for ``a``, ``l_t`` for ``b`` and
    ``a_0 * l_0`` for ``h0``.  ``l`` is the same scan on the chunk
    reversed in time, ``a`` shifted one step (its last step reads no
    successor)."""
    a, h0, out = ctx.saved_tensors
    nxt = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    lam = torch.ops.repro_torch.linear_scan(
        nxt.flip(1), g.flip(1), torch.zeros_like(h0)).flip(1)
    da = db = dh0 = None
    if ctx.needs_input_grad[0]:
        da = lam * torch.cat([h0[:, None], out[:, :-1]], dim=1)
    if ctx.needs_input_grad[1]:
        db = lam
    if ctx.needs_input_grad[2]:
        dh0 = a[:, 0] * lam[:, 0]
    return da, db, dh0


linear_scan_op.register_autograd(_backward, setup_context=_setup_context)
