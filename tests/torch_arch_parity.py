"""Shared body of ``test_torch_arch_dense.py`` and
``test_torch_arch_mixed.py``: one architecture at its smoke config
through the JAX package and the port, on the same weights and tokens.

The reference's weights (``LM.init``, optionally ``quantize_tree``) are
carried into the port with ``params_from_numpy``.  The JAX side is
compiled with XLA's ``xla_allow_excess_precision`` off: by default XLA
keeps the bf16 intermediates of a fused chain at float32 precision,
which the port's one-op-at-a-time torch cannot follow; with it off,
every bf16 result is rounded, as an eager (``jax.disable_jit()``) run
rounds it (``test_torch_arch_mixed.py::
test_compiled_reference_rounds_as_eager`` holds the two equal), in far
less time than the eager run.  The two packages then round at the same
places, and most archs give the same logits bit for bit.

Tolerances: logits (``apply``, ``prefill``, ``decode_step``) and the
bf16/f32 cache contents within the reference's own decode-against-
prefill bound, rtol = atol = 0.05 (``tests/test_arch_smoke.py``); cache
positions exactly.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.models.model import LM as RefLM
from repro.models.qweight import quantize_tree as ref_quantize_tree
from repro_torch import configs
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import LM

TOL = dict(rtol=0.05, atol=0.05)
B, S = 2, 8


#: XLA options of the JAX side's compiles (see the module docstring)
EAGER_ROUNDING = {"xla_allow_excess_precision": False}


def run_ref(fn, *args):
    """``fn(*args)`` compiled with :data:`EAGER_ROUNDING`."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options=EAGER_ROUNDING)(*args)


def to_torch(tree):
    """A JAX tree as the port's CPU tensors, bits unchanged."""
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close(got, want, what):
    np.testing.assert_allclose(_f32(got), _f32(want), err_msg=what, **TOL)


def _caches_close(got, want, path="caches"):
    """Leaf by leaf along the same keys: integer leaves (positions, int
    KV codes) exactly, float leaves within :data:`TOL`."""
    if isinstance(got, dict):
        assert got.keys() == want.keys(), path
        for k in got:
            _caches_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(got, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _caches_close(g, w, f"{path}/{i}")
    else:
        assert tuple(got.shape) == want.shape, path
        if got.dtype in (torch.int32, torch.int8, torch.uint8):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=path)
        else:
            _close(got, want, path)


def check_arch(arch, bits=None, kv_bits=None):
    """apply / prefill / decode_step logits and caches against the JAX
    package, the port's decode against its own full forward, and a
    finite loss."""
    ref_cfg = ref_configs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    if kv_bits:
        ref_cfg = dataclasses.replace(ref_cfg, kv_quant_bits=kv_bits)
        cfg = dataclasses.replace(cfg, kv_quant_bits=kv_bits)
    ref_model, model = RefLM(ref_cfg), LM(cfg, device="cpu")
    ref_params = jax.jit(ref_model.init)(jax.random.PRNGKey(0))
    if bits:
        ref_params = ref_quantize_tree(ref_params, bits=bits)
    params = to_torch(ref_params)

    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    ref_kw, kw = {}, {}
    if cfg.is_encdec:
        src = jnp.asarray(rng.normal(0, 1, (B, S, cfg.d_model)),
                          jnp.bfloat16)
        epos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        enc = run_ref(ref_model.encode, ref_params, src, jnp.asarray(epos))
        port_enc = model.encode(params, to_torch(src),
                                torch.from_numpy(epos.copy()))
        _close(port_enc, enc, "encoder output")
        ref_kw = {"enc_out": enc, "enc_pos": jnp.asarray(epos)}
        kw = {"enc_out": port_enc, "enc_pos": torch.from_numpy(epos.copy())}

    pos = np.full((B,), S, np.int32)
    full, _ = run_ref(lambda p, t, kw: ref_model.apply(p, tokens=t, **kw),
                      ref_params, jnp.asarray(toks), ref_kw)
    pre, caches = run_ref(
        lambda p, t, kw: ref_model.prefill(p, tokens=t, capacity=S + 1,
                                           **kw),
        ref_params, jnp.asarray(toks[:, :S]), ref_kw)
    step, _ = run_ref(
        lambda p, c, t, q, kw: ref_model.decode_step(p, c, t, q, **kw),
        ref_params, caches, jnp.asarray(toks[:, S:]), jnp.asarray(pos),
        ref_kw)

    t = torch.from_numpy(toks)
    got_full, aux = model.apply(params, tokens=t, **kw)
    got_pre, got_caches = model.prefill(params, tokens=t[:, :S],
                                        capacity=S + 1, **kw)
    # before the decode step, which writes the prefill's caches in place
    _caches_close(got_caches, caches)
    got_step, _ = model.decode_step(params, got_caches, t[:, S:],
                                    torch.from_numpy(pos), **kw)

    assert got_full.shape == (B, S + 1, cfg.vocab)
    _close(got_full, full, "apply logits")
    _close(got_pre, pre, "prefill logits")
    _close(got_step, step, "decode_step logits")
    if not kv_bits:
        # the port's own decode against its full forward, at the same
        # bound (an int KV cache is held against the reference instead:
        # its quantization error is no part of this bound)
        _close(got_step[:, 0], got_full[:, S], "decode against full forward")
    batch = {"tokens": t}
    if cfg.is_encdec:
        batch["src_embeds"] = to_torch(src)
    assert torch.isfinite(model.loss(params, batch))
    assert torch.isfinite(torch.as_tensor(aux))
