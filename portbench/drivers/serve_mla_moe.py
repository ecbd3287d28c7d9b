"""Driver of the serve cells of a latent-attention MoE model (DeepSeek-V2's
layers): the serve driver (``drivers/serve.py``) as it is, loaded as a
module of its own, with this model's weights (``pb_mla_moe.weights``),
FLOPs (``pb_mla_moe.token_flops``, ``attention_flops``) and plain
reference (``reference/deepseek_v2.py``) in place of the dense LM's.

In a traced run (``run.py --trace 1`` wraps ``moe.moe_apply`` for
``moe.decode_share``) the window also runs with the port's recorder on
(``repro_torch.trace``), and after it the MoE's device counters are read
once into ``rec.work["device_counters"]``, the host counters into
``rec.work["counters"]``, and ``rec.work["moe_decode"]`` gives what
``moe.byte_roofline`` needs of the model: the bytes of one expert, of one
routed row, and the rows of one decode call.  An untraced window runs the
serve driver's alone.

So this cell's traced per-layer metrics (``decode_step_ms``,
``serve.prefill_share``, ``device_idle.serve``, ``serve_mfu`` among
them) are taken with the recorder on, and the chat cell's without it: a
decode step's spans and counters cost some 3 % of it.  When ``run.py``'s
``--trace 1`` branch turns the recorder on for every cell, ``traced``
and the ``enable``/``disable`` here go, and only the reading of the
device counters stays.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pb_mla_moe
from reference import deepseek_v2


def _serve_driver():
    path = Path(__file__).with_name("serve.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_serve_for_mla_moe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pb_weights = SimpleNamespace(lm_weights=pb_mla_moe.weights)
    mod.pb_peaks = SimpleNamespace(
        lm_matmul_flops=pb_mla_moe.token_flops,
        attention_flops=pb_mla_moe.attention_flops)
    mod.ref = deepseek_v2
    return mod


serve = _serve_driver()
buckets, setup, roots, release = (serve.buckets, serve.setup, serve.roots,
                                  serve.release)
sample, check, control = serve.sample, serve.check, serve.control


def traced() -> bool:
    """Whether ``run.py`` wrapped the MoE for a traced run."""
    from repro_torch.models import moe
    return hasattr(moe.moe_apply, "__wrapped__")


def window(st, seconds, rec):
    from repro_torch import trace
    if not traced():
        return serve.window(st, seconds, rec)
    trace.enable()
    try:
        serve.window(st, seconds, rec)
    finally:
        rec.work["device_counters"] = trace.device_counters()
        rec.work["counters"] = trace.take()[1]
        trace.disable()
    mc = st.ctx.model
    rec.work["moe_decode"] = {
        "expert_bytes": pb_mla_moe.expert_bytes(mc),
        "row_bytes": mc.d_model * pb_mla_moe.BF16,
        "rows_per_call": st.engine.B * mc.moe.top_k}
