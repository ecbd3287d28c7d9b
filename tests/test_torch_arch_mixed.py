"""The port's moe, ssm, hybrid and encoder-decoder architectures against
the JAX package at their smoke configs (``torch_arch_parity.check_arch``
says what is held and within which tolerance)."""

import pytest

pytest.importorskip("torch")

from torch_arch_parity import check_arch  # noqa: E402

MIXED = ["granite-moe-3b-a800m", "mixtral-8x7b", "falcon-mamba-7b",
         "recurrentgemma-9b", "seamless-m4t-large-v2"]


@pytest.mark.parametrize("arch", MIXED)
def test_arch_matches_reference(arch):
    check_arch(arch)


def test_compiled_reference_rounds_as_eager():
    """The JAX side's compile without excess precision
    (``torch_arch_parity.run_ref``) gives the eager run's logits bit for
    bit, on a MoE arch: the parity tests hold the port to the
    reference's own op-by-op rounding."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro import configs
    from repro.models.model import LM
    from torch_arch_parity import run_ref

    model = LM(configs.get_config("granite-moe-3b-a800m", smoke=True))
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    toks = jnp.asarray(np.random.default_rng(0).integers(
        0, model.cfg.vocab, (2, 8)), jnp.int32)
    got, _ = run_ref(lambda p, t: model.apply(p, tokens=t), params, toks)
    with jax.disable_jit():
        want, _ = model.apply(params, tokens=toks)
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  np.asarray(want, np.float32))
