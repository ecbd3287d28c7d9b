"""The port's dense and vlm architectures against the JAX package at
their smoke configs (``torch_arch_parity.check_arch`` says what is held
and within which tolerance), plus quantized weights and quantized KV
caches on qwen2-0.5b."""

import pytest

pytest.importorskip("torch")

from torch_arch_parity import check_arch  # noqa: E402

DENSE = ["qwen2-0.5b", "llama3.2-1b", "granite-20b", "h2o-danube-1.8b",
         "chameleon-34b"]


@pytest.mark.parametrize("arch", DENSE)
def test_arch_matches_reference(arch):
    check_arch(arch)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_weights_match_reference(bits):
    check_arch("qwen2-0.5b", bits=bits)


@pytest.mark.parametrize("kv_bits", [4, 8])
def test_quantized_kv_cache_matches_reference(kv_bits):
    check_arch("qwen2-0.5b", kv_bits=kv_bits)
