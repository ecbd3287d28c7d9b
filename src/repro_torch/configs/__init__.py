"""Architecture registry: ``--arch <id>`` resolution."""

import importlib

from .base import ModelConfig, MoESpec, RGLRUSpec, SSMSpec  # noqa

ARCHS = {
    "falcon-mamba-7b": "falcon_mamba_7b",
    "granite-20b": "granite_20b",
    "llama3.2-1b": "llama3_2_1b",
    "qwen2-0.5b": "qwen2_0_5b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "mixtral-8x7b": "mixtral_8x7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "chameleon-34b": "chameleon_34b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

#: architectures of the port alone, which the reference's zoo lacks (the
#: parity tests iterate ``list_archs()``, the reference's ten)
PORT_ARCHS = {
    "deepseek-v2-lite": "deepseek_v2_lite",
    "jamba2-mini": "jamba2_mini",
    "jamba2-mini-stage0": "jamba2_mini_stage0",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f".{ARCHS.get(arch) or PORT_ARCHS[arch]}",
                                  __package__)
    return mod.smoke_config() if smoke else mod.config()


def list_archs():
    return sorted(ARCHS)
