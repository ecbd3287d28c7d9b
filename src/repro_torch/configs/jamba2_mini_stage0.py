"""jamba2-mini-stage0: the first stage of ``jamba2-mini`` served by a
two-stage pipeline, layers 0-15 (two whole periods: 14 Mamba and 2
attention layers, 8 expert and 8 dense FFNs) with the embedding and the
output head; every width as published."""

import dataclasses

from . import jamba2_mini
from .jamba import JambaConfig


def config() -> JambaConfig:
    return dataclasses.replace(jamba2_mini.config(),
                               name="jamba2-mini-stage0", n_layers=16)


def smoke_config() -> JambaConfig:
    return jamba2_mini.smoke_config()
