from .linear import (PimConfig, linear_init, linear_apply,  # noqa
                     fused_linear_apply, pack_linear, params_from_numpy)
from .cram import (DTYPES, DType, cram_dot, cram_fdot, cram_fmatmul,  # noqa
                   cram_matmul, fdot_geometry, idot_geometry,
                   resolve_dtype)
