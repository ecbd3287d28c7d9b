from .cram import (DTYPES, DType, cram_dot, cram_fdot, cram_fmatmul,  # noqa
                   cram_matmul, fdot_geometry, idot_geometry,
                   resolve_dtype)
