from .linear import (PimConfig, linear_init, linear_apply,  # noqa
                     fused_linear_apply, pack_linear, params_from_numpy)
from .cram import (DTYPES, DType, cram_dot, cram_fdot, cram_fmatmul,  # noqa
                   cram_matmul, fdot_geometry, idot_geometry,
                   resolve_dtype)
from .fabric import (FabricConfig, FabricLinearProbe, FabricProgram,  # noqa
                     GemmSpec, Schedule, SearchResult, TileLoad,
                     fabric_attention_scores, fabric_fused_matmul,
                     fabric_matmul, residency_stats, schedule_gemm,
                     schedule_program, search_program, search_schedule)
