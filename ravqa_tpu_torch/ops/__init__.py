from .maxsim import (NEG_INF, build_kernels, coarse_sweep, coarse_sweep_int8,
                     coarse_sweep_int8_torch, coarse_sweep_torch,
                     maxsim_reduce, maxsim_search, maxsim_search_torch,
                     stage1_rows, stage1_sweep, stage1_sweep_torch)
from .quant import (quantize_queries_int8, quantize_summaries_int8,
                    quantize_summaries_t_int8)

__all__ = ["NEG_INF", "build_kernels", "coarse_sweep", "coarse_sweep_int8",
           "coarse_sweep_int8_torch", "coarse_sweep_torch", "maxsim_reduce",
           "maxsim_search", "maxsim_search_torch", "stage1_rows",
           "stage1_sweep", "stage1_sweep_torch", "quantize_queries_int8",
           "quantize_summaries_int8", "quantize_summaries_t_int8"]
