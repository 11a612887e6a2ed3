from .maxsim import (NEG_INF, build_kernel, maxsim_reduce, maxsim_search,
                     maxsim_search_torch)

__all__ = ["NEG_INF", "build_kernel", "maxsim_reduce", "maxsim_search",
           "maxsim_search_torch"]
