"""python3 -m portbench: one run of one cell (portbench/run.py).

The program's build and kernel caches go to fixed directories inside the
checkout, so only a cell's first run there compiles; transformers, where
installed, is kept from loading JAX.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), ".portbench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

from portbench.run import main  # noqa: E402

sys.exit(main(t_start=T_START))
