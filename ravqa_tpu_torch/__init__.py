"""ravqa_tpu_torch — the PyTorch/CUDA port of ravqa_tpu for NVIDIA Hopper.

Same subpackage layout as ravqa_tpu (ops/, models/, retrieval/,
executors/, data/, serving.py, main.py): each ported file has one
counterpart there, which is its reference in the tests. Plain tensor code
is PyTorch; each Pallas TPU kernel becomes a hand-written Hopper kernel
under csrc/, built at first use. Imports no jax and no flax; shares the
jax-free host modules ravqa_tpu.config and ravqa_tpu.tokenization.
"""

__version__ = "0.1.0"
