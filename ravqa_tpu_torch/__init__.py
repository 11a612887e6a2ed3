"""ravqa_tpu_torch — the PyTorch/CUDA port of ravqa_tpu for NVIDIA Hopper.

Same subpackage layout as ravqa_tpu (ops/, models/, retrieval/,
executors/, data/, config/, tokenization/, native/, scripts/, serving.py,
main.py): each ported file has one counterpart there, which is its
reference in the tests. Plain tensor code is PyTorch; each Pallas TPU
kernel becomes a hand-written Hopper kernel under csrc/, built at first
use. Imports nothing of ravqa_tpu, jax or flax: the host modules it needs
(config, tokenization, the native WordPiece encoder) are its own copies.
"""

__version__ = "0.1.0"
