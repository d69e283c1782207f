"""pynqs_tpu_torch — the PyTorch/CUDA port of pynqs_tpu.

Mirrors the JAX package's module tree (``pynqs_tpu_torch/ops/
hamiltonian.py`` ↔ ``pynqs_tpu/ops/hamiltonian.py``, and so on).  It
imports torch and numpy only, never JAX or the JAX package.

Precision rule: integral and Hamiltonian arithmetic runs in full f32
on the card (f64 in the CPU tests), so TF32 is switched off for matrix
products and convolutions; only the ansatz forward may run bf16.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
