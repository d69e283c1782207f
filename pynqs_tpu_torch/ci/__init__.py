"""ci of the PyTorch/CUDA port (see pynqs_tpu/ci)."""
