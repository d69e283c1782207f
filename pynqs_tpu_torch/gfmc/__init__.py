"""gfmc of the PyTorch/CUDA port (see pynqs_tpu/gfmc)."""
