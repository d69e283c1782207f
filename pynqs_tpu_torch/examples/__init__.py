"""examples of the PyTorch/CUDA port (see examples/)."""
