"""Constants, errors and device choice of the PyTorch/CUDA port."""
