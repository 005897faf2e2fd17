"""Pipeline stages of the PyTorch/CUDA port."""
