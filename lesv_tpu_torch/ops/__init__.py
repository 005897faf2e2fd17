"""Host- and device-side ops of the PyTorch/CUDA port."""
