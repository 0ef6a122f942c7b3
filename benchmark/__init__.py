"""The benchmark of norma_tpu_torch, the PyTorch and CUDA port (see run.py)."""
