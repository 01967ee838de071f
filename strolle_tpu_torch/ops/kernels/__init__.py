"""Hand-written CUDA kernels (sources in ``strolle_tpu_torch/csrc``),
each beside its plain PyTorch version, which the wrapper runs for CPU
tensors only."""
