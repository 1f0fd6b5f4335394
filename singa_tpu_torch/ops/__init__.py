"""Hand-written CUDA kernels for Hopper and their dispatchers
(counterpart of singa_tpu/ops/).

- `flash_attention`: the attention forward (`csrc/flash_fwd.cu`), one
  kernel for the head-split and the fused-QKV layouts, with its plain
  PyTorch version beside it.

Import the modules (`from singa_tpu_torch.ops import flash_attention as
fa`); unlike the reference, this package does not rebind their names to
functions.
"""
