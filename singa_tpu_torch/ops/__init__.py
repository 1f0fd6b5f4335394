"""Hand-written CUDA kernels for Hopper and their dispatchers
(counterpart of singa_tpu/ops/).

- `flash_attention`: the attention forward (`csrc/flash_fwd.cu`) and
  backward (`csrc/flash_bwd.cu`: a dQ kernel and a dK/dV kernel), each
  serving the head-split and the fused-QKV layouts, behind
  `torch.autograd.Function`s, with their plain PyTorch versions beside
  them.

Import the modules (`from singa_tpu_torch.ops import flash_attention as
fa`); unlike the reference, this package does not rebind their names to
functions.
"""
