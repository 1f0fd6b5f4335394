"""PyTorch/CUDA port of singa_tpu for NVIDIA Hopper (H100).

A second package beside `singa_tpu`, which stays the reference: each
module here carries the name of its counterpart there, with PyTorch
idiom inside (`nn.Module`s, plain functions on tensors, an explicit
`device=` and `torch.Generator`). Every Pallas kernel of the reference
that a ported path reaches is a hand-written CUDA kernel here
(`ops/csrc/`), built with `nvcc` on first use.

Entry points run on CUDA unless the caller passes `device="cpu"`; with
no card and no explicit CPU request they raise. On CPU tensors the
kernel wrappers run their plain PyTorch versions, which the parity
tests hold against `singa_tpu`.

This package imports nothing of JAX and nothing of `singa_tpu`.
"""
