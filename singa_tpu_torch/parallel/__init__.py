"""Parallel building blocks (counterpart of singa_tpu/parallel/).

Only the single-device reference attention (`ring.full_attention`) is
ported in this slice.
"""
