"""Parallel building blocks (counterpart of singa_tpu/parallel/).

Ported so far: the single-device reference attention
(`ring.full_attention`) and the data axis (`mesh`: the 1-D data group
and the batch-axis context DistOpt's BatchNorm sync reads).
"""
