"""Batched fluid transfer model on torch tensors.

Channel state lives in (S, C) tensors, per-chunk queue state in (S, K)
tensors over one flat file-size buffer; :mod:`.kernels` holds the fluid
kernels, :mod:`.controllers` the SC / MC / ProMC decision kernels, and
:mod:`.driver` the sweep loop. Two of the fluid steps run as
hand-written CUDA kernels on the card (:mod:`.kernels.waterfill`,
:mod:`.kernels.fused_step`, sources in ``csrc/``).
"""
