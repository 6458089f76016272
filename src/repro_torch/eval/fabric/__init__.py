"""Batched fluid transfer model on torch tensors.

Channel state lives in (S, C) tensors, per-chunk queue state in (S, K)
tensors over one flat file-size buffer; :mod:`.kernels` holds the fluid
kernels, :mod:`.controllers` the SC / MC / ProMC decision kernels, and
:mod:`.driver` the sweep loop. The water-fill and the fused sweep step
run as hand-written CUDA kernels on the card
(:mod:`.kernels.waterfill_bisect`; :mod:`.kernels.fused_step`, one step a
launch or a row's steps in a loop; sources in ``csrc/``).
"""
