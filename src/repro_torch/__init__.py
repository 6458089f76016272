"""PyTorch / CUDA port of the protocol-tuning reproduction.

The batched scenario sweep — scenarios -> columnar plan -> batched fluid
driver -> per-scenario results -> golden compare — runs here on an NVIDIA
H100 through two hand-written CUDA kernels (the bisected water-fill and
the fused sweep step). The package imports ``torch`` and ``numpy`` only;
it keeps its own copy of every host-side module it needs.

RWKV-6 serving (``repro_torch.models.model.build_model``,
``repro_torch.train.serve_step.generate``) runs its recurrence through a
third hand-written CUDA kernel, the WKV-6 scan.

Entry points (``repro_torch.eval.runner.run_matrix``,
``TorchFabricSimulation``, ``build_model``) run on the card by default and
raise when no card is present, unless the caller passes ``device="cpu"``,
where every kernel wrapper runs its plain PyTorch version.
"""
