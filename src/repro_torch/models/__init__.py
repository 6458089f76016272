"""Models of the LLM scaffold, in PyTorch: the RWKV-6 serving path."""
