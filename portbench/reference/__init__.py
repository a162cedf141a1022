"""Plain fp32 PyTorch references that judge what the benchmark's windows produce."""
