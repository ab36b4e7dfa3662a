"""The storage engine on PyTorch: the paper's policies, schedulers and
constraints, the engine's write/read/merge path on the hand-written
kernels, and the two-phase write-stall harness."""
