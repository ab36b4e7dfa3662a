"""PyTorch/CUDA port of the LSM storage engine and its two-phase
write-stall harness.

The JAX package ``repro`` is the reference; this package imports none of
it.  Every Pallas kernel of the storage path is a CUDA C++ kernel for
Hopper (``csrc/``, built with ``nvcc`` at first use) with a plain PyTorch
twin beside it: CUDA tensors go to the kernel, CPU tensors to the twin.
Entry points default to ``device="cuda"`` and raise when no card is
present unless the caller passes ``device="cpu"``.
"""
