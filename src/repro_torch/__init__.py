"""repro_torch — the PyTorch/CUDA port of the OpenMLDB reproduction.

A second package beside ``repro`` (the JAX reference, which it never
imports): the same SQL frontend, store and fused serving path, with the
TPU kernels on that path rewritten by hand for the H100 (CUDA C++ for
the unit fold, Triton for feature hashing).  Entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU.
"""
