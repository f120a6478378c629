"""repro_torch — the PyTorch/CUDA port of the OpenMLDB reproduction.

A second package beside ``repro`` (the JAX reference, which it never
imports): the same SQL frontend, store, fused serving path, offline
executor and consistency gate, and the model serving path that consumes
the features (``serve.engine.ServingEngine``: prefill / decode /
``generate_greedy`` for the dense and hybrid families, e.g. hymba-1.5b),
with every TPU kernel rewritten by hand for the H100 (CUDA C++ for the
unit fold, the additive folds, the linear scan and flash decode; Triton
for feature hashing).  Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU.
"""
