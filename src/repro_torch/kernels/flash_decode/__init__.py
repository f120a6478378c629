"""Decode attention with mergeable partial-softmax states (ref.py =
plain PyTorch version; kernel.py + csrc/ = the CUDA kernel for sm_90a;
ops.py = dispatch)."""

from .ops import (decode_attention, decode_attention_ref,  # noqa: F401
                  decode_partials, finalize_partials, merge_partials)

__all__ = ["decode_partials", "decode_attention", "merge_partials",
           "finalize_partials", "decode_attention_ref"]
