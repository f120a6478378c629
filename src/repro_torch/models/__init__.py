"""Model stack of the dense and hybrid families (llama3-8b, hymba-1.5b),
served through the flash-decode and linear-scan kernels."""

from .model import (decode_step, forward_prefill,  # noqa: F401
                    init_decode_state, init_params, params_from_jax)

__all__ = ["init_params", "params_from_jax", "forward_prefill",
           "init_decode_state", "decode_step"]
