"""Model stack of every family of the JAX package (dense, hybrid, MoE,
MLA, VLM, audio, RWKV6), served through the flash-decode and linear-scan
kernels and trained through the linear scan's forward and backward
kernels; served also on weights in pieces over a mesh's cards
(``tensor_parallel``)."""

from .model import (decode_step, fill_placed,  # noqa: F401
                    forward_prefill, forward_train, init_decode_state,
                    init_params, loss_fn, model_input_spec, params_from_jax,
                    train_state_from_jax)

__all__ = ["init_params", "params_from_jax", "forward_train", "loss_fn",
           "forward_prefill", "init_decode_state", "decode_step",
           "model_input_spec", "train_state_from_jax", "fill_placed"]
