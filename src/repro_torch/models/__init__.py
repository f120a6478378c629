"""Model stack of the dense and hybrid families (llama3-8b, hymba-1.5b),
served through the flash-decode and linear-scan kernels and trained
through the linear scan's forward and backward kernels."""

from .model import (decode_step, forward_prefill,  # noqa: F401
                    forward_train, init_decode_state, init_params,
                    loss_fn, model_input_spec, params_from_jax,
                    train_state_from_jax)

__all__ = ["init_params", "params_from_jax", "forward_train", "loss_fn",
           "forward_prefill", "init_decode_state", "decode_step",
           "model_input_spec", "train_state_from_jax"]
