"""Feature-signature hashing into a fixed-dim sparse space (§4.1(5))."""

from .ops import feature_hash  # noqa: F401

__all__ = ["feature_hash"]
