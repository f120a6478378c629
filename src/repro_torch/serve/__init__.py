"""Online serving: the feature engine and its request batcher."""

from .engine import FeatureEngine  # noqa: F401
from .batcher import RequestBatcher  # noqa: F401
