"""Online serving: the feature engine, its request batcher, and the
model serving engine."""

from .engine import FeatureEngine, ServingEngine  # noqa: F401
from .batcher import RequestBatcher  # noqa: F401
