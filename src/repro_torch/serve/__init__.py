"""Online serving: the feature engine, its request batcher, the model
serving engine, and the serving loop.

Layers: ``FeatureEngine`` (deployed script + store, synchronous call
surface) -> ``ServeLoop`` (deadline-aware batching, admission control,
snapshot double buffer, record/replay; ``serve.loop``) with time
injected through ``serve.clock`` and traces handled by ``serve.trace``.
"""

from .engine import EngineSnapshot, FeatureEngine, ServingEngine  # noqa: F401
from .batcher import RequestBatcher  # noqa: F401
from .clock import Clock, SystemClock, VirtualClock  # noqa: F401
from .loop import AdmissionError, ServeLoop  # noqa: F401
from .trace import (TraceEvent, TraceRecorder, load_trace,  # noqa: F401
                    record_consistency_trace, replay, save_trace)
