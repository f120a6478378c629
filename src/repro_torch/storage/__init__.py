"""Online time-series store and runtime memory guard."""

from .timestore import OnlineStore, StoreSnapshot  # noqa: F401
from .memest import MemoryGuard  # noqa: F401
