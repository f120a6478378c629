"""repro_torch.core — SQL frontend, plan, leaf algebra and compiler."""

from .types import Column, ColumnType, Dictionary, Table, TableSchema  # noqa: F401
from .window import WindowSpec, parse_interval_ms  # noqa: F401
from .plan import FeatureScript, LastJoinSpec, SelectItem, build_plan  # noqa: F401
from .sql import ParseError, parse  # noqa: F401
from .compiler import CompileContext, CompiledScript, compile_script  # noqa: F401
