"""repro_torch.core — SQL frontend, plan, leaf algebra, compiler, the
offline/online consistency gate and the deploy-time certifier."""

from .types import Column, ColumnType, Dictionary, Table, TableSchema  # noqa: F401
from .expr import (AggCall, BinaryOp, ColumnRef, Expr, FuncCall,  # noqa: F401
                   Literal, UnaryOp)
from .window import WindowSpec, parse_interval_ms  # noqa: F401
from .plan import FeatureScript, LastJoinSpec, SelectItem, build_plan  # noqa: F401
from .sql import ParseError, parse  # noqa: F401
from .compiler import (CompileContext, CompiledScript,  # noqa: F401
                       cache_stats, clear_cache, compile_script)
from .consistency import replay_online, verify_consistency  # noqa: F401
from .analysis import DeploymentCertificate, certify  # noqa: F401
