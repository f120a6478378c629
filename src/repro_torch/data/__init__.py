"""Data substrate: deterministic synthetic event streams + training
pipelines."""

from .synthetic import (make_action_tables, make_clicks_table,  # noqa: F401
                        ACTIONS_SCHEMA, ORDERS_SCHEMA, PROFILE_SCHEMA)
from .pipeline import FeatureDataPipeline, TokenPipeline  # noqa: F401
