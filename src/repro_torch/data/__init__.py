"""Data substrate: deterministic synthetic event streams."""

from .synthetic import (make_action_tables, ACTIONS_SCHEMA,  # noqa: F401
                        ORDERS_SCHEMA, PROFILE_SCHEMA)
