"""The port's SQL front end: SQL text -> the port's logical dataflow Graph
(the port's copy of the JAX package's ``sql``): a self-contained
lexer/parser/planner compiles SQL to the Graph IR whose operators are the
port's (windows, joins, updating aggregates over the device kernels) and
whose expressions are arroyo_tpu_torch.expr nodes.

Scope mirrors the JAX package's: connector DDL with event-time/watermark
options, projections/filters, tumble/hop/session window aggregates,
updating (non-windowed) aggregates, stream-stream windowed and updating
joins, SQL window functions (OVER), views, and INSERT INTO.
"""

from .parser import parse_statements
from .planner import PlanError, Planner, plan_query

__all__ = ["parse_statements", "plan_query", "Planner", "PlanError"]
