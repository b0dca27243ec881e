from .engine import Engine, construct_operator, load_operators, register_operator, run_graph  # noqa: F401
