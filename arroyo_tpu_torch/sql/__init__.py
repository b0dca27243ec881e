"""The SQL front end of the port: its lexer so far (the parser, planner and
compiler follow it)."""
