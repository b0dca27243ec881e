"""SQL tokenizer (the port's copy of the JAX package's ``sql/lexer.py``,
the first module of its SQL front end).

Hand-rolled (no sqlparser dependency); mirrors the token classes the
reference gets from its forked sqlparser-rs (SURVEY §2.3 stage 1).
"""

from __future__ import annotations

from dataclasses import dataclass


class SqlError(ValueError):
    """Parse/plan-time SQL error."""


@dataclass(frozen=True)
class Token:
    kind: str  # "ident" | "quoted_ident" | "string" | "number" | "op" | "eof"
    value: str
    pos: int  # character offset (for error messages)

    def upper(self) -> str:
        return self.value.upper()


_MULTI_OPS = ["<>", "!=", ">=", "<=", "||", "::", "->>", "->"]
_SINGLE_OPS = "+-*/%(),.;=<>[]"


def tokenize(sql: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        # comments
        if sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i + 2)
            if j < 0:
                raise SqlError(f"unterminated block comment at {i}")
            i = j + 2
            continue
        # string literal
        if c == "'":
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":  # escaped ''
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            else:
                raise SqlError(f"unterminated string literal at {i}")
            toks.append(Token("string", "".join(buf), i))
            i = j + 1
            continue
        # quoted identifier
        if c == '"':
            j = sql.find('"', i + 1)
            if j < 0:
                raise SqlError(f"unterminated quoted identifier at {i}")
            toks.append(Token("quoted_ident", sql[i + 1 : j], i))
            i = j + 1
            continue
        # number
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_exp = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j > i:
                    seen_exp = True
                    j += 1
                    if j < n and sql[j] in "+-":
                        j += 1
                else:
                    break
            toks.append(Token("number", sql[i:j], i))
            i = j
            continue
        # identifier / keyword
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            toks.append(Token("ident", sql[i:j], i))
            i = j
            continue
        # operators (longest match first: ->> before ->)
        three = sql[i : i + 3]
        if three in _MULTI_OPS:
            toks.append(Token("op", three, i))
            i += 3
            continue
        two = sql[i : i + 2]
        if two in _MULTI_OPS:
            toks.append(Token("op", two, i))
            i += 2
            continue
        if c in _SINGLE_OPS:
            toks.append(Token("op", c, i))
            i += 1
            continue
        raise SqlError(f"unexpected character {c!r} at offset {i}")
    toks.append(Token("eof", "", n))
    return toks
