"""Tokenizer for the SQL dialect.

Case-insensitive keywords, Python-style numbers (incl. negative and
floats like `0.05`, `1e-4`, `inf`), identifiers, single-quoted strings,
and the punctuation the grammar needs. Statements are `;`-separated; the
lexer keeps positions so errors point at the offending character.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List

from repro_torch.rdbms.ast_nodes import SqlError


class LexError(SqlError):
    pass


# token kinds: KW (keyword), IDENT, NUMBER, STRING, PUNCT, END
KEYWORDS = {
    "create", "table", "classification", "view", "on", "using", "model",
    "with", "from", "corpus", "insert", "into", "values", "update", "set",
    "where", "delete", "commit", "select", "explain", "analyze", "order",
    "by", "limit", "asc", "desc", "and", "in", "count", "show", "tables",
    "views", "storage", "metrics", "cost", "prepare", "execute", "as",
    "alter", "suspend", "resume", "refresh", "schedule",
}

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<number>[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|[+-]?inf(?![A-Za-z_0-9]))
  | (?P<ident>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<string>'[^']*')
  | (?P<punct>[(),=*;?])
""", re.VERBOSE)


@dataclasses.dataclass(slots=True)
class Token:
    kind: str         # KW | IDENT | NUMBER | STRING | PUNCT | END
    value: str        # keywords/idents lowered; punct verbatim
    pos: int

    def __repr__(self):
        return f"{self.kind}:{self.value}"


def tokenize(sql: str) -> List[Token]:
    # finditer + a running end-position check (any gap = an unlexable
    # character) is measurably faster than per-position re.match — the
    # lexer sits on the batched-DML hot path, where statement parsing is
    # the whole front-end overhead the benchmarks report.
    out: List[Token] = []
    append = out.append
    keywords = KEYWORDS
    end = 0
    for m in _TOKEN_RE.finditer(sql):
        if m.start() != end:
            raise LexError(f"unexpected character {sql[end]!r} at {end}")
        end = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        if kind == "number":
            append(Token("NUMBER", text, m.start()))
        elif kind == "ident":
            low = text.lower()
            append(Token("KW" if low in keywords else "IDENT", low,
                         m.start()))
        elif kind == "string":
            append(Token("STRING", text[1:-1], m.start()))
        else:
            append(Token("PUNCT", text, m.start()))
    if end != len(sql):
        raise LexError(f"unexpected character {sql[end]!r} at {end}")
    append(Token("END", "", len(sql)))
    return out
