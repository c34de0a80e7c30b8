"""Recursive-descent parser: token stream -> statement AST.

Grammar (keywords case-insensitive, statements `;`-separated):

  CREATE TABLE t FROM CORPUS name [WITH (opt = val, ...)]
  CREATE CLASSIFICATION VIEW v ON t USING MODEL svm [WITH (opt = val, ...)]
        (ON may name another classification view: a derived view over its
         margin column — the freshness DAG edge)
  ALTER VIEW v SUSPEND | RESUME | REFRESH | SET (opt = val, ...)
  INSERT INTO t [(id, label)] VALUES (i, y) [, (i, y) ...]
  UPDATE t SET label = y WHERE id = i
  UPDATE MODEL ON v
  DELETE FROM t WHERE id = i
  COMMIT
  SELECT cols | COUNT(*) FROM v [WHERE pred [AND pred ...]]
         [ORDER BY margin [ASC|DESC]] [LIMIT n]
  EXPLAIN [ANALYZE] <any statement>
  SHOW TABLES | SHOW VIEWS | SHOW STORAGE | SHOW METRICS | SHOW SCHEDULE
       | SHOW COST ON v
  PREPARE p AS <statement with ? placeholders>
  EXECUTE p [(v1, v2, ...)]

  cols: * | id | view | label | margin | class  (comma-separated)
  pred: id = i | id IN (i, ...) | label = ±1 | class = c | view = v
  Inside PREPARE, any number position in a predicate / LIMIT / SET may be
  a `?` placeholder (numbered left to right); EXECUTE binds them.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.rdbms.ast_nodes import (
    AlterView, Commit, CreateTable, CreateView, Delete, ExecutePrepared,
    Explain, Insert, Param, Prepare, Select, Show, SqlError, Statement, Update,
    UpdateModel, Where)
from repro_torch.rdbms.lexer import Token, tokenize
from repro_torch.rdbms.options import coerce_number

COLUMNS = ("id", "view", "label", "margin", "class")


class ParseError(SqlError):
    pass


def _num(text: str) -> float:
    return float(text)


class _Parser:
    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.i = 0
        self._prepare_depth = 0      # > 0 while parsing a PREPARE body
        self._n_params = 0           # ? placeholders seen in that body

    # -- token helpers -------------------------------------------------
    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "END":
            self.i += 1
        return t

    def at_kw(self, *words: str) -> bool:
        t = self.peek()
        return t.kind == "KW" and t.value in words

    def expect_kw(self, word: str) -> Token:
        t = self.next()
        if t.kind != "KW" or t.value != word:
            raise ParseError(f"expected {word.upper()} at {t.pos}, got "
                             f"{t.value or 'end of input'!r}")
        return t

    def expect_punct(self, ch: str) -> Token:
        t = self.next()
        if t.kind != "PUNCT" or t.value != ch:
            raise ParseError(f"expected {ch!r} at {t.pos}, got "
                             f"{t.value or 'end of input'!r}")
        return t

    def expect_name(self) -> str:
        t = self.next()
        if t.kind not in ("IDENT", "KW", "STRING"):
            raise ParseError(f"expected a name at {t.pos}, got {t.value!r}")
        return t.value

    def expect_number(self) -> float:
        t = self.next()
        if t.kind != "NUMBER":
            raise ParseError(f"expected a number at {t.pos}, got {t.value!r}")
        return _num(t.value)

    def maybe_punct(self, ch: str) -> bool:
        if self.peek().kind == "PUNCT" and self.peek().value == ch:
            self.i += 1
            return True
        return False

    def number_or_param(self):
        """A literal number, or (inside PREPARE only) a `?` placeholder."""
        t = self.peek()
        if t.kind == "PUNCT" and t.value == "?":
            self.next()
            if not self._prepare_depth:
                raise ParseError(f"'?' placeholder outside PREPARE at {t.pos}")
            p = Param(self._n_params)
            self._n_params += 1
            return p
        return self.expect_number()

    @staticmethod
    def _as_int(v):
        return v if isinstance(v, Param) else int(v)

    # -- grammar -------------------------------------------------------
    def statements(self) -> List[Statement]:
        out: List[Statement] = []
        while self.peek().kind != "END":
            if self.maybe_punct(";"):
                continue
            out.append(self.statement())
            if self.peek().kind != "END":
                self.expect_punct(";")
        return out

    def statement(self) -> Statement:
        t = self.peek()
        if t.kind != "KW":
            raise ParseError(f"expected a statement at {t.pos}, got "
                             f"{t.value!r}")
        if t.value == "create":
            return self.create()
        if t.value == "alter":
            return self.alter()
        if t.value == "insert":
            return self.insert()
        if t.value == "update":
            return self.update()
        if t.value == "delete":
            return self.delete()
        if t.value == "commit":
            self.next()
            return Commit()
        if t.value == "select":
            return self.select()
        if t.value == "explain":
            self.next()
            analyze = False
            if self.at_kw("analyze"):
                self.next()
                analyze = True
            return Explain(self.statement(), analyze=analyze)
        if t.value == "show":
            self.next()
            what = self.next()
            if what.value == "cost":
                self.expect_kw("on")
                return Show("cost", view=self.expect_name())
            if what.value not in ("tables", "views", "storage", "metrics",
                                  "schedule"):
                raise ParseError(f"SHOW TABLES, SHOW VIEWS, SHOW STORAGE, "
                                 f"SHOW METRICS, SHOW SCHEDULE or "
                                 f"SHOW COST ON <view>, got {what.value!r}")
            return Show(what.value)
        if t.value == "prepare":
            return self.prepare()
        if t.value == "execute":
            return self.execute_prepared()
        raise ParseError(f"unknown statement {t.value!r} at {t.pos}")

    def alter(self) -> AlterView:
        self.expect_kw("alter")
        self.expect_kw("view")
        name = self.expect_name()
        t = self.next()
        if t.kind == "KW" and t.value in ("suspend", "resume", "refresh"):
            return AlterView(name, t.value)
        if t.kind == "KW" and t.value == "set":
            return AlterView(name, "set", self.options_body())
        raise ParseError(f"ALTER VIEW wants SUSPEND, RESUME, REFRESH or "
                         f"SET (...) at {t.pos}, got {t.value!r}")

    def prepare(self) -> Prepare:
        self.expect_kw("prepare")
        name = self.expect_name()
        self.expect_kw("as")
        self._prepare_depth += 1
        self._n_params = 0
        try:
            inner = self.statement()
        finally:
            self._prepare_depth -= 1
        if isinstance(inner, (Prepare, ExecutePrepared)):
            raise ParseError("cannot PREPARE a PREPARE/EXECUTE statement")
        return Prepare(name, inner, self._n_params)

    def execute_prepared(self) -> ExecutePrepared:
        self.expect_kw("execute")
        name = self.expect_name()
        params: List[float] = []
        if self.maybe_punct("("):
            params.append(self.expect_number())
            while self.maybe_punct(","):
                params.append(self.expect_number())
            self.expect_punct(")")
        return ExecutePrepared(name, params)

    def with_options(self) -> dict:
        if not self.at_kw("with"):
            return {}
        self.next()
        return self.options_body()

    def options_body(self) -> dict:
        """`(key = value, ...)` — shared by WITH and ALTER ... SET. Values
        stay RAW here (number/identifier/string); the typed schemas in
        `repro_torch.rdbms.options` own all per-option validation, the parser
        only applies the dialect-wide number coercion."""
        opts: dict = {}
        self.expect_punct("(")
        while True:
            key = self.expect_name()
            self.expect_punct("=")
            t = self.next()
            if t.kind == "NUMBER":
                opts[key] = coerce_number(_num(t.value))
            elif t.kind in ("IDENT", "KW", "STRING"):
                opts[key] = t.value
            else:
                raise ParseError(f"bad option value at {t.pos}")
            if not self.maybe_punct(","):
                break
        self.expect_punct(")")
        return opts

    def create(self) -> Statement:
        self.expect_kw("create")
        if self.at_kw("table"):
            self.next()
            name = self.expect_name()
            self.expect_kw("from")
            self.expect_kw("corpus")
            corpus = self.expect_name()
            return CreateTable(name, corpus, self.with_options())
        self.expect_kw("classification")
        self.expect_kw("view")
        name = self.expect_name()
        self.expect_kw("on")
        table = self.expect_name()
        self.expect_kw("using")
        self.expect_kw("model")
        model = self.expect_name()
        return CreateView(name, table, model, self.with_options())

    def insert(self) -> Insert:
        self.expect_kw("insert")
        self.expect_kw("into")
        table = self.expect_name()
        if self.maybe_punct("("):       # optional (id, label) column list
            c1, = (self.expect_name(),)
            self.expect_punct(",")
            c2 = self.expect_name()
            self.expect_punct(")")
            if (c1, c2) not in (("id", "label"), ("id", "class")):
                raise ParseError(
                    f"INSERT columns must be (id, label) or (id, class), "
                    f"got ({c1}, {c2})")
        self.expect_kw("values")
        # tight loop over the '(' NUMBER ',' NUMBER ')' tuples — this is
        # the batched-DML hot path (the front-end overhead the benchmarks
        # gate on); malformed input rewinds into the expect_* helpers for
        # their error messages
        toks, j = self.toks, self.i
        rows = []
        while True:
            chunk = toks[j:j + 5]
            if (len(chunk) == 5 and chunk[0].value == "("
                    and chunk[1].kind == "NUMBER" and chunk[2].value == ","
                    and chunk[3].kind == "NUMBER" and chunk[4].value == ")"):
                rows.append((int(float(chunk[1].value)),
                             float(chunk[3].value)))
                j += 5
            else:
                self.i = j
                self.expect_punct("(")
                i = self.expect_number()
                self.expect_punct(",")
                y = self.expect_number()
                self.expect_punct(")")
                rows.append((int(i), float(y)))
                j = self.i
            t = toks[j]
            if t.kind == "PUNCT" and t.value == ",":
                j += 1
                continue
            break
        self.i = j
        return Insert(table, rows)

    def update(self) -> Statement:
        self.expect_kw("update")
        if self.at_kw("model"):         # UPDATE MODEL ON v
            self.next()
            self.expect_kw("on")
            return UpdateModel(self.expect_name())
        table = self.expect_name()
        self.expect_kw("set")
        col = self.expect_name()
        if col not in ("label", "class"):
            raise ParseError(f"can only SET label/class, got {col!r}")
        self.expect_punct("=")
        y = self.number_or_param()
        self.expect_kw("where")
        idcol = self.expect_name()
        if idcol != "id":
            raise ParseError(f"UPDATE needs WHERE id = n, got {idcol!r}")
        self.expect_punct("=")
        i = self.number_or_param()
        return Update(table, self._as_int(i),
                      y if isinstance(y, Param) else float(y))

    def delete(self) -> Delete:
        self.expect_kw("delete")
        self.expect_kw("from")
        table = self.expect_name()
        self.expect_kw("where")
        idcol = self.expect_name()
        if idcol != "id":
            raise ParseError(f"DELETE needs WHERE id = n, got {idcol!r}")
        self.expect_punct("=")
        return Delete(table, self._as_int(self.number_or_param()))

    def select(self) -> Select:
        self.expect_kw("select")
        count = False
        columns: List[str] = []
        if self.at_kw("count"):
            self.next()
            self.expect_punct("(")
            self.expect_punct("*")
            self.expect_punct(")")
            count = True
        elif self.maybe_punct("*"):
            columns = ["id", "label"]
        else:
            while True:
                col = self.expect_name()
                if col not in COLUMNS:
                    raise ParseError(
                        f"unknown column {col!r}; columns are "
                        f"{', '.join(COLUMNS)}")
                columns.append(col)
                if not self.maybe_punct(","):
                    break
        self.expect_kw("from")
        view = self.expect_name()
        where = self.where() if self.at_kw("where") else None
        order_by, desc = None, True
        if self.at_kw("order"):
            self.next()
            self.expect_kw("by")
            order_by = self.expect_name()
            if order_by != "margin":
                raise ParseError(f"can only ORDER BY margin, got {order_by!r}")
            if self.at_kw("asc"):
                self.next()
                desc = False
            elif self.at_kw("desc"):
                self.next()
        limit: Optional[int] = None
        if self.at_kw("limit"):
            self.next()
            limit = self._as_int(self.number_or_param())
        return Select(view, columns, count=count, where=where,
                      order_by=order_by, descending=desc, limit=limit)

    def where(self) -> Where:
        self.expect_kw("where")
        w = Where()
        while True:
            col = self.expect_name()
            if col == "id":
                if self.at_kw("in"):
                    self.next()
                    self.expect_punct("(")
                    ids = [self._as_int(self.number_or_param())]
                    while self.maybe_punct(","):
                        ids.append(self._as_int(self.number_or_param()))
                    self.expect_punct(")")
                    w.ids = ids
                else:
                    self.expect_punct("=")
                    w.ids = [self._as_int(self.number_or_param())]
            elif col == "label":
                self.expect_punct("=")
                w.label = self._as_int(self.number_or_param())
                if not isinstance(w.label, Param) and w.label not in (1, -1):
                    raise ParseError("label predicate must be 1 or -1")
            elif col == "class":
                self.expect_punct("=")
                w.cls = self._as_int(self.number_or_param())
            elif col == "view":
                self.expect_punct("=")
                w.view = self._as_int(self.number_or_param())
            else:
                raise ParseError(f"unsupported predicate column {col!r}")
            if not self.at_kw("and"):
                break
            self.next()
        return w


def parse(sql: str) -> List[Statement]:
    """Parse a `;`-separated script into a list of statements."""
    return _Parser(tokenize(sql)).statements()


def parse_one(sql: str) -> Statement:
    stmts = parse(sql)
    if len(stmts) != 1:
        raise ParseError(f"expected one statement, got {len(stmts)}")
    return stmts[0]
