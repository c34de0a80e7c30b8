"""Statement AST of the SQL dialect (and the front-end error hierarchy).

One dataclass per statement kind; the parser builds these, the planner
prices them, the executor runs them. `Where` is deliberately tiny — the
dialect supports exactly the predicates the paper's workloads need (point
lookups, label/class membership scans, top-k margins), so the planner can
always route to a §3.5 tier instead of a generic filter scan.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union


class SqlError(Exception):
    """Base of every front-end error (lex, parse, plan, execution)."""


class PlanError(SqlError):
    """Catalog / planner / option-validation errors (defined here, at the
    bottom of the import graph, so the typed option schemas can raise it;
    `repro_torch.rdbms.catalog` re-exports it for its historical import
    path)."""


@dataclasses.dataclass(frozen=True)
class Param:
    """A `?` placeholder inside a PREPAREd statement, numbered in parse
    order; EXECUTE binds positional values over these."""
    index: int


@dataclasses.dataclass
class Where:
    """Conjunction of the supported predicates (any subset may be set)."""
    ids: Optional[List[int]] = None        # id = n  /  id IN (...)
    label: Optional[int] = None            # label = ±1
    cls: Optional[int] = None              # class = c (multiclass views)
    view: Optional[int] = None             # view = v (selects one o-v-a view)

    def is_point(self) -> bool:
        return self.ids is not None


@dataclasses.dataclass
class CreateTable:
    name: str
    corpus: str                            # repro_torch.data factory name
    options: dict


@dataclasses.dataclass
class CreateView:
    name: str
    table: str
    model: str                             # "svm" | "logistic"
    options: dict                          # policy=, k=, engine=, buffer_frac=, ...


@dataclasses.dataclass
class Insert:
    table: str
    rows: List[Tuple[int, float]]          # (entity_id, label/class)


@dataclasses.dataclass
class Update:
    table: str
    entity_id: int
    label: float                           # SET label = y WHERE id = i


@dataclasses.dataclass
class Delete:
    table: str
    entity_id: int


@dataclasses.dataclass
class UpdateModel:
    view: str                              # UPDATE MODEL ON v


@dataclasses.dataclass
class Commit:
    pass


@dataclasses.dataclass
class Select:
    view: str
    columns: List[str]                     # id/view/label/margin/class, or *
    count: bool = False                    # SELECT COUNT(*)
    where: Optional[Where] = None
    order_by: Optional[str] = None         # only "margin"
    descending: bool = True
    limit: Optional[int] = None


@dataclasses.dataclass
class Explain:
    """EXPLAIN <stmt> plans without executing; EXPLAIN ANALYZE <stmt>
    EXECUTES the inner statement (Postgres semantics — DML included) and
    annotates the plan with the measured span tree and tier deltas."""
    stmt: Statement
    analyze: bool = False


@dataclasses.dataclass
class AlterView:
    """ALTER VIEW v SUSPEND | RESUME | REFRESH | SET (opt = val, ...)."""
    view: str
    action: str                            # "suspend"|"resume"|"refresh"|"set"
    options: dict = dataclasses.field(default_factory=dict)  # SET only


@dataclasses.dataclass
class Show:
    what: str      # "tables" | "views" | "storage" | "metrics" | "cost" | "schedule"
    view: Optional[str] = None             # SHOW COST ON <view>


@dataclasses.dataclass
class Prepare:
    """PREPARE name AS <statement with ? placeholders>."""
    name: str
    stmt: Statement
    n_params: int = 0


@dataclasses.dataclass
class ExecutePrepared:
    """EXECUTE name (v1, v2, ...) — binds and runs a prepared statement,
    reusing its cached plan route (point reads skip parse AND plan)."""
    name: str
    params: List[float] = dataclasses.field(default_factory=list)


Statement = Union[CreateTable, CreateView, AlterView, Insert, Update,
                  Delete, UpdateModel, Commit, Select, Explain, Show,
                  Prepare, ExecutePrepared]
