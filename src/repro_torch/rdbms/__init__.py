"""Relational front-end over the HAZY engines (the paper's actual surface),
the counterpart of `repro.rdbms` over the port's engine facades.

The paper's architecture puts classification *inside* the RDBMS: users
issue SQL DDL/DML/SELECTs against model-based views and the system picks
eager/lazy/hybrid maintenance under the covers. This package is that
surface for our engines:

  * `catalog`  — base entity tables + registered classification views
                 (single-view / multiclass / sharded, behind `EngineFacade`)
  * `lexer`/`parser`/`ast_nodes` — the SQL dialect
  * `wal`      — group-commit update log (WAL-style, replayable): heavy
                 write traffic amortizes into ONE engine round per commit
  * `planner`  — routes reads to the cheapest §3.5 tier and prices every
                 statement in touched tuples (the §3.4/§3.5 cost model)
  * `executor` — executes plans; `EXPLAIN` makes tier + cost user-visible;
                 `Session` scopes a prepared-statement cache per client
  * `concurrency` — the epoch gate: statement-scoped snapshot isolation
                 (readers pin the committed WAL batch index; commits
                 serialize exclusively behind them)
  * `wire`/`server`/`client` — length-prefixed-JSON protocol, the asyncio
                 SQL server (N concurrent sessions over ONE executor),
                 and the blocking client
                 (`python -m repro_torch.launch.serve --mode sql --serve ...`)
  * `repl`     — interactive / scripted entry point
                 (`python -m repro_torch.launch.serve --mode sql`)
"""
from repro_torch.rdbms.ast_nodes import (
    AlterView, Commit, CreateTable, CreateView, Delete, ExecutePrepared,
    Explain, Insert, Param, Prepare, Select, Show, Update, UpdateModel, Where)
from repro_torch.rdbms.catalog import Catalog, PlanError, SqlError, ViewDef
from repro_torch.rdbms.client import ClientResult, ServerError, SqlClient
from repro_torch.rdbms.concurrency import EpochGate
from repro_torch.rdbms.executor import Executor, Result, Session
from repro_torch.rdbms.lexer import LexError
from repro_torch.rdbms.options import (
    DOWNSTREAM, TableOptions, ViewOptions, format_lag, parse_lag)
from repro_torch.rdbms.parser import ParseError, parse
from repro_torch.rdbms.planner import Plan, plan_statement
from repro_torch.rdbms.server import (ServerHandle, SqlServer,
                                      start_server_thread)
from repro_torch.rdbms.wal import UpdateLog, WalRecord
