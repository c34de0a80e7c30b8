"""Blocking SQL client for the wire protocol (`repro_torch.rdbms.wire`).

One `SqlClient` == one server session (its own prepared-statement cache
server-side). The canonical surface mirrors the redesigned DDL/ALTER
statements one-to-one:

    with SqlClient.connect(host, port) as c:
        c.run("CREATE TABLE papers FROM CORPUS cora_like; ...")
        c.prepare("pt", "SELECT label FROM topics WHERE id = ? AND view = ?")
        rows = c.run_prepared("pt", [17, 3]).rows
        c.alter_view("slow", target_lag="5 s")   # ALTER VIEW ... SET (...)
        c.suspend("slow"); c.resume("slow")
        c.refresh()                              # freshness barrier
        for row in c.show("schedule"):           # typed rows
            print(row.view, row.state, row.staleness_s)

`query` / `query_one` / `execute` are the legacy spellings — thin
deprecated wrappers that emit byte-identical wire frames (a test pins
that), kept so embedders written against the old surface keep working.

Every call is a strict request/response round trip (closed loop), so a
session's statements are totally ordered — which is exactly what makes
read-your-writes meaningful at the protocol level.

`ServerError` carries the server-side error string; transport problems
raise `WireError`.
"""
from __future__ import annotations

import dataclasses
import socket
import warnings
from collections import namedtuple
from typing import List, Optional, Sequence

from repro_torch.rdbms.wire import recv_frame, send_frame, WireError


class ServerError(RuntimeError):
    def __init__(self, message: str, error_type: str = "SqlError"):
        super().__init__(message)
        self.error_type = error_type

    def __str__(self) -> str:
        return f"{self.error_type}: {super().__str__()}"


@dataclasses.dataclass
class ClientResult:
    columns: List[str]
    rows: List[list]
    epoch: Optional[int] = None
    plan: Optional[dict] = None
    tiers: Optional[List[str]] = None
    elapsed_us: Optional[float] = None      # span-derived statement time
    phases: Optional[dict] = None           # {span name: µs} top-level phases

    def __iter__(self):
        return iter(self.rows)

    @staticmethod
    def from_payload(p: dict) -> "ClientResult":
        return ClientResult(p.get("columns", []), p.get("rows", []),
                            p.get("epoch"), p.get("plan"), p.get("tiers"),
                            p.get("elapsed_us"), p.get("phases"))

    def typed_rows(self) -> list:
        """The rows as namedtuples keyed by the result's column names."""
        row_t = namedtuple("Row", self.columns, rename=True)
        return [row_t(*r) for r in self.rows]


def _option_sql(value) -> str:
    """Render one option value for `SET (k = v)`: numbers bare, flags as
    on/off, strings quoted (a target_lag like '5 s' needs the quotes)."""
    if isinstance(value, bool):
        return "on" if value else "off"
    if isinstance(value, (int, float)):
        return repr(value)
    return "'" + str(value).replace("'", "") + "'"


class SqlClient:
    def __init__(self, sock: socket.socket):
        self._sock = sock
        self.session_id: Optional[int] = None
        self.last_elapsed_us: Optional[float] = None

    @classmethod
    def connect(cls, host: str, port: int,
                timeout: Optional[float] = 30.0) -> "SqlClient":
        sock = socket.create_connection((host, port), timeout=timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return cls(sock)

    # -- protocol round trips ------------------------------------------
    def request(self, obj: dict) -> dict:
        send_frame(self._sock, obj)
        response = recv_frame(self._sock)
        if response is None:
            raise WireError("server closed the connection")
        self.session_id = response.get("session", self.session_id)
        if not response.get("ok"):
            raise ServerError(response.get("error", "unknown server error"),
                              response.get("error_type", "SqlError"))
        self.last_elapsed_us = response.get("elapsed_us")
        return response

    def run(self, sql: str) -> List[ClientResult]:
        """Execute a `;`-separated SQL script; one result per statement."""
        response = self.request({"op": "query", "sql": sql})
        return [ClientResult.from_payload(p)
                for p in response.get("results", [])]

    def run_one(self, sql: str) -> ClientResult:
        results = self.run(sql)
        if len(results) != 1:
            raise ServerError(f"expected one result, got {len(results)}")
        return results[0]

    def prepare(self, name: str, sql: str) -> ClientResult:
        return self.run_one(f"PREPARE {name} AS {sql.rstrip(';')}")

    def run_prepared(self, name: str,
                     params: Sequence[float] = ()) -> ClientResult:
        """EXECUTE a prepared statement (the zero-parse wire path)."""
        response = self.request({"op": "execute", "name": name,
                                 "params": list(params)})
        return ClientResult.from_payload(response["results"][0])

    # -- the freshness surface -----------------------------------------
    def alter_view(self, view: str, **options) -> ClientResult:
        """`ALTER VIEW view SET (opt = val, ...)` — typed-schema checked
        server-side; e.g. `c.alter_view("v", target_lag="5 s")`."""
        if not options:
            raise ValueError("alter_view() needs at least one option")
        body = ", ".join(f"{k} = {_option_sql(v)}"
                         for k, v in options.items())
        return self.run_one(f"ALTER VIEW {view} SET ({body})")

    def suspend(self, view: str) -> ClientResult:
        """Freeze a view: reads keep serving its current labels while
        committed base-table updates queue."""
        return self.run_one(f"ALTER VIEW {view} SUSPEND")

    def resume(self, view: str) -> ClientResult:
        """Unfreeze a view; it catches up exactly once, bit-identically
        to never having been suspended."""
        return self.run_one(f"ALTER VIEW {view} RESUME")

    def refresh(self, view: Optional[str] = None,
                wait: bool = True) -> List[str]:
        """Freshness barrier: commit pending DML and refresh every view
        (or `view` plus its ancestors) in topological order. Returns the
        refreshed view names. The protocol is closed-loop, so the call
        always blocks until the barrier completes — `wait` is accepted
        for signature stability."""
        del wait
        request: dict = {"op": "refresh"}
        if view is not None:
            request["view"] = view
        return list(self.request(request).get("refreshed", []))

    def show(self, what: str, view: Optional[str] = None) -> list:
        """`SHOW <what>` as typed rows (namedtuples keyed by the result
        columns): `c.show("schedule")[0].staleness_s`, etc. `what` is one
        of tables/views/storage/metrics/schedule/cost (cost needs
        `view=`)."""
        if what == "cost":
            if view is None:
                raise ValueError('show("cost") needs view=')
            return self.run_one(f"SHOW COST ON {view}").typed_rows()
        return self.run_one(f"SHOW {what.upper()}").typed_rows()

    # -- legacy spellings (deprecated, wire-format identical) ----------
    def query(self, sql: str) -> List[ClientResult]:
        warnings.warn("SqlClient.query() is deprecated; use run()",
                      DeprecationWarning, stacklevel=2)
        return self.run(sql)

    def query_one(self, sql: str) -> ClientResult:
        warnings.warn("SqlClient.query_one() is deprecated; use run_one()",
                      DeprecationWarning, stacklevel=2)
        return self.run_one(sql)

    def execute(self, name: str,
                params: Sequence[float] = ()) -> ClientResult:
        warnings.warn("SqlClient.execute() is deprecated; use "
                      "run_prepared()", DeprecationWarning, stacklevel=2)
        return self.run_prepared(name, params)

    # -- plumbing ------------------------------------------------------
    def ping(self) -> int:
        """Round trip; returns the server's current epoch."""
        return self.request({"op": "ping"})["epoch"]

    def metrics(self) -> dict:
        """The server's unified telemetry snapshot (counters, gauges,
        histograms, per-component collectors, epoch) as plain JSON."""
        return self.request({"op": "metrics"})["metrics"]

    def close(self):
        if self._sock is not None:
            try:
                send_frame(self._sock, {"op": "close"})
                recv_frame(self._sock)
            except (OSError, WireError):
                pass
            finally:
                self._sock.close()
                self._sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
