"""Concurrent SQL server: asyncio wire protocol over the shared Executor.

Architecture (thin shell over the `EngineFacade` seam — the serving layer
adds NO engine semantics of its own):

  * one asyncio event loop accepts connections and frames messages
    (`repro_torch.rdbms.wire`: 4-byte length prefix + JSON);
  * each connection gets a `Session` — a private prepared-statement cache
    over the ONE shared `Executor` (catalog, WAL, engines);
  * statement execution is synchronous numpy work, so each request is
    handed to a thread pool; the executor's epoch gate arbitrates — point
    reads on eager/hybrid views run concurrently under a pinned epoch
    (snapshot isolation), group commits serialize exclusively behind
    them (see `repro_torch.rdbms.concurrency`);
  * a session's own DML is always visible to its next read
    (read-your-writes: reads flush the target table's pending group
    before pinning), and the closed loop per connection means the flush
    is ordered after the append.

`SqlServer` is the asyncio core; `ServerHandle`/`start_server_thread` run
it on a background thread for tests, benchmarks, and embedders that live
in sync code.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import os
import threading
from typing import Optional

from repro_torch.obs import trace
from repro_torch.rdbms.ast_nodes import SqlError
from repro_torch.rdbms.executor import Executor, Result, Session
from repro_torch.rdbms.wire import (
    WireError, decode_payload, encode_frame, frame_length)

logger = logging.getLogger("repro_torch.rdbms.server")


def _result_payload(res: Result) -> dict:
    out = {"columns": list(res.columns),
           "rows": [list(r) for r in res.rows],
           "epoch": res.epoch}
    if res.plan is not None:
        out["plan"] = {"kind": res.plan.kind, "tier": res.plan.tier,
                       "est_touched": res.plan.est_touched}
    if res.tiers_used is not None:
        out["tiers"] = list(res.tiers_used)
    if res.trace is not None:
        # span-derived timing: the SAME tree EXPLAIN ANALYZE and the REPL
        # footer render, so every surface reports one per-phase breakdown
        out["elapsed_us"] = round(res.trace.duration_us, 1)
        out["phases"] = {c.name: round(c.duration_us, 1)
                         for c in res.trace.children}
    return out


class SqlServer:
    """Asyncio server; construct, `await start()`, then `serve_forever()`
    (or use `start_server_thread` from sync code)."""

    def __init__(self, executor: Optional[Executor] = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 max_workers: Optional[int] = None,
                 log_statements: bool = False):
        self.executor = executor if executor is not None else Executor()
        self.host = host
        self.port = port                    # 0 -> ephemeral; set by start()
        self.log_statements = log_statements    # access log (one INFO line
                                                # per statement) on/off
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers or min(32, (os.cpu_count() or 4) * 4),
            thread_name_prefix="sql-session")
        self._server: Optional[asyncio.AbstractServer] = None
        self.sessions_opened = 0
        self.statements_served = 0

    async def start(self):
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def serve_forever(self):
        assert self._server is not None, "call start() first"
        async with self._server:
            await self._server.serve_forever()

    async def aclose(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self._pool.shutdown(wait=False)

    # -- one connection == one session ---------------------------------
    async def _handle_connection(self, reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter):
        session = Session(self.executor)
        self.sessions_opened += 1
        loop = asyncio.get_running_loop()
        try:
            while True:
                try:
                    header = await reader.readexactly(4)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                try:
                    payload = await reader.readexactly(frame_length(header))
                    request = decode_payload(payload)
                except (WireError, ValueError, asyncio.IncompleteReadError):
                    break                   # desynced stream: drop session
                if not isinstance(request, dict):
                    response = {"ok": False, "error": "request must be an "
                                "object", "error_type": "WireError"}
                elif request.get("op") == "close":
                    writer.write(encode_frame({"ok": True, "closed": True}))
                    await writer.drain()
                    break
                else:
                    # run the (GIL-releasing numpy) statement off the loop;
                    # the epoch gate decides who actually runs concurrently
                    response = await loop.run_in_executor(
                        self._pool, self._serve_request, session, request)
                writer.write(encode_frame(response))
                await writer.drain()
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    # -- worker-thread side --------------------------------------------
    def _serve_request(self, session: Session, request: dict) -> dict:
        op = request.get("op")
        try:
            if op == "ping":
                return {"ok": True, "pong": True,
                        "session": session.session_id,
                        "epoch": self.executor.epoch}
            if op == "metrics":
                # the unified telemetry snapshot over the wire — what the
                # CI serve-smoke reconciles and dashboards would scrape
                return {"ok": True,
                        "metrics": self.executor.metrics_snapshot(),
                        "session": session.session_id}
            if op == "refresh":
                # freshness barrier: commit pending DML + refresh every
                # view (or request["view"] + ancestors) in topo order.
                # NOT a statement — it must not skew per-statement
                # telemetry the serve benchmarks reconcile.
                refreshed = self.executor.refresh_views(request.get("view"))
                return {"ok": True, "refreshed": refreshed,
                        "epoch": self.executor.epoch,
                        "session": session.session_id}
            with trace.span("request", metrics=self.executor.metrics,
                            op=op):
                if op == "query":
                    results = session.execute(request["sql"])
                elif op == "execute":
                    results = [session.execute_prepared(
                        request["name"], request.get("params", ()))]
                else:
                    raise SqlError(f"unknown op {op!r}")
            self.statements_served += len(results)
            if self.log_statements:
                for r in results:
                    self._access_log(session, r)
            return {"ok": True,
                    "results": [_result_payload(r) for r in results],
                    "session": session.session_id,
                    "elapsed_us": sum(r.trace.duration_us for r in results
                                      if r.trace is not None)}
        except Exception as e:              # statement errors keep the
            # session alive; the class name crosses the wire (the client
            # re-raises typed) and the server keeps its own trace
            logger.warning("session %s statement failed: %s: %s",
                           session.session_id, type(e).__name__, e)
            if self.log_statements:
                logger.info(
                    "session=%s op=%s kind=- epoch=%s elapsed_us=- error=%s",
                    session.session_id, op, self.executor.epoch,
                    type(e).__name__)
            return {"ok": False, "error": str(e),
                    "error_type": type(e).__name__,
                    "session": session.session_id}

    def _access_log(self, session: Session, res: Result):
        """One structured line per statement (satellite of the telemetry
        layer): session, statement kind, pinned epoch, span-derived µs."""
        kind = res.trace.attrs.get("kind", "?") if res.trace else "?"
        us = f"{res.trace.duration_us:.1f}" if res.trace else "-"
        logger.info("session=%s op=query kind=%s epoch=%s elapsed_us=%s "
                    "error=-", session.session_id, kind, res.epoch, us)


class ServerHandle:
    """A running SqlServer on a background daemon thread (the sync-world
    entry: tests, the benchmark swarm, `--serve` supervisors)."""

    def __init__(self, server: SqlServer, loop: asyncio.AbstractEventLoop,
                 thread: threading.Thread):
        self.server = server
        self._loop = loop
        self._thread = thread

    @property
    def address(self):
        return self.server.host, self.server.port

    def stop(self, timeout: float = 5.0):
        async def _shutdown():
            await self.server.aclose()
        if self._loop.is_running():
            fut = asyncio.run_coroutine_threadsafe(_shutdown(), self._loop)
            try:
                fut.result(timeout)
            except (concurrent.futures.TimeoutError, RuntimeError):
                pass
            try:
                self._loop.call_soon_threadsafe(self._loop.stop)
            except RuntimeError:
                pass                         # loop already wound down
        self._thread.join(timeout)


def start_server_thread(executor: Optional[Executor] = None, *,
                        host: str = "127.0.0.1", port: int = 0,
                        max_workers: Optional[int] = None,
                        log_statements: bool = False,
                        bind_timeout: float = 10.0) -> ServerHandle:
    """Start a SqlServer on its own event loop + daemon thread; returns
    once the socket is bound (raises if binding fails)."""
    server = SqlServer(executor, host=host, port=port,
                       max_workers=max_workers,
                       log_statements=log_statements)
    loop = asyncio.new_event_loop()
    bound = threading.Event()
    failure: list = []

    def _run():
        asyncio.set_event_loop(loop)

        async def _main():
            try:
                await server.start()
            except OSError as e:
                failure.append(e)
                return
            finally:
                bound.set()
            try:
                await server.serve_forever()
            except asyncio.CancelledError:
                pass

        try:
            loop.run_until_complete(_main())
        finally:
            loop.close()

    thread = threading.Thread(target=_run, name="sql-server", daemon=True)
    thread.start()
    if not bound.wait(bind_timeout):
        raise RuntimeError(f"SQL server failed to bind within "
                           f"{bind_timeout}s")
    if failure:
        raise RuntimeError(f"SQL server could not bind "
                           f"{host}:{port}: {failure[0]}") from failure[0]
    return ServerHandle(server, loop, thread)
