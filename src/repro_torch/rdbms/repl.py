"""SQL entry point: interactive REPL and scripted execution.

Used by `python -m repro_torch.launch.serve --mode sql` (interactive), with
`--script f.sql` (run a file) or `--execute "stmt; stmt"` (one-shot).
"""
from __future__ import annotations

import sys
from typing import Optional

from repro_torch.rdbms.ast_nodes import SqlError
from repro_torch.rdbms.executor import Executor

BANNER = """HAZY SQL — classification views inside the relational front-end.
Statements end with ';'.  Try:
  CREATE TABLE papers FROM CORPUS cora_like WITH (scale = 0.1);
  CREATE CLASSIFICATION VIEW topics ON papers USING MODEL svm
      WITH (policy = hybrid, k = 7, memory_budget = 0.1);
  INSERT INTO papers (id, class) VALUES (0, 3), (1, 0);
  SELECT id, view, label FROM topics WHERE id = 0;
  EXPLAIN SELECT label FROM topics WHERE id = 0 AND view = 3;
  PREPARE pt AS SELECT label FROM topics WHERE id = ? AND view = ?;
  EXECUTE pt (0, 3);
  SHOW STORAGE;
Ctrl-D to exit."""


def run_script(sql: str, executor: Optional[Executor] = None, *,
               echo: bool = True, out=None) -> Executor:
    """Execute a `;`-separated script, printing each result table."""
    out = sys.stdout if out is None else out   # resolve at call time
    ex = executor or Executor()
    for result in ex.execute(sql):
        if echo:
            print(result.pretty(), file=out)
    return ex


def repl(executor: Optional[Executor] = None, *, stdin=None,
         out=None) -> Executor:
    stdin = sys.stdin if stdin is None else stdin
    out = sys.stdout if out is None else out
    ex = executor or Executor()
    print(BANNER, file=out)
    buf = ""
    while True:
        try:
            prompt = "sql> " if not buf else "...> "
            if stdin is sys.stdin and sys.stdin.isatty():
                line = input(prompt)
            else:
                line = stdin.readline()
                if not line:
                    break
        except EOFError:
            break
        buf += line.rstrip("\n") + "\n"
        if ";" not in buf:
            if buf.strip().lower() in ("quit", "exit"):
                break
            continue
        try:
            results = ex.execute(buf)
            for result in results:
                print(result.pretty(), file=out)
                if result.plan is not None:
                    p = result.plan
                    print(f"-- plan: {p.kind} via {p.tier} "
                          f"(est {p.est_touched} tuples)", file=out)
            print(_timing_footer(results), file=out)
        except SqlError as e:
            print(f"error: {e}", file=out)
        buf = ""
    return ex


def _timing_footer(results) -> str:
    """`-- N ms (gate-wait g ms, execute e ms)` from the statements' span
    trees — the SAME per-phase numbers the server's elapsed_us and EXPLAIN
    ANALYZE report (no second clock in the REPL)."""
    traces = [r.trace for r in results if r.trace is not None]
    total = sum(t.duration_us for t in traces) / 1e3
    gate = sum(t.sum_us("gate.wait") for t in traces) / 1e3
    execute = sum(t.sum_us("execute") for t in traces) / 1e3
    return (f"-- {total:.2f} ms (gate-wait {gate:.2f} ms, "
            f"execute {execute:.2f} ms)")
