"""The reference's lint (`python -m repro.analysis`) over the port's tree:
it must print nothing and exit 0. Its rules match on path parts and lock
class names, so they reach the port's files as they reach the
reference's: FRS001 (DAG edges only in `rdbms/catalog.py`, freshness
state written only under `scheduler/`), LCK001–004 (`EpochGate`,
`UpdateLog._commit_lock`, `BufferPool._lock`), TEL001 (no raw timer),
SRC001 and the PUR rules. A copy of the port with one planted fault in
the front end shows that the lint reads those files."""
import os
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _lint(tree):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro.analysis", tree],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)


def test_reference_lint_is_silent_on_the_port():
    out = _lint("src/repro_torch")
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout == "" and out.stderr == ""


@pytest.mark.parametrize("path,code,rule", [
    ("rdbms/executor.py",
     "\n\ndef _poke(vd):\n    vd.downstreams.append('x')\n", "FRS001"),
    ("rdbms/executor.py",
     "\n\ndef _poke(vd):\n    vd.runtime.inbox.clear()\n", "FRS001"),
    ("scheduler/refresh.py",
     "\n\ndef _stamp():\n    import time\n    return time.perf_counter()\n",
     "TEL001"),
])
def test_lint_reads_the_sql_front_end(tmp_path, path, code, rule):
    tree = tmp_path / "repro_torch"
    shutil.copytree(os.path.join(ROOT, "src/repro_torch"), tree,
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(tree / path, "a") as fh:
        fh.write(code)
    out = _lint(str(tree))
    assert out.returncode != 0 and rule in out.stdout, out.stdout[-3000:]
