"""The reference's lint (`python -m repro.analysis`) over the port's tree:
it must print nothing and exit 0. Its rules match on path parts and lock
class names, so they reach the port's files as they reach the
reference's: FRS001 (DAG edges only in `rdbms/catalog.py`, freshness
state written only under `scheduler/`), LCK001–004 (`EpochGate`,
`UpdateLog._commit_lock`, `BufferPool._lock`), TEL001 (no raw timer),
SRC001 and the PUR rules. A copy of the port with one planted fault in
the front end shows that the lint reads those files.

The port's own passes (`python -m repro_torch.analysis`), in process:
silent on the port's tree; on each file of the reference's fixture corpus
and on `src/repro`, the same findings as `repro.analysis` (rule, line and
message, the package's name aside); the torch forms the reference's rules
cannot see (an `EngineState` step, `.copy_`/`.index_put_`/`.zero_`, an
`out=` keyword, the decode kernel's old out-parameter) found under their
rules; the same planted faults through the port's CLI."""
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


# ---------------------------------------------------------------------------
# the port's own passes (`repro_torch.analysis`), in process
# ---------------------------------------------------------------------------

FIXTURES = os.path.join(ROOT, "tests", "fixtures", "analysis")
CORPUS = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".py"))


def _port_cli(capsys, *argv):
    from repro_torch.analysis.__main__ import main
    capsys.readouterr()
    rc = main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_port_lint_is_silent_on_its_tree(capsys):
    from repro_torch.analysis import run
    assert run() == []
    assert _port_cli(capsys) == (0, "", "")


def _normalized(findings):
    """(path, line, rule, message), the package's name read as the
    reference's."""
    return [(f.path, f.line, f.rule, f.message.replace("repro_torch",
                                                       "repro"))
            for f in findings]


@pytest.mark.parametrize("target", CORPUS + ["src/repro"])
def test_findings_equal_the_reference(target):
    """On each file of the reference's fixture corpus and on the
    reference's own tree, the port's passes find what `repro.analysis`
    finds: the same rule, line and message."""
    from pathlib import Path

    from repro import analysis as reference
    from repro_torch import analysis as port
    if target == "src/repro":
        files = sorted(Path(ROOT, "src", "repro").rglob("*.py"))
    else:
        files = [Path(FIXTURES, target)]
    want = _normalized(reference.run(files))
    assert _normalized(port.run(files)) == want
    if target.startswith("bad_"):
        assert want


# the torch forms the reference's rules cannot see: (file under the scan
# root, code, the rules found in order); a pure step is known by an `xp`
# parameter or by a first parameter annotated `EngineState`; a file
# outside `src/` is a shell too, so a step that writes a state's field
# breaks both rules (as an assignment does under the reference's)
TORCH_FORMS = {
    "step_copy_": ("step.py", """
def advance(state: EngineState, labels):
    labels.copy_(state.labels)
    return state
""", ["PUR003"]),
    "step_field_index_put_": ("step.py", """
def relabel(state: "EngineState", idx, value):
    state.labels.index_put_((idx,), value)
    return state
""", ["PUR003", "PUR004"]),
    "step_out_keyword": ("step.py", """
import torch

def shift(state: EngineState, delta):
    torch.add(state.eps_sorted, delta, out=state.eps_sorted)
    return state
""", ["PUR003", "PUR004"]),
    "xp_step_add_": ("step.py", """
def bump(acc, xp):
    acc[0].add_(1.0)
    return acc
""", ["PUR003"]),
    "step_side_effects": ("step.py", """
def probe(state: EngineState, i):
    print(state.pos_count[i].item())
    return state
""", ["PUR002", "PUR002"]),
    "shell_index_put_": ("shell.py", """
def poke(state, rows, labels):
    state.labels.index_put_((rows,), labels)
""", ["PUR004"]),
    "shell_out_keyword": ("shell.py", """
import torch

def poke(eng, mask, a, b):
    torch.where(mask, a, b, out=eng.labels)
""", ["PUR004"]),
    "shell_subscript_zero_": ("shell.py", """
def clear(eng, v):
    eng.acc[v].zero_()
""", ["PUR004"]),
    # the decode kernel's wrapper as it stood: its `lse` out-parameter
    # filled in Python on an empty block
    "kernel_out_parameter": ("kernels/decode_attention/kernel.py", """
def decode_attention(q, k, v, cache_index, lse=None, row0=None):
    out = q.new_zeros(q.shape)
    if lse is not None:
        lse.fill_(float("-inf"))
    return out
""", ["PUR003"]),
    # none of these is a finding: numpy on the host in an EngineState
    # step, a shell's own mirror, locals, dunders, a non-field attribute
    "allowed": ("shell.py", """
import numpy as np

def waters(state: EngineState, lw):
    hw = np.maximum(state.hw, 0.0)
    out = lw.clone()
    out.add_(1.0)
    return state._replace(hw=hw), out

class Shell:
    def sync(self, state):
        self.labels.copy_(state.labels)
        self.__init_subclass__()
        state.cache.zero_()
""", []),
}


@pytest.mark.parametrize("case", sorted(TORCH_FORMS))
def test_torch_in_place_forms_are_found(tmp_path, case):
    from repro_torch.analysis import run
    name, code, rules = TORCH_FORMS[case]
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(code)
    found = run([path], rules=["PUR"])
    assert [f.rule for f in found] == rules, found


def test_engine_state_steps_of_the_port_are_checked():
    """The port's six Layer 2 steps are pure steps to the pass (known by
    their `EngineState` argument), and none of them is held to PUR001."""
    import ast
    from pathlib import Path

    from repro_torch.analysis import purity
    path = Path(ROOT, "src", "repro_torch", "core", "engine.py")
    steps = {fn.name: xp for fn, xp in purity._pure_steps(
        ast.parse(path.read_text()))}
    assert {"_margins", "reorganize", "_relabel", "apply_model",
            "catch_up", "hybrid_probe"} <= set(steps)
    assert not any(steps.values())


@pytest.mark.parametrize("path,code,rule", [
    ("rdbms/executor.py",
     "\n\ndef _poke(vd):\n    vd.downstreams.append('x')\n", "FRS001"),
    ("rdbms/executor.py",
     "\n\ndef _poke(vd):\n    vd.runtime.inbox.clear()\n", "FRS001"),
    ("scheduler/refresh.py",
     "\n\ndef _stamp():\n    import time\n    return time.perf_counter()\n",
     "TEL001"),
])
def test_port_lint_reads_the_sql_front_end(tmp_path, capsys, path, code,
                                           rule):
    """The planted faults of `test_lint_reads_the_sql_front_end` through
    the port's CLI."""
    tree = tmp_path / "repro_torch"
    shutil.copytree(os.path.join(ROOT, "src/repro_torch"), tree,
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(tree / path, "a") as fh:
        fh.write(code)
    rc, out, err = _port_cli(capsys, str(tree))
    assert rc == 1 and rule in out and "1 finding(s)" in err, out[-3000:]
