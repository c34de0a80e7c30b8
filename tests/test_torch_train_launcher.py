"""The port's training launcher (`python -m repro_torch.launch.train`) on
the CPU: the analog of tests/test_training_e2e.py's
`test_train_launcher_preemption_resume` (SIGTERM after the first
checkpoint → a synchronous checkpoint and exit 0 → the relaunch prints
"resumed at step" and reaches --steps), and the fault-tolerance
contract's other half: the preempted and resumed run ends in the same
checkpoint, byte for byte, as an uninterrupted run beside it."""
import os
import signal
import subprocess
import sys
import time

import pytest

pytest.importorskip("torch")

from repro_torch.checkpoint import latest_step              # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
STEPS = 30


def _cmd(ckpt):
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "tinyllama-1.1b", "--smoke", "--device", "cpu", "--steps",
            str(STEPS), "--batch", "2", "--seq", "16", "--ckpt-dir", ckpt,
            "--ckpt-every", "5", "--log-every", "5"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"        # the same in every run compared
    return env


def _step_dir(ckpt, step):
    return os.path.join(ckpt, f"step_{step:08d}")


def test_train_launcher_preemption_resume(tmp_path):
    """SIGTERM mid-run -> checkpoint -> relaunch resumes past the kill point
    and ends where an uninterrupted run ends."""
    ckpt, whole = str(tmp_path / "ckpt"), str(tmp_path / "whole")
    env = _env()
    proc = subprocess.Popen(_cmd(ckpt), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    ref = subprocess.Popen(_cmd(whole), env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    # let it make progress, then preempt
    deadline = time.time() + 120
    while time.time() < deadline:
        if os.path.isdir(ckpt) and any(d.startswith("step_")
                                       for d in os.listdir(ckpt)):
            break
        time.sleep(0.2)
        if proc.poll() is not None:
            break
    proc.send_signal(signal.SIGTERM)
    out1, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, out1[-2000:]
    assert "preemption signal: checkpointing + exiting" in out1, out1[-2000:]

    resumed_from = latest_step(ckpt)
    assert resumed_from is not None and 0 < resumed_from < STEPS

    out2 = subprocess.run(_cmd(ckpt), env=env, capture_output=True,
                          text=True, timeout=120)
    assert out2.returncode == 0, out2.stdout[-2000:]
    assert f"[train] resumed at step {resumed_from}" in out2.stdout
    assert f"[train] done at step {STEPS}" in out2.stdout
    assert latest_step(ckpt) == STEPS

    out3, _ = ref.communicate(timeout=120)
    assert ref.returncode == 0, out3[-2000:]
    assert "resumed" not in out3 and latest_step(whole) == STEPS
    a, b = _step_dir(ckpt, STEPS), _step_dir(whole, STEPS)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "manifest.json" in names
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
