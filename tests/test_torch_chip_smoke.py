"""chip_smoke.py refuses to run without a CUDA device: it exits non-zero and
prints no `{"ok": true, ...}` line, both from the repository root and from a
directory that holds the script alone. (With a device present it runs the
whole smoke run, which these tests do not start.)"""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SCRIPT = Path(__file__).resolve().parents[1] / "chip_smoke.py"


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_cuda(tmp_path, where):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run in full")
    if where == "alone":
        script = tmp_path / SCRIPT.name
        shutil.copy(SCRIPT, script)
    else:
        script = SCRIPT
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "is_available() is False" in proc.stderr
