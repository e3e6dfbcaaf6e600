"""acclint over the port: the reference's analyzer (``python -m
accl_tpu.analysis``, run as a tool, not edited) checks
``accl_tpu_torch/`` with every check and must find nothing left
unsuppressed; each suppression in the port carries its reason."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_acclint_is_clean_over_the_port():
    out = subprocess.run(
        [sys.executable, "-m", "accl_tpu.analysis", "accl_tpu_torch",
         "--check"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
