"""CI-style exercise of the real-data parity runbook.

Berlin/Munich data cannot mount in this environment, so the BASELINE.md
gate stays open — but the day it mounts, `scripts/runbook_real_data.py`
must run builder -> train -> test -> building-instance eval in one command.
The --dry-run mode runs the IDENTICAL chain on a synthetic city; this test
keeps it green against CLI/config churn.
"""

import json
import os
import subprocess
import sys


def test_runbook_dry_run(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable,
         os.path.join(repo, "scripts", "runbook_real_data.py"),
         "--dry-run", "--work", str(tmp_path)],
        capture_output=True, text=True, timeout=1500, cwd=repo,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, (proc.stdout[-3000:] + proc.stderr[-3000:])
    assert "=== runbook result ===" in proc.stdout
    results = list(tmp_path.glob("outputs/*/runbook_result.json"))
    assert results, "runbook_result.json not written"
    res = json.loads(results[0].read_text())
    assert res["config"] == "cloud"
    assert set(res["instance"]) == {"RMSE_B", "MAE_B", "MedAE_B"}
    assert res["n_buildings"] > 0
    for v in res["instance"].values():
        assert 0.0 <= v < 100.0  # sane meters on the synthetic city
