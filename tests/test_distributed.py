"""Multi-process (multi-host scaffolding) smoke test.

Spawns two REAL OS processes, each with 4 virtual CPU devices, joined by
``jax.distributed`` into one 8-device global mesh — the same code path a
multi-host cluster takes (SURVEY.md §2.3/§5). Verifies:
  - init_distributed wires coordinator/process ids,
  - make_mesh spans all global devices,
  - shard_batch assembles per-process local batches into one global array,
  - a jitted replicated-output reduction returns the identical global value
    on every process (the cross-process collective actually ran).
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "dist_worker_smoke.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class TestMultiProcessMesh:
    def test_two_process_global_mesh(self):
        nproc = 2
        coord = f"127.0.0.1:{_free_port()}"
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        procs = [
            subprocess.Popen(
                [sys.executable, WORKER, str(pid), str(nproc), coord],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
                text=True)
            for pid in range(nproc)
        ]
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=300)
                assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        sums = []
        for out in outs:
            lines = [l for l in out.splitlines() if l.startswith("GLOBAL_SUM")]
            assert lines, out
            sums.append(float(lines[-1].split()[1]))
        # sum of both processes' local batches: (0..11)=66 plus 1000*12 offset
        expected = 66.0 + (66.0 + 1000.0 * 12)
        assert sums == [expected] * nproc, sums
