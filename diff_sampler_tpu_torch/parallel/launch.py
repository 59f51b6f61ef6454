"""Run one Python command as n local processes of a multi-process job: the
helper that the multi-process tests and ``chip_smoke.py`` start their ranks
with.  Users launch the CLIs with torchrun (see ``parallel/mesh.py``).

Process i gets ``DST_COORDINATOR`` (a ``file://`` rendezvous in a fresh
temporary directory, so that no port is taken), ``DST_NUM_PROCESSES``,
``DST_PROCESS_ID=i``, ``DST_LOCAL_DEVICE_IDS`` (the i-th of ``devices``,
by default i) and, with ``backend``, ``DST_BACKEND``; the CLIs read them
through ``parallel.mesh.maybe_initialize_distributed``.  ``run_local``
waits for every process; at the first failure, or at its timeout, it kills
the others, so that no rank waits forever on a peer that is gone.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

__all__ = ["run_local"]


def run_local(nproc: int, args: Sequence[str], *, backend: Optional[str] = None,
              devices: Optional[Sequence[int]] = None, timeout_s: float = 600.0,
              env: Optional[dict] = None,
              cwd: Optional[str] = None) -> List[Tuple[int, str]]:
    """Run ``python <args>`` as ``nproc`` processes of one job; returns each
    process's (exit code, output) in rank order.  A process still running
    when another failed, or at ``timeout_s``, is killed (exit code -9);
    every process has ended when this returns."""
    devices = list(devices) if devices is not None else list(range(nproc))
    if len(devices) != nproc:
        raise ValueError(f"{len(devices)} device ids for {nproc} processes")
    tmp = tempfile.mkdtemp(prefix="dst_launch_")
    procs, logs = [], []
    try:
        for rank in range(nproc):
            penv = dict(os.environ if env is None else env)
            penv.update(DST_COORDINATOR=f"file://{os.path.join(tmp, 'rendezvous')}",
                        DST_NUM_PROCESSES=str(nproc), DST_PROCESS_ID=str(rank),
                        DST_LOCAL_DEVICE_IDS=str(devices[rank]))
            if backend:
                penv["DST_BACKEND"] = backend
            out = open(os.path.join(tmp, f"rank{rank}.log"), "w+")
            logs.append(out)
            procs.append(subprocess.Popen([sys.executable, *args], env=penv, cwd=cwd,
                                          stdout=out, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            failed = any(p.poll() not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
            time.sleep(0.05)
        results = []
        for p, out in zip(procs, logs):
            out.seek(0)
            results.append((p.wait(), out.read()))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out in logs:
            out.close()
        shutil.rmtree(tmp, ignore_errors=True)

