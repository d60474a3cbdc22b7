"""Crash/leak-tolerant subprocess watchdog (a copy of the JAX package's
``datagen/watchdog.py``; synthetic_dataset_anti_leak.py:75-127 parity): run a command, kill it if a
run exceeds the time limit (terminate -> grace wait -> kill), restart, and
stop once a run completes within the limit. Combined with the generators'
resume-skip of existing outputs this makes long dataset generation
restartable and leak-tolerant."""

from __future__ import annotations

import subprocess
import time
from typing import List, Optional, Sequence


def run_with_watchdog(
    command: Sequence[str],
    timeout_minutes: float = 30.0,
    grace_seconds: float = 10.0,
    max_restarts: int = 100,
    log=print,
) -> int:
    """Returns the final exit code (0 when a run finished under the limit)."""
    for attempt in range(1, max_restarts + 1):
        log(f"[watchdog] attempt {attempt}: {' '.join(command)}")
        proc = subprocess.Popen(command)
        try:
            code = proc.wait(timeout=timeout_minutes * 60)
            log(f"[watchdog] finished with exit code {code}")
            return code
        except subprocess.TimeoutExpired:
            log(
                f"[watchdog] exceeded {timeout_minutes} min — terminating "
                f"(grace {grace_seconds}s) and restarting"
            )
            proc.terminate()
            try:
                proc.wait(timeout=grace_seconds)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    log(f"[watchdog] giving up after {max_restarts} restarts")
    return -1
