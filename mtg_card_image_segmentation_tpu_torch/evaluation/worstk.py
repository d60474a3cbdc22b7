"""Shared running worst-k buffer merge for the evaluators (copy of the JAX
package's ``evaluation/worstk.py``).

The evaluators keep the k most extreme cases (lowest IoU / highest corner
error) across batches, materializing image arrays only for admitted
candidates — each is a device->host copy, and most candidates lose once
the buffer fills.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Tuple


def merge_worst_k(
    buffer: List[tuple],
    candidates: Iterable[Tuple[float, Callable[[], tuple]]],
    k: int,
    reverse: bool,
) -> None:
    """Merge ``(key, build_entry)`` candidates into ``buffer`` in place.

    - ``buffer`` holds tuples whose first element is the key; it is kept
      sorted most-extreme-first and at most ``k`` long.
    - ``candidates`` must be ordered most-extreme-first; iteration stops at
      the first candidate that cannot displace the buffer's weakest member
      (later candidates are weaker still).
    - ``reverse=True`` means larger keys are more extreme (errors);
      ``False`` means smaller keys are (IoUs).
    - ``build_entry()`` is called only for admitted candidates and returns
      the entry's tail (everything after the key).
    """
    if k <= 0:
        return

    def more_extreme(a: float, b: float) -> bool:
        return a > b if reverse else a < b

    for key, build in candidates:
        if len(buffer) < k:
            buffer.append((key, *build()))
        elif more_extreme(key, buffer[-1][0]):
            buffer[-1] = (key, *build())
        else:
            break
        buffer.sort(key=lambda t: t[0], reverse=reverse)


def fresh_failures_dir(output_dir: str) -> str:
    """Create (or wipe) ``output_dir``/failures and return its path.

    Evaluators regenerate their panels on every run; without clearing,
    re-evaluating into the same run dir accretes stale worst-k panels next
    to current ones — the exact artifacts a human inspects. Only the
    evaluator writes here, so wiping the directory is safe.
    """
    import os
    import shutil

    fdir = os.path.join(output_dir, "failures")
    shutil.rmtree(fdir, ignore_errors=True)
    os.makedirs(fdir, exist_ok=True)
    return fdir
