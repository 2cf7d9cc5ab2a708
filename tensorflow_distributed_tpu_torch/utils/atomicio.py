"""Writers for files other processes read: the port's copy of
``utils/atomicio.py``'s ``atomic_write_json``. Its ``durable_append``
comes with the ``--observe.metrics-jsonl`` sink it serves, and the
path-family table its lint reads with the analysis layer (ROADMAP.md
A8).

:func:`atomic_write_json` replaces a whole file: a temporary
``<path>.tmp.<pid>`` (pid-suffixed, so two writers racing on one target
never share a staging file), fsync'd, then renamed over the path. A
reader sees the old payload or the new one, never a torn or empty file
(checkpoint manifests).

Pure stdlib.
"""

from __future__ import annotations

import json
import os
from typing import Any

__all__ = ["atomic_write_json"]


def atomic_write_json(path: str, obj: Any) -> str:
    """Atomically replace ``path`` with ``obj`` as JSON (fsync'd before
    the rename). Returns ``path``."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path
