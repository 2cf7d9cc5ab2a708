"""Writers for files other processes read: the port's copy of
``utils/atomicio.py``'s ``atomic_write_json`` and ``durable_append``.
The path-family table its lint reads comes with the analysis layer
(ROADMAP.md A8).

- :func:`atomic_write_json` replaces a whole file: a temporary
  ``<path>.tmp.<pid>`` (pid-suffixed, so two writers racing on one
  target never share a staging file), fsync'd, then renamed over the
  path. A reader sees the old payload or the new one, never a torn or
  empty file (checkpoint manifests, the ``--observe.export-path``
  snapshot a fleet router polls, trace files).
- :func:`durable_append` appends one JSON line, flushed to the OS: the
  append streams (a fleet replica's inbox, the supervisor's records in
  the child's metrics JSONL) survive a process kill. No fsync a line: it
  would only add OS-crash cover these streams do not promise, at a cost
  on the serving path.

Pure stdlib.
"""

from __future__ import annotations

import json
import os
from typing import Any

__all__ = ["atomic_write_json", "durable_append"]


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


def durable_append(path: str, record: Any) -> None:
    """Append one JSON line, flushed to the OS (one writer a file; the
    readers tolerate a torn tail)."""
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
        f.flush()
