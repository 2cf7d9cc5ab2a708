"""The port's parity harness (imports no JAX): run one of the JAX
package's own test functions twice, once over the JAX package's classes
and once over the port's, each class wrapped so that every public call's
result is recorded, and hand back both records.

A scenario function reads the names it tests as globals of its module
(``Router``, ``Scheduler``, ...) or imports them inside its body; ``run``
patches both places for the run's duration, so the JAX test drives the
port unchanged and its own assertions hold the port too. Two records
that compare equal mean the same calls returned the same values, in the
same order, on both packages: decisions, records, snapshots, streams and
journals. The wall-clock fields ``ts``, ``wall_ts``, ``pid`` and ``t``
are dropped first, and the temporary directory's path is replaced by
``<tmp>``.
"""

import dataclasses
import inspect
import json
import os

import numpy as np
import pytest

#: Wall-clock fields: dropped from every recorded mapping.
CLOCK_FIELDS = ("ts", "wall_ts", "pid", "t")


def norm(obj, tmp: str):
    """``obj`` as plain JSON-like data, the clock fields dropped and the
    temporary root replaced."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"__type__": type(obj).__name__,
                **norm({f.name: getattr(obj, f.name)
                        for f in dataclasses.fields(obj)}, tmp)}
    if isinstance(obj, dict):
        return {str(k): norm(v, tmp) for k, v in obj.items()
                if k not in CLOCK_FIELDS}
    if isinstance(obj, (list, tuple)):
        return [norm(v, tmp) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(norm(v, tmp) for v in obj)
    if isinstance(obj, np.ndarray):
        return norm(obj.tolist(), tmp)
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, str):
        return obj.replace(tmp, "<tmp>") if tmp else obj
    if obj is None or isinstance(obj, (bool, int, float)):
        return obj
    return f"<{type(obj).__name__}>"


def recorded(obj, log: list, name: str, tmp: str, skip=()):
    """A recording stand-in for a class (a subclass whose public methods
    log their results, normalized at the call: a result the caller
    mutates later is recorded as it was returned) or a function (logging
    its result); any other value stands for itself."""
    if not callable(obj):
        return obj
    if inspect.isclass(obj):
        methods = {}
        for attr in dir(obj):
            if attr.startswith("_") or attr in skip:
                continue
            static = inspect.getattr_static(obj, attr)
            if isinstance(static, (staticmethod, classmethod, property)):
                continue
            fn = getattr(obj, attr)
            if not callable(fn):
                continue

            def make(attr, fn):
                def method(self, *a, **k):
                    out = fn(self, *a, **k)
                    log.append((name, attr, norm(out, tmp)))
                    return out
                return method
            methods[attr] = make(attr, fn)
        return type(obj.__name__, (obj,), methods)

    def function(*a, **k):
        out = obj(*a, **k)
        log.append((name, "()", norm(out, tmp)))
        return out
    return function


def _files(root: str) -> dict:
    """Every JSON and JSONL file under ``root``, parsed (a torn line is
    kept as text)."""
    out = {}
    for base, _, names in os.walk(root):
        for n in sorted(names):
            path = os.path.join(base, n)
            rel = os.path.relpath(path, root)
            with open(path) as f:
                text = f.read()
            if n.endswith(".json"):
                try:
                    out[rel] = json.loads(text)
                except ValueError:
                    out[rel] = text
            elif n.endswith(".jsonl"):
                lines = []
                for line in text.splitlines():
                    try:
                        lines.append(json.loads(line))
                    except ValueError:
                        lines.append(line)
                out[rel] = lines
    return out


def run(fn, targets: dict, tmp_path, skip=()):
    """Call the scenario ``fn`` with each name in ``targets`` (``{(module
    or module path, attribute): replacement}``) replaced by a recording
    wrapper of its replacement. Returns ``(calls, files)``: the
    normalized record of every wrapped call, and the normalized JSON
    files the scenario left under ``tmp_path`` (created)."""
    import importlib

    os.makedirs(tmp_path, exist_ok=True)
    tmp = str(tmp_path)
    log: list = []
    with pytest.MonkeyPatch.context() as mp:
        for (mod, attr), value in targets.items():
            if isinstance(mod, str):
                mod = importlib.import_module(mod)
            mp.setattr(mod, attr, recorded(value, log, attr, tmp, skip))
        params = inspect.signature(fn).parameters
        if "tmp_path" in params:
            fn(tmp_path)
        else:
            fn()
    return log, norm(_files(tmp), tmp)
