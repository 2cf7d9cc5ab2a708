"""Prefill length buckets: the port of ``serve/buckets.py``.

Padding prompts up to a small ladder of bucket lengths keeps the set of
prefill shapes to ``len(buckets)`` for the life of the process (one
compiled program each in the JAX package; here, one shape each, which a
later CUDA-graph capture can hold). Padding is pure slack: the causal
mask keeps positions >= the true length from influencing any real
token, and the engine takes the first token from the TRUE last
position.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def parse_buckets(spec: str) -> Tuple[int, ...]:
    """``"32,64,128"`` -> (32, 64, 128), validated ascending unique."""
    try:
        vals = tuple(int(tok) for tok in spec.split(",") if tok.strip())
    except ValueError:
        raise ValueError(
            f"buckets spec {spec!r} is not comma-separated ints") from None
    if not vals:
        raise ValueError(f"buckets spec {spec!r} names no buckets")
    if any(v < 1 for v in vals):
        raise ValueError(f"bucket lengths must be >= 1, got {vals}")
    if tuple(sorted(set(vals))) != vals:
        raise ValueError(
            f"buckets must be strictly ascending, got {vals}")
    return vals


def default_buckets(max_prompt_len: int, min_bucket: int = 16,
                    cap: int | None = None) -> Tuple[int, ...]:
    """Power-of-two ladder covering prompts up to ``max_prompt_len``:
    (min_bucket, 2*min_bucket, ...) — at most log2 buckets, <2x padding
    waste per prompt. ``cap`` (e.g. the model's max_len) clamps the
    ladder: rungs past it drop and the top rung becomes ``cap`` itself
    when the power-of-two would overshoot — a 100-token cache gets
    (16, 32, 64, 100), not an unusable 128."""
    if max_prompt_len < 1:
        raise ValueError(
            f"max_prompt_len must be >= 1, got {max_prompt_len}")
    if min_bucket < 1:
        raise ValueError(f"min_bucket must be >= 1, got {min_bucket}")
    if cap is not None and max_prompt_len > cap:
        raise ValueError(
            f"max_prompt_len {max_prompt_len} exceeds the bucket cap "
            f"{cap}")
    out = [min_bucket]
    while out[-1] < max_prompt_len:
        out.append(out[-1] * 2)
    if cap is not None:
        out = [b for b in out if b <= cap]
        if not out or out[-1] < max_prompt_len:
            out.append(cap)
    return tuple(out)


def pick_bucket(prompt_len: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits the prompt."""
    for b in buckets:
        if prompt_len <= b:
            return b
    raise ValueError(
        f"prompt length {prompt_len} exceeds the largest bucket "
        f"{max(buckets)}")
