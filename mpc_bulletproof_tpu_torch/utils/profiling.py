"""Lightweight profiling counters and spans.

The port's copy of the JAX package's ``utils/profiling.py``: named call
counters and wall-clock spans, process-wide, with zero cost when disabled
(the default).  The R1CS prover opens one span, ``r1cs.prove``, around
:meth:`..models.r1cs.prover.Prover.prove`.  A span measures the host
clock; work it enqueues on the card may finish after the span closes.

    from mpc_bulletproof_tpu_torch.utils import profiling
    profiling.enable()
    ... run proofs ...
    print(profiling.report())
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

_enabled = False
_counts: dict[str, int] = defaultdict(int)
_times: dict[str, float] = defaultdict(float)


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    _counts.clear()
    _times.clear()


def count(name: str, n: int = 1) -> None:
    if _enabled:
        _counts[name] += n


@contextmanager
def span(name: str):
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _times[name] += time.perf_counter() - t0
        _counts[name] += 1


def report() -> str:
    lines = ["span/counter              calls     total"]
    for name in sorted(set(_counts) | set(_times)):
        t = _times.get(name, 0.0)
        lines.append(f"{name:<24} {_counts.get(name, 0):>7} {t * 1e3:>8.2f}ms")
    return "\n".join(lines)


def snapshot() -> dict:
    return {
        "counts": dict(_counts),
        "times_ms": {k: v * 1e3 for k, v in _times.items()},
    }
