"""Pinned inputs and proof digests of the range prover.

The inputs are the deterministic ones of the JAX package's fused-prover
test: values and blindings from ``random.Random(909)`` and a blinding stream
of chained sha256 blocks.  :data:`DIGESTS` holds, per ``(n, m)``, the
sha256 of ``proof bytes || V bytes || final transcript state`` that the JAX
package's host party/dealer path gives for them; ``chip_smoke.py`` holds the
card's proof to it, and a CPU test recomputes it from the JAX package.
"""

from __future__ import annotations

import hashlib
import random

from .ops.field import Scalar

TRANSCRIPT_LABEL = b"fused-rp"

DIGESTS = {
    (8, 2): "1f97185de6591a8a35c03ecf79378ba753cdf8182fd8eea9094da55091d8ec2c",
    (64, 64): "2f5823ea54cc5e9fb1e190f71d0b6c5cfde362ecbae7d94c1dcec34b7ebf1554",
}


def det_stream():
    """``rng_bytes(k)``: a deterministic blinding stream."""
    state = {"ctr": 0}

    def rng_bytes(k: int) -> bytes:
        out = b""
        while len(out) < k:
            out += hashlib.sha256(b"fused-test" + state["ctr"].to_bytes(4, "big")).digest()
            state["ctr"] += 1
        return out[:k]

    return rng_bytes


def inputs(n: int, m: int):
    """``(values, blindings)`` for an ``(n, m)`` proof."""
    rng = random.Random(909)
    values = [rng.randrange(1 << n) for _ in range(m)]
    blindings = [Scalar(rng.getrandbits(251)) for _ in range(m)]
    return values, blindings


def proof_digest(proof, commitments, transcript_state: bytes) -> str:
    data = proof.to_bytes() + b"".join(v.to_bytes() for v in commitments) + transcript_state
    return hashlib.sha256(data).hexdigest()
