"""Pinned inputs and proof digests of the range prover and the R1CS shuffle.

Range proofs: the inputs are the deterministic ones of the JAX package's
fused-prover test: values and blindings from ``random.Random(909)`` and a
blinding stream of chained sha256 blocks.  :data:`DIGESTS` holds, per
``(n, m)``, the sha256 of ``proof bytes || V bytes || final transcript
state`` that the JAX package's host party/dealer path gives for them.

R1CS: a k-shuffle (:func:`shuffle_inputs`, the transcript of
:func:`shuffle_transcript`), its blinding RNG finalized with the first 32
bytes of :func:`det_stream`.  :data:`SHUFFLE_DIGESTS` holds, per k, the same
digest over the proof, the 2k commitments (inputs, then outputs) and the
final transcript state, from the JAX package's host prover.

``chip_smoke.py`` holds the card's proofs to these digests, and the CPU
tests recompute them from the JAX package.
"""

from __future__ import annotations

import hashlib
import random

from .ops.field import Scalar

TRANSCRIPT_LABEL = b"fused-rp"
SHUFFLE_LABEL = b"ShuffleProofTest"

DIGESTS = {
    (8, 2): "1f97185de6591a8a35c03ecf79378ba753cdf8182fd8eea9094da55091d8ec2c",
    (64, 64): "2f5823ea54cc5e9fb1e190f71d0b6c5cfde362ecbae7d94c1dcec34b7ebf1554",
}

SHUFFLE_DIGESTS = {
    16: "344e14748e5e33f48a3e520f89418346ee9199d7b01e59247405b40f7a35d2b8",
    1024: "6d443a4bd8c3020258ed1ab0698a145ac0ef0579d84826929cfba3dbcf6b7d17",
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


def shuffle_inputs(k: int):
    """``(inputs, outputs, blindings)`` of a k-shuffle: k values, the same
    values in a seeded permutation, and 2k blindings (inputs' first)."""
    rng = random.Random(4242)
    inputs = [Scalar(rng.getrandbits(251)) for _ in range(k)]
    perm = list(range(k))
    rng.shuffle(perm)
    outputs = [inputs[i] for i in perm]
    blindings = [Scalar(rng.getrandbits(251)) for _ in range(2 * k)]
    return inputs, outputs, blindings


def shuffle_transcript(k: int):
    """The transcript a k-shuffle proof starts from (prover and verifier)."""
    from .transcript import HashChainTranscript

    t = HashChainTranscript(SHUFFLE_LABEL)
    t.append_message(b"dom-sep", b"ShuffleProof")
    t.append_u64(b"k", k)
    return t


def proof_digest(proof, commitments, transcript_state: bytes) -> str:
    data = proof.to_bytes() + b"".join(v.to_bytes() for v in commitments) + transcript_state
    return hashlib.sha256(data).hexdigest()
