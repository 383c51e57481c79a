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

Collaborative (2-party MPC) R1CS: :func:`mpc_range_party` is one party's
side of an m-value, n-bit range proof (party 0 owns the first half of
the values, party 1 the rest), on :func:`mpc_range_inputs` and the
transcript labelled :data:`MPC_LABEL`.  The deterministic pre-processing
(``PartyIdBeaverSource``) leaves nothing random in the opened proof.
:data:`MPC_RANGE_DIGESTS` holds, per ``(n, m)``, the same digest over the
opened proof, the m commitments and party 0's final transcript state,
from the JAX package's host path.  To recompute one (the (64, 64) one
takes a few seconds of CPU)::

    BP_FORCE_BACKEND=host JAX_PLATFORMS=cpu python -c \
        "from tests.test_torch_mpc import jax_mpc_range; print(jax_mpc_range(64, 64)[2])"

``chip_smoke.py`` holds the card's proofs to these digests, and the CPU
tests recompute them from the JAX package.
"""

from __future__ import annotations

import hashlib
import random

from .ops.field import Scalar

TRANSCRIPT_LABEL = b"fused-rp"
SHUFFLE_LABEL = b"ShuffleProofTest"
MPC_LABEL = b"mpc-range"

DIGESTS = {
    (8, 2): "1f97185de6591a8a35c03ecf79378ba753cdf8182fd8eea9094da55091d8ec2c",
    (64, 64): "2f5823ea54cc5e9fb1e190f71d0b6c5cfde362ecbae7d94c1dcec34b7ebf1554",
}

SHUFFLE_DIGESTS = {
    16: "344e14748e5e33f48a3e520f89418346ee9199d7b01e59247405b40f7a35d2b8",
    1024: "6d443a4bd8c3020258ed1ab0698a145ac0ef0579d84826929cfba3dbcf6b7d17",
}


MPC_RANGE_DIGESTS = {
    (4, 2): "99799541d8825308e570fd3ef7281e4673587a8e419b9623f6b664efa6024e78",
    (8, 2): "da514356c3e56f6dad7761b9f3cdaaed65f141a9a4f1d9fa90fda11229faf0bb",
    (64, 64): "aff23d88bad49214ea128ce2962019dc8102b0e20e6f91127bf3ce9cb65286e1",
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


def mpc_range_inputs(n: int, m: int):
    """``(values, blindings)`` of an m-value, n-bit collaborative range
    proof, as Python ints (either package's ``Scalar`` takes them)."""
    rng = random.Random(5150)
    values = [rng.randrange(1 << n) for _ in range(m)]
    blindings = [rng.getrandbits(251) for _ in range(m)]
    return values, blindings


def mpc_range_party(prover, fabric, n: int, values, blindings, scalar=Scalar):
    """Party ``fabric.party_id``'s side of the collaborative range proof on
    ``prover`` (an ``MpcProver`` over ``fabric``); returns the commitments.

    Each party commits the values it owns (party 0 the first half, party 1
    the rest) with one ``batch_commit``; per value its owner shares the n
    bit pairs ``(1 - b, b)`` in one ``batch_share_scalars`` call, and both
    parties allocate each pair as a multiplier and constrain ``a b = 0``,
    ``a + b = 1`` and ``v = sum b_i 2^i`` (the plain verifier's
    ``range_check_gadget``).  Only the owner reads ``values[j]`` and
    ``blindings[j]``.  ``scalar``: the ``Scalar`` class of the prover's
    package."""
    m = len(values)
    owned = [(0, range(m // 2)), (1, range(m // 2, m))]
    commitments, variables = [], []
    for owner, idx in owned:
        if fabric.party_id == owner:
            comms, vars_ = prover.batch_commit(owner, [scalar(values[j]) for j in idx],
                                               [scalar(blindings[j]) for j in idx])
        else:
            comms, vars_ = prover.batch_commit(owner, None, None, count=len(idx))
        commitments += comms
        variables += vars_
    for j, var in enumerate(variables):
        owner = 0 if j < m // 2 else 1
        bits = None
        if fabric.party_id == owner:
            bits = [scalar(x) for i in range(n) for x in (1 - (values[j] >> i & 1), values[j] >> i & 1)]
        pairs = fabric.batch_share_scalars(bits, owner, count=2 * n)
        lc = var.to_lc()
        exp_2 = scalar(1)
        for i in range(n):
            a, b, o = prover.allocate_multiplier((pairs[2 * i], pairs[2 * i + 1]))
            prover.constrain(o.to_lc())
            prover.constrain(a + (b - 1))
            lc = lc - b * exp_2
            exp_2 = exp_2 + exp_2
        prover.constrain(lc)
    return commitments
