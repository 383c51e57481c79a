"""The pins of the reference's benchmark sweeps, against the JAX package.

``chip_smoke.py``'s ``rp_sweep`` and ``r1cs_sweep`` phases hold the card's
proofs to ``pinned.DIGESTS`` (config 1, the 32-bit README value, and
config 2 at m = 1 to 32), ``pinned.SHUFFLE_DIGESTS`` (k = 2 to 2^9) and
``pinned.SQUARING_DIGESTS`` (the squaring chain, n = 2 to 2^10).  Here
each R1CS digest is recomputed from the JAX package's host path
(``BP_FORCE_BACKEND=host``, ``secrets.token_bytes`` giving the pinned
entropy; the range proofs' in ``tests/test_torch_range_proof.py``, which
runs every ``DIGESTS`` entry), and the port on
``device="cpu"`` gives the same bytes where it stays on its host routes
(the shuffle at k = 2 and 4, the squaring chain up to n = 16).  Config 1
and m = 1 take the port's device route, ~70 s together on the plain
kernels with one thread: the card alone holds them
(``tests/test_torch_generators_card.py``, ``chip_smoke.py``)."""

import secrets

import pytest
import torch

from mpc_bulletproof_tpu import BulletproofGens as JGens
from mpc_bulletproof_tpu import HashChainTranscript as JTranscript
from mpc_bulletproof_tpu import PedersenGens as JPedersen
from mpc_bulletproof_tpu import Scalar as JScalar
from mpc_bulletproof_tpu.models.r1cs import Prover as JProver
from mpc_bulletproof_tpu.models.r1cs import gadgets as jgadgets
from mpc_bulletproof_tpu_torch import (BulletproofGens, PedersenGens, Prover, Scalar, Verifier,
                                       pinned)
from mpc_bulletproof_tpu_torch.models.r1cs import gadgets

torch.set_num_threads(1)


def _jax_host(fn):
    """``fn()`` on the JAX package's host path, its R1CS entropy pinned."""
    entropy = pinned.det_stream()(32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BP_FORCE_BACKEND", "host")
        mp.setattr(secrets, "token_bytes", lambda n: entropy[:n])
        return fn()


def jax_shuffle_digest(k: int) -> str:
    inputs, outputs, blindings = pinned.shuffle_inputs(k)

    def run():
        t = JTranscript(pinned.SHUFFLE_LABEL)
        t.append_message(b"dom-sep", b"ShuffleProof")
        t.append_u64(b"k", k)
        p = JProver(JPedersen(), t)
        pairs = [p.commit(JScalar(int(v)), JScalar(int(b))) for v, b in zip(inputs + outputs, blindings)]
        jgadgets.shuffle_gadget(p, [v for _, v in pairs[:k]], [v for _, v in pairs[k:]])
        return pinned.proof_digest(p.prove(JGens(2 * k, 1)), [c for c, _ in pairs], t.state)

    return _jax_host(run)


def jax_squaring_digest(n: int) -> str:
    def run():
        t = pinned.squaring_transcript(n, JTranscript)
        p = JProver(JPedersen(), t)
        pinned.squaring_chain(p, n, JScalar(pinned.squaring_value()))
        return pinned.proof_digest(p.prove(JGens(n, 1)), [], t.state)

    return _jax_host(run)


def test_config1_inputs_are_the_readme_value():
    """``DIGESTS[(32, 1)]`` is config 1's: ``inputs(32, 1)`` is the README's
    32-bit value with a seeded blinding (the JAX host path recomputes every
    ``DIGESTS`` entry on ``inputs``: ``tests/test_torch_range_proof.py``)."""
    (value,), (blinding,) = pinned.inputs(32, 1)
    assert value == pinned.SINGLE_VALUE == 1037578891 < 1 << 32
    assert pinned.single_inputs() == ([value], [blinding])
    assert {(32, 1), (64, 1), (64, 2), (64, 4), (64, 8), (64, 16), (64, 32)} <= set(pinned.DIGESTS)


@pytest.mark.parametrize("k", [2, 4, 8, 32, 64, 128, 256, 512])
def test_pinned_shuffle_digest_is_the_jax_host_digest(k):
    assert jax_shuffle_digest(k) == pinned.SHUFFLE_DIGESTS[k]


@pytest.mark.parametrize("n", sorted(pinned.SQUARING_DIGESTS))
def test_pinned_squaring_digest_is_the_jax_host_digest(n):
    assert jax_squaring_digest(n) == pinned.SQUARING_DIGESTS[n]


@pytest.fixture(scope="module")
def gens16():
    return BulletproofGens(16, 1, device="cpu")


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_port_squaring_chain_gives_the_pinned_digest(n, gens16):
    value = Scalar(pinned.squaring_value())
    t = pinned.squaring_transcript(n)
    p = Prover(PedersenGens(), t)
    pinned.squaring_chain(p, n, value)
    proof = p.prove(gens16, device="cpu", rng_bytes=pinned.det_stream())
    assert pinned.proof_digest(proof, [], t.state) == pinned.SQUARING_DIGESTS[n]
    if n <= 4:
        v = Verifier(PedersenGens(), pinned.squaring_transcript(n))
        pinned.squaring_chain(v, n, value)
        v.verify(proof, gens16, device="cpu")


@pytest.mark.parametrize("k", [2, 4])
def test_port_shuffle_gives_the_pinned_digest(k, gens16):
    inputs, outputs, blindings = pinned.shuffle_inputs(k)
    t = pinned.shuffle_transcript(k)
    p = Prover(PedersenGens(), t)
    pairs = [p.commit(v, b) for v, b in zip(inputs + outputs, blindings)]
    gadgets.shuffle_gadget(p, [v for _, v in pairs[:k]], [v for _, v in pairs[k:]])
    proof = p.prove(gens16, device="cpu", rng_bytes=pinned.det_stream())
    assert pinned.proof_digest(proof, [c for c, _ in pairs], t.state) == pinned.SHUFFLE_DIGESTS[k]
