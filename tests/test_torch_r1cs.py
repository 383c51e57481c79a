"""The port's R1CS prover and verifier against the JAX package's.

Proof bytes, commitments and the final transcript state must be equal for
the same witness, blindings and entropy: the JAX prover finalizes its
blinding RNG with ``secrets.token_bytes(32)``, which the tests replace for
the duration of the call by the 32 bytes the port gets from ``rng_bytes``,
and the JAX package runs on its host path (``BP_FORCE_BACKEND=host``).
The shuffle at k = 2 and 4 takes the port's host IPP route, at k = 16
(n = 32) its device route, here on the plain versions of the kernels;
each proof is made once per module (fixtures).  Verifiers must pass where
the JAX verifier passes and raise where it raises.  Also
the host pieces the R1CS slice added: the transcript RNG, ``clone``, the
polynomials, ``PedersenGens.commit`` and ``BulletproofGens.share``.
"""

import dataclasses
import random
import secrets

import pytest
import torch

from mpc_bulletproof_tpu import BulletproofGens as JGens
from mpc_bulletproof_tpu import HashChainTranscript as JTranscript
from mpc_bulletproof_tpu import PedersenGens as JPedersen
from mpc_bulletproof_tpu import Scalar as JScalar
from mpc_bulletproof_tpu import StarkPoint as JPoint
from mpc_bulletproof_tpu.models.inner_product import _create_host as j_create_host
from mpc_bulletproof_tpu.models.r1cs import Prover as JProver
from mpc_bulletproof_tpu.models.r1cs import R1CSProof as JR1CSProof
from mpc_bulletproof_tpu.models.r1cs import Verifier as JVerifier
from mpc_bulletproof_tpu.models.r1cs import gadgets as jgadgets
from mpc_bulletproof_tpu.ops import poly as jpoly
from mpc_bulletproof_tpu.utils.errors import VerificationError as JVerificationError
from mpc_bulletproof_tpu_torch import (BulletproofGens, HashChainTranscript, InnerProductProof,
                                       PedersenGens, Prover, R1CSProof, Scalar, StarkPoint,
                                       VerificationError, Verifier, pinned)
from mpc_bulletproof_tpu_torch.models.r1cs import gadgets
from mpc_bulletproof_tpu_torch.ops import poly
from mpc_bulletproof_tpu_torch.utils.errors import FormatError

torch.set_num_threads(1)


def _entropy() -> bytes:
    return pinned.det_stream()(32)


def _pt(p) -> StarkPoint:
    return StarkPoint.from_bytes(p.to_bytes())


def _jpt(p) -> JPoint:
    return JPoint.from_bytes(p.to_bytes())


def _outcome(fn, *errors) -> bool:
    """True if ``fn()`` returns, False if it raises one of ``errors``."""
    try:
        fn()
    except errors:
        return False
    return True


def _jax_host(fn):
    """Run ``fn()`` on the JAX package's host path with ``secrets.token_bytes``
    giving the pinned entropy."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BP_FORCE_BACKEND", "host")
        mp.setattr(secrets, "token_bytes", lambda n: _entropy()[:n])
        return fn()


def _shuffle_parts(k: int, outputs=None):
    inputs, perm_outputs, blindings = pinned.shuffle_inputs(k)
    return inputs, perm_outputs if outputs is None else outputs, blindings


def jax_shuffle(k: int, outputs=None):
    """The JAX package's k-shuffle proof on the pinned inputs:
    ``(proof, commitments, final transcript state, gens)``."""
    inputs, outs, blindings = _shuffle_parts(k, outputs)

    def run():
        gens = JGens(2 * k, 1)
        t = JTranscript(pinned.SHUFFLE_LABEL)
        t.append_message(b"dom-sep", b"ShuffleProof")
        t.append_u64(b"k", k)
        p = JProver(JPedersen(), t)
        pairs = [p.commit(JScalar(int(v)), JScalar(int(b))) for v, b in zip(inputs + outs, blindings)]
        jgadgets.shuffle_gadget(p, [v for _, v in pairs[:k]], [v for _, v in pairs[k:]])
        return p.prove(gens), [c for c, _ in pairs], t.state, gens, p

    return _jax_host(run)


def port_shuffle(k: int, gens: BulletproofGens, outputs=None):
    """The port's k-shuffle proof on the CPU: ``(proof, commitments, state, prover)``."""
    inputs, outs, blindings = _shuffle_parts(k, outputs)
    t = pinned.shuffle_transcript(k)
    p = Prover(PedersenGens(), t)
    pairs = [p.commit(v, b) for v, b in zip(inputs + outs, blindings)]
    gadgets.shuffle_gadget(p, [v for _, v in pairs[:k]], [v for _, v in pairs[k:]])
    proof = p.prove(gens, device="cpu", rng_bytes=pinned.det_stream())
    return proof, [c for c, _ in pairs], t.state, p


def port_verify(proof, V, gens, k: int) -> None:
    v = Verifier(PedersenGens(), pinned.shuffle_transcript(k))
    xs, ys = [v.commit(c) for c in V[:k]], [v.commit(c) for c in V[k:]]
    gadgets.shuffle_gadget(v, xs, ys)
    v.verify(proof, gens, device="cpu")


def jax_verify(proof, V, gens, k: int) -> None:
    t = JTranscript(pinned.SHUFFLE_LABEL)
    t.append_message(b"dom-sep", b"ShuffleProof")
    t.append_u64(b"k", k)
    v = JVerifier(JPedersen(), t)
    xs, ys = [v.commit(c) for c in V[:k]], [v.commit(c) for c in V[k:]]
    jgadgets.shuffle_gadget(v, xs, ys)
    _jax_host(lambda: v.verify(proof, gens))


def _tampered(proof, case: str):
    """A copy with t_x + 1, or with the IPP's first L and R swapped."""
    if case == "t_x+1":
        return dataclasses.replace(proof, t_x=proof.t_x + 1)
    if case == "swap_L1_R1":
        ipp = proof.ipp_proof
        return dataclasses.replace(proof, ipp_proof=type(ipp)(
            [ipp.R_vec[0]] + ipp.L_vec[1:], [ipp.L_vec[0]] + ipp.R_vec[1:], ipp.a, ipp.b))
    return proof


@pytest.fixture(scope="module")
def gens16():
    return BulletproofGens(32, 1, device="cpu")


@pytest.fixture(scope="module")
def shuffle16(gens16):
    """The port's k = 16 shuffle proof on the CPU (n = 32: the device route)."""
    proof, V, state, _ = port_shuffle(16, gens16)
    return {"gens": gens16, "proof": proof, "V": V, "state": state}


@pytest.fixture(scope="module")
def shuffle4():
    """The port's k = 4 shuffle proof (n = 8: the host IPP route) and its prover."""
    gens = BulletproofGens(8, 1, device="cpu")
    proof, V, state, prover = port_shuffle(4, gens)
    return {"gens": gens, "proof": proof, "V": V, "state": state, "prover": prover}


@pytest.fixture(scope="module")
def shuffle2():
    """A k = 2 shuffle proof (host routes only), for the tests that need any proof."""
    gens = BulletproofGens(4, 1, device="cpu")
    proof, V, state, _ = port_shuffle(2, gens)
    return {"gens": gens, "proof": proof, "V": V, "state": state}


@pytest.fixture(scope="module")
def jax_shuffles():
    """The JAX package's host-path shuffle proofs, each made once:
    ``k -> (proof, commitments, final state, gens, prover)``."""
    made = {}

    def get(k: int):
        if k not in made:
            made[k] = jax_shuffle(k)
        return made[k]

    return get


@pytest.mark.parametrize("k", [2, 4, 16])
def test_shuffle_proof_matches_jax_host(k, request, jax_shuffles):
    port = request.getfixturevalue(f"shuffle{k}")
    proof, V, state = port["proof"], port["V"], port["state"]
    j_proof, j_V, j_state, _, _ = jax_shuffles(k)
    assert [v.to_bytes() for v in V] == [v.to_bytes() for v in j_V]
    assert proof.to_bytes() == j_proof.to_bytes()
    assert state == j_state
    assert proof.to_bytes()[0] == 1 and not proof.missing_phase2_commitments()
    if k in pinned.SHUFFLE_DIGESTS:
        assert pinned.proof_digest(proof, V, state) == pinned.SHUFFLE_DIGESTS[k]


@pytest.mark.parametrize("k,case", [(2, "valid"), (2, "t_x+1"), (2, "swap_L1_R1"),
                                    (16, "valid"), (16, "swap_L1_R1")])
def test_shuffle_verify_matches_jax(k, case, request, jax_shuffles):
    """Both verifiers on the same bytes, tampered or not: the JAX host
    path's proof, which ``test_shuffle_proof_matches_jax_host`` holds
    byte-equal to the port's.  k = 16: the mega-check has 6 + 32 + 5 + 2 +
    10 + 64 = 119 points and runs the device MSM (plain versions); k = 2:
    23 points, the host Pippenger."""
    gens = request.getfixturevalue("gens16" if k == 16 else "shuffle2")
    gens = gens if k == 16 else gens["gens"]
    j_proof, j_V, _, j_gens, _ = jax_shuffles(k)
    data = _tampered(R1CSProof.from_bytes(j_proof.to_bytes()), case).to_bytes()
    V = [_pt(v) for v in j_V]
    port_ok = _outcome(lambda: port_verify(R1CSProof.from_bytes(data), V, gens, k), VerificationError)
    jax_ok = _outcome(lambda: jax_verify(JR1CSProof.from_bytes(data), list(j_V), j_gens, k),
                      JVerificationError)
    assert port_ok == jax_ok == (case == "valid")


def test_shuffle_rejects_non_permutation():
    k = 2
    inputs, _, _ = pinned.shuffle_inputs(k)
    outputs = [inputs[0] + 1] + inputs[1:]
    gens = BulletproofGens(2 * k, 1, device="cpu")
    proof, V, _, _ = port_shuffle(k, gens, outputs)
    j_proof, j_V, _, j_gens, _ = jax_shuffle(k, outputs)
    assert proof.to_bytes() == j_proof.to_bytes()
    assert not _outcome(lambda: port_verify(proof, V, gens, k), VerificationError)
    assert not _outcome(lambda: jax_verify(j_proof, j_V, j_gens, k), JVerificationError)


def _range_circuit(cs, var, value, nbits, mod):
    mod.range_check_gadget(cs, var.to_lc(), value, nbits)


def test_one_phase_range_gadget_matches_jax():
    """A one-phase circuit (no randomized constraints): version byte 0,
    A_I2 = A_O2 = S2 = identity; 8 multipliers, the host IPP route."""
    value, blinding, nbits = 200, Scalar(987654321), 8
    gens = BulletproofGens(nbits, 1, device="cpu")
    t = HashChainTranscript(b"r1cs-range")
    p = Prover(PedersenGens(), t)
    V, var = p.commit(Scalar(value), blinding)
    _range_circuit(p, var, value, nbits, gadgets)
    assert p.constraints_satisfied()
    weights = p.get_weights()
    proof = p.prove(gens, device="cpu", rng_bytes=pinned.det_stream())

    def run():
        jt = JTranscript(b"r1cs-range")
        jp = JProver(JPedersen(), jt)
        jV, jvar = jp.commit(JScalar(value), JScalar(int(blinding)))
        _range_circuit(jp, jvar, value, nbits, jgadgets)
        jw = jp.get_weights()
        return jp.prove(JGens(nbits, 1)), jV, jt.state, jw

    j_proof, j_V, j_state, j_weights = _jax_host(run)
    assert (proof.to_bytes(), V.to_bytes(), t.state) == (j_proof.to_bytes(), j_V.to_bytes(), j_state)
    assert proof.to_bytes()[0] == 0 and proof.missing_phase2_commitments()
    assert weights.to_json() == j_weights.to_json()
    v = Verifier(PedersenGens(), HashChainTranscript(b"r1cs-range"))
    _range_circuit(v, v.commit(V), None, nbits, gadgets)
    v.verify(proof, gens, device="cpu")


def test_weights_match_jax(shuffle4, jax_shuffles):
    """The sparse weights IR of a shuffle after proving (both phases'
    constraints) equals the JAX package's, row for row."""
    port_prover = shuffle4["prover"]
    *_, j_prover = jax_shuffles(4)
    w, jw = port_prover.get_weights(), j_prover.get_weights()
    assert w.to_json() == jw.to_json()
    assert len(w.w_l.rows) == port_prover.num_constraints() == j_prover.num_constraints()
    assert type(w).from_json(w.to_json()) == w


def test_r1cs_proof_codec_round_trip(shuffle2):
    data = shuffle2["proof"].to_bytes()
    restored = R1CSProof.from_bytes(data)
    assert restored == shuffle2["proof"] and restored.to_bytes() == data
    assert len(data) == restored.serialized_size() == 1 + 14 * 32 + (2 * 1 + 2) * 32
    assert JR1CSProof.from_bytes(data).to_bytes() == data
    for bad in (b"", bytes([2]) + data[1:], data[:-1], data[: 1 + 10 * 32]):
        with pytest.raises(FormatError):
            R1CSProof.from_bytes(bad)


@pytest.mark.parametrize("n", [8, 32])
def test_ipp_create_matches_jax_host(n):
    """n = 8 takes the host route, n = 32 the device route (plain versions)."""
    rng = random.Random(31 + n)
    gen = JPoint.generator()
    pts = [gen.scalar_mul(JScalar(rng.getrandbits(250))) for _ in range(2 * n + 1)]
    G, H, Q = pts[:n], pts[n : 2 * n], pts[-1]
    a = [JScalar(rng.getrandbits(251)) for _ in range(n)]
    b = [JScalar(rng.getrandbits(251)) for _ in range(n)]
    Gf = [JScalar(1)] * (n // 2) + [JScalar(rng.getrandbits(251)) for _ in range(n // 2)]
    Hf = [JScalar(rng.getrandbits(251)) for _ in range(n)]
    jt = JTranscript(b"ipp-create")
    jt.innerproduct_domain_sep(n)
    j_proof = j_create_host(jt, Q, Gf, Hf, G, H, a, b)
    t = HashChainTranscript(b"ipp-create")
    sc = lambda xs: [Scalar(int(x)) for x in xs]
    proof = InnerProductProof.create(t, _pt(Q), sc(Gf), sc(Hf), [_pt(g) for g in G],
                                     [_pt(h) for h in H], sc(a), sc(b), device="cpu")
    assert proof.to_bytes() == j_proof.to_bytes()
    assert t.state == jt.state


def test_ipp_create_rejects_point_tensors_below_device_width():
    """Below width 32 the IPP runs on the host over host lists; point
    tensors (already on a device) raise instead of moving back, and the
    transcript is left as it was."""
    from mpc_bulletproof_tpu_torch.ops import curve_t

    n = 4
    pts = [StarkPoint.generator().scalar_mul(Scalar(i + 2)) for i in range(2 * n)]
    G = torch.as_tensor(curve_t.points_from_host(pts[:n]))
    ones = [Scalar(1)] * n
    t = HashChainTranscript(b"ipp-tensor")
    before = t.state
    for g, h in ((G, pts[n:]), (pts[:n], G)):
        with pytest.raises(ValueError, match="host point lists"):
            InnerProductProof.create(t, StarkPoint.generator(), ones, ones, g, h, ones, ones, device="cpu")
    assert t.state == before


@pytest.mark.parametrize("k", sorted(pinned.SHUFFLE_DIGESTS))
def test_pinned_shuffle_digest_is_the_jax_host_digest(k, jax_shuffles):
    """chip_smoke.py holds the card's k = 2^10 proof to this digest."""
    j_proof, j_V, j_state, _, _ = jax_shuffles(k)
    assert pinned.proof_digest(j_proof, j_V, j_state) == pinned.SHUFFLE_DIGESTS[k]


def test_r1cs_needs_a_card_unless_asked_for_the_cpu(monkeypatch, shuffle2):
    gens, proof, V = shuffle2["gens"], shuffle2["proof"], shuffle2["V"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = Prover(PedersenGens(), HashChainTranscript(b"no-card"))
    _, var = p.commit(Scalar(5), Scalar(7))
    p.constrain(var - 5)
    with pytest.raises(RuntimeError):
        p.prove(gens)
    v = Verifier(PedersenGens(), pinned.shuffle_transcript(2))
    xs, ys = [v.commit(c) for c in V[:2]], [v.commit(c) for c in V[2:]]
    gadgets.shuffle_gadget(v, xs, ys)
    with pytest.raises(RuntimeError):
        v.verify(proof, gens)
    with pytest.raises(RuntimeError):
        InnerProductProof.create(HashChainTranscript(b"no-card"), StarkPoint.generator(), [Scalar(1)],
                                 [Scalar(1)], [StarkPoint.generator()], [StarkPoint.generator()],
                                 [Scalar(2)], [Scalar(3)])


# ---------------------------------------------------------------------------
# host pieces: transcript RNG, clone, polynomials, commitments, gens shares
# ---------------------------------------------------------------------------

def test_transcript_rng_clone_and_domain_seps_match_jax():
    t, jt = pinned.shuffle_transcript(3), JTranscript(pinned.SHUFFLE_LABEL)
    jt.append_message(b"dom-sep", b"ShuffleProof")
    jt.append_u64(b"k", 3)
    for tr in (t, jt):
        tr.r1cs_domain_sep()
        tr.r1cs_1phase_domain_sep()
        tr.r1cs_2phase_domain_sep()
    assert t.state == jt.state
    c = t.clone()
    c.append_u64(b"x", 1)
    assert c.state != t.state and t.state == jt.state
    entropy = _entropy()
    rng = t.build_rng().rekey_with_witness_bytes(b"v", b"w" * 32).finalize(entropy)
    jrng = jt.build_rng().rekey_with_witness_bytes(b"v", b"w" * 32).finalize(entropy)
    assert rng.randbytes(5) == jrng.randbytes(5)            # a partial block, then whole ones
    assert [int(s) for s in rng.random_scalars(7)] == [int(s) for s in jrng.random_scalars(7)]
    assert int(rng.random_scalar()) == int(jrng.random_scalar())
    assert rng.randbytes(0) == b"" and rng.random_scalars(0) == []


def test_polynomials_match_jax():
    rng = random.Random(3)
    vec = lambda n: [rng.getrandbits(251) for _ in range(n)]
    cols = [vec(5) for _ in range(8)]
    x = rng.getrandbits(251)
    P, J = (lambda c: [Scalar(v) for v in c]), (lambda c: [JScalar(v) for v in c])
    l1, r1 = poly.VecPoly1(P(cols[0]), P(cols[1])), poly.VecPoly1(P(cols[2]), P(cols[3]))
    jl1, jr1 = jpoly.VecPoly1(J(cols[0]), J(cols[1])), jpoly.VecPoly1(J(cols[2]), J(cols[3]))
    t2, jt2 = l1.inner_product(r1), jl1.inner_product(jr1)
    assert [int(t2.t0), int(t2.t1), int(t2.t2), int(t2.eval(Scalar(x)))] == \
        [int(jt2.t0), int(jt2.t1), int(jt2.t2), int(jt2.eval(JScalar(x)))]
    assert [int(v) for v in l1.eval(Scalar(x))] == [int(v) for v in jl1.eval(JScalar(x))]
    zero = [0] * 5
    l3 = poly.VecPoly3(P(zero), *(P(c) for c in cols[:3]))
    r3 = poly.VecPoly3(*(P(c) for c in cols[3:5]), P(zero), P(cols[5]))
    jl3 = jpoly.VecPoly3(J(zero), *(J(c) for c in cols[:3]))
    jr3 = jpoly.VecPoly3(*(J(c) for c in cols[3:5]), J(zero), J(cols[5]))
    t6, jt6 = poly.VecPoly3.special_inner_product(l3, r3), jpoly.VecPoly3.special_inner_product(jl3, jr3)
    assert int(t6.eval(Scalar(x))) == int(jt6.eval(JScalar(x)))
    assert [int(v) for v in l3.eval(Scalar(x))] == [int(v) for v in jl3.eval(JScalar(x))]
    assert poly.VecPoly3.zero(2).eval(Scalar(x)) == [Scalar(0)] * 2


def test_commit_and_gens_share_match_jax():
    pc, jpc = PedersenGens(), JPedersen()
    vals, blinds = [Scalar(5), Scalar(2**250 + 3)], [Scalar(7), Scalar(11)]
    got = pc.commit_batch(vals, blinds) + [pc.commit(vals[0], blinds[0])]
    want = jpc.commit_batch([JScalar(int(v)) for v in vals], [JScalar(int(b)) for b in blinds])
    assert [p.to_bytes() for p in got] == [p.to_bytes() for p in want + want[:1]]
    gens, j_gens = BulletproofGens(4, 2, device="cpu"), JGens(4, 2)
    assert gens.share(0).G(4) == gens.G(4, 1)
    for j in range(2):
        for mine, theirs in ((gens.share(j).G(3), j_gens.share(j).G(3)),
                             (gens.share(j).H(4), j_gens.share(j).H(4))):
            assert [p.to_bytes() for p in mine] == [p.to_bytes() for p in theirs]


@pytest.mark.cuda
def test_card_shuffle_matches_pinned_digest():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py proves k = 2^10 there)")
    k = 16
    inputs, outputs, blindings = pinned.shuffle_inputs(k)
    gens = BulletproofGens(2 * k, 1)
    t = pinned.shuffle_transcript(k)
    p = Prover(PedersenGens(), t)
    pairs = [p.commit(v, b) for v, b in zip(inputs + outputs, blindings)]
    gadgets.shuffle_gadget(p, [v for _, v in pairs[:k]], [v for _, v in pairs[k:]])
    proof = p.prove(gens, rng_bytes=pinned.det_stream())
    V = [c for c, _ in pairs]
    assert pinned.proof_digest(proof, V, t.state) == pinned.SHUFFLE_DIGESTS[k]
    v = Verifier(PedersenGens(), pinned.shuffle_transcript(k))
    xs, ys = [v.commit(c) for c in V[:k]], [v.commit(c) for c in V[k:]]
    gadgets.shuffle_gadget(v, xs, ys)
    v.verify(proof, gens)
