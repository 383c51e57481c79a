"""The port's verifiers against the JAX package's: range-proof verification
(single, aggregated, batched), its scalar derivation, and the IPP check.

The (8, 2) proof is the JAX host path's on the pinned inputs, which is the
port's CPU proof byte for byte (the fixture holds it to the pinned digest
that ``tests/test_torch_range_proof.py`` holds the port's own proof to).
Outcomes must agree: the port passes where the JAX package passes and
raises where it raises.  The port's MSMs run on the CPU through the plain
versions of its kernels.
"""

import os
import random

import pytest
import torch

from mpc_bulletproof_tpu import BulletproofGens as JGens
from mpc_bulletproof_tpu import HashChainTranscript as JTranscript
from mpc_bulletproof_tpu import PedersenGens as JPedersen
from mpc_bulletproof_tpu import Scalar as JScalar
from mpc_bulletproof_tpu import StarkPoint as JPoint
from mpc_bulletproof_tpu.models.inner_product import InnerProductProof as JIPP
from mpc_bulletproof_tpu.models.range_proof import RangeProof as JRangeProof
from mpc_bulletproof_tpu.ops.field import inner_product as j_inner_product
from mpc_bulletproof_tpu.ops.field import scalar_powers as j_scalar_powers
from mpc_bulletproof_tpu.utils.errors import ProofError as JProofError
from mpc_bulletproof_tpu.utils.errors import VerificationError as JVerificationError
from mpc_bulletproof_tpu.utils.native import scalars_to_ints
from mpc_bulletproof_tpu_torch import (BulletproofGens, HashChainTranscript, PedersenGens,
                                       RangeProof, Scalar, StarkPoint, VerificationError, pinned)
from mpc_bulletproof_tpu_torch.models.inner_product import InnerProductProof
from mpc_bulletproof_tpu_torch.ops import kernels
from mpc_bulletproof_tpu_torch.utils.errors import ProofError
from test_torch_range_proof import jax_host_prove

# Under pytest-xdist several worker processes share the cores: split them,
# or torch's default of one intra-op thread per core in every worker
# oversubscribes the machine.
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

N, M = 8, 2


def _pt(p) -> StarkPoint:
    return StarkPoint.from_bytes(p.to_bytes())


def _jpt(p) -> JPoint:
    return JPoint.from_bytes(p.to_bytes())


@pytest.fixture(scope="module")
def rp82():
    """The pinned (8, 2) proof as both packages' objects, and both gens."""
    j_proof, j_V, state, j_gens = jax_host_prove(N, M)
    assert pinned.proof_digest(j_proof, j_V, state) == pinned.DIGESTS[(N, M)]
    proof = RangeProof.from_bytes(j_proof.to_bytes())
    return {"j_proof": j_proof, "j_V": j_V, "j_gens": j_gens, "proof": proof,
            "V": [_pt(v) for v in j_V], "gens": BulletproofGens(N, M, device="cpu")}


def _tampered(data: bytes, case: str) -> bytes:
    """Proof bytes with t_x + 1, or with L_1 and R_1 swapped."""
    if case == "t_x+1":
        t_x = (int.from_bytes(data[128:160], "big") + 1) % JScalar.MODULUS
        return data[:128] + t_x.to_bytes(32, "big") + data[160:]
    if case == "swap_L1_R1":
        return data[:224] + data[256:288] + data[224:256] + data[288:]
    return data


def _outcome(fn, *errors) -> bool:
    """True if ``fn()`` returns, False if it raises one of ``errors``."""
    try:
        fn()
    except errors:
        return False
    return True


def test_verification_terms_match_jax(rp82, monkeypatch):
    """The port replays the whole transcript in one ``keccak_transcript``
    call (the plain version here); its scalars are the JAX package's host
    route's, and the caller's transcript ends in the host route's state."""
    calls = []
    orig = kernels.keccak_transcript
    monkeypatch.setattr(kernels, "keccak_transcript", lambda *a: calls.append(a[0].shape) or orig(*a))
    tr, j_tr = HashChainTranscript(pinned.TRANSCRIPT_LABEL), JTranscript(pinned.TRANSCRIPT_LABEL)
    (g, h), scalars, points = rp82["proof"]._verification_terms(
        rp82["gens"], PedersenGens(), tr, rp82["V"], N, device="cpu")
    (jg, jh), j_scalars, j_points = rp82["j_proof"]._verification_terms(
        rp82["j_gens"], JPedersen(), j_tr, rp82["j_V"], N)
    assert g == scalars_to_ints(jg)
    assert h == scalars_to_ints(jh)
    assert scalars == [int(s) for s in j_scalars]
    assert [p.to_bytes() for p in points] == [p.to_bytes() for p in j_points]
    assert len(scalars) + len(g) + len(h) == 4 + M + 2 + 2 * 4 + 2 * N * M   # 48 points
    assert tr.state == j_tr.state
    assert calls == [(1, 4)]


@pytest.mark.parametrize("case", ["A", "T_2", "L_1"])
def test_identity_point_in_the_replay_raises_proof_error(rp82, case):
    """``validate_and_append_point``'s refusal holds on the replay: an
    identity A, T_2 or IPP L raises ``ProofError`` in both packages."""
    proof = RangeProof.from_bytes(rp82["proof"].to_bytes())
    j_proof = JRangeProof.from_bytes(rp82["proof"].to_bytes())
    for p, ident in ((proof, StarkPoint.identity()), (j_proof, JPoint.identity())):
        if case == "L_1":
            p.ipp_proof.L_vec[0] = ident
        else:
            setattr(p, case, ident)
    with pytest.raises(ProofError, match="identity"):
        proof._verification_terms(rp82["gens"], PedersenGens(), HashChainTranscript(pinned.TRANSCRIPT_LABEL),
                                  rp82["V"], N, device="cpu")
    with pytest.raises(JProofError, match="identity"):
        j_proof._verification_terms(rp82["j_gens"], JPedersen(), JTranscript(pinned.TRANSCRIPT_LABEL),
                                    rp82["j_V"], N)


@pytest.mark.parametrize("case", ["valid", "t_x+1", "swap_L1_R1"])
def test_verify_multiple_matches_jax(rp82, case):
    data = _tampered(rp82["proof"].to_bytes(), case)
    port = _outcome(lambda: RangeProof.from_bytes(data).verify_multiple(
        rp82["gens"], PedersenGens(), HashChainTranscript(pinned.TRANSCRIPT_LABEL), rp82["V"], N,
        device="cpu"), VerificationError)
    jax_ok = _outcome(lambda: JRangeProof.from_bytes(data).verify_multiple(
        rp82["j_gens"], JPedersen(), JTranscript(pinned.TRANSCRIPT_LABEL), rp82["j_V"], N),
        JVerificationError)
    assert port == jax_ok == (case == "valid")


def test_prove_and_verify_single_match_jax(rp82, monkeypatch):
    """m = 1: the mega-check has 29 points and takes the host route over the
    host generators: neither the generator tensor nor the device MSM."""
    from mpc_bulletproof_tpu_torch import generators
    from mpc_bulletproof_tpu_torch.ops import msm

    j_proof, j_V, j_state, j_gens = jax_host_prove(N, 1)
    (v,), (gamma,) = (x[:1] for x in pinned.inputs(N, 1))
    tr = HashChainTranscript(pinned.TRANSCRIPT_LABEL)
    proof, V = RangeProof.prove_single(rp82["gens"], PedersenGens(), tr, v, gamma, N, device="cpu",
                                       rng_bytes=pinned.det_stream())
    assert (proof.to_bytes(), V.to_bytes(), tr.state) == (j_proof.to_bytes(), j_V[0].to_bytes(), j_state)
    device_calls = []
    for mod, name in ((generators, "device_gens"), (msm, "msm_host_points")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, **k: device_calls.append(name) or _o(*a, **k))
    for case in ("valid", "t_x+1"):
        data = _tampered(proof.to_bytes(), case)
        port = _outcome(lambda: RangeProof.from_bytes(data).verify_single(
            rp82["gens"], PedersenGens(), HashChainTranscript(pinned.TRANSCRIPT_LABEL), V, N,
            device="cpu"), VerificationError)
        jax_ok = _outcome(lambda: JRangeProof.from_bytes(data).verify_single(
            j_gens, JPedersen(), JTranscript(pinned.TRANSCRIPT_LABEL), j_V[0], N),
            JVerificationError)
        assert port == jax_ok == (case == "valid")
    assert not device_calls


def test_verify_batch_matches_jax(rp82, monkeypatch):
    rng = random.Random(5)
    values = [rng.randrange(1 << N) for _ in range(M)]
    blindings = [JScalar(rng.getrandbits(251)) for _ in range(M)]
    label = b"batch-2"
    j_second, j_V2 = JRangeProof.prove_multiple(rp82["j_gens"], JPedersen(), JTranscript(label),
                                                values, blindings, N)
    datas = [rp82["proof"].to_bytes(), j_second.to_bytes()]
    j_comms = [rp82["j_V"], j_V2]
    calls = []
    orig = kernels.keccak_transcript
    monkeypatch.setattr(kernels, "keccak_transcript", lambda *a: calls.append(a[0].shape) or orig(*a))
    for case in ("valid", "t_x+1"):
        batch = [datas[0], _tampered(datas[1], case)]
        port = _outcome(lambda: RangeProof.verify_batch(
            [RangeProof.from_bytes(d) for d in batch], rp82["gens"], PedersenGens(),
            [HashChainTranscript(pinned.TRANSCRIPT_LABEL), HashChainTranscript(label)],
            [[_pt(v) for v in c] for c in j_comms], N, device="cpu"),
            VerificationError)
        jax_ok = _outcome(lambda: JRangeProof.verify_batch(
            [JRangeProof.from_bytes(d) for d in batch], rp82["j_gens"], JPedersen(),
            [JTranscript(pinned.TRANSCRIPT_LABEL), JTranscript(label)], j_comms, N),
            JVerificationError)
        assert port == jax_ok == (case == "valid")
    assert calls == [(2, 4)] * 2                # both transcripts of a batch in one call


def test_ipp_verify_matches_jax():
    """n = 16: the check has 41 points and takes the device route."""
    n = 16
    rng = random.Random(11)
    j_gens = JGens(n, 1)
    G, H = j_gens.share(0).G(n), j_gens.share(0).H(n)
    Q = JPoint.generator().scalar_mul(JScalar(rng.getrandbits(250)))
    a = [JScalar(rng.getrandbits(251)) for _ in range(n)]
    b = [JScalar(rng.getrandbits(251)) for _ in range(n)]
    Gf = [JScalar(1)] * n
    Hf = j_scalar_powers(JScalar(rng.getrandbits(251)), n)
    P = JPoint.msm(a + [bi * hi for bi, hi in zip(b, Hf)] + [j_inner_product(a, b)], G + H + [Q])
    j_proof = JIPP.create(JTranscript(b"ipp-test"), Q, Gf, Hf, list(G), list(H), list(a), list(b))
    Gf_t, Hf_t = [Scalar(int(x)) for x in Gf], [Scalar(int(x)) for x in Hf]
    for case in ("valid", "a+1", "wrong P"):
        data = j_proof.to_bytes()
        if case == "a+1":
            a_fin = (int.from_bytes(data[-64:-32], "big") + 1) % JScalar.MODULUS
            data = data[:-64] + a_fin.to_bytes(32, "big") + data[-32:]
        P_case = P + JPoint.generator() if case == "wrong P" else P
        port = _outcome(lambda: InnerProductProof.from_bytes(data).verify(
            n, HashChainTranscript(b"ipp-test"), Gf_t, Hf_t, _pt(P_case), _pt(Q),
            [_pt(g) for g in G], [_pt(h) for h in H], device="cpu"), VerificationError)
        jax_ok = _outcome(lambda: JIPP.from_bytes(data).verify(
            n, JTranscript(b"ipp-test"), Gf, Hf, P_case, Q, G, H), JVerificationError)
        assert port == jax_ok == (case == "valid")


def test_verify_needs_a_card_unless_asked_for_the_cpu(rp82, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        rp82["proof"].verify_multiple(rp82["gens"], PedersenGens(),
                                      HashChainTranscript(pinned.TRANSCRIPT_LABEL), rp82["V"], N)
    with pytest.raises(RuntimeError):
        RangeProof.verify_batch([rp82["proof"]], rp82["gens"], PedersenGens(),
                                [HashChainTranscript(pinned.TRANSCRIPT_LABEL)], [rp82["V"]], N)
