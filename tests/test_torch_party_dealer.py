"""The port's range-proof party/dealer protocol against the JAX package's.

Both packages run their ``Party`` and ``Dealer`` state machines on the
pinned inputs, the parties in order j = 0..m-1 drawing from one
``pinned.det_stream()``: the port on the CPU (``device="cpu"``: from 32
points the party MSMs, the share audits and the inner-product argument
run on the plain versions of the kernels), the JAX package on its host
path (``BP_FORCE_BACKEND=host``).  Every message and the proof must agree
exactly, and the proof must equal the fused prover's pinned digest.  At
(8, 4), n m = 32: the dealer's inner-product argument takes the port's
device route over the cached generator tensor.  Also the JAX package's
own protocol tests (``tests/test_range_proof.py``): a faulty share named
by its party, one-shot states, a value out of range.
"""

import pytest
import torch

from mpc_bulletproof_tpu import BulletproofGens as JGens
from mpc_bulletproof_tpu import HashChainTranscript as JTranscript
from mpc_bulletproof_tpu import PedersenGens as JPedersen
from mpc_bulletproof_tpu import Scalar as JScalar
from mpc_bulletproof_tpu.models.range_proof.dealer import Dealer as JDealer
from mpc_bulletproof_tpu.models.range_proof.party import Party as JParty
from mpc_bulletproof_tpu_torch import (BulletproofGens, HashChainTranscript, PedersenGens, RangeProof,
                                       Scalar, StarkPoint, generators, pinned)
from mpc_bulletproof_tpu_torch.models.range_proof import (BitChallenge, BitCommitment, Dealer, Party,
                                                          PolyChallenge, PolyCommitment, ProofShare)
from mpc_bulletproof_tpu_torch.ops import backend
from mpc_bulletproof_tpu_torch.utils.errors import MPCError

torch.set_num_threads(1)

PC, JPC = PedersenGens(), JPedersen()


@pytest.fixture(autouse=True)
def _jax_host_path(monkeypatch):
    """The JAX package's protocol runs on its host path."""
    monkeypatch.setenv("BP_FORCE_BACKEND", "host")


def flow(pkg: str, n: int, m: int, bp_gens=None, corrupt=None, audit=False):
    """The party/dealer protocol of ``pkg`` ("port" or "jax") on the pinned
    inputs; returns ``(messages, proof, V, final transcript state, bp_gens)``
    with ``messages`` the five message lists.  ``corrupt(shares)`` may
    alter the shares before the dealer sees them; ``audit`` runs
    ``receive_shares`` in place of ``receive_trusted_shares``."""
    port = pkg == "port"
    values, blindings = pinned.inputs(n, m)
    if bp_gens is None:
        bp_gens = BulletproofGens(n, m, device="cpu") if port else JGens(n, m)
    pc = PC if port else JPC
    kw = {"device": "cpu"} if port else {}
    tr = (HashChainTranscript if port else JTranscript)(pinned.TRANSCRIPT_LABEL)
    rng_bytes = pinned.det_stream()
    dealer = (Dealer if port else JDealer).new(bp_gens, pc, tr, n, m, **kw)
    parties = [(Party if port else JParty).new(bp_gens, pc, v, (Scalar if port else JScalar)(int(b)), n, **kw)
               for v, b in zip(values, blindings)]
    positioned, bit_comms = [], []
    for j, p in enumerate(parties):
        st, bc = p.assign_position(j, rng_bytes=rng_bytes)
        positioned.append(st)
        bit_comms.append(bc)
    dealer, bit_ch = dealer.receive_bit_commitments(bit_comms)
    polied, poly_comms = [], []
    for p in positioned:
        st, pc_msg = p.apply_challenge(bit_ch)
        polied.append(st)
        poly_comms.append(pc_msg)
    dealer, poly_ch = dealer.receive_poly_commitments(poly_comms)
    shares = [p.apply_challenge(poly_ch) for p in polied]
    if corrupt is not None:
        corrupt(shares)
    proof = dealer.receive_shares(shares) if audit else dealer.receive_trusted_shares(shares)
    msgs = {"bit_commitments": bit_comms, "bit_challenge": [bit_ch], "poly_commitments": poly_comms,
            "poly_challenge": [poly_ch], "shares": shares}
    return msgs, proof, [bc.V_j for bc in bit_comms], tr.state, bp_gens


def canonical(msg):
    """A message as canonical integers: points as affine (x, y) or None for
    the identity, scalars as ints, lists element by element."""
    if isinstance(msg, list):
        return [canonical(v) for v in msg]
    if hasattr(msg, "__dataclass_fields__"):
        return {k: canonical(getattr(msg, k)) for k in msg.__dataclass_fields__}
    if hasattr(msg, "is_identity"):
        return None if msg.is_identity() else (int(msg.x), int(msg.y))
    return int(msg)


@pytest.fixture(scope="module")
def port_82():
    return flow("port", 8, 2)


def test_messages_and_proof_match_jax_at_8_2(port_82):
    """Every message equal on canonical integers, the proof bytes equal,
    and the digest the fused prover's pinned (8, 2) digest."""
    msgs, proof, V, state, _ = port_82
    j_msgs, j_proof, j_V, j_state, _ = flow("jax", 8, 2)
    for kind in msgs:
        assert canonical(msgs[kind]) == canonical(j_msgs[kind]), kind
    assert proof.to_bytes() == j_proof.to_bytes()
    assert [v.to_bytes() for v in V] == [v.to_bytes() for v in j_V]
    assert state == j_state
    assert pinned.proof_digest(proof, V, state) == pinned.DIGESTS[(8, 2)]


def test_message_types(port_82):
    msgs = port_82[0]
    kinds = {"bit_commitments": BitCommitment, "bit_challenge": BitChallenge,
             "poly_commitments": PolyCommitment, "poly_challenge": PolyChallenge, "shares": ProofShare}
    for kind, cls in kinds.items():
        assert all(type(msg) is cls for msg in msgs[kind])
    assert all(len(s.l_vec) == len(s.r_vec) == 8 for s in msgs["shares"])


def test_audited_shares_assemble_the_same_proof(port_82):
    """``receive_shares`` on honest shares gives the trusted assembly's bytes."""
    _, proof, V, state, bp = port_82
    _, audited, V2, state2, _ = flow("port", 8, 2, bp_gens=bp, audit=True)
    assert audited.to_bytes() == proof.to_bytes() and state2 == state
    RangeProof.verify_multiple(audited, bp, PC, HashChainTranscript(pinned.TRANSCRIPT_LABEL), V2, 8,
                               device="cpu")


def test_proof_matches_jax_at_8_4():
    """n m = 32: the dealer's inner-product argument runs on the port's
    device route (plain versions on the CPU) over the cached generators;
    the proof equals the JAX package's host proof."""
    msgs, proof, V, state, bp = flow("port", 8, 4)
    j_msgs, j_proof, j_V, j_state, _ = flow("jax", 8, 4)
    assert canonical(msgs["shares"]) == canonical(j_msgs["shares"])
    assert proof.to_bytes() == j_proof.to_bytes()
    assert [v.to_bytes() for v in V] == [v.to_bytes() for v in j_V]
    assert state == j_state


def test_party_msms_use_the_generator_slice(monkeypatch):
    """Party j's A and S (2n + 1 points) go through ``gens_msm`` over the
    columns j n .. (j + 1) n of the aggregated generators, with B~ first;
    from 32 points on the device tensor (n = 16: 33 points)."""
    calls = []
    orig = backend.gens_msm

    def spy(bp_gens, scalars, lead, n, m=1, **kw):
        calls.append((len(scalars), n, m, kw["lo"], kw["hi"]))
        return orig(bp_gens, scalars, lead, n, m, **kw)

    monkeypatch.setattr(backend, "gens_msm", spy)
    bp = BulletproofGens(16, 4, device="cpu")
    st, bc = Party.new(bp, PC, 12345, Scalar(7), 16, device="cpu").assign_position(2, pinned.det_stream())
    assert calls == [(33, 16, 4, 32, 48), (33, 16, 4, 32, 48)]
    G, H = generators.device_gens(bp, 16, 4, torch.device("cpu"))
    assert G.shape[-1] == H.shape[-1] == 64
    # the same point as the host MSM over party 2's generators
    rng = pinned.det_stream()
    a_bl = Scalar(int.from_bytes(rng(48), "big"))
    bits = [(12345 >> i) & 1 for i in range(16)]
    want = StarkPoint.msm([a_bl] + [Scalar(b) for b in bits] + [Scalar(b - 1) for b in bits],
                                    [PC.B_blinding] + bp.share(2).G(16) + bp.share(2).H(16))
    assert bc.A_j == want


def test_dealer_detects_faulty_party():
    """A party sending a corrupted ProofShare is named by its index."""

    def corrupt(shares):
        shares[2].t_x = shares[2].t_x + Scalar(1)

    with pytest.raises(MPCError, match=r"\[2\]"):
        flow("port", 8, 4, corrupt=corrupt, audit=True)


def test_dealer_names_a_share_with_a_bad_vector():
    """A tampered l vector that keeps t = <l, r> fails the commitment
    equation of the audit MSM."""

    def corrupt(shares):
        s = shares[1]
        s.l_vec[0] = s.l_vec[0] + Scalar(1)
        s.t_x = s.t_x + s.r_vec[0]

    with pytest.raises(MPCError, match=r"\[1\]"):
        flow("port", 8, 2, corrupt=corrupt, audit=True)


def test_party_states_are_one_shot():
    bp = BulletproofGens(8, 1, device="cpu")
    p = Party.new(bp, PC, 5, Scalar(9), 8, device="cpu")
    st, bit_comm = p.assign_position(0, pinned.det_stream())
    with pytest.raises(MPCError):
        p.assign_position(1)
    dealer = Dealer.new(bp, PC, HashChainTranscript(b"one-shot"), 8, 1, device="cpu")
    _, bit_ch = dealer.receive_bit_commitments([bit_comm])
    st2, _ = st.apply_challenge(bit_ch)
    with pytest.raises(MPCError):
        st.apply_challenge(bit_ch)
    st2.apply_challenge(PolyChallenge(Scalar(3)))
    with pytest.raises(MPCError):
        st2.apply_challenge(PolyChallenge(Scalar(3)))


def test_out_of_range_value_rejected_at_party():
    bp = BulletproofGens(16, 1, device="cpu")
    with pytest.raises(MPCError):
        Party.new(bp, PC, 1 << 16, Scalar(1), 16, device="cpu")
    with pytest.raises(MPCError):
        Party.new(bp, PC, 3, Scalar(1), 12, device="cpu")          # not a power of two
    with pytest.raises(MPCError):
        Party.new(bp, PC, 3, Scalar(1), 32, device="cpu")          # beyond the generators
    p = Party.new(bp, PC, 3, Scalar(1), 16, device="cpu")
    with pytest.raises(MPCError):
        p.assign_position(1)                                      # beyond the party capacity


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, the default device raises instead of running on the CPU."""
    bp = BulletproofGens(8, 1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Party.new(bp, PC, 5, Scalar(9), 8)
    with pytest.raises(RuntimeError):
        Dealer.new(bp, PC, HashChainTranscript(b"x"), 8, 1)
