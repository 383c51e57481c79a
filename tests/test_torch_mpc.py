"""The port's collaborative (2-party MPC) prover against the JAX package's.

Both parties run as threads over the in-process link, in the port on the
CPU (``MpcFabric(..., device="cpu")``: MSMs and the device share plane on
the plain versions of the kernels) and in the JAX package on its host
path (``BP_FORCE_BACKEND=host``).  The deterministic pre-processing
(``PartyIdBeaverSource``) makes every share, MAC and opened value a
function of the inputs, so the two packages must agree on all of them:
the fabric's primitives, the device share vectors against the host ones,
the t-polynomial's device branch against its host branch, the shared IPP
round by round, and the opened proofs byte for byte.  Tampered shares
must raise ``AuthenticationError`` in both parties, a rushing party
included.  The collaborative range proof runs at 4 bits x 2 values (n =
8, the host branches) and 8 bits x 2 values (n = 16, the device share
plane and the phase MSMs' device route on the plain versions).
"""

import random
import socket
import threading
import time

import pytest
import torch

from mpc_bulletproof_tpu import BulletproofGens as JGens
from mpc_bulletproof_tpu import HashChainTranscript as JTranscript
from mpc_bulletproof_tpu import PedersenGens as JPedersen
from mpc_bulletproof_tpu import Scalar as JScalar
from mpc_bulletproof_tpu import StarkPoint as JPoint
from mpc_bulletproof_tpu.models.r1cs.gadgets import example_gadget as j_example_gadget
from mpc_bulletproof_tpu.models.r1cs.linear_combination import LinearCombination as JLC
from mpc_bulletproof_tpu.models.r1cs.linear_combination import Variable as JVariable
from mpc_bulletproof_tpu.models.r1cs_mpc import MpcProver as JMpcProver
from mpc_bulletproof_tpu.models.r1cs_mpc import SharedInnerProductProof as JSharedIPP
from mpc_bulletproof_tpu.models.r1cs_mpc.authenticated_poly import AuthenticatedVecPoly3 as JPoly3
from mpc_bulletproof_tpu.parallel.beaver import PartyIdBeaverSource as JBeaver
from mpc_bulletproof_tpu.parallel.device_shares import DeviceShareVector as JDeviceShareVector
from mpc_bulletproof_tpu.parallel.fabric import MpcFabric as JFabric
from mpc_bulletproof_tpu.parallel.network import make_local_pair as j_make_local_pair
from mpc_bulletproof_tpu.transcript import MpcTranscript as JMpcTranscript
from mpc_bulletproof_tpu_torch import (AuthenticationError, BulletproofGens, HashChainTranscript,
                                       InnerProductProof, LinearCombination, MpcFabric, MpcProver,
                                       MpcTranscript, PartyIdBeaverSource, PedersenGens, R1CSProof,
                                       Scalar, SharedInnerProductProof, StarkPoint, Variable, Verifier,
                                       make_local_pair, pinned)
from mpc_bulletproof_tpu_torch.models.r1cs.gadgets import example_gadget, range_check_gadget
from mpc_bulletproof_tpu_torch.models.r1cs_mpc import authenticated_poly
from mpc_bulletproof_tpu_torch.models.r1cs_mpc.authenticated_poly import AuthenticatedVecPoly3
from mpc_bulletproof_tpu_torch.ops import kernels
from mpc_bulletproof_tpu_torch.ops.field import scalar_powers
from mpc_bulletproof_tpu_torch.ops.keccak import keccak256
from mpc_bulletproof_tpu_torch.parallel.device_shares import DeviceShareVector
from mpc_bulletproof_tpu_torch.parallel.fabric import (AuthenticatedScalarVector, _pack_scalars,
                                                       _unpack_scalars)
from mpc_bulletproof_tpu_torch.parallel.network import TcpTwoPartyNet

torch.set_num_threads(1)

PC, JPC = PedersenGens(), JPedersen()


@pytest.fixture(autouse=True)
def _jax_host_path(monkeypatch):
    """The JAX package's MPC runs on its host path."""
    monkeypatch.setenv("BP_FORCE_BACKEND", "host")


def _run(fn0, fn1=None, *, jax=False, latency_s=0.0):
    """``fn(fabric)`` for both parties as threads over a local link, port
    (on the CPU) or JAX package; returns ``[result0, result1]`` and raises
    the first party's error."""
    fn1 = fn0 if fn1 is None else fn1
    if jax:
        nets = j_make_local_pair(latency_s=latency_s)
        fabrics = [JFabric(net, JBeaver(net.party_id)) for net in nets]
    else:
        nets = make_local_pair(latency_s=latency_s)
        fabrics = [MpcFabric(net, PartyIdBeaverSource(net.party_id), device="cpu") for net in nets]
    results, errors = [None, None], [None, None]

    def runner(i, fn):
        try:
            results[i] = fn(fabrics[i])
        except Exception as exc:  # noqa: BLE001 - raised below
            errors[i] = exc

    threads = [threading.Thread(target=runner, args=(i, fn)) for i, fn in enumerate((fn0, fn1))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    assert not any(th.is_alive() for th in threads), "a party did not finish"
    for err in errors:
        if err is not None:
            raise err
    return results


def _ints(vec):
    return [int(v) for v in vec.shares], [int(v) for v in vec.macs]


def _rand(rng, k):
    return [rng.getrandbits(260) for _ in range(k)]


def _share(fabric, values, owner, k, scalar):
    return fabric.batch_share_scalars([scalar(v) for v in values] if fabric.party_id == owner else None,
                                      owner, count=k)


# ---------------------------------------------------------------------------
# fabric primitives
# ---------------------------------------------------------------------------

def _fabric_ops(scalar, point):
    """Every fabric primitive of one party; returns the shares, MACs and
    opened values as ints and bytes."""
    rng = random.Random(77)
    xs, ys = _rand(rng, 6), _rand(rng, 6)
    g = point.generator()
    pts = [g * scalar(i + 2) for i in range(3)]

    def fn(fabric):
        x = _share(fabric, xs, 0, 6, scalar)
        y = _share(fabric, ys, 1, 6, scalar)
        combo = (x + y).mul_public(scalar(3)) - y
        prod = fabric.beaver_mul(x, y)
        ip = fabric.inner_product(x, y)
        msm_pt = fabric.shared_msm(x[:3], pts)
        owned_pt = fabric.share_point(g * scalar(0xDEADBEEF) if fabric.party_id == 1 else None, owner=1)
        pre = fabric.authenticate_preshared([scalar(700)] if fabric.party_id == 0 else [scalar(77)])
        return {
            "x": _ints(x), "combo": _ints(combo), "prod": _ints(prod), "ip": _ints(ip), "pre": _ints(pre),
            "opened": [int(v) for v in x.open_authenticated() + combo.open_authenticated()
                       + prod.open_authenticated() + ip.open_authenticated() + pre.open_authenticated()],
            "points": [p.to_bytes() for p in (msm_pt.share, msm_pt.mac, msm_pt.open_authenticated(),
                                              owned_pt.open_authenticated())],
        }

    return fn, xs, ys


def test_fabric_primitives_match_jax():
    """Share, open, beaver_mul, inner_product, shared_msm, share_point and
    authenticate_preshared: the port's shares, MACs and opened values equal
    the JAX fabric's, and the opened values are the plain results."""
    fn, xs, ys = _fabric_ops(Scalar, StarkPoint)
    port = _run(fn)
    jfn, _, _ = _fabric_ops(JScalar, JPoint)
    jax_ = _run(jfn, jax=True)
    assert port == jax_
    r = Scalar.MODULUS
    opened = port[0]["opened"]
    assert opened[:6] == [x % r for x in xs]
    assert opened[6:12] == [((x + y) * 3 - y) % r for x, y in zip(xs, ys)]
    assert opened[12:18] == [x * y % r for x, y in zip(xs, ys)]
    assert opened[18] == sum(x * y for x, y in zip(xs, ys)) % r
    assert opened[19] == 777
    g = StarkPoint.generator()
    assert port[0]["points"][2] == StarkPoint.msm([Scalar(x) for x in xs[:3]],
                                                  [g * Scalar(i + 2) for i in range(3)]).to_bytes()
    assert port[0]["points"][3] == (g * Scalar(0xDEADBEEF)).to_bytes()


def test_fabric_defaults_to_the_card(monkeypatch):
    """Without a card the default device raises instead of running on the
    CPU: the fabric, and so its MSMs and device share vectors."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = make_local_pair()[0]
    with pytest.raises(RuntimeError):
        MpcFabric(net, PartyIdBeaverSource(0))
    with pytest.raises(RuntimeError):
        MpcProver.new_with_network(net, PartyIdBeaverSource(0), PC, HashChainTranscript(b"t"))
    assert MpcFabric(net, PartyIdBeaverSource(0), device="cpu").device.type == "cpu"


def test_tampered_share_raises_in_both_parties():
    def party(tamper):
        def fn(fabric):
            shared = _share(fabric, [42], 0, 1, Scalar)
            if tamper:
                shared.shares[0] = shared.shares[0] + Scalar(1)
            with pytest.raises(AuthenticationError):
                shared.open_authenticated()
            return True
        return fn

    assert _run(party(True), party(False)) == [True, True]


def test_rushing_adversary_cannot_forge_the_mac_check():
    """A party that changes its share, commits to garbage, waits for the
    honest sigma and reveals its negation still fails the honest party's
    check: the commitment binds before the reveal."""
    def honest(fabric):
        shared = _share(fabric, [42], 0, 1, Scalar)
        with pytest.raises(AuthenticationError):
            shared.open_authenticated()
        return True

    def rushing(fabric):
        shared = fabric.batch_share_scalars(None, owner=0, count=1)
        tampered = shared.shares[0] + Scalar(1)
        net = fabric.net
        net.send_bytes(_pack_scalars([tampered]))
        opened = tampered + _unpack_scalars(net.recv_bytes())[0]
        salt = b"\xAA" * 32
        net.recv_bytes()                                     # the honest commitment
        net.send_bytes(keccak256(_pack_scalars([Scalar(0)]) + salt))
        honest_sigma = _unpack_scalars(net.recv_bytes()[:-32])[0]
        net.send_bytes(_pack_scalars([-honest_sigma]) + salt)
        return opened

    assert _run(honest, rushing)[0] is True


# ---------------------------------------------------------------------------
# the device share plane on CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [16, 40])
def test_device_share_vector_matches_host_vectors(k):
    """Every DeviceShareVector operation on CPU tensors (the plain versions
    of vec2) gives the shares and MACs of the host vectors' operation."""
    rng = random.Random(k)
    xs, ys, pub = _rand(rng, k), _rand(rng, k), _rand(rng, k)
    c = Scalar(rng.getrandbits(251))

    def fn(fabric):
        x = _share(fabric, xs, 0, k, Scalar)
        y = _share(fabric, ys, 1, k, Scalar)
        dx, dy = DeviceShareVector.from_host(x), DeviceShareVector.from_host(y)
        pairs = [
            (dx + dy, x + y),
            (dx - dy, x - y),
            (dx.add_public([Scalar(v) for v in pub]), x.add_public(pub)),
            (dx.mul_public(c), x.mul_public(c)),
            (dx.mul_public([Scalar(v) for v in pub]), x.mul_public(pub)),
            (dx.beaver_mul(dy), fabric.beaver_mul(x, y)),
            (dx.sum(), x.sum()),
            (dx.inner_product(dy), fabric.inner_product(x, y)),
            (DeviceShareVector.concat([dx[: k // 2], dy[3]]), AuthenticatedScalarVector.concat([x[: k // 2], y[3]])),
        ]
        for dev_vec, host_vec in pairs:
            assert dev_vec.shares.device.type == "cpu"
            assert _ints(dev_vec.to_host()) == _ints(host_vec)
        return [int(v) for v in fabric.beaver_mul(x, y).open_authenticated()], \
            dx.beaver_mul(dy).open_authenticated()

    (host0, dev0), (host1, dev1) = _run(fn)
    from mpc_bulletproof_tpu_torch.ops.limb import words_to_ints

    want = [x * y % Scalar.MODULUS for x, y in zip(xs, ys)]
    assert host0 == host1 == want
    assert words_to_ints(dev0) == words_to_ints(dev1) == want


@pytest.mark.parametrize("k", [16, 40])
def test_device_beaver_mul_matches_jax_device_share_vector(k):
    """The fused Beaver round (difference, opening, combination) gives, in
    both parties, the shares and MACs of the JAX package's
    ``DeviceShareVector.beaver_mul`` (its limb ops one at a time) and of
    the host fabric's ``beaver_mul``; the opened products are x y."""
    rng = random.Random(300 + k)
    xs, ys = _rand(rng, k), _rand(rng, k)
    xs[:3] = [0, 1, Scalar.MODULUS - 1]
    ys[:3] = [Scalar.MODULUS - 1, 0, Scalar.MODULUS - 1]

    def port(fabric):
        x, y = _share(fabric, xs, 0, k, Scalar), _share(fabric, ys, 1, k, Scalar)
        z = DeviceShareVector.from_host(x).beaver_mul(DeviceShareVector.from_host(y))
        assert z.shares.is_contiguous() and z.macs.is_contiguous()
        return _ints(z.to_host()), _ints(fabric.beaver_mul(x, y)), [int(v) for v in z.to_host().open_authenticated()]

    def jax_(fabric):
        x, y = _share(fabric, xs, 0, k, JScalar), _share(fabric, ys, 1, k, JScalar)
        return _ints(JDeviceShareVector.from_host(x).beaver_mul(JDeviceShareVector.from_host(y)).to_host())

    got = _run(port)
    want = _run(jax_, jax=True)
    for party in (0, 1):
        assert got[party][0] == want[party] == got[party][1]
    assert got[0][2] == got[1][2] == [x * y % Scalar.MODULUS for x, y in zip(xs, ys)]


@pytest.mark.parametrize("n", [16, 40])
def test_poly_device_branch_matches_jax_device_branch(n, monkeypatch):
    """The t-polynomial (one fused Beaver round over 9n lanes) and both
    evaluations (one ``poly3_eval`` each) on the port's device share plane
    give the shares, MACs and opened values of the JAX package's
    ``AuthenticatedVecPoly3`` on its own device branch (forced with
    ``BP_FORCE_BACKEND=device``, JAX on the CPU), in both parties."""
    port = _run(lambda f: _poly_parts(n, Scalar)(f, AuthenticatedVecPoly3))
    calls = []
    real = JDeviceShareVector.from_host
    monkeypatch.setattr(JDeviceShareVector, "from_host", staticmethod(lambda v: calls.append(len(v)) or real(v)))
    monkeypatch.setenv("BP_FORCE_BACKEND", "device")
    jax_ = _run(lambda f: _poly_parts(n, JScalar)(f, JPoly3), jax=True)
    assert sorted(set(calls)) == [n, 9 * n]
    assert port == jax_


def test_device_share_vector_tamper_raises():
    def party(tamper):
        def fn(fabric):
            d = DeviceShareVector.from_host(_share(fabric, [5] * 16, 0, 16, Scalar))
            if tamper:
                d.shares[0, 7] += 1
            with pytest.raises(AuthenticationError):
                d.open_authenticated()
            return True
        return fn

    assert _run(party(True), party(False)) == [True, True]


def _poly_parts(n, scalar):
    rng = random.Random(n + 5)
    coeffs = [_rand(rng, n) for _ in range(8)]
    x = scalar(rng.getrandbits(251))

    def fn(fabric, poly3):
        zeros = fabric.zeros_authenticated(n)
        l_poly = poly3(zeros, _share(fabric, coeffs[1], 0, n, scalar), _share(fabric, coeffs[2], 1, n, scalar),
                       _share(fabric, coeffs[3], 0, n, scalar))
        r_poly = poly3(_share(fabric, coeffs[4], 1, n, scalar), _share(fabric, coeffs[5], 0, n, scalar), zeros,
                       _share(fabric, coeffs[7], 1, n, scalar))
        t = poly3.special_inner_product(l_poly, r_poly)
        ts = [t.t1, t.t2, t.t3, t.t4, t.t5, t.t6]
        l_x, r_x = l_poly.eval(x), r_poly.eval(x)
        return ([_ints(v) for v in ts], _ints(l_x), _ints(r_x),
                [int(v) for v in type(l_x).concat(ts + [l_x]).open_authenticated()])

    return fn


def test_special_inner_product_and_eval_device_branch(monkeypatch):
    """At n = 16 the t-polynomial and the evaluations take the device share
    plane (CPU tensors); their shares, MACs and opened values equal the
    host branch's (forced by raising the width limit) and the JAX host
    path's."""
    n = 16
    fn = _poly_parts(n, Scalar)
    calls = []
    real, real_poly3 = DeviceShareVector.from_host, DeviceShareVector.poly3
    monkeypatch.setattr(DeviceShareVector, "from_host", staticmethod(lambda v: calls.append(len(v)) or real(v)))
    monkeypatch.setattr(DeviceShareVector, "poly3",
                        staticmethod(lambda cs, x: calls.append(len(cs[0])) or real_poly3(cs, x)))
    device = _run(lambda f: fn(f, AuthenticatedVecPoly3))
    assert sorted(set(calls)) == [n, 9 * n]
    calls.clear()
    monkeypatch.setattr(authenticated_poly, "DEVICE_MIN_WIDTH", 1 << 30)
    host = _run(lambda f: fn(f, AuthenticatedVecPoly3))
    assert calls == []
    jfn = _poly_parts(n, JScalar)
    jax_ = _run(lambda f: jfn(f, JPoly3), jax=True)
    assert device == host == jax_


def test_device_branch_launches_vec2_only(monkeypatch):
    """On a CUDA device the device branch's work is launches of
    ``csrc/vec2.cu``'s entries and nothing else (the CUDA branch of the
    wrappers on CPU tensors: ``_check`` reports a card, ``_launch`` records;
    the plain versions raise if reached).  An evaluation at n = 16 is one
    ``poly3_eval`` launch; the t-polynomial's Beaver round is three a party
    (the difference, the opening's sum, the combination), six for both."""
    n = 16
    lanes_arg = {"vec2": 3, "beaver_diff": 4, "beaver_combine": 4, "poly3_eval": 2}
    calls = []
    monkeypatch.setattr(kernels, "_check", lambda t, *a, **kw: "cuda")
    monkeypatch.setattr(kernels, "_launch", lambda name, device, *args: calls.append((name, args[lanes_arg[name]])))

    def no_plain(*a, **kw):
        raise AssertionError("plain version reached on a CUDA device")

    monkeypatch.setattr(kernels, "_VEC_OPS", {op: (code, no_plain) for op, (code, _) in kernels._VEC_OPS.items()})
    for name in ("beaver_diff_plain", "beaver_combine_plain", "poly3_eval_plain"):
        monkeypatch.setattr(kernels, name, no_plain)
    fabric = MpcFabric(make_local_pair()[0], PartyIdBeaverSource(0), device="cpu")
    zeros = fabric.zeros_authenticated(n)
    AuthenticatedVecPoly3(zeros, zeros, zeros, zeros).eval(Scalar(3))
    assert calls == [("poly3_eval", n)]
    calls.clear()

    def t_poly(f):
        z = f.zeros_authenticated(n)
        AuthenticatedVecPoly3.special_inner_product(AuthenticatedVecPoly3(z, z, z, z),
                                                    AuthenticatedVecPoly3(z, z, z, z))
        return threading.current_thread().name

    _run(t_poly)
    assert sorted(calls) == sorted([("beaver_diff", 9 * n), ("vec2", 18 * n), ("beaver_combine", 9 * n)] * 2)
    calls.clear()
    small = fabric.zeros_authenticated(n - 1)
    AuthenticatedVecPoly3(small, small, small, small).eval(Scalar(3))
    assert calls == []


# ---------------------------------------------------------------------------
# the shared inner-product argument
# ---------------------------------------------------------------------------

def _ipp_inputs(n):
    rng = random.Random(n)
    return _rand(rng, n), _rand(rng, n), rng.getrandbits(251), rng.getrandbits(251)


def _shared_ipp(n, jax=False, tamper=False):
    a, b, y_inv, q = _ipp_inputs(n)
    if jax:
        scalar, gens, create, mpc_tr, tr = JScalar, JGens(n, 1), JSharedIPP.create, JMpcTranscript, JTranscript
        G, H = gens.share(0).G(n), gens.share(0).H(n)
        Q = JPoint.generator() * JScalar(q)
    else:
        scalar, gens, create, mpc_tr, tr = Scalar, BulletproofGens(n, 1, device="cpu"), \
            SharedInnerProductProof.create, MpcTranscript, HashChainTranscript
        G, H = gens.share(0).G(n), gens.share(0).H(n)
        Q = StarkPoint.generator() * Scalar(q)
    G_factors = [scalar(1)] * (n // 2) + [scalar(y_inv)] * (n // 2)
    yp = scalar(y_inv)
    H_factors = [scalar(1)]
    for _ in range(n - 1):
        H_factors.append(H_factors[-1] * yp)

    def fn(fabric):
        t = tr(b"ipptest")
        proof = create(mpc_tr(t), Q, G_factors, H_factors, G, H, _share(fabric, a, 0, n, scalar),
                       _share(fabric, b, 1, n, scalar), fabric)
        if tamper and fabric.party_id == 0:
            proof.a.shares[0] = proof.a.shares[0] + scalar(1)
        opened = proof.open()
        return opened.to_bytes(), [p.to_bytes() for p in proof.L_vec], [p.to_bytes() for p in proof.R_vec], t.state

    return _run(fn, jax=jax)


@pytest.mark.parametrize("n", [8, 16])
def test_shared_ipp_matches_jax_round_by_round(n):
    """L and R of every round, the opened proof's bytes and the final
    transcript state equal the JAX host path's; the port's verifier
    accepts the proof."""
    port = _shared_ipp(n)
    assert port[0] == port[1]
    jax_ = _shared_ipp(n, jax=True)
    for got, want in zip(port[0], jax_[0]):
        assert got == want
    a, b, y_inv, q = _ipp_inputs(n)
    gens = BulletproofGens(n, 1, device="cpu")
    G, H = gens.share(0).G(n), gens.share(0).H(n)
    G_factors = [Scalar(1)] * (n // 2) + [Scalar(y_inv)] * (n // 2)
    H_factors = scalar_powers(Scalar(y_inv), n)
    Q = StarkPoint.generator() * Scalar(q)
    P = StarkPoint.msm([Scalar(x) * f for x, f in zip(a, G_factors)] + [Scalar(x) * f for x, f in zip(b, H_factors)]
                       + [Scalar(sum(x * y for x, y in zip(a, b)))], G + H + [Q])
    proof = InnerProductProof.from_bytes(port[0][0])
    proof.verify(n, HashChainTranscript(b"ipptest"), G_factors, H_factors, P, Q, G, H, device="cpu")


@pytest.mark.parametrize("cur", [4, 2])
def test_shared_ipp_round_msms_on_generator_tensors(cur):
    """Over generator tensors a round's four MSMs (L and R, share and MAC
    rows) are one multi-MSM call; its points equal the host route's."""
    from mpc_bulletproof_tpu_torch.generators import device_gens
    from mpc_bulletproof_tpu_torch.models.r1cs_mpc.mpc_inner_product import _round_msms

    n = 4
    gens = BulletproofGens(n, 1, device="cpu")
    fabric = MpcFabric(make_local_pair()[0], PartyIdBeaverSource(0), device="cpu")
    Q = StarkPoint.generator() * Scalar(0xABCDEF)
    rng = random.Random(cur)
    rows = [[rng.randrange(Scalar.MODULUS) for _ in range(n + 1)] for _ in range(4)]
    G, H = device_gens(gens, n, 1, torch.device("cpu"))
    got = _round_msms(fabric, G, H, Q, n)(cur, *rows)
    assert got == _round_msms(fabric, gens.share(0).G(n), gens.share(0).H(n), Q, n)(cur, *rows)


def test_shared_ipp_tamper_raises():
    with pytest.raises(AuthenticationError):
        _shared_ipp(4, tamper=True)


# ---------------------------------------------------------------------------
# the collaborative R1CS prover
# ---------------------------------------------------------------------------

def jax_mpc_range(n_bits: int, m: int):
    """The JAX package's collaborative range proof on the pinned inputs
    (host path): ``(proof bytes, commitment bytes, digest)``."""
    import os

    os.environ["BP_FORCE_BACKEND"] = "host"
    values, blindings = pinned.mpc_range_inputs(n_bits, m)
    bp = JGens(n_bits * m, 1)

    def fn(fabric):
        t = JTranscript(pinned.MPC_LABEL)
        prover = JMpcProver(fabric, JPC, t)
        comms = pinned.mpc_range_party(prover, fabric, n_bits, values, blindings, scalar=JScalar)
        proof = prover.prove(bp).open()
        return proof.to_bytes(), [c.to_bytes() for c in comms], pinned.proof_digest(proof, comms, t.state)

    r0, r1 = _run(fn, jax=True)
    assert r0 == r1
    return r0


def port_mpc_range(n_bits: int, m: int, tamper: bool = False):
    values, blindings = pinned.mpc_range_inputs(n_bits, m)
    bp = BulletproofGens(n_bits * m, 1, device="cpu")

    def fn(fabric):
        t = HashChainTranscript(pinned.MPC_LABEL)
        prover = MpcProver(fabric, PC, t)
        comms = pinned.mpc_range_party(prover, fabric, n_bits, values, blindings)
        shared = prover.prove(bp)
        if tamper and fabric.party_id == 1:
            shared.ipp_proof.b.macs[0] = shared.ipp_proof.b.macs[0] + Scalar(1)
        proof = shared.open()
        return proof, comms, pinned.proof_digest(proof, comms, t.state)

    r0, r1 = _run(fn)
    assert r0[0] == r1[0] and r0[1] == r1[1]
    return r0, bp


def _verify_range(proof, comms, bp, n_bits):
    v = Verifier(PC, HashChainTranscript(pinned.MPC_LABEL))
    for V in comms:
        range_check_gadget(v, v.commit(V).to_lc(), None, n_bits)
    v.verify(proof, bp, device="cpu")


@pytest.mark.parametrize("n_bits", [4, 8])
def test_mpc_range_proof_matches_jax_host(n_bits):
    """The collaborative range proof over 2 values: the opened bytes and
    commitments equal the JAX host path's, the digest the pinned one, and
    the port's plain verifier accepts the proof.  n_bits = 8 gives n = 16
    multipliers: the t-polynomial and evaluations on the device share
    plane, the phase MSMs (33 points) on the plain device MSM."""
    (proof, comms, digest), bp = port_mpc_range(n_bits, 2)
    j_bytes, j_comms, j_digest = jax_mpc_range(n_bits, 2)
    assert proof.to_bytes() == j_bytes
    assert [c.to_bytes() for c in comms] == j_comms
    assert digest == j_digest == pinned.MPC_RANGE_DIGESTS[(n_bits, 2)]
    assert R1CSProof.from_bytes(j_bytes) == proof
    _verify_range(proof, comms, bp, n_bits)


def test_mpc_range_proof_mac_tamper_raises():
    with pytest.raises(AuthenticationError):
        port_mpc_range(4, 2, tamper=True)


def _example(fabric, prover_cls, scalar, lc, var, gadget, gens, label=b"bench-mpc"):
    """``bench.py``'s MPC configuration (``_mpc_prove_ms``): the example
    gadget over five committed values, two owners."""
    rng = random.Random(4242)
    blind = [scalar(rng.getrandbits(260)) for _ in range(5)]
    c2 = lc({var.one(): scalar(9)})
    prover = prover_cls(fabric, PC if scalar is Scalar else JPC,
                        (HashChainTranscript if scalar is Scalar else JTranscript)(label))
    if fabric.party_id == 0:
        c0, v0 = prover.batch_commit(0, [scalar(3), scalar(6), scalar(40)], blind[:3])
        c1, v1 = prover.batch_commit(1, None, None, count=2)
    else:
        c0, v0 = prover.batch_commit(0, None, None, count=3)
        c1, v1 = prover.batch_commit(1, [scalar(4), scalar(1)], blind[3:])
    gadget(prover, v0[0].to_lc(), v1[0].to_lc(), v0[1].to_lc(), v1[1].to_lc(), v0[2].to_lc(), c2)
    return prover.prove(gens).open().to_bytes(), [c.to_bytes() for c in c0 + c1]


def test_example_gadget_proof_matches_jax():
    gens, jgens = BulletproofGens(16, 1, device="cpu"), JGens(16, 1)
    port = _run(lambda f: _example(f, MpcProver, Scalar, LinearCombination, Variable, example_gadget, gens))
    jax_ = _run(lambda f: _example(f, JMpcProver, JScalar, JLC, JVariable, j_example_gadget, jgens), jax=True)
    assert port[0] == port[1] == jax_[0]
    proof_bytes, comm_bytes = port[0]
    v = Verifier(PC, HashChainTranscript(b"bench-mpc"))
    vv = [v.commit(StarkPoint.from_bytes(c)) for c in comm_bytes]
    example_gadget(v, vv[0].to_lc(), vv[3].to_lc(), vv[1].to_lc(), vv[4].to_lc(), vv[2].to_lc(),
                   LinearCombination({Variable.one(): Scalar(9)}))
    v.verify(R1CSProof.from_bytes(proof_bytes), gens, device="cpu")


def test_launch_counter_is_safe_for_party_threads(monkeypatch):
    """Both parties launch kernels from their own threads: the launch
    counter loses no update under threads switching every microsecond
    (the launch itself stubbed, as no card is here)."""
    import contextlib
    import sys
    import types

    monkeypatch.setattr(kernels, "_fn", lambda name: lambda *args: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    kernels.reset_launches()
    workers, calls = 16, 2000

    def work():
        for _ in range(calls):
            kernels._launch("vec2", torch.device("cuda", 0))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert kernels.launches["vec2"] == workers * calls
    kernels.reset_launches()


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

def test_local_pair_latency_injection_and_counters():
    net0, net1 = make_local_pair(latency_s=0.05)
    out = [None]
    th = threading.Thread(target=lambda: out.__setitem__(0, net1.exchange_bytes(b"from1")))
    t0 = time.monotonic()
    th.start()
    got = net0.exchange_bytes(b"from0")
    th.join(timeout=10)
    assert not th.is_alive()
    assert got == b"from1" and out[0] == b"from0"
    assert time.monotonic() - t0 >= 0.05
    assert (net0.sent_messages, net0.sent_bytes) == (1, 5)


def test_tcp_large_exchange_no_deadlock():
    """Payloads larger than the socket buffers, both parties sending first."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    nets = [TcpTwoPartyNet(i, ("127.0.0.1", port), ("127.0.0.1", port)) for i in (0, 1)]
    results = [None, None]

    def party(i):
        nets[i].connect()
        results[i] = nets[i].exchange_bytes(bytes([i]) * (4 << 20))
        nets[i].close()

    threads = [threading.Thread(target=party, args=(i,)) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert results[0] == bytes([1]) * (4 << 20)
    assert results[1] == bytes([0]) * (4 << 20)


@pytest.mark.cuda
def test_card_mpc_range_proof_matches_pinned_digest():
    """On a card: the (8, 2) collaborative proof, its MSMs and the device
    share plane on the kernels, equals the pinned digest and launches vec2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py proves (64, 64) there)")
    n_bits, m = 8, 2
    values, blindings = pinned.mpc_range_inputs(n_bits, m)
    bp = BulletproofGens(n_bits * m, 1)
    nets = make_local_pair()
    out = [None, None]

    def party(i):
        fabric = MpcFabric(nets[i], PartyIdBeaverSource(i))
        t = HashChainTranscript(pinned.MPC_LABEL)
        prover = MpcProver(fabric, PC, t)
        comms = pinned.mpc_range_party(prover, fabric, n_bits, values, blindings)
        proof = prover.prove(bp).open()
        out[i] = pinned.proof_digest(proof, comms, t.state)

    kernels.reset_launches()
    threads = [threading.Thread(target=party, args=(i,)) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert out == [pinned.MPC_RANGE_DIGESTS[(n_bits, m)]] * 2
    assert kernels.launches["vec2"] > 0
