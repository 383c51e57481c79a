"""The inner-product argument alone (``models/inner_product.py``), its
MSMs (``msm_device_pair``, ``msm_device_split``), ``utils/profiling.py``
and the host names the port copies from the JAX package, against the JAX
package.

The pinned IPP inputs (``pinned.ipp_inputs``) go through the JAX
package's host ``InnerProductProof.create`` (``JAX_PLATFORMS=cpu``: its
host path, native engine where present), which must give
``pinned.IPP_DIGESTS``; the port's ``create`` on the CPU must give them
too.  The coefficient-tracking device prover (``_create_device``) and the
folding prover (``_create_host_folding``) must give the JAX host prover's
proof bytes and final transcript state.  The port's fused route (from n =
32) takes ~30 s a proof on the plain kernels with one torch thread; it is
held to the digests on the card (``tests/test_torch_ipp_card.py``,
``chip_smoke.py``) and to the JAX package here by ``test_torch_r1cs.py``'s
k = 16 shuffle.
"""

import os
import random

import pytest
import torch

from mpc_bulletproof_tpu import HashChainTranscript as JTranscript
from mpc_bulletproof_tpu import InnerProductProof as JIPP
from mpc_bulletproof_tpu import Scalar as JScalar
from mpc_bulletproof_tpu import StarkPoint as JPoint
from mpc_bulletproof_tpu import generators as jgens
from mpc_bulletproof_tpu import inner_product as j_inner_product
from mpc_bulletproof_tpu import random_point as j_random_point
from mpc_bulletproof_tpu.models import inner_product as jipp
from mpc_bulletproof_tpu.ops import curve_jax as cj
from mpc_bulletproof_tpu.ops import field as jfield
from mpc_bulletproof_tpu.ops import msm as jmsm
from mpc_bulletproof_tpu.transcript import hash_to_scalar as j_hash_to_scalar
from mpc_bulletproof_tpu.utils import errors as jerrors
from mpc_bulletproof_tpu.utils import native as jnative
from mpc_bulletproof_tpu.utils import profiling as jprofiling
import mpc_bulletproof_tpu_torch as port
from mpc_bulletproof_tpu_torch import (BulletproofGens, HashChainTranscript, InnerProductProof,
                                       PedersenGens, Scalar, StarkPoint, VerificationError, pinned)
from mpc_bulletproof_tpu_torch.generators import GeneratorsChain
from mpc_bulletproof_tpu_torch.models import inner_product as ipp
from mpc_bulletproof_tpu_torch.ops import curve_t, msm
from mpc_bulletproof_tpu_torch.ops.field import exp_iter, scalar_exp_vartime, scalars_from_ints
from mpc_bulletproof_tpu_torch.ops.limb import ints_to_words
from mpc_bulletproof_tpu_torch.utils import profiling
from test_torch_r1cs import jax_shuffle, port_shuffle

# Under pytest-xdist several worker processes share the cores: split them,
# or torch's default of one intra-op thread per core in every worker
# oversubscribes the machine.
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

B = StarkPoint.generator()


def _jax_points(ints):
    if jnative.available():
        return jnative.fixed_base_mul([JScalar(v) for v in ints], JPoint.generator())
    return [JPoint.generator().scalar_mul(JScalar(v)) for v in ints]


def _port_points(ints):
    return [B.scalar_mul(v) for v in ints]


def jax_ipp(n: int, create=None):
    """The JAX package's IPP on ``pinned.ipp_inputs(n)``: ``(proof, final
    transcript state)``; ``create`` one of its inner provers, after the
    transcript's IPP domain is opened, else its ``InnerProductProof.create``."""
    inp = pinned.ipp_host_inputs(n, _jax_points, JScalar)
    t = JTranscript(pinned.IPP_LABEL)
    args = (inp["Q"], inp["G_factors"], inp["H_factors"], inp["G"], inp["H"], inp["a"], inp["b"])
    if create is None:
        proof = JIPP.create(t, *args)
    else:
        t.innerproduct_domain_sep(n)
        proof = create(t, *args)
    return proof, t.state


def jax_ipp_digest(n: int) -> str:
    """``pinned.IPP_DIGESTS[n]`` as the JAX package's host prover gives it."""
    return pinned.ipp_digest(*jax_ipp(n))


def port_ipp(n: int, create=None, **kw):
    """:func:`jax_ipp` on the port, on the CPU."""
    inp = pinned.ipp_host_inputs(n, _port_points)
    t = HashChainTranscript(pinned.IPP_LABEL)
    args = (inp["Q"], inp["G_factors"], inp["H_factors"], inp["G"], inp["H"], inp["a"], inp["b"])
    if create is None:
        proof = InnerProductProof.create(t, *args, device="cpu")
    else:
        t.innerproduct_domain_sep(n)
        proof = create(t, *args, device="cpu", **kw)
    return proof, t.state, inp


def _host_msm_device(scalars, points, c=None):
    """An exact stand-in for ``msm.msm_device`` in host arithmetic."""
    s = [Scalar(v) for v in curve_t.scalars_to_host(scalars)]
    return torch.as_tensor(curve_t.points_from_host([StarkPoint.msm(s, curve_t.points_to_host(points))]))[..., 0]


def test_jax_host_path_gives_the_pinned_digests():
    for lg in range(1, 7):
        assert jax_ipp_digest(1 << lg) == pinned.IPP_DIGESTS[1 << lg]


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_create_matches_pinned_digest(n):
    proof, state, _ = port_ipp(n)
    assert pinned.ipp_digest(proof, state) == pinned.IPP_DIGESTS[n]


def test_create_device_matches_jax_host():
    """n = 8 on the port's plain device MSM: two ``msm_device`` calls a round."""
    proof, state, _ = port_ipp(8, ipp._create_device)
    j_proof, j_state = jax_ipp(8, jipp._create_host)
    assert proof.to_bytes() == j_proof.to_bytes()
    assert state == j_state


def test_create_device_rounds_match_jax_host_with_host_msm(monkeypatch):
    """n = 16, its round scalars, coefficient updates and folds on the CPU
    tensors, with ``msm_device`` replaced by exact host arithmetic (the
    JAX package's own ``tests/test_device_ipp_plumbing.py`` does the same;
    the MSM itself is held to the JAX package in ``test_torch_msm.py``)."""
    calls = []
    monkeypatch.setattr(msm, "msm_device", lambda s, p, c=None: calls.append(s.shape[-1]) or _host_msm_device(s, p))
    proof, state, _ = port_ipp(16, ipp._create_device)
    j_proof, j_state = jax_ipp(16, jipp._create_host)
    assert proof.to_bytes() == j_proof.to_bytes()
    assert state == j_state
    assert calls == [17] * 8


def test_create_host_folding_matches_jax():
    proof, state, _ = port_ipp(16, ipp._create_host_folding)
    j_proof, j_state = jax_ipp(16, jipp._create_host_folding)
    assert proof.to_bytes() == j_proof.to_bytes()
    assert state == j_state
    assert pinned.ipp_digest(proof, state) == pinned.IPP_DIGESTS[16]


def test_verify_takes_point_tensors():
    """The same proof verifies with G and H as host lists and as point
    tensors; the tampered copies the card phase uses raise both ways."""
    n = 8
    proof, _, inp = port_ipp(n)
    P = StarkPoint.msm(inp["a"] + inp["b"] + [port.inner_product(inp["a"], inp["b"])],
                       inp["G"] + [h * f for h, f in zip(inp["H"], inp["H_factors"])] + [inp["Q"]])
    tensors = {k: torch.as_tensor(curve_t.points_from_host(inp[k])) for k in ("G", "H")}
    bumped = InnerProductProof(proof.L_vec, proof.R_vec, proof.a + 1, proof.b)
    swapped = InnerProductProof([proof.R_vec[0]] + proof.L_vec[1:], [proof.L_vec[0]] + proof.R_vec[1:],
                                proof.a, proof.b)
    for G, H in ((inp["G"], inp["H"]), (tensors["G"], tensors["H"])):
        run = lambda pr: pr.verify(n, HashChainTranscript(pinned.IPP_LABEL), inp["G_factors"], inp["H_factors"],
                                   P, inp["Q"], G, H, device="cpu")
        run(proof)
        for bad in (bumped, swapped):
            with pytest.raises(VerificationError):
                run(bad)


def test_msm_pair_and_split_match_jax_host():
    n = 20
    rng = random.Random(2121)
    sA, sB = ([rng.getrandbits(251) for _ in range(n)] for _ in range(2))
    kA, kB = ([rng.getrandbits(200) for _ in range(n)] for _ in range(2))
    sA[0], sB[1] = 0, port.R - 1
    pA, pB = _port_points(kA), _port_points(kB)
    pA[2] = StarkPoint.identity()
    t = lambda pts: torch.as_tensor(curve_t.points_from_host(pts))
    w = lambda vals: torch.as_tensor(ints_to_words(vals))
    jmsm_host = lambda s, pts: JPoint.msm([JScalar(v) for v in s],
                                          [JPoint.from_bytes(p.to_bytes()) for p in pts]).to_bytes()

    c = msm.select_window(n)
    pair = curve_t.points_to_host(msm.msm_device_pair(w(sA), t(pA), w(sB), t(pB), c))
    assert [p.to_bytes() for p in pair] == [jmsm_host(sA, pA), jmsm_host(sB, pB)]
    split = curve_t.points_to_host(msm.msm_device_split(w(sA), msm.split_points_device(t(pA)))[..., None])
    assert [p.to_bytes() for p in split] == [jmsm_host(sA, pA)]

    # c = 9 fills the top window of 252 bits (28 x 9): both packages' guards refuse it
    with pytest.raises(ValueError):
        msm.msm_device_pair(w(sA), t(pA), w(sB), t(pB), 9)
    j = lambda vals: cj.scalars_from_host([JScalar(v) for v in vals])
    jp = lambda pts: cj.points_from_host([JPoint.from_bytes(p.to_bytes()) for p in pts])
    with pytest.raises(ValueError):
        jmsm.msm_device_pair(j(sA), jp(pA), j(sB), jp(pB), 9, 252)


def test_profiling_counts_r1cs_prove_once():
    """A k = 2 shuffle proof opens the ``r1cs.prove`` span once, in both
    packages (the JAX package's native engine also counts its
    ``native.msm_points``, which the port leaves out); disabled, nothing
    is counted."""
    gens = BulletproofGens(4, 1, device="cpu")
    try:
        for prof, prove in ((profiling, lambda: port_shuffle(2, gens)), (jprofiling, lambda: jax_shuffle(2))):
            prof.reset()
            prof.enable()
            prove()
            prof.disable()
            snap = prof.snapshot()
            assert snap["counts"]["r1cs.prove"] == 1
            assert prof is jprofiling or snap["counts"] == {"r1cs.prove": 1}
            assert snap["times_ms"]["r1cs.prove"] > 0
            assert "r1cs.prove" in prof.report()
            prof.reset()
            prove()
            assert prof.snapshot() == {"counts": {}, "times_ms": {}}
    finally:
        for prof in (profiling, jprofiling):
            prof.disable()
            prof.reset()


def test_host_names_match_jax():
    chain, j_chain = GeneratorsChain(b"test"), jgens.GeneratorsChain(b"test")
    assert [p.to_bytes() for p in chain.take(4, device="cpu")] == [p.to_bytes() for p in j_chain.take(4)]
    chain.fast_forward(3)
    j_chain.fast_forward(3)
    assert [int(s) for s in chain.take_scalars(2)] == [int(s) for s in j_chain.take_scalars(2)]
    assert int(chain.next_scalar()) == int(j_chain.next_scalar())

    x = Scalar(0x1234567)
    it, j_it = exp_iter(x), jfield.exp_iter(JScalar(0x1234567))
    assert [int(next(it)) for _ in range(6)] == [int(next(j_it)) for _ in range(6)]
    assert int(scalar_exp_vartime(x, 77)) == int(jfield.scalar_exp_vartime(JScalar(0x1234567), 77))
    assert [int(s) for s in scalars_from_ints([0, 5, port.R + 3])] == [0, 5, 3]
    assert port.random_point(random.Random(7)).to_bytes() == j_random_point(random.Random(7)).to_bytes()

    pc = PedersenGens()
    v, b = Scalar(11), Scalar(13)
    assert pc.commit_shared(v, b) == pc.commit(v, b)
    gens = BulletproofGens(4, 2, device="cpu")
    assert [p.to_bytes() for p in gens.as_mpc_values().G(4)] == [p.to_bytes() for p in gens.share(0).G(4)]

    import mpc_bulletproof_tpu as jroot
    for name in ("P", "R", "SCALAR_BYTES", "STARK_POINT_BYTES"):
        assert getattr(port, name) == getattr(jroot, name)
    a, bb = [Scalar(3), Scalar(4)], [Scalar(5), Scalar(6)]
    assert int(port.inner_product(a, bb)) == int(j_inner_product([JScalar(3), JScalar(4)], [JScalar(5), JScalar(6)]))
    assert int(port.hash_to_scalar(b"\x07" * 32)) == int(j_hash_to_scalar(b"\x07" * 32))
    assert {n for n in dir(port.errors) if n.endswith("Error")} == {n for n in dir(jerrors) if n.endswith("Error")}
