"""The port's aggregated range prover against the JAX package's host
party/dealer path: the same blinding stream gives the same proof bytes,
value commitments and final transcript state.  Also the generators, the
pinned digests that chip_smoke.py holds the card to, and the port's
isolation from JAX."""

import ast
import os
import pathlib

import pytest
import torch


from mpc_bulletproof_tpu import BulletproofGens as JGens
from mpc_bulletproof_tpu import HashChainTranscript as JTranscript
from mpc_bulletproof_tpu import PedersenGens as JPedersen
from mpc_bulletproof_tpu import Scalar as JScalar
from mpc_bulletproof_tpu.models.range_proof.dealer import Dealer as JDealer
from mpc_bulletproof_tpu.models.range_proof.party import Party as JParty
from mpc_bulletproof_tpu.ops import curve_jax as cj
from mpc_bulletproof_tpu_torch import (BulletproofGens, HashChainTranscript, PedersenGens,
                                       RangeProof, convert, pinned)
from mpc_bulletproof_tpu_torch import generators
from mpc_bulletproof_tpu_torch.utils.errors import MPCError

# Under pytest-xdist several worker processes share the cores: split them,
# or torch's default of one intra-op thread per core in every worker
# oversubscribes the machine.
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ROOT = pathlib.Path(__file__).resolve().parent.parent


def jax_host_prove(n: int, m: int):
    """The JAX package's party/dealer flow on the pinned inputs, drawing the
    blinding stream in the fused prover's order (party-major phases)."""
    values, blindings = pinned.inputs(n, m)
    rng_bytes = pinned.det_stream()
    bp_gens, pc_gens = JGens(n, m), JPedersen()
    transcript = JTranscript(pinned.TRANSCRIPT_LABEL)
    dealer = JDealer.new(bp_gens, pc_gens, transcript, n, m)
    parties = [JParty.new(bp_gens, pc_gens, v, JScalar(int(b)), n) for v, b in zip(values, blindings)]
    positioned, bit_comms = [], []
    for j, p in enumerate(parties):
        st, bc = p.assign_position(j, rng_bytes=rng_bytes)
        positioned.append(st)
        bit_comms.append(bc)
    dealer, bit_challenge = dealer.receive_bit_commitments(bit_comms)
    polied, poly_comms = [], []
    for p in positioned:
        st, pc = p.apply_challenge(bit_challenge)
        polied.append(st)
        poly_comms.append(pc)
    dealer, poly_challenge = dealer.receive_poly_commitments(poly_comms)
    proof = dealer.receive_trusted_shares([p.apply_challenge(poly_challenge) for p in polied])
    return proof, [bc.V_j for bc in bit_comms], transcript.state, bp_gens


@pytest.fixture(scope="module")
def port_82():
    """Generators and one proof of the port at (n, m) = (8, 2) on the CPU."""
    n, m = 8, 2
    bp_gens, pc_gens = BulletproofGens(n, m, device="cpu"), PedersenGens()
    values, blindings = pinned.inputs(n, m)
    tr = HashChainTranscript(pinned.TRANSCRIPT_LABEL)
    proof, V = RangeProof.prove_multiple(bp_gens, pc_gens, tr, values, blindings, n,
                                         device="cpu", rng_bytes=pinned.det_stream())
    return bp_gens, proof, V, tr.state


def test_slice_matches_jax_host_path(port_82):
    _, proof, V, state = port_82
    j_proof, j_V, j_state, _ = jax_host_prove(8, 2)
    assert [v.to_bytes() for v in V] == [v.to_bytes() for v in j_V]
    assert proof.to_bytes() == j_proof.to_bytes()
    assert state == j_state
    assert RangeProof.from_bytes(proof.to_bytes()).to_bytes() == proof.to_bytes()
    assert len(proof.to_bytes()) == proof.serialized_size() == (9 + 2 * 4) * 32


def test_generators_match_jax(port_82):
    bp_gens = port_82[0]
    j_gens = jax_host_prove(8, 2)[3]
    for mine, theirs in ((bp_gens.G(8, 2), j_gens.G(8, 2)), (bp_gens.H(8, 2), j_gens.H(8, 2))):
        assert [(p.x, p.y) for p in mine] == [(p.x, p.y) for p in theirs]
    # the device tensors the prover caches equal the JAX package's arrays, carried across
    G_dev, H_dev = generators.device_gens(bp_gens, 8, 2, torch.device("cpu"))
    assert torch.equal(G_dev, convert.points_from_jax(cj.points_from_host(j_gens.G(8, 2)), device="cpu"))
    assert torch.equal(H_dev, convert.points_from_jax(cj.points_from_host(j_gens.H(8, 2)), device="cpu"))


@pytest.mark.parametrize("n,m", sorted(pinned.DIGESTS))
def test_pinned_digest_is_the_jax_host_digest(n, m):
    """chip_smoke.py holds the card's (64, 64) proof to this digest."""
    proof, V, state, _ = jax_host_prove(n, m)
    assert pinned.proof_digest(proof, V, state) == pinned.DIGESTS[(n, m)]


def test_port_digest_at_8_2(port_82):
    _, proof, V, state = port_82
    assert pinned.proof_digest(proof, V, state) == pinned.DIGESTS[(8, 2)]


def test_entry_checks_and_no_card(monkeypatch, port_82):
    bp_gens = port_82[0]
    pc = PedersenGens()
    values, blindings = pinned.inputs(8, 2)
    prove = lambda vals, n, **kw: RangeProof.prove_multiple(
        bp_gens, pc, HashChainTranscript(b"x"), vals, blindings[: len(vals)], n, **kw)
    with pytest.raises(MPCError):
        prove([1, 300], 8, device="cpu")          # value out of range
    with pytest.raises(MPCError):
        prove(values, 6, device="cpu")            # bitsize not a power of two
    with pytest.raises(MPCError):
        prove(values, 16, device="cpu")           # beyond the generators' capacity
    # without a card the default device raises instead of running on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        prove(values, 8)
    with pytest.raises(RuntimeError):
        BulletproofGens(8, 1)


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_port_never_imports_jax_or_the_jax_package():
    """Every import statement of every port module and of chip_smoke.py
    (function-level ones included) names neither jax nor the JAX package."""
    files = sorted((ROOT / "mpc_bulletproof_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 25
    names = {f.relative_to(ROOT).as_posix() for f in files}
    for module in ("ops/probes.py", "ops/poly.py", "models/r1cs/prover.py", "models/r1cs/verifier.py",
                   "models/r1cs/proof.py", "models/r1cs/gadgets.py", "models/r1cs/constraint_system.py",
                   "models/r1cs/linear_combination.py", "parallel/network.py", "parallel/beaver.py",
                   "parallel/fabric.py", "parallel/device_shares.py", "models/r1cs_mpc/__init__.py",
                   "models/r1cs_mpc/authenticated_poly.py", "models/r1cs_mpc/mpc_constraint_system.py",
                   "models/r1cs_mpc/mpc_inner_product.py", "models/r1cs_mpc/mpc_linear_combination.py",
                   "models/r1cs_mpc/mpc_prover.py", "models/r1cs_mpc/proof.py",
                   "models/range_proof/party.py", "models/range_proof/dealer.py",
                   "models/range_proof/messages.py", "integration/__init__.py", "integration/main.py",
                   "integration/launch.py", "ops/fold.py", "utils/profiling.py", "generators.py",
                   "ops/keccak_t.py", "ops/kernels.py", "ops/transcript_t.py", "ops/curve_t.py", "pinned.py",
                   "parallel/sharded.py"):
        assert f"mpc_bulletproof_tpu_torch/{module}" in names
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "mpc_bulletproof_tpu"), (f, name)


@pytest.mark.cuda
def test_card_proof_matches_pinned_digest():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py proves (64, 64) there)")
    n, m = 8, 2
    bp_gens, pc_gens = BulletproofGens(n, m), PedersenGens()
    values, blindings = pinned.inputs(n, m)
    tr = HashChainTranscript(pinned.TRANSCRIPT_LABEL)
    proof, V = RangeProof.prove_multiple(bp_gens, pc_gens, tr, values, blindings, n,
                                         rng_bytes=pinned.det_stream())
    assert pinned.proof_digest(proof, V, tr.state) == pinned.DIGESTS[(n, m)]
