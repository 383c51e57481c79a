"""The generator chains' keccak kernels on the card, without JAX (this file
imports only torch and the port, so it also runs on a machine with a card
and no JAX): ``keccak_chain`` and ``keccak256_32`` against their plain
versions byte for byte, ``BulletproofGens`` against ``pinned.GENS_DIGESTS``
(host lists and device tensors), and config 1 and config 2 at m = 1
against ``pinned.DIGESTS`` (too slow on the CPU's plain kernels).  Skips
without a card; ``chip_smoke.py``'s ``gens`` and ``rp_sweep`` phases run
the same checks at the benchmark sizes."""

import pytest
import torch

from mpc_bulletproof_tpu_torch import (BulletproofGens, HashChainTranscript, PedersenGens, RangeProof,
                                       generators, pinned)
from mpc_bulletproof_tpu_torch.ops import curve_t, keccak_t, kernels


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py's gens and rp_sweep phases run these there)")
    return torch.device("cuda")


def _rows(card, k: int, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    return torch.randint(0, 256, (k, 32), generator=gen, device=card, dtype=torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("chains, skip, count", [(2, 0, 256), (128, 64, 64), (33, 3, 1), (1, 0, 0)])
def test_card_keccak_chain_equals_its_plain_version(card, chains, skip, count):
    starts = _rows(card, chains, chains + skip)
    got = kernels.keccak_chain(starts, skip, count)
    torch.cuda.synchronize()
    assert torch.equal(got, keccak_t.keccak_chain_plain(starts, skip, count))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 129, 1 << 14])
def test_card_keccak256_32_equals_its_plain_version(card, n):
    msgs = _rows(card, n, n)
    got = kernels.keccak256_32(msgs)
    torch.cuda.synchronize()
    assert torch.equal(got, keccak_t.keccak256_32_plain(msgs))


@pytest.mark.cuda
def test_card_keccak_wrappers_refuse_unaligned_rows(card):
    buf = torch.zeros(8 * 32 + 1, dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="aligned"):
        kernels.keccak256_32(buf[1:].reshape(8, 32))


@pytest.mark.cuda
@pytest.mark.parametrize("key", [(64, 1), (8, 1)])
def test_card_gens_give_the_pinned_digest(card, key):
    n, m = key
    kernels.reset_launches()
    gens = BulletproofGens(n, m, device=card)
    assert kernels.launches["keccak_chain"] == 1 and kernels.launches["keccak256_32"] == 1
    assert pinned.gens_digest(gens.G(n, m), gens.H(n, m)) == pinned.GENS_DIGESTS[key]
    G, H = generators.device_gens(gens, n, m, card)
    assert pinned.gens_digest(curve_t.points_to_host(G), curve_t.points_to_host(H)) == pinned.GENS_DIGESTS[key]


@pytest.mark.cuda
def test_card_config1_and_m1_give_the_pinned_digests(card):
    gens, pc = BulletproofGens(64, 1, device=card), PedersenGens()
    for key, (values, blindings) in (((32, 1), pinned.single_inputs()), ((64, 1), pinned.inputs(64, 1))):
        t = HashChainTranscript(pinned.TRANSCRIPT_LABEL)
        proof, V = RangeProof.prove_multiple(gens, pc, t, values, blindings, key[0],
                                             rng_bytes=pinned.det_stream())
        assert pinned.proof_digest(proof, V, t.state) == pinned.DIGESTS[key]
        proof.verify_multiple(gens, pc, HashChainTranscript(pinned.TRANSCRIPT_LABEL), V, key[0])
