"""The transcript's keccak kernel and the warp-a-chain ``keccak_chain`` on
the card, without JAX (this file imports only torch and the port, so it
also runs on a machine with a card and no JAX: ``python3 -m pytest
--noconftest tests/test_torch_transcript_card.py``):
``kernels.keccak_transcript`` against its plain version byte for byte over
total lengths 32 to 135 and runs of 1, 2, 3 and 64 absorbs with and
without the closing challenge, ``keccak_chain`` against its plain walk,
and the (8, 2) fused range proof, whose transcript runs on the kernel,
against ``pinned.DIGESTS``.  Skips without a card; ``chip_smoke.py``'s
``transcript`` and ``gens`` phases run the same checks at the paths'
sizes."""

import pytest
import torch

from mpc_bulletproof_tpu_torch import BulletproofGens, HashChainTranscript, PedersenGens, RangeProof, pinned
from mpc_bulletproof_tpu_torch.ops import keccak_t, kernels
from mpc_bulletproof_tpu_torch.ops import transcript_t as tj

LENGTHS = (32, 33, 64, 72, 96, 128, 134, 135)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py's transcript and gens phases run these there)")
    return torch.device("cuda")


def _gen(card, seed: int) -> torch.Generator:
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    return gen


def _blocks(card, gen, lengths) -> torch.Tensor:
    """Padded blocks of the given total lengths: random bytes below each
    (bytes 0-31 too, which the kernel must not read), 0x01 at it, 0x80
    or'ed into byte 135."""
    rows = torch.randint(0, 256, (len(lengths), 136), generator=gen, device=card, dtype=torch.int64)
    col = torch.arange(136, device=card)
    total = torch.as_tensor(list(lengths), device=card)[:, None]
    rows = torch.where(col < total, rows, 0) | torch.where(col == total, 0x01, 0)
    rows[:, 135] |= 0x80
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("high", [False, True])
@pytest.mark.parametrize("run", [(n,) for n in LENGTHS] + [LENGTHS[:2], LENGTHS[:3],
                                                            tuple(LENGTHS[i % 8] for i in range(64))])
def test_card_keccak_transcript_equals_its_plain_version(card, run, high):
    gen = _gen(card, len(run) * 1000 + run[0])
    state = torch.randint(0, 256, (32,), generator=gen, device=card, dtype=torch.int64)
    blocks = _blocks(card, gen, run)
    kernels.reset_launches()
    got = kernels.keccak_transcript(state, blocks, high)
    torch.cuda.synchronize()
    assert kernels.launches["keccak_transcript"] == 1
    assert got.shape == (64 if high else 32,)
    assert torch.equal(got, keccak_t.keccak_transcript_plain(state, blocks, high))


@pytest.mark.cuda
def test_card_absorb_many_equals_the_cpu_run(card):
    gen = _gen(card, 7)
    state = torch.randint(0, 256, (32,), generator=gen, device=card, dtype=torch.int64)
    enc = torch.randint(0, 256, (64, 2), generator=gen, device=card, dtype=torch.int64)
    s_card, u_card = tj.absorb_many(state, [b"L", b"R"], enc, b"u")
    s_cpu, u_cpu = tj.absorb_many(state.cpu(), [b"L", b"R"], enc.cpu(), b"u")
    assert torch.equal(s_card.cpu(), s_cpu) and torch.equal(u_card.cpu(), u_cpu)
    with pytest.raises(ValueError, match="135"):
        tj.absorb_many(state, [b"x"], enc.new_zeros((72, 1)))


@pytest.mark.cuda
@pytest.mark.parametrize("chains, skip, count", [(2, 0, 256), (128, 64, 64), (33, 3, 1)])
def test_card_warp_keccak_chain_equals_its_plain_walk(card, chains, skip, count):
    starts = torch.randint(0, 256, (chains, 32), generator=_gen(card, chains + skip), device=card,
                           dtype=torch.uint8)
    got = kernels.keccak_chain(starts, skip, count)
    torch.cuda.synchronize()
    assert torch.equal(got, keccak_t.keccak_chain_plain(starts, skip, count))


@pytest.mark.cuda
def test_card_fused_proof_digest_runs_on_the_transcript_kernel(card):
    n, m = 8, 2
    gens, pc = BulletproofGens(n, m, device=card), PedersenGens()
    values, blindings = pinned.inputs(n, m)
    t = HashChainTranscript(pinned.TRANSCRIPT_LABEL)
    kernels.reset_launches()
    proof, V = RangeProof.prove_multiple(gens, pc, t, values, blindings, n, rng_bytes=pinned.det_stream())
    # V, A S y, z, T x, the scalars and w, dom-sep and n, 4 IPP rounds
    assert kernels.launches["keccak_transcript"] == 10
    assert pinned.proof_digest(proof, V, t.state) == pinned.DIGESTS[(n, m)]
