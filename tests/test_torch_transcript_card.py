"""The transcript's keccak kernel and the warp-a-chain ``keccak_chain`` on
the card, without JAX (this file imports only torch and the port, so it
also runs on a machine with a card and no JAX: ``python3 -m pytest
--noconftest tests/test_torch_transcript_card.py``):
``kernels.keccak_transcript`` against its plain version, states and
challenges word for word, over runs of 1, 2, 3 and 64 absorbs of every
word length a block holds, with challenges after them, between them and
none, and several transcripts a launch; the verifiers' replay on the
kernel; ``keccak_chain`` against its plain walk; and the (8, 2) fused range
proof, whose transcript runs on the kernel, against ``pinned.DIGESTS``.
Skips without a card; ``chip_smoke.py``'s ``transcript`` and ``gens``
phases run the same checks at the paths' sizes."""

import pytest
import torch

from mpc_bulletproof_tpu_torch import (BulletproofGens, HashChainTranscript, PedersenGens, RangeProof, pinned,
                                       transcript)
from mpc_bulletproof_tpu_torch.ops import keccak_t, kernels
from mpc_bulletproof_tpu_torch.ops import transcript_t as tj

# message words a block can hold under a 32-byte label: 0 to 8
WORDS = (0, 1, 4, 5, 8)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py's transcript and gens phases run these there)")
    return torch.device("cuda")


def _gen(card, seed: int) -> torch.Generator:
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    return gen


def _words(card, gen, *shape) -> torch.Tensor:
    return torch.randint(-(1 << 63), (1 << 63) - 1, shape, generator=gen, device=card, dtype=torch.int64)


def _steps(run, challenges: str):
    """Absorbs of ``run[i]`` words; ``challenges``: "end", "between" (after
    every absorb) or "none"."""
    steps = []
    for i, n in enumerate(run):
        steps.append((b"m%d" % i, n))
        if challenges == "between":
            steps.append((b"c%d" % i, None))
    return steps + ([(b"end", None)] if challenges == "end" else [])


@pytest.mark.cuda
@pytest.mark.parametrize("challenges", ["end", "between", "none"])
@pytest.mark.parametrize("run", [(n,) for n in WORDS] + [WORDS[:2], WORDS[:3],
                                                         tuple(WORDS[i % 5] for i in range(64))])
def test_card_keccak_transcript_equals_its_plain_version(card, run, challenges):
    gen = _gen(card, len(run) * 1000 + run[0])
    steps = _steps(run, challenges)
    plan = tj._plan(tuple(steps), card)
    for transcripts in (1, 3):
        starts, msgs = _words(card, gen, transcripts, 4), _words(card, gen, transcripts, plan.words)
        kernels.reset_launches()
        got = kernels.keccak_transcript(starts, plan, msgs)
        torch.cuda.synchronize()
        assert kernels.launches["keccak_transcript"] == 1
        want = keccak_t.keccak_transcript_plain(starts, plan.template, plan.layout, msgs, plan.challenges)
        assert got[0].shape == (transcripts, 4) and got[1].shape == (transcripts, 4, plan.challenges)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_card_absorb_many_equals_the_cpu_run(card):
    gen = _gen(card, 7)
    state, enc = _words(card, gen, 4), _words(card, gen, 16)
    steps = [(b"L", 8), (b"R", 8), (b"u", None)]
    s_card, u_card = tj.absorb_many(state, steps, enc)
    s_cpu, u_cpu = tj.absorb_many(state.cpu(), steps, enc.cpu())
    assert torch.equal(s_card.cpu(), s_cpu) and torch.equal(u_card.cpu(), u_cpu)
    with pytest.raises(ValueError, match="135"):
        tj.absorb_many(state, [(b"x", 9)], enc[:9])
    runs = [[(b"t_x", bytes(range(32))), (b"w", None)], [(b"t_x", bytes(32)), (b"w", None)]]
    on_card = [HashChainTranscript(b"a"), HashChainTranscript(b"b")]
    on_cpu = [HashChainTranscript(b"a"), HashChainTranscript(b"b")]
    kernels.reset_launches()
    got = transcript.replay(on_card, runs, card)
    assert kernels.launches["keccak_transcript"] == 1
    assert got == transcript.replay(on_cpu, runs, torch.device("cpu"))
    assert [t.state for t in on_card] == [t.state for t in on_cpu]


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
    # V A S y z, T x, the scalars w and the IPP's domain, 4 IPP rounds
    assert kernels.launches["keccak_transcript"] == 7
    assert pinned.proof_digest(proof, V, t.state) == pinned.DIGESTS[(n, m)]
    kernels.reset_launches()
    proof.verify_multiple(gens, pc, HashChainTranscript(pinned.TRANSCRIPT_LABEL), V, n)
    assert kernels.launches["keccak_transcript"] == 1
