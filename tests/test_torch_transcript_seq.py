"""The transcript kernel's plain version against the JAX package, on the CPU.

``transcript_t.absorb_many`` hashes a run of absorbs, and a closing
challenge, with one ``kernels.keccak_transcript`` call; on CPU tensors the
wrapper runs its plain version, ``keccak_t.keccak_transcript_plain``.  Here
a run of 1 and of 64 absorbs, then a challenge, at total lengths (state,
label and message) of 32, 64, 128 and 135 bytes goes through it and
through the JAX package's ``ops/transcript_jax.py`` (``absorb``, one jit
compile per length, shared by both runs; ``challenge_scalar``, one
compile) and its host ``HashChainTranscript``, from the same numpy bytes:
states and challenges equal byte for byte.  Then the refusal above 135 bytes, the
wrapper's operand checks, and that a CUDA tensor goes to the kernel's
launch with no fallback.  The kernel itself is held to the plain version on
the card (``tests/test_torch_transcript_card.py``, ``chip_smoke.py``'s
``transcript`` phase)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_bulletproof_tpu import transcript as jtranscript
from mpc_bulletproof_tpu.ops import limb as jlimb
from mpc_bulletproof_tpu.ops import transcript_jax as tjax
from mpc_bulletproof_tpu_torch.ops import keccak_t, kernels
from mpc_bulletproof_tpu_torch.ops import transcript_t as tj
from mpc_bulletproof_tpu_torch.ops.limb import words_to_ints

torch.set_num_threads(1)

# total length -> (label, message length): 32 + len(pad_label(label)) + message
LAYOUTS = {32: (b"", 0), 64: (b"dom-sep", 0), 128: (b"L", 64), 135: (b"n", 71)}


@functools.lru_cache(maxsize=None)
def _jax_absorb(label: bytes, msg_len: int):
    return jax.jit(lambda state, msg: tjax.absorb(state, label, msg, msg_len))


@functools.lru_cache(maxsize=None)
def _jax_challenge(label: bytes):
    return jax.jit(lambda state: tjax.challenge_scalar(state, label))


def _as_jax(b: np.ndarray):
    return jnp.asarray(b.astype(np.uint32))


@pytest.mark.parametrize("total", sorted(LAYOUTS))
def test_absorb_run_and_challenge_match_jax_device_and_host(total):
    """Each absorb against ``transcript_jax.absorb`` and the host
    transcript, the closing challenge against the host transcript (the
    next test holds the host's challenge to ``transcript_jax``'s)."""
    label, msg_len = LAYOUTS[total]
    rng = np.random.default_rng(total)
    start = rng.integers(0, 256, 32, dtype=np.uint8)
    for run in (1, 64):
        msgs = rng.integers(0, 256, (msg_len, run), dtype=np.uint8)
        state, u = tj.absorb_many(torch.as_tensor(start.astype(np.int64)), [label] * run,
                                  torch.as_tensor(msgs.astype(np.int64)), b"u")
        host = jtranscript.HashChainTranscript()
        host.state = bytes(start)
        state_j = _as_jax(start)
        for i in range(run):
            host.append_message(label, bytes(msgs[:, i]))
            state_j = _jax_absorb(label, msg_len)(state_j, _as_jax(msgs[:, i]))
        assert bytes(np.asarray(state_j).astype(np.uint8)) == host.state
        want_u = host.challenge_scalar(b"u")
        assert bytes(state.tolist()) == host.state
        assert words_to_ints(u) == [int(want_u)]


def test_challenge_matches_jax_device_and_host():
    """A challenge after a 64-absorb run of 128-byte absorbs (the V run's
    shape): state and scalar against ``transcript_jax.challenge_scalar``
    and the host transcript (one jit compile of the challenge)."""
    rng = np.random.default_rng(64)
    start = rng.integers(0, 256, 32, dtype=np.uint8)
    msgs = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    state, u = tj.absorb_many(torch.as_tensor(start.astype(np.int64)), [b"V"] * 64,
                              torch.as_tensor(msgs.astype(np.int64)), b"y")
    host = jtranscript.HashChainTranscript()
    host.state = bytes(start)
    for i in range(64):
        host.append_message(b"V", bytes(msgs[:, i]))
    state_j, u_j = _jax_challenge(b"y")(_as_jax(np.frombuffer(host.state, np.uint8)))
    want_u = host.challenge_scalar(b"y")
    assert bytes(state.tolist()) == bytes(np.asarray(state_j).astype(np.uint8)) == host.state
    assert words_to_ints(u) == jlimb.limbs_to_ints(np.asarray(u_j)) == [int(want_u)]


def test_run_of_absorbs_is_the_absorbs_one_by_one():
    """``absorb_many`` over host constants, over device columns, and
    ``absorb`` / ``challenge_scalar`` one at a time give the same states."""
    rng = np.random.default_rng(5)
    state = torch.as_tensor(rng.integers(0, 256, 32).astype(np.int64))
    cols = torch.as_tensor(rng.integers(0, 256, (32, 3)).astype(np.int64))
    labels = [b"t_x", b"t_x_blinding", b"e_blinding"]
    got, u = tj.absorb_many(state, labels, cols, b"w")
    consts, _ = tj.absorb_many(state, labels, [bytes(cols[:, i].tolist()) for i in range(3)])
    one = state
    for i, lbl in enumerate(labels):
        one = tj.absorb(one, lbl, cols[:, i])
    assert torch.equal(consts, one)
    one, u1 = tj.challenge_scalar(one, b"w")
    assert torch.equal(got, one) and torch.equal(u, u1)


def test_longer_than_one_block_is_refused_by_both_packages():
    state = torch.zeros(32, dtype=torch.int64)
    with pytest.raises(ValueError, match="135"):
        tj.absorb_many(state, [b"n"], torch.zeros((72, 1), dtype=torch.int64))    # 32 + 32 + 72 = 136
    with pytest.raises(ValueError, match="135"):
        tj.absorb(state, b"n", torch.zeros(72, dtype=torch.int64))
    with pytest.raises(ValueError):
        tjax.absorb(jnp.zeros(32, jnp.uint32), b"n", jnp.zeros(72, jnp.uint32), 72)


def test_keccak_transcript_checks_its_operands():
    state, blocks = torch.zeros(32, dtype=torch.int64), torch.zeros((2, 136), dtype=torch.int64)
    with pytest.raises(TypeError, match="int64"):
        kernels.keccak_transcript(state.to(torch.uint8), blocks, False)
    with pytest.raises(ValueError, match=r"\(32,\)"):
        kernels.keccak_transcript(torch.zeros(31, dtype=torch.int64), blocks, False)
    with pytest.raises(ValueError, match=r"\(j, 136\)"):
        kernels.keccak_transcript(state, torch.zeros((2, 135), dtype=torch.int64), False)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.keccak_transcript(state, torch.zeros((136, 2), dtype=torch.int64).T, False)
    with pytest.raises(ValueError, match="one message a label"):
        tj.absorb_many(state, [b"a", b"b"], [b"x"])
    assert kernels.keccak_transcript(state, blocks[:0], False).shape == (32,)
    assert torch.equal(kernels.keccak_transcript(state, blocks[:0], True)[:32], state)


def test_keccak_transcript_launches_for_card_tensors(monkeypatch):
    """On a card tensor the wrapper launches the kernel (recorded here with
    the device check patched) with the entry point's arguments, and never
    runs the plain version; ``absorb_many`` makes one call a run."""
    calls = []
    monkeypatch.setattr(kernels, "_check", lambda t, what, shape=None, lead=None: "cuda")
    monkeypatch.setattr(kernels, "_launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(kernels, "keccak_transcript_plain",
                        lambda *a: pytest.fail("the plain version ran for a card tensor"))
    state, blocks = torch.zeros(32, dtype=torch.int64), torch.zeros((3, 136), dtype=torch.int64)
    out = kernels.keccak_transcript(state, blocks, True)
    assert out.shape == (64,)
    assert calls == [("keccak_transcript", (state.data_ptr(), blocks.data_ptr(), 3, 1, out.data_ptr()))]
    assert kernels.KERNELS["keccak_transcript"][0] == "keccak.cu"

    runs = []
    monkeypatch.setattr(kernels, "keccak_transcript",
                        lambda s, b, high: runs.append((tuple(b.shape), high)) or s.new_zeros(64 if high else 32))
    tj.absorb_many(state, [b"L", b"R"], torch.zeros((64, 2), dtype=torch.int64), b"u")
    tj.absorb_many(state, [b"dom-sep", b"n"], [bytes(32), bytes(8)])
    assert runs == [((3, 136), True), ((2, 136), False)]


def test_plain_transcript_run_pads_like_keccak256():
    """The run's blocks carry the padding the template gives them: one block
    at 135 bytes (0x81 in its last byte) hashes as ``keccak256`` of the same
    135 bytes."""
    rng = np.random.default_rng(135)
    data = torch.as_tensor(rng.integers(0, 256, 135).astype(np.int64))
    block = torch.cat([data, torch.tensor([0x81])])
    assert torch.equal(keccak_t.keccak_transcript_plain(data[:32], block[None], False),
                       keccak_t.keccak256(data, 135))
