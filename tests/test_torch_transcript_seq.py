"""The transcript kernel's plain version against the JAX package, on the CPU.

``transcript_t.absorb_many`` hashes a run of absorbs and challenges with
one ``kernels.keccak_transcript`` call; on CPU tensors the wrapper runs its
plain version, ``keccak_t.keccak_transcript_plain``.  Here a run of 1 and
of 64 absorbs, then a challenge, at total lengths (state, label and
message words) of 32, 64, 72 and 128 bytes goes through it and through the
JAX package's ``ops/transcript_jax.py`` (``absorb``, one jit compile per
length, shared by both runs; ``challenge_scalar``, one compile) and its
host ``HashChainTranscript``, from the same numpy words: states and
challenges equal.  Then the refusals (a block past 135 bytes, a message
that is not whole words), the wrapper's operand checks, and that a CUDA
tensor goes to the kernel's launch with no fallback.  The kernel itself is
held to the plain version on the card
(``tests/test_torch_transcript_card.py``, ``chip_smoke.py``'s
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

# total length -> (label, message words): 32 + len(pad_label(label)) + 8 words
LAYOUTS = {32: (b"", 0), 64: (b"dom-sep", 0), 72: (b"n", 1), 128: (b"L", 8)}


@functools.lru_cache(maxsize=None)
def _jax_absorb(label: bytes, msg_len: int):
    return jax.jit(lambda state, msg: tjax.absorb(state, label, msg, msg_len))


@functools.lru_cache(maxsize=None)
def _jax_challenge(label: bytes):
    return jax.jit(lambda state: tjax.challenge_scalar(state, label))


def _as_jax(b: np.ndarray):
    return jnp.asarray(b.astype(np.uint32))


def _words(rng, *shape) -> np.ndarray:
    return rng.integers(-(1 << 63), 1 << 63, shape, dtype=np.int64)


def _bytes(words: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(words).astype("<i8").view(np.uint8)


@pytest.mark.parametrize("total", sorted(LAYOUTS))
def test_absorb_run_and_challenge_match_jax_device_and_host(total):
    """Each absorb against ``transcript_jax.absorb`` and the host
    transcript, the closing challenge against the host transcript (the
    next test holds the host's challenge to ``transcript_jax``'s)."""
    label, n_words = LAYOUTS[total]
    rng = np.random.default_rng(total)
    start = _words(rng, 4)
    for run in (1, 64):
        msgs = _words(rng, run, n_words)
        state, u = tj.absorb_many(torch.as_tensor(start), [(label, n_words)] * run + [(b"u", None)],
                                  torch.as_tensor(msgs))
        host = jtranscript.HashChainTranscript()
        host.state = _bytes(start).tobytes()
        state_j = _as_jax(_bytes(start))
        for i in range(run):
            host.append_message(label, _bytes(msgs[i]).tobytes())
            state_j = _jax_absorb(label, 8 * n_words)(state_j, _as_jax(_bytes(msgs[i])))
        assert bytes(np.asarray(state_j).astype(np.uint8)) == host.state
        want_u = host.challenge_scalar(b"u")
        assert tj.state_bytes(state.numpy()) == host.state
        assert words_to_ints(u) == [int(want_u)]


def test_challenge_matches_jax_device_and_host():
    """A challenge after a 64-absorb run of 128-byte absorbs (the V run's
    shape): state and scalar against ``transcript_jax.challenge_scalar``
    and the host transcript (one jit compile of the challenge)."""
    rng = np.random.default_rng(64)
    start = _words(rng, 4)
    msgs = _words(rng, 64, 8)
    state, u = tj.absorb_many(torch.as_tensor(start), [(b"V", 8)] * 64 + [(b"y", None)], torch.as_tensor(msgs))
    host = jtranscript.HashChainTranscript()
    host.state = _bytes(start).tobytes()
    for i in range(64):
        host.append_message(b"V", _bytes(msgs[i]).tobytes())
    state_j, u_j = _jax_challenge(b"y")(_as_jax(np.frombuffer(host.state, np.uint8)))
    want_u = host.challenge_scalar(b"y")
    assert tj.state_bytes(state.numpy()) == bytes(np.asarray(state_j).astype(np.uint8)) == host.state
    assert words_to_ints(u) == jlimb.limbs_to_ints(np.asarray(u_j)) == [int(want_u)]


def test_run_of_absorbs_is_the_absorbs_one_by_one():
    """``absorb_many`` over host constants, over device words, and
    ``absorb`` / ``challenge_scalar`` one at a time give the same states."""
    rng = np.random.default_rng(5)
    state = torch.as_tensor(_words(rng, 4))
    cols = torch.as_tensor(_words(rng, 3, 4))
    labels = [b"t_x", b"t_x_blinding", b"e_blinding"]
    got, u = tj.absorb_many(state, [(lbl, 4) for lbl in labels] + [(b"w", None)], cols)
    consts, none = tj.absorb_many(state, [(lbl, _bytes(cols[i].numpy()).tobytes()) for i, lbl in enumerate(labels)])
    one = state
    for i, lbl in enumerate(labels):
        one = tj.absorb(one, lbl, cols[i])
    assert none is None and torch.equal(consts, one)
    one, u1 = tj.challenge_scalar(one, b"w")
    assert torch.equal(got, one) and torch.equal(u, u1)


def test_longer_than_one_block_is_refused_by_both_packages():
    state = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="135"):
        tj.absorb_many(state, [(b"n", 9)], torch.zeros(9, dtype=torch.int64))    # 32 + 32 + 72 = 136
    with pytest.raises(ValueError, match="135"):
        tj.absorb(state, b"n", torch.zeros(9, dtype=torch.int64))
    with pytest.raises(ValueError, match="whole 64-bit words"):
        tj.absorb_many(state, [(b"n", bytes(12))])
    with pytest.raises(ValueError):
        tjax.absorb(jnp.zeros(32, jnp.uint32), b"n", jnp.zeros(72, jnp.uint32), 72)


def _layout(*rows):
    return np.asarray(rows, dtype=np.int64).reshape(-1, 4)


def test_keccak_transcript_checks_its_operands():
    tmpl = np.zeros((2, 17), dtype=np.int64)
    plan = kernels.transcript_plan(tmpl, _layout([4, 1, 0, 0], [0, 0, 0, 1]), "cpu")
    assert (plan.words, plan.challenges) == (1, 1)
    starts, msgs = torch.zeros((1, 4), dtype=torch.int64), torch.zeros((1, 1), dtype=torch.int64)
    with pytest.raises(TypeError, match="int64"):
        kernels.keccak_transcript(starts.to(torch.uint8), plan, msgs)
    with pytest.raises(ValueError, match=r"\(T, 4\)"):
        kernels.keccak_transcript(torch.zeros((1, 3), dtype=torch.int64), plan, msgs)
    with pytest.raises(ValueError, match=r"\(J, 17\)"):
        kernels.transcript_plan(np.zeros((2, 16), dtype=np.int64), _layout([0] * 4, [0] * 4), "cpu")
    with pytest.raises(ValueError, match="contiguous"):
        kernels.keccak_transcript(starts, plan._replace(template=torch.zeros((17, 2), dtype=torch.int64).T), msgs)
    with pytest.raises(TypeError, match="TranscriptPlan"):
        kernels.keccak_transcript(starts, tuple(plan), msgs)
    with pytest.raises(ValueError, match=r"layout"):
        kernels.transcript_plan(tmpl, _layout([0] * 4), "cpu")
    with pytest.raises(ValueError, match=r"msgs"):
        kernels.keccak_transcript(starts, plan, torch.zeros((1, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match=r"msgs"):
        kernels.keccak_transcript(starts, plan, torch.zeros((2, 1), dtype=torch.int64))
    with pytest.raises(ValueError, match="shared memory"):
        kernels.transcript_plan(np.zeros((2000, 17), dtype=np.int64), np.zeros((2000, 4), dtype=np.int64), "cpu")
    with pytest.raises(ValueError, match="message words"):
        tj.absorb_many(starts[0], [(b"a", 1), (b"b", 1)], torch.zeros(1, dtype=torch.int64))
    empty = kernels.transcript_plan(tmpl[:0], _layout(), "cpu")
    out, u = kernels.keccak_transcript(starts, empty, torch.zeros((1, 0), dtype=torch.int64))
    assert torch.equal(out, starts) and u.shape == (1, 4, 0)


@pytest.mark.parametrize("row, what", [
    ([4, 1, 0, 2], "flag is 0 or 1"),
    ([4, 1, 0, -1], "flag is 0 or 1"),
    ([4, 1, 0, 1], "none at a challenge"),
    ([4, -1, 0, 0], "message words >= 0"),
    ([3, 1, 0, 0], "outside words 4-16"),
    ([16, 2, 0, 0], "outside words 4-16"),
    ([4, 1, -1, 0], "outside words 4-16"),
])
def test_transcript_plan_refuses_a_layout_the_kernel_cannot_run(row, what):
    """The layout is checked on the host, where the plan is made, so the
    kernel (which trusts it: a flag it misses leaves its side warp waiting,
    a word outside the block reads past the staged run) and the plain
    version refuse the same runs."""
    with pytest.raises(ValueError, match=what):
        kernels.transcript_plan(np.zeros((2, 17), dtype=np.int64), _layout(row, [0, 0, 0, 1]), "cpu")


def test_keccak_transcript_launches_for_card_tensors(monkeypatch):
    """On a card tensor the wrapper launches the kernel (recorded here with
    the device check patched) with the entry point's arguments, the counts
    the plan's, and never runs the plain version; ``absorb_many`` makes one
    call a run."""
    calls = []
    monkeypatch.setattr(kernels, "_check", lambda t, what, shape=None, lead=None: "cuda")
    monkeypatch.setattr(kernels, "_launch", lambda name, device, *args: calls.append((name, args)))
    monkeypatch.setattr(kernels, "keccak_transcript_plain",
                        lambda *a: pytest.fail("the plain version ran for a card tensor"))
    plan = kernels.transcript_plan(np.zeros((3, 17), dtype=np.int64),
                                   _layout([4, 8, 0, 0], [4, 8, 8, 0], [0, 0, 0, 1]), "cpu")
    starts, msgs = torch.zeros((2, 4), dtype=torch.int64), torch.zeros((2, 16), dtype=torch.int64)
    out, u = kernels.keccak_transcript(starts, plan, msgs)
    assert out.shape == (2, 4) and u.shape == (2, 4, 1)
    assert calls == [("keccak_transcript", (starts.data_ptr(), plan.template.data_ptr(), plan.layout.data_ptr(),
                                            msgs.data_ptr(), 2, 3, 16, 1, out.data_ptr(), u.data_ptr()))]
    assert kernels.KERNELS["keccak_transcript"][0] == "keccak.cu"

    runs = []
    monkeypatch.setattr(kernels, "keccak_transcript",
                        lambda s, p, m: runs.append((tuple(p.template.shape), p.layout[:, 3].tolist(),
                                                     tuple(m.shape), p.challenges))
                        or (s, s.new_zeros((s.shape[0], 4, p.challenges))))
    tj.absorb_many(starts[0], [(b"L", 8), (b"R", 8), (b"u", None)], torch.zeros(16, dtype=torch.int64))
    tj.absorb_many(starts[0], [(b"dom-sep", bytes(32)), (b"n", bytes(8))])
    assert runs == [((3, 17), [0, 0, 1], (1, 16), 1), ((2, 17), [0, 0], (1, 0), 0)]


def test_plain_transcript_run_pads_like_keccak256():
    """The run's blocks carry the padding the template gives them: one block
    of 128 bytes (0x01 and 0x80 in its last word) hashes as ``keccak256``
    of the same 128 bytes."""
    rng = np.random.default_rng(135)
    words = _words(rng, 16)
    data = torch.as_tensor(_bytes(words).astype(np.int64))
    state, _ = tj.absorb_many(torch.as_tensor(words[:4]), [(b"", 12)], torch.as_tensor(words[4:]))
    assert tj.state_bytes(state.numpy()) == bytes(keccak_t.keccak256(data, 128).tolist())


def test_every_entry_point_takes_its_argtypes():
    """Each kernel's ctypes argtypes (the stream last) are as many as its C
    entry point's parameters: a missing one passes the stream as a 32-bit
    int, which only the card would show."""
    import re

    params = {}
    for src in kernels.CSRC.glob("*.cu"):
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            params[name] = len([a for a in args.split(",") if a.strip()])
    for name, (source, symbol, argtypes) in kernels.KERNELS.items():
        assert len(argtypes) == params[symbol], name
