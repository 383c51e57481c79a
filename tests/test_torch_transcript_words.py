"""The word transcript (``ops/transcript_t.py`` on ``kernels.keccak_transcript``'s
plain version) against the JAX package, on the CPU, at tolerance 0.

Every run shape the port drives goes through ``transcript_t.absorb_many``
and through the JAX package's host ``HashChainTranscript`` from the same
numpy words: the fused prover's V run at m = 4 with A, S, y and z, an IPP
round, the three proof scalars then w and the IPP's domain, the domain
separators, challenges at several positions of one run, identity points,
and two transcripts in one call; the IPP round also through the JAX
package's ``transcript_jax.absorb`` and ``challenge_scalar``.  States are
equal byte for byte and challenges as integers.  The reduction mod r is
held at its edge values (all zeros, all 0xFF, just above and below
multiples of r, 2^251) to ``transcript_jax.bytes_to_scalar_mod_r``: the
plain version's ``limb.reduce_512`` and a Python-int transcription of the
kernel's epilogue (``csrc/keccak.cu`` ``fr_reduce_u512``, its constants
read from ``csrc/field.cuh``).  The kernel itself is held to the plain
version on the card (``tests/test_torch_transcript_card.py``,
``chip_smoke.py``'s ``transcript`` phase)."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_bulletproof_tpu import transcript as jtranscript
from mpc_bulletproof_tpu.ops import limb as jlimb
from mpc_bulletproof_tpu.ops import transcript_jax as tjax
from mpc_bulletproof_tpu_torch import transcript as ttranscript
from mpc_bulletproof_tpu_torch.constants import R
from mpc_bulletproof_tpu_torch.ops import curve_t, kernels, limb
from mpc_bulletproof_tpu_torch.ops import transcript_t as tj
from mpc_bulletproof_tpu_torch.ops.curve import StarkPoint, stark_point_to_transcript_bytes
from mpc_bulletproof_tpu_torch.ops.keccak import pad_label
from mpc_bulletproof_tpu_torch.ops.limb import words_to_ints

torch.set_num_threads(1)


def _words(rng, *shape) -> np.ndarray:
    return rng.integers(-(1 << 63), 1 << 63, shape, dtype=np.int64)


def _bytes(words) -> bytes:
    return np.ascontiguousarray(words, dtype=np.int64).astype("<i8").tobytes()


def _u64(v: int) -> bytes:
    return v.to_bytes(8, "little")


# shape -> steps; an int is that many device message words, bytes a host constant
SHAPES = {
    "v_run_m4_A_S_y_z": [(b"V", 8)] * 4 + [(b"A", 8), (b"S", 8), (b"y", None), (b"z", None)],
    "ipp_round": [(b"L", 8), (b"R", 8), (b"u", None)],
    "scalars_w_ipp_domain": [(b"t_x", 4), (b"t_x_blinding", 4), (b"e_blinding", 4), (b"w", None),
                             (b"dom-sep", pad_label(b"ipp v1")), (b"n", _u64(256))],
    "domain_separators": [(b"dom-sep", pad_label(b"rangeproof v1")), (b"n", _u64(64)), (b"m", _u64(4)),
                          (b"dom-sep", 4), (b"n", 1)],
    "challenges_at_several_positions": [(b"y", None), (b"V", 8), (b"z", None), (b"x", None), (b"n", 1),
                                        (b"c", None), (b"T_1", 8), (b"w", None)],
}


def _host_run(start: bytes, steps, msgs: np.ndarray):
    """The JAX package's host transcript over ``steps``: final state and
    challenges as ints."""
    host = jtranscript.HashChainTranscript()
    host.state = start
    raw, k, us = _bytes(msgs), 0, []
    for label, msg in steps:
        if msg is None:
            us.append(int(host.challenge_scalar(label)))
        elif isinstance(msg, int):
            host.append_message(label, raw[8 * k : 8 * (k + msg)])
            k += msg
        else:
            host.append_message(label, msg)
    return host.state, us


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_word_runs_match_the_jax_host_transcript(shape):
    steps = SHAPES[shape]
    rng = np.random.default_rng(len(shape))
    start = _words(rng, 4)
    msgs = _words(rng, sum(m for _, m in steps if isinstance(m, int)))
    state, u = tj.absorb_many(torch.as_tensor(start), steps, torch.as_tensor(msgs))
    want_state, want_u = _host_run(_bytes(start), steps, msgs)
    assert tj.state_bytes(state.numpy()) == want_state
    if want_u:
        assert u.shape == (4, len(want_u)) and words_to_ints(u) == want_u
    else:
        assert u is None


@functools.lru_cache(maxsize=None)
def _jax_absorb(msg_len: int):
    """``transcript_jax.absorb`` under the empty label (which pads to no
    bytes) of ``pad_label(label) || msg``: the same bytes as ``absorb``
    under ``label``, one compile for every label."""
    return jax.jit(lambda state, msg: tjax.absorb(state, b"", msg, msg_len))


@functools.lru_cache(maxsize=None)
def _jax_challenge(label: bytes):
    return jax.jit(lambda state: tjax.challenge_scalar(state, label))


def test_ipp_round_matches_transcript_jax():
    """An IPP round of real points (the first one the identity) through
    ``lazy_points_to_affine`` and ``points_words``, against
    ``transcript_jax.absorb`` twice and ``challenge_scalar``."""
    G = StarkPoint.generator()
    pts = [StarkPoint.identity(), G.scalar_mul(123456789)]
    x, y, iid = tj.lazy_points_to_affine(torch.as_tensor(curve_t.points_from_host(pts)))
    words = tj.points_words(x, y, iid)
    assert _bytes(words.numpy()) == b"".join(stark_point_to_transcript_bytes(p) for p in pts)
    start = jtranscript.HashChainTranscript(b"ipp-round").state
    state, u = tj.absorb_many(torch.as_tensor(tj.state_words(start)), SHAPES["ipp_round"], words)
    sj = jnp.asarray(np.frombuffer(start, np.uint8).astype(np.uint32))
    for i, label in enumerate((b"L", b"R")):
        data = pad_label(label) + _bytes(words[8 * i : 8 * i + 8].numpy())
        sj = _jax_absorb(96)(sj, jnp.asarray(np.frombuffer(data, np.uint8).astype(np.uint32)))
    sj, uj = _jax_challenge(b"u")(sj)
    assert tj.state_bytes(state.numpy()) == bytes(np.asarray(sj).astype(np.uint8))
    assert words_to_ints(u) == jlimb.limbs_to_ints(np.asarray(uj))


def test_identity_points_absorb_as_zeros():
    """The prover's points: an identity among them absorbs 64 zero bytes,
    the others ``x || y``, as the host transcript's ``append_point``."""
    G = StarkPoint.generator()
    pts = [G.scalar_mul(7), StarkPoint.identity(), G.scalar_mul(11), StarkPoint.identity()]
    x, y, iid = tj.lazy_points_to_affine(torch.as_tensor(curve_t.points_from_host(pts)))
    assert iid.tolist() == [False, True, False, True]
    start = ttranscript.HashChainTranscript(b"ids")
    host = ttranscript.HashChainTranscript(b"ids")
    for p in pts:
        host.append_point(b"V", p)
    state, u = tj.absorb_many(torch.as_tensor(tj.state_words(start.state)), [(b"V", 8)] * 4 + [(b"y", None)],
                              tj.points_words(x, y, iid))
    assert words_to_ints(u) == [int(host.challenge_scalar(b"y"))]
    assert tj.state_bytes(state.numpy()) == host.state


def test_two_transcripts_in_one_call():
    """``(T, 4)`` states and ``(T, W)`` message rows: one call, each row
    its own transcript, as the verifiers' batch runs it."""
    steps = SHAPES["challenges_at_several_positions"]
    rng = np.random.default_rng(2)
    starts, msgs = _words(rng, 2, 4), _words(rng, 2, 17)
    calls = []
    orig = kernels.keccak_transcript
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "keccak_transcript", lambda *a: calls.append(a[0].shape) or orig(*a))
        state, u = tj.absorb_many(torch.as_tensor(starts), steps, torch.as_tensor(msgs))
    assert calls == [(2, 4)] and state.shape == (2, 4) and u.shape == (2, 4, 5)
    for i in range(2):
        want_state, want_u = _host_run(_bytes(starts[i]), steps, msgs[i])
        assert tj.state_bytes(state[i].numpy()) == want_state
        assert words_to_ints(u[i]) == want_u


def test_replay_sets_the_host_states_and_refuses_uneven_runs():
    """``transcript.replay``: the host transcripts end where the host route
    leaves them; runs of other lengths, or messages that are not whole
    words, are refused before anything is hashed."""
    a, b = ttranscript.HashChainTranscript(b"a"), ttranscript.HashChainTranscript(b"b")
    runs = [[(b"t_x", bytes(range(32))), (b"w", None)], [(b"t_x", bytes(32)), (b"w", None)]]
    got = ttranscript.replay([a, b], runs, torch.device("cpu"))
    for t, label, run, us in zip((a, b), (b"a", b"b"), runs, got):
        host = ttranscript.HashChainTranscript(label)
        host.append_message(b"t_x", run[0][1])
        assert us == [int(host.challenge_scalar(b"w"))]
        assert t.state == host.state
    with pytest.raises(ValueError, match="same labels"):
        ttranscript.replay([a, b], [runs[0], [(b"t_x", bytes(40)), (b"w", None)]], torch.device("cpu"))
    with pytest.raises(ValueError, match="whole 64-bit words"):
        ttranscript.replay([a], [[(b"t_x", bytes(31))]], torch.device("cpu"))


# -- the reduction mod r at its edges -----------------------------------------

def _fr_const(name: str) -> int:
    """A constant of ``FrConst`` in ``csrc/field.cuh``, words joined."""
    src = (kernels.CSRC / "field.cuh").read_text()
    body = src[src.index("struct FrConst"):]
    body = body[: body.index("};")]
    words = [int(re.search(rf"{name}{j}\s*=\s*(0x[0-9a-fA-F]+)ull", body).group(1), 16) for j in range(4)]
    return sum(w << (64 * j) for j, w in enumerate(words))


def _kernel_reduce_model(lo: int, hi: int) -> int:
    """``fr_reduce_u512`` of ``csrc/keccak.cu`` in Python ints: each half
    less q r for q = v >> 251 (plus r on a borrow, mod 2^256 as
    ``fe_sub``), then ``lo' + mont(hi', R^2)``.  Asserts the canonical
    inputs ``fe_add`` and ``fe_mont_mul`` need."""
    m256 = (1 << 256) - 1
    r2 = _fr_const("R2")
    assert _fr_const("M") == R and r2 == pow(2, 512, R)

    def half(v):
        q = v >> 251
        d = (v - q * R) & m256
        if v < q * R:
            d = (d + R) & m256
        assert d < R
        return d

    t = half(hi) * r2 * pow(2, -256, R) % R
    s = half(lo) + t
    return s - R if s >= R else s


EDGES = {
    "zero": (0, 0),
    "all_ff": ((1 << 256) - 1, (1 << 256) - 1),
    "r_and_r": (R, R),
    "r_minus_1": (R - 1, R - 1),
    "31r_plus_1": (31 * R + 1, 31 * R + 1),
    "31r_minus_1": (31 * R - 1, 1),
    "2r_plus_1_lo": (2 * R + 1, 0),
    "2^251": (1 << 251, (1 << 251) - 1),
    "top_bits_just_under_qr": ((17 << 251) + 5, (31 << 251)),
}


@pytest.mark.parametrize("edge", sorted(EDGES))
def test_reduction_edges_match_jax(edge):
    lo, hi = EDGES[edge]
    value = lo + (hi << 256)
    raw = value.to_bytes(64, "little")
    want = jlimb.limbs_to_ints(np.asarray(_jax_reduce()(jnp.asarray(np.frombuffer(raw, np.uint8).astype(np.uint32)))))
    assert want == [value % R]
    words = torch.as_tensor(np.frombuffer(raw, "<u8").view(np.int64).copy())
    plain = limb.reduce_512(torch.cat([limb.to_pieces(words[:4, None]), limb.to_pieces(words[4:, None])]), limb.FR)
    assert words_to_ints(plain) == want
    assert [_kernel_reduce_model(lo, hi)] == want


@functools.lru_cache(maxsize=None)
def _jax_reduce():
    return jax.jit(tjax.bytes_to_scalar_mod_r)
