"""The port's keccak and transcript, host and tensor versions, byte-equal to
the JAX package's host keccak/transcript and its on-device keccak_jax /
transcript_jax, including the longest single-block message (135 bytes)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpc_bulletproof_tpu import transcript as jtranscript
from mpc_bulletproof_tpu.ops import curve_jax as cj
from mpc_bulletproof_tpu.ops import keccak as jkeccak
from mpc_bulletproof_tpu.ops import keccak_jax
from mpc_bulletproof_tpu.ops import limb as jlimb
from mpc_bulletproof_tpu.ops import transcript_jax as tjax
from mpc_bulletproof_tpu.ops.curve import StarkPoint as JPoint
from mpc_bulletproof_tpu.ops.field import Scalar as JScalar
from mpc_bulletproof_tpu_torch import transcript as ttranscript
from mpc_bulletproof_tpu_torch.constants import R
from mpc_bulletproof_tpu_torch.ops import curve as tcurve
from mpc_bulletproof_tpu_torch.ops import curve_t, keccak, keccak_t, transcript_t
from mpc_bulletproof_tpu_torch.ops.field import Scalar
from mpc_bulletproof_tpu_torch.ops.limb import ints_to_words, words_to_ints

# Under pytest-xdist several worker processes share the cores: split them,
# or torch's default of one intra-op thread per core in every worker
# oversubscribes the machine.
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


def _bytes_t(b: bytes) -> torch.Tensor:
    return torch.as_tensor(np.frombuffer(b, np.uint8).astype(np.int64))


@pytest.mark.parametrize("length", [0, 1, 31, 32, 64, 96, 134, 135])
def test_keccak_single_block_matches_host_and_jax(length):
    data = np.random.default_rng(length).bytes(length)
    want = jkeccak.keccak256(data)
    assert keccak.keccak256(data) == want
    got = keccak_t.keccak256(_bytes_t(data), length)
    assert bytes(got.tolist()) == want
    if length in (0, 135):  # the JAX package's device keccak, run eagerly
        jdev = keccak_jax.keccak256_device(jnp.asarray(np.frombuffer(data, np.uint8).astype(np.uint32)), length)
        assert bytes(np.asarray(jdev).astype(np.uint8)) == want


def test_keccak_limits_and_batch():
    with pytest.raises(ValueError):
        keccak_t.keccak256(_bytes_t(bytes(136)), 136)
    msgs = np.frombuffer(np.random.default_rng(9).bytes(32 * 5), np.uint8).reshape(5, 32)
    batch = keccak.keccak256_batch32(msgs)
    assert [bytes(r) for r in batch] == [jkeccak.keccak256(bytes(r)) for r in msgs]
    assert keccak.keccak256(bytes(200)) == jkeccak.keccak256(bytes(200))   # multi-block host path
    assert keccak.pad_label(b"abc") == jkeccak.pad_label(b"abc")


def test_tensor_transcript_matches_jax_device_and_host():
    jt = jtranscript.HashChainTranscript(b"torch-port")
    tt = ttranscript.HashChainTranscript(b"torch-port")
    assert jt.state == tt.state
    state_t = torch.as_tensor(transcript_t.state_words(tt.state))
    state_j = jnp.asarray(np.frombuffer(jt.state, np.uint8).astype(np.uint32))

    # points absorb as x || y LE felts (identity = zeros), through the
    # projective -> affine conversion of the prover
    G = JPoint.generator()
    jpts = [G.scalar_mul(987654321), JPoint.identity()]
    tpts = [tcurve.StarkPoint(p.x, p.y) if not p.is_identity() else tcurve.StarkPoint.identity()
            for p in jpts]
    arr = torch.as_tensor(curve_t.points_from_host(tpts))
    x, y, iid = transcript_t.lazy_points_to_affine(arr)
    enc = transcript_t.points_words(x, y, iid).reshape(2, 8)
    jenc = tjax.points_transcript_bytes(*[jnp.asarray(jlimb.ints_to_limbs(words_to_ints(v))) for v in (x, y)],
                                        jnp.asarray(iid.numpy()))
    assert np.array_equal(np.asarray(jenc).T.astype(np.uint8).reshape(-1),
                          enc.numpy().astype("<i8").view(np.uint8).reshape(-1))
    for i, lbl in enumerate([b"L", b"R"]):
        state_t = transcript_t.absorb(state_t, lbl, enc[i])
        jt.append_point(lbl, jpts[i])
        tt.append_point(lbl, tpts[i])
        assert transcript_t.state_bytes(state_t.numpy()) == jt.state == tt.state
    # the JAX package's device transcript absorbs the same bytes (eager; its
    # challenge is the host's, which the port matches below)
    state_j = tjax.absorb(state_j, b"L", jenc[:, 0], 64)
    jt2 = jtranscript.HashChainTranscript(b"torch-port")
    jt2.append_point(b"L", jpts[0])
    assert bytes(np.asarray(state_j).tolist()) == jt2.state

    # a scalar absorb and challenges
    s = Scalar(2**250 + 12345)
    state_t = transcript_t.absorb(state_t, b"t_x", transcript_t.scalars_words(
        torch.as_tensor(ints_to_words([int(s)]))))
    jt.append_scalar(b"t_x", JScalar(int(s)))
    tt.append_scalar(b"t_x", s)
    assert transcript_t.state_bytes(state_t.numpy()) == jt.state == tt.state
    for lbl in (b"u", b"w"):
        state_t, u = transcript_t.challenge_scalar(state_t, lbl)
        want = jt.challenge_scalar(lbl)
        assert int(tt.challenge_scalar(lbl)) == int(want)
        assert words_to_ints(u) == [int(want)]
        assert transcript_t.state_bytes(state_t.numpy()) == jt.state == tt.state

    # the single-block limit with whole words: 32 state + 32 label + 64
    # message = 128 bytes (the protocol's longest absorb, a point); 72 are refused
    long_msg = np.frombuffer(bytes(range(64)), "<i8").copy()
    state_t = transcript_t.absorb(state_t, b"n", torch.as_tensor(long_msg))
    jt.append_message(b"n", bytes(range(64)))
    assert transcript_t.state_bytes(state_t.numpy()) == jt.state
    with pytest.raises(ValueError, match="135"):
        transcript_t.absorb(state_t, b"n", torch.zeros(9, dtype=torch.int64))


def test_bytes_to_scalar_mod_r_matches_jax():
    data = np.random.default_rng(3).bytes(64)
    got = transcript_t.bytes_to_scalar_mod_r(_bytes_t(data))
    want = jax.jit(tjax.bytes_to_scalar_mod_r)(jnp.asarray(np.frombuffer(data, np.uint8).astype(np.uint32)))
    assert words_to_ints(got) == jlimb.limbs_to_ints(np.asarray(want))
    assert words_to_ints(got) == [int.from_bytes(data, "little") % R]
    assert cj.scalars_to_host(np.asarray(want))[0].value == words_to_ints(got)[0]
