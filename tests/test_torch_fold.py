"""The port's IPP folds (``ops/fold.py``) against the JAX package's: the
scalar bits and the scalar fold against its jnp versions, the point fold
against its Pallas kernels in interpret mode at 12-bit scalars (as its own
``tests/test_fold_kernels.py`` runs them), and the full 252-bit folds,
per-lane and shared, against the exact host two-point MSM.  Canonical
integers and points are compared, never limb layouts."""

import os
import random

import numpy as np
import torch

import jax.numpy as jnp

from mpc_bulletproof_tpu.ops import curve_jax as cj
from mpc_bulletproof_tpu.ops import fold as jfold
from mpc_bulletproof_tpu.ops import limb as jlimb
from mpc_bulletproof_tpu.ops.curve import StarkPoint as JPoint
from mpc_bulletproof_tpu.ops.field import Scalar as JScalar
from mpc_bulletproof_tpu_torch.constants import FIELD_BITS, R
from mpc_bulletproof_tpu_torch.ops import curve_t, fold
from mpc_bulletproof_tpu_torch.ops.curve import StarkPoint
from mpc_bulletproof_tpu_torch.ops.limb import ints_to_words, words_to_ints

# Under pytest-xdist several worker processes share the cores: split them,
# or torch's default of one intra-op thread per core in every worker
# oversubscribes the machine.
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

rng = random.Random(4243)
G = StarkPoint.generator()


def _words(vals) -> torch.Tensor:
    return torch.as_tensor(ints_to_words(vals))


def _jax(points):
    return [JPoint(p.x, p.y) for p in points]


def _random_points(k: int):
    return [G.scalar_mul(rng.getrandbits(200)) for _ in range(k)]


def test_scalar_bits_and_fold_scalars_match_jax():
    n = 8
    vals = [0, 1, R - 1, (1 << 251) - 1] + [rng.getrandbits(251) for _ in range(n - 4)]
    got = fold.scalar_bits(_words(vals)).numpy()
    want = np.asarray(jfold.scalar_bits(jnp.asarray(cj.scalars_from_host([JScalar(v) for v in vals]))))
    assert got.shape == (FIELD_BITS, n)
    assert np.array_equal(got, want)

    u = rng.getrandbits(251)
    u_inv = pow(u, -1, R)
    left = vals
    right = [R - 1, 0] + [rng.getrandbits(251) for _ in range(n - 2)]
    out = fold.fold_scalars(_words([u]), _words([u_inv]), _words(left), _words(right))
    j_out = jfold.fold_scalars(jnp.asarray(jlimb.int_to_limbs_np(u)), jnp.asarray(jlimb.int_to_limbs_np(u_inv)),
                               jnp.asarray(cj.scalars_from_host([JScalar(v) for v in left])),
                               jnp.asarray(cj.scalars_from_host([JScalar(v) for v in right])))
    assert words_to_ints(out) == [int(s) for s in cj.scalars_to_host(j_out)]
    assert words_to_ints(out) == [(u * a + u_inv * b) % R for a, b in zip(left, right)]


def test_fold_points_short_scalars_match_jax_interpret():
    n, bits_len = 4, 12
    ul = [rng.getrandbits(bits_len) for _ in range(n)]
    ur = [rng.getrandbits(bits_len) for _ in range(n)]
    L, Rp = _random_points(n), _random_points(n)
    bl = np.array([[(u >> i) & 1 for u in ul] for i in range(bits_len)])
    br = np.array([[(u >> i) & 1 for u in ur] for i in range(bits_len)])
    out = fold.fold_points(torch.as_tensor(bl), torch.as_tensor(br),
                           torch.as_tensor(curve_t.points_from_host(L)),
                           torch.as_tensor(curve_t.points_from_host(Rp)))
    j_out = jfold.fold_points(jnp.asarray(bl, dtype=jnp.int32), jnp.asarray(br, dtype=jnp.int32),
                              jnp.asarray(cj.points_from_host(_jax(L))), jnp.asarray(cj.points_from_host(_jax(Rp))))
    got = [p.to_bytes() for p in curve_t.points_to_host(out)]
    assert got == [p.to_bytes() for p in cj.points_to_host(j_out)]
    assert got == [JPoint.msm([JScalar(a), JScalar(b)], [x, y]).to_bytes()
                   for a, b, x, y in zip(ul, ur, _jax(L), _jax(Rp))]


def test_fold_points_full_scalars_match_host():
    """Per-lane 252-bit scalars (the first round's factors): a zero scalar,
    r - 1, and a lane whose two points are equal (its G_L + G_R is a doubling)."""
    L, Rp = _random_points(4), _random_points(4)
    Rp[3] = L[3]
    sl = [0, R - 1, rng.getrandbits(251), rng.getrandbits(251)]
    sr = [rng.getrandbits(251), 1, R - 1, rng.getrandbits(251)]
    out = fold.fold_points(fold.scalar_bits(_words(sl)), fold.scalar_bits(_words(sr)),
                           torch.as_tensor(curve_t.points_from_host(L)),
                           torch.as_tensor(curve_t.points_from_host(Rp)))
    want = [JPoint.msm([JScalar(a), JScalar(b)], [x, y]).to_bytes()
            for a, b, x, y in zip(sl, sr, _jax(L), _jax(Rp))]
    assert [p.to_bytes() for p in curve_t.points_to_host(out)] == want


def test_fold_points_shared_matches_host():
    """One challenge pair for every lane, as a fold of G: ``u^-1 G_L + u G_R``."""
    L, Rp = _random_points(4), _random_points(4)
    u = rng.getrandbits(251)
    u_inv = pow(u, -1, R)
    out = fold.fold_points_shared(_words([u_inv]), _words([u]), torch.as_tensor(curve_t.points_from_host(L)),
                                  torch.as_tensor(curve_t.points_from_host(Rp)))
    want = [JPoint.msm([JScalar(u_inv), JScalar(u)], [x, y]).to_bytes() for x, y in zip(_jax(L), _jax(Rp))]
    assert [p.to_bytes() for p in curve_t.points_to_host(out)] == want
