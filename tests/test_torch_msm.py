"""The port's MSMs (ops/msm.py): signed digits, the split-table MSM and the
fixed-base commitment, against the JAX package's digit recoding and the
exact host MSM (``StarkPoint.msm``)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpc_bulletproof_tpu.ops import limb as jlimb
from mpc_bulletproof_tpu.ops import msm as jmsm
from mpc_bulletproof_tpu_torch.constants import R
from mpc_bulletproof_tpu_torch.generators import device_point_table
from mpc_bulletproof_tpu_torch.ops import curve_t, msm
from mpc_bulletproof_tpu_torch.ops.curve import StarkPoint
from mpc_bulletproof_tpu_torch.ops.limb import ints_to_words

# Under pytest-xdist several worker processes share the cores: split them,
# or torch's default of one intra-op thread per core in every worker
# oversubscribes the machine.
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


def _scalars(k: int, seed: int, bits: int = 252) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % (1 << bits) for _ in range(k)]


def _points(k: int, seed: int) -> list[StarkPoint]:
    G = StarkPoint.generator()
    return [G.scalar_mul(v) for v in _scalars(k, seed, 62)]


def test_signed_digits_match_jax_and_guard():
    for bits, c in ((64, 9), (252, 13), (252, 10)):
        vals = _scalars(12, bits + c, bits) + [0, (1 << bits) - 1]
        got = msm._signed_digits(torch.as_tensor(ints_to_words(vals)), c, bits)
        if c == 9:  # the main path's recoding, against the JAX package's
            want = jmsm._signed_digits(jnp.asarray(jlimb.ints_to_limbs(vals)), c, bits)
            assert np.array_equal(got.numpy(), np.asarray(want))
        half = 1 << (c - 1)
        assert int(got[:-1].abs().max()) <= half
        recon = [sum(int(d) << (c * i) for i, d in enumerate(got[:, j].tolist())) for j in range(len(vals))]
        assert recon == vals
    assert msm.SPLIT_WINDOW == 9
    # c = 8 divides 64: the top window would be a full 8 bits and overflow
    with pytest.raises(ValueError):
        msm._signed_digits(torch.zeros((4, 3), dtype=torch.int64), 8, 64)


def test_split_table_msm_matches_host():
    pts = _points(5, 1) + [StarkPoint.identity()]
    n = len(pts)
    table = msm.build_split_affine_table(torch.as_tensor(curve_t.points_from_host(pts)))
    # records are the affine shifts 2^(64 b) P, then the identity
    shifts = [p.scalar_mul(1 << (64 * b)) for b in range(4) for p in pts]
    assert torch.equal(table, torch.as_tensor(curve_t.points_from_host(shifts + [StarkPoint.identity()])))
    # an L/R-style pair of MSMs over permuted records of the table
    sa, sb = _scalars(n, 2), _scalars(n, 3)
    sa[1], sb[2] = 0, (1 << 252) - 1
    perm = np.array([3, 0, 5, 1, 4, 2])
    parts = [
        (msm.split_scalars_device(torch.as_tensor(ints_to_words(sa))),
         torch.as_tensor(msm.split_record_indices(np.arange(n), n))),
        (msm.split_scalars_device(torch.as_tensor(ints_to_words(sb))),
         torch.as_tensor(msm.split_record_indices(perm, n))),
    ]
    got = curve_t.points_to_host(msm._msm_multi_table_impl(parts, table, 9))
    assert got == [StarkPoint.msm(sa, pts), StarkPoint.msm(sb, [pts[i] for i in perm])]


def test_fixed_base_commit_matches_host():
    G = StarkPoint.generator()
    table = device_point_table(G, "cpu")
    assert table.shape == (3, 4, msm.FB_WINDOWS * msm.FB_TABLE)
    rows = [0, 1, 255, 256 + 3, 31 * 256 + 200]
    want = [G.scalar_mul((r % 256) << (8 * (r // 256))) for r in rows]
    assert torch.equal(table[..., rows], torch.as_tensor(curve_t.points_from_host(want)))
    both = torch.cat([table, table], dim=-1)
    vl, vr = _scalars(4, 5), _scalars(4, 6)
    vl[0], vr[1] = 0, 0
    off_l = torch.tensor([0, 0, msm.FB_WINDOWS * msm.FB_TABLE, 0])
    off_r = torch.full((4,), msm.FB_WINDOWS * msm.FB_TABLE)
    got = msm.fixed_commit(both, off_l, torch.as_tensor(ints_to_words(vl)),
                           off_r, torch.as_tensor(ints_to_words(vr)))
    assert curve_t.points_to_host(got) == [G.scalar_mul((a + b) % R) for a, b in zip(vl, vr)]
