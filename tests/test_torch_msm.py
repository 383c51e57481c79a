"""The port's MSMs (ops/msm.py, ops/backend.py): signed digits, the
variable-base MSM on both routes, the routing by size, the split-table MSM
and the fixed-base commitment, against the JAX package's digit recoding,
its device MSM (Pallas kernels in interpret mode) and the exact host MSM
(``StarkPoint.msm``)."""

import ctypes
import gc
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpc_bulletproof_tpu.ops import limb as jlimb
from mpc_bulletproof_tpu.ops import msm as jmsm
from mpc_bulletproof_tpu.ops.curve import StarkPoint as JPoint
from mpc_bulletproof_tpu.ops.field import Scalar as JScalar
from mpc_bulletproof_tpu_torch.constants import R
from mpc_bulletproof_tpu_torch.generators import device_point_table
from mpc_bulletproof_tpu_torch.ops import backend, curve_t, msm
from mpc_bulletproof_tpu_torch.ops.curve import StarkPoint
from mpc_bulletproof_tpu_torch.ops.limb import ints_to_words

# Under pytest-xdist several worker processes share the cores: split them,
# or torch's default of one intra-op thread per core in every worker
# oversubscribes the machine.
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


@pytest.fixture(autouse=True, scope="module")
def _release_jax_memory():
    """Free what the JAX interpret-mode kernels compiled (the device MSM leaves about 4.5 GB) once this
    module is done and hand the heap back to the OS: under pytest-xdist
    a worker lives on through later tests and would carry it."""
    yield
    jax.clear_caches()
    gc.collect()
    libc = ctypes.CDLL(None)
    if hasattr(libc, "malloc_trim"):
        libc.malloc_trim(0)


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


def _msm_case(n: int, seed: int):
    """``n`` JAX host points and scalars with the edge cases: identity points,
    P twice and P with -P, scalars 0 and r - 1, and one whose digit in
    window 49 of c = 5 is 31, so the top window ends on a borrow."""
    rng = random.Random(seed)
    G = JPoint.generator()
    pts = [G.scalar_mul(JScalar(rng.getrandbits(64) + 1)) for _ in range(n)]
    pts[0] = pts[7] = JPoint.identity()
    pts[5], pts[6] = pts[4], -pts[4]
    sc = [rng.getrandbits(251) for _ in range(n)]
    sc[1], sc[2], sc[3], sc[7] = 0, R - 1, (1 << 250) - (1 << 245), 0
    return pts, sc


def _port_points(pts) -> list[StarkPoint]:
    return [StarkPoint.from_bytes(p.to_bytes()) for p in pts]


def test_select_window_matches_jax():
    for n in (1, 24, 40, 48, 8286, 1 << 16, 1 << 20):
        assert msm.select_window(n) == jmsm.select_window(n)
    assert msm.select_window(8286, 64) == jmsm.select_window(8286, 64) == 9
    assert msm.select_window(1 << 20) == 16


@pytest.mark.parametrize("n", [1, 24, 40])
def test_msm_device_matches_jax(monkeypatch, n):
    """The port's one route at c = 5 against the JAX host MSM; at n = 24
    also against the JAX device MSM, on its sort route (_PERM_MAX = 4, as
    ``tests/test_msm_algorithm.py`` forces it; the one Pallas interpret-mode
    MSM of these tests)."""
    pts, sc = _msm_case(n, n) if n > 1 else ([JPoint.generator().scalar_mul(JScalar(7))], [R - 1])
    want = JPoint.msm([JScalar(s) for s in sc], pts).to_bytes()
    got = msm.msm_host_points(sc, _port_points(pts), 5, device="cpu").to_bytes()
    assert got == want
    if n == 24:
        monkeypatch.setattr(jmsm, "_PERM_MAX", 4)
        assert jmsm.msm_host_points([JScalar(s) for s in sc], pts, 5).to_bytes() == want


@pytest.mark.parametrize("n", [31, 32])
def test_dispatch_msm_routes_by_size(monkeypatch, n):
    """Host points: below _DEVICE_MIN = 32 the host Pippenger, from 32 on
    the device MSM.  A point tensor (on the device already) always takes
    the device MSM."""
    device_calls = []
    orig = msm.msm_host_points
    monkeypatch.setattr(msm, "msm_host_points",
                        lambda *a, **k: device_calls.append(1) or orig(*a, **k))
    pts, sc = _msm_case(n, 100 + n)
    want = JPoint.msm([JScalar(s) for s in sc], pts).to_bytes()
    port_pts = _port_points(pts)
    assert backend.dispatch_msm(sc, port_pts, device="cpu").to_bytes() == want
    tensor = torch.as_tensor(curve_t.points_from_host(port_pts))
    assert backend.dispatch_msm(sc, tensor, device="cpu").to_bytes() == want
    assert len(device_calls) == (2 if n >= backend._DEVICE_MIN else 1)
    # the card is the default: without one even the host route raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        backend.dispatch_msm(sc, port_pts)
