"""The port's point layer (ops/curve_t.py, kernels.point_add on the CPU)
against the JAX package's complete addition (plain jnp and the Pallas
kernel in interpret mode) and the exact host curve."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpc_bulletproof_tpu.ops import curve as jcurve
from mpc_bulletproof_tpu.ops import curve_jax as cj
from mpc_bulletproof_tpu.ops import kernels as jkernels
from mpc_bulletproof_tpu_torch import convert
from mpc_bulletproof_tpu_torch.ops import curve as tcurve
from mpc_bulletproof_tpu_torch.ops import curve_t, kernels

# Under pytest-xdist several worker processes share the cores: split them,
# or torch's default of one intra-op thread per core in every worker
# oversubscribes the machine.
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


def _host_points(k: int, seed: int):
    """Pairs of (JAX host point, port host point) for random multiples of G."""
    rng = np.random.default_rng(seed)
    ks = [int(v) for v in rng.integers(1, 2**62, size=k)]
    jp = [jcurve.StarkPoint.generator().scalar_mul(v) for v in ks]
    return jp, [tcurve.StarkPoint(p.x, p.y) for p in jp]


def _affine(pts):
    return [None if p.is_identity() else (p.x, p.y) for p in pts]


def _edge_pairs():
    """(a, b) operand lists covering doubling, P + (-P) and the identity."""
    jp, _ = _host_points(6, 11)
    ident = jcurve.StarkPoint.identity()
    pairs = [(jp[0], jp[0]), (jp[1], -jp[1]), (jp[2], ident), (ident, jp[3]),
             (ident, ident), (jp[4], jp[5]), (jp[5], jp[5].double())]
    return [p for p, _ in pairs], [q for _, q in pairs]


def test_points_round_trip_and_convert():
    jp, tp = _host_points(5, 1)
    tp.append(tcurve.StarkPoint.identity())
    jp.append(jcurve.StarkPoint.identity())
    arr = torch.as_tensor(curve_t.points_from_host(tp))
    assert _affine(curve_t.points_to_host(arr)) == _affine(tp)
    # the JAX package's (3, NLZ, n) Montgomery arrays carry across exactly
    assert torch.equal(convert.points_from_jax(cj.points_from_host(jp), device="cpu"), arr)
    sc = [0, 1, 12345, (1 << 251) + 7]
    assert torch.equal(convert.scalars_from_jax(cj.scalars_from_host(sc), device="cpu"),
                       torch.as_tensor(curve_t.scalars_from_host(sc)))
    assert [int(s) for s in curve_t.scalars_to_host(torch.as_tensor(curve_t.scalars_from_host(sc)))] == sc


def test_point_add_matches_jax_plain_and_host():
    a, b = _edge_pairs()
    ja, jb = cj.points_from_host(a), cj.points_from_host(b)
    got = kernels.point_add(convert.points_from_jax(ja, device="cpu"),
                            convert.points_from_jax(jb, device="cpu"))
    want = [x + y for x, y in zip(a, b)]
    assert _affine(curve_t.points_to_host(got)) == _affine(want)
    # the JAX package's plain formula, run eagerly (no whole-program compile)
    jout = np.asarray(cj._point_add(jnp.asarray(ja), jnp.asarray(jb)))
    assert _affine(curve_t.points_to_host(convert.points_from_jax(jout, device="cpu"))) == _affine(want)


def test_point_add_matches_jax_pallas_kernel():
    """The Pallas kernel, run in interpret mode, and the port's wrapper give
    the same group elements, also on the kernel's lazy outputs carried
    across by convert."""
    a, b = _edge_pairs()
    ja, jb = cj.points_from_host(a), cj.points_from_host(b)
    lazy = jkernels.point_add(ja, jb)
    jout = jkernels.point_add(lazy, jb)
    tout = kernels.point_add(convert.points_from_jax(np.asarray(lazy), device="cpu"),
                             convert.points_from_jax(jb, device="cpu"))
    assert _affine(curve_t.points_to_host(tout)) == _affine(cj.points_to_host(jout))
    assert _affine(cj.points_to_host(jout)) == _affine([x + y + y for x, y in zip(a, b)])


def test_neg_select_affine_and_wrapper_contract():
    jp, tp = _host_points(4, 2)
    tp.append(tcurve.StarkPoint.identity())
    arr = torch.as_tensor(curve_t.points_from_host(tp))
    assert _affine(curve_t.points_to_host(curve_t._point_neg(arr))) == _affine([-p for p in tp])
    # projective inputs (a sum) -> affine records with Z in {0, 1_M}
    s = kernels.point_add(arr, arr)
    aff = curve_t.to_affine_mont(s)
    assert torch.equal(aff, torch.as_tensor(curve_t.points_from_host([p + p for p in tp])))
    cond = torch.tensor([True, False, True, False, True])
    sel = curve_t._point_select(cond, arr, s)
    assert torch.equal(sel[..., 1], s[..., 1]) and torch.equal(sel[..., 0], arr[..., 0])
    before = kernels.launches["point_add"]
    kernels.point_add(arr, arr)
    assert kernels.launches["point_add"] == before     # a plain run is not a launch
    with pytest.raises(ValueError):
        kernels.point_add(arr, arr[..., :1])           # no broadcasting
    with pytest.raises(ValueError):
        kernels.point_add(arr[..., ::2], arr[..., ::2])  # not contiguous
    with pytest.raises(TypeError):
        kernels.point_add(arr.int(), arr.int())
