"""The kernel wrappers of the port (ops/kernels.py).

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX package's Pallas kernels in interpret mode
(point_scan_steps_inner, point_scan_steps, point_horner_multi, vec_mul,
vec_add, vec_sub), against its plain references
(curve_jax._point_reduce_sum), the share plane's entries (beaver_diff,
beaver_combine, poly3_eval) against compositions of its limb ops, and
against exact host arithmetic.  Group
elements are compared in affine form, field elements as integers.  The
scans and Horner's start from the top window are also held to golden
host arithmetic.  The kernels themselves run only on the card: the tests
marked ``cuda`` hold each one against its plain version there and skip
elsewhere.

The op-rate probes (ops/probes.py) are held against the TPU benches they
replace: ``benches/tpu_mul_bench.py``'s ``make_kernel`` runs in interpret
mode off the TPU; ``benches/micro_vpu.py`` and ``benches/micro_mul.py``
have no interpret flag, so their kernel bodies are restated in ``jnp``
around the benches' op lambdas, at small repetition counts.
"""

import ctypes
import gc
import importlib.util
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpc_bulletproof_tpu.ops import curve as jcurve
from mpc_bulletproof_tpu.ops import curve_jax as cj
from mpc_bulletproof_tpu.ops import field as jfield
from mpc_bulletproof_tpu.ops import kernels as jkernels
from mpc_bulletproof_tpu.ops import limb as jlimb
from mpc_bulletproof_tpu_torch import convert
from mpc_bulletproof_tpu_torch.ops import curve_t, kernels, msm, probes
from mpc_bulletproof_tpu_torch.ops.curve import StarkPoint
from mpc_bulletproof_tpu_torch.ops.limb import (FP, FR, NW, ints_to_words, mod_add, mod_mul, mod_sub,
                                                words_to_ints)

# Under pytest-xdist several worker processes share the cores: split them,
# or torch's default of one intra-op thread per core in every worker
# oversubscribes the machine.
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


@pytest.fixture(autouse=True, scope="module")
def _release_jax_memory():
    """Free what the JAX interpret-mode kernels compiled (about 0.8 GB) once this
    module is done and hand the heap back to the OS: under pytest-xdist
    a worker lives on through later tests and would carry it."""
    yield
    jax.clear_caches()
    gc.collect()
    libc = ctypes.CDLL(None)
    if hasattr(libc, "malloc_trim"):
        libc.malloc_trim(0)


def _jax_points(k: int, seed: int, identity_every: int = 5):
    rng = np.random.default_rng(seed)
    G = jcurve.StarkPoint.generator()
    pts = [G.scalar_mul(int(v)) for v in rng.integers(1, 2**62, size=k)]
    for i in range(0, k, identity_every):
        pts[i] = jcurve.StarkPoint.identity()
    return pts


def _affine(pts):
    return [None if p.is_identity() else (p.x, p.y) for p in pts]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode (chip_smoke.py runs them)")
    return torch.device("cuda")


def test_scan_matches_jax_pallas_scan():
    T, L = 3, 6
    pts = _jax_points(T * L, 1)
    jx = cj.points_from_host(pts).reshape(3, -1, T, L)
    jout = np.asarray(jkernels.point_scan_steps_inner(jx))
    tout = kernels.point_scan_steps_inner(
        convert.points_from_jax(jx.reshape(3, -1, T * L), device="cpu")
        .reshape(3, NW, T, L).contiguous())
    for t in range(T):
        want = cj.points_to_host(jout[:, :, t])
        assert _affine(curve_t.points_to_host(tout[:, :, t])) == _affine(want)
    # and the last step is the running sum of the host points
    for lane in range(L):
        s = jcurve.StarkPoint.identity()
        for t in range(T):
            s = s + pts[t * L + lane]
        assert _affine(curve_t.points_to_host(tout[:, :, T - 1, lane : lane + 1])) == _affine([s])


def test_scan_steps_matches_jax_pallas_scan():
    """The step axis outside the words: ``(3, T, NW, L)``."""
    T, L = 3, 5
    pts = _jax_points(T * L, 11)
    jx = cj.points_from_host(pts).reshape(3, -1, T, L).transpose(0, 2, 1, 3)   # (3, T, NLZ, L)
    jout = np.asarray(jkernels.point_scan_steps(jnp.asarray(jx)))
    tx = convert.points_from_jax(cj.points_from_host(pts), device="cpu").reshape(3, NW, T, L)
    tout = kernels.point_scan_steps(tx.transpose(1, 2).contiguous())
    assert tout.shape == (3, T, NW, L)
    for t in range(T):
        assert _affine(curve_t.points_to_host(tout[:, t])) == _affine(cj.points_to_host(jout[:, t]))
    assert torch.equal(tout.transpose(1, 2), kernels.point_scan_steps_inner(tx.contiguous()))


@pytest.mark.parametrize("op,field,width", [("mul", "FR", 1), ("add", "FR", 1), ("sub", "FR", 1),
                                            ("mul", "FR", 6), ("mul", "FP", 6)])
def test_vec_ops_match_jax_pallas(op, field, width):
    """Standard-form residues in and out, as the JAX package's Barrett
    kernels; a width-1 ``b`` is broadcast."""
    mp, jmp = (FP, jlimb.FP) if field == "FP" else (FR, jlimb.FR)
    m = mp.modulus
    rng = np.random.default_rng(13)
    a_int = [0, 1, m - 1, m - 2] + [int.from_bytes(rng.bytes(32), "little") % m for _ in range(2)]
    b_int = [m - 1] if width == 1 else [m - 1, 0, 1, m - 1, 5, int.from_bytes(rng.bytes(32), "little") % m]
    jfn = {"mul": jkernels.vec_mul, "add": jkernels.vec_add, "sub": jkernels.vec_sub}[op]
    tfn = {"mul": kernels.vec_mul, "add": kernels.vec_add, "sub": kernels.vec_sub}[op]
    want = jlimb.limbs_to_ints(np.asarray(jfn(jnp.asarray(jlimb.ints_to_limbs(a_int)),
                                              jnp.asarray(jlimb.ints_to_limbs(b_int)), jmp)))
    got = words_to_ints(tfn(torch.as_tensor(ints_to_words(a_int)), torch.as_tensor(ints_to_words(b_int)), mp))
    bb = b_int * len(a_int) if width == 1 else b_int
    host = {"mul": lambda x, y: x * y % m, "add": lambda x, y: (x + y) % m,
            "sub": lambda x, y: (x - y) % m}[op]
    assert got == want == [host(x, y) for x, y in zip(a_int, bb)]


# ---------------------------------------------------------------------------
# the device share plane's entries (beaver_diff, beaver_combine, poly3_eval)
# ---------------------------------------------------------------------------

def _fr_ints(rng, k, edge=(0, 1, FR.modulus - 1)):
    """k ints in [0, r) from numpy's generator, the edge values first."""
    vals = [int.from_bytes(rng.bytes(32), "little") % FR.modulus for _ in range(k)]
    vals[: len(edge)] = edge
    return vals


def _pairs(rng, count, k):
    """``count`` share pairs as ints ``[[shares, macs], ...]`` (edges rotated
    so edge lanes meet other edges)."""
    return [[_fr_ints(rng, k, edge=(0, 1, FR.modulus - 1)[(2 * i + j) % 3:] + (0, 1, FR.modulus - 1)[:(2 * i + j) % 3])
             for j in range(2)] for i in range(count)]


def _stack_t(pairs):
    return torch.stack([torch.stack([torch.as_tensor(ints_to_words(v)) for v in pair]) for pair in pairs]).contiguous()


def _jl(vals):
    return jnp.asarray(jlimb.ints_to_limbs(vals))


def _jints(arr):
    return jlimb.limbs_to_ints(np.asarray(arr))


@pytest.mark.parametrize("k", [16, 48])
def test_beaver_diff_matches_jax_limb_ops(k):
    """``[x - a | y - b]`` equals the JAX package's ``limb.mod_sub`` of each
    half, exactly."""
    rng = np.random.default_rng(k)
    x, y = _fr_ints(rng, k), _fr_ints(rng, k)[::-1]
    triple = _pairs(rng, 3, k)
    got = kernels.beaver_diff(torch.as_tensor(ints_to_words(x)), torch.as_tensor(ints_to_words(y)),
                              _stack_t(triple))
    assert got.shape == (NW, 2 * k)
    want = (_jints(jlimb.mod_sub(_jl(x), _jl(triple[0][0]), jlimb.FR))
            + _jints(jlimb.mod_sub(_jl(y), _jl(triple[1][0]), jlimb.FR)))
    m = FR.modulus
    assert words_to_ints(got) == want == [(u - v) % m for u, v in zip(x + y, triple[0][0] + triple[1][0])]


@pytest.mark.parametrize("party", [0, 1])
@pytest.mark.parametrize("k", [16, 48])
def test_beaver_combine_matches_jax_limb_ops(k, party):
    """The JAX package's ``DeviceShareVector.beaver_mul`` local algebra
    (``limb.mod_mul`` / ``mod_add`` one op at a time) on the same opened d,
    e, triple and MAC key share, exactly; the key at 0, 1, r - 1 and at
    random."""
    rng = np.random.default_rng(100 + k + party)
    m = FR.modulus
    d, e = _fr_ints(rng, k), _fr_ints(rng, k)[::-1]
    triple = _pairs(rng, 3, k)
    de = torch.as_tensor(ints_to_words(d + e))
    (a, a_m), (b, b_m), (c, c_m) = [[_jl(v) for v in pair] for pair in triple]
    jd, je = _jl(d), _jl(e)
    shares = jlimb.mod_add(jlimb.mod_add(c, jlimb.mod_mul(b, jd, jlimb.FR), jlimb.FR),
                           jlimb.mod_mul(a, je, jlimb.FR), jlimb.FR)
    d_e = jlimb.mod_mul(jd, je, jlimb.FR)
    if party == 0:
        shares = jlimb.mod_add(shares, d_e, jlimb.FR)
    macs = jlimb.mod_add(jlimb.mod_add(c_m, jlimb.mod_mul(b_m, jd, jlimb.FR), jlimb.FR),
                         jlimb.mod_mul(a_m, je, jlimb.FR), jlimb.FR)
    for alpha in (0, 1, m - 1, int.from_bytes(rng.bytes(32), "little") % m):
        got = kernels.beaver_combine(de, _stack_t(triple), alpha, party)
        assert got.shape == (2, NW, k)
        want_m = jlimb.mod_add(macs, jlimb.mod_mul(d_e, jnp.asarray(jlimb.int_to_limbs_np(alpha)), jlimb.FR),
                               jlimb.FR)
        assert words_to_ints(got[0]) == _jints(shares)
        assert words_to_ints(got[1]) == _jints(want_m)
        host = [(cv + dv * bv + ev * av + (dv * ev if party == 0 else 0)) % m
                for av, bv, cv, dv, ev in zip(triple[0][0], triple[1][0], triple[2][0], d, e)]
        assert words_to_ints(got[0]) == host


@pytest.mark.parametrize("x", ["zero", "one", "r_minus_1", "random"])
@pytest.mark.parametrize("k", [16, 48])
def test_poly3_eval_matches_jax_limb_ops(k, x):
    """Horner at a public x on both rows equals the JAX package's
    ``mul_public`` / ``+`` chain (``limb.mod_mul`` / ``mod_add``), exactly."""
    rng = np.random.default_rng(200 + k)
    m = FR.modulus
    xv = {"zero": 0, "one": 1, "r_minus_1": m - 1,
          "random": int.from_bytes(rng.bytes(32), "little") % m}[x]
    coeffs = _pairs(rng, 4, k)
    got = kernels.poly3_eval(_stack_t(coeffs), xv)
    assert got.shape == (2, NW, k)
    jx = jnp.asarray(jlimb.int_to_limbs_np(xv))
    for row in range(2):
        acc = _jl(coeffs[3][row])
        for j in (2, 1, 0):
            acc = jlimb.mod_add(jlimb.mod_mul(acc, jx, jlimb.FR), _jl(coeffs[j][row]), jlimb.FR)
        host = [(((c3 * xv + c2) * xv + c1) * xv + c0) % m
                for c0, c1, c2, c3 in zip(*(coeffs[j][row] for j in range(4)))]
        assert words_to_ints(got[row]) == _jints(acc) == host


def test_share_plane_wrappers_reject_bad_operands():
    """dtype, shape, contiguity, device, lane counts and public scalars are
    checked before any plain version or launch."""
    k = 5
    x = torch.zeros((NW, k), dtype=torch.int64)
    triple = torch.zeros((3, 2, NW, k), dtype=torch.int64)
    coeffs = torch.zeros((4, 2, NW, k), dtype=torch.int64)
    de = torch.zeros((NW, 2 * k), dtype=torch.int64)
    r = FR.modulus
    with pytest.raises(TypeError):
        kernels.beaver_diff(x.int(), x, triple)                            # int64 only
    with pytest.raises(ValueError):
        kernels.beaver_diff(x[:, :3].contiguous(), x, triple)              # lane counts differ
    with pytest.raises(ValueError):
        kernels.beaver_diff(x, x, triple[:2].contiguous())                 # a triple is 3 pairs
    with pytest.raises(ValueError):
        kernels.beaver_diff(x, x, triple.transpose(2, 3).contiguous())     # (3, 2, NW, k)
    with pytest.raises(ValueError):
        kernels.beaver_diff(x, x.to("meta"), triple)                       # not a CPU or CUDA tensor
    with pytest.raises(ValueError):
        kernels.beaver_combine(de[:, :-1].contiguous(), triple, 1, 0)      # de is (NW, 2k)
    with pytest.raises(ValueError):
        kernels.beaver_combine(torch.zeros((2 * k, NW), dtype=torch.int64).T, triple, 1, 0)  # not contiguous
    with pytest.raises(ValueError):
        kernels.beaver_combine(de, triple, 1, 2)                           # party 0 or 1
    with pytest.raises(ValueError):
        kernels.beaver_combine(de, triple, r, 0)                           # alpha < r
    with pytest.raises(ValueError):
        kernels.beaver_combine(de, triple, -1, 1)                          # alpha >= 0
    with pytest.raises(ValueError):
        kernels.poly3_eval(triple, 1)                                      # four pairs
    with pytest.raises(ValueError):
        kernels.poly3_eval(coeffs[..., None], 1)                           # (4, 2, NW, k)
    with pytest.raises(ValueError):
        kernels.poly3_eval(coeffs, r)                                      # x < r
    with pytest.raises(TypeError):
        kernels.poly3_eval(coeffs.float(), 1)


def test_horner_matches_jax_pallas_horner():
    nw, c, k = 2, 3, 2
    pts = _jax_points(nw * k, 2, identity_every=4)
    jw = np.stack([cj.points_from_host(pts[w * k : (w + 1) * k]) for w in range(nw)])
    jout = cj.points_to_host(jkernels.point_horner_multi(jw, c))
    tw = torch.stack([convert.points_from_jax(jw[w], device="cpu") for w in range(nw)]).contiguous()
    tout = curve_t.points_to_host(kernels.point_horner_multi(tw, c))
    assert _affine(tout) == _affine(jout)
    want = []
    for j in range(k):
        acc = jcurve.StarkPoint.identity()
        for w in range(nw):
            acc = acc + pts[w * k + j].scalar_mul(1 << (c * w))
        want.append(acc)
    assert _affine(tout) == _affine(want)


# ---------------------------------------------------------------------------
# the scans and Horner against golden host arithmetic
# ---------------------------------------------------------------------------

def _host_points(k: int, seed: int):
    """Port-side golden points, every fifth the identity: sums of two of
    eight random multiples of G (one host add a point)."""
    rng = np.random.default_rng(seed)
    G = StarkPoint.generator()
    base = [G.scalar_mul(int(v)) for v in rng.integers(1, 2**62, size=8)]
    pts = [base[i] + base[j] for i, j in rng.integers(0, 8, size=(k, 2))]
    for i in range(0, k, 5):
        pts[i] = StarkPoint.identity()
    return pts


@pytest.mark.parametrize("layout", ["inner", "steps"])
@pytest.mark.parametrize("L", [1, 6, 33])
@pytest.mark.parametrize("T", [1, 2, 3, 4, 5, 8, 9, 13, 16, 17])
def test_scan_matches_host_running_sums(T, L, layout):
    """Both scans' every prefix equals the lane's running sum in golden
    host arithmetic, at the paths' step counts (4, 8, 9, 13, 16, 17) and
    lane counts that part-fill the kernel's blocks of 32."""
    pts = _host_points(T * L, 40 + T * L)
    x = torch.as_tensor(curve_t.points_from_host(pts)).reshape(3, NW, T, L)
    if layout == "inner":
        got = kernels.point_scan_steps_inner(x.contiguous())
    else:
        got = kernels.point_scan_steps(x.transpose(1, 2).contiguous()).transpose(1, 2)
    assert got.shape == x.shape
    want = []
    for lane in range(L):
        acc = StarkPoint.identity()
        for t in range(T):
            acc = acc + pts[t * L + lane]
            want.append(acc)
    got_lanes = [curve_t.points_to_host(got[:, :, :, lane].contiguous()) for lane in range(L)]
    assert _affine([p for lane in got_lanes for p in lane]) == _affine(want)


@pytest.mark.parametrize("nw,c,k", [(1, 1, 1), (2, 3, 2), (8, 9, 2)])
def test_horner_plain_matches_host_horner(nw, c, k):
    """Starting from the top window's sum gives the points of the
    sequential Horner from the identity, in golden host arithmetic."""
    pts = _host_points(nw * k, 30 + nw)
    w = torch.as_tensor(curve_t.points_from_host(pts)).reshape(3, NW, nw, k).permute(2, 0, 1, 3).contiguous()
    got = curve_t.points_to_host(kernels.point_horner_multi(w, c))
    want = []
    for j in range(k):
        acc = StarkPoint.identity()
        for i in range(nw - 1, -1, -1):
            for _ in range(c):
                acc = acc.double()
            acc = acc + pts[i * k + j]
        want.append(acc)
    assert _affine(got) == _affine(want)


@pytest.mark.parametrize("shape", [(1,), (2,), (300,), (3, 37), (2, 130), (4, 2)],
                         ids=["1", "2", "300", "3x37", "2x130", "4x2"])
def test_reduce_matches_jax_reference_and_host(shape):
    """Each segment of a ``(3, NW, *batch, n)`` batch (one segment, or S
    ragged ones that take one or two tree passes) against the host sum, and
    at n = 2 also against the JAX package's plain reduction, run eagerly
    (its op-by-op compile costs ~15 s for each other width)."""
    *batch, n = shape
    S = int(np.prod(batch, dtype=np.int64))
    pts = _jax_points(S * n, 3 + S * n)
    jx = cj.points_from_host(pts)
    tout = kernels.point_reduce(convert.points_from_jax(jx, device="cpu").reshape(3, NW, *batch, n).contiguous())
    assert tout.shape == (3, NW, *batch, 1)
    got = curve_t.points_to_host(tout.reshape(3, NW, S))
    for s in range(S):
        want = jcurve.StarkPoint.identity()
        for p in pts[s * n : (s + 1) * n]:
            want = want + p
        assert _affine([got[s]]) == _affine([want])
        if n == 2:
            jref = np.asarray(cj._point_reduce_sum(jnp.asarray(jx[..., s * n : (s + 1) * n])))[..., None]
            assert _affine(cj.points_to_host(jref)) == _affine([want])


@pytest.mark.parametrize("name", ["FP", "FR"])
def test_mod_pow_matches_host_pow(name):
    mp = FP if name == "FP" else FR
    m = mp.modulus
    rng = np.random.default_rng(7)
    xs = [0, 1, m - 1, m - 2] + [int.from_bytes(rng.bytes(32), "little") % m for _ in range(12)]
    x = torch.as_tensor(ints_to_words(xs))
    for e in (m - 2, 5, (1 << 255) + 12345):
        want = [pow(v, e, m) for v in xs]
        assert words_to_ints(kernels.mod_pow_static(x, e, mp)) == want
    if name == "FR":  # the Fermat inverse is the host Scalar's inverse
        got = words_to_ints(kernels.mod_pow_static(x, m - 2, mp))
        assert got[1:] == [int(jfield.Scalar(v).inverse()) for v in xs[1:]]
    assert words_to_ints(kernels.mod_pow_static(x[:, :3].contiguous(), 0, mp)) == [1, 1, 1]
    with pytest.raises(ValueError):
        kernels.mod_pow_static(x, 1 << 256, mp)


# ---------------------------------------------------------------------------
# mod_pow_static's inverse: csrc/mod_pow.cu's binary GCD, transcribed
# ---------------------------------------------------------------------------

GCD_ROUNDS, GCD_STEPS = 17, 31
_M31 = (1 << 31) - 1


def _gcd_inverse_model(x: int, m: int) -> int:
    """``mod_inv_kernel`` in Python ints, round for round: the kernel's
    64-bit approximations (the top 33 bits at ``len = max(len(a), len(b),
    64)`` over the low 31), 31 steps a round with its selects, the signed
    factors applied as magnitudes and signs, and ``u, v`` updated with the
    Montgomery division by 2^31; a fixed 17 rounds."""
    minv = (-pow(m, -1, 1 << 31)) & _M31
    a, b, u, v = x, m, 1, 0
    for _ in range(GCD_ROUNDS):
        sh = max(a.bit_length(), b.bit_length(), 64) - 33
        at = (((a >> sh) & ((1 << 33) - 1)) << 31) | (a & _M31)
        bt = (((b >> sh) & ((1 << 33) - 1)) << 31) | (b & _M31)
        f0, g0, f1, g1 = 1, 0, 0, 1
        for _ in range(GCD_STEPS):
            odd = at & 1
            swap = odd and at < bt
            na = (bt - at) if swap else (at - bt) if odd else at
            bt = at if swap else bt
            sf, sg = (f1, g1) if swap else (f0, g0)
            f1, g1 = (f0, g0) if swap else (f1, g1)
            f0, g0 = (sf - f1, sg - g1) if odd else (sf, sg)
            at, f1, g1 = na >> 1, f1 << 1, g1 << 1
        assert abs(f0) + abs(g0) <= 1 << 31 and abs(f1) + abs(g1) <= 1 << 31

        def lin_comb(f, g):        # |a f + b g| / 2^31 and its sign
            t = a * f + b * g
            assert t % (1 << 31) == 0 and abs(t) < 1 << 283
            return abs(t) >> 31, t < 0

        def mont_comb(f, g):       # (u f + v g) / 2^31 mod m
            t = (m - u if f < 0 else u) * abs(f) + (m - v if g < 0 else v) * abs(g)
            assert t <= m << 31
            r = (t + ((t * minv) & _M31) * m) >> 31
            return r - m if r >= m else r

        (na, nega), (nb, negb) = lin_comb(f0, g0), lin_comb(f1, g1)
        if nega:
            f0, g0 = -f0, -g0
        if negb:
            f1, g1 = -f1, -g1
        u, v, a, b = mont_comb(f0, g0), mont_comb(f1, g1), na, nb
        assert a < 1 << 252 and b < 1 << 252
    return v


@pytest.mark.parametrize("name", ["FP", "FR"])
def test_gcd_inverse_model_matches_pow(name):
    """The kernel's GCD gives ``pow(x, -1, m)`` (0 for 0) on edge inputs and
    1,000 seeded random ones."""
    m = (FP if name == "FP" else FR).modulus
    rng = np.random.default_rng(17 if name == "FP" else 18)
    edge = [0, 1, 2, 3, m - 1, m - 2, (m - 1) // 2, (1 << 251) - 1, (1 << 251) - 2]
    edge += [1 << k for k in range(0, 252, 3) if 1 << k < m] + [(1 << k) - 1 for k in range(2, 252, 5)]
    edge += [m - (1 << k) for k in range(0, 250, 7)]
    edge += [int(("1" * r + "0" * r) * (250 // (2 * r)), 2) % m for r in (1, 2, 3, 8, 31, 32, 33, 64, 100)]
    xs = edge + [int.from_bytes(rng.bytes(32), "little") % m for _ in range(1000)]
    assert [_gcd_inverse_model(x, m) for x in xs] == [pow(x, -1, m) if x else 0 for x in xs]


@pytest.fixture
def recorded_launches(monkeypatch):
    """The CUDA branch of the wrappers on CPU tensors: ``_check`` reports a
    card and ``_launch`` records its arguments instead of launching."""
    calls = []
    monkeypatch.setattr(kernels, "_check", lambda t, *a, **kw: "cuda")
    monkeypatch.setattr(kernels, "_launch", lambda name, device, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("name", ["FP", "FR"])
def test_mod_pow_takes_the_gcd_exactly_at_m_minus_2(recorded_launches, name):
    mp, other = (FP, FR) if name == "FP" else (FR, FP)
    m = mp.modulus
    x = torch.zeros((NW, 3), dtype=torch.int64)
    cases = [m - 2, m - 1, m - 3, other.modulus - 2, 0, 1, 65537, (1 << 255) + 12345]
    for e in cases:
        kernels.mod_pow_static(x, e, mp)
    flags = [args[-1] for name_, args in recorded_launches]
    assert [name_ for name_, _ in recorded_launches] == ["mod_pow_static"] * len(cases)
    assert flags == [1, 0, 0, 0, 0, 0, 0, 0]
    assert [kernels.is_inverse(e, mp) for e in cases] == [bool(f) for f in flags]


def test_point_add_design_by_width(recorded_launches):
    """The narrow design up to ``POINT_ADD_NARROW_MAX`` lanes, the wide one
    above; both count as ``point_add`` launches."""
    top = kernels.POINT_ADD_NARROW_MAX
    for n in (1, 16, top, top + 1):
        a = torch.zeros((3, NW, n), dtype=torch.int64)
        kernels.point_add(a, a)
    assert [(name, args[3], args[4]) for name, args in recorded_launches] == [
        ("point_add", 1, 1), ("point_add", 16, 1), ("point_add", top, 1), ("point_add", top + 1, 0)]


@pytest.mark.parametrize("shape", [(8192,), (16, 256), (66, 64), (26, 512), (8, 32768), (64, 128)],
                         ids=["prove_A", "prove_tail", "fixed_commit", "verify_tail", "msm_tail",
                              "r1cs_prove_tail"])
def test_reduce_sum_is_one_segmented_call(recorded_launches, shape):
    """One ``msm._reduce_sum`` at a path's shape launches exactly the planned
    passes of ``point_reduce``, each on the previous pass's width, and no
    ``point_add`` (the halving tree of adds and copies is gone)."""
    *batch, n = shape
    S = int(np.prod(batch, dtype=np.int64))
    out = msm._reduce_sum(torch.zeros((3, NW, *shape), dtype=torch.int64))
    assert out.shape == (3, NW, *batch, 1)
    plan = kernels.point_reduce_plan(S, n)
    assert [name for name, _ in recorded_launches] == ["point_reduce"] * len(plan)
    m = n
    for (kind, param), (_, args) in zip(plan, recorded_launches):
        assert args[2:] == (S, m, int(kind == "fold"), param)
        m = -(-m // (param if kind == "fold" else 1 << param))
    assert m == 1
    assert plan[0][0] == ("fold" if S * n >= 1 << 17 else "tree")


def test_reduce_plan_rule():
    """Tree passes of at most REDUCE_TREE_LEVELS levels, as few as that
    allows, the extra levels last; a fold first only where the folds keep
    REDUCE_FOLD_THREADS threads and REDUCE_FOLD_MIN_WIDTH a segment."""
    assert kernels.point_reduce_plan(1, 8192) == [("tree", 4), ("tree", 4), ("tree", 5)]
    assert kernels.point_reduce_plan(16, 256) == [("tree", 4), ("tree", 4)]
    assert kernels.point_reduce_plan(66, 64) == [("tree", 6)]
    assert kernels.point_reduce_plan(8, 32768) == [("fold", 8), ("tree", 6), ("tree", 6)]
    assert kernels.point_reduce_plan(131072, 64) == [("fold", 16), ("tree", 2)]
    assert kernels.point_reduce_plan(5, 1) == []
    for S, n in [(1, 2), (37, 2), (1, 64), (1, 65), (3, 1000), (1, 1 << 20), (2, 130)]:
        plan = kernels.point_reduce_plan(S, n)
        assert all(1 <= p <= kernels.REDUCE_TREE_LEVELS for kind, p in plan if kind == "tree")
        m = n
        for kind, param in plan:
            m = -(-m // (param if kind == "fold" else 1 << param))
        assert m == 1


def test_wrappers_reject_bad_operands():
    pts = torch.zeros((3, NW, 4), dtype=torch.int64)
    with pytest.raises(ValueError):
        kernels.point_scan_steps_inner(pts)                       # needs (3, NW, T, L)
    with pytest.raises(ValueError):
        kernels.point_horner_multi(pts[None].contiguous(), 0)    # c out of range
    with pytest.raises(ValueError):
        kernels.point_reduce(pts[:, :2].contiguous())            # wrong word count
    with pytest.raises(ValueError):
        kernels.point_reduce(pts.reshape(3, NW, 2, 2).transpose(2, 3))   # not contiguous
    with pytest.raises(ValueError):
        kernels.point_reduce(pts[:, :, 0].contiguous())          # no point axis
    with pytest.raises(ValueError):
        kernels.mod_pow_static(pts[0], 3, object())               # FP or FR only
    with pytest.raises(ValueError):
        kernels.point_add(pts.reshape(NW, 3, 4), pts.reshape(NW, 3, 4))  # not (3, NW, ...)
    with pytest.raises(ValueError):
        kernels.point_scan_steps(pts[None].contiguous())               # needs (3, T, NW, L)
    x = pts[0]
    with pytest.raises(ValueError):
        kernels.vec_mul(x, x[:, :2].contiguous())                     # b is (NW, n) or (NW, 1)
    with pytest.raises(ValueError):
        kernels.vec_add(x, x, object())                               # FP or FR only


# ---------------------------------------------------------------------------
# op-rate probes
# ---------------------------------------------------------------------------

BENCHES = pathlib.Path(__file__).resolve().parent.parent / "benches"
PROBE_CHECK_REPS = 16


def _load_bench(name: str, argv: list[str]):
    """Import ``benches/<name>.py`` by path, with ``sys.argv`` set for the
    import (tpu_mul_bench reads REPS from it) and the environment and
    ``sys.path`` restored after."""
    spec = importlib.util.spec_from_file_location(f"_bench_{name}", BENCHES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", argv)
        mp.setattr(sys, "path", list(sys.path))
        mp.setattr(os, "environ", dict(os.environ))
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tpu_mul_bench():
    return _load_bench("tpu_mul_bench", ["tpu_mul_bench.py", str(PROBE_CHECK_REPS)])


@pytest.fixture(scope="module")
def micro_vpu():
    return _load_bench("micro_vpu", ["micro_vpu.py"])


@pytest.fixture(scope="module")
def micro_mul():
    return _load_bench("micro_mul", ["micro_mul.py"])


# the op lambdas benches/tpu_mul_bench.py:70-83 passes to make_kernel, in order
TPU_MUL_OPS = [
    lambda a, y: a * y,
    lambda a, y: a * y + y,
    lambda a, y: a + y,
    lambda a, y: (a & 0x1FFF) + (a >> 13) + y,
    lambda a, y: a * y,
    lambda a, y: a * y + y,
    lambda a, y: a + y,
    lambda a, y: a - jnp.floor(a * (1.0 / 512.0)) * 512.0 + y,
]

# the op lambdas benches/micro_mul.py:125-135 passes to bench_vpu, in order
MICRO_MUL_OPS = [
    lambda a, b: a * b,
    lambda a, b: a + b,
    lambda a, b: (a >> 7) & 0x3F,
    lambda a, b: a * b,
    lambda a, b: a * b + a,
    lambda a, b: (a & 0xFFFF) * (b & 0xFFFF),
    lambda a, b: ((a << 16) >> 16) * ((b << 16) >> 16),
    lambda a, b: (a & 0xFFFF) * b,
]


def _same(got: torch.Tensor, want) -> None:
    """Bit for bit, NaN equal to NaN (NaN payloads may differ)."""
    want = torch.as_tensor(np.array(want))
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.is_floating_point():
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("op", probes.CHAIN_OPS)
def test_probe_chain_matches_tpu_mul_bench(tpu_mul_bench, op):
    """``make_kernel(dtype, op)`` in interpret mode, REPS = 16, on the
    bench's (8, 512) tile and inputs (int32 in [1, 2^12), the same values
    as float32)."""
    rng = np.random.default_rng(0)
    xi = rng.integers(1, 1 << 12, tpu_mul_bench.SHAPE, dtype=np.int32)
    yi = rng.integers(1, 1 << 12, tpu_mul_bench.SHAPE, dtype=np.int32)
    dt = probes.op_dtype(op)
    jdt = jnp.int32 if dt == torch.int32 else jnp.float32
    x, y = (v.astype(np.float32) if dt == torch.float32 else v for v in (xi, yi))
    want = tpu_mul_bench.make_kernel(jdt, TPU_MUL_OPS[probes.CHAIN_OPS.index(op)])(
        jnp.asarray(x), jnp.asarray(y))
    got = probes.probe_chain(op, torch.as_tensor(x), torch.as_tensor(y), PROBE_CHECK_REPS)
    if op != "f32_mul_add":
        _same(got, want)
        return
    # XLA on the CPU contracts the kernel's a * y + y into one FMA (one
    # rounding) in some lanes; the probe rounds twice, as numpy's float32
    # operations do.  So: exact against numpy, and against the bench's kernel
    # within one rounding (2^-23 relative) per step.
    ref = x.copy()
    with np.errstate(over="ignore"):
        for _ in range(PROBE_CHECK_REPS):
            ref = ref * y + y
    _same(got, ref)
    torch.testing.assert_close(got, torch.as_tensor(np.array(want)), rtol=PROBE_CHECK_REPS * 2.0**-23,
                               atol=0, equal_nan=True)


@pytest.mark.parametrize("op", probes.XOR_OPS)
def test_probe_xor_chain_matches_micro_vpu(micro_vpu, op):
    """The bench's ``OPS[op]`` in its kernel body's chain (micro_vpu.py:37-45):
    ``acc = op(acc, x) ^ i`` or ``op(acc, x) + float(i & 3)``, over two of
    its (8, 256) blocks, x int32 in [1, 8191) or float32 in [0.5, 1.5)."""
    fn, jdt = micro_vpu.OPS[op]
    rng = np.random.default_rng(1)
    shape = (2, micro_vpu.SUB, micro_vpu.LANE)
    if jdt == jnp.int32:
        x = rng.integers(1, 8191, shape, dtype=np.int32)
    else:
        x = rng.uniform(0.5, 1.5, shape).astype(np.float32)
    acc = jnp.asarray(x)
    for i in range(PROBE_CHECK_REPS):
        acc = fn(acc, jnp.asarray(x)) ^ i if jdt == jnp.int32 else fn(acc, jnp.asarray(x)) + float(i & 3)
    _same(probes.probe_xor_chain(op, torch.as_tensor(x), PROBE_CHECK_REPS), acc)


@pytest.mark.parametrize("op", probes.ACCUM_OPS)
def test_probe_accum_matches_micro_mul(micro_mul, op):
    """The bench's op lambdas in its kernel body (micro_mul.py:45-52):
    ``acc = acc + op(a + i, b)`` (float32: ``op(a, b)``) for i < REP = 64,
    over two of its (8, 128) blocks, a and b in [0, 2^13); some int32 lanes
    at the edges (2^31 - 1, -1, -2^31) so the wraps and the sign
    extension are exercised."""
    dt = probes.op_dtype(op)
    rng = np.random.default_rng(2)
    shape = (2, micro_mul.SUB, micro_mul.LANE)
    a = rng.integers(0, 1 << 13, shape).astype(np.int32)
    b = rng.integers(0, 1 << 13, shape).astype(np.int32)
    a[0, 0, :4] = [2**31 - 1, -1, -(2**31), 0xFFFF]
    b[0, 0, :4] = [-5, 0x8000, 0x7FFF, -1]
    jdt = jnp.int32 if dt == torch.int32 else jnp.float32
    if jdt == jnp.float32:
        a, b = a.astype(np.float32), b.astype(np.float32)
    fn = MICRO_MUL_OPS[probes.ACCUM_OPS.index(op)]
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    acc = jnp.zeros_like(ja)
    for i in range(micro_mul.REP):
        acc = acc + fn(ja + i if jdt == jnp.int32 else ja, jb)
    _same(probes.probe_accum(op, torch.as_tensor(a), torch.as_tensor(b), micro_mul.REP), acc)


def test_probe_wrappers_reject_bad_operands():
    xi = torch.ones((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        probes.probe_chain("i64_mul", xi, xi)                            # not a bench op
    with pytest.raises(TypeError):
        probes.probe_chain("f32_mul", xi, xi)                            # float32 op, int32 data
    with pytest.raises(ValueError):
        probes.probe_accum("i32_mul", xi, xi[:4].contiguous())          # shapes differ
    with pytest.raises(ValueError):
        probes.probe_xor_chain("i32_add", xi.t(), 4)                     # not contiguous
    with pytest.raises(ValueError):
        probes.probe_xor_chain("i32_add", xi, -1)                        # negative count


# ---------------------------------------------------------------------------
# the probes' bounds and SASS reading (chip_smoke.py)
# ---------------------------------------------------------------------------

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("_chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SMS_HZ = 132 * 1980e6
XOR_LANE_STEPS = 2048 * 8 * 256 * 4096


@pytest.mark.parametrize("lane_steps,needs,ms,pipe", [
    # the xor chain's i32_mul needs an IMAD and a LOP3 a lane-step, one on each 64-lane pipe
    (XOR_LANE_STEPS, {"imad": 1, "alu": 1}, XOR_LANE_STEPS / (64 * _SMS_HZ) * 1e3, "alu"),
    # one conversion a lane-step at 16 a clock outweighs 2 ALU at 64
    (XOR_LANE_STEPS, {"alu": 2, "fp32": 1, "conv": 1}, XOR_LANE_STEPS / (16 * _SMS_HZ) * 1e3, "conv"),
    # 2 FP32 a lane-step at 128, but 2.5 instructions a lane-step to dispatch (the branch left out)
    (XOR_LANE_STEPS, {"fp32": 2, "other": 0.5}, XOR_LANE_STEPS * 2.5 / (128 * _SMS_HZ) * 1e3, "dispatch"),
    (XOR_LANE_STEPS, {"fp32": 2, "other": 0.5, "branch": 2}, XOR_LANE_STEPS * 2.5 / (128 * _SMS_HZ) * 1e3,
     "dispatch"),
    # probe_accum's i32_mul: an IMAD and an add a lane-step, 0.00201 ms at the TPU shape
    (512 * 8 * 128 * 64, {"imad": 1, "int": 1}, 512 * 8 * 128 * 64 / (64 * _SMS_HZ) * 1e3, "imad"),
    # probe_chain's f32_mul_add: 2 FP32 a step at 128
    (8 * 512 * 4096, {"fp32": 2}, 8 * 512 * 4096 * 2 / (128 * _SMS_HZ) * 1e3, "fp32"),
    # an add issues on either integer pipe: 1 ALU op and 2 adds share 128 lanes a clock
    (8 * 512 * 4096, {"alu": 1, "int": 2}, 8 * 512 * 4096 * 3 / (128 * _SMS_HZ) * 1e3, "int"),
], ids=["xor_i32_mul", "conv", "dispatch", "branch_not_dispatched", "accum_i32_mul", "chain_f32_mul_add",
        "int_either_pipe"])
def test_probe_pipe_bound_reckoning(chip_smoke, lane_steps, needs, ms, pipe):
    got_ms, got_pipe = chip_smoke.pipe_bound_ms(lane_steps, needs, 1980.0)
    assert got_pipe == pipe
    assert got_ms == pytest.approx(ms, rel=1e-12)


@pytest.mark.parametrize("name,op", [("probe_chain", op) for op in probes.CHAIN_OPS]
                         + [("probe_xor_chain", op) for op in probes.XOR_OPS]
                         + [("probe_accum", op) for op in probes.ACCUM_OPS])
def test_probe_pipe_table_has_every_op(chip_smoke, name, op):
    """Every probe op has the instructions a lane-step it needs per pipe
    and its dependency steps; a main loop's lane-steps an iteration are
    the kernel's unroll (probe_chain CHAIN_STEPS, the xor chain 4,
    probe_accum ACCUM_STEPS steps of 4 lanes)."""
    needs = chip_smoke.PROBE_NEEDS[name][op]
    assert set(needs) <= set(chip_smoke.PIPE_RATE) | {"int"}
    assert all(isinstance(v, int) and v > 0 for v in needs.values())
    assert op in chip_smoke.PROBE_DEP_STEPS[name]
    assert chip_smoke.LOOP_LANE_STEPS[name] == {"probe_chain": probes.CHAIN_STEPS, "probe_xor_chain": 4,
                                                "probe_accum": 4 * probes.ACCUM_STEPS}[name]


@pytest.mark.parametrize("name,want", [
    # a CIOS product on 8 x 32-bit limbs: 8 rounds of 8 mad.wide and an 8-add carry chain, the
    # reduction (FP: u = -t0, 2 mad.wide, 9 carry adds; FR: u = t0 m', 8 mad.wide, 8 carry adds),
    # then 8 subtracts with borrow, the mask and 8 selects
    ("FP_MUL_NEEDS", {"imad": 80, "alu": 153, "int": 8}),
    ("FR_MUL_NEEDS", {"imad": 136, "alu": 145}),
    ("FE_ADD_NEEDS", {"alu": 25}),
    ("FP_SUB_NEEDS", {"alu": 20}),
    ("FR_SUB_NEEDS", {"alu": 23}),
    # 14 FP products, 17 sums and 6 differences
    ("POINT_ADD_NEEDS", {"imad": 14 * 80, "alu": 14 * 153 + 17 * 25 + 6 * 20, "int": 14 * 8}),
], ids=["fp_mul", "fr_mul", "add", "fp_sub", "fr_sub", "point_add"])
def test_kernel_row_needs(chip_smoke, name, want):
    assert getattr(chip_smoke, name) == want


def test_kernel_row_bound_per_pipe(chip_smoke, monkeypatch):
    """A kernel row's bound: the larger of the byte time and the per-pipe
    issue time at the clock under load; a point add is ALU-bound, a
    modular sum over 36,864 lanes bytes-bound."""
    monkeypatch.setattr(chip_smoke, "SM_CLOCK_MHZ", 1980.0)
    lanes = 16 * 1024
    row = chip_smoke.bound(3 * chip_smoke.POINT_BYTES * lanes, chip_smoke.needs((lanes, chip_smoke.POINT_ADD_NEEDS)))
    assert row["pipe"] == "alu" and row["bound_by"] == "operations"
    assert row["bound_ms"] == pytest.approx(lanes * 2687 / (64 * _SMS_HZ) * 1e3, rel=1e-12)
    assert row["bytes_bound_ms"] == pytest.approx(3 * 96 * lanes / 3.35e12 * 1e3, rel=1e-12)
    k = 36864
    row = chip_smoke.bound(3 * 4 * 8 * k, chip_smoke.needs((k, chip_smoke.FE_ADD_NEEDS)))
    assert row["bound_by"] == "bytes" and row["bound_ms"] == row["bytes_bound_ms"]
    assert not hasattr(chip_smoke, "PEAK_OPS_PER_S")


def test_gcd_needs_count_every_round(chip_smoke):
    fp, fr = chip_smoke.gcd_needs(False), chip_smoke.gcd_needs(True)
    assert fp["alu"] >= 17 * 31 * chip_smoke.GCD_STEP_NEEDS["alu"]
    assert fr["imad"] > fp["imad"]                     # FR's Montgomery quotient is a full 8 x 1-limb product


def test_probe_chain_steps_match_source():
    src = (ROOT / "mpc_bulletproof_tpu_torch" / "csrc" / "probes.cu").read_text()
    assert f"static const int CHAIN_STEPS = {probes.CHAIN_STEPS};" in src
    assert f"static const int ACCUM_STEPS = {probes.ACCUM_STEPS};" in src


_SASS = """
\tcode for sm_90a
\t\tFunction : _Z12accum_kernelILi3EEvPKvS1_Pvxxi
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                                   /* 0x00000a00ff017b82 */
        /*0010*/                   FADD R2, R2, R3 ;
        /*0020*/                   ISETP.NE.AND P0, PT, R4, RZ, PT ;
        /*0030*/              @!P0 BRA 0x10 ;
        /*0040*/                   FADD R2, R2, R3 ;
        /*0050*/                   FADD R5, R5, R3 ;
        /*0060*/                   FADD R6, R6, R3 ;
        /*0070*/                   NOP ;
        /*0080*/                   IADD3 R4, R4, 0x1, RZ ;
        /*0090*/               @P0 BRA 0x40 ;
        /*00a0*/                   VIADD R7, R7, 0x1 ;
        /*00b0*/                   UIADD3 UR4, UR4, 0x1, URZ ;
        /*00c0*/                   BRA 0x10 ;
        /*00d0*/                   EXIT ;
        /*00e0*/                   BRA 0xe0;
\t\t..........

\t\tFunction : _Z12chain_kernelILi0EEvPKvS1_Pvxij
        /*0000*/                   IMAD R2, R2, R3, R4 ;
        /*0010*/                   EXIT ;
"""


def test_sass_main_loop_histogram(chip_smoke):
    """The innermost loops of a function are [0x10, 0x30] and [0x40, 0x90]
    (the loop [0x10, 0xc0] holds both, the branch at 0xe0 is to itself):
    the longer is the main loop; NOP is not counted, the branch is."""
    funcs = chip_smoke.sass_functions(_SASS)
    assert set(funcs) == {"accum_kernel<3>", "chain_kernel<0>"}
    body = chip_smoke.main_loop(funcs["accum_kernel<3>"])
    assert [addr for addr, _, _ in body] == [0x40, 0x50, 0x60, 0x80, 0x90]
    hist, pipes = chip_smoke.loop_pipes(body)
    assert hist == {"FADD": 3, "IADD3": 1, "BRA": 1}
    assert pipes == {"fp32": 3, "alu": 1, "branch": 1}
    assert chip_smoke.main_loop(funcs["chain_kernel<0>"]) == []


@pytest.mark.parametrize("opcode,pipe", [("IMAD.IADD", "imad"), ("VIADD", "imad"), ("IADD3", "alu"),
                                         ("LEA.HI.SX32", "alu"), ("I2FP.F32.S32", "alu"),
                                         ("F2I.TRUNC.NTZ", "conv"), ("FRND.FLOOR", "conv"),
                                         ("FFMA", "fp32"), ("UIADD3", "other"), ("BRA", "branch")])
def test_sass_opcode_pipes(chip_smoke, opcode, pipe):
    assert chip_smoke.loop_pipes([(0, opcode, "")])[1] == {pipe: 1}


def _random_points_t(k: int, seed: int, dev):
    pts = _jax_points(k, seed)
    return convert.points_from_jax(cj.points_from_host(pts), device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(kernels.KERNELS))
def test_kernel_matches_plain_on_card(cuda_device, name):
    dev = cuda_device
    a = _random_points_t(40, 1, dev)
    b = _random_points_t(40, 2, dev)
    b[..., 1::4] = a[..., 1::4]
    b = b.contiguous()
    if name == "point_add":   # both designs, whichever the width picks
        got = torch.stack([kernels._point_add_launch(a, b, d) for d in ("narrow", "wide")])
        want = torch.stack([curve_t._point_add(a, b)] * 2)
    elif name == "point_scan_steps_inner":
        x = a.reshape(3, NW, 5, 8).contiguous()
        got, want = kernels.point_scan_steps_inner(x), kernels.point_scan_plain(x)
    elif name == "point_scan_steps":
        x = a.reshape(3, NW, 4, 10).transpose(1, 2).contiguous()   # points, steps outside the words
        got, want = kernels.point_scan_steps(x), kernels.point_scan_steps_plain(x)
    elif name == "vec2":
        x, y = a[0].contiguous(), b[1].contiguous()                 # canonical mod p
        got = torch.stack([kernels.vec_mul(x, y, FP), kernels.vec_add(x, y[:, :1].contiguous(), FP),
                           kernels.vec_sub(x, y, FP)])
        want = torch.stack([mod_mul(x, y, FP), mod_add(x, y[:, :1], FP), mod_sub(x, y, FP)])
    elif name in ("beaver_diff", "beaver_combine", "poly3_eval"):   # words < 2^251 < r
        k = 8
        words = (a & ((1 << 59) - 1)).reshape(-1)[: 8 * NW * k].reshape(4, 2, NW, k).contiguous()
        if name == "beaver_diff":
            x, y = words[3, 0].contiguous(), words[3, 1].contiguous()
            got, want = kernels.beaver_diff(x, y, words[:3]), kernels.beaver_diff_plain(x, y, words[:3])
        elif name == "beaver_combine":
            de = words[3].reshape(NW, 2 * k).contiguous()
            got = torch.stack([kernels.beaver_combine(de, words[:3], al, p)
                               for al, p in ((0, 0), (FR.modulus - 1, 1), (12345, 0))])
            want = torch.stack([kernels.beaver_combine_plain(de, words[:3], al, p)
                                for al, p in ((0, 0), (FR.modulus - 1, 1), (12345, 0))])
        else:
            xs = (0, 1, FR.modulus - 1, 987654321)
            got = torch.stack([kernels.poly3_eval(words, x) for x in xs])
            want = torch.stack([kernels.poly3_eval_plain(words, x) for x in xs])
    elif name == "point_horner_multi":
        w = a.reshape(3, NW, 8, 5).permute(2, 0, 1, 3).contiguous()
        got, want = kernels.point_horner_multi(w, 9), kernels.point_horner_plain(w, 9)
    elif name == "point_reduce":   # segments, ragged n, many blocks a segment, every tree depth, a fold
        c = _random_points_t(300, 3, dev)
        cases = [(a, None), (a.reshape(3, NW, 4, 10).contiguous(), None), (a[..., :37].contiguous(), None),
                 (c, None), (c[..., :299].reshape(3, NW, 13, 23).contiguous(), None),
                 (c, [("fold", 4)] + kernels.point_reduce_plan(1, 75)),
                 *[(c, [("tree", lv)] * -(-9 // lv)) for lv in range(1, 7)]]   # 2^9 >= 300
        got = torch.cat([(kernels.point_reduce(x) if p is None else kernels._point_reduce_launch(x, p))
                         .reshape(3, NW, -1) for x, p in cases], dim=-1)
        want = torch.cat([kernels.point_reduce_plain(x, p).reshape(3, NW, -1) for x, p in cases], dim=-1)
    elif name == "mod_pow_static":   # the GCD (e = m - 2) and the ladder, forced at m - 2 too
        x = a[0].contiguous()
        xr = (a[0] & ((1 << 59) - 1)).contiguous()               # < r
        got, want = [], []
        for v, mp in ((x, FP), (xr, FR)):
            for e, inverse in ((mp.modulus - 2, True), (mp.modulus - 2, False), (65537, False)):
                got.append(kernels._mod_pow_launch(v, e, mp, inverse))
                want.append(kernels.mod_pow_plain(v, e, mp))
        got, want = torch.stack(got), torch.stack(want)
    else:
        _probes_match_plain_on_card(name, dev)
        return
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _probes_match_plain_on_card(name: str, dev) -> None:
    """Every op of one probe kernel at a small shape, against its plain version."""
    rng = np.random.default_rng(5)
    xi = torch.as_tensor(rng.integers(1, 1 << 12, (4, 8, 64), dtype=np.int32), device=dev)
    yi = torch.as_tensor(rng.integers(1, 1 << 12, (4, 8, 64), dtype=np.int32), device=dev)
    ops = {"probe_chain": probes.CHAIN_OPS, "probe_xor_chain": probes.XOR_OPS,
           "probe_accum": probes.ACCUM_OPS}[name]
    for op in ops:
        x, y = (xi, yi) if probes.op_dtype(op) == torch.int32 else (xi.float(), yi.float() / 4096)
        if name == "probe_chain":
            got, want = probes.probe_chain(op, x, y, 100), probes.chain_plain(op, x, y, 100)
        elif name == "probe_xor_chain":
            got, want = probes.probe_xor_chain(op, x, 100), probes.xor_chain_plain(op, x, 100)
        else:
            got, want = probes.probe_accum(op, x, y, 64), probes.accum_plain(op, x, y, 64)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("op", probes.CHAIN_OPS)
def test_probe_chain_reps_on_card(cuda_device, op):
    """The unrolled chain and its one-step tail, at reps 0, 1, U - 1, U,
    U + 1, 100 and 4,096 (U = CHAIN_STEPS), on the bench's tile."""
    rng = np.random.default_rng(6)
    x, y = (torch.as_tensor(rng.integers(1, 1 << 12, probes.CHAIN_SHAPE, dtype=np.int32), device=cuda_device)
            for _ in range(2))
    if probes.op_dtype(op) == torch.float32:
        x, y = x.float(), y.float()
    for reps in probes.EDGE_CHAIN_REPS:
        got, want = probes.probe_chain(op, x, y, reps), probes.chain_plain(op, x, y, reps)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("op", probes.ACCUM_OPS)
def test_probe_accum_lanes_on_card(cuda_device, op):
    """The 16-byte path (2,048 lanes), with a scalar tail (2,047 and 4,099
    lanes), and a contiguous view at a 4-byte offset, which takes the scalar
    path; int32 edge lanes (2^31 - 1, -1, -2^31) at its start."""
    rng = np.random.default_rng(7)
    for n, off in probes.EDGE_ACCUM_LANES:
        a, b = (torch.as_tensor(rng.integers(0, 1 << 13, n + off).astype(np.int32), device=cuda_device)
                for _ in range(2))
        a[off:off + 3] = torch.tensor([2**31 - 1, -1, -(2**31)], dtype=torch.int32)
        if probes.op_dtype(op) == torch.float32:
            a, b = a.float(), b.float()
        a, b = a[off:], b[off:]
        for rep in probes.EDGE_ACCUM_REPS:
            got, want = probes.probe_accum(op, a, b, rep), probes.accum_plain(op, a, b, rep)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
