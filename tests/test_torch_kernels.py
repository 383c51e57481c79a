"""The kernel wrappers of the port (ops/kernels.py).

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX package's Pallas kernels in interpret mode
(point_scan_steps_inner, point_scan_steps, point_horner_multi, vec_mul,
vec_add, vec_sub), against its plain references
(curve_jax._point_reduce_sum) and against exact host arithmetic.  Group
elements are compared in affine form, field elements as integers.  The
kernels themselves run only on the card: the tests marked ``cuda`` hold
each one against its plain version there and skip elsewhere.
"""

import ctypes
import gc
import os

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
from mpc_bulletproof_tpu_torch.ops import curve_t, kernels
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
        convert.points_from_jax(jx.reshape(3, -1, T * L)).reshape(3, NW, T, L).contiguous())
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
    tx = convert.points_from_jax(cj.points_from_host(pts)).reshape(3, NW, T, L)
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


def test_horner_matches_jax_pallas_horner():
    nw, c, k = 2, 3, 2
    pts = _jax_points(nw * k, 2, identity_every=4)
    jw = np.stack([cj.points_from_host(pts[w * k : (w + 1) * k]) for w in range(nw)])
    jout = cj.points_to_host(jkernels.point_horner_multi(jw, c))
    tw = torch.stack([convert.points_from_jax(jw[w]) for w in range(nw)]).contiguous()
    tout = curve_t.points_to_host(kernels.point_horner_multi(tw, c))
    assert _affine(tout) == _affine(jout)
    want = []
    for j in range(k):
        acc = jcurve.StarkPoint.identity()
        for w in range(nw):
            acc = acc + pts[w * k + j].scalar_mul(1 << (c * w))
        want.append(acc)
    assert _affine(tout) == _affine(want)


@pytest.mark.parametrize("n", [1, 2, 300])
def test_reduce_matches_jax_reference_and_host(n):
    pts = _jax_points(n, 3 + n)
    want = jcurve.StarkPoint.identity()
    for p in pts:
        want = want + p
    jx = cj.points_from_host(pts)
    tout = kernels.point_reduce(convert.points_from_jax(jx))
    assert tout.shape == (3, NW, 1)
    assert _affine(curve_t.points_to_host(tout)) == _affine([want])
    if n == 2:  # the JAX package's plain reduction, run eagerly
        jref = np.asarray(cj._point_reduce_sum(jnp.asarray(jx)))[..., None]
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


def test_wrappers_reject_bad_operands():
    pts = torch.zeros((3, NW, 4), dtype=torch.int64)
    with pytest.raises(ValueError):
        kernels.point_scan_steps_inner(pts)                       # needs (3, NW, T, L)
    with pytest.raises(ValueError):
        kernels.point_horner_multi(pts[None].contiguous(), 0)    # c out of range
    with pytest.raises(ValueError):
        kernels.point_reduce(pts[:, :2].contiguous())            # wrong word count
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
    if name == "point_add":
        got, want = kernels.point_add(a, b), curve_t._point_add(a, b)
    elif name == "point_scan_steps_inner":
        x = a.reshape(3, NW, 4, 10).contiguous()
        got, want = kernels.point_scan_steps_inner(x), kernels.point_scan_plain(x)
    elif name == "point_scan_steps":
        x = a.reshape(3, 4, NW, 10).contiguous()
        got, want = kernels.point_scan_steps(x), kernels.point_scan_steps_plain(x)
    elif name == "vec2":
        x, y = a[0].contiguous(), b[1].contiguous()                 # canonical mod p
        got = torch.stack([kernels.vec_mul(x, y, FP), kernels.vec_add(x, y[:, :1].contiguous(), FP),
                           kernels.vec_sub(x, y, FP)])
        want = torch.stack([mod_mul(x, y, FP), mod_add(x, y[:, :1], FP), mod_sub(x, y, FP)])
    elif name == "point_horner_multi":
        w = a.reshape(3, NW, 8, 5).permute(2, 0, 1, 3).contiguous()
        got, want = kernels.point_horner_multi(w, 9), kernels.point_horner_plain(w, 9)
    elif name == "point_reduce":
        got, want = kernels.point_reduce(a), kernels.point_reduce_plain(a)
    else:
        x = a[0].contiguous()
        got, want = kernels.mod_pow_static(x, FP.modulus - 2, FP), kernels.mod_pow_plain(x, FP.modulus - 2, FP)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
