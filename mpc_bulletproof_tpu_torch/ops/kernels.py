"""The hand-written CUDA kernels, their wrappers and their plain versions.

Sixteen kernels.  Ten carry the point, inverse and field work, each
replacing one Pallas kernel of ``mpc_bulletproof_tpu/ops/kernels.py``:

==============================  =======================  =======================
wrapper                         CUDA source (``csrc/``)  replaces
==============================  =======================  =======================
``point_add``                   ``point_add.cu``         ``point_add``
``point_scan_steps_inner``      ``point_scan.cu``        ``point_scan_steps_inner``
``point_scan_steps``            ``point_scan.cu``        ``point_scan_steps``
``point_horner_multi``          ``point_horner.cu``      ``point_horner_multi``
``point_reduce``                ``point_reduce.cu``      ``point_reduce``
``mod_pow_static``              ``mod_pow.cu``           ``mod_pow_static``
``vec_mul/vec_add/vec_sub``     ``vec2.cu``              ``_vec2``
``beaver_diff``                 ``vec2.cu``              ``_vec2`` (4 subs)
``beaver_combine``              ``vec2.cu``              ``_vec2`` (12 or 13 ops)
``poly3_eval``                  ``vec2.cu``              ``_vec2`` (12 ops)
==============================  =======================  =======================

The last three compute the device share plane's fixed expressions, which
the JAX package composes from ``_vec2``'s ops, in one launch each.  Three
more, ``probe_chain``, ``probe_xor_chain`` and ``probe_accum``
(``probes.cu``, wrappers in :mod:`.probes`), replace the Pallas op-rate
probes of the JAX package's benches.  The last three, ``keccak_chain``,
``keccak256_32`` and ``keccak_transcript`` (``keccak.cu``), replace no
Pallas kernel: the first two walk the generator chains, which the JAX
package walks with its native engine's keccak on the host
(:mod:`..generators`); the third runs the tensor transcript's hash chain
and reduces its challenges mod r (:mod:`.transcript_t`), which the JAX
package writes in jnp (``ops/keccak_jax.py``, ``ops/transcript_jax.py``)
inside its fused prover's one program.

The provers and the verifiers launch ``point_add``, ``point_scan_steps_inner``,
``point_horner_multi``, ``point_reduce`` and ``mod_pow_static``; the
collaborative prover's device share plane (:mod:`..parallel.device_shares`)
launches the vector ops and the three share-plane entries;
``point_scan_steps`` and the probes serve callers of the library (the JAX
package calls them only from its benches); ``BulletproofGens`` launches
``keccak_chain`` and ``keccak256_32``; every run of absorbs and
challenges of the tensor transcript (the fused range prover, the fused IPP
rounds) and every range-proof or IPP verification's replay (a batch's in
one) launches ``keccak_transcript``.

Every wrapper checks dtype, shape and contiguity the same way for every
device.  For a tensor on the CPU it runs the plain PyTorch version beside
it (the CPU tests use those); for a CUDA tensor it launches the kernel on
that tensor's card and its current stream, raises if the launch was
refused, and counts the launch in :data:`launches`.  There is no fallback
from one to the other.

The kernels are compiled with ``nvcc`` at first use, one shared library
per source, all sources at once (:func:`build`), into ``build/`` beside
this package, and bound with ``ctypes``: the build takes seconds, where a
source including PyTorch's headers takes minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from .curve_t import _point_add, identity
from .keccak_t import RATE, keccak256_32_plain, keccak_chain_plain, keccak_transcript_plain
from .limb import (FP, FR, NW, ModParams, from_pieces, ints_to_words, mod_add, mod_mul, mod_sub,
                   mont_mul_p, to_pieces)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# kernel name -> (source, C entry point, ctypes argtypes)
_P, _LL, _I, _U = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint64
KERNELS = {
    "point_add": ("point_add.cu", "bp_point_add", [_P, _P, _P, _LL, _I, _P]),
    "point_scan_steps_inner": ("point_scan.cu", "bp_point_scan", [_P, _P, _I, _LL, _P]),
    "point_scan_steps": ("point_scan.cu", "bp_point_scan_steps", [_P, _P, _I, _LL, _P]),
    "point_horner_multi": ("point_horner.cu", "bp_point_horner", [_P, _P, _I, _I, _LL, _P]),
    "point_reduce": ("point_reduce.cu", "bp_point_reduce", [_P, _P, _LL, _LL, _I, _I, _P]),
    "mod_pow_static": ("mod_pow.cu", "bp_mod_pow", [_P, _P, _LL, _U, _U, _U, _U, _I, _I, _P]),
    "vec2": ("vec2.cu", "bp_vec2", [_P, _P, _P, _LL, _LL, _I, _I, _P]),
    "beaver_diff": ("vec2.cu", "bp_beaver_diff", [_P, _P, _P, _P, _LL, _P]),
    "beaver_combine": ("vec2.cu", "bp_beaver_combine", [_P, _LL, _P, _P, _LL, _I, _U, _U, _U, _U, _P]),
    "poly3_eval": ("vec2.cu", "bp_poly3_eval", [_P, _P, _LL, _U, _U, _U, _U, _P]),
    "probe_chain": ("probes.cu", "bp_probe_chain", [_P, _P, _P, _LL, _I, _I, _P]),
    "probe_xor_chain": ("probes.cu", "bp_probe_xor_chain", [_P, _P, _LL, _I, _I, _P]),
    "probe_accum": ("probes.cu", "bp_probe_accum", [_P, _P, _P, _LL, _I, _I, _P]),
    "keccak_chain": ("keccak.cu", "bp_keccak_chain", [_P, _P, _LL, _LL, _LL, _P]),
    "keccak256_32": ("keccak.cu", "bp_keccak256_32", [_P, _P, _LL, _P]),
    "keccak_transcript": ("keccak.cu", "bp_keccak_transcript", [_P, _P, _P, _P, _LL, _LL, _LL, _LL, _P, _P, _P]),
}

# Launches per kernel since the last reset_launches(); only a launch of the
# CUDA kernel counts, never a run of the plain version.  Threads may launch
# at once (the two parties of the MPC prover): the counts, the build and
# the library loads are taken under one lock.
launches = {name: 0 for name in KERNELS}

_FNS: dict = {}
_LOCK = threading.RLock()


def reset_launches() -> None:
    with _LOCK:
        for name in launches:
            launches[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(source: str) -> Path:
    """Library path keyed by the source, the shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / source] + sorted(CSRC.glob("*.cuh")):
        h.update(f.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every kernel source that has no library yet, one ``nvcc`` per
    source (two kernels may share one), all started together.  Returns
    ``{name: (library path, ptxas report)}``; raises with the compiler's
    output if any build fails."""
    with _LOCK:
        return _build()


def _build() -> dict:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source in sorted({source for source, _, _ in KERNELS.values()}):
        lib = _lib_path(source)
        if not lib.exists():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
            procs[source] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True), tmp, lib)
    failed = []
    for source, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        lib.with_suffix(".log").write_text(out)
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{source}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    report = {}
    for name, (source, _, _) in KERNELS.items():
        lib = _lib_path(source)
        log = lib.with_suffix(".log")
        report[name] = (str(lib), log.read_text() if log.exists() else "")
    return report


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        with _LOCK:
            fn = _FNS.get(name)
            if fn is None:
                source, symbol, argtypes = KERNELS[name]
                lib = _lib_path(source)
                if not lib.exists():
                    _build()
                fn = getattr(ctypes.CDLL(str(lib)), symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _FNS[name] = fn
    return fn


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` on the current stream of ``device``, the
    operands' card.  The ctypes entry launches on the calling thread's
    current device, so a ``device`` that is not current is made current
    around it: on a mesh whose shards sit on several cards, each shard's
    kernels run on its own.  On the current card nothing is switched."""
    if device.index == torch.cuda.current_device():
        rc = _fn(name)(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            rc = _fn(name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    with _LOCK:
        launches[name] += 1


def _check(t: torch.Tensor, what: str, shape=None, lead=None) -> str:
    """Validate a kernel operand; returns its device type ('cpu' or 'cuda')."""
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int64:
        raise TypeError(f"{what}: expected an int64 tensor")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if lead is not None and tuple(t.shape[: len(lead)]) != tuple(lead):
        raise ValueError(f"{what}: expected leading dims {tuple(lead)}, got {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type


# ---------------------------------------------------------------------------
# point_add
# ---------------------------------------------------------------------------

# Widest batch the narrow design (8 lanes an add) takes; wider batches get
# one thread an add.  Measured on one H100 80GB HBM3 at 700 W, both designs
# in turns (chip_smoke.py's point_add_sweep, device us, wide / narrow):
# 2,048 lanes 8.20 / 3.96, 4,096 8.26 / 5.51, 8,192 8.33 / 8.99, 16,384
# 8.57 / 15.18 (csrc/point_add.cu has the whole sweep; PERF.md).
POINT_ADD_NARROW_MAX = 4096


def point_add_design(lanes: int) -> str:
    """The design :func:`point_add` launches for a batch of this width."""
    return "narrow" if lanes <= POINT_ADD_NARROW_MAX else "wide"


def _point_add_launch(a: torch.Tensor, b: torch.Tensor, design: str) -> torch.Tensor:
    out = torch.empty_like(a)
    _launch("point_add", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel() // (3 * NW),
            {"wide": 0, "narrow": 1}[design])
    return out


def point_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Complete point addition of two ``(3, NW, *batch)`` batches of the same
    shape.  No broadcasting: the caller expands an operand explicitly."""
    dev = _check(a, "point_add a", lead=(3, NW))
    if _check(b, "point_add b", shape=a.shape) != dev or b.device != a.device:
        raise ValueError("point_add: operands on different devices")
    if dev == "cpu":
        return _point_add(a, b)
    return _point_add_launch(a, b, point_add_design(a.numel() // (3 * NW)))


# ---------------------------------------------------------------------------
# point_scan_steps_inner, point_scan_steps
# ---------------------------------------------------------------------------

def point_scan_plain(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along axis 2 of ``(3, NW, T, L)``, step by step."""
    acc = x[:, :, 0]
    outs = [acc]
    for t in range(1, x.shape[2]):
        acc = _point_add(acc, x[:, :, t])
        outs.append(acc)
    return torch.stack(outs, dim=2)


def point_scan_steps_inner(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix point-sum along the step axis T of a ``(3, NW, T, L)``
    batch; the L lanes are independent scans."""
    dev = _check(x, "point_scan_steps_inner x", lead=(3, NW))
    if x.dim() != 4:
        raise ValueError("point_scan_steps_inner: expected (3, NW, T, L)")
    if dev == "cpu":
        return point_scan_plain(x)
    out = torch.empty_like(x)
    _launch("point_scan_steps_inner", x.device, x.data_ptr(), out.data_ptr(), x.shape[2], x.shape[3])
    return out


def point_scan_steps_plain(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along axis 1 of ``(3, T, NW, L)``, step by step."""
    return point_scan_plain(x.transpose(1, 2)).transpose(1, 2).contiguous()


def point_scan_steps(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix point-sum along the step axis T of a ``(3, T, NW, L)``
    batch (the step axis outside the words); the L lanes are independent."""
    dev = _check(x, "point_scan_steps x")
    if x.dim() != 4 or x.shape[0] != 3 or x.shape[2] != NW:
        raise ValueError("point_scan_steps: expected (3, T, NW, L)")
    if dev == "cpu":
        return point_scan_steps_plain(x)
    out = torch.empty_like(x)
    _launch("point_scan_steps", x.device, x.data_ptr(), out.data_ptr(), x.shape[1], x.shape[3])
    return out


# ---------------------------------------------------------------------------
# point_horner_multi
# ---------------------------------------------------------------------------

def point_horner_plain(window_sums: torch.Tensor, c: int) -> torch.Tensor:
    """``sum_w 2^(c w) S_w``: from the most significant window's sum, per
    lower window c doublings then one add."""
    acc = window_sums[-1]
    for w in range(window_sums.shape[0] - 2, -1, -1):
        for _ in range(c):
            acc = _point_add(acc, acc)
        acc = _point_add(acc, window_sums[w])
    return acc.contiguous()


def point_horner_multi(window_sums: torch.Tensor, c: int) -> torch.Tensor:
    """Horner combine of ``(nw, 3, NW, k)`` window sums (window 0 least
    significant) -> ``(3, NW, k)``."""
    dev = _check(window_sums, "point_horner_multi window_sums")
    if window_sums.dim() != 4 or tuple(window_sums.shape[1:3]) != (3, NW) or window_sums.shape[0] < 1:
        raise ValueError("point_horner_multi: expected (nw, 3, NW, k)")
    if not 1 <= c <= 30:
        raise ValueError("point_horner_multi: window size out of range")
    if dev == "cpu":
        return point_horner_plain(window_sums, c)
    nw, _, _, k = window_sums.shape
    out = torch.empty((3, NW, k), dtype=torch.int64, device=window_sums.device)
    _launch("point_horner_multi", window_sums.device, window_sums.data_ptr(), out.data_ptr(), nw, c, k)
    return out


# ---------------------------------------------------------------------------
# point_reduce
# ---------------------------------------------------------------------------

# The plan's rule (csrc/point_reduce.cu has the design).  Fold runs with the
# one-thread add only while the folds keep REDUCE_FOLD_THREADS threads (two
# warps a scheduler: the multiplier's issue, not the add's latency, bounds
# them) and REDUCE_FOLD_MIN_WIDTH threads a segment (a warp's loads fill
# 32-byte sectors); split the rest into tree passes of at most
# REDUCE_TREE_LEVELS warp-split levels, as few passes as that allows, the
# extra levels in the later passes.
REDUCE_FOLD_THREADS = 32768
REDUCE_FOLD_MIN_WIDTH = 4
REDUCE_TREE_LEVELS = 6  # the kernel's limit (csrc/point_reduce.cu TREE_MAX_LEVELS)


def point_reduce_plan(segments: int, n: int) -> list:
    """The passes that sum ``segments`` segments of ``n >= 1`` points each:
    ``("fold", run)`` then ``("tree", levels)`` entries, each one launch."""
    plan, m, run = [], n, 1
    while -(-m // (2 * run)) >= REDUCE_FOLD_MIN_WIDTH and segments * -(-m // (2 * run)) >= REDUCE_FOLD_THREADS:
        run *= 2
    if run > 1:
        plan.append(("fold", run))
        m = -(-m // run)
    levels = (m - 1).bit_length()
    passes = -(-levels // REDUCE_TREE_LEVELS)
    for k in range(passes):
        plan.append(("tree", levels // passes + (k >= passes - levels % passes)))
    return plan


def _pass_width(m: int, kind: str, param: int) -> int:
    return -(-m // (param if kind == "fold" else 1 << param))


def _fold_plain(x: torch.Tensor, run: int) -> torch.Tensor:
    """``(3, NW, S, m) -> (3, NW, S, w)``, ``w = ceil(m / run)``: lane t adds
    points t + w, t + 2w, ... to point t, in that order."""
    m = x.shape[-1]
    w = -(-m // run)
    acc = x[..., :w]
    for k in range(1, run):
        count = min(w, m - k * w)
        if count <= 0:
            break
        head = _point_add(acc[..., :count], x[..., k * w : k * w + count])
        acc = torch.cat([head, acc[..., count:]], dim=-1)
    return acc


def _tree_plain(x: torch.Tensor, levels: int) -> torch.Tensor:
    """``(3, NW, S, m) -> (3, NW, S, ceil(m / 2^levels))``: sub-trees of
    2^levels consecutive points (identity past m), neighbours added
    pairwise level by level."""
    S, m = x.shape[2:]
    C = 1 << levels
    w = -(-m // C)
    if w * C != m:
        x = torch.cat([x, identity((S, w * C - m), x.device)], dim=-1)
    x = x.reshape(3, NW, S, w, C)
    for _ in range(levels):
        x = _point_add(x[..., 0::2], x[..., 1::2])
    return x[..., 0]


def _reduce_shape(pts: torch.Tensor) -> tuple:
    """``(device type, batch, segments, n)`` of a ``(3, NW, *batch, n)`` operand."""
    dev = _check(pts, "point_reduce pts", lead=(3, NW))
    if pts.dim() < 3:
        raise ValueError("point_reduce: expected (3, NW, *batch, n)")
    batch = tuple(pts.shape[2:-1])
    return dev, batch, math.prod(batch), pts.shape[-1]


def point_reduce_plain(pts: torch.Tensor, plan: list | None = None) -> torch.Tensor:
    """Segment sums of ``(3, NW, *batch, n)`` -> ``(3, NW, *batch, 1)``, pass
    by pass in the kernel's order (``plan``, by default
    :func:`point_reduce_plan`'s): the same order gives the same projective
    words, not only the same group elements."""
    _, batch, S, n = _reduce_shape(pts)
    if S == 0 or n == 0:
        return identity((*batch, 1), pts.device).contiguous()
    x = pts.reshape(3, NW, S, n)
    for kind, param in point_reduce_plan(S, n) if plan is None else plan:
        x = _fold_plain(x, param) if kind == "fold" else _tree_plain(x, param)
    return x.reshape(3, NW, *batch, 1).contiguous()


def _point_reduce_launch(pts: torch.Tensor, plan: list) -> torch.Tensor:
    """The passes of ``plan`` on a contiguous ``(3, NW, *batch, n)`` operand,
    one launch each."""
    _, batch, S, n = _reduce_shape(pts)
    if S == 0 or n == 0:
        return identity((*batch, 1), pts.device).contiguous()
    m = n
    for kind, param in plan:
        m = _pass_width(m, kind, param)
    if m != 1:
        raise ValueError("point_reduce: the plan leaves more than one point a segment")
    x = pts.reshape(3, NW, S, n)
    for kind, param in plan:
        m = x.shape[-1]
        out = torch.empty((3, NW, S, _pass_width(m, kind, param)), dtype=torch.int64, device=pts.device)
        _launch("point_reduce", x.device, x.data_ptr(), out.data_ptr(), S, m, int(kind == "fold"), param)
        x = out
    out = x.reshape(3, NW, *batch, 1)
    return out if plan else out.clone()


def point_reduce(pts: torch.Tensor) -> torch.Tensor:
    """Segment sums: the last axis of a contiguous ``(3, NW, *batch, n)``
    batch summed, ``(3, NW, *batch, 1)``; the ``prod(batch)`` segments are
    independent.  No segment (``n = 0``) sums to the identity."""
    dev, _, S, n = _reduce_shape(pts)
    if dev == "cpu":
        return point_reduce_plain(pts)
    return _point_reduce_launch(pts, point_reduce_plan(S, n) if S and n else [])


# ---------------------------------------------------------------------------
# mod_pow_static
# ---------------------------------------------------------------------------

def _ladder_plain(xp: torch.Tensor, exponent: int, mp: ModParams) -> torch.Tensor:
    """``x^e`` on Montgomery-form pieces by the kernel's ladder: a table of
    x^0..x^15, then per base-16 digit (most significant first, leading zeros
    skipped) four squarings and one product by the digit's entry."""
    one = to_pieces(torch.as_tensor(ints_to_words([mp.mont_r]), device=xp.device)).expand_as(xp)
    table = [one, xp]
    for _ in range(14):
        table.append(mont_mul_p(table[-1], xp, mp))
    acc = one
    started = False
    for d in range(63, -1, -1):
        digit = (exponent >> (4 * d)) & 15
        if started:
            for _ in range(4):
                acc = mont_mul_p(acc, acc, mp)
        if digit:
            acc = mont_mul_p(acc, table[digit], mp)
            started = True
    return acc


def _batch_inverse_plain(xp: torch.Tensor, mp: ModParams) -> torch.Tensor:
    """Inverses of nonzero Montgomery-form pieces ``(NP, n)`` by Montgomery's
    trick: prefix and suffix products (log-depth doubling scans), one
    ladder for the inverse of the total, then ``x_i^-1 = total^-1
    prod_{j != i} x_j``."""
    n = xp.shape[-1]
    mul = lambda a, b: mont_mul_p(a, b, mp)
    pre, suf, sh = xp, xp, 1
    while sh < n:
        pre = torch.cat([pre[:, :sh], mul(pre[:, sh:], pre[:, :-sh])], dim=-1)
        suf = torch.cat([mul(suf[:, :-sh], suf[:, sh:]), suf[:, n - sh :]], dim=-1)
        sh *= 2
    inv_total = _ladder_plain(pre[:, -1:], mp.modulus - 2, mp)
    one = to_pieces(torch.as_tensor(ints_to_words([mp.mont_r]), device=xp.device))
    excl_pre = torch.cat([one, pre[:, :-1]], dim=-1)
    excl_suf = torch.cat([suf[:, 1:], one], dim=-1)
    return mul(mul(excl_pre, excl_suf), inv_total)


def is_inverse(exponent: int, mp: ModParams) -> bool:
    """Whether ``x^exponent mod m`` is the inverse (``e = m - 2``), which the
    kernel computes by a binary GCD and the plain version as a batch."""
    return exponent == mp.modulus - 2


def mod_pow_plain(x: torch.Tensor, exponent: int, mp: ModParams) -> torch.Tensor:
    """``x^e mod m``, the kernel's function in plain tensor code.  The ladder
    runs lane by lane, except for the inverse exponent ``e = m - 2``: there
    the batch shares one ladder (:func:`_batch_inverse_plain`).  Inverses
    are unique, so both give the kernel's words."""
    dev = x.device
    zero = (x == 0).all(dim=0)
    inverse = is_inverse(exponent, mp)
    if inverse:
        x = torch.where(zero[None], 1, x)
    xp = mont_mul_p(to_pieces(x), mp.t("r2", dev), mp)
    acc = _batch_inverse_plain(xp, mp) if inverse else _ladder_plain(xp, exponent, mp)
    unit = to_pieces(torch.as_tensor(ints_to_words([1]), device=dev))
    out = from_pieces(mont_mul_p(acc, unit, mp))
    if inverse:
        out = torch.where(zero[None], 0, out)
    return out.contiguous()


def _mod_pow_launch(x: torch.Tensor, exponent: int, mp: ModParams, inverse: bool) -> torch.Tensor:
    out = torch.empty_like(x)
    ew = [(exponent >> (64 * j)) & ((1 << 64) - 1) for j in range(4)]
    _launch("mod_pow_static", x.device, x.data_ptr(), out.data_ptr(), x.shape[-1], *ew,
            0 if mp is FP else 1, int(inverse))
    return out


def mod_pow_static(x: torch.Tensor, exponent: int, mp: ModParams = FR) -> torch.Tensor:
    """Batched ``x^exponent mod m`` over canonical ``(NW, n)`` words, for a
    fixed exponent ``0 <= e < 2^256``; ``x = 0`` gives 0 (for ``e > 0``).
    With ``e = m - 2`` it is the inverse: the kernel runs a binary GCD
    instead of the ladder."""
    dev = _check(x, "mod_pow_static x", lead=(NW,))
    if x.dim() != 2:
        raise ValueError("mod_pow_static: expected (NW, n)")
    if mp is not FP and mp is not FR:
        raise ValueError("mod_pow_static: the kernel serves FP and FR only")
    e = int(exponent)
    if not 0 <= e < 1 << 256:
        raise ValueError("mod_pow_static: exponent out of range")
    if dev == "cpu":
        return mod_pow_plain(x, e, mp)
    return _mod_pow_launch(x, e, mp, is_inverse(e, mp))


# ---------------------------------------------------------------------------
# vec_mul / vec_add / vec_sub
# ---------------------------------------------------------------------------

_VEC_OPS = {"mul": (0, mod_mul), "add": (1, mod_add), "sub": (2, mod_sub)}


def _vec2(op: str, a: torch.Tensor, b: torch.Tensor, mp: ModParams) -> torch.Tensor:
    """Elementwise ``a op b mod m`` over canonical standard-form ``(NW, n)``
    words; a ``(NW, 1)`` operand ``b`` is broadcast over the lanes."""
    code, plain = _VEC_OPS[op]
    dev = _check(a, f"vec_{op} a", lead=(NW,))
    if _check(b, f"vec_{op} b", lead=(NW,)) != dev or b.device != a.device:
        raise ValueError(f"vec_{op}: operands on different devices")
    if a.dim() != 2 or b.dim() != 2 or b.shape[-1] not in (a.shape[-1], 1):
        raise ValueError(f"vec_{op}: expected (NW, n) and (NW, n) or (NW, 1)")
    if mp is not FP and mp is not FR:
        raise ValueError(f"vec_{op}: the kernel serves FP and FR only")
    if dev == "cpu":
        return plain(a, b, mp).contiguous()
    out = torch.empty_like(a)
    _launch("vec2", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[-1], b.shape[-1], code,
            0 if mp is FP else 1)
    return out


def vec_mul(a: torch.Tensor, b: torch.Tensor, mp: ModParams = FR) -> torch.Tensor:
    """``(a * b) mod m`` lane by lane."""
    return _vec2("mul", a, b, mp)


def vec_add(a: torch.Tensor, b: torch.Tensor, mp: ModParams = FR) -> torch.Tensor:
    """``(a + b) mod m`` lane by lane."""
    return _vec2("add", a, b, mp)


def vec_sub(a: torch.Tensor, b: torch.Tensor, mp: ModParams = FR) -> torch.Tensor:
    """``(a - b) mod m`` lane by lane."""
    return _vec2("sub", a, b, mp)


# ---------------------------------------------------------------------------
# the device share plane's expressions: beaver_diff, beaver_combine, poly3_eval
# ---------------------------------------------------------------------------
#
# FR only, canonical standard-form words in and out.  A share pair is the
# (2, NW, k) stack of a share vector's values and MACs; the triple is the
# (3, 2, NW, k) stack of the pairs of a, b and c, the coefficients the
# (4, 2, NW, k) stack of the pairs of c0..c3.  Public scalars are Python
# ints in [0, r); the kernels take them in Montgomery form by value.

def _mont_words(x: int, what: str) -> list:
    """``x R mod r`` as four 64-bit words, for a public ``0 <= x < r``."""
    x = int(x)
    if not 0 <= x < FR.modulus:
        raise ValueError(f"{what}: a public scalar must lie in [0, r)")
    v = x * FR.mont_r % FR.modulus
    return [(v >> (64 * j)) & ((1 << 64) - 1) for j in range(NW)]


def _check_pairs(t: torch.Tensor, what: str, count: int) -> tuple:
    """``(device type, k)`` of a ``(count, 2, NW, k)`` stack of share pairs."""
    dev = _check(t, what, lead=(count, 2, NW))
    if t.dim() != 4:
        raise ValueError(f"{what}: expected ({count}, 2, NW, k)")
    return dev, t.shape[-1]


def _same_device(name: str, first: torch.Tensor, *others: torch.Tensor) -> None:
    if any(t.device != first.device for t in others):
        raise ValueError(f"{name}: operands on different devices")


def beaver_diff_plain(x: torch.Tensor, y: torch.Tensor, triple: torch.Tensor) -> torch.Tensor:
    return torch.cat([mod_sub(x, triple[0, 0], FR), mod_sub(y, triple[1, 0], FR)], dim=-1)


def beaver_diff(x: torch.Tensor, y: torch.Tensor, triple: torch.Tensor) -> torch.Tensor:
    """``[x - a | y - b]``, ``(NW, 2k)``: the shares a Beaver round opens,
    for ``(NW, k)`` shares x and y and the triple's shares a and b."""
    dev, k = _check_pairs(triple, "beaver_diff triple", 3)
    _check(x, "beaver_diff x", shape=(NW, k))
    _check(y, "beaver_diff y", shape=(NW, k))
    _same_device("beaver_diff", triple, x, y)
    if dev == "cpu":
        return beaver_diff_plain(x, y, triple)
    out = torch.empty((NW, 2 * k), dtype=torch.int64, device=x.device)
    _launch("beaver_diff", x.device, x.data_ptr(), y.data_ptr(), triple.data_ptr(), out.data_ptr(), k)
    return out


def beaver_combine_plain(de: torch.Tensor, triple: torch.Tensor, alpha: int, party: int) -> torch.Tensor:
    k = triple.shape[-1]
    d, e = de[:, :k], de[:, k:]
    (a, a_mac), (b, b_mac), (c, c_mac) = triple
    d_e = mod_mul(d, e, FR)
    shares = mod_add(mod_add(c, mod_mul(b, d, FR), FR), mod_mul(a, e, FR), FR)
    if party == 0:
        shares = mod_add(shares, d_e, FR)
    alpha_w = torch.as_tensor(ints_to_words([alpha]), device=de.device)
    macs = mod_add(mod_add(c_mac, mod_mul(b_mac, d, FR), FR), mod_mul(a_mac, e, FR), FR)
    return torch.stack([shares, mod_add(macs, mod_mul(d_e, alpha_w, FR), FR)])


def beaver_combine(de: torch.Tensor, triple: torch.Tensor, alpha: int, party: int) -> torch.Tensor:
    """One party's share pair of ``x y`` from a Beaver round: ``z = c + d b
    + e a`` (``+ d e`` on party 0), its MAC ``c_m + d b_m + e a_m + alpha d
    e``, for the opened ``de = [d | e]`` (``(NW, 2k)``, read in place), the
    triple's pairs and the party's MAC key share ``alpha``."""
    dev, k = _check_pairs(triple, "beaver_combine triple", 3)
    _check(de, "beaver_combine de", shape=(NW, 2 * k))
    _same_device("beaver_combine", triple, de)
    if party not in (0, 1):
        raise ValueError("beaver_combine: party is 0 or 1")
    words = _mont_words(alpha, "beaver_combine alpha")
    if dev == "cpu":
        return beaver_combine_plain(de, triple, int(alpha), party)
    out = torch.empty((2, NW, k), dtype=torch.int64, device=de.device)
    _launch("beaver_combine", de.device, de.data_ptr(), de.shape[-1], triple.data_ptr(), out.data_ptr(), k, party,
            *words)
    return out


def poly3_eval_plain(coeffs: torch.Tensor, x: int) -> torch.Tensor:
    c = coeffs.movedim(2, 0)                                   # (NW, 4, 2, k)
    xw = torch.as_tensor(ints_to_words([x]), device=coeffs.device).reshape(NW, 1, 1)
    acc = c[:, 3]
    for j in (2, 1, 0):
        acc = mod_add(mod_mul(acc, xw, FR), c[:, j], FR)
    return acc.movedim(0, 1).contiguous()


def poly3_eval(coeffs: torch.Tensor, x: int) -> torch.Tensor:
    """``c0 + c1 x + c2 x^2 + c3 x^3`` at a public ``x`` on both rows (values
    and MACs) of the coefficients' share pairs, ``(2, NW, k)``."""
    dev, k = _check_pairs(coeffs, "poly3_eval coeffs", 4)
    words = _mont_words(x, "poly3_eval x")
    if dev == "cpu":
        return poly3_eval_plain(coeffs, int(x))
    out = torch.empty((2, NW, k), dtype=torch.int64, device=coeffs.device)
    _launch("poly3_eval", coeffs.device, coeffs.data_ptr(), out.data_ptr(), k, *words)
    return out


# ---------------------------------------------------------------------------
# keccak_chain, keccak256_32: the generator chains
# ---------------------------------------------------------------------------

def _check_rows32(t: torch.Tensor, what: str) -> str:
    """Validate ``(k, 32)`` uint8 byte rows; returns the device type.  The
    kernel reads them as 64-bit words, so on the card they must be 8-byte
    aligned."""
    if not isinstance(t, torch.Tensor) or t.dtype != torch.uint8:
        raise TypeError(f"{what}: expected a uint8 tensor")
    if t.dim() != 2 or t.shape[1] != 32:
        raise ValueError(f"{what}: expected (k, 32) byte rows, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    if t.device.type == "cuda" and t.data_ptr() % 8:
        raise ValueError(f"{what}: the kernel needs 8-byte aligned rows")
    return t.device.type


def keccak_chain(starts: torch.Tensor, skip: int, count: int) -> torch.Tensor:
    """Walk each of the ``(C, 32)`` start states ``skip`` steps of
    ``s <- keccak256(s)`` without writing, then ``count`` steps, and return
    those ``(C, count, 32)`` states (a generator chain's walk, one chain a
    warp)."""
    dev = _check_rows32(starts, "keccak_chain starts")
    skip, count = int(skip), int(count)
    if skip < 0 or count < 0:
        raise ValueError("keccak_chain: skip and count must be >= 0")
    if dev == "cpu":
        return keccak_chain_plain(starts, skip, count)
    out = torch.empty((starts.shape[0], count, 32), dtype=torch.uint8, device=starts.device)
    if starts.shape[0] and count:
        _launch("keccak_chain", starts.device, starts.data_ptr(), out.data_ptr(), starts.shape[0], skip, count)
    return out


def keccak256_32(msgs: torch.Tensor) -> torch.Tensor:
    """keccak256 of each of the ``(N, 32)`` byte rows, all in parallel."""
    if _check_rows32(msgs, "keccak256_32 msgs") == "cpu":
        return keccak256_32_plain(msgs)
    out = torch.empty_like(msgs)
    if msgs.shape[0]:
        _launch("keccak256_32", msgs.device, msgs.data_ptr(), out.data_ptr(), msgs.shape[0])
    return out


# ---------------------------------------------------------------------------
# keccak_transcript: the Fiat-Shamir transcript's hash chain
# ---------------------------------------------------------------------------

# A block's dynamic shared memory on Hopper, and what a transcript block
# stages (csrc/keccak.cu transcript_smem): the run must fit.
TRANSCRIPT_SMEM_MAX = 232448


def transcript_smem(blocks: int, msg_words: int, challenges: int) -> int:
    return 8 * (RATE // 8 * blocks + msg_words + 4 * challenges + 4 * blocks) + 16


class TranscriptPlan(NamedTuple):
    """A run of transcript blocks, checked on the host by
    :func:`transcript_plan`: ``template`` ``(J, 17)`` words (labels, host
    constants and padding; words 0-3 are not read), ``layout`` ``(J, 4)``
    (block ``i``'s first message word's position in the block, its
    message's words, their offset in a message row, and 1 for a
    challenge), both on the run's device; the message words a transcript
    and the challenges the layout flags."""
    template: torch.Tensor
    layout: torch.Tensor
    words: int
    challenges: int


def transcript_plan(template, layout, device) -> TranscriptPlan:
    """Check a run's host ``template`` and ``layout`` (int64 arrays, as in
    :class:`TranscriptPlan`) and put them on ``device``.  Every block's
    message words lie in words 4-16 of the block and in the message row,
    every flag is 0 or 1, a challenge takes no message, and the run fits a
    block's shared memory; so the kernel and its plain version take the
    same runs and read nothing outside them.  Raises ``ValueError``."""
    template = torch.as_tensor(template, dtype=torch.int64)
    layout = torch.as_tensor(layout, dtype=torch.int64)
    if template.dim() != 2 or template.shape[1] != RATE // 8:
        raise ValueError(f"keccak_transcript template: expected (J, {RATE // 8}) words, got {tuple(template.shape)}")
    if tuple(layout.shape) != (template.shape[0], 4):
        raise ValueError(f"keccak_transcript layout: expected ({template.shape[0]}, 4), got {tuple(layout.shape)}")
    pos, n, off, flag = layout.T
    if not bool(((flag == 0) | (flag == 1)).all()):
        raise ValueError("keccak_transcript layout: a challenge flag is 0 or 1")
    if bool((n < 0).any()) or bool(((flag == 1) & (n != 0)).any()):
        raise ValueError("keccak_transcript layout: message words >= 0, and none at a challenge")
    has = n > 0
    if bool((has & ((pos < 4) | (pos + n > RATE // 8) | (off < 0))).any()):
        raise ValueError("keccak_transcript layout: a message outside words 4-16 of its block")
    words, challenges = int((off + n)[has].max()) if bool(has.any()) else 0, int(flag.sum())
    if transcript_smem(template.shape[0], words, challenges) > TRANSCRIPT_SMEM_MAX:
        raise ValueError("keccak_transcript: the run does not fit a block's shared memory")
    return TranscriptPlan(template.to(device).contiguous(), layout.to(device).contiguous(), words, challenges)


def keccak_transcript(starts: torch.Tensor, plan: TranscriptPlan, msgs: torch.Tensor):
    """Run the blocks of ``plan`` (:func:`transcript_plan`) from each of the
    ``(T, 4)`` word states ``starts``, with the ``(T, plan.words)`` message
    words placed as its layout says, and squeeze each challenge:
    ``LE(state' || keccak256(state')) mod r``.  One launch, a block a
    transcript.  Returns the final states ``(T, 4)`` and the
    ``plan.challenges`` challenges ``(T, NW, C)``, canonical words in run
    order."""
    if not isinstance(plan, TranscriptPlan):
        raise TypeError("keccak_transcript: the run is a TranscriptPlan (transcript_plan checks it)")
    dev = _check(starts, "keccak_transcript starts")
    ops = ((plan.template, "template"), (plan.layout, "layout"), (msgs, "msgs"))
    if any(_check(t, f"keccak_transcript {what}") != dev or t.device != starts.device for t, what in ops):
        raise ValueError("keccak_transcript: every operand on the same device")
    if starts.dim() != 2 or starts.shape[1] != 4:
        raise ValueError(f"keccak_transcript starts: expected (T, 4) words, got {tuple(starts.shape)}")
    if tuple(msgs.shape) != (starts.shape[0], plan.words):
        raise ValueError(f"keccak_transcript msgs: expected ({starts.shape[0]}, {plan.words}) words, "
                         f"got {tuple(msgs.shape)}")
    if dev == "cpu":
        return keccak_transcript_plain(starts, plan.template, plan.layout, msgs, plan.challenges)
    states = torch.empty_like(starts)
    chals = torch.empty((starts.shape[0], NW, plan.challenges), dtype=torch.int64, device=starts.device)
    if starts.shape[0]:
        _launch("keccak_transcript", starts.device, starts.data_ptr(), plan.template.data_ptr(), plan.layout.data_ptr(),
                msgs.data_ptr(), starts.shape[0], plan.template.shape[0], plan.words, plan.challenges,
                states.data_ptr(), chals.data_ptr())
    return states, chals
