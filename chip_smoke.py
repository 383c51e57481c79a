#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py    # from the repository root, on a machine with one card

Phases, one JSON object per line on standard output:

1. ``env``: torch and CUDA versions, the ``nvcc`` path, the card.
2. ``build``: all five CUDA kernels built from ``mpc_bulletproof_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel), with each library's ptxas report.
3. ``kernel``: each kernel against its plain PyTorch version on the card, at
   the shapes of the aggregated m = 64 proof, with worst-case lanes
   (identity, doubling, P + (-P), coordinates near p, 0 and m - 1 for the
   inverse); equality is exact on the 64-bit words.  Times by CUDA events.
4. ``main_path``: ``RangeProof.prove_multiple`` at (n, m) = (64, 64) on the
   pinned inputs; the digest of proof, commitments and transcript must equal
   the JAX package's (``mpc_bulletproof_tpu_torch/pinned.py``).  Launch
   counts are read around one proof, then the median of warm proofs.
   ``profile``: device time by kernel over one more warm proof
   (torch.profiler) and the device's idle share.
5. the ``kernels`` summary, the card's ``nvidia-smi`` name and power limit,
   and last ``{"ok": true, "device": {...}}``.

Any failed phase raises and the script exits non-zero without the last
line.  Without a CUDA device it exits 1 at once.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

N_BITS, M_PARTIES = 64, 64
WARM_PROOFS = 3

# Bounds: NVIDIA's published H100 SXM rates (data sheet, dense, 700 W):
# 3.35 TB/s of HBM, 67 TFLOP/s float32 outside the tensor cores.  There is
# no published integer rate outside the tensor cores; the integer
# multiply-add issues no faster than the float32 FMA, so the float32 rate
# gives a lower bound on the time (2 operations per 32-bit multiply-add).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Montgomery product on 4 x 64-bit words: 16 word products for a b plus the
# reduction (4 for p = [1, 0, 0, 2^59 + 17] with m' = -1; 20 for r), each a
# 64 x 64 -> 128 product of four 32-bit multiply-adds.
FP_MUL_OPS = 2 * 4 * (16 + 4)
FR_MUL_OPS = 2 * 4 * (16 + 20)
POINT_ADD_OPS = 14 * FP_MUL_OPS  # 12 products + 2 by the constant 3b
POINT_BYTES = 3 * 4 * 8

REPLACES = {
    "point_add": "mpc_bulletproof_tpu/ops/kernels.py:164",
    "point_scan_steps_inner": "mpc_bulletproof_tpu/ops/kernels.py:253",
    "point_horner_multi": "mpc_bulletproof_tpu/ops/kernels.py:329",
    "point_reduce": "mpc_bulletproof_tpu/ops/kernels.py:419",
    "mod_pow_static": "mpc_bulletproof_tpu/ops/kernels.py:497",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b, word_dim: int) -> float:
    """Largest |a - b| over the canonical integers of two word tensors
    (the 64-bit words of an element on axis ``word_dim``)."""
    import torch

    from mpc_bulletproof_tpu_torch.ops.limb import NW, words_to_ints

    if torch.equal(a, b):
        return 0.0
    a, b = (t.movedim(word_dim, 0).reshape(NW, -1) for t in (a, b))
    return float(max(abs(x - y) for x, y in zip(words_to_ints(a), words_to_ints(b))))


def random_points(pool, count: int, gen):
    """``count`` points drawn from ``pool`` with random projective scaling
    (some lanes by p - 1, so coordinates lie near p) and every 7th lane the
    identity."""
    import torch

    from mpc_bulletproof_tpu_torch.constants import P
    from mpc_bulletproof_tpu_torch.ops import curve_t, limb

    dev = pool.device
    idx = torch.randint(0, pool.shape[-1], (count,), generator=gen, device=dev)
    pts = pool[:, :, idx]
    lam = torch.randint(-(2**63), 2**63 - 1, (4, count), generator=gen, device=dev)
    lam[3] &= (1 << 58) - 1                                    # < 2^250 < p
    lam[0] |= 1                                                # nonzero
    lam[:, 1::3] = torch.as_tensor(limb.ints_to_words([P - 1]), device=dev)
    pts = torch.stack([limb.mod_mul(pts[c], lam, limb.FP) for c in range(3)])
    ident = curve_t.identity((count,), dev)
    return curve_t._point_select(torch.arange(count, device=dev) % 7 == 3, ident, pts).contiguous()


def check_kernels(gpu: str, dev, n_bits: int = N_BITS, m_parties: int = M_PARTIES) -> dict:
    """Each kernel against its plain version at main-path shapes."""
    import torch

    from mpc_bulletproof_tpu_torch.constants import P, R
    from mpc_bulletproof_tpu_torch.ops import curve_t, kernels, limb
    from mpc_bulletproof_tpu_torch.ops import msm as msm_mod
    from mpc_bulletproof_tpu_torch.ops.curve import StarkPoint
    from mpc_bulletproof_tpu_torch.ops.limb import FP, FR, NW

    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    G = StarkPoint.generator()
    host_pool = [G]
    for _ in range(63):
        host_pool.append(host_pool[-1] + host_pool[-1] + G)
    pool = torch.as_tensor(curve_t.points_from_host(host_pool), device=dev)
    nm = n_bits * m_parties

    # shapes of the main path
    W_ipp, n_ipp = 2 * 8, msm_mod.SPLIT_CHUNKS * (nm + 1)        # L/R pair, 8 windows each
    nt, T = msm_mod._chunk_shape(W_ipp, n_ipp)
    add_n = W_ipp * nt                                           # chunk-offset lane scan
    a = random_points(pool, add_n, gen)
    b = random_points(pool, add_n, gen)
    b[:, :, 1::5] = a[:, :, 1::5]                                # doubling
    b[:, :, 2::5] = curve_t._point_neg(a[:, :, 2::5])            # P + (-P)
    a, b = a.reshape(3, NW, W_ipp, nt).contiguous(), b.reshape(3, NW, W_ipp, nt).contiguous()
    scan_x = random_points(pool, T * W_ipp * nt, gen).reshape(3, NW, T, W_ipp * nt).contiguous()
    horner_w = random_points(pool, 8 * 2, gen).reshape(3, NW, 8, 2).permute(2, 0, 1, 3).contiguous()
    reduce_x = random_points(pool, 2 * nm, gen)

    def scalars(count, mp):
        xs = torch.randint(-(2**63), 2**63 - 1, (NW, count), generator=gen, device=dev)
        xs[3] &= (1 << 58) - 1
        edge = torch.as_tensor(limb.ints_to_words([0, 1, mp.modulus - 1, mp.modulus - 2]), device=dev)
        k = min(4, count)
        xs[:, :k] = edge[:, :k]
        return xs.contiguous()

    pow_cases = [  # (lanes, field, exponent): per round u^-1 (FR, 1), L/R affine (FP, 2),
        (2, FP, P - 2), (1, FR, R - 2), (m_parties, FP, P - 2),  # V affine (FP, m)
        (msm_mod.SPLIT_CHUNKS * (2 * nm + 1), FP, P - 2),        # split-table affine
    ]
    pow_inputs = [(scalars(k, mp), mp, e) for k, mp, e in pow_cases]

    def pow_ops(k, mp, e):
        ndig = (e.bit_length() + 3) // 4
        nnz = sum(1 for d in range(ndig) if (e >> (4 * d)) & 15)
        prods = 2 + 14 + 4 * (ndig - 1) + nnz
        return k * prods * (FP_MUL_OPS if mp is FP else FR_MUL_OPS)

    c = msm_mod.SPLIT_WINDOW
    cases = {
        "point_add": ((a, b), kernels.point_add, lambda: curve_t._point_add(a, b),
                      bound(3 * POINT_BYTES * add_n, add_n * POINT_ADD_OPS),
                      {"W": W_ipp, "nt": nt}),
        "point_scan_steps_inner": ((scan_x,), kernels.point_scan_steps_inner,
                                   lambda: kernels.point_scan_plain(scan_x),
                                   bound(2 * POINT_BYTES * scan_x.shape[2] * scan_x.shape[3],
                                         (T - 1) * W_ipp * nt * POINT_ADD_OPS),
                                   {"T": T, "L": W_ipp * nt}),
        "point_horner_multi": ((horner_w, c), kernels.point_horner_multi,
                               lambda: kernels.point_horner_plain(horner_w, c),
                               bound(POINT_BYTES * (8 * 2 + 2), 8 * (c + 1) * 2 * POINT_ADD_OPS),
                               {"nw": 8, "c": c, "k": 2}),
        "point_reduce": ((reduce_x,), kernels.point_reduce,
                         lambda: kernels.point_reduce_plain(reduce_x),
                         bound(POINT_BYTES * (2 * nm + 1), (2 * nm - 1) * POINT_ADD_OPS),
                         {"n": 2 * nm}),
    }
    results = {}
    for name, (args, fn, plain, (bound_ms, bound_by), shape) in cases.items():
        got = fn(*args)
        torch.cuda.synchronize()
        want = plain()
        res = {"phase": "kernel", "name": name, "shape": shape, "tolerance": 0,
               "equal": bool(torch.equal(got, want)),
               "max_abs_err": max_abs_err(got, want, 1), "kernel_ms": cuda_ms(lambda: fn(*args), 20),
               "plain_ms": cuda_ms(plain, 1), "bound_ms": bound_ms, "bound_by": bound_by, "gpu": gpu}
        emit(res)
        results[name] = res
    # mod_pow: every case must agree; the per-round inverse (FP, 2 lanes) is timed
    errs, equal = [], True
    for x, mp, e in pow_inputs:
        got = kernels.mod_pow_static(x, e, mp)
        want = kernels.mod_pow_plain(x, e, mp)
        equal &= bool(torch.equal(got, want))
        errs.append(max_abs_err(got, want, 0))
    x0, mp0, e0 = pow_inputs[0]
    bound_ms, bound_by = bound(2 * 32 * x0.shape[-1], pow_ops(x0.shape[-1], mp0, e0))
    res = {"phase": "kernel", "name": "mod_pow_static",
           "shape": [{"n": k, "field": "FP" if mp is FP else "FR"} for k, mp, _ in pow_cases],
           "tolerance": 0, "equal": equal, "max_abs_err": max(errs),
           "kernel_ms": cuda_ms(lambda: kernels.mod_pow_static(x0, e0, mp0), 20),
           "plain_ms": cuda_ms(lambda: kernels.mod_pow_plain(x0, e0, mp0), 1),
           "bound_ms": bound_ms, "bound_by": bound_by, "gpu": gpu}
    emit(res)
    results["mod_pow_static"] = res
    bad = [n for n, r in results.items() if not r["equal"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions: {bad}")
    return results


def main_path(gpu: str, dev, n_bits: int = N_BITS, m_parties: int = M_PARTIES) -> dict:
    import torch

    from mpc_bulletproof_tpu_torch import (BulletproofGens, HashChainTranscript, PedersenGens,
                                           RangeProof)
    from mpc_bulletproof_tpu_torch import pinned
    from mpc_bulletproof_tpu_torch.ops import kernels

    want = pinned.DIGESTS[(n_bits, m_parties)]
    values, blindings = pinned.inputs(n_bits, m_parties)

    def prove():
        tr = HashChainTranscript(pinned.TRANSCRIPT_LABEL)
        proof, V = RangeProof.prove_multiple(bp_gens, pc_gens, tr, values, blindings, n_bits,
                                             device=dev, rng_bytes=pinned.det_stream())
        digest = pinned.proof_digest(proof, V, tr.state)
        if digest != want:
            raise RuntimeError(f"proof digest {digest} != pinned {want}")
        return proof

    t0 = time.perf_counter()
    bp_gens = BulletproofGens(n_bits, m_parties, device=dev)
    pc_gens = PedersenGens()
    torch.cuda.synchronize()
    gens_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof = prove()                       # cold: builds the device tables
    cold_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    prove()
    counted_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    if not all(v > 0 for v in launches.values()):
        raise RuntimeError(f"a kernel of the main path was not launched: {launches}")

    warm = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(WARM_PROOFS):
        t0 = time.perf_counter()
        prove()
        warm.append(time.perf_counter() - t0)
    res = {"phase": "main_path", "n": n_bits, "m": m_parties, "digest": want, "digest_equal": True,
           "proof_bytes": len(proof.to_bytes()), "gens_s": gens_s, "cold_prove_s": cold_s,
           "counted_prove_s": counted_s, "warm_prove_s": warm,
           "us_per_proof_median": statistics.median(warm) * 1e6,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(), "launches": launches, "gpu": gpu}
    emit(res)
    emit(profile_proof(prove, res["us_per_proof_median"], gpu))
    return res


def profile_proof(prove, warm_us: float, gpu: str) -> dict:
    """Device time by kernel over one warm proof (torch.profiler).  The
    profiler slows the host, so the idle share is also given against the
    unprofiled median proof time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prove()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    # device rows only: an aten op's self device time repeats its kernels'
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count) for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
                  reverse=True)
    busy_us = sum(r[0] for r in rows)
    return {"phase": "profile", "wall_us": wall_us, "device_busy_us": busy_us if rows else None,
            "device_idle_share": (1 - busy_us / wall_us) if rows else None,
            "device_idle_share_unprofiled": (1 - busy_us / warm_us) if rows else None,
            "device_launches": sum(r[2] for r in rows) if rows else None,
            "top": [{"name": k[:80], "device_us": us, "count": n} for us, k, n in rows[:25]],
            "gpu": gpu}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from mpc_bulletproof_tpu_torch.ops import kernels

    gpu = smi_line()
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc",
          "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(), "gpu": gpu})

    t0 = time.perf_counter()
    report = kernels.build()
    ptxas = {name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for name, (_, log) in report.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libs": {name: os.path.relpath(path) for name, (path, _) in report.items()},
          "ptxas": ptxas})

    dev = torch.device("cuda")
    checks = check_kernels(gpu, dev)
    mp = main_path(gpu, dev)

    summary = []
    for name, (source, _, _) in kernels.KERNELS.items():
        r = checks[name]
        summary.append({
            "name": name, "route": "cuda", "source": f"mpc_bulletproof_tpu_torch/csrc/{source}",
            "replaces": REPLACES[name], "launches": mp["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "equal": r["equal"],
        })
    emit({"kernels": summary})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
