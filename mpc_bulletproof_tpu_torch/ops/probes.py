"""Op-rate probes: the card's counterparts of the JAX package's three
Pallas VPU probes, their wrappers and their plain versions.

Each probe runs a dependent chain of one elementwise int32 or float32 op
per lane (``csrc/probes.cu``), at the TPU probe's shapes, op list and
repetition counts:

===================  ====================================  ===================
wrapper              TPU kernel (``pallas_call``)          chain per lane
===================  ====================================  ===================
``probe_chain``      ``benches/tpu_mul_bench.py:40``       ``acc = op(acc, y)``
``probe_xor_chain``  ``benches/micro_vpu.py:46``           ``acc = op(acc, x) ^ i``
                                                           (f32: ``+ (i & 3)``)
``probe_accum``      ``benches/micro_mul.py:57``           ``acc += op(a + i, b)``
                                                           (f32: ``op(a, b)``)
===================  ====================================  ===================

int32 wraps on overflow, ``>>`` is arithmetic; float32 rounds every
operation (``a * y + y`` is two roundings, never an FMA).  The plain
versions compute int32 chains in int64 and wrap each step to 32 bits, and
float32 chains in float32 tensor ops, so kernel and plain version agree
bit for bit (NaN payloads aside: the mul chains overflow to inf, and the
carry steps then make NaN).  No protocol path calls a probe.
"""

from __future__ import annotations

import torch

from . import kernels

# op lists, in the order of the TPU benches
CHAIN_OPS = ("i32_mul", "i32_mul_add", "i32_add", "i32_shift_mask",
             "f32_mul", "f32_mul_add", "f32_add", "f32_carry")       # tpu_mul_bench.py:70-83
XOR_OPS = ("baseline_xor", "i32_mul", "i32_add", "i32_mul_mask", "i32_shift",
           "f32_mul", "f32_add", "f32_fma", "i32_to_f32", "f32_floor")  # micro_vpu.py:59-71
ACCUM_OPS = ("i32_mul", "i32_add", "i32_shift_and", "f32_mul", "f32_fma",
             "i32_mul16_masked", "i32_mul16_sext", "i32_mul16_one_side")  # micro_mul.py:125-135

# the TPU probes' shapes and repetition counts
CHAIN_SHAPE, CHAIN_REPS = (8, 512), 4096                   # one VMEM tile
# steps an iteration of probe_chain's unrolled loop (CHAIN_STEPS in csrc/probes.cu);
# the reps past a multiple of it run one an iteration
CHAIN_STEPS = 32
XOR_SHAPE, XOR_REPS = (2048, 8, 256), (512, 4096)          # grid 2048 of (1, 8, 256)
ACCUM_SHAPE, ACCUM_REP = (512, 8, 128), 64                 # grid 512 of (1, 8, 128)
# steps an iteration of probe_accum's unrolled loop (ACCUM_STEPS in csrc/probes.cu)
ACCUM_STEPS = 64

# The redesigned kernels' edge cases, held to the plain versions on the
# card: probe_chain's counts with no unrolled iteration, the tail alone and
# both; probe_accum's (lanes, offset in lanes) for the 16-byte path, its
# scalar tail and the scalar path (a view at a 4-byte offset), each at
# EDGE_ACCUM_REPS (one unrolled iteration, none, the tail alone, both).
EDGE_CHAIN_REPS = (0, 1, CHAIN_STEPS - 1, CHAIN_STEPS, CHAIN_STEPS + 1, 100, CHAIN_REPS)
EDGE_ACCUM_LANES = ((2048, 0), (2047, 0), (4099, 0), (4099, 1))
EDGE_ACCUM_REPS = (ACCUM_REP, 0, 5, ACCUM_STEPS + 36)

# Arithmetic operations per chain step (loop control not counted), for the
# bound and the rates: the op's own operations plus the xor / add that
# chains it.
CHAIN_OPS_PER_STEP = {"i32_mul": 1, "i32_mul_add": 2, "i32_add": 1, "i32_shift_mask": 4,
                      "f32_mul": 1, "f32_mul_add": 2, "f32_add": 1, "f32_carry": 5}
XOR_OPS_PER_STEP = {"baseline_xor": 1, "i32_mul": 2, "i32_add": 2, "i32_mul_mask": 3,
                    "i32_shift": 3, "f32_mul": 2, "f32_add": 2, "f32_fma": 3, "i32_to_f32": 5,
                    "f32_floor": 4}
ACCUM_OPS_PER_STEP = {"i32_mul": 3, "i32_add": 3, "i32_shift_and": 4, "f32_mul": 2, "f32_fma": 3,
                      "i32_mul16_masked": 5, "i32_mul16_sext": 7, "i32_mul16_one_side": 4}


def op_dtype(op: str) -> torch.dtype:
    return torch.float32 if op.startswith("f32") else torch.int32


def _wrap32(t: torch.Tensor) -> torch.Tensor:
    """int64 values -> the int32 they wrap to, still as int64."""
    return ((t + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _sext16(t: torch.Tensor) -> torch.Tensor:
    """``(t << 16) >> 16`` on int32: the low 16 bits, sign-extended."""
    return ((t & 0xFFFF) ^ 0x8000) - 0x8000


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

_CHAIN_STEP = {
    "i32_mul": lambda a, y: _wrap32(a * y),
    "i32_mul_add": lambda a, y: _wrap32(a * y + y),
    "i32_add": lambda a, y: _wrap32(a + y),
    "i32_shift_mask": lambda a, y: _wrap32((a & 0x1FFF) + (a >> 13) + y),
    "f32_mul": lambda a, y: a * y,
    "f32_mul_add": lambda a, y: a * y + y,
    "f32_add": lambda a, y: a + y,
    "f32_carry": lambda a, y: a - torch.floor(a * (1.0 / 512.0)) * 512.0 + y,
}

_XOR_STEP = {
    "baseline_xor": lambda a, b: a,
    "i32_mul": lambda a, b: _wrap32(a * b),
    "i32_add": lambda a, b: _wrap32(a + b),
    "i32_mul_mask": lambda a, b: (a * b) & 0x1FFF,
    "i32_shift": lambda a, b: _wrap32((a >> 13) + b),
    "f32_mul": lambda a, b: a * b,
    "f32_add": lambda a, b: a + b,
    "f32_fma": lambda a, b: a * b + b,
    "i32_to_f32": lambda a, b: _wrap32((a.to(torch.float32) + b.to(torch.float32)).to(torch.int64)),
    "f32_floor": lambda a, b: torch.floor(a * 0.5) + b,
}

_ACCUM_STEP = {
    "i32_mul": lambda a, b: a * b,
    "i32_add": lambda a, b: a + b,
    "i32_shift_and": lambda a, b: (a >> 7) & 0x3F,
    "f32_mul": lambda a, b: a * b,
    "f32_fma": lambda a, b: a * b + a,
    "i32_mul16_masked": lambda a, b: (a & 0xFFFF) * (b & 0xFFFF),
    "i32_mul16_sext": lambda a, b: _sext16(a) * _sext16(b),
    "i32_mul16_one_side": lambda a, b: (a & 0xFFFF) * b,
}


def _widen(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) if t.dtype == torch.int32 else t


def _narrow(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype).contiguous()


def chain_plain(op: str, x: torch.Tensor, y: torch.Tensor, reps: int) -> torch.Tensor:
    step = _CHAIN_STEP[op]
    acc, y = _widen(x), _widen(y)
    for _ in range(reps):
        acc = step(acc, y)
    return _narrow(acc, x.dtype)


def xor_chain_plain(op: str, x: torch.Tensor, reps: int) -> torch.Tensor:
    step = _XOR_STEP[op]
    x = _widen(x)
    acc = x
    for i in range(reps):
        acc = step(acc, x) ^ i if op_dtype(op) == torch.int32 else step(acc, x) + float(i & 3)
    return _narrow(acc, op_dtype(op))


def accum_plain(op: str, a: torch.Tensor, b: torch.Tensor, rep: int) -> torch.Tensor:
    step = _ACCUM_STEP[op]
    a, b = _widen(a), _widen(b)
    acc = torch.zeros_like(a)
    for i in range(rep):
        if op_dtype(op) == torch.int32:
            acc = _wrap32(acc + step(_wrap32(a + i), b))
        else:
            acc = acc + step(a, b)
    return _narrow(acc, op_dtype(op))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(op: str, ops, reps: int, *ts: torch.Tensor) -> str:
    """Validate a probe's operands; returns their device type."""
    if op not in ops:
        raise ValueError(f"unknown probe op {op!r}")
    if reps < 0:
        raise ValueError("probe: negative repetition count")
    dtype, first = op_dtype(op), ts[0]
    for t in ts:
        if not isinstance(t, torch.Tensor) or t.dtype != dtype:
            raise TypeError(f"probe {op}: expected {dtype} tensors")
        if not t.is_contiguous() or t.shape != first.shape or t.device != first.device:
            raise ValueError(f"probe {op}: expected contiguous tensors of one shape and device")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"probe {op}: unsupported device {t.device}")
    return first.device.type


def probe_chain(op: str, x: torch.Tensor, y: torch.Tensor, reps: int = CHAIN_REPS) -> torch.Tensor:
    """``acc = op(acc, y)`` from ``acc = x``, ``reps`` times, lane by lane."""
    if _check(op, CHAIN_OPS, reps, x, y) == "cpu":
        return chain_plain(op, x, y, reps)
    out = torch.empty_like(x)
    kernels._launch("probe_chain", x.device, x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(), reps,
                    CHAIN_OPS.index(op))
    return out


def probe_xor_chain(op: str, x: torch.Tensor, reps: int) -> torch.Tensor:
    """``acc = op(acc, x) ^ i`` (int32) or ``op(acc, x) + (i & 3)`` (float32)
    for ``i < reps``, from ``acc = x``."""
    if _check(op, XOR_OPS, reps, x) == "cpu":
        return xor_chain_plain(op, x, reps)
    out = torch.empty_like(x)
    kernels._launch("probe_xor_chain", x.device, x.data_ptr(), out.data_ptr(), x.numel(), reps,
                    XOR_OPS.index(op))
    return out


def probe_accum(op: str, a: torch.Tensor, b: torch.Tensor, rep: int = ACCUM_REP) -> torch.Tensor:
    """``acc += op(a + i, b)`` (int32) or ``op(a, b)`` (float32) for
    ``i < rep``, from ``acc = 0``."""
    if _check(op, ACCUM_OPS, rep, a, b) == "cpu":
        return accum_plain(op, a, b, rep)
    out = torch.empty_like(a)
    kernels._launch("probe_accum", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), rep,
                    ACCUM_OPS.index(op))
    return out
