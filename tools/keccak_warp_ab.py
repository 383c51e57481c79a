#!/usr/bin/env python3
"""Other designs of the warp keccak-f[1600] against the port's, on one card.

    python3 tools/keccak_warp_ab.py    # from the repository root, on a machine with one card

Builds ``tools/keccak_warp_ab.cu`` (which includes
``mpc_bulletproof_tpu_torch/csrc/keccak.cu``) into the port's build
directory with the port's nvcc flags, prints the SASS opcode histogram of
each keccak kernel's main loop, then, one JSON line each:

- the chain walk (2 and 128 chains of ``STEPS`` steps) on the four designs
  of ``ab_chain`` (0 is ``keccak_f_warp`` itself), each held byte for byte
  to ``kernels.keccak_chain``, timed by CUDA events in turns (0, 2, 3, 1,
  1, 3, 2, 0), with cycles a step at the SM clock under load;
- ``keccak_transcript`` against the staged transcript at an IPP round's
  run (2 absorbs and the challenge; 3 and the challenge) and the range
  prover's V run (64 absorbs), held to each other, device ms by the
  profiler in turns (port, staged, staged, port).

Imports nothing of JAX.  Exits 1 without a card.
"""

from __future__ import annotations

import collections
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

STEPS = 1 << 15
CHAIN_ORDER = (0, 2, 3, 1, 1, 3, 2, 0)
TRANSCRIPT_RUNS = ((3, True), (64, False), (2, True))


def build(kernels) -> str:
    lib = kernels.BUILD_DIR / "keccak_warp_ab.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-o", str(lib),
                          str(ROOT / "tools" / "keccak_warp_ab.cu")], capture_output=True, text=True)
    print("\n".join(ln for ln in (out.stdout + out.stderr).splitlines() if "registers" in ln or "error" in ln))
    if out.returncode:
        raise RuntimeError("nvcc failed for tools/keccak_warp_ab.cu")
    return str(lib)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("keccak_warp_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from mpc_bulletproof_tpu_torch.ops import kernels

    print(cs.smi_line(), flush=True)
    port_lib = kernels.build()["keccak_chain"][0]
    lib = build(kernels)
    for path in (port_lib, lib):
        sass = subprocess.run([str(Path(kernels._nvcc()).parent / "cuobjdump"), "-sass", path],
                              capture_output=True, text=True, check=True).stdout
        for name, code in cs.sass_functions(sass).items():
            loop = cs.main_loop(code)
            hist = collections.Counter(op.split(".")[0] for _, op, _ in (loop or code) if op != "NOP")
            print(json.dumps({"lib": Path(path).name, "fn": name[:60], "loop": bool(loop),
                              "n": sum(hist.values()), "top": hist.most_common(12)}))

    chain = ctypes.CDLL(lib).ab_chain
    chain.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
    transcript = ctypes.CDLL(lib).ab_transcript
    transcript.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p]
    dev = torch.device("cuda")
    cs.SM_CLOCK_MHZ = cs.measure_clock(dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    for chains in (2, 128):
        st = torch.randint(0, 256, (chains, 32), generator=gen, device=dev, dtype=torch.uint8)
        want = kernels.keccak_chain(st, 0, STEPS)
        outs = {v: torch.empty_like(want) for v in set(CHAIN_ORDER)}

        def run(v):
            if chain(st.data_ptr(), outs[v].data_ptr(), chains, 0, STEPS, v, stream()):
                raise RuntimeError(f"ab_chain {v}: launch failed")

        for v in outs:
            run(v)
        torch.cuda.synchronize()
        ms = {v: [] for v in outs}
        for v in CHAIN_ORDER:
            ms[v].append(cs.cuda_ms(lambda: run(v), 3))
        print(json.dumps({"chains": chains, "steps": STEPS, "equal": {v: bool(torch.equal(o, want))
                                                                      for v, o in outs.items()},
                          "ms": ms, "cycles_a_step": {v: [m * cs.SM_CLOCK_MHZ * 1e3 / STEPS for m in t]
                                                      for v, t in ms.items()}}), flush=True)
    for j, high in TRANSCRIPT_RUNS:
        s = torch.randint(0, 256, (32,), generator=gen, device=dev, dtype=torch.int64)
        b = cs.transcript_blocks(gen, dev, [128] * j)
        out = torch.empty(64 if high else 32, dtype=torch.int64, device=dev)
        runs = {"port": lambda: kernels.keccak_transcript(s, b, high),
                "staged": lambda: transcript(s.data_ptr(), b.data_ptr(), j, int(high), out.data_ptr(), stream())}
        runs["staged"]()
        torch.cuda.synchronize()
        equal = bool(torch.equal(out, kernels.keccak_transcript(s, b, high)))
        ms = {"port": [], "staged": []}
        for who in ("port", "staged", "staged", "port"):
            ms[who].append(cs.device_ms(runs[who], 20))
        print(json.dumps({"transcript": [j, high], "equal": equal, "device_ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
