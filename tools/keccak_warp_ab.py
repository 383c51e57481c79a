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
- ``keccak_transcript`` (each challenge hashed and reduced by the side
  warp) against the same kernel with every challenge on the chain warp
  (``inline``), at an IPP round's run (L, R, u), the prover's V, A, S, y,
  z run at m = 64 and a whole (64, 64) verification's replay, held to each
  other word for word, device ms by the profiler in turns (port, inline,
  inline, port).

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
    transcript.argtypes = kernels.KERNELS["keccak_transcript"][2]
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
    from mpc_bulletproof_tpu_torch.ops import transcript_t as tj

    runs = {"ipp_round": [(b"L", 8), (b"R", 8), (b"u", None)],
            "v_run_A_S_y_z": [(b"V", 8)] * 64 + [(b"A", 8), (b"S", 8), (b"y", None), (b"z", None)],
            "verify_64x64": cs.verify_replay_steps(64, 64)}
    for what, steps in runs.items():
        plan = tj._plan(tuple(steps), dev)
        n_chal = plan.challenges
        starts = torch.randint(-(1 << 63), (1 << 63) - 1, (1, 4), generator=gen, device=dev, dtype=torch.int64)
        msgs = torch.randint(-(1 << 63), (1 << 63) - 1, (1, plan.words), generator=gen, device=dev,
                             dtype=torch.int64)
        states, chals = torch.empty_like(starts), torch.empty((1, 4, n_chal), dtype=torch.int64, device=dev)

        def inline():
            if transcript(starts.data_ptr(), plan.template.data_ptr(), plan.layout.data_ptr(), msgs.data_ptr(), 1,
                          len(steps), plan.words, n_chal, states.data_ptr(), chals.data_ptr(), stream()):
                raise RuntimeError("ab_transcript: launch failed")

        fns = {"port": lambda: kernels.keccak_transcript(starts, plan, msgs), "inline": inline}
        inline()
        want = kernels.keccak_transcript(starts, plan, msgs)
        torch.cuda.synchronize()
        equal = bool(torch.equal(states, want[0]) and torch.equal(chals, want[1]))
        ms = {"port": [], "inline": []}
        for who in ("port", "inline", "inline", "port"):
            ms[who].append(cs.device_ms(fns[who], 20))
        print(json.dumps({"transcript": what, "blocks": len(steps), "challenges": n_chal, "equal": equal,
                          "device_ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
