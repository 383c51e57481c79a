"""The two-process integration harness of the collaborative (2-party MPC) prover.

Each party runs this program as its own OS process; the two connect over
TCP (:class:`...parallel.network.TcpTwoPartyNet`: party 0 listens, party 1
dials) and run the registered cases in name order, each over one
``MpcFabric(net, PartyIdBeaverSource(party), device=device)``:

    python -m mpc_bulletproof_tpu_torch.integration.main --party 0 --port 9850 [--device cpu]
    python -m mpc_bulletproof_tpu_torch.integration.main --party 1 --port 9850 [--device cpu]

or both at once by :mod:`.launch`.  The cases are the JAX package's
(``integration/main.py``) on the port's fabric and prover, plus
``mpc_range_proof``: the collaborative range proof of
``pinned.mpc_range_party`` over ``--values`` values of ``--bits`` bits,
proved ``--proofs`` times, each opened proof held to
``pinned.MPC_RANGE_DIGESTS`` where the width is pinned.

Each party names each case on standard error as it starts it, and party
0 prints ``[PASS] name`` or ``[FAIL] name (error)`` when it ends.  Then
each party prints one JSON line: per case its name, ``ok``, the sha256 of
the opened proof where there is one, seconds, the messages and bytes its
end of the link sent, and the kernel launches this process made; and the
modules of ``jax`` or of the JAX package this process loaded (none).  The
exit code is 1 if any case failed.  The device is the card unless
``--device cpu``; a card asked for and missing fails the run.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import random
import sys
import time
import traceback

import torch

from .. import pinned
from ..generators import BulletproofGens, PedersenGens
from ..models.r1cs import LinearCombination, Variable, Verifier
from ..models.r1cs.gadgets import example_gadget, range_check_gadget, shuffle_gadget
from ..models.r1cs_mpc import MpcProver, SharedInnerProductProof
from ..ops import kernels
from ..ops.curve import StarkPoint
from ..ops.field import Scalar, inner_product, scalar_powers
from ..parallel.beaver import PartyIdBeaverSource
from ..parallel.fabric import AuthenticatedScalarVector, MpcFabric
from ..parallel.network import TcpTwoPartyNet
from ..transcript import HashChainTranscript, MpcTranscript
from ..utils.device import resolve_device
from ..utils.errors import AuthenticationError, VerificationError

CASES: dict = {}
# Each party sets itself up (generators, the CUDA context) before it
# connects, so the first to be ready waits here for the other's set-up:
# ~10 s a process on the card at (64, 64), more on a loaded CPU.
CONNECT_TIMEOUT_S = 120.0


def case(name):
    def register(fn):
        CASES[name] = fn
        return fn

    return register


class Context:
    """What the cases share: the device, the generators, the range proof's
    width and its number of proofs."""

    def __init__(self, device, bits: int, values: int, proofs: int):
        self.device = device
        self.pc = PedersenGens()
        self.bp = BulletproofGens(32, 1, device=device)
        self.bits, self.values, self.proofs = bits, values, proofs
        self.range_bp = BulletproofGens(bits * values, 1, device=device) if proofs else None


def det_scalar(i):
    return Scalar(0x1234567 + i * 0xDEAD + i * i)


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def commit_example(prover, fabric, blind, owned0):
    """The example gadget's five commitments: party 0 owns ``owned0``, party
    1 owns (4, 1); returns ``(commitments, variables)`` in owner order."""
    if fabric.party_id == 0:
        comms0, vars0 = prover.batch_commit(0, [Scalar(v) for v in owned0], blind[:3])
        comms1, vars1 = prover.batch_commit(1, None, None, count=2)
    else:
        comms0, vars0 = prover.batch_commit(0, None, None, count=3)
        comms1, vars1 = prover.batch_commit(1, [Scalar(4), Scalar(1)], blind[3:])
    return comms0 + comms1, vars0 + vars1


def example_constraints(cs, v, c2):
    """The example gadget over the variables in owner order (a1 = v0, a2 =
    v3, b1 = v1, b2 = v4, c1 = v2)."""
    example_gadget(cs, v[0].to_lc(), v[3].to_lc(), v[1].to_lc(), v[4].to_lc(), v[2].to_lc(), c2)


# ---------------------------------------------------------------------------


@case("transcript_sync")
def transcript_sync(fabric: MpcFabric, ctx: Context):
    """Both parties absorb opened shared values and squeeze equal challenges."""
    shared = fabric.batch_share_scalars([det_scalar(i) for i in range(4)] if fabric.party_id == 0 else None,
                                        owner=0, count=4)
    t = MpcTranscript(HashChainTranscript(b"sync-test"))
    for v in shared.open_authenticated():
        t.append_scalar(b"v", v)
    mine = t.challenge_scalar(b"c")
    if fabric.exchange_scalars([mine])[0] != mine:
        raise AssertionError("challenge desync between parties")


@case("shared_ipp")
def shared_ipp(fabric: MpcFabric, ctx: Context):
    """Shared IPP with interleaved ownership; the opened proof verifies."""
    n = 8
    G, H = ctx.bp.share(0).G(n), ctx.bp.share(0).H(n)
    Q = StarkPoint.generator().scalar_mul(Scalar(0xABC))
    a = [det_scalar(i) for i in range(n)]
    b = [det_scalar(100 + i) for i in range(n)]
    Gf, Hf = [Scalar(1)] * n, scalar_powers(Scalar(3), n)
    a_sh = fabric.batch_share_scalars(a if fabric.party_id == 0 else None, 0, count=n)
    b_sh = fabric.batch_share_scalars(b if fabric.party_id == 1 else None, 1, count=n)
    t = MpcTranscript(HashChainTranscript(b"ipp-integration"))
    opened = SharedInnerProductProof.create(t, Q, Gf, Hf, list(G), list(H), a_sh, b_sh, fabric).open()
    b_prime = [bi * yi for bi, yi in zip(b, Hf)]
    P = StarkPoint.msm(a + b_prime + [inner_product(a, b)], G + H + [Q])
    opened.verify(n, HashChainTranscript(b"ipp-integration"), Gf, Hf, P, Q, G, H, device=ctx.device)
    return opened.to_bytes()


@case("ipp_malleability")
def ipp_malleability(fabric: MpcFabric, ctx: Context):
    """A malleated IPP share fails the MAC-checked opening."""
    n = 4
    G, H = ctx.bp.share(0).G(n), ctx.bp.share(0).H(n)
    a = [det_scalar(i) for i in range(n)]
    b = [det_scalar(7 * i) for i in range(n)]
    a_sh = fabric.batch_share_scalars(a if fabric.party_id == 0 else None, 0, count=n)
    b_sh = fabric.batch_share_scalars(b if fabric.party_id == 1 else None, 1, count=n)
    t = MpcTranscript(HashChainTranscript(b"malleable"))
    proof = SharedInnerProductProof.create(t, StarkPoint.generator(), [Scalar(1)] * n, [Scalar(1)] * n,
                                           list(G), list(H), a_sh, b_sh, fabric)
    if fabric.party_id == 0:
        proof.a.shares[0] = proof.a.shares[0] + Scalar(1)
    try:
        proof.open()
    except AuthenticationError:
        return None
    raise AssertionError("malleated share was not detected")


@case("mpc_prover_simple")
def mpc_prover_simple(fabric: MpcFabric, ctx: Context):
    """Collaborative example-gadget proof, verified by the plain verifier."""
    prover = MpcProver(fabric, ctx.pc, HashChainTranscript(b"mpc-int"))
    comms, vars_ = commit_example(prover, fabric, [det_scalar(1000 + i) for i in range(5)], (3, 6, 40))
    c2 = LinearCombination({Variable.one(): Scalar(9)})
    example_constraints(prover, vars_, c2)
    proof = prover.prove(ctx.bp).open()
    verifier = Verifier(ctx.pc, HashChainTranscript(b"mpc-int"))
    example_constraints(verifier, [verifier.commit(c) for c in comms], c2)
    verifier.verify(proof, ctx.bp, device=ctx.device)
    return proof.to_bytes()


@case("mpc_shuffle_proof")
def mpc_shuffle_proof(fabric: MpcFabric, ctx: Context):
    """Collaborative shuffle proof (randomized two-phase constraints)."""
    k = 3
    inputs = [det_scalar(i) for i in range(k)]
    outputs = [inputs[2], inputs[0], inputs[1]]
    blind = [det_scalar(50 + i) for i in range(2 * k)]

    def transcript():
        t = HashChainTranscript(b"mpc-shuffle")
        t.append_message(b"dom-sep", b"ShuffleProof")
        t.append_u64(b"k", k)
        return t

    prover = MpcProver(fabric, ctx.pc, transcript())
    if fabric.party_id == 0:
        in_c, in_v = prover.batch_commit(0, inputs, blind[:k])
        out_c, out_v = prover.batch_commit(1, None, None, count=k)
    else:
        in_c, in_v = prover.batch_commit(0, None, None, count=k)
        out_c, out_v = prover.batch_commit(1, outputs, blind[k:])
    shuffle_gadget(prover, in_v, out_v)
    proof = prover.prove(ctx.bp).open()
    verifier = Verifier(ctx.pc, transcript())
    shuffle_gadget(verifier, [verifier.commit(c) for c in in_c], [verifier.commit(c) for c in out_c])
    verifier.verify(proof, ctx.bp, device=ctx.device)
    return proof.to_bytes()


@case("mpc_prover_malleability")
def mpc_prover_malleability(fabric: MpcFabric, ctx: Context):
    """A party that malleates its share of the IPP tail after proving is
    caught by the MAC-checked opening, in both parties."""
    prover = MpcProver(fabric, ctx.pc, HashChainTranscript(b"mpc-malleate"))
    _, vars_ = commit_example(prover, fabric, [det_scalar(2000 + i) for i in range(5)], (3, 6, 40))
    example_constraints(prover, vars_, LinearCombination({Variable.one(): Scalar(9)}))
    partial = prover.prove(ctx.bp)
    if fabric.party_id == 1:
        partial.ipp_proof.a.shares[0] = partial.ipp_proof.a.shares[0] + Scalar(5)
    try:
        partial.open()
    except AuthenticationError:
        return None
    raise AssertionError("malleated R1CS proof share was not detected")


@case("mpc_prover_false_statement")
def mpc_prover_false_statement(fabric: MpcFabric, ctx: Context):
    """A collaboratively proved false statement fails plain verification:
    (3 + 4)(6 + 1) = 49, but c1 + c2 = 41 + 9 = 50."""
    prover = MpcProver(fabric, ctx.pc, HashChainTranscript(b"mpc-false"))
    comms, vars_ = commit_example(prover, fabric, [det_scalar(3000 + i) for i in range(5)], (3, 6, 41))
    c2 = LinearCombination({Variable.one(): Scalar(9)})
    example_constraints(prover, vars_, c2)
    proof = prover.prove(ctx.bp).open()
    verifier = Verifier(ctx.pc, HashChainTranscript(b"mpc-false"))
    example_constraints(verifier, [verifier.commit(c) for c in comms], c2)
    try:
        verifier.verify(proof, ctx.bp, device=ctx.device)
    except VerificationError:
        return proof.to_bytes()
    raise AssertionError("false statement verified")


@case("shared_ipp_random_ownership")
def shared_ipp_random_ownership(fabric: MpcFabric, ctx: Context):
    """Shared IPP over 2 x 16 values with a seeded owner for each."""
    n = 16
    G, H = ctx.bp.share(0).G(n), ctx.bp.share(0).H(n)
    Q = StarkPoint.generator().scalar_mul(Scalar(0x17))
    a = [det_scalar(31 * i + 5) for i in range(n)]
    b = [det_scalar(17 * i + 3) for i in range(n)]
    owners = [random.Random(777 + i).randrange(2) for i in range(2 * n)]

    def share_elementwise(vals, base):
        return AuthenticatedScalarVector.concat(
            fabric.batch_share_scalars([v] if fabric.party_id == owners[base + i] else None,
                                       owners[base + i], count=1)
            for i, v in enumerate(vals))

    t = MpcTranscript(HashChainTranscript(b"ipp-rand-own"))
    ones = [Scalar(1)] * n
    opened = SharedInnerProductProof.create(t, Q, ones, ones, list(G), list(H), share_elementwise(a, 0),
                                            share_elementwise(b, n), fabric).open()
    P = StarkPoint.msm(a + b + [inner_product(a, b)], G + H + [Q])
    opened.verify(n, HashChainTranscript(b"ipp-rand-own"), ones, ones, P, Q, G, H, device=ctx.device)
    return opened.to_bytes()


@case("mpc_range_proof")
def mpc_range_proof(fabric: MpcFabric, ctx: Context):
    """The collaborative range proof of ``pinned.mpc_range_party``, proved
    ``ctx.proofs`` times (the first cold); each opened proof's digest must
    be the pinned one where the width is pinned.  Both parties pass a
    barrier before each proof, outside its counts; party 0 verifies the
    last proof with the plain verifier."""
    n, m = ctx.bits, ctx.values
    values, blindings = pinned.mpc_range_inputs(n, m)
    want = pinned.MPC_RANGE_DIGESTS.get((n, m))
    net = fabric.net
    runs, digest, proof, comms = [], None, None, None
    for _ in range(ctx.proofs):
        net.exchange_bytes(b"go")
        sync(ctx.device)
        launched = dict(kernels.launches)
        msgs, sent = net.sent_messages, net.sent_bytes
        t0 = time.perf_counter()
        t = HashChainTranscript(pinned.MPC_LABEL)
        prover = MpcProver(fabric, ctx.pc, t)
        comms = pinned.mpc_range_party(prover, fabric, n, values, blindings)
        proof = prover.prove(ctx.range_bp).open()
        sync(ctx.device)
        runs.append({"seconds": time.perf_counter() - t0, "sent_messages": net.sent_messages - msgs,
                     "sent_bytes": net.sent_bytes - sent,
                     "launches": {k: v - launched[k] for k, v in kernels.launches.items() if v > launched[k]}})
        got = pinned.proof_digest(proof, comms, t.state)
        if digest is not None and got != digest:
            raise AssertionError("the proofs of one run differ")
        digest = got
        if want is not None and got != want:
            raise AssertionError(f"digest {got} != pinned {want}")
    if fabric.party_id == 0:
        verifier = Verifier(ctx.pc, HashChainTranscript(pinned.MPC_LABEL))
        for V in comms:
            range_check_gadget(verifier, verifier.commit(V).to_lc(), None, n)
        verifier.verify(proof, ctx.range_bp, device=ctx.device)
    return proof.to_bytes(), {"bits": n, "values": m, "digest": digest, "pinned": want is not None,
                              "proofs": runs}


# ---------------------------------------------------------------------------


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def jax_modules() -> list:
    """Modules of ``jax`` or of the JAX package this process has loaded."""
    return sorted(name for name in sys.modules if name.split(".")[0] in ("jax", "jaxlib", "mpc_bulletproof_tpu"))


def run_case(name, fn, fabric, ctx) -> dict:
    """One case: its outcome, the link counts and launches it made."""
    net = fabric.net
    msgs, sent = net.sent_messages, net.sent_bytes
    kernels.reset_launches()
    t0 = time.perf_counter()
    row = {"name": name, "ok": True, "error": None, "opened_sha256": None}
    try:
        out = fn(fabric, ctx)
        sync(ctx.device)
        if isinstance(out, tuple):
            out, row["detail"] = out
        if out is not None:
            row["opened_sha256"] = sha256(out)
    except Exception as exc:  # noqa: BLE001 - a failed case is reported, the next one runs
        traceback.print_exc()
        row.update(ok=False, error=f"{type(exc).__name__}: {exc}")
    row.update(seconds=time.perf_counter() - t0, sent_messages=net.sent_messages - msgs,
               sent_bytes=net.sent_bytes - sent, launches={k: v for k, v in kernels.launches.items() if v})
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--party", type=int, required=True, choices=(0, 1))
    ap.add_argument("--port", type=int, default=9850)
    ap.add_argument("--host", default="127.0.0.1",
                    help="party 0: the address to listen on; party 1: party 0's address")
    ap.add_argument("--test", default=None, help="run only the cases whose name contains this")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--bits", type=int, default=64, help="mpc_range_proof: bits a value")
    ap.add_argument("--values", type=int, default=64, help="mpc_range_proof: values (even)")
    ap.add_argument("--proofs", type=int, default=1, help="mpc_range_proof: proofs in a row")
    ap.add_argument("--timeout", type=float, default=60.0, help="seconds the link waits for the peer")
    ap.add_argument("--threads", type=int, default=None,
                    help="torch's intra-op CPU threads (default: torch's own)")
    args = ap.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)

    t0 = time.perf_counter()
    device = resolve_device(args.device)
    selected = {name: fn for name, fn in sorted(CASES.items()) if args.test is None or args.test in name}
    ctx = Context(device, args.bits, args.values, args.proofs if "mpc_range_proof" in selected else 0)
    sync(device)
    setup_s = time.perf_counter() - t0
    net = TcpTwoPartyNet(args.party, (args.host, args.port), (args.host, args.port), recv_timeout=args.timeout)
    net.connect(timeout=CONNECT_TIMEOUT_S)
    fabric = MpcFabric(net, PartyIdBeaverSource(args.party), device=device)
    rows = []
    for name, fn in selected.items():
        print(f"party {args.party}: {name}", file=sys.stderr, flush=True)
        row = run_case(name, fn, fabric, ctx)
        rows.append(row)
        if args.party == 0:
            print(f"[{'PASS' if row['ok'] else 'FAIL'}] {name}" + ("" if row["ok"] else f" ({row['error']})"),
                  flush=True)
    fabric.shutdown()
    print(json.dumps({"party": args.party, "device": str(device), "setup_s": setup_s, "cases": rows,
                      "jax_modules": jax_modules()}), flush=True)
    return 0 if rows and all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
