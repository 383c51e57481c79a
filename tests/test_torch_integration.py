"""The two-process deployment of the port's collaborative prover.

The launcher (``mpc_bulletproof_tpu_torch.integration.launch``) runs both
parties of the harness (``integration.main``) as two OS processes over
loopback on the CPU (``--device cpu``, one torch thread each).  Every case
of the registry must pass in both; the collaborative range proof at 4 bits
x 2 values must give ``pinned.MPC_RANGE_DIGESTS[(4, 2)]`` and send, per
party, the messages and bytes of the same proof with both parties as
threads over ``make_local_pair``; neither process may load JAX or the JAX
package.  A party that is killed, or stops answering, makes the other
exit nonzero within the link's receive timeout instead of hanging it.
"""

import hashlib
import os
import signal
import socket
import threading
import time

import pytest
import torch

from mpc_bulletproof_tpu_torch import (BulletproofGens, HashChainTranscript, MpcFabric, MpcProver,
                                       PartyIdBeaverSource, PedersenGens, make_local_pair, pinned)
from mpc_bulletproof_tpu_torch.integration import launch
from mpc_bulletproof_tpu_torch.integration.main import CASES
from mpc_bulletproof_tpu_torch.parallel.network import TcpTwoPartyNet
from mpc_bulletproof_tpu_torch.utils.errors import NetworkError

torch.set_num_threads(1)

CPU = ["--device", "cpu", "--threads", "1"]
RANGE = ["--bits", "4", "--values", "2"]


@pytest.fixture(scope="module")
def pair_run():
    res = launch.run_pair(CPU + RANGE, deadline_s=600)
    assert not res["timed_out"], res["stderr"]
    return res


def thread_range_run(n_bits: int, m: int):
    """The collaborative range proof with both parties as threads over the
    in-process link: ``(digest, sha256 of the opened proof, [(messages,
    bytes)] per party)``."""
    values, blindings = pinned.mpc_range_inputs(n_bits, m)
    bp, pc = BulletproofGens(n_bits * m, 1, device="cpu"), PedersenGens()
    nets = make_local_pair()
    out = [None, None]

    def party(i):
        fabric = MpcFabric(nets[i], PartyIdBeaverSource(i), device="cpu")
        t = HashChainTranscript(pinned.MPC_LABEL)
        prover = MpcProver(fabric, pc, t)
        comms = pinned.mpc_range_party(prover, fabric, n_bits, values, blindings)
        proof = prover.prove(bp).open()
        out[i] = (pinned.proof_digest(proof, comms, t.state), hashlib.sha256(proof.to_bytes()).hexdigest())

    threads = [threading.Thread(target=party, args=(i,)) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert out[0] == out[1]
    return (*out[0], [(n.sent_messages, n.sent_bytes) for n in nets])


def test_every_case_passes_in_both_processes(pair_run):
    assert pair_run["rcs"] == [0, 0], pair_run["stderr"]
    for party, rep in enumerate(pair_run["reports"]):
        assert rep["party"] == party and rep["device"] == "cpu"
        assert [c["name"] for c in rep["cases"]] == sorted(CASES)
        assert all(c["ok"] for c in rep["cases"]), [c for c in rep["cases"] if not c["ok"]]
    for name in CASES:
        assert f"[PASS] {name}" in pair_run["stdout"][0]
    # the opened proofs are the same bytes in both parties
    opened = [{c["name"]: c["opened_sha256"] for c in rep["cases"]} for rep in pair_run["reports"]]
    assert opened[0] == opened[1]
    assert sum(v is not None for v in opened[0].values()) == 6


def test_range_proof_matches_pinned_digest_and_thread_link_counts(pair_run):
    digest, proof_sha, link = thread_range_run(4, 2)
    assert digest == pinned.MPC_RANGE_DIGESTS[(4, 2)]
    for party, rep in enumerate(pair_run["reports"]):
        row = next(c for c in rep["cases"] if c["name"] == "mpc_range_proof")
        detail = row["detail"]
        assert detail["digest"] == digest and detail["pinned"]
        assert row["opened_sha256"] == proof_sha
        (proof,) = detail["proofs"]
        assert (proof["sent_messages"], proof["sent_bytes"]) == link[party]
        assert proof["launches"] == {}          # plain versions on the CPU launch nothing


def test_no_jax_in_either_process(pair_run):
    assert [rep["jax_modules"] for rep in pair_run["reports"]] == [[], []]


def _wait_for(pair, party, text, timeout_s):
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        if any(text in line for line in pair.err[party]) or pair.procs[party].poll() is not None:
            return any(text in line for line in pair.err[party])
        time.sleep(0.05)
    return False


@pytest.mark.parametrize("how", ["kill", "stop"])
def test_a_failed_peer_ends_the_other_party(how):
    """Party 1 killed (its socket closes) or stopped (its socket stays open
    and silent) during the range proof: party 0 ends with a nonzero exit,
    the case failed on a network error, within the link's timeout."""
    timeout_s = 3.0
    pair = launch.Pair(CPU + ["--bits", "4", "--values", "2", "--proofs", "50", "--test", "mpc_range_proof",
                              "--timeout", str(timeout_s)])
    try:
        assert _wait_for(pair, 1, "party 1: mpc_range_proof", 120), pair.err
        time.sleep(1.0)
        assert pair.procs[1].poll() is None
        os.kill(pair.procs[1].pid, signal.SIGKILL if how == "kill" else signal.SIGSTOP)
        t0 = time.monotonic()
        rc0 = pair.procs[0].wait(timeout=timeout_s + 30)
        waited = time.monotonic() - t0
    finally:
        if how == "stop" and pair.procs[1].poll() is None:
            os.kill(pair.procs[1].pid, signal.SIGCONT)
        res = pair.wait(10)
    assert rc0 == 1
    assert waited < timeout_s + 30
    (row,) = res["reports"][0]["cases"]
    assert not row["ok"] and row["error"].startswith("NetworkError"), row


def test_launcher_deadline_kills_both_parties():
    res = launch.run_pair(CPU + RANGE + ["--proofs", "1000", "--test", "mpc_range_proof"], deadline_s=15)
    assert res["timed_out"] and res["rcs"] == [None, None]
    assert res["seconds"] < 60


def test_tcp_receive_times_out_with_network_error():
    """A connected peer that sends nothing: the receive raises
    ``NetworkError`` after ``recv_timeout`` instead of blocking."""
    port = launch.free_port()
    nets = [TcpTwoPartyNet(i, ("127.0.0.1", port), ("127.0.0.1", port), recv_timeout=0.5) for i in (0, 1)]
    th = threading.Thread(target=nets[1].connect)
    th.start()
    nets[0].connect()
    th.join(timeout=30)
    try:
        t0 = time.monotonic()
        with pytest.raises(NetworkError, match="timed out"):
            nets[0].recv_bytes()
        assert 0.4 < time.monotonic() - t0 < 10
        nets[1].send_bytes(b"late")
        assert nets[0].recv_bytes() == b"late"
    finally:
        for net in nets:
            net.close()


def test_free_port_is_bindable():
    port = launch.free_port()
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))
