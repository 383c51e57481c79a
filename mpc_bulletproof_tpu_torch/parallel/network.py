"""Two-party transport for the collaborative prover.

The port's copy of the JAX package's ``parallel/network.py``, with two
interchangeable backends:

* :class:`LocalTwoPartyNet`: an in-process queue pair, for both parties
  as threads of one process (tests, ``chip_smoke.py``);
* :class:`TcpTwoPartyNet`: a length-prefixed TCP socket (party 0
  listens, party 1 dials), for two processes.

The fabric's communication is round-based (batched opens and exchanges),
so the API is a blocking ``exchange_bytes(payload) -> peer_payload`` plus
raw send and receive.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import time

from ..utils.errors import NetworkError, SetupFailedError

PARTY0 = 0
PARTY1 = 1


class TwoPartyNetwork:
    """Abstract two-party transport.  ``sent_messages`` and ``sent_bytes``
    count what this end has sent."""

    party_id: int
    sent_messages = 0
    sent_bytes = 0

    def _count(self, payload: bytes) -> None:
        self.sent_messages += 1
        self.sent_bytes += len(payload)

    def send_bytes(self, payload: bytes) -> None:
        raise NotImplementedError

    def recv_bytes(self) -> bytes:
        raise NotImplementedError

    def exchange_bytes(self, payload: bytes) -> bytes:
        """Send ours, receive the peer's.

        Send and receive run concurrently: with both parties sending first,
        a payload larger than the transport's buffer would deadlock two
        blocking ``sendall`` calls (the batched Beaver round of a large
        circuit)."""
        send_error: list[Exception] = []

        def do_send():
            try:
                self.send_bytes(payload)
            except Exception as exc:  # noqa: BLE001 - re-raised below
                send_error.append(exc)

        sender = threading.Thread(target=do_send)
        sender.start()
        try:
            received = self.recv_bytes()
        finally:
            sender.join()
        if send_error:
            raise send_error[0]
        return received

    def close(self) -> None:
        pass


class LocalTwoPartyNet(TwoPartyNetwork):
    """In-process transport; make both ends with :func:`make_local_pair`.

    ``latency_s`` adds a one-way link delay to every message (a delivery
    time rides the queue; the receiver sleeps until it is due), to price
    the fabric's synchronous rounds on a real party-to-party link."""

    def __init__(self, party_id: int, inbox: "queue.Queue", outbox: "queue.Queue",
                 latency_s: float = 0.0):
        self.party_id = party_id
        self._inbox = inbox
        self._outbox = outbox
        self._latency_s = latency_s

    def send_bytes(self, payload: bytes) -> None:
        self._count(payload)
        self._outbox.put((time.monotonic() + self._latency_s, payload))

    def recv_bytes(self) -> bytes:
        try:
            ready_at, payload = self._inbox.get(timeout=60)
        except queue.Empty as exc:
            raise NetworkError("timed out waiting for peer message") from exc
        delay = ready_at - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        return payload


def make_local_pair(latency_s: float = 0.0) -> tuple[LocalTwoPartyNet, LocalTwoPartyNet]:
    """Both ends of one in-process link (party 0's, party 1's)."""
    q01: queue.Queue = queue.Queue()
    q10: queue.Queue = queue.Queue()
    return (
        LocalTwoPartyNet(PARTY0, inbox=q10, outbox=q01, latency_s=latency_s),
        LocalTwoPartyNet(PARTY1, inbox=q01, outbox=q10, latency_s=latency_s),
    )


class TcpTwoPartyNet(TwoPartyNetwork):
    """Length-prefixed TCP transport: party 0 listens on ``local_addr``,
    party 1 dials ``peer_addr``.  Once connected, a receive (or a send the
    peer does not drain) that waits longer than ``recv_timeout`` seconds
    raises :class:`NetworkError`, as :class:`LocalTwoPartyNet`'s queues do:
    a peer that died or hangs ends this party's run instead of blocking it."""

    def __init__(self, party_id: int, local_addr: tuple[str, int], peer_addr: tuple[str, int],
                 recv_timeout: float = 60.0):
        self.party_id = party_id
        self.local_addr = local_addr
        self.peer_addr = peer_addr
        self.recv_timeout = recv_timeout
        self._sock: socket.socket | None = None

    def connect(self, timeout: float = 30.0) -> None:
        try:
            if self.party_id == PARTY0:
                srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                srv.bind(self.local_addr)
                srv.listen(1)
                srv.settimeout(timeout)
                conn, _ = srv.accept()
                srv.close()
                self._sock = conn
            else:
                deadline = time.time() + timeout
                last_err = None
                while time.time() < deadline:
                    try:
                        self._sock = socket.create_connection(self.peer_addr, timeout=2.0)
                        break
                    except OSError as exc:  # the peer is not listening yet
                        last_err = exc
                        time.sleep(0.1)
                if self._sock is None:
                    raise SetupFailedError(f"could not reach peer: {last_err}")
            self._sock.settimeout(self.recv_timeout)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError as exc:
            raise SetupFailedError(str(exc)) from exc

    def send_bytes(self, payload: bytes) -> None:
        if self._sock is None:
            raise NetworkError("not connected")
        self._count(payload)
        try:
            self._sock.sendall(struct.pack(">I", len(payload)) + payload)
        except OSError as exc:
            raise NetworkError(str(exc)) from exc

    def recv_bytes(self) -> bytes:
        if self._sock is None:
            raise NetworkError("not connected")
        try:
            (length,) = struct.unpack(">I", self._recv_exact(4))
            return self._recv_exact(length)
        except socket.timeout as exc:
            raise NetworkError(f"timed out after {self.recv_timeout} s waiting for the peer") from exc
        except OSError as exc:
            raise NetworkError(str(exc)) from exc

    def _recv_exact(self, count: int) -> bytes:
        buf = bytearray()
        while len(buf) < count:
            chunk = self._sock.recv(count - len(buf))
            if not chunk:
                raise NetworkError("peer closed connection")
            buf += chunk
        return bytes(buf)

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
