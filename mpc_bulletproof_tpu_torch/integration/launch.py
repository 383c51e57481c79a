"""Run both parties of the integration harness (:mod:`.main`) as two OS
processes on one machine, over loopback:

    python -m mpc_bulletproof_tpu_torch.integration.launch [--deadline S] [harness arguments]

e.g. ``... launch --device cpu --test transcript``.  The launcher picks a
free loopback port (it binds port 0), starts both parties with this
interpreter and the repository root on ``PYTHONPATH``, waits for both
under a deadline, kills both when it passes, and returns both exit codes
and outputs.  From Python: :func:`run_pair`, or :class:`Pair` to watch
the parties while they run.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def free_port(host: str = "127.0.0.1") -> int:
    """A port no socket on ``host`` holds now (the kernel's pick for port 0)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


class Pair:
    """Both parties running: ``procs[i]`` is party i's process, ``out[i]``
    and ``err[i]`` the lines it has written so far (read by a thread each,
    so neither pipe fills)."""

    def __init__(self, args: list[str], *, host: str = "127.0.0.1", port: int | None = None, env=None):
        self.port = port or free_port(host)
        env = dict(os.environ if env is None else env)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
        self.out: list[list[str]] = [[], []]
        self.err: list[list[str]] = [[], []]
        self.procs = []
        self._readers = []
        for party in (0, 1):
            cmd = [sys.executable, "-m", "mpc_bulletproof_tpu_torch.integration.main", "--party", str(party),
                   "--port", str(self.port), "--host", host, *args]
            proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
            self.procs.append(proc)
            for stream, sink in ((proc.stdout, self.out[party]), (proc.stderr, self.err[party])):
                reader = threading.Thread(target=lambda s=stream, k=sink: k.extend(s), daemon=True)
                reader.start()
                self._readers.append(reader)

    def kill(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()

    def wait(self, deadline_s: float) -> dict:
        """Wait for both parties until ``deadline_s`` seconds from now, then
        kill whichever still runs.  Returns ``{"rcs", "stdout", "stderr",
        "reports", "timed_out", "seconds"}``: ``rcs`` the exit codes (None
        for a party the deadline killed), ``reports`` each party's JSON
        line (None if it printed none)."""
        t0 = time.monotonic()
        end = t0 + deadline_s
        rcs = []
        for proc in self.procs:
            try:
                rcs.append(proc.wait(timeout=max(0.0, end - time.monotonic())))
            except subprocess.TimeoutExpired:
                rcs.append(None)
        timed_out = any(rc is None for rc in rcs)
        self.kill()
        for proc in self.procs:
            proc.wait()
        for reader in self._readers:
            reader.join(timeout=10)
        stdout = ["".join(lines) for lines in self.out]
        return {"rcs": rcs, "stdout": stdout, "stderr": ["".join(lines) for lines in self.err],
                "reports": [report(text) for text in stdout], "timed_out": timed_out,
                "seconds": time.monotonic() - t0}


def report(stdout: str):
    """A party's JSON line (the last line that parses as a JSON object with
    a ``party`` key), or None."""
    for line in reversed(stdout.splitlines()):
        if line.startswith("{"):
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict) and "party" in obj:
                return obj
    return None


def run_pair(args: list[str], deadline_s: float, **kw) -> dict:
    """Start both parties with the harness arguments ``args`` and wait for
    them (:meth:`Pair.wait`)."""
    return Pair(args, **kw).wait(deadline_s)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    deadline = 3600.0
    if argv[:1] == ["--deadline"]:
        deadline, argv = float(argv[1]), argv[2:]
    res = run_pair(argv, deadline)
    sys.stdout.write(res["stdout"][0])
    for party in (0, 1):
        if res["rcs"][party] != 0:
            sys.stderr.write(f"party {party}: exit {res['rcs'][party]}\n{res['stderr'][party]}")
    if res["timed_out"]:
        sys.stderr.write(f"deadline of {deadline} s passed: both parties killed\n")
    return 0 if res["rcs"] == [0, 0] else 1


if __name__ == "__main__":
    sys.exit(main())
