"""Localhost multi-process launcher for :class:`DistributedRuntime`.

Counterpart of ``repro/runtime/launcher.py``.  Spawns ``n_procs`` python
processes wired to one coordinator port through the ``REPRO_RT_*``
variables, which ``DistributedRuntime.from_env`` reads; each process
holds ``shards_per_process`` shards.  The children inherit this
process's environment, ``PYTHONPATH`` included, and share its devices:
on one card, every child runs its kernels on that card.

The child is an ordinary python program, a script path or inline code
(``code=``); it calls ``DistributedRuntime.from_env(device=...)``.  On
the card, build the kernels in the parent first
(``repro_torch.kernels.backend.build()``), so no child waits on ``nvcc``.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

from .distributed import ENV_COORD, ENV_NPROCS, ENV_PID, ENV_SHARDS


def find_free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port (released at once; the race window is
    acceptable for localhost launches)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


class ProcResult(NamedTuple):
    """One child's outcome."""
    process_id: int
    returncode: int
    stdout: str
    stderr: str


def _child_env(pid: int, n_procs: int, shards_per_process: int, coord: str,
               extra_env: Optional[Dict[str, str]]) -> Dict[str, str]:
    env = dict(os.environ)
    env.update({ENV_COORD: coord, ENV_NPROCS: str(n_procs),
                ENV_PID: str(pid), ENV_SHARDS: str(shards_per_process)})
    if extra_env:
        env.update(extra_env)
    return env


def launch_localhost(script: Optional[str] = None, *,
                     code: Optional[str] = None,
                     args: Sequence[str] = (),
                     n_procs: int = 2, shards_per_process: int = 4,
                     timeout: float = 600.0,
                     extra_env: Optional[Dict[str, str]] = None,
                     check: bool = True) -> List[ProcResult]:
    """Run ``n_procs`` copies of a python program as one runtime.

    Args:
      script: path of a python file (exclusive with ``code``, which runs
        inline through ``python -c``).
      args: extra argv for every child.
      n_procs / shards_per_process: the world's shape (the pool holds
        ``n_procs * shards_per_process`` shards).
      timeout: seconds for the whole world; children still running then
        are killed and ``subprocess.TimeoutExpired`` raised.  A child that
        exits non-zero before then has its siblings killed at once (they
        would wait for it in a collective).
      extra_env: more environment for every child.
      check: raise ``RuntimeError`` with the failing child's output on
        a nonzero exit (not on a sibling killed after it).

    Returns one :class:`ProcResult` per process, in process-id order.
    """
    if (script is None) == (code is None):
        raise ValueError("pass exactly one of script= or code=")
    coord = f"127.0.0.1:{find_free_port()}"
    cmd = [sys.executable] + (["-c", code] if code is not None else [script])
    cmd += list(args)
    procs = [subprocess.Popen(
        cmd, env=_child_env(pid, n_procs, shards_per_process, coord,
                            extra_env),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(n_procs)]
    # one reader per child: a child blocked on a full pipe would stall
    # the collective its siblings wait in
    outs: list = [("", "")] * n_procs

    def reap(i, p):
        outs[i] = p.communicate()
    readers = [threading.Thread(target=reap, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in readers:
        t.start()
    # a child that fails stops the world: its siblings would wait in a
    # collective until the timeout
    deadline = time.monotonic() + timeout
    hung, killed = False, set()
    try:
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(codes):
                break
            if time.monotonic() > deadline:
                hung = True
                break
            time.sleep(0.05)
    finally:
        for i, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                killed.add(i)
        for t in readers:
            t.join()
    if hung:
        raise subprocess.TimeoutExpired(cmd, timeout, output=outs[0][0],
                                        stderr=outs[0][1])
    results = [ProcResult(i, p.returncode, *outs[i])
               for i, p in enumerate(procs)]
    if check:
        for r in results:
            if r.returncode != 0 and r.process_id not in killed:
                raise RuntimeError(
                    f"distributed child {r.process_id}/{n_procs} exited "
                    f"{r.returncode}\n--- stdout ---\n{r.stdout}\n"
                    f"--- stderr ---\n{r.stderr}")
    return results
