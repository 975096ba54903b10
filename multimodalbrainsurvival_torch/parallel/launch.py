"""Start a world of processes on this host, one rank each.

What ``python -m torch.distributed.run --nproc_per_node N`` does for a
single node, kept small so that a caller sees each rank's own exit status
and output: ``start`` sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` (127.0.0.1), ``MASTER_PORT`` (a
free port, found by binding port 0) and, unless set, ``OMP_NUM_THREADS``
(the host's cores over the ranks) for each rank's process, its output
going to ``<log_dir>/rank<r>.log``; ``wait`` collects the exit statuses,
killing the whole world at the time limit. The dry run
(``parallel/dryrun.py``), the tests and ``chip_smoke.py`` start their
worlds with it.
"""

from __future__ import annotations

import os
import socket
import subprocess
import time
from dataclasses import dataclass


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class Rank:
    process: subprocess.Popen
    log: str

    def output(self) -> str:
        with open(self.log, errors="replace") as f:
            return f.read()


def start(world: int, argv: list[str], log_dir: str, env: dict | None = None,
          cwd: str | None = None) -> list[Rank]:
    """``argv`` in ``world`` processes, rank r's output in
    ``<log_dir>/rank<r>.log``."""
    os.makedirs(log_dir, exist_ok=True)
    base = dict(os.environ if env is None else env)
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    # the host's cores shared out, as torch.distributed.run does
    base.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // world)))
    ranks = []
    for r in range(world):
        log = os.path.join(log_dir, f"rank{r}.log")
        with open(log, "w") as out:
            process = subprocess.Popen(
                argv, stdout=out, stderr=subprocess.STDOUT, cwd=cwd,
                env={**base, "RANK": str(r), "LOCAL_RANK": str(r)})
        ranks.append(Rank(process, log))
    return ranks


def wait(ranks: list[Rank], timeout: float) -> list[int]:
    """Every rank's exit status; at ``timeout`` seconds all are killed and
    TimeoutError is raised with their output's ends."""
    deadline = time.monotonic() + timeout
    try:
        return [r.process.wait(max(deadline - time.monotonic(), 0.01)) for r in ranks]
    except subprocess.TimeoutExpired:
        for r in ranks:
            r.process.kill()
        for r in ranks:
            r.process.wait()
        tails = "\n".join(f"--- rank {i}\n{r.output()[-2000:]}" for i, r in enumerate(ranks))
        raise TimeoutError(f"world of {len(ranks)} did not end in {timeout} s\n{tails}")


def run(world: int, argv: list[str], log_dir: str, timeout: float,
        env: dict | None = None, cwd: str | None = None) -> list[tuple[int, str]]:
    """``start`` then ``wait``: each rank's ``(exit status, output)``."""
    ranks = start(world, argv, log_dir, env, cwd)
    codes = wait(ranks, timeout)
    return [(c, r.output()) for c, r in zip(codes, ranks)]
