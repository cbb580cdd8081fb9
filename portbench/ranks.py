"""A cell over several cards: one process a card, the processes in one group.

The parent (`launch`, from portbench/run.py) starts P ranks, each the
run's own command with the rank's flags, in a session of its own; rank r
runs on the device the parent names for it (cuda:r; the CPU tests name
the CPU) and joins the others through the program's own
`multihost.initialize("127.0.0.1:N", P, r)`, a gloo group.  Each rank
gets an equal share of the parent's CPUs for its thread pools
(OMP_NUM_THREADS), as a launcher of one process a card gives it, so
that the ranks' pools do not contend for the cores.  Rank 0 writes
two lines to a pipe that the parent reads: "open" when its window opens,
and "result <json>" once its run is done.  The ranks also share a few
words of memory that the parent makes (a memfd), where they meet after
every request (`Meeting`).  The parent watches its ranks: when any rank
exits with another code than 0, or the set-up passes SETUP_LIMIT
seconds, or the window and the check pass `--seconds` + CHECK_LIMIT, it
kills every rank's session (with any compiler a rank started) and
returns None.  The program's gloo group waits 30 minutes on a rank that
has died, so without the parent the live ranks would hang.  A rank also
dies with its parent (PR_SET_PDEATHSIG).

A rank's side: `world`, `barrier`, `Meeting` (the rendezvous that ends
each request of a sharded window), `summed_counts` and `reduce` (the
harness's own sums and maxima over the ranks, in the gloo group): for one
process, no collective runs.

The rendezvous is not a gloo all-reduce: one of two ints took 1.6 ms on
the four-card host (PERF.md), twice the slowest card's decode, so the
request would have timed the harness.  The meeting in shared memory
costs microseconds, and a request still ends when the slowest card has
decoded its shard.  It holds for ranks on one host; ranks on several
hosts would meet over the network.

The launcher is the harness's own, not torchrun: the program's
`initialize` makes its own TCP store at the address it is given, so the
ranks need a free port agreed before they start besides the one that
torchrun's agent holds, and the meeting needs memory that the parent
shares with its ranks.
"""

from __future__ import annotations

import ctypes
import json
import mmap
import os
import select
import signal
import socket
import subprocess
import sys
import time

SETUP_LIMIT = 1080.0  # s to the window: the first run in a checkout builds
#                       every kernel in every rank
CHECK_LIMIT = 240.0   # s past --seconds: the last request, the trace's
#                       reading on rank 0 and the reference's check
POLL = 0.25           # s between the parent's looks at its ranks


def log(*parts) -> None:
    """One line on standard error, in one write: the ranks of a run share
    it."""
    sys.stderr.write(" ".join(map(str, parts)) + "\n")
    sys.stderr.flush()


# --------------------------------------------------------------------------
# the parent
# --------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def threads(world: int) -> int:
    """The CPUs of this process shared equally over `world` ranks."""
    return max(1, len(os.sched_getaffinity(0)) // world)


def launch(command: list, devices: list, seconds: float,
           cwd=None) -> dict | None:
    """Run `command` as one rank a device of `devices` and return rank 0's
    result, or None when a rank failed or the run passed its limits:
    every rank has then been killed.  `command` is the run's own,
    `--started` included; each rank's standard output goes to standard
    error, so that the parent's own result line is the last of its
    standard output."""
    world = len(devices)
    env = dict(os.environ, OMP_NUM_THREADS=str(threads(world)))
    port = free_port()
    read_fd, write_fd = os.pipe()
    meet_fd = os.memfd_create("portbench-meeting")
    os.ftruncate(meet_fd, Meeting.size(world))
    procs = []
    try:
        for r in range(world):
            extra = ["--rank", str(r), "--world", str(world), "--port",
                     str(port), "--meet-fd", str(meet_fd), "--device",
                     devices[r]]
            if r == 0:
                extra += ["--result-fd", str(write_fd)]
            procs.append(subprocess.Popen(
                command + extra, cwd=cwd, env=env,
                stdout=sys.stderr.fileno(),
                pass_fds=(meet_fd, write_fd) if r == 0 else (meet_fd,),
                start_new_session=True))
        os.close(write_fd)
        write_fd = None
        return _watch(procs, read_fd, seconds)
    finally:
        if write_fd is not None:
            os.close(write_fd)
        os.close(read_fd)
        os.close(meet_fd)
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()


def _watch(procs: list, read_fd: int, seconds: float) -> dict | None:
    deadline = time.monotonic() + SETUP_LIMIT
    buf, result, reading = b"", None, True
    while True:
        if reading and select.select([read_fd], [], [], POLL)[0]:
            chunk = os.read(read_fd, 1 << 20)
            reading = bool(chunk)
            buf += chunk
            *lines, buf = buf.split(b"\n")
            for line in lines:
                if line == b"open":
                    deadline = time.monotonic() + seconds + CHECK_LIMIT
                elif line.startswith(b"result "):
                    result = json.loads(line[len(b"result "):])
        elif not reading:
            time.sleep(POLL)
        codes = [p.poll() for p in procs]
        failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
        if failed:
            log("ranks ended: " + ", ".join(f"rank {r} exit {c}"
                                            for r, c in failed)
                + "; killing every rank")
            return None
        if all(c == 0 for c in codes) and not reading:
            if result is None:
                log("rank 0 ended without a result")
            return result
        if time.monotonic() > deadline:
            log("the run passed its time limit; killing every rank")
            return None


# --------------------------------------------------------------------------
# a rank
# --------------------------------------------------------------------------

def die_with_parent() -> None:
    """Have the kernel kill this process when its parent dies (Linux)."""
    try:
        ctypes.CDLL(None).prctl(1, int(signal.SIGKILL))  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def world() -> tuple[int, int]:
    """(processes in the group, this one's rank); (1, 0) without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def barrier() -> None:
    if world()[0] > 1:
        import torch.distributed as dist
        dist.barrier()


class Meeting:
    """The rendezvous of the ranks after each request, in the memory
    behind `fd`: called with this rank's (failed, stop), it returns both
    summed over the ranks once every rank has called it for the same
    request.  Rank r posts request i as (i + 1) << 2 | failed << 1 | stop
    in word [i % 2, r], then spins until every rank's word in that row has
    reached request i.  Two rows, by the request's parity: no rank can
    post request i + 2 before every rank has posted i + 1, which each
    does only after it has read request i's row.  (Each rank writes its
    own aligned word; x86 keeps stores in order.)"""

    @staticmethod
    def size(world: int) -> int:
        return 2 * 8 * world

    def __init__(self, fd: int, world: int, rank: int):
        import numpy as np
        self._map = mmap.mmap(fd, self.size(world))
        self.rows = np.frombuffer(self._map, dtype=np.int64).reshape(2, world)
        self.rank, self.done = rank, 0

    def __call__(self, failed: int, stop: int) -> tuple[int, int]:
        row = self.rows[self.done % 2]
        self.done += 1
        row[self.rank] = self.done << 2 | failed << 1 | stop
        while (row >> 2 < self.done).any():
            pass
        return int((row >> 1 & 1).sum()), int((row & 1).sum())


def summed_counts(arrays: list):
    """The raw-value histogram of `arrays` together, summed over the
    ranks (int64, as long as the longest)."""
    import numpy as np
    size = max(int(a.max()) for a in arrays) + 1
    counts = sum(np.bincount(a, minlength=size) for a in arrays)
    if world()[0] == 1:
        return counts
    import torch
    import torch.distributed as dist
    size = torch.tensor([len(counts)], dtype=torch.int64)
    dist.all_reduce(size, op=dist.ReduceOp.MAX)
    t = torch.zeros(int(size[0]), dtype=torch.int64)
    t[:len(counts)] = torch.from_numpy(counts.astype(np.int64))
    dist.all_reduce(t)
    return t.numpy()


def reduce(sums: dict, maxima: dict) -> tuple[dict, dict]:
    """`sums` (whole numbers) summed and `maxima` taken the largest over
    the ranks, each in one all-reduce."""
    if world()[0] == 1:
        return sums, maxima
    import torch
    import torch.distributed as dist
    s = torch.tensor(list(sums.values()), dtype=torch.int64)
    m = torch.tensor(list(maxima.values()), dtype=torch.float64)
    dist.all_reduce(s)
    dist.all_reduce(m, op=dist.ReduceOp.MAX)
    return (dict(zip(sums, (int(v) for v in s))),
            dict(zip(maxima, (float(v) for v in m))))
