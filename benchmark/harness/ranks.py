"""The ranks of a cell that asks for more than one card.

``run.py`` is started once, as rank 0.  For a cell with ``chips`` above 1
it starts ``chips - 1`` followers, each the same command with ``--rank r
--store <dir>`` added (``Followers``); every rank takes card ``cuda:<rank>``
and joins one default process group of world size ``chips`` (NCCL on the
card, gloo on the CPU) and a gloo group beside it for the host's
decisions, both on a ``file://`` store in a fresh temporary directory
(``join``).  Every rank then runs the same set-up, the same driver calls
and the same gathers; rank 0 alone decides when the window ends
(``Team.decide``), judges the gathered state and prints the result.

How a failed rank ends the run:

  * a follower that exits with a code other than 0, or is killed, is seen
    by rank 0's watchdog within ``POLL_S``; it kills the other followers,
    waits up to ``KILL_WAIT_S`` for them and ends rank 0 with code
    ``FOLLOWER_FAILED``, whatever rank 0 was doing, before any result is
    printed: within ``FAIL_BOUND_S`` of the follower's end;
  * rank 0 that fails stops its followers before it exits; one that is
    killed closes their standard input, on which each follower watches for
    the end of file and then exits at once;
  * a rank that hangs holds the others in a collective until the groups'
    ``TIMEOUT`` raises there.

At one card none of this runs: no process, no group, no channel.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from datetime import timedelta

#: how long a collective of the run's groups waits for the other ranks
TIMEOUT = timedelta(seconds=120)
#: rank 0's watchdog looks at its followers this often
POLL_S = 0.25
#: how long it waits for the killed followers to end
KILL_WAIT_S = 10.0
#: a follower's failure ends the run within this many seconds
FAIL_BOUND_S = 15.0
#: rank 0's exit code when a follower failed
FOLLOWER_FAILED = 4


class Followers:
    """Rank 0's followers: started at once, watched until ``finish`` or
    ``stop``."""

    def __init__(self, argv, chips: int):
        self.store = tempfile.mkdtemp(prefix="bench_ranks_")
        script = os.path.abspath(sys.argv[0])
        self.procs = []
        for r in range(1, chips):
            env = dict(os.environ, LOCAL_RANK=str(r))
            self.procs.append(subprocess.Popen(
                [sys.executable, script, *argv, "--rank", str(r),
                 "--store", self.store], stdin=subprocess.PIPE, stdout=2,
                env=env))
        self._done = threading.Event()
        self._watch = threading.Thread(target=self._watchdog, daemon=True)
        self._watch.start()

    def _watchdog(self):
        while not self._done.wait(POLL_S):
            for r, p in enumerate(self.procs, 1):
                rc = p.poll()
                if rc is not None and rc != 0 and not self._done.is_set():
                    print(f"benchmark: rank {r} exited with code {rc}; "
                          "ending the run", file=sys.stderr, flush=True)
                    self._kill()
                    os._exit(FOLLOWER_FAILED)

    def _kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        deadline = time.monotonic() + KILL_WAIT_S
        for p in self.procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
            if p.stdin is not None:
                p.stdin.close()

    def finish(self, timeout: float = 60.0) -> list:
        """Wait for every follower to end by itself; the ranks (from 1)
        that did not end with 0 in ``timeout`` seconds.  The others are
        then killed."""
        deadline = time.monotonic() + timeout
        bad = []
        for r, p in enumerate(self.procs, 1):
            try:
                rc = p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = None
            if rc != 0:
                bad.append(r)
        self.stop()
        return bad

    def stop(self):
        """Kill what still runs, wait for it, remove the store."""
        self._done.set()
        self._kill()
        shutil.rmtree(self.store, ignore_errors=True)


def watch_rank0():
    """A follower's guard: exit at once when rank 0 is gone (the end of
    file on the standard input rank 0 holds open)."""
    def watch():
        while os.read(0, 4096):
            pass
        print("benchmark: rank 0 is gone; a follower ends",
              file=sys.stderr, flush=True)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


class Team:
    """This process's rank among ``world``, the default group (the
    program's collectives) and ``ctl``, a gloo group for what the harness
    decides and gathers on the host; on rank 0 also its ``followers``."""

    def __init__(self, torch, rank: int, world: int, ctl):
        self.torch, self.rank, self.world, self.ctl = torch, rank, world, ctl
        self.lead = rank == 0
        self.followers = None

    def decide(self, go: bool) -> bool:
        """Rank 0's ``go``, on every rank."""
        t = self.torch.tensor([int(go)], dtype=self.torch.int64)
        self.torch.distributed.broadcast(t, src=0, group=self.ctl)
        return bool(t.item())

    def ints(self, v: int) -> list:
        """Every rank's ``v``, in rank order, on every rank."""
        torch = self.torch
        t = torch.tensor([int(v)], dtype=torch.int64)
        out = [torch.zeros_like(t) for _ in range(self.world)]
        torch.distributed.all_gather(out, t, group=self.ctl)
        return [int(x.item()) for x in out]

    def gather(self, x):
        """Every rank's ``x`` concatenated along dim 0 in rank order, on
        rank 0's host (None on the others): through the host, so that
        no card holds more than its own shard for it."""
        torch = self.torch
        w = x.to(torch.uint8) if x.dtype == torch.bool else x
        w = w.contiguous().cpu()
        parts = ([torch.empty_like(w) for _ in range(self.world)]
                 if self.lead else None)
        torch.distributed.gather(w, parts, dst=0, group=self.ctl)
        return torch.cat(parts).to(x.dtype) if self.lead else None

    def finish(self) -> list:
        """Leave the groups, after the last gather; on rank 0 then wait
        for the followers to end: the ranks that did not end with 0."""
        self.torch.distributed.destroy_process_group()
        return self.followers.finish() if self.followers else []


def join(torch, device: str, rank: int, world: int, store: str,
         followers: Followers = None) -> Team:
    """Join the run's groups as ``rank`` (rank 0 with its
    ``followers``); on the card first take ``cuda:<rank>`` as the current
    device."""
    dist = torch.distributed
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method="file://" + os.path.join(store,
                                                                 "group"),
                            rank=rank, world_size=world, timeout=TIMEOUT)
    team = Team(torch, rank, world, dist.new_group(backend="gloo",
                                                   timeout=TIMEOUT))
    team.followers = followers
    return team
