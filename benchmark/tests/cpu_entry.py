"""``run.py`` on the CPU, for the tests of the harness's ranks.

A test copies this file beside ``run.py`` in its checkout and starts it as
``run.py`` is started; rank 0 then starts its followers as this same file,
as it starts them as ``run.py`` on the card.  Each rank runs the harness
past the look for a card, on the program's plain-torch path, with gloo in
place of NCCL.  What a test plants or records comes from the environment,
read here and never by the harness:

  * ``CPU_ENTRY_DIR``: where each rank writes what the tests read: its
    process id (``pid_rank<r>``), the shard and, on rank 0, the gathered
    arrays of each ``snapshot`` (``snap<i>_rank<r>.pt``,
    ``snap<i>_gathered.pt``), the process groups and processes it made
    (``made_rank<r>.json``), and the time a planted exit happened
    (``exit_time``);
  * ``CPU_ENTRY_EXIT`` = ``"<rank>:<k>"``: that rank ends with code 7 at its
    ``k``-th call of ``ShardedSimulation.run``;
  * ``CPU_ENTRY_SHIFT`` = ``"<rank>"``: that rank moves its shard's row 7
    by 1e-3 in x after every ``ShardedSimulation.run``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from harness import main  # noqa: E402


def _rank(argv) -> int:
    return int(argv[argv.index("--rank") + 1]) if "--rank" in argv else 0


def plant(rank: int, out: Path, made: dict):
    from nbody_tpu_torch.parallel import sharded

    run, calls = sharded.ShardedSimulation.run, [0]
    exit_at = os.environ.get("CPU_ENTRY_EXIT", "")
    shift = os.environ.get("CPU_ENTRY_SHIFT", "")

    def planted(self, n_steps, dt=None):
        calls[0] += 1
        if exit_at and exit_at == f"{rank}:{calls[0]}":
            (out / "exit_time").write_text(repr(time.time()))
            os._exit(7)
        run(self, n_steps, dt)
        if shift == str(rank):
            pos = self._state.pos.clone()
            pos[7, 0] += 1e-3
            self._state = dataclasses.replace(self._state, pos=pos)
        return self._state

    sharded.ShardedSimulation.run = planted

    snap, seen = main.snapshot, [0]

    def recorded(state, to_host, team=None):
        got = snap(state, to_host, team)
        i = seen[0]
        seen[0] += 1
        keys = ("pos", "vel", "acc", "mass", "alive")
        torch.save({k: getattr(state, k).cpu() for k in keys},
                   out / f"snap{i}_rank{rank}.pt")
        if got:
            torch.save({k: v.cpu() for k, v in got.items()},
                       out / f"snap{i}_gathered.pt")
        return got

    main.snapshot = recorded

    for mod, name in ((dist, "init_process_group"),
                      (subprocess, "Popen")):
        orig = getattr(mod, name)

        def counted(*a, _orig=orig, _name=name, **kw):
            made[_name] = made.get(_name, 0) + 1
            return _orig(*a, **kw)

        setattr(mod, name, counted)


if __name__ == "__main__":
    t_start = time.perf_counter()
    argv = sys.argv[1:]
    rank = _rank(argv)
    out = Path(os.environ["CPU_ENTRY_DIR"])
    (out / f"pid_rank{rank}").write_text(str(os.getpid()))
    made = {}
    plant(rank, out, made)
    rc = main.run(argv, t_start, where="cpu", root=HERE.parent,
                  bench_dir=HERE)
    (out / f"made_rank{rank}.json").write_text(json.dumps(made))
    sys.exit(rc)
