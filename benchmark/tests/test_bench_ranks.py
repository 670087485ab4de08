"""A cell of four ranks, run as ``run.py`` runs it on the card: rank 0 a
process that starts three followers, each a process on the CPU with gloo
in place of NCCL (``cpu_entry.py``), the system ``ShardedSimulation``'s
Morton-range domain decomposition.  And a cell of one card, which starts
no process and makes no process group."""

import json
import os

import pytest
import torch

from conftest import SHARD, ranks_checkout, run_entry
from harness import ranks


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return ranks_checkout(tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def sound(checkout, tmp_path_factory):
    out = tmp_path_factory.mktemp("sound")
    return out, run_entry(checkout, "disc-shard.batch1", out)


def _result(stdout):
    lines = [l for l in stdout.splitlines() if l.startswith("{")]
    return lines


def _steps_by_rank(stderr):
    for line in stderr.splitlines():
        if line.startswith("benchmark: steps by rank "):
            return json.loads(line.split("rank ", 1)[1])
    return None


def test_four_ranks_give_one_correct_result_from_rank_0(sound):
    out, (rc, stdout, stderr, _) = sound
    assert rc == 0, stderr[-3000:]
    lines = _result(stdout)
    assert len(lines) == 1 and stdout.strip().splitlines()[-1] == lines[0]
    result = json.loads(lines[0])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["count"] == 4
    assert result["checks"]["state_err"]["value"] > 0
    made = [json.loads((out / f"made_rank{r}.json").read_text())
            for r in range(4)]
    assert made[0] == {"Popen": 3, "init_process_group": 1}
    assert made[1:] == [{"init_process_group": 1}] * 3


def test_every_rank_made_the_same_steps(sound):
    out, (rc, stdout, stderr, _) = sound
    steps = _steps_by_rank(stderr)
    assert steps is not None and len(steps) == 4, stderr[-3000:]
    assert len(set(steps)) == 1 and steps[0] >= 1
    assert json.loads(_result(stdout)[0])["attempted"] == steps[0]


def test_the_gathered_snapshot_is_the_shards_in_rank_order(sound):
    out, _ = sound
    n_snaps = len(list(out.glob("snap*_gathered.pt")))
    assert n_snaps == 4  # the first step's two, the checked step's two
    for i in range(n_snaps):
        whole = torch.load(out / f"snap{i}_gathered.pt")
        shards = [torch.load(out / f"snap{i}_rank{r}.pt") for r in range(4)]
        for k, v in whole.items():
            assert torch.equal(v, torch.cat([s[k] for s in shards])), k
        assert whole["pos"].shape[0] % 4 == 0
        assert not whole["alive"][SHARD["n"] + 1:].any()
    # the scene's rows, in the scene's order, before the first step
    from harness import manifest

    pos, _, mass = manifest.plugin("scenes", "disc").make(
        SHARD["n"], box_width=10.0, seed=(2**31 + 41) % (1 << 64))
    first = torch.load(out / "snap0_gathered.pt")
    assert torch.equal(first["mass"][:SHARD["n"] + 1],
                       torch.as_tensor(mass, dtype=torch.float32))
    assert torch.equal(first["pos"][:SHARD["n"] + 1],
                       torch.as_tensor(pos, dtype=torch.float32))


def test_a_traced_run_of_four_ranks(checkout, tmp_path):
    """Rank 0 traces and reads the per-layer metrics; the followers make
    the steps that rank 0's set-up traces, so the ranks stay in step."""
    rc, stdout, stderr, _ = run_entry(checkout, "disc-shard.batch1",
                                      tmp_path, seed=2**31 + 43, seconds=8.0,
                                      trace=1)
    assert rc == 0, stderr[-3000:]
    result = json.loads(_result(stdout)[-1])
    assert result["correct"] is True
    assert result["metrics"] and "steps_per_s" not in result["metrics"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert len(set(_steps_by_rank(stderr))) == 1


def test_a_fault_on_one_followers_shard_makes_correct_false(checkout,
                                                            tmp_path):
    rc, stdout, stderr, _ = run_entry(checkout, "disc-shard.batch1",
                                      tmp_path, env={"CPU_ENTRY_SHIFT": "2"})
    assert rc == 0, stderr[-3000:]
    result = json.loads(_result(stdout)[-1])
    assert result["correct"] is False
    row = result["checks"]["state_err"]
    assert row["value"] > row["limit"]


def _ended(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/status") as f:
            return any(l.startswith("State:") and "Z" in l.split()[1]
                       for l in f)
    except FileNotFoundError:
        return True


def test_a_follower_that_exits_ends_the_run_without_a_result(checkout,
                                                             tmp_path):
    """Rank 3 exits at its third call of ``run`` (the window's first), in
    a window of 60 s: the run ends non-zero and without a result within
    ``FAIL_BOUND_S`` of that exit (by rank 0's watchdog, or sooner where
    rank 0's collective fails first), and no rank is left."""
    rc, stdout, stderr, t_end = run_entry(
        checkout, "disc-shard.batch1", tmp_path, seconds=60.0,
        env={"CPU_ENTRY_EXIT": "3:3"})
    assert rc != 0 and "{" not in stdout
    t_exit = float((tmp_path / "exit_time").read_text())
    assert 0 <= t_end - t_exit < ranks.FAIL_BOUND_S
    for r in range(4):
        assert _ended(int((tmp_path / f"pid_rank{r}").read_text())), r


def test_one_card_starts_no_process_and_makes_no_group(checkout, tmp_path):
    rc, stdout, stderr, _ = run_entry(checkout, "disc-tiny.batch", tmp_path)
    assert rc == 0, stderr[-3000:]
    assert json.loads(_result(stdout)[-1])["correct"] is True
    assert json.loads((tmp_path / "made_rank0.json").read_text()) == {}
    assert "steps by rank" not in stderr


def test_the_view_kind_refuses_more_than_one_card(checkout, tmp_path):
    rc, stdout, stderr, _ = run_entry(checkout, "disc-shard.view", tmp_path)
    assert rc != 0 and "{" not in stdout
    assert "runs on one card" in stderr
    assert json.loads((tmp_path / "made_rank0.json").read_text()) == {}
    assert not os.path.exists(tmp_path / "pid_rank1")


SUPERVISED = """
import os, sys, time
sys.path.insert(0, {bench!r})
from harness import ranks

out = {out!r}
argv = sys.argv[1:]
if "--rank" in argv:
    rank = int(argv[argv.index("--rank") + 1])
    ranks.watch_rank0()
    open(os.path.join(out, f"pid_rank{{rank}}"), "w").write(str(os.getpid()))
    if argv[0] == "fail" and rank == 1:
        time.sleep(1.0)
        sys.exit(7)
    time.sleep(60)
    sys.exit(0)
followers = ranks.Followers(argv, 3)
time.sleep(3.0)
if argv[0] == "kill0":
    os.kill(os.getpid(), 9)
time.sleep(60)
print("{{}}")
"""


def _supervised(tmp_path, mode):
    import subprocess
    import sys
    import time

    from conftest import BENCH

    script = tmp_path / "supervised.py"
    script.write_text(SUPERVISED.format(bench=str(BENCH), out=str(tmp_path)))
    t0 = time.time()
    p = subprocess.run([sys.executable, str(script), mode], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    return p, time.time() - t0


def test_the_watchdog_ends_rank_0_when_a_follower_fails(tmp_path):
    """Rank 1 exits with 7 after a second while rank 0 sleeps: rank 0
    ends with ``FOLLOWER_FAILED`` and no result, having killed rank 2."""
    p, took = _supervised(tmp_path, "fail")
    assert p.returncode == ranks.FOLLOWER_FAILED
    assert "{" not in p.stdout and "rank 1 exited with code 7" in p.stderr
    assert took < 1.0 + ranks.FAIL_BOUND_S
    assert _ended(int((tmp_path / "pid_rank2").read_text()))


def test_followers_end_when_rank_0_is_killed(tmp_path):
    import time

    p, took = _supervised(tmp_path, "kill0")
    assert p.returncode == -9
    deadline = time.time() + ranks.FAIL_BOUND_S
    pids = [int((tmp_path / f"pid_rank{r}").read_text()) for r in (1, 2)]
    while time.time() < deadline and not all(map(_ended, pids)):
        time.sleep(0.2)
    assert all(map(_ended, pids))
