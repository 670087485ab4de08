"""The check fails what it must: the control (the reference in the
program's place in bfloat16) and the faults a cell can have, each planted
in the program underneath a run driven past the look for a card."""

import dataclasses

import pytest
import torch

from conftest import run_cell


def test_the_control_fails_the_check(tree):
    import sys
    from harness import main

    sys.path.insert(0, str(tree / "benchmark"))
    import control

    rows = control.run_control("disc-tiny.batch", [4, 2**31 + 3], 0.5,
                               main.Card(torch, "cpu"), root=tree,
                               bench_dir=tree / "benchmark")
    for row in rows:
        assert row["correct"] and row["control_correct"] is False
        failed = [k for k, lim in row["limits"].items()
                  if row["control"].get(k, 0) > lim]
        assert "state_err" in failed
        # the program's own readings sit below the control's
        assert row["readings"]["state_err"] * 1e3 < row["control"][
            "state_err"]


def _unchanged(state, new):
    return state


def _half_left_out(state, new):
    half = torch.arange(state.capacity) % 2 == 0
    col = half[:, None]
    return dataclasses.replace(
        new, pos=torch.where(col, state.pos, new.pos),
        vel=torch.where(col, state.vel, new.vel))


def _one_altered(state, new):
    pos = new.pos.clone()
    pos[7, 0] += 1e-3
    return dataclasses.replace(new, pos=pos)


def _force_halved(state, new):
    return dataclasses.replace(new, acc=new.acc * 0.5)


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _one_altered,
                                   _force_halved])
@pytest.mark.parametrize("cell", ["disc-tiny.batch", "disc-tiny.view"])
def test_a_fault_makes_correct_false(tree, monkeypatch, fault, cell):
    """Each step of the window's own call (``Simulation.run`` in batch,
    ``Simulation.step`` in view) broken underneath the harness."""
    from nbody_tpu_torch import api

    run, step_by = api.Simulation.run, api.Simulation.step_by

    def broken_run(self, n_steps, dt=None):
        for _ in range(n_steps):
            old = self._state
            run(self, 1, dt)
            self._state = fault(old, self._state)
        return self._state

    def broken_step_by(self, dt=None):
        old = self._state
        step_by(self, dt)
        self._state = fault(old, self._state)

    monkeypatch.setattr(api.Simulation, "run", broken_run)
    monkeypatch.setattr(api.Simulation, "step_by", broken_step_by)
    rc, result, err = run_cell(tree, cell, seconds=0.5)
    assert rc == 0 and result["correct"] is False, err
