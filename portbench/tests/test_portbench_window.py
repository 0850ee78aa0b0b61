"""The window rule: whole batches only, started while the window's seconds
last, each on inputs of its own; the rate is the work over the span from
the first start to the last end."""

import time

import torch

from portbench import catalog, streams


class Slow:
    """A stand-in entry: each call takes ``dt`` seconds and echoes its
    inputs as a solution of one trip."""

    def __init__(self, dt):
        self.dt, self.seen = dt, []

    def __call__(self, xs, us, ws):
        time.sleep(self.dt)
        self.seen.append(xs[:, 0].clone())

        class Sol:
            pass
        sol = Sol()
        B = xs.shape[0]
        sol.xs, sol.us, sol.iterations = xs, us, torch.ones(B, dtype=torch.int32)
        sol.objective = sol.reg = torch.zeros(B)
        sol.status = torch.ones(B, dtype=torch.bool)
        sol.duals = sol.penalty = torch.zeros(B, xs.shape[1], 4)
        sol.K, sol.k = torch.zeros(B, xs.shape[1] - 1, 1, 4), torch.zeros(B, xs.shape[1] - 1, 1)
        return sol


def test_no_batch_is_cut_and_each_draws_its_own_inputs(monkeypatch):
    config = catalog.config("acrobot_T101")
    s = streams.Sweep(config, {"kind": "sweep", "batch": 4}, 2, torch.device("cpu"), torch.float32)
    s.solver.solve = Slow(0.12)
    w = s.window(seed=9, seconds=0.3)
    n = len(w["answers"])
    assert n == 3                                    # started at 0, 0.12, 0.24 s
    assert w["span"] >= 0.36 and w["span"] >= w["answers"][-1]["t1"] - w["answers"][0]["t0"]
    assert w["trips"] == n
    seen = s.solver.solve.seen
    assert all(not torch.equal(seen[i], seen[j]) for i in range(n) for j in range(i))
    again = streams.Sweep(config, {"kind": "sweep", "batch": 4}, 2, torch.device("cpu"),
                          torch.float32).inputs(9, 1)
    assert torch.equal(again[0][:, 0], seen[1])
