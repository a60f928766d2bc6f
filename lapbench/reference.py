"""The plain reference that decides ``correct``.

It imports nothing of the program and takes nothing the program derived:
it reads the COO arrays the benchmark made (rows, columns, float32 costs)
and the program's answers (the assignment, the reported objective, and
the prices where the public entry returns them), and works out in float64:

- ``bad_rows``: rows whose assigned column is not an entry of the input,
  plus columns assigned twice (0 for a perfect matching on the input).
- ``obj_rel_err``: the reported objective against the objective of the
  assignment recomputed from the input costs, relative.
- ``gap``: the duality gap ``sum_i c_i,sigma(i) - D(v)`` of the assignment
  against the dual bound ``D(v) = sum_i min_j (c_ij - v_j) + sum_j v_j``
  (a lower bound on the optimum for every ``v``), in units of
  ``n * eps_min``.  ``v`` is the negated program prices (a minimisation's
  duals in the solver's maximisation form) where the entry returns them,
  else duals this module works out itself by Bellman-Ford over the
  assignment's residual graph with every edge lengthened by ``eps_min``
  (``bf_duals``), which converge exactly when the assignment is
  eps_min-optimal in the sense of complementary slackness.
- ``slack_max``: the largest row slack ``c_i,sigma(i) - v_sigma(i) -
  min_j (c_ij - v_j)`` in units of ``eps_min``: eps_min-complementary
  slackness of the returned prices (priced entries only).
- ``final_eps``: the final eps the program reports, in units of the
  eps_min of the request's costs (of all its instances' costs in a batch,
  which runs one schedule): above 1, the schedule stopped short of
  eps_min.

``eps_min`` is the solver's documented float default, worked out from the
costs: ``max(1 / (m + 1), 1e-6 * max cost)``.
"""

from __future__ import annotations

import math
import numpy as np
import torch


def eps_min(cost_max: float, m: int) -> float:
    """The float path's final eps: 1/(m+1), floored by float32's
    resolution of the cost range."""
    return max(1.0 / (m + 1), float(cost_max) * 1e-6)


class Instance:
    """One or more same-shape instances on ``device``, COO sorted by (row,
    column) within each; instance b's rows and columns are flattened to
    ``b * n + r`` and ``b * m + c``."""

    def __init__(self, rows, cols, costs, n: int, m: int, device="cpu"):
        dev = torch.device(device)
        rows = [np.asarray(r, np.int64) for r in rows]
        cols = [np.asarray(c, np.int64) for c in cols]
        self.B, self.n, self.m = len(rows), int(n), int(m)
        self.nnz = [int(r.shape[0]) for r in rows]
        off = np.repeat(np.arange(self.B, dtype=np.int64), self.nnz)
        self.rows = torch.from_numpy(np.concatenate(rows) + off * n).to(dev)
        self.cols = torch.from_numpy(np.concatenate(cols) + off * m).to(dev)
        self.costs = torch.from_numpy(np.concatenate(
            [np.asarray(c, np.float32) for c in costs]).astype(
                np.float64)).to(dev)
        self.key = self.rows * (self.B * m) + self.cols
        if self.key.numel() > 1 and not bool(
                (self.key[1:] > self.key[:-1]).all()):
            raise ValueError("COO must be sorted by (row, column), unique")
        self.eps = torch.tensor(
            [eps_min(float(np.max(c)), m) for c in costs],
            dtype=torch.float64, device=dev)
        self.eps_request = eps_min(max(float(np.max(c)) for c in costs), m)


def _matched(inst: Instance, sigma: torch.Tensor):
    """(index of each row's assigned entry, whether it is one) and the
    count of bad rows."""
    N, M = inst.B * inst.n, inst.B * inst.m
    r = torch.arange(N, device=inst.rows.device)
    col = sigma + torch.repeat_interleave(
        torch.arange(inst.B, device=sigma.device) * inst.m, inst.n)
    q = r * M + col
    idx = torch.searchsorted(inst.key, q).clamp_(max=inst.key.numel() - 1)
    hit = (inst.key[idx] == q) & (sigma >= 0)
    counts = torch.bincount(col[hit], minlength=M)
    dup = (counts - 1).clamp_(min=0).view(inst.B, inst.m).sum(1)
    bad = (~hit).view(inst.B, inst.n).sum(1) + dup
    return idx, hit, col, bad


def bf_duals(inst: Instance, col: torch.Tensor, own: torch.Tensor,
             max_iters: int) -> torch.Tensor:
    """Duals ``v`` with ``v_k <= v_sigma(i) + c_ik - c_i,sigma(i) + eps`` on
    every entry (i, k), by Bellman-Ford from 0 (at most ``max_iters``
    sweeps): the largest such ``v`` exists exactly when the assignment
    is eps-optimal, and then every row's slack under it is at most
    eps."""
    src = col[inst.rows]
    eps = torch.repeat_interleave(inst.eps, torch.tensor(
        inst.nnz, device=inst.eps.device))
    w = inst.costs - own[inst.rows] + eps
    v = torch.zeros(inst.B * inst.m, dtype=torch.float64,
                    device=inst.costs.device)
    for _ in range(max_iters):
        nv = v.scatter_reduce(0, inst.cols, v[src] + w, reduce="amin",
                              include_self=True)
        if torch.equal(nv, v):
            break
        v = nv
    return v


def judge(inst: Instance, sigma, reported_obj, prices=None,
          bf_iters: int = 2000, final_eps=None) -> dict:
    """Judge one answer (``sigma`` [B, n] or [n]; ``reported_obj`` one
    objective per instance, None where the program reported none;
    ``prices`` [B, m] or [m], the program's, or None; ``final_eps`` the
    final eps reported per instance, None where it reported none).
    Returns per instance lists of the numbers in the module note."""
    dev = inst.rows.device
    sig = torch.as_tensor(np.asarray(sigma, np.int64).reshape(-1),
                          device=dev)
    idx, hit, col, bad = _matched(inst, sig)
    B, n, m = inst.B, inst.n, inst.m
    own = torch.where(hit, inst.costs[idx],
                      torch.zeros((), dtype=torch.float64, device=dev))
    primal = own.view(B, n).sum(1)
    if prices is None:
        v = bf_duals(inst, col.where(hit, torch.zeros_like(col)), own,
                     bf_iters)
    else:
        v = -torch.as_tensor(np.asarray(prices, np.float64).reshape(-1),
                             device=dev)
    best = torch.full((B * n,), math.inf, dtype=torch.float64, device=dev)
    best = best.scatter_reduce(0, inst.rows, inst.costs - v[inst.cols],
                               reduce="amin", include_self=True)
    slack = (own - v[col.where(hit, torch.zeros_like(col))] - best)
    slack = slack.where(hit, torch.zeros_like(slack)).view(B, n)
    eps = inst.eps
    gap = slack.sum(1) / (n * eps)
    out = {
        "bad_rows": [int(x) for x in bad.tolist()],
        "objective": [float(x) for x in primal.tolist()],
        "gap": [float(x) for x in gap.tolist()],
    }
    if prices is not None:
        out["slack_max"] = [float(x) for x in
                            (slack.max(1).values / eps).tolist()]
    rep = np.asarray(reported_obj, dtype=object).reshape(-1)
    out["obj_rel_err"] = [
        math.inf if r is None else abs(float(r) - p) / max(abs(p), 1e-300)
        for r, p in zip(rep, out["objective"])]
    if final_eps is not None:
        out["final_eps"] = [math.inf if f is None
                            else float(f) / inst.eps_request
                            for f in final_eps]
    return out


def worst(numbers: dict, keys=("bad_rows", "obj_rel_err", "gap",
                               "slack_max", "final_eps")) -> dict:
    """The largest reading of each number over every judged instance; a
    NaN anywhere is the largest."""
    return {k: max(numbers[k], key=lambda x: (math.isnan(x), x))
            for k in keys if numbers.get(k)}

