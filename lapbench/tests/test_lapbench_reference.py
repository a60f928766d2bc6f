"""The plain reference against scipy at small sizes."""

import numpy as np
import pytest
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import min_weight_full_bipartite_matching

from lapbench import gen, reference


def _inst(n, seed, k=6):
    loc, val = gen.make_sparse(n, n, k, seed=seed, integer=False)
    return loc, val


def _scipy(loc, val, n):
    a = csr_matrix((val.astype(np.float64), (loc[:, 0], loc[:, 1])),
                   shape=(n, n))
    r, c = min_weight_full_bipartite_matching(a)
    sigma = np.empty(n, np.int64)
    sigma[r] = c
    return sigma, float(np.asarray(a[r, c]).sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_optimum_has_no_gap_beyond_eps_and_its_objective(seed):
    n = 300
    loc, val = _inst(n, seed)
    sigma, opt = _scipy(loc, val, n)
    inst = reference.Instance([loc[:, 0]], [loc[:, 1]], [val], n, n)
    got = reference.judge(inst, sigma, [opt])
    assert got["bad_rows"] == [0]
    assert got["objective"][0] == pytest.approx(opt, rel=1e-12)
    assert got["obj_rel_err"][0] < 1e-12
    # Bellman-Ford duals with every edge lengthened by eps: slack <= eps
    assert 0.0 <= got["gap"][0] <= 1.0


def test_dual_bound_never_passes_the_optimum():
    n = 200
    loc, val = _inst(n, 5)
    sigma, opt = _scipy(loc, val, n)
    inst = reference.Instance([loc[:, 0]], [loc[:, 1]], [val], n, n)
    rng = np.random.default_rng(0)
    for _ in range(3):
        prices = rng.normal(0, 50, n)          # any duals at all
        got = reference.judge(inst, sigma, [opt], prices=prices)
        eps = inst.eps.item()
        dual = opt - got["gap"][0] * n * eps
        assert dual <= opt + 1e-6


def test_a_worse_assignment_shows_a_gap():
    """Rows pick their cheapest column greedily in order: a perfect
    matching on the input, but not an optimal one."""
    n = 300
    loc, val = _inst(n, 3)
    _, opt = _scipy(loc, val, n)
    order = np.lexsort((val, loc[:, 0]))
    taken = np.zeros(n, bool)
    sigma = np.full(n, -1, np.int64)
    for i in order:
        r, c = loc[i]
        if sigma[r] < 0 and not taken[c]:
            sigma[r], taken[c] = c, True
    inst = reference.Instance([loc[:, 0]], [loc[:, 1]], [val], n, n)
    if (sigma < 0).any():                 # greedy may strand rows
        assert reference.judge(inst, sigma, [opt])["bad_rows"][0] > 0
        return
    got = reference.judge(inst, sigma, [None])
    assert got["gap"][0] > 3.0
    assert got["obj_rel_err"][0] == float("inf")


def test_bad_rows_counts_missing_entries_and_shared_columns():
    n = 100
    loc, val = _inst(n, 9)
    sigma, opt = _scipy(loc, val, n)
    inst = reference.Instance([loc[:, 0]], [loc[:, 1]], [val], n, n)
    s = sigma.copy()
    s[0] = s[1]                           # a column taken twice
    assert reference.judge(inst, s, [opt])["bad_rows"][0] >= 1
    s = sigma.copy()
    s[2] = -1                             # a row left unassigned
    assert reference.judge(inst, s, [opt])["bad_rows"][0] >= 1


def test_batched_instances_are_judged_apart():
    n, B = 120, 3
    insts = [_inst(n, 20 + b) for b in range(B)]
    sols = [_scipy(loc, val, n) for loc, val in insts]
    inst = reference.Instance([loc[:, 0] for loc, _ in insts],
                              [loc[:, 1] for loc, _ in insts],
                              [val for _, val in insts], n, n)
    sigma = np.stack([s for s, _ in sols])
    got = reference.judge(inst, sigma, [o for _, o in sols])
    assert got["bad_rows"] == [0] * B
    for b in range(B):
        assert got["objective"][b] == pytest.approx(sols[b][1], rel=1e-12)
    sigma[1, :2] = sigma[1, 1::-1]       # swap two columns of instance 1
    got = reference.judge(inst, sigma, [o for _, o in sols])
    assert got["bad_rows"][0] == 0 and got["bad_rows"][2] == 0


def test_eps_min_is_the_float_default():
    assert reference.eps_min(999.9, 1_000_000) == pytest.approx(999.9e-6)
    assert reference.eps_min(1.0, 99) == pytest.approx(0.01)


def test_worst_takes_a_nan_as_the_largest():
    got = reference.worst({"gap": [0.5, float("nan"), 0.7], "bad_rows": [0]})
    assert got["bad_rows"] == 0
    assert got["gap"] != got["gap"]
