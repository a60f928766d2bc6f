"""The eps-phase ladder op (sslap_tpu_torch.ops.ladder) on the CPU: its
plain version, one phase at a time, against the JAX package's tiered solve
(sslap_tpu.compact.solve_ell_tiered) advanced one phase at a time, and a
Python mirror of the kernel's round accounting (csrc/ladder.cu:
next_slot) against the reference's tier_rounds.

The cases are test_torch_compact.py's (its helpers build them): there the
port's whole solve is held against the reference's; here each phase of the
op starts from the reference's own state after the phase before (so every
phase is a resume), and must end in the reference's state after it.

Tolerance: exact.  sigma, owner, rounds and tier_rounds equal; prices bit
for bit.
"""

import jax
import numpy as np
import pytest
import torch

from sslap_tpu import compact as RC
from sslap_tpu_torch import auction as PA
from sslap_tpu_torch.ops import ladder as L
from sslap_tpu_torch.ops import ladder_phase
from tests.test_torch_compact import _bits, _case, _ref, _t

# name -> (_case arguments, solve arguments); the mixed eps tail engages
# at theta = 10, the wide loop on the contended instance
CASES = {
    "trunc0": (dict(seed=0, n=600, theta=5.0), dict(trunc=0)),
    "trunc16_mixed_tail": (dict(seed=0, n=600, theta=10.0), dict(trunc=16)),
    "fine_ladder_floor": (dict(seed=1, n=700, theta=5.0),
                          dict(trunc=16, fine=True)),
    "wide": (dict(seed=2, n=800, theta=5.0, contended=True),
             dict(trunc=16, wide=True)),
    "round_cap": (dict(seed=3, n=600, theta=10.0),
                  dict(trunc=16, max_iter=50)),
}


def _setup(name, integer):
    case_kw, kw = CASES[name]
    c = _case(integer=integer, **case_kw)
    n = c["n"]
    if "max_iter" in kw:
        c["max_iter"] = kw["max_iter"]
    tiers = (RC.default_tiers(n, fine=True, floor=kw["trunc"])
             if kw.get("fine") else RC.default_tiers(n))
    return c, tiers, kw["trunc"], kw.get("wide", False)


def _reference_phases(c, tiers, trunc, wide):
    """The reference's TieredState after each phase (host copies)."""
    states = [jax.device_get(_ref(c, trunc=trunc, tiers=tiers, wide=wide,
                                  max_phases=0)[1])]
    while not (states[-1].eps <= c["e_min"]
               or states[-1].rounds >= c["max_iter"]):
        st = _ref(c, trunc=trunc, tiers=tiers, wide=wide, max_phases=1,
                  init_state=states[-1])[1]
        states.append(jax.device_get(st))
    return states


def _port_inputs(c):
    vals_t, valid = _t(c["vals_t"]), _t(c["valid"])
    return (_t(c["cols"]), PA.mask_vals(vals_t, valid), _t(c["nvalid"]),
            PA.value_bigp(vals_t, valid))


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("integer", [True, False])
def test_plain_op_matches_reference_phase_by_phase(integer, name):
    c, tiers, trunc, wide = _setup(name, integer)
    n = c["n"]
    cols, vals_m, nvalid, bigp = _port_inputs(c)
    states = _reference_phases(c, tiers, trunc, wide)
    assert len(states) >= 3
    dt = c["vals"].dtype
    for k, after in enumerate(states):
        if k == 0:
            prices = torch.zeros(n, dtype=vals_m.dtype)
            owner = torch.full((n,), -1, dtype=torch.int32)
            sigma = torch.full((n,), -1, dtype=torch.int32)
            rounds, hist0 = 0, [0] * (len(tiers) + 1)
        else:
            before = states[k - 1]
            prices, owner, sigma = (_t(before.prices), _t(before.owner),
                                    _t(before.sigma))
            rounds = int(before.rounds)
            hist0 = np.asarray(before.tier_rounds).tolist()
        rounds, active, hist = ladder_phase(
            cols, vals_m, nvalid, prices, owner, sigma,
            np.asarray(after.eps, dt)[()], bigp, first=k == 0, wide=wide,
            tiers=tiers, threshold=trunc, max_iter=c["max_iter"],
            rounds=rounds)
        np.testing.assert_array_equal(sigma.numpy(), np.asarray(after.sigma))
        np.testing.assert_array_equal(owner.numpy(), np.asarray(after.owner))
        np.testing.assert_array_equal(_bits(prices.numpy()),
                                      _bits(after.prices))
        assert rounds == int(after.rounds)
        assert [a + b for a, b in zip(hist0, hist)] == \
            np.asarray(after.tier_rounds).tolist()
        assert active == int(((sigma < 0) & (nvalid > 0)).sum())
    if name == "round_cap":
        assert int(states[-1].rounds) == c["max_iter"]
        assert states[-1].eps > c["e_min"]
    if name == "wide":
        assert int(states[-1].tier_rounds[0]) > len(states)


def next_slot(active, rounds, max_iter, in_wide, wide_floor, threshold,
              tiers):
    """Python mirror of csrc/ladder.cu's next_slot: the histogram slot of
    the next round at ``active`` live rows, or -1 when the phase ends; and
    whether the wide loop still runs."""
    if rounds >= max_iter:
        return -1, in_wide
    if in_wide:
        if active > wide_floor:
            return 0, True
        in_wide = False
    if active <= threshold:
        return -1, in_wide
    ti = 0
    while ti + 1 < len(tiers) and active <= max(tiers[ti + 1], threshold):
        ti += 1
    return 1 + ti, in_wide


@pytest.mark.parametrize("name", ["fine_ladder_floor", "wide", "round_cap"])
def test_tier_mirror_rebuilds_reference_tier_rounds(monkeypatch, name):
    """The kernel counts a round under the tier its active count a falls
    in, min{ti : a > max(tiers[ti + 1] or 0, threshold)}, instead of
    looping tier by tier.  Record the active count before every round of
    the plain op, replay it through the mirror, and get the reference's
    histogram (and the end of every phase) back."""
    c, tiers, trunc, wide = _setup(name, False)
    n = c["n"]
    cols, vals_m, nvalid, bigp = _port_inputs(c)
    states = _reference_phases(c, tiers, trunc, wide)
    actives = []
    plain_round = L._round

    def recording(*args, **kw):
        actives.append(int((args[6] < n).sum()))
        return plain_round(*args, **kw)

    monkeypatch.setattr(L, "_round", recording)
    prices = torch.zeros(n, dtype=vals_m.dtype)
    owner = torch.full((n,), -1, dtype=torch.int32)
    sigma = torch.full((n,), -1, dtype=torch.int32)
    rounds, hist = 0, [0] * (len(tiers) + 1)
    for k, after in enumerate(states):
        actives.clear()
        start = rounds
        rounds, active, _ = ladder_phase(
            cols, vals_m, nvalid, prices, owner, sigma,
            np.asarray(after.eps, c["vals"].dtype)[()], bigp, first=k == 0,
            wide=wide, tiers=tiers, threshold=trunc,
            max_iter=c["max_iter"], rounds=rounds)
        assert len(actives) == rounds - start
        hist[0] += 1                               # the phase start
        in_wide = wide
        for i, a in enumerate(actives[1:] + [active]):
            slot, in_wide = next_slot(a, start + 1 + i, c["max_iter"],
                                      in_wide, (2 * n) // 5, trunc, tiers)
            if i == len(actives) - 1:
                assert slot == -1                  # the phase ends here
            else:
                assert slot >= 0
                hist[slot] += 1
        assert hist == np.asarray(after.tier_rounds).tolist()


def _args(n=64, m=64, K=4, dtype=torch.float32):
    cols = torch.zeros((n, K), dtype=torch.int32)
    return [cols, torch.zeros((n, K), dtype=dtype),
            torch.full((n,), K, dtype=torch.int32),
            torch.zeros(m, dtype=dtype),
            torch.full((m,), -1, dtype=torch.int32),
            torch.full((n,), -1, dtype=torch.int32)]


@pytest.mark.parametrize("bad, exc", [
    ("float64", TypeError), ("int64_cols", ValueError),
    ("noncontiguous", ValueError), ("mixed_device", ValueError),
    ("meta_device", RuntimeError), ("short_sigma", ValueError),
    ("tiers", ValueError),
])
def test_ladder_phase_rejects_bad_arguments(bad, exc):
    args = _args()
    tiers = (64, 32)
    if bad == "float64":
        args[1] = args[1].double()
        args[3] = args[3].double()
    elif bad == "int64_cols":
        args[0] = args[0].long()
    elif bad == "noncontiguous":
        args[1] = torch.zeros((4, 64)).t()
    elif bad == "mixed_device":
        args[3] = args[3].to("meta")
    elif bad == "meta_device":
        args = [a.to("meta") for a in args]
    elif bad == "short_sigma":
        args[5] = args[5][:10]
    elif bad == "tiers":
        tiers = (32, 64)
    with pytest.raises(exc):
        ladder_phase(*args, 1.0, 2.0, first=True, wide=False, tiers=tiers,
                     threshold=0, max_iter=10, rounds=0)


def test_plain_op_runs_through_its_arguments():
    """A valid call on the CPU runs the plain version and counts no
    launch."""
    before = ladder_phase.launches
    args = _args()
    args[0] = torch.arange(64 * 4, dtype=torch.int32).reshape(64, 4) % 64
    args[1] = -torch.arange(64 * 4, dtype=torch.float32).reshape(64, 4)
    rounds, active, hist = ladder_phase(
        *args, np.float32(0.5), np.float32(300.0), first=True, wide=False,
        tiers=(64, 32), threshold=0, max_iter=10_000, rounds=0)
    assert ladder_phase.launches == before
    assert active == 0 and rounds == sum(hist) and hist[0] == 1
    assert sorted(args[5].tolist()) == list(range(64))
