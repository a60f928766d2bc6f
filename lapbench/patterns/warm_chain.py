"""``warm_chain``: one pattern of entries and ``pool`` value arrays from
``gen.drift_pool`` (consecutive arrays, the wrap included, differ by a
clipped Gaussian of ``sigma``).  A cold solve in set-up seeds the chain;
request k solves array ``k mod pool`` warm from request k-1's prices,
with the traffic's ``solver`` and ``solve`` keyword arguments."""

import numpy as np

from lapbench import gen
from lapbench.drivers import Spans


class Pattern:
    def __init__(self, driver, seed: int):
        t, c = driver.traffic, driver.config
        self.driver = driver
        pool = int(t["pool"])
        base = driver.make(seed, 0)
        if len(base["vals"]) != 1:
            raise ValueError("warm_chain chains one instance a request")
        vals = gen.drift_pool(base["vals"][0], gen.seed_rng(seed, 1), pool,
                              float(t["sigma"]), float(c.get("low", 1.0)),
                              float(c.get("high", 1000.0)))
        self.pool = [dict(base, vals=[v]) for v in vals]
        # the cold solve that seeds the chain, on the array two before the
        # first timed frame's (the warm-up frame takes the one between)
        self.prices = driver.call(-2, -2 % pool, Spans(),
                                  pool=self.pool)["prices"]

    def request(self, k: int, spans) -> dict:
        t = self.driver.traffic
        rec = self.driver.call(
            k, k % len(self.pool), spans, solver=t.get("solver"),
            solve=dict(t.get("solve", {}), warm_prices=self.prices))
        self.prices = np.array(rec["prices"], copy=True)
        return rec
