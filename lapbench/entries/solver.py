"""``solver``: ``AuctionSolver`` built from the item's COO arrays (the
ingest), then ``solve()``.  Keyword arguments: the configuration's
``solver``, updated by the pattern's; ``solve()``'s from the pattern.  A
``sharded_hybrid`` solve on the cards must use one shard a card."""

import numpy as np

from sslap_tpu_torch import AuctionSolver

from lapbench.drivers import scalars


def call(driver, item: dict, k: int, spans, solver=None, solve=None
         ) -> dict:
    skw = dict(driver.config.get("solver", {}), **(solver or {}))
    with spans("ingest", k):
        s = AuctionSolver(loc=item["loc"][0], val=driver.fed(item["vals"][0]),
                          shape=(driver.n, driver.m), device=driver.device,
                          **skw)
    with spans("solve", k):
        res = s.solve(**(solve or {}))
    meta = scalars(res["meta"])
    if skw.get("mode") == "sharded_hybrid" and driver.device != "cpu" \
            and meta.get("n_shards") != driver.chips:
        raise RuntimeError(f"{meta.get('n_shards')} shards on "
                           f"{driver.chips} cards")
    return {"sigma": np.array(res["sol"]),
            "prices": np.array(res["prices"], copy=True),
            "obj": [meta.get("obj")], "found": [bool(meta.get("soln_found"))],
            "meta": [meta]}
