"""``batch``: ``from_coo`` on each instance of the item with the
configuration's ``pad_to``, ``stack_problems`` (the ingest), then
``auction_solve_batched`` with the configuration's ``batch`` keyword
arguments.  The entry returns no prices, so it takes no warm start."""

import numpy as np

from sslap_tpu_torch.batch import auction_solve_batched, stack_problems
from sslap_tpu_torch.ingest import from_coo

from lapbench.drivers import scalars


def call(driver, item: dict, k: int, spans, solver=None, solve=None
         ) -> dict:
    if solver or solve:
        raise ValueError("the batch entry takes no solver or solve "
                         "arguments")
    with spans("ingest", k):
        probs = [from_coo(loc, driver.fed(v), shape=(driver.n, driver.m),
                          pad_to=driver.config.get("pad_to"))
                 for loc, v in zip(item["loc"], item["vals"])]
        stacked = stack_problems(probs)
    with spans("solve", k):
        sols, metas = auction_solve_batched(
            stacked, device=driver.device, **driver.config.get("batch", {}))
    metas = [scalars(mt) for mt in metas]
    return {"sigma": np.array(sols), "prices": None,
            "obj": [mt.get("obj") for mt in metas],
            "found": [bool(mt.get("soln_found")) for mt in metas],
            "meta": metas}
