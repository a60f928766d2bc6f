"""``make_instance``: one instance a pool item, ``k_extra`` random columns
a row plus a planted permutation, float32 costs in [``low``, ``high``)
(``gen.make_instance``)."""

import numpy as np

from lapbench import gen


def make(config: dict, seed: int, k: int) -> dict:
    rr, cc, vv = gen.make_instance(
        int(config["n"]), int(config["m"]), int(config["k_extra"]),
        gen.seed_int(seed, 0, k), float(config.get("low", 1.0)),
        float(config.get("high", 1000.0)))
    return {"loc": [np.stack([rr, cc], 1)], "vals": [vv]}
