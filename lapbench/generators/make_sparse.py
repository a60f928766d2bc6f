"""``make_sparse``: ``instances`` instances a pool item, each
``nnz_per_row - 1`` random columns a row plus a planted matching, costs
in [1, ``high``), integers or float32 as ``integer`` says
(``gen.make_sparse``)."""

from lapbench import gen


def make(config: dict, seed: int, k: int) -> dict:
    locs, vals = [], []
    for b in range(int(config.get("instances", 1))):
        loc, vv = gen.make_sparse(
            int(config["n"]), int(config["m"]), int(config["nnz_per_row"]),
            gen.seed_int(seed, 0, k, b), int(config.get("high", 1000)),
            bool(config.get("integer", False)))
        locs.append(loc)
        vals.append(vv)
    return {"loc": locs, "vals": vals}
