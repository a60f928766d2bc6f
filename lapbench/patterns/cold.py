"""``cold``: a pool of ``pool`` items made from the seed in set-up;
request k solves item ``k mod pool`` from nothing, ingest included."""


class Pattern:
    def __init__(self, driver, seed: int):
        self.driver = driver
        self.pool = [driver.make(seed, k)
                     for k in range(int(driver.traffic["pool"]))]

    def request(self, k: int, spans) -> dict:
        return self.driver.call(k, k % len(self.pool), spans)
