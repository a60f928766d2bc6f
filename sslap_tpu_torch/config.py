"""Frozen solver configuration: the same fields, defaults and validation as
``sslap_tpu.config.AuctionConfig``, so one config object describes a solve
in either package.

    cfg = AuctionConfig(problem="max", mode="cpu")
    res = auction_solve(mat, config=cfg)

Explicit kwargs always override the config's values.  Modes and engines
that the port does not carry yet are accepted here (the config is a plain
bundle) and refused by ``AuctionSolver`` with NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

MODES = ("auto", "device", "hybrid", "cpu", "sharded", "overlapped",
         "sharded_hybrid")
ENGINES = ("auto", "compact", "candidates", "dense")
GS_ENGINES = ("auto", "forward", "fr")


@dataclasses.dataclass(frozen=True)
class AuctionConfig:
    """Bundle of auction_solve/AuctionSolver keyword defaults.

    Determinism contract carried by every path: a row picks the highest
    value then the lowest column index; a column picks the highest bid then
    the lowest row id.
    """

    problem: str = "min"                 # 'min' | 'max'
    eps_start: Optional[float] = None    # default: ~(cost range)/2 (scaled)
    eps_min: Optional[float] = None      # default: 1 (int) | 1/(m+1) (float)
    theta: Optional[float] = None        # geometric eps divisor; None =
                                         # per-mode default (device 10 at
                                         # n >= 200k, else 5)
    theta_tail: Optional[float] = None   # mixed tail: final-phase drop
                                         # ratio; None = per-mode default,
                                         # 0 = pure theta
    tail_phases: int = 2                 # phases descending by theta_tail
    max_iter: Optional[int] = None       # round cap (safety valve)
    cardinality_check: bool = True       # Hopcroft-Karp pre-check
    mode: str = "auto"                   # see MODES
    keep_assignment: bool = True         # warm-started eps phases
    dtype: Optional[object] = None       # force solver dtype
    wide_rounds: Optional[bool] = None   # full-width rounds while > 0.4n
                                         # rows are active (None = auto:
                                         # on at n >= 400k)
    fine_ladder: Optional[bool] = None   # {2^k, 3*2^(k-1)} tiers below
                                         # 32768 (None = on)
    engine: str = "auto"                 # square device engine
    gs_engine: str = "auto"              # host finisher: 'auto' (= 'fr'
                                         # on the square hybrid tail,
                                         # else 'forward'), 'forward', 'fr'

    def __post_init__(self):
        if self.problem not in ("min", "max"):
            raise ValueError(
                f"problem must be 'min' or 'max', got {self.problem!r}")
        if self.theta is not None and self.theta <= 1:
            raise ValueError("theta must be > 1")
        if self.theta_tail is not None and \
                not (self.theta_tail == 0 or self.theta_tail > 1):
            raise ValueError("theta_tail must be 0 (off) or > 1")
        if self.tail_phases < 1:
            raise ValueError("tail_phases must be >= 1")
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.gs_engine not in GS_ENGINES:
            raise ValueError(f"unknown gs_engine {self.gs_engine!r}")

    def solver_kwargs(self) -> dict:
        """The kwargs this config supplies to AuctionSolver."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}
