"""The one traffic generator: it reads a mix from `traffic/<mix>.json` and
draws each request's inputs from the run's seed.

A mix's keys:

  entry       "solve": one client calls `Problem.solve` back to back (a
              closed loop); "multistart": one client calls the batched
              lane solve with `lanes` guesses back to back.
  lanes       guesses per multistart call.
  guess       {"from": "seed", "scale": s, "levels": m}: a fresh guess per
              solve or lane, s·k·randn(n) with k = i mod m for the i-th
              solve of a run (the j-th lane of a call); {"from": "built"}:
              every solve starts from the guess the configuration's own
              build sets (its source's published guess), and the seed
              draws nothing.

Every draw comes from one stream of the seed, so the same seed gives the
same requests in the same order; set-up's warm-up draws from a stream of
its own.
"""

from __future__ import annotations

import dataclasses

import numpy as np

WINDOW, WARM_UP = 0, 1


@dataclasses.dataclass
class Request:
    """One request: its guesses, one per lane."""

    guesses: list


class Traffic:
    """The requests of one mix. `start` is the decision vector as the
    configuration's build left it: its size sets the guesses' and it is
    the guess of a "built" mix."""

    def __init__(self, mix: dict, start: np.ndarray, seed: int, stream: int = WINDOW) -> None:
        if mix["entry"] not in ("solve", "multistart"):
            raise ValueError(f"unknown entry {mix['entry']!r}")
        if mix["guess"]["from"] not in ("seed", "built"):
            raise ValueError(f"unknown guess {mix['guess']['from']!r}")
        self.mix = mix
        self.start = np.array(start, dtype=np.float64)
        self.rng = np.random.default_rng([seed % 2**64, stream])
        self.count = 0

    @property
    def lanes(self) -> int:
        return int(self.mix.get("lanes", 1)) if self.mix["entry"] == "multistart" else 1

    def _guess(self, i: int) -> np.ndarray:
        g = self.mix["guess"]
        if g["from"] == "built":
            return self.start.copy()
        return float(g["scale"]) * (i % int(g["levels"])) * self.rng.standard_normal(len(self.start))

    def next(self) -> Request:
        if self.mix["entry"] == "solve":
            guesses = [self._guess(self.count)]
        else:
            guesses = [self._guess(j) for j in range(self.lanes)]
        self.count += 1
        return Request(guesses)
