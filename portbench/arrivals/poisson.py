"""Open loop at `rate` requests/s, as independent users send them: every
seed gets the same multiset of gaps (the exponential distribution's
quantiles, scaled to fill the window) in its own order, and each request
is timed from when it was due."""

import time

import numpy as np


def gaps(rate: float, seconds: float, seed: int) -> np.ndarray:
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    g = -np.log1p(-q) / rate
    g *= seconds / g.sum()
    return np.random.default_rng([seed, 4]).permutation(g)


def send_all(w) -> int:
    g = gaps(w.traffic["rate"], w.seconds, w.seed)
    due = w.t0 + np.concatenate([[0.0], np.cumsum(g)[:-1]])
    for i, d in enumerate(due):
        wait = d - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        w.send(i, due=float(d))
    return len(due)
