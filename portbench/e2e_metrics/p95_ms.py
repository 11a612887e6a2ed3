"""p95_ms: the 95th percentile of every request due in the window, each
timed from when it was due to its answer (host clock; open-loop cells,
whose arrival process says when each request was due). A request that
failed or never answered counts as infinitely late."""

import math

import numpy as np


def read(ctx):
    if not ctx.log.latencies_ms:
        return None
    lat = list(ctx.log.latencies_ms)
    lat += [math.inf] * (ctx.log.failed + ctx.log.unanswered)
    return float(np.percentile(lat, 95))
