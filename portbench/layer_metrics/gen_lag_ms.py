"""gen_lag_ms: the 95th percentile of how late the open-loop generator
sent each request after it was due (host clock)."""

import numpy as np


def read(ctx):
    lags = ctx.log.lags_ms
    return float(np.percentile(lags, 95)) if lags else None
