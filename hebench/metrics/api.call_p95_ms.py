"""The 95th percentile, over every call of the window's untraced part, of
the milliseconds from an op's call to the return of its XCompleted(), in a
cell that calls one op at a time (worksize 1)."""

import numpy as np


def read(r):
    c = r.win.call_s
    return 1e3 * float(np.percentile(c, 95)) if c else None
