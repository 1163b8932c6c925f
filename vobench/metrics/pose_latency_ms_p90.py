"""The 90th percentile, over the window's frames (one stream) or steps (a
batch of streams), of the time from handing the frame or batch to the
program to its pose record being readable on the host."""

import numpy as np


def read(run):
    lat = run.window.latencies_s
    return 1e3 * float(np.percentile(lat, 90)) if lat else None
