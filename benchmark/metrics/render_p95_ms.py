"""The 95th percentile over every call of the window of its host time from
the call to the mix in host memory."""

import numpy as np

from benchmark.lib import window


def read(rec):
    if rec['kind'] != 'render':
        return None
    return float(np.percentile(window.call_ms(rec), 95))
