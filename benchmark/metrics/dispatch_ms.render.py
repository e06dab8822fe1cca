"""Host time a render call takes to enqueue its work: from the call into
``PolyPatch.render`` until it returns, before the copy that waits for the
device; the mean over the window's calls (the benchmark's own spans)."""

import numpy as np


def read(rec):
    if rec['kind'] != 'render':
        return None
    calls = rec['window']['calls']
    return float(np.mean([(c[1] - c[0]) * 1e3 for c in calls]))
