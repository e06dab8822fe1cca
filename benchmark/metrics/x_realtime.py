"""Audio seconds delivered to host memory over the window's wall seconds:
every call of the window, first start to last end."""


def read(rec):
    if rec['kind'] != 'render':
        return None
    calls = rec['window']['calls']
    return sum(c[3] for c in calls) / rec['window']['seconds']
