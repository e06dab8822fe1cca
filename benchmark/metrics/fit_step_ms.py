"""The window's wall milliseconds over the optimizer steps it completed."""


def read(rec):
    if rec['kind'] != 'fit':
        return None
    steps = sum(c[4] for c in rec['window']['calls'])
    return rec['window']['seconds'] * 1e3 / steps
