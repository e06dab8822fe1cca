"""Process start to the first timed call: imports, the patch built from
the seed, the kernels loaded (built in a checkout's first run), the warm-up
call."""


def read(rec):
    return rec['setup_s']
