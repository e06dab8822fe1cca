"""The tiny sizes of the ``stems-64v-fit`` cell, entered in
``test_bench_harness.TINY`` (every cell's sizes for the CPU runs, which
``test_every_cell_has_its_files`` holds to ``BENCHMARK.json``'s cells and
``test_bench_spans`` parametrises over) from ``test_bench_stems.TINY``."""

from benchmark.tests import test_bench_harness, test_bench_stems

test_bench_harness.TINY.update(test_bench_stems.TINY)
