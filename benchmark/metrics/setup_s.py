"""setup_s: process start to the first timed call (imports, the kernel
library, the data drawn from the seed, the ingest, the warm-up)."""


def read(run):
    return run.setup_s
