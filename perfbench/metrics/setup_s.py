"""Process start (the harness's first line) to the first timed call: the
imports, the inputs, the kernels' build or load and the warm-up."""


def read(run):
    return run.setup_s
