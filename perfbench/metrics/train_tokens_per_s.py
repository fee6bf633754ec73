"""Training tokens of all learners over the whole measured window."""


def read(run):
    return run.tokens / run.window_s if run.tokens and run.window_s > 0 else None
