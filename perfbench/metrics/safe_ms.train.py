"""Milliseconds a step spends in the SAFE round over the learners'
gradients (``step_fn``'s "aggregate" part, by CUDA events)."""


def read(run):
    t = run.parts.get("aggregate")
    return sum(t) / len(t) if t else None
