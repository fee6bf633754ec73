"""Milliseconds a step spends in the learners' forward and backward
passes (``step_fn``'s "forward_backward" parts, by CUDA events)."""


def read(run):
    t = run.parts.get("forward_backward")
    return sum(t) / len(t) if t else None
