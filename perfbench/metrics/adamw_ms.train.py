"""Milliseconds a step spends in FlatAdamW and the bf16 rebuild
(``step_fn``'s "optimizer" and "rebuild" parts, by CUDA events)."""


def read(run):
    a, b = run.parts.get("optimizer"), run.parts.get("rebuild")
    return (sum(a) + sum(b)) / len(a) if a and b else None
