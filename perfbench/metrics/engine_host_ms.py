"""Host milliseconds a call of ``AggregationEngine.step`` takes (the
harness's span around each call in the traced window; the call returns
once its work is queued on the card)."""


def read(run):
    t = run.spans.get("engine.step")
    return sum(t) / len(t) * 1e3 if t else None
