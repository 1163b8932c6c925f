"""Shared arithmetic of the stage readers: the mean stage time of a span
per traced step (or per call)."""


def per_step_ms(run, span):
    t = run.trace
    if t is None or not t.steps or span not in t.spans:
        return None
    return 1e3 * sum(s.stage_s for s in t.spans[span]) / t.steps


def per_call_ms(run, span):
    t = run.trace
    if t is None or not t.spans.get(span):
        return None
    return 1e3 * sum(s.stage_s for s in t.spans[span]) / len(t.spans[span])
