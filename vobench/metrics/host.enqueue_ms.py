"""Host time inside the program's entry call (``VisualOdometry.process_async``
or ``MultiStreamVO.step``), per frame or step of the traced window."""


def read(run):
    t = run.trace
    if t is None or not t.spans.get("entry"):
        return None
    return 1e3 * sum(s.host_s for s in t.spans["entry"]) / len(t.spans["entry"])
