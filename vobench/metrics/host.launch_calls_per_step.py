"""CUDA runtime calls that launch device work (a graph launch counts one) in
the traced window, per frame or step."""


def read(run):
    t = run.trace
    if t is None or not t.steps or not t.launch_calls:
        return None
    return t.launch_calls / t.steps
