"""Stream-frames whose pose record reached the host inside the window, per
second of the window."""


def read(run):
    return run.window.frames_read / run.window.length_s if run.window.length_s > 0 else None
