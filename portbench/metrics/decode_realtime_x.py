"""Audio seconds of the window's chunks over the time from its opening to
the last of them (portbench.window)."""


def read(run):
    return run.window.realtime_x()
