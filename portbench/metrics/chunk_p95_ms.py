"""The 95th percentile of the latencies of all the window's chunks, from
hand-over to the PCM's yield (portbench.window)."""


def read(run):
    return run.window.p95_ms()
