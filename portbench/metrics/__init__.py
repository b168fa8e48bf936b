"""One module per metric, found by the metric's name in BENCHMARK.json
(`<name>.py`).  Each gives `read(run) -> float | None`: the metric's value
from the run's window, spans or trace (portbench.run.Run), or None where
the run holds nothing for it to read, and the harness then leaves the
metric out of the result line."""
