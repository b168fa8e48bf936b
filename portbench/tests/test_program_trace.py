"""The program's own recorder (`BatchDecoder.trace`, an
`aacjax_torch.runtime.stats.Trace`) against the benchmark's instruments
over one traced window of the HE cell on the CPU at a test's size: its SBR
cache counters against the counting stand-in for the cache (routes/he.py
`CountingCache`), its `he_host` spans against the benchmark's."""
import time

from portbench import run
from portbench.trace import Tracer

SEED = 2 ** 31 + 17
TRAFFIC = {"streams": 4, "chunk_frames": 4, "check": {"slots": 1}}


def test_the_programs_recorder_agrees_with_the_benchmarks(monkeypatch):
    from aacjax_torch.runtime.stats import Trace
    reads, tracers = [], []
    read = Tracer._read_counters

    def stamped(self, at):      # the stand-in is read as the window opens
        reads.append(time.perf_counter_ns())      # and as it closes
        tracers.append(self)
        read(self, at)
    monkeypatch.setattr(Tracer, "_read_counters", stamped)
    decoders, logged = [], []

    def traced(dec, serve):
        dec.trace = Trace()
        decoders.append(dec)
        return serve
    run.run_cell("hev1-64k.bulk", SEED, 1.5, True, device="cpu",
                 tamper=traced, traffic=TRAFFIC, workers=1,
                 t_start=time.perf_counter(), log=logged.append)
    line = next(m for m in logged if "counted over the window" in m)
    stand_in = dict(part.rsplit(" ", 1)
                    for part in line.split(": ", 2)[-1].split(", "))
    assert len(reads) == 2
    tr = decoders[0].trace
    inside = {s.chunk for s in tr.spans if s.name == "he.sbr"
              and reads[0] < s.t1_ns < reads[1]}
    assert inside
    for n in ("lookups", "hits", "inserts"):
        program = sum(tr.counters[(f"sbr_cache_{n}", k)] for k in inside)
        assert program == int(stand_in[f"sbr_cache_{n}"]), n
    assert int(stand_in["sbr_cache_lookups"]) == sum(
        tr.counters[("sbr_payloads", k)] for k in inside) > 0
    # each host phase: the benchmark's span around the call, the program's
    # inside it, the same length within 1%
    bench = [(t0, t1) for n, t0, t1 in tracers[0].spans if n == "he_host"]
    prog = [s for s in tr.spans if s.name == "he_host"]
    assert len(bench) == len(prog) > 2
    for (t0, t1), s in zip(bench, prog):
        assert t0 * 1e9 <= s.t0_ns <= s.t1_ns <= t1 * 1e9 + 1e3
        assert (s.t1_ns - s.t0_ns) / ((t1 - t0) * 1e9) > 0.99
