"""The four-card AAC-LC cell, `lc256k.mesh4`, on the CPU at a size a test
run holds: its route (routes/lc_mesh.py) serves through
`decode_pipelined(..., mesh=)` over four CPU shards; a sound run is
correct, each planted fault and the control (the reference in TF32 in the
program's place) are not; the fan-out reader reads None where the run
holds no mesh spans and a number where it does."""
import time
from types import SimpleNamespace

import pytest

from portbench import registry, run
from portbench.metrics import mesh_fanout_ms
from portbench.tests.faults import FAULTS
from portbench.trace import Tracer

CELL = "lc256k.mesh4"
# eight streams, two a shard; a window long enough that every slot is
# checked (the CPU's plain TNS takes ~0.2 s a shard a chunk; `pairs` above
# the window's chunks: each chunk keeps one slot in turn)
TRAFFIC = {"streams": 8, "chunk_frames": 4, "check": {"pairs": 64}}
SECONDS = 10.0
SEED = 2 ** 31 + 2020


def _run(trace=False, tamper=None, **kw):
    return run.run_cell(CELL, SEED, SECONDS, trace, device="cpu",
                        traffic=TRAFFIC, workers=2, tamper=tamper,
                        t_start=time.perf_counter(), log=lambda msg: None,
                        **kw)


def test_the_cell_is_the_four_card_configuration():
    c = registry.cell(registry.benchmark(), CELL)
    assert c.chips == 4 and c.config["route"] == "lc_mesh"
    assert c.config["mesh"] == {"stream": 4, "frame": 1}
    assert c.traffic["streams"] == 4 * c.config["streams_per_card"] == 2048
    assert {m["name"] for m in c.end_to_end} == {"decode_realtime_x",
                                                "setup_s"}
    assert {m["name"] for m in c.per_layer} == {
        "parse_ms", "mesh_fanout_ms", "device_idle_pct"}


def test_a_sound_run_on_four_cpu_shards_is_correct():
    meshes = []

    def spy(dec, serve):            # the serving entry's mesh, as given
        entry = dec.decode_pipelined

        def pipelined(chunks, **kw):
            meshes.append(kw.get("mesh"))
            return entry(chunks, **kw)
        dec.decode_pipelined = pipelined
        return serve
    result, readings = _run(tamper=spy)
    assert result["correct"] is True, readings
    assert readings["compared_slots"] == TRAFFIC["streams"]
    assert set(result["compared"]) == {"max_lsb", "share_ne"}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"decode_realtime_x", "setup_s"}
    assert len(meshes) == 1 and meshes[0].shape == {"stream": 4, "frame": 1}
    assert {d.type for d in meshes[0].device_set} == {"cpu"}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_planted_fault_is_not_correct(fault):
    result, readings = _run(tamper=FAULTS[fault])
    assert result["correct"] is False, readings


def test_the_control_is_not_correct():
    result, readings = _run(control="tf32")
    assert result["correct"] is False, readings


def test_a_traced_run_reads_the_programs_mesh_spans():
    """On the CPU the program records the mesh's dispatch spans: the parse
    and the fan-out read numbers."""
    result, _ = _run(trace=True)
    got = result["metrics"]
    assert got["parse_ms"]["value"] > 0
    assert got["mesh_fanout_ms"]["value"] > 0


def test_a_program_without_the_mesh_spans_reads_none(monkeypatch):
    """A program that records no mesh spans (as before they were added):
    the fan-out reads None, the parse (the benchmark's own span) still a
    number."""
    from aacjax_torch.runtime.batch import BatchDecoder
    monkeypatch.setattr(BatchDecoder, "_traces_mesh", lambda self, mesh: False)
    result, _ = _run(trace=True)
    assert "mesh_fanout_ms" not in result["metrics"]
    assert result["metrics"]["parse_ms"]["value"] > 0


def _counted(values):
    return SimpleNamespace(counted=values.get)


def test_the_fanout_reader_without_and_with_its_numbers():
    assert mesh_fanout_ms.read(_counted({})) is None
    assert mesh_fanout_ms.read(_counted({"mesh.fanout_ns": None,
                                         "mesh.chunks_up": 5})) is None
    assert mesh_fanout_ms.read(_counted({"mesh.fanout_ns": 15 * 10 ** 6,
                                         "mesh.chunks_up": 5})) == (
        pytest.approx(3.0))


class _Decoder:
    """A stand-in for the program's decoder: the methods the route wraps."""
    trace = None

    def _parse_native(self):
        pass

    _device_step = finalize_step = _parse_native


def test_the_route_reads_the_programs_sums_through_the_tracer():
    """instrument's counters over the program's recorder: the fan-out
    spans summed and the chunks uploaded; the fan-out None until the
    program records any."""
    from aacjax_torch.runtime.stats import Trace
    lc_mesh = registry.route("lc_mesh")
    dec = _Decoder()
    tracer = Tracer(False)
    lc_mesh.instrument(dec, tracer)
    tr = dec.trace
    assert isinstance(tr, Trace)

    def chunk(k):
        up = tr.open("upload_dispatch", k, 0)
        for name in lc_mesh.FANOUT:
            tr.close(tr.open(name, k, 100), 400)
        tr.close(up, 1000)
    tracer._read_counters(1)        # as the window opens: nothing yet
    for k in range(3):
        chunk(k)
    tracer._read_counters(2)
    assert tracer.counted("mesh.fanout_ns") is None
    assert tracer.counted("mesh.chunks_up") == 3
    tracer._read_counters(1)
    chunk(3)
    tracer._read_counters(2)
    assert tracer.counted("mesh.fanout_ns") == 600
    assert tracer.counted("mesh.chunks_up") == 1
