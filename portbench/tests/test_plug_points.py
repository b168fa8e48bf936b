"""The four places where a configuration brings its own piece as a new
file, each with today's cells on the default: the reference decoder a
configuration names (`reference_decoder`), the output rows a route
declares (ROWS, OUT_CHANNELS), the SBR extended data's payload readers of
the reference's parse, and the corpus encoder a codec's name finds
(corpus/codecs/<codec>.py)."""
import json
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import registry
from portbench.check import Check
from portbench.corpus import Feed, adts_payloads, assign_slots, load
from portbench.corpus import make_corpus
from portbench.reference import asc, sbr
from portbench.reference.bitio import BitReader
from portbench.reference.syntax import decode_frame

BENCH = registry.benchmark()
CONFIGS = [c["name"] for c in BENCH["configs"]]
SEED = 2 ** 31 + 24

COUNTING = '''"""reference/decode.py's decoder, each making and each frame counted
in a file beside this one (one line each, from any worker process)."""
import pathlib

from portbench.reference import decode

CALLS = pathlib.Path(__file__).with_suffix(".calls")


def _note(line):
    with CALLS.open("a") as f:
        f.write(line + "\\n")


class Counting:
    def __init__(self, inner):
        self.inner = inner

    def decode(self, payload):
        _note("frame")
        return self.inner.decode(payload)


def decoder(facts, precision):
    _note("make " + precision)
    return Counting(decode.decoder(facts, precision))
'''


def _lc_check(config, feed, window):
    check = Check("pairs", SEED, feed, config, {"pairs": len(window)},
                  load(config, registry.ROOT).files, False)
    rng = np.random.default_rng(5)
    for k in range(window[-1] + 1):
        check.keep(k, rng.integers(-400, 400, (2 * len(feed.slots), feed.T,
                                               1024)).astype(np.int16))
    return check


def test_a_configuration_names_its_reference_decoder(tmp_path, monkeypatch):
    base = registry.load_json("configs", "aac-lc-256k-stereo-44k")
    (tmp_path / "configs").mkdir()
    (tmp_path / "reference").mkdir()
    (tmp_path / "reference" / "counting.py").write_text(COUNTING)
    throwaway = tmp_path / "configs" / "lc-counting.json"
    throwaway.write_text(json.dumps({**base, "reference_decoder": "counting"}))
    named = json.loads(throwaway.read_text())
    corpus = load(base, registry.ROOT)
    feed = Feed(corpus, assign_slots(SEED, [len(p) for p in corpus.payloads],
                                     3, 2), 2)
    window = [1, 2, 3]

    default = _lc_check(base, feed, window)
    monkeypatch.setattr(registry, "HERE", tmp_path)
    counted = _lc_check(named, feed, window)
    assert counted.module == str(tmp_path / "reference" / "counting.py")
    for control in (None, "tf32"):
        want = default.run(window, control=control, workers=2)
        got = counted.run(window, control=control, workers=2)
        assert got == want
        assert want["compared_chunks"] == len(window)
    calls = (tmp_path / "reference" / "counting.calls").read_text().split()
    tasks = counted._tasks(window)
    frames = sum(len(t[2]) for t in tasks)
    # the exact reference in both runs, the control's precision in one
    assert calls.count("exact") == 2 * len(tasks)
    assert calls.count("tf32") == len(tasks)
    assert calls.count("frame") == 3 * frames


def test_a_configuration_without_the_key_takes_reference_decode():
    for name in CONFIGS:
        path = registry.reference_file(registry.load_json("configs", name))
        assert path == registry.HERE / "reference" / "decode.py"


@pytest.mark.parametrize("channels,rows,out,first_rows", [
    (1, 2, 2, lambda s: [2 * s, 2 * s + 1]),    # a mono core, stereo out
    (2, None, None, lambda s: [2 * s, 2 * s + 1]),     # today's cells
    (2, 3, 2, lambda s: [3 * s, 3 * s + 1]),    # a spare slot after each
])
@pytest.mark.parametrize("kind", ["pairs", "slots"])
def test_a_route_declares_its_output_rows(kind, channels, rows, out,
                                          first_rows):
    n, T = 5, 2
    feed = SimpleNamespace(slots=[(0, 0)] * n, T=T)
    config = {"channels": channels, "check": {"limits": {}}}
    check = Check(kind, SEED, feed, config, {"pairs": 1, "slots": n}, [],
                  False, rows=rows, out_channels=out)
    per = rows or channels
    pcm = np.broadcast_to(np.arange(n * per, dtype=np.int16)[:, None, None],
                          (n * per, T, 8)).copy()
    for k in range(n):
        check.keep(k, pcm)
        for s, got in check.kept[k].items():
            assert got.shape == ((out or channels), T, 8)
            assert got[:, 0, 0].tolist() == first_rows(s)


def test_the_routes_declare_nothing_or_their_configurations_channels():
    for w in BENCH["workloads"]:
        c = registry.cell(BENCH, w["name"])
        for attr in ("ROWS", "OUT_CHANNELS"):
            assert getattr(c.route, attr, c.config["channels"]) \
                == c.config["channels"]


@pytest.fixture(scope="module")
def ps_stream():
    job = {"sample_rate": make_corpus.SR, "bitrate": 32000}
    enc = make_corpus.codec("he-aac-v2")
    assert enc.CODED_CHANNELS == 1
    return adts_payloads(enc.encode(make_corpus.music(SEED, 1.0), job))


def _parse(payloads, readers):
    config = asc.stream_config(2, 7, 1)       # 22.05 kHz mono core
    ctx = sbr.SBRContext(sample_rate=44100)
    return [decode_frame(BitReader(p), config, [0], sbr_ctx=ctx,
                         sbr_readers=readers) for p in payloads]


def _port_ps_payloads(payloads) -> int:
    """The frames whose SBR data the program's own parse finds PS in."""
    from aacjax_torch.host import sbr as port_sbr
    from aacjax_torch.host.asc import make_asc, parse_asc
    from aacjax_torch.host.bitio import BitReader as PortReader
    from aacjax_torch.host.syntax import decode_frame as port_frame
    config = parse_asc(make_asc(2, 7, 1))
    ctx = port_sbr.SBRContext(sample_rate=44100)
    frames = [port_frame(PortReader(p), config, [0], sbr_ctx=ctx)
              for p in payloads]
    return sum(f.elements[0].sbr.ps is not None for f in frames)


def test_the_sbr_reference_hands_ps_payloads_to_a_reader(ps_stream):
    assert len(ps_stream) >= 20
    with pytest.raises(asc.UnsupportedError, match="Parametric Stereo"):
        _parse(ps_stream[:1], None)
    calls = []

    def skip(r, bits_left):
        calls.append(bits_left)
        r.advance(bits_left)
        return len(calls)
    frames = _parse(ps_stream, {2: skip})
    assert len(frames) == len(ps_stream)
    assert len(calls) == _port_ps_payloads(ps_stream) == len(ps_stream)
    assert [f.elements[0].sbr.extensions for f in frames] == [
        {2: i + 1} for i in range(len(frames))]
    assert all(0 < b < 8 * 255 for b in calls)


def test_a_reader_that_reads_past_the_payload_is_an_overrun(ps_stream):
    from portbench.reference.bitio import BitstreamError

    def greedy(r, bits_left):
        r.advance(bits_left + 8)
    with pytest.raises(BitstreamError):
        _parse(ps_stream[:1], {2: greedy})


@pytest.mark.parametrize("config", CONFIGS)
def test_the_codec_modules_reproduce_the_committed_corpus(config, tmp_path):
    # one worker: two spawned HE encoders contend for the cores ~8x slower
    made = make_corpus.make(config, 1, out=tmp_path, streams=2)
    committed = registry.load_json("configs", config)["corpus"]
    table = json.loads((registry.ROOT / committed["frames_file"]).read_text())
    ours = json.loads((tmp_path / f"{config}.frames.json").read_text())
    for got, want in zip(made["corpus"]["files"], committed["files"][:2],
                         strict=True):
        assert got == want
        assert ours[got["file"]] == table[want["file"]]
    assert (registry.ROOT / committed["files"][0]["file"]).read_bytes() == (
        tmp_path / committed["files"][0]["file"].split("/")[-1]).read_bytes()
