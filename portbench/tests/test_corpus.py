"""The frozen corpus and the slots the seed assigns over it."""
import collections
import hashlib
import json

import numpy as np
import pytest

from portbench import registry
from portbench.corpus import CorpusError, Feed, assign_slots, load

BENCH = registry.benchmark()
CONFIGS = [c["name"] for c in BENCH["configs"]]
CELLS = [w["name"] for w in BENCH["workloads"]]
SEEDS = [0, 7, 2 ** 31 + 11, 2 ** 40 + 3, -5]


@pytest.fixture(scope="module")
def corpora():
    return {c: load(registry.load_json("configs", c), registry.ROOT)
            for c in CONFIGS}


@pytest.mark.parametrize("config", CONFIGS)
def test_hashes_match(config, corpora):
    cfg = registry.load_json("configs", config)
    for f in cfg["corpus"]["files"]:
        data = (registry.ROOT / f["file"]).read_bytes()
        assert hashlib.sha256(data).hexdigest() == f["sha256"]
        assert len(data) == f["bytes"]
    table = (registry.ROOT / cfg["corpus"]["frames_file"]).read_bytes()
    assert hashlib.sha256(table).hexdigest() == cfg["corpus"]["frames_sha256"]
    assert len(corpora[config].payloads) == len(cfg["corpus"]["files"])


@pytest.mark.parametrize("config", CONFIGS)
def test_a_changed_byte_is_refused(config, tmp_path):
    cfg = registry.load_json("configs", config)
    f = cfg["corpus"]["files"][0]["file"]
    for rel in [f, cfg["corpus"]["frames_file"]] + [
            x["file"] for x in cfg["corpus"]["files"][1:]]:
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes((registry.ROOT / rel).read_bytes())
    data = bytearray((tmp_path / f).read_bytes())
    data[100] ^= 1
    (tmp_path / f).write_bytes(bytes(data))
    with pytest.raises(CorpusError):
        load(cfg, tmp_path)


@pytest.mark.parametrize("config", CONFIGS)
def test_bitrate_within_5_percent_of_the_published_rate(config):
    cfg = registry.load_json("configs", config)
    kbps = [f["bytes"] * 8 / cfg["corpus"]["make"]["seconds"] / 1000
            for f in cfg["corpus"]["files"]]
    assert abs(np.mean(kbps) - cfg["corpus"]["mean_kbps"]) < 0.01
    assert abs(np.mean(kbps) * 1000 / cfg["bitrate_bps"] - 1) <= 0.05


def _cell_slots(cell, seed, corpora):
    c = registry.cell(BENCH, cell)
    corpus = corpora[c.config["name"]]
    t = c.traffic
    return c, corpus, assign_slots(seed, [len(p) for p in corpus.payloads],
                                   t["streams"],
                                   t["spacing_chunks"] * t["chunk_frames"])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_slots_are_deterministic_for_a_seed(cell, seed, corpora):
    _, _, a = _cell_slots(cell, seed, corpora)
    _, _, b = _cell_slots(cell, seed, corpora)
    _, _, other = _cell_slots(cell, seed + 1, corpora)
    assert a == b
    assert a != other


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_every_seed_gives_every_stream_the_same_load(cell, seed, corpora):
    c, corpus, slots = _cell_slots(cell, seed, corpora)
    per = collections.Counter(s for s, _ in slots)
    n = len(corpus.payloads)
    assert set(per.values()) <= {c.traffic["streams"] // n,
                                 -(-c.traffic["streams"] // n)}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_no_two_slots_read_one_frame_in_a_chunk(cell, seed, corpora):
    c, corpus, slots = _cell_slots(cell, seed, corpora)
    feed = Feed(corpus, slots, c.traffic["chunk_frames"])
    longest = max(len(p) for p in corpus.payloads)
    for k in range(0, 2 * longest // feed.T + 2):
        seen = set()
        for j, (s, _) in enumerate(slots):
            for f in feed.frames(j, k):
                assert (s, f) not in seen, (k, j, s, f)
                seen.add((s, f))


@pytest.mark.parametrize("cell", CELLS)
def test_slots_of_a_stream_start_the_traffic_spacing_apart(cell, corpora):
    c, corpus, slots = _cell_slots(cell, 12345, corpora)
    spacing = c.traffic["spacing_chunks"] * c.traffic["chunk_frames"]
    by = collections.defaultdict(list)
    for s, start in slots:
        by[s].append(start)
    for s, starts in by.items():
        n = len(corpus.payloads[s])
        st = sorted(starts)
        gaps = np.diff(st + [st[0] + n])
        assert gaps.min() >= spacing


def test_feed_hands_each_slot_its_frames_in_order(corpora):
    c, corpus, slots = _cell_slots("lc256k.bulk", 99, corpora)
    feed = Feed(corpus, slots, 2)
    it = iter(feed)
    for k in range(300):            # past every stream's loop
        chunk = next(it)
        for j, (s, _) in enumerate(slots):
            want = [corpus.payloads[s][f] for f in feed.frames(j, k)]
            assert chunk[j] == want
    feed.stop()
    assert next(it, None) is None
    assert len(feed.handed) == 300


def test_too_many_slots_for_the_spacing_are_refused():
    with pytest.raises(CorpusError):
        assign_slots(1, [100, 100], 20, 16)


def test_frame_tables_hold_a_digit_a_frame(corpora):
    for config in CONFIGS:
        cfg = registry.load_json("configs", config)
        table = json.loads((registry.ROOT / cfg["corpus"]["frames_file"])
                           .read_text())
        for f in cfg["corpus"]["files"]:
            assert len(table[f["file"]]) == f["frames"]
