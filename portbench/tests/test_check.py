"""The output check, driven through the rest of a run on the CPU at a
size a test run holds (the program's plain PyTorch versions; the harness's
look for a card is skipped): a sound run reads small numbers; a run with
a fault planted under the timed path, and the control (the reference in
TF32 put in the program's place), come out not correct."""
import time

import pytest

from portbench import run
from portbench.tests.faults import FAULTS

# a few slots and chunks of each cell's traffic, and a window long enough
# that every slot is checked: LC compares every window chunk (`pairs` above
# their number), each chunk one slot in turn
SIZES = {
    "lc256k.bulk": ({"streams": 4, "chunk_frames": 4,
                     "check": {"pairs": 64}}, 6.0),
    "hev1-64k.bulk": ({"streams": 4, "chunk_frames": 4,
                       "check": {"slots": 4}}, 1.5),
}
SEED = 2 ** 31 + 2026


def _run(cell, **kw):
    t0 = time.perf_counter()
    traffic, seconds = SIZES[cell]
    return run.run_cell(cell, SEED, seconds, False, device="cpu",
                        traffic=traffic, workers=2, t_start=t0,
                        log=lambda msg: None, **kw)


@pytest.mark.parametrize("cell", list(SIZES))
def test_a_sound_run_reads_small_numbers(cell):
    result, readings = _run(cell)
    assert readings["compared_chunks"] > 0
    assert readings["compared_slots"] == SIZES[cell][0]["streams"]
    assert result["correct"] is True, readings
    assert list(result)[-1] == "compared"
    assert set(result["compared"]) == {"max_lsb", "share_ne"}
    wall = result["wall"]
    assert set(wall) == {"setup_s", "window_s", "check_s"}
    assert wall["setup_s"] == result["metrics"]["setup_s"]["value"]
    assert wall["window_s"] >= SIZES[cell][1] and wall["check_s"] > 0
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", ["lc256k.bulk", "hev1-64k.bulk"])
def test_a_planted_fault_is_not_correct(cell, fault):
    result, readings = _run(cell, tamper=FAULTS[fault])
    assert result["correct"] is False, readings


@pytest.mark.parametrize("cell", list(SIZES))
def test_the_control_is_not_correct(cell):
    result, readings = _run(cell, control="tf32")
    assert result["correct"] is False, readings
