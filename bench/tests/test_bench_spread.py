"""``bench/spread.py``: the quartile spread over the median of hand-made
sets of 6 runs, with and without the run farthest from the median, the
bound the widest set supports, and the command over files of result
lines."""
import json

import pytest

from bench import spread

# a slow run far above the rest: leaving it out narrows the spread.
# quartiles (exclusive): 100.75 and 104 + 0.25 * 16 = 108, median 102.5;
# without 120: 100.5 and 103.5, median 102
TAIL = [103.0, 100.0, 120.0, 101.0, 104.0, 102.0]
# two levels, as a shift of the host's pace gives: leaving out the
# farthest (105) moves the median to 96 and widens the spread, so it stays.
# quartiles 96 and 104 + 0.25 * 1 = 104.25, median 100; without 105:
# 96 and 104, median 96
SHIFT = [96.0, 104.0, 96.0, 105.0, 96.0, 104.0]


def test_spread_is_the_quartiles_distance_over_the_median():
    assert spread.spread(TAIL) == pytest.approx(7.25 / 102.5)
    assert spread.spread(SHIFT) == pytest.approx(8.25 / 100.0)
    assert spread.spread([5.0] * 6) == 0.0


def test_leaving_out_the_farthest_run_only_where_it_narrows():
    assert spread.trimmed_spread(TAIL) == pytest.approx(3.0 / 102.0)
    assert spread.spread(SHIFT[:3] + SHIFT[4:]) == pytest.approx(8.0 / 96.0)
    assert spread.trimmed_spread(SHIFT) == pytest.approx(8.25 / 100.0)


@pytest.mark.parametrize("widest, want", [
    (0.0170, 0.05),     # 4.25 % rounds up
    (0.0200, 0.05),     # exactly 5 % stays, round-off aside
    (0.0201, 0.06),     # 5.025 %
    (0.0005, 0.01),     # 0.125 %: a spread above 0 never gives 0
    (0.0800, 0.20),     # no cap here: the spec test holds every bound to 0.25
    (0.05173, 0.13),    # 12.93 %
])
def test_bound_is_the_factor_times_the_spread_rounded_up_to_a_hundredth(widest, want):
    assert spread.FACTOR == 2.5
    assert spread.bound(widest) == pytest.approx(want)


def _result(qps, setup):
    return {"correct": True, "metrics": {"qps.live": {"value": qps, "unit": "queries/s"},
                                         "setup_s": {"value": setup, "unit": "s"}}}


def test_report_takes_the_widest_set():
    sets = [[_result(v, 10.0 + i) for i, v in enumerate(TAIL)],
            [_result(v, 10.0) for v in SHIFT]]
    rep = spread.report(sets)
    live = rep["qps.live"]
    assert [s["n"] for s in live["sets"]] == [6, 6]
    assert live["widest"] == pytest.approx(8.25 / 100.0)
    assert live["widest_trimmed"] == pytest.approx(8.25 / 100.0)
    assert [s["median"] for s in live["sets"]] == [102.5, 100.0]
    assert live["bound"] == pytest.approx(0.21)  # 2.5 x 8.25 % = 20.6 %
    assert "bound" not in rep["setup_s"]  # judged by its median alone
    assert rep["setup_s"]["sets"][1]["spread"] == 0.0
    # the bound follows the spread without the farthest run: TAIL's 7.1 %
    # over all its runs does not raise it
    tail_only = spread.report([sets[0], sets[0]])["qps.live"]
    assert tail_only["widest"] == pytest.approx(7.25 / 102.5)
    assert tail_only["bound"] == pytest.approx(0.08)  # 2.5 x 2.94 % = 7.4 %


def test_the_command_reads_result_lines_and_passes_over_the_rest(tmp_path, capsys):
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    a.write_text("device: NVIDIA H100\n" + "\n".join(
        json.dumps(_result(v, 9.0)) for v in TAIL) + "\n")
    b.write_text("\n".join(json.dumps(_result(v, 9.0)) for v in SHIFT) + "\n"
                 + json.dumps({"seed": 1}) + "\n")  # an object with no metrics is no run
    assert [len(spread.load(p)) for p in (a, b)] == [6, 6]
    assert spread.main([str(a), str(b)]) == 0
    out = capsys.readouterr().out
    assert "qps.live" in out and "bound 0.21" in out  # 2.5 x 8.25 % = 20.6 %
    empty = tmp_path / "empty.jsonl"
    empty.write_text("no result here\n")
    assert spread.main([str(a), str(empty)]) == 1
