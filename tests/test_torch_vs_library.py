"""The paired rule of ``probes/vs_library.py`` on injected timings.

``in_turns`` times a kernel and its PyTorch call alternately; here its
timer (``_ms``) is replaced by one that returns the next injected time of
each side, so the verdict is checked on known per-round differences: a
one-sided sign test at 1% over the rounds that were not ties (19 of 25),
with the median difference's sign.  No device is used.
"""

import pytest

from fm_radio_tpu_torch.probes import vs_library as vl


def _turns(monkeypatch, k_ms, lib_ms):
    """in_turns on the injected per-round times of each side; also the
    order in which the sides were timed."""
    order = []

    def side(name, times):
        it = iter(times)

        def call():
            order.append(name)
            return next(it)
        return call

    monkeypatch.setattr(vl, "_ms", lambda fn, reps: fn())
    res = vl.in_turns(side("k", k_ms), side("lib", lib_ms), len(k_ms), 10)
    return res, order


@pytest.mark.parametrize("n, need", [(25, 19), (20, 16), (18, 15), (10, 10),
                                     (6, 7), (5, 6), (0, 1)])
def test_sign_need_is_the_one_sided_one_percent_count(n, need):
    assert vl.sign_need(n) == need


@pytest.mark.parametrize("slower, faster, ties, loses, wins", [
    (25, 0, 0, True, False),    # slower in every round
    (19, 6, 0, True, False),    # exactly the 1% count
    (18, 7, 0, False, False),   # one round short of it
    (0, 25, 0, False, True),    # faster in every round
    (6, 19, 0, False, True),
    (7, 18, 0, False, False),
    (0, 0, 25, False, False),   # every round a tie
    (18, 0, 7, True, False),    # ties drop out: 18 of 18 rounds
    (12, 12, 1, False, False),
], ids=["25of25", "19of25", "18of25", "wins25", "wins19", "wins18",
        "all_ties", "ties_drop_out", "even"])
def test_in_turns_verdict(monkeypatch, slower, faster, ties, loses, wins):
    lib = [0.100 + 0.001 * i for i in range(slower + faster + ties)]
    k = ([t + 0.002 for t in lib[:slower]]
         + [t - 0.002 for t in lib[slower:slower + faster]]
         + lib[slower + faster:])
    res, _ = _turns(monkeypatch, k, lib)
    assert res["rounds_kernel_slower"] == slower
    assert res["rounds_kernel_faster"] == faster
    assert res["rounds_needed"] == vl.sign_need(slower + faster)
    assert (res["loses"], res["wins"]) == (loses, wins)
    assert res["rounds"] == len(k) and res["calls_a_round"] == 10


def test_in_turns_alternates_and_reports_both_sides(monkeypatch):
    k = [0.2, 0.3, 0.25, 0.21]
    lib = [0.1, 0.1, 0.12, 0.11]
    res, order = _turns(monkeypatch, k, lib)
    # the kernel first in even rounds, the library call first in odd ones
    assert order == ["k", "lib", "lib", "k", "k", "lib", "lib", "k"]
    assert res["kernel"] == pytest.approx({"median_ms": 0.23, "min_ms": 0.2,
                                           "max_ms": 0.3, "spread_ms": 0.1})
    assert res["library"]["median_ms"] == pytest.approx(0.105)
    assert res["median_diff_ms"] == pytest.approx(0.115)


def test_a_slow_round_does_not_hide_a_steady_gap(monkeypatch):
    """The earlier rule compared the medians' gap with either side's
    min-max spread, which one slow round widens; the paired rule counts
    the rounds."""
    lib = [0.1788] * 25
    k = [0.1878] * 24 + [0.2007]
    res, _ = _turns(monkeypatch, k, lib)
    assert res["loses"] and res["rounds_kernel_slower"] == 25
    assert res["median_diff_ms"] > 0
