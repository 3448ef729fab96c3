"""The window's arithmetic on a fake clock: whole scans back to back, none
started after the window's seconds, `scan_GBps` over all of them."""

import numpy as np
import pytest

from portbench import run


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class FakeScanner:
    def __init__(self, clock, seconds_by_path):
        self.clock, self.seconds = clock, seconds_by_path
        self.paths = []

    def scan(self, path):
        self.paths.append(path)
        self.clock.t += self.seconds[path]
        return "output of " + path


def _images(sizes):
    return [(f"img{k}", np.zeros(n, np.uint8), np.zeros(0, np.int64))
            for k, n in enumerate(sizes)]


@pytest.mark.parametrize("seconds,per_scan,want_scans", [
    (30.0, 6.0, 5), (30.0, 7.0, 5), (10.0, 10.0, 1), (10.0, 9.99, 2),
])
def test_window_runs_whole_scans_and_starts_none_after_its_seconds(
        seconds, per_scan, want_scans):
    clock = FakeClock()
    imgs = _images([1000, 2000, 3000, 4000])
    sc = FakeScanner(clock, {p: per_scan for p, _, _ in imgs})
    scans, elapsed, nbytes, traced = run.window(sc, imgs, seconds,
                                                False, clock=clock)
    assert len(scans) == want_scans
    assert [i for i, _, _ in scans] == [k % 4 for k in range(want_scans)]
    assert sc.paths == [f"img{k % 4}" for k in range(want_scans)]
    assert elapsed == pytest.approx(want_scans * per_scan)
    assert nbytes == sum(1000 * (k % 4 + 1) for k in range(want_scans))
    assert traced is None
    assert run.scan_gbps(nbytes, elapsed) == pytest.approx(
        nbytes / (want_scans * per_scan) / 1e9)


def test_window_time_ends_with_the_last_scan_of_unequal_lengths():
    clock = FakeClock()
    imgs = _images([10**9, 2 * 10**9])
    sc = FakeScanner(clock, {"img0": 4.0, "img1": 8.0})
    scans, elapsed, nbytes, _ = run.window(sc, imgs, 13.0, False,
                                           clock=clock)
    # starts at 0, 4, 12: the third starts before 13 s and runs to 16 s
    assert [round(s, 6) for _, _, s in scans] == [4.0, 8.0, 4.0]
    assert elapsed == pytest.approx(16.0)
    assert run.scan_gbps(nbytes, elapsed) == pytest.approx(4.0 / 16.0)


def test_a_traced_window_goes_on_to_its_traced_scan(monkeypatch):
    clock = FakeClock()
    imgs = _images([1000])
    sc = FakeScanner(clock, {"img0": 50.0})
    monkeypatch.setattr(run, "profiled_scan", lambda scanner, path: (
        scanner.scan(path), "events", {"device.feed": 1.0}))
    scans, _, nbytes, traced = run.window(sc, imgs, 10.0, True,
                                          clock=clock)
    assert len(scans) == run.TRACED_SCAN + 1
    assert traced == ("events", {"device.feed": 1.0}, 1000)
    assert nbytes == 1000 * (run.TRACED_SCAN + 1)
