"""The plain reference against the port's own yardstick (`run.run_host`,
the C++ emitter over the whole stream) on the CPU: cut at its calm
boundaries, the regions' lines put together are the whole output, and
every region the check draws reads 0 wrong lines (the lower reading).
The control, the reference with the carry dropped at every decode window,
reads more (the upper reading), so the comparison can fail."""

import io

import numpy as np
import pytest

from portbench import check, images, run
from portbench.reference.regions import Reference
from portbench.tests.small import CJK_ARGV
from stringsext_tpu_torch import cli
from stringsext_tpu_torch import run as port_run

CASES = {
    "dense": ("trio", 1 << 20, 11),
    "firmware": (CJK_ARGV, 3 << 19, 12),
    "disk": ("trio", 2 << 20, 13),
}


def _case(kind, tmp_path):
    config, size, seed = CASES[kind]
    argv = config if isinstance(config, list) else \
        run.load_json(run.HERE, "configs", config + ".json")["argv"]
    data, marks = images.KINDS[kind](size, seed)
    path = tmp_path / "image.bin"
    data.tofile(path)
    out = io.BytesIO()
    port_run.run_host(cli.parse_args(argv + ["--", str(path)]), out=out)
    return Reference(argv), data, marks, out.getvalue()


@pytest.mark.parametrize("kind", sorted(CASES))
def test_regions_between_calm_boundaries_make_the_whole_output(kind,
                                                               tmp_path):
    ref, data, _, out = _case(kind, tmp_path)
    calm = ref.calm_boundaries(data)
    assert calm[0] == 0 and calm[-1] == len(data)
    assert (np.diff(calm) > 0).all() and (calm % 4096 == 0)[:-1].all()
    cuts = calm[::max(1, len(calm) // 12)].tolist()
    if cuts[-1] != len(data):
        cuts.append(len(data))
    lines = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        lines += ref.region_lines(data, lo, hi)
    whole = out[3:].split(b"\n")[1:-1]
    assert len(whole) > 0 and lines == whole


@pytest.mark.parametrize("kind", sorted(CASES))
def test_drawn_regions_read_zero_and_the_control_more(kind, tmp_path):
    ref, data, marks, out = _case(kind, tmp_path)
    parsed = check.Parsed(out, ref)
    assert (parsed.frame_errors, parsed.grammar_errors,
            parsed.order_errors) == (0, 0, 0)
    plan = {"bytes": 8192, "seams": 2, "marks": 8, "random": 8}
    regs = check.sample_regions(ref, data, marks, [len(data) // 2], plan,
                                np.random.default_rng(3))
    assert regs[0][0] == 0 and regs[-1][1] == len(data)
    wrong, total = check.region_mismatches(parsed, ref, data, regs)
    assert (wrong, total > 0) == (0, True)
    whole = [(0, len(data))]
    ctl_wrong, _ = check.region_mismatches(parsed, ref, data, whole,
                                           carry=False)
    assert ctl_wrong > 0


def test_grammar_and_order_faults_are_counted():
    ref = Reference(["-t", "x", "-e", "UTF-8", "-e", "UTF-16LE"])
    good = (b"\xef\xbb\xbf\n 10 \t(a UTF-8)\tabcd\n>10 \t(b UTF-16LE)\tefgh"
            b"\n<2a+\t(a UTF-8)\tijkl\n")
    p = check.Parsed(good, ref)
    assert (p.frame_errors, p.grammar_errors, p.order_errors) == (0, 0, 0)
    assert p.position.tolist() == [16, 16, 42]
    bad = (b"\n 10 \t(a UTF-8)\tabcd\n 10 \t(c UTF-8)\tx\n 1g \t(a UTF-8)\t"
           b"y\n 9 \t(b UTF-16LE)\tz\n 8 \t(a UTF-8)\t\n")
    p = check.Parsed(bad, ref)
    assert p.frame_errors == 2  # no BOM, so the first newline is early
    assert p.grammar_errors == 3  # (c ...), 1g, an empty string
    assert p.order_errors >= 1


class _EveryPage:
    def calm_boundaries(self, image):
        return np.arange(0, len(image) + 1, 4096)


def test_marks_are_drawn_between_every_two_seams():
    n, seams = 1 << 20, list(range(1 << 17, 1 << 20, 1 << 17))
    marks = np.arange(5000, n, 1 << 14)
    plan = {"bytes": 4096, "seams": 0, "marks": 0, "marks_each_seam": 2,
            "random": 0}
    regs = check.sample_regions(_EveryPage(), np.zeros(n, np.uint8), marks,
                                seams, plan, np.random.default_rng(3))
    cuts = [0] + seams + [n]
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        inside = [r for r in regs if lo <= r[0] and r[1] <= hi]
        assert len(inside) >= 1, (lo, hi, regs)
    assert len(regs) >= 2 + len(cuts) - 1
    without = dict(plan, marks_each_seam=0)
    assert check.sample_regions(_EveryPage(), np.zeros(n, np.uint8), marks,
                                seams, without,
                                np.random.default_rng(3)) == [(0, 4096),
                                                              (n - 4096, n)]
