"""The byte counts of the kernels' roofline metrics, from the input size
and the mission count alone: `chip_smoke.py`'s arithmetic at 64 MiB."""

import importlib.util
import os

import pytest

from portbench import run
from portbench.tests.small import CJK_ARGV

MIB64 = 64 << 20


def _module(name):
    path = os.path.join(run.HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_swar_counts_bytes_of_the_trio_at_64_mib():
    m = _module("swar_counts_roofline")
    assert m.pass_bytes(MIB64, 3) == 71_303_168  # 71.3 MB
    assert round(m.pass_bytes(MIB64, 3) / 1e6, 1) == 71.3


def test_orbit_bytes_of_one_pass_at_64_mib():
    m = _module("orbit_roofline")
    assert m.pass_bytes(MIB64) == 335_544_320  # 335.5 MB
    assert round(m.pass_bytes(MIB64) / 1e6, 1) == 335.5
    assert m.chain_missions(CJK_ARGV) == 4


class _Ctx:
    peak_bytes_per_s = run.HBM_PEAK_BYTES_PER_S
    traced_bytes = MIB64

    def __init__(self, config, device):
        self.config = config
        self.events = {"device": device, "host": [], "span": (0.0, 1e6)}


@pytest.mark.parametrize("name,argv,kernel,per_launch_us,launches", [
    ("swar_counts_roofline", None, "swar_counts_kernel(unsigned int)",
     100.0, 2),
    ("orbit_roofline", CJK_ARGV, "orbit_kernel(int const*, long)", 250.0, 4),
])
def test_roofline_share_from_device_time(name, argv, kernel,
                                         per_launch_us, launches):
    cfg = run.load_json(run.HERE, "configs", "trio.json") if argv is None \
        else {"argv": argv}
    device = [(0, kernel, 1000.0 * k, 1000.0 * k + per_launch_us)
              for k in range(launches)]
    device.append((0, "some_other_kernel", 0.0, 5e5))
    got = _module(name).read(_Ctx(cfg, device))
    m = _module(name)
    need = m.pass_bytes(MIB64, 3) if name.startswith("swar") else \
        4 * m.pass_bytes(MIB64)
    want = 100 * need / run.HBM_PEAK_BYTES_PER_S / (
        launches * per_launch_us / 1e6)
    assert got == pytest.approx(want)
    assert _module(name).read(_Ctx(cfg, device[-1:])) is None
