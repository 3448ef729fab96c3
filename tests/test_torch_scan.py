"""The port's field kernels' plain versions against the JAX Pallas kernels
run in interpret mode, on the CPU:

- `flagship_swar_lanes_ref` (stringsext_tpu_torch/ops/swar.py) against
  `pallas_swar.flagship_swar_lanes`, also under filters that set the
  UTF-16 `astral` flag or have 12 intervals and on the seam and edge
  corpora of the CUDA kernel's design;
- `flagship_mission_lanes_ref` (stringsext_tpu_torch/ops/scan.py) against
  `pallas_scan.flagship_mission_lanes`, on unpadded random edges, which
  pins the reference's stream-edge context;
- the copies `swar_params` and `flagship_params` against the originals.

A CPU tensor takes the plain version; the CUDA kernels are held to them
on the card by chip_smoke.py. Every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stringsext_tpu.mission import Missions
from stringsext_tpu.ops import pallas_scan, pallas_swar
from stringsext_tpu_torch import _build
from stringsext_tpu_torch.corpus import SWAR_LANES_FILTERS, swar_lanes_corpora
from stringsext_tpu_torch.ops import scan, swar

MISSION_SETS = {
    "flagship": dict(),
    "grep": dict(flag_grep_char="63"),
    "astral": dict(flag_unicode_block_filter="Uncommon"),
    "asian": dict(flag_unicode_block_filter="Asian", flag_grep_char="41"),
    "nul": dict(flag_ascii_filter="0x" + "f" * 32),
    "many-intervals": dict(flag_ascii_filter="0x" + "5" * 32),
    "twelve": SWAR_LANES_FILTERS["twelve"],  # 12 intervals a mission
}


def _missions(name):
    return Missions.new(flag_encoding=["UTF-8", "utf-16le", "utf-16be"],
                        **MISSION_SETS[name]).v


def _corpus(n, seed):
    """Random bytes to both edges with UTF-8 and UTF-16 text planted."""
    r = np.random.default_rng(seed)
    raw = r.integers(0, 256, n, dtype=np.uint8)
    for t, off in [
        ("text ? déjà vu €uro here! \U0001F600".encode(), 1000),
        ("utf16 ? string Жж \U0001F600 日本語".encode("utf-16-le"), 2002),
        ("utf16 ? string Ωω \U0001F600".encode("utf-16-be"), 3000),
        (("\U0001F600" * 20 + "寿司").encode("utf-16-le"), 5002),
        (("\U0001F600" * 20 + "寿司").encode("utf-16-be"), 6500),
    ]:
        raw[off:off + len(t)] = np.frombuffer(t, np.uint8)
    return raw


@pytest.mark.parametrize("name", sorted(MISSION_SETS))
def test_copied_params_equal_the_originals(name):
    ms = _missions(name)
    assert swar.swar_params(ms) == pallas_swar.swar_params(ms)
    want = pallas_scan.flagship_params(ms)
    got = scan.flagship_params(ms)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (swar.swar_params(ms) is None) == (name == "many-intervals")


@pytest.mark.parametrize("corpus", ["random", "pairs", "seams-8-rows",
                                    "seams-40-rows"])
@pytest.mark.parametrize("name", ["flagship", "grep", "astral", "asian",
                                  "nul", "twelve"])
def test_flagship_swar_lanes_ref_matches_jax(name, corpus):
    """`seams-N-rows`: the corpora that the CUDA kernel's 16-byte threads
    and 512-byte warps make risky (`corpus.swar_lanes_corpora`: a 4-byte
    char or a surrogate pair across every seam in each codec, and edges
    that tell zero bytes around the stream from its own), at row counts
    the reference's 8-row halo blocks take."""
    tile_rows = 32
    if corpus == "random":
        raw = _corpus(64 * 512, seed=len(name))
        raw[-1] = 0xC3  # a lead byte at the very end: its trail is virtual
        corpora = {corpus: raw}
    elif corpus == "pairs":
        corpora = {corpus: np.array([[i, j] for i in range(256)
                                     for j in range(256)],
                                    np.uint8).reshape(-1)}
    else:
        tile_rows = 8
        corpora = swar_lanes_corpora((int(corpus.split("-")[1]),))
    p = swar.swar_params(_missions(name))
    for cname, raw in corpora.items():
        words = raw.view(np.int32).reshape(-1, 128)
        want = pallas_swar.flagship_swar_lanes(
            jnp.asarray(words), tile_rows=tile_rows, interpret=True, **p)
        got = swar.flagship_swar_lanes(torch.from_numpy(words), **p)
        assert len(got) == 3
        for mi, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == torch.int32 and g.shape == words.shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{cname} mission {mi}")
    if name == "astral" and corpus == "random":
        assert ((got[1].numpy() & 1) != 0).sum() > 20  # pairs accepted


def _edge_corpus(rows, seed):
    """Unpadded random data whose edges exercise the reference's edge
    context: a UTF-8 lead in the last byte with a continuation at the
    start of row R-32, and a UTF-16LE high surrogate in bytes 4094-4095
    with a low surrogate in bytes 0-1."""
    raw = _corpus(rows * 128, seed)
    raw[-1] = 0xC3
    raw[(rows - 32) * 128] = 0xA9
    raw[4094:4096] = (0x3D, 0xD8)
    raw[0:2] = (0x00, 0xDE)
    return raw.reshape(rows, 128)


@pytest.mark.parametrize("tile_rows", [32, 64])
@pytest.mark.parametrize("name", ["flagship", "grep", "asian",
                                  "many-intervals"])
def test_flagship_mission_lanes_ref_matches_jax(name, tile_rows):
    rows = 64
    data = _edge_corpus(rows, seed=tile_rows + len(name))
    params = scan.flagship_params(_missions(name))
    want = np.asarray(pallas_scan.flagship_mission_lanes(
        jnp.asarray(data), jnp.asarray(params), tile_rows=tile_rows,
        interpret=True))
    got = scan.flagship_mission_lanes(torch.from_numpy(data), params)
    assert got.dtype == torch.int32 and got.shape == data.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _seam_rows(rows):
    """[rows, 128] with a multi-byte char or a surrogate pair across every
    16-byte boundary (the seam between two threads of the CUDA kernel, so
    between its warps and blocks too): UTF-8 chars of 2-4 bytes starting
    1-3 bytes before it in the first half, UTF-16LE then UTF-16BE pairs
    with the boundary between their halves after; the edges are those of
    `_edge_corpus`."""
    n = rows * 128
    raw = np.full(n, 0x20, np.uint8)
    chars = [np.frombuffer(c.encode(), np.uint8) for c in "é€\U0001D11E"]
    for k, s in enumerate(range(16, n // 2, 16)):
        c = chars[k % 3]
        o = s - 1 - (k // 3) % (len(c) - 1)
        raw[o:o + len(c)] = c
    for base, end, codec in ((n // 2, 3 * n // 4, "utf-16-le"),
                             (3 * n // 4, n, "utf-16-be")):
        raw[base:end] = np.tile(np.frombuffer("A?".encode(codec), np.uint8),
                                (end - base) // 4)
        pair = np.frombuffer("\U0001D11E".encode(codec), np.uint8)
        for s in range(base + 16, end, 16):
            raw[s - 2:s + 2] = pair
    raw[-1] = 0xC3
    raw[(rows - 32) * 128] = 0xA9
    raw[4094:4096] = (0x3D, 0xD8)
    raw[0:2] = (0x00, 0xDE)
    return raw.reshape(rows, 128)


@pytest.mark.parametrize("rows", [32, 64])
@pytest.mark.parametrize("name", ["flagship", "grep", "astral", "nul",
                                  "many-intervals"])
def test_flagship_mission_lanes_seams_and_edges_match_jax(name, rows):
    """The corpora that the CUDA kernel's 16-byte threads make risky, at
    the two smallest row counts (R = 32: the stream is its own edge
    context on both sides), against interpret mode; chip_smoke.py holds
    the kernel to the plain version on the same corpora on the card."""
    params = scan.flagship_params(_missions(name))
    edges = np.random.default_rng(rows).integers(0, 256, rows * 128, np.uint8)
    edges[0:4] = (0x80, 0xDE, 0xBF, 0xDC)  # trails that byte 4095 claims
    edges[4093:4096] = (0x41, 0x3D, 0xD8)
    edges[-1] = 0xC3
    edges[(rows - 32) * 128] = 0xA9
    for data in (_seam_rows(rows), edges.reshape(rows, 128)):
        want = np.asarray(pallas_scan.flagship_mission_lanes(
            jnp.asarray(data), jnp.asarray(params), tile_rows=32,
            interpret=True))
        got = scan.flagship_mission_lanes(torch.from_numpy(data), params)
        np.testing.assert_array_equal(got.numpy(), want)
    if name == "astral":
        le = (got.numpy().reshape(-1) >> 8) & 0x7F
        assert ((le & 1) != 0).sum() > 50  # planted pairs are accepted


def test_flagship_mission_lanes_edge_context():
    """The reference's edge rule, pinned on the plain version: the last
    byte 0xC3 reads row R-32's 0xA9 as its trail (an accepted 2-byte
    char, as in the reference), and byte 0 reads bytes 4094-4095 as the
    high surrogate of a pair, so its UTF-16LE unit is a trail, no start.
    With zeros instead, both edges read the other way."""
    rows = 64
    data = _edge_corpus(rows, seed=1)
    params = scan.flagship_params(_missions("flagship"))
    got = scan.flagship_mission_lanes_ref(torch.from_numpy(data),
                                          params).numpy().reshape(-1)
    assert got[-1] & 0x7F == 0b1100101  # accept, length 2, start, valid
    assert (got[0] >> 8) & scan.START_BIT == 0  # UTF-16LE: pair trail
    padded = np.concatenate([np.zeros((32, 128), np.uint8), data,
                             np.zeros((32, 128), np.uint8)])
    zero_ctx = scan.flagship_mission_lanes_ref(
        torch.from_numpy(padded), params).numpy().reshape(-1)
    assert zero_ctx[4096 + rows * 128 - 1] & 1 == 0  # lead without trail
    assert (zero_ctx[4096] >> 8) & scan.START_BIT  # lone low: a start


@pytest.mark.parametrize("rows", [0, 16, 48])
def test_flagship_mission_lanes_needs_whole_halo_rows(rows):
    params = scan.flagship_params(_missions("flagship"))
    with pytest.raises(ValueError, match="multiple of 32"):
        scan.flagship_mission_lanes(torch.zeros((rows, 128), dtype=torch.uint8),
                                    params)


@pytest.mark.parametrize("bad,exc", [
    (torch.zeros((32, 128), dtype=torch.int32), TypeError),
    (torch.zeros((32, 64), dtype=torch.uint8), ValueError),
    (torch.zeros((128, 32), dtype=torch.uint8).t(), ValueError),
    (torch.zeros((32, 128), dtype=torch.uint8, device="meta"), ValueError),
])
def test_mission_lanes_wrapper_checks_its_input(bad, exc):
    params = scan.flagship_params(_missions("flagship"))
    with pytest.raises(exc):
        scan.flagship_mission_lanes(bad, params)


@pytest.mark.parametrize("bad,exc", [
    (torch.zeros((8, 128), dtype=torch.int64), TypeError),
    (torch.zeros((8, 64), dtype=torch.int32), ValueError),
    (torch.zeros((8, 128), dtype=torch.int32, device="meta"), ValueError),
])
def test_swar_lanes_wrapper_checks_its_input(bad, exc):
    p = swar.swar_params(_missions("flagship"))
    with pytest.raises(exc):
        swar.flagship_swar_lanes(bad, **p)


def test_cpu_tensors_never_load_the_cuda_library(monkeypatch):
    def refuse():
        raise AssertionError("the CUDA library was loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", refuse)
    before = (swar.flagship_swar_lanes.launches,
              scan.flagship_mission_lanes.launches)
    ms = _missions("grep")
    raw = _corpus(64 * 128, seed=3)
    words = torch.from_numpy(raw.view(np.int32).reshape(-1, 128))
    p = swar.swar_params(ms)
    for g, w in zip(swar.flagship_swar_lanes(words, **p),
                    swar.flagship_swar_lanes_ref(words, **p)):
        assert torch.equal(g, w)
    data = torch.from_numpy(raw.reshape(-1, 128))
    params = scan.flagship_params(ms)
    assert torch.equal(scan.flagship_mission_lanes(data, params),
                       scan.flagship_mission_lanes_ref(data, params))
    assert (swar.flagship_swar_lanes.launches,
            scan.flagship_mission_lanes.launches) == before


def _csrc_copy(tmp_path):
    import shutil

    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    return dst


def test_library_path_hashes_headers_and_sources(tmp_path):
    """A header edit builds a new library: the path hashes every *.cu,
    *.cuh and *.h under csrc/, and nothing else."""
    csrc = _csrc_copy(tmp_path)
    base = _build.library_path(str(csrc))
    assert base == _build.library_path()  # a copy hashes like the tree
    (csrc / "notes.txt").write_text("not a source")
    assert _build.library_path(str(csrc)) == base
    header = csrc / "common.cuh"
    header.write_text("#pragma once\n")
    with_header = _build.library_path(str(csrc))
    assert with_header != base
    header.write_text("#pragma once\n// edited\n")
    assert _build.library_path(str(csrc)) not in (base, with_header)
    (csrc / "sub").mkdir()
    (csrc / "sub" / "extra.h").write_text("#define X 1\n")
    last = _build.library_path(str(csrc))
    (csrc / "sub" / "extra.h").write_text("#define X 2\n")
    assert _build.library_path(str(csrc)) != last
    src = csrc / "swar_lanes.cu"
    src.write_text(src.read_text() + "\n")
    assert _build.library_path(str(csrc)) != _build.library_path()
