"""Seeded corpora and the flagship mission set of the port's checks.

Counterpart: bench.py::make_corpus :28 (the benchmark corpus, byte for
byte) and __graft_entry__.py::_flagship_missions :15. `sparse_corpus` is
the port's own: the same messages planted alone into zeros, and so are
the filter sets and seam corpora of `flagship_swar_lanes`' checks.
"""

from __future__ import annotations

import numpy as np

from .mission import Missions

MESSAGES = [
    b"/lib64/ld-linux-x86-64.so.2\x00",
    "Configuration déjà chargée €uro.".encode("utf-8"),
    "Device path: \\EFI\\BOOT\\BOOTX64.EFI".encode("utf-16-le"),
    "Русский текст в дампе памяти".encode("utf-16-le"),
    b"GET /index.html HTTP/1.1\r\nHost: example.com\r\n",
]


def make_corpus(size: int, seed: int = 0) -> np.ndarray:
    """Binary-image-like corpus: mostly random bytes with embedded
    ASCII/UTF-8/UTF-16 strings (like the reference's functional test
    input2: machine code + embedded UTF-16LE strings)."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=size, dtype=np.uint8)
    step = max(size // 2048, 4096)
    for off in range(0, size - 256, step):
        m = MESSAGES[(off // step) % len(MESSAGES)]
        data[off : off + len(m)] = np.frombuffer(m, np.uint8)
    return data


def sparse_corpus(size: int) -> np.ndarray:
    """Zeros with the messages every 128 KiB; the first and last 4 KiB
    stay zero."""
    raw = np.zeros(size, np.uint8)
    for k, off in enumerate(range(4096, size - 8192, 128 * 1024)):
        m = MESSAGES[k % len(MESSAGES)]
        raw[off:off + len(m)] = np.frombuffer(m, np.uint8)
    return raw


def flagship_missions(**kw) -> Missions:
    """UTF-8 + UTF-16LE + UTF-16BE (+ ascii), at least 4 chars: the
    mission set of the run-table step; `kw` adds filter flags."""
    return Missions.new(
        flag_encoding=["UTF-8", "utf-16le", "utf-16be", "ascii"],
        flag_chars_min_nb="4", **kw,
    )


# Filter flags (keyword arguments of `Missions.new`) under which
# `flagship_swar_lanes` is held to its plain version and to the reference:
# the defaults, a grep char, a filter whose UTF-16 intervals reach the
# astral planes, one whose interval covers the surrogates (both set the
# spec record's `astral` flag), and an ASCII filter of 11 runs that makes 12
# byte intervals for UTF-8 and 12 code-point intervals for UTF-16, the most
# `swar_params` takes.
SWAR_LANES_FILTERS = {
    "flagship": {},
    "grep": {"flag_grep_char": "63"},
    "astral": {"flag_unicode_block_filter": "Uncommon"},
    "surrogates": {"flag_unicode_block_filter": "Asian",
                   "flag_grep_char": "41"},
    "twelve": {"flag_ascii_filter": "0x7fdfffdf7fff7febbfeff7700000000",
               "flag_grep_char": "63"},
}

SEAM_CODECS = ("utf-8", "utf-16-le", "utf-16-be")


def swar_lanes_seams(rows: int, codec: str, high_first: bool = False):
    """`rows` blocks of 512 bytes of "a?" text in `codec` with U+1D11E, a
    4-byte UTF-8 char or a surrogate pair, across every 16-byte boundary
    (the seam between two threads of the field kernels, so every 512-byte
    row seam too): the UTF-8 char starts 1, 2 or 3 bytes before the
    boundary in turn, the pair has one half on each side. The edges tell a
    stream surrounded by zero bytes from one that reads any of its own
    bytes there. UTF-8: the stream starts with the char's last three bytes
    and an accepted char, and ends with an accepted char and the char's
    first three bytes. UTF-16: it starts with a lone low surrogate (a lone
    high one with `high_first`) and an accepted char, and ends with an
    accepted char and a lone high surrogate."""
    n = rows * 512
    char = np.frombuffer("\U0001D11E".encode(codec), np.uint8)
    fill = np.frombuffer("a?".encode(codec), np.uint8)
    raw = np.tile(fill, n // len(fill))
    a = fill[:len(fill) // 2]
    if codec == "utf-8":
        for k, s in enumerate(range(16, n, 16)):
            o = s - 1 - k % 3
            raw[o:o + 4] = char
        raw[:4] = np.concatenate([char[1:], a])
        raw[-4:] = np.concatenate([a, char[:3]])
    else:
        for s in range(16, n, 16):
            raw[s - 2:s + 2] = char
        raw[:4] = np.concatenate([char[:2] if high_first else char[2:], a])
        raw[-4:] = np.concatenate([a, char[:2]])
    return raw


def swar_lanes_edges(rows: int, codec: str, seed: int = 0) -> np.ndarray:
    """`rows` blocks of 512 random bytes whose first and last word are the
    same four bytes, chosen so that a kernel which read the stream's own
    edge word once more instead of zero bytes would see another field:
    UTF-8 a continuation byte first and a 2-byte lead last (the lead would
    claim it), UTF-16 a low surrogate first and a high one last (they
    would pair)."""
    word = {"utf-8": (0xA9, 0x41, 0x41, 0xC3),
            "utf-16-le": (0x00, 0xDC, 0x3D, 0xD8),
            "utf-16-be": (0xDC, 0x00, 0xD8, 0x3D)}[codec]
    raw = np.random.default_rng(seed).integers(0, 256, rows * 512, np.uint8)
    raw[:4] = raw[-4:] = word
    return raw


def swar_lanes_corpora(row_counts=(1, 3, 33)) -> dict:
    """The corpora of `swar_lanes_seams` and `swar_lanes_edges` by name,
    for row counts that are no multiple of a block's 8 rows, in every
    codec, and at the first row count also with a high surrogate first."""
    out = {}
    for k, codec in enumerate(SEAM_CODECS):
        out[f"edges-{codec}-{row_counts[0]}-rows"] = swar_lanes_edges(
            row_counts[0], codec, seed=k)
    for rows in row_counts:
        for codec in SEAM_CODECS:
            out[f"seams-{codec}-{rows}-rows"] = swar_lanes_seams(rows, codec)
    for codec in SEAM_CODECS[1:]:
        out[f"seams-{codec}-{row_counts[0]}-rows-high-first"] = \
            swar_lanes_seams(row_counts[0], codec, high_first=True)
    return out
